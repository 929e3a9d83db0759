"""How far REBLUR_DIFFUSE's port and the JAX Engine part, beside how far the JAX Engine parts
from itself when one ulp is added to half of its radiance texels: both unsharded, on the CPU,
the orbit scene of `tests/test_sharding.py` at 128x64, frames 16.66 ms apart. Not a test (the
witness that `tests/test_torch_mesh_slice.py:test_reblur_amplifies_rounding` holds at 3 frames);
a table for more seeds and frames:

    JAX_PLATFORMS=cpu python tests/reblur_rounding_witness.py --frames 5 --seeds 0,1,2

Per seed and frame it prints the share of output values that part by more than 1e-4 and the
largest difference, for port - JAX, JAX(+1 ulp) - JAX and port(+1 ulp) - port; with --state it
also compares each state plane of the two Engines after each frame of seed 0.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from nrdtpu import frontend as fe  # noqa: E402
from nrdtpu.engine import Engine  # noqa: E402
from nrdtpu.settings import Denoiser, ResourceType as RT  # noqa: E402
from nrdtpu.utils.scene import SceneGenerator, SceneSpec  # noqa: E402
from nrdtpu_torch.engine import Engine as TEngine  # noqa: E402
from nrdtpu_torch.settings import Denoiser as TD, ResourceType as TRT  # noqa: E402

SIZE = (128, 64)
HDP = [3.0, 0.1, 20.0, -25.0]


def frames(seed, n, ulp):
    """(common settings, pool) of n frames; ulp: one ulp added to a seeded half of the
    radiance texels."""
    gen = SceneGenerator(SceneSpec(size=SIZE, seed=seed), camera_mode="orbit")
    rng = np.random.default_rng(123)
    for i in range(n):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        nhd = fe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist), jnp.asarray(fd.view_z),
                                          jnp.asarray(HDP), 1.0)
        rad = np.asarray(fe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), nhd))
        if ulp:
            rad = np.where(rng.random(rad.shape) < 0.5, np.nextafter(rad, np.float32(np.inf)),
                           rad)
        yield fd.common_settings, {RT.IN_VIEWZ: fd.view_z,
                                   RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                                   RT.IN_MV: fd.mv, RT.IN_DIFF_RADIANCE_HITDIST: rad}


def engines():
    return (Engine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=SIZE),
            TEngine({0: TD.REBLUR_DIFFUSE}, resource_size=SIZE, device="cpu"))


def outputs(seed, n, ulp):
    """([JAX output a frame], [port output a frame]), float64, (h, w, 4)."""
    je, te = engines()
    jo, to = [], []
    for cs, pool in frames(seed, n, ulp):
        je.set_common_settings(cs)
        jo.append(np.asarray(je.denoise([0], pool)[RT.OUT_DIFF_RADIANCE_HITDIST], np.float64))
        te.set_common_settings(cs)
        out = te.denoise([0], {TRT[k.name]: v for k, v in pool.items()})
        to.append(out[TRT.OUT_DIFF_RADIANCE_HITDIST].double().numpy())
    return jo, to


def parted(a, b):
    d = np.abs(a - b.reshape(a.shape))
    return f"{(d > 1e-4).mean():.4f} (max {d.max():.2e})"


def state_table(n):
    je, te = engines()
    for i, (cs, pool) in enumerate(frames(0, n, False)):
        je.set_common_settings(cs)
        je.denoise([0], pool)
        te.set_common_settings(cs)
        te.denoise([0], {TRT[k.name]: v for k, v in pool.items()})
        js, ts = je.get_state(0), te.get_state(0)
        for k in sorted(ts):
            a = np.asarray(jnp.asarray(js[k], jnp.float32), np.float64)
            d = np.abs(a - ts[k].double().numpy().reshape(a.shape))
            print(f"state frame {i + 1} {k:24s} {str(ts[k].dtype):15s} parted "
                  f"{(d > 1e-4).mean():.4f} (max {d.max():.3e})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--state", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(2)
    for seed in (int(s) for s in args.seeds.split(",")):
        jax0, port0 = outputs(seed, args.frames, False)
        jax1, port1 = outputs(seed, args.frames, True)
        for i in range(args.frames):
            print(f"seed {seed} frame {i + 1}: port - JAX {parted(port0[i], jax0[i])}; "
                  f"JAX(+1 ulp) - JAX {parted(jax1[i], jax0[i])}; "
                  f"port(+1 ulp) - port {parted(port1[i], port0[i])}", flush=True)
    if args.state:
        state_table(args.frames)


if __name__ == "__main__":
    main()
