"""REBLUR hit-distance reconstruction in the PyTorch port (K12 `hitdist_recon` and its glue)
against the JAX package's XLA path.

The orbit scene gives every geometry pixel a hit distance, so the inputs here get holes: the
hit-distance channel is set to 0 on a seeded 30 % of the geometry pixels, as a renderer that
traces some pixels and not others sends them. Both packages get the same inputs.

- The pass, `hit_dist_reconstruction`, at radius 1 and 2 for the diffuse signal, the
  specular signal and both in one launch, within rtol=1e-4, atol=1e-5 of
  `nrdtpu.passes.reblur.kernels.hit_dist_reconstruction` (the port keeps XLA's op order;
  what remains is last-bit differences of exp, atan and rsqrt).
- REBLUR_DIFFUSE with AREA_3X3 and AREA_5X5 end to end, >= 60 dB against the JAX Engine on
  every one of 4 frames at 64x48 (`tests/test_torch_hdrecon_slice.py` runs the flagship).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, HitDistanceReconstructionMode as JHM
from nrdtpu.settings import ResourceType as JRT, replace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode, ResourceType as RT

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (72, 40)  # not a multiple of 16
RTOL, ATOL = 1e-4, 1e-5
PSNR_BAR_DB = 60.0
HOLE_FRACTION = 0.3
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
OUTPUTS = {"diff": JRT.OUT_DIFF_RADIANCE_HITDIST, "spec": JRT.OUT_SPEC_RADIANCE_HITDIST}


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def punched_pool(gen, fd, seed):
    """Both signals packed as the front end packs them, hit distance 0 on a seeded subset of
    the geometry pixels."""
    rng = np.random.default_rng(seed)
    holes = (rng.random(fd.view_z.shape) < HOLE_FRACTION) & (fd.hit_mask > 0)
    vz = jnp.asarray(fd.view_z)
    pool = {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv}
    for rt, noisy, hit, rough in (
            (JRT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist, 1.0),
            (JRT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist,
             jnp.asarray(fd.roughness))):
        nhd = jfe.reblur_get_norm_hit_dist(jnp.asarray(hit), vz, jnp.asarray(HDP), rough)
        sig = np.array(jfe.reblur_pack_radiance_hitdist(jnp.asarray(noisy), nhd))
        sig[..., 3][holes] = 0.0
        pool[rt] = sig
    return pool


@pytest.fixture(scope="module")
def ctx():
    """Frame 1's constants of the JAX Engine (REBLUR_DIFFUSE_SPECULAR) and punched inputs."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=SIZE)
    fd = gen.frame(1)
    eng.set_common_settings(fd.common_settings)
    inst = eng._instances[0]
    sc = eng._shared_consts()
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    return dict(sc=sc, dc=dc, cfg=inst.config, pool=punched_pool(gen, fd, 3),
                geometry=fd.hit_mask > 0)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("signals", [("diff",), ("spec",), ("diff", "spec")],
                         ids=["diff", "spec", "both"])
def test_pass_matches_xla(ctx, radius, signals):
    p = ctx["pool"]
    sig = {s: p[rt] if s in signals else None
           for s, rt in (("diff", JRT.IN_DIFF_RADIANCE_HITDIST),
                         ("spec", JRT.IN_SPEC_RADIANCE_HITDIST))}
    want = JK.hit_dist_reconstruction(
        ctx["sc"], ctx["dc"], jnp.asarray(p[JRT.IN_VIEWZ]), jnp.asarray(p[JRT.IN_NORMAL_ROUGHNESS]),
        *[None if v is None else jnp.asarray(v) for v in sig.values()], ctx["cfg"],
        radius=radius)
    got = TK.hit_dist_reconstruction(
        interop.consts_from_numpy(ctx["sc"]), interop.consts_from_numpy(ctx["dc"]),
        torch.from_numpy(p[JRT.IN_VIEWZ]), torch.from_numpy(p[JRT.IN_NORMAL_ROUGHNESS]),
        *[None if v is None else torch.from_numpy(v) for v in sig.values()], ctx["cfg"],
        radius=radius)
    for name, g, w, src in zip(("diff", "spec"), got, want, sig.values()):
        if src is None:
            assert g is None and w is None
            continue
        g, w = g.numpy(), np.asarray(w)
        bad = ~np.isclose(g, w, rtol=RTOL, atol=ATOL)
        assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                               f"{np.abs(g - w).max():.3g}")
        # the holes in the geometry were filled and the other channels passed through
        holes = (src[..., 3] == 0.0) & ctx["geometry"]
        assert (g[..., 3][holes] > 0.0).mean() > 0.9
        np.testing.assert_array_equal(g[..., :3], src[..., :3])


def run(denoiser, size, n_frames, mode):
    """n_frames of the orbit scene with holes through both Engines with the reconstruction
    mode set. Returns per frame the outputs of both, by signal."""
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser[denoiser]}, resource_size=size)
    te = TEngine({0: Denoiser[denoiser]}, resource_size=size, device="cpu")
    je.set_denoiser_settings(0, replace(je._settings[0], hitDistanceReconstructionMode=JHM[mode]))
    te.set_denoiser_settings(0, replace(
        te._settings[0], hitDistanceReconstructionMode=HitDistanceReconstructionMode[mode]))
    signals = [sig for sig, name in (("diff", "DIFFUSE"), ("spec", "SPECULAR"))
               if name in denoiser]
    frames = []
    for i in range(n_frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = punched_pool(gen, fd, i)
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], pool)
        to = te.denoise([0], {RT(int(k)): v for k, v in pool.items()})
        frames.append(dict(
            jax={sig: np.asarray(jo[OUTPUTS[sig]]) for sig in signals},
            torch={sig: interop.tensor_to_numpy(to[RT(int(OUTPUTS[sig]))]) for sig in signals}))
    return frames


@pytest.mark.parametrize("mode", ["AREA_3X3", "AREA_5X5"])
def test_diffuse_slice_matches_jax(mode):
    for frame, r in enumerate(run("REBLUR_DIFFUSE", (64, 48), 4, mode)):
        got, want = r["torch"]["diff"], r["jax"]["diff"]
        assert got.shape == want.shape and np.isfinite(got).all()
        p = psnr(got, want)
        assert p >= PSNR_BAR_DB, f"{mode} frame {frame}: {p:.2f} dB"
