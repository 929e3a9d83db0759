"""REBLUR's other specular paths at SQ_LINEAR and SQRT_LINEAR roughness, end to end on the CPU:
the occlusion variants, the SH variants, checkerboard and the hit-distance reconstruction, the
PyTorch port's Engine against the JAX Engine (XLA path, op by op, as in
`tests/test_torch_reblur_roughness_slice.py`) at 48x32 over 2 frames of the orbit scene.

Each configuration is one JAX run of the two-signal variant, which on the CPU runs the one-signal
functions op for op, so it holds the port's specular variant and its two-signal variant:
- occlusion at SQ_LINEAR: REBLUR_SPECULAR_OCCLUSION and REBLUR_DIFFUSE_SPECULAR_OCCLUSION on the
  binary AO of `tests/test_torch_reblur_occ_slice.py` (the specular one a second draw);
- SH at SQRT_LINEAR: REBLUR_SPECULAR_SH and REBLUR_DIFFUSE_SPECULAR_SH, SH0 / SH1 packed as
  `tests/test_torch_reblur_sh_slice.py` packs them (SH1 along a direction field of the surface);
- checkerboard BLACK at SQ_LINEAR: REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR, the inputs at
  half width (H2's and N4's checkerboard PrePass);
- AREA_3X3 at SQRT_LINEAR: REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR, the hit distance zeroed
  on a seeded 30 % of the geometry pixels (K12 at LINEAR on the decoded plane).

Bar: every output >= 60 dB PSNR against JAX on every frame.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import CheckerboardMode as JCB, Denoiser as JDenoiser
from nrdtpu.settings import HitDistanceReconstructionMode as JHM, ResourceType as JRT
from nrdtpu.settings import RoughnessEncoding as JRE, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import CheckerboardMode as CB, Denoiser
from nrdtpu_torch.settings import HitDistanceReconstructionMode as HM, ResourceType as RT
from nrdtpu_torch.settings import RoughnessEncoding as RE, replace

from test_torch_reblur_occ_slice import half_width
from test_torch_reblur_sh_slice import SH_DIRECTIONS
from test_torch_relax_slice import psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (48, 32)
FRAMES = 2
PSNR_BAR_DB = 60.0
HOLE_FRACTION = 0.3
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
# kind: each signal's (inputs, outputs)
RESOURCES = {"radiance": {"diff": ((RT.IN_DIFF_RADIANCE_HITDIST,), (RT.OUT_DIFF_RADIANCE_HITDIST,)),
                          "spec": ((RT.IN_SPEC_RADIANCE_HITDIST,), (RT.OUT_SPEC_RADIANCE_HITDIST,))},
             "occ": {"diff": ((RT.IN_DIFF_HITDIST,), (RT.OUT_DIFF_HITDIST,)),
                     "spec": ((RT.IN_SPEC_HITDIST,), (RT.OUT_SPEC_HITDIST,))},
             "sh": {"diff": ((RT.IN_DIFF_SH0, RT.IN_DIFF_SH1), (RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1)),
                    "spec": ((RT.IN_SPEC_SH0, RT.IN_SPEC_SH1), (RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1))}}
SUFFIX = {"radiance": "", "occ": "_OCCLUSION", "sh": "_SH"}
# configuration: (kind, encoding, settings of both Engines)
CONFIGS = {"occlusion_sq_linear": ("occ", "SQ_LINEAR", {}),
           "sh_sqrt_linear": ("sh", "SQRT_LINEAR", {}),
           "cb_black_sq_linear": ("radiance", "SQ_LINEAR", dict(checkerboardMode="BLACK")),
           "area_3x3_sqrt_linear": ("radiance", "SQRT_LINEAR",
                                    dict(hitDistanceReconstructionMode="AREA_3X3"))}


def _pool(gen, fd, i, kind, encoding, cb, holes):
    """Both signals' inputs of the kind, IN_NORMAL_ROUGHNESS packed with the encoding."""
    rng = np.random.default_rng((61, i))
    pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
            RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd, re_=JRE[encoding])}
    punched = (rng.uniform(size=fd.view_z.shape) < HOLE_FRACTION) & (fd.hit_mask > 0)
    vz = jnp.asarray(fd.view_z)
    for sig, noisy, hit, rough in (("diff", fd.diff_noisy, fd.diff_hit_dist, 1.0),
                                   ("spec", fd.spec_noisy, fd.spec_hit_dist, fd.roughness)):
        ins = RESOURCES[kind][sig][0]
        if kind == "occ":
            ao = (fd.ao_noisy if sig == "diff" else
                  (rng.uniform(size=fd.ao_clean.shape) < fd.ao_clean).astype(np.float32))
            planes = [ao]
        else:
            nhd = np.asarray(jfe.reblur_get_norm_hit_dist(jnp.asarray(hit), vz, jnp.asarray(HDP),
                                                          jnp.asarray(rough)))
            if holes:
                nhd = np.where(punched, 0.0, nhd).astype(np.float32)
            if kind == "sh":
                sh0, sh1 = tfe.reblur_pack_sh(torch.from_numpy(noisy), torch.from_numpy(nhd),
                                              SH_DIRECTIONS[sig](torch.from_numpy(fd.normal)))
                sh1 = sh1.numpy()
                sh1[..., 3] = rng.uniform(0.0, 1.0, fd.view_z.shape)
                planes = [sh0.numpy(), sh1]
            else:
                planes = [np.asarray(jfe.reblur_pack_radiance_hitdist(jnp.asarray(noisy),
                                                                      jnp.asarray(nhd)))]
        for rt, plane in zip(ins, planes):
            pool[rt] = (plane if cb is None
                        else half_width(plane, fd.common_settings.frameIndex, CB[cb]))
    return pool


def _settings(settings, hm, cbm):
    return {k: hm[v] if k == "hitDistanceReconstructionMode" else cbm[v]
            if k == "checkerboardMode" else v for k, v in settings.items()}


@functools.lru_cache(maxsize=None)
def run(config):
    """A configuration through the JAX Engine (the two-signal variant, op by op) and the port's
    specular and two-signal variants."""
    kind, encoding, settings = CONFIGS[config]
    names = {"spec": "REBLUR_SPECULAR" + SUFFIX[kind],
             "both": "REBLUR_DIFFUSE_SPECULAR" + SUFFIX[kind]}
    je = JEngine({0: JDenoiser[names["both"]]}, resource_size=SIZE,
                 roughness_encoding=JRE[encoding])
    if settings:
        je.set_denoiser_settings(0, jreplace(je._settings[0], **_settings(settings, JHM, JCB)))
    engs = {}
    for key, name in names.items():
        engs[key] = TEngine({0: Denoiser[name]}, resource_size=SIZE,
                            roughness_encoding=RE[encoding], device="cpu")
        engs[key].set_denoiser_settings(0, replace(engs[key]._settings[0],
                                                   **_settings(settings, HM, CB)))
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    frames = []
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = _pool(gen, fd, i, kind, encoding, settings.get("checkerboardMode"),
                     "hitDistanceReconstructionMode" in settings)
        je.set_common_settings(fd.common_settings)
        with jax.disable_jit():
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        frame = {"jax": {rt: np.asarray(jo[JRT(int(rt))])
                         for sig in ("diff", "spec") for rt in RESOURCES[kind][sig][1]}}
        for key, eng in engs.items():
            eng.set_common_settings(fd.common_settings)
            out = eng.denoise([0], pool)
            frame[key] = {rt: interop.tensor_to_numpy(out[rt])
                          for sig in (("spec",) if key == "spec" else ("diff", "spec"))
                          for rt in RESOURCES[kind][sig][1]}
        frames.append(frame)
    return frames


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_outputs_match_jax(config):
    """Every output of the port's specular and two-signal variants >= 60 dB against JAX on
    every frame, finite."""
    for i, frame in enumerate(run(config)):
        for key in ("spec", "both"):
            for rt, got in frame[key].items():
                want = frame["jax"][rt]
                assert got.shape == want.shape and np.isfinite(got).all()
                p = psnr(got, want)
                print(f"{config} {key} {rt.name} frame {i}: {p:.2f} dB")
                assert p >= PSNR_BAR_DB, f"{config} {key} {rt.name} frame {i}: {p:.2f} dB"
