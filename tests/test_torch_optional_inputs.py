"""The optional per-pixel inputs on the port's Engine against the JAX Engine (XLA path): 6
frames of the orbit scene at 128x96 with IN_DIFF_CONFIDENCE / IN_SPEC_CONFIDENCE (the three
`confidenceDriven*` settings at 1.0, so that the confidences relax the à-trous edge stopping
and slow the accumulation) and with IN_DISOCCLUSION_THRESHOLD_MIX, on RELAX_DIFFUSE,
RELAX_SPECULAR and REBLUR_DIFFUSE_SPECULAR.

The confidences are seeded ramps: a left-to-right ramp from 0.2 to 1 plus uniform noise of
+-0.1, clipped to [0, 1], made anew each frame; the threshold mix a seeded uniform [0, 1].
Bar: every output >= 60 dB PSNR against JAX on every frame, as the slices hold them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, replace

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
FRAMES = 6
PSNR_BAR_DB = 60.0
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
CONFIDENCE_DRIVEN = dict(confidenceDrivenRelaxationMultiplier=1.0,
                         confidenceDrivenLuminanceEdgeStoppingRelaxation=1.0,
                         confidenceDrivenNormalEdgeStoppingRelaxation=1.0)
OUTPUTS = {"DIFFUSE": JRT.OUT_DIFF_RADIANCE_HITDIST, "SPECULAR": JRT.OUT_SPEC_RADIANCE_HITDIST}


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def signals(denoiser, gen, fd):
    """The radiance inputs as the tests of each denoiser pack them."""
    out = {}
    if denoiser.startswith("RELAX"):
        for name, rt, noisy, hit in (
                ("DIFFUSE", JRT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist),
                ("SPECULAR", JRT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist)):
            if name in denoiser:
                out[rt] = tfe.relax_pack_radiance_hitdist(torch.from_numpy(noisy),
                                                          torch.from_numpy(hit)).numpy()
        return out
    vz = jnp.asarray(fd.view_z)
    dn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist), vz, jnp.asarray(HDP), 1.0)
    sn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.spec_hit_dist), vz, jnp.asarray(HDP),
                                      jnp.asarray(fd.roughness))
    out[JRT.IN_DIFF_RADIANCE_HITDIST] = np.asarray(
        jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), dn))
    out[JRT.IN_SPEC_RADIANCE_HITDIST] = np.asarray(
        jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.spec_noisy), sn))
    return out


def ramp(rng, h, w):
    r = np.linspace(0.2, 1.0, w, dtype=np.float32)[None, :] + rng.uniform(-0.1, 0.1, (h, w))
    return np.clip(r, 0.0, 1.0).astype(np.float32)


def run(denoiser, optional, settings):
    """6 frames through both Engines with the optional inputs named in `optional`; returns
    per frame and output the PSNR of the port against JAX."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser[denoiser]}, resource_size=SIZE)
    te = TEngine({0: Denoiser[denoiser]}, resource_size=SIZE, device="cpu")
    if settings:
        je.set_denoiser_settings(0, jreplace(je._settings[0], **settings))
        te.set_denoiser_settings(0, replace(te._settings[0], **settings))
    rng = np.random.default_rng(11)
    h, w = SIZE[1], SIZE[0]
    results = []
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                JRT.IN_MV: fd.mv, **signals(denoiser, gen, fd)}
        if "diff_confidence" in optional:
            pool[JRT.IN_DIFF_CONFIDENCE] = ramp(rng, h, w)
        if "spec_confidence" in optional:
            pool[JRT.IN_SPEC_CONFIDENCE] = ramp(rng, h, w)[:, ::-1].copy()
        if "threshold_mix" in optional:
            pool[JRT.IN_DISOCCLUSION_THRESHOLD_MIX] = rng.uniform(0.0, 1.0, (h, w)).astype(
                np.float32)
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], pool)
        to = te.denoise([0], {RT(int(k)): v for k, v in pool.items()})
        frame = {}
        for name, rt in OUTPUTS.items():
            if name in denoiser:
                got = interop.tensor_to_numpy(to[RT(int(rt))])
                assert np.isfinite(got).all()
                frame[name] = psnr(got, np.asarray(jo[rt]))
        results.append(frame)
    return results


CASES = {
    "RELAX_DIFFUSE-diff_confidence": ("RELAX_DIFFUSE", ("diff_confidence",), CONFIDENCE_DRIVEN),
    "RELAX_DIFFUSE-threshold_mix": ("RELAX_DIFFUSE", ("threshold_mix",), {}),
    "RELAX_SPECULAR-spec_confidence": ("RELAX_SPECULAR", ("spec_confidence",),
                                       CONFIDENCE_DRIVEN),
    "RELAX_SPECULAR-threshold_mix": ("RELAX_SPECULAR", ("threshold_mix",), {}),
    "REBLUR_DIFFUSE_SPECULAR-all": ("REBLUR_DIFFUSE_SPECULAR",
                                    ("diff_confidence", "spec_confidence", "threshold_mix"), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optional_inputs_match_jax(case):
    denoiser, optional, settings = CASES[case]
    for i, frame in enumerate(run(denoiser, optional, settings)):
        for name, p in frame.items():
            print(f"{case} frame {i} {name}: {p:.2f} dB against JAX")
            assert p >= PSNR_BAR_DB, f"{case} frame {i} {name}: {p:.2f} dB"
