"""The REBLUR_DIFFUSE_SPECULAR slice end to end: the JAX Engine (XLA path, per-signal stages)
and the PyTorch port's Engine on the CPU (fused stages, two-signal TA), 6 frames of the
orbit scene at 128x96.

The port also runs the band (NRDTPU_REBLUR_BAND=1, set only while its engine runs: HistoryFix,
Blur and PostBlur in one `reblur_band` launch) on the same frames, held against the same JAX
frames; JAX runs its default path once for both.

Bars, as for the one-signal slices: OUT_DIFF_RADIANCE_HITDIST and OUT_SPEC_RADIANCE_HITDIST
each >= 60 dB PSNR against JAX on every frame (the passes agree to ~1e-6 relative each;
across frames the bf16 history re-quantization can round a value the other way, which the
feedback then carries), diff_accum and spec_accum equal on >= 99.9 % of pixels, and the same
state keys with the same storage dtypes. The settings paths run 4 frames at 64x48 with the
setting changed from frame 2 on.
"""

import numpy as np
import pytest
import torch

from nrdtpu_torch import kernels as KM

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT, replace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, ResourceType as RT

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
FRAMES = 6
PSNR_BAR_DB = 60.0
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
OUTPUTS = {"diff": JRT.OUT_DIFF_RADIANCE_HITDIST, "spec": JRT.OUT_SPEC_RADIANCE_HITDIST}


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _pool(gen, fd):
    vz = jnp.asarray(fd.view_z)
    dn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist), vz, jnp.asarray(HDP), 1.0)
    sn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.spec_hit_dist), vz, jnp.asarray(HDP),
                                      jnp.asarray(fd.roughness))
    return {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv,
            JRT.IN_DIFF_RADIANCE_HITDIST: np.asarray(
                jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), dn)),
            JRT.IN_SPEC_RADIANCE_HITDIST: np.asarray(
                jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.spec_noisy), sn))}


# the band's kernel and the kernels it replaces, counted a frame on the band path
BAND_WRAPPERS = ("reblur_band", "spatial_filter_fused", "history_fix_fused")


def _run_band(engine, pool, counts):
    """One frame of the port's band engine: NRDTPU_REBLUR_BAND=1 only while it runs, with the
    wrappers of BAND_WRAPPERS counting their calls (on the CPU `launches` stays 0)."""
    originals = {n: getattr(KM.MODULES[n], n) for n in BAND_WRAPPERS}
    counts.append(dict.fromkeys(BAND_WRAPPERS, 0))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("NRDTPU_REBLUR_BAND", "1")
            for n in BAND_WRAPPERS:
                def rec(*a, _n=n, **k):
                    counts[-1][_n] += 1
                    return originals[_n](*a, **k)
                mp.setattr(KM.MODULES[n], n, rec)
            return engine.denoise([0], pool)
    finally:
        for n in BAND_WRAPPERS:
            setattr(KM.MODULES[n], n, originals[n])


def run(denoiser, size, n_frames, settings=None, from_frame=0, band=False):
    """n_frames of the orbit scene through both Engines; from frame `from_frame` on, the
    ReblurSettings fields in `settings` are changed on both. With `band`, a second port
    Engine runs the same frames with NRDTPU_REBLUR_BAND=1. Returns per frame the outputs
    of both (and of the band: "torch_band", with its wrapper calls "band_calls"), by signal,
    and both states."""
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser[denoiser]}, resource_size=size)
    te = TEngine({0: Denoiser[denoiser]}, resource_size=size, device="cpu")
    tb = TEngine({0: Denoiser[denoiser]}, resource_size=size, device="cpu") if band else None
    band_calls = []
    signals = [sig for sig, name in (("diff", "DIFFUSE"), ("spec", "SPECULAR"))
               if name in denoiser]
    frames = []
    for i in range(n_frames):
        if settings and i == from_frame:
            je.set_denoiser_settings(0, replace(je._settings[0], **settings))
            te.set_denoiser_settings(0, replace(te._settings[0], **settings))
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = _pool(gen, fd)
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], pool)
        to = te.denoise([0], {RT(int(k)): v for k, v in pool.items()})
        frames.append(dict(
            jax={sig: np.asarray(jo[OUTPUTS[sig]]) for sig in signals},
            torch={sig: interop.tensor_to_numpy(to[RT(int(OUTPUTS[sig]))]) for sig in signals},
            jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
            tstate=dict(te.get_state(0))))
        if band:
            tb.set_common_settings(fd.common_settings)
            bo = _run_band(tb, {RT(int(k)): v for k, v in pool.items()}, band_calls)
            frames[-1].update(
                torch_band={sig: interop.tensor_to_numpy(bo[RT(int(OUTPUTS[sig]))])
                            for sig in signals}, band_calls=band_calls[-1])
    return frames


@pytest.fixture(scope="module")
def runs():
    return run("REBLUR_DIFFUSE_SPECULAR", SIZE, FRAMES, band=True)


@pytest.mark.parametrize("frame", range(FRAMES))
@pytest.mark.parametrize("signal", ["diff", "spec"])
def test_output_matches_jax(runs, frame, signal):
    r = runs[frame]
    got, want = r["torch"][signal], r["jax"][signal]
    assert got.shape == want.shape and np.isfinite(got).all()
    p = psnr(got, want)
    assert p >= PSNR_BAR_DB, f"frame {frame} {signal}: {p:.2f} dB"


@pytest.mark.parametrize("frame", range(FRAMES))
@pytest.mark.parametrize("signal", ["diff", "spec"])
def test_band_output_matches_jax(runs, frame, signal):
    """The port's band path against the same JAX frames (JAX's default three-stage path)."""
    r = runs[frame]
    got, want = r["torch_band"][signal], r["jax"][signal]
    assert got.shape == want.shape and np.isfinite(got).all()
    p = psnr(got, want)
    assert p >= PSNR_BAR_DB, f"band frame {frame} {signal}: {p:.2f} dB"


def test_band_launches_one_kernel_a_frame(runs):
    """A band frame calls reblur_band once and spatial_filter_fused once (the PrePass), and
    history_fix_fused never."""
    for r in runs:
        assert r["band_calls"] == {"reblur_band": 1, "spatial_filter_fused": 1,
                                   "history_fix_fused": 0}


def test_accum_speed_matches(runs):
    for r in runs:
        for key in ("diff_accum", "spec_accum"):
            eq = np.mean(interop.tensor_to_numpy(r["tstate"][key]) == r["jstate"][key])
            assert eq >= 0.999, (key, eq)


def test_state_keys_and_dtypes(runs):
    for r in runs:
        assert r["tstate"].keys() == r["jstate"].keys()
        for k, v in r["tstate"].items():
            assert str(v.dtype).split(".")[-1] == r["jstate"][k].dtype.name, k


@pytest.mark.parametrize("denoiser,settings", [
    ("REBLUR_DIFFUSE_SPECULAR", dict(enableAntiFirefly=True)),
    ("REBLUR_DIFFUSE", dict(enableAntiFirefly=True)),
    ("REBLUR_DIFFUSE_SPECULAR", dict(specularPrepassBlurRadius=0.0)),
], ids=["anti_firefly", "diffuse_anti_firefly", "specular_prepass_off"])
def test_settings_paths_match_jax(denoiser, settings):
    """The anti-firefly ring (HistoryFix) on the fused and the one-signal path, and a fused
    PrePass with one signal's radius at 0, from frame 2 on."""
    for frame, r in enumerate(run(denoiser, (64, 48), 4, settings, from_frame=2)):
        for sig in r["torch"]:
            p = psnr(r["torch"][sig], r["jax"][sig])
            assert p >= PSNR_BAR_DB, f"frame {frame} {sig}: {p:.2f} dB"
