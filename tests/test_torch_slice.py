"""The slice end to end: REBLUR_DIFFUSE through the JAX Engine (XLA path) and through the
PyTorch port's Engine on the CPU, 6 frames of the orbit scene at 128x96.

Bars: OUT_DIFF_RADIANCE_HITDIST >= 60 dB PSNR against JAX on every frame (the passes agree to
~1e-6 relative each; across frames the bf16 history re-quantization can round a value the
other way, which the feedback then carries), diff_accum equal on >= 99.9 % of pixels, and
every state plane keeps its storage dtype (bf16 histories).
"""

import numpy as np
import pytest
import torch

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


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _run(size, n_frames, **settings):
    """n_frames of the orbit scene through both Engines, optionally with ReblurSettings
    fields changed."""
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser.REBLUR_DIFFUSE}, resource_size=size)
    te = TEngine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=size, device="cpu")
    if settings:
        je.set_denoiser_settings(0, replace(je._settings[0], **settings))
        te.set_denoiser_settings(0, replace(te._settings[0], **settings))
    frames = []
    for i in range(n_frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        nhd = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist),
                                           jnp.asarray(fd.view_z), jnp.asarray(HDP), 1.0)
        sig = np.asarray(jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), nhd))
        pool = {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                JRT.IN_MV: fd.mv, JRT.IN_DIFF_RADIANCE_HITDIST: sig}
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = np.asarray(je.denoise([0], pool)[JRT.OUT_DIFF_RADIANCE_HITDIST])
        to = te.denoise([0], {RT(int(k)): v for k, v in pool.items()})
        frames.append(dict(jax=jo, torch=interop.tensor_to_numpy(to[RT.OUT_DIFF_RADIANCE_HITDIST]),
                           jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
                           tstate=dict(te.get_state(0))))
    return frames


@pytest.fixture(scope="module")
def runs():
    return _run(SIZE, FRAMES)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_output_matches_jax(runs, frame):
    r = runs[frame]
    assert r["torch"].shape == r["jax"].shape and np.isfinite(r["torch"]).all()
    p = psnr(r["torch"], r["jax"])
    assert p >= PSNR_BAR_DB, f"frame {frame}: {p:.2f} dB"


def test_accum_speed_matches(runs):
    for r in runs:
        got = interop.tensor_to_numpy(r["tstate"]["diff_accum"])
        eq = np.mean(got == r["jstate"]["diff_accum"])
        assert eq >= 0.999, eq


def test_state_dtypes_preserved(runs):
    for r in runs:
        assert r["tstate"].keys() == r["jstate"].keys()
        for k, v in r["tstate"].items():
            assert str(v.dtype).split(".")[-1] == r["jstate"][k].dtype.name, k


@pytest.mark.parametrize("settings,frames", [
    (dict(enablePerformanceMode=True), 3),
    (dict(diffusePrepassBlurRadius=0.0), 3),
    (dict(maxStabilizedFrameNum=0), 3),
    (dict(historyFixFrameNum=0), 4),
    (dict(minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0), 4),
    (dict(maxAccumulatedFrameNum=10, maxFastAccumulatedFrameNum=2), 4),
], ids=["performance_mode", "no_prepass", "no_stabilization", "history_fix_frame_num_0",
        "min_material_0", "max_accumulated_10_2"])
def test_settings_paths_match_jax(settings, frames):
    """The other settings paths the port runs: 6-tap spatial filters, PrePass off, TS off (3
    frames); and the settings whose math H2 and H3 take in (4 frames; ROADMAP.md, Queue 3's
    probe table): historyFixFrameNum 0, both min materials 0, max accumulated frames 10 / 2."""
    for frame, r in enumerate(_run((64, 48), frames, **settings)):
        p = psnr(r["torch"], r["jax"])
        assert p >= PSNR_BAR_DB, f"frame {frame}: {p:.2f} dB"
