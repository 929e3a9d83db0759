"""The SIGMA slices end to end: SIGMA_SHADOW and SIGMA_SHADOW_TRANSLUCENCY through the JAX
Engine (XLA path) and through the PyTorch port's Engine on the CPU, 6 frames of the orbit
scene at 128x96, with temporal stabilization and with `maxStabilizedFrameNum=0`, and
SIGMA_SHADOW with `isMotionVectorInWorldSpace=True` and IN_MV zeroed (the true world motion of
the scene's static geometry: TS reprojects through world_to_clip_prev); then
`tests/test_sigma.py`'s behavioural checks on the port.

Bars: OUT_SHADOW_TRANSLUCENCY >= 60 dB PSNR against JAX on every frame (the passes agree to
~1e-6 each; across frames the bf16 history re-quantization can round a value the other way,
and the TS clamp of a vanishing variance amplifies last bits, see
`tests/test_torch_sigma_passes.py`), history length equal on >= 99.9 % of pixels, and the
same state keys with the same storage dtypes.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.settings import SigmaSettings as JSigmaSettings
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, SigmaSettings

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
FRAMES = 6
PSNR_BAR_DB = 60.0
TRANSLUCENCY_RGB = np.array([0.3, 0.6, 0.2], np.float32)
VARIANTS = ("SIGMA_SHADOW", "SIGMA_SHADOW_TRANSLUCENCY")


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def sigma_pool(gen, fd, translucent):
    """The inputs as tests/test_sigma.py packs them (numpy)."""
    pen = tfe.sigma_pack_penumbra_directional(torch.from_numpy(fd.dist_to_occluder),
                                              gen.spec.light_tan_angular_radius).numpy()
    pool = {RT.IN_PENUMBRA: pen, RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
            RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd)}
    if translucent:
        rgb = torch.from_numpy(TRANSLUCENCY_RGB).expand(fd.view_z.shape + (3,))
        pool[RT.IN_TRANSLUCENCY] = tfe.sigma_pack_translucency(
            torch.from_numpy(fd.dist_to_occluder), rgb).numpy()
    return pool


def run(variant, max_stabilized, world_mv=False):
    gen = SceneGenerator(SceneSpec(size=SIZE), camera_mode="orbit")
    je = JEngine({0: JDenoiser[variant]}, resource_size=SIZE)
    te = TEngine({0: Denoiser[variant]}, resource_size=SIZE, device="cpu")
    je.set_denoiser_settings(0, JSigmaSettings(maxStabilizedFrameNum=max_stabilized))
    te.set_denoiser_settings(0, SigmaSettings(maxStabilizedFrameNum=max_stabilized))
    frames = []
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        if world_mv:
            fd.common_settings.isMotionVectorInWorldSpace = True
            fd.mv = np.zeros_like(fd.mv)
        pool = sigma_pool(gen, fd, variant == "SIGMA_SHADOW_TRANSLUCENCY")
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        to = te.denoise([0], pool)
        frames.append(dict(jax=np.asarray(jo[JRT.OUT_SHADOW_TRANSLUCENCY]),
                           torch=interop.tensor_to_numpy(to[RT.OUT_SHADOW_TRANSLUCENCY]),
                           jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
                           tstate=dict(te.get_state(0))))
    return frames


RUNS = {f"{v}-{s}": (v, m) for v in VARIANTS for s, m in (("stabilized", 5),
                                                          ("no_stabilization", 0))}
RUNS["SIGMA_SHADOW-world_mv"] = ("SIGMA_SHADOW", 5, True)


@pytest.fixture(scope="module", params=list(RUNS.values()), ids=list(RUNS))
def runs(request):
    return run(*request.param)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_output_matches_jax(runs, frame):
    r = runs[frame]
    assert r["torch"].shape == r["jax"].shape and np.isfinite(r["torch"]).all()
    p = psnr(r["torch"], r["jax"])
    assert p >= PSNR_BAR_DB, f"frame {frame}: {p:.2f} dB"


def test_state_matches_jax(runs):
    for r in runs:
        assert r["tstate"].keys() == r["jstate"].keys()
        for k, v in r["tstate"].items():
            assert str(v.dtype).split(".")[-1] == r["jstate"][k].dtype.name, k
        eq = np.mean(interop.tensor_to_numpy(r["tstate"]["history_len"])
                     == r["jstate"]["history_len"])
        assert eq >= 0.999, eq


# --- tests/test_sigma.py:47-121 on the port -----------------------------------------------


@pytest.fixture(scope="module")
def scene():
    return SceneGenerator(SceneSpec(size=SIZE), camera_mode="static")


def run_frames(gen, n_frames, settings=None, denoiser=Denoiser.SIGMA_SHADOW, split=0.0):
    eng = TEngine({0: denoiser}, resource_size=SIZE, device="cpu")
    if settings is not None:
        eng.set_denoiser_settings(0, settings)
    out = None
    for i in range(n_frames):
        fd = gen.frame(i)
        fd.common_settings.splitScreen = split
        eng.set_common_settings(fd.common_settings)
        out = eng.denoise([0], sigma_pool(gen, fd, denoiser == Denoiser.SIGMA_SHADOW_TRANSLUCENCY))
    return out[RT.OUT_SHADOW_TRANSLUCENCY].numpy(), eng


def test_runs_and_is_finite(scene):
    out, _ = run_frames(scene, 2)
    assert out.shape == (SIZE[1], SIZE[0], 1)
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0


def test_fully_lit_stays_lit():
    gen = SceneGenerator(SceneSpec(size=SIZE, spheres=()), camera_mode="static")
    out, _ = run_frames(gen, 3)
    fd = gen.frame(0)
    lit = (fd.hit_mask > 0) & (fd.shadow_clean > 0.5)
    assert (out[..., 0] ** 2)[lit].min() > 0.99


def test_umbra_core_stays_dark_and_edges_soften(scene):
    out, _ = run_frames(scene, 4)
    fd = scene.frame(3)
    shadow = out[..., 0] ** 2
    hard = fd.shadow_clean
    core = (ndimage.minimum_filter(1.0 - hard, size=9) > 0.5) & (fd.hit_mask > 0)
    if core.any():  # as tests/test_sigma.py: this small frame may have no 9x9 umbra
        assert shadow[core].max() < 0.15
    edge_in = ((hard > 0.05) & (hard < 0.95)).sum()
    edge_out = ((shadow > 0.05) & (shadow < 0.95) & (fd.hit_mask > 0)).sum()
    assert edge_out > edge_in


def test_history_length_grows_on_static_camera(scene):
    _, eng = run_frames(scene, 10)
    hist_len = eng.get_state(0)["history_len"].numpy()
    assert np.median(hist_len[scene.frame(0).hit_mask > 0]) == 7.0


def test_no_stabilization_when_disabled(scene):
    out, _ = run_frames(scene, 3, settings=SigmaSettings(maxStabilizedFrameNum=0))
    assert np.isfinite(out).all()


def test_split_screen(scene):
    out, _ = run_frames(scene, 1, split=0.5)
    left = out[:, : SIZE[0] // 2, 0]
    assert np.logical_or(np.abs(left) < 1e-6, np.abs(left - 1.0) < 1e-6).all()


def test_translucency_channels_flow_through(scene):
    out, _ = run_frames(scene, 3, denoiser=Denoiser.SIGMA_SHADOW_TRANSLUCENCY)
    assert out.shape == (SIZE[1], SIZE[0], 4) and np.isfinite(out).all()
    fd = scene.frame(2)
    lit = (fd.shadow_clean > 0.5) & (fd.hit_mask > 0)
    assert (out[..., 0] ** 2)[lit].mean() > 0.8


def test_front_end_packs_as_jax(scene):
    """The inputs above come from the port's front end; they equal the JAX package's."""
    fd = scene.frame(0)
    ours = sigma_pool(scene, fd, True)
    dist = jnp.asarray(fd.dist_to_occluder)
    np.testing.assert_array_equal(ours[RT.IN_PENUMBRA], np.asarray(
        jfe.sigma_pack_penumbra_directional(dist, scene.spec.light_tan_angular_radius)))
    rgb = jnp.broadcast_to(jnp.asarray(TRANSLUCENCY_RGB), fd.view_z.shape + (3,))
    np.testing.assert_array_equal(ours[RT.IN_TRANSLUCENCY],
                                  np.asarray(jfe.sigma_pack_translucency(dist, rgb)))
