"""REFERENCE (plain temporal accumulation) through the port's Engine on the CPU against the JAX
Engine, frame by frame, on inputs made from a seed.

Each scenario runs 6 frames: a static camera with the split screen moved in from frame 3; a
camera change at frame 3 (frames of another camera), which resets the accumulation counter,
and a still camera after it; maxAccumulatedFrameNum=2, which caps the counter; and
AccumulationMode.RESTART at frame 3. Outputs and histories agree to 1e-6 (both sides run the
same float32 lerp; XLA may contract it).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import AccumulationMode as JAccumulationMode
from nrdtpu.settings import Denoiser as JDenoiser, ReferenceSettings as JReferenceSettings
from nrdtpu.settings import ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch.engine import Engine
from nrdtpu_torch.settings import AccumulationMode, Denoiser, ReferenceSettings
from nrdtpu_torch.settings import ResourceType as RT

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (96, 64)
FRAMES = 6
ATOL = 1e-6


def _frames(scenario):
    """(common settings, signal) of each frame; the signal is the scene's noisy radiance and
    hit distance."""
    still = SceneGenerator(SceneSpec(size=SIZE, noise=0.5, seed=1), camera_mode="static")
    moved = SceneGenerator(SceneSpec(size=SIZE, noise=0.5, seed=1), camera_mode="orbit")
    for i in range(FRAMES):
        fd = still.frame(i)
        cs = fd.common_settings
        if scenario == "camera_change" and i >= 3:
            # another camera from frame 3 on, still after it: from frame 4 its previous
            # matrices are its current ones
            cs = dataclasses.replace(moved.frame(5).common_settings, frameIndex=cs.frameIndex)
            if i > 3:
                cs = dataclasses.replace(
                    cs, viewToClipMatrixPrev=cs.viewToClipMatrix,
                    worldToViewMatrixPrev=cs.worldToViewMatrix, cameraJitterPrev=cs.cameraJitter)
        if scenario == "split_screen" and i >= 3:
            cs.splitScreen = 0.4
        if scenario == "restart" and i == 3:
            cs.accumulationMode = JAccumulationMode.RESTART
        yield cs, np.concatenate([fd.diff_noisy, fd.diff_hit_dist[..., None]], -1)


@pytest.mark.parametrize("scenario", ["split_screen", "camera_change", "max_frames", "restart"])
def test_reference_matches_jax(scenario):
    je = JEngine({0: JDenoiser.REFERENCE}, resource_size=SIZE)
    te = Engine({0: Denoiser.REFERENCE}, resource_size=SIZE, device="cpu")
    if scenario == "max_frames":
        je.set_denoiser_settings(0, JReferenceSettings(maxAccumulatedFrameNum=2))
        te.set_denoiser_settings(0, ReferenceSettings(maxAccumulatedFrameNum=2))
    counters = []
    for cs, signal in _frames(scenario):
        je.set_common_settings(cs)
        te.set_common_settings(cs)
        want = np.asarray(je.denoise([0], {JRT.IN_SIGNAL: signal})[JRT.OUT_SIGNAL])
        got = te.denoise([0], {RT.IN_SIGNAL: signal})[RT.OUT_SIGNAL]
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(te.get_state(0)["history"].numpy(),
                                   np.asarray(je.get_state(0)["history"]), atol=ATOL, rtol=0)
        counters.append(te._instances[0]._accumulated_frame_num)
        assert counters[-1] == je._instances[0]._accumulated_frame_num
    expected = {"split_screen": [0, 1, 2, 3, 4, 5], "camera_change": [0, 1, 2, 0, 1, 2],
                "max_frames": [0, 1, 2, 2, 2, 2], "restart": [0, 1, 2, 0, 1, 2]}[scenario]
    assert counters == expected


def test_split_screen_passes_the_input_left():
    eng = Engine({0: Denoiser.REFERENCE}, resource_size=SIZE, device="cpu")
    frames = list(_frames("split_screen"))
    for cs, signal in frames:
        eng.set_common_settings(cs)
        out = eng.denoise([0], {RT.IN_SIGNAL: signal})[RT.OUT_SIGNAL].numpy()
    left = int(0.4 * SIZE[0])
    np.testing.assert_array_equal(out[:, :left], frames[-1][1][:, :left])
    assert not np.array_equal(out[:, left + 1:], frames[-1][1][:, left + 1:])


def test_clear_and_restart_clears_the_history():
    eng = Engine({0: Denoiser.REFERENCE}, resource_size=SIZE, device="cpu")
    for i, (cs, signal) in enumerate(_frames("split_screen")):
        if i == 4:
            cs.accumulationMode = AccumulationMode.CLEAR_AND_RESTART
        eng.set_common_settings(cs)
        out = eng.denoise([0], {RT.IN_SIGNAL: signal})[RT.OUT_SIGNAL]
        if i == 4:
            np.testing.assert_array_equal(out.numpy(), signal)
