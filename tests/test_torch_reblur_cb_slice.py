"""The REBLUR checkerboard slices of one signal end to end: the JAX Engine and the PyTorch
port's Engine on the CPU, 4 frames of the orbit scene at 64x48 with the signals at half width
(the has-data pixel of each horizontal pair, `tests/test_reblur_full.py:244-250`):
REBLUR_DIFFUSE and REBLUR_SPECULAR in BLACK (REBLUR_DIFFUSE_SPECULAR in
`tests/test_torch_reblur_cb_ds_slice.py`).

The JAX Engine runs op by op (`jax.disable_jit`), each float32 step as its code writes it, as
the port and its kernels (`nvcc --fmad=false`) compute it. Jitted, XLA contracts multiply-adds
on the CPU, which moves a Poisson tap that lands exactly on a pixel edge into the other row:
frame 0's PrePass rotator is 45 degrees, and at the 1 px minimum radius, which every pixel
without data takes (its hit distance is zeroed), the diagonal taps land at half-pixel
offsets. Jitted, frame 0 of REBLUR_DIFFUSE falls below the 60 dB bar against the port and
against the JAX Engine op by op alike, and the later frames carry it in the history.

Bars: every output >= 60 dB PSNR against JAX on every frame, as for the other REBLUR slices;
each frame's PrePass runs in its checkerboard mode (`cb` = the mode's parity).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import CheckerboardMode as JCB
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, replace

from test_torch_reblur_cb import pool_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 4
PSNR_BAR_DB = 60.0
OUTPUTS = {"diff": JRT.OUT_DIFF_RADIANCE_HITDIST, "spec": JRT.OUT_SPEC_RADIANCE_HITDIST}
SLICES = {"REBLUR_DIFFUSE-BLACK": ("REBLUR_DIFFUSE", CB.BLACK, False),
          "REBLUR_SPECULAR-BLACK": ("REBLUR_SPECULAR", CB.BLACK, False)}
PREPASS = {"REBLUR_DIFFUSE": "spatial_filter", "REBLUR_SPECULAR": "spatial_filter",
           "REBLUR_DIFFUSE_SPECULAR": "spatial_filter_fused"}


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


@contextlib.contextmanager
def recording_cb(name, calls):
    """Each call of the wrapper `name` appends its `cb` to `calls`."""
    wrapper = getattr(KM.MODULES[name], name)

    def rec(*a, **k):
        cb = k.get("cb")  # N4's: a dict with the parity
        calls.append(cb["parity"] if isinstance(cb, dict) else cb)
        return wrapper(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(KM.MODULES[name], name, rec)
        yield


def run(denoiser, mode, band):
    """FRAMES frames through the JAX Engine (op by op), the port's Engine and, with `band`, the
    port's band engine; per frame the outputs of each by signal, and the `cb` of each wrapper
    call of the port's PrePass kernel."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser[denoiser]}, resource_size=SIZE)
    je.set_denoiser_settings(0, jreplace(je._settings[0], checkerboardMode=JCB[mode.name]))
    engines = {"torch": TEngine({0: Denoiser[denoiser]}, resource_size=SIZE, device="cpu")}
    if band:
        engines["torch_band"] = TEngine({0: Denoiser[denoiser]}, resource_size=SIZE,
                                        device="cpu")
    for eng in engines.values():
        eng.set_denoiser_settings(0, replace(eng._settings[0], checkerboardMode=mode))
    signals = [sig for sig, part in (("diff", "DIFFUSE"), ("spec", "SPECULAR"))
               if part in denoiser]
    frames = []
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        pool = pool_of(gen, fd, mode)
        je.set_common_settings(fd.common_settings)
        with jax.disable_jit():
            jo = je.denoise([0], pool)
        frame = dict(jax={sig: np.asarray(jo[OUTPUTS[sig]]) for sig in signals}, cb=[])
        for name, eng in engines.items():
            eng.set_common_settings(fd.common_settings)
            with contextlib.ExitStack() as stack:
                if name == "torch_band":
                    mp = stack.enter_context(pytest.MonkeyPatch.context())
                    mp.setenv("NRDTPU_REBLUR_BAND", "1")
                if name == "torch":
                    stack.enter_context(recording_cb(PREPASS[denoiser], frame["cb"]))
                to = eng.denoise([0], {RT(int(k)): v for k, v in pool.items()})
            frame[name] = {sig: interop.tensor_to_numpy(to[RT(int(OUTPUTS[sig]))])
                           for sig in signals}
        frames.append(frame)
    return frames


@pytest.fixture(scope="module")
def runs():
    return {name: run(*spec) for name, spec in SLICES.items()}


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_matches_jax(runs, name):
    for frame, r in enumerate(runs[name]):
        for sig, want in r["jax"].items():
            assert r["torch"][sig].shape == (SIZE[1], SIZE[0], 4)
            p = psnr(r["torch"][sig], want)
            assert p >= PSNR_BAR_DB, f"{name} frame {frame} {sig}: {p:.2f} dB"


@pytest.mark.parametrize("name", list(SLICES))
def test_prepass_runs_in_checkerboard_mode(runs, name):
    """Each frame's PrePass call takes the mode's parity; Blur and PostBlur (H2's other calls)
    take none."""
    mode = SLICES[name][1]
    for r in runs[name]:
        assert r["cb"][0] == int(mode) - 1
        assert all(cb is None for cb in r["cb"][1:])
