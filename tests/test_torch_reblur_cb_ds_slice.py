"""The REBLUR_DIFFUSE_SPECULAR checkerboard slices end to end: the JAX Engine (op by op, for the
reason `tests/test_torch_reblur_cb_slice.py` gives) and the PyTorch port's Engine on the CPU, 4
frames of the orbit scene at 64x48 with both signals at half width: BLACK, also with the port's
band (NRDTPU_REBLUR_BAND=1, set only while its engine runs) against the same JAX frames, and
WHITE. Bars as for the one-signal slices: every output >= 60 dB PSNR against JAX on every
frame, and each frame's PrePass (N4) in its checkerboard mode.
"""

import pytest
import torch

from nrdtpu_torch.settings import CheckerboardMode as CB

from test_torch_reblur_cb_slice import PSNR_BAR_DB, SIZE, psnr, run

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SLICES = {"BLACK": (CB.BLACK, True), "WHITE": (CB.WHITE, False)}


@pytest.fixture(scope="module")
def runs():
    return {name: run("REBLUR_DIFFUSE_SPECULAR", mode, band)
            for name, (mode, band) in SLICES.items()}


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_matches_jax(runs, name):
    for frame, r in enumerate(runs[name]):
        for sig, want in r["jax"].items():
            assert r["torch"][sig].shape == (SIZE[1], SIZE[0], 4)
            p = psnr(r["torch"][sig], want)
            assert p >= PSNR_BAR_DB, f"{name} frame {frame} {sig}: {p:.2f} dB"


def test_band_slice_matches_jax(runs):
    """REBLUR_DIFFUSE_SPECULAR in BLACK with NRDTPU_REBLUR_BAND=1: its checkerboard PrePass
    (N4) before the band launch."""
    for frame, r in enumerate(runs["BLACK"]):
        for sig, want in r["jax"].items():
            p = psnr(r["torch_band"][sig], want)
            assert p >= PSNR_BAR_DB, f"band frame {frame} {sig}: {p:.2f} dB"


@pytest.mark.parametrize("name", list(SLICES))
def test_prepass_runs_in_checkerboard_mode(runs, name):
    """Each frame's PrePass call of N4 takes the mode's parity; its Blur and PostBlur calls
    take none."""
    for r in runs[name]:
        assert r["cb"] == [int(SLICES[name][0]) - 1, None, None]
