"""REBLUR_DIFFUSE_SPECULAR with hit-distance reconstruction end to end: the JAX Engine (XLA
path) and the PyTorch port's Engine on the CPU, on orbit frames whose hit distance has holes
(`tests/test_torch_hdrecon.py` says how they are made). Both outputs >= 60 dB against JAX on
every frame, for AREA_3X3 (6 frames at 128x96) and AREA_5X5 (4 frames at 64x48).
"""

import numpy as np
import pytest
import torch

from test_torch_hdrecon import PSNR_BAR_DB, psnr, run

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

FRAMES = 6


@pytest.fixture(scope="module")
def runs():
    return run("REBLUR_DIFFUSE_SPECULAR", (128, 96), FRAMES, "AREA_3X3")


@pytest.mark.parametrize("frame", range(FRAMES))
@pytest.mark.parametrize("signal", ["diff", "spec"])
def test_area_3x3_matches_jax(runs, frame, signal):
    got, want = runs[frame]["torch"][signal], runs[frame]["jax"][signal]
    assert got.shape == want.shape and np.isfinite(got).all()
    p = psnr(got, want)
    assert p >= PSNR_BAR_DB, f"frame {frame} {signal}: {p:.2f} dB"


def test_area_5x5_matches_jax():
    for frame, r in enumerate(run("REBLUR_DIFFUSE_SPECULAR", (64, 48), 4, "AREA_5X5")):
        for sig in ("diff", "spec"):
            p = psnr(r["torch"][sig], r["jax"][sig])
            assert p >= PSNR_BAR_DB, f"frame {frame} {sig}: {p:.2f} dB"
