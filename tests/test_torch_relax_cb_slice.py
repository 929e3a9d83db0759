"""The one-signal RELAX checkerboard slices end to end: RELAX_DIFFUSE and RELAX_SPECULAR in
WHITE, the JAX Engine and the PyTorch port's Engine on the CPU, 4 frames of the orbit scene at
64x48 with the signal at half width (`tests/test_torch_relax_cb.py` has the inputs, the passes
and RELAX_DIFFUSE_SPECULAR in BLACK). Bar: the output >= 60 dB PSNR against JAX on every
frame.
"""

import pytest
import torch

from nrdtpu_torch.settings import CheckerboardMode as CB

from test_torch_relax_cb import PSNR_BAR_DB, slice_psnrs

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)


@pytest.mark.parametrize("denoiser", ["RELAX_DIFFUSE", "RELAX_SPECULAR"])
def test_slice_matches_jax(denoiser):
    for i, frame in enumerate(slice_psnrs(denoiser, CB.WHITE)):
        for sig, p in frame.items():
            assert p >= PSNR_BAR_DB, f"{denoiser} frame {i} {sig}: {p:.2f} dB"
