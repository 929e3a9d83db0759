"""REBLUR_DIFFUSE's printfAt probe and SHOW capture ("reblur/hfix/diff_fast_history") and
REBLUR_DIFFUSE_OCCLUSION's OUT_VALIDATION overlay (a one-channel input, its hit-distance
viewport reading the AO) through the port's Engine on the CPU against the JAX Engine run op by
op, at 64x48: the diffuse-only defaults of the tags (the previous spec_accum, zero curvature and
virtual history, no hit distance for tracking) and the overlay's frames 0-2. The helpers and
tolerances are `tests/test_torch_observability.py`'s.

Run alone: python -m pytest tests/test_torch_observability_modes.py -q
"""

import functools

import pytest
import torch

from test_torch_observability import (PROBE_AT, check_overlay_frames, check_probe, check_show,
                                      run_pair)

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

DIFFUSE_TAGS = {"reblur/smb/footprint_quality", "reblur/smb/fbits",
                "reblur/ta/diff_accum_frames", "reblur/ta/spec_accum_frames",
                "reblur/ta/curvature", "reblur/ta/virtual_history_amount",
                "reblur/hfix/diff_fast_history"}


@functools.lru_cache(maxsize=None)
def diffuse_frames():
    def debug(i, cs):
        cs.printfAt = PROBE_AT
    return run_pair("REBLUR_DIFFUSE", 2, debug, show="reblur/hfix/diff_fast_history")


@functools.lru_cache(maxsize=None)
def occlusion_frames():
    def debug(i, cs):
        cs.enableValidation = True
    return run_pair("REBLUR_DIFFUSE_OCCLUSION", 3, debug)


@pytest.mark.parametrize("frame,engine", [(0, "own"), (1, "carried")])
def test_diffuse_probe_matches_jax(frame, engine):
    frames = diffuse_frames()
    check_probe(frames, frame, engine)
    assert set(frames[frame]["jprobe"]) == DIFFUSE_TAGS


@pytest.mark.parametrize("frame,engine", [(0, "own"), (1, "carried")])
def test_diffuse_show_matches_jax(frame, engine):
    check_show(diffuse_frames(), frame, engine)
    assert diffuse_frames()[frame]["jshow"] is not None


def test_occlusion_overlay_matches_jax():
    check_overlay_frames(occlusion_frames())
