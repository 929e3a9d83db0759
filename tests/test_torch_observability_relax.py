"""RELAX_DIFFUSE's OUT_VALIDATION overlay and printfAt probe through the port's Engine on the
CPU against the JAX Engine run op by op, 3 frames of the orbit scene at 64x48: frame 0 all zeros
on both sides, frames 1-2 >= 60 dB (viewports 0-4 and 8, the history length against 255), on
the port's own chain and from JAX's state carried across; RELAX emits no probe tag, so printfAt
gives {} and a SHOW tag None, as in the JAX package. The helpers and tolerances are
`tests/test_torch_observability.py`'s.

Run alone: python -m pytest tests/test_torch_observability_relax.py -q
"""

import functools

import torch

from nrdtpu_torch.engine import Engine as TEngine

from test_torch_observability import PROBE_AT, check_overlay_frames, run_pair

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def relax_frames():
    def debug(i, cs):
        cs.enableValidation = True
        cs.printfAt = PROBE_AT
    return run_pair("RELAX_DIFFUSE", 3, debug, show="reblur/ta/curvature")


def test_relax_overlay_matches_jax():
    """RELAX_DIFFUSE with the overlay (viewports 0-4 and 8, the history length of 255): frame 0
    all zeros, frames 1-2 >= 60 dB against JAX, on its own chain and from JAX's state."""
    check_overlay_frames(relax_frames())


def test_relax_probe_is_empty():
    """RELAX emits no tag: printfAt gives {} and its SHOW None, as in the JAX package."""
    for f in relax_frames():
        assert f["jprobe"] == {} and f["own"][TEngine.PROBE_KEY] == {}
        assert f["jshow"] is None and f["own"][TEngine.SHOW_KEY] is None
