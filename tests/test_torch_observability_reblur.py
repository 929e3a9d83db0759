"""REBLUR_DIFFUSE_SPECULAR's OUT_VALIDATION overlay, printfAt probe and SHOW capture through the
port's Engine on the CPU against the JAX Engine run op by op, 3 frames of the orbit scene at
64x48, validation, printfAt at a geometry pixel and the SHOW tag
"reblur/ta/virtual_history_confidence" on together; and, on the port alone, the band switched
off under printfAt and SHOW (as the reference's `band_ok` does, `nrdtpu/passes/reblur/
denoiser.py:410-413`) and the outputs unchanged by the debug modes. The helpers and tolerances
are `tests/test_torch_observability.py`'s.

Run alone: python -m pytest tests/test_torch_observability_reblur.py -q
"""

import functools

import numpy as np
import pytest
import torch

from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, ResourceType as RT

from test_torch_observability import (PROBE_AT, SIZE, check_overlay_frames, check_probe,
                                      check_show, run_pair, scene)
from test_torch_rect_slice import rect_pool
from test_torch_relax_slice import CallCounter

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

DS = "REBLUR_DIFFUSE_SPECULAR"
TAGS = {"reblur/smb/footprint_quality", "reblur/smb/fbits", "reblur/ta/diff_accum_frames",
        "reblur/ta/spec_accum_frames", "reblur/ta/curvature", "reblur/ta/virtual_history_amount",
        "reblur/ta/hit_dist_for_tracking", "reblur/ta/surface_history_confidence",
        "reblur/ta/virtual_history_confidence", "reblur/ta/virtual_normal_confidence",
        "reblur/ta/virtual_roughness_confidence", "reblur/ta/virtual_parallax_confidence",
        "reblur/hfix/diff_fast_history", "reblur/hfix/spec_fast_history"}


@functools.lru_cache(maxsize=None)
def ds_frames():
    def debug(i, cs):
        cs.enableValidation = True
        cs.printfAt = PROBE_AT
    return run_pair(DS, 3, debug, show="reblur/ta/virtual_history_confidence")


def test_overlay_matches_jax():
    """Frame 0 all zeros, frames 1-2 >= 60 dB against JAX, on the port's own chain and from
    JAX's state; `persistent_mb` JAX's state's, the overlay included."""
    check_overlay_frames(ds_frames())


@pytest.mark.parametrize("frame,engine", [(0, "own"), (1, "carried"), (2, "carried")])
def test_probe_matches_jax(frame, engine):
    """The 14 tags of both signals, JAX's values at the probe pixel."""
    check_probe(ds_frames(), frame, engine)
    assert set(ds_frames()[frame]["jprobe"]) == TAGS


@pytest.mark.parametrize("frame,engine", [(0, "own"), (1, "carried"), (2, "carried")])
def test_show_matches_jax(frame, engine):
    """The SHOW plane: the rect-sized plane of the tag, JAX's values."""
    check_show(ds_frames(), frame, engine)


def _port_frames(n, band, debug, show=None):
    """The port's DS outputs, probe and kernel-module calls over n frames, with
    NRDTPU_REBLUR_BAND=`band` around its engine and `debug(cs)` setting the debug fields."""
    eng = TEngine({0: Denoiser[DS]}, resource_size=SIZE, device="cpu")
    eng.set_debug_show(show)
    out = []
    with pytest.MonkeyPatch.context() as mp, CallCounter() as calls:
        mp.setenv("NRDTPU_REBLUR_BAND", "1" if band else "0")
        for i in range(n):
            fd = scene().frame(i)
            cs = fd.common_settings
            cs.timeDeltaBetweenFrames = 16.66
            debug(cs)
            eng.set_common_settings(cs)
            out.append(eng.denoise([0], rect_pool(DS, fd, i)))
    return out, calls.counts


def _debug_all(cs):
    cs.enableValidation = True
    cs.printfAt = PROBE_AT


@pytest.mark.parametrize("mode", ["printf", "show"])
def test_band_off_under_probe_and_show(mode):
    """Under NRDTPU_REBLUR_BAND=1 a probe or a SHOW capture takes the three-launch chain: no
    reblur_band call, and the outputs, probe and SHOW plane equal to the chain's (max abs 0)."""
    def debug(cs):
        if mode == "printf":
            cs.printfAt = PROBE_AT
    show = "reblur/hfix/spec_fast_history" if mode == "show" else None
    band, band_calls = _port_frames(2, True, debug, show)
    chain, _ = _port_frames(2, False, debug, show)
    assert band_calls["reblur_band"] == 0 and band_calls["history_fix_fused"] == 2
    for b, c in zip(band, chain):
        assert b.keys() == c.keys()
        for k in c:
            if k == TEngine.PROBE_KEY:
                assert b[k].keys() == c[k].keys()
                assert all(torch.equal(b[k][t], c[k][t]) for t in c[k])
            else:
                assert torch.equal(b[k], c[k]), k


def test_debug_modes_leave_outputs_alone():
    """The overlay, the probe and the SHOW capture change no other output and no state plane:
    the same frames with them on and off give equal denoised outputs (max abs 0); the band
    still runs when they are off."""
    on, _ = _port_frames(3, True, _debug_all, "reblur/ta/curvature")
    off, calls = _port_frames(3, True, lambda cs: None)
    assert calls["reblur_band"] == 3
    for a, b in zip(on, off):
        assert set(a) - set(b) == {RT.OUT_VALIDATION, TEngine.PROBE_KEY, TEngine.SHOW_KEY}
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k.name)
