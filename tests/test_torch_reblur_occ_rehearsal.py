"""Rehearsal on the CPU of the one-channel (occlusion) modes of the REBLUR kernels: H1
`smb_resolve.cu`, N3 `vmb_resolve.cu`, K12 `hitdist_recon.cu`, H2 `spatial_filter.cu`, H3
`history_fix.cu`, N4 `spatial_filter_fused.cu`, N5 `history_fix_fused.cu` and K23
`reblur_band.cu`, as they are in the tree, compiled as C++ by g++ through `tests/cuda_shim.h`
and bound through the same ctypes entry points as on the card (the machinery of
`tests/test_torch_kernel_rehearsal.py`). Each one-channel instance is held against its plain
version on the calls that the port's Engine makes on the CPU for REBLUR_DIFFUSE_OCCLUSION,
REBLUR_SPECULAR_OCCLUSION and REBLUR_DIFFUSE_SPECULAR_OCCLUSION (the band too) at 48x32 over 3
orbit frames, the inputs of `tests/test_torch_reblur_occ_slice.py`: a binary AO a signal,
different for the two signals, so that a kernel that swapped them fails. The histories are 0
on frame 0, so frames 1-2 give H1 and N3 history to sample (asserted); K12 runs on the AO with a
seeded 30 % of the geometry pixels zeroed, so that its refill bites (asserted).

Run alone: python -m pytest tests/test_torch_reblur_occ_rehearsal.py -q

Tolerance: that of `chip_smoke.py` on the card, |kernel - plain| <= 1e-4 + 1e-4 |plain| on all
but 1e-4 of the values.
"""


import pytest
import torch

from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM, replace

from test_torch_kernel_rehearsal import _hold, shared_library
from test_torch_reblur_occ_slice import frames_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (48, 32)
FRAMES = 3
FLIP_FRACTION = 1e-4
D, S, DS = ("REBLUR_DIFFUSE_OCCLUSION", "REBLUR_SPECULAR_OCCLUSION",
            "REBLUR_DIFFUSE_SPECULAR_OCCLUSION")
STAGES = ("blur", "post_blur")
# each recorded run: (variant, settings, NRDTPU_REBLUR_BAND, the wrappers it records, frames
# with hit-distance holes)
RUNS = {"D": (D, {}, False, ("smb_resolve", "spatial_filter", "history_fix"), False),
        "S": (S, {}, False, ("smb_resolve", "vmb_resolve", "spatial_filter", "history_fix"),
              False),
        "DS": (DS, {}, False, ("smb_resolve", "vmb_resolve", "spatial_filter_fused",
                               "history_fix_fused"), False),
        "DS_perf": (DS, dict(enablePerformanceMode=True), False, ("spatial_filter_fused",),
                    False),
        "DS_band": (DS, {}, True, ("reblur_band",), False),
        "DS_band_perf": (DS, dict(enablePerformanceMode=True), True, ("reblur_band",), False)}
for _v, _name in ((D, "D"), (S, "S"), (DS, "DS")):
    for _mode in ("AREA_3X3", "AREA_5X5"):
        RUNS[f"{_name}_{_mode.lower()}"] = (_v, dict(hitDistanceReconstructionMode=HM[_mode]),
                                            False, ("hitdist_recon",), True)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    return shared_library(tmp_path_factory)


def _record(variant, settings, band, names, holes):
    """Every call of the wrappers `names` over the frames, through the port's Engine on the
    CPU (where the wrappers run their plain versions)."""
    calls = {n: [] for n in names}
    eng = Engine({0: Denoiser[variant]}, resource_size=SIZE, device="cpu")
    eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))

    def recorder(n):
        wrapper = getattr(KM.MODULES[n], n)

        def rec(*a, **k):
            calls[n].append((a, k))
            return wrapper(*a, **k)
        return rec
    with pytest.MonkeyPatch.context() as mp:
        for n in names:
            mp.setattr(KM.MODULES[n], n, recorder(n))
        if band:
            mp.setenv("NRDTPU_REBLUR_BAND", "1")
        for cs, pool, _ in frames_of(FRAMES, size=SIZE, holes=holes):
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    return calls


@pytest.fixture(scope="module")
def calls():
    return {run: _record(*spec) for run, spec in RUNS.items()}


def _check(library, name, recorded, exact=()):
    # every call is a one-channel instance: its signal or history is (h, w, 1)
    assert recorded and all(any(getattr(x, "dim", lambda: 0)() == 3 and x.shape[-1] == 1
                                for x in a) for a, _ in recorded), name
    over, count, worst = _hold(library, name, recorded, exact)
    assert over <= FLIP_FRACTION * count, (f"{name}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("run", ["D", "S", "DS"])
def test_smb_resolve_occ_rehearsal(library, calls, run):
    """H1 `<kNSig, false, true>`: one signal (D, S) and two (DS), each (h, w, 1) bf16 history
    through the CatRom footprint; frames 1-2 sample a non-zero history, with both footprints."""
    recorded = calls[run]["smb_resolve"]
    assert len(recorded) == FRAMES
    for a, k in recorded[1:]:
        assert a[9].shape[-1] == 1 and bool((a[9] != 0).any())
        sampled = KM.MODULES["smb_resolve"].smb_resolve_ref(*a, **k)
        assert bool(sampled["allow_catrom"].any()) and not bool(sampled["allow_catrom"].all())
    _check(library, "smb_resolve", recorded, exact=("fbits", "allow_catrom"))


@pytest.mark.parametrize("run", ["S", "DS"])
def test_vmb_resolve_occ_rehearsal(library, calls, run):
    """N3's one-channel kernel (`vmb_resolve_occ_kernel`): the specular (h, w, 1) history at
    the virtual-motion footprint, non-zero on frames 1-2."""
    recorded = calls[run]["vmb_resolve"]
    assert len(recorded) == FRAMES
    assert all(bool((a[6] != 0).any()) for a, _ in recorded[1:])
    _check(library, "vmb_resolve", recorded, exact=("fbits_vmb", "allow_catrom"))


@pytest.mark.parametrize("mode", ["area_3x3", "area_5x5"])
@pytest.mark.parametrize("run", ["D", "S", "DS"])
def test_hitdist_recon_occ_rehearsal(library, calls, run, mode):
    """K12 `<kRadius, kSig, 0, true>` on the AO with holes: a quarter or more of the geometry
    pixels are 0 and refilled."""
    recorded = calls[f"{run}_{mode}"]["hitdist_recon"]
    assert len(recorded) == FRAMES
    for a, _ in recorded:
        sig = a[2] if a[2] is not None else a[3]
        geometry = a[0].abs() < 1e6
        assert float((sig[..., 0] == 0)[geometry].float().mean()) > 0.25
    _check(library, "hitdist_recon", recorded)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("run", ["D", "S"])
def test_spatial_filter_occ_rehearsal(library, calls, run, stage):
    """H2 `<., ., false, false, true, false>` by stage: Blur and PostBlur of the hit distance,
    the min hit-distance weight without sqrt(nlas)."""
    recorded = calls[run]["spatial_filter"]
    assert len(recorded) == FRAMES * len(STAGES)
    _check(library, "spatial_filter", recorded[STAGES.index(stage)::len(STAGES)])


@pytest.mark.parametrize("run", ["D", "S"])
def test_history_fix_occ_rehearsal(library, calls, run):
    """H3 `<1, kSig, false, true>`: the stride taps on the hit distance, the clamp with the hit
    distance as the luma and sigma scale 1."""
    recorded = calls[run]["history_fix"]
    assert len(recorded) == FRAMES
    _check(library, "history_fix", recorded)


@pytest.mark.parametrize("stage", STAGES + ("perf",))
def test_spatial_filter_fused_occ_rehearsal(library, calls, stage):
    """N4 `<., false, false, true, false>` by stage, and in performance mode: each signal's
    hit distance at its own taps."""
    recorded = calls["DS_perf" if stage == "perf" else "DS"]["spatial_filter_fused"]
    assert len(recorded) == FRAMES * len(STAGES)
    if stage != "perf":
        recorded = recorded[STAGES.index(stage)::len(STAGES)]
    _check(library, "spatial_filter_fused", recorded)


def test_history_fix_fused_occ_rehearsal(library, calls):
    """N5 `<1, false, true>`: each signal's taps and its occlusion clamp."""
    recorded = calls["DS"]["history_fix_fused"]
    assert len(recorded) == FRAMES
    _check(library, "history_fix_fused", recorded)


@pytest.mark.parametrize("run", ["DS_band", "DS_band_perf"])
def test_reblur_band_occ_rehearsal(library, calls, run):
    """K23 `<., ., false, true>`: the history fix, Blur and PostBlur phases on the one-channel
    signals."""
    recorded = calls[run]["reblur_band"]
    assert len(recorded) == FRAMES
    _check(library, "reblur_band", recorded)
