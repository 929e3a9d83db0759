"""Rehearsal on the CPU of the SH modes of the REBLUR kernels: H1 `smb_resolve.cu`, N3
`vmb_resolve.cu`, H2 `spatial_filter.cu`, H3 `history_fix.cu`, N4 `spatial_filter_fused.cu`, N5
`history_fix_fused.cu` and K23 `reblur_band.cu`, as they are in the tree, compiled as C++ by
g++ through `tests/cuda_shim.h` and bound through the same ctypes entry points as on the card
(the machinery of `tests/test_torch_kernel_rehearsal.py`). Each SH instance is held against its
plain version on the calls that the port's Engine makes on the CPU for REBLUR_DIFFUSE_SH,
REBLUR_SPECULAR_SH and REBLUR_DIFFUSE_SPECULAR_SH at 48x32 over 2 orbit frames (the SH
histories are 0 on frame 0, so frame 1 gives H1 and N3 history to sample), the inputs of
`tests/test_torch_reblur_sh_slice.py`: SH1 along a different direction field a signal, so that a
kernel that swapped the two signals' SH fails, and SH1's .w drawn per pixel, so that a kernel
that dropped a pass's rule for .w (kept by the specular filters, averaged by the history fix
and the diffuse filters) fails; H1 and N3 on frames whose footprints are both bicubic and
bilinear, where an SH read through the CatRom or at another origin fails.

Run alone: python -m pytest tests/test_torch_reblur_sh_rehearsal.py -q

Tolerance: that of `chip_smoke.py` on the card, |kernel - plain| <= 1e-4 + 1e-4 |plain| on all
but 1e-4 of the values.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.kernels import build
from nrdtpu_torch.settings import Denoiser, replace

from test_torch_kernel_rehearsal import SHIM, _hold, rewrite
from test_torch_reblur_sh_slice import SIZE, frames_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SOURCES = ("smb_resolve.cu", "vmb_resolve.cu", "spatial_filter.cu", "history_fix.cu",
           "spatial_filter_fused.cu", "history_fix_fused.cu", "reblur_band.cu")
FRAMES = 2
FLIP_FRACTION = 1e-4
D, S, DS = "REBLUR_DIFFUSE_SH", "REBLUR_SPECULAR_SH", "REBLUR_DIFFUSE_SPECULAR_SH"
STAGES = ("prepass", "blur", "post_blur")
# each recorded run: (variant, settings, NRDTPU_REBLUR_BAND) and the wrappers it records
RUNS = {"D": (D, {}, False, ("smb_resolve", "spatial_filter", "history_fix")),
        "S": (S, {}, False, ("smb_resolve", "vmb_resolve", "spatial_filter", "history_fix")),
        "S_anti_firefly": (S, dict(enableAntiFirefly=True), False, ("history_fix",)),
        "DS": (DS, {}, False, ("smb_resolve", "spatial_filter_fused", "history_fix_fused")),
        "DS_anti_firefly": (DS, dict(enableAntiFirefly=True), False, ("history_fix_fused",)),
        "DS_perf": (DS, dict(enablePerformanceMode=True), False, ("spatial_filter_fused",)),
        "DS_band": (DS, {}, True, ("reblur_band",)),
        "DS_band_anti_firefly": (DS, dict(enableAntiFirefly=True), True, ("reblur_band",))}


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the rehearsal compiles the CUDA sources as C++")
    d = tmp_path_factory.mktemp("sh_rehearsal")
    for stub in ("cuda_runtime.h", "cuda_bf16.h"):
        (d / stub).write_text("#pragma once\n")
    units = []  # smb_resolve.cu defines the library's nrd_error_string
    for name in SOURCES:
        src = rewrite((build.CSRC / name).read_text())
        assert "<<<" not in src and "extern __shared__" not in src, name
        units.append(d / name.replace(".cu", ".cpp"))
        units[-1].write_text(src)
    flags = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread", "-include",
             str(SHIM), f"-I{d}", f"-I{build.CSRC}"]
    jobs = [subprocess.Popen([gxx, *flags, "-c", str(u), "-o", str(u.with_suffix(".o"))],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for u in units]
    for u, p in zip(units, jobs):
        out = p.communicate()[0]
        assert p.returncode == 0, f"g++ {u.name}:\n{out[-4000:]}"
    so = d / "libshrehearsal.so"
    subprocess.run([gxx, "-shared", "-pthread", "-o", str(so),
                    *[str(u.with_suffix(".o")) for u in units]], check=True)
    lib = ctypes.CDLL(str(so))
    lib.nrd_error_string.argtypes = [ctypes.c_int]
    lib.nrd_error_string.restype = ctypes.c_char_p
    return lib


def _record(variant, settings, band, names):
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
        for cs, pool in frames_of(FRAMES):
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    return calls


@pytest.fixture(scope="module")
def calls():
    return {run: _record(*spec) for run, spec in RUNS.items()}


def _check(library, name, recorded, exact=()):
    # every call is an SH instance
    assert recorded and all(any(k.get(key) is not None for key in ("sh", "sh_history"))
                            for _, k in recorded), name
    over, count, worst = _hold(library, name, recorded, exact)
    assert over <= FLIP_FRACTION * count, (f"{name}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("run", ["D", "S", "DS"])
def test_smb_resolve_sh_rehearsal(library, calls, run):
    """H1 `<kNSig, true>`: one signal (D, S) and two (DS), each SH history sampled bilinear
    with the footprint's custom weights; both footprints occur on these frames."""
    recorded = calls[run]["smb_resolve"]
    assert len(recorded) == FRAMES
    bicubic = [bool(c["allow_catrom"].any()) and not bool(c["allow_catrom"].all())
               for c in (KM.MODULES["smb_resolve"].smb_resolve_ref(*a, **k)
                         for a, k in recorded[1:])]
    assert all(bicubic)
    _check(library, "smb_resolve", recorded, exact=("fbits", "allow_catrom"))


def test_vmb_resolve_sh_rehearsal(library, calls):
    """N3's SH kernel (`vmb_resolve_sh_kernel`): the specular SH history at the virtual-motion
    footprint."""
    recorded = calls["S"]["vmb_resolve"]
    assert len(recorded) == FRAMES
    _check(library, "vmb_resolve", recorded, exact=("fbits_vmb", "allow_catrom"))


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("run", ["D", "S"])
def test_spatial_filter_sh_rehearsal(library, calls, run, stage):
    """H2 `<., ., ., true, false>` by stage: the diffuse SH over four channels, the specular
    over three with the centre's .w (the PrePass's hitDistForTracking too)."""
    recorded = calls[run]["spatial_filter"]
    assert len(recorded) == FRAMES * len(STAGES)
    _check(library, "spatial_filter", recorded[STAGES.index(stage)::len(STAGES)])


@pytest.mark.parametrize("run", ["D", "S", "S_anti_firefly"])
def test_history_fix_sh_rehearsal(library, calls, run):
    """H3 `<1, kSig, true>`: the SH through the stride taps (four channels), passed through
    where the stride is 0, scaled to the clamped luma (with the ring)."""
    recorded = calls[run]["history_fix"]
    assert len(recorded) == FRAMES
    _check(library, "history_fix", recorded)


@pytest.mark.parametrize("stage", STAGES + ("perf",))
def test_spatial_filter_fused_sh_rehearsal(library, calls, stage):
    """N4 with SH by stage, and in performance mode: each signal's SH at its own taps."""
    recorded = calls["DS_perf" if stage == "perf" else "DS"]["spatial_filter_fused"]
    assert len(recorded) == FRAMES * len(STAGES)
    if stage != "perf":
        recorded = recorded[STAGES.index(stage)::len(STAGES)]
    _check(library, "spatial_filter_fused", recorded)


@pytest.mark.parametrize("run", ["DS", "DS_anti_firefly"])
def test_history_fix_fused_sh_rehearsal(library, calls, run):
    """N5 `<1, true>`: each signal's SH through its taps and its clamp."""
    recorded = calls[run]["history_fix_fused"]
    assert len(recorded) == FRAMES
    _check(library, "history_fix_fused", recorded)


@pytest.mark.parametrize("run", ["DS_band", "DS_band_anti_firefly"])
def test_reblur_band_sh_rehearsal(library, calls, run):
    """K23 with SH: the history fix, Blur and PostBlur phases carry each signal's SH."""
    recorded = calls[run]["reblur_band"]
    assert len(recorded) == FRAMES
    _check(library, "reblur_band", recorded)
