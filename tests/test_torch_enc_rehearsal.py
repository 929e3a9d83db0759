"""Rehearsal on the CPU of the decoded-plane instances (`kDec`) of K12 `hitdist_recon.cu`, K13
`sigma_blur.cu`, K15 `relax_prepass.cu`, K16 `relax_smb_resolve.cu`, K17 `relax_vmb_resolve.cu`,
K19 `relax_history_fix.cu`, K21 `relax_antifirefly.cu` and K22 `relax_atrous.cu` (RELAX and
SIGMA), and of the REBLUR kernels H1 `smb_resolve.cu`, N1 `spec_ta_head.cu`, N3
`vmb_resolve.cu`, H2 `spatial_filter.cu`, H3 `history_fix.cu`, H4 `ts_prelude.cu`, N4
`spatial_filter_fused.cu`, N5 `history_fix_fused.cu`, K23 `reblur_band.cu` and K12's one-channel
`kOcc && kDec` instances, as they are in the tree, compiled as C++ by g++ through
`tests/cuda_shim.h` and bound through the same ctypes entry points as on the card (the
machinery of `tests/test_torch_kernel_rehearsal.py`); and K20 `relax_clamp_moments.cu` on NaN
inputs (`test_clamp_moments_keeps_nan`).

Each kernel is held against its plain version on every call that the port's Engine makes on
the CPU at 48x32 over 3 orbit frames (`RUNS`), IN_NORMAL_ROUGHNESS at an RGBA encoding
(`tests/test_torch_relax_enc_slice.py:frames_of`, the SNORM ones with the sky's normal
(0, 0, 1)): RELAX_DIFFUSE, RELAX_SPECULAR and RELAX_DIFFUSE_SPECULAR with the anti-firefly pass
and the hit-distance reconstruction on frames whose hit distance is zeroed on a seeded 30 % of
the pixels, at the three roughness encodings between them; RELAX_DIFFUSE_SH, RELAX_SPECULAR_SH
and RELAX_DIFFUSE_SPECULAR_SH; SIGMA_SHADOW and SIGMA_SHADOW_TRANSLUCENCY. Between them the
calls reach every kDec instance that RELAX and SIGMA launch (K16's two- and four-history modes
with and without SH, K17 with and without SH, K19's three phases, K21 with one and two
signals, K22's staged iteration 0 and the later strides at one and two signals, K12 at radius
1 and 2 on each signal count, K13's four modes). `test_plain_versions_see_the_mode` shows that
the plain versions give another result when they read the decoded plane as packed, so that an
instance that skipped its mode fails.

REBLUR (`REBLUR_RUNS`): the port's Engine on the CPU at 48x32 over 2 orbit frames,
IN_NORMAL_ROUGHNESS at an RGBA encoding (`tests/test_torch_reblur_enc_slice.py:pool_of`), every REBLUR variant among
the runs, with the band, checkerboard, performance mode, the anti-firefly ring, AREA_3X3 /
AREA_5X5 on hit distances with holes and the three roughness encodings between them. Each
kernel is held on the last frame's calls, one call of each mode (`_signature`: the call's
flags and its tensors' shapes), which between them reach every kDec instance that REBLUR
launches (`test_reblur_runs_reach_every_mode`).

Run alone: python -m pytest tests/test_torch_enc_rehearsal.py -q

Tolerance: that of `chip_smoke.py` on the card, |kernel - plain| <= 1e-4 + 1e-4 |plain| on all
but 1e-4 of the values.
"""

import enum

import numpy as np
import pytest
import torch

from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import NormalEncoding as NE, ResourceType as RT
from nrdtpu_torch.settings import RoughnessEncoding as RE, replace

from test_torch_kernel_rehearsal import _hold, kernels_on_cpu, shared_library
from test_torch_reblur_enc_slice import frames_of as reblur_frames_of
from test_torch_relax_enc_slice import frames_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (48, 32)
FRAMES = 3
FLIP_FRACTION = 1e-4
HOLE_FRACTION = 0.3
RELAX_DEC = ("relax_prepass", "relax_smb_resolve", "relax_vmb_resolve", "relax_history_fix",
             "relax_antifirefly", "relax_atrous", "hitdist_recon", "sigma_blur")
KERNELS = RELAX_DEC
AF = dict(enableAntiFirefly=True)
# name: (variant, normal encoding, roughness encoding, settings, hit-distance holes)
RUNS = {
    "RD": ("RELAX_DIFFUSE", "RGBA8_UNORM", "LINEAR",
           dict(AF, hitDistanceReconstructionMode=HM.AREA_3X3), True),
    "RS": ("RELAX_SPECULAR", "RGBA8_SNORM", "SQ_LINEAR",
           dict(AF, hitDistanceReconstructionMode=HM.AREA_5X5), True),
    "RDS": ("RELAX_DIFFUSE_SPECULAR", "RGBA16_UNORM", "SQRT_LINEAR",
            dict(AF, hitDistanceReconstructionMode=HM.AREA_3X3), True),
    "RDS_R2": ("RELAX_DIFFUSE_SPECULAR", "RGBA16_SNORM", "LINEAR",
               dict(hitDistanceReconstructionMode=HM.AREA_5X5), True),
    "RD_SH": ("RELAX_DIFFUSE_SH", "RGBA16_SNORM", "LINEAR", {}, False),
    "RS_SH": ("RELAX_SPECULAR_SH", "RGBA8_UNORM", "LINEAR", {}, False),
    "RDS_SH": ("RELAX_DIFFUSE_SPECULAR_SH", "RGBA8_SNORM", "SQ_LINEAR", {}, False),
    "SS": ("SIGMA_SHADOW", "RGBA8_SNORM", "LINEAR", {}, False),
    "ST": ("SIGMA_SHADOW_TRANSLUCENCY", "RGBA16_UNORM", "LINEAR", {}, False),
}
MIN_MATERIAL_0 = {"relax_vmb_resolve": dict(min_material=0.0),
                  "relax_antifirefly": dict(min_materials=[0.0, 0.0])}
# the kernels each run calls
CALLED = {name: ({"sigma_blur"} if v.startswith("SIGMA") else
                 {"relax_prepass", "relax_smb_resolve", "relax_history_fix", "relax_atrous"}
                 | ({"relax_vmb_resolve"} if "SPEC" in v else set())
                 | ({"relax_antifirefly"} if s.get("enableAntiFirefly") else set())
                 | ({"hitdist_recon"} if "hitDistanceReconstructionMode" in s else set()))
          for name, (v, _, _, s, _) in RUNS.items()}


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    return shared_library(tmp_path_factory)


def _punched(pool, frame):
    """The RELAX signals' hit distance zeroed on a seeded HOLE_FRACTION of the pixels that
    have one."""
    for rt in (RT.IN_DIFF_RADIANCE_HITDIST, RT.IN_SPEC_RADIANCE_HITDIST):
        if rt in pool:
            s = pool[rt].copy()
            hit = s[..., 3]
            hit[(np.random.default_rng((7, frame)).random(hit.shape) < HOLE_FRACTION)
                & (hit > 0)] = 0.0
            pool[rt] = s
    return pool


@pytest.fixture(scope="module")
def calls():
    """{run: {kernel: its calls}} through the port's Engine on the CPU."""
    out = {}
    for run, (variant, encoding, roughness, settings, holes) in RUNS.items():
        rec = {n: [] for n in KERNELS}
        eng = Engine({0: Denoiser[variant]}, resource_size=SIZE, normal_encoding=NE[encoding],
                     roughness_encoding=RE[roughness], device="cpu")
        eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))

        def recorder(n, wrapper):
            def r(*a, **k):
                rec[n].append((a, k))
                return wrapper(*a, **k)
            return r
        with pytest.MonkeyPatch.context() as mp:
            for n in KERNELS:
                mp.setattr(KM.MODULES[n], n, recorder(n, getattr(KM.MODULES[n], n)))
            for i, (cs, pool) in enumerate(frames_of(variant, encoding, roughness,
                                                     frames=FRAMES, size=SIZE)):
                eng.set_common_settings(cs)
                eng.denoise([0], _punched(pool, i) if holes else pool)
        out[run] = rec
    return out


@pytest.mark.parametrize("run,kernel", [(r, k) for r in RUNS for k in sorted(CALLED[r])])
def test_dec_instance_rehearsal(library, calls, run, kernel):
    recorded = calls[run][kernel]
    assert recorded and all(k["decoded"] for _, k in recorded), (run, kernel)
    mod = KM.MODULES[kernel]
    before = mod.dec_launches
    over, count, worst = _hold(library, kernel, recorded)
    assert mod.dec_launches == before + len(recorded)
    assert over <= FLIP_FRACTION * count, (f"{run} {kernel}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


def test_runs_call_only_their_kernels(calls):
    for run, rec in calls.items():
        assert {k for k, v in rec.items() if v} == CALLED[run], run


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_see_the_mode(calls, kernel):  # RELAX's and SIGMA's kernels
    """Read as packed R10G10B10A2 (`decoded=False`), the decoded plane gives another result
    than in the decoded mode, on the first call of the kernel that RELAX_DIFFUSE_SPECULAR (or
    SIGMA_SHADOW) makes. K17 and K21 read the plane for the material alone, which the default
    min materials of 4 hide: their calls take min materials of 0 here."""
    a, k = next(c for run in ("RDS", "RDS_R2", "SS") for c in calls[run][kernel])
    k = dict(k, **MIN_MATERIAL_0.get(kernel, {}))
    ref = getattr(KM.MODULES[kernel], kernel + "_ref")
    dec, packed = ref(*a, **k), ref(*a, **dict(k, decoded=False))
    flat = [(x, y) for x, y in zip(*[[v for v in (r.values() if isinstance(r, dict) else
                                                  r if isinstance(r, tuple) else (r,))]
                                     for r in (dec, packed)])]
    assert any(x is not None and not torch.allclose(x.float(), y.float(), rtol=1e-3, atol=1e-3)
               for x, y in flat), kernel


# ---------------------------------------------------------------------------------------------
# REBLUR
# ---------------------------------------------------------------------------------------------

REBLUR_FRAMES = 2
REBLUR_KERNELS = ("smb_resolve", "spec_ta_head", "vmb_resolve", "spatial_filter", "history_fix",
                  "ts_prelude", "spatial_filter_fused", "history_fix_fused", "reblur_band",
                  "hitdist_recon")
PERF = dict(enablePerformanceMode=True)
# TS's responsive factor reads the roughness only below the threshold, 0 by default
RESPONSIVE = dict(responsiveAccumulationRoughnessThreshold=0.5)
# name: (variant, normal encoding, roughness encoding, settings, band, hit-distance holes)
REBLUR_RUNS = {
    "DS": ("REBLUR_DIFFUSE_SPECULAR", "RGBA8_UNORM", "LINEAR",
           dict(AF, hitDistanceReconstructionMode=HM.AREA_3X3, **RESPONSIVE), False, True),
    "DS_BAND_PERF": ("REBLUR_DIFFUSE_SPECULAR", "RGBA16_SNORM", "SQ_LINEAR", PERF, True, False),
    "DS_CB": ("REBLUR_DIFFUSE_SPECULAR", "RGBA8_SNORM", "LINEAR", dict(checkerboardMode=CB.BLACK),
              False, False),
    "DS_SH": ("REBLUR_DIFFUSE_SPECULAR_SH", "RGBA16_UNORM", "LINEAR", {}, False, False),
    "DS_SH_BAND": ("REBLUR_DIFFUSE_SPECULAR_SH", "RGBA8_SNORM", "LINEAR", {}, True, False),
    "DS_OCC": ("REBLUR_DIFFUSE_SPECULAR_OCCLUSION", "RGBA16_SNORM", "LINEAR",
               dict(hitDistanceReconstructionMode=HM.AREA_5X5), False, True),
    "DS_OCC_BAND": ("REBLUR_DIFFUSE_SPECULAR_OCCLUSION", "RGBA8_UNORM", "LINEAR", {}, True,
                    False),
    "D_PERF": ("REBLUR_DIFFUSE", "RGBA16_UNORM", "LINEAR", dict(AF, **PERF), False, False),
    "D_CB": ("REBLUR_DIFFUSE", "RGBA8_SNORM", "LINEAR", dict(checkerboardMode=CB.BLACK), False,
             False),
    "D_SH": ("REBLUR_DIFFUSE_SH", "RGBA8_UNORM", "LINEAR", {}, False, False),
    "S": ("REBLUR_SPECULAR", "RGBA16_SNORM", "SQRT_LINEAR", AF, False, False),
    "S_CB": ("REBLUR_SPECULAR", "RGBA16_UNORM", "LINEAR", dict(checkerboardMode=CB.WHITE), False,
             False),
    "S_SH_PERF": ("REBLUR_SPECULAR_SH", "RGBA16_UNORM", "LINEAR", PERF, False, False),
    "S_OCC": ("REBLUR_SPECULAR_OCCLUSION", "RGBA8_SNORM", "LINEAR",
              dict(hitDistanceReconstructionMode=HM.AREA_3X3), False, True),
    "D_OCC": ("REBLUR_DIFFUSE_OCCLUSION", "RGBA16_SNORM", "LINEAR", {}, False, False),
    "DO": ("REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION", "RGBA8_UNORM", "LINEAR", {}, False, False),
}


def _part(v):
    if v is None or isinstance(v, (bool, int, str, enum.Enum)):
        return v
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), str(v.dtype)
    if isinstance(v, (tuple, list)):
        return tuple(_part(x) for x in v)
    return type(v).__name__  # frame constants, floats


def _signature(a, k):
    """A call's mode: its flags and its tensors' shapes."""
    return tuple(_part(x) for x in a), tuple(sorted((n, _part(v)) for n, v in k.items()))


@pytest.fixture(scope="module")
def reblur_calls():
    """{kernel: {signature: (run, call)}} of the last frame of every REBLUR run, each call of the
    kernel's wrappers (ts_prelude's specular half only)."""
    out = {n: {} for n in REBLUR_KERNELS}
    for run, (variant, encoding, roughness, settings, band, holes) in REBLUR_RUNS.items():
        eng = Engine({0: Denoiser[variant]}, resource_size=SIZE, normal_encoding=NE[encoding],
                     roughness_encoding=RE[roughness], device="cpu")
        eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))
        frame = [0]

        def recorder(n, wrapper):
            def r(*a, **k):
                if frame[0] == REBLUR_FRAMES - 1 and not (n == "ts_prelude" and len(a) < 6):
                    out[n].setdefault(_signature(a, k), (run, (a, k)))
                return wrapper(*a, **k)
            return r
        with pytest.MonkeyPatch.context() as mp:
            if band:
                mp.setenv("NRDTPU_REBLUR_BAND", "1")
            for n in REBLUR_KERNELS:
                mp.setattr(KM.MODULES[n], n, recorder(n, getattr(KM.MODULES[n], n)))
            for i, (cs, pool) in enumerate(reblur_frames_of(
                    variant, encoding, roughness, settings.get("checkerboardMode", CB.OFF),
                    holes, frames=REBLUR_FRAMES, size=SIZE)):
                frame[0] = i
                eng.set_common_settings(cs)
                eng.denoise([0], pool)
    return out


def test_reblur_runs_reach_every_mode(reblur_calls):
    """Between them the runs call every REBLUR kDec mode: H1 with one and two signals, SH and
    one channel; N3 plain, SH and one channel; H2's and N4's stages at 8 and 6 taps with SH,
    checkerboard and one channel; H3 on both signals with SH, one channel and the directional
    clamp; N5 and K23 with SH and one channel; K12 on one channel at radius 1 and 2; every
    call on the decoded plane."""
    def count(n, pred):
        return sum(bool(pred(a, k)) for _, (a, k) in reblur_calls[n].values())
    for n, calls in reblur_calls.items():
        assert calls, n
        assert all(k.get("decoded") for _, (_, k) in calls.values()), n
    assert count("smb_resolve", lambda a, k: k.get("second") is None and k.get("sh")) and count(
        "smb_resolve", lambda a, k: k.get("second") is not None and a[9].shape[-1] == 1)
    assert count("vmb_resolve", lambda a, k: k.get("sh_history") is not None) and count(
        "vmb_resolve", lambda a, k: a[6].shape[-1] == 1)
    for spec in (False, True):
        def sf(pred):
            return count("spatial_filter", lambda a, k: k.get("spec") == spec and pred(a, k))

        def hf(pred):
            return count("history_fix", lambda a, k: (a[7] is not None) == spec and pred(a, k))
        for stage in range(3):
            for perf in (False, True):
                assert sf(lambda a, k: k.get("mode") == stage and k.get("perf_mode") == perf), (
                    spec, stage, perf)
        assert sf(lambda a, k: k.get("cb") is not None) and sf(lambda a, k: a[0].shape[-1] == 1)
        assert sf(lambda a, k: k.get("sh") is not None)
        assert hf(lambda a, k: k.get("sh") is not None) and hf(lambda a, k: a[0].shape[-1] == 1)
    assert count("history_fix", lambda a, k: k.get("directional"))
    assert count("spatial_filter_fused", lambda a, k: k.get("cb") is not None)
    assert count("spatial_filter_fused", lambda a, k: k.get("sh") is not None)
    assert count("spatial_filter_fused", lambda a, k: a[0].shape[-1] == 1)
    assert count("spatial_filter_fused", lambda a, k: k.get("perf_mode"))
    assert count("history_fix_fused", lambda a, k: k.get("sh") is not None)
    assert count("history_fix_fused", lambda a, k: a[0].shape[-1] == 1)
    assert count("reblur_band", lambda a, k: k.get("sh") is not None)
    assert count("reblur_band", lambda a, k: a[0].shape[-1] == 1)
    assert count("reblur_band", lambda a, k: k.get("perf_mode"))
    assert sorted(k.get("radius") for _, (a, k) in reblur_calls["hitdist_recon"].values()
                  if (a[2] if a[2] is not None else a[3]).shape[-1] == 1) == [1, 2]


@pytest.mark.parametrize("kernel", REBLUR_KERNELS)
def test_reblur_dec_instance_rehearsal(library, reblur_calls, kernel):
    """Each REBLUR kDec mode against its plain version on a recorded call."""
    mod = KM.MODULES[kernel]
    recorded = [call for _, call in reblur_calls[kernel].values()]
    before = mod.dec_launches
    over, count, worst = _hold(library, kernel, recorded)
    assert mod.dec_launches == before + len(recorded)
    assert over <= FLIP_FRACTION * count, (f"{kernel}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("kernel", REBLUR_KERNELS)
def test_reblur_plain_versions_see_the_mode(reblur_calls, kernel):
    """Read as packed R10G10B10A2 (`decoded=False`), the decoded plane gives another result than
    in the decoded mode, on the first recorded call of the kernel."""
    a, k = next(iter(reblur_calls[kernel].values()))[1]
    ref = getattr(KM.MODULES[kernel], kernel + "_ref")
    dec, packed = ref(*a, **k), ref(*a, **dict(k, decoded=False))
    flat = [(x, y) for x, y in zip(*[[v for v in (r.values() if isinstance(r, dict) else
                                                  r if isinstance(r, tuple) else (r,))]
                                     for r in (dec, packed)])]
    assert any(x is not None and not torch.equal(x, y) for x, y in flat), kernel


def test_clamp_moments_keeps_nan(library):
    """K20 keeps NaN where its plain version does (ROADMAP.md Queue 3, closed): RELAX_DIFFUSE's
    history clamping on frame 2 at RGBA8_SNORM, its slow history and its fast (responsive)
    history NaN on a seeded 5 % of the pixels each. The kernel's outputs hold NaN exactly where
    the plain version's do, and the finite values agree within the tolerance. With fminf / fmaxf
    in its per-pixel part (the kernel before the repair) the kernel gave no NaN value here
    against the plain version's 304 in the slow history."""
    rec = []
    eng = Engine({0: Denoiser.RELAX_DIFFUSE}, resource_size=SIZE,
                 normal_encoding=NE.RGBA8_SNORM, device="cpu")
    mod = KM.MODULES["relax_clamp_moments"]

    def r(*a, **k):
        rec.append((a, k))
        return wrapper(*a, **k)
    wrapper = mod.relax_clamp_moments
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "relax_clamp_moments", r)
        for cs, pool in frames_of("RELAX_DIFFUSE", "RGBA8_SNORM", frames=FRAMES, size=SIZE):
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    a, k = rec[-1]
    a = list(a)
    rng = np.random.default_rng(97)
    for idx in (1, 5):  # fast, slow
        t = a[idx].clone()
        t[torch.from_numpy(rng.uniform(size=t.shape[:2]) < 0.05)] = float("nan")
        a[idx] = t
    with kernels_on_cpu(library):
        got = mod.relax_clamp_moments(*a, **k)
    want = mod.relax_clamp_moments_ref(*a, **k)
    for g, w in zip(got, want):
        nan_g, nan_w = torch.isnan(g), torch.isnan(w)
        print(f"NaN values: kernel {int(nan_g.sum())}, plain {int(nan_w.sum())}")
        assert nan_w.any() and torch.equal(nan_g, nan_w)
        fin = ~nan_w
        d = (g[fin] - w[fin]).abs()
        assert (d > 1e-4 + 1e-4 * w[fin].abs()).float().mean() <= FLIP_FRACTION


# K16, K17 and K22 on the SNORM sky fault's frames: the kernels and the calls that the NaN cases
# hold, recorded once
NAN_KERNELS = ("relax_smb_resolve", "relax_vmb_resolve", "relax_atrous")


@pytest.fixture(scope="module")
def snorm_fault_calls():
    """Every call of K16, K17 and K22 over 3 frames of RELAX_SPECULAR at RGBA8_SNORM with the
    scene's zero sky normal (`frames_of(..., sky=False)`): the reference's fault (ROADMAP.md
    Queue 3) leaves NaN on every geometry pixel of the specular TA's output, which reaches the
    histories K16 and K17 sample and the signal K22 filters."""
    rec = {n: [] for n in NAN_KERNELS}
    eng = Engine({0: Denoiser.RELAX_SPECULAR}, resource_size=SIZE,
                 normal_encoding=NE.RGBA8_SNORM, device="cpu")

    def recorder(n, wrapper):
        def r(*a, **k):
            rec[n].append((a, k))
            return wrapper(*a, **k)
        return r
    with pytest.MonkeyPatch.context() as mp:
        for n in NAN_KERNELS:
            mp.setattr(KM.MODULES[n], n, recorder(n, getattr(KM.MODULES[n], n)))
        for cs, pool in frames_of("RELAX_SPECULAR", "RGBA8_SNORM", frames=FRAMES, sky=False,
                                  size=SIZE):
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    return rec


@pytest.mark.parametrize("kernel", NAN_KERNELS)
def test_relax_kernels_keep_nan(library, snorm_fault_calls, kernel):
    """K16, K17 and K22 keep NaN where their plain versions do (ROADMAP.md Queue 3, closed) on
    every call of the SNORM sky fault's frames: each output's non-finite values lie exactly where
    the plain version's do, and the finite values agree within the tolerance. The kernels before
    the repair failed each case on frames 1-2 (K16's and K17's histories: their CatRom skipped
    the texels of weight 0, which the plain version multiplies by 0, a NaN there included; K22's
    staged iteration 0: its variance's fmaxf turned the NaN moments into 0), e.g. K22's first
    call with 2583 non-finite values against the plain version's 3444."""
    mod = KM.MODULES[kernel]
    calls = snorm_fault_calls[kernel]
    assert calls
    split = {}
    nonfinite = 0
    for ci, (a, k) in enumerate(calls):
        with kernels_on_cpu(library):
            got = mod_out(getattr(mod, kernel)(*a, **k))
        want = mod_out(getattr(mod, kernel + "_ref")(*a, **k))
        for key, w in want.items():
            g = got[key].float()
            w = w.float()
            bad_g, bad_w = ~torch.isfinite(g), ~torch.isfinite(w)
            nonfinite += int(bad_w.sum())
            if not torch.equal(bad_g, bad_w):
                split[(ci, key)] = (int(bad_g.sum()), int(bad_w.sum()))
            fin = ~bad_w
            d = (g[fin] - w[fin]).abs()
            assert int((d > 1e-4 + 1e-4 * w[fin].abs()).sum()) <= FLIP_FRACTION * d.numel(), (
                ci, key)
    assert nonfinite, kernel  # the frames carry the fault's NaN
    assert not split, f"{kernel}: (call, output): (kernel's, plain's non-finite values) {split}"


def mod_out(r):
    """A wrapper's outputs as {name: tensor}, the tuples of a two-signal call flattened."""
    if isinstance(r, dict):
        return {k: v for k, v in r.items() if isinstance(v, torch.Tensor)}
    if isinstance(r, tuple):
        return {i: v for i, v in enumerate(r) if isinstance(v, torch.Tensor)}
    return {"out": r}
