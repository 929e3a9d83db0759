#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py   # REBLUR_DIFFUSE, REBLUR_SPECULAR, REBLUR_DIFFUSE_SPECULAR, 2560x1440

Phases, each of which raises on failure (exit code != 0):
  1. build the hand-written kernels from `nrdtpu_torch/kernels/csrc/` with nvcc, one process
     per source, all started together;
  2. per variant: run 3 frames of the orbit scene through `Engine(device="cuda")`, record
     every kernel call of frame 4, and hold each kernel against its plain PyTorch version
     on the same inputs on the card; time both, and compute each call's bound (compulsory
     bytes over the card's memory rate, or operations over its float32 rate). The same again
     with `enableAntiFirefly=True`, so that the anti-firefly ring of history_fix and
     history_fix_fused is held against its plain version too. Every kernel module must be
     called by one of the paths;
  3. slices: for each variant a fresh `Engine(device="cuda")` runs 3 warm-up + 24 frames with
     the launch counts set to 0 just before and read just after; every output must be
     finite, every kernel of the path launched exactly its count a frame, and each denoised
     output must beat its noisy input by >= 3 dB against the scene's clean image; prints the
     median ms/frame (CUDA events), the host ms/frame and the peak allocator bytes;
  4. card vs CPU: the same 4 frames at 256x160 on the card and on the CPU plain path must
     agree to >= 50 dB PSNR, for every output of every variant.

With `--profile` it also traces 3 frames of each variant (after 4 warm-up) with
torch.profiler and prints the device time a frame, the device's idle share against the
slice's median ms/frame, and the device time by kernel.

It prints the card's name and power limit, one JSON line of per-kernel results, and as its
last line `{"ok": true, "device": {...}}`. It imports torch, numpy and nrdtpu_torch only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

NRD_WORKING_SET_MB = 135.06  # NRD REBLUR_DIFFUSE at 1440p (BASELINE.md:22)
# the card's peaks (NVIDIA H100 SXM data sheet): device memory rate and float32 rate outside
# the tensor cores; the kernels do float32 arithmetic on gathered texels
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# kernel vs plain version on the card: |a - b| <= ATOL + RTOL |b| on all but a fraction
# FLIP_FRACTION of values. Both sides run the same float32 op order (nvcc --fmad=false);
# what remains is last-bit differences of exp/rsqrt/division between the kernel and
# PyTorch's CUDA ops, which can flip a step function (plane-distance test, floor snap) at a
# rare pixel that sits on its threshold.
ATOL, RTOL, FLIP_FRACTION = 1e-4, 1e-4, 1e-4
P = "nrdtpu/kernels/reblur_pallas.py"
F = "nrdtpu/kernels/reblur_fused.py"
SOURCES = {  # kernel: (source, TPU kernel it replaces, the other TPU kernels it also replaces)
    "smb_resolve": ("nrdtpu_torch/kernels/csrc/smb_resolve.cu", f"{P}:577", None),
    "spatial_filter": ("nrdtpu_torch/kernels/csrc/spatial_filter.cu",
                       "nrdtpu/kernels/reblur_blur2.py:264", None),
    "history_fix": ("nrdtpu_torch/kernels/csrc/history_fix.cu",
                    "nrdtpu/kernels/reblur_hfix2.py:222", None),
    "ts_prelude": ("nrdtpu_torch/kernels/csrc/ts_prelude.cu", f"{P}:1754", f"{P}:1705"),
    "spec_ta_head": ("nrdtpu_torch/kernels/csrc/spec_ta_head.cu", f"{P}:942",
                     f"{P}:882, {P}:847, {P}:171"),
    "nearest_multi": ("nrdtpu_torch/kernels/csrc/nearest_multi.cu", f"{P}:219", None),
    "vmb_resolve": ("nrdtpu_torch/kernels/csrc/vmb_resolve.cu", f"{P}:779", None),
    "spatial_filter_fused": ("nrdtpu_torch/kernels/csrc/spatial_filter_fused.cu", f"{F}:787",
                             None),
    "history_fix_fused": ("nrdtpu_torch/kernels/csrc/history_fix_fused.cu", f"{F}:668", None),
}
# per variant: its signals and its launches per frame
VARIANTS = {
    "REBLUR_DIFFUSE": dict(signals=("diff",), launches={
        "smb_resolve": 1, "spatial_filter": 3, "history_fix": 1, "ts_prelude": 1}),
    "REBLUR_SPECULAR": dict(signals=("spec",), launches={
        "smb_resolve": 1, "spatial_filter": 3, "history_fix": 1, "ts_prelude": 1,
        "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1}),
    "REBLUR_DIFFUSE_SPECULAR": dict(signals=("diff", "spec"), launches={
        "smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
        "spatial_filter_fused": 3, "history_fix_fused": 1, "ts_prelude": 2}),
}
# Float operations a pixel, counted from the kernel sources (transcendentals count as one):
# the fixed part of each kernel, and the parts that depend on the call (taps, signals)
SF_TAP_OPS, SF_PREPASS_TAP_OPS = 110, 40   # reblur_filters.cuh:sf_filter, one tap
HF_TAP_OPS, HF_MOMENT_OPS, HF_RING_OPS = 100, 27, 216  # :hf_filter tap, 3x3, the 72-tap ring
FIXED_OPS = {"smb_resolve": 450, "ts_prelude": 40, "spec_ta_head": 120, "vmb_resolve": 600,
             "nearest_multi": 0, "spatial_filter": 0, "spatial_filter_fused": 0,
             "history_fix": 0, "history_fix_fused": 0}
SMB_SIGNAL_OPS, TS_SAMPLE_OPS, NEAREST_SET_OPS = 200, 200, 12


def log(*a):
    print(*a, flush=True)


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def in_rt(sig):
    from nrdtpu_torch.settings import ResourceType as RT

    return RT.IN_DIFF_RADIANCE_HITDIST if sig == "diff" else RT.IN_SPEC_RADIANCE_HITDIST


def out_rt(sig):
    from nrdtpu_torch.settings import ResourceType as RT

    return RT.OUT_DIFF_RADIANCE_HITDIST if sig == "diff" else RT.OUT_SPEC_RADIANCE_HITDIST


class Scene:
    """Frames of the port's orbit scene as input pools (numpy) for every variant."""

    def __init__(self, w, h, seed=0):
        from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

        self.w, self.h = w, h
        self.gen = SceneGenerator(SceneSpec(size=(w, h), noise=0.4, seed=seed),
                                  camera_mode="orbit")

    def frame(self, i, truth=False):
        """(common settings, {variant: pool}, truth or None)."""
        from nrdtpu_torch import frontend as fe
        from nrdtpu_torch.settings import ResourceType as RT

        fd = self.gen.frame(i)
        cs = fd.common_settings
        cs.timeDeltaBetweenFrames = 16.66
        hdp = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
        view_z = torch.from_numpy(fd.view_z)
        base = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                RT.IN_NORMAL_ROUGHNESS: self.gen.packed_normal_roughness(fd)}
        packed = {}
        for sig, noisy, hit, rough in (
                ("diff", fd.diff_noisy, fd.diff_hit_dist, torch.ones(self.h, self.w)),
                ("spec", fd.spec_noisy, fd.spec_hit_dist, torch.from_numpy(fd.roughness))):
            nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(hit), view_z, hdp, rough)
            packed[sig] = fe.reblur_pack_radiance_hitdist(torch.from_numpy(noisy), nhd).numpy()
        pools = {name: {**base, **{in_rt(sig): packed[sig] for sig in v["signals"]}}
                 for name, v in VARIANTS.items()}
        t = None
        if truth:
            t = dict(mask=fd.hit_mask > 0, diff=(fd.diff_clean, fd.diff_noisy),
                     spec=(fd.spec_clean, fd.spec_noisy))
        return cs, pools, t

    def frames(self, n, workers=4):
        """Frames 0..n-1 in order, generated ahead on a few threads (numpy frees the GIL);
        the truth planes come with the last frame only."""
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            def submit(i):
                return ex.submit(self.frame, i, i == n - 1)
            pending = {i: submit(i) for i in range(min(n, workers))}
            for i in range(n):
                if i + workers < n:
                    pending[i + workers] = submit(i + workers)
                yield pending.pop(i).result()


def engine(variant, w, h, device, anti_firefly=False):
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser, replace

    eng = Engine({0: Denoiser[variant]}, resource_size=(w, h), device=device)
    if anti_firefly:
        eng.set_denoiser_settings(0, replace(eng._settings[0], enableAntiFirefly=True))
    return eng


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _outputs(r):
    if isinstance(r, dict):
        return dict(r)
    if isinstance(r, tuple):
        return {str(i): v for i, v in enumerate(r)}
    return {"out": r}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _ops(name, a, k):
    """Float operations of one call on its inputs, counted as FIXED_OPS says; the history
    fixes count the taps only of the pixels whose stride is non-zero in this call."""
    from nrdtpu_torch.kernels import spatial_filter as sf

    h, w = a[0].shape[:2]  # every kernel's first argument is a (h, w, ...) plane
    px = h * w
    ops = FIXED_OPS[name] * px
    ntaps = len(sf.tap_table(bool(k.get("perf_mode", False))))
    if name == "smb_resolve":
        ops += SMB_SIGNAL_OPS * px * (2 if k.get("second") is not None else 1)
    elif name == "ts_prelude":
        ops += TS_SAMPLE_OPS * px * (2 if k.get("vmb_uv") is not None else 1)
    elif name == "nearest_multi":
        ops += NEAREST_SET_OPS * px * a[1].shape[0]
    elif name in ("spatial_filter", "spatial_filter_fused"):
        per = [a[4]] if name == "spatial_filter" else [a[5], a[6]]
        for params in per:
            extra = SF_PREPASS_TAP_OPS if sf.MODES[params.shape[0]] == "spec_prepass" else 0
            ops += (SF_TAP_OPS + extra) * ntaps * px
    elif name in ("history_fix", "history_fix_fused"):
        af = k.get("anti_firefly", False)
        per = ([(a[6], af)] if name == "history_fix"
               else [(a[9], af[0]), (a[10], af[1])])
        for params, ring in per:
            live = int((params[0] != 0.0).sum())
            ops += HF_MOMENT_OPS * px + (HF_RING_OPS * px if ring else 0) + HF_TAP_OPS * 20 * live
    return ops


def _bound(name, a, k, outputs):
    """(bound ms, "bytes" or "operations"): each input read once and each output written
    once at the memory rate, against the operations at the float32 rate."""
    nbytes = sum(t.nbytes for t in _tensors(a) + _tensors(k) + _tensors(outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = _ops(name, a, k) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library(name, a, k):
    """One PyTorch call computing the same function on the same inputs, where there is one:
    nearest_multi is a nearest-texel sample at S uv sets (grid_sample, border clamp). It is
    a yardstick here only; the port never calls it."""
    if name != "nearest_multi":
        return None
    packed, uvs = a
    img = packed.permute(2, 0, 1)[None].contiguous()
    s, h, w = uvs.shape[:3]
    grid = (uvs.reshape(1, s * h, w, 2) * 2.0 - 1.0).contiguous()
    return lambda: torch.nn.functional.grid_sample(img, grid, mode="nearest",
                                                   padding_mode="border", align_corners=False)


def record_calls(variant, w, h, frames, anti_firefly):
    """Every kernel call of the last of `frames` through a fresh Engine(device="cuda")."""
    from nrdtpu_torch import kernels as KM

    eng = engine(variant, w, h, "cuda", anti_firefly)
    calls = []
    originals = {name: getattr(m, name) for name, m in KM.MODULES.items()}
    try:
        for i, (cs, pools, _) in enumerate(frames):
            if i == len(frames) - 1:
                for name, m in KM.MODULES.items():
                    def rec(*a, _n=name, _f=originals[name], **k):
                        calls.append((_n, a, k))
                        return _f(*a, **k)
                    setattr(m, name, rec)
            eng.set_common_settings(cs)
            eng.denoise([0], pools[variant])
    finally:
        for name, m in KM.MODULES.items():
            setattr(m, name, originals[name])
    torch.cuda.synchronize()
    return calls


def kernel_phase(w, h, frames):
    """Record the kernel calls of one frame of each main path, with and without the
    anti-firefly ring, and hold each kernel against its plain version on the same inputs.
    Times and bounds are of the calls without the ring; the ring's calls of the history
    fixes are timed apart."""
    from nrdtpu_torch import kernels as KM

    results = {}
    for variant in VARIANTS:
        for af in (False, True):
            for name, a, k in record_calls(variant, w, h, frames, af):
                m = KM.MODULES[name]
                kern = getattr(m, name)
                ref = getattr(m, name + "_ref")
                got = _outputs(kern(*a, **k))
                want = _outputs(ref(*a, **k))
                torch.cuda.synchronize()
                r = results.setdefault(name, dict(max_abs_err=0.0, max_rel_err=0.0, over=0,
                                                  count=0, ms={}, plain_ms={}, bound_ms={},
                                                  bound_by=set(), library_ms={},
                                                  ms_anti_firefly={}, outputs={}))
                for key in want:
                    g, wv = got[key].float(), want[key].float()
                    d = (g - wv).abs()
                    over = int((d > ATOL + RTOL * wv.abs()).sum())
                    mx = float(d.max())
                    o = r["outputs"].setdefault(key, dict(max_abs_err=0.0, over=0, count=0))
                    o["max_abs_err"] = max(o["max_abs_err"], mx)
                    o["over"] += over
                    o["count"] += d.numel()
                    r["max_abs_err"] = max(r["max_abs_err"], mx)
                    rel = float((d / wv.abs().clamp_min(1e-6)).max())
                    r["max_rel_err"] = max(r["max_rel_err"], rel)
                    r["over"] += over
                    r["count"] += d.numel()
                if af:
                    if name in ("history_fix", "history_fix_fused"):
                        r["ms_anti_firefly"].setdefault(variant, []).append(
                            _time(lambda: kern(*a, **k), 20))
                    continue
                r["ms"].setdefault(variant, []).append(_time(lambda: kern(*a, **k), 20))
                r["plain_ms"].setdefault(variant, []).append(_time(lambda: ref(*a, **k), 3))
                b, by = _bound(name, a, k, got)
                r["bound_ms"].setdefault(variant, []).append(b)
                r["bound_by"].add(by)
                lib = _library(name, a, k)
                if lib is not None:
                    r["library_ms"].setdefault(variant, []).append(_time(lib, 20))
    for name, r in results.items():
        frac = r["over"] / max(r["count"], 1)
        r["over_fraction"] = frac
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "ms_anti_firefly"):
            r[key + "_by_path"] = {v: float(np.mean(t)) for v, t in r[key].items()}
            vals = [x for t in r[key].values() for x in t]
            r[key] = float(np.mean(vals)) if vals else None
        r["bound_by"] = "operations" if "operations" in r["bound_by"] else "bytes"
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g} max_rel_err "
            f"{r['max_rel_err']:.3g} over-tolerance fraction {frac:.3g} | mean per launch "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']} ms | by path "
            + ", ".join(f"{v}: {r['ms_by_path'][v]:.4f} vs {r['plain_ms_by_path'][v]:.4f} ms, "
                        f"bound {r['bound_ms_by_path'][v]:.4f}" for v in r["ms_by_path"])
            + (" | with the anti-firefly ring "
               + ", ".join(f"{v}: {t:.4f} ms" for v, t in r["ms_anti_firefly_by_path"].items())
               if r["ms_anti_firefly_by_path"] else "")
            + " | per output "
            + ", ".join(f"{k}: max_abs {v['max_abs_err']:.3g} over {v['over'] / v['count']:.3g}"
                        for k, v in r["outputs"].items()))
        if frac > FLIP_FRACTION:
            raise AssertionError(f"{name} disagrees with its plain version: {frac:.3g} of "
                                 f"values outside atol={ATOL}, rtol={RTOL}")
    missing = set(KM.MODULES) - set(results)
    if missing:
        raise AssertionError(f"kernels called by no main path: {sorted(missing)}")
    return results


def slice_phase(variant, w, h, frames, warmup):
    """One main path through the Engine, with its own launch counts."""
    from nrdtpu_torch import frontend as fe
    from nrdtpu_torch import kernels as KM

    n = len(frames)
    signals = VARIANTS[variant]["signals"]
    eng = engine(variant, w, h, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms = [], []
    gains = {}
    KM.reset_launch_counts()
    for i, (cs, pools, truth) in enumerate(frames):
        pool = {k: torch.from_numpy(v).cuda() for k, v in pools[variant].items()}
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        eng.set_common_settings(cs)
        outs = eng.denoise([0], pool)
        e1.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        for sig in signals:
            out = outs[out_rt(sig)]
            if tuple(out.shape) != (h, w, 4) or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{variant} frame {i} {sig}: output not finite or of "
                                     f"shape {tuple(out.shape)}")
            if truth is not None:
                rgb = fe.reblur_unpack_radiance_hitdist(out)[..., :3].cpu().numpy()
                clean, noisy = truth[sig]
                m = truth["mask"]
                gains[sig] = (psnr(noisy[m], clean[m]), psnr(rgb[m], clean[m]))
        if i >= warmup:
            ms.append(e0.elapsed_time(e1))
            host_ms.append(host)
    counts = KM.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: n * VARIANTS[variant]["launches"].get(k, 0) for k in KM.MODULES}
    log(f"slice {variant}: {n} frames at {w}x{h}, launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{variant} launch counts {counts} != {expected}")
    log(f"slice {variant}: median {np.median(ms):.3f} ms/frame (CUDA events, {len(ms)} frames "
        f"after {warmup} warm-up; min {min(ms):.3f}, max {max(ms):.3f}); host wall "
        f"{np.median(host_ms):.3f} ms/frame")
    log(f"slice {variant}: peak allocated {peak / 1e6:.2f} MB (NRD REBLUR_DIFFUSE working set "
        f"{NRD_WORKING_SET_MB} MB)")
    for sig in signals:
        noisy_db, out_db = gains[sig]
        log(f"slice {variant} {sig}: PSNR vs clean on geometry: noisy input {noisy_db:.2f} dB, "
            f"denoised {out_db:.2f} dB")
        if not out_db >= noisy_db + 3.0:
            raise AssertionError(f"{variant} {sig}: denoised output does not beat the noisy "
                                 f"input by 3 dB: {gains[sig]}")
    return counts, float(np.median(ms))


def profile_phase(variant, w, h, frames, slice_ms, warmup=4, n=3):
    """Device time a frame by kernel name over n traced frames after `warmup` frames."""
    from torch.profiler import ProfilerActivity, profile

    from nrdtpu_torch import kernels as KM

    eng = engine(variant, w, h, "cuda")
    pools = [(cs, {k: torch.from_numpy(v).cuda() for k, v in p[variant].items()})
             for cs, p, _ in frames[:warmup + n]]
    for cs, pool in pools[:warmup]:
        eng.set_common_settings(cs)
        eng.denoise([0], pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for cs, pool in pools[warmup:]:
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
        torch.cuda.synchronize()

    # device-side events only (kernels, copies): the aten ops that launch them carry the
    # same time as their "self device time" and would count it twice
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError(f"profile {variant}: the trace holds no device events")
    by_name = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3 / n, c + 1)
    busy = sum(t for t, _ in by_name.values())
    groups = {"hand kernels": 0.0, "torch.cat / torch.stack copies": 0.0, "rest of the glue": 0.0}
    for name, (t, _) in by_name.items():
        key = ("hand kernels" if any(f"{k}_kernel(" in name for k in KM.MODULES)
               else "torch.cat / torch.stack copies" if "CatArrayBatchedCopy" in name
               else "rest of the glue")
        groups[key] += t
    log(f"profile {variant}: device busy {busy:.3f} ms/frame, idle share "
        f"{1.0 - busy / slice_ms:.3f} of the slice's {slice_ms:.3f} ms/frame; "
        f"{len(events) / n:.0f} device events a frame; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"profile {variant}:   {t:8.3f} ms/frame  {c / n:5.0f} x  {name[:90]}")


def card_vs_cpu_phase(w=256, h=160, frames=4):
    frames = list(Scene(w, h).frames(frames, workers=1))
    for variant, v in VARIANTS.items():
        cuda, cpu = engine(variant, w, h, "cuda"), engine(variant, w, h, "cpu")
        worst = {sig: float("inf") for sig in v["signals"]}
        for i, (cs, pools, _) in enumerate(frames):
            outs = []
            for eng in (cuda, cpu):
                eng.set_common_settings(cs)
                outs.append(eng.denoise([0], pools[variant]))
            for sig in v["signals"]:
                p = psnr(outs[0][out_rt(sig)].cpu().numpy(), outs[1][out_rt(sig)].cpu().numpy())
                worst[sig] = min(worst[sig], p)
                log(f"card vs cpu {variant} {sig} frame {i}: {p:.2f} dB")
        for sig, p in worst.items():
            if p < 50.0:
                raise AssertionError(f"{variant} {sig}: card and CPU disagree: {p:.2f} dB < 50 dB")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--frames", type=int, default=24, help="timed frames of each slice")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each variant with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from nrdtpu_torch.kernels import build

    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    build.library()
    log(f"build: {build.build_seconds:.2f} s")

    warmup = 3
    # the frames are made first, so that the scene generator's threads do not compete with
    # the denoiser for the host while it is timed; every variant reads the same frames
    t0 = time.perf_counter()
    frames = list(Scene(args.width, args.height).frames(warmup + args.frames))
    log(f"scene: {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    kr = kernel_phase(args.width, args.height, frames[:4])
    log(f"phase kernels: done at {time.perf_counter() - t_start:.1f} s")
    counts, slice_ms = {}, {}
    for variant in VARIANTS:
        counts[variant], slice_ms[variant] = slice_phase(variant, args.width, args.height,
                                                         frames, warmup)
        log(f"phase slice {variant}: done at {time.perf_counter() - t_start:.1f} s")
    if args.profile:
        for variant in VARIANTS:
            profile_phase(variant, args.width, args.height, frames, slice_ms[variant])
        log(f"phase profile: done at {time.perf_counter() - t_start:.1f} s")
    del frames
    card_vs_cpu_phase()
    log(f"phase card vs cpu: done at {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces, also) in SOURCES.items():
        r = kr[name]
        k = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=sum(c[name] for c in counts.values()),
                 max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                 launches_by_path={v: c[name] for v, c in counts.items()},
                 ms_by_path=r["ms_by_path"], plain_ms_by_path=r["plain_ms_by_path"],
                 bound_ms_by_path=r["bound_ms_by_path"])
        if r["ms_anti_firefly_by_path"]:
            k["ms_anti_firefly_by_path"] = r["ms_anti_firefly_by_path"]
        if also:
            k["also_replaces"] = also
        kernels.append(k)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
