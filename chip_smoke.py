#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # REBLUR_DIFFUSE and REBLUR_SPECULAR at 2560x1440

Phases, each of which raises on failure (exit code != 0):
  1. build the hand-written kernels from `nrdtpu_torch/kernels/csrc/` with nvcc, one process
     per source, all started together;
  2. per variant: run 3 frames of the orbit scene through `Engine(device="cuda")`, record
     every kernel call of frame 4, and hold each kernel against its plain PyTorch version
     on the same inputs on the card; time both. Every kernel module must be called by one
     of the two paths;
  3. slices: for each variant a fresh `Engine(device="cuda")` runs 3 warm-up + 24 frames with
     the launch counts set to 0 just before and read just after; every output must be
     finite, every kernel of the path launched exactly its count a frame, and the denoised
     image must beat the noisy input by >= 3 dB against the scene's clean image; prints the
     median ms/frame (CUDA events), the host ms/frame and the peak allocator bytes;
  4. card vs CPU: the same 4 frames at 256x160 on the card and on the CPU plain path must
     agree to >= 50 dB PSNR, for both variants.

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
# kernel vs plain version on the card: |a - b| <= ATOL + RTOL |b| on all but a fraction
# FLIP_FRACTION of values. Both sides run the same float32 op order (nvcc --fmad=false);
# what remains is last-bit differences of exp/rsqrt/division between the kernel and
# PyTorch's CUDA ops, which can flip a step function (plane-distance test, floor snap) at a
# rare pixel that sits on its threshold.
ATOL, RTOL, FLIP_FRACTION = 1e-4, 1e-4, 1e-4
P = "nrdtpu/kernels/reblur_pallas.py"
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
}
# per variant: input and output resource names, clean / noisy truth, launches per frame
VARIANTS = {
    "REBLUR_DIFFUSE": dict(signal="diff", launches={
        "smb_resolve": 1, "spatial_filter": 3, "history_fix": 1, "ts_prelude": 1}),
    "REBLUR_SPECULAR": dict(signal="spec", launches={
        "smb_resolve": 1, "spatial_filter": 3, "history_fix": 1, "ts_prelude": 1,
        "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1}),
}


def log(*a):
    print(*a, flush=True)


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


class Scene:
    """Frames of the port's orbit scene as input pools (numpy) for both variants."""

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
        pools = {}
        for name, rt, noisy, hit, rough in (
                ("REBLUR_DIFFUSE", RT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist,
                 torch.ones(self.h, self.w)),
                ("REBLUR_SPECULAR", RT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist,
                 torch.from_numpy(fd.roughness))):
            nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(hit), view_z, hdp, rough)
            sig = fe.reblur_pack_radiance_hitdist(torch.from_numpy(noisy), nhd).numpy()
            pools[name] = {**base, rt: sig}
        t = None
        if truth:
            t = dict(mask=fd.hit_mask > 0,
                     REBLUR_DIFFUSE=(fd.diff_clean, fd.diff_noisy),
                     REBLUR_SPECULAR=(fd.spec_clean, fd.spec_noisy))
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


def engine(variant, w, h, device):
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser

    return Engine({0: Denoiser[variant]}, resource_size=(w, h), device=device)


def out_rt(variant):
    from nrdtpu_torch.settings import ResourceType as RT

    return (RT.OUT_SPEC_RADIANCE_HITDIST if variant == "REBLUR_SPECULAR"
            else RT.OUT_DIFF_RADIANCE_HITDIST)


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


def record_calls(variant, w, h, frames):
    """Every kernel call of the last of `frames` through a fresh Engine(device="cuda")."""
    from nrdtpu_torch import kernels as KM

    eng = engine(variant, w, h, "cuda")
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
    """Record the kernel calls of one frame of each main path and hold each kernel against
    its plain version on the same inputs."""
    from nrdtpu_torch import kernels as KM

    results = {}
    for variant in VARIANTS:
        for name, a, k in record_calls(variant, w, h, frames):
            m = KM.MODULES[name]
            kern = getattr(m, name)
            ref = getattr(m, name + "_ref")
            got = _outputs(kern(*a, **k))
            want = _outputs(ref(*a, **k))
            torch.cuda.synchronize()
            r = results.setdefault(name, dict(max_abs_err=0.0, max_rel_err=0.0, over=0, count=0,
                                              ms={}, plain_ms={}, outputs={}))
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
            r["ms"].setdefault(variant, []).append(_time(lambda: kern(*a, **k), 20))
            r["plain_ms"].setdefault(variant, []).append(_time(lambda: ref(*a, **k), 3))
    for name, r in results.items():
        frac = r["over"] / max(r["count"], 1)
        r["over_fraction"] = frac
        for key in ("ms", "plain_ms"):
            r[key + "_by_path"] = {v: float(np.mean(t)) for v, t in r[key].items()}
            r[key] = float(np.mean([x for t in r[key].values() for x in t]))
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g} max_rel_err "
            f"{r['max_rel_err']:.3g} over-tolerance fraction {frac:.3g} | mean per launch "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms | by path "
            + ", ".join(f"{v}: {r['ms_by_path'][v]:.4f} vs {r['plain_ms_by_path'][v]:.4f} ms"
                        for v in r["ms_by_path"])
            + " | per output "
            + ", ".join(f"{k}: max_abs {v['max_abs_err']:.3g} over {v['over'] / v['count']:.3g}"
                        for k, v in r["outputs"].items()))
        if frac > FLIP_FRACTION:
            raise AssertionError(f"{name} disagrees with its plain version: {frac:.3g} of "
                                 f"values outside atol={ATOL}, rtol={RTOL}")
    missing = set(KM.MODULES) - set(results)
    if missing:
        raise AssertionError(f"kernels called by neither main path: {sorted(missing)}")
    return results


def slice_phase(variant, w, h, frames, warmup):
    """One main path through the Engine, with its own launch counts."""
    from nrdtpu_torch import frontend as fe
    from nrdtpu_torch import kernels as KM

    n = len(frames)
    eng = engine(variant, w, h, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms = [], []
    gains = None
    KM.reset_launch_counts()
    for i, (cs, pools, truth) in enumerate(frames):
        pool = {k: torch.from_numpy(v).cuda() for k, v in pools[variant].items()}
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        eng.set_common_settings(cs)
        out = eng.denoise([0], pool)[out_rt(variant)]
        e1.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        if tuple(out.shape) != (h, w, 4) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{variant} frame {i}: output not finite or of shape "
                                 f"{tuple(out.shape)}")
        if i >= warmup:
            ms.append(e0.elapsed_time(e1))
            host_ms.append(host)
        if truth is not None:
            rgb = fe.reblur_unpack_radiance_hitdist(out)[..., :3].cpu().numpy()
            clean, noisy = truth[variant]
            m = truth["mask"]
            gains = (psnr(noisy[m], clean[m]), psnr(rgb[m], clean[m]))
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
    log(f"slice {variant}: PSNR vs clean on geometry: noisy input {gains[0]:.2f} dB, denoised "
        f"{gains[1]:.2f} dB")
    if not gains[1] >= gains[0] + 3.0:
        raise AssertionError(f"{variant}: denoised output does not beat the noisy input by "
                             f"3 dB: {gains}")
    return counts


def card_vs_cpu_phase(w=256, h=160, frames=4):
    frames = list(Scene(w, h).frames(frames, workers=1))
    for variant in VARIANTS:
        cuda, cpu = engine(variant, w, h, "cuda"), engine(variant, w, h, "cpu")
        worst = float("inf")
        for i, (cs, pools, _) in enumerate(frames):
            outs = []
            for eng in (cuda, cpu):
                eng.set_common_settings(cs)
                outs.append(eng.denoise([0], pools[variant])[out_rt(variant)].cpu().numpy())
            p = psnr(outs[0], outs[1])
            worst = min(worst, p)
            log(f"card vs cpu {variant} frame {i}: {p:.2f} dB")
        if worst < 50.0:
            raise AssertionError(f"{variant}: card and CPU disagree: {worst:.2f} dB < 50 dB")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--frames", type=int, default=24, help="timed frames of each slice")
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
    # the denoiser for the host while it is timed; both variants read the same frames
    t0 = time.perf_counter()
    frames = list(Scene(args.width, args.height).frames(warmup + args.frames))
    log(f"scene: {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    kr = kernel_phase(args.width, args.height, frames[:4])
    log(f"phase kernels: done at {time.perf_counter() - t_start:.1f} s")
    counts = {}
    for variant in VARIANTS:
        counts[variant] = slice_phase(variant, args.width, args.height, frames, warmup)
        log(f"phase slice {variant}: done at {time.perf_counter() - t_start:.1f} s")
    del frames
    card_vs_cpu_phase()
    log(f"phase card vs cpu: done at {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces, also) in SOURCES.items():
        k = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=sum(c[name] for c in counts.values()),
                 max_abs_err=kr[name]["max_abs_err"], ms=kr[name]["ms"],
                 plain_ms=kr[name]["plain_ms"],
                 launches_by_path={v: c[name] for v, c in counts.items()},
                 ms_by_path=kr[name]["ms_by_path"], plain_ms_by_path=kr[name]["plain_ms_by_path"])
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
