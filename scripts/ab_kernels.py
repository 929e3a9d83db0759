#!/usr/bin/env python3
"""Time this tree's redesigned hand kernels against another tree's on one CUDA card, in turns.

    git archive HEAD | tar -x -C _ab/parent        # the parent commit, unpacked
    python3 scripts/ab_kernels.py --parent _ab/parent [--variant NAME=FLAGS ...] [--slices]

Sides: the parent (its own `nrdtpu_torch`, imported as `nrdtpu_torch_parent` with its own
glue, wrappers and kernel library), this tree ("change"), and each `--variant`: this tree's
glue and wrappers over a library built from this tree's sources with extra nvcc flags (for
example `-DNAME=1` or `--fmad=true`; the library holds the sources of `VARIANT_SOURCES`
only). Every side records the calls of frame 4 of the orbit scene at 2560x1440 through its own
Engine(device="cuda"), then each call is timed (CUDA events, `--reps` launches) side after
side and back again (parent, change, variants..., variants reversed, change, parent), and
held against its own plain version (the fraction of values outside 1e-4 + 1e-4 |plain|).
Labels: N5 `history_fix_fused` and its pass (`pass fused_history_fix`), by default and with
the anti-firefly ring; N4 `spatial_filter_fused` by stage, also in performance mode; K23
`reblur_band` (default, ring, performance mode); H2 and H3 of REBLUR_DIFFUSE (D) and
REBLUR_SPECULAR (S), H3 also with the ring, and H3's pass (`pass history_fix`: its glue and
launch, on a tree whose kernel leaves the clamp to the glue the clamp glue included); H1
`smb_resolve` on D, S (one signal) and DS (two); K13 `sigma_blur` in its four modes (SS / ST
blur and post_blur: SIGMA_SHADOW and SIGMA_SHADOW_TRANSLUCENCY, Blur and PostBlur); K14
`sigma_ts` and its pass (`pass temporal_stabilization`: on a tree whose kernel takes the
reprojected planes, the glue that makes them included) on SS and ST; K19 `relax_history_fix`, K16
`relax_smb_resolve` and K15 `relax_prepass` by signal (RD, RS: RELAX_DIFFUSE, RELAX_SPECULAR;
frame 4 runs K19's taps on every pixel); K17 `relax_vmb_resolve` (RS); K15 on RELAX_SPECULAR
at the roughness encodings SQ_LINEAR and SQRT_LINEAR (`RS SQ_LINEAR`, `RS SQRT_LINEAR`:
`chip_smoke.ENCODED`'s pools and settings); K20 `relax_clamp_moments` and its pass (`pass
history_clamping`: on a tree whose kernel computes the moments only, the clamp glue included;
the responsive history's select before it is not) on RD and RS; H4 `ts_prelude` by TS half
(`D ts_prelude diffuse`, `S ts_prelude specular`, `DS ts_prelude diffuse` / `specular`) and
REBLUR's TS passes (`pass temporal_stabilization`, `pass temporal_stabilization_specular`: on
a tree whose kernel is the prelude only, the glue around it included) on D, S and DS.
`--labels REGEX` times only the labels it finds.

With `--slices` it also runs every path that launches the kernels under test (`SLICES`: D,
S, DS, DS+BAND, DS+AREA_3X3, RD, RS, RS+AF, as `chip_smoke.PATHS` defines them) on parent and
change in turns (parent, change, change, parent): the median ms/frame over `--frames` frames, the
peak allocated memory above what the slice's resident frames take, and a torch.profiler trace
of 3 frames (device events and device busy time a frame). The slices' frames stay on the card
for the run, so the peak is not the slice's own (`chip_smoke.py` reports that); parent and
change are compared on the same measure.

Per side it prints each device kernel's registers and spill bytes (ptxas) and SASS
instruction count (cuobjdump), the largest loop of each (its instructions between a
backward branch and its target), and writes the SASS of the filter kernels (REBLUR's, H1's,
H4's, K13's, K14's, K15's, K16's, K17's, K19's and K20's: `SASS_KERNELS`) and a JSON
of every number to `--out`. Recording the calls, holding a kernel to its plain version,
timing, the build log's ptxas lines and the SASS listing are `chip_smoke.py`'s own
(`recording`, `disagreement`, `time_ms`, `ptxas_usage`, `sass_listing`), so that both
scripts measure alike.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import enum
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

VARIANT_SOURCES = ("history_fix_fused.cu", "spatial_filter_fused.cu", "reblur_band.cu",
                   "spatial_filter.cu", "history_fix.cu", "smb_resolve.cu", "sigma_blur.cu",
                   "sigma_ts.cu", "relax_history_fix.cu", "relax_smb_resolve.cu",
                   "relax_vmb_resolve.cu", "relax_prepass.cu", "relax_clamp_moments.cu",
                   "ts_prelude.cu")
SASS_KERNELS = re.compile(
    r"history_fix|spatial_filter|reblur_band|sigma_blur|sigma_ts|smb_resolve|relax_vmb_resolve|"
    r"relax_prepass|relax_clamp_moments|ts_prelude")
DS = "REBLUR_DIFFUSE_SPECULAR"
BAND = DS + "+BAND"  # chip_smoke.PATHS: the pool and environment (the band's switch)
# the pass functions whose calls are timed beside the kernels' (glue and launch), by the
# family of the denoiser that calls them: their module, as a Side attribute
PASSES = {("REBLUR", "fused_history_fix"): "TK", ("REBLUR", "history_fix"): "TK",
          ("REBLUR", "temporal_stabilization"): "TK",
          ("REBLUR", "temporal_stabilization_specular"): "TK",
          ("SIGMA", "temporal_stabilization"): "SK", ("RELAX", "history_clamping"): "RK"}
# (label prefix, denoiser, path of the pool and environment, settings, kernels and passes
# ("pass <name>") recorded)
RUNS = (
    ("DS", DS, DS, {}, ("history_fix_fused", "spatial_filter_fused", "smb_resolve",
                        "ts_prelude", "pass fused_history_fix", "pass temporal_stabilization",
                        "pass temporal_stabilization_specular")),
    ("DS ring", DS, DS, dict(enableAntiFirefly=True),
     ("history_fix_fused", "pass fused_history_fix")),
    ("DS perf", DS, DS, dict(enablePerformanceMode=True), ("spatial_filter_fused",)),
    ("band", DS, BAND, {}, ("reblur_band",)),
    ("band ring", DS, BAND, dict(enableAntiFirefly=True), ("reblur_band",)),
    ("band perf", DS, BAND, dict(enablePerformanceMode=True), ("reblur_band",)),
    ("D", "REBLUR_DIFFUSE", "REBLUR_DIFFUSE", {},
     ("spatial_filter", "history_fix", "smb_resolve", "ts_prelude", "pass history_fix",
      "pass temporal_stabilization")),
    ("S", "REBLUR_SPECULAR", "REBLUR_SPECULAR", {},
     ("spatial_filter", "history_fix", "smb_resolve", "ts_prelude", "pass history_fix",
      "pass temporal_stabilization_specular")),
    ("D ring", "REBLUR_DIFFUSE", "REBLUR_DIFFUSE", dict(enableAntiFirefly=True),
     ("history_fix", "pass history_fix")),
    ("S ring", "REBLUR_SPECULAR", "REBLUR_SPECULAR", dict(enableAntiFirefly=True),
     ("history_fix", "pass history_fix")),
    ("SS", "SIGMA_SHADOW", "SIGMA_SHADOW", {},
     ("sigma_blur", "sigma_ts", "pass temporal_stabilization")),
    ("ST", "SIGMA_SHADOW_TRANSLUCENCY", "SIGMA_SHADOW_TRANSLUCENCY", {},
     ("sigma_blur", "sigma_ts", "pass temporal_stabilization")),
    ("RD", "RELAX_DIFFUSE", "RELAX_DIFFUSE", {},
     ("relax_history_fix", "relax_smb_resolve", "relax_prepass", "relax_clamp_moments",
      "pass history_clamping")),
    ("RS", "RELAX_SPECULAR", "RELAX_SPECULAR", {},
     ("relax_history_fix", "relax_smb_resolve", "relax_vmb_resolve", "relax_prepass",
      "relax_clamp_moments", "pass history_clamping")),
) + tuple((f"RS {v['encoding']}", v["denoiser"], pool,
           dict(v["settings"], roughness_encoding=v["encoding"]), ("relax_prepass",))
          for pool, v in CS.ENCODED.items())
# the paths that --slices runs on both sides (chip_smoke.PATHS): those that launch H4 or K20
SLICES = ("REBLUR_DIFFUSE", "REBLUR_SPECULAR", DS, BAND, DS + "+AREA_3X3", "RELAX_DIFFUSE",
          "RELAX_SPECULAR", "RELAX_SPECULAR+ANTI_FIREFLY")


def log(*a):
    print(*a, flush=True)


class Side:
    """One package (this tree or the parent's) with the library its wrappers launch."""

    def __init__(self, name, pkg, lib=None):
        self.name, self.pkg, self.lib = name, pkg, lib
        self.KM = importlib.import_module(pkg + ".kernels")
        self.build = importlib.import_module(pkg + ".kernels.build")
        self.TK = importlib.import_module(pkg + ".passes.reblur.kernels")
        self.SK = importlib.import_module(pkg + ".passes.sigma.kernels")
        self.RK = importlib.import_module(pkg + ".passes.relax.kernels")
        self.S = importlib.import_module(pkg + ".settings")
        self.Engine = importlib.import_module(pkg + ".engine").Engine

    def activate(self):
        """Point the package's wrappers at this side's library (the package's own built
        library unless the side was given one)."""
        if self.lib is None:
            self.build._lib = None
            self.lib = self.build.library()
        self.build._lib = self.lib
        return self.lib

    def convert(self, value):
        """A value of this tree's settings (an enum or a dataclass) in this side's types."""
        if isinstance(value, enum.Enum):
            return getattr(self.S, type(value).__name__)[value.name]
        if dataclasses.is_dataclass(value):
            cls = getattr(self.S, type(value).__name__)
            return cls(**{f.name: self.convert(getattr(value, f.name))
                          for f in dataclasses.fields(value)})
        return value

    def engine(self, denoiser, w, h, roughness_encoding="LINEAR", **settings):
        """An Engine of the denoiser at the roughness encoding, with `settings` changed from
        the defaults (enum fields of this side's types, or by name)."""
        eng = self.Engine({0: self.S.Denoiser[denoiser]}, resource_size=(w, h), device="cuda",
                          roughness_encoding=self.S.RoughnessEncoding[roughness_encoding])
        if "hitDistanceReconstructionMode" in settings:
            mode = settings["hitDistanceReconstructionMode"]
            settings["hitDistanceReconstructionMode"] = self.S.HitDistanceReconstructionMode[
                getattr(mode, "name", mode)]
        if settings:
            eng.set_denoiser_settings(0, self.S.replace(eng._settings[0], **settings))
        return eng

    def pool(self, pool):
        return {getattr(self.S.ResourceType, k.name): v for k, v in pool.items()}


def build_variant(flags, out_dir):
    """Start building this tree's VARIANT_SOURCES with the extra nvcc flags: (library path,
    objects, nvcc processes)."""
    from nrdtpu_torch.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    base = [f for f in build.NVCC_FLAGS if f != "--fmad=false"] if "--fmad=true" in flags \
        else list(build.NVCC_FLAGS)
    objs, procs = [], []
    for src in VARIANT_SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *base, *flags, "-c", "-o", str(obj), str(build.CSRC / src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    return out_dir / "lib.so", objs, procs


def finish_variant(so, objs, procs):
    """Wait for a variant's nvcc processes and link its library; returns their output."""
    from nrdtpu_torch.kernels import build

    text = ""
    for cmd, p in procs:
        out = p.communicate()[0]
        text += " ".join(cmd) + "\n" + out
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-3000:]}")
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                    str(so), *map(str, objs)], check=True)
    return text


def record(side, denoiser, pool, settings, names, frames, w, h):
    """The calls of `names` (kernels, and passes as "pass <name>") in the last frame, in the
    environment of chip_smoke's path `pool`."""
    side.activate()
    eng = side.engine(denoiser, w, h, **{k: side.convert(v) for k, v in settings.items()})

    def run(cs, pools):
        eng.set_common_settings(side.convert(cs))
        eng.denoise([0], side.pool({k: torch.from_numpy(v).cuda()
                                    for k, v in pools[pool].items()}))

    family = denoiser.split("_")[0]
    with CS.path_env(pool):
        for cs, pools, _ in frames[:-1]:
            run(cs, pools)
        passes = [(getattr(side, mod), name) for (fam, name), mod in PASSES.items()
                  if fam == family]
        with CS.recording(side.KM, passes) as calls:
            run(*frames[-1][:2])
    torch.cuda.synchronize()
    return [(name, a, k, family) for name, a, k in calls if name in names]


def labelled(prefix, calls):
    """{label: (kernel name, args, kwargs, denoiser family)}: the spatial filters' calls by
    stage, SIGMA's blur by pass (Blur, PostBlur), H4 by TS half (diffuse, specular), the rest
    (and the passes, "pass <name>") by name."""
    out, stages = {}, {"spatial_filter_fused": iter(CS.SF_STAGES),
                       "spatial_filter": iter(CS.SF_STAGES)}
    for call in calls:
        name, a, k, _ = call
        if name in stages:
            out[f"{prefix} {name} {next(stages[name])}"] = call
        elif name == "sigma_blur":
            out[f"{prefix} {name} {'blur' if k['first_pass'] else 'post_blur'}"] = call
        elif name == "ts_prelude":  # the prelude-only wrapper took the vmb uv by keyword
            spec = len(a) > 5 or k.get("vmb_uv") is not None
            out[f"{prefix} {name} {'specular' if spec else 'diffuse'}"] = call
        else:
            out[f"{prefix} {name}"] = call
    return out


def runner(side, name, a, k, family):
    """(run, plain) of one recorded call on its side."""
    if name.startswith("pass "):
        fn = getattr(getattr(side, PASSES[family, name[5:]]), name[5:])
        return (lambda: fn(*CS.copied(a), **k)), None
    m = side.KM.MODULES[name]
    return (lambda: getattr(m, name)(*a, **k)), (lambda: getattr(m, name + "_ref")(*a, **k))


def hold(run, plain):
    """Values outside 1e-4 + 1e-4 |plain|, their count and the largest difference."""
    d = CS.disagreement(run(), plain()).values()
    return (sum(v[2] for v in d), sum(v[3] for v in d), max(v[0] for v in d))


def loops(body):
    """(instructions, loop bodies) of one function's SASS lines, NOPs left out: a loop body
    is the instructions from a backward branch's target to the branch."""
    insts, at_label, at_addr, pending = [], {}, {}, []
    for line in body:
        t = line.strip()
        m = re.match(r"\.L_x_(\d+):", t)
        if m:
            pending.append(m[1])
            continue
        m = re.match(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", t)
        if not m:
            continue
        for lab in pending:
            at_label[lab] = len(insts)
        pending = []
        at_addr[int(m[1], 16)] = len(insts)
        if not m[2].startswith("NOP"):
            insts.append(m[2])
    bodies = []
    for idx, text in enumerate(insts):
        if not re.search(r"\bBRA\b", text):
            continue
        m = re.search(r"\.L_x_(\d+)", text)
        target = at_label.get(m[1]) if m else None
        if target is None:
            m = re.search(r"0x([0-9a-f]+)\s*$", text)
            target = at_addr.get(int(m[1], 16)) if m else None
        if target is not None and target <= idx:
            bodies.append(idx - target + 1)
    return len(insts), sorted(bodies, reverse=True)[:4]


def sass_report(lib_path, name, out_dir):
    """{kernel: (instructions, largest loops)} of the filter kernels; writes their SASS."""
    funcs = {f: lines for f, lines in (CS.sass_listing(lib_path) or {}).items()
             if SASS_KERNELS.search(f)}
    if name in ("parent", "change") and funcs:
        import gzip

        with gzip.open(out_dir / f"sass_{name}.txt.gz", "wt") as f:
            f.write("".join(f"Function : {k}\n" + "\n".join(b) + "\n" for k, b in funcs.items()))
    return {CS.kernel_name(f): loops(b) for f, b in funcs.items()}


def slice_run(side, path, w, h, frames, warmup=3, traced=3):
    """One path of SLICES on one side, its engine in the path's environment: median
    ms/frame, the peak allocated MB above the resident frames, device events and busy ms a
    frame of a traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    side.activate()
    v = CS.PATHS[path]
    with CS.path_env(path):
        eng = side.engine(v.get("denoiser", path), w, h, **v.get("settings", {}))
        pools = [(side.convert(cs), side.pool({k: torch.from_numpy(x).cuda()
                                               for k, x in p[path].items()}))
                 for cs, p, _ in frames]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i, (cs, pool) in enumerate(pools):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
            e1.record()
            torch.cuda.synchronize()
            if i >= warmup:
                ms.append(e0.elapsed_time(e1))
        peak_mb = (torch.cuda.max_memory_allocated() - resident) / 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for cs, pool in pools[-traced:]:
                eng.set_common_settings(cs)
                eng.denoise([0], pool)
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 / traced
    return dict(ms=float(np.median(ms)), peak_mb=peak_mb, events=len(events) / traced,
                busy_ms=busy)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other tree, unpacked")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: this tree's sources built with extra nvcc flags")
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--slices", action="store_true")
    ap.add_argument("--frames", type=int, default=24, help="timed frames of each slice run")
    ap.add_argument("--out", default="_ab/out", help="directory of the JSON and the SASS")
    ap.add_argument("--labels", help="time only the labels that this regular expression finds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 1
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    log(CS.card_line())
    w, h = args.width, args.height

    # the parent's package under its own name, beside this tree's
    alias = ROOT / "_ab" / "alias"
    alias.mkdir(parents=True, exist_ok=True)
    link = alias / "nrdtpu_torch_parent"
    if not link.exists():
        link.symlink_to((Path(args.parent).resolve() / "nrdtpu_torch"))
    sys.path.insert(0, str(alias))

    t0 = time.perf_counter()
    pending = []
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        pending.append((name, *build_variant(flags.split(), ROOT / "_ab" / "build" / name)))
    sides = [Side("parent", "nrdtpu_torch_parent"), Side("change", "nrdtpu_torch")]
    libs, logs = {}, {}
    for s in sides:
        libs[s.name] = s.activate()._name
        logs[s.name] = (s.build.BUILD_DIR / "build.log").read_text()
    for name, so, objs, procs in pending:
        logs[name] = finish_variant(so, objs, procs)
        lib = ctypes.CDLL(str(so))
        lib.nrd_error_string.argtypes = [ctypes.c_int]
        lib.nrd_error_string.restype = ctypes.c_char_p
        sides.append(Side(name, "nrdtpu_torch", lib=lib))
        libs[name] = so
    log(f"build: {time.perf_counter() - t0:.1f} s, sides {[s.name for s in sides]}")

    report = dict(card=CS.card_line(), sides=[s.name for s in sides], usage={}, sass={},
                  times={}, over={}, slices=[])
    for s in sides:
        usage = CS.ptxas_usage(logs[s.name])
        report["usage"][s.name] = {
            k["kernel"]: (k["registers"], k["spill_bytes"],
                          CS.ctas_per_sm(k["registers"], k["static_smem"]))
            for src, ks in usage.items() if SASS_KERNELS.search(src) for k in ks}
        report["sass"][s.name] = sass_report(libs[s.name], s.name, out_dir)
        for k, (regs, spill, ctas) in sorted(report["usage"][s.name].items()):
            n, loop = report["sass"][s.name].get(k, (None, None))
            log(f"usage {s.name}: {k}: {regs} registers, {spill} B spill, {ctas} CTAs/SM, "
                f"{n} SASS instructions, loop bodies {loop}")

    if args.slices:
        slice_frames = list(CS.Scene(w, h).frames(3 + args.frames))
        for path in SLICES:
            for s in (sides[0], sides[1], sides[1], sides[0]):
                r = slice_run(s, path, w, h, slice_frames)
                report["slices"].append(dict(side=s.name, path=path, **r))
                log(f"slice {path} {s.name}: {r['ms']:.3f} ms/frame, peak {r['peak_mb']:.2f} MB "
                    f"above the frames, {r['events']:.0f} device events a frame, device busy "
                    f"{r['busy_ms']:.3f} ms")
        del slice_frames
        torch.cuda.empty_cache()
    frames = list(CS.Scene(w, h).frames(4))
    calls = {}
    for s in sides[:2]:
        calls[s.name] = {}
        for prefix, denoiser, pool, settings, names in RUNS:
            calls[s.name].update(labelled(prefix, record(s, denoiser, pool, settings, names,
                                                         frames, w, h)))

    labels = [lab for lab in calls["change"] if " pass " not in lab or lab in calls["parent"]]
    if args.labels:
        labels = [lab for lab in labels if re.search(args.labels, lab)]
    order = sides + sides[::-1]
    for lab in labels:
        res = {}
        for s in order:
            own = calls["parent" if s.name == "parent" else "change"]
            if lab not in own:
                continue
            s.activate()
            run, plain = runner(s, *own[lab])
            res.setdefault(s.name, []).append(CS.time_ms(run, args.reps))
            if plain is not None and s.name not in report["over"].setdefault(lab, {}):
                report["over"][lab][s.name] = hold(run, plain)
        report["times"][lab] = res
        log(f"time {lab}: " + ", ".join(f"{n} {np.mean(t):.4f}" for n, t in res.items()))
        log(f"spread {lab}: " + ", ".join(f"{n} {max(t) - min(t):.4f}" for n, t in res.items()))
        log(f"over {lab}: " + ", ".join(
            f"{n} {o}/{c} max {m:.3g}" for n, (o, c, m) in report["over"].get(lab, {}).items()))
    (out_dir / "ab.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
