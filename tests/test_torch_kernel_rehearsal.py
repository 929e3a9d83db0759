"""Rehearsal on the CPU of the kernels redesigned for the H100 and of the kernels with a
roughness-encoding mode: K22 `relax_atrous.cu`, K23 `reblur_band.cu`, N4
`spatial_filter_fused.cu`, N5 `history_fix_fused.cu`, K13 `sigma_blur.cu`, K19
`relax_history_fix.cu`, K16 `relax_smb_resolve.cu`, K17 `relax_vmb_resolve.cu`, K15
`relax_prepass.cu`, K12 `hitdist_recon.cu`, H1 `smb_resolve.cu`, K14 `sigma_ts.cu`, H3
`history_fix.cu`, K20 `relax_clamp_moments.cu`, H4 `ts_prelude.cu` and H2 `spatial_filter.cu`,
as they are in the tree,
compiled as C++ by g++
through `tests/cuda_shim.h` (every CUDA thread a std::thread,
`__syncthreads` a barrier of the block) and bound through the same ctypes entry points as on
the card, with `build.library`, `build.kernel_device` and `torch.cuda.current_stream` patched.
Each is held against its plain version on the calls that the port's Engine makes on the CPU at
48x32 over 4 orbit frames: every stride of the à-trous ladder of RELAX_DIFFUSE and
RELAX_SPECULAR with IN_DIFF_CONFIDENCE / IN_SPEC_CONFIDENCE; the band of
REBLUR_DIFFUSE_SPECULAR (NRDTPU_REBLUR_BAND=1) by default, with the anti-firefly ring and in
performance mode; N4's PrePass (hitDistForTracking and its PCG draws), Blur, PostBlur and
performance mode, and N5 by default and with the ring, both of REBLUR_DIFFUSE_SPECULAR;
N5's tap-geometry plane read by N4's Blur (the two kernels chained); K13 in its four modes
(SIGMA_SHADOW and SIGMA_SHADOW_TRANSLUCENCY, Blur and PostBlur); K19 on RELAX_DIFFUSE and
RELAX_SPECULAR (its tap-record prologue, then the taps; the first frame included) and with
historyFixFrameNum = 0, whose frame num of 1 switches the taps and the prologue off; K16 on
RELAX_DIFFUSE and RELAX_SPECULAR and K17 on RELAX_SPECULAR, whose orbit frames give both
bicubic and bilinear-fallback footprints, their footprint planes (smb_found, any, all) equal;
K15, K19, K22 and K12 on RELAX_SPECULAR with AREA_3X3 reconstruction on frames with
hit-distance holes, IN_NORMAL_ROUGHNESS packed as SQ_LINEAR and as SQRT_LINEAR; H1 on
REBLUR_DIFFUSE (one signal) and REBLUR_DIFFUSE_SPECULAR (two), also with both min materials 0
on frames with striped materials (at the default of 4 the material test never bites), both
footprints on the frames, fbits and allow_catrom equal; and K15 on RELAX_DIFFUSE and
RELAX_SPECULAR at LINEAR, with depthThreshold 0.03 (the snapped tap position at its
plane-distance threshold) and with both min materials 0 on striped materials; K20 on
RELAX_DIFFUSE and RELAX_SPECULAR (`CLAMP_CASES`); H4 on every TS half (`TS_CASES`); H2 on
REBLUR_DIFFUSE and REBLUR_SPECULAR by stage (`SF_CASES`: PrePass, Blur and PostBlur, these two
with the taps on H3's geometry plane; performance mode,
usePrepassOnlyForSpecularMotionEstimation and both min materials 0 on striped materials),
and H3's kernel chained into H2's Blur; K12 on REBLUR_DIFFUSE, REBLUR_SPECULAR and
REBLUR_DIFFUSE_SPECULAR at radius 1 and 2 (`HD_CASES`) on frames with hit-distance holes,
the image border's included; and the two-signal modes on RELAX_DIFFUSE_SPECULAR's calls: K16
`<true, 4>`, K22 at every stride with both confidences (`RDS_ATROUS_CASES`), K19
(`RDS_FIX_CASES`) and K20 (`RDS_CLAMP_CASES`), each also on inputs where the two signals'
constants differ, so that a kernel that swapped them fails; and the SH modes of K15, K16, K17,
K19, K20 and K22 on the calls of RELAX_DIFFUSE_SH, RELAX_SPECULAR_SH and
RELAX_DIFFUSE_SPECULAR_SH (`SH_CASES`), whose SH planes differ between the two signals and
whose SH1 is negative where the radiance is positive (`SH_DIRECTIONS`), on frames that give
K16 and K17 both footprints; and the checkerboard PrePass of H2 (REBLUR_DIFFUSE and
REBLUR_SPECULAR, `CB_CASES`) and N4 (REBLUR_DIFFUSE_SPECULAR, `CB_DS_CASES`) in BLACK and
WHITE on half-width inputs, with the PrePass radius 0 (which still runs under checkerboard),
with usePrepassOnlyForSpecularMotionEstimation (every pixel without data falls back to its
neighbours) and on frames where the fallback fires at some pixels (`CB_FALLBACK`).

Run alone: python -m pytest tests/test_torch_kernel_rehearsal.py -q

Tolerance: that of `chip_smoke.py` on the card, |kernel - plain| <= 1e-4 + 1e-4 |plain| on all
but 1e-4 of the values. g++ builds with -ffp-contract=off as nvcc builds with --fmad=false;
what remains is last-bit differences of the C library's exp/sqrt against PyTorch's.
"""

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nrdtpu_torch import frontend as fe
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.kernels import build
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import RelaxAntilagSettings
from nrdtpu_torch.settings import ResourceType as RT, RoughnessEncoding, replace
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SHIM = Path(__file__).with_name("cuda_shim.h")
# every source that a rehearsal holds; smb_resolve.cu defines the library's nrd_error_string
SOURCES = ("relax_atrous.cu", "reblur_band.cu", "spatial_filter_fused.cu",
           "history_fix_fused.cu", "sigma_blur.cu", "relax_history_fix.cu",
           "relax_smb_resolve.cu", "relax_vmb_resolve.cu", "relax_prepass.cu",
           "hitdist_recon.cu", "smb_resolve.cu", "sigma_ts.cu", "history_fix.cu",
           "relax_clamp_moments.cu", "ts_prelude.cu", "spatial_filter.cu", "spec_ta_head.cu",
           "nearest_multi.cu", "vmb_resolve.cu", "bilinear_resolve.cu", "relax_antifirefly.cu")
SIZE = (48, 32)
FRAMES = 4
ATOL, RTOL, FLIP_FRACTION = 1e-4, 1e-4, 1e-4
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
CONFIDENCE_DRIVEN = dict(confidenceDrivenRelaxationMultiplier=1.0,
                         confidenceDrivenLuminanceEdgeStoppingRelaxation=1.0,
                         confidenceDrivenNormalEdgeStoppingRelaxation=1.0)
BAND_CASES = {"default": {}, "anti_firefly": dict(enableAntiFirefly=True),
              "perf": dict(enablePerformanceMode=True)}
STEPS = (1, 2, 4, 8, 16)
# N4's calls of a REBLUR_DIFFUSE_SPECULAR frame, in order
SF_STAGES = ("prepass", "blur", "post_blur")
# K13's four modes: the SIGMA variant and the call of its frame (Blur, then PostBlur)
SIGMA_MODES = {"shadow_blur": (Denoiser.SIGMA_SHADOW, 0),
               "shadow_post_blur": (Denoiser.SIGMA_SHADOW, 1),
               "translucency_blur": (Denoiser.SIGMA_SHADOW_TRANSLUCENCY, 0),
               "translucency_post_blur": (Denoiser.SIGMA_SHADOW_TRANSLUCENCY, 1)}
TRANSLUCENCY_RGB = (0.3, 0.6, 0.2)
# K19's calls: each RELAX signal over the frames (the first one included), and
# historyFixFrameNum = 0, whose frame num of 1 switches the taps off
HISTORY_FIX_CASES = {"diffuse": (Denoiser.RELAX_DIFFUSE, {}),
                     "specular": (Denoiser.RELAX_SPECULAR, {}),
                     "taps_off": (Denoiser.RELAX_DIFFUSE, dict(historyFixFrameNum=0))}
DS = Denoiser.REBLUR_DIFFUSE_SPECULAR
# the kernels that unpack the roughness, each held at the two encodings other than LINEAR
ENCODED_KERNELS = ("relax_prepass", "relax_history_fix", "relax_atrous", "hitdist_recon")
HOLE_FRACTION = 0.3  # of the geometry pixels whose hit distance the frames with holes zero
NO_MIN_MATERIAL = dict(minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0)
# H1's calls: one signal, two, and two with the material test biting
SMB_CASES = {"diffuse": (Denoiser.REBLUR_DIFFUSE, {}), "diffuse_specular": (DS, {}),
             "min_material_0": (DS, NO_MIN_MATERIAL)}
# K15's calls at LINEAR: each RELAX signal, the plane-distance threshold of 0.03 and the
# material test biting
PREPASS_CASES = {"diffuse": (Denoiser.RELAX_DIFFUSE, {}),
                 "specular": (Denoiser.RELAX_SPECULAR, {}),
                 "diffuse_depth_threshold": (Denoiser.RELAX_DIFFUSE, dict(depthThreshold=0.03)),
                 "specular_depth_threshold": (Denoiser.RELAX_SPECULAR,
                                              dict(depthThreshold=0.03)),
                 "diffuse_min_material_0": (Denoiser.RELAX_DIFFUSE, NO_MIN_MATERIAL),
                 "specular_min_material_0": (Denoiser.RELAX_SPECULAR, NO_MIN_MATERIAL)}
# K14's calls: each SIGMA variant under each motion-vector branch. The orbit scene sends 2.5D
# motion vectors (motionVectorScale (1, 1, 1): screen space, the mv's z the viewZ delta);
# "mv_z_scaled" scales that z by MV_Z_SCALE, so that the given z moves the previous view z
# across the disocclusion threshold (the scene's own deltas stay below it, where a kernel that
# ignored the given z would pass); "mv_z_computed" scales the z by 0, so that the kernel
# computes it from world_to_view_prev; "world_mv" sets isMotionVectorInWorldSpace with IN_MV
# zeroed, the true world motion of the scene's static geometry, projected by
# world_to_clip_prev
MOTIONS = ("mv_z_given", "mv_z_scaled", "mv_z_computed", "world_mv")
MV_Z_SCALE = 50.0
# and "umbra": the orbit frames' PostBlur penumbra is nowhere 0 at this size, so these calls
# zero it on a seeded UMBRA_FRACTION of the pixels, where the hard-shadow pass-through and the
# moments' lit/unlit weight bite
UMBRA_FRACTION = 0.2
SIGMA_TS_CASES = {f"{v}_{m}": (d, m) for v, d in (("shadow", Denoiser.SIGMA_SHADOW),
                                                    ("translucency",
                                                     Denoiser.SIGMA_SHADOW_TRANSLUCENCY))
                  for m in MOTIONS + ("umbra",)}
# H3's calls: each REBLUR signal alone, with the anti-firefly ring, and with the material test
# biting (both min materials 0 on striped materials)
HISTORY_FIX_H3_CASES = {f"{sig}{suffix}": (d, settings)
                        for sig, d in (("diffuse", Denoiser.REBLUR_DIFFUSE),
                                       ("specular", Denoiser.REBLUR_SPECULAR))
                        for suffix, settings in (("", {}),
                                                 ("_anti_firefly", dict(enableAntiFirefly=True)),
                                                 ("_min_material_0", NO_MIN_MATERIAL))}
# K20's calls: each RELAX signal by default (on frames 1-3 every history is in the fix), with
# historyFixFrameNum = 1 (histories on both sides of the fix), a tight colour box and an
# antilag whose acceleration (also its cap at the noisy mean) and reset bite on these frames,
# and with the tight colour box's clamp off (the max fast frame num at the max frame num)
STRONG_ANTILAG = RelaxAntilagSettings(accelerationAmount=1.0, spatialSigmaScale=0.5,
                                      temporalSigmaScale=0.1, resetAmount=1.0)
CLAMP_CASES = {f"{sig}{suffix}": (d, settings)
               for sig, d in (("diffuse", Denoiser.RELAX_DIFFUSE),
                              ("specular", Denoiser.RELAX_SPECULAR))
               for suffix, settings in (
                   ("", {}),
                   ("_fix_mix", dict(historyFixFrameNum=1, antilagSettings=STRONG_ANTILAG,
                                     historyClampingColorBoxSigmaScale=0.25)),
                   ("_no_clamp", dict(historyFixFrameNum=1, historyClampingColorBoxSigmaScale=0.25,
                                      diffuseMaxFastAccumulatedFrameNum=30,
                                      specularMaxFastAccumulatedFrameNum=30)))}
# The two-signal modes of K19, K20 and K22 on RELAX_DIFFUSE_SPECULAR's calls: (settings, striped
# materials) of each case. The signals' phi (2 and 1 by default), acceleration and reset
# amount (the specular ones scaled by 0.33 and 0.5) differ in every case; "min_material_split"
# gives them different min materials on striped materials and "clamp_split" different clamp
# flags, so that a kernel that swapped a constant of the two signals fails; "min_material_0"
# lets the material test bite for both.
RDS = Denoiser.RELAX_DIFFUSE_SPECULAR
SPLIT_MIN_MATERIAL = dict(minMaterialForDiffuse=0.0, minMaterialForSpecular=2.0)
RDS_FIX_CASES = {"default": ({}, False), "min_material_0": (NO_MIN_MATERIAL, True),
                 "min_material_split": (SPLIT_MIN_MATERIAL, True),
                 "taps_off": (dict(historyFixFrameNum=0), False)}
RDS_CLAMP_CASES = {"default": {}, "fix_mix": CLAMP_CASES["diffuse_fix_mix"][1],
                   "no_clamp": CLAMP_CASES["diffuse_no_clamp"][1],
                   "clamp_split": dict(historyFixFrameNum=1, historyClampingColorBoxSigmaScale=0.25,
                                       diffuseMaxFastAccumulatedFrameNum=30)}
RDS_ATROUS_CASES = {"confidence": (CONFIDENCE_DRIVEN, False),
                    "min_material_split": ({**CONFIDENCE_DRIVEN, **SPLIT_MIN_MATERIAL}, True)}
# The SH modes on the SH variants' calls: SH1 packed from the scene's radiance along a direction
# a signal (the diffuse one against the normal, the specular one along the normal with x and z
# swapped), so that the two signals' SH differ and SH1 has components of the sign opposite to
# the radiance's; the settings of each kernel's calls: the confidences for the à-trous (its
# relaxations), and for K20 `fix_mix` (histories on both sides of the fix and a clamping
# factor strictly between 0 and 1, where the SH lerp bites) with the max fast frame nums at 1,
# so that the TA's slow and responsive SH differ on these short histories (at the defaults
# both alphas are 1 / history length, and the two SH stay equal).
SH_DIRECTIONS = {"diff": lambda n: -n, "spec": lambda n: n[..., [2, 1, 0]]}
SH_VARIANTS = ("RELAX_DIFFUSE_SH", "RELAX_SPECULAR_SH", "RELAX_DIFFUSE_SPECULAR_SH")
SH_KERNELS = ("relax_prepass", "relax_smb_resolve", "relax_vmb_resolve", "relax_history_fix",
              "relax_clamp_moments", "relax_atrous")
SH_SETTINGS = {"default": CONFIDENCE_DRIVEN,
               "fix_mix": dict(RDS_CLAMP_CASES["fix_mix"], diffuseMaxFastAccumulatedFrameNum=1,
                               specularMaxFastAccumulatedFrameNum=1)}
SH_CASES = {f"{name}-{v}": (name, v) for name in SH_KERNELS if name != "relax_atrous"
            for v in SH_VARIANTS if name != "relax_vmb_resolve" or "SPECULAR" in v}

# H4's calls: (denoiser, the call's index in a frame, calls a frame) of each TS half
TS_HALVES = {"diffuse": (Denoiser.REBLUR_DIFFUSE, 0, 1),
             "specular": (Denoiser.REBLUR_SPECULAR, 0, 1),
             "ds_diffuse": (DS, 0, 2), "ds_specular": (DS, 1, 2)}
# and the changes made to a half's recorded calls: maxBlurRadius 0 (no RCRS clamp); splitScreen
# 0.5 on the pixel's and the previous frame's uv; a seeded 30 % of the pixels with one fbits bit
# cleared (the CatRom falls back to the bilinear footprint); virtual history amounts of exactly 0
# and 1 on 20 % of the pixels each, with the previous frame's split screen at 0.5 and the
# virtual-motion uv mirrored on half of the pixels, so that the surface- and virtual-motion
# split tests disagree on both sides; materials striped with strand material 2
TS_CASES = {**{half: (half, "") for half in TS_HALVES},
            **{f"{half}_{v}": (half, v) for half in ("diffuse", "specular")
               for v in ("no_rcrs", "split_screen", "occluded")},
            "specular_virtual_amounts": ("specular", "virtual_amounts"),
            "specular_strand": ("specular", "strand")}

# H2's calls: (denoiser, settings, striped materials) of each case, whose frames' PrePass, Blur
# and PostBlur calls (SF_STAGES, in order) are held by stage
SF_CASES = {"diffuse": (Denoiser.REBLUR_DIFFUSE, {}, False),
            "diffuse_perf": (Denoiser.REBLUR_DIFFUSE, dict(enablePerformanceMode=True), False),
            "diffuse_min_material_0": (Denoiser.REBLUR_DIFFUSE, NO_MIN_MATERIAL, True),
            "specular": (Denoiser.REBLUR_SPECULAR, {}, False),
            "specular_prepass_only": (Denoiser.REBLUR_SPECULAR,
                                      dict(usePrepassOnlyForSpecularMotionEstimation=True), False),
            "specular_min_material_0": (Denoiser.REBLUR_SPECULAR, NO_MIN_MATERIAL, True)}
# K12's calls: each REBLUR variant at each radius, on frames with hit-distance holes
HD_CASES = {f"{sig}_{mode.name.lower()}": (d, mode)
            for sig, d in (("diffuse", Denoiser.REBLUR_DIFFUSE),
                           ("specular", Denoiser.REBLUR_SPECULAR),
                           ("diffuse_specular", DS))
            for mode in (HM.AREA_3X3, HM.AREA_5X5)}

# The checkerboard PrePass of H2 and N4: (denoiser, mode, settings, materials) of each case.
# On the orbit frames no pixel without data loses every tap: its zeroed hit distance gives it
# the minimum radius of 1 px, where some tap lands on its own expanded texel. CB_FALLBACK
# widens the minimum radius to 3 px and draws a material per geometry pixel (both min
# materials 0), so that the fallback fires at about a tenth of the pixels without data;
# usePrepassOnlyForSpecularMotionEstimation weighs every specular tap 0, so that it fires at
# all of them.
CB_FALLBACK = dict(minBlurRadius=3.0, **NO_MIN_MATERIAL)
CB_CASES = {"diffuse_black": (Denoiser.REBLUR_DIFFUSE, CB.BLACK, {}, False),
            "diffuse_white": (Denoiser.REBLUR_DIFFUSE, CB.WHITE, {}, False),
            "diffuse_radius_0": (Denoiser.REBLUR_DIFFUSE, CB.BLACK,
                                 dict(diffusePrepassBlurRadius=0.0), False),
            "diffuse_fallback": (Denoiser.REBLUR_DIFFUSE, CB.WHITE, CB_FALLBACK, "scattered"),
            "specular_black": (Denoiser.REBLUR_SPECULAR, CB.BLACK, {}, False),
            "specular_white": (Denoiser.REBLUR_SPECULAR, CB.WHITE, {}, False),
            "specular_fallback": (Denoiser.REBLUR_SPECULAR, CB.BLACK, CB_FALLBACK, "scattered"),
            "specular_prepass_only": (Denoiser.REBLUR_SPECULAR, CB.WHITE,
                                      dict(usePrepassOnlyForSpecularMotionEstimation=True),
                                      False)}
CB_DS_CASES = {"black": (CB.BLACK, {}, False), "white": (CB.WHITE, {}, False),
               "fallback": (CB.WHITE, CB_FALLBACK, "scattered"),
               "perf": (CB.BLACK, dict(enablePerformanceMode=True), False)}

LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)\s*<<<([^;]*?)>>>\s*\(([^;]*)\);")
DYNAMIC_SHARED = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\s*\[\s*\]\s*;")


def rewrite(src):
    """The two source rewrites that `cuda_shim.h` needs: each launch and each dynamic
    shared-memory array."""
    src = LAUNCH.sub(lambda m: f"shim::launch({m[1]}, shim::Config({m[2]}), {m[3]});", src)
    return DYNAMIC_SHARED.sub(lambda m: f"{m[1]}* {m[2]} = reinterpret_cast<{m[1]}*>"
                                        f"(shim::dynamic_smem);", src)


def compile_library(d):
    """The rehearsal library of SOURCES (`csrc/*.cu`), compiled by g++ in the directory `d`,
    one process a source, all started together; skips without g++. Returns its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the rehearsal compiles the CUDA sources as C++")
    for stub in ("cuda_runtime.h", "cuda_bf16.h"):
        (d / stub).write_text("#pragma once\n")
    units = []
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
    so, part = d / "librehearsal.so", d / "librehearsal.so.part"
    subprocess.run([gxx, "-shared", "-pthread", "-o", str(part),
                    *[str(u.with_suffix(".o")) for u in units]], check=True)
    part.rename(so)
    return so


def shared_library(tmp_path_factory):
    """The rehearsal library, built once a test run: the first test process that asks builds
    it under a lock in the run's temporary root (the one that the pytest-xdist workers share),
    in a directory named by a hash of the sources and the shim; the others load it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    digest = hashlib.sha256()
    for f in sorted(build.CSRC.iterdir()) + [SHIM]:
        digest.update(f.name.encode() + f.read_bytes())
    d = root / f"rehearsal-{digest.hexdigest()[:16]}"
    with open(root / "rehearsal.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        so = d / "librehearsal.so"
        if not so.exists():
            d.mkdir(exist_ok=True)
            compile_library(d)
    lib = ctypes.CDLL(str(so))
    lib.nrd_error_string.argtypes = [ctypes.c_int]
    lib.nrd_error_string.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    return shared_library(tmp_path_factory)


class _Stream:
    cuda_stream = 0


@contextlib.contextmanager
def kernels_on_cpu(lib):
    """The wrappers launch the rehearsal library on CPU tensors."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "kernel_device", lambda t: t.device)
        mp.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
        yield


def _ramp(rng, h, w):
    r = np.linspace(0.2, 1.0, w, dtype=np.float32)[None, :] + rng.uniform(-0.1, 0.1, (h, w))
    return np.clip(r, 0.0, 1.0).astype(np.float32)


def _striped(fd):
    """Materials 0-3 in stripes fixed to the surfaces (one world unit of x each), so that
    footprints and taps often land on another material; the scene itself has almost one."""
    return np.where(fd.hit_mask > 0, np.floor(fd.world_pos[..., 0]) % 4.0, 0.0).astype(
        np.float32)


def _scattered(fd, i):
    """Materials 0-3 drawn per geometry pixel from a seed, so that any tap may fail the
    material test."""
    rng = np.random.default_rng((23, i))
    return np.where(fd.hit_mask > 0, rng.integers(0, 4, fd.view_z.shape), 0).astype(np.float32)


def _half_width(plane, frame, mode):
    """The checkerboard's half-width input of a full-width plane: half texel x holds the pixel
    of the pair (2x, 2x + 1) that has data in this frame under `mode`
    (tests/test_reblur_full.py:244-250)."""
    h, w = plane.shape[:2]
    has = ((np.arange(w)[None, :] + np.arange(h)[:, None] + frame) & 1) == int(mode) - 1
    sel = np.where(has[:, ::2], 0, 1) + np.arange(0, w, 2)[None, :]
    return np.ascontiguousarray(plane[np.arange(h)[:, None], sel])


def _pools(kind, encoding=RoughnessEncoding.LINEAR, holes=False, materials=False,
           motion="mv_z_given", sh=False, checkerboard=CB.OFF):
    """The inputs of each frame for "reblur", "relax" or "sigma" (the penumbra from the
    scene's distance to the occluder, and a constant translucency), the roughness packed
    with `encoding`; with `holes` the hit distance zeroed on a seeded HOLE_FRACTION of the
    geometry pixels (REBLUR's also on every geometry pixel of the image border); with
    `materials` the materials striped (`_striped`); the motion vectors as `motion` of MOTIONS
    says; with `sh` RELAX's SH0 / SH1 too (`relax_pack_sh`, SH1 along SH_DIRECTIONS); under
    a `checkerboard` mode REBLUR's signals at half width (`_half_width`). `materials`
    "scattered" draws them per pixel (`_scattered`)."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    rng = np.random.default_rng(11)
    relax = kind == "relax"
    for i in range(FRAMES):
        fd = gen.frame(i)
        if materials:
            fd.material_id = _scattered(fd, i) if materials == "scattered" else _striped(fd)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        if motion == "mv_z_scaled":
            fd.common_settings.motionVectorScale = (1.0, 1.0, MV_Z_SCALE)
        elif motion == "mv_z_computed":
            fd.common_settings.motionVectorScale = (1.0, 1.0, 0.0)
        elif motion == "world_mv":
            fd.common_settings.isMotionVectorInWorldSpace = True
            fd.mv = np.zeros_like(fd.mv)
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd, re_=encoding)}
        punched = ((np.random.default_rng((17, i)).random(fd.view_z.shape) < HOLE_FRACTION)
                   & (fd.hit_mask > 0))
        border = np.ones(fd.view_z.shape, bool)
        border[1:-1, 1:-1] = False
        if kind == "sigma":
            dist = torch.from_numpy(fd.dist_to_occluder)
            pool[RT.IN_PENUMBRA] = fe.sigma_pack_penumbra_directional(
                dist, gen.spec.light_tan_angular_radius).numpy()
            rgb = torch.tensor(TRANSLUCENCY_RGB).expand(SIZE[1], SIZE[0], 3)
            pool[RT.IN_TRANSLUCENCY] = fe.sigma_pack_translucency(dist, rgb).numpy()
            yield fd.common_settings, pool
            continue
        for rt, noisy, hit, conf in (
                (RT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist,
                 RT.IN_DIFF_CONFIDENCE),
                (RT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist,
                 RT.IN_SPEC_CONFIDENCE)):
            if relax and sh:
                sig = "diff" if rt == RT.IN_DIFF_RADIANCE_HITDIST else "spec"
                sh0, sh1 = fe.relax_pack_sh(
                    torch.from_numpy(noisy), torch.from_numpy(hit),
                    SH_DIRECTIONS[sig](torch.from_numpy(fd.normal.astype(np.float32))))
                sh_rt = ((RT.IN_DIFF_SH0, RT.IN_DIFF_SH1) if sig == "diff"
                         else (RT.IN_SPEC_SH0, RT.IN_SPEC_SH1))
                pool[sh_rt[0]], pool[sh_rt[1]] = sh0.numpy(), sh1.numpy()
                pool[conf] = _ramp(rng, SIZE[1], SIZE[0])
            elif relax:
                pool[rt] = fe.relax_pack_radiance_hitdist(torch.from_numpy(noisy),
                                                          torch.from_numpy(hit)).numpy()
                if holes:
                    pool[rt][..., 3][punched] = 0.0
                pool[conf] = _ramp(rng, SIZE[1], SIZE[0])
            else:
                rough = (torch.from_numpy(fd.roughness) if rt == RT.IN_SPEC_RADIANCE_HITDIST
                         else torch.ones(SIZE[1], SIZE[0]))
                nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(hit),
                                                  torch.from_numpy(fd.view_z), HDP, rough)
                pool[rt] = fe.reblur_pack_radiance_hitdist(torch.from_numpy(noisy), nhd).numpy()
                if holes:
                    pool[rt][..., 3][punched | (border & (fd.hit_mask > 0))] = 0.0
                if checkerboard != CB.OFF:
                    pool[rt] = _half_width(pool[rt], i, checkerboard)
        yield fd.common_settings, pool


def _record(denoiser, name, env=None, encoding=RoughnessEncoding.LINEAR, holes=False,
            materials=False, motion="mv_z_given", **settings):
    """Every call of the wrapper `name` over the frames, through the port's Engine on the
    CPU (where the wrappers run their plain versions), at the roughness encoding
    `encoding`, on frames with hit-distance holes if `holes`, striped materials if
    `materials` and the motion vectors of `motion` (an SH variant's frames with SH0 and SH1).
    With a tuple of names, a dict of each one's calls, from the one run."""
    names = name if isinstance(name, tuple) else (name,)
    calls = {n: [] for n in names}
    eng = Engine({0: denoiser}, resource_size=SIZE, roughness_encoding=encoding, device="cpu")
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
        for key, value in (env or {}).items():
            mp.setenv(key, value)
        kind = denoiser.name.split("_")[0].lower()
        for cs, pool in _pools(kind, encoding, holes, materials, motion,
                               sh=denoiser.name.endswith("_SH"),
                               checkerboard=settings.get("checkerboardMode", CB.OFF)):
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    return calls if isinstance(name, tuple) else calls[name]


@pytest.fixture(scope="module")
def atrous_calls():
    return {mode: _record(denoiser, "relax_atrous", **CONFIDENCE_DRIVEN)
            for mode, denoiser in (("diffuse", Denoiser.RELAX_DIFFUSE),
                                   ("specular", Denoiser.RELAX_SPECULAR))}


def _flat(r):
    if isinstance(r, dict):
        return r
    return dict(enumerate(r)) if isinstance(r, tuple) else {"out": r}


def _hold(lib, name, calls, exact=()):
    """Run each call through the rehearsal kernel and the plain version; return the values
    outside the tolerance, the values and the largest difference. The outputs named in
    `exact` must be equal."""
    mod = KM.MODULES[name]
    over = count = 0
    worst = 0.0
    for a, k in calls:
        with kernels_on_cpu(lib):
            before = mod.launches
            got = getattr(mod, name)(*a, **k)
            assert mod.launches == before + 1
        want = getattr(mod, name + "_ref")(*a, **k)
        got, want = (_flat(r) for r in (got, want))
        for key, w in want.items():
            if w is None:
                continue
            if key in exact:
                assert torch.equal(got[key], w), f"{name}: {key} differs"
            w = w.float()  # a flag (allow_catrom) as 0 / 1
            d = (got[key].float() - w).abs()
            over += int((d > ATOL + RTOL * w.abs()).sum())
            count += d.numel()
            worst = max(worst, float(d.max()))
    return over, count, worst


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("mode", ["diffuse", "specular"])
def test_relax_atrous_rehearsal(library, atrous_calls, mode, step):
    calls = [(a, k) for a, k in atrous_calls[mode] if k["step_size"] == step]
    assert len(calls) == FRAMES
    # the signal's confidence reaches the kernel (diff_confidence, spec_confidence)
    assert all(a[4 if mode == "diffuse" else 5] is not None for a, _ in calls)
    over, count, worst = _hold(library, "relax_atrous", calls)
    assert over <= FLIP_FRACTION * count, (f"{mode} step {step}: {over} of {count} values out "
                                           f"of tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(BAND_CASES))
def test_reblur_band_rehearsal(library, case):
    calls = _record(Denoiser.REBLUR_DIFFUSE_SPECULAR, "reblur_band",
                    env={"NRDTPU_REBLUR_BAND": "1"}, **BAND_CASES[case])
    assert len(calls) == FRAMES
    over, count, worst = _hold(library, "reblur_band", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


def test_poisson_table_is_tap_table():
    """The kernels' compile-time Poisson tables (`reblur_filters.cuh:kPoissonTaps8`, `6`) are
    `spatial_filter.tap_table` bit for bit, 8 taps and the 6 of performance mode."""
    from nrdtpu_torch.kernels import spatial_filter as sf

    src = (build.CSRC / "reblur_filters.cuh").read_text()
    for n, perf in ((8, False), (6, True)):
        body = re.search(rf"kPoissonTaps{n}\[{n} \* 3\] = \{{(.*?)\}};", src, re.S)[1]
        literals = [v.strip().rstrip("f") for v in body.split(",")]
        got = np.array([float.fromhex(v) if "0x" in v else float(v) for v in literals],
                       np.float32).reshape(n, 3)
        assert sf.ntaps(perf) == n
        np.testing.assert_array_equal(got, sf.tap_table(perf))


@pytest.fixture(scope="module")
def ds_calls():
    """N4's and N5's calls of REBLUR_DIFFUSE_SPECULAR, by default, with the anti-firefly ring
    and in performance mode."""
    out = {}
    for case, settings in BAND_CASES.items():
        out[case] = {name: _record(DS, name, **settings)
                     for name in ("spatial_filter_fused", "history_fix_fused")}
    return out


@pytest.mark.parametrize("stage", SF_STAGES + ("perf",))
def test_spatial_filter_fused_rehearsal(library, ds_calls, stage):
    case = "perf" if stage == "perf" else "default"
    calls = ds_calls[case]["spatial_filter_fused"]
    assert len(calls) == FRAMES * len(SF_STAGES)
    if stage != "perf":
        calls = calls[SF_STAGES.index(stage)::len(SF_STAGES)]
        # the PrePass unpacks its taps; Blur and PostBlur read N5's tap-geometry plane
        assert all((k["prepass"] is not None) == (stage == "prepass") for _, k in calls)
        assert all((k["geometry"] is None) == (stage == "prepass") for _, k in calls)
    over, count, worst = _hold(library, "spatial_filter_fused", calls)
    assert over <= FLIP_FRACTION * count, (f"{stage}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", ["default", "anti_firefly"])
def test_history_fix_fused_rehearsal(library, ds_calls, case):
    calls = ds_calls[case]["history_fix_fused"]
    assert len(calls) == FRAMES
    assert all(k["anti_firefly"] == ((case == "anti_firefly"),) * 2 for _, k in calls)
    over, count, worst = _hold(library, "history_fix_fused", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


def test_geometry_plane_chain_rehearsal(library, ds_calls):
    """N5's kernel writes the tap-geometry plane that N4's Blur kernel then reads: the chain
    of the two kernels against the plain versions."""
    hff, sff = KM.MODULES["history_fix_fused"], KM.MODULES["spatial_filter_fused"]
    fix = ds_calls["default"]["history_fix_fused"]
    blur = ds_calls["default"]["spatial_filter_fused"][1::len(SF_STAGES)]
    worst = 0.0
    for (fa, fk), (ba, bk) in zip(fix, blur):
        with kernels_on_cpu(library):
            plane = hff.history_fix_fused(*fa, **fk)["geometry"]
            got = sff.spatial_filter_fused(*ba, **dict(bk, geometry=plane))
        want = sff.spatial_filter_fused_ref(*ba, **bk)
        for key in ("diff", "spec"):
            d = (got[key] - want[key]).abs()
            assert int((d > ATOL + RTOL * want[key].abs()).sum()) <= FLIP_FRACTION * d.numel()
            worst = max(worst, float(d.max()))
    assert worst < 1e-3


@pytest.mark.parametrize("mode", list(SIGMA_MODES))
def test_sigma_blur_rehearsal(library, mode):
    """K13 in each of its modes: <1, first pass, no shadow input>, <1, PostBlur, shadow>,
    <4, first pass, shadow>, <4, PostBlur, shadow>."""
    denoiser, stage = SIGMA_MODES[mode]
    calls = _record(denoiser, "sigma_blur")
    assert len(calls) == 2 * FRAMES
    calls = calls[stage::2]
    assert all(k["first_pass"] == (stage == 0) for _, k in calls)
    channels = 4 if denoiser == Denoiser.SIGMA_SHADOW_TRANSLUCENCY else 1
    for a, _ in calls:
        shadow = a[1]
        if mode == "shadow_blur":
            assert shadow is None
        else:
            assert shadow.shape[-1] == channels
    over, count, worst = _hold(library, "sigma_blur", calls)
    assert over <= FLIP_FRACTION * count, (f"{mode}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(HISTORY_FIX_CASES))
def test_relax_history_fix_rehearsal(library, case):
    """K19's prologue (the tap records) and taps against the plain version; with a frame num
    of 1 the entry runs neither and passes the signal through."""
    denoiser, settings = HISTORY_FIX_CASES[case]
    calls = _record(denoiser, "relax_history_fix", **settings)
    assert len(calls) == FRAMES
    assert all((k["frame_num"] == 1.0) == (case == "taps_off") for _, k in calls)
    assert all((k["specular"] is not None) == (case == "specular") for _, k in calls)
    # the taps run on some pixels of every frame (all of them on the first)
    if case != "taps_off":
        assert all(bool((a[3] <= k["frame_num"]).any()) for a, k in calls)
    over, count, worst = _hold(library, "relax_history_fix", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")
    if case == "taps_off":
        assert worst == 0.0


@pytest.mark.parametrize("denoiser", ["RELAX_DIFFUSE", "RELAX_SPECULAR",
                                      "RELAX_DIFFUSE_SPECULAR"])
def test_relax_smb_resolve_rehearsal(library, denoiser):
    """K16 (the staged 3x3 window, the 12 occlusion taps, the histories through one CatRom-12
    footprint) against the plain version, smb_found equal; the frames give both bicubic
    (smb_found 2) and bilinear-fallback (1) footprints. RELAX_DIFFUSE_SPECULAR runs its
    `<true, 4>` instance: the specular planes and four histories."""
    calls = _record(Denoiser[denoiser], "relax_smb_resolve")
    assert len(calls) == FRAMES
    assert all((a[9] is not None) == (denoiser != "RELAX_DIFFUSE") for a, _ in calls)
    assert all(len(a[8]) == (4 if denoiser == "RELAX_DIFFUSE_SPECULAR" else 2) for a, _ in calls)
    found = torch.cat([KM.relax_smb_resolve.relax_smb_resolve_ref(*a, **k)["smb_found"]
                       .flatten() for a, k in calls])
    assert bool((found == 2.0).any()) and bool((found == 1.0).any())
    over, count, worst = _hold(library, "relax_smb_resolve", calls, exact=("smb_found",))
    assert over <= FLIP_FRACTION * count, (f"{denoiser}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


def test_relax_vmb_resolve_rehearsal(library):
    """K17 (both histories through one CatRom footprint) against the plain version, any
    and all equal; the frames give both footprints: bicubic (K16's footprint bicubic and all
    four taps valid) and the bilinear fallback (some tap valid, not all)."""
    calls = _record(Denoiser.RELAX_SPECULAR, "relax_vmb_resolve")
    assert len(calls) == FRAMES
    bicubic = fallback = False
    for a, k in calls:
        r = KM.relax_vmb_resolve.relax_vmb_resolve_ref(*a, **k)
        bicubic |= bool(((a[5] == 2.0) & (r["all"] > 0.0)).any())
        fallback |= bool(((r["any"] > 0.0) & ((a[5] != 2.0) | (r["all"] == 0.0))).any())
    assert bicubic and fallback
    over, count, worst = _hold(library, "relax_vmb_resolve", calls, exact=("any", "all"))
    assert over <= FLIP_FRACTION * count, (f"{over} of {count} values out of tolerance, "
                                           f"max |d| {worst:.3g}")


@pytest.mark.parametrize("encoding", ["SQ_LINEAR", "SQRT_LINEAR"])
@pytest.mark.parametrize("name", ENCODED_KERNELS)
def test_roughness_encoding_rehearsal(library, name, encoding):
    """K15, K19, K22 and K12 in the roughness mode of the encoding, on RELAX_SPECULAR's calls
    with AREA_3X3 reconstruction on frames with hit-distance holes."""
    enc = RoughnessEncoding[encoding]
    calls = _record(Denoiser.RELAX_SPECULAR, name, encoding=enc, holes=True,
                    hitDistanceReconstructionMode=HM.AREA_3X3)
    assert len(calls) == FRAMES * (len(STEPS) if name == "relax_atrous" else 1)
    assert all(k["roughness_encoding"] == enc for _, k in calls)
    over, count, worst = _hold(library, name, calls)
    assert over <= FLIP_FRACTION * count, (f"{name} {encoding}: {over} of {count} values out "
                                           f"of tolerance, max |d| {worst:.3g}")


def _materials(calls, nr_arg):
    """The distinct packed materials of the calls' current normal/roughness planes."""
    return torch.unique(torch.cat([a[nr_arg][..., 3].flatten() for a, _ in calls]))


@pytest.mark.parametrize("case", list(SMB_CASES))
def test_smb_resolve_rehearsal(library, case):
    """H1 (the staged 17x17 window, the 12 occlusion taps, every signal's history through one
    CatRom footprint of bf16 texels) against the plain version, fbits and allow_catrom equal;
    the frames give both bicubic and bilinear-fallback footprints. With the min materials at 0
    the materials are striped, so that the material test bites."""
    denoiser, settings = SMB_CASES[case]
    calls = _record(denoiser, "smb_resolve", materials=bool(settings), **settings)
    assert len(calls) == FRAMES
    assert all((k["second"] is not None) == (denoiser == DS) for _, k in calls)
    assert all(k["min_material"] == (0.0 if settings else 4.0) for _, k in calls)
    assert len(_materials(calls, 4)) == (4 if settings else 2)
    catrom = torch.cat([KM.smb_resolve.smb_resolve_ref(*a, **k)["allow_catrom"].flatten()
                        for a, k in calls])
    assert bool(catrom.any()) and not bool(catrom.all())
    over, count, worst = _hold(library, "smb_resolve", calls, exact=("fbits", "allow_catrom"))
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(PREPASS_CASES))
def test_relax_prepass_rehearsal(library, case):
    """K15 (the rolled tap loop, float4 signal and normal a tap, the snap by reciprocal) at
    LINEAR against the plain version, in both modes, at a plane-distance threshold of 0.03 and
    with the min materials at 0 on striped materials (the material test biting)."""
    denoiser, settings = PREPASS_CASES[case]
    striped = "min_material" in case
    calls = _record(denoiser, "relax_prepass", materials=striped, **settings)
    assert len(calls) == FRAMES
    assert all((k["specular"] is not None) == (denoiser == Denoiser.RELAX_SPECULAR)
               for _, k in calls)
    assert all(k["roughness_encoding"] == RoughnessEncoding.LINEAR for _, k in calls)
    assert all(k["depth_threshold"] == np.float32(settings.get("depthThreshold", 0.003))
               for _, k in calls)
    assert all(k["min_material"] == (0.0 if striped else 4.0) for _, k in calls)
    assert len(_materials(calls, 2)) == (4 if striped else 2)
    over, count, worst = _hold(library, "relax_prepass", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(SIGMA_TS_CASES))
def test_sigma_ts_rehearsal(library, case):
    """K14 (the reprojection in the kernel, the staged 20x20 window of the 5x5 moments, the
    history through the CatRom gather, the hard-shadow and dead-pixel early outs) against the
    plain version, in each channel count under each motion-vector branch: the mv's z given
    (also scaled), computed from world_to_view_prev, and the world-space mv projected by
    world_to_clip_prev; and with penumbra-0 pixels. Every frame has pixels that run the
    reprojection and pixels that pass through."""
    denoiser, motion = SIGMA_TS_CASES[case]
    calls = _record(denoiser, "sigma_ts", motion="mv_z_given" if motion == "umbra" else motion)
    assert len(calls) == FRAMES
    if motion == "umbra":
        rng = np.random.default_rng(23)
        for a, _ in calls:
            umbra = torch.from_numpy(rng.random(tuple(a[1].shape)) < UMBRA_FRACTION)
            assert not bool((a[1] == 0.0).any())
            a[1][umbra] = 0.0
    mvs = [np.asarray(k["reprojection"]["mv_scale"]) for _, k in calls]
    assert all((m[2] == 0.0) == (motion == "mv_z_computed") for m in mvs)
    assert all((m[2] == MV_Z_SCALE) == (motion == "mv_z_scaled") for m in mvs)
    assert all((m[3] != 0.0) == (motion == "world_mv") for m in mvs)
    assert all(bool((a[3] == 0.0).all()) == (motion == "world_mv") for a, _ in calls)
    channels = 4 if denoiser == Denoiser.SIGMA_SHADOW_TRANSLUCENCY else 1
    for a, k in calls:
        assert a[0].shape[-1] == channels
        penumbra, view_z_in, tile = a[1], a[2], a[7]
        live = ((tile[0] != 0.0) & (penumbra != 0.0) & (tile[1] == 0.0)
                & (view_z_in.abs() * k["view_z_scale"] <= k["denoising_range"]))
        assert bool(live.any()) and not bool(live.all())
    over, count, worst = _hold(library, "sigma_ts", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(HISTORY_FIX_H3_CASES))
def test_history_fix_rehearsal(library, case):
    """H3 (N5's CTA body for one signal: the staged fast-history window, the taps, the clamp)
    against the plain version (the taps, the moments and `params.history_fix_clamp`), on
    REBLUR_DIFFUSE and REBLUR_SPECULAR, with the anti-firefly ring, and with both min
    materials 0 on striped materials. Every frame has pixels that run the taps."""
    denoiser, settings = HISTORY_FIX_H3_CASES[case]
    striped = "min_material" in case
    calls = _record(denoiser, "history_fix", materials=striped, **settings)
    assert len(calls) == FRAMES
    spec = denoiser == Denoiser.REBLUR_SPECULAR
    assert all((a[7] is not None) == spec for a, _ in calls)
    assert all(k["anti_firefly"] == ("anti_firefly" in case) for _, k in calls)
    assert all(k["min_material"] == (0.0 if striped else 4.0) for _, k in calls)
    assert len(_materials(calls, 2)) == (4 if striped else 2)
    assert all(bool((a[6][0] != 0.0).any()) for a, _ in calls)  # the stride plane
    over, count, worst = _hold(library, "history_fix", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(CLAMP_CASES))
def test_relax_clamp_moments_rehearsal(library, case):
    """K20 (the responsive history picked per texel, the staged 20x20 window of the 5x5 moments,
    the whole clamp pass) against the plain version, on RELAX_DIFFUSE and RELAX_SPECULAR: every
    frame has pixels beyond the denoising range; with historyFixFrameNum = 1 the histories lie
    on both sides of the fix, and the acceleration and the reset move the output; with the
    clamp off the slow history passes unclamped."""
    denoiser, settings = CLAMP_CASES[case]
    calls = _record(denoiser, "relax_clamp_moments", **settings)
    assert len(calls) == FRAMES
    # the first frame resets the history: its max frame nums are 0, the clamp off
    assert all(k["clamp"] == (i > 0 and "no_clamp" not in case) for i, (_, k) in enumerate(calls))
    assert all(bool((a[0].abs() * k["view_z_scale"] >= k["denoising_range"]).any())
               for a, k in calls)
    in_fix = torch.cat([(a[3] <= k["history_fix_frame_num"]).flatten() for a, k in calls])
    if case.endswith(("_fix_mix", "_no_clamp")):
        assert bool(in_fix.any()) and not bool(in_fix.all())
    if case.endswith("_fix_mix"):
        ref = KM.relax_clamp_moments.relax_clamp_moments_ref
        for key in ("acceleration", "reset_amount"):
            assert any(not torch.equal(ref(*a, **k)[0], ref(*a, **dict(k, **{key: 0.0}))[0])
                       for a, k in calls), key
    over, count, worst = _hold(library, "relax_clamp_moments", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.fixture(scope="module")
def ts_calls():
    """H4's calls of a REBLUR denoiser over the frames, with or without striped materials."""
    cache = {}

    def get(denoiser, materials):
        if (denoiser, materials) not in cache:
            cache[denoiser, materials] = _record(denoiser, "ts_prelude", materials=materials)
        return cache[denoiser, materials]
    return get


def _ts_variant(calls, variant):
    """The recorded calls of one TS half with the inputs or constants of `variant` changed
    (TS_CASES)."""
    rng = np.random.default_rng(29)
    out = []
    for a, k in calls:
        a, k = list(a), dict(k)
        if variant == "no_rcrs":
            k["max_blur_radius"] = 0.0
        if variant == "split_screen":
            k["split_screen"] = k["split_screen_prev"] = 0.5
        if variant == "virtual_amounts":  # the previous frame's split only
            k["split_screen_prev"] = 0.5
        if variant == "occluded":
            bits = a[3].to(torch.int32)
            hit = torch.from_numpy(rng.random(tuple(bits.shape)) < 0.3)
            bit = torch.from_numpy(rng.integers(0, 8, tuple(bits.shape))).to(torch.int32)
            cleared = bits & ~torch.bitwise_left_shift(torch.ones_like(bit), bit)
            a[3] = torch.where(hit, cleared, bits).to(torch.float32)
        if variant == "virtual_amounts":
            r = torch.from_numpy(rng.random(tuple(a[6].shape)))
            a[6] = torch.where(r < 0.2, 0.0, torch.where(r > 0.8, 1.0, a[6]))
            mirror = torch.from_numpy(rng.random(tuple(a[6].shape)) < 0.5)
            vmb = a[5].clone()
            vmb[..., 0] = torch.where(mirror, 1.0 - a[2][..., 0], vmb[..., 0])
            a[5] = vmb
        if variant == "strand":
            k["strand_material_id"] = 2.0
        out.append((tuple(a), k))
    return out


@pytest.mark.parametrize("case", list(TS_CASES))
def test_ts_prelude_rehearsal(library, ts_calls, case):
    """H4 (the staged 18x18 luma window, the history through the CatRom gather at each motion,
    the rest of the TS half) against the plain version, on each half of REBLUR_DIFFUSE,
    REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR, and with the changes of TS_CASES, each of which
    is asserted to reach the kernel's inputs."""
    half, variant = TS_CASES[case]
    denoiser, index, per_frame = TS_HALVES[half]
    calls = ts_calls(denoiser, variant == "strand")
    assert len(calls) == per_frame * FRAMES
    calls = _ts_variant(calls[index::per_frame], variant)
    spec = half.endswith("specular")
    assert all((len(a) == 8) == spec for a, _ in calls)
    ref = KM.ts_prelude.ts_prelude_ref
    if variant in ("no_rcrs", "split_screen"):  # the change moves the output
        base = ts_calls(denoiser, False)[index::per_frame]
        assert any(not torch.equal(ref(*a, **k)["signal"], ref(*b, **kb)["signal"])
                   for (a, k), (b, kb) in zip(calls, base))
    if variant == "occluded":  # both footprints, of each motion's bits
        for first in (0, 4) if spec else (0,):
            four = torch.cat([((a[3].to(torch.int32) >> first) & 15).flatten() for a, _ in calls])
            assert bool((four == 15).any()) and bool((four != 15).any())
    if variant == "virtual_amounts":  # the split tests disagree where the amount is 0 or 1
        for amount in (0.0, 1.0):
            assert any(bool(((a[6] == amount) & ((a[2][..., 0] >= 0.5) != (a[5][..., 0] >= 0.5)))
                            .any()) for a, _ in calls)
    if variant == "strand":
        assert any(bool((a[7][..., 3] * 3.0 == 2.0).any()) for a, _ in calls)
    over, count, worst = _hold(library, "ts_prelude", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.fixture(scope="module")
def sf_calls():
    """H2's and H3's calls of each SF_CASES case over the frames, which have hit-distance holes
    (where the PrePass radius falls to its minimum)."""
    cache = {}

    def get(case):
        if case not in cache:
            denoiser, settings, striped = SF_CASES[case]
            cache[case] = {name: _record(denoiser, name, holes=True, materials=striped,
                                         **settings)
                           for name in ("spatial_filter", "history_fix")}
        return cache[case]
    return get


@pytest.mark.parametrize("stage", SF_STAGES)
@pytest.mark.parametrize("case", list(SF_CASES))
def test_spatial_filter_rehearsal(library, sf_calls, case, stage):
    """H2 (the centre's geometry and parameters in the kernel, then the tap loop) against the
    plain version (`params.filter_geometry`, the glue's parameter functions and the XLA tap
    loop) by stage on frames with hit-distance holes: the specular PrePass with
    hitDistForTracking and its PCG draws (with usePrepassOnlyForSpecularMotionEstimation its
    taps weigh 0), Blur and PostBlur with the taps on H3's geometry plane, performance mode's
    6 taps, and both min materials 0 on striped materials."""
    denoiser, settings, striped = SF_CASES[case]
    calls = sf_calls(case)["spatial_filter"]
    assert len(calls) == FRAMES * len(SF_STAGES)
    calls = calls[SF_STAGES.index(stage)::len(SF_STAGES)]
    spec = denoiser == Denoiser.REBLUR_SPECULAR
    assert all(k["mode"] == SF_STAGES.index(stage) and k["spec"] == spec for _, k in calls)
    assert all(k["perf_mode"] == ("perf" in case) for _, k in calls)
    assert all(float(k["dc"]["use_prepass_not_only_for_specular_motion_estimation"])
               == (0.0 if "prepass_only" in case else 1.0) for _, k in calls)
    assert all(float(k["dc"]["spec_min_material" if spec else "diff_min_material"])
               == (0.0 if striped else 4.0) for _, k in calls)
    assert len(_materials(calls, 2)) == (4 if striped else 2)
    assert all(bool((a[0][..., 3] == 0.0).any()) for a, _ in calls)  # holes or dead pixels
    assert all((k["geometry"] is None) == (stage == "prepass") for _, k in calls)
    over, count, worst = _hold(library, "spatial_filter", calls)
    assert over <= FLIP_FRACTION * count, (f"{case} {stage}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", ["diffuse", "specular"])
def test_history_fix_plane_chain_rehearsal(library, sf_calls, case):
    """H3's kernel writes the tap-geometry plane that H2's Blur kernel then reads: the chain of
    the two kernels against the plain versions."""
    hf, sf = KM.MODULES["history_fix"], KM.MODULES["spatial_filter"]
    calls = sf_calls(case)
    blur = calls["spatial_filter"][1::len(SF_STAGES)]
    assert len(calls["history_fix"]) == len(blur) == FRAMES
    worst = 0.0
    for (fa, fk), (ba, bk) in zip(calls["history_fix"], blur):
        with kernels_on_cpu(library):
            plane = hf.history_fix(*fa, **fk)["geometry"]
            got = sf.spatial_filter(*ba, **dict(bk, geometry=plane))
        want = sf.spatial_filter_ref(*ba, **bk)
        assert torch.equal(plane, hf.history_fix_ref(*fa, **fk)["geometry"])
        d = (got - want).abs()
        assert int((d > ATOL + RTOL * want.abs()).sum()) <= FLIP_FRACTION * d.numel()
        worst = max(worst, float(d.max()))
    assert worst < 1e-3


@pytest.mark.parametrize("case", list(HD_CASES))
def test_hitdist_recon_rehearsal(library, case):
    """K12 (the staged window of derived texels, the centre's parameters in the kernel, whole
    float4 signals written) against the plain version on REBLUR's calls, on frames with
    hit-distance holes: the holes are refilled, the image border's too, and .xyz pass
    through; and with a roughness texture."""
    denoiser, mode = HD_CASES[case]
    calls = _record(denoiser, "hitdist_recon", holes=True, hitDistanceReconstructionMode=mode)
    assert len(calls) == FRAMES
    names = [n for n, present in (("diff", "DIFFUSE" in denoiser.name),
                                  ("spec", "SPECULAR" in denoiser.name)) if present]
    ref = KM.hitdist_recon.hitdist_recon_ref
    for a, k in calls:
        assert k["radius"] == (2 if mode == HM.AREA_5X5 else 1)
        assert [a[2] is not None, a[3] is not None] == [n in names for n in ("diff", "spec")]
        want = ref(*a, **k)
        for n in names:
            src = a[2 if n == "diff" else 3]
            holes = src[..., 3] == 0.0
            assert bool(holes[0].any() or holes[-1].any() or holes[:, 0].any()
                        or holes[:, -1].any())
            assert bool((want[n][..., 3][holes] > 0.0).any())
            assert torch.equal(want[n][..., :3], src[..., :3])
    # the scene's roughness is constant on each surface, where the roughness weight is 1 at any
    # parameter: the calls again with a seeded roughness texture
    rng = np.random.default_rng(31)
    textured = []
    for a, k in calls:
        nr = a[1].clone()
        nr[..., 2] = torch.from_numpy(rng.random(tuple(nr.shape[:2]), dtype=np.float32))
        textured.append(((a[0], nr, *a[2:]), k))
    over, count, worst = _hold(library, "hitdist_recon", calls + textured)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.fixture(scope="module")
def rds_atrous_calls():
    return {case: _record(RDS, "relax_atrous", materials=striped, **settings)
            for case, (settings, striped) in RDS_ATROUS_CASES.items()}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("case", list(RDS_ATROUS_CASES))
def test_relax_atrous_pair_rehearsal(library, rds_atrous_calls, case, step):
    """K22's two-signal instance (one launch for the diffuse and the specular signal, the tap
    geometry shared, each signal's own weights and constants) against the plain version, at
    every stride of RELAX_DIFFUSE_SPECULAR's ladder with both confidences, and with the
    signals' min materials apart on striped materials."""
    calls = [(a, k) for a, k in rds_atrous_calls[case] if k["step_size"] == step]
    assert len(calls) == FRAMES
    assert all(isinstance(a[0], tuple) and a[4] is not None and a[5] is not None
               for a, _ in calls)
    assert all(k["phi_luminance"][0] != k["phi_luminance"][1] for _, k in calls)
    if case == "min_material_split":
        assert all(k["min_material"] == (0.0, 2.0) for _, k in calls)
        assert len(_materials(calls, 2)) == 4
    over, count, worst = _hold(library, "relax_atrous", calls)
    assert over <= FLIP_FRACTION * count, (f"{case} step {step}: {over} of {count} values out "
                                           f"of tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(RDS_FIX_CASES))
def test_relax_history_fix_pair_rehearsal(library, case):
    """K19's phase for both signals (one record prologue, each tap's records read once, a
    weight, min material and accumulator a signal) against the plain version on
    RELAX_DIFFUSE_SPECULAR: by default, with both min materials 0 and with them apart on
    striped materials, and with historyFixFrameNum = 0 (no taps, no prologue)."""
    settings, striped = RDS_FIX_CASES[case]
    calls = _record(RDS, "relax_history_fix", materials=striped, **settings)
    assert len(calls) == FRAMES
    assert all(isinstance(a[0], tuple) and k["specular"] is not None for a, k in calls)
    assert all((k["frame_num"] == 1.0) == (case == "taps_off") for _, k in calls)
    if striped:
        assert len(_materials(calls, 2)) == 4
        assert all(k["min_material"] == (0.0, 2.0 if case == "min_material_split" else 0.0)
                   for _, k in calls)
    if case != "taps_off":
        assert all(bool((a[3] <= k["frame_num"]).any()) for a, k in calls)
    over, count, worst = _hold(library, "relax_history_fix", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")
    if case == "taps_off":
        assert worst == 0.0


@pytest.mark.parametrize("case", list(RDS_CLAMP_CASES))
def test_relax_clamp_moments_pair_rehearsal(library, case):
    """K20 with both signals in one launch (each signal's window, constants and outputs)
    against the plain version on RELAX_DIFFUSE_SPECULAR: by default, with the strong antilag
    and the histories on both sides of the fix, with the colour box off for both signals
    (NO_FAST_CLAMP's frame nums) and off for the diffuse one only."""
    settings = RDS_CLAMP_CASES[case]
    calls = _record(RDS, "relax_clamp_moments", **settings)
    assert len(calls) == FRAMES
    clamp = {"default": (True, True), "fix_mix": (True, True), "no_clamp": (False, False),
             "clamp_split": (False, True)}[case]
    # the first frame resets the history: its max frame nums are 0, the clamp off
    assert all(k["clamp"] == (clamp if i > 0 else (False, False))
               for i, (_, k) in enumerate(calls))
    # each signal's acceleration and reset amount: the specular ones scaled by 0.33 and 0.5
    assert all(k["acceleration"][0] != k["acceleration"][1]
               and k["reset_amount"][0] != k["reset_amount"][1] for _, k in calls)
    if case != "default":
        in_fix = torch.cat([(a[3] <= k["history_fix_frame_num"]).flatten() for a, k in calls])
        assert bool(in_fix.any()) and not bool(in_fix.all())
    over, count, worst = _hold(library, "relax_clamp_moments", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.fixture(scope="module")
def sh_calls():
    """Every call of the RELAX kernels of each SH variant over the frames, one Engine run a
    variant and SH_SETTINGS entry."""
    return {(v, case): _record(Denoiser[v], SH_KERNELS, **settings)
            for v in SH_VARIANTS for case, settings in SH_SETTINGS.items()}


def _sh_planes(name, a, k):
    """The SH planes a recorded call passes its kernel: K16's SH histories, K17's two, the
    others' `sh` (a pair with both signals)."""
    if name == "relax_smb_resolve":
        return a[11]
    if name == "relax_vmb_resolve":
        return a[12:14]
    return k["sh"] if isinstance(k["sh"], tuple) else (k["sh"],)


@pytest.mark.parametrize("case", list(SH_CASES))
def test_relax_sh_rehearsal(library, sh_calls, case):
    """The SH mode of K15, K16, K17, K19 and K20 against its plain version on an SH variant's
    calls: the SH planes ride the signal's launch. K16 and K17 sample the SH histories with
    the custom-weight bilinear, never the CatRom, on frames with both footprints (smb_found,
    any and all equal); K20 lerps the SH by its clamping factor, held on `fix_mix` calls."""
    name, variant = SH_CASES[case]
    calls = sh_calls[(variant, "fix_mix" if name == "relax_clamp_moments" else "default")][name]
    both = variant == "RELAX_DIFFUSE_SPECULAR_SH"
    per_frame = 2 if both and name == "relax_prepass" else 1
    assert len(calls) == FRAMES * per_frame
    planes = [_sh_planes(name, a, k) for a, k in calls]
    assert all(p is not None and all(t is not None for t in p) for p in planes)
    if name in ("relax_smb_resolve", "relax_vmb_resolve"):  # the bf16 SH histories
        assert all(t.dtype == torch.bfloat16 for p in planes for t in p)
    if name == "relax_prepass":  # SH1 as packed: negative components, one plane a signal
        assert all(bool((p[0] < 0.0).any()) for p in planes)
        if both:
            assert not torch.equal(planes[0][0], planes[1][0])
    elif both and name != "relax_vmb_resolve":  # the signals' SH differ
        assert all(not torch.equal(p[0], p[-1]) for p in planes[1:])
    exact = ()
    if name == "relax_smb_resolve":
        found = torch.cat([KM.relax_smb_resolve.relax_smb_resolve_ref(*a, **k)["smb_found"]
                           .flatten() for a, k in calls[1:]])
        assert bool((found == 2.0).any()) and bool((found == 1.0).any())
        exact = ("smb_found",)
    if name == "relax_vmb_resolve":
        r = [KM.relax_vmb_resolve.relax_vmb_resolve_ref(*a, **k) for a, k in calls[1:]]
        assert any(bool(((a[5] == 2.0) & (x["all"] > 0.0)).any())
                   for (a, _), x in zip(calls[1:], r))
        assert any(bool(((x["any"] > 0.0) & (x["all"] == 0.0)).any()) for x in r)
        exact = ("any", "all")
    if name == "relax_clamp_moments":
        in_fix = torch.cat([(a[3] <= k["history_fix_frame_num"]).flatten() for a, k in calls])
        assert bool(in_fix.any()) and not bool(in_fix.all())
    over, count, worst = _hold(library, name, calls, exact=exact)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("variant", SH_VARIANTS)
def test_relax_atrous_sh_rehearsal(library, sh_calls, variant, step):
    """K22's SH mode against its plain version at every stride of an SH variant's ladder, with
    both confidences: the SH filtered with the signal's weights (the 5x5 estimation's SH at
    iteration 0 where the history is short), the lobe fraction's base 1.0 after iteration 0."""
    calls = [(a, k) for a, k in sh_calls[(variant, "default")]["relax_atrous"]
             if k["step_size"] == step]
    assert len(calls) == FRAMES
    assert all(k["sh"] is not None for _, k in calls)
    if step > 1:  # the SH base: 1 / sqrt(step), not the settings' fraction / sqrt(step)
        assert all(k["lobe_fraction"] == 1.0 / step ** 0.5 for _, k in calls)
    else:  # iteration 0: some histories short (the estimation), some not
        short = torch.cat([(a[3] < k["history_threshold"]).flatten() for a, k in calls])
        assert bool(short.any()) and not bool(short.all())
    over, count, worst = _hold(library, "relax_atrous", calls)
    assert over <= FLIP_FRACTION * count, (f"{variant} step {step}: {over} of {count} values "
                                           f"out of tolerance, max |d| {worst:.3g}")


def _cb_prepass_calls(calls, per_frame):
    """The PrePass calls of a frame's `per_frame` calls of a spatial filter (the first)."""
    assert len(calls) == FRAMES * per_frame
    return calls[::per_frame]


def _cb_fallback_pixels(name, a, k):
    """Pixels of one checkerboard PrePass call where a signal's weight sum is 0: the plain
    version with a NaN fallback marks them."""
    mod = KM.MODULES[name]
    sf = KM.MODULES["spatial_filter"]
    orig = sf.cb_neighbor_resolve
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sf, "cb_neighbor_resolve",
                   lambda signal, *r: torch.full_like(orig(signal, *r), float("nan")))
        out = _flat(getattr(mod, name + "_ref")(*a, **k))
    return sum(int(torch.isnan(out[key][..., 0]).sum()) for key in out if key != "hdt")


@pytest.mark.parametrize("case", list(CB_CASES))
def test_spatial_filter_cb_rehearsal(library, case):
    """H2's checkerboard PrePass (diffuse and specular, BLACK and WHITE) against its plain
    version on half-width inputs: has_data from the pixel and the frame index, the centre's
    hit distance zeroed for its parameters and weighed by has_data, the taps on the expanded
    signal, and where no weight is left the horizontal neighbour resolve; with the PrePass
    radius 0 the kernel still runs (`diffuse_radius_0`), and the fallback fires on the
    CB_FALLBACK frames and everywhere without data with usePrepassOnly..."""
    denoiser, mode, settings, materials = CB_CASES[case]
    calls = _cb_prepass_calls(_record(denoiser, "spatial_filter", materials=materials,
                                      checkerboardMode=mode, **settings), len(SF_STAGES))
    assert all(k["mode"] == 0 and k["cb"] == int(mode) - 1 for _, k in calls)
    assert all(a[0].shape[1] == SIZE[0] for a, _ in calls)  # expanded to full width
    fired = sum(_cb_fallback_pixels("spatial_filter", a, k) for a, k in calls)
    if "fallback" in case or "prepass_only" in case:
        assert fired > 0, f"{case}: the fallback never fires"
    over, count, worst = _hold(library, "spatial_filter", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", list(CB_DS_CASES))
def test_spatial_filter_fused_cb_rehearsal(library, case):
    """N4's checkerboard PrePass against its plain version on REBLUR_DIFFUSE_SPECULAR's
    half-width inputs: each signal's centre weighed by has_data, and each signal's own
    fallback where its weight sum is 0 (the CB_FALLBACK frames); in performance mode too."""
    mode, settings, materials = CB_DS_CASES[case]
    calls = _cb_prepass_calls(_record(DS, "spatial_filter_fused", materials=materials,
                                      checkerboardMode=mode, **settings), len(SF_STAGES))
    assert all(k["cb"]["parity"] == int(mode) - 1 and k["prepass"] is not None
               for _, k in calls)
    if case == "fallback":
        assert sum(_cb_fallback_pixels("spatial_filter_fused", a, k) for a, k in calls) > 0
    over, count, worst = _hold(library, "spatial_filter_fused", calls)
    assert over <= FLIP_FRACTION * count, (f"{case}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


def test_spatial_filter_cb_edge_rehearsal(library):
    """The fallback at the image's edge columns: on the diffuse CB_FALLBACK calls, viewZ one
    column in from each edge set to half its value (a near object's silhouette), so that the
    edge pixels' inner neighbours fail the depth test. An edge pixel then has no neighbour to
    take (0), where a fallback without the edge test would take its own expanded texel: the
    pixels at x = 0 and x = w - 1 that fall back must be held."""
    denoiser, mode, settings, materials = CB_CASES["diffuse_fallback"]
    calls = []
    for a, k in _cb_prepass_calls(_record(denoiser, "spatial_filter", materials=materials,
                                          checkerboardMode=mode, **settings), len(SF_STAGES)):
        view_z = a[1].clone()
        view_z[:, 1] = view_z[:, 1] * 0.5
        view_z[:, -2] = view_z[:, -2] * 0.5
        calls.append(((a[0], view_z, *a[2:]), k))
    sf = KM.MODULES["spatial_filter"]
    edge = 0
    for a, k in calls:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sf, "cb_neighbor_resolve", lambda signal, *r: torch.full_like(
                signal, float("nan")))
            out = sf.spatial_filter_ref(*a, **k)
        edge += int(torch.isnan(out[:, [0, -1], 0]).sum())
    assert edge > 0, "no edge pixel falls back"
    over, count, worst = _hold(library, "spatial_filter", calls)
    assert over <= FLIP_FRACTION * count, (f"{over} of {count} values out of tolerance, max "
                                           f"|d| {worst:.3g}")
