"""Rehearsal on the CPU of the kernels redesigned for the H100 and of the kernels with a
roughness-encoding mode: K22 `relax_atrous.cu`, K23 `reblur_band.cu`, N4
`spatial_filter_fused.cu`, N5 `history_fix_fused.cu`, K13 `sigma_blur.cu`, K19
`relax_history_fix.cu`, K16 `relax_smb_resolve.cu`, K17 `relax_vmb_resolve.cu`, K15
`relax_prepass.cu`, K12 `hitdist_recon.cu`, H1 `smb_resolve.cu`, K14 `sigma_ts.cu`, H3
`history_fix.cu`, K20 `relax_clamp_moments.cu` and H4 `ts_prelude.cu`, as they are in the tree,
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
RELAX_DIFFUSE and RELAX_SPECULAR (`CLAMP_CASES`); H4 on every TS half (`TS_CASES`).

Run alone: python -m pytest tests/test_torch_kernel_rehearsal.py -q

Tolerance: that of `chip_smoke.py` on the card, |kernel - plain| <= 1e-4 + 1e-4 |plain| on all
but 1e-4 of the values. g++ builds with -ffp-contract=off as nvcc builds with --fmad=false;
what remains is last-bit differences of the C library's exp/sqrt against PyTorch's.
"""

import contextlib
import ctypes
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
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import RelaxAntilagSettings
from nrdtpu_torch.settings import ResourceType as RT, RoughnessEncoding, replace
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SHIM = Path(__file__).with_name("cuda_shim.h")
SOURCES = ("relax_atrous.cu", "reblur_band.cu", "spatial_filter_fused.cu",
           "history_fix_fused.cu", "sigma_blur.cu", "relax_history_fix.cu",
           "relax_smb_resolve.cu", "relax_vmb_resolve.cu", "relax_prepass.cu",
           "hitdist_recon.cu", "smb_resolve.cu", "sigma_ts.cu", "history_fix.cu",
           "relax_clamp_moments.cu", "ts_prelude.cu")
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

LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)\s*<<<([^;]*?)>>>\s*\(([^;]*)\);")
DYNAMIC_SHARED = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\s*\[\s*\]\s*;")


def rewrite(src):
    """The two source rewrites that `cuda_shim.h` needs: each launch and each dynamic
    shared-memory array."""
    src = LAUNCH.sub(lambda m: f"shim::launch({m[1]}, shim::Config({m[2]}), {m[3]});", src)
    return DYNAMIC_SHARED.sub(lambda m: f"{m[1]}* {m[2]} = reinterpret_cast<{m[1]}*>"
                                        f"(shim::dynamic_smem);", src)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the rehearsal compiles the CUDA sources as C++")
    d = tmp_path_factory.mktemp("rehearsal")
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
    so = d / "librehearsal.so"
    subprocess.run([gxx, "-shared", "-pthread", "-o", str(so),
                    *[str(u.with_suffix(".o")) for u in units]], check=True)
    lib = ctypes.CDLL(str(so))
    lib.nrd_error_string.argtypes = [ctypes.c_int]
    lib.nrd_error_string.restype = ctypes.c_char_p
    return lib


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


def _pools(kind, encoding=RoughnessEncoding.LINEAR, holes=False, materials=False,
           motion="mv_z_given"):
    """The inputs of each frame for "reblur", "relax" or "sigma" (the penumbra from the
    scene's distance to the occluder, and a constant translucency), the roughness packed
    with `encoding`; with `holes` the RELAX hit distance zeroed on a seeded HOLE_FRACTION of
    the geometry pixels; with `materials` the materials striped (`_striped`); the motion
    vectors as `motion` of MOTIONS says."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    rng = np.random.default_rng(11)
    relax = kind == "relax"
    for i in range(FRAMES):
        fd = gen.frame(i)
        if materials:
            fd.material_id = _striped(fd)
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
            if relax:
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
        yield fd.common_settings, pool


def _record(denoiser, name, env=None, encoding=RoughnessEncoding.LINEAR, holes=False,
            materials=False, motion="mv_z_given", **settings):
    """Every call of the wrapper `name` over the frames, through the port's Engine on the
    CPU (where the wrappers run their plain versions), at the roughness encoding
    `encoding`, on frames with hit-distance holes if `holes`, striped materials if
    `materials` and the motion vectors of `motion`."""
    mod = KM.MODULES[name]
    wrapper, calls = getattr(mod, name), []
    eng = Engine({0: denoiser}, resource_size=SIZE, roughness_encoding=encoding, device="cpu")
    eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))

    def rec(*a, **k):
        calls.append((a, k))
        return wrapper(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, name, rec)
        for key, value in (env or {}).items():
            mp.setenv(key, value)
        kind = denoiser.name.split("_")[0].lower()
        for cs, pool in _pools(kind, encoding, holes, materials, motion):
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    return calls


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


@pytest.mark.parametrize("denoiser", ["RELAX_DIFFUSE", "RELAX_SPECULAR"])
def test_relax_smb_resolve_rehearsal(library, denoiser):
    """K16 (the staged 3x3 window, the 12 occlusion taps, the histories through one CatRom-12
    footprint) against the plain version, smb_found equal; the frames give both bicubic
    (smb_found 2) and bilinear-fallback (1) footprints."""
    calls = _record(Denoiser[denoiser], "relax_smb_resolve")
    assert len(calls) == FRAMES
    assert all((a[9] is not None) == (denoiser == "RELAX_SPECULAR") for a, _ in calls)
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
