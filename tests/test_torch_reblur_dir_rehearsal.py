"""Rehearsal on the CPU of the modes this slice adds to the REBLUR kernels: H3 `history_fix.cu`
and H4 `ts_prelude.cu` in their directional-occlusion modes (`kDir`), and H2
`spatial_filter.cu` in its specular instances that decode the taps' roughness (`kRough`), as
they are in the tree, compiled as C++ by g++ through `tests/cuda_shim.h` and bound through the
same ctypes entry points as on the card (the machinery of `tests/test_torch_kernel_rehearsal.py`).

Each instance is held against its plain version on the calls that the port's Engine makes on
the CPU at 48x32 over 3 orbit frames:
- H3 `<1, 0, false, false, true>` and H4 `<false, true>` on REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION,
  its input packed from the surface normal and the binary AO (`frames_of` of
  `tests/test_torch_reblur_dir_slice.py`), by default and with AREA_3X3 on frames whose AO is 0
  on a seeded 30 % of the geometry pixels, so that .w is 0 or near it where the clamp's and TS's
  luma changes divide by it (asserted);
- H2 `kRough` 1 and 2 on REBLUR_SPECULAR with IN_NORMAL_ROUGHNESS packed as SQRT_LINEAR and
  SQ_LINEAR, by stage (PrePass, Blur, PostBlur) and in its SH, checkerboard, occlusion and
  performance-mode instances (`ROUGH_CASES`).

Run alone: python -m pytest tests/test_torch_reblur_dir_rehearsal.py -q

Tolerance: that of `chip_smoke.py` on the card, |kernel - plain| <= 1e-4 + 1e-4 |plain| on all
but 1e-4 of the values.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.kernels import build
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import ResourceType as RT, RoughnessEncoding as RE, replace
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

from test_torch_kernel_rehearsal import SHIM, _hold, rewrite
from test_torch_reblur_dir_slice import DO, frames_of as dir_frames
from test_torch_reblur_roughness_variants import _pool

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (48, 32)
SOURCES = ("smb_resolve.cu", "history_fix.cu", "ts_prelude.cu", "spatial_filter.cu")
FRAMES = 3
FLIP_FRACTION = 1e-4
STAGES = ("prepass", "blur", "post_blur")
# H2's kRough cases on REBLUR_SPECULAR: (variant, the kind of its inputs, settings)
ROUGH_CASES = {"default": ("REBLUR_SPECULAR", "radiance", {}),
               "perf": ("REBLUR_SPECULAR", "radiance", dict(enablePerformanceMode=True)),
               "sh": ("REBLUR_SPECULAR_SH", "sh", {}),
               "cb": ("REBLUR_SPECULAR", "radiance", dict(checkerboardMode=CB.BLACK)),
               "occlusion": ("REBLUR_SPECULAR_OCCLUSION", "occ", {})}


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the rehearsal compiles the CUDA sources as C++")
    d = tmp_path_factory.mktemp("dir_rehearsal")
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
    so = d / "libdirrehearsal.so"
    subprocess.run([gxx, "-shared", "-pthread", "-o", str(so),
                    *[str(u.with_suffix(".o")) for u in units]], check=True)
    lib = ctypes.CDLL(str(so))
    lib.nrd_error_string.argtypes = [ctypes.c_int]
    lib.nrd_error_string.restype = ctypes.c_char_p
    return lib


def _record(variant, settings, names, pools, encoding=RE.LINEAR):
    """Every call of the wrappers `names` over the (common settings, pool) frames, through the
    port's Engine on the CPU (where the wrappers run their plain versions)."""
    calls = {n: [] for n in names}
    eng = Engine({0: Denoiser[variant]}, resource_size=SIZE, roughness_encoding=encoding,
                 device="cpu")
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
        for cs, pool in pools:
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    return calls


@pytest.fixture(scope="module")
def dir_calls():
    """REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION's history-fix and TS calls, by default and with
    AREA_3X3 on the AO with holes."""
    out = {}
    for case, settings, holes in (("default", {}, False),
                                  ("holes", dict(hitDistanceReconstructionMode=HM.AREA_3X3),
                                   True)):
        pools = [(cs, pool) for cs, pool, _ in dir_frames(FRAMES, size=SIZE, holes=holes)]
        out[case] = _record(DO, settings, ("history_fix", "ts_prelude"), pools)
    return out


def _check(library, name, recorded):
    over, count, worst = _hold(library, name, recorded)
    assert over <= FLIP_FRACTION * count, (f"{name}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


@pytest.mark.parametrize("case", ["default", "holes"])
def test_history_fix_dir_rehearsal(library, dir_calls, case):
    """H3 `kDir`: the radiance taps on the directional signal, the clamp with .w as the luma,
    sigma scale 1, the directional ChangeLuma; with holes the TA output's .w is below 1e-3 on
    some pixels."""
    recorded = dir_calls[case]["history_fix"]
    assert len(recorded) == FRAMES and all(k["directional"] for _, k in recorded)
    if case == "holes":
        assert any(bool((a[1].abs() < 1e6).any() and (a[0][..., 3] < 1e-3).any())
                   for a, _ in recorded)
    _check(library, "history_fix", recorded)


@pytest.mark.parametrize("case", ["default", "holes"])
def test_ts_prelude_dir_rehearsal(library, dir_calls, case):
    """H4 `kDir`: the luma window on .w, the directional ChangeLuma of the diffuse half."""
    recorded = dir_calls[case]["ts_prelude"]
    assert len(recorded) == FRAMES and all(k["directional"] for _, k in recorded)
    if case == "holes":
        assert any(bool((a[0][..., 3] < 1e-3).any()) for a, _ in recorded)
    _check(library, "ts_prelude", recorded)


@pytest.fixture(scope="module")
def rough_calls():
    """H2's calls on the ROUGH_CASES at SQRT_LINEAR and SQ_LINEAR."""
    out = {}
    for case, (variant, kind, settings) in ROUGH_CASES.items():
        for encoding in ("SQRT_LINEAR", "SQ_LINEAR"):
            gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
            pools = []
            for i in range(FRAMES):
                fd = gen.frame(i)
                fd.common_settings.timeDeltaBetweenFrames = 16.66
                cb = settings.get("checkerboardMode")
                pools.append((fd.common_settings, _pool(gen, fd, i, kind, encoding,
                                                        None if cb is None else cb.name, False)))
            out[case, encoding] = _record(variant, settings, ("spatial_filter",), pools,
                                          RE[encoding])["spatial_filter"]
    return out


def _stages(case):
    return STAGES[1:] if case == "occlusion" else STAGES  # occlusion: no PrePass


@pytest.mark.parametrize("case,encoding,stage", [
    (case, encoding, stage) for case in ROUGH_CASES for encoding in ("SQRT_LINEAR", "SQ_LINEAR")
    for stage in _stages(case)])
def test_spatial_filter_rough_rehearsal(library, rough_calls, case, encoding, stage):
    """H2 `kRough`: the centre from the packed roughness, the taps' decoded, by stage."""
    recorded = rough_calls[case, encoding]
    stages = _stages(case)
    assert len(recorded) == FRAMES * len(stages)
    calls = recorded[stages.index(stage)::len(stages)]
    assert all(k["spec"] and k["roughness_encoding"] == RE[encoding] for _, k in calls)
    _check(library, "spatial_filter", calls)


def test_rough_planes_differ():
    """The encodings move the packed roughness far from the decoded one on these frames, so an
    instance that skipped its decode fails."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    fd = gen.frame(0)
    m = fd.hit_mask > 0
    for encoding in ("SQRT_LINEAR", "SQ_LINEAR"):
        packed = _pool(gen, fd, 0, "radiance", encoding, None, False)
        r = packed[RT.IN_NORMAL_ROUGHNESS][..., 2]
        assert np.abs(r - fd.roughness)[m].max() > 0.05
