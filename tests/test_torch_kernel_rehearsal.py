"""Rehearsal on the CPU of the two kernels redesigned for the H100: K22 `relax_atrous.cu` and
K23 `reblur_band.cu`, as they are in the tree, compiled as C++ by g++ through
`tests/cuda_shim.h` (every CUDA thread a std::thread, `__syncthreads` a barrier of the block)
and bound through the same ctypes entry points as on the card, with `build.library`,
`build.kernel_device` and `torch.cuda.current_stream` patched. Each is held against its plain
version on the calls that the port's Engine makes on the CPU at 48x32 over 4 orbit frames:
every stride of the à-trous ladder of RELAX_DIFFUSE and RELAX_SPECULAR with IN_DIFF_CONFIDENCE /
IN_SPEC_CONFIDENCE, and the band of REBLUR_DIFFUSE_SPECULAR (NRDTPU_REBLUR_BAND=1) by default,
with the anti-firefly ring and in performance mode.

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
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, replace
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SHIM = Path(__file__).with_name("cuda_shim.h")
SOURCES = ("relax_atrous.cu", "reblur_band.cu")
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
    (d / "errors.cpp").write_text('extern "C" const char* nrd_error_string(int) '
                                  '{ return "cuda shim"; }\n')
    units = [d / "errors.cpp"]
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


def _pools(relax):
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    rng = np.random.default_rng(11)
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                RT.IN_MV: fd.mv}
        for rt, noisy, hit, conf in (
                (RT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist,
                 RT.IN_DIFF_CONFIDENCE),
                (RT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist,
                 RT.IN_SPEC_CONFIDENCE)):
            if relax:
                pool[rt] = fe.relax_pack_radiance_hitdist(torch.from_numpy(noisy),
                                                          torch.from_numpy(hit)).numpy()
                pool[conf] = _ramp(rng, SIZE[1], SIZE[0])
            else:
                rough = (torch.from_numpy(fd.roughness) if rt == RT.IN_SPEC_RADIANCE_HITDIST
                         else torch.ones(SIZE[1], SIZE[0]))
                nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(hit),
                                                  torch.from_numpy(fd.view_z), HDP, rough)
                pool[rt] = fe.reblur_pack_radiance_hitdist(torch.from_numpy(noisy), nhd).numpy()
        yield fd.common_settings, pool


def _record(denoiser, name, env=None, **settings):
    """Every call of the wrapper `name` over the frames, through the port's Engine on the
    CPU (where the wrappers run their plain versions)."""
    mod = KM.MODULES[name]
    wrapper, calls = getattr(mod, name), []
    eng = Engine({0: denoiser}, resource_size=SIZE, device="cpu")
    eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))

    def rec(*a, **k):
        calls.append((a, k))
        return wrapper(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, name, rec)
        for key, value in (env or {}).items():
            mp.setenv(key, value)
        for cs, pool in _pools(denoiser.name.startswith("RELAX")):
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


def _hold(lib, name, calls):
    """Run each call through the rehearsal kernel and the plain version; return the values
    outside the tolerance, the values and the largest difference."""
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
            d = (got[key] - w).abs()
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
