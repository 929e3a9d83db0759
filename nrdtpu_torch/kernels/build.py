"""Build the CUDA sources of `csrc/` into one shared library with nvcc and bind it with
ctypes (no PyTorch headers, so a build takes seconds). Each source compiles in its own nvcc
process, all started together; one more call links the objects.

The library is built at first use into `_build/`, named by a hash of the sources and flags,
and reused while neither changes. A missing nvcc, a failed build or a failed launch raises.

Every C entry has one signature,
    int entry(void* const* ptrs, const float* consts, int w, int h, void* stream)
takes device pointers in a fixed order, launches on the given stream without synchronising
or allocating, and returns cudaGetLastError().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from ..settings import RoughnessEncoding

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
# --fmad=false: no a*b+c contraction, so step functions (plane-distance and material tests,
# floor snaps) see the same float32 values as the plain versions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

# The kernels' roughness decode mode of each roughness encoding (`csrc/common.cuh:
# decode_roughness`), as `frontend.unpack_normal_roughness` decodes it
ROUGHNESS_MODE = {RoughnessEncoding.LINEAR: 0, RoughnessEncoding.SQRT_LINEAR: 1,
                  RoughnessEncoding.SQ_LINEAR: 2}

_lib = None
build_seconds = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def library_path() -> Path:
    """The library that the current sources and flags build to."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cuh + cu:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libnrdtpu_torch_{digest.hexdigest()[:16]}.so"


def library():
    """Build (if needed) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so = library_path()
    t0 = time.perf_counter()
    if not so.exists():
        _build(so, _sources()[0])
    lib = ctypes.CDLL(str(so))
    lib.nrd_error_string.argtypes = [ctypes.c_int]
    lib.nrd_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def _build(so: Path, sources):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in jobs]
    logs = [(cmd, *p.communicate(), p.returncode) for cmd, p in zip(jobs, procs)]
    tmp = so.with_suffix(f".{tag}")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
            *map(str, objs)]
    failed = [(cmd, out) for cmd, out, _, rc in logs if rc != 0]
    if not failed:
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append((link, res.stdout, None, res.returncode))
        if res.returncode != 0:
            failed.append((link, res.stdout))
    (BUILD_DIR / "build.log").write_text(
        "".join(" ".join(cmd) + "\n" + out for cmd, out, _, _ in logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, so)


def launch(entry: str, tensors, consts, w: int, h: int):
    """Launch one C entry on the current stream of the tensors' device; raise on error. An
    optional input given as None reaches the kernel as a null pointer."""
    lib = library()
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    vals = (ctypes.c_float * max(1, len(consts)))(*[float(c) for c in consts])
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = fn(ptrs, vals, int(w), int(h), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: {lib.nrd_error_string(err).decode()}")


def check(name: str, t, device, dtype, shape):
    """Raise unless `t` is a contiguous tensor of the given device, dtype and shape; an
    (..., 4) image must also be aligned to its record (the kernels read a float record as one
    float4, a bf16 record as one 8-byte load)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    record = 4 * t.element_size()
    if len(shape) > 1 and shape[-1] == 4 and t.data_ptr() % record:
        raise ValueError(f"{name}: not {record}-byte aligned")


def kernel_device(t):
    """The device a wrapper runs on: None for CPU (plain version), else a CUDA device."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return t.device
