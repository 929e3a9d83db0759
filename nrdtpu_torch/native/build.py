"""Build the port's C ABI shim, `libnrdtpu_torch_c.so`, from `src/nrdtpu_torch_c.cpp` and
`include/nrdtpu_c.h` at first use:

    g++ -O2 -fPIC -std=c++17 -shared -Iinclude -I<Python include> src/nrdtpu_torch_c.cpp
        -L<LIBDIR> -lpython3.x -Wl,-rpath,<LIBDIR> -DNRDTPU_PYTHON=<this interpreter>

into `_build/`, named by a hash of the sources and flags and reused while neither changes. The
Python flags come from `sysconfig` of the running interpreter, whose path the shim keeps: a C
program that loads the shim starts that interpreter, with its packages (torch, numpy). The
shim finds `nrdtpu_torch` from its own path. A missing g++ or a failed build raises.

    python -m nrdtpu_torch.native.build   # prints the library's path
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "src" / "nrdtpu_torch_c.cpp"
HEADER = HERE / "include" / "nrdtpu_c.h"
BUILD_DIR = HERE / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]


def python_flags():
    """(compile flags, link flags) of the running interpreter, from sysconfig. The link flags
    name libpython where the interpreter has a shared one; without it the shim still loads
    into a Python process, but a C program cannot start an interpreter through it."""
    cflags = [f"-I{sysconfig.get_paths()['include']}",
              f'-DNRDTPU_PYTHON="{sys.executable}"']
    ldflags = []
    libdir = sysconfig.get_config_var("LIBDIR")
    version = sysconfig.get_config_var("VERSION") + (sys.abiflags or "")
    if sysconfig.get_config_var("Py_ENABLE_SHARED") and libdir:
        ldflags = [f"-L{libdir}", f"-lpython{version}", f"-Wl,-rpath,{libdir}"]
    return cflags, ldflags + (sysconfig.get_config_var("LIBS") or "").split()


def _command(out: Path):
    cflags, ldflags = python_flags()
    return ["g++", *CXX_FLAGS, f"-I{HEADER.parent}", *cflags, "-o", str(out), str(SOURCE),
            *ldflags, "-ldl"]


def library_path() -> Path:
    """The library that the current sources and flags build to."""
    digest = hashlib.sha256(" ".join(_command(Path("lib"))).encode())
    for p in (SOURCE, HEADER):
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libnrdtpu_torch_c-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the shim if the current sources have not been built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found: it builds the C ABI shim")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(_command(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed:\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build of the same sources wins either way
    return out


if __name__ == "__main__":
    print(build())
