"""The port's C ABI (`nrdtpu_torch/native/`) on the CPU: the shim builds with g++, its header
keeps the JAX package's enums and structs (`native/include/nrdtpu_c.h`), ctypes calls in this
process give the port's Engine exactly (max abs 0), a "cuda" instance fails without CUDA, and a
C program that loads the shim starts Python through it.

Run alone: python -m pytest tests/test_torch_c_abi.py -q
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from nrdtpu_torch.engine import Engine
from nrdtpu_torch.native import bindings as B
from nrdtpu_torch.native import build
from nrdtpu_torch.settings import Denoiser, ResourceType as RT
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HEADER = os.path.join(REPO, "native", "include", "nrdtpu_c.h")
SIZE = (48, 32)
R10G10B10A2, LINEAR = 2, 1  # NormalEncoding / RoughnessEncoding values of the C enums


@pytest.fixture(scope="module")
def lib():
    return B.load()


def _parse(path):
    """{enum or struct name: [(member, value or type)]} of a C header."""
    text = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
    out = {}
    for kind, body, name in re.findall(r"typedef (enum|struct) \w+ \{(.*?)\} (\w+);", text,
                                       flags=re.S):
        members = [m.strip() for m in body.split(";" if kind == "struct" else ",") if m.strip()]
        if kind == "enum":
            out[name] = [tuple(p.strip() for p in m.split("=")) for m in members]
        else:
            out[name] = [tuple(m.rsplit(None, 1)) for m in members]
    return out


def _functions(path):
    text = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
    return set(re.findall(r"(\w+)\s*\([^;{]*\)\s*;", text))


def test_shim_builds():
    """g++ builds the shim into the ignored `_build/` directory, named by its sources' hash;
    a second call reuses it."""
    path = build.build()
    assert path.exists() and path.parent == build.BUILD_DIR
    assert build.build() == path
    res = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=REPO)
    assert res.returncode == 0, "the built shim must lie in a directory .gitignore lists"


def test_header_matches_jax_header():
    """The enums' values and the structs' fields equal those of the JAX package's header; the
    port's header declares every function of it and nrdtpu_create_instance_device."""
    port_header = os.path.join(os.path.dirname(build.__file__), "include", "nrdtpu_c.h")
    ours, theirs = _parse(port_header), _parse(JAX_HEADER)
    assert len(theirs) >= 12 and ours == theirs
    assert _functions(port_header) == _functions(JAX_HEADER) | {"nrdtpu_create_instance_device"}
    # the ctypes struct of the bindings has the header's fields in order
    fields = [name.split("[")[0] for _, name in ours["nrdtpu_common_settings"]]
    assert fields == [f for f, _ in B.CommonSettingsC._fields_]


def test_names_and_library_desc(lib):
    for d in Denoiser:
        assert lib.nrdtpu_get_denoiser_string(int(d)) == d.name.encode()
    for r in RT:
        assert lib.nrdtpu_get_resource_type_string(int(r)) == r.name.encode()
    assert lib.nrdtpu_get_version_string() == b"nrdtpu_torch 0.1.0"


def _pool(gen, fd, denoiser):
    planes = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
              RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd)}
    if denoiser == Denoiser.REFERENCE:
        planes = {RT.IN_SIGNAL: np.concatenate([fd.diff_noisy, fd.view_z[..., None]], -1)}
    else:
        planes[RT.IN_DIFF_RADIANCE_HITDIST] = np.concatenate(
            [fd.diff_noisy, np.full(fd.view_z.shape + (1,), 0.5, np.float32)], -1)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in planes.items()}


@pytest.mark.parametrize("denoiser", [Denoiser.REFERENCE, Denoiser.REBLUR_DIFFUSE],
                         ids=lambda d: d.name)
def test_abi_matches_engine_on_cpu(lib, denoiser):
    """Two frames through the ABI on "cpu" (validation on for REBLUR_DIFFUSE) against the
    port's Engine on the same inputs and the settings the shim makes of the struct: every
    output slot, OUT_VALIDATION included, equal (max abs 0)."""
    w, h = SIZE
    gen = SceneGenerator(SceneSpec(size=SIZE), camera_mode="orbit")
    descs = (B.DenoiserDescC * 1)(B.DenoiserDescC(3, int(denoiser)))
    inst = ctypes.c_void_p()
    assert lib.nrdtpu_create_instance_device(descs, 1, w, h, R10G10B10A2, LINEAR, b"cpu",
                                             ctypes.byref(inst)) == 0, lib.nrdtpu_get_last_error()
    eng = Engine({3: denoiser}, resource_size=SIZE, device="cpu")
    out_rts = ([RT.OUT_SIGNAL] if denoiser == Denoiser.REFERENCE
               else [RT.OUT_DIFF_RADIANCE_HITDIST, RT.OUT_VALIDATION])
    try:
        for i in range(2):
            fd = gen.frame(i)
            cs = fd.common_settings
            cs.timeDeltaBetweenFrames = 16.66
            cs.enableValidation = denoiser != Denoiser.REFERENCE
            c = B.common_settings_c(cs)
            assert lib.nrdtpu_set_common_settings(inst, ctypes.byref(c)) == 0
            pool = _pool(gen, fd, denoiser)
            outs = {rt: np.full((h, w, 4), np.nan, np.float32) for rt in out_rts}
            slots = [B.slot(k, v) for k, v in {**pool, **outs}.items()]
            r = lib.nrdtpu_denoise(inst, (ctypes.c_uint32 * 1)(3), 1,
                                   (B.ResourceSlotC * len(slots))(*slots), len(slots))
            assert r == 0, lib.nrdtpu_get_last_error()
            eng.set_common_settings(B.common_settings_from_c(c))
            want = eng.denoise([3], pool)
            for rt in out_rts:
                np.testing.assert_array_equal(outs[rt], want[rt].numpy(), err_msg=rt.name)
        if denoiser != Denoiser.REFERENCE:
            assert np.abs(outs[RT.OUT_VALIDATION]).max() > 0.5  # frame 1 renders the overlay
    finally:
        assert lib.nrdtpu_destroy_instance(inst) == 0


def test_cuda_instance_fails_without_cuda(lib):
    """nrdtpu_create_instance means "cuda": without CUDA it fails with the Engine's message and
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA path cannot be exercised here")
    descs = (B.DenoiserDescC * 1)(B.DenoiserDescC(0, int(Denoiser.REBLUR_DIFFUSE)))
    inst = ctypes.c_void_p()
    r = lib.nrdtpu_create_instance(descs, 1, 64, 48, R10G10B10A2, LINEAR, ctypes.byref(inst))
    assert r == 1  # NRDTPU_FAILURE
    assert not inst.value
    msg = lib.nrdtpu_get_last_error().decode()
    assert "CUDA is not available" in msg and msg.startswith("RuntimeError")


_DRIVER = r"""
#include <stdio.h>
#include <string.h>
#include "nrdtpu_c.h"

int main(void) {
    enum { W = 32, H = 24 };
    nrdtpu_denoiser_desc desc = {7, NRDTPU_REFERENCE};
    nrdtpu_instance* inst = NULL;
    if (nrdtpu_create_instance(&desc, 1, W, H, 2, 1, &inst) == NRDTPU_SUCCESS) {
        printf("cuda: created\n");
        nrdtpu_destroy_instance(inst);
    } else {
        printf("cuda: %s\n", nrdtpu_get_last_error());
    }
    if (nrdtpu_create_instance_device(&desc, 1, W, H, 2, 1, "cpu", &inst) != NRDTPU_SUCCESS) {
        printf("cpu failed: %s\n", nrdtpu_get_last_error());
        return 1;
    }
    static float sig[H * W * 4], out[H * W * 4];
    nrdtpu_common_settings cs;
    memset(&cs, 0, sizeof(cs));
    /* a perspective projection (column-major): x' = x, y' = y, z' = z - 0.1, w' = z */
    const float proj[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, -0.1f, 0};
    memcpy(cs.view_to_clip_matrix, proj, sizeof(proj));
    memcpy(cs.view_to_clip_matrix_prev, proj, sizeof(proj));
    for (int i = 0; i < 16; i += 5) {
        cs.world_to_view_matrix[i] = cs.world_to_view_matrix_prev[i] = 1.0f;
        cs.world_prev_to_world_matrix[i] = 1.0f;
    }
    cs.resource_size[0] = cs.resource_size_prev[0] = cs.rect_size[0] = cs.rect_size_prev[0] = W;
    cs.resource_size[1] = cs.resource_size_prev[1] = cs.rect_size[1] = cs.rect_size_prev[1] = H;
    cs.motion_vector_scale[0] = cs.motion_vector_scale[1] = 1.0f;
    cs.view_z_scale = 1.0f;
    cs.time_delta_between_frames = 16.66f;
    cs.denoising_range = 500000.0f;
    cs.disocclusion_threshold = 0.01f;
    cs.disocclusion_threshold_alternate = 0.05f;
    for (unsigned f = 0; f < 2; f++) {
        for (int i = 0; i < H * W * 4; i++) sig[i] = (float)((i * 7 + f * 3) % 11) / 10.0f;
        cs.frame_index = f;
        if (nrdtpu_set_common_settings(inst, &cs) != NRDTPU_SUCCESS) {
            printf("settings failed: %s\n", nrdtpu_get_last_error());
            return 1;
        }
        nrdtpu_resource_slot slots[2] = {{NRDTPU_IN_SIGNAL, sig, 4}, {NRDTPU_OUT_SIGNAL, out, 4}};
        uint32_t id = 7;
        if (nrdtpu_denoise(inst, &id, 1, slots, 2) != NRDTPU_SUCCESS) {
            printf("denoise failed: %s\n", nrdtpu_get_last_error());
            return 1;
        }
    }
    for (int i = 0; i < H * W * 4; i++) printf("%.9g\n", out[i]);
    return nrdtpu_destroy_instance(inst) == NRDTPU_SUCCESS ? 0 : 1;
}
"""


def test_c_program_embeds_python(tmp_path):
    """A C program linked against the shim, run with no PYTHONPATH from another directory,
    starts Python through it (the interpreter that built it, the package found from the
    shim's path), fails its "cuda" instance without CUDA, and on "cpu" gives REFERENCE's
    second frame as the port's Engine does."""
    lib = build.build()
    (tmp_path / "driver.c").write_text(_DRIVER)
    exe = tmp_path / "driver"
    res = subprocess.run(["gcc", "-O1", "-Wall", f"-I{lib.parent.parent / 'include'}",
                          str(tmp_path / "driver.c"), str(lib), f"-Wl,-rpath,{lib.parent}",
                          "-o", str(exe)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([str(exe)], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.splitlines()
    if not torch.cuda.is_available():
        assert lines[0].startswith("cuda: RuntimeError") and "CUDA" in lines[0]
    got = np.array([float(v) for v in lines[1:]], np.float32)

    w, h = 32, 24
    eng = Engine({7: Denoiser.REFERENCE}, resource_size=(w, h), device="cpu")
    proj = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, -0.1, 0], np.float32)
    c = B.CommonSettingsC()
    c.view_to_clip_matrix[:] = c.view_to_clip_matrix_prev[:] = proj.tolist()
    for name in ("world_to_view_matrix", "world_to_view_matrix_prev",
                 "world_prev_to_world_matrix"):
        getattr(c, name)[:] = np.eye(4, dtype=np.float32).reshape(-1).tolist()
    for name in ("resource_size", "resource_size_prev", "rect_size", "rect_size_prev"):
        getattr(c, name)[:] = [w, h]
    c.motion_vector_scale[:] = [1.0, 1.0, 0.0]
    c.view_z_scale, c.time_delta_between_frames, c.denoising_range = 1.0, 16.66, 500000.0
    c.disocclusion_threshold, c.disocclusion_threshold_alternate = 0.01, 0.05
    idx = np.arange(h * w * 4)
    for f in range(2):
        c.frame_index = f
        eng.set_common_settings(B.common_settings_from_c(c))
        sig = (((idx * 7 + f * 3) % 11).astype(np.float32) / np.float32(10.0)).reshape(h, w, 4)
        want = eng.denoise([7], {RT.IN_SIGNAL: sig})[RT.OUT_SIGNAL]
    np.testing.assert_array_equal(got, want.numpy().reshape(-1))
