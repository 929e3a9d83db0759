"""Rehearsal on the CPU of the decoded-plane instances (`kDec`) that this slice adds to K12
`hitdist_recon.cu`, K13 `sigma_blur.cu`, K15 `relax_prepass.cu`, K16 `relax_smb_resolve.cu`, K17
`relax_vmb_resolve.cu`, K19 `relax_history_fix.cu`, K21 `relax_antifirefly.cu` and K22
`relax_atrous.cu`, as they are in the tree, compiled as C++ by g++ through `tests/cuda_shim.h`
and bound through the same ctypes entry points as on the card (the machinery of
`tests/test_torch_kernel_rehearsal.py`).

Each kernel is held against its plain version on every call that the port's Engine makes on
the CPU at 48x32 over 3 orbit frames (`RUNS`), IN_NORMAL_ROUGHNESS at an RGBA encoding
(`tests/test_torch_relax_enc_slice.py:frames_of`, the SNORM ones with the sky's normal
(0, 0, 1)): RELAX_DIFFUSE, RELAX_SPECULAR and RELAX_DIFFUSE_SPECULAR with the anti-firefly pass
and the hit-distance reconstruction on frames whose hit distance is zeroed on a seeded 30 % of
the pixels, at the three roughness encodings between them; RELAX_DIFFUSE_SH, RELAX_SPECULAR_SH
and RELAX_DIFFUSE_SPECULAR_SH; SIGMA_SHADOW and SIGMA_SHADOW_TRANSLUCENCY. Between them the
calls reach every kDec instance that RELAX and SIGMA launch (K16's two- and four-history modes
with and without SH, K17 with and without SH, K19's three phases, K21 with one and two
signals, K22's staged iteration 0 and the later strides at one and two signals, K12 at radius
1 and 2 on each signal count, K13's four modes). `test_plain_versions_see_the_mode` shows that
the plain versions give another result when they read the decoded plane as packed, so that an
instance that skipped its mode fails.

Run alone: python -m pytest tests/test_torch_enc_rehearsal.py -q

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
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import NormalEncoding as NE, ResourceType as RT
from nrdtpu_torch.settings import RoughnessEncoding as RE, replace

from test_torch_kernel_rehearsal import SHIM, _hold, rewrite
from test_torch_relax_enc_slice import frames_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (48, 32)
FRAMES = 3
FLIP_FRACTION = 1e-4
HOLE_FRACTION = 0.3
# smb_resolve.cu defines the library's nrd_error_string
SOURCES = ("smb_resolve.cu", "hitdist_recon.cu", "sigma_blur.cu", "relax_prepass.cu",
           "relax_smb_resolve.cu", "relax_vmb_resolve.cu", "relax_history_fix.cu",
           "relax_antifirefly.cu", "relax_atrous.cu")
KERNELS = tuple(name[:-len("_dec")] for name in KM.DEC_INSTANCES)
AF = dict(enableAntiFirefly=True)
# name: (variant, normal encoding, roughness encoding, settings, hit-distance holes)
RUNS = {
    "RD": ("RELAX_DIFFUSE", "RGBA8_UNORM", "LINEAR",
           dict(AF, hitDistanceReconstructionMode=HM.AREA_3X3), True),
    "RS": ("RELAX_SPECULAR", "RGBA8_SNORM", "SQ_LINEAR",
           dict(AF, hitDistanceReconstructionMode=HM.AREA_5X5), True),
    "RDS": ("RELAX_DIFFUSE_SPECULAR", "RGBA16_UNORM", "SQRT_LINEAR",
            dict(AF, hitDistanceReconstructionMode=HM.AREA_3X3), True),
    "RDS_R2": ("RELAX_DIFFUSE_SPECULAR", "RGBA16_SNORM", "LINEAR",
               dict(hitDistanceReconstructionMode=HM.AREA_5X5), True),
    "RD_SH": ("RELAX_DIFFUSE_SH", "RGBA16_SNORM", "LINEAR", {}, False),
    "RS_SH": ("RELAX_SPECULAR_SH", "RGBA8_UNORM", "LINEAR", {}, False),
    "RDS_SH": ("RELAX_DIFFUSE_SPECULAR_SH", "RGBA8_SNORM", "SQ_LINEAR", {}, False),
    "SS": ("SIGMA_SHADOW", "RGBA8_SNORM", "LINEAR", {}, False),
    "ST": ("SIGMA_SHADOW_TRANSLUCENCY", "RGBA16_UNORM", "LINEAR", {}, False),
}
MIN_MATERIAL_0 = {"relax_vmb_resolve": dict(min_material=0.0),
                  "relax_antifirefly": dict(min_materials=[0.0, 0.0])}
# the kernels each run calls
CALLED = {name: ({"sigma_blur"} if v.startswith("SIGMA") else
                 {"relax_prepass", "relax_smb_resolve", "relax_history_fix", "relax_atrous"}
                 | ({"relax_vmb_resolve"} if "SPEC" in v else set())
                 | ({"relax_antifirefly"} if s.get("enableAntiFirefly") else set())
                 | ({"hitdist_recon"} if "hitDistanceReconstructionMode" in s else set()))
          for name, (v, _, _, s, _) in RUNS.items()}


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the rehearsal compiles the CUDA sources as C++")
    d = tmp_path_factory.mktemp("enc_rehearsal")
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
    so = d / "libencrehearsal.so"
    subprocess.run([gxx, "-shared", "-pthread", "-o", str(so),
                    *[str(u.with_suffix(".o")) for u in units]], check=True)
    lib = ctypes.CDLL(str(so))
    lib.nrd_error_string.argtypes = [ctypes.c_int]
    lib.nrd_error_string.restype = ctypes.c_char_p
    return lib


def _punched(pool, frame):
    """The RELAX signals' hit distance zeroed on a seeded HOLE_FRACTION of the pixels that
    have one."""
    for rt in (RT.IN_DIFF_RADIANCE_HITDIST, RT.IN_SPEC_RADIANCE_HITDIST):
        if rt in pool:
            s = pool[rt].copy()
            hit = s[..., 3]
            hit[(np.random.default_rng((7, frame)).random(hit.shape) < HOLE_FRACTION)
                & (hit > 0)] = 0.0
            pool[rt] = s
    return pool


@pytest.fixture(scope="module")
def calls():
    """{run: {kernel: its calls}} through the port's Engine on the CPU."""
    out = {}
    for run, (variant, encoding, roughness, settings, holes) in RUNS.items():
        rec = {n: [] for n in KERNELS}
        eng = Engine({0: Denoiser[variant]}, resource_size=SIZE, normal_encoding=NE[encoding],
                     roughness_encoding=RE[roughness], device="cpu")
        eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))

        def recorder(n, wrapper):
            def r(*a, **k):
                rec[n].append((a, k))
                return wrapper(*a, **k)
            return r
        with pytest.MonkeyPatch.context() as mp:
            for n in KERNELS:
                mp.setattr(KM.MODULES[n], n, recorder(n, getattr(KM.MODULES[n], n)))
            for i, (cs, pool) in enumerate(frames_of(variant, encoding, roughness,
                                                     frames=FRAMES, size=SIZE)):
                eng.set_common_settings(cs)
                eng.denoise([0], _punched(pool, i) if holes else pool)
        out[run] = rec
    return out


@pytest.mark.parametrize("run,kernel", [(r, k) for r in RUNS for k in sorted(CALLED[r])])
def test_dec_instance_rehearsal(library, calls, run, kernel):
    recorded = calls[run][kernel]
    assert recorded and all(k["decoded"] for _, k in recorded), (run, kernel)
    mod = KM.MODULES[kernel]
    before = mod.dec_launches
    over, count, worst = _hold(library, kernel, recorded)
    assert mod.dec_launches == before + len(recorded)
    assert over <= FLIP_FRACTION * count, (f"{run} {kernel}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")


def test_runs_call_only_their_kernels(calls):
    for run, rec in calls.items():
        assert {k for k, v in rec.items() if v} == CALLED[run], run


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_see_the_mode(calls, kernel):
    """Read as packed R10G10B10A2 (`decoded=False`), the decoded plane gives another result
    than in the decoded mode, on the first call of the kernel that RELAX_DIFFUSE_SPECULAR (or
    SIGMA_SHADOW) makes. K17 and K21 read the plane for the material alone, which the default
    min materials of 4 hide: their calls take min materials of 0 here."""
    a, k = next(c for run in ("RDS", "RDS_R2", "SS") for c in calls[run][kernel])
    k = dict(k, **MIN_MATERIAL_0.get(kernel, {}))
    ref = getattr(KM.MODULES[kernel], kernel + "_ref")
    dec, packed = ref(*a, **k), ref(*a, **dict(k, decoded=False))
    flat = [(x, y) for x, y in zip(*[[v for v in (r.values() if isinstance(r, dict) else
                                                  r if isinstance(r, tuple) else (r,))]
                                     for r in (dec, packed)])]
    assert any(x is not None and not torch.allclose(x.float(), y.float(), rtol=1e-3, atol=1e-3)
               for x, y in flat), kernel
