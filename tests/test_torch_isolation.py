"""The PyTorch port stands alone: no JAX and no `nrdtpu` import, a CPU tensor always takes a
kernel's plain version, and nothing carries on on the CPU where CUDA was asked for."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nrdtpu_torch import kernels as KM
from nrdtpu_torch.kernels import build

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ONE_FRAME = """
import os
import sys
import numpy as np
import torch
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode, ResourceType as RT
from nrdtpu_torch.settings import replace
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec
gen = SceneGenerator(SceneSpec(size=(64, 48)), camera_mode="orbit")
fd = gen.frame(0)
sig = np.concatenate([fd.diff_noisy, np.full((48, 64, 1), 0.5, np.float32)], -1)
sig[::3, ::2, 3] = 0.0
pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
        RT.IN_MV: fd.mv, RT.IN_DIFF_RADIANCE_HITDIST: sig, RT.IN_SPEC_RADIANCE_HITDIST: sig,
        RT.IN_PENUMBRA: np.where(fd.shadow_clean > 0.5, 65504.0, 1.0).astype(np.float32),
        RT.IN_TRANSLUCENCY: np.full((48, 64, 4), 0.5, np.float32)}
for d in (Denoiser.REBLUR_DIFFUSE, Denoiser.REBLUR_SPECULAR, Denoiser.REBLUR_DIFFUSE_SPECULAR,
          Denoiser.SIGMA_SHADOW, Denoiser.SIGMA_SHADOW_TRANSLUCENCY, Denoiser.RELAX_DIFFUSE,
          Denoiser.RELAX_SPECULAR):
    eng = Engine({0: d}, resource_size=(64, 48), device="cpu")
    if not d.name.startswith("SIGMA"):
        eng.set_denoiser_settings(0, replace(
            eng._settings[0],
            hitDistanceReconstructionMode=HitDistanceReconstructionMode.AREA_3X3))
    eng.set_common_settings(fd.common_settings)
    outs = eng.denoise([0], pool)
    for out in outs.values():
        c = 1 if d == Denoiser.SIGMA_SHADOW else 4
        assert out.shape == (48, 64, c) and bool(out.isfinite().all())
os.environ["NRDTPU_REBLUR_BAND"] = "1"
eng = Engine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=(64, 48), device="cpu")
eng.set_common_settings(fd.common_settings)
assert all(bool(o.isfinite().all()) for o in eng.denoise([0], pool).values())
eng = Engine({0: Denoiser.REFERENCE}, resource_size=(64, 48), device="cpu")
eng.set_common_settings(fd.common_settings)
assert eng.denoise([0], {RT.IN_SIGNAL: sig})[RT.OUT_SIGNAL].shape == (48, 64, 4)
from nrdtpu_torch.kernels import halo
assert halo.halo_call("box", [torch.from_numpy(sig)], [4], 2)[0].shape == (48, 64, 4)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "nrdtpu"
             or m.startswith("nrdtpu."))
print("IMPORTED", bad)
assert not bad, bad
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_and_no_nrdtpu():
    res = subprocess.run([sys.executable, "-c", _ONE_FRAME], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "IMPORTED []" in res.stdout


@pytest.fixture(scope="module")
def recorded_calls():
    """The kernel calls of two CPU frames of each main path, recorded at the wrappers; the
    second frame of REBLUR_DIFFUSE_SPECULAR with the anti-firefly ring, one frame of it with
    AREA_3X3 hit-distance reconstruction on a signal with holes, two frames of it under
    NRDTPU_REBLUR_BAND=1 (the band), two frames of RELAX_DIFFUSE and of RELAX_SPECULAR (its
    second frame with the anti-firefly pass), two frames of each SIGMA variant, and two calls
    of the halo launcher, which no path calls."""
    from nrdtpu_torch import frontend as fe
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode, replace
    from nrdtpu_torch.settings import ResourceType as RT
    from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

    gen = SceneGenerator(SceneSpec(size=(48, 32)), camera_mode="orbit")
    calls = []
    originals = {n: getattr(m, n) for n, m in KM.MODULES.items()}
    try:
        for n, m in KM.MODULES.items():
            def rec(*a, _n=n, _f=originals[n], **k):
                calls.append((_n, a, k))
                return _f(*a, **k)
            setattr(m, n, rec)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("NRDTPU_REBLUR_BAND", "1")
            eng = Engine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=(48, 32),
                         device="cpu")
            for i in range(2):
                fd = gen.frame(i)
                eng.set_common_settings(fd.common_settings)
                sig = np.concatenate([fd.diff_noisy, np.full((32, 48, 1), 0.5, np.float32)], -1)
                eng.denoise([0], {RT.IN_VIEWZ: fd.view_z,
                                  RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                                  RT.IN_MV: fd.mv, RT.IN_DIFF_RADIANCE_HITDIST: sig,
                                  RT.IN_SPEC_RADIANCE_HITDIST: sig})
        img = torch.from_numpy(np.random.default_rng(5).random((32, 48, 3), dtype=np.float32))
        for block in ((16, 16), (64, 256)):
            KM.MODULES["halo_call"].halo_call("box", [img], [3], 2, block)
        for d in (Denoiser.REBLUR_DIFFUSE, Denoiser.REBLUR_SPECULAR,
                  Denoiser.REBLUR_DIFFUSE_SPECULAR):
            eng = Engine({0: d}, resource_size=(48, 32), device="cpu")
            for i in range(2):
                if i == 1 and d == Denoiser.REBLUR_DIFFUSE_SPECULAR:
                    eng.set_denoiser_settings(0, replace(eng._settings[0], enableAntiFirefly=True))
                fd = gen.frame(i)
                eng.set_common_settings(fd.common_settings)
                sig = np.concatenate([fd.diff_noisy, np.full((32, 48, 1), 0.5, np.float32)], -1)
                eng.denoise([0], {RT.IN_VIEWZ: fd.view_z,
                                  RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                                  RT.IN_MV: fd.mv, RT.IN_DIFF_RADIANCE_HITDIST: sig,
                                  RT.IN_SPEC_RADIANCE_HITDIST: sig})
        fd = gen.frame(2)
        eng = Engine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=(48, 32), device="cpu")
        eng.set_denoiser_settings(0, replace(
            eng._settings[0], hitDistanceReconstructionMode=HitDistanceReconstructionMode.AREA_3X3))
        eng.set_common_settings(fd.common_settings)
        sig = np.concatenate([fd.diff_noisy, np.full((32, 48, 1), 0.5, np.float32)], -1)
        sig[::2, ::3, 3] = 0.0
        eng.denoise([0], {RT.IN_VIEWZ: fd.view_z,
                          RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                          RT.IN_MV: fd.mv, RT.IN_DIFF_RADIANCE_HITDIST: sig,
                          RT.IN_SPEC_RADIANCE_HITDIST: sig})
        for d, rt, noisy, hit in (
                (Denoiser.RELAX_DIFFUSE, RT.IN_DIFF_RADIANCE_HITDIST, "diff_noisy", "diff_hit_dist"),
                (Denoiser.RELAX_SPECULAR, RT.IN_SPEC_RADIANCE_HITDIST, "spec_noisy",
                 "spec_hit_dist")):
            eng = Engine({0: d}, resource_size=(48, 32), device="cpu")
            for i in range(2):
                if i == 1 and d == Denoiser.RELAX_SPECULAR:
                    eng.set_denoiser_settings(0, replace(eng._settings[0], enableAntiFirefly=True))
                fd = gen.frame(i)
                eng.set_common_settings(fd.common_settings)
                eng.denoise([0], {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                                  RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                                  rt: fe.relax_pack_radiance_hitdist(
                                      torch.from_numpy(getattr(fd, noisy)),
                                      torch.from_numpy(getattr(fd, hit))).numpy()})
        for d in (Denoiser.SIGMA_SHADOW, Denoiser.SIGMA_SHADOW_TRANSLUCENCY):
            eng = Engine({0: d}, resource_size=(48, 32), device="cpu")
            for i in range(2):
                fd = gen.frame(i)
                eng.set_common_settings(fd.common_settings)
                dist = torch.from_numpy(fd.dist_to_occluder)
                eng.denoise([0], {
                    RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                    RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                    RT.IN_PENUMBRA: fe.sigma_pack_penumbra_directional(dist, 0.15).numpy(),
                    RT.IN_TRANSLUCENCY: fe.sigma_pack_translucency(
                        dist, torch.full((32, 48, 3), 0.4)).numpy()})
    finally:
        for n, m in KM.MODULES.items():
            setattr(m, n, originals[n])
    return calls


def _flat(r):
    if isinstance(r, dict):
        return [r[k] for k in sorted(r)]
    return list(r) if isinstance(r, tuple) else [r]


@pytest.mark.parametrize("name", sorted(KM.MODULES))
def test_wrapper_takes_plain_version_on_cpu(recorded_calls, name, monkeypatch):
    """For CPU tensors each wrapper returns exactly its plain version, launches nothing and
    never asks for the kernel library."""
    def no_library():
        raise AssertionError("the kernel library was asked for on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    calls = [(a, k) for n, a, k in recorded_calls if n == name]
    assert calls, f"{name} is on neither main path"
    mod = KM.MODULES[name]
    KM.reset_launch_counts()
    for a, k in calls:
        got, want = _flat(getattr(mod, name)(*a, **k)), _flat(getattr(mod, name + "_ref")(*a, **k))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert KM.launch_counts()[name] == 0


@pytest.mark.parametrize("name", sorted(KM.MODULES))
def test_wrapper_raises_off_cpu_without_kernel(recorded_calls, name):
    """A tensor that is neither on the CPU nor on a CUDA card has no kernel: it raises."""
    a, k = next((a, k) for n, a, k in recorded_calls if n == name)

    def meta(x):
        if isinstance(x, (list, tuple)):
            return type(x)(meta(v) for v in x)
        return x.to("meta") if isinstance(x, torch.Tensor) else x
    with pytest.raises(ValueError):
        getattr(KM.MODULES[name], name)(*meta(a), **k)


def test_engine_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA path cannot be exercised here")
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser

    with pytest.raises(RuntimeError, match="CUDA"):
        Engine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=(64, 48), device="cuda")


def test_engine_default_device_raises_without_cuda():
    """The Engine runs on the card unless asked for the CPU: without CUDA, the default
    raises rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser

    with pytest.raises(RuntimeError, match="CUDA"):
        Engine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=(64, 48))


def test_unported_variants_raise():
    """No variant raises any more: REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION, the last to be ported,
    builds on the CPU with REBLUR_DIFFUSE's state (a (h, w, 4) history, a diff_luma_stab), and
    every REBLUR variant with a specular signal builds at SQ_LINEAR and SQRT_LINEAR roughness."""
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser, RoughnessEncoding

    eng = Engine({0: Denoiser.REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION}, resource_size=(64, 48),
                 device="cpu")
    state = eng._instances[0].init_state()
    assert tuple(state["diff_history"].shape) == (48, 64, 4)
    assert tuple(state["diff_luma_stab"].shape) == (48, 64)
    for d in Denoiser:
        if d.name.startswith("REBLUR") and "SPECULAR" in d.name:
            for enc in (RoughnessEncoding.SQ_LINEAR, RoughnessEncoding.SQRT_LINEAR):
                Engine({0: d}, resource_size=(64, 48), roughness_encoding=enc, device="cpu")


def test_rgba_normal_encodings_raise_in_reblur_only():
    """No variant raises at a normal encoding any more (REBLUR, the last, since the RGBA slice):
    at every encoding every variant builds on the CPU, and a REBLUR instance takes the decoded
    planes exactly at the four RGBA formats."""
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser, NormalEncoding

    for enc in NormalEncoding:
        for d in Denoiser:
            eng = Engine({0: d}, resource_size=(64, 48), normal_encoding=enc, device="cpu")
            if d.name.startswith("REBLUR"):
                assert eng._instances[0].decoded == (enc != NormalEncoding.R10_G10_B10_A2_UNORM)


def test_denoise_before_common_settings_raises():
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import Denoiser

    eng = Engine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=(64, 48), device="cpu")
    with pytest.raises(RuntimeError, match="set_common_settings"):
        eng.denoise([0], {})


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: chip_smoke.py would run for real")
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo it must fail."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
