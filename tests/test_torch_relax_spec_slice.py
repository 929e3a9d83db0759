"""The RELAX_SPECULAR slice end to end: the JAX Engine (XLA path) and the PyTorch port's Engine
on the CPU, 6 frames of the orbit scene at 128x96, inputs packed with
`relax_pack_radiance_hitdist` from the raw specular hit distance; at the default settings,
with `enableAntiFirefly=True` and with AREA_3X3 hit-distance reconstruction on frames whose
hit distance is zeroed on a seeded 30 % of the geometry pixels. Then the launches a frame of
each kernel module and the variants the port does not run yet.

Bars: OUT_SPEC_RADIANCE_HITDIST >= 60 dB PSNR against JAX on every frame (the passes agree to
~1e-6 relative, `tests/test_torch_relax_spec_passes.py`; the history length is rounded to
whole frames, so a last-bit difference at a .5 can round it the other way, which the
feedback then carries), the history length equal on >= 99.9 % of pixels, and the same state
keys with the same storage dtypes.
"""

import numpy as np
import pytest
import torch

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT, replace as jreplace
from nrdtpu.settings import HitDistanceReconstructionMode as JHM
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import ResourceType as RT, replace

from test_torch_relax_slice import CallCounter, psnr, run_sh_variant

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
FRAMES = 6
PSNR_BAR_DB = 60.0
LAUNCHES = {"relax_prepass": 1, "relax_smb_resolve": 1, "relax_vmb_resolve": 1,
            "nearest_multi": 1, "bilinear_resolve": 1, "relax_history_fix": 1,
            "relax_clamp_moments": 1, "relax_atrous": 5}
# configuration: (JAX settings, port settings, hit-distance holes, extra launches a frame)
CONFIGS = {
    "default": ({}, {}, False, {}),
    "anti_firefly": (dict(enableAntiFirefly=True), dict(enableAntiFirefly=True), False,
                     {"relax_antifirefly": 1}),
    "area_3x3": (dict(hitDistanceReconstructionMode=JHM.AREA_3X3),
                 dict(hitDistanceReconstructionMode=HM.AREA_3X3), True, {"hitdist_recon": 1}),
}


def pool_of(gen, fd, holes=None):
    sig = tfe.relax_pack_radiance_hitdist(torch.from_numpy(fd.spec_noisy),
                                          torch.from_numpy(fd.spec_hit_dist)).numpy()
    if holes is not None:
        sig[..., 3][holes] = 0.0
    return {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv, RT.IN_SPEC_RADIANCE_HITDIST: sig}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    jset, tset, with_holes, extra = CONFIGS[request.param]
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser.RELAX_SPECULAR}, resource_size=SIZE)
    te = TEngine({0: Denoiser.RELAX_SPECULAR}, resource_size=SIZE, device="cpu")
    je.set_denoiser_settings(0, jreplace(je._settings[0], **jset))
    te.set_denoiser_settings(0, replace(te._settings[0], **tset))
    frames = []
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        holes = ((np.random.default_rng(i).random(fd.view_z.shape) < 0.3) & (fd.hit_mask > 0)
                 if with_holes else None)
        pool = pool_of(gen, fd, holes)
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        with CallCounter() as calls:
            to = te.denoise([0], pool)
        frames.append(dict(jax=np.asarray(jo[JRT.OUT_SPEC_RADIANCE_HITDIST]),
                           torch=interop.tensor_to_numpy(to[RT.OUT_SPEC_RADIANCE_HITDIST]),
                           jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
                           tstate=dict(te.get_state(0)), calls=calls.counts))
    return request.param, frames, {**LAUNCHES, **extra}


@pytest.mark.parametrize("frame", range(FRAMES))
def test_output_matches_jax(runs, frame):
    name, frames, _ = runs
    r = frames[frame]
    assert r["torch"].shape == r["jax"].shape and np.isfinite(r["torch"]).all()
    p = psnr(r["torch"], r["jax"])
    print(f"RELAX_SPECULAR {name} frame {frame}: {p:.2f} dB against JAX")
    assert p >= PSNR_BAR_DB, f"{name} frame {frame}: {p:.2f} dB"


def test_state_matches_jax(runs):
    _, frames, _ = runs
    for r in frames:
        assert r["tstate"].keys() == r["jstate"].keys()
        for k, v in r["tstate"].items():
            assert str(v.dtype).split(".")[-1] == r["jstate"][k].dtype.name, k
        eq = np.mean(interop.tensor_to_numpy(r["tstate"]["history_length"])
                     == r["jstate"]["history_length"])
        assert eq >= 0.999, eq


def test_kernel_calls_a_frame(runs):
    """Every frame calls each kernel module exactly as often as the card launches it, and
    no other kernel module."""
    _, frames, launches = runs
    for r in frames:
        assert r["calls"] == {n: launches.get(n, 0) for n in r["calls"]}


@pytest.mark.parametrize("denoiser", ["RELAX_DIFFUSE_SPECULAR_SH", "RELAX_SPECULAR_SH"])
def test_unported_variants_raise(denoiser):
    """The specular SH variants raised NotImplementedError until the port ran them; now each
    runs a frame with finite outputs of the right shape."""
    run_sh_variant(denoiser)


def test_anti_firefly_changes_the_stored_history():
    """The slow history is stored after the anti-firefly pass (`denoiser.py:299-304`): on a
    signal with fireflies the stored history differs from the one without the pass."""
    gen = SceneGenerator(SceneSpec(size=(48, 32), noise=0.4), camera_mode="orbit")
    states = []
    for af in (False, True):
        eng = TEngine({0: Denoiser.RELAX_SPECULAR}, resource_size=(48, 32), device="cpu")
        eng.set_denoiser_settings(0, replace(eng._settings[0], enableAntiFirefly=af))
        for i in range(2):
            fd = gen.frame(i)
            pool = pool_of(gen, fd)
            pool[RT.IN_SPEC_RADIANCE_HITDIST][::7, ::5, :3] = 40.0
            eng.set_common_settings(fd.common_settings)
            eng.denoise([0], pool)
        states.append(eng.get_state(0)["spec_illum_prev"])
    assert not torch.equal(states[0], states[1])
