"""The RELAX_DIFFUSE_SPECULAR slice end to end on the CPU: the JAX Engine (XLA path) and the
PyTorch port's Engine, 4 frames of the orbit scene at 64x48 (one JAX Engine configuration), both
signals' inputs packed with `relax_pack_radiance_hitdist` from the raw hit distances; then the
launches a frame of each kernel module, and the port's two outputs against its RELAX_DIFFUSE's
and RELAX_SPECULAR's on the same frames: by default, with `enableAntiFirefly=True` and with
AREA_3X3 hit-distance reconstruction on frames whose hit distance is zeroed on a seeded 30 % of
the geometry pixels.

Bars: both outputs >= 60 dB PSNR against JAX on every frame (the passes agree to ~1e-6
relative, `tests/test_torch_relax_ds_passes.py`; the history length is rounded to whole
frames, so a last-bit difference at a .5 can round it the other way, which the feedback then
carries), the history length equal on >= 99.9 % of pixels, and the same state keys with the
same storage dtypes. The variant shares only the TA's head between its signals, its history
length is the one-signal variants' (the larger max frame num, the smaller min material, equal
by default) and the JAX Engine gives its outputs bit for bit as RELAX_DIFFUSE's and
RELAX_SPECULAR's: the port's must agree with its own one-signal outputs within 1e-6 abs.
"""

import numpy as np
import pytest
import torch

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import ResourceType as RT, replace

from test_torch_relax_slice import CallCounter, psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 4
PSNR_BAR_DB = 60.0
PAIR_ATOL = 1e-6
LAUNCHES = {"relax_prepass": 2, "relax_smb_resolve": 1, "relax_vmb_resolve": 1,
            "nearest_multi": 1, "bilinear_resolve": 1, "relax_history_fix": 1,
            "relax_clamp_moments": 1, "relax_atrous": 5}
# configuration: (port settings, hit-distance holes, extra launches a frame)
CONFIGS = {
    "default": ({}, False, {}),
    "anti_firefly": (dict(enableAntiFirefly=True), False, {"relax_antifirefly": 1}),
    "area_3x3": (dict(hitDistanceReconstructionMode=HM.AREA_3X3), True, {"hitdist_recon": 1}),
}
OUTPUTS = {RT.OUT_DIFF_RADIANCE_HITDIST: Denoiser.RELAX_DIFFUSE,
           RT.OUT_SPEC_RADIANCE_HITDIST: Denoiser.RELAX_SPECULAR}


def frames_of(with_holes):
    """(common settings, pool) of each frame: both signals, raw radiance and raw hitT."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        holes = ((np.random.default_rng(i).random(fd.view_z.shape) < 0.3) & (fd.hit_mask > 0)
                 if with_holes else None)
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                RT.IN_MV: fd.mv}
        for rt, noisy, hit in ((RT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist),
                               (RT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist)):
            sig = tfe.relax_pack_radiance_hitdist(torch.from_numpy(noisy),
                                                  torch.from_numpy(hit)).numpy()
            if holes is not None:
                sig[..., 3][holes] = 0.0
            pool[rt] = sig
        yield fd.common_settings, pool


def _engine(denoiser, settings):
    eng = TEngine({0: denoiser}, resource_size=SIZE, device="cpu")
    eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))
    return eng


@pytest.fixture(scope="module")
def runs():
    """The default configuration through the JAX Engine and the port's."""
    je = JEngine({0: JDenoiser.RELAX_DIFFUSE_SPECULAR}, resource_size=SIZE)
    te = _engine(Denoiser.RELAX_DIFFUSE_SPECULAR, {})
    frames = []
    for cs, pool in frames_of(False):
        je.set_common_settings(cs)
        te.set_common_settings(cs)
        jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        to = te.denoise([0], pool)
        frames.append(dict(jax={rt: np.asarray(jo[JRT(int(rt))]) for rt in OUTPUTS},
                           torch={rt: interop.tensor_to_numpy(to[rt]) for rt in OUTPUTS},
                           jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
                           tstate=dict(te.get_state(0))))
    return frames


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pairs(request):
    """A configuration through the port's RELAX_DIFFUSE_SPECULAR, RELAX_DIFFUSE and
    RELAX_SPECULAR, with the kernel wrappers' calls a frame of the first."""
    settings, with_holes, extra = CONFIGS[request.param]
    engs = {d: _engine(d, settings) for d in (Denoiser.RELAX_DIFFUSE_SPECULAR,
                                              *OUTPUTS.values())}
    frames = []
    for cs, pool in frames_of(with_holes):
        outs = {}
        for d, eng in engs.items():
            eng.set_common_settings(cs)
            with CallCounter() as calls:
                outs[d] = eng.denoise([0], pool)
            if d == Denoiser.RELAX_DIFFUSE_SPECULAR:
                counts = calls.counts
        frames.append(dict(outs=outs, calls=counts))
    return request.param, frames, {**LAUNCHES, **extra}


@pytest.mark.parametrize("frame", range(FRAMES))
@pytest.mark.parametrize("rt", list(OUTPUTS), ids=lambda rt: rt.name)
def test_output_matches_jax(runs, rt, frame):
    r = runs[frame]
    got, want = r["torch"][rt], r["jax"][rt]
    assert got.shape == want.shape and np.isfinite(got).all()
    p = psnr(got, want)
    print(f"RELAX_DIFFUSE_SPECULAR {rt.name} frame {frame}: {p:.2f} dB against JAX")
    assert p >= PSNR_BAR_DB, f"{rt.name} frame {frame}: {p:.2f} dB"


def test_state_matches_jax(runs):
    for r in runs:
        assert r["tstate"].keys() == r["jstate"].keys()
        assert {"diff_illum_prev", "spec_illum_prev", "reflection_hit_t"} <= r["tstate"].keys()
        for k, v in r["tstate"].items():
            assert str(v.dtype).split(".")[-1] == r["jstate"][k].dtype.name, k
        eq = np.mean(interop.tensor_to_numpy(r["tstate"]["history_length"])
                     == r["jstate"]["history_length"])
        assert eq >= 0.999, eq


def test_kernel_calls_a_frame(pairs):
    """Every frame calls each kernel module exactly as often as the card launches it: K15 once
    a signal, every other kernel once for both signals, and no other kernel module."""
    _, frames, launches = pairs
    for r in frames:
        assert r["calls"] == {n: launches.get(n, 0) for n in r["calls"]}


def test_outputs_match_one_signal_variants(pairs):
    name, frames, _ = pairs
    for i, r in enumerate(frames):
        for rt, single in OUTPUTS.items():
            got = r["outs"][Denoiser.RELAX_DIFFUSE_SPECULAR][rt]
            d = float((got - r["outs"][single][rt]).abs().max())
            assert d <= PAIR_ATOL, f"{name} frame {i} {rt.name}: max |d| {d:.3g}"


# the variants that the port ran last: REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION raised until the port
# ran every variant (ROADMAP.md Queue 1)
UNPORTED = ("REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION",)
# the variants that the port runs since they left UNPORTED
OCCLUSION = ("REBLUR_DIFFUSE_OCCLUSION", "REBLUR_SPECULAR_OCCLUSION",
             "REBLUR_DIFFUSE_SPECULAR_OCCLUSION")


def test_ported_variants():
    """The port runs all 19 variants: each builds an Engine on the CPU."""
    assert len(Denoiser) == 19 and set(UNPORTED + OCCLUSION) < {d.name for d in Denoiser}
    for d in Denoiser:
        TEngine({0: d}, resource_size=(48, 32), device="cpu")


@pytest.mark.parametrize("denoiser", UNPORTED)
def test_unported_variants_raise(denoiser):
    """No variant raises any more: the one that did, REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION, builds
    on the CPU with REBLUR_DIFFUSE's state, a (h, w, 4) history and a diff_luma_stab (its slice:
    `tests/test_torch_reblur_dir_slice.py`)."""
    eng = TEngine({0: Denoiser[denoiser]}, resource_size=(48, 32), device="cpu")
    state = eng._instances[0].init_state()
    assert tuple(state["diff_history"].shape) == (32, 48, 4)
    assert tuple(state["diff_luma_stab"].shape) == (32, 48)
    assert "spec_history" not in state


@pytest.mark.parametrize("denoiser", OCCLUSION)
def test_occlusion_variants_are_ported(denoiser):
    """The occlusion variants build on the CPU with one-channel (h, w, 1) histories (their
    slice: `tests/test_torch_reblur_occ_slice.py`)."""
    eng = TEngine({0: Denoiser[denoiser]}, resource_size=(48, 32), device="cpu")
    state = eng._instances[0].init_state()
    histories = [v for k, v in state.items() if k in ("diff_history", "spec_history")]
    assert histories and {tuple(v.shape) for v in histories} == {(32, 48, 1)}
