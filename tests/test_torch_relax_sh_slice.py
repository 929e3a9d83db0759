"""The RELAX SH variants end to end on the CPU: RELAX_DIFFUSE_SH, RELAX_SPECULAR_SH and
RELAX_DIFFUSE_SPECULAR_SH through the JAX Engine (XLA path) and the PyTorch port's Engine, 4
frames of the orbit scene at 64x48 (one JAX Engine a variant, shared by every test of this
file), each signal's SH0 / SH1 packed with `relax_pack_sh` from the scene's noisy radiance, its
raw hit distance and its normal; then the launches a frame of each kernel module, and the port's
RELAX_DIFFUSE_SPECULAR_SH outputs against its own RELAX_DIFFUSE_SH's and RELAX_SPECULAR_SH's on
the same frames: by default and with AREA_3X3 hit-distance reconstruction (on SH0's hitT) on
frames whose hit distance is zeroed on a seeded 30 % of the geometry pixels.

Bars: every output (SH0 and SH1 of each signal) >= 60 dB PSNR against JAX on every frame (the
passes agree to ~1e-6 relative, `tests/test_torch_relax_sh_passes.py`; the SH histories are
rounded to bfloat16 each frame, so a last-bit difference at a rounding tie carries one bf16
step into the next frame), the history length equal on >= 99.9 % of pixels, the same state
keys with the same storage dtypes (the four SH histories bfloat16), and the launches a frame
those of the variant without SH: the SH planes ride its launches. The JAX Engine gives
RELAX_DIFFUSE_SPECULAR_SH's four outputs bit for bit as the one-signal SH variants'; the
port's must agree with its own one-signal outputs within 1e-6 abs.
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

from test_torch_relax_ds_slice import LAUNCHES as RDS_LAUNCHES
from test_torch_relax_slice import CallCounter, psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 4
PSNR_BAR_DB = 60.0
PAIR_ATOL = 1e-6
HOLE_FRACTION = 0.3
SH_IN = {"diff": (RT.IN_DIFF_SH0, RT.IN_DIFF_SH1), "spec": (RT.IN_SPEC_SH0, RT.IN_SPEC_SH1)}
# each SH variant: its signals' outputs, and its launches a frame (the variant without SH's)
VARIANTS = {
    "RELAX_DIFFUSE_SH": ((RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1),
                         {"relax_prepass": 1, "relax_smb_resolve": 1, "relax_history_fix": 1,
                          "relax_clamp_moments": 1, "relax_atrous": 5}),
    "RELAX_SPECULAR_SH": ((RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1), {**RDS_LAUNCHES,
                                                               "relax_prepass": 1}),
    "RELAX_DIFFUSE_SPECULAR_SH": ((RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1, RT.OUT_SPEC_SH0,
                                   RT.OUT_SPEC_SH1), RDS_LAUNCHES),
}
SH_STATE = ("diff_sh_prev", "diff_sh_responsive_prev", "spec_sh_prev", "spec_sh_responsive_prev")
# configuration of the pair check: (port settings, hit-distance holes, extra launches a frame)
CONFIGS = {
    "default": ({}, False, {}),
    "area_3x3": (dict(hitDistanceReconstructionMode=HM.AREA_3X3), True, {"hitdist_recon": 1}),
}
PAIR = "RELAX_DIFFUSE_SPECULAR_SH"
SINGLES = {"RELAX_DIFFUSE_SH": VARIANTS["RELAX_DIFFUSE_SH"][0],
           "RELAX_SPECULAR_SH": VARIANTS["RELAX_SPECULAR_SH"][0]}


def frames_of(with_holes=False):
    """(common settings, pool) of each frame: both signals' SH0 / SH1 (SH1 along the normal)."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        holes = ((np.random.default_rng(i).random(fd.view_z.shape) < HOLE_FRACTION)
                 & (fd.hit_mask > 0) if with_holes else None)
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                RT.IN_MV: fd.mv}
        normal = torch.from_numpy(fd.normal.astype(np.float32))
        for sig, noisy, hit in (("diff", fd.diff_noisy, fd.diff_hit_dist),
                                ("spec", fd.spec_noisy, fd.spec_hit_dist)):
            sh0, sh1 = tfe.relax_pack_sh(torch.from_numpy(noisy), torch.from_numpy(hit), normal)
            sh0 = sh0.numpy()
            if holes is not None:
                sh0[..., 3][holes] = 0.0
            pool[SH_IN[sig][0]], pool[SH_IN[sig][1]] = sh0, sh1.numpy()
        yield fd.common_settings, pool


def _engine(denoiser, settings):
    eng = TEngine({0: Denoiser[denoiser]}, resource_size=SIZE, device="cpu")
    eng.set_denoiser_settings(0, replace(eng._settings[0], **settings))
    return eng


@pytest.fixture(scope="module")
def runs():
    """Each SH variant through the JAX Engine and the port's, with the port's kernel wrapper
    calls a frame."""
    out = {}
    for name, (outputs, _) in VARIANTS.items():
        je = JEngine({0: JDenoiser[name]}, resource_size=SIZE)
        te = _engine(name, {})
        frames = []
        for cs, pool in frames_of():
            je.set_common_settings(cs)
            te.set_common_settings(cs)
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
            with CallCounter() as calls:
                to = te.denoise([0], pool)
            frames.append(dict(jax={rt: np.asarray(jo[JRT(int(rt))]) for rt in outputs},
                               torch={rt: interop.tensor_to_numpy(to[rt]) for rt in outputs},
                               calls=calls.counts,
                               jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
                               tstate=dict(te.get_state(0))))
        out[name] = frames
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pairs(request):
    """A configuration through the port's RELAX_DIFFUSE_SPECULAR_SH, RELAX_DIFFUSE_SH and
    RELAX_SPECULAR_SH, with the kernel wrappers' calls a frame of the first."""
    settings, with_holes, extra = CONFIGS[request.param]
    engs = {d: _engine(d, settings) for d in (PAIR, *SINGLES)}
    frames = []
    for cs, pool in frames_of(with_holes):
        outs = {}
        for d, eng in engs.items():
            eng.set_common_settings(cs)
            with CallCounter() as calls:
                outs[d] = eng.denoise([0], pool)
            if d == PAIR:
                counts = calls.counts
        frames.append(dict(outs=outs, calls=counts))
    return request.param, frames, {**RDS_LAUNCHES, **extra}


@pytest.mark.parametrize("frame", range(FRAMES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_outputs_match_jax(runs, variant, frame):
    r = runs[variant][frame]
    for rt in VARIANTS[variant][0]:
        got, want = r["torch"][rt], r["jax"][rt]
        assert got.shape == want.shape == (SIZE[1], SIZE[0], 4) and np.isfinite(got).all()
        p = psnr(got, want)
        print(f"{variant} {rt.name} frame {frame}: {p:.2f} dB against JAX")
        assert p >= PSNR_BAR_DB, f"{variant} {rt.name} frame {frame}: {p:.2f} dB"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_matches_jax(runs, variant):
    """The same state keys and storage dtypes as JAX, the four SH histories (two a signal)
    bfloat16, and the history length equal on >= 99.9 % of pixels."""
    for r in runs[variant]:
        assert r["tstate"].keys() == r["jstate"].keys()
        sh = [k for k in SH_STATE if k in r["tstate"]]
        assert len(sh) == 2 * len(VARIANTS[variant][0]) // 2
        assert all(r["tstate"][k].dtype == torch.bfloat16 for k in sh)
        for k, v in r["tstate"].items():
            assert str(v.dtype).split(".")[-1] == r["jstate"][k].dtype.name, k
        eq = np.mean(interop.tensor_to_numpy(r["tstate"]["history_length"])
                     == r["jstate"]["history_length"])
        assert eq >= 0.999, eq


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernel_calls_a_frame(runs, variant):
    """Every frame calls each kernel module exactly as often as the variant without SH: no SH
    plane adds a launch."""
    launches = VARIANTS[variant][1]
    for r in runs[variant]:
        assert r["calls"] == {n: launches.get(n, 0) for n in r["calls"]}


def test_pair_kernel_calls_a_frame(pairs):
    _, frames, launches = pairs
    for r in frames:
        assert r["calls"] == {n: launches.get(n, 0) for n in r["calls"]}


def test_outputs_match_one_signal_variants(pairs):
    name, frames, _ = pairs
    for i, r in enumerate(frames):
        for single, rts in SINGLES.items():
            for rt in rts:
                got = r["outs"][PAIR][rt]
                assert bool(got.isfinite().all())
                d = float((got - r["outs"][single][rt]).abs().max())
                assert d <= PAIR_ATOL, f"{name} frame {i} {rt.name}: max |d| {d:.3g}"


def test_dead_pixels_pass_the_raw_sh(runs):
    """Sky pixels (dead) pass the raw SH0 (linear, not YCoCg, as in JAX) and SH1 through."""
    frame = runs["RELAX_DIFFUSE_SH"][-1]
    _, pool = list(frames_of())[-1]
    sky = pool[RT.IN_VIEWZ] > 1e6
    assert sky.any()
    for rt_in, rt_out in zip(SH_IN["diff"], VARIANTS["RELAX_DIFFUSE_SH"][0]):
        np.testing.assert_array_equal(frame["torch"][rt_out][sky], pool[rt_in][sky])
