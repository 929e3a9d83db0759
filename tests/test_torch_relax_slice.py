"""The RELAX_DIFFUSE slice end to end: the JAX Engine (XLA path) and the PyTorch port's Engine
on the CPU, 6 frames of the orbit scene at 128x96 (one JAX Engine configuration), inputs
packed with `relax_pack_radiance_hitdist` from the raw diffuse hit distance; then the
launches a frame of each kernel module, the settings the port does not run yet, and
`tests/test_relax.py`'s behavioural checks on the port.

Bars: OUT_DIFF_RADIANCE_HITDIST >= 60 dB PSNR against JAX on every frame (the passes agree to
~1e-6 relative, `tests/test_torch_relax_passes.py`; the history length is rounded to whole
frames, so a last-bit difference at a .5 can round it the other way, which the feedback then
carries), the history length equal on >= 99.9 % of pixels, and the same state keys with the
same storage dtypes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import (CheckerboardMode, Denoiser, RelaxSettings, ResourceType as RT,
                                   replace)

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
FRAMES = 6
PSNR_BAR_DB = 60.0
LAUNCHES = {"relax_prepass": 1, "relax_smb_resolve": 1, "relax_history_fix": 1,
            "relax_clamp_moments": 1, "relax_atrous": 5}


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def pool_of(gen, fd):
    """The inputs as tests/test_relax.py packs them (numpy), by the port's front end."""
    sig = tfe.relax_pack_radiance_hitdist(torch.from_numpy(fd.diff_noisy),
                                          torch.from_numpy(fd.diff_hit_dist)).numpy()
    return {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv, RT.IN_DIFF_RADIANCE_HITDIST: sig}


class CallCounter:
    """Counts the calls of each kernel module's wrapper (on the CPU no kernel launches, so
    `launches` stays 0; the wrappers are called where the card would launch)."""

    def __init__(self):
        self.counts = dict.fromkeys(KM.MODULES, 0)
        self._orig = {n: getattr(m, n) for n, m in KM.MODULES.items()}

    def __enter__(self):
        for n, m in KM.MODULES.items():
            def counted(*a, _n=n, _f=self._orig[n], **k):
                self.counts[_n] += 1
                return _f(*a, **k)
            setattr(m, n, counted)
        return self

    def __exit__(self, *exc):
        for n, m in KM.MODULES.items():
            setattr(m, n, self._orig[n])


@pytest.fixture(scope="module")
def runs():
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser.RELAX_DIFFUSE}, resource_size=SIZE)
    te = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=SIZE, device="cpu")
    frames = []
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = pool_of(gen, fd)
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        with CallCounter() as calls:
            to = te.denoise([0], pool)
        frames.append(dict(jax=np.asarray(jo[JRT.OUT_DIFF_RADIANCE_HITDIST]),
                           torch=interop.tensor_to_numpy(to[RT.OUT_DIFF_RADIANCE_HITDIST]),
                           jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
                           tstate=dict(te.get_state(0)), calls=calls.counts))
    return frames


@pytest.mark.parametrize("frame", range(FRAMES))
def test_output_matches_jax(runs, frame):
    r = runs[frame]
    assert r["torch"].shape == r["jax"].shape and np.isfinite(r["torch"]).all()
    p = psnr(r["torch"], r["jax"])
    assert p >= PSNR_BAR_DB, f"frame {frame}: {p:.2f} dB"


def test_state_matches_jax(runs):
    for r in runs:
        assert r["tstate"].keys() == r["jstate"].keys()
        for k, v in r["tstate"].items():
            assert str(v.dtype).split(".")[-1] == r["jstate"][k].dtype.name, k
        eq = np.mean(interop.tensor_to_numpy(r["tstate"]["history_length"])
                     == r["jstate"]["history_length"])
        assert eq >= 0.999, eq


def test_kernel_calls_a_frame(runs):
    """Every frame calls each RELAX kernel module exactly as often as the card launches it
    (1 / 1 / 1 / 1 / 5), and no other kernel module."""
    for r in runs:
        assert r["calls"] == {n: LAUNCHES.get(n, 0) for n in KM.MODULES}


@pytest.mark.parametrize("iterations,calls", [(1, 2), (2, 2), (8, 8), (12, 8)])
def test_atrous_iterations(iterations, calls):
    """atrousIterationNum is clipped to [2, 8], as in the reference (`denoiser.py:307`)."""
    gen = SceneGenerator(SceneSpec(size=(48, 32)), camera_mode="orbit")
    eng = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=(48, 32), device="cpu")
    eng.set_denoiser_settings(0, RelaxSettings(atrousIterationNum=iterations))
    fd = gen.frame(0)
    eng.set_common_settings(fd.common_settings)
    with CallCounter() as c:
        out = eng.denoise([0], pool_of(gen, fd))[RT.OUT_DIFF_RADIANCE_HITDIST]
    assert c.counts["relax_atrous"] == calls and bool(out.isfinite().all())


def sh_pool_of(gen, fd):
    """Both signals' SH0 / SH1 (`relax_pack_sh`, SH1 along the normal) beside the geometry."""
    pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv}
    normal = torch.from_numpy(fd.normal.astype(np.float32))
    for (rt0, rt1), noisy, hit in (((RT.IN_DIFF_SH0, RT.IN_DIFF_SH1), fd.diff_noisy,
                                    fd.diff_hit_dist),
                                   ((RT.IN_SPEC_SH0, RT.IN_SPEC_SH1), fd.spec_noisy,
                                    fd.spec_hit_dist)):
        sh0, sh1 = tfe.relax_pack_sh(torch.from_numpy(noisy), torch.from_numpy(hit), normal)
        pool[rt0], pool[rt1] = sh0.numpy(), sh1.numpy()
    return pool


SH_OUTPUTS = {"DIFFUSE": (RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1),
              "SPECULAR": (RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1)}


def run_sh_variant(denoiser, size=(48, 32)):
    """One frame of an SH variant through the port's Engine on the CPU: every output of its
    signals is finite and of the resource's shape, and no other is returned."""
    gen = SceneGenerator(SceneSpec(size=size), camera_mode="orbit")
    fd = gen.frame(0)
    eng = TEngine({0: Denoiser[denoiser]}, resource_size=size, device="cpu")
    eng.set_common_settings(fd.common_settings)
    outs = eng.denoise([0], sh_pool_of(gen, fd))
    expected = {rt for part, rts in SH_OUTPUTS.items() if part in denoiser for rt in rts}
    assert set(outs) == expected
    for rt in expected:
        assert tuple(outs[rt].shape) == (size[1], size[0], 4), rt
        assert bool(outs[rt].isfinite().all()), rt


@pytest.mark.parametrize("denoiser", ["RELAX_DIFFUSE_SH", "RELAX_SPECULAR_SH",
                                      "RELAX_DIFFUSE_SPECULAR_SH"])
def test_unported_variants_raise(denoiser):
    """The SH variants raised NotImplementedError until the port ran them; now each runs a
    frame with finite outputs of the right shape (`tests/test_torch_relax_sh_slice.py` holds
    them against the JAX Engine)."""
    run_sh_variant(denoiser)


@pytest.mark.parametrize("settings", [dict(checkerboardMode=CheckerboardMode.BLACK),
                                      "validation"], ids=["checkerboard", "validation"])
def test_unported_settings_raise(settings):
    """Neither raises any more. The validation overlay raised NotImplementedError until the port
    rendered it; now frame 1 gives a finite (h, w, 4) OUT_VALIDATION that shows
    (`tests/test_torch_observability_relax.py` holds it against the JAX Engine). Checkerboard
    raised until the port ran it; now a frame of half-width input (every other pixel of the
    full-width one) gives a finite full-width output (`tests/test_torch_relax_cb.py` holds it
    against the JAX Engine)."""
    gen = SceneGenerator(SceneSpec(size=(48, 32)), camera_mode="orbit")
    eng = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=(48, 32), device="cpu")
    fd = gen.frame(0)
    if settings == "validation":
        for i in range(2):  # frame 0 resets the history, which clears the overlay
            fd = gen.frame(i)
            cs = fd.common_settings
            cs.enableValidation = True
            eng.set_common_settings(cs)
            overlay = eng.denoise([0], pool_of(gen, fd))[RT.OUT_VALIDATION]
        assert tuple(overlay.shape) == (32, 48, 4)
        assert bool(overlay.isfinite().all()) and float(overlay[..., 3].max()) == 1.0
        return
    eng.set_denoiser_settings(0, replace(RelaxSettings(), **settings))
    eng.set_common_settings(fd.common_settings)
    pool = pool_of(gen, fd)
    pool[RT.IN_DIFF_RADIANCE_HITDIST] = np.ascontiguousarray(
        pool[RT.IN_DIFF_RADIANCE_HITDIST][:, ::2])
    out = eng.denoise([0], pool)[RT.OUT_DIFF_RADIANCE_HITDIST]
    assert tuple(out.shape) == (32, 48, 4)
    assert bool(out.isfinite().all())


@pytest.mark.parametrize("denoiser", ["RELAX_DIFFUSE_SH", "RELAX_SPECULAR_SH",
                                      "RELAX_DIFFUSE_SPECULAR_SH"])
def test_sh_checkerboard_raises(denoiser):
    """The SH variants under checkerboard raise NotImplementedError, naming the fault of the
    JAX reference that leaves them without one: its dead-pixel pass-through of SH1 reads the
    half-width input unexpanded (`nrdtpu/passes/relax/denoiser.py:367-369`)."""
    eng = TEngine({0: Denoiser[denoiser]}, resource_size=(48, 32), device="cpu")
    eng.set_denoiser_settings(0, replace(RelaxSettings(),
                                         checkerboardMode=CheckerboardMode.WHITE))
    gen = SceneGenerator(SceneSpec(size=(48, 32)), camera_mode="orbit")
    fd = gen.frame(0)
    eng.set_common_settings(fd.common_settings)
    with pytest.raises(NotImplementedError, match=r"denoiser\.py:367-369"):
        eng.denoise([0], sh_pool_of(gen, fd))


def test_front_end_packs_as_jax():
    gen = SceneGenerator(SceneSpec(size=(48, 32)), camera_mode="orbit")
    fd = gen.frame(1)
    ours = pool_of(gen, fd)[RT.IN_DIFF_RADIANCE_HITDIST]
    np.testing.assert_array_equal(ours, np.asarray(jfe.relax_pack_radiance_hitdist(
        jnp.asarray(fd.diff_noisy), jnp.asarray(fd.diff_hit_dist))))


# --- tests/test_relax.py:53-91 on the port ---------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    return SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="static")


def run_frames(gen, n_frames, settings=None):
    eng = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=SIZE, device="cpu")
    if settings is not None:
        eng.set_denoiser_settings(0, settings)
    out = None
    for i in range(n_frames):
        fd = gen.frame(i)
        eng.set_common_settings(fd.common_settings)
        out = eng.denoise([0], pool_of(gen, fd))[RT.OUT_DIFF_RADIANCE_HITDIST].numpy()
    return out, eng, fd


def test_converges_to_clean(scene):
    out, _, fd = run_frames(scene, 20)
    assert np.isfinite(out).all()
    geom = fd.hit_mask > 0
    p_noisy = psnr(fd.diff_noisy[geom], fd.diff_clean[geom])
    p_out = psnr(out[..., :3][geom], fd.diff_clean[geom])
    assert p_out > p_noisy + 8.0, (p_noisy, p_out)


def test_single_frame_spatial_only(scene):
    """First frame: the spatial variance estimation and the à-trous already denoise."""
    out, _, fd = run_frames(scene, 1)
    geom = fd.hit_mask > 0
    p_noisy = psnr(fd.diff_noisy[geom], fd.diff_clean[geom])
    p_out = psnr(out[..., :3][geom], fd.diff_clean[geom])
    assert p_out > p_noisy + 2.0, (p_noisy, p_out)


def test_history_length_grows(scene):
    _, eng, fd = run_frames(scene, 10)
    hist = eng.get_state(0)["history_length"].numpy()
    assert np.median(hist[fd.hit_mask > 0]) >= 9.0


def test_split_screen(scene):
    gen = SceneGenerator(SceneSpec(size=(48, 32)), camera_mode="static")
    eng = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=(48, 32), device="cpu")
    fd = gen.frame(0)
    cs = fd.common_settings
    cs.splitScreen = 0.5
    eng.set_common_settings(cs)
    pool = pool_of(gen, fd)
    out = eng.denoise([0], pool)[RT.OUT_DIFF_RADIANCE_HITDIST].numpy()
    left = (fd.hit_mask > 0)[:, :24]
    noisy = pool[RT.IN_DIFF_RADIANCE_HITDIST][:, :24]
    np.testing.assert_array_equal(out[:, :24][left], noisy[left])


def test_hit_dist_reconstruction_engine():
    """AREA_3X3 and AREA_5X5 on RELAX_DIFFUSE run through REBLUR's reconstruction kernel
    (`relax/denoiser.py:249-255`): one call a frame, finite output, holes refilled before the
    PrePass. Its parity with the XLA path is `tests/test_torch_relax_passes.py`'s."""
    from nrdtpu_torch.settings import HitDistanceReconstructionMode as HM

    gen = SceneGenerator(SceneSpec(size=(48, 32)), camera_mode="orbit")
    for mode in (HM.AREA_3X3, HM.AREA_5X5):
        eng = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=(48, 32), device="cpu")
        eng.set_denoiser_settings(0, RelaxSettings(hitDistanceReconstructionMode=mode))
        for i in range(2):
            fd = gen.frame(i)
            pool = pool_of(gen, fd)
            holes = (np.random.default_rng(i).random((32, 48)) < 0.3) & (fd.hit_mask > 0)
            pool[RT.IN_DIFF_RADIANCE_HITDIST][..., 3][holes] = 0.0
            eng.set_common_settings(fd.common_settings)
            with CallCounter() as c:
                out = eng.denoise([0], pool)[RT.OUT_DIFF_RADIANCE_HITDIST]
            assert c.counts["hitdist_recon"] == 1 and bool(out.isfinite().all())
