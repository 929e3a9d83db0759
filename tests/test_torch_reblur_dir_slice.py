"""REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION end to end on the CPU: the PyTorch port's Engine against
the JAX Engine (XLA path) over the orbit scene at 64x48.

The input is IN_DIFF_DIRECTION_HITDIST packed with `reblur_pack_directional_occlusion` from the
surface normal as the direction and the scene's binary one-sample AO (`ao_noisy`) as the
normalized hit distance, as `tests/test_reblur_full.py:191-196` packs it. The AREA_3X3 run also
zeroes a seeded 30 % of the geometry pixels (`HOLE_FRACTION`), so that the reconstruction
refills many and .w is 0 on many pixels of the input.

The JAX Engine runs op by op (`jax.disable_jit`), as in `tests/test_torch_reblur_occ_slice.py`:
each float32 step as its code writes it. Jitted, XLA fuses the steps, and the directional
luma changes, which scale .xyz by (luma + 1e-6) / (.w + 1e-6), carry the last-bit differences
far where .w is small: on the AREA_3X3 frames with holes the port's frame 3 was 59.5 dB from the
jitted JAX run and 96 dB from the op-by-op run.

The configurations, 4 frames each: the defaults, AREA_3X3 hit-distance reconstruction,
checkerboard BLACK with the input at half width (no PrePass and so no neighbour resolve: the
expanded input goes to TA, `nrdtpu/passes/reblur/denoiser.py:267`, `:278`), and
IN_NORMAL_ROUGHNESS packed as SQ_LINEAR (the diffuse path reads no roughness).

Bars: the output >= 60 dB PSNR against JAX on every frame, and the histories (state) too; the
state keys, shapes and storage dtypes of JAX's (REBLUR_DIFFUSE's: a (h, w, 4) bfloat16 history,
the fast history and luma_stab); the kernel calls a frame (no PrePass); dead pixels pass the
raw input; anti-firefly forced off; after 4 frames the output's .w closer to the clean AO than
the input.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import CheckerboardMode as JCB, Denoiser as JDenoiser
from nrdtpu.settings import HitDistanceReconstructionMode as JHM
from nrdtpu.settings import ResourceType as JRT, RoughnessEncoding as JRE, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.passes.reblur.denoiser import PORTED
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import ResourceType as RT, RoughnessEncoding as RE, replace

from test_torch_reblur_occ_slice import half_width
from test_torch_relax_slice import CallCounter, psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 4
PSNR_BAR_DB = 60.0
HOLE_FRACTION = 0.3
DO = "REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION"
IN, OUT = RT.IN_DIFF_DIRECTION_HITDIST, RT.OUT_DIFF_DIRECTION_HITDIST
# the kernel calls a frame: no PrePass, TS on the diffuse half
LAUNCHES = {"smb_resolve": 1, "history_fix": 1, "spatial_filter": 2, "ts_prelude": 1}
# configuration: (settings of both Engines, the roughness encoding, extra calls a frame; the
# AREA_3X3 run on frames with holes)
CONFIGS = {"default": ({}, "LINEAR", {}),
           "area_3x3": (dict(hitDistanceReconstructionMode="AREA_3X3"), "LINEAR",
                        {"hitdist_recon": 1}),
           "cb_black": (dict(checkerboardMode="BLACK"), "LINEAR", {}),
           "sq_linear": ({}, "SQ_LINEAR", {})}


def frames_of(n_frames, cb=None, size=SIZE, holes=False, encoding="LINEAR"):
    """(common settings, pool, truth) of each frame: the directional occlusion packed from the
    surface normal and the binary AO (half width under the checkerboard mode `cb`; with `holes`
    the AO zeroed on a seeded HOLE_FRACTION of the geometry pixels), IN_NORMAL_ROUGHNESS packed
    with `encoding`; the truth holds the clean AO, the input AO and the geometry mask."""
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    for i in range(n_frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        ao = fd.ao_noisy
        if holes:
            rng = np.random.default_rng((53, i))
            punched = (rng.uniform(size=ao.shape) < HOLE_FRACTION) & (fd.hit_mask > 0)
            ao = np.where(punched, 0.0, ao).astype(np.float32)
        sig = np.asarray(jfe.reblur_pack_directional_occlusion(jnp.asarray(fd.normal),
                                                               jnp.asarray(ao)))
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd, re_=JRE[encoding]),
                IN: sig if cb is None else half_width(sig, fd.common_settings.frameIndex, CB[cb])}
        yield fd.common_settings, pool, dict(clean=fd.ao_clean, ao=ao, mask=fd.hit_mask > 0)


def _settings(settings, hm, cbm):
    return {k: hm[v] if k == "hitDistanceReconstructionMode" else cbm[v]
            if k == "checkerboardMode" else v for k, v in settings.items()}


def _engine(settings, encoding="LINEAR"):
    eng = TEngine({0: Denoiser[DO]}, resource_size=SIZE, roughness_encoding=RE[encoding],
                  device="cpu")
    eng.set_denoiser_settings(0, replace(eng._settings[0], **_settings(settings, HM, CB)))
    return eng


def _port_frame(eng, cs, pool):
    eng.set_common_settings(cs)
    with CallCounter() as calls:
        out = eng.denoise([0], pool)
    return dict(out=interop.tensor_to_numpy(out[OUT]), calls=calls.counts,
                state=dict(eng.get_state(0)))


@functools.lru_cache(maxsize=None)
def run(config):
    """A configuration through the JAX Engine (op by op) and the port's Engine."""
    settings, encoding, extra = CONFIGS[config]
    je = JEngine({0: JDenoiser[DO]}, resource_size=SIZE, roughness_encoding=JRE[encoding])
    if settings:
        je.set_denoiser_settings(0, jreplace(je._settings[0], **_settings(settings, JHM, JCB)))
    eng = _engine(settings, encoding)
    frames = []
    for cs, pool, truth in frames_of(FRAMES, settings.get("checkerboardMode"),
                                     holes=bool(extra), encoding=encoding):
        je.set_common_settings(cs)
        with jax.disable_jit():
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        frames.append(dict(cs=cs, pool=pool, truth=truth, jax=np.asarray(jo[JRT(int(OUT))]),
                           jstate={k: np.asarray(v) for k, v in je.get_state(0).items()},
                           port=_port_frame(eng, cs, pool)))
    return config, frames, extra


@pytest.fixture(params=sorted(CONFIGS))
def runs(request):
    return run(request.param)


def test_output_matches_jax(runs):
    """The output >= 60 dB against JAX on every frame, of shape (h, w, 4) and finite."""
    config, frames, _ = runs
    for i, frame in enumerate(frames):
        got = frame["port"]["out"]
        assert got.shape == frame["jax"].shape == (SIZE[1], SIZE[0], 4)
        assert np.isfinite(got).all()
        p = psnr(got, frame["jax"])
        print(f"{config} frame {i}: {p:.2f} dB")
        assert p >= PSNR_BAR_DB, f"{config} frame {i}: {p:.2f} dB"


def test_state_matches_jax(runs):
    """The port's state: JAX's keys, shapes and storage dtypes (REBLUR_DIFFUSE's), and the
    histories >= 60 dB against JAX's on every frame."""
    config, frames, _ = runs
    for i, frame in enumerate(frames):
        js, ts = frame["jstate"], frame["port"]["state"]
        assert ts.keys() == js.keys(), sorted(ts.keys() ^ js.keys())
        assert tuple(ts["diff_history"].shape) == (SIZE[1], SIZE[0], 4)
        for k, v in ts.items():
            assert str(v.dtype).split(".")[-1] == js[k].dtype.name, k
            assert tuple(v.shape) == js[k].shape, k
        for k in ("diff_history", "diff_fast_history", "diff_luma_stab"):
            p = psnr(interop.tensor_to_numpy(ts[k]), js[k].astype(np.float32))
            assert p >= PSNR_BAR_DB, f"{config} {k} frame {i}: {p:.2f} dB"


def test_kernel_calls_a_frame(runs):
    """The kernel wrappers called a frame as the card launches them: no PrePass (never for
    directional occlusion), the radiance history fix and spatial filters, TS's diffuse half,
    the reconstruction with AREA_3X3."""
    _, frames, extra = runs
    for frame in frames:
        launches = {**LAUNCHES, **extra}
        assert frame["port"]["calls"] == {n: launches.get(n, 0) for n in KM.MODULES}


def test_prev_normal_roughness_is_the_packed_input():
    """At SQ_LINEAR the state keeps IN_NORMAL_ROUGHNESS as packed, as JAX's does."""
    frame = run("sq_linear")[1][-1]
    got = interop.tensor_to_numpy(frame["port"]["state"]["prev_normal_roughness"])
    np.testing.assert_array_equal(got, frame["jstate"]["prev_normal_roughness"])


def test_anti_firefly_is_forced_off():
    """enableAntiFirefly changes nothing of directional occlusion: its outputs equal the
    defaults' exactly on every frame (`nrdtpu/passes/reblur/denoiser.py:434-435`, `:448-449`)."""
    frames = run("default")[1]
    eng = _engine(dict(enableAntiFirefly=True))
    for frame in frames:
        np.testing.assert_array_equal(_port_frame(eng, frame["cs"], frame["pool"])["out"],
                                      frame["port"]["out"])


def test_dead_pixels_pass_the_raw_input():
    """Dead (sky) pixels pass the raw input (SplitScreen is off)."""
    frame = run("default")[1][-1]
    sky = frame["pool"][RT.IN_VIEWZ] > 1e6
    assert sky.any()
    np.testing.assert_array_equal(frame["port"]["out"][sky], frame["pool"][IN][sky])


def test_output_beats_the_noisy_input():
    """After 4 frames the output's .w is closer to the clean AO on the geometry than the binary
    input (`tests/test_reblur_full.py:198-202` asks it of the JAX package over 16 frames)."""
    frame = run("default")[1][-1]
    truth = frame["truth"]
    m = truth["mask"]
    noisy = np.abs(truth["ao"] - truth["clean"])[m].mean()
    out = np.abs(frame["port"]["out"][..., 3] - truth["clean"])[m].mean()
    assert out < noisy, (noisy, out)


def test_every_variant_is_ported():
    """REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION completes the port's REBLUR variants: every REBLUR
    `Denoiser` is in `PORTED`."""
    assert set(PORTED) == {d for d in Denoiser if d.name.startswith("REBLUR")}
    assert len(PORTED) == 10
