"""The REBLUR occlusion variants end to end on the CPU: REBLUR_DIFFUSE_OCCLUSION,
REBLUR_SPECULAR_OCCLUSION and REBLUR_DIFFUSE_SPECULAR_OCCLUSION through the PyTorch port's
Engine against the JAX Engine (XLA path), over the orbit scene at 64x48. Each signal's input is
a binary one-sample ambient-occlusion estimate of the scene's clean AO (the diffuse one the
scene's `ao_noisy`, the specular one a second draw from a seed), as IN_DIFF_HITDIST /
IN_SPEC_HITDIST take it. A few percent of its geometry pixels are 0; the AREA_3X3 runs also zero
a seeded 30 % of them (`HOLE_FRACTION`), so that the reconstruction refills many.

The JAX Engine runs op by op (`jax.disable_jit`), as in `tests/test_torch_reblur_cb_slice.py`:
each float32 step as its code writes it. On the CPU it runs REBLUR_DIFFUSE_SPECULAR_OCCLUSION
signal by signal with the one-signal functions (`fused_ok` needs the TPU kernels), op for op
what REBLUR_DIFFUSE_OCCLUSION and REBLUR_SPECULAR_OCCLUSION compute, so one JAX run a
configuration holds all three variants. The configurations: the defaults (4 frames),
AREA_3X3 hit-distance reconstruction (2 frames), and checkerboard BLACK and WHITE with the AO
at half width (3 and 2 frames); the defaults and BLACK also hold REBLUR_DIFFUSE_SPECULAR_OCCLUSION
with NRDTPU_REBLUR_BAND=1 (the port's band; JAX's band is Pallas only, and off the TPU the
switch leaves its XLA chain as it is). `enableAntiFirefly` is forced off for occlusion
(`nrdtpu/passes/reblur/denoiser.py:416-418`, `:434-438`, `:448`, `:456`): the port with it must
give the defaults' outputs exactly.

Bars: every output >= 60 dB PSNR against JAX on every frame, the histories (state) too; the
state keys, shapes and storage dtypes of JAX's (no luma_stab: no TS); the launches a frame of
each variant; dead pixels pass the raw input; JAX's state carried to the port with
`nrdtpu_torch.interop` continues JAX's run.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import CheckerboardMode as JCB, Denoiser as JDenoiser
from nrdtpu.settings import HitDistanceReconstructionMode as JHM
from nrdtpu.settings import ResourceType as JRT, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import ResourceType as RT, replace

from test_torch_relax_slice import CallCounter, psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
PSNR_BAR_DB = 60.0
HOLE_FRACTION = 0.3
D, S, DS = ("REBLUR_DIFFUSE_OCCLUSION", "REBLUR_SPECULAR_OCCLUSION",
            "REBLUR_DIFFUSE_SPECULAR_OCCLUSION")
IN = {"diff": RT.IN_DIFF_HITDIST, "spec": RT.IN_SPEC_HITDIST}
OUT = {"diff": RT.OUT_DIFF_HITDIST, "spec": RT.OUT_SPEC_HITDIST}
# each variant's signals and launches a frame (no PrePass, no TS)
D_LAUNCHES = {"smb_resolve": 1, "history_fix": 1, "spatial_filter": 2}
S_LAUNCHES = {**D_LAUNCHES, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1}
DS_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
               "history_fix_fused": 1, "spatial_filter_fused": 2}
BAND_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
                 "reblur_band": 1}
VARIANTS = {D: (("diff",), D_LAUNCHES), S: (("spec",), S_LAUNCHES),
            DS: (("diff", "spec"), DS_LAUNCHES)}
BAND = DS + "+BAND"
# configuration: (settings of both Engines, frames, the port's engines, extra launches a frame;
# the AREA_3X3 run on frames with holes)
CONFIGS = {"default": ({}, 4, (D, S, DS, BAND), {}),
           "area_3x3": (dict(hitDistanceReconstructionMode="AREA_3X3"), 2, (D, S, DS),
                        {"hitdist_recon": 1}),
           "cb_black": (dict(checkerboardMode="BLACK"), 3, (D, S, DS, BAND), {}),
           "cb_white": (dict(checkerboardMode="WHITE"), 2, (D, S, DS), {})}
# the state planes of one signal, which a variant without it does not keep
SIGNAL_STATE = {sig: (f"{sig}_history", f"{sig}_fast_history") for sig in ("diff", "spec")}
SIGNAL_STATE["spec"] += ("prev_spec_hitdist_for_tracking",)


def half_width(plane, frame_index, mode):
    """The half-width checkerboard input of a full-width plane: half texel x holds the pixel of
    the pair (2x, 2x + 1) that has data this frame (`tests/test_reblur_full.py:244-250`)."""
    h, w = plane.shape[:2]
    has = (((np.arange(w)[None, :] + np.arange(h)[:, None] + int(frame_index)) & 1)
           == int(mode) - 1)
    sel = np.where(has[:, ::2], 0, 1) + np.arange(0, w, 2)[None, :]
    return np.ascontiguousarray(plane[np.arange(h)[:, None], sel])


def frames_of(n_frames, cb=None, size=SIZE, holes=False):
    """(common settings, pool, truth) of each frame: both signals' binary AO (half width under
    the checkerboard mode `cb`; with `holes` zeroed on a seeded HOLE_FRACTION of the geometry
    pixels), and the clean AO and geometry mask."""
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    for i in range(n_frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        rng = np.random.default_rng((37, i))
        ao = {"diff": fd.ao_noisy,
              "spec": (rng.uniform(size=fd.ao_clean.shape) < fd.ao_clean).astype(np.float32)}
        if holes:
            punched = (rng.uniform(size=fd.ao_clean.shape) < HOLE_FRACTION) & (fd.hit_mask > 0)
            ao = {sig: np.where(punched, 0.0, plane).astype(np.float32)
                  for sig, plane in ao.items()}
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                RT.IN_MV: fd.mv}
        for sig, plane in ao.items():
            pool[IN[sig]] = (plane if cb is None
                             else half_width(plane, fd.common_settings.frameIndex, CB[cb]))
        yield fd.common_settings, pool, dict(clean=fd.ao_clean, mask=fd.hit_mask > 0, ao=ao)


def _settings(settings, hm, cbm):
    return {k: hm[v] if k == "hitDistanceReconstructionMode" else cbm[v]
            if k == "checkerboardMode" else v for k, v in settings.items()}


def _engine(denoiser, settings):
    eng = TEngine({0: Denoiser[denoiser]}, resource_size=SIZE, device="cpu")
    eng.set_denoiser_settings(0, replace(eng._settings[0], **_settings(settings, HM, CB)))
    return eng


@contextlib.contextmanager
def _band(on):
    """NRDTPU_REBLUR_BAND=1 around the port's band engine only."""
    if not on:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NRDTPU_REBLUR_BAND", "1")
        yield


def _port_frame(eng, name, cs, pool):
    eng.set_common_settings(cs)
    with _band(name == BAND), CallCounter() as calls:
        out = eng.denoise([0], pool)
    signals = VARIANTS[name.split("+")[0]][0]
    return dict(out={OUT[sig]: interop.tensor_to_numpy(out[OUT[sig]]) for sig in signals},
                calls=calls.counts, state=dict(eng.get_state(0)))


@functools.lru_cache(maxsize=None)
def run(config):
    """A configuration through the JAX Engine (REBLUR_DIFFUSE_SPECULAR_OCCLUSION, op by op) and
    the port's engines, with each port engine's wrapper calls and state a frame."""
    settings, n_frames, engines, extra = CONFIGS[config]
    je = JEngine({0: JDenoiser[DS]}, resource_size=SIZE)
    if settings:
        je.set_denoiser_settings(0, jreplace(je._settings[0], **_settings(settings, JHM, JCB)))
    engs = {name: _engine(name.split("+")[0], settings) for name in engines}
    frames = []
    for cs, pool, truth in frames_of(n_frames, settings.get("checkerboardMode"),
                                     holes=bool(extra)):
        je.set_common_settings(cs)
        with jax.disable_jit():
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        frame = dict(cs=cs, pool=pool, truth=truth,
                     jax={rt: np.asarray(jo[JRT(int(rt))]) for rt in OUT.values()},
                     jstate={k: np.asarray(v) for k, v in je.get_state(0).items()})
        for name, eng in engs.items():
            frame[name] = _port_frame(eng, name, cs, pool)
        frames.append(frame)
    return config, frames, extra


@pytest.fixture(params=sorted(CONFIGS))
def runs(request):
    return run(request.param)


def _ported(frame):
    return [k for k in frame if k in VARIANTS or k == BAND]


def test_outputs_match_jax(runs):
    """Every output of every port engine >= 60 dB against JAX on every frame, of JAX's shape
    (h, w, 1), finite and in [0, 1]."""
    config, frames, _ = runs
    for i, frame in enumerate(frames):
        for name in _ported(frame):
            for rt, got in frame[name]["out"].items():
                want = frame["jax"][rt]
                assert got.shape == want.shape == (SIZE[1], SIZE[0], 1)
                assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
                p = psnr(got, want)
                print(f"{config} {name} {rt.name} frame {i}: {p:.2f} dB")
                assert p >= PSNR_BAR_DB, f"{config} {name} {rt.name} frame {i}: {p:.2f} dB"


def test_state_matches_jax(runs):
    """The port's state: JAX's keys, shapes and storage dtypes (the (h, w, 1) histories
    bfloat16, no luma_stab), and the histories >= 60 dB against JAX's on every frame."""
    config, frames, _ = runs
    for i, frame in enumerate(frames):
        js = frame["jstate"]
        for name in _ported(frame):
            ts = frame[name]["state"]
            signals = VARIANTS[name.split("+")[0]][0]
            want_keys = set(js).difference(*(SIGNAL_STATE[s] for s in ("diff", "spec")
                                             if s not in signals))
            assert ts.keys() == want_keys, (name, sorted(ts.keys() ^ want_keys))
            for k, v in ts.items():
                assert str(v.dtype).split(".")[-1] == js[k].dtype.name, (name, k)
                assert tuple(v.shape) == js[k].shape, (name, k)
            for sig in signals:
                for k in (f"{sig}_history", f"{sig}_fast_history"):
                    p = psnr(interop.tensor_to_numpy(ts[k]), js[k].astype(np.float32))
                    assert p >= PSNR_BAR_DB, f"{config} {name} {k} frame {i}: {p:.2f} dB"


def test_kernel_calls_a_frame(runs):
    """Each port engine calls each kernel module as often a frame as the card launches it: no
    PrePass and no TS (no ts_prelude), the band in place of the history fix and both spatial
    stages, the reconstruction with AREA_3X3."""
    _, frames, extra = runs
    for frame in frames:
        for name in _ported(frame):
            launches = {**(BAND_LAUNCHES if name == BAND else VARIANTS[name][1]), **extra}
            assert frame[name]["calls"] == {n: launches.get(n, 0) for n in KM.MODULES}, name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_anti_firefly_is_forced_off(variant):
    """enableAntiFirefly changes nothing of an occlusion variant: its outputs equal the
    defaults' exactly on every frame."""
    frames = run("default")[1]
    eng = _engine(variant, dict(enableAntiFirefly=True))
    for frame in frames:
        got = _port_frame(eng, variant, frame["cs"], frame["pool"])
        for rt, out in got["out"].items():
            np.testing.assert_array_equal(out, frame[variant]["out"][rt])


def test_dead_pixels_pass_the_raw_input():
    """Dead (sky) pixels pass the raw input (SplitScreen is off)."""
    frame = run("default")[1][-1]
    sky = frame["pool"][RT.IN_VIEWZ] > 1e6
    assert sky.any()
    for name in VARIANTS:
        for sig in VARIANTS[name][0]:
            np.testing.assert_array_equal(frame[name]["out"][OUT[sig]][..., 0][sky],
                                          frame["pool"][IN[sig]][sky])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_state_matches_jax(variant):
    """The port's initial state has JAX's keys, shapes and dtypes."""
    je = JEngine({0: JDenoiser[variant]}, resource_size=SIZE)
    js = je._instances[0].init_state()
    ts = _engine(variant, {})._instances[0].init_state()
    assert ts.keys() == js.keys()
    for k, v in ts.items():
        assert tuple(v.shape) == js[k].shape and str(v.dtype).split(".")[-1] == js[k].dtype.name


def test_jax_state_carries_to_the_port():
    """JAX's state after frame 2, carried to the port with `interop.state_from_numpy` (the
    (h, w, 1) bfloat16 histories bit for bit) in place of the port's own, continues JAX's run:
    frame 3's outputs >= 60 dB against JAX's."""
    frames = run("default")[1]
    eng = _engine(DS, {})
    for frame in frames[:3]:  # the frame math keeps the previous frame's camera
        _port_frame(eng, DS, frame["cs"], frame["pool"])
    eng._states[0] = interop.state_from_numpy(frames[2]["jstate"])
    for k, v in eng.get_state(0).items():
        np.testing.assert_array_equal(interop.tensor_to_numpy(v),
                                      frames[2]["jstate"][k].astype(np.float32))
    got = _port_frame(eng, DS, frames[3]["cs"], frames[3]["pool"])
    for rt, out in got["out"].items():
        p = psnr(out, frames[3]["jax"][rt])
        assert p >= PSNR_BAR_DB, f"{rt.name}: {p:.2f} dB"


def test_output_beats_the_noisy_input():
    """After 4 frames each output is closer to the clean AO on the geometry than the binary
    input is (`tests/test_reblur_occlusion.py:48-57` asks it of the JAX package)."""
    frame = run("default")[1][-1]
    truth = frame["truth"]
    m = truth["mask"]
    for name in VARIANTS:
        for sig in VARIANTS[name][0]:
            noisy = np.abs(truth["ao"][sig] - truth["clean"])[m].mean()
            out = np.abs(frame[name]["out"][OUT[sig]][..., 0] - truth["clean"])[m].mean()
            assert out < noisy, (name, sig, noisy, out)
