"""REBLUR's specular path at SQ_LINEAR and SQRT_LINEAR roughness end to end on the CPU: the
PyTorch port's Engine against the JAX Engine (XLA path) when IN_NORMAL_ROUGHNESS packs its
roughness with the encoding, over 4 frames of the orbit scene at 64x48.

The JAX Engine runs REBLUR_DIFFUSE_SPECULAR op by op (`jax.disable_jit`), as in
`tests/test_torch_reblur_occ_slice.py`; on the CPU it runs the two signals with the one-signal
functions (`fused_ok` needs the TPU kernels), op for op what REBLUR_DIFFUSE and REBLUR_SPECULAR
compute, so one JAX run an encoding holds REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR of the
port, and at SQ_LINEAR also REBLUR_DIFFUSE_SPECULAR with NRDTPU_REBLUR_BAND=1 (the port's band;
JAX's band is Pallas only, and off the TPU the switch leaves its XLA chain as it is).

Without a decode the outputs would be far from JAX's: the encoding moves JAX's own
REBLUR_SPECULAR output far from its LINEAR run (`test_the_encoding_matters`). Nor may the port
decode every read: the reference reads the centre pixel's roughness of HistoryFix, PrePass,
Blur and PostBlur as packed (`unpack_nr3`, `nrdtpu/passes/reblur/kernels.py:37-42`), and a port
that decoded it too ends far from JAX (`test_the_packed_centre_matters`).

Bars: every output >= 60 dB PSNR against JAX on every frame, and the histories (state) too;
the state keeps IN_NORMAL_ROUGHNESS as packed, as JAX's does; the kernel calls a frame those of
LINEAR.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.settings import RoughnessEncoding as JRE
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, RoughnessEncoding as RE

from test_torch_relax_slice import CallCounter, psnr
from test_torch_reblur_roughness_passes import pool_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 4
PSNR_BAR_DB = 60.0
S, DS = "REBLUR_SPECULAR", "REBLUR_DIFFUSE_SPECULAR"
BAND = DS + "+BAND"
OUT = {"diff": RT.OUT_DIFF_RADIANCE_HITDIST, "spec": RT.OUT_SPEC_RADIANCE_HITDIST}
S_LAUNCHES = {"smb_resolve": 1, "spatial_filter": 3, "history_fix": 1, "ts_prelude": 1,
              "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1}
DS_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
               "spatial_filter_fused": 3, "history_fix_fused": 1, "ts_prelude": 2}
BAND_LAUNCHES = {**DS_LAUNCHES, "spatial_filter_fused": 1, "history_fix_fused": 0,
                 "reblur_band": 1}
VARIANTS = {S: (("spec",), S_LAUNCHES), DS: (("diff", "spec"), DS_LAUNCHES),
            BAND: (("diff", "spec"), BAND_LAUNCHES)}
# the port's engines held against each encoding's JAX run
ENCODINGS = {"SQ_LINEAR": (S, DS, BAND), "SQRT_LINEAR": (S, DS)}


@contextlib.contextmanager
def _band(on):
    """NRDTPU_REBLUR_BAND=1 around the port's band engine only."""
    if not on:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NRDTPU_REBLUR_BAND", "1")
        yield


def _frames(encoding, n_frames=FRAMES):
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    for i in range(n_frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        yield fd.common_settings, pool_of(gen, fd, encoding)


@functools.lru_cache(maxsize=None)
def run(encoding):
    """An encoding through the JAX Engine (REBLUR_DIFFUSE_SPECULAR, op by op) and the port's
    engines, with each port engine's outputs, wrapper calls and state a frame."""
    je = JEngine({0: JDenoiser[DS]}, resource_size=SIZE, roughness_encoding=JRE[encoding])
    engs = {name: TEngine({0: Denoiser[name.split("+")[0]]}, resource_size=SIZE,
                          roughness_encoding=RE[encoding], device="cpu")
            for name in ENCODINGS[encoding]}
    frames = []
    for cs, pool in _frames(encoding):
        je.set_common_settings(cs)
        with jax.disable_jit():
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        frame = dict(pool=pool, jax={rt: np.asarray(jo[JRT(int(rt))]) for rt in OUT.values()},
                     jstate={k: np.asarray(v) for k, v in je.get_state(0).items()})
        for name, eng in engs.items():
            eng.set_common_settings(cs)
            with _band(name == BAND), CallCounter() as calls:
                out = eng.denoise([0], pool)
            frame[name] = dict(out={OUT[s]: interop.tensor_to_numpy(out[OUT[s]])
                                    for s in VARIANTS[name][0]},
                               calls=calls.counts, state=dict(eng.get_state(0)))
        frames.append(frame)
    return encoding, frames


@pytest.fixture(params=sorted(ENCODINGS))
def runs(request):
    return run(request.param)


def test_outputs_match_jax(runs):
    """Every output of every port engine >= 60 dB against JAX on every frame, finite."""
    encoding, frames = runs
    for i, frame in enumerate(frames):
        for name in ENCODINGS[encoding]:
            for rt, got in frame[name]["out"].items():
                assert got.shape == frame["jax"][rt].shape and np.isfinite(got).all()
                p = psnr(got, frame["jax"][rt])
                print(f"{encoding} {name} {rt.name} frame {i}: {p:.2f} dB")
                assert p >= PSNR_BAR_DB, f"{encoding} {name} {rt.name} frame {i}: {p:.2f} dB"


def test_state_matches_jax(runs):
    """Each port engine's histories >= 60 dB against JAX's on every frame, and its
    prev_normal_roughness the packed input, as JAX keeps it."""
    encoding, frames = runs
    for i, frame in enumerate(frames):
        js = frame["jstate"]
        for name in ENCODINGS[encoding]:
            ts = frame[name]["state"]
            np.testing.assert_array_equal(interop.tensor_to_numpy(ts["prev_normal_roughness"]),
                                          js["prev_normal_roughness"])
            for sig in VARIANTS[name][0]:
                for k in (f"{sig}_history", f"{sig}_fast_history", f"{sig}_luma_stab"):
                    p = psnr(interop.tensor_to_numpy(ts[k]), js[k].astype(np.float32))
                    assert p >= PSNR_BAR_DB, f"{encoding} {name} {k} frame {i}: {p:.2f} dB"


def test_kernel_calls_a_frame(runs):
    """The encodings add no launch: each engine calls each kernel module as at LINEAR."""
    encoding, frames = runs
    for frame in frames:
        for name in ENCODINGS[encoding]:
            launches = VARIANTS[name][1]
            assert frame[name]["calls"] == {n: launches.get(n, 0) for n in KM.MODULES}, name


def test_the_encoding_matters():
    """JAX's own REBLUR_SPECULAR output at SQ_LINEAR is far (< 50 dB) from its output when the
    same frame's roughness is packed as LINEAR, so a port that read the packed roughness as
    linear would fail the 60 dB bar."""
    frame = run("SQ_LINEAR")[1][0]
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    fd = gen.frame(0)
    fd.common_settings.timeDeltaBetweenFrames = 16.66
    je = JEngine({0: JDenoiser[DS]}, resource_size=SIZE)
    je.set_common_settings(fd.common_settings)
    with jax.disable_jit():
        jo = je.denoise([0], {JRT(int(k)): v for k, v in pool_of(gen, fd, "LINEAR").items()})
    rt = OUT["spec"]
    assert psnr(np.asarray(jo[JRT(int(rt))]), frame["jax"][rt]) < 50.0


def test_the_packed_centre_matters():
    """The reference reads the filters' centre roughness as packed: the port's REBLUR_SPECULAR
    fed the decoded plane at LINEAR, every read decoded, ends < 50 dB from JAX at SQ_LINEAR, so
    the packed centre reads that the port keeps are what the 60 dB bar holds."""
    frames = run("SQ_LINEAR")[1]
    eng = TEngine({0: Denoiser[S]}, resource_size=SIZE, device="cpu")
    rt = OUT["spec"]
    for (cs, pool), frame in zip(_frames("SQ_LINEAR"), frames):
        pool = dict(pool)
        pool[RT.IN_NORMAL_ROUGHNESS] = interop.tensor_to_numpy(tfe.decode_roughness_plane(
            torch.from_numpy(pool[RT.IN_NORMAL_ROUGHNESS]), RE.SQ_LINEAR))
        eng.set_common_settings(cs)
        out = interop.tensor_to_numpy(eng.denoise([0], pool)[rt])
    assert psnr(out, frames[-1]["jax"][rt]) < 50.0
