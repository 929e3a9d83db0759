"""The port's row-sharded Engine (`Engine(mesh=)`) on 8 gloo ranks on the CPU, against the port
unsharded and against the JAX Engine on its 8-device mesh.

The scene and pools are `tests/test_sharding.py`'s: 128x64, 8 rows a rank, 3 orbit frames of
REFERENCE, SIGMA_SHADOW and REBLUR_DIFFUSE, with the frame time left at 0 (the default): each
rank's Engine then smooths rank 0's time between frames (`Engine.set_common_settings`), which the
ranks record (`time_delta_ms`). The unsharded port and the JAX Engines run the same frames with
those frame times, so that every side computes the same frame constants. The ranks are spawned
once for the file (`parallel.launch.spawn`, one intra-op thread a rank) and run every case; their
target lives in the port, so that no rank imports JAX.

Tolerance against the port unsharded: 1e-4 abs + 1e-4 rel on all but 1e-3 of the values, and
max |d| < 5e-3 (the JAX test's bound for the same comparison). No value lies outside 1e-4: every
pass of a band runs the same float32 operations on the same texels as the whole frame (the
halos cover each pass's reach, rows beyond the frame are edge-replicated as clamp addressing
reads them, positions are the frame's), so the outputs agree bit for bit. Against the JAX
Engine on its mesh: max |d| < 5e-3 and >= 60 dB, the bar of the port's other slice tests, and
the JAX test's fraction, (|d| > 1e-4).mean() < 1e-3, for REFERENCE and SIGMA_SHADOW.
REBLUR_DIFFUSE does not meet that fraction: the port and the JAX Engine, both unsharded, differ
by more than 1e-4 on 1.6-2.2 % of the values of frame 3 (seeds 0-2 at 16.66 ms frames; 1.97 % at
the ranks' frame times here; max 2.5e-3, 86 dB). It is held to a fixed 2.5e-2 instead, and
`test_reblur_amplifies_rounding` is the witness that this share is what float32 rounding gives
after 3 frames: the JAX Engine against itself, one ulp added to half of the radiance texels,
differs on 1.4-2.0 % (`tests/reblur_rounding_witness.py`). The two Engines' float32 state planes
agree exactly; their bfloat16 histories part by whole bfloat16 ulps (3.9e-3 at 0.5-1), which TA
carries from frame to frame. The witness covers 3 frames only: at frames 4-5 the port parts on
3.0-4.9 % against the witness's 1.4-2.0 % (ROADMAP.md Queue 3).
"""

import numpy as np
import pytest
import torch

from nrdtpu_torch.engine import Engine
from nrdtpu_torch.parallel import RowMesh, launch, make_mesh, rows
from nrdtpu_torch.settings import (
    CheckerboardMode,
    Denoiser,
    HitDistanceReconstructionMode,
    NormalEncoding,
    RoughnessEncoding,
    replace,
)
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

import test_sharding
from test_sharding import SIZE

torch.set_num_threads(1)

RANKS = 8
FRAMES = 3
VARIANTS = ("REFERENCE", "SIGMA_SHADOW", "REBLUR_DIFFUSE")
REBLUR_PASSES = ("prepass", "smb", "history_fix", "blur", "post_blur", "ts")
# the REBLUR_DIFFUSE runs of the halo cases, at fixed frame times: the derived halos, every halo
# the whole frame, and Blur's 2 rows
HALO_CASES = {"derived": None, "whole_frame": {p: SIZE[1] for p in REBLUR_PASSES},
              "blur_2_rows": {"blur": 2}}
HALO_FRAME_TIMES = [16.66] * FRAMES
# REBLUR_DIFFUSE's fixed fraction of values outside 1e-4 against the JAX Engine (the docstring)
REBLUR_JAX_FRACTION = 2.5e-2


def _case(denoiser, halos=None, frame_times=None):
    return dict(denoiser=denoiser, size=SIZE, frames=FRAMES, halos=halos, frame_times=frame_times)


@pytest.fixture(scope="module")
def sharded():
    """{name: run_engine_ranks' result} of every case, on one spawn of RANKS ranks."""
    names = list(VARIANTS) + list(HALO_CASES)
    cases = ([_case(v) for v in VARIANTS]
             + [_case("REBLUR_DIFFUSE", h, HALO_FRAME_TIMES) for h in HALO_CASES.values()])
    return dict(zip(names, launch.spawn(launch.run_engine_ranks, RANKS, "gloo", "cpu", cases)))


def _frame_times(sharded, variant):
    """The frame times of rank 0's run of the variant."""
    return sharded[variant]["time_delta_ms"][0]


@pytest.fixture(scope="module")
def unsharded(sharded):
    return {v: launch.run_engine(None, v, SIZE, FRAMES, frame_times=_frame_times(sharded, v)
                                 )["outputs"] for v in VARIANTS}


def _diff(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))


def _psnr(a, b):
    mse = np.mean(_diff(a, b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-6)
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak * peak / mse)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_matches_port_unsharded(sharded, unsharded, variant):
    got, want = sharded[variant]["outputs"], unsharded[variant]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        d = _diff(got[k], want[k])
        outside = d > 1e-4 + 1e-4 * np.abs(want[k])
        assert outside.mean() <= 1e-3, (k, outside.sum())
        assert d.max() < 5e-3, (k, d.max())


def _jax(variant, mesh, frame_times, ulp=False):
    """`test_sharding.run_engine` (its scene, pools and Engine), frame i given frame_times[i];
    ulp: one ulp added to a seeded half of each frame's radiance texels (REBLUR_DIFFUSE)."""
    from nrdtpu.settings import Denoiser as JDenoiser

    frame = test_sharding.SceneGenerator.frame
    pack = test_sharding.fe.reblur_pack_radiance_hitdist
    rng = np.random.default_rng(123)

    def timed(self, i):
        fd = frame(self, i)
        fd.common_settings.timeDeltaBetweenFrames = frame_times[i]
        return fd

    def nudged(*a, **k):
        rad = np.asarray(pack(*a, **k))
        return np.where(rng.random(rad.shape) < 0.5, np.nextafter(rad, np.float32(np.inf)), rad)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_sharding.SceneGenerator, "frame", timed)
        if ulp:
            mp.setattr(test_sharding.fe, "reblur_pack_radiance_hitdist", nudged)
        outs = test_sharding.run_engine(JDenoiser[variant], FRAMES,
                                        mesh=test_sharding._mesh() if mesh else None)
    return {k.name: v for k, v in outs.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_matches_jax_mesh(sharded, variant):
    """The port on 8 ranks against the JAX Engine on its 8-device mesh, each from its own
    package's scene and frontend, at the ranks' frame times."""
    want = _jax(variant, True, _frame_times(sharded, variant))
    got = sharded[variant]["outputs"]
    assert set(got) == set(want)
    bound = REBLUR_JAX_FRACTION if variant == "REBLUR_DIFFUSE" else 1e-3
    for k in want:
        w = want[k].reshape(got[k].shape)
        d = _diff(got[k], w)
        assert d.max() < 5e-3, (k, d.max())
        assert _psnr(got[k], w) >= 60.0, (k, _psnr(got[k], w))
        assert (d > 1e-4).mean() < bound, (k, (d > 1e-4).mean(), bound)


def test_reblur_amplifies_rounding():
    """The witness for REBLUR_DIFFUSE's fraction against JAX (the docstring): the JAX Engine
    against itself, one ulp added to half of the radiance texels, differs by more than 1e-4 on
    more than the JAX test's 1e-3 of the values, and on at least two thirds of the share by
    which the port differs from it (both unsharded, at 16.66 ms frames)."""
    times = HALO_FRAME_TIMES
    base = _jax("REBLUR_DIFFUSE", False, times)
    nudged = _jax("REBLUR_DIFFUSE", False, times, ulp=True)
    port = launch.run_engine(None, "REBLUR_DIFFUSE", SIZE, FRAMES, frame_times=times)["outputs"]
    for k in base:
        itself = (_diff(nudged[k], base[k]) > 1e-4).mean()
        ported = (_diff(port[k], base[k].reshape(port[k].shape)) > 1e-4).mean()
        assert itself > 1e-3, (k, itself)
        assert ported <= 1.5 * itself, (k, ported, itself)


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_share_frame_time(sharded, variant):
    """With the frame time left at 0, every rank's frame constants use the same frame time,
    rank 0's (each rank's own clock would part the bands), and it follows the wall clock."""
    times = sharded[variant]["time_delta_ms"]
    assert all(t == times[0] for t in times), times
    assert len(set(times[0])) == FRAMES, times[0]


@pytest.mark.parametrize("variant", VARIANTS)
def test_state_is_row_sharded(sharded, variant):
    """Every rank's state plane holds h // 8 rows of the frame's width (the counterpart of
    `test_state_is_actually_sharded`), with the unsharded state's keys."""
    per_rank = sharded[variant]["state_shapes"]
    assert len(per_rank) == RANKS
    eng = Engine({0: Denoiser[variant]}, resource_size=SIZE, device="cpu")
    whole = eng._instances[0].init_state()
    for shapes in per_rank:
        assert set(shapes) == set(whole)
        for k, shape in shapes.items():
            assert shape == (SIZE[1] // RANKS,) + tuple(whole[k].shape[1:]), (k, shape)


def test_halos_suffice(sharded):
    """REBLUR_DIFFUSE with every halo the whole frame equals the run with the derived halos."""
    got = sharded["whole_frame"]["outputs"]
    want = sharded["derived"]["outputs"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_short_blur_halo_changes_output(sharded):
    """H2's Blur on 2 halo rows, far below its derived reach (31 rows), changes the output:
    the scene exercises the reach, so a halo too small fails `test_halos_suffice`."""
    got = sharded["blur_2_rows"]["outputs"]
    want = sharded["derived"]["outputs"]
    assert max(_diff(got[k], want[k]).max() for k in want) > 1e-3


def test_exchange_counts(sharded):
    """Every rank received rows in every frame of a stencil path, none in REFERENCE's (its
    passes are per pixel)."""
    assert all(b == 0 for r in sharded["REFERENCE"]["exchanged_bytes"] for b in r)
    for v in ("SIGMA_SHADOW", "REBLUR_DIFFUSE"):
        assert all(b > 0 for r in sharded[v]["exchanged_bytes"] for b in r)


def _fake_mesh(size=2):
    """A RowMesh with no process group: enough for what the Engine checks before a frame's
    first exchange."""
    return RowMesh(group=None, rank=0, size=size, device=torch.device("cpu"), backend="gloo")


def _frame(variant, size=(64, 48)):
    gen = SceneGenerator(SceneSpec(size=size), camera_mode="orbit")
    fd = gen.frame(0)
    return fd.common_settings, launch.scene_pool(Denoiser[variant], gen, fd)


def test_uneven_and_missing_mesh_raise():
    with pytest.raises(ValueError, match="equal bands"):
        rows(64, _fake_mesh(3))
    with pytest.raises(ValueError, match="equal bands"):
        Engine({0: Denoiser.REFERENCE}, resource_size=(64, 50), mesh=_fake_mesh(4), device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()


@pytest.mark.parametrize("what", [
    "RELAX_DIFFUSE", "REBLUR_SPECULAR", "SIGMA_SHADOW_TRANSLUCENCY", "REBLUR_DIFFUSE_SH",
    "normal_encoding", "roughness_encoding", "rect", "device"])
def test_unsupported_engine_raises(what):
    kw = dict(resource_size=(64, 48), mesh=_fake_mesh(), device="cpu")
    d = {0: Denoiser.REBLUR_DIFFUSE}
    if what in Denoiser.__members__:
        d = {0: Denoiser[what]}
    elif what == "normal_encoding":
        kw["normal_encoding"] = NormalEncoding.RGBA8_UNORM
    elif what == "roughness_encoding":
        kw["roughness_encoding"] = RoughnessEncoding.SQ_LINEAR
    elif what == "rect":
        kw["rect_size"] = (48, 32)
    else:  # a mesh on another device than the Engine's
        kw["mesh"] = RowMesh(None, 0, 2, torch.device("cuda:0"), "nccl")
    with pytest.raises(ValueError if what == "device" else NotImplementedError):
        Engine(d, **kw)


@pytest.mark.parametrize("what", ["checkerboard", "hit_distance_reconstruction", "validation",
                                  "printf_at", "show", "rect_per_frame", "memory_usage"])
def test_unsupported_frame_raises(what):
    """What a frame asks that the mesh does not run raises before any exchange."""
    cs, pool = _frame("REBLUR_DIFFUSE")
    eng = Engine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=(64, 48), mesh=_fake_mesh(),
                 device="cpu")
    s = eng._settings[0]
    if what == "checkerboard":
        eng.set_denoiser_settings(0, replace(s, checkerboardMode=CheckerboardMode.BLACK))
    elif what == "hit_distance_reconstruction":
        eng.set_denoiser_settings(0, replace(
            s, hitDistanceReconstructionMode=HitDistanceReconstructionMode.AREA_3X3))
    elif what == "validation":
        cs.enableValidation = True
    elif what == "printf_at":
        cs.printfAt = (10, 10)
    elif what == "show":
        eng.set_debug_show("reblur/ta/curvature")
    elif what == "rect_per_frame":
        cs.rectSize = (48, 32)
    eng.set_common_settings(cs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1.1"):
        if what == "memory_usage":
            eng.get_memory_usage(0)
        else:
            eng.denoise([0], pool)


def test_rank_failure_fails_the_call():
    """A rank that raises (here every rank: a variant the mesh does not run) fails the call."""
    with pytest.raises(Exception, match="not ported under a mesh"):
        launch.spawn(launch.run_engine_ranks, 2, "gloo", "cpu",
                     [dict(denoiser="RELAX_DIFFUSE", size=(64, 48), frames=1)], timeout=120.0)
