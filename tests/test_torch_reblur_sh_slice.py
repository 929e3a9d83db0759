"""The REBLUR SH variants end to end on the CPU: REBLUR_DIFFUSE_SH, REBLUR_SPECULAR_SH and
REBLUR_DIFFUSE_SPECULAR_SH through the PyTorch port's Engine against the JAX Engine (XLA
path), over the orbit scene at 48x32 (at most 2 frames: the JAX Engine op by op takes ~7 s a
frame here), each signal's SH0 / SH1 packed with the port's
`reblur_pack_sh` from the scene's noisy radiance, its normalized hit distance and a direction
(`SH_DIRECTIONS`), SH1's .w drawn per pixel from a seed.

The JAX Engine runs op by op (`jax.disable_jit`), as in `tests/test_torch_reblur_cb_slice.py`:
each float32 step as its code writes it, as the port computes it. On the CPU it runs
REBLUR_DIFFUSE_SPECULAR_SH signal by signal with the one-signal functions (`fused_ok` needs the
TPU kernels), op for op what REBLUR_DIFFUSE_SH and REBLUR_SPECULAR_SH compute, so one JAX run a
configuration holds all three variants: the port's REBLUR_DIFFUSE_SH against its diffuse
outputs, REBLUR_SPECULAR_SH against its specular ones. The configurations: the defaults (2
frames), `enableAntiFirefly` and AREA_3X3 hit-distance reconstruction (on SH0's .w, the
normalized hit distance zeroed on a seeded 30 % of the geometry pixels), frame 0 each; and
REBLUR_DIFFUSE_SPECULAR_SH with NRDTPU_REBLUR_BAND=1 (the port's band; JAX's band is Pallas
only, and off the TPU the switch leaves its XLA chain as it is) against the default run.

SH1 goes along a direction field of the surface (the diffuse signal's against the normal, the
specular one's along the normal with x and z swapped), as a light direction is coherent over a
surface. REBLUR scales SH1.xyz by get_luma_scale(length(SH1.xyz), luma) in TA, the history fix
and TS (`nrdtpu/passes/reblur/kernels.py:493-495`, `:729-731`, `:2407-2410`), which divides by
the length of the filtered SH1: with a direction drawn per pixel the filters average it toward
0 and the scale turns float32 rounding into errors of the output's size, in the JAX Engine
jitted against itself op by op alike.

Bars: every output >= 60 dB PSNR against JAX on every frame, the SH histories (state) too; the
state keys and storage dtypes of JAX's (the SH histories bfloat16); the launches a frame those
of the variant without SH (the SH rides its launches); dead pixels pass the raw SH0 and SH1;
under checkerboard the SH variants raise (the JAX reference fails there, ROADMAP.md Queue 3).
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, HitDistanceReconstructionMode as JHM
from nrdtpu.settings import ResourceType as JRT, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as fe
from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import ResourceType as RT, replace

from test_torch_relax_slice import CallCounter, psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (48, 32)
PSNR_BAR_DB = 60.0
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
HOLE_FRACTION = 0.3
DS_SH = "REBLUR_DIFFUSE_SPECULAR_SH"
SH_IN = {"diff": (RT.IN_DIFF_SH0, RT.IN_DIFF_SH1), "spec": (RT.IN_SPEC_SH0, RT.IN_SPEC_SH1)}
SH_OUT = {"diff": (RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1), "spec": (RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1)}
SH_DIRECTIONS = {"diff": lambda n: -n, "spec": lambda n: n[..., [2, 1, 0]]}
# each variant's signals and launches a frame: those of the variant without SH
D_LAUNCHES = {"smb_resolve": 1, "spatial_filter": 3, "history_fix": 1, "ts_prelude": 1}
S_LAUNCHES = {**D_LAUNCHES, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1}
DS_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
               "spatial_filter_fused": 3, "history_fix_fused": 1, "ts_prelude": 2}
BAND_LAUNCHES = {**DS_LAUNCHES, "spatial_filter_fused": 1, "history_fix_fused": 0,
                 "reblur_band": 1}
VARIANTS = {"REBLUR_DIFFUSE_SH": (("diff",), D_LAUNCHES),
            "REBLUR_SPECULAR_SH": (("spec",), S_LAUNCHES),
            DS_SH: (("diff", "spec"), DS_LAUNCHES)}
# configuration: (settings of both Engines, frames, hit-distance holes, the port's variants
# held, extra launches a frame)
CONFIGS = {"default": ({}, 2, False, tuple(VARIANTS), {}),
           "anti_firefly": (dict(enableAntiFirefly=True), 1, False, (DS_SH,), {}),
           "area_3x3": (dict(hitDistanceReconstructionMode="AREA_3X3"), 1, True, (DS_SH,),
                        {"hitdist_recon": 1})}
# the state planes of one signal, which a variant without it does not keep
SIGNAL_STATE = {sig: (f"{sig}_history", f"{sig}_fast_history", f"{sig}_luma_stab",
                      f"{sig}_sh_history") for sig in ("diff", "spec")}
SIGNAL_STATE["spec"] += ("prev_spec_hitdist_for_tracking",)


def frames_of(n_frames, holes=False):
    """(common settings, pool) of each frame: both signals' SH0 / SH1."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    for i in range(n_frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        rng = np.random.default_rng((29, i))
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                RT.IN_MV: fd.mv}
        normal = torch.from_numpy(fd.normal.astype(np.float32))
        view_z = torch.from_numpy(fd.view_z)
        punched = (rng.random(fd.view_z.shape) < HOLE_FRACTION) & (fd.hit_mask > 0)
        for sig, noisy, hit, rough in (
                ("diff", fd.diff_noisy, fd.diff_hit_dist, torch.ones_like(view_z)),
                ("spec", fd.spec_noisy, fd.spec_hit_dist, torch.from_numpy(fd.roughness))):
            nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(hit), view_z, HDP, rough)
            sh0, sh1 = fe.reblur_pack_sh(torch.from_numpy(noisy), nhd,
                                         SH_DIRECTIONS[sig](normal))
            sh0, sh1 = sh0.numpy(), sh1.numpy()
            sh1[..., 3] = rng.uniform(0.0, 1.0, fd.view_z.shape)
            if holes:
                sh0[..., 3][punched] = 0.0
            pool[SH_IN[sig][0]], pool[SH_IN[sig][1]] = sh0, sh1
        yield fd.common_settings, pool


def _engine(denoiser, settings):
    eng = TEngine({0: Denoiser[denoiser]}, resource_size=SIZE, device="cpu")
    over = {k: HM[v] if k == "hitDistanceReconstructionMode" else v for k, v in settings.items()}
    eng.set_denoiser_settings(0, replace(eng._settings[0], **over))
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


def _outputs(out, signals):
    return {rt: interop.tensor_to_numpy(out[rt]) for sig in signals for rt in SH_OUT[sig]}


@functools.lru_cache(maxsize=None)
def run(config):
    """A configuration through the JAX Engine (REBLUR_DIFFUSE_SPECULAR_SH, op by op) and the
    port's variants (and, by default, the band), with each port engine's wrapper calls and
    state a frame."""
    settings, n_frames, holes, variants, extra = CONFIGS[config]
    je = JEngine({0: JDenoiser[DS_SH]}, resource_size=SIZE)
    if settings:
        over = {k: JHM[v] if k == "hitDistanceReconstructionMode" else v
                for k, v in settings.items()}
        je.set_denoiser_settings(0, jreplace(je._settings[0], **over))
    engs = {v: _engine(v, settings) for v in variants}
    if config == "default":
        engs[DS_SH + "+BAND"] = _engine(DS_SH, settings)
    frames = []
    for cs, pool in frames_of(n_frames, holes):
        je.set_common_settings(cs)
        with jax.disable_jit():
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        frame = dict(pool=pool, jax={rt: np.asarray(jo[JRT(int(rt))]) for sig in ("diff", "spec")
                                     for rt in SH_OUT[sig]},
                     jstate={k: np.asarray(v) for k, v in je.get_state(0).items()})
        for name, eng in engs.items():
            eng.set_common_settings(cs)
            with _band(name.endswith("+BAND")), CallCounter() as calls:
                to = eng.denoise([0], pool)
            signals = VARIANTS[name.split("+")[0]][0]
            frame[name] = dict(out=_outputs(to, signals), calls=calls.counts,
                               state=dict(eng.get_state(0)))
        frames.append(frame)
    return config, frames, extra


@pytest.fixture(params=sorted(CONFIGS))
def runs(request):
    return run(request.param)


def test_outputs_match_jax(runs):
    """Every SH0 and SH1 output of every port variant >= 60 dB against JAX on every frame."""
    config, frames, _ = runs
    for i, frame in enumerate(frames):
        for name in (k for k in frame if k in VARIANTS or k.endswith("+BAND")):
            for rt, got in frame[name]["out"].items():
                want = frame["jax"][rt]
                assert got.shape == want.shape == (SIZE[1], SIZE[0], 4)
                assert np.isfinite(got).all()
                p = psnr(got, want)
                print(f"{config} {name} {rt.name} frame {i}: {p:.2f} dB")
                assert p >= PSNR_BAR_DB, f"{config} {name} {rt.name} frame {i}: {p:.2f} dB"


def test_state_matches_jax(runs):
    """The port's state: JAX's keys and storage dtypes (the SH histories bfloat16), and the SH
    histories >= 60 dB against JAX's on every frame."""
    config, frames, _ = runs
    for i, frame in enumerate(frames):
        js = frame["jstate"]
        for name in (k for k in frame if k in VARIANTS or k.endswith("+BAND")):
            ts = frame[name]["state"]
            signals = VARIANTS[name.split("+")[0]][0]
            want_keys = set(js).difference(*(SIGNAL_STATE[s] for s in ("diff", "spec")
                                             if s not in signals))
            assert ts.keys() == want_keys, (name, sorted(ts.keys() ^ want_keys))
            for k, v in ts.items():
                assert str(v.dtype).split(".")[-1] == js[k].dtype.name, (name, k)
            for sig in signals:
                got = interop.tensor_to_numpy(ts[f"{sig}_sh_history"])
                p = psnr(got, js[f"{sig}_sh_history"].astype(np.float32))
                assert p >= PSNR_BAR_DB, f"{config} {name} {sig}_sh_history frame {i}: {p:.2f} dB"


def test_kernel_calls_a_frame(runs):
    """Each port variant calls each kernel module as often a frame as the variant without SH
    (the band as REBLUR_DIFFUSE_SPECULAR's band path): no SH plane adds a launch."""
    _, frames, extra = runs
    for frame in frames:
        for name in (k for k in frame if k in VARIANTS or k.endswith("+BAND")):
            launches = {**(BAND_LAUNCHES if name.endswith("+BAND")
                           else VARIANTS[name][1]), **extra}
            assert frame[name]["calls"] == {n: launches.get(n, 0) for n in KM.MODULES}, name


def test_dead_pixels_pass_the_raw_sh():
    """Dead (sky) pixels pass the raw SH0 (before SplitScreen, which is off) and the raw SH1."""
    frame = run("default")[1][-1]
    sky = frame["pool"][RT.IN_VIEWZ] > 1e6
    assert sky.any()
    for name in VARIANTS:
        for sig in VARIANTS[name][0]:
            for rt_in, rt_out in zip(SH_IN[sig], SH_OUT[sig]):
                np.testing.assert_array_equal(frame[name]["out"][rt_out][sky],
                                              frame["pool"][rt_in][sky])


@pytest.mark.parametrize("mode", [CB.BLACK, CB.WHITE])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_checkerboard_raises(variant, mode):
    """Under checkerboard the SH variants raise NotImplementedError naming the JAX fault: the
    reference passes the half-width IN_*_SH1 through its dead pixels unexpanded
    (`nrdtpu/passes/reblur/denoiser.py:585-587`) and fails on frame 0."""
    eng = _engine(variant, dict(checkerboardMode=mode))
    cs, pool = next(frames_of(1))
    eng.set_common_settings(cs)
    with pytest.raises(NotImplementedError, match="denoiser.py:585-587"):
        eng.denoise([0], pool)
