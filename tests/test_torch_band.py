"""The band of REBLUR_DIFFUSE_SPECULAR (NRDTPU_REBLUR_BAND=1): HistoryFix, Blur and PostBlur of
both signals in one `reblur_band` launch, against the JAX package's XLA chain and against the
port's own three-launch chain.

The JAX Engine runs REBLUR_DIFFUSE_SPECULAR for 3 frames of the orbit scene at 128x96; its
state and the frame-4 constants are carried across with `nrdtpu_torch.interop`, the XLA TA
runs frame 4, and from its outputs the XLA chain runs per signal the way the reference does
off-TPU: `history_fix`, then `diffuse_spatial_filter` / `specular_spatial_filter` in BLUR and
POST_BLUR mode. The band (its plain version on the CPU) takes the same TA outputs. The JAX
band kernel itself (`reblur_spatial_band`) is held against that chain by the JAX package's own
test, which is marked slow (interpret mode takes minutes).

Tolerance: rtol=1e-4, atol=1e-5, as for the fused passes (`test_torch_ds_passes.py`); against
the port's chain the band's plain version is exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser
from nrdtpu.settings import ResourceType as RT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.kernels import reblur_band as k_band
from nrdtpu_torch.passes.reblur import kernels as TK

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ds_passes as DP  # noqa: E402

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
RTOL, ATOL = 1e-4, 1e-5
# case: (anti-firefly ring on both signals, performance mode)
CASES = {"default": (False, False), "anti_firefly": (True, False), "perf": (False, True)}
OUTPUTS = ("diff", "diff_fast", "spec", "spec_fast")


@pytest.fixture(scope="module")
def ctx():
    """JAX runs frames 0-2 and frame 4's TA; returns the TA outputs, the constants and the
    XLA chain's outputs of every case."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=SIZE)
    for i in range(3):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        eng.denoise([0], DP._inputs(gen, fd))
    fd = gen.frame(3)
    fd.common_settings.timeDeltaBetweenFrames = 16.66
    eng.set_common_settings(fd.common_settings)
    inst = eng._instances[0]
    sc = eng._shared_consts()
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    cfg = inst.config
    pool = {k: np.asarray(v) for k, v in DP._inputs(gen, fd).items()}
    js = {k: jnp.asarray(np.asarray(v)) for k, v in eng.get_state(0).items()}
    vz, nr, mv = (jnp.asarray(pool[k]) for k in (RT.IN_VIEWZ, RT.IN_NORMAL_ROUGHNESS, RT.IN_MV))

    # frame 4 up to TA, with the PrePass, as the reference runs it
    diff_in, _ = JK.diffuse_pre_pass(sc, dc, jnp.asarray(pool[RT.IN_DIFF_RADIANCE_HITDIST]), vz,
                                     nr, cfg)
    spec_in, _, hdt = JK.specular_spatial_filter(sc, dc, JK.PRE_BLUR,
                                                 jnp.asarray(pool[RT.IN_SPEC_RADIANCE_HITDIST]),
                                                 vz, nr, None, cfg, occlusion=False)
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = JK.surface_motion_reprojection(sc, dc, vz, nr, mv, js["prev_view_z"],
                                        js["prev_normal_roughness"], prev_internal, cfg)
    diff1, diff_fast1, data1_d, _ = JK.temporal_accumulation_diffuse(
        sc, dc, sm, diff_in, js["diff_history"], js["diff_fast_history"], cfg, occlusion=False)
    ta = JK.temporal_accumulation_specular(
        sc, dc, sm, spec_in, js["spec_history"], js["spec_fast_history"], vz, nr,
        js["prev_view_z"], js["prev_normal_roughness"], prev_internal, hdt,
        js["prev_spec_hitdist_for_tracking"], cfg, occlusion=False, has_prepass_hitdist=True)
    data1_s = ta["accum_speed"]

    want = {}
    for case, (af, perf) in CASES.items():
        kw = dict(occlusion=False, anti_firefly=af)
        d, d_fast = JK.history_fix(sc, dc, vz, nr, data1_d, data1_s, diff1, diff_fast1, cfg,
                                   is_diffuse=True, **kw)[:2]
        s, s_fast = JK.history_fix(sc, dc, vz, nr, data1_d, data1_s, ta["spec"], ta["fast"], cfg,
                                   is_diffuse=False, **kw)[:2]
        for mode in (JK.BLUR, JK.POST_BLUR):
            d = JK.diffuse_spatial_filter(sc, dc, mode, d, vz, nr, data1_d, cfg, occlusion=False,
                                          perf_mode=perf)[0]
            s = JK.specular_spatial_filter(sc, dc, mode, s, vz, nr, data1_s, cfg,
                                           occlusion=False, perf_mode=perf)[0]
        want[case] = dict(diff=d, diff_fast=d_fast, spec=s, spec_fast=s_fast)
    ta_out = dict(diff=diff1, diff_fast=diff_fast1, data1_diff=data1_d, spec=ta["spec"],
                  spec_fast=ta["fast"], data1_spec=data1_s)
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc), cfg=cfg,
                pool=pool, ta={k: t(v) for k, v in ta_out.items()}, want=want, port={})


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pass_args(ctx):
    p, ta = ctx["pool"], ctx["ta"]
    vz, nr = t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS])
    geom = TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, nr, ctx["cfg"])
    return (ctx["sc"], ctx["dc"], geom, vz, nr, (ta["diff"], ta["data1_diff"], ta["diff_fast"]),
            (ta["spec"], ta["data1_spec"], ta["spec_fast"]))


def _band(ctx, case):
    """The band pass of the case, once per module, through the wrapper on CPU tensors (its
    plain version); counts the wrapper's calls."""
    if case not in ctx["port"]:
        af, perf = CASES[case]
        calls = []
        wrapper = k_band.reblur_band

        def rec(*a, **k):
            calls.append((a, k))
            return wrapper(*a, **k)
        k_band.reblur_band = rec
        try:
            (d, d_fast), (s, s_fast) = TK.spatial_band(*_pass_args(ctx), anti_firefly=(af, af),
                                                       perf_mode=perf)
        finally:
            k_band.reblur_band = wrapper
        ctx["port"][case] = dict(diff=d, diff_fast=d_fast, spec=s, spec_fast=s_fast,
                                 calls=calls)
    return ctx["port"][case]


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("case", list(CASES))
def test_band_matches_xla_chain(ctx, case, output):
    """reblur_band's plain version vs history_fix + the per-signal BLUR and POST_BLUR XLA
    calls, from the same TA outputs."""
    got = _band(ctx, case)[output].numpy()
    want = np.asarray(ctx["want"][case][output], np.float32)
    assert got.shape == want.shape
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{case} {output}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


@pytest.mark.parametrize("case", list(CASES))
def test_band_equals_three_launch_chain(ctx, case):
    """On the CPU the band pass and the port's three-launch chain (N5, the clamp, the
    parameters, N4 twice) give identical results; the band pass calls its wrapper once."""
    af, perf = CASES[case]
    band = _band(ctx, case)
    assert len(band["calls"]) == 1
    (d, d_fast), (s, s_fast) = TK.spatial_chain(*_pass_args(ctx), anti_firefly=(af, af),
                                                perf_mode=perf)
    for name, got in (("diff", d), ("diff_fast", d_fast), ("spec", s), ("spec_fast", s_fast)):
        assert torch.equal(band[name], got), name


def test_band_flags_reach_the_band(ctx):
    """The ring and the performance mode change the band's output."""
    default = _band(ctx, "default")
    for case in ("anti_firefly", "perf"):
        assert not torch.allclose(_band(ctx, case)["diff"], default["diff"], rtol=RTOL, atol=ATOL)
    a, k = _band(ctx, "perf")["calls"][0]
    assert k["perf_mode"] and k["anti_firefly"] == (False, False)


def test_band_checks_its_planes(ctx):
    """A call with the wrong planes raises before any kernel or plain version runs."""
    a, k = _band(ctx, "default")["calls"][0]
    with pytest.raises(ValueError, match="planes"):
        k_band.reblur_band(*a[:8], a[8][:-1], *a[9:], **k)
    with pytest.raises(ValueError, match="diff_params"):
        k_band.reblur_band(*a[:9], a[10], a[9], **k)
    assert KM.MODULES["reblur_band"] is k_band
