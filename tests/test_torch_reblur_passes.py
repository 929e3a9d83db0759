"""Per-pass parity: each kernel-holding REBLUR diffuse pass of the PyTorch port (its plain CPU
path) against the JAX package's XLA function, from identical inputs and identical state.

The JAX Engine runs 3 frames of the orbit scene at 128x96; its state and the frame-4
constants are carried across with `nrdtpu_torch.interop`, and both sides run frame 4 pass by
pass. Each pass takes the JAX chain's own intermediate as input, so a fault shows in the
pass that makes it.

Tolerance: rtol=1e-4, atol=1e-5 on float32 outputs. The port keeps the op order of the XLA
functions; what remains is last-bit differences of transcendentals (exp, pow, rsqrt) and of
3-term dot products between XLA and PyTorch's CPU kernels. fbits and allow_catrom are step
functions of the same values and must match exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser, ResourceType as RT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch.passes.reblur import kernels as TK

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
RTOL, ATOL = 1e-4, 1e-5
# TS settings off the defaults: (shared constants, denoiser constants) changed
TS_CASES = {"max_blur_radius_0": ({}, dict(max_blur_radius=0.0)),
            "split_screen": (dict(split_screen=0.5, split_screen_prev=0.5), {})}
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)


def _inputs(gen, fd):
    nhd = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist), jnp.asarray(fd.view_z),
                                       jnp.asarray(HDP), 1.0)
    sig = np.asarray(jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), nhd))
    return {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv, RT.IN_DIFF_RADIANCE_HITDIST: sig}


@pytest.fixture(scope="module")
def ctx():
    """JAX runs frames 0-2; returns frame 3's inputs, constants, state and the XLA chain."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=SIZE)
    for i in range(3):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        eng.denoise([0], _inputs(gen, fd))
    fd = gen.frame(3)
    fd.common_settings.timeDeltaBetweenFrames = 16.66
    eng.set_common_settings(fd.common_settings)
    inst = eng._instances[0]
    sc = eng._shared_consts()
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    cfg = inst.config
    state = {k: np.asarray(v) for k, v in eng.get_state(0).items()}
    pool = {k: np.asarray(v) for k, v in _inputs(gen, fd).items()}
    vz, nr, mv = pool[RT.IN_VIEWZ], pool[RT.IN_NORMAL_ROUGHNESS], pool[RT.IN_MV]

    j = {}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    j["pre"], _ = JK.diffuse_pre_pass(sc, dc, jnp.asarray(pool[RT.IN_DIFF_RADIANCE_HITDIST]),
                                      jnp.asarray(vz), jnp.asarray(nr), cfg)
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    j["sm"] = JK.surface_motion_reprojection(
        sc, dc, jnp.asarray(vz), jnp.asarray(nr), jnp.asarray(mv), js["prev_view_z"],
        js["prev_normal_roughness"], prev_internal, cfg)
    j["ta"] = JK.temporal_accumulation_diffuse(sc, dc, j["sm"], j["pre"], js["diff_history"],
                                               js["diff_fast_history"], cfg, occlusion=False)
    diff1, fast1, data1, _ = j["ta"]
    j["hf"] = JK.history_fix(sc, dc, jnp.asarray(vz), jnp.asarray(nr), data1, data1, diff1,
                             fast1, cfg, is_diffuse=True, occlusion=False)
    j["blur"], _ = JK.diffuse_spatial_filter(sc, dc, JK.BLUR, j["hf"][0], jnp.asarray(vz),
                                             jnp.asarray(nr), data1, cfg, occlusion=False)
    j["post"], _ = JK.diffuse_spatial_filter(sc, dc, JK.POST_BLUR, j["blur"], jnp.asarray(vz),
                                             jnp.asarray(nr), data1, cfg, occlusion=False)
    j["ts"] = JK.temporal_stabilization(
        sc, dc, jnp.asarray(vz), jnp.asarray(nr), jnp.asarray(mv), data1, data1,
        j["sm"]["fbits"], None, None, j["post"], None, js["diff_luma_stab"], None, None, None,
        cfg, has_diffuse=True, has_specular=False, has_prepass=True)
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc), cfg=cfg,
                state=interop.state_from_numpy(state), pool=pool, j=j, jsc=sc, jdc=dc,
                jstate=state)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


def _geom(ctx):
    p = ctx["pool"]
    return t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS]), t(p[RT.IN_MV])


def test_smb_and_ta_diffuse(ctx):
    """H1 (smb_resolve) + the TA glue vs surface_motion_reprojection + TA diffuse."""
    vz, nr, mv = _geom(ctx)
    st, j = ctx["state"], ctx["j"]
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = TK.surface_motion_reprojection(ctx["sc"], ctx["dc"], vz, nr, mv, st["prev_view_z"],
                                        st["prev_normal_roughness"], prev_internal, ctx["cfg"],
                                        {"diff": (st["diff_history"], st["diff_fast_history"])})
    np.testing.assert_array_equal(sm["fbits"].numpy(), np.asarray(j["sm"]["fbits"]))
    np.testing.assert_array_equal(sm["allow_catrom"].numpy(), np.asarray(j["sm"]["allow_catrom"]))
    close("footprint_quality", sm["footprint_quality"], j["sm"]["footprint_quality"])
    close("diff_accum_speed", sm["diff_accum_speed"], j["sm"]["diff_accum_speed"])
    diff1, fast1, data1 = TK.temporal_accumulation_diffuse(ctx["sc"], ctx["dc"], sm, t(j["pre"]))
    close("ta diff", diff1, j["ta"][0])
    close("ta fast", fast1, j["ta"][1])
    close("ta accum speed", data1, j["ta"][2])


def test_pre_pass(ctx):
    """H2 in PrePass mode vs diffuse_pre_pass."""
    vz, nr, _ = _geom(ctx)
    got = TK.diffuse_pre_pass(ctx["sc"], ctx["dc"], t(ctx["pool"][RT.IN_DIFF_RADIANCE_HITDIST]),
                              vz, nr, ctx["cfg"])
    close("pre pass", got, ctx["j"]["pre"])


@pytest.mark.parametrize("mode", ["blur", "post_blur"])
def test_spatial_filter(ctx, mode):
    """H2 in Blur / PostBlur mode vs diffuse_spatial_filter."""
    vz, nr, _ = _geom(ctx)
    j = ctx["j"]
    src, want, m = ((j["hf"][0], j["blur"], TK.BLUR) if mode == "blur"
                    else (j["blur"], j["post"], TK.POST_BLUR))
    got = TK.diffuse_spatial_filter(ctx["sc"], ctx["dc"], m, t(src), vz, nr, t(j["ta"][2]),
                                    ctx["cfg"])
    close(mode, got, want)


def test_history_fix(ctx):
    """H3 + the fast-history clamp glue vs history_fix."""
    vz, nr, _ = _geom(ctx)
    diff1, fast1, data1, _ = ctx["j"]["ta"]
    sig, fast = TK.history_fix(ctx["sc"], ctx["dc"], vz, nr, t(data1), t(diff1), t(fast1),
                               ctx["cfg"])
    close("history fix signal", sig, ctx["j"]["hf"][0])
    close("history fix fast", fast, ctx["j"]["hf"][1])


def test_temporal_stabilization(ctx):
    """H4 (ts_prelude: the whole diffuse TS half) vs the diffuse half of
    temporal_stabilization."""
    vz, nr, mv = _geom(ctx)
    j = ctx["j"]
    got = TK.temporal_stabilization(ctx["sc"], ctx["dc"], vz, nr, mv, t(j["ta"][2]),
                                    t(j["sm"]["fbits"]), t(j["post"]),
                                    ctx["state"]["diff_luma_stab"], ctx["cfg"])
    for k in ("diff", "diff_luma_stab", "data1_diff"):
        close(f"ts {k}", got[k], j["ts"][k])


@pytest.mark.parametrize("case", list(TS_CASES))
def test_temporal_stabilization_settings(ctx, case):
    """The diffuse TS half against XLA with maxBlurRadius = 0 (no RCRS clamp of the luma) and
    with splitScreen = 0.5 (no history left of the split, tested on the pixel's uv and on the
    reprojected one)."""
    vz, nr, mv = _geom(ctx)
    j = ctx["j"]
    sc_set, dc_set = TS_CASES[case]
    jsc = dict(ctx["jsc"], **{k: np.float32(v) for k, v in sc_set.items()})
    jdc = dict(ctx["jdc"], **{k: np.float32(v) for k, v in dc_set.items()})
    data1 = j["ta"][2]
    want = JK.temporal_stabilization(
        jsc, jdc, jnp.asarray(vz.numpy()), jnp.asarray(nr.numpy()), jnp.asarray(mv.numpy()),
        data1, data1, j["sm"]["fbits"], None, None, j["post"], None,
        jnp.asarray(ctx["jstate"]["diff_luma_stab"]), None, None, None, ctx["cfg"],
        has_diffuse=True, has_specular=False, has_prepass=True)
    assert not np.allclose(np.asarray(want["diff"]), np.asarray(j["ts"]["diff"]))
    got = TK.temporal_stabilization(interop.consts_from_numpy(jsc),
                                    interop.consts_from_numpy(jdc), vz, nr, mv, t(data1),
                                    t(j["sm"]["fbits"]), t(j["post"]),
                                    ctx["state"]["diff_luma_stab"], ctx["cfg"])
    for k in ("diff", "diff_luma_stab", "data1_diff"):
        close(f"ts {case} {k}", got[k], want[k])
