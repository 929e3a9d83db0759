"""Per-pass parity of the REBLUR specular passes: each kernel-holding pass of the PyTorch port
(its plain CPU path) against the JAX package's XLA function, from identical inputs and state.

The JAX Engine runs REBLUR_SPECULAR for 3 frames of the orbit scene at 128x96; its state
and the frame-4 constants are carried across with `nrdtpu_torch.interop`, and both sides run
frame 4 pass by pass. Each pass takes the JAX chain's own intermediate as input, so a fault
shows in the pass that makes it.

Tolerance: rtol=1e-4, atol=1e-5 on float32 outputs, as for the diffuse passes. fbits and
allow_catrom of the surface motion are step functions of the same values and must match
exactly. The specular TA is held to the same rtol/atol on all but FLIP_RATE of its pixels,
and fbits_vmb by its flip rate: XLA's rsqrt, atan, exp2 and log differ from PyTorch's in the
last bit on 13-38 % of float32 inputs, and the TA amplifies that where it divides by a small
difference (curvature = dot(n_edge - n, edge) / |edge|^2 of nearly equal normals one pixel
apart) or tests a threshold (the virtual-motion footprint).
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
from nrdtpu_torch.kernels import history_fix as k_hf
from nrdtpu_torch.passes.reblur import kernels as TK

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
RTOL, ATOL = 1e-4, 1e-5
FLIP_RATE = 1e-3
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)


def _inputs(gen, fd):
    nhd = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.spec_hit_dist), jnp.asarray(fd.view_z),
                                       jnp.asarray(HDP), jnp.asarray(fd.roughness))
    sig = np.asarray(jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.spec_noisy), nhd))
    return {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv, RT.IN_SPEC_RADIANCE_HITDIST: sig}


@pytest.fixture(scope="module")
def ctx():
    """JAX runs frames 0-2; returns frame 3's inputs, constants, state and the XLA chain."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: Denoiser.REBLUR_SPECULAR}, resource_size=SIZE)
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
    rng = np.random.default_rng(5)
    bcm = rng.uniform(0.0, 1.0, SIZE[::-1] + (4,)).astype(np.float32)

    vz, nr, mv = (jnp.asarray(pool[k]) for k in (RT.IN_VIEWZ, RT.IN_NORMAL_ROUGHNESS, RT.IN_MV))
    js = {k: jnp.asarray(v) for k, v in state.items()}
    j = {}
    j["pre"], _, j["pre_hdt"] = JK.specular_spatial_filter(
        sc, dc, JK.PRE_BLUR, jnp.asarray(pool[RT.IN_SPEC_RADIANCE_HITDIST]), vz, nr, None, cfg,
        occlusion=False)
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    j["sm"] = JK.surface_motion_reprojection(sc, dc, vz, nr, mv, js["prev_view_z"],
                                             js["prev_normal_roughness"], prev_internal, cfg)
    j["ta"] = JK.temporal_accumulation_specular(
        sc, dc, j["sm"], j["pre"], js["spec_history"], js["spec_fast_history"], vz, nr,
        js["prev_view_z"], js["prev_normal_roughness"], prev_internal, j["pre_hdt"],
        js["prev_spec_hitdist_for_tracking"], cfg, occlusion=False, has_prepass_hitdist=True)
    ta = j["ta"]
    data1 = ta["accum_speed"]
    j["hf"] = JK.history_fix(sc, dc, vz, nr, js["diff_accum"], data1, ta["spec"], ta["fast"],
                             cfg, is_diffuse=False, occlusion=False)
    j["blur"], _, _ = JK.specular_spatial_filter(sc, dc, JK.BLUR, j["hf"][0], vz, nr, data1,
                                                 cfg, occlusion=False)
    j["post"], _, _ = JK.specular_spatial_filter(sc, dc, JK.POST_BLUR, j["blur"], vz, nr, data1,
                                                 cfg, occlusion=False)
    j["fbits"] = j["sm"]["fbits"] + ta["fbits_vmb"]
    for key, base_color_metalness in (("ts", None), ("ts_bcm", jnp.asarray(bcm))):
        j[key] = JK.temporal_stabilization(
            sc, dc, vz, nr, mv, js["diff_accum"], data1, j["fbits"], ta["curvature"],
            ta["virtual_history_amount"], None, j["post"], None, js["spec_luma_stab"],
            ta["hit_dist_for_tracking"], base_color_metalness, cfg, has_diffuse=False,
            has_specular=True, has_prepass=True)
    # the PrePass with its radius at 0: the `disabled` fallback (kernels.py:1768-1778)
    dc_off = dict(dc, spec_prepass_blur_radius=np.float32(0.0))
    j["pre_off"], _, j["pre_off_hdt"] = JK.specular_spatial_filter(
        sc, dc_off, JK.PRE_BLUR, jnp.asarray(pool[RT.IN_SPEC_RADIANCE_HITDIST]), vz, nr, None,
        cfg, occlusion=False)
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc),
                dc_off=interop.consts_from_numpy(dc_off), cfg=cfg,
                state=interop.state_from_numpy(state), pool=pool, bcm=bcm, j=j, jsc=sc, jdc=dc,
                jstate=state)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want, outliers=0.0):
    """Within rtol/atol on all but a fraction `outliers` of the pixels."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    if bad.ndim == 3:
        bad = bad.any(-1)
    assert bad.mean() <= outliers, (f"{name}: {bad.sum()} of {bad.size} pixels differ, "
                                    f"max |d| = {np.abs(got - want).max():.3g}")


def _geom(ctx):
    p = ctx["pool"]
    return t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS]), t(p[RT.IN_MV])


def _sm(ctx):
    vz, nr, mv = _geom(ctx)
    st = ctx["state"]
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = TK.surface_motion_reprojection(ctx["sc"], ctx["dc"], vz, nr, mv, st["prev_view_z"],
                                        st["prev_normal_roughness"], prev_internal, ctx["cfg"],
                                        {"spec": (st["spec_history"], st["spec_fast_history"])})
    return sm, prev_internal


def test_smb_resolve_specular_outputs(ctx):
    """H1 with the specular accumulation plane, and the normal averages the TA reads."""
    sm, _ = _sm(ctx)
    jsm = ctx["j"]["sm"]
    np.testing.assert_array_equal(sm["fbits"].numpy(), np.asarray(jsm["fbits"]))
    np.testing.assert_array_equal(sm["allow_catrom"].numpy(), np.asarray(jsm["allow_catrom"]))
    for k in ("spec_accum_speed", "n_avg", "smb_navg", "footprint_quality", "x", "x_prev", "v",
              "nov", "smb_pixel_uv"):
        close(k, sm[k], jsm[k])


def test_ta_specular(ctx):
    """N1 (spec_ta_head), N2 (nearest_multi), N3 (vmb_resolve) + the glue vs the XLA TA."""
    vz, nr, _ = _geom(ctx)
    st, j = ctx["state"], ctx["j"]
    sm, prev_internal = _sm(ctx)
    got = TK.temporal_accumulation_specular(
        ctx["sc"], ctx["dc"], sm, t(j["pre"]), st["spec_history"], st["spec_fast_history"], vz,
        nr, st["prev_view_z"], st["prev_normal_roughness"], prev_internal, t(j["pre_hdt"]),
        st["prev_spec_hitdist_for_tracking"], ctx["cfg"], has_prepass_hitdist=True)
    for k in ("spec", "fast", "accum_speed", "curvature", "virtual_history_amount",
              "hit_dist_for_tracking"):
        close(f"ta {k}", got[k], j["ta"][k], FLIP_RATE)
    flips = np.mean(got["fbits_vmb"].numpy() != np.asarray(j["ta"]["fbits_vmb"]))
    assert flips <= FLIP_RATE, f"fbits_vmb: {flips:.2%} of pixels differ"


@pytest.mark.parametrize("mode", ["pre_blur", "pre_blur_off", "blur", "post_blur"])
def test_specular_spatial_filter(ctx, mode):
    """H2 in the specular PrePass (with hitDistForTracking; radius 0 takes the `disabled`
    fallback), Blur and PostBlur modes."""
    vz, nr, _ = _geom(ctx)
    j = ctx["j"]
    data1 = t(j["ta"]["accum_speed"])
    raw = ctx["pool"][RT.IN_SPEC_RADIANCE_HITDIST]
    src, want, m = {"pre_blur": (raw, j["pre"], TK.PRE_BLUR),
                    "pre_blur_off": (raw, j["pre_off"], TK.PRE_BLUR),
                    "blur": (j["hf"][0], j["blur"], TK.BLUR),
                    "post_blur": (j["blur"], j["post"], TK.POST_BLUR)}[mode]
    dc = ctx["dc_off" if mode == "pre_blur_off" else "dc"]
    plane = (None if m == TK.PRE_BLUR  # Blur and PostBlur read the history fix's plane
             else k_hf.tap_geometry_ref(nr, vz, float(ctx["sc"]["view_z_scale"])))
    got, hdt = TK.specular_spatial_filter(ctx["sc"], dc, m, t(src), vz, nr,
                                          None if m == TK.PRE_BLUR else data1, ctx["cfg"],
                                          tap_geometry=plane)
    close(mode, got, want)
    if m == TK.PRE_BLUR:
        want_hdt = j["pre_off_hdt" if mode == "pre_blur_off" else "pre_hdt"]
        close(f"{mode} hit_dist_for_tracking", hdt, want_hdt)
    else:
        assert hdt is None


def test_history_fix_specular(ctx):
    """H3 in specular mode + the fast-history clamp glue vs history_fix(is_diffuse=False)."""
    vz, nr, _ = _geom(ctx)
    ta = ctx["j"]["ta"]
    sig, fast, _ = TK.history_fix(ctx["sc"], ctx["dc"], vz, nr, t(ta["accum_speed"]),
                                  t(ta["spec"]), t(ta["fast"]), ctx["cfg"], is_diffuse=False)
    close("history fix signal", sig, ctx["j"]["hf"][0])
    close("history fix fast", fast, ctx["j"]["hf"][1])


# TS settings off the defaults: (shared constants, denoiser constants) changed
TS_CASES = {"max_blur_radius_0": ({}, dict(max_blur_radius=0.0)),
            "split_screen": (dict(split_screen=0.5, split_screen_prev=0.5), {})}


@pytest.mark.parametrize("case", list(TS_CASES))
def test_temporal_stabilization_specular_settings(ctx, case):
    """The specular TS half against XLA with maxBlurRadius = 0 (no RCRS clamp of the luma) and
    with splitScreen = 0.5 (no history left of the split, tested on the pixel's uv and on the
    surface- and virtual-motion uv by the virtual history amount)."""
    vz, nr, mv = _geom(ctx)
    j = ctx["j"]
    ta = j["ta"]
    sc_set, dc_set = TS_CASES[case]
    jsc = dict(ctx["jsc"], **{k: np.float32(v) for k, v in sc_set.items()})
    jdc = dict(ctx["jdc"], **{k: np.float32(v) for k, v in dc_set.items()})
    js = ctx["jstate"]
    want = JK.temporal_stabilization(
        jsc, jdc, jnp.asarray(vz.numpy()), jnp.asarray(nr.numpy()), jnp.asarray(mv.numpy()),
        jnp.asarray(js["diff_accum"]), ta["accum_speed"], j["fbits"], ta["curvature"],
        ta["virtual_history_amount"], None, j["post"], None, jnp.asarray(js["spec_luma_stab"]),
        ta["hit_dist_for_tracking"], None, ctx["cfg"], has_diffuse=False, has_specular=True,
        has_prepass=True)
    assert not np.allclose(np.asarray(want["spec"]), np.asarray(j["ts"]["spec"]))
    got = TK.temporal_stabilization_specular(
        interop.consts_from_numpy(jsc), interop.consts_from_numpy(jdc), vz, nr, mv,
        t(ta["accum_speed"]), t(j["fbits"]), t(ta["curvature"]),
        t(ta["virtual_history_amount"]), t(j["post"]), ctx["state"]["spec_luma_stab"],
        t(ta["hit_dist_for_tracking"]), None, ctx["cfg"], has_prepass=True)
    for k in ("spec", "spec_luma_stab", "data1_spec"):
        close(f"ts {case} {k}", got[k], want[k])


@pytest.mark.parametrize("with_bcm", [False, True], ids=["plain", "base_color_metalness"])
def test_temporal_stabilization_specular(ctx, with_bcm):
    """H4's specular half (the virtual-motion sample and the rest of the half) + the glue
    before it, with and without the MV patching that IN_BASECOLOR_METALNESS turns on."""
    vz, nr, mv = _geom(ctx)
    j = ctx["j"]
    ta = j["ta"]
    want = j["ts_bcm" if with_bcm else "ts"]
    got = TK.temporal_stabilization_specular(
        ctx["sc"], ctx["dc"], vz, nr, mv, t(ta["accum_speed"]), t(j["fbits"]),
        t(ta["curvature"]), t(ta["virtual_history_amount"]), t(j["post"]),
        ctx["state"]["spec_luma_stab"], t(ta["hit_dist_for_tracking"]),
        t(ctx["bcm"]) if with_bcm else None, ctx["cfg"], has_prepass=True)
    for k in ("spec", "spec_luma_stab", "data1_spec", "mv_out"):
        close(f"ts {k}", got[k], want[k])
    if with_bcm:
        assert not np.array_equal(got["mv_out"].numpy(), ctx["pool"][RT.IN_MV])
