"""Per-pass parity of REBLUR_DIFFUSE_SPECULAR: the port's two-signal passes (their plain CPU
path) against the JAX package's XLA per-signal functions, from identical inputs and state.

The JAX Engine runs REBLUR_DIFFUSE_SPECULAR for 3 frames of the orbit scene at 128x96; its
state and the frame-4 constants are carried across with `nrdtpu_torch.interop`, and the XLA
chain runs frame 4 the way the reference does off-TPU: per signal (`diffuse_pre_pass` /
`diffuse_spatial_filter`, `specular_spatial_filter`, `history_fix` twice). Each fused pass of
the port, one launch for both signals, must compute what the two per-signal calls compute.

Tolerance: rtol=1e-4, atol=1e-5 on float32 outputs, as for the one-signal passes; fbits and
allow_catrom are step functions of the same values and must match exactly. The kernels'
plain versions for two signals must equal their one-signal plain versions run per signal
exactly. The diffuse side of the fused stages and the two-signal TS are also held against
the HLSL oracles (`tests/oracle/reblur.py`) at >= 40 dB.
"""

import os
import sys

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
from nrdtpu_torch.kernels import history_fix_fused as k_hff
from nrdtpu_torch.kernels import smb_resolve as k_smb
from nrdtpu_torch.kernels import spatial_filter as k_sf
from nrdtpu_torch.kernels import spatial_filter_fused as k_sff
from nrdtpu_torch.passes.reblur import kernels as TK

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import reblur as O  # noqa: E402
import test_torch_oracle as TO  # noqa: E402

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (128, 96)
RTOL, ATOL = 1e-4, 1e-5
ORACLE_BAR_DB = 40.0
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
PREPASS_CASES = {"both": {}, "diff_off": {"diff_prepass_blur_radius": np.float32(0.0)},
                 "spec_off": {"spec_prepass_blur_radius": np.float32(0.0)}}


def _inputs(gen, fd):
    vz = jnp.asarray(fd.view_z)
    dn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist), vz, jnp.asarray(HDP), 1.0)
    sn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.spec_hit_dist), vz, jnp.asarray(HDP),
                                      jnp.asarray(fd.roughness))
    return {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv,
            RT.IN_DIFF_RADIANCE_HITDIST: np.asarray(
                jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), dn)),
            RT.IN_SPEC_RADIANCE_HITDIST: np.asarray(
                jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.spec_noisy), sn))}


@pytest.fixture(scope="module")
def ctx():
    """JAX runs frames 0-2; returns frame 3's inputs, constants, state and the XLA chain."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=SIZE)
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

    vz, nr, mv = (jnp.asarray(pool[k]) for k in (RT.IN_VIEWZ, RT.IN_NORMAL_ROUGHNESS, RT.IN_MV))
    diff_in = jnp.asarray(pool[RT.IN_DIFF_RADIANCE_HITDIST])
    spec_in = jnp.asarray(pool[RT.IN_SPEC_RADIANCE_HITDIST])
    js = {k: jnp.asarray(v) for k, v in state.items()}
    j = {}
    for case, over in PREPASS_CASES.items():
        dcc = dict(dc, **over)
        j[f"pre_diff_{case}"], _ = JK.diffuse_pre_pass(sc, dcc, diff_in, vz, nr, cfg)
        j[f"pre_spec_{case}"], _, j[f"pre_hdt_{case}"] = JK.specular_spatial_filter(
            sc, dcc, JK.PRE_BLUR, spec_in, vz, nr, None, cfg, occlusion=False)
    j["pre_perf"] = (JK.diffuse_pre_pass(sc, dc, diff_in, vz, nr, cfg, perf_mode=True)[0],
                     *JK.specular_spatial_filter(sc, dc, JK.PRE_BLUR, spec_in, vz, nr, None, cfg,
                                                 occlusion=False, perf_mode=True)[::2])
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = JK.surface_motion_reprojection(sc, dc, vz, nr, mv, js["prev_view_z"],
                                        js["prev_normal_roughness"], prev_internal, cfg)
    j["sm"] = sm
    for sig in ("diff", "spec"):
        j[f"{sig}_history"] = JK.sample_history(js[f"{sig}_history"], sm["smb_pixel_uv"],
                                                sc["rect_size_prev"], sm["occlusion_weights"],
                                                sm["allow_catrom"])
        j[f"{sig}_fast"] = JK.sample_history_bilinear(
            js[f"{sig}_fast_history"], sm["smb_pixel_uv"], sc["rect_size_prev"],
            sm["occlusion_weights"])
    diff1, diff_fast1, data1_d, _ = JK.temporal_accumulation_diffuse(
        sc, dc, sm, j["pre_diff_both"], js["diff_history"], js["diff_fast_history"], cfg,
        occlusion=False)
    ta = JK.temporal_accumulation_specular(
        sc, dc, sm, j["pre_spec_both"], js["spec_history"], js["spec_fast_history"], vz, nr,
        js["prev_view_z"], js["prev_normal_roughness"], prev_internal, j["pre_hdt_both"],
        js["prev_spec_hitdist_for_tracking"], cfg, occlusion=False, has_prepass_hitdist=True)
    data1_s = ta["accum_speed"]
    j["ta"] = dict(diff=diff1, diff_fast=diff_fast1, data1_diff=data1_d, spec=ta["spec"],
                   spec_fast=ta["fast"], data1_spec=data1_s)
    for af in (False, True):
        j[f"hf_diff_{af}"] = JK.history_fix(sc, dc, vz, nr, data1_d, data1_s, diff1, diff_fast1,
                                            cfg, is_diffuse=True, occlusion=False,
                                            anti_firefly=af)
        j[f"hf_spec_{af}"] = JK.history_fix(sc, dc, vz, nr, data1_d, data1_s, ta["spec"],
                                            ta["fast"], cfg, is_diffuse=False, occlusion=False,
                                            anti_firefly=af)
    d2, s2 = j["hf_diff_False"][0], j["hf_spec_False"][0]
    for key, perf in (("", False), ("_perf", True)):
        j["blur_diff" + key], _ = JK.diffuse_spatial_filter(sc, dc, JK.BLUR, d2, vz, nr, data1_d,
                                                            cfg, occlusion=False, perf_mode=perf)
        j["blur_spec" + key], _, _ = JK.specular_spatial_filter(
            sc, dc, JK.BLUR, s2, vz, nr, data1_s, cfg, occlusion=False, perf_mode=perf)
    j["post_diff"], _ = JK.diffuse_spatial_filter(sc, dc, JK.POST_BLUR, j["blur_diff"], vz, nr,
                                                  data1_d, cfg, occlusion=False)
    j["post_spec"], _, _ = JK.specular_spatial_filter(sc, dc, JK.POST_BLUR, j["blur_spec"], vz,
                                                      nr, data1_s, cfg, occlusion=False)
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc), cfg=cfg,
                state=interop.state_from_numpy(state), pool=pool, j=j)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


def _geom(ctx, dc=None):
    p = ctx["pool"]
    vz, nr = t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS])
    geom = TK.make_filter_geometry(ctx["sc"], dc or ctx["dc"], vz, nr, ctx["cfg"])
    return geom, vz, nr


def _plane(sc, vz, nr):
    """The frame's tap geometry, as N5 returns it for N4's Blur and PostBlur."""
    return k_hff.tap_geometry_ref(nr, vz, float(sc["view_z_scale"]))


@pytest.mark.parametrize("case", list(PREPASS_CASES) + ["perf"])
def test_fused_pre_pass(ctx, case):
    """N4 in PrePass mode (the specular half with hitDistForTracking) vs diffuse_pre_pass and
    specular_spatial_filter(PRE_BLUR); a signal whose radius is 0 passes through."""
    j = ctx["j"]
    dc = dict(ctx["dc"], **interop.consts_from_numpy(PREPASS_CASES.get(case, {})))
    geom, vz, nr = _geom(ctx, dc)
    p = ctx["pool"]
    d, s, hdt = TK.fused_spatial_filter(ctx["sc"], dc, TK.PRE_BLUR, geom, vz, nr,
                                        t(p[RT.IN_DIFF_RADIANCE_HITDIST]),
                                        t(p[RT.IN_SPEC_RADIANCE_HITDIST]), perf_mode=case == "perf")
    want = j["pre_perf"] if case == "perf" else (
        j[f"pre_diff_{case}"], j[f"pre_spec_{case}"], j[f"pre_hdt_{case}"])
    for name, got, w in zip(("diff", "spec", "hit_dist_for_tracking"), (d, s, hdt), want):
        close(f"{case} {name}", got, w)


@pytest.mark.parametrize("mode", ["blur", "post_blur", "blur_perf"])
def test_fused_spatial_filter(ctx, mode):
    """N4 in Blur / PostBlur mode vs diffuse_spatial_filter and specular_spatial_filter, each
    signal at its own tap positions (diffuse skewed in screen space)."""
    j = ctx["j"]
    geom, vz, nr = _geom(ctx)
    src_d, src_s = ((j["hf_diff_False"][0], j["hf_spec_False"][0]) if mode != "post_blur"
                    else (j["blur_diff"], j["blur_spec"]))
    d, s, hdt = TK.fused_spatial_filter(
        ctx["sc"], ctx["dc"], TK.POST_BLUR if mode == "post_blur" else TK.BLUR, geom, vz, nr,
        t(src_d), t(src_s), data1_diff=t(j["ta"]["data1_diff"]),
        data1_spec=t(j["ta"]["data1_spec"]), tap_geometry=_plane(ctx["sc"], vz, nr),
        perf_mode=mode == "blur_perf")
    key = {"blur": "blur", "post_blur": "post", "blur_perf": "blur"}[mode]
    suffix = "_perf" if mode == "blur_perf" else ""
    close(f"{mode} diff", d, j[f"{key}_diff{suffix}"])
    close(f"{mode} spec", s, j[f"{key}_spec{suffix}"])
    assert hdt is None


@pytest.mark.parametrize("mode", ["pre_pass", "blur"])
def test_fused_spatial_filter_geometry_by_stage(ctx, mode):
    """N4 takes the tap-geometry plane in Blur and PostBlur mode and only there: a Blur
    without it and a PrePass with it are refused, on the CPU as on the card."""
    j = ctx["j"]
    geom, vz, nr = _geom(ctx)
    plane = None if mode == "blur" else _plane(ctx["sc"], vz, nr)
    with pytest.raises(ValueError, match="tap-geometry plane"):
        TK.fused_spatial_filter(ctx["sc"], ctx["dc"], TK.BLUR if mode == "blur" else TK.PRE_BLUR,
                                geom, vz, nr, t(j["hf_diff_False"][0]), t(j["hf_spec_False"][0]),
                                data1_diff=t(j["ta"]["data1_diff"]),
                                data1_spec=t(j["ta"]["data1_spec"]), tap_geometry=plane)


@pytest.mark.parametrize("anti_firefly", [False, True], ids=["default", "anti_firefly"])
def test_fused_history_fix(ctx, anti_firefly):
    """N5 (the clamp in the module) vs history_fix twice, with and without the anti-firefly
    ring: the clamped signals and the fast histories; the tap geometry it returns is the
    frame's unpacked normal and scaled viewZ."""
    j, ta = ctx["j"], ctx["j"]["ta"]
    geom, vz, nr = _geom(ctx)
    (d, d_fast), (s, s_fast), plane = TK.fused_history_fix(
        ctx["sc"], ctx["dc"], geom, vz, nr,
        (t(ta["diff"]), t(ta["data1_diff"]), t(ta["diff_fast"])),
        (t(ta["spec"]), t(ta["data1_spec"]), t(ta["spec_fast"])),
        anti_firefly=(anti_firefly, anti_firefly))
    for name, got, want in (("diff", d, j[f"hf_diff_{anti_firefly}"][0]),
                            ("diff fast", d_fast, j[f"hf_diff_{anti_firefly}"][1]),
                            ("spec", s, j[f"hf_spec_{anti_firefly}"][0]),
                            ("spec fast", s_fast, j[f"hf_spec_{anti_firefly}"][1])):
        close(name, got, want)
    if anti_firefly:  # the ring changes the result: the flag reaches the kernel
        assert not np.allclose(d.numpy(), np.asarray(j["hf_diff_False"][0]), rtol=RTOL, atol=ATOL)
    n3 = geom["n3"]
    close("tap geometry", plane,
          torch.stack([n3.x, n3.y, n3.z, geom["view_z"]], -1).numpy())


@pytest.mark.parametrize("is_diffuse", [True, False], ids=["diffuse", "specular"])
def test_history_fix_anti_firefly(ctx, is_diffuse):
    """H3 with the anti-firefly ring + the clamp glue vs history_fix(anti_firefly=True)."""
    j, ta = ctx["j"], ctx["j"]["ta"]
    _, vz, nr = _geom(ctx)
    sig = "diff" if is_diffuse else "spec"
    out, fast, _ = TK.history_fix(ctx["sc"], ctx["dc"], vz, nr, t(ta[f"data1_{sig}"]),
                                  t(ta[sig]), t(ta[f"{sig}_fast"]), ctx["cfg"],
                                  is_diffuse=is_diffuse, anti_firefly=True)
    close("signal", out, j[f"hf_{sig}_True"][0])
    close("fast", fast, j[f"hf_{sig}_True"][1])


def _two_signal_sm(ctx):
    p, st = ctx["pool"], ctx["state"]
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    return TK.surface_motion_reprojection(
        ctx["sc"], ctx["dc"], t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS]), t(p[RT.IN_MV]),
        st["prev_view_z"], st["prev_normal_roughness"], prev_internal, ctx["cfg"],
        {sig: (st[f"{sig}_history"], st[f"{sig}_fast_history"]) for sig in ("diff", "spec")})


def test_two_signal_surface_motion(ctx):
    """H1 in its two-signal mode: one footprint, both signals' accumulation speeds, CatRom
    histories and fast histories, vs surface_motion_reprojection + the XLA samples."""
    sm = _two_signal_sm(ctx)
    j = ctx["j"]
    np.testing.assert_array_equal(sm["fbits"].numpy(), np.asarray(j["sm"]["fbits"]))
    np.testing.assert_array_equal(sm["allow_catrom"].numpy(), np.asarray(j["sm"]["allow_catrom"]))
    for k in ("footprint_quality", "diff_accum_speed", "spec_accum_speed", "n_avg", "smb_navg"):
        close(k, sm[k], j["sm"][k])
    for sig in ("diff", "spec"):
        close(f"{sig} history", sm[f"{sig}_history"], np.asarray(j[f"{sig}_history"], np.float32))
        close(f"{sig} fast", sm[f"{sig}_fast"], np.asarray(j[f"{sig}_fast"], np.float32))


def _recorded(ctx, names):
    """The kernel calls of the port's frame 4 (both signals, the anti-firefly ring on)."""
    from nrdtpu_torch import kernels as KM

    calls = []
    originals = {n: getattr(KM.MODULES[n], n) for n in names}
    try:
        for n in names:
            def rec(*a, _n=n, **k):
                calls.append((_n, a, k))
                return originals[_n](*a, **k)
            setattr(KM.MODULES[n], n, rec)
        sm = _two_signal_sm(ctx)
        j, ta = ctx["j"], ctx["j"]["ta"]
        geom, vz, nr = _geom(ctx)
        TK.fused_spatial_filter(ctx["sc"], ctx["dc"], TK.PRE_BLUR, geom, vz, nr,
                                t(ctx["pool"][RT.IN_DIFF_RADIANCE_HITDIST]),
                                t(ctx["pool"][RT.IN_SPEC_RADIANCE_HITDIST]))
        TK.fused_spatial_filter(ctx["sc"], ctx["dc"], TK.BLUR, geom, vz, nr,
                                t(j["hf_diff_False"][0]), t(j["hf_spec_False"][0]),
                                data1_diff=t(ta["data1_diff"]), data1_spec=t(ta["data1_spec"]),
                                tap_geometry=_plane(ctx["sc"], vz, nr))
        TK.fused_history_fix(ctx["sc"], ctx["dc"], geom, vz, nr,
                             (t(ta["diff"]), t(ta["data1_diff"]), t(ta["diff_fast"])),
                             (t(ta["spec"]), t(ta["data1_spec"]), t(ta["spec_fast"])),
                             anti_firefly=(True, False))
        del sm
    finally:
        for n in names:
            setattr(KM.MODULES[n], n, originals[n])
    return calls


def test_plain_versions_are_per_signal(ctx):
    """The plain version of each two-signal kernel equals its one-signal plain version run
    per signal, exactly: two-signal H1, N4 (PrePass and Blur; H2's tap loop `taps_ref`), N5
    (ring on one signal; H3's plain version, the clamp and the tap geometry included)."""
    calls = _recorded(ctx, ("smb_resolve", "spatial_filter_fused", "history_fix_fused"))
    assert sorted(n for n, _, _ in calls) == ["history_fix_fused", "smb_resolve",
                                              "spatial_filter_fused", "spatial_filter_fused"]
    for name, a, k in calls:
        if name == "smb_resolve":
            both = k_smb.smb_resolve_ref(*a, **k)
            one = dict(k, second=None)
            for s, (acc, hist, fast) in enumerate((a[8:11], k["second"])):
                ref = k_smb.smb_resolve_ref(*a[:8], acc, hist, fast, **one)
                for key, v in ref.items():
                    key2 = key + "_2" if s == 1 and key in k_smb.PER_SIGNAL else key
                    assert torch.equal(both[key2], v), key2
        elif name == "spatial_filter_fused":
            both = k_sff.spatial_filter_fused_ref(*a, **k)
            diff, spec, vz, nr, shared, dp, sp = a
            kw = {x: k[x] for x in ("frustum", "rect_size", "view_z_scale", "ortho_mode",
                                    "perf_mode")}
            assert torch.equal(both["diff"], k_sf.taps_ref(
                diff, vz, nr, shared, dp, min_material=k["diff_min_material"], **kw))
            res = k_sf.taps_ref(spec, vz, nr, shared, sp, min_material=k["spec_min_material"],
                                prepass=k["prepass"], **kw)
            if k["prepass"] is None:
                assert torch.equal(both["spec"], res)
            else:
                assert torch.equal(both["spec"], res[0]) and torch.equal(both["hdt"], res[1])
        else:
            both = k_hff.history_fix_fused_ref(*a, **k)
            diff, spec, vz, nr, d1d, d1s, fd, fs, shared, dp, sp, smc = a
            kw = {x: k[x] for x in ("frustum", "rect_size_inv", "view_z_scale", "ortho_mode")}
            for sig, args, mm, af in (("diff", (diff, vz, nr, d1d, fd, shared, dp, None),
                                       k["diff_min_material"], k["anti_firefly"][0]),
                                      ("spec", (spec, vz, nr, d1s, fs, shared, sp, smc),
                                       k["spec_min_material"], k["anti_firefly"][1])):
                want = k_hf.history_fix_ref(*args, min_material=mm, anti_firefly=af, dc=k["dc"],
                                            **kw)
                assert len(want) == 3
                assert torch.equal(both[sig], want["signal"]), sig
                assert torch.equal(both[f"{sig}_fast"], want["fast"]), f"{sig}_fast"
                assert torch.equal(both["geometry"], want["geometry"])
            assert torch.equal(both["geometry"], k_hff.tap_geometry_ref(nr, vz, k["view_z_scale"]))


# ---------------------------------------------------------------------------
# against the HLSL oracles (the synthetic slanted-wall scene of test_torch_oracle.py)
# ---------------------------------------------------------------------------


def _oracle_inputs(seed):
    rng = np.random.default_rng(seed)
    sc, dc, cfg = TO._camera()
    s = TO._scene(sc, rng)
    spec = rng.uniform(0.0, 1.0, s["signal"].shape).astype(np.float32)
    spec[..., 1:3] -= 0.5
    geom = TK.make_filter_geometry(sc, dc, t(s["view_z"]), t(s["nr"]), cfg)
    return sc, dc, cfg, s, spec, geom, rng


@pytest.mark.parametrize("mode", ["blur", "post_blur"])
def test_fused_spatial_filter_diffuse_matches_oracle(mode):
    """The diffuse side of N4 vs the HLSL diffuse spatial filter (REBLUR_Blur.hlsli)."""
    sc, dc, cfg, s, spec, geom, rng = _oracle_inputs(7)
    data1 = rng.uniform(0.0, 30.0, s["view_z"].shape).astype(np.float32)
    ref = O.diffuse_spatial_filter(sc, dc, mode, s["signal"], s["view_z"], s["nr"], data1)
    got, _, _ = TK.fused_spatial_filter(sc, dc, TK.BLUR if mode == "blur" else TK.POST_BLUR,
                                        geom, t(s["view_z"]), t(s["nr"]), t(s["signal"]), t(spec),
                                        data1_diff=t(data1), data1_spec=t(data1),
                                        tap_geometry=_plane(sc, t(s["view_z"]), t(s["nr"])))
    p = TO.psnr(ref, got.numpy())
    assert p >= ORACLE_BAR_DB, f"{mode}: PSNR vs HLSL oracle = {p:.1f} dB"


def test_fused_history_fix_diffuse_matches_oracle():
    """The diffuse side of N5 (the clamp included) vs the HLSL history fix
    (REBLUR_HistoryFix)."""
    sc, dc, cfg, s, spec, geom, rng = _oracle_inputs(8)
    h, w = s["view_z"].shape
    data1 = np.broadcast_to(np.where(np.arange(w)[None, :] < w // 2, 1.0, 20.0),
                            (h, w)).astype(np.float32)
    fast = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    ref_sig, ref_fast = O.history_fix_diffuse(sc, dc, s["view_z"], s["nr"], data1, s["signal"],
                                              fast)
    (got_sig, got_fast), _, _ = TK.fused_history_fix(sc, dc, geom, t(s["view_z"]), t(s["nr"]),
                                                     (t(s["signal"]), t(data1), t(fast)),
                                                     (t(spec), t(data1), t(fast)))
    assert TO.psnr(ref_sig, got_sig.numpy()) >= ORACLE_BAR_DB
    assert TO.psnr(ref_fast, got_fast.numpy()) >= ORACLE_BAR_DB


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_two_signal_ts_matches_oracle(translate_x):
    """The flagship's TS: one surface motion shared by the diffuse half and the specular half
    (with the virtual-motion sample), vs the HLSL diff+spec TS
    (REBLUR_TemporalStabilization.hlsli)."""
    rng = np.random.default_rng(9)
    sc, dc, cfg = TO._camera(translate_x)
    s = TO._scene(sc, rng)
    h, w = s["view_z"].shape
    mv = s["mv"] + np.asarray([0.37 / w, 0.23 / h, 0.0], np.float32)  # off the texel lattice
    data1 = rng.uniform(0.0, 30.0, (2, h, w)).astype(np.float32)
    fbits = rng.integers(0, 256, (h, w)).astype(np.float32)
    curvature = rng.uniform(-0.2, 0.2, (h, w)).astype(np.float32)
    amount = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    sig = rng.uniform(0.0, 1.0, (2, h, w, 4)).astype(np.float32)
    sig[..., 1:3] -= 0.5
    hist = rng.uniform(0.0, 1.0, (2, h, w)).astype(np.float32)
    ref = O.temporal_stabilization(sc, dc, s["view_z"], s["nr"], mv, data1[0], data1[1], fbits,
                                   curvature, amount, sig[0], sig[1], hist[0], hist[1])
    vz, nr, mv_t = t(s["view_z"]), t(s["nr"]), t(mv)
    ts_sm = TK.ts_surface_motion(sc, vz, mv_t)
    got = TK.temporal_stabilization(sc, dc, vz, nr, mv_t, t(data1[0]), t(fbits), t(sig[0]),
                                    t(hist[0]), cfg, surface_motion=ts_sm)
    got.update(TK.temporal_stabilization_specular(
        sc, dc, vz, nr, mv_t, t(data1[1]), t(fbits), t(curvature), t(amount), t(sig[1]),
        t(hist[1]), None, None, cfg, has_prepass=False, surface_motion=ts_sm))
    for name in ("diff", "diff_luma_stab", "data1_diff", "spec", "spec_luma_stab", "data1_spec"):
        p = TO.psnr(ref[name], got[name].numpy())
        assert p >= ORACLE_BAR_DB, f"TS {name}: {p:.1f} dB vs HLSL oracle"
