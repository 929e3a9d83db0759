"""The REBLUR SH variants in the PyTorch port, pass by pass with the SH planes: each pass (its
plain CPU path, the kernels' `*_ref` in their SH modes) against the JAX package's XLA function
with SH, from identical inputs and identical state.

The port's Engine runs REBLUR_DIFFUSE_SPECULAR_SH over 3 frames of the orbit scene at 48x32 on
the CPU (its slice is held against the JAX Engine in `tests/test_torch_reblur_sh_slice.py`); its
state, with the two bfloat16 SH histories, goes to the JAX side and the JAX Engine's frame-4
constants to the port's, both with `nrdtpu_torch.interop`; then both sides run frame 4 pass by
pass, each pass from the JAX chain's own intermediate: the PrePass, TA, the history fix (with
and without the anti-firefly ring), Blur, PostBlur and TS, each of one signal (H2, H3) and of
both (N4, N5, H1 with two signals), and the band against the three-launch chain. SH1 goes along
the surface direction field of `tests/test_torch_reblur_sh_slice.py` (`SH_DIRECTIONS`), its .w
drawn per pixel from a seed, so that the passes' different rules for .w show (the specular
filters keep the centre's .w, TA writes the modified roughness there, the history fix and the
diffuse filters average it).

Tolerance: rtol=1e-4, atol=1e-5, as `tests/test_torch_ds_passes.py`, with the allowance of
`tests/test_torch_relax_sh_passes.py` for the specular TA (at most 1e-3 of the values outside
the tolerance: the curvature is a quotient of nearly equal normals), which the specular SH
shares. The frontend's SH helpers are held against the JAX package's on seeded inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.kernels import history_fix_fused as k_hff
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.settings import Denoiser, ResourceType as RT

from test_torch_reblur_sh_slice import SH_IN, frames_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TA_FLIP_FRACTION = 1e-3
SIZE = (48, 32)
SIGNALS = ("diff", "spec")
STAGES = {"blur": JK.BLUR, "post_blur": JK.POST_BLUR}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want, flip_fraction=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert bad.mean() <= flip_fraction, (
        f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
        f"{np.abs(got - want).max():.3g}")


@pytest.fixture(scope="module")
def ctx():
    """The port runs frames 0-2 (the JAX Engine only takes each frame's common settings);
    returns frame 3's inputs, both sides' constants and state, and the XLA chain with SH."""
    frames = list(frames_of(4))
    eng = JEngine({0: JDenoiser.REBLUR_DIFFUSE_SPECULAR_SH}, resource_size=SIZE)
    port = TEngine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR_SH}, resource_size=SIZE, device="cpu")
    for i, (cs, pool) in enumerate(frames):
        eng.set_common_settings(cs)
        if i < 3:
            port.set_common_settings(cs)
            port.denoise([0], pool)
    inst = eng._instances[0]
    cfg = inst.config
    sc = eng._shared_consts()
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    state = {k: v.clone() for k, v in port.get_state(0).items()}
    js = {k: jnp.asarray(interop.tensor_to_numpy(v)).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32) for k, v in state.items()}
    pool = frames[3][1]
    vz, nr, mv = (jnp.asarray(pool[k]) for k in (RT.IN_VIEWZ, RT.IN_NORMAL_ROUGHNESS, RT.IN_MV))
    sh0 = {sig: jnp.asarray(pool[SH_IN[sig][0]]) for sig in SIGNALS}
    sh1 = {sig: jnp.asarray(pool[SH_IN[sig][1]]) for sig in SIGNALS}
    j = {}
    j["pre_diff"] = JK.diffuse_pre_pass(sc, dc, sh0["diff"], vz, nr, cfg, sh=sh1["diff"])
    j["pre_spec"] = JK.specular_spatial_filter(sc, dc, JK.PRE_BLUR, sh0["spec"], vz, nr, None,
                                               cfg, sh=sh1["spec"], occlusion=False)
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = JK.surface_motion_reprojection(sc, dc, vz, nr, mv, js["prev_view_z"],
                                        js["prev_normal_roughness"], prev_internal, cfg)
    j["sm"] = sm
    for sig in SIGNALS:
        j[f"{sig}_sh_sample"] = JK.sample_history_bilinear(
            js[f"{sig}_sh_history"], sm["smb_pixel_uv"], sc["rect_size_prev"],
            sm["occlusion_weights"])
    d1, df1, data1_d, dsh1 = JK.temporal_accumulation_diffuse(
        sc, dc, sm, j["pre_diff"][0], js["diff_history"], js["diff_fast_history"], cfg,
        occlusion=False, diff_sh_input=j["pre_diff"][1], diff_sh_history=js["diff_sh_history"])
    ta = JK.temporal_accumulation_specular(
        sc, dc, sm, j["pre_spec"][0], js["spec_history"], js["spec_fast_history"], vz, nr,
        js["prev_view_z"], js["prev_normal_roughness"], prev_internal, j["pre_spec"][2],
        js["prev_spec_hitdist_for_tracking"], cfg, occlusion=False, has_prepass_hitdist=True,
        spec_sh_input=j["pre_spec"][1], spec_sh_history=js["spec_sh_history"])
    j["ta"] = dict(diff=d1, diff_fast=df1, data1_diff=data1_d, diff_sh=dsh1, spec=ta["spec"],
                   spec_fast=ta["fast"], data1_spec=ta["accum_speed"], spec_sh=ta["sh"],
                   spec_dict=ta)
    for af in (False, True):
        for sig, is_diffuse in (("diff", True), ("spec", False)):
            j[f"hf_{sig}_{af}"] = JK.history_fix(
                sc, dc, vz, nr, data1_d, ta["accum_speed"], j["ta"][sig], j["ta"][f"{sig}_fast"],
                cfg, is_diffuse=is_diffuse, occlusion=False, anti_firefly=af,
                sh=j["ta"][f"{sig}_sh"])
    src = {sig: (j[f"hf_{sig}_False"][0], j[f"hf_{sig}_False"][2]) for sig in SIGNALS}
    for stage, mode in STAGES.items():
        j[f"{stage}_diff"] = JK.diffuse_spatial_filter(
            sc, dc, mode, src["diff"][0], vz, nr, data1_d, cfg, sh=src["diff"][1],
            occlusion=False)
        j[f"{stage}_spec"] = JK.specular_spatial_filter(
            sc, dc, mode, src["spec"][0], vz, nr, ta["accum_speed"], cfg, sh=src["spec"][1],
            occlusion=False)[:2]
        src = {sig: j[f"{stage}_{sig}"] for sig in SIGNALS}
    j["ts"] = JK.temporal_stabilization(
        sc, dc, vz, nr, mv, data1_d, ta["accum_speed"], sm["fbits"] + ta["fbits_vmb"],
        ta["curvature"], ta["virtual_history_amount"], src["diff"][0], src["spec"][0],
        js["diff_luma_stab"], js["spec_luma_stab"], ta["hit_dist_for_tracking"], None, cfg,
        has_diffuse=True, has_specular=True, has_prepass=True, diff_sh=src["diff"][1],
        spec_sh=src["spec"][1])
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc), cfg=cfg,
                state=state, pool=pool, j=j)


def _planes(ctx):
    p = ctx["pool"]
    return t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS])


def _geom(ctx):
    vz, nr = _planes(ctx)
    return TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, nr, ctx["cfg"]), vz, nr


def _plane(ctx, vz, nr):
    """The frame's tap geometry, as H3 and N5 return it for the Blur and PostBlur."""
    return k_hff.tap_geometry_ref(nr, vz, float(ctx["sc"]["view_z_scale"]))


@pytest.mark.parametrize("signals", ["one", "both"])
def test_pre_pass(ctx, signals):
    """The PrePass with SH: H2 per signal (diffuse_pre_pass, specular_spatial_filter) and N4
    for both (fused_spatial_filter), signal, SH and hitDistForTracking."""
    j, p = ctx["j"], ctx["pool"]
    vz, nr = _planes(ctx)
    sh0 = {sig: t(p[SH_IN[sig][0]]) for sig in SIGNALS}
    sh1 = {sig: t(p[SH_IN[sig][1]]) for sig in SIGNALS}
    if signals == "one":
        d, dsh = TK.diffuse_pre_pass(ctx["sc"], ctx["dc"], sh0["diff"], vz, nr, ctx["cfg"],
                                     sh=sh1["diff"])
        s, hdt, ssh = TK.specular_spatial_filter(ctx["sc"], ctx["dc"], TK.PRE_BLUR, sh0["spec"],
                                                 vz, nr, None, ctx["cfg"], sh=sh1["spec"])
    else:
        geom, _, _ = _geom(ctx)
        d, s, hdt, (dsh, ssh) = TK.fused_spatial_filter(
            ctx["sc"], ctx["dc"], TK.PRE_BLUR, geom, vz, nr, sh0["diff"], sh0["spec"],
            sh=(sh1["diff"], sh1["spec"]))
    for name, got, want in (("diff", d, j["pre_diff"][0]), ("diff sh", dsh, j["pre_diff"][1]),
                            ("spec", s, j["pre_spec"][0]), ("spec sh", ssh, j["pre_spec"][1]),
                            ("hit_dist_for_tracking", hdt, j["pre_spec"][2])):
        close(f"{signals} {name}", got, want)
    # the specular filter keeps the centre's .w; the diffuse one filters it
    np.testing.assert_array_equal(ssh[..., 3].numpy(), p[SH_IN["spec"][1]][..., 3])
    assert not np.allclose(dsh[..., 3].numpy(), p[SH_IN["diff"][1]][..., 3])


def _sm(ctx):
    p, st = ctx["pool"], ctx["state"]
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    return TK.surface_motion_reprojection(
        ctx["sc"], ctx["dc"], t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS]), t(p[RT.IN_MV]),
        st["prev_view_z"], st["prev_normal_roughness"], prev_internal, ctx["cfg"],
        {sig: (st[f"{sig}_history"], st[f"{sig}_fast_history"]) for sig in SIGNALS},
        sh_histories={sig: st[f"{sig}_sh_history"] for sig in SIGNALS})


def test_surface_motion_sh_samples(ctx):
    """H1 with two signals and SH: each SH history sampled with the custom bilinear weights
    (`sample_history_bilinear`), never the CatRom."""
    sm = _sm(ctx)
    for sig in SIGNALS:
        close(f"{sig} sh sample", sm[f"{sig}_sh"], ctx["j"][f"{sig}_sh_sample"])


def test_temporal_accumulation(ctx):
    """TA of both signals with SH: the diffuse SH mix over four channels and its anti-firefly
    scale; the specular SH's two lerps, .w the modified roughness, and its scale."""
    j, p, st = ctx["j"], ctx["pool"], ctx["state"]
    sm = _sm(ctx)
    vz, nr = _planes(ctx)
    d, dfast, data1, dsh = TK.temporal_accumulation_diffuse(
        ctx["sc"], ctx["dc"], sm, t(j["pre_diff"][0]), sh_input=t(j["pre_diff"][1]))
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    ta = TK.temporal_accumulation_specular(
        ctx["sc"], ctx["dc"], sm, t(j["pre_spec"][0]), st["spec_history"],
        st["spec_fast_history"], vz, nr, st["prev_view_z"], st["prev_normal_roughness"],
        prev_internal, t(j["pre_spec"][2]), st["prev_spec_hitdist_for_tracking"], ctx["cfg"],
        has_prepass_hitdist=True, sh_input=t(j["pre_spec"][1]),
        sh_history=st["spec_sh_history"])
    jt = j["ta"]
    for name, got, want in (("diff", d, jt["diff"]), ("diff fast", dfast, jt["diff_fast"]),
                            ("data1 diff", data1, jt["data1_diff"]),
                            ("diff sh", dsh, jt["diff_sh"])):
        close(name, got, want)
    for key in ("spec", "fast", "accum_speed", "sh"):
        close(f"spec {key}", ta[key], jt["spec_dict"][key], TA_FLIP_FRACTION)


@pytest.mark.parametrize("anti_firefly", [False, True], ids=["default", "anti_firefly"])
@pytest.mark.parametrize("signals", ["one", "both"])
def test_history_fix(ctx, signals, anti_firefly):
    """The history fix with SH: H3 per signal and N5 for both, with and without the ring; the
    SH through the taps (all four channels) and scaled to the clamped luma."""
    j, ta = ctx["j"], ctx["j"]["ta"]
    vz, nr = _planes(ctx)
    args = {sig: (t(ta[sig]), t(ta[f"data1_{sig}"]), t(ta[f"{sig}_fast"])) for sig in SIGNALS}
    sh = {sig: t(ta[f"{sig}_sh"]) for sig in SIGNALS}
    got = {}
    if signals == "one":
        for sig in SIGNALS:
            out, fast, _, osh = TK.history_fix(
                ctx["sc"], ctx["dc"], vz, nr, args[sig][1], args[sig][0], args[sig][2],
                ctx["cfg"], is_diffuse=sig == "diff", anti_firefly=anti_firefly, sh=sh[sig])
            got[sig] = (out, fast, osh)
    else:
        geom, _, _ = _geom(ctx)
        (d, df), (s, sf), _, (dsh, ssh) = TK.fused_history_fix(
            ctx["sc"], ctx["dc"], geom, vz, nr, args["diff"], args["spec"],
            anti_firefly=(anti_firefly, anti_firefly), sh=(sh["diff"], sh["spec"]))
        got = dict(diff=(d, df, dsh), spec=(s, sf, ssh))
    for sig in SIGNALS:
        for k, name in enumerate(("signal", "fast", "sh")):
            close(f"{signals} {sig} {name}", got[sig][k], j[f"hf_{sig}_{anti_firefly}"][k])


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("signals", ["one", "both"])
def test_spatial_filter(ctx, signals, stage):
    """Blur and PostBlur with SH: H2 per signal and N4 for both; the diffuse SH sums four
    channels, the specular three (the centre's .w kept)."""
    j, ta = ctx["j"], ctx["j"]["ta"]
    vz, nr = _planes(ctx)
    prev = {"blur": {sig: j[f"hf_{sig}_False"] for sig in SIGNALS},
            "post_blur": {sig: j[f"blur_{sig}"] for sig in SIGNALS}}[stage]
    src = {sig: (t(prev[sig][0]), t(prev[sig][-1] if stage == "post_blur" else prev[sig][2]))
           for sig in SIGNALS}
    data1 = {sig: t(ta[f"data1_{sig}"]) for sig in SIGNALS}
    mode, plane = STAGES[stage], _plane(ctx, vz, nr)
    if signals == "one":
        d, dsh = TK.diffuse_spatial_filter(ctx["sc"], ctx["dc"], mode, src["diff"][0], vz, nr,
                                           data1["diff"], ctx["cfg"], sh=src["diff"][1],
                                           tap_geometry=plane)
        s, hdt, ssh = TK.specular_spatial_filter(ctx["sc"], ctx["dc"], mode, src["spec"][0], vz,
                                                 nr, data1["spec"], ctx["cfg"],
                                                 sh=src["spec"][1], tap_geometry=plane)
        assert hdt is None
    else:
        geom, _, _ = _geom(ctx)
        d, s, hdt, (dsh, ssh) = TK.fused_spatial_filter(
            ctx["sc"], ctx["dc"], mode, geom, vz, nr, src["diff"][0], src["spec"][0],
            data1_diff=data1["diff"], data1_spec=data1["spec"], tap_geometry=plane,
            sh=(src["diff"][1], src["spec"][1]))
    for name, got, want in (("diff", d, j[f"{stage}_diff"][0]), ("diff sh", dsh,
                                                                  j[f"{stage}_diff"][1]),
                            ("spec", s, j[f"{stage}_spec"][0]),
                            ("spec sh", ssh, j[f"{stage}_spec"][1])):
        close(f"{signals} {stage} {name}", got, want)
    np.testing.assert_array_equal(ssh[..., 3].numpy(), src["spec"][1][..., 3].numpy())


def test_band_is_the_chain(ctx):
    """With SH, the band's plain version gives what the three-launch chain gives, exactly."""
    ta = ctx["j"]["ta"]
    geom, vz, nr = _geom(ctx)
    args = [(t(ta[sig]), t(ta[f"data1_{sig}"]), t(ta[f"{sig}_fast"])) for sig in SIGNALS]
    kw = dict(anti_firefly=(True, False), perf_mode=False,
              sh=(t(ta["diff_sh"]), t(ta["spec_sh"])))
    chain = TK.spatial_chain(ctx["sc"], ctx["dc"], geom, vz, nr, *args, **kw)
    band = TK.spatial_band(ctx["sc"], ctx["dc"], geom, vz, nr, *args, **kw)
    for a, b in zip(chain, band):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_temporal_stabilization(ctx):
    """TS with SH: each half's SH .xyz scaled to its stabilized luma."""
    j, ta, st, p = ctx["j"], ctx["j"]["ta"], ctx["state"], ctx["pool"]
    vz, nr = _planes(ctx)
    mv = t(p[RT.IN_MV])
    ts_sm = TK.ts_surface_motion(ctx["sc"], vz, mv)
    fbits = t(j["sm"]["fbits"] + ta["spec_dict"]["fbits_vmb"])
    src = {sig: j[f"post_blur_{sig}"] for sig in SIGNALS}
    got = TK.temporal_stabilization(ctx["sc"], ctx["dc"], vz, nr, mv, t(ta["data1_diff"]), fbits,
                                    t(src["diff"][0]), st["diff_luma_stab"], ctx["cfg"],
                                    surface_motion=ts_sm, sh=t(src["diff"][1]))
    sd = ta["spec_dict"]
    got.update(TK.temporal_stabilization_specular(
        ctx["sc"], ctx["dc"], vz, nr, mv, t(ta["data1_spec"]), fbits, t(sd["curvature"]),
        t(sd["virtual_history_amount"]), t(src["spec"][0]), st["spec_luma_stab"],
        t(sd["hit_dist_for_tracking"]), None, ctx["cfg"], has_prepass=True,
        surface_motion=ts_sm, sh=t(src["spec"][1])))
    for key in ("diff", "diff_sh", "spec", "spec_sh", "diff_luma_stab", "spec_luma_stab"):
        close(f"ts {key}", got[key], j["ts"][key])


def test_frontend_sh_helpers():
    """The frontend's SH packing and resolves vs the JAX package's, on seeded inputs."""
    rng = np.random.default_rng(31)
    shape = (16, 12)
    radiance = rng.uniform(0.0, 4.0, shape + (3,)).astype(np.float32)
    nhd = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    d = rng.normal(size=shape + (3,)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = rng.normal(size=shape + (3,)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    rough = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    got = tfe.reblur_pack_sh(t(radiance), t(nhd), t(d))
    want = jfe.reblur_pack_sh(jnp.asarray(radiance), jnp.asarray(nhd), jnp.asarray(d))
    for g, w in zip(got, want):
        close("pack", g, w)
    tsg, jsg = tfe.reblur_unpack_sh(*got), jfe.reblur_unpack_sh(*want)
    close("extract color", tfe.sg_extract_color(tsg), jfe.sg_extract_color(jsg))
    close("sg diffuse", tfe.sg_resolve_diffuse(tsg, t(n)), jfe.sg_resolve_diffuse(jsg, n))
    close("sg specular", tfe.sg_resolve_specular(tsg, t(n), t(v), t(rough)),
          jfe.sg_resolve_specular(jsg, n, v, rough))
    close("sh diffuse", tfe.sh_resolve_diffuse(tsg, t(n)), jfe.sh_resolve_diffuse(jsg, n))
    close("sh specular", tfe.sh_resolve_specular(tsg, t(n), t(v), t(rough)),
          jfe.sh_resolve_specular(jsg, n, v, rough))
    c = tfe.sg_create(t(radiance), t(d), t(nhd))
    jc = jfe.sg_create(jnp.asarray(radiance), jnp.asarray(d), jnp.asarray(nhd))
    for g, w in zip(c, jc):
        close("sg create", g, w)
