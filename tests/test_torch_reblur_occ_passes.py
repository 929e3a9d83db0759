"""The REBLUR occlusion variants in the PyTorch port, pass by pass on one channel: each pass
(its plain CPU path, the kernels' `*_ref` in their one-channel modes) against the JAX package's
XLA function with `occlusion=True`, from identical inputs and identical state.

The port's Engine runs REBLUR_DIFFUSE_SPECULAR_OCCLUSION over 3 frames of the orbit scene at
64x48 on the CPU (its slice is held against the JAX Engine in
`tests/test_torch_reblur_occ_slice.py`, whose AO frames this file takes, with a seeded 30 % of
the geometry pixels zeroed); its state, the (h, w, 1) bfloat16 histories, goes to the JAX side
and the JAX Engine's frame-4 constants to the port's, both with `nrdtpu_torch.interop`; then
both sides run frame 4 pass by pass, each pass from the JAX chain's own intermediate: the
hit-distance reconstruction (K12), TA of each signal (H1, N1-N3), the history fix (H3 per
signal, N5 for both), Blur and PostBlur (H2 per signal, N4 for both), the band against the
chain and against XLA, and the checkerboard neighbour resolve (glue). The occlusion forms of the
common helpers are held against the JAX package's on seeded inputs.

Tolerance: rtol=1e-4, atol=1e-5, as `tests/test_torch_ds_passes.py`, with the allowance of
`tests/test_torch_reblur_sh_passes.py` for the specular TA (at most 1e-3 of the values outside
the tolerance: the curvature is a quotient of nearly equal normals).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import math as jnm
from nrdtpu.engine import Engine as JEngine
from nrdtpu.ops import resample as jrs
from nrdtpu.passes.reblur import common as JC
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser

from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.kernels import history_fix_fused as k_hff
from nrdtpu_torch.passes.reblur import common as TC
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.settings import Denoiser, ResourceType as RT

from test_torch_reblur_occ_slice import IN, SIZE, frames_of, half_width

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TA_FLIP_FRACTION = 1e-3
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
    returns frame 3's inputs, both sides' constants and state, and the XLA chain."""
    frames = list(frames_of(4, holes=True))
    eng = JEngine({0: JDenoiser.REBLUR_DIFFUSE_SPECULAR_OCCLUSION}, resource_size=SIZE)
    port = TEngine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR_OCCLUSION}, resource_size=SIZE,
                   device="cpu")
    for i, (cs, pool, _) in enumerate(frames):
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
    cs, pool, _ = frames[3]
    vz, nr, mv = (jnp.asarray(pool[k]) for k in (RT.IN_VIEWZ, RT.IN_NORMAL_ROUGHNESS, RT.IN_MV))
    sig_in = {sig: jnp.asarray(pool[IN[sig]])[..., None] for sig in SIGNALS}
    j = {"recon": {r: JK.hit_dist_reconstruction(sc, dc, vz, nr, sig_in["diff"], sig_in["spec"],
                                                 cfg, radius=r) for r in (1, 2)}}
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = JK.surface_motion_reprojection(sc, dc, vz, nr, mv, js["prev_view_z"],
                                        js["prev_normal_roughness"], prev_internal, cfg)
    j["sm"] = sm
    for sig in SIGNALS:
        j[f"{sig}_history_sample"] = JK.sample_history(
            js[f"{sig}_history"], sm["smb_pixel_uv"], sc["rect_size_prev"],
            sm["occlusion_weights"], sm["allow_catrom"])
    d1, df1, data1_d, _ = JK.temporal_accumulation_diffuse(
        sc, dc, sm, sig_in["diff"], js["diff_history"], js["diff_fast_history"], cfg,
        occlusion=True)
    ta = JK.temporal_accumulation_specular(
        sc, dc, sm, sig_in["spec"], js["spec_history"], js["spec_fast_history"], vz, nr,
        js["prev_view_z"], js["prev_normal_roughness"], prev_internal,
        JC.extract_hit_dist(sig_in["spec"]), js["prev_spec_hitdist_for_tracking"], cfg,
        occlusion=True, has_prepass_hitdist=False)
    j["ta"] = dict(diff=d1, diff_fast=df1, data1_diff=data1_d, spec=ta["spec"],
                   spec_fast=ta["fast"], data1_spec=ta["accum_speed"], spec_dict=ta)
    for sig, is_diffuse in (("diff", True), ("spec", False)):
        j[f"hf_{sig}"] = JK.history_fix(
            sc, dc, vz, nr, data1_d, ta["accum_speed"], j["ta"][sig], j["ta"][f"{sig}_fast"],
            cfg, is_diffuse=is_diffuse, occlusion=True)
    src = {sig: j[f"hf_{sig}"][0] for sig in SIGNALS}
    for stage, mode in STAGES.items():
        j[f"{stage}_diff"] = JK.diffuse_spatial_filter(
            sc, dc, mode, src["diff"], vz, nr, data1_d, cfg, occlusion=True)[0]
        j[f"{stage}_spec"] = JK.specular_spatial_filter(
            sc, dc, mode, src["spec"], vz, nr, ta["accum_speed"], cfg, occlusion=True)[0]
        src = {sig: j[f"{stage}_{sig}"] for sig in SIGNALS}
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc), cfg=cfg,
                jsc=sc, state=state, pool=pool, cs=cs, j=j)


def _planes(ctx):
    p = ctx["pool"]
    return t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS])


def _geom(ctx):
    vz, nr = _planes(ctx)
    return TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, nr, ctx["cfg"]), vz, nr


def _plane(ctx, vz, nr):
    """The frame's tap geometry, as H3 and N5 return it for the Blur and PostBlur."""
    return k_hff.tap_geometry_ref(nr, vz, float(ctx["sc"]["view_z_scale"]))


def _ta_args(ctx):
    ta = ctx["j"]["ta"]
    return {sig: (t(ta[sig]), t(ta[f"data1_{sig}"]), t(ta[f"{sig}_fast"])) for sig in SIGNALS}


@pytest.mark.parametrize("radius", [1, 2])
def test_hit_dist_reconstruction(ctx, radius):
    """K12's one-channel mode on the AO with holes: both signals' zeros refilled."""
    vz, nr = _planes(ctx)
    sig = {s: t(ctx["pool"][IN[s]])[..., None] for s in SIGNALS}
    assert float((sig["diff"] == 0).float().mean()) > 0.2
    d, s = TK.hit_dist_reconstruction(ctx["sc"], ctx["dc"], vz, nr, sig["diff"], sig["spec"],
                                      ctx["cfg"], radius=radius)
    want = ctx["j"]["recon"][radius]
    close("diff", d, want[0])
    close("spec", s, want[1])


def _sm(ctx):
    p, st = ctx["pool"], ctx["state"]
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    return TK.surface_motion_reprojection(
        ctx["sc"], ctx["dc"], t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS]), t(p[RT.IN_MV]),
        st["prev_view_z"], st["prev_normal_roughness"], prev_internal, ctx["cfg"],
        {sig: (st[f"{sig}_history"], st[f"{sig}_fast_history"]) for sig in SIGNALS})


def test_surface_motion_history_samples(ctx):
    """H1 with two one-channel histories: each (h, w, 1) history through the CatRom with the
    bilinear-custom fallback (`sample_history`)."""
    sm = _sm(ctx)
    for sig in SIGNALS:
        assert tuple(sm[f"{sig}_history"].shape) == (SIZE[1], SIZE[0], 1)
        close(f"{sig} history sample", sm[f"{sig}_history"], ctx["j"][f"{sig}_history_sample"])


def test_temporal_accumulation(ctx):
    """TA of both signals with occlusion: the one-channel mixes by f_hit, no firefly
    suppressor; the specular half's virtual-motion history from N3's one-channel kernel."""
    j, p, st = ctx["j"], ctx["pool"], ctx["state"]
    sm = _sm(ctx)
    vz, nr = _planes(ctx)
    sig_in = {sig: t(p[IN[sig]])[..., None] for sig in SIGNALS}
    d, dfast, data1 = TK.temporal_accumulation_diffuse(ctx["sc"], ctx["dc"], sm, sig_in["diff"],
                                                       occlusion=True)
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    ta = TK.temporal_accumulation_specular(
        ctx["sc"], ctx["dc"], sm, sig_in["spec"], st["spec_history"], st["spec_fast_history"],
        vz, nr, st["prev_view_z"], st["prev_normal_roughness"], prev_internal,
        TC.extract_hit_dist(sig_in["spec"]), st["prev_spec_hitdist_for_tracking"], ctx["cfg"],
        has_prepass_hitdist=False, occlusion=True)
    jt = j["ta"]
    for name, got, want in (("diff", d, jt["diff"]), ("diff fast", dfast, jt["diff_fast"]),
                            ("data1 diff", data1, jt["data1_diff"])):
        close(name, got, want)
    for key in ("spec", "fast", "accum_speed", "hit_dist_for_tracking"):
        close(f"spec {key}", ta[key], jt["spec_dict"][key], TA_FLIP_FRACTION)


@pytest.mark.parametrize("signals", ["one", "both"])
def test_history_fix(ctx, signals):
    """The history fix with occlusion: H3 per signal and N5 for both; the clamp with the hit
    distance as the luma and sigma scale 1."""
    vz, nr = _planes(ctx)
    args = _ta_args(ctx)
    if signals == "one":
        got = {}
        for sig in SIGNALS:
            out, fast, _ = TK.history_fix(ctx["sc"], ctx["dc"], vz, nr, args[sig][1], args[sig][0],
                                          args[sig][2], ctx["cfg"], is_diffuse=sig == "diff")
            got[sig] = (out, fast)
    else:
        geom, _, _ = _geom(ctx)
        (d, df), (s, sf), _ = TK.fused_history_fix(ctx["sc"], ctx["dc"], geom, vz, nr,
                                                   args["diff"], args["spec"])
        got = dict(diff=(d, df), spec=(s, sf))
    for sig in SIGNALS:
        for k, name in enumerate(("signal", "fast")):
            close(f"{signals} {sig} {name}", got[sig][k], ctx["j"][f"hf_{sig}"][k])


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("signals", ["one", "both"])
def test_spatial_filter(ctx, signals, stage):
    """Blur and PostBlur with occlusion: H2 per signal and N4 for both, the min hit-distance
    weight without sqrt(nlas)."""
    j, ta = ctx["j"], ctx["j"]["ta"]
    vz, nr = _planes(ctx)
    prev = {"blur": {sig: j[f"hf_{sig}"][0] for sig in SIGNALS},
            "post_blur": {sig: j[f"blur_{sig}"] for sig in SIGNALS}}[stage]
    src = {sig: t(prev[sig]) for sig in SIGNALS}
    data1 = {sig: t(ta[f"data1_{sig}"]) for sig in SIGNALS}
    mode, plane = STAGES[stage], _plane(ctx, vz, nr)
    if signals == "one":
        d = TK.diffuse_spatial_filter(ctx["sc"], ctx["dc"], mode, src["diff"], vz, nr,
                                      data1["diff"], ctx["cfg"], tap_geometry=plane)
        s, hdt = TK.specular_spatial_filter(ctx["sc"], ctx["dc"], mode, src["spec"], vz, nr,
                                            data1["spec"], ctx["cfg"], tap_geometry=plane)
        assert hdt is None
    else:
        geom, _, _ = _geom(ctx)
        d, s, hdt = TK.fused_spatial_filter(
            ctx["sc"], ctx["dc"], mode, geom, vz, nr, src["diff"], src["spec"],
            data1_diff=data1["diff"], data1_spec=data1["spec"], tap_geometry=plane)
    close(f"{signals} {stage} diff", d, j[f"{stage}_diff"])
    close(f"{signals} {stage} spec", s, j[f"{stage}_spec"])


def test_band(ctx):
    """The band with occlusion: its plain version gives what the three-launch chain gives,
    exactly, and the XLA chain within the tolerance."""
    j = ctx["j"]
    geom, vz, nr = _geom(ctx)
    args = _ta_args(ctx)
    kw = dict(anti_firefly=(False, False), perf_mode=False)
    chain = TK.spatial_chain(ctx["sc"], ctx["dc"], geom, vz, nr, args["diff"], args["spec"], **kw)
    band = TK.spatial_band(ctx["sc"], ctx["dc"], geom, vz, nr, args["diff"], args["spec"], **kw)
    for a, b in zip(chain, band):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for k, sig in enumerate(SIGNALS):
        close(f"band {sig}", band[k][0], j[f"post_blur_{sig}"])
        close(f"band {sig} fast", band[k][1], j[f"hf_{sig}"][1])


@pytest.mark.parametrize("mode", [1, 2], ids=["BLACK", "WHITE"])
def test_checkerboard_resolve(ctx, mode):
    """The occlusion variants' checkerboard glue (`cb_resolve`): the half-width AO expanded,
    the horizontal neighbour resolve on the pixels without data, as JAX's denoiser glue
    (`nrdtpu/passes/reblur/denoiser.py:278-298`)."""
    vz, nr = _planes(ctx)
    frame = int(ctx["cs"].frameIndex)
    sc, jsc = ctx["sc"], ctx["jsc"]
    h, w = SIZE[1], SIZE[0]
    expanded = {sig: TC.cb_expand(t(half_width(ctx["pool"][IN[sig]], frame, mode))[..., None], w)
                for sig in SIGNALS}
    col = np.arange(w)[None, :] + np.zeros((h, 1), np.int64)
    row = np.arange(h)[:, None] + np.zeros((1, w), np.int64)
    has_data = ((col + row + frame) & 1) == mode - 1
    got = TK.cb_resolve(sc, vz, nr, expanded, torch.from_numpy(has_data))
    # JAX's glue, op for op (`denoiser.py:282-298`)
    jvz = jnp.abs(jnp.asarray(ctx["pool"][RT.IN_VIEWZ])) * jsc["view_z_scale"]
    fsz = jnm.get_frustum_size(jsc["min_rect_dim_mul_unproject"], jsc["ortho_mode"], jvz)
    n, _, _ = JK.unpack_nr(jsc, jnp.asarray(ctx["pool"][RT.IN_NORMAL_ROUGHNESS]), ctx["cfg"])
    xv = jnm.reconstruct_view_position(jrs.pixel_uv_grid(h, w), jsc["frustum"][None, None, :],
                                       jvz, jsc["ortho_mode"])
    nv = n @ jnp.asarray(jsc["world_to_view"])[:3, :3].T
    nov = jnp.abs(jnm.dot(nv, JC.get_view_vector_view_space(jsc, xv)))
    for sig in SIGNALS:
        e = jnp.asarray(expanded[sig].numpy())
        want = jnp.where(jnp.asarray(has_data)[..., None], e,
                         JK.cb_neighbor_resolve(jsc, e, jvz, fsz, nov))
        assert bool((~has_data).any())
        close(f"cb {sig}", got[sig], want)


def test_common_occlusion_forms():
    """The occlusion forms of the common helpers against the JAX package's, on seeded
    (h, w, 1) signals: luma, ChangeLuma, ClampNegativeToZero, MixHistoryAndCurrent."""
    rng = np.random.default_rng(41)
    shape = (12, 10)
    sig = rng.uniform(-0.2, 1.2, shape + (1,)).astype(np.float32)
    hist = rng.uniform(-0.2, 1.2, shape + (1,)).astype(np.float32)
    luma = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    f = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    dc = dict(max_accumulated_frame_num=np.float32(30.0))
    close("luma", TC.get_luma(t(sig), True), JC.get_luma(jnp.asarray(sig), True))
    close("change", TC.change_luma(t(sig), t(luma), True),
          JC.change_luma(jnp.asarray(sig), jnp.asarray(luma), True))
    close("clamp", TC.clamp_negative_to_zero(t(sig), True),
          JC.clamp_negative_to_zero(jnp.asarray(sig), True))
    close("mix", TC.mix_history_and_current(dc, t(hist), t(sig), t(f), t(rough), True),
          JC.mix_history_and_current(dc, jnp.asarray(hist), jnp.asarray(sig), jnp.asarray(f),
                                     jnp.asarray(rough), True))
    assert TC.color_clamping_sigma_scale(True) == JC.color_clamping_sigma_scale(True) == 1.0
