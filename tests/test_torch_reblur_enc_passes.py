"""REBLUR at the RGBA normal encodings, pass by pass: each pass of REBLUR_DIFFUSE_SPECULAR (its
plain CPU path, the kernels' `*_ref` in their decoded modes) against the JAX package's XLA
function, from identical inputs and identical state, at RGBA8_UNORM and at RGBA16_SNORM (the
sky's normal packed as (0, 0, 1), `tests/test_torch_reblur_enc_slice.py` says why).

The port's Engine runs frames 0-2 of the orbit scene at 64x48 on the CPU; its state goes to the
JAX side and the JAX Engine's frame-3 constants to the port's (`nrdtpu_torch.interop`). Frame 3
has depth and normal edges under camera motion (the orbit's objects against the floor and each
other). The JAX side unpacks the packed IN_NORMAL_ROUGHNESS at every read, the centres' too, as
the reference does at these formats; the port's passes take the planes as
`nrdtpu_torch/passes/reblur/denoiser.py` hands them: decoded once (`frontend.decode_normal_plane`,
then `decode_roughness_plane(decoded=True)`) at LINEAR for every reader, and the packed planes for
the specular TA's previous-normal fetch and curvature lanes (`packed=`). Each pass starts from
the JAX chain's own intermediate: the surface motion, the diffuse and specular TA (the specular
one's previous normals bilinear on the packed plane, with no hash draw and no lerp of the
prev-prev weights: `test_specular_ta_fetch_is_bilinear` shows that the stochastic nearest fetch
or a bilinear fetch of the decoded plane moves the result past the tolerance), the history fix,
PrePass, Blur and PostBlur (H2, N4, N5 and K23), TS, and the hit-distance reconstruction (radius
1 and 2, and radius 1 on one channel, the hit distance zeroed on a seeded 30 % of the geometry
pixels).

Tolerance: rtol=1e-4, atol=1e-5, as `tests/test_torch_ds_passes.py`, with the allowance of
`tests/test_torch_reblur_roughness_passes.py` for the specular TA (at most 1e-3 of the values
outside the tolerance: the curvature is a quotient of nearly equal normals).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, NormalEncoding as JNE

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch import math as tnm
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.kernels import history_fix as k_hf
from nrdtpu_torch.kernels import nearest_multi as k_nearest_multi
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.settings import Denoiser, NormalEncoding as NE, ResourceType as RT
from nrdtpu_torch.settings import RoughnessEncoding as RE, replace

from test_torch_reblur_enc_slice import SIZE, frames_of
from test_torch_reblur_roughness_passes import STAGES, TA_FLIP_FRACTION, close, t

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

VARIANT = "REBLUR_DIFFUSE_SPECULAR"
SIGNALS = ("diff", "spec")
SIGNAL_IN = {"diff": RT.IN_DIFF_RADIANCE_HITDIST, "spec": RT.IN_SPEC_RADIANCE_HITDIST}
HOLE_FRACTION = 0.3


@pytest.fixture(scope="module", params=["RGBA8_UNORM", "RGBA16_SNORM"])
def ctx(request):
    """Frame 3's inputs (packed and decoded), both sides' constants and state, and the XLA
    chain (per signal, as the reference runs at these formats)."""
    encoding = request.param
    eng = JEngine({0: JDenoiser[VARIANT]}, resource_size=SIZE, normal_encoding=JNE[encoding])
    port = TEngine({0: Denoiser[VARIANT]}, resource_size=SIZE, normal_encoding=NE[encoding],
                   device="cpu")
    for i, (cs, pool) in enumerate(frames_of(VARIANT, encoding, frames=4)):
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
    vz, nr, mv = (jnp.asarray(pool[k]) for k in (RT.IN_VIEWZ, RT.IN_NORMAL_ROUGHNESS, RT.IN_MV))
    sig_in = {sig: jnp.asarray(pool[SIGNAL_IN[sig]]) for sig in SIGNALS}
    j = {}
    j["pre_diff"], _ = JK.diffuse_pre_pass(sc, dc, sig_in["diff"], vz, nr, cfg)
    j["pre_spec"], _, j["pre_hdt"] = JK.specular_spatial_filter(
        sc, dc, JK.PRE_BLUR, sig_in["spec"], vz, nr, None, cfg, occlusion=False)
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = JK.surface_motion_reprojection(sc, dc, vz, nr, mv, js["prev_view_z"],
                                        js["prev_normal_roughness"], prev_internal, cfg)
    d1, df1, data1_d, _ = JK.temporal_accumulation_diffuse(
        sc, dc, sm, j["pre_diff"], js["diff_history"], js["diff_fast_history"], cfg,
        occlusion=False)
    ta = JK.temporal_accumulation_specular(
        sc, dc, sm, j["pre_spec"], js["spec_history"], js["spec_fast_history"], vz, nr,
        js["prev_view_z"], js["prev_normal_roughness"], prev_internal, j["pre_hdt"],
        js["prev_spec_hitdist_for_tracking"], cfg, occlusion=False, has_prepass_hitdist=True)
    j["sm"] = sm
    j["ta"] = dict(diff=d1, diff_fast=df1, data1_diff=data1_d, spec=ta["spec"],
                   spec_fast=ta["fast"], data1_spec=ta["accum_speed"], spec_dict=ta)
    data1_s = ta["accum_speed"]
    j["hf_diff"] = JK.history_fix(sc, dc, vz, nr, data1_d, data1_s, d1, df1, cfg,
                                  is_diffuse=True, occlusion=False)
    j["hf_spec"] = JK.history_fix(sc, dc, vz, nr, data1_d, data1_s, ta["spec"], ta["fast"], cfg,
                                  is_diffuse=False, occlusion=False)
    src = {"diff": j["hf_diff"][0], "spec": j["hf_spec"][0]}
    for stage in ("blur", "post_blur"):
        mode = STAGES[stage]
        j[f"{stage}_diff"], _ = JK.diffuse_spatial_filter(sc, dc, mode, src["diff"], vz, nr,
                                                          data1_d, cfg, occlusion=False)
        j[f"{stage}_spec"], _, _ = JK.specular_spatial_filter(sc, dc, mode, src["spec"], vz, nr,
                                                              data1_s, cfg, occlusion=False)
        src = {"diff": j[f"{stage}_diff"], "spec": j[f"{stage}_spec"]}
    j["ts"] = JK.temporal_stabilization(
        sc, dc, vz, nr, mv, data1_d, data1_s, sm["fbits"] + ta["fbits_vmb"], ta["curvature"],
        ta["virtual_history_amount"], src["diff"], src["spec"], js["diff_luma_stab"],
        js["spec_luma_stab"], ta["hit_dist_for_tracking"], None, cfg, has_diffuse=True,
        has_specular=True, has_prepass=True)
    j["fbits"] = sm["fbits"] + ta["fbits_vmb"]
    # the hit-distance reconstruction's inputs: each signal's hit distance zeroed on a seeded
    # 30 % of the geometry pixels
    hit = np.asarray(pool[RT.IN_VIEWZ]) < 1e3
    punched = (np.random.default_rng(83).uniform(size=hit.shape) < HOLE_FRACTION) & hit
    holes = {sig: np.asarray(pool[SIGNAL_IN[sig]]).copy() for sig in SIGNALS}
    for sig in SIGNALS:
        holes[sig][..., 3] = np.where(punched, 0.0, holes[sig][..., 3])
    for radius in (1, 2):
        j[f"recon{radius}"] = JK.hit_dist_reconstruction(
            sc, dc, vz, nr, jnp.asarray(holes["diff"]), jnp.asarray(holes["spec"]), cfg,
            radius=radius)
    j["recon_occ"] = JK.hit_dist_reconstruction(
        sc, dc, vz, nr, jnp.asarray(holes["diff"][..., 3:]), jnp.asarray(holes["spec"][..., 3:]),
        cfg, radius=1)
    pcfg = port._instances[0].config
    return dict(encoding=encoding, sc=interop.consts_from_numpy(sc),
                dc=interop.consts_from_numpy(dc), cfg=pcfg,
                lin=replace(pcfg, roughness_encoding=RE.LINEAR), state=state, pool=pool,
                holes=holes, j=j)


def _decode(p, cfg):
    """The denoiser's decoded plane of a packed one."""
    return tfe.decode_roughness_plane(tfe.decode_normal_plane(p, cfg.normal_encoding),
                                      cfg.roughness_encoding, decoded=True)


def _planes(ctx):
    """viewZ, IN_NORMAL_ROUGHNESS as packed, and its decoded plane (the denoiser's `nr`)."""
    p = ctx["pool"]
    nr = t(p[RT.IN_NORMAL_ROUGHNESS])
    return t(p[RT.IN_VIEWZ]), nr, _decode(nr, ctx["cfg"])


def _surface_motion(ctx):
    st = ctx["state"]
    vz, _, dec = _planes(ctx)
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = TK.surface_motion_reprojection(
        ctx["sc"], ctx["dc"], vz, dec, t(ctx["pool"][RT.IN_MV]), st["prev_view_z"],
        _decode(st["prev_normal_roughness"], ctx["cfg"]), prev_internal, ctx["lin"],
        {sig: (st[f"{sig}_history"], st[f"{sig}_fast_history"]) for sig in SIGNALS})
    return sm, prev_internal


def _specular_ta(ctx, prev_packed=None, patch=None):
    """The specular TA as the denoiser calls it; prev_packed: another plane for the
    previous-normal fetch; patch: (object, name, value) set around the TA alone."""
    j, st = ctx["j"], ctx["state"]
    vz, nr, dec = _planes(ctx)
    sm, prev_internal = _surface_motion(ctx)
    prev_dec = _decode(st["prev_normal_roughness"], ctx["cfg"])
    packed = (nr, st["prev_normal_roughness"] if prev_packed is None else prev_packed)
    with pytest.MonkeyPatch.context() as mp:
        if patch is not None:
            mp.setattr(*patch)
        return TK.temporal_accumulation_specular(
            ctx["sc"], ctx["dc"], sm, t(j["pre_spec"]), st["spec_history"],
            st["spec_fast_history"], vz, dec, st["prev_view_z"], prev_dec, prev_internal,
            t(j["pre_hdt"]), st["prev_spec_hitdist_for_tracking"], ctx["cfg"],
            has_prepass_hitdist=True, packed=packed)


def test_surface_motion(ctx):
    """H1's footprint on the decoded planes (no material test) and the glue around it."""
    sm, _ = _surface_motion(ctx)
    want = ctx["j"]["sm"]
    for key in ("n", "roughness", "material_id", "n_avg", "smb_navg", "footprint_quality",
                "fbits", "diff_accum_speed", "spec_accum_speed", "parallax_max"):
        close(key, sm[key], want[key])
    assert torch.equal(sm["allow_catrom"], torch.from_numpy(np.asarray(want["allow_catrom"])))


def test_diffuse_temporal_accumulation(ctx):
    ta = ctx["j"]["ta"]
    sm, _ = _surface_motion(ctx)
    d, fast, data1 = TK.temporal_accumulation_diffuse(ctx["sc"], ctx["dc"], sm,
                                                      t(ctx["j"]["pre_diff"]))
    close("diff", d, ta["diff"])
    close("diff fast", fast, ta["diff_fast"])
    close("data1 diff", data1, ta["data1_diff"])


def test_specular_temporal_accumulation(ctx):
    """N1 on the packed plane with its roughness decoded (its curvature lanes the packed .xy),
    the previous normals from bilinear_resolve on the packed previous plane, N3 on the decoded
    previous plane. The curvature reads the reference's octahedral decode of the RGBA texel's
    .xy (ROADMAP.md Queue 3): at RGBA16_SNORM the floor's (0, 1, 0) decodes to (0, 0, -1), so
    n_edge - n is of order 1 where the reference's is near 0, and the rounding of the edge
    vector is amplified. Its allowance is the share of values that the port's own TA moves out
    of the tolerance when viewZ moves by one ulp (1.4 % out at RGBA16_SNORM against 2.5 % moved
    by the ulp, max |d| 2.5e-4 both), where that share exceeds 1e-3."""
    got = _specular_ta(ctx)
    want = ctx["j"]["ta"]["spec_dict"]
    for key in ("spec", "fast", "accum_speed", "hit_dist_for_tracking",
                "virtual_history_amount", "fbits_vmb"):
        close(key, got[key], want[key], TA_FLIP_FRACTION)
    nudged = dict(ctx, pool=dict(ctx["pool"]))
    vz = ctx["pool"][RT.IN_VIEWZ]
    nudged["pool"][RT.IN_VIEWZ] = np.nextafter(vz, np.float32(np.inf)).astype(np.float32)
    moved = ~np.isclose(_specular_ta(nudged)["curvature"].numpy(), got["curvature"].numpy(),
                        rtol=1e-4, atol=1e-5)
    print(f"{ctx['encoding']} curvature: one ulp of viewZ moves {moved.mean():.3%} of it")
    close("curvature", got["curvature"], want["curvature"], max(TA_FLIP_FRACTION, moved.mean()))


@pytest.mark.parametrize("fetch", ["stochastic_nearest", "decoded_blend"])
def test_specular_ta_fetch_is_bilinear(ctx, fetch):
    """The previous normals along the virtual motion are bilinear samples of the packed plane,
    unpacked after the blend. Fetched as R10G10B10A2 fetches them (stochastic nearest, with its
    hash draws), or blended from the decoded plane and normalized after, the TA's outputs move
    outside the tolerance on more than the allowance of values."""
    if fetch == "stochastic_nearest":
        def sample(image, uvs, *, scale):
            h, w = image.shape[:2]
            return k_nearest_multi.nearest_multi(
                image, TK._stochastic_bilinear_uvs(ctx["sc"], list(uvs), (float(w), float(h))))
        got = _specular_ta(ctx, patch=(TK.k_bilinear, "bilinear_resolve", sample))
    else:
        got = _specular_ta(
            ctx, prev_packed=_decode(ctx["state"]["prev_normal_roughness"], ctx["cfg"]),
            patch=(TK.fe, "unpack_normal_roughness", lambda p, ne, re_: (
                tnm.safe_normalize(p[..., :3]), p[..., 3], torch.zeros_like(p[..., 3]))))
    want = ctx["j"]["ta"]["spec_dict"]
    worst = max(np.mean(~np.isclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5))
                for k in ("spec", "accum_speed", "virtual_history_amount"))
    print(f"{ctx['encoding']} {fetch}: up to {worst:.3%} of a TA output out of tolerance")
    assert worst > TA_FLIP_FRACTION


@pytest.mark.parametrize("stage", list(STAGES))
def test_specular_spatial_filter(ctx, stage):
    """H2's specular filter on the decoded plane (`kDec`): the centre and the taps decoded."""
    j = ctx["j"]
    vz, _, dec = _planes(ctx)
    if stage == "prepass":
        got, hdt = TK.specular_spatial_filter(ctx["sc"], ctx["dc"], TK.PRE_BLUR,
                                              t(ctx["pool"][RT.IN_SPEC_RADIANCE_HITDIST]), vz,
                                              dec, None, ctx["lin"])
        close("hit_dist_for_tracking", hdt, j["pre_hdt"])
        close("prepass", got, j["pre_spec"])
        return
    src = j["hf_spec"][0] if stage == "blur" else j["blur_spec"]
    got, _ = TK.specular_spatial_filter(
        ctx["sc"], ctx["dc"], STAGES[stage], t(src), vz, dec, t(j["ta"]["data1_spec"]),
        ctx["lin"], tap_geometry=k_hf.tap_geometry_ref(dec, vz, float(ctx["sc"]["view_z_scale"]),
                                                      decoded=True))
    close(stage, got, j[f"{stage}_spec"])


@pytest.mark.parametrize("stage", list(STAGES))
def test_diffuse_spatial_filter(ctx, stage):
    """H2's diffuse filter on the decoded plane (`kDec`)."""
    j = ctx["j"]
    vz, _, dec = _planes(ctx)
    if stage == "prepass":
        got = TK.diffuse_pre_pass(ctx["sc"], ctx["dc"], t(ctx["pool"][RT.IN_DIFF_RADIANCE_HITDIST]),
                                  vz, dec, ctx["lin"])
        close("prepass", got, j["pre_diff"])
        return
    src = j["hf_diff"][0] if stage == "blur" else j["blur_diff"]
    got = TK.diffuse_spatial_filter(
        ctx["sc"], ctx["dc"], STAGES[stage], t(src), vz, dec, t(j["ta"]["data1_diff"]),
        ctx["lin"], tap_geometry=k_hf.tap_geometry_ref(dec, vz, float(ctx["sc"]["view_z_scale"]),
                                                      decoded=True))
    close(stage, got, j[f"{stage}_diff"])


@pytest.mark.parametrize("sig", SIGNALS)
def test_history_fix(ctx, sig):
    """H3 on the decoded plane (`kDec`): the centre's geometry and the taps decoded."""
    j, ta = ctx["j"], ctx["j"]["ta"]
    vz, _, dec = _planes(ctx)
    out, fast, _ = TK.history_fix(ctx["sc"], ctx["dc"], vz, dec, t(ta[f"data1_{sig}"]),
                                  t(ta[sig]), t(ta[f"{sig}_fast"]), ctx["lin"],
                                  is_diffuse=sig == "diff")
    close("signal", out, j[f"hf_{sig}"][0])
    close("fast", fast, j[f"hf_{sig}"][1])


def _ta_args(ctx):
    ta = ctx["j"]["ta"]
    return {sig: (t(ta[sig]), t(ta[f"data1_{sig}"]), t(ta[f"{sig}_fast"])) for sig in SIGNALS}


def test_fused_history_fix(ctx):
    """N5, both signals, on the decoded plane."""
    j = ctx["j"]
    vz, _, dec = _planes(ctx)
    geom = TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, dec, ctx["lin"])
    assert geom["decoded"]
    args = _ta_args(ctx)
    (d, df), (s, sf), _ = TK.fused_history_fix(ctx["sc"], ctx["dc"], geom, vz, dec,
                                               args["diff"], args["spec"])
    for name, got, want in (("diff", d, j["hf_diff"][0]), ("diff fast", df, j["hf_diff"][1]),
                            ("spec", s, j["hf_spec"][0]), ("spec fast", sf, j["hf_spec"][1])):
        close(name, got, want)


@pytest.mark.parametrize("stage", list(STAGES))
def test_fused_spatial_filter(ctx, stage):
    """N4, both signals, each stage, on the decoded plane."""
    j = ctx["j"]
    vz, _, dec = _planes(ctx)
    geom = TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, dec, ctx["lin"])
    p = ctx["pool"]
    if stage == "prepass":
        d, s, hdt = TK.fused_spatial_filter(
            ctx["sc"], ctx["dc"], TK.PRE_BLUR, geom, vz, dec, t(p[RT.IN_DIFF_RADIANCE_HITDIST]),
            t(p[RT.IN_SPEC_RADIANCE_HITDIST]))
        close("hit_dist_for_tracking", hdt, j["pre_hdt"])
        want = (j["pre_diff"], j["pre_spec"])
    else:
        src = ((j["hf_diff"][0], j["hf_spec"][0]) if stage == "blur"
               else (j["blur_diff"], j["blur_spec"]))
        d, s, _ = TK.fused_spatial_filter(
            ctx["sc"], ctx["dc"], STAGES[stage], geom, vz, dec, t(src[0]), t(src[1]),
            data1_diff=t(j["ta"]["data1_diff"]), data1_spec=t(j["ta"]["data1_spec"]),
            tap_geometry=k_hf.tap_geometry_ref(dec, vz, float(ctx["sc"]["view_z_scale"]),
                                               decoded=True))
        want = (j[f"{stage}_diff"], j[f"{stage}_spec"])
    close(f"{stage} diff", d, want[0])
    close(f"{stage} spec", s, want[1])


def test_band(ctx):
    """K23, both signals, on the decoded plane: what the three-launch chain gives, exactly, and
    the XLA chain within the tolerance."""
    j = ctx["j"]
    vz, _, dec = _planes(ctx)
    geom = TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, dec, ctx["lin"])
    args = _ta_args(ctx)
    kw = dict(anti_firefly=(False, False), perf_mode=False)
    chain = TK.spatial_chain(ctx["sc"], ctx["dc"], geom, vz, dec, args["diff"], args["spec"],
                             **kw)
    band = TK.spatial_band(ctx["sc"], ctx["dc"], geom, vz, dec, args["diff"], args["spec"], **kw)
    for a, b in zip(chain, band):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for k, sig in enumerate(SIGNALS):
        close(f"band {sig}", band[k][0], j[f"post_blur_{sig}"])


def test_temporal_stabilization(ctx):
    """H4's specular half on the decoded plane (`kDec`: the roughness .w, the material 0 against
    the strand material id), and the diffuse half."""
    j, st = ctx["j"], ctx["state"]
    vz, _, dec = _planes(ctx)
    mv = t(ctx["pool"][RT.IN_MV])
    ta = j["ta"]["spec_dict"]
    ts_sm = TK.ts_surface_motion(ctx["sc"], vz, mv)
    spec = TK.temporal_stabilization_specular(
        ctx["sc"], ctx["dc"], vz, dec, mv, t(j["ta"]["data1_spec"]), t(j["fbits"]),
        t(ta["curvature"]), t(ta["virtual_history_amount"]), t(j["post_blur_spec"]),
        st["spec_luma_stab"], t(ta["hit_dist_for_tracking"]), None, ctx["lin"],
        has_prepass=True, surface_motion=ts_sm)
    diff = TK.temporal_stabilization(ctx["sc"], ctx["dc"], vz, dec, mv, t(j["ta"]["data1_diff"]),
                                     t(j["fbits"]), t(j["post_blur_diff"]), st["diff_luma_stab"],
                                     ctx["lin"], surface_motion=ts_sm)
    for sig, got in (("spec", spec), ("diff", diff)):
        close(sig, got[sig], j["ts"][sig])
        close(f"{sig} luma_stab", got[f"{sig}_luma_stab"], j["ts"][f"{sig}_luma_stab"])
        close(f"data1 {sig}", got[f"data1_{sig}"], j["ts"][f"data1_{sig}"])


@pytest.mark.parametrize("case", ["radius1", "radius2", "one_channel"])
def test_hit_dist_reconstruction(ctx, case):
    """K12 on the decoded plane at LINEAR (`kDec`; one channel: the occlusion variants' `kOcc`
    and `kDec` instances), both signals in one launch."""
    vz, _, dec = _planes(ctx)
    holes = {sig: t(ctx["holes"][sig]) for sig in SIGNALS}
    if case == "one_channel":
        holes = {sig: h[..., 3:] for sig, h in holes.items()}
    radius = 2 if case == "radius2" else 1
    want = ctx["j"]["recon_occ" if case == "one_channel" else f"recon{radius}"]
    got = TK.hit_dist_reconstruction(ctx["sc"], ctx["dc"], vz, dec, holes["diff"], holes["spec"],
                                     ctx["lin"], radius=radius)
    for k, sig in enumerate(SIGNALS):
        close(f"{case} {sig}", got[k], want[k])
        assert not torch.equal(got[k], holes[sig]), "nothing was reconstructed"


def test_decoded_planes(ctx):
    """The denoiser's planes: .xyz the unpacked normal, .w the decoded roughness; the packed
    roughness of the first is what `unpack_normal_roughness` decodes."""
    _, nr, dec = _planes(ctx)
    n, r, m = tfe.unpack_normal_roughness(nr, ctx["cfg"].normal_encoding,
                                          ctx["cfg"].roughness_encoding)
    assert torch.equal(dec[..., :3], n) and torch.equal(dec[..., 3], r)
    assert not m.any()
