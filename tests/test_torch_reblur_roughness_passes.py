"""REBLUR's passes that read the roughness, at the three roughness encodings: each pass of the
PyTorch port (its plain CPU path) against the JAX package's XLA function when
IN_NORMAL_ROUGHNESS packs its roughness as LINEAR, SQRT_LINEAR or SQ_LINEAR.

The reference decodes the roughness at each read (`unpack_nr`), except the centre pixel of
HistoryFix, PrePass, Blur and PostBlur, which it reads as packed (`unpack_nr3`,
`nrdtpu/passes/reblur/kernels.py:37-42`). The port decodes IN_NORMAL_ROUGHNESS and the previous
frame's copy once a frame (`frontend.decode_roughness_plane`); these tests call each pass as
`nrdtpu_torch/passes/reblur/denoiser.py` does: the decoded planes at LINEAR for the specular
TA (N1, N2, N3) and TS (H4), the packed plane for the filters' centre geometry with the decoded
one for their taps (H3, N4, N5, K23), and the packed plane with the encoding for H2, which
decodes at its taps (its `kRough` instances).

The port's Engine runs REBLUR_DIFFUSE_SPECULAR over frames 0-2 of the orbit scene at 64x48 at
the encoding; its state goes to the JAX side and the JAX Engine's frame-3 constants to the
port's (`nrdtpu_torch.interop`); then both sides run frame 3 pass by pass, each from the JAX
chain's own intermediate.

Tolerance: rtol=1e-4, atol=1e-5, as `tests/test_torch_ds_passes.py`, with the allowance of
`tests/test_torch_reblur_occ_passes.py` for the specular TA (at most 1e-3 of the values outside
the tolerance: the curvature is a quotient of nearly equal normals).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, RoughnessEncoding as JRE
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.kernels import history_fix_fused as k_hff
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, RoughnessEncoding as RE
from nrdtpu_torch.settings import replace

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
RTOL, ATOL = 1e-4, 1e-5
TA_FLIP_FRACTION = 1e-3
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
ENCODINGS = ("LINEAR", "SQRT_LINEAR", "SQ_LINEAR")
STAGES = {"prepass": JK.PRE_BLUR, "blur": JK.BLUR, "post_blur": JK.POST_BLUR}


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


def pool_of(gen, fd, encoding):
    """REBLUR_DIFFUSE_SPECULAR's inputs, IN_NORMAL_ROUGHNESS packed with the encoding (the
    specular hit distance normalized with the linear roughness, as a renderer does)."""
    vz = jnp.asarray(fd.view_z)
    dn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist), vz, jnp.asarray(HDP), 1.0)
    sn = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.spec_hit_dist), vz, jnp.asarray(HDP),
                                      jnp.asarray(fd.roughness))
    return {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
            RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd, re_=JRE[encoding]),
            RT.IN_DIFF_RADIANCE_HITDIST: np.asarray(
                jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), dn)),
            RT.IN_SPEC_RADIANCE_HITDIST: np.asarray(
                jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.spec_noisy), sn))}


@pytest.fixture(scope="module", params=ENCODINGS)
def ctx(request):
    """The port runs frames 0-2 at the encoding; returns frame 3's inputs, both sides'
    constants and state, and the XLA chain (per signal, as the reference runs off the TPU)."""
    encoding = request.param
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=SIZE,
                  roughness_encoding=JRE[encoding])
    port = TEngine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=SIZE,
                   roughness_encoding=RE[encoding], device="cpu")
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = pool_of(gen, fd, encoding)
        eng.set_common_settings(fd.common_settings)
        if i < 3:
            port.set_common_settings(fd.common_settings)
            port.denoise([0], pool)
    inst = eng._instances[0]
    cfg = inst.config
    sc = eng._shared_consts()
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    state = {k: v.clone() for k, v in port.get_state(0).items()}
    js = {k: jnp.asarray(interop.tensor_to_numpy(v)).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32) for k, v in state.items()}
    vz, nr, mv = (jnp.asarray(pool[k]) for k in (RT.IN_VIEWZ, RT.IN_NORMAL_ROUGHNESS, RT.IN_MV))
    diff_in = jnp.asarray(pool[RT.IN_DIFF_RADIANCE_HITDIST])
    spec_in = jnp.asarray(pool[RT.IN_SPEC_RADIANCE_HITDIST])
    j = {}
    j["pre_diff"], _ = JK.diffuse_pre_pass(sc, dc, diff_in, vz, nr, cfg)
    j["pre_spec"], _, j["pre_hdt"] = JK.specular_spatial_filter(
        sc, dc, JK.PRE_BLUR, spec_in, vz, nr, None, cfg, occlusion=False)
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
    pcfg = port._instances[0].config
    return dict(encoding=encoding, sc=interop.consts_from_numpy(sc),
                dc=interop.consts_from_numpy(dc), cfg=pcfg,
                lin=replace(pcfg, roughness_encoding=RE.LINEAR), state=state, pool=pool, j=j)


def _planes(ctx):
    """viewZ, IN_NORMAL_ROUGHNESS as packed, and its decoded copy (the denoiser's `nr`)."""
    p = ctx["pool"]
    nr = t(p[RT.IN_NORMAL_ROUGHNESS])
    return t(p[RT.IN_VIEWZ]), nr, tfe.decode_roughness_plane(nr, ctx["cfg"].roughness_encoding)


def _prev(ctx):
    st = ctx["state"]
    return tfe.decode_roughness_plane(st["prev_normal_roughness"], ctx["cfg"].roughness_encoding)


def test_decoded_plane(ctx):
    """The decoded copy: .z as `unpack_normal_roughness` decodes it, the rest as packed, the
    plane itself at LINEAR."""
    _, nr, dec = _planes(ctx)
    _, r, _ = tfe.unpack_normal_roughness(nr, roughness_encoding=ctx["cfg"].roughness_encoding)
    assert torch.equal(dec[..., 2], r)
    assert torch.equal(dec[..., (0, 1, 3)], nr[..., (0, 1, 3)])
    assert (dec is nr) == (ctx["encoding"] == "LINEAR")


def test_specular_temporal_accumulation(ctx):
    """The specular TA on the decoded planes (N1's roughness moments, N2's previous roughness,
    N3's roughness confidence) at LINEAR."""
    j, st = ctx["j"], ctx["state"]
    vz, _, nr = _planes(ctx)
    prev_nr = _prev(ctx)
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = TK.surface_motion_reprojection(
        ctx["sc"], ctx["dc"], vz, nr, t(ctx["pool"][RT.IN_MV]), st["prev_view_z"], prev_nr,
        prev_internal, ctx["lin"], {sig: (st[f"{sig}_history"], st[f"{sig}_fast_history"])
                                    for sig in ("diff", "spec")})
    ta = TK.temporal_accumulation_specular(
        ctx["sc"], ctx["dc"], sm, t(j["pre_spec"]), st["spec_history"], st["spec_fast_history"],
        vz, nr, st["prev_view_z"], prev_nr, prev_internal, t(j["pre_hdt"]),
        st["prev_spec_hitdist_for_tracking"], ctx["lin"], has_prepass_hitdist=True)
    for key in ("spec", "fast", "accum_speed", "hit_dist_for_tracking", "curvature",
                "virtual_history_amount"):
        close(key, ta[key], j["ta"]["spec_dict"][key], TA_FLIP_FRACTION)


@pytest.mark.parametrize("stage", list(STAGES))
def test_specular_spatial_filter(ctx, stage):
    """H2's specular filter on the packed plane with the encoding: the centre as packed, the
    taps decoded (`kRough`)."""
    j = ctx["j"]
    vz, nr, dec = _planes(ctx)
    if stage == "prepass":
        got, hdt = TK.specular_spatial_filter(ctx["sc"], ctx["dc"], TK.PRE_BLUR,
                                              t(ctx["pool"][RT.IN_SPEC_RADIANCE_HITDIST]), vz,
                                              nr, None, ctx["cfg"])
        close("hit_dist_for_tracking", hdt, j["pre_hdt"])
        close("prepass", got, j["pre_spec"])
        return
    src = j["hf_spec"][0] if stage == "blur" else j["blur_spec"]
    got, _ = TK.specular_spatial_filter(
        ctx["sc"], ctx["dc"], STAGES[stage], t(src), vz, nr, t(j["ta"]["data1_spec"]),
        ctx["cfg"], tap_geometry=k_hff.tap_geometry_ref(dec, vz, float(ctx["sc"]["view_z_scale"])))
    close(stage, got, j[f"{stage}_spec"])


def test_history_fix(ctx):
    """H3's specular history fix: the centre's geometry from the packed plane, the taps on the
    decoded one."""
    j, ta = ctx["j"], ctx["j"]["ta"]
    vz, nr, dec = _planes(ctx)
    out, fast, _ = TK.history_fix(ctx["sc"], ctx["dc"], vz, nr, t(ta["data1_spec"]),
                                  t(ta["spec"]), t(ta["spec_fast"]), ctx["cfg"],
                                  is_diffuse=False, tap_normal_roughness=dec)
    close("signal", out, j["hf_spec"][0])
    close("fast", fast, j["hf_spec"][1])


def _ta_args(ctx):
    ta = ctx["j"]["ta"]
    return {sig: (t(ta[sig]), t(ta[f"data1_{sig}"]), t(ta[f"{sig}_fast"]))
            for sig in ("diff", "spec")}


def test_fused_history_fix(ctx):
    """N5, both signals: the centre's geometry from the packed plane, the taps decoded."""
    j = ctx["j"]
    vz, nr, dec = _planes(ctx)
    geom = TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, nr, ctx["cfg"])
    args = _ta_args(ctx)
    (d, df), (s, sf), _ = TK.fused_history_fix(ctx["sc"], ctx["dc"], geom, vz, nr, args["diff"],
                                               args["spec"], tap_normal_roughness=dec)
    for name, got, want in (("diff", d, j["hf_diff"][0]), ("diff fast", df, j["hf_diff"][1]),
                            ("spec", s, j["hf_spec"][0]), ("spec fast", sf, j["hf_spec"][1])):
        close(name, got, want)


@pytest.mark.parametrize("stage", list(STAGES))
def test_fused_spatial_filter(ctx, stage):
    """N4, both signals, each stage: the parameters from the packed plane, the taps decoded."""
    j = ctx["j"]
    vz, nr, dec = _planes(ctx)
    geom = TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, nr, ctx["cfg"])
    p = ctx["pool"]
    if stage == "prepass":
        d, s, hdt = TK.fused_spatial_filter(
            ctx["sc"], ctx["dc"], TK.PRE_BLUR, geom, vz, nr, t(p[RT.IN_DIFF_RADIANCE_HITDIST]),
            t(p[RT.IN_SPEC_RADIANCE_HITDIST]), tap_normal_roughness=dec)
        close("hit_dist_for_tracking", hdt, j["pre_hdt"])
        want = (j["pre_diff"], j["pre_spec"])
    else:
        src = ((j["hf_diff"][0], j["hf_spec"][0]) if stage == "blur"
               else (j["blur_diff"], j["blur_spec"]))
        d, s, _ = TK.fused_spatial_filter(
            ctx["sc"], ctx["dc"], STAGES[stage], geom, vz, nr, t(src[0]), t(src[1]),
            data1_diff=t(j["ta"]["data1_diff"]), data1_spec=t(j["ta"]["data1_spec"]),
            tap_geometry=k_hff.tap_geometry_ref(dec, vz, float(ctx["sc"]["view_z_scale"])),
            tap_normal_roughness=dec)
        want = (j[f"{stage}_diff"], j[f"{stage}_spec"])
    close(f"{stage} diff", d, want[0])
    close(f"{stage} spec", s, want[1])


def test_band(ctx):
    """K23, both signals: what the three-launch chain gives, exactly, and the XLA chain within
    the tolerance; the centre from the packed plane, the taps decoded."""
    j = ctx["j"]
    vz, nr, dec = _planes(ctx)
    geom = TK.make_filter_geometry(ctx["sc"], ctx["dc"], vz, nr, ctx["cfg"])
    args = _ta_args(ctx)
    kw = dict(anti_firefly=(False, False), perf_mode=False, tap_normal_roughness=dec)
    chain = TK.spatial_chain(ctx["sc"], ctx["dc"], geom, vz, nr, args["diff"], args["spec"], **kw)
    band = TK.spatial_band(ctx["sc"], ctx["dc"], geom, vz, nr, args["diff"], args["spec"], **kw)
    for a, b in zip(chain, band):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for k, sig in enumerate(("diff", "spec")):
        close(f"band {sig}", band[k][0], j[f"post_blur_{sig}"])


def test_temporal_stabilization(ctx):
    """H4's specular half on the decoded plane (its roughness feeds the responsive factor and
    the magic curve) at LINEAR, and the diffuse half."""
    j, st = ctx["j"], ctx["state"]
    vz, _, nr = _planes(ctx)
    mv = t(ctx["pool"][RT.IN_MV])
    ta = j["ta"]["spec_dict"]
    ts_sm = TK.ts_surface_motion(ctx["sc"], vz, mv)
    spec = TK.temporal_stabilization_specular(
        ctx["sc"], ctx["dc"], vz, nr, mv, t(j["ta"]["data1_spec"]), t(j["fbits"]),
        t(ta["curvature"]), t(ta["virtual_history_amount"]), t(j["post_blur_spec"]),
        st["spec_luma_stab"], t(ta["hit_dist_for_tracking"]), None, ctx["lin"],
        has_prepass=True, surface_motion=ts_sm)
    diff = TK.temporal_stabilization(ctx["sc"], ctx["dc"], vz, nr, mv, t(j["ta"]["data1_diff"]),
                                     t(j["fbits"]), t(j["post_blur_diff"]), st["diff_luma_stab"],
                                     ctx["lin"], surface_motion=ts_sm)
    for sig, got in (("spec", spec), ("diff", diff)):
        close(sig, got[sig], j["ts"][sig])
        close(f"{sig} luma_stab", got[f"{sig}_luma_stab"], j["ts"][f"{sig}_luma_stab"])
        close(f"data1 {sig}", got[f"data1_{sig}"], j["ts"][f"data1_{sig}"])
