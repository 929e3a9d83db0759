"""The six kernels of the row-sharded slice at a row origin: each pass's plain version (the
kernels' `*_ref` and their glue) on a halo-padded band of rows, at the band's row origin, against
the JAX package's XLA function on the whole frame, cropped to the band.

The JAX Engine runs 3 frames of the orbit scene at 48x64 (REBLUR_DIFFUSE and SIGMA_SHADOW); its
state and the frame-4 constants are carried across with `nrdtpu_torch.interop`, and the XLA
chain of frame 4 runs pass by pass on the whole frame. Each port pass takes a band of 8 rows of
the chain's own intermediate, padded by the denoiser's halo for that pass (`halos`, the rows
beyond the frame edge-replicated) with the previous-frame planes whole, as `Engine(mesh=)` runs
it. The top, middle and bottom bands each lie within the halo of the frame's edge: all are
shorter than the filters' halos (31 to 61 rows for H2, 14 for H3, 33 for K13).

Tolerance: rtol=1e-4, atol=1e-5, that of the passes' whole-frame tests (`test_torch_reblur_
passes.py`, `test_torch_sigma_passes.py`); fbits and allow_catrom must match exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.passes.sigma import kernels as JS
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.passes.sigma import kernels as TS
from nrdtpu_torch.settings import Denoiser

torch.set_num_threads(1)

SIZE = (48, 64)
RTOL, ATOL = 1e-4, 1e-5
BAND = 8
BANDS = {"top": 0, "middle": 24, "bottom": SIZE[1] - BAND}
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


def padded(x, row0, halo):
    """The band's rows of a whole-frame plane with `halo` rows above and below, edge-replicated
    beyond the frame (`parallel.halo_rows`)."""
    x = x if isinstance(x, torch.Tensor) else t(x)
    rows = torch.clamp(torch.arange(row0 - halo, row0 + BAND + halo), 0, x.shape[0] - 1)
    return x.index_select(0, rows).contiguous()


def crop(x, halo):
    return x[halo:halo + BAND]


def rows_of(x, row0):
    return np.asarray(x)[row0:row0 + BAND]


def _reblur_inputs(gen, fd):
    nhd = jfe.reblur_get_norm_hit_dist(jnp.asarray(fd.diff_hit_dist), jnp.asarray(fd.view_z),
                                       jnp.asarray(HDP), 1.0)
    sig = np.asarray(jfe.reblur_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy), nhd))
    return {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv, JRT.IN_DIFF_RADIANCE_HITDIST: sig}


def _sigma_inputs(gen, fd):
    pen = np.asarray(jfe.sigma_pack_penumbra_directional(
        jnp.asarray(fd.dist_to_occluder), gen.spec.light_tan_angular_radius))
    return {JRT.IN_PENUMBRA: pen, JRT.IN_VIEWZ: fd.view_z, JRT.IN_MV: fd.mv,
            JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd)}


def _run_jax(denoiser, inputs):
    """The JAX Engine after frames 0-2; frame 3's constants, state and pool."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: denoiser}, resource_size=SIZE)
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        if i < 3:
            eng.denoise([0], inputs(gen, fd))
    inst = eng._instances[0]
    sc = eng._shared_consts()
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    state = {k: np.asarray(v) for k, v in eng.get_state(0).items()}
    pool = {k: np.asarray(v) for k, v in inputs(gen, fd).items()}
    return inst, sc, dc, state, pool


@pytest.fixture(scope="module")
def reblur():
    inst, sc, dc, state, pool = _run_jax(JDenoiser.REBLUR_DIFFUSE, _reblur_inputs)
    cfg = inst.config
    vz, nr, mv = pool[JRT.IN_VIEWZ], pool[JRT.IN_NORMAL_ROUGHNESS], pool[JRT.IN_MV]
    js = {k: jnp.asarray(v) for k, v in state.items()}
    j = {}
    j["pre"], _ = JK.diffuse_pre_pass(sc, dc, jnp.asarray(pool[JRT.IN_DIFF_RADIANCE_HITDIST]),
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
    tsc, tdc = interop.consts_from_numpy(sc), interop.consts_from_numpy(dc)
    port = TEngine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=SIZE, device="cpu")
    return dict(sc=tsc, dc=tdc, cfg=port._instances[0].config,
                halos=port._instances[0].halos(tdc), state=interop.state_from_numpy(state),
                jstate=state, pool=pool, j=j)


@pytest.fixture(scope="module")
def sigma():
    inst, sc, dc, state, pool = _run_jax(JDenoiser.SIGMA_SHADOW, _sigma_inputs)
    jsc = dict(sc, plane_dist_sensitivity=dc["plane_dist_sensitivity"])
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    kw = dict(translucent=False, channels=1, normal_encoding=inst.config.normal_encoding,
              roughness_encoding=inst.config.roughness_encoding)
    j = {"tiles": JS.smooth_tiles(JS.classify_tiles(jsc, ja[JRT.IN_PENUMBRA],
                                                    ja[JRT.IN_VIEWZ], None))}
    j["blur"] = JS.blur(jsc, dc, ja[JRT.IN_PENUMBRA], None, ja[JRT.IN_VIEWZ],
                        ja[JRT.IN_NORMAL_ROUGHNESS], j["tiles"], first_pass=True, **kw)
    j["post"] = JS.blur(jsc, dc, j["blur"][0], j["blur"][1], ja[JRT.IN_VIEWZ],
                        ja[JRT.IN_NORMAL_ROUGHNESS], j["tiles"], first_pass=False, **kw)
    j["ts"] = JS.temporal_stabilization(
        jsc, dc, ja[JRT.IN_VIEWZ], ja[JRT.IN_MV], j["post"][0], j["post"][1],
        js["shadow_history"], js["prev_view_z"], js["history_len"], j["tiles"], channels=1)
    port = TEngine({0: Denoiser.SIGMA_SHADOW}, resource_size=SIZE, device="cpu")
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc),
                halos=port._instances[0].halos(), state=interop.state_from_numpy(state),
                pool=pool, j=j)


def _geom(ctx, row0, halo):
    p = ctx["pool"]
    return [padded(p[k], row0, halo) for k in (JRT.IN_VIEWZ, JRT.IN_NORMAL_ROUGHNESS, JRT.IN_MV)]


@pytest.mark.parametrize("band", list(BANDS))
def test_smb_resolve_band(reblur, band):
    """H1 with the surface-motion glue on a band, the previous planes whole, then TA."""
    row0, halo, fh = BANDS[band], reblur["halos"]["smb"], SIZE[1]
    vz, nr, mv = _geom(reblur, row0, halo)
    st, j = reblur["state"], reblur["j"]
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = TK.surface_motion_reprojection(
        reblur["sc"], reblur["dc"], vz, nr, mv, st["prev_view_z"], st["prev_normal_roughness"],
        prev_internal, reblur["cfg"], {"diff": (st["diff_history"], st["diff_fast_history"])},
        row0=row0 - halo, frame_h=fh)
    np.testing.assert_array_equal(crop(sm["fbits"], halo).numpy(), rows_of(j["sm"]["fbits"], row0))
    np.testing.assert_array_equal(crop(sm["allow_catrom"], halo).numpy(),
                                  rows_of(j["sm"]["allow_catrom"], row0))
    for k in ("footprint_quality", "diff_accum_speed", "smb_pixel_uv"):
        close(k, crop(sm[k], halo), rows_of(j["sm"][k], row0))
    sm = {k: crop(v, halo) for k, v in sm.items()}
    diff1, fast1, data1 = TK.temporal_accumulation_diffuse(
        reblur["sc"], reblur["dc"], sm, padded(j["pre"], row0, 0))
    close("ta diff", diff1, rows_of(j["ta"][0], row0))
    close("ta fast", fast1, rows_of(j["ta"][1], row0))


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("stage", ["prepass", "blur", "post_blur"])
def test_spatial_filter_band(reblur, stage, band):
    """H2 in each stage on a band; Blur and PostBlur on the band's history-fix tap geometry."""
    row0, fh = BANDS[band], SIZE[1]
    halo = reblur["halos"][stage]
    vz, nr, _ = _geom(reblur, row0, halo)
    j, kw = reblur["j"], dict(row0=row0 - halo, frame_h=fh)
    if stage == "prepass":
        got = TK.diffuse_pre_pass(reblur["sc"], reblur["dc"],
                                  padded(reblur["pool"][JRT.IN_DIFF_RADIANCE_HITDIST], row0, halo),
                                  vz, nr, reblur["cfg"], **kw)
        close(stage, crop(got, halo), rows_of(j["pre"], row0))
        return
    src, want, mode = ((j["hf"][0], j["blur"], TK.BLUR) if stage == "blur"
                       else (j["blur"], j["post"], TK.POST_BLUR))
    from nrdtpu_torch.kernels import history_fix as k_hf

    plane = k_hf.tap_geometry_ref(nr, vz, float(reblur["sc"]["view_z_scale"]))
    got = TK.diffuse_spatial_filter(reblur["sc"], reblur["dc"], mode, padded(src, row0, halo), vz,
                                    nr, padded(j["ta"][2], row0, halo), reblur["cfg"],
                                    tap_geometry=plane, **kw)
    close(stage, crop(got, halo), rows_of(want, row0))


@pytest.mark.parametrize("band", list(BANDS))
def test_history_fix_band(reblur, band):
    """H3 with the fast-history clamp glue on a band."""
    row0, halo, fh = BANDS[band], reblur["halos"]["history_fix"], SIZE[1]
    vz, nr, _ = _geom(reblur, row0, halo)
    diff1, fast1, data1, _ = reblur["j"]["ta"]
    sig, fast, _ = TK.history_fix(reblur["sc"], reblur["dc"], vz, nr, padded(data1, row0, halo),
                                  padded(diff1, row0, halo), padded(fast1, row0, halo),
                                  reblur["cfg"], row0=row0 - halo, frame_h=fh)
    close("history fix signal", crop(sig, halo), rows_of(reblur["j"]["hf"][0], row0))
    close("history fix fast", crop(fast, halo), rows_of(reblur["j"]["hf"][1], row0))


@pytest.mark.parametrize("band", list(BANDS))
def test_ts_prelude_band(reblur, band):
    """H4 (the diffuse TS half) on a band, its reprojection at the band's rows, the previous
    luma whole."""
    row0, halo, fh = BANDS[band], reblur["halos"]["ts"], SIZE[1]
    vz, nr, mv = _geom(reblur, row0, halo)
    j = reblur["j"]
    sm = TK.ts_surface_motion(reblur["sc"], vz, mv, row0 - halo, fh)
    got = TK.temporal_stabilization(reblur["sc"], reblur["dc"], vz, nr, mv,
                                    padded(j["ta"][2], row0, halo),
                                    padded(j["sm"]["fbits"], row0, halo),
                                    padded(j["post"], row0, halo),
                                    reblur["state"]["diff_luma_stab"], reblur["cfg"],
                                    surface_motion=sm)
    for k in ("diff", "diff_luma_stab", "data1_diff"):
        close(f"ts {k}", crop(got[k], halo), rows_of(j["ts"][k], row0))


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("stage", ["blur", "post_blur"])
def test_sigma_blur_band(sigma, stage, band):
    """K13 Blur and PostBlur on a band, the tile planes of the band's rows."""
    row0, halo, fh = BANDS[band], sigma["halos"]["blur"], SIZE[1]
    vz, nr, _ = _geom(sigma, row0, halo)
    j, w = sigma["j"], SIZE[0]
    tile = TS.tile_planes(sigma["sc"], t(j["tiles"]), BAND + 2 * halo, w, row0 - halo, fh)
    first = stage == "blur"
    penumbra, shadow = ((sigma["pool"][JRT.IN_PENUMBRA], None) if first else j["blur"])
    got = TS.blur(sigma["sc"], sigma["dc"], padded(penumbra, row0, halo),
                  None if shadow is None else padded(shadow, row0, halo), vz, nr, tile,
                  first_pass=first, row0=row0 - halo, frame_h=fh)
    want = j["blur"] if first else j["post"]
    close(f"{stage} penumbra", crop(got[0], halo), rows_of(want[0], row0))
    close(f"{stage} shadow", crop(got[1], halo), rows_of(want[1], row0))


@pytest.mark.parametrize("band", list(BANDS))
def test_sigma_ts_band(sigma, band):
    """K14 on a band, the previous planes whole (its dead pixels pass their own rows of
    them)."""
    row0, halo, fh = BANDS[band], sigma["halos"]["ts"], SIZE[1]
    vz, _, mv = _geom(sigma, row0, halo)
    j, st, w = sigma["j"], sigma["state"], SIZE[0]
    tile = TS.tile_planes(sigma["sc"], t(j["tiles"]), BAND + 2 * halo, w, row0 - halo, fh)
    got = TS.temporal_stabilization(sigma["sc"], sigma["dc"], vz, mv,
                                    padded(j["post"][0], row0, halo),
                                    padded(j["post"][1], row0, halo), st["shadow_history"],
                                    st["prev_view_z"], st["history_len"], tile,
                                    row0=row0 - halo, frame_h=fh)
    for i, k in enumerate(("shadow", "prev_view_z", "history_len")):
        close(f"ts {k}", crop(got[i], halo), rows_of(j["ts"][i], row0))


def test_state_rows(reblur):
    """`interop.state_rows` gives each of 8 ranks its band of every plane of the JAX Engine's
    state, dtypes kept (the bf16 histories bit for bit): the bands, in rank order, are the
    whole state."""
    n = 8
    whole = reblur["state"]
    bands = [interop.state_rows(reblur["jstate"], r, n) for r in range(n)]
    for k, t in whole.items():
        assert all(b[k].dtype == t.dtype and b[k].shape[0] == SIZE[1] // n for b in bands), k
        assert torch.equal(torch.cat([b[k] for b in bands]), t), k
    with pytest.raises(ValueError, match="rows"):
        interop.state_rows(reblur["jstate"], 0, 5)

