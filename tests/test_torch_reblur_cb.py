"""REBLUR under checkerboard in the PyTorch port, pass by pass: each checkerboard piece of the
port (its plain CPU path) against the JAX package's XLA function from identical inputs and
identical state, at 64x48 on frame 4 of the orbit scene with the signals at half width (the
has-data pixel of each horizontal pair, as `tests/test_reblur_full.py:244-250` packs them).

The port's Engine runs REBLUR_DIFFUSE_SPECULAR in BLACK for frames 1-3; its state goes to the
JAX side and the JAX Engine's frame-4 constants to the port's (the JAX Engine only takes each
frame's common settings, so that nothing of it compiles). Held: `math.checkerboard` bit for bit
and the has-data plane; `cb_expand`; H2's plain checkerboard PrePass, diffuse and specular,
against `diffuse_pre_pass(cb_mask=)` and `specular_spatial_filter(PRE_BLUR, cb_mask=)`, by
default, with the PrePass radius 0 (which still runs under checkerboard), on a frame whose
fallback fires (`CB_FALLBACK`: a material drawn per pixel, both min materials 0, a 3 px minimum
radius) and, specular, with usePrepassOnlyForSpecularMotionEstimation (every pixel without data
falls back); N4's plain checkerboard PrePass against the two per-signal XLA functions; and the
diffuse and specular TA with the has-data plane.

Tolerance: rtol=1e-4, atol=1e-5, as for the other pass tests; the specular TA on all but 1e-3 of
its pixels, for the reason `tests/test_torch_spec_passes.py` gives.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu import math as jnm
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import common as JC
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import CheckerboardMode as JCB
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import interop
from nrdtpu_torch import math as nm
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.kernels import spatial_filter as k_sf
from nrdtpu_torch.passes.reblur import common as TC
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, replace

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
RTOL, ATOL = 1e-4, 1e-5
FLIP_RATE = 1e-3
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
MODE = CB.BLACK
# the frames whose fallback fires: a 3 px minimum radius takes the taps of a pixel without data
# off its own expanded texel, and with a material drawn per pixel (both min materials 0) every
# tap fails the material test at about a tenth of those pixels
CB_FALLBACK = dict(minBlurRadius=3.0, minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0)
PREPASS_CASES = {"default": {}, "radius_0": None, "fallback": CB_FALLBACK,
                 "prepass_only": dict(usePrepassOnlyForSpecularMotionEstimation=True)}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want, outliers=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    if bad.ndim == 3:
        bad = bad.any(-1)
    assert bad.mean() <= outliers, (f"{name}: {bad.sum()} of {bad.size} pixels differ, max "
                                    f"|d| = {np.abs(got - want).max():.3g}")


def half_width(plane, frame_index, mode):
    """The half-width checkerboard input of a full-width plane: half texel x holds the pixel of
    the pair (2x, 2x + 1) that has data in this frame (`tests/test_reblur_full.py:244-250`)."""
    h, w = plane.shape[:2]
    has = ((np.arange(w)[None, :] + np.arange(h)[:, None] + frame_index) & 1) == int(mode) - 1
    sel = np.where(has[:, ::2], 0, 1) + np.arange(0, w, 2)[None, :]
    return np.ascontiguousarray(plane[np.arange(h)[:, None], sel])


def pool_of(gen, fd, mode=MODE):
    """Both signals' inputs at half width (numpy), by the JAX front end."""
    vz = jnp.asarray(fd.view_z)
    pool = {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv}
    for rt, noisy, hit, rough in (
            (JRT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist, 1.0),
            (JRT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist,
             jnp.asarray(fd.roughness))):
        nhd = jfe.reblur_get_norm_hit_dist(jnp.asarray(hit), vz, jnp.asarray(HDP), rough)
        full = np.asarray(jfe.reblur_pack_radiance_hitdist(jnp.asarray(noisy), nhd))
        pool[rt] = half_width(full, fd.common_settings.frameIndex, mode)
    return pool


def scattered(nr, seed=5):
    """IN_NORMAL_ROUGHNESS with a material 0-3 drawn per pixel (.w is material / 3)."""
    nr = np.array(nr)
    m = np.random.default_rng(seed).integers(0, 4, nr.shape[:2]).astype(np.float32)
    nr[..., 3] = m / np.float32(3.0)
    return nr


@pytest.fixture(scope="module")
def ctx():
    """The port runs frames 1-3; returns frame 4's inputs (full-width expanded signals), the
    JAX constants and settings, the state and the has-data plane."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=SIZE)
    eng.set_denoiser_settings(0, jreplace(eng._settings[0], checkerboardMode=JCB[MODE.name]))
    port = TEngine({0: Denoiser.REBLUR_DIFFUSE_SPECULAR}, resource_size=SIZE, device="cpu")
    port.set_denoiser_settings(0, replace(port._settings[0], checkerboardMode=MODE))
    for i in range(1, 5):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        if i < 4:
            port.set_common_settings(fd.common_settings)
            port.denoise([0], {RT(int(k)): v for k, v in pool_of(gen, fd).items()})
    inst = eng._instances[0]
    sc = eng._shared_consts()
    pool = pool_of(gen, fd)
    w = SIZE[0]
    for rt in (JRT.IN_DIFF_RADIANCE_HITDIST, JRT.IN_SPEC_RADIANCE_HITDIST):
        pool[rt] = np.asarray(JC.cb_expand(jnp.asarray(pool[rt]), w))
    fi = int(sc["frame_index"])
    has_data = ((np.arange(w)[None, :] + np.arange(SIZE[1])[:, None] + fi) & 1) == int(MODE) - 1
    return dict(eng=eng, inst=inst, cfg=inst.config, jsc=sc, sc=interop.consts_from_numpy(sc),
                pool=pool, has_data=has_data, parity=int(MODE) - 1,
                state={k: interop.tensor_to_numpy(v) for k, v in port.get_state(0).items()})


def _dc(ctx, settings):
    """The JAX denoiser constants of frame 4 with `settings` changed (JAX, port)."""
    s = jreplace(ctx["eng"]._settings[0], **settings)
    dc = ctx["inst"].frame_constants(ctx["eng"]._consts, s)
    return dc, interop.consts_from_numpy(dc)


def _case(ctx, case, sig):
    """(settings, normal_roughness) of a PrePass case of a signal."""
    settings = PREPASS_CASES[case]
    if settings is None:  # the signal's PrePass radius 0
        settings = {("diffusePrepassBlurRadius" if sig == "diff"
                     else "specularPrepassBlurRadius"): 0.0}
    nr = ctx["pool"][JRT.IN_NORMAL_ROUGHNESS]
    return settings, scattered(nr) if case == "fallback" else nr


def _fallback_pixels(fn):
    """The pixels of the port's plain PrePass call `fn` that fall back (a NaN resolve marks
    them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k_sf, "cb_neighbor_resolve",
                   lambda signal, *r: torch.full_like(signal, float("nan")))
        out = fn()
    outs = out if isinstance(out, tuple) else (out,)
    return sum(int(torch.isnan(o[..., 0]).sum()) for o in outs if o is not None and o.dim() == 3)


def test_checkerboard_is_bit_exact():
    """`math.checkerboard` and the has-data plane against `nrdtpu/math.py:189` and
    `nrdtpu/passes/reblur/denoiser.py:189-195`, at frame indices up to 2^31 - 1."""
    h, w = 7, 10
    col = jnp.arange(w, dtype=jnp.int32)[None, :] * jnp.ones((h, 1), jnp.int32)
    row = jnp.arange(h, dtype=jnp.int32)[:, None] * jnp.ones((1, w), jnp.int32)
    for fi in (0, 1, 2, 5, 2 ** 31 - 1):
        want = np.asarray(jnm.checkerboard((col, row), fi))
        got = nm.checkerboard(torch.arange(w)[None, :], torch.arange(h)[:, None], fi)
        np.testing.assert_array_equal(got.numpy(), want)
        for mode in (CB.BLACK, CB.WHITE):
            np.testing.assert_array_equal(nm.checkerboard_has_data(h, w, fi, int(mode)).numpy(),
                                          want == np.uint32(int(mode) - 1))


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 4), (6, 4, 4)], ids=["2d", "odd", "even"])
def test_cb_expand(shape):
    """`cb_expand` against `nrdtpu/passes/reblur/common.py:207-212`, at an odd and an even full
    width."""
    x = np.random.default_rng(1).random(shape, dtype=np.float32)
    for w in (2 * shape[1], 2 * shape[1] - 1):
        got = TC.cb_expand(torch.from_numpy(x), w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(JC.cb_expand(jnp.asarray(x), w)))
        assert got.is_contiguous()


@pytest.mark.parametrize("case", ["default", "radius_0", "fallback"])
def test_diffuse_prepass_cb(ctx, case):
    """H2's plain checkerboard PrePass, diffuse, against `diffuse_pre_pass(cb_mask=)`."""
    settings, nr = _case(ctx, case, "diff")
    jdc, dc = _dc(ctx, settings)
    p = ctx["pool"]
    sig, vz = p[JRT.IN_DIFF_RADIANCE_HITDIST], p[JRT.IN_VIEWZ]
    want, _ = JK.diffuse_pre_pass(ctx["jsc"], jdc, jnp.asarray(sig), jnp.asarray(vz),
                                  jnp.asarray(nr), ctx["cfg"],
                                  cb_mask=jnp.asarray(ctx["has_data"], jnp.float32))

    def run():
        return TK.diffuse_pre_pass(ctx["sc"], dc, t(sig), t(vz), t(nr), ctx["cfg"],
                                   cb=ctx["parity"])
    close(f"diffuse PrePass {case}", run(), want)
    if case == "fallback":
        assert _fallback_pixels(run) > 0, "the fallback never fires"


@pytest.mark.parametrize("case", ["default", "radius_0", "fallback", "prepass_only"])
def test_specular_prepass_cb(ctx, case):
    """H2's plain checkerboard PrePass, specular, against `specular_spatial_filter(PRE_BLUR,
    cb_mask=)`, its hitDistForTracking included (from the kernel, not JAX's radius-0 branch)."""
    settings, nr = _case(ctx, case, "spec")
    jdc, dc = _dc(ctx, settings)
    p = ctx["pool"]
    sig, vz = p[JRT.IN_SPEC_RADIANCE_HITDIST], p[JRT.IN_VIEWZ]
    want, _, want_hdt = JK.specular_spatial_filter(
        ctx["jsc"], jdc, JK.PRE_BLUR, jnp.asarray(sig), jnp.asarray(vz), jnp.asarray(nr), None,
        ctx["cfg"], occlusion=False, cb_mask=jnp.asarray(ctx["has_data"], jnp.float32))

    def run():
        return TK.specular_spatial_filter(ctx["sc"], dc, TK.PRE_BLUR, t(sig), t(vz), t(nr), None,
                                          ctx["cfg"], cb=ctx["parity"])
    got, hdt = run()
    close(f"specular PrePass {case}", got, want)
    close(f"specular PrePass {case} hitDistForTracking", hdt, want_hdt)
    fired = _fallback_pixels(run) if case in ("fallback", "prepass_only") else 0
    if case == "fallback":
        assert fired > 0, "the fallback never fires"
    if case == "prepass_only":  # every pixel without data
        assert fired == int((~ctx["has_data"]).sum())


@pytest.mark.parametrize("case", ["default", "fallback"])
def test_fused_prepass_cb(ctx, case):
    """N4's plain checkerboard PrePass (both signals, the parameter planes on the zeroed centre)
    against the two per-signal XLA functions."""
    settings, nr = _case(ctx, case, "diff")
    jdc, dc = _dc(ctx, settings)
    p = ctx["pool"]
    vz = p[JRT.IN_VIEWZ]
    diff, spec = p[JRT.IN_DIFF_RADIANCE_HITDIST], p[JRT.IN_SPEC_RADIANCE_HITDIST]
    mask = jnp.asarray(ctx["has_data"], jnp.float32)
    want_d, _ = JK.diffuse_pre_pass(ctx["jsc"], jdc, jnp.asarray(diff), jnp.asarray(vz),
                                    jnp.asarray(nr), ctx["cfg"], cb_mask=mask)
    want_s, _, want_hdt = JK.specular_spatial_filter(
        ctx["jsc"], jdc, JK.PRE_BLUR, jnp.asarray(spec), jnp.asarray(vz), jnp.asarray(nr), None,
        ctx["cfg"], occlusion=False, cb_mask=mask)

    def run():
        geom = TK.make_filter_geometry(ctx["sc"], dc, t(vz), t(nr), ctx["cfg"])
        return TK.fused_spatial_filter(ctx["sc"], dc, TK.PRE_BLUR, geom, t(vz), t(nr), t(diff),
                                       t(spec), cb=ctx["parity"])
    got_d, got_s, got_hdt = run()
    close(f"fused PrePass {case} diff", got_d, want_d)
    close(f"fused PrePass {case} spec", got_s, want_s)
    close(f"fused PrePass {case} hitDistForTracking", got_hdt, want_hdt)
    if case == "fallback":
        assert _fallback_pixels(lambda: run()[:2]) > 0, "the fallback never fires"


@pytest.fixture(scope="module")
def ta_inputs(ctx):
    """Frame 4's PrePass outputs (XLA), and each side's surface motion."""
    jdc, dc = _dc(ctx, {})
    p = {k: jnp.asarray(v) for k, v in ctx["pool"].items()}
    vz, nr, mv = p[JRT.IN_VIEWZ], p[JRT.IN_NORMAL_ROUGHNESS], p[JRT.IN_MV]
    mask = jnp.asarray(ctx["has_data"], jnp.float32)
    pre_d, _ = JK.diffuse_pre_pass(ctx["jsc"], jdc, p[JRT.IN_DIFF_RADIANCE_HITDIST], vz, nr,
                                   ctx["cfg"], cb_mask=mask)
    pre_s, _, pre_hdt = JK.specular_spatial_filter(
        ctx["jsc"], jdc, JK.PRE_BLUR, p[JRT.IN_SPEC_RADIANCE_HITDIST], vz, nr, None, ctx["cfg"],
        occlusion=False, cb_mask=mask)
    js = {k: jnp.asarray(v) for k, v in ctx["state"].items()}
    jprev = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    jsm = JK.surface_motion_reprojection(ctx["jsc"], jdc, vz, nr, mv, js["prev_view_z"],
                                         js["prev_normal_roughness"], jprev, ctx["cfg"])
    st = interop.state_from_numpy(ctx["state"])
    prev = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = TK.surface_motion_reprojection(
        ctx["sc"], dc, t(vz), t(nr), t(mv), st["prev_view_z"], st["prev_normal_roughness"],
        prev, ctx["cfg"], {sig: (st[f"{sig}_history"], st[f"{sig}_fast_history"])
                           for sig in ("diff", "spec")})
    return dict(jdc=jdc, dc=dc, js=js, jprev=jprev, jsm=jsm, st=st, prev=prev, sm=sm,
                pre_d=pre_d, pre_s=pre_s, pre_hdt=pre_hdt, vz=vz, nr=nr)


def test_ta_diffuse_has_data(ctx, ta_inputs):
    """The diffuse TA with the has-data plane (`kernels.py:459-464`, `:499-503`): the slower
    accumulation of the pixels without data, which moves them on this frame."""
    x = ta_inputs
    has = jnp.asarray(ctx["has_data"])
    want = JK.temporal_accumulation_diffuse(ctx["jsc"], x["jdc"], x["jsm"], x["pre_d"],
                                            x["js"]["diff_history"], x["js"]["diff_fast_history"],
                                            ctx["cfg"], occlusion=False, has_data=has)
    args = (ctx["sc"], x["dc"], x["sm"], t(x["pre_d"]))
    got = TK.temporal_accumulation_diffuse(*args, has_data=torch.from_numpy(ctx["has_data"]))
    for name, g, wv in zip(("diff", "fast", "accum_speed"), got, want):
        close(f"TA {name}", g, wv)
    without = TK.temporal_accumulation_diffuse(*args)
    assert not torch.equal(got[0], without[0]) and not torch.equal(got[1], without[1])


def test_ta_specular_has_data(ctx, ta_inputs):
    """The specular TA with the has-data plane (`kernels.py:1466-1474`, `:1524-1529`)."""
    x = ta_inputs
    cfg, st = ctx["cfg"], x["st"]
    want = JK.temporal_accumulation_specular(
        ctx["jsc"], x["jdc"], x["jsm"], x["pre_s"], x["js"]["spec_history"],
        x["js"]["spec_fast_history"], x["vz"], x["nr"], x["js"]["prev_view_z"],
        x["js"]["prev_normal_roughness"], x["jprev"], x["pre_hdt"],
        x["js"]["prev_spec_hitdist_for_tracking"], cfg, occlusion=False,
        has_prepass_hitdist=True, has_data=jnp.asarray(ctx["has_data"]))

    def run(has_data):
        return TK.temporal_accumulation_specular(
            ctx["sc"], x["dc"], x["sm"], t(x["pre_s"]), st["spec_history"],
            st["spec_fast_history"], t(x["vz"]), t(x["nr"]), st["prev_view_z"],
            st["prev_normal_roughness"], x["prev"], t(x["pre_hdt"]),
            st["prev_spec_hitdist_for_tracking"], cfg, has_prepass_hitdist=True,
            has_data=has_data)
    got = run(torch.from_numpy(ctx["has_data"]))
    for k in ("spec", "fast", "accum_speed", "hit_dist_for_tracking"):
        close(f"TA {k}", got[k], want[k], FLIP_RATE)
    without = run(None)
    assert not torch.equal(got["spec"], without["spec"])
    assert not torch.equal(got["fast"], without["fast"])
