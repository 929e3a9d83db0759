"""RELAX_SPECULAR in the PyTorch port, pass by pass: each specular pass (its plain CPU path,
the kernels' `*_ref`) against the JAX package's XLA function from identical inputs and
identical state, and the new kernel modules' plain versions against the XLA formulas they
replace.

The JAX Engine runs 3 frames of the orbit scene at 72x40 (not a multiple of the 16-pixel
block or tile); its state and the frame-4 constants are carried across with
`nrdtpu_torch.interop`, and both sides run frame 4 pass by pass, each pass from the JAX
chain's own intermediate. The specular input is the scene's radiance and raw hit distance,
packed with `relax_pack_radiance_hitdist`.

Tolerance: rtol=1e-4, atol=1e-5 (the port keeps the XLA op order; what remains is last-bit
differences of atan, exp, log, pow and rsqrt between XLA and PyTorch's CPU kernels). One
exception, the TA: its curvature is a quotient of nearly equal normals, as in REBLUR's
specular TA (`tests/test_torch_spec_passes.py`), and a step function downstream of it (the
`dulf > 1` high-parallax switch, the floor of the high-parallax uv, the look-back's
in-screen test) can flip at a rare pixel, so at most 1e-3 of a TA output's values may lie
outside the tolerance. The TA's spec_reprojection_confidence is held looser still: its
surface-motion term is acos_approx(v . v_prev) with v . v_prev within 1e-3 of 1, where
sqrt(1 - x) has an unbounded slope, divided by a lobe angle of a few milliradians. XLA's
rsqrt and PyTorch's agree on two thirds of float32 inputs only, so v . v_prev differs by up
to 3e-7 at 72x40 and the confidence by up to 0.05 on ~4 % of the pixels: at most 5 % of its
values may lie outside the tolerance, none by more than 0.05. The outputs it feeds (the
accumulated signal, the responsive history, the reflection hitT) keep the 1e-3 bar.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import math as jnm
from nrdtpu.engine import Engine as JEngine
from nrdtpu.ops import resample as jrs
from nrdtpu.passes.relax import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch import math as tnm
from nrdtpu_torch.engine import DenoiserConfig
from nrdtpu_torch.kernels import bilinear_resolve as k_bil
from nrdtpu_torch.kernels import relax_antifirefly as k_af
from nrdtpu_torch.kernels import relax_clamp_moments as KCM
from nrdtpu_torch.kernels import relax_vmb_resolve as k_vmb
from nrdtpu_torch.passes import relax as TC
from nrdtpu_torch.passes.relax import kernels as TK
from nrdtpu_torch.passes.relax.denoiser import RelaxDenoiser
from nrdtpu_torch.settings import Denoiser, ResourceType as RT

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TA_FLIP_FRACTION = 1e-3
CONFIDENCE_FLIP_FRACTION, CONFIDENCE_MAX_ABS = 0.05, 0.05
SIZE = (72, 40)
ATROUS_STEPS = (1, 2, 4, 8, 16)


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


def spec_pool(gen, fd):
    sig = tfe.relax_pack_radiance_hitdist(torch.from_numpy(fd.spec_noisy),
                                          torch.from_numpy(fd.spec_hit_dist)).numpy()
    return {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv, JRT.IN_SPEC_RADIANCE_HITDIST: sig}


def _confidence(seed):
    h, w = SIZE[1], SIZE[0]
    rng = np.random.default_rng(seed)
    return np.clip(np.linspace(0.2, 1.0, w, dtype=np.float32)[None, :]
                   + rng.uniform(-0.1, 0.1, (h, w)), 0.0, 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def ctx():
    """JAX runs frames 0-2; returns frame 3's inputs, constants, state and the XLA chain."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.RELAX_SPECULAR}, resource_size=SIZE)
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        fd.common_settings.splitScreen = 0.3 if i == 3 else 0.0
        eng.set_common_settings(fd.common_settings)
        if i < 3:
            eng.denoise([0], spec_pool(gen, fd))
    inst = eng._instances[0]
    cfg = inst.config
    sc = dict(eng._shared_consts())
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    jsc = inst._relax_sc(sc)
    state = {k: np.asarray(v) for k, v in eng.get_state(0).items()}
    pool = spec_pool(gen, fd)
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    vz, nr, spec = ja[JRT.IN_VIEWZ], ja[JRT.IN_NORMAL_ROUGHNESS], ja[JRT.IN_SPEC_RADIANCE_HITDIST]
    j = {}
    j["pre"] = JK.pre_pass(jsc, dc, None, spec, vz, nr, cfg, pallas=False)[1]
    j["ta"] = JK.temporal_accumulation(jsc, dc, vz, nr, ja[JRT.IN_MV], None, j["pre"], js, cfg,
                                       pallas=False)
    hl = j["ta"]["history_length"]
    j["fix"] = JK.history_fix(jsc, dc, vz, nr, hl, None, j["ta"]["spec"], cfg, pallas=False)[1]
    fixmask = (hl <= dc["history_fix_frame_num"])[..., None]
    j["resp"] = jnp.where(fixmask, jnp.concatenate([j["fix"][..., :3],
                                                    j["ta"]["spec_fast"][..., 3:]], -1),
                          j["ta"]["spec_fast"])
    j["hc"] = JK.history_clamping(jsc, dc, vz, None, j["pre"], None, j["ta"]["spec"], None,
                                  j["resp"], hl, cfg, pallas=False)
    j["af"] = JK.anti_firefly(jsc, dc, vz, nr, None, j["hc"]["spec_slow"], cfg)[1]
    cur = j["hc"]["spec_slow"]
    j["atrous_in"], j["atrous"] = {}, {}
    for i, step in enumerate(ATROUS_STEPS):
        j["atrous_in"][step] = cur
        cur = JK.atrous(jsc, dc, vz, nr, hl, j["ta"]["spec_reprojection_confidence"], None, cur,
                        cfg, step_size=step, is_first=i == 0,
                        is_last=i == len(ATROUS_STEPS) - 1, pallas=False)["spec"]
        j["atrous"][step] = cur
    tcfg = DenoiserConfig(Denoiser.RELAX_SPECULAR, SIZE, SIZE)
    tsc = interop.consts_from_numpy(sc)
    return dict(gen=gen, fd=fd, pool=pool, jsc=jsc, dc_j=dc, cfg=tcfg, jcfg=cfg,
                sc=RelaxDenoiser._relax_sc(tsc), dc=interop.consts_from_numpy(dc),
                jstate=state, state=interop.state_from_numpy(state), j=j)


def _in(ctx, key):
    return t(ctx["pool"][key])


def _j(ctx, key):
    return jnp.asarray(ctx["pool"][key])


def test_pre_pass(ctx):
    got = TK.pre_pass(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_SPEC_RADIANCE_HITDIST),
                      _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS), ctx["cfg"],
                      which="spec")
    close("spec pre_pass", got, ctx["j"]["pre"])


def test_pre_pass_radius_disabled(ctx):
    """specularPrepassBlurRadius = 0: the signal passes through, its hitT clamped."""
    dc = dict(ctx["dc"], spec_blur_radius=0.0)
    got = TK.pre_pass(ctx["sc"], dc, _in(ctx, RT.IN_SPEC_RADIANCE_HITDIST),
                      _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS), ctx["cfg"],
                      which="spec")
    jdc = dict(ctx["dc_j"], spec_blur_radius=np.float32(0.0))
    want = JK.pre_pass(ctx["jsc"], jdc, None, _j(ctx, JRT.IN_SPEC_RADIANCE_HITDIST),
                       _j(ctx, JRT.IN_VIEWZ), _j(ctx, JRT.IN_NORMAL_ROUGHNESS), ctx["jcfg"],
                       pallas=False)[1]
    close("spec pre_pass radius 0", got, want)


@pytest.fixture(scope="module")
def ta(ctx):
    return TK.temporal_accumulation_specular(
        ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS),
        _in(ctx, RT.IN_MV), t(ctx["j"]["pre"]), ctx["state"], ctx["cfg"])


@pytest.mark.parametrize("key", ["history_length", "spec", "spec_fast", "reflection_hit_t",
                                 "spec_reprojection_confidence"])
def test_temporal_accumulation(ctx, ta, key):
    if key != "spec_reprojection_confidence":
        close(f"TA {key}", ta[key], ctx["j"]["ta"][key], TA_FLIP_FRACTION)
        return
    close(f"TA {key}", ta[key], ctx["j"]["ta"][key], CONFIDENCE_FLIP_FRACTION)
    assert float(np.abs(ta[key].numpy() - np.asarray(ctx["j"]["ta"][key])).max()) \
        <= CONFIDENCE_MAX_ABS


def test_history_fix(ctx):
    hl = np.asarray(ctx["j"]["ta"]["history_length"])
    assert (hl <= ctx["dc_j"]["history_fix_frame_num"]).any(), "no short history to fix"
    got = TK.history_fix(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                         _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl), t(ctx["j"]["ta"]["spec"]),
                         ctx["cfg"], which="spec")
    close("spec history_fix", got, ctx["j"]["fix"])
    resp = KCM.responsive_history(t(ctx["j"]["ta"]["spec_fast"]), got, t(hl),
                                  history_fix_frame_num=float(ctx["dc"]["history_fix_frame_num"]))
    close("responsive history after the fix", resp, ctx["j"]["resp"])


@pytest.mark.parametrize("key", ["spec_slow", "spec_resp"])
def test_history_clamping(ctx, key):
    got = TK.history_clamping(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), t(ctx["j"]["pre"]),
                              t(ctx["j"]["ta"]["spec"]), t(ctx["j"]["ta"]["spec_fast"]),
                              t(ctx["j"]["fix"]), t(ctx["j"]["ta"]["history_length"]), which="spec")
    close(f"spec history_clamping {key}", got[key], ctx["j"]["hc"][key])


@pytest.mark.parametrize("clamp", [True, False])
def test_history_clamping_seeded(ctx, clamp):
    """The pass against XLA on seeded inputs at 128x96: histories on both sides of
    historyFixFrameNum, 10 % of the pixels beyond the denoising range, and the colour-box clamp
    on (specularMaxFastAccumulatedFrameNum < specularMaxAccumulatedFrameNum, the default) and off
    (both equal)."""
    rng = np.random.default_rng(7)
    h, w = 96, 128
    far = 2.0 * float(ctx["jsc"]["denoising_range"])
    view_z = rng.uniform(0.5, 40.0, (h, w)).astype(np.float32)
    view_z[rng.random((h, w)) < 0.1] = far
    noisy, slow, fast, fixed = rng.uniform(0.0, 1.0, (4, h, w, 4)).astype(np.float32)
    hl = rng.integers(0, 12, (h, w)).astype(np.float32)
    fix_num = ctx["dc_j"]["history_fix_frame_num"]
    assert (hl <= fix_num).any() and (hl > fix_num).any()
    key = "spec_max_fast_accumulated_frame_num"
    n = ctx["dc_j"][key] if clamp else ctx["dc_j"]["spec_max_accumulated_frame_num"]
    assert (n < ctx["dc_j"]["spec_max_accumulated_frame_num"]) == clamp
    resp = jnp.where(jnp.asarray(hl <= fix_num)[..., None],
                     jnp.concatenate([fixed[..., :3], fast[..., 3:]], -1), fast)
    want = JK.history_clamping(ctx["jsc"], dict(ctx["dc_j"], **{key: n}), jnp.asarray(view_z),
                               None, jnp.asarray(noisy), None, jnp.asarray(slow), None, resp,
                               jnp.asarray(hl), ctx["jcfg"], pallas=False)
    got = TK.history_clamping(ctx["sc"], dict(ctx["dc"], **{key: float(n)}), t(view_z), t(noisy),
                              t(slow), t(fast), t(fixed), t(hl), which="spec")
    for k in ("spec_slow", "spec_resp"):
        close(f"history_clamping clamp={clamp} {k}", got[k], want[k])


def test_anti_firefly(ctx):
    """K21's plain path against the XLA branch (`kernels.py:1302-1326`) on the clamped slow
    history."""
    (got,) = TK.anti_firefly(ctx["dc"], _in(ctx, RT.IN_NORMAL_ROUGHNESS),
                             (t(ctx["j"]["hc"]["spec_slow"]),), ("spec",))
    close("spec anti_firefly", got, ctx["j"]["af"])
    assert not np.array_equal(np.asarray(ctx["j"]["af"]), np.asarray(ctx["j"]["hc"]["spec_slow"]))


# à-trous variants: (roughness edge stopping, the TA's reprojection confidence,
# IN_SPEC_CONFIDENCE with the confidence-driven settings at 1.0)
ATROUS_VARIANTS = {"default": (True, True, False), "no_roughness_stopping": (False, True, False),
                   "no_reprojection": (True, False, False), "spec_confidence": (True, True, True)}


@pytest.mark.parametrize("variant", sorted(ATROUS_VARIANTS))
@pytest.mark.parametrize("step", (1, 2, 16))
def test_atrous(ctx, step, variant):
    """Iteration 0 (the diffuse normal weight for the specular signal, the 5x5 estimation of
    short histories), 2 and the jittered 16, each from the JAX chain's input."""
    roughness_stopping, reprojection, confidence = ATROUS_VARIANTS[variant]
    hl = ctx["j"]["ta"]["history_length"]
    reproj = ctx["j"]["ta"]["spec_reprojection_confidence"] if reprojection else None
    conf = _confidence(step) if confidence else None
    relax = dict(confidence_driven_relaxation_multiplier=np.float32(1.0),
                 confidence_driven_luminance_edge_stopping_relaxation=np.float32(1.0),
                 confidence_driven_normal_edge_stopping_relaxation=np.float32(1.0)) \
        if confidence else {}
    jdc = dict(ctx["dc_j"], roughness_edge_stopping_enabled=np.float32(roughness_stopping),
               **relax)
    dc = interop.consts_from_numpy(jdc)
    signal = ctx["j"]["atrous_in"][step]
    want = JK.atrous(ctx["jsc"], jdc, _j(ctx, JRT.IN_VIEWZ), _j(ctx, JRT.IN_NORMAL_ROUGHNESS), hl,
                     reproj, None, signal, ctx["jcfg"], step_size=step, is_first=step == 1,
                     is_last=False, spec_confidence=None if conf is None else jnp.asarray(conf),
                     pallas=False)["spec"]
    got = TK.atrous(ctx["sc"], dc, _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl),
                    t(signal), ctx["cfg"], step_size=step, is_first=step == 1, which="spec",
                    spec_confidence=None if conf is None else t(conf),
                    reprojection_confidence=None if reproj is None else t(reproj))
    close(f"spec atrous step {step} {variant}", got, want)


def test_atrous_ladder(ctx):
    """The five iterations of the frame, each from the JAX chain's input."""
    hl = t(ctx["j"]["ta"]["history_length"])
    for i, step in enumerate(ATROUS_STEPS):
        got = TK.atrous(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                        _in(ctx, RT.IN_NORMAL_ROUGHNESS), hl, t(ctx["j"]["atrous_in"][step]),
                        ctx["cfg"], step_size=step, is_first=i == 0, which="spec",
                        reprojection_confidence=t(ctx["j"]["ta"]["spec_reprojection_confidence"]))
        close(f"spec atrous step {step}", got, ctx["j"]["atrous"][step])


# --- the new kernel modules' plain versions against the XLA formulas they replace ----------


def test_vmb_resolve_matches_xla_formula(ctx):
    """K17's plain version against `kernels.py:742-796` on the carried state, at virtual-motion
    uvs that wander off the surface-motion ones and off screen."""
    sc, jsc = ctx["sc"], ctx["jsc"]
    h, w = SIZE[1], SIZE[0]
    rng = np.random.default_rng(4)
    uv = np.asarray(jrs.pixel_uv_grid(h, w)) + rng.normal(0.0, 0.02, (h, w, 2)).astype(np.float32)
    uv = uv.astype(np.float32)
    nr = ctx["pool"][JRT.IN_NORMAL_ROUGHNESS]
    vz = np.abs(ctx["pool"][JRT.IN_VIEWZ]) * np.float32(jsc["view_z_scale"])
    n = np.asarray(jnm.normalize(jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32)) * 0.1
                                 + jnp.asarray([0.0, 0.0, -1.0])))
    x = np.asarray(JK.world_pos_from_uv(jsc, jnp.asarray(np.asarray(jrs.pixel_uv_grid(h, w))),
                                        jnp.asarray(vz)))
    xmd = (x - np.asarray(jsc["camera_delta"])[None, None, :]).astype(np.float32)
    thr = (rng.uniform(0.001, 0.05, (h, w)) * vz).astype(np.float32)
    smb_found = rng.integers(0, 3, (h, w)).astype(np.float32)
    st = ctx["jstate"]
    dc = ctx["dc_j"]
    # XLA (`kernels.py:743-790`)
    rect_prev = jnp.asarray(jsc["rect_size_prev"])[None, None, :]
    origin, frac = jnm.bilinear_filter(jnp.asarray(uv), jnp.asarray(jsc["rect_size_prev"]))
    in_screen = jrs.is_in_screen_bilinear(origin, jsc["rect_size_prev"])
    vx0 = origin[..., 0].astype(jnp.int32)
    vy0 = origin[..., 1].astype(jnp.int32)
    valid = []
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        zp = JK.unpack_view_z(jsc, jrs.texel_fetch(jnp.asarray(st["view_z_prev"]), vx0 + dx,
                                                   vy0 + dy))
        tap_uv = (jnp.stack([(vx0 + dx).astype(jnp.float32), (vy0 + dy).astype(jnp.float32)], -1)
                  + 0.5) / rect_prev
        xp = JK.world_pos_from_uv(jsc, tap_uv, zp, prev=True)
        ok = (jnp.abs(jnm.dot(jnp.asarray(xmd) - xp, jnp.asarray(n)))
              <= jnp.asarray(thr) * in_screen[..., k] - 1e-6).astype(jnp.float32)
        mp = jrs.texel_fetch(jnp.asarray(st["material_id_prev"]), vx0 + dx, vy0 + dy)
        ok = ok * (jnp.maximum(jnp.asarray(nr[..., 3] * 3.0), dc["spec_min_material"])
                   == jnp.maximum(mp, dc["spec_min_material"])).astype(jnp.float32)
        valid.append(ok)
    valid4 = jnp.stack(valid, -1)
    cw = jnm.get_bilinear_custom_weights(frac, valid4)
    bicubic = jnp.logical_and(jnp.asarray(smb_found) == 2.0, jnp.all(valid4 > 0.0, -1))
    pos = jnp.asarray(uv) * rect_prev
    res_prev = jnp.asarray(jsc["resolution_scale_prev"])[None, None, :]
    want = dict(
        spec_vmb=jrs.sample_catrom(jnp.asarray(st["spec_illum_prev"]), pos, bicubic, cw),
        spec_vmb_resp=jrs.sample_catrom(jnp.asarray(st["spec_responsive_prev"]), pos, bicubic,
                                        cw),
        hit_t=jrs.sample_bilinear(jnp.asarray(st["reflection_hit_t"]), jnp.asarray(uv) * res_prev),
        nr_packed=jrs.sample_bilinear(jnp.asarray(st["normal_roughness_prev"]),
                                      jnp.asarray(uv) * res_prev),
        any=jnp.any(valid4 > 0.0, -1).astype(jnp.float32),
        all=jnp.all(valid4 > 0.0, -1).astype(jnp.float32))
    got = k_vmb.relax_vmb_resolve_ref(
        t(uv), t(n), t(xmd), t(thr), t(nr), t(smb_found), *[ctx["state"][k] for k in (
            "view_z_prev", "material_id_prev", "reflection_hit_t", "normal_roughness_prev",
            "spec_illum_prev", "spec_responsive_prev")],
        prev_frustum=TC.frustum_consts(sc, prev=True), ortho_mode=float(sc["ortho_mode"]),
        view_z_scale=float(sc["view_z_scale"]), rect_size_prev=TK._v(sc["rect_size_prev"]),
        resolution_scale_prev=TK._v(sc["resolution_scale_prev"]),
        min_material=float(ctx["dc"]["spec_min_material"]))
    assert 0.0 < float(got["all"].mean()) < 1.0 and float(got["any"].mean()) > 0.0
    for key, v in want.items():
        close(f"vmb_resolve {key}", got[key], v)


def test_bilinear_resolve_matches_sample_bilinear(ctx):
    """The look-back sampler's plain version against XLA's sample_bilinear(image,
    uv x resolution_scale_prev), at uvs off screen too."""
    h, w = SIZE[1], SIZE[0]
    rng = np.random.default_rng(6)
    uvs = rng.uniform(-0.1, 1.1, (2, h, w, 2)).astype(np.float32)
    img = ctx["jstate"]["normal_roughness_prev"]
    scale = TK._v(ctx["sc"]["resolution_scale_prev"])
    got = k_bil.bilinear_resolve_ref(t(img), t(uvs), scale=scale)
    for k in range(2):
        want = jrs.sample_bilinear(jnp.asarray(img), jnp.asarray(uvs[k])
                                   * jnp.asarray(ctx["jsc"]["resolution_scale_prev"])[None, None])
        close(f"bilinear_resolve set {k}", got[k], want)


def test_antifirefly_matches_xla_on_two_signals(ctx):
    """K21's plain version on two signals at once against the XLA branch of each."""
    rng = np.random.default_rng(8)
    h, w = SIZE[1], SIZE[0]
    a, b = rng.uniform(0.0, 1.0, (2, h, w, 4)).astype(np.float32)
    a[rng.random((h, w)) < 0.05] = 50.0  # fireflies
    nr = ctx["pool"][JRT.IN_NORMAL_ROUGHNESS]
    got = k_af.relax_antifirefly_ref(t(nr), (t(a), t(b)), min_materials=(
        float(ctx["dc"]["diff_min_material"]), float(ctx["dc"]["spec_min_material"])))
    wd, ws = JK.anti_firefly(ctx["jsc"], ctx["dc_j"], None, jnp.asarray(nr), jnp.asarray(a),
                             jnp.asarray(b), ctx["jcfg"])
    close("anti_firefly diff", got[0], wd)
    close("anti_firefly spec", got[1], ws)


def test_math_helpers_match_jax():
    rng = np.random.default_rng(9)
    o, c = rng.uniform(0.01, 5.0, (2, 16)).astype(np.float32)
    c = c - 2.5
    close("apply_thin_lens_equation", tnm.apply_thin_lens_equation(t(o), t(c)),
          jnm.apply_thin_lens_equation(jnp.asarray(o), jnp.asarray(c)))
    close("rsqrt_safe", tnm.rsqrt_safe(t(o)), jnm.rsqrt_safe(jnp.asarray(o)))
    n = rng.normal(size=(2, 64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    m = rng.uniform(0.05, 0.5, 64).astype(np.float32)
    ca = rng.uniform(0.0, 0.1, 64).astype(np.float32)
    for remap in (False, True):
        close("get_encoding_aware_normal_weight",
              tnm.get_encoding_aware_normal_weight(t(n[0]), t(n[1]), t(m), t(ca), 0.01, remap),
              jnm.get_encoding_aware_normal_weight(jnp.asarray(n[0]), jnp.asarray(n[1]),
                                                   jnp.asarray(m), jnp.asarray(ca), 0.01, remap))
    r, hl, cf = rng.uniform(0.0, 1.0, (3, 64)).astype(np.float32)
    hl = hl * 30.0
    for got, want in zip(TC.get_normal_weight_params_atrous(t(r), t(hl), t(cf), 0.3, 0.5, 0.1),
                         JK.get_normal_weight_params_atrous(jnp.asarray(r), jnp.asarray(hl),
                                                            jnp.asarray(cf), 0.3, 0.5, 0.1)):
        close("get_normal_weight_params_atrous", got, want)
    a0, f0 = JK.get_normal_weight_params_atrous(jnp.asarray(r), jnp.asarray(hl), jnp.asarray(cf),
                                                0.3, 0.5, 0.1)
    close("get_specular_normal_weight_atrous",
          TC.get_specular_normal_weight_atrous(t(a0), t(f0), t(n[0]), t(n[1]), t(n[1]), t(n[0])),
          JK.get_specular_normal_weight_atrous(a0, f0, jnp.asarray(n[0]), jnp.asarray(n[1]),
                                               jnp.asarray(n[1]), jnp.asarray(n[0])))


# --- the HLSL oracles (tests/test_oracle.py:375-502), specular halves -------------------------

from test_torch_relax_passes import (BAR_DB, OH, OR, OW, _oracle_camera,  # noqa: E402
                                     _oracle_scene, psnr)


@pytest.mark.parametrize("step_size", [1, 4, 32])
def test_atrous_matches_oracle(step_size):
    """Iterations >= 1 of the specular signal (RELAX_Atrous.hlsli) with the reprojection
    confidence; 32 exercises the per-pixel jitter."""
    rng = np.random.default_rng(42)
    sc, dc, cfg = _oracle_camera()
    s = _oracle_scene(sc)
    history_length = rng.uniform(0.0, 30.0, (OH, OW)).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (OH, OW)).astype(np.float32)
    diff = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    spec = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    diff[..., 3] = rng.uniform(0.0, 0.2, (OH, OW))
    spec[..., 3] = rng.uniform(0.0, 0.2, (OH, OW))
    ref = OR.atrous(sc, dc, s["view_z"], s["nr"], history_length, conf, diff, spec,
                    step_size=step_size)
    got = TK.atrous(sc, dc, t(s["view_z"]), t(s["nr"]), t(history_length), t(spec), cfg,
                    step_size=step_size, is_first=False, which="spec",
                    reprojection_confidence=t(conf)).numpy()
    assert psnr(ref["spec"][..., :3], got[..., :3]) >= BAR_DB
    assert psnr(ref["spec"][..., 3], got[..., 3]) >= BAR_DB


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_ta_matches_oracle(translate_x):
    """RELAX TemporalAccumulation (RELAX_TemporalAccumulation.hlsli:15-929), specular half."""
    rng = np.random.default_rng(42)
    sc, dc, cfg = _oracle_camera(translate_x)
    s = _oracle_scene(sc)
    s["mv"] = s["mv"] + np.asarray([0.37 / OW, 0.23 / OH, 0.0], np.float32)
    diff = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    spec = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    spec[..., 3] = rng.uniform(0.0, 4.0, (OH, OW))
    prev_nr = TC.pack_prev_normal_roughness(t(s["n"]), t(s["roughness"])).numpy()
    state = {
        "history_length": rng.uniform(0.0, 30.0, (OH, OW)).astype(np.float32),
        "normal_roughness_prev": prev_nr,
        "material_id_prev": np.zeros((OH, OW), np.float32),
        "view_z_prev": (s["view_z"] + rng.uniform(-0.005, 0.005, (OH, OW))).astype(np.float32),
        "diff_illum_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "diff_responsive_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "spec_illum_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "spec_responsive_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "reflection_hit_t": rng.uniform(0.01, 4.0, (OH, OW)).astype(np.float32),
    }
    ref = OR.temporal_accumulation(sc, dc, s["view_z"], s["nr"], s["mv"], diff, spec, state)
    got = TK.temporal_accumulation_specular(sc, dc, t(s["view_z"]), t(s["nr"]), t(s["mv"]),
                                            t(spec), {k: t(v) for k, v in state.items()}, cfg)
    for name in ("history_length", "spec", "spec_fast", "reflection_hit_t",
                 "spec_reprojection_confidence"):
        p = psnr(ref[name], got[name].numpy())
        assert p >= BAR_DB, f"RELAX TA {name}: {p:.1f} dB vs HLSL oracle"


def test_history_clamping_matches_oracle():
    """RELAX HistoryClamping (RELAX_HistoryClamping.hlsli:52-330), specular half."""
    rng = np.random.default_rng(42)
    sc, dc, cfg = _oracle_camera()
    s = _oracle_scene(sc)
    noisy_d, noisy_s, slow_d, slow_s, resp_d, resp_s = rng.uniform(
        0.0, 1.0, (6, OH, OW, 4)).astype(np.float32)
    hl = rng.uniform(0.0, 30.0, (OH, OW)).astype(np.float32)
    ref = OR.history_clamping(sc, dc, s["view_z"], noisy_d, noisy_s, slow_d, slow_s, resp_d,
                              resp_s, hl)
    # the responsive history is resp_s in the fix and out of it
    got = TK.history_clamping(sc, dc, t(s["view_z"]), t(noisy_s), t(slow_s),
                              t(resp_s), t(resp_s), t(hl),
                              which="spec")
    assert psnr(ref["spec"], got["spec_slow"].numpy()) >= BAR_DB
    assert psnr(ref["spec_fast"][..., :3], got["spec_resp"][..., :3].numpy()) >= BAR_DB
