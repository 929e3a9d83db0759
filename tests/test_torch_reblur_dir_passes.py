"""REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION in the PyTorch port, pass by pass: each pass (its plain
CPU path, the kernels' `*_ref` in their directional modes) against the JAX package's XLA
function with `directional=True`, from identical inputs and identical state.

The signal is IN_DIFF_DIRECTION_HITDIST, (direction x normHitDist, normHitDist), packed with the
surface normal as the direction, as `tests/test_reblur_full.py:191-196` packs it, and the
scene's binary AO with a seeded 30 % of the geometry pixels zeroed (`frames_of` of
`tests/test_torch_reblur_dir_slice.py`), so that .w is 0 on many pixels and the hit-distance
reconstruction refills them. The port's Engine runs frames 0-2 at 64x48 with AREA_3X3; its
state goes to the JAX side and the JAX Engine's frame-3 constants to the port's, both with
`nrdtpu_torch.interop`; then both sides run frame 3 pass by pass, each pass from the JAX
chain's own intermediate: the reconstruction (K12's radiance diffuse mode), TA's diffuse half
(H1 and the directional glue: ClampNegativeToZero's .xyz scale, the float4 mix, no firefly
suppressor, the fast history from .w), the history fix (H3's `kDir` clamp: .w the luma, sigma
scale 1, the directional ChangeLuma), Blur and PostBlur (H2's radiance diffuse instances) and
TS's diffuse half (H4's `kDir`: the luma .w). The directional forms of the common helpers and
the front end's pack and unpack are held against the JAX package's on seeded inputs.

Tolerance: rtol=1e-4, atol=1e-5, as `tests/test_torch_ds_passes.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import common as JC
from nrdtpu.passes.reblur import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser
from nrdtpu.settings import HitDistanceReconstructionMode as JHM, replace as jreplace

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.kernels import history_fix_fused as k_hff
from nrdtpu_torch.passes.reblur import common as TC
from nrdtpu_torch.passes.reblur import kernels as TK
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM
from nrdtpu_torch.settings import ResourceType as RT, replace

from test_torch_reblur_dir_slice import DO, SIZE, frames_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STAGES = {"blur": JK.BLUR, "post_blur": JK.POST_BLUR}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


@pytest.fixture(scope="module")
def ctx():
    """The port runs frames 0-2 with AREA_3X3 (the JAX Engine only takes each frame's common
    settings); returns frame 3's inputs, both sides' constants and state, and the XLA chain."""
    frames = list(frames_of(4, holes=True))
    eng = JEngine({0: JDenoiser[DO]}, resource_size=SIZE)
    eng.set_denoiser_settings(0, jreplace(eng._settings[0],
                                          hitDistanceReconstructionMode=JHM.AREA_3X3))
    port = TEngine({0: Denoiser[DO]}, resource_size=SIZE, device="cpu")
    port.set_denoiser_settings(0, replace(port._settings[0],
                                          hitDistanceReconstructionMode=HM.AREA_3X3))
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
    sig_in = jnp.asarray(pool[RT.IN_DIFF_DIRECTION_HITDIST])
    j = {"recon": {1: JK.hit_dist_reconstruction(sc, dc, vz, nr, sig_in, None, cfg,
                                                 radius=1)[0]}}
    sig = j["recon"][1]
    prev_internal = {k: js[k] for k in ("diff_accum", "spec_accum", "material_id")}
    sm = JK.surface_motion_reprojection(sc, dc, vz, nr, mv, js["prev_view_z"],
                                        js["prev_normal_roughness"], prev_internal, cfg)
    d1, df1, data1, _ = JK.temporal_accumulation_diffuse(
        sc, dc, sm, sig, js["diff_history"], js["diff_fast_history"], cfg, occlusion=False,
        directional=True)
    j["ta"] = dict(diff=d1, diff_fast=df1, data1=data1)
    j["hf"] = JK.history_fix(sc, dc, vz, nr, data1, js["spec_accum"], d1, df1, cfg,
                             is_diffuse=True, occlusion=False, directional=True)
    src = j["hf"][0]
    for stage, mode in STAGES.items():
        src = j[stage] = JK.diffuse_spatial_filter(sc, dc, mode, src, vz, nr, data1, cfg,
                                                   occlusion=False, directional=True)[0]
    j["ts"] = JK.temporal_stabilization(
        sc, dc, vz, nr, mv, data1, js["spec_accum"], sm["fbits"], jnp.zeros_like(vz),
        jnp.zeros_like(vz), src, None, js["diff_luma_stab"], None, None, None, cfg,
        has_diffuse=True, has_specular=False, has_prepass=False, directional=True)
    j["fbits"] = sm["fbits"]
    return dict(sc=interop.consts_from_numpy(sc), dc=interop.consts_from_numpy(dc), cfg=cfg,
                state=state, pool=pool, j=j)


def _planes(ctx):
    p = ctx["pool"]
    return t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS])


def _sm(ctx):
    p, st = ctx["pool"], ctx["state"]
    prev_internal = {k: st[k] for k in ("diff_accum", "spec_accum", "material_id")}
    return TK.surface_motion_reprojection(
        ctx["sc"], ctx["dc"], t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS]), t(p[RT.IN_MV]),
        st["prev_view_z"], st["prev_normal_roughness"], prev_internal, ctx["cfg"],
        {"diff": (st["diff_history"], st["diff_fast_history"])})


@pytest.mark.parametrize("radius", [1])
def test_hit_dist_reconstruction(ctx, radius):
    """K12's radiance diffuse mode on the directional signal, at the slice's AREA_3X3: .w
    refilled where it is 0, .xyz copied. (At radius 2 one pixel of this frame differs by 0.2 %:
    its taps' weights sum below NRD_EPS, so its result is their sum over 1e-6, and their plane
    weights sit on the ramp's cancelling end; JAX jitted and op by op differ there too.
    ROADMAP.md Queue 3.)"""
    vz, nr = _planes(ctx)
    sig = t(ctx["pool"][RT.IN_DIFF_DIRECTION_HITDIST])
    assert float((sig[..., 3] == 0).float().mean()) > 0.2
    d, s = TK.hit_dist_reconstruction(ctx["sc"], ctx["dc"], vz, nr, sig, None, ctx["cfg"],
                                      radius=radius)
    assert s is None
    close("diff", d, ctx["j"]["recon"][radius])


def test_temporal_accumulation(ctx):
    """TA's diffuse half with `directional`: the history's .xyz scaled with its saturated .w,
    the float4 mix, no firefly suppressor, the fast history from the input's .w."""
    jt = ctx["j"]["ta"]
    d, dfast, data1 = TK.temporal_accumulation_diffuse(
        ctx["sc"], ctx["dc"], _sm(ctx), t(ctx["j"]["recon"][1]), directional=True)
    close("diff", d, jt["diff"])
    close("diff fast", dfast, jt["diff_fast"])
    close("data1", data1, jt["data1"])


def test_history_fix(ctx):
    """H3's `kDir` clamp: .w the luma with sigma scale 1, ChangeLuma scaling .xyz by the luma
    change of .w and setting .w, on the radiance taps; its tap-geometry plane as for
    REBLUR_DIFFUSE."""
    vz, nr = _planes(ctx)
    jt = ctx["j"]["ta"]
    out, fast, plane = TK.history_fix(ctx["sc"], ctx["dc"], vz, nr, t(jt["data1"]),
                                      t(jt["diff"]), t(jt["diff_fast"]), ctx["cfg"],
                                      directional=True)
    close("signal", out, ctx["j"]["hf"][0])
    close("fast", fast, ctx["j"]["hf"][1])
    assert torch.equal(plane, k_hff.tap_geometry_ref(nr, vz, float(ctx["sc"]["view_z_scale"])))


@pytest.mark.parametrize("stage", list(STAGES))
def test_spatial_filter(ctx, stage):
    """Blur and PostBlur: H2's radiance diffuse instances serve the directional signal (XLA's
    `diffuse_spatial_filter` takes `directional` and never reads it)."""
    j = ctx["j"]
    vz, nr = _planes(ctx)
    src = t(j["hf"][0] if stage == "blur" else j["blur"])
    plane = k_hff.tap_geometry_ref(nr, vz, float(ctx["sc"]["view_z_scale"]))
    got = TK.diffuse_spatial_filter(ctx["sc"], ctx["dc"], STAGES[stage], src, vz, nr,
                                    t(j["ta"]["data1"]), ctx["cfg"], tap_geometry=plane)
    close(stage, got, j[stage])


def test_temporal_stabilization(ctx):
    """TS's diffuse half with `directional` (H4's `kDir`): the luma moments and the luma
    history on .w, the directional ChangeLuma."""
    j, p, st = ctx["j"], ctx["pool"], ctx["state"]
    vz, nr = _planes(ctx)
    ts = TK.temporal_stabilization(ctx["sc"], ctx["dc"], vz, nr, t(p[RT.IN_MV]),
                                   t(j["ta"]["data1"]), t(j["fbits"]), t(j["post_blur"]),
                                   st["diff_luma_stab"], ctx["cfg"], directional=True)
    close("diff", ts["diff"], j["ts"]["diff"])
    close("luma_stab", ts["diff_luma_stab"], j["ts"]["diff_luma_stab"])
    close("data1", ts["data1_diff"], j["ts"]["data1_diff"])


def test_common_directional_forms():
    """The directional forms of the common helpers against the JAX package's, on seeded (h, w,
    4) signals whose .w reaches 0, 1 and beyond: luma, ChangeLuma, ClampNegativeToZero."""
    rng = np.random.default_rng(43)
    shape = (12, 10)
    sig = rng.uniform(-0.2, 1.2, shape + (4,)).astype(np.float32)
    sig[::3, ::2, 3] = 0.0
    luma = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    close("luma", TC.get_luma(t(sig), directional=True), JC.get_luma(jnp.asarray(sig), True))
    close("change", TC.change_luma(t(sig), t(luma), directional=True),
          JC.change_luma(jnp.asarray(sig), jnp.asarray(luma), False, True))
    close("clamp", TC.clamp_negative_to_zero(t(sig), directional=True),
          JC.clamp_negative_to_zero(jnp.asarray(sig), False, True))


def test_frontend_pack_unpack():
    """`reblur_pack_directional_occlusion` (with its sanitizing of NaN and out-of-range values)
    and `reblur_unpack_directional_occlusion` against the JAX package's."""
    rng = np.random.default_rng(44)
    shape = (9, 7)
    direction = rng.uniform(-1.5, 1.5, shape + (3,)).astype(np.float32)
    hit = rng.uniform(-0.5, 1.5, shape).astype(np.float32)
    direction[0, 0, 1] = np.nan
    hit[1, 1] = np.inf
    got = tfe.reblur_pack_directional_occlusion(t(direction), t(hit))
    want = jfe.reblur_pack_directional_occlusion(jnp.asarray(direction), jnp.asarray(hit))
    close("pack", got, want)
    data = rng.uniform(0.0, 1.0, shape + (4,)).astype(np.float32)
    sg, jsg = (tfe.reblur_unpack_directional_occlusion(t(data)),
               jfe.reblur_unpack_directional_occlusion(jnp.asarray(data)))
    for name in jsg._fields:
        close(f"unpack {name}", getattr(sg, name), getattr(jsg, name))
