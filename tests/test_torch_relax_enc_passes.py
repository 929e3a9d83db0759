"""RELAX at the RGBA normal encodings, pass by pass: each pass of RELAX_DIFFUSE_SPECULAR (its
plain CPU path, the kernels' `*_ref` in their decoded-plane modes) against the JAX package's
XLA function, from identical inputs and identical state, at RGBA8_UNORM and at RGBA16_SNORM.

The port's Engine runs frames 0-2 of the orbit scene at 64x48 on the CPU (the JAX Engine only
takes each frame's common settings, so that none of its frames compiles); its state goes to
the JAX side and the JAX Engine's frame-3 constants to the port's (`nrdtpu_torch.interop`).
On frame 3 the JAX side unpacks the packed IN_NORMAL_ROUGHNESS at every read, as the reference
does, and the port's passes read the plane decoded once (`frontend.decode_normal_plane`), each
pass from the JAX chain's own intermediate: the PrePass of each signal, the TA (the head, then
each signal's accumulation), the history fix, the anti-firefly pass, every à-trous stride and
the hit-distance reconstruction of both signals (radius 1 and 2, the hit distance zeroed on a
seeded 30 % of the geometry pixels). RGBA16_SNORM packs the sky's normal as (0, 0, 1)
(`tests/test_torch_relax_enc_slice.py` says why).

Tolerance: rtol=1e-4, atol=1e-5, with the TA allowances of
`tests/test_torch_relax_ds_passes.py` for the reason that file gives, but 8 % (not 5 %) of the
reprojection confidence's values, still none by more than 0.05: at RGBA8_UNORM 5.8 % of them
differ (max |d| 0.0069; RGBA16_SNORM 2.8 %, max 0.011; R10G10B10A2 2.8 %, max 0.011). The
decoded plane is not the cause: the port's TA fed the JAX package's own unpacked normals gives
the same values, and the port's TA moves no value outside the tolerance when every normal moves
by an ulp. The differences are of the size that the same chain gives at R10G10B10A2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JRK
from nrdtpu.passes.relax import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, NormalEncoding as JNE, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import DenoiserConfig, Engine as TEngine
from nrdtpu_torch.passes.reblur import kernels as TRK
from nrdtpu_torch.passes.relax import kernels as TK
from nrdtpu_torch.passes.relax.denoiser import RelaxDenoiser
from nrdtpu_torch.settings import Denoiser, NormalEncoding as NE, ResourceType as RT

from test_torch_relax_ds_passes import (ATROUS_STEPS, BOTH, CONFIDENCE_MAX_ABS,
                                        TA_FLIP_FRACTION, close, t)
from test_torch_relax_enc_slice import SIZE, frames_of

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

VARIANT = "RELAX_DIFFUSE_SPECULAR"
SIGNAL_IN = {"diff": RT.IN_DIFF_RADIANCE_HITDIST, "spec": RT.IN_SPEC_RADIANCE_HITDIST}
HOLE_FRACTION = 0.3
CONFIDENCE_FLIP_FRACTION = 0.08


@pytest.fixture(scope="module", params=["RGBA8_UNORM", "RGBA16_SNORM"])
def ctx(request):
    """Frame 3's inputs (packed and decoded), the constants of both sides and the XLA chain."""
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
    sc = dict(eng._shared_consts())
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    jsc = inst._relax_sc(sc)
    state = {k: interop.tensor_to_numpy(v) for k, v in port.get_state(0).items()}
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    vz, nr = ja[RT.IN_VIEWZ], ja[RT.IN_NORMAL_ROUGHNESS]
    j = {}
    j["pre"] = JK.pre_pass(jsc, dc, ja[RT.IN_DIFF_RADIANCE_HITDIST],
                           ja[RT.IN_SPEC_RADIANCE_HITDIST], vz, nr, cfg, pallas=False)[:2]
    j["ta"] = JK.temporal_accumulation(jsc, dc, vz, nr, ja[RT.IN_MV], *j["pre"], js, cfg,
                                       pallas=False)
    hl = j["ta"]["history_length"]
    j["fix"] = JK.history_fix(jsc, dc, vz, nr, hl, j["ta"]["diff"], j["ta"]["spec"], cfg,
                              pallas=False)[:2]
    j["af"] = JK.anti_firefly(jsc, dc, vz, nr, *j["fix"], cfg)
    cur = tuple(j["ta"][sig] for sig in BOTH)
    j["atrous_in"], j["atrous"] = {}, {}
    for i, step in enumerate(ATROUS_STEPS):
        j["atrous_in"][step] = cur
        res = JK.atrous(jsc, dc, vz, nr, hl, j["ta"]["spec_reprojection_confidence"], *cur, cfg,
                        step_size=step, is_first=i == 0, is_last=i == len(ATROUS_STEPS) - 1,
                        pallas=False)
        cur = (res["diff"], res["spec"])
        j["atrous"][step] = cur
    tcfg = DenoiserConfig(Denoiser[VARIANT], SIZE, SIZE, normal_encoding=NE[encoding])
    hit = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit").frame(3).hit_mask
    return dict(encoding=encoding, pool=pool, hit=hit > 0, jsc=jsc, dc_j=dc, jcfg=cfg,
                cfg=tcfg, sc=RelaxDenoiser._relax_sc(interop.consts_from_numpy(sc)),
                dc=interop.consts_from_numpy(dc), state=interop.state_from_numpy(state),
                nr=tfe.decode_normal_plane(t(pool[RT.IN_NORMAL_ROUGHNESS]), NE[encoding]), j=j)


def _in(ctx, key):
    return t(ctx["pool"][key])


def test_decoded_plane(ctx):
    """The plane the port's passes read: the reference's unpacked normal, the roughness as
    packed."""
    p = ctx["pool"][RT.IN_NORMAL_ROUGHNESS]
    n, _, m = tfe.unpack_normal_roughness(t(p), NE[ctx["encoding"]])
    assert torch.equal(ctx["nr"][..., :3], n) and torch.equal(ctx["nr"][..., 3], t(p[..., 3]))
    assert not m.any()


@pytest.mark.parametrize("sig", BOTH)
def test_pre_pass(ctx, sig):
    got = TK.pre_pass(ctx["sc"], ctx["dc"], _in(ctx, SIGNAL_IN[sig]), _in(ctx, RT.IN_VIEWZ),
                      ctx["nr"], ctx["cfg"], sig)
    close(f"{sig} pre_pass {ctx['encoding']}", got, ctx["j"]["pre"][BOTH.index(sig)])


@pytest.fixture(scope="module")
def ta(ctx):
    return TK.temporal_accumulation_diffuse_specular(
        ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), ctx["nr"], _in(ctx, RT.IN_MV),
        *[t(p) for p in ctx["j"]["pre"]], ctx["state"], ctx["cfg"])


@pytest.mark.parametrize("key", ["history_length", "diff", "diff_fast", "spec", "spec_fast",
                                 "reflection_hit_t", "spec_reprojection_confidence"])
def test_temporal_accumulation(ctx, ta, key):
    """The head (K16 on the decoded plane, no material test), the curvature from the decoded
    normals, the virtual motion (K17) and each signal's accumulation."""
    want = ctx["j"]["ta"][key]
    if key == "spec_reprojection_confidence":
        close(f"TA {key}", ta[key], want, CONFIDENCE_FLIP_FRACTION)
        assert float(np.abs(ta[key].numpy() - np.asarray(want)).max()) <= CONFIDENCE_MAX_ABS
        return
    flips = TA_FLIP_FRACTION if key in ("spec", "spec_fast", "reflection_hit_t") else 0.0
    close(f"TA {key} {ctx['encoding']}", ta[key], want, flips)


def test_history_fix(ctx):
    hl = np.asarray(ctx["j"]["ta"]["history_length"])
    assert (hl <= ctx["dc_j"]["history_fix_frame_num"]).any(), "no short history to fix"
    got = TK.history_fix(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), ctx["nr"], t(hl),
                         tuple(t(ctx["j"]["ta"][sig]) for sig in BOTH), ctx["cfg"], which=BOTH)
    for sig, g, want in zip(BOTH, got, ctx["j"]["fix"]):
        close(f"{sig} history_fix {ctx['encoding']}", g, want)


def test_anti_firefly(ctx):
    got = TK.anti_firefly(ctx["dc"], ctx["nr"], tuple(t(f) for f in ctx["j"]["fix"]), BOTH,
                          ctx["cfg"])
    for sig, g, want in zip(BOTH, got, ctx["j"]["af"]):
        close(f"{sig} anti_firefly {ctx['encoding']}", g, want)


@pytest.mark.parametrize("step", ATROUS_STEPS)
def test_atrous(ctx, step):
    j = ctx["j"]
    got = TK.atrous(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), ctx["nr"],
                    t(j["ta"]["history_length"]), tuple(t(s) for s in j["atrous_in"][step]),
                    ctx["cfg"], step_size=step, is_first=step == ATROUS_STEPS[0], which=BOTH,
                    reprojection_confidence=t(j["ta"]["spec_reprojection_confidence"]))
    for sig, g, want in zip(BOTH, got, j["atrous"][step]):
        close(f"{sig} atrous step {step} {ctx['encoding']}", g, want)


@pytest.mark.parametrize("radius", [1, 2])
def test_hit_dist_reconstruction(ctx, radius):
    """Both signals on RELAX's constants, with the encoding's error constant (RGBA8 1.5 / 255,
    RGBA16 0.5 / 255) and the specular taps' roughness from the decoded plane's .w."""
    c = ctx
    holes = (np.random.default_rng(radius).random(c["hit"].shape) < HOLE_FRACTION) & c["hit"]
    sigs = []
    for sig in BOTH:
        s = c["pool"][SIGNAL_IN[sig]].copy()
        s[..., 3][holes] = 0.0
        sigs.append(s)
    got = TRK.hit_dist_reconstruction(c["sc"], c["dc"], _in(c, RT.IN_VIEWZ), c["nr"],
                                      *[t(s) for s in sigs], c["cfg"], radius=radius)
    want = JRK.hit_dist_reconstruction(c["jsc"], c["dc_j"], jnp.asarray(c["pool"][RT.IN_VIEWZ]),
                                       jnp.asarray(c["pool"][RT.IN_NORMAL_ROUGHNESS]),
                                       *[jnp.asarray(s) for s in sigs], c["jcfg"],
                                       radius=radius, pallas=False)
    for sig, g, w in zip(BOTH, got, want):
        close(f"{sig} hit_dist_reconstruction radius {radius} {c['encoding']}", g, w)
        assert float((g[..., 3][torch.from_numpy(holes)] > 0).float().mean()) > 0.9
