"""RELAX_DIFFUSE_SPECULAR in the PyTorch port, pass by pass with both signals: each pass (its
plain CPU path, the kernels' `*_ref` in their two-signal modes) against the JAX package's XLA
function with both signals, from identical inputs and identical state.

The port's Engine runs 3 frames of the orbit scene at 64x48 on the CPU (its slice is held
against the JAX Engine in `tests/test_torch_relax_ds_slice.py`); its state goes to the JAX side
and the JAX Engine's frame-4 constants to the port's, both with `nrdtpu_torch.interop`, and
both sides run frame 4 pass by pass, each pass from the JAX chain's own intermediate: the TA
(one head for both signals, then each signal's accumulation), the history fix, the history
clamp and the anti-firefly pass of both signals, and the à-trous at strides 1 and 16 (also
with IN_DIFF_CONFIDENCE and IN_SPEC_CONFIDENCE). The inputs are the scene's radiance and raw
hit distance of each signal, packed with `relax_pack_radiance_hitdist`.

Tolerance: rtol=1e-4, atol=1e-5 (the port keeps the XLA op order; what remains is last-bit
differences of atan, exp, log, pow and rsqrt between XLA and PyTorch's CPU kernels). The TA's
specular outputs keep `tests/test_torch_relax_spec_passes.py`'s allowance, for the reason that
file gives (the curvature is a quotient of nearly equal normals): at most 1e-3 of a specular TA
output's values outside the tolerance, and 5 % of the reprojection confidence's, none by more
than 0.05.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.relax import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import DenoiserConfig, Engine as TEngine
from nrdtpu_torch.kernels import relax_clamp_moments as KCM
from nrdtpu_torch.passes.relax import kernels as TK
from nrdtpu_torch.passes.relax.denoiser import RelaxDenoiser
from nrdtpu_torch.settings import Denoiser, ResourceType as RT

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TA_FLIP_FRACTION = 1e-3
CONFIDENCE_FLIP_FRACTION, CONFIDENCE_MAX_ABS = 0.05, 0.05
SIZE = (64, 48)
ATROUS_STEPS = (1, 2, 4, 8, 16)
BOTH = ("diff", "spec")
CONFIDENCE_DRIVEN = dict(confidence_driven_relaxation_multiplier=np.float32(1.0),
                         confidence_driven_luminance_edge_stopping_relaxation=np.float32(1.0),
                         confidence_driven_normal_edge_stopping_relaxation=np.float32(1.0))


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


def pool_of(gen, fd):
    pool = {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv}
    for rt, noisy, hit in ((JRT.IN_DIFF_RADIANCE_HITDIST, fd.diff_noisy, fd.diff_hit_dist),
                           (JRT.IN_SPEC_RADIANCE_HITDIST, fd.spec_noisy, fd.spec_hit_dist)):
        pool[rt] = tfe.relax_pack_radiance_hitdist(torch.from_numpy(noisy),
                                                   torch.from_numpy(hit)).numpy()
    return pool


def _confidence(seed):
    h, w = SIZE[1], SIZE[0]
    rng = np.random.default_rng(seed)
    return np.clip(np.linspace(0.2, 1.0, w, dtype=np.float32)[None, :]
                   + rng.uniform(-0.1, 0.1, (h, w)), 0.0, 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def ctx():
    """The port runs frames 0-2 (the JAX Engine only takes each frame's common settings, so
    that no frame of it compiles); returns frame 3's inputs, the JAX constants, the state and
    the XLA chain of both signals."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.RELAX_DIFFUSE_SPECULAR}, resource_size=SIZE)
    port = TEngine({0: Denoiser.RELAX_DIFFUSE_SPECULAR}, resource_size=SIZE, device="cpu")
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        if i < 3:
            port.set_common_settings(fd.common_settings)
            port.denoise([0], {RT(int(k)): v for k, v in pool_of(gen, fd).items()})
    inst = eng._instances[0]
    cfg = inst.config
    sc = dict(eng._shared_consts())
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    jsc = inst._relax_sc(sc)
    state = {k: interop.tensor_to_numpy(v) for k, v in port.get_state(0).items()}
    pool = pool_of(gen, fd)
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    vz, nr = ja[JRT.IN_VIEWZ], ja[JRT.IN_NORMAL_ROUGHNESS]
    j = {}
    j["pre"] = JK.pre_pass(jsc, dc, ja[JRT.IN_DIFF_RADIANCE_HITDIST],
                           ja[JRT.IN_SPEC_RADIANCE_HITDIST], vz, nr, cfg, pallas=False)[:2]
    j["ta"] = JK.temporal_accumulation(jsc, dc, vz, nr, ja[JRT.IN_MV], *j["pre"], js, cfg,
                                       pallas=False)
    hl = j["ta"]["history_length"]
    j["fix"] = JK.history_fix(jsc, dc, vz, nr, hl, j["ta"]["diff"], j["ta"]["spec"], cfg,
                              pallas=False)[:2]
    fixmask = (hl <= dc["history_fix_frame_num"])[..., None]
    j["resp"] = tuple(
        jnp.where(fixmask, jnp.concatenate([fix[..., :3], j["ta"][f"{sig}_fast"][..., 3:]], -1),
                  j["ta"][f"{sig}_fast"]) for sig, fix in zip(BOTH, j["fix"]))
    j["hc"] = JK.history_clamping(jsc, dc, vz, *j["pre"], j["ta"]["diff"], j["ta"]["spec"],
                                  *j["resp"], hl, cfg, pallas=False)
    j["af"] = JK.anti_firefly(jsc, dc, vz, nr, j["hc"]["diff_slow"], j["hc"]["spec_slow"], cfg)
    cur = (j["hc"]["diff_slow"], j["hc"]["spec_slow"])
    j["atrous_in"] = {}
    for i, step in enumerate(ATROUS_STEPS):
        j["atrous_in"][step] = cur
        res = JK.atrous(jsc, dc, vz, nr, hl, j["ta"]["spec_reprojection_confidence"], *cur, cfg,
                        step_size=step, is_first=i == 0, is_last=i == len(ATROUS_STEPS) - 1,
                        pallas=False)
        cur = (res["diff"], res["spec"])
    tcfg = DenoiserConfig(Denoiser.RELAX_DIFFUSE_SPECULAR, SIZE, SIZE)
    tsc = interop.consts_from_numpy(sc)
    return dict(jsc=jsc, dc_j=dc, cfg=tcfg, jcfg=cfg, pool=pool,
                sc=RelaxDenoiser._relax_sc(tsc), dc=interop.consts_from_numpy(dc),
                state=interop.state_from_numpy(state), j=j)


def _in(ctx, key):
    return t(ctx["pool"][key])


def _j(ctx, key):
    return jnp.asarray(ctx["pool"][key])


@pytest.fixture(scope="module")
def ta(ctx):
    return TK.temporal_accumulation_diffuse_specular(
        ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS),
        _in(ctx, RT.IN_MV), *[t(p) for p in ctx["j"]["pre"]], ctx["state"], ctx["cfg"])


@pytest.mark.parametrize("key", ["history_length", "diff", "diff_fast", "spec", "spec_fast",
                                 "reflection_hit_t", "spec_reprojection_confidence"])
def test_temporal_accumulation(ctx, ta, key):
    """One head for both signals (the footprint and four histories in one `relax_smb_resolve`
    launch), then each signal's accumulation."""
    want = ctx["j"]["ta"][key]
    if key == "spec_reprojection_confidence":
        close(f"TA {key}", ta[key], want, CONFIDENCE_FLIP_FRACTION)
        assert float(np.abs(ta[key].numpy() - np.asarray(want)).max()) <= CONFIDENCE_MAX_ABS
        return
    flips = TA_FLIP_FRACTION if key in ("spec", "spec_fast", "reflection_hit_t") else 0.0
    close(f"TA {key}", ta[key], want, flips)


def test_history_fix(ctx):
    hl = np.asarray(ctx["j"]["ta"]["history_length"])
    assert (hl <= ctx["dc_j"]["history_fix_frame_num"]).any(), "no short history to fix"
    got = TK.history_fix(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                         _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl),
                         (t(ctx["j"]["ta"]["diff"]), t(ctx["j"]["ta"]["spec"])), ctx["cfg"],
                         which=BOTH)
    for sig, g, want, resp in zip(BOTH, got, ctx["j"]["fix"], ctx["j"]["resp"]):
        close(f"{sig} history_fix", g, want)
        r = KCM.responsive_history(t(ctx["j"]["ta"][f"{sig}_fast"]), g, t(hl),
                                   history_fix_frame_num=float(ctx["dc"]["history_fix_frame_num"]))
        close(f"{sig} responsive history after the fix", r, resp)


@pytest.mark.parametrize("key", ["diff_slow", "diff_resp", "spec_slow", "spec_resp"])
def test_history_clamping(ctx, key):
    """Both signals in one clamp, each with its own clamp flag, acceleration and reset."""
    j = ctx["j"]
    got = TK.history_clamping(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                              tuple(t(p) for p in j["pre"]),
                              (t(j["ta"]["diff"]), t(j["ta"]["spec"])),
                              (t(j["ta"]["diff_fast"]), t(j["ta"]["spec_fast"])),
                              tuple(t(f) for f in j["fix"]), t(j["ta"]["history_length"]),
                              which=BOTH)
    close(f"history_clamping {key}", got[key], j["hc"][key])


def test_anti_firefly(ctx):
    got = TK.anti_firefly(ctx["dc"], _in(ctx, RT.IN_NORMAL_ROUGHNESS),
                          (t(ctx["j"]["hc"]["diff_slow"]), t(ctx["j"]["hc"]["spec_slow"])), BOTH)
    for sig, g, want in zip(BOTH, got, ctx["j"]["af"]):
        close(f"{sig} anti_firefly", g, want)


@pytest.mark.parametrize("confidence", [False, True], ids=["default", "confidence"])
@pytest.mark.parametrize("step", (1, 16))
def test_atrous(ctx, step, confidence):
    """Iteration 0 (the prefilter, the 5x5 estimation of short histories) and the jittered 16,
    both signals in one call from the JAX chain's input; also with IN_DIFF_CONFIDENCE and
    IN_SPEC_CONFIDENCE under the confidence-driven settings at 1.0."""
    hl = ctx["j"]["ta"]["history_length"]
    reproj = ctx["j"]["ta"]["spec_reprojection_confidence"]
    confs = (_confidence(step), _confidence(step + 1)) if confidence else (None, None)
    jdc = dict(ctx["dc_j"], **(CONFIDENCE_DRIVEN if confidence else {}))
    signals = ctx["j"]["atrous_in"][step]
    want = JK.atrous(ctx["jsc"], jdc, _j(ctx, JRT.IN_VIEWZ), _j(ctx, JRT.IN_NORMAL_ROUGHNESS), hl,
                     reproj, *signals, ctx["jcfg"], step_size=step, is_first=step == 1,
                     is_last=False,
                     diff_confidence=None if confs[0] is None else jnp.asarray(confs[0]),
                     spec_confidence=None if confs[1] is None else jnp.asarray(confs[1]),
                     pallas=False)
    got = TK.atrous(ctx["sc"], interop.consts_from_numpy(jdc), _in(ctx, RT.IN_VIEWZ),
                    _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl), tuple(t(s) for s in signals),
                    ctx["cfg"], step_size=step, is_first=step == 1, which=BOTH,
                    diff_confidence=None if confs[0] is None else t(confs[0]),
                    spec_confidence=None if confs[1] is None else t(confs[1]),
                    reprojection_confidence=t(reproj))
    for sig, g in zip(BOTH, got):
        close(f"{sig} atrous step {step}", g, want[sig])
