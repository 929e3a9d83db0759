"""The RELAX SH variants in the PyTorch port, pass by pass with the SH planes: each pass (its
plain CPU path, the kernels' `*_ref` in their SH modes) against the JAX package's XLA function
with SH, from identical inputs and identical state.

The port's Engine runs RELAX_DIFFUSE_SPECULAR_SH over 3 frames of the orbit scene at 64x48 on
the CPU (its slice is held against the JAX Engine in `tests/test_torch_relax_sh_slice.py`); its
state, with the four bfloat16 SH histories, goes to the JAX side and the JAX Engine's frame-4
constants to the port's, both with `nrdtpu_torch.interop`, and both sides run frame 4 pass by
pass, each pass from the JAX chain's own intermediate: the PrePass of each signal, the TA (both
signals on one head, and each signal alone), the history fix and the history clamp (both
signals, and each alone), the à-trous at iteration 0, 1 and the last (its YCoCg), of each
signal and of both, and the split screen. The inputs are packed with `relax_pack_sh` from the
scene's radiance and raw hit distance along directions drawn from a seeded numpy generator, so
that SH1 has negative components (a clip at 0 would show).

Tolerance: rtol=1e-4, atol=1e-5, as `tests/test_torch_relax_ds_passes.py`, with its allowance
for the specular TA's outputs (at most 1e-3 of the values outside the tolerance: the curvature
is a quotient of nearly equal normals), which the specular SH shares (its lerps take the same
alphas and virtual amount).
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
from nrdtpu_torch.passes.relax import kernels as TK
from nrdtpu_torch.passes.relax.denoiser import RelaxDenoiser
from nrdtpu_torch.settings import Denoiser, ResourceType as RT

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TA_FLIP_FRACTION = 1e-3
SIZE = (64, 48)
BOTH = ("diff", "spec")
SIGNALS = {"diff": ("diff",), "spec": ("spec",), "both": BOTH}
# the à-trous iterations held: 0 (prefilter, 5x5 estimation), 1 (the SH lobe base) and the last
ATROUS = {1: 0, 2: 1, 16: 4}
SH_IN = {"diff": (JRT.IN_DIFF_SH0, JRT.IN_DIFF_SH1), "spec": (JRT.IN_SPEC_SH0, JRT.IN_SPEC_SH1)}
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


def pool_of(gen, fd, i):
    """Frame i's inputs: SH0 / SH1 of each signal, SH1 along seeded directions in [-1, 1]."""
    pool = {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv}
    rng = np.random.default_rng((23, i))
    for sig, noisy, hit in (("diff", fd.diff_noisy, fd.diff_hit_dist),
                            ("spec", fd.spec_noisy, fd.spec_hit_dist)):
        direction = rng.uniform(-1.0, 1.0, noisy.shape).astype(np.float32)
        sh0, sh1 = tfe.relax_pack_sh(torch.from_numpy(noisy), torch.from_numpy(hit),
                                     torch.from_numpy(direction))
        pool[SH_IN[sig][0]], pool[SH_IN[sig][1]] = sh0.numpy(), sh1.numpy()
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
    the XLA chain of both signals with SH."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.RELAX_DIFFUSE_SPECULAR_SH}, resource_size=SIZE)
    port = TEngine({0: Denoiser.RELAX_DIFFUSE_SPECULAR_SH}, resource_size=SIZE, device="cpu")
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        if i < 3:
            port.set_common_settings(fd.common_settings)
            port.denoise([0], {RT(int(k)): v for k, v in pool_of(gen, fd, i).items()})
    inst = eng._instances[0]
    cfg = inst.config
    sc = dict(eng._shared_consts())
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    jsc = inst._relax_sc(sc)
    # the port's state as it stands, and to JAX in the same dtypes (the bf16 SH histories
    # widened exactly to float32 and narrowed back)
    state = {k: v.clone() for k, v in port.get_state(0).items()}
    pool = pool_of(gen, fd, 3)
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(interop.tensor_to_numpy(v)).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32) for k, v in state.items()}
    vz, nr = ja[JRT.IN_VIEWZ], ja[JRT.IN_NORMAL_ROUGHNESS]
    j = {}
    d, s, dsh, ssh = JK.pre_pass(jsc, dc, ja[JRT.IN_DIFF_SH0], ja[JRT.IN_SPEC_SH0], vz, nr, cfg,
                                 diff_sh=ja[JRT.IN_DIFF_SH1], spec_sh=ja[JRT.IN_SPEC_SH1],
                                 pallas=False)
    j["pre"] = dict(diff=d, spec=s, diff_sh=dsh, spec_sh=ssh)
    ta = JK.temporal_accumulation(jsc, dc, vz, nr, ja[JRT.IN_MV], d, s, js, cfg, diff_sh=dsh,
                                  spec_sh=ssh, pallas=False)
    j["ta"] = ta
    hl = ta["history_length"]
    fd_, fs_, fdsh, fssh = JK.history_fix(jsc, dc, vz, nr, hl, ta["diff"], ta["spec"], cfg,
                                          diff_sh=ta["diff_sh"], spec_sh=ta["spec_sh"],
                                          pallas=False)
    j["fix"] = dict(diff=fd_, spec=fs_, diff_sh=fdsh, spec_sh=fssh)
    fixmask = (hl <= dc["history_fix_frame_num"])[..., None]
    j["resp"] = {sig: jnp.where(fixmask, jnp.concatenate([j["fix"][sig][..., :3],
                                                          ta[f"{sig}_fast"][..., 3:]], -1),
                                ta[f"{sig}_fast"]) for sig in BOTH}
    j["hc"] = JK.history_clamping(jsc, dc, vz, d, s, ta["diff"], ta["spec"], j["resp"]["diff"],
                                  j["resp"]["spec"], hl, cfg, diff_sh=ta["diff_sh"],
                                  spec_sh=ta["spec_sh"], diff_sh_fast=ta["diff_sh_fast"],
                                  spec_sh_fast=ta["spec_sh_fast"], pallas=False)
    cur = {sig: j["hc"][f"{sig}_slow"] for sig in BOTH}
    cur.update({f"{sig}_sh": j["hc"][f"{sig}_sh"] for sig in BOTH})
    j["atrous_in"] = {}
    for i in range(5):
        j["atrous_in"][i] = dict(cur)
        res = JK.atrous(jsc, dc, vz, nr, hl, ta["spec_reprojection_confidence"], cur["diff"],
                        cur["spec"], cfg, step_size=1 << i, is_first=i == 0, is_last=i == 4,
                        diff_sh=cur["diff_sh"], spec_sh=cur["spec_sh"], sh_mode=True,
                        pallas=False)
        cur = res
    j["out"] = cur
    tcfg = DenoiserConfig(Denoiser.RELAX_DIFFUSE_SPECULAR_SH, SIZE, SIZE)
    tsc = interop.consts_from_numpy(sc)
    return dict(jsc=jsc, dc_j=dc, cfg=tcfg, jcfg=cfg, pool=pool, js=js,
                sc=RelaxDenoiser._relax_sc(tsc), dc=interop.consts_from_numpy(dc), state=state,
                j=j)


def _in(ctx, key):
    return t(ctx["pool"][key])


def _j(ctx, key):
    return jnp.asarray(ctx["pool"][key])


def _pair(ctx, stage, key, which):
    """The JAX chain's `stage` planes `<sig><key>` of the signals of `which`, as the port's pass
    takes them (one, or the pair)."""
    planes = tuple(t(ctx["j"][stage][sig + key]) for sig in SIGNALS[which])
    return planes if which == "both" else planes[0]


def test_state_is_bf16(ctx):
    """The port's SH histories are bfloat16 on both sides of the interop, as JAX keeps them."""
    for sig in BOTH:
        for kind in ("sh", "sh_responsive"):
            assert ctx["state"][f"{sig}_{kind}_prev"].dtype == torch.bfloat16
            assert ctx["js"][f"{sig}_{kind}_prev"].dtype == jnp.bfloat16


@pytest.mark.parametrize("sig", BOTH)
def test_pre_pass(ctx, sig):
    """The PrePass of one signal with its SH plane in the same call; SH1 is negative in
    places, and stays so (clipped at -FP16_MAX, not at 0)."""
    sh_in = _in(ctx, SH_IN[sig][1])
    assert bool((sh_in < 0.0).any())
    got, got_sh = TK.pre_pass(ctx["sc"], ctx["dc"], _in(ctx, SH_IN[sig][0]),
                              _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS),
                              ctx["cfg"], sig, sh=sh_in)
    close(f"{sig} pre_pass", got, ctx["j"]["pre"][sig])
    close(f"{sig} pre_pass SH", got_sh, ctx["j"]["pre"][sig + "_sh"])
    assert bool((got_sh < 0.0).any())


@pytest.fixture(scope="module")
def ta_both(ctx):
    j = ctx["j"]["pre"]
    return TK.temporal_accumulation_diffuse_specular(
        ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS),
        _in(ctx, RT.IN_MV), t(j["diff"]), t(j["spec"]), ctx["state"], ctx["cfg"],
        diff_sh=t(j["diff_sh"]), spec_sh=t(j["spec_sh"]))


TA_KEYS = {"diff": ("history_length", "diff", "diff_fast", "diff_sh", "diff_sh_fast"),
           "spec": ("history_length", "spec", "spec_fast", "reflection_hit_t", "spec_sh",
                    "spec_sh_fast")}


def _ta_close(ctx, got, key, label):
    flips = TA_FLIP_FRACTION if key.startswith("spec") or key == "reflection_hit_t" else 0.0
    close(f"TA {label} {key}", got[key], ctx["j"]["ta"][key], flips)


@pytest.mark.parametrize("key", sorted(set(TA_KEYS["diff"] + TA_KEYS["spec"])))
def test_temporal_accumulation(ctx, ta_both, key):
    """One head for both signals (the footprint, four histories and four SH histories in one
    `relax_smb_resolve` launch), then each signal's accumulation with its SH lerps."""
    _ta_close(ctx, ta_both, key, "both")


@pytest.mark.parametrize("sig", BOTH)
def test_temporal_accumulation_one_signal(ctx, sig):
    """The diffuse and the specular TA alone, each with its SH, against the same signals of
    the JAX TA of both (each signal's accumulation reads only its own planes and the head)."""
    j = ctx["j"]["pre"]
    kw = dict(diff_sh=t(j["diff_sh"])) if sig == "diff" else dict(spec_sh=t(j["spec_sh"]))
    fn = TK.temporal_accumulation if sig == "diff" else TK.temporal_accumulation_specular
    got = fn(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS),
             _in(ctx, RT.IN_MV), t(j[sig]), ctx["state"], ctx["cfg"], **kw)
    for key in TA_KEYS[sig]:
        _ta_close(ctx, got, key, sig)


@pytest.mark.parametrize("which", list(SIGNALS))
def test_history_fix(ctx, which):
    """The fix of the TA's signals and slow SH, in one call (the pair with both signals)."""
    hl = np.asarray(ctx["j"]["ta"]["history_length"])
    assert (hl <= ctx["dc_j"]["history_fix_frame_num"]).any(), "no short history to fix"
    names = SIGNALS[which]
    got = TK.history_fix(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                         _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl), _pair(ctx, "ta", "", which),
                         ctx["cfg"], which=names if which == "both" else which,
                         sh=_pair(ctx, "ta", "_sh", which))
    n = len(names)
    for k, sig in enumerate(names):
        close(f"{sig} history_fix", got[k], ctx["j"]["fix"][sig])
        close(f"{sig} history_fix SH", got[n + k], ctx["j"]["fix"][sig + "_sh"])


@pytest.mark.parametrize("which", list(SIGNALS))
def test_history_clamping(ctx, which):
    """The clamp with the SH lerp by the clamping factor in the same call, the responsive SH
    passed through."""
    j = ctx["j"]
    names = SIGNALS[which]
    fixed = tuple(t(j["fix"][sig]) for sig in names)
    got = TK.history_clamping(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                              _pair(ctx, "pre", "", which), _pair(ctx, "ta", "", which),
                              _pair(ctx, "ta", "_fast", which),
                              fixed if which == "both" else fixed[0],
                              t(j["ta"]["history_length"]),
                              which=names if which == "both" else which,
                              sh=_pair(ctx, "ta", "_sh", which),
                              sh_fast=_pair(ctx, "ta", "_sh_fast", which))
    for sig in names:
        for key in ("_slow", "_resp", "_sh", "_sh_fast"):
            close(f"history_clamping {sig}{key}", got[sig + key], j["hc"][sig + key])


@pytest.mark.parametrize("confidence", [False, True], ids=["default", "confidence"])
@pytest.mark.parametrize("which", list(SIGNALS))
@pytest.mark.parametrize("step", list(ATROUS))
def test_atrous(ctx, step, which, confidence):
    """Iterations 0, 1 and the last (the signal's rgb in YCoCg after it, the SH not) of one
    signal or both with their SH, from the JAX chain's input; also with IN_DIFF_CONFIDENCE and
    IN_SPEC_CONFIDENCE under the confidence-driven settings at 1.0."""
    i = ATROUS[step]
    hl = ctx["j"]["ta"]["history_length"]
    reproj = ctx["j"]["ta"]["spec_reprojection_confidence"]
    names = SIGNALS[which]
    confs = (_confidence(step), _confidence(step + 1)) if confidence else (None, None)
    jdc = dict(ctx["dc_j"], **(CONFIDENCE_DRIVEN if confidence else {}))
    cur = ctx["j"]["atrous_in"][i]
    want = JK.atrous(ctx["jsc"], jdc, _j(ctx, JRT.IN_VIEWZ), _j(ctx, JRT.IN_NORMAL_ROUGHNESS), hl,
                     reproj if "spec" in names else None,
                     cur["diff"] if "diff" in names else None,
                     cur["spec"] if "spec" in names else None, ctx["jcfg"], step_size=step,
                     is_first=i == 0, is_last=i == 4,
                     diff_confidence=None if confs[0] is None else jnp.asarray(confs[0]),
                     spec_confidence=None if confs[1] is None else jnp.asarray(confs[1]),
                     diff_sh=cur["diff_sh"] if "diff" in names else None,
                     spec_sh=cur["spec_sh"] if "spec" in names else None, sh_mode=True,
                     pallas=False)
    signals = tuple(t(cur[sig]) for sig in names)
    shs = tuple(t(cur[sig + "_sh"]) for sig in names)
    got, got_sh = TK.atrous(ctx["sc"], interop.consts_from_numpy(jdc), _in(ctx, RT.IN_VIEWZ),
                            _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl),
                            signals if which == "both" else signals[0], ctx["cfg"],
                            step_size=step, is_first=i == 0,
                            which=names if which == "both" else which,
                            diff_confidence=None if confs[0] is None else t(confs[0]),
                            spec_confidence=None if confs[1] is None else t(confs[1]),
                            reprojection_confidence=t(reproj) if "spec" in names else None,
                            sh=shs if which == "both" else shs[0], is_last=i == 4)
    if which != "both":
        got, got_sh = (got,), (got_sh,)
    for sig, g, g_sh in zip(names, got, got_sh):
        close(f"{sig} atrous step {step}", g, want[sig])
        close(f"{sig} atrous step {step} SH", g_sh, want[sig + "_sh"])


@pytest.mark.parametrize("sig", BOTH)
def test_split_screen(ctx, sig):
    """The noisy side of the split in YCoCg, as the denoised SH0 is (and 0 beyond the
    denoising range), at a split of 0.5."""
    jsc = dict(ctx["jsc"], split_screen=np.float32(0.5))
    tsc = dict(ctx["sc"], split_screen=0.5)
    out = ctx["j"]["out"][sig]
    want = JK.split_screen(jsc, _j(ctx, JRT.IN_VIEWZ), _j(ctx, SH_IN[sig][0]), out, sh_mode=True)
    got = TK.split_screen(tsc, _in(ctx, RT.IN_VIEWZ), _in(ctx, SH_IN[sig][0]), t(out),
                          sh_mode=True)
    close(f"{sig} split_screen", got, want)
    w = SIZE[0]
    assert not torch.equal(got[:, : w // 2], t(out)[:, : w // 2])
