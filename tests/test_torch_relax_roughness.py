"""RELAX under the roughness encodings: the port against the JAX package when
IN_NORMAL_ROUGHNESS packs its roughness as SQ_LINEAR or SQRT_LINEAR.

The reference unpacks every packed normal with `config.roughness_encoding`
(`nrdtpu/passes/relax/kernels.py:40-42`); the port's PrePass, history fix, à-trous and
hit-distance reconstruction take the encoding as a mode of their kernels.

- The slice: RELAX_SPECULAR at SQ_LINEAR and at SQRT_LINEAR and RELAX_DIFFUSE at SQ_LINEAR,
  the JAX Engine (XLA path) against the port's Engine on the CPU, 4 frames of the orbit scene
  at 128x96, noise 0.4, IN_NORMAL_ROUGHNESS packed with the encoding: >= 60 dB PSNR on every
  frame (the bar of `tests/test_torch_relax_spec_slice.py`) and the history length equal on
  >= 99.9 % of the pixels.
- The passes: `pre_pass`, `history_fix` and every à-trous step of RELAX_SPECULAR at each of
  the three encodings, each from the JAX chain's own intermediate of frame 4 (JAX runs frames
  1-3 at 72x40, its state carried across), against XLA at rtol=1e-4, atol=1e-5 (the bars of
  `tests/test_torch_relax_spec_passes.py`), and RELAX's `hit_dist_reconstruction` of the
  specular signal, whose taps weigh by the unpacked roughness, at radius 1 and 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JRK
from nrdtpu.passes.relax import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.settings import RoughnessEncoding as JRE
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import DenoiserConfig, Engine as TEngine
from nrdtpu_torch.passes.reblur import kernels as TRK
from nrdtpu_torch.passes.relax import kernels as TK
from nrdtpu_torch.passes.relax.denoiser import RelaxDenoiser
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, RoughnessEncoding

from test_torch_relax_slice import psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SLICE_SIZE, SLICE_FRAMES = (128, 96), 4
PASS_SIZE = (72, 40)
PSNR_BAR_DB = 60.0
RTOL, ATOL = 1e-4, 1e-5
ATROUS_STEPS = (1, 2, 4, 8, 16)
# (variant, encoding) of the slice
SLICES = [("RELAX_SPECULAR", "SQ_LINEAR"), ("RELAX_SPECULAR", "SQRT_LINEAR"),
          ("RELAX_DIFFUSE", "SQ_LINEAR")]
SIGNALS = {"RELAX_DIFFUSE": ("diff", RT.IN_DIFF_RADIANCE_HITDIST, RT.OUT_DIFF_RADIANCE_HITDIST),
           "RELAX_SPECULAR": ("spec", RT.IN_SPEC_RADIANCE_HITDIST,
                              RT.OUT_SPEC_RADIANCE_HITDIST)}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


def pool_of(gen, fd, variant, encoding):
    """The variant's inputs, IN_NORMAL_ROUGHNESS packed with the roughness encoding."""
    which, rt_in, _ = SIGNALS[variant]
    noisy, hit = (fd.diff_noisy, fd.diff_hit_dist) if which == "diff" else (fd.spec_noisy,
                                                                            fd.spec_hit_dist)
    sig = tfe.relax_pack_radiance_hitdist(torch.from_numpy(noisy), torch.from_numpy(hit))
    return {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv, rt_in: sig.numpy(),
            RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd, re_=JRE[encoding])}


def test_packing_follows_the_encoding():
    """The pools hold the encoded roughness: squared (SQ_LINEAR) and square-rooted
    (SQRT_LINEAR) against LINEAR, to the 10-bit quantization."""
    gen = SceneGenerator(SceneSpec(size=(48, 32), noise=0.4), camera_mode="orbit")
    fd = gen.frame(0)
    r = {e: gen.packed_normal_roughness(fd, re_=JRE[e])[..., 2]
         for e in ("LINEAR", "SQ_LINEAR", "SQRT_LINEAR")}
    assert np.abs(r["SQ_LINEAR"] - fd.roughness ** 2).max() <= 1e-3
    assert np.abs(r["SQRT_LINEAR"] - np.sqrt(fd.roughness)).max() <= 1e-3
    assert np.abs(r["SQ_LINEAR"] - r["LINEAR"]).max() > 0.05


# --- the slice ------------------------------------------------------------------------------


@pytest.fixture(scope="module", params=SLICES, ids=["-".join(c) for c in SLICES])
def runs(request):
    variant, encoding = request.param
    _, _, rt_out = SIGNALS[variant]
    gen = SceneGenerator(SceneSpec(size=SLICE_SIZE, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser[variant]}, resource_size=SLICE_SIZE,
                 roughness_encoding=JRE[encoding])
    te = TEngine({0: Denoiser[variant]}, resource_size=SLICE_SIZE,
                 roughness_encoding=RoughnessEncoding[encoding], device="cpu")
    frames = []
    for i in range(SLICE_FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = pool_of(gen, fd, variant, encoding)
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        to = te.denoise([0], pool)
        frames.append(dict(jax=np.asarray(jo[JRT(int(rt_out))]),
                           torch=interop.tensor_to_numpy(to[rt_out]),
                           jhl=np.asarray(je.get_state(0)["history_length"]),
                           thl=interop.tensor_to_numpy(te.get_state(0)["history_length"])))
    return f"{variant} {encoding}", frames


@pytest.mark.parametrize("frame", range(SLICE_FRAMES))
def test_output_matches_jax(runs, frame):
    name, frames = runs
    r = frames[frame]
    assert r["torch"].shape == r["jax"].shape and np.isfinite(r["torch"]).all()
    p = psnr(r["torch"], r["jax"])
    print(f"{name} frame {frame}: {p:.2f} dB against JAX")
    assert p >= PSNR_BAR_DB, f"{name} frame {frame}: {p:.2f} dB"


def test_history_length_matches_jax(runs):
    _, frames = runs
    for r in frames:
        assert np.mean(r["thl"] == r["jhl"]) >= 0.999


# --- the passes -----------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["LINEAR", "SQ_LINEAR", "SQRT_LINEAR"])
def ctx(request):
    """RELAX_SPECULAR at one encoding: JAX runs frames 0-2; returns frame 3's inputs,
    constants, state and the XLA chain's intermediates."""
    encoding = request.param
    gen = SceneGenerator(SceneSpec(size=PASS_SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.RELAX_SPECULAR}, resource_size=PASS_SIZE,
                  roughness_encoding=JRE[encoding])
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        pool = pool_of(gen, fd, "RELAX_SPECULAR", encoding)
        if i < 3:
            eng.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
    inst = eng._instances[0]
    cfg = inst.config
    sc = dict(eng._shared_consts())
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    jsc = inst._relax_sc(sc)
    state = {k: np.asarray(v) for k, v in eng.get_state(0).items()}
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    vz, nr, spec = ja[RT.IN_VIEWZ], ja[RT.IN_NORMAL_ROUGHNESS], ja[RT.IN_SPEC_RADIANCE_HITDIST]
    j = {}
    j["pre"] = JK.pre_pass(jsc, dc, None, spec, vz, nr, cfg, pallas=False)[1]
    j["ta"] = JK.temporal_accumulation(jsc, dc, vz, nr, ja[RT.IN_MV], None, j["pre"], js, cfg,
                                       pallas=False)
    hl = j["ta"]["history_length"]
    j["fix"] = JK.history_fix(jsc, dc, vz, nr, hl, None, j["ta"]["spec"], cfg, pallas=False)[1]
    fixmask = (hl <= dc["history_fix_frame_num"])[..., None]
    resp = jnp.where(fixmask, jnp.concatenate([j["fix"][..., :3],
                                               j["ta"]["spec_fast"][..., 3:]], -1),
                     j["ta"]["spec_fast"])
    hc = JK.history_clamping(jsc, dc, vz, None, j["pre"], None, j["ta"]["spec"], None, resp,
                             hl, cfg, pallas=False)
    cur = hc["spec_slow"]
    j["atrous_in"], j["atrous"] = {}, {}
    for i, step in enumerate(ATROUS_STEPS):
        j["atrous_in"][step] = cur
        cur = JK.atrous(jsc, dc, vz, nr, hl, j["ta"]["spec_reprojection_confidence"], None, cur,
                        cfg, step_size=step, is_first=i == 0,
                        is_last=i == len(ATROUS_STEPS) - 1, pallas=False)["spec"]
        j["atrous"][step] = cur
    tcfg = DenoiserConfig(Denoiser.RELAX_SPECULAR, PASS_SIZE, PASS_SIZE,
                          roughness_encoding=RoughnessEncoding[encoding])
    return dict(encoding=encoding, fd=fd, pool=pool, jsc=jsc, dc_j=dc, jcfg=cfg, cfg=tcfg,
                sc=RelaxDenoiser._relax_sc(interop.consts_from_numpy(sc)),
                dc=interop.consts_from_numpy(dc), j=j)


def _in(ctx, key):
    return t(ctx["pool"][key])


def test_pre_pass(ctx):
    got = TK.pre_pass(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_SPEC_RADIANCE_HITDIST),
                      _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS), ctx["cfg"],
                      which="spec")
    close(f"spec pre_pass {ctx['encoding']}", got, ctx["j"]["pre"])


def test_history_fix(ctx):
    hl = np.asarray(ctx["j"]["ta"]["history_length"])
    assert (hl <= ctx["dc_j"]["history_fix_frame_num"]).any(), "no short history to fix"
    got = TK.history_fix(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                         _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl), t(ctx["j"]["ta"]["spec"]),
                         ctx["cfg"], which="spec")
    close(f"spec history_fix {ctx['encoding']}", got, ctx["j"]["fix"])


@pytest.mark.parametrize("step", ATROUS_STEPS)
def test_atrous(ctx, step):
    j = ctx["j"]
    got = TK.atrous(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS),
                    t(j["ta"]["history_length"]), t(j["atrous_in"][step]), ctx["cfg"],
                    step_size=step, is_first=step == ATROUS_STEPS[0], which="spec",
                    reprojection_confidence=t(j["ta"]["spec_reprojection_confidence"]))
    close(f"spec atrous step {step} {ctx['encoding']}", got, j["atrous"][step])


@pytest.mark.parametrize("radius", [1, 2])
def test_hit_dist_reconstruction(ctx, radius):
    """The specular signal's reconstruction on RELAX's constants, on frame 4 with its hit
    distance zeroed on a seeded 30 % of the geometry pixels."""
    c = ctx
    sig = c["pool"][RT.IN_SPEC_RADIANCE_HITDIST].copy()
    holes = (np.random.default_rng(3).random(sig.shape[:2]) < 0.3) & (c["fd"].hit_mask > 0)
    sig[..., 3][holes] = 0.0
    _, got = TRK.hit_dist_reconstruction(c["sc"], c["dc"], _in(c, RT.IN_VIEWZ),
                                         _in(c, RT.IN_NORMAL_ROUGHNESS), None, t(sig), c["cfg"],
                                         radius=radius)
    _, want = JRK.hit_dist_reconstruction(c["jsc"], c["dc_j"], jnp.asarray(c["pool"][RT.IN_VIEWZ]),
                                          jnp.asarray(c["pool"][RT.IN_NORMAL_ROUGHNESS]), None,
                                          jnp.asarray(sig), c["jcfg"], radius=radius,
                                          pallas=False)
    close(f"spec hit_dist_reconstruction radius {radius} {c['encoding']}", got, want)
    assert float((got[..., 3][t(holes.astype(np.float32)) > 0] > 0).float().mean()) > 0.9
