"""RELAX under checkerboard in the PyTorch port: the front resolve and the TA's slower
accumulation pass by pass against the JAX package's XLA code, and RELAX_DIFFUSE_SPECULAR in
BLACK end to end against the JAX Engine (RELAX_DIFFUSE and RELAX_SPECULAR in WHITE in
`tests/test_torch_relax_cb_slice.py`), at 64x48 on the orbit scene with the signals at half
width (the has-data pixel of each horizontal pair, `tests/test_reblur_full.py:244-250`).

Pass by pass, frame 4 of the scene (the port's Engine runs frames 1-3 in BLACK and its state
goes to the JAX side; the JAX Engine only takes each frame's common settings):
- `checkerboard_resolve` of the signals and of the SH planes against
  `nrdtpu/passes/relax/denoiser.py:176-239`, which is glue inside JAX's `frame`: JAX's
  RELAX_DIFFUSE_SPECULAR_SH runs its frame op by op up to the PrePass, whose inputs are the
  resolved planes (it stops there, before the dead pass-through that fails under
  checkerboard, `:367-369`); by default, where the material test never bites (both min
  materials at 4), and with both min materials 0 on a material drawn per pixel;
- the TA with the has-data plane (`nrdtpu/passes/relax/kernels.py:590-595`, `:919-925`,
  `:944-952`) through the one-signal entry points and the two-signal one.

Tolerance: rtol=1e-4, atol=1e-5; the TA's specular outputs on all but 1e-3 of their values, and
the reprojection confidence on all but 5 % by at most 0.05, for the reason
`tests/test_torch_relax_ds_passes.py` gives. The slice: every output >= 60 dB PSNR against the
JAX Engine on every one of 4 frames.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.relax import kernels as JK
from nrdtpu.settings import CheckerboardMode as JCB
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import DenoiserConfig, Engine as TEngine
from nrdtpu_torch.passes.reblur import common as TC
from nrdtpu_torch.passes.relax import kernels as TK
from nrdtpu_torch.passes.relax.denoiser import RelaxDenoiser
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, ResourceType as RT, replace

from test_torch_reblur_cb import half_width, scattered

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 4
RTOL, ATOL = 1e-4, 1e-5
TA_FLIP_FRACTION = 1e-3
CONFIDENCE_FLIP_FRACTION, CONFIDENCE_MAX_ABS = 0.05, 0.05
PSNR_BAR_DB = 60.0
MODE = CB.BLACK
SIGNALS = {"diff": (RT.IN_DIFF_RADIANCE_HITDIST, RT.OUT_DIFF_RADIANCE_HITDIST),
           "spec": (RT.IN_SPEC_RADIANCE_HITDIST, RT.OUT_SPEC_RADIANCE_HITDIST)}
SH_IN = {"diff": (RT.IN_DIFF_SH0, RT.IN_DIFF_SH1), "spec": (RT.IN_SPEC_SH0, RT.IN_SPEC_SH1)}
NO_MIN_MATERIAL = dict(minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0)


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


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def pool_of(gen, fd, mode=MODE, sh=False):
    """Both signals at half width: the radiance and raw hit distance
    (`relax_pack_radiance_hitdist`), or with `sh` SH0 / SH1 (`relax_pack_sh`, SH1 along the
    normal)."""
    pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv}
    fi = fd.common_settings.frameIndex
    normal = torch.from_numpy(fd.normal.astype(np.float32))
    for sig, noisy, hit in (("diff", fd.diff_noisy, fd.diff_hit_dist),
                            ("spec", fd.spec_noisy, fd.spec_hit_dist)):
        noisy, hit = torch.from_numpy(noisy), torch.from_numpy(hit)
        if sh:
            planes = zip(SH_IN[sig], tfe.relax_pack_sh(noisy, hit, normal))
        else:
            planes = [(SIGNALS[sig][0], tfe.relax_pack_radiance_hitdist(noisy, hit))]
        for rt, p in planes:
            pool[rt] = half_width(p.numpy(), fi, mode)
    return pool


@pytest.fixture(scope="module")
def ctx():
    """The port runs frames 1-3 of RELAX_DIFFUSE_SPECULAR in BLACK; returns frame 4's inputs
    (radiance and SH), the JAX engine and constants, the state and the has-data plane."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.RELAX_DIFFUSE_SPECULAR}, resource_size=SIZE)
    eng.set_denoiser_settings(0, jreplace(eng._settings[0], checkerboardMode=JCB[MODE.name]))
    port = TEngine({0: Denoiser.RELAX_DIFFUSE_SPECULAR}, resource_size=SIZE, device="cpu")
    port.set_denoiser_settings(0, replace(port._settings[0], checkerboardMode=MODE))
    for i in range(1, 5):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        eng.set_common_settings(fd.common_settings)
        if i < 4:
            port.set_common_settings(fd.common_settings)
            port.denoise([0], pool_of(gen, fd))
    inst = eng._instances[0]
    sc = dict(eng._shared_consts())
    fi = int(sc["frame_index"])
    w, h = SIZE
    has_data = ((np.arange(w)[None, :] + np.arange(h)[:, None] + fi) & 1) == int(MODE) - 1
    return dict(eng=eng, inst=inst, jcfg=inst.config, sc=sc, jsc=inst._relax_sc(sc),
                tsc=RelaxDenoiser._relax_sc(interop.consts_from_numpy(sc)),
                cfg=DenoiserConfig(Denoiser.RELAX_DIFFUSE_SPECULAR, SIZE, SIZE),
                pool=pool_of(gen, fd), sh_pool=pool_of(gen, fd, sh=True), has_data=has_data,
                state={k: interop.tensor_to_numpy(v) for k, v in port.get_state(0).items()})


def _dc(ctx, settings):
    """Frame 4's RELAX denoiser constants with `settings` changed (JAX, port)."""
    dc = ctx["inst"].frame_constants(ctx["eng"]._consts, jreplace(ctx["eng"]._settings[0],
                                                                  **settings))
    return dc, interop.consts_from_numpy(dc)


class _Stop(Exception):
    pass


def jax_resolved(ctx, settings, nr):
    """The four planes JAX's RELAX_DIFFUSE_SPECULAR_SH resolves at its front
    (`denoiser.py:176-239`, op by op), as its PrePass receives them."""
    jeng = JEngine({0: JDenoiser.RELAX_DIFFUSE_SPECULAR_SH}, resource_size=SIZE)
    inst = jeng._instances[0]
    s = jreplace(jeng._settings[0], checkerboardMode=JCB[MODE.name], **settings)
    inst.specialize(s)
    dc = inst.frame_constants(ctx["eng"]._consts, s)
    inputs = {JRT(int(k)): jnp.asarray(v) for k, v in ctx["sh_pool"].items()}
    inputs[JRT.IN_NORMAL_ROUGHNESS] = jnp.asarray(nr)
    got = {}

    def stop(sc, dc, diff, spec, view_z, normal_roughness, cfg, diff_sh=None, spec_sh=None,
             **kw):
        got.update(diff=diff, spec=spec, diff_sh=diff_sh, spec_sh=spec_sh)
        raise _Stop
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JK, "pre_pass", stop)
        with pytest.raises(_Stop):
            inst.frame(ctx["sc"], dc, inst.init_state(), inputs)
    return got


@pytest.mark.parametrize("case", ["default", "min_material_0"])
def test_checkerboard_resolve(ctx, case):
    """The front resolve of both signals' SH0 and SH1 against the JAX code it ports."""
    settings = NO_MIN_MATERIAL if case == "min_material_0" else {}
    nr = ctx["sh_pool"][RT.IN_NORMAL_ROUGHNESS]
    nr = scattered(nr) if settings else nr
    want = jax_resolved(ctx, settings, nr)
    _, dc = _dc(ctx, settings)
    p = ctx["sh_pool"]
    planes = [TC.cb_expand(t(p[rt]), SIZE[0]) for rt in (RT.IN_DIFF_SH0, RT.IN_SPEC_SH0,
                                                         RT.IN_DIFF_SH1, RT.IN_SPEC_SH1)]
    has = torch.from_numpy(ctx["has_data"])
    got = TK.checkerboard_resolve(ctx["tsc"], dc, t(p[RT.IN_VIEWZ]), t(nr), has, planes,
                                  ctx["cfg"])
    for name, g, e in zip(("diff", "spec", "diff_sh", "spec_sh"), got, planes):
        close(f"resolve {name}", g, want[name])
        assert not torch.equal(g, e), f"{name}: nothing resolved"  # the no-data pixels moved
    if settings:  # the material test bites: some pixel without data keeps only one neighbour
        default = TK.checkerboard_resolve(ctx["tsc"], _dc(ctx, {})[1], t(p[RT.IN_VIEWZ]), t(nr),
                                          has, planes[:1], ctx["cfg"])
        assert not torch.equal(got[0], default[0])


@pytest.fixture(scope="module")
def ta_inputs(ctx):
    """Frame 4's resolved signals through JAX's PrePass (XLA), and the state on both sides."""
    jdc, dc = _dc(ctx, {})
    p = ctx["pool"]
    has = torch.from_numpy(ctx["has_data"])
    vz, nr = t(p[RT.IN_VIEWZ]), t(p[RT.IN_NORMAL_ROUGHNESS])
    resolved = TK.checkerboard_resolve(
        ctx["tsc"], dc, vz, nr, has,
        [TC.cb_expand(t(p[SIGNALS[sig][0]]), SIZE[0]) for sig in ("diff", "spec")], ctx["cfg"])
    pre = JK.pre_pass(ctx["jsc"], jdc, *[jnp.asarray(r.numpy()) for r in resolved],
                      jnp.asarray(vz.numpy()), jnp.asarray(nr.numpy()), ctx["jcfg"],
                      pallas=False)[:2]
    return dict(jdc=jdc, dc=dc, pre=pre, js={k: jnp.asarray(v) for k, v in ctx["state"].items()},
                st=interop.state_from_numpy(ctx["state"]), vz=vz, nr=nr, mv=t(p[RT.IN_MV]))


@pytest.mark.parametrize("which", ["diff", "spec", "both"])
def test_ta_has_data(ctx, ta_inputs, which):
    """The TA with the has-data plane through each entry point: the diffuse alphas slower where
    a pixel has no data and its history is longer than 1 frame, the specular surface- and
    virtual-motion alphas where it has none and the parallax is under half a pixel."""
    x = ta_inputs
    diff = x["pre"][0] if which != "spec" else None
    spec = x["pre"][1] if which != "diff" else None
    has_j = jnp.asarray(ctx["has_data"])
    want = JK.temporal_accumulation(ctx["jsc"], x["jdc"], jnp.asarray(x["vz"].numpy()),
                                    jnp.asarray(x["nr"].numpy()), jnp.asarray(x["mv"].numpy()),
                                    diff, spec, x["js"], ctx["jcfg"], pallas=False,
                                    has_data=has_j)
    common = (ctx["tsc"], x["dc"], x["vz"], x["nr"], x["mv"])

    def run(has_data):
        if which == "diff":
            return TK.temporal_accumulation(*common, t(diff), x["st"], ctx["cfg"],
                                            has_data=has_data)
        if which == "spec":
            return TK.temporal_accumulation_specular(*common, t(spec), x["st"], ctx["cfg"],
                                                     has_data=has_data)
        return TK.temporal_accumulation_diffuse_specular(*common, t(diff), t(spec), x["st"],
                                                         ctx["cfg"], has_data=has_data)
    got = run(torch.from_numpy(ctx["has_data"]))
    without = run(None)
    keys = [k for k in ("history_length", "diff", "diff_fast", "spec", "spec_fast",
                        "reflection_hit_t", "spec_reprojection_confidence") if k in got]
    for key in keys:
        if key == "spec_reprojection_confidence":
            close(f"TA {key}", got[key], want[key], CONFIDENCE_FLIP_FRACTION)
            assert float(np.abs(got[key].numpy() - np.asarray(want[key])).max()) \
                <= CONFIDENCE_MAX_ABS
            continue
        flips = TA_FLIP_FRACTION if key in ("spec", "spec_fast", "reflection_hit_t") else 0.0
        close(f"TA {key}", got[key], want[key], flips)
    for key in ("diff", "diff_fast", "spec", "reflection_hit_t"):
        if key in got:  # the slower accumulation moves these on this frame
            assert not torch.equal(got[key], without[key]), key


def slice_psnrs(denoiser, mode):
    """FRAMES frames of `denoiser` in `mode` through the JAX Engine and the port's Engine; per
    frame and output the port's PSNR against JAX."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser[denoiser]}, resource_size=SIZE)
    je.set_denoiser_settings(0, jreplace(je._settings[0], checkerboardMode=JCB[mode.name]))
    te = TEngine({0: Denoiser[denoiser]}, resource_size=SIZE, device="cpu")
    te.set_denoiser_settings(0, replace(te._settings[0], checkerboardMode=mode))
    signals = [sig for sig, part in (("diff", "DIFFUSE"), ("spec", "SPECULAR"))
               if part in denoiser]
    out = []
    for i in range(FRAMES):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        pool = {rt: v for rt, v in pool_of(gen, fd, mode).items()
                if rt not in [SIGNALS[sig][0] for sig in SIGNALS if sig not in signals]}
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        to = te.denoise([0], pool)
        frame = {}
        for sig in signals:
            got = interop.tensor_to_numpy(to[SIGNALS[sig][1]])
            assert got.shape == (SIZE[1], SIZE[0], 4)
            frame[sig] = psnr(got, np.asarray(jo[JRT(int(SIGNALS[sig][1]))]))
        out.append(frame)
    return out


def test_slice_matches_jax():
    """RELAX_DIFFUSE_SPECULAR in BLACK, 4 frames, the port's Engine against the JAX Engine
    (RELAX_DIFFUSE and RELAX_SPECULAR in `tests/test_torch_relax_cb_slice.py`)."""
    for i, frame in enumerate(slice_psnrs("RELAX_DIFFUSE_SPECULAR", CB.BLACK)):
        for sig, p in frame.items():
            assert p >= PSNR_BAR_DB, f"frame {i} {sig}: {p:.2f} dB"
