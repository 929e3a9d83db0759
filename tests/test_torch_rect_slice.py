"""Dynamic resolution end to end: a rect smaller than the resource, and rect changes with the
history migrated, through the port's Engine on the CPU against the JAX Engine (XLA path, run op
by op, `jax.disable_jit()`, so that no rect compiles a graph of its own).

The resource is 64x48. Each frame of the orbit scene is made at that frame's rect size and
pasted into the top-left of resource-sized planes whose other texels are NaN: the JAX Engine
crops them away (`nrdtpu/engine.py:322-328`), so a port that read there would fail. The
sequence (`RECTS`, (w, h), `rectSizePrev` the previous frame's rect): 56x41 from the start,
56x41 again (a static rect with its history), 48x37 (a shrink), 56x41 (a grow). Two rect shapes
only: op by op, JAX compiles each primitive once a shape, ~30 s a shape for RELAX, and the
families run in this one module so that they share what one has compiled (RELAX first).

`test_port_matches_jax_at_rect` holds RELAX_DIFFUSE_SPECULAR, REBLUR_DIFFUSE_SPECULAR,
REBLUR_SPECULAR (against the JAX REBLUR_DIFFUSE_SPECULAR run: on the XLA path the two signals
are independent, so its specular output holds the port's REBLUR_SPECULAR too),
SIGMA_SHADOW_TRANSLUCENCY and REFERENCE: every output >= 60 dB against JAX inside the rect on
every frame and exactly 0 outside (`check_outputs`). `test_state_migrates_as_jax`: the state
after each frame of JAX's keys, shapes and dtypes, and at each change the port's
`_migrate_state` of JAX's state equal to JAX's `_migrate_state` of it (rtol 1e-4, atol 1e-5;
bf16 stays bf16).

`test_every_variant_across_a_rect_change` runs all 19 variants on the port alone at 32x24, two
frames across a change from 32x24 to 27x19: nothing raises, the outputs are finite inside the
rect and zero outside, and the state has the new rect's shape.

`test_reference_fault_rect_sampling` holds the reference's fault at a rect, and
`test_checkerboard_at_rect_raises` its failure under checkerboard (ROADMAP.md Queue 3).

Run alone: python -m pytest tests/test_torch_rect_slice.py -q
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nrdtpu import engine as jengine
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import engine as tengine
from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import Denoiser, ResourceType as RT
from nrdtpu_torch.utils.scene import SceneGenerator as TSceneGenerator

from test_torch_reblur_enc_slice import pool_of as reblur_pool_of
from test_torch_relax_slice import psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
PSNR_BAR_DB = 60.0
RECTS = [(56, 41), (56, 41), (48, 37), (56, 41)]
TRANSLUCENCY_RGB = (0.3, 0.6, 0.2)
RELAX_IN = {"diff": (RT.IN_DIFF_RADIANCE_HITDIST, RT.IN_DIFF_SH0, RT.IN_DIFF_SH1),
            "spec": (RT.IN_SPEC_RADIANCE_HITDIST, RT.IN_SPEC_SH0, RT.IN_SPEC_SH1)}


@functools.lru_cache(maxsize=None)
def scene(size):
    return SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")


def rect_pool(variant, fd, i):
    """The inputs of `variant` on orbit frame `fd`, at the frame's own size."""
    if variant.startswith("REBLUR"):
        return reblur_pool_of(fd, i, variant, "R10_G10_B10_A2_UNORM")
    pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
            RT.IN_NORMAL_ROUGHNESS: TSceneGenerator.packed_normal_roughness(fd)}
    if variant == "REFERENCE":
        return {RT.IN_SIGNAL: fd.diff_noisy[..., :3].copy()}
    if variant.startswith("SIGMA"):
        dist = torch.from_numpy(fd.dist_to_occluder)
        pool[RT.IN_PENUMBRA] = tfe.sigma_pack_penumbra_directional(
            dist, scene(fd.view_z.shape[::-1]).spec.light_tan_angular_radius).numpy()
        if variant == "SIGMA_SHADOW_TRANSLUCENCY":
            rgb = torch.tensor(TRANSLUCENCY_RGB).expand(fd.view_z.shape + (3,))
            pool[RT.IN_TRANSLUCENCY] = tfe.sigma_pack_translucency(dist, rgb).numpy()
        return pool
    normal = torch.from_numpy(fd.normal.astype(np.float32))
    for sig, noisy, hit, part in (("diff", fd.diff_noisy, fd.diff_hit_dist, "DIFFUSE"),
                                  ("spec", fd.spec_noisy, fd.spec_hit_dist, "SPECULAR")):
        if part not in variant:
            continue
        noisy, hit = torch.from_numpy(noisy), torch.from_numpy(hit)
        if variant.endswith("_SH"):
            sh0, sh1 = tfe.relax_pack_sh(noisy, hit, normal)
            pool[RELAX_IN[sig][1]], pool[RELAX_IN[sig][2]] = sh0.numpy(), sh1.numpy()
        else:
            pool[RELAX_IN[sig][0]] = tfe.relax_pack_radiance_hitdist(noisy, hit).numpy()
    return pool


def paste(plane, size):
    """A resource-sized plane, `plane` in its top-left, NaN elsewhere."""
    w, h = size
    out = np.full((h, w) + plane.shape[2:], np.nan, np.float32)
    out[:plane.shape[0], :plane.shape[1]] = plane
    return out


def frames(variant, rects, size=SIZE):
    """(common settings, resource-sized pool) of each frame: the scene at the frame's rect."""
    for i, rect in enumerate(rects):
        fd = scene(rect).frame(i)
        cs = fd.common_settings
        cs.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        cs.resourceSize = cs.resourceSizePrev = size
        cs.rectSize, cs.rectSizePrev = rect, rects[max(i - 1, 0)]
        yield cs, {k: paste(np.asarray(v, np.float32), size)
                   for k, v in rect_pool(variant, fd, i).items()}


def _state_np(state):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def run(variant, ports=None):
    """Per frame of RECTS: each port engine's outputs beside JAX's, the port's and JAX's
    states, and JAX's state before the frame (the one a change migrates). `ports`: the port's
    variants held against this JAX run (by default `variant` alone)."""
    je = JEngine({0: JDenoiser[variant]}, resource_size=SIZE)
    tes = {v: TEngine({0: Denoiser[v]}, resource_size=SIZE, device="cpu")
           for v in (ports or (variant,))}
    out = []
    for cs, pool in frames(variant, RECTS):
        jprev = je._states[0]
        je.set_common_settings(cs)
        with jax.disable_jit():
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        frame = dict(outputs={}, states={}, jstate=je.get_state(0), jprev=jprev,
                     variant=variant)
        for v, te in tes.items():
            te.set_common_settings(cs)
            to = te.denoise([0], pool)
            frame["outputs"][v] = {k: (interop.tensor_to_numpy(t), np.asarray(jo[JRT(int(k))]))
                                   for k, t in to.items()}
            frame["states"][v] = te.get_state(0)
        out.append(frame)
    return out


def check_outputs(frames_, rects, label):
    """Every output >= 60 dB against JAX inside the frame's rect and 0 outside."""
    for i, (frame, (rw, rh)) in enumerate(zip(frames_, rects)):
        for v, outs in frame["outputs"].items():
            for k, (got, want) in outs.items():
                assert got.shape == want.shape == (SIZE[1], SIZE[0]) + got.shape[2:], k
                inside = got[:rh, :rw]
                assert np.isfinite(inside).all(), (label, v, i, k.name)
                outside = got.copy()
                outside[:rh, :rw] = 0.0
                assert not outside.any(), (label, v, i, k.name)
                p = psnr(inside, want[:rh, :rw])
                print(f"{label} {v} frame {i} {k.name}: {p:.2f} dB")
                assert p >= PSNR_BAR_DB, (label, v, i, k.name, p)


def check_states(frames_, rects):
    """The port's state after each frame has JAX's keys, shapes and dtypes; at each change the
    port's `_migrate_state` of JAX's state before the frame equals JAX's `_migrate_state`."""
    for i, frame in enumerate(frames_):
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in frame["jstate"].items()}
        assert _state_np(frame["states"][frame["variant"]]) == want, i
        if i and rects[i] != rects[i - 1]:
            prev = {k: np.asarray(v) for k, v in frame["jprev"].items()}
            jmig = jengine._migrate_state(prev, rects[i - 1], rects[i])
            tmig = tengine._migrate_state(interop.state_from_numpy(prev), rects[i - 1],
                                          rects[i])
            assert set(tmig) == set(jmig), i
            for k, w_ in jmig.items():
                g = tmig[k]
                assert tuple(g.shape) == np.shape(w_), (i, k)
                assert str(g.dtype).replace("torch.", "") == str(np.asarray(w_).dtype), (i, k)
                np.testing.assert_allclose(g.float().numpy(), np.asarray(w_, np.float32),
                                           rtol=1e-4, atol=1e-5, err_msg=f"frame {i} {k}")


# (JAX run, the port's variants held against it), RELAX first: the other families reuse much
# of what its run has compiled
RUNS = (("RELAX_DIFFUSE_SPECULAR", ("RELAX_DIFFUSE_SPECULAR",)),
        ("REBLUR_DIFFUSE_SPECULAR", ("REBLUR_DIFFUSE_SPECULAR", "REBLUR_SPECULAR")),
        ("SIGMA_SHADOW_TRANSLUCENCY", ("SIGMA_SHADOW_TRANSLUCENCY",)),
        ("REFERENCE", ("REFERENCE",)))
PORTS = [(v, p) for v, ps in RUNS for p in ps]


@pytest.mark.parametrize("variant,port", PORTS, ids=[p for _, p in PORTS])
def test_port_matches_jax_at_rect(variant, port):
    """Every output of the port's `port` >= 60 dB against the JAX `variant` inside the rect and
    0 outside, on every frame."""
    ports = dict(RUNS)[variant]
    frames_ = [dict(f, outputs={port: f["outputs"][port]}) for f in run(variant, ports)]
    check_outputs(frames_, RECTS, port)


@pytest.mark.parametrize("variant", [v for v, _ in RUNS])
def test_state_migrates_as_jax(variant):
    check_states(run(variant, dict(RUNS)[variant]), RECTS)


# the 19 variants on the port alone: resource 32x24, then the rect 27x19
SMOKE_SIZE = (32, 24)
SMOKE_RECTS = [(32, 24), (27, 19)]


@pytest.mark.parametrize("variant", [d.name for d in Denoiser])
def test_every_variant_across_a_rect_change(variant):
    """Two frames across a change from the resource's 32x24 to a rect of 27x19: nothing raises,
    the outputs are finite inside the rect and 0 outside, the state has the new rect's shape."""
    te = TEngine({0: Denoiser[variant]}, resource_size=SMOKE_SIZE, device="cpu")
    for i, (cs, pool) in enumerate(frames(variant, SMOKE_RECTS, SMOKE_SIZE)):
        te.set_common_settings(cs)
        outs = te.denoise([0], pool)
        rw, rh = SMOKE_RECTS[i]
        assert outs
        for k, t in outs.items():
            got = interop.tensor_to_numpy(t)
            assert got.shape[:2] == (SMOKE_SIZE[1], SMOKE_SIZE[0]), (variant, k)
            assert np.isfinite(got[:rh, :rw]).all(), (variant, i, k.name)
            got[:rh, :rw] = 0.0
            assert not got.any(), (variant, i, k.name)
    for k, t in te.get_state(0).items():
        if t.ndim >= 2:
            assert tuple(t.shape[:2]) == (rh, rw), (variant, k)


def test_reference_fault_rect_sampling():
    """The reference's fault at a rect (ROADMAP.md Queue 3). Its state planes have the rect's
    shape, but `resample.sample_bilinear` places uv with the plane's own (w, h)
    (`nrdtpu/ops/resample.py:63-72`): where it samples a previous plane at uv x
    resolution_scale_prev (REBLUR's specular TA parallax hit distance,
    `nrdtpu/passes/reblur/kernels.py:1338-1340`; RELAX's specular TA previous hitT and normal,
    `nrdtpu/passes/relax/kernels.py:780-789`, `:867-869`) it reads at uv x scale x rect, and
    RELAX's footprint-centre uv is (origin + 1) / resource_size (`:520-521`). NRD reads a
    resource-sized texture and lands at uv x rect and at origin + 1. The port follows the
    reference (N3, K17, K16). At a static rect of 48x37 in 64x48, the same port engines with the
    two constants set so that the sampling lands where NRD's does (resolution_scale_prev 1 and
    resource_size the rect: on planes of the rect's shape that reads at uv x rect and at
    origin + 1) give other outputs from frame 1 on; the printed PSNR is the gap. This test
    fails once `nrdtpu/` is repaired (the port then follows it)."""
    rect = (48, 37)
    for variant, rt in (("REBLUR_SPECULAR", RT.OUT_SPEC_RADIANCE_HITDIST),
                        ("RELAX_SPECULAR", RT.OUT_SPEC_RADIANCE_HITDIST)):
        engines = {nrd: TEngine({0: Denoiser[variant]}, resource_size=SIZE, device="cpu")
                   for nrd in (False, True)}
        gaps = []
        for i, (cs, pool) in enumerate(frames(variant, [rect] * 3)):
            outs = {}
            for nrd, te in engines.items():
                te.set_common_settings(cs)
                if nrd:
                    te._consts["resolution_scale_prev"] = np.ones(2, np.float32)
                    te._consts["resource_size"] = np.array(rect, np.float32)
                outs[nrd] = interop.tensor_to_numpy(te.denoise([0], pool)[rt])[:rect[1], :rect[0]]
            gaps.append(psnr(outs[False], outs[True]))
        print(f"{variant}: as written against NRD's sampling, frames 0-2: "
              + ", ".join(f"{g:.2f} dB" for g in gaps))
        assert gaps[0] == float("inf") and all(np.isfinite(gaps[1:])), (variant, gaps)


@pytest.mark.parametrize("variant", ["REBLUR_DIFFUSE", "RELAX_DIFFUSE"])
def test_checkerboard_at_rect_raises(variant):
    """Checkerboard at a rect (ROADMAP.md Queue 3): the JAX Engine crops only the inputs at
    least as wide as the rect (`nrdtpu/engine.py:322-328`), so the half-width signal keeps the
    resource's height and its frame fails on the shape; the port raises NotImplementedError
    naming the fault. This test fails once `nrdtpu/` is repaired."""
    from nrdtpu.settings import CheckerboardMode as JCB, replace as jreplace
    from nrdtpu_torch.settings import CheckerboardMode as CB, replace

    from test_torch_reblur_occ_slice import half_width

    cs, pool = next(frames(variant, [(56, 41)]))
    sig = RT.IN_DIFF_RADIANCE_HITDIST
    pool[sig] = half_width(pool[sig], cs.frameIndex, CB.BLACK)
    je = JEngine({0: JDenoiser[variant]}, resource_size=SIZE)
    je.set_denoiser_settings(0, jreplace(je._settings[0], checkerboardMode=JCB.BLACK))
    je.set_common_settings(cs)
    with pytest.raises(TypeError, match="incompatible shapes"), jax.disable_jit():
        je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
    te = TEngine({0: Denoiser[variant]}, resource_size=SIZE, device="cpu")
    te.set_denoiser_settings(0, replace(te._settings[0], checkerboardMode=CB.BLACK))
    te.set_common_settings(cs)
    with pytest.raises(NotImplementedError, match="checkerboard at a rect"):
        te.denoise([0], pool)
