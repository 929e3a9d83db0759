"""REBLUR at the four RGBA normal encodings end to end: the JAX Engine (XLA path, run op by op,
`jax.disable_jit()`) against the port's Engine on the CPU, 3 frames of the orbit scene at 64x48
(frame 2 is the first whose TA reprojects a history of two frames). IN_NORMAL_ROUGHNESS is
packed at the encoding (`nrdtpu_torch.utils.scene.SceneGenerator.packed_normal_roughness`,
quantized; the RGBA formats carry no material), the SNORM ones with the sky's normal (0, 0, 1):
with the scene's zero sky normal the reference's specular TA divides 0 by 0 there, as RELAX's
does (ROADMAP.md Queue 3).

At the RGBA formats the JAX Engine runs its one-signal XLA functions for every REBLUR variant
(`nrdtpu/passes/reblur/denoiser.py:204-207`: no Pallas, no fused stage, no band), so one JAX run
of a two-signal variant holds the port's two-signal variant, its band (`NRDTPU_REBLUR_BAND=1`
around the port's engine only) and its one-signal variants. The runs (`RUNS`):
- REBLUR_DIFFUSE_SPECULAR at each of the four encodings: at RGBA8_UNORM also under the band; at
  RGBA8_SNORM with SQ_LINEAR roughness, which also holds REBLUR_SPECULAR there (the filters'
  centres read the decoded roughness at these formats; responsiveAccumulationRoughnessThreshold
  0.5, so that TS's responsive factor reads the roughness too: at its default of 0 it is 1); at
  RGBA16_UNORM with strandMaterialID and cameraAttachedReflectionMaterialID 0, so that the material 0 of the RGBA formats bites
  (every pixel a strand and camera attached: the disocclusion-threshold mix, the virtual-motion
  uv and TS's history weight);
- the SH, occlusion (AREA_3X3) and directional-occlusion variants and checkerboard BLACK are in
  `tests/test_torch_reblur_enc_modes.py`, which shares these helpers, so that no file takes much
  more than a minute.
Bars: every output >= 60 dB PSNR against JAX on every frame, the accumulation speeds (REBLUR's
history length) equal on >= 99.9 % of the pixels, and every call of a kernel with a decoded mode
made on the decoded plane, with no nearest_multi launch (the TA's previous normals come from
bilinear_resolve).

`test_reference_fault_curvature` holds the reference's fault (ROADMAP.md Queue 3): the specular
TA's curvature reads .xy of IN_NORMAL_ROUGHNESS as octahedral at every encoding.

Run alone: python -m pytest tests/test_torch_reblur_enc_slice.py -q
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import AccumulationMode as JAccumulationMode
from nrdtpu.settings import CheckerboardMode as JCB, Denoiser as JDenoiser
from nrdtpu.settings import HitDistanceReconstructionMode as JHM, NormalEncoding as JNE
from nrdtpu.settings import ResourceType as JRT, RoughnessEncoding as JRE, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import CheckerboardMode as CB, Denoiser
from nrdtpu_torch.settings import HitDistanceReconstructionMode as HM, NormalEncoding as NE
from nrdtpu_torch.settings import ResourceType as RT, RoughnessEncoding as RE, replace
from nrdtpu_torch.utils.scene import SceneGenerator as TSceneGenerator

from test_torch_reblur_occ_slice import half_width
from test_torch_reblur_sh_slice import SH_DIRECTIONS
from test_torch_relax_slice import psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 3
PSNR_BAR_DB = 60.0
HOLE_FRACTION = 0.3
HDP = np.array([3.0, 0.1, 20.0, -25.0], np.float32)  # ReblurSettings' hitDistanceParameters
SNORM = ("RGBA8_SNORM", "RGBA16_SNORM")
# kind: each signal's (inputs, outputs)
RESOURCES = {
    "radiance": {"diff": ((RT.IN_DIFF_RADIANCE_HITDIST,), (RT.OUT_DIFF_RADIANCE_HITDIST,)),
                 "spec": ((RT.IN_SPEC_RADIANCE_HITDIST,), (RT.OUT_SPEC_RADIANCE_HITDIST,))},
    "occ": {"diff": ((RT.IN_DIFF_HITDIST,), (RT.OUT_DIFF_HITDIST,)),
            "spec": ((RT.IN_SPEC_HITDIST,), (RT.OUT_SPEC_HITDIST,))},
    "sh": {"diff": ((RT.IN_DIFF_SH0, RT.IN_DIFF_SH1), (RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1)),
           "spec": ((RT.IN_SPEC_SH0, RT.IN_SPEC_SH1), (RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1))},
    "dir": {"diff": ((RT.IN_DIFF_DIRECTION_HITDIST,), (RT.OUT_DIFF_DIRECTION_HITDIST,))}}
MATERIAL_0 = dict(strandMaterialID=0.0, cameraAttachedReflectionMaterialID=0.0)
# run: (JAX variant, normal encoding, roughness encoding, denoiser settings, common settings,
#       the port's engines: {label: (variant, band)})
RUNS = {
    "DS-RGBA8_UNORM": ("REBLUR_DIFFUSE_SPECULAR", "RGBA8_UNORM", "LINEAR", {}, {},
                       {"DS": ("REBLUR_DIFFUSE_SPECULAR", False),
                        "DS+BAND": ("REBLUR_DIFFUSE_SPECULAR", True)}),
    "DS-RGBA16_SNORM": ("REBLUR_DIFFUSE_SPECULAR", "RGBA16_SNORM", "LINEAR", {}, {},
                        {"DS": ("REBLUR_DIFFUSE_SPECULAR", False)}),
    "DS-RGBA8_SNORM-SQ_LINEAR": ("REBLUR_DIFFUSE_SPECULAR", "RGBA8_SNORM", "SQ_LINEAR",
                                 dict(responsiveAccumulationRoughnessThreshold=0.5), {},
                                 {"DS": ("REBLUR_DIFFUSE_SPECULAR", False),
                                  "S": ("REBLUR_SPECULAR", False)}),
    "DS-RGBA16_UNORM-MATERIAL_0": ("REBLUR_DIFFUSE_SPECULAR", "RGBA16_UNORM", "LINEAR", {},
                                   MATERIAL_0, {"DS": ("REBLUR_DIFFUSE_SPECULAR", False)}),
}


def kind_of(variant):
    for suffix, kind in (("_DIRECTIONAL_OCCLUSION", "dir"), ("_OCCLUSION", "occ"), ("_SH", "sh")):
        if variant.endswith(suffix):
            return kind
    return "radiance"


def signals_of(variant):
    return tuple(sig for sig, part in (("diff", "DIFFUSE"), ("spec", "SPECULAR"))
                 if part in variant)


def outputs_of(variant):
    kind = kind_of(variant)
    return tuple(rt for sig in signals_of(variant) for rt in RESOURCES[kind][sig][1])


def pool_of(fd, i, variant, encoding, roughness="LINEAR", cb=CB.OFF, holes=False):
    """The inputs of `variant`'s kind on orbit frame `fd`: REBLUR's radiance and normalized hit
    distance (YCoCg, `reblur_pack_radiance_hitdist`), SH0 / SH1 (SH1 along a direction field of
    the surface, .w drawn per pixel), the binary AO (the specular one a second draw), or the
    directional occlusion of the surface normal; with `holes` the hit distance (AO) zeroed on a
    seeded 30 % of the geometry pixels; under checkerboard at half width."""
    rng = np.random.default_rng((67, i))
    snorm = encoding in SNORM
    pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
            RT.IN_NORMAL_ROUGHNESS: TSceneGenerator.packed_normal_roughness(
                fd, encoding, roughness, sky_normal=(0.0, 0.0, 1.0) if snorm else None)}
    punched = (rng.uniform(size=fd.view_z.shape) < HOLE_FRACTION) & (fd.hit_mask > 0)
    vz = jnp.asarray(fd.view_z)
    kind = kind_of(variant)
    for sig, noisy, hit, rough in (("diff", fd.diff_noisy, fd.diff_hit_dist, 1.0),
                                   ("spec", fd.spec_noisy, fd.spec_hit_dist, fd.roughness)):
        if sig not in signals_of(variant):
            continue
        if kind in ("occ", "dir"):
            ao = (fd.ao_noisy if sig == "diff" else
                  (rng.uniform(size=fd.ao_clean.shape) < fd.ao_clean).astype(np.float32))
            if holes:
                ao = np.where(punched, 0.0, ao).astype(np.float32)
            planes = [ao if kind == "occ" else tfe.reblur_pack_directional_occlusion(
                torch.from_numpy(fd.normal), torch.from_numpy(ao)).numpy()]
        else:
            nhd = np.asarray(jfe.reblur_get_norm_hit_dist(jnp.asarray(hit), vz, jnp.asarray(HDP),
                                                          jnp.asarray(rough)))
            if holes:
                nhd = np.where(punched, 0.0, nhd).astype(np.float32)
            if kind == "sh":
                sh0, sh1 = tfe.reblur_pack_sh(torch.from_numpy(noisy), torch.from_numpy(nhd),
                                              SH_DIRECTIONS[sig](torch.from_numpy(fd.normal)))
                sh1 = sh1.numpy()
                sh1[..., 3] = rng.uniform(0.0, 1.0, fd.view_z.shape)
                planes = [sh0.numpy(), sh1]
            else:
                planes = [np.asarray(jfe.reblur_pack_radiance_hitdist(jnp.asarray(noisy),
                                                                      jnp.asarray(nhd)))]
        for rt, plane in zip(RESOURCES[kind][sig][0], planes):
            pool[rt] = (plane if cb == CB.OFF
                        else half_width(plane, fd.common_settings.frameIndex, cb))
    return pool


def frames_of(variant, encoding, roughness="LINEAR", cb=CB.OFF, holes=False, common=None,
              frames=FRAMES, size=SIZE):
    """(common settings, pool) of each orbit frame."""
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    for i in range(frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        for k, v in (common or {}).items():
            setattr(fd.common_settings, k, v)
        yield fd.common_settings, pool_of(fd, i, variant, encoding, roughness, cb, holes)


def _settings(settings, hm, cbm):
    return {k: hm[v.name] if k == "hitDistanceReconstructionMode" else cbm[v.name]
            if k == "checkerboardMode" else v for k, v in settings.items()}


def jax_engine(variant, encoding, roughness="LINEAR", settings=None):
    je = JEngine({0: JDenoiser[variant]}, resource_size=SIZE, normal_encoding=JNE[encoding],
                 roughness_encoding=JRE[roughness])
    if settings:
        je.set_denoiser_settings(0, jreplace(je._settings[0], **_settings(settings, JHM, JCB)))
    return je


def jax_denoise(je, cs, pool):
    """One frame of the JAX Engine, op by op: one dispatch a primitive, whose per-shape
    compiles every run shares, in place of one whole-graph compile a configuration."""
    je.set_common_settings(cs)
    with jax.disable_jit():
        out = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def port_engine(variant, encoding, roughness="LINEAR", settings=None, size=SIZE):
    te = TEngine({0: Denoiser[variant]}, resource_size=size, normal_encoding=NE[encoding],
                 roughness_encoding=RE[roughness], device="cpu")
    if settings:
        te.set_denoiser_settings(0, replace(te._settings[0], **settings))
    return te


@contextlib.contextmanager
def recording():
    """Each wrapper call's `decoded` of the kernels with a decoded mode ({DEC_INSTANCES name:
    [decoded, ...]}; ts_prelude's specular half only: the diffuse half reads no normal), and the
    calls of nearest_multi and bilinear_resolve."""
    calls = {name: [] for name in KM.DEC_INSTANCES} | {"nearest_multi": [],
                                                       "bilinear_resolve": []}

    def recorder(name, wrapper):
        def rec(*a, **k):
            if not (name == "ts_prelude_dec" and len(a) < 6):  # vmb_uv: the specular half
                calls[name].append(k.get("decoded", False))
            return wrapper(*a, **k)
        return rec
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in KM.DEC_INSTANCES.items():
            base = name[:-len("_dec")]
            mp.setattr(mod, base, recorder(name, getattr(mod, base)))
        for name in ("nearest_multi", "bilinear_resolve"):
            mod = KM.MODULES[name]
            mp.setattr(mod, name, recorder(name, getattr(mod, name)))
        yield calls


def run_case(jvariant, encoding, roughness, settings, common, ports, holes=False):
    """One JAX run and the port's engines on the same frames: per frame each engine's outputs
    and accumulation speeds against JAX's, and each port engine's recorded calls."""
    cb = settings.get("checkerboardMode", CB.OFF)
    je = jax_engine(jvariant, encoding, roughness, settings)
    engs = {label: port_engine(v, encoding, roughness, settings) for label, (v, _) in
            ports.items()}
    frames, calls = [], {}
    for cs, pool in frames_of(jvariant, encoding, roughness, cb, holes, common):
        jo = jax_denoise(je, cs, pool)
        jstate = je.get_state(0)
        frame = {}
        for label, (variant, band) in ports.items():
            engs[label].set_common_settings(cs)
            with pytest.MonkeyPatch.context() as mp, recording() as rec:
                if band:
                    mp.setenv("NRDTPU_REBLUR_BAND", "1")
                out = engs[label].denoise([0], pool)
            for k, v in rec.items():
                calls.setdefault(label, {}).setdefault(k, []).extend(v)
            state = engs[label].get_state(0)
            frame[label] = {rt: (interop.tensor_to_numpy(out[rt]), jo[JRT(int(rt))])
                            for rt in outputs_of(variant)}
            frame[label].update({f"{sig}_accum": (interop.tensor_to_numpy(state[f"{sig}_accum"]),
                                                  np.asarray(jstate[f"{sig}_accum"]))
                                 for sig in signals_of(variant)})
        frames.append(frame)
    return frames, calls


@functools.lru_cache(maxsize=None)
def run(name):
    return run_case(*RUNS[name])


def expected_dec_calls(variant, band, settings):
    """The kernels with a decoded mode that a frame of `variant` calls at the RGBA formats."""
    sigs = signals_of(variant)
    kind = kind_of(variant)
    both = len(sigs) == 2
    calls = {"smb_resolve_dec"}
    if "spec" in sigs:
        calls |= {"spec_ta_head_dec", "vmb_resolve_dec"}
    if settings.get("hitDistanceReconstructionMode", HM.OFF) != HM.OFF:
        calls.add("hitdist_recon_dec")
    if kind in ("radiance", "sh") and "spec" in sigs:
        calls.add("ts_prelude_dec")
    prepass = kind in ("radiance", "sh")
    if both:
        calls |= ({"reblur_band_dec"} | ({"spatial_filter_fused_dec"} if prepass else set())
                  if band else {"spatial_filter_fused_dec", "history_fix_fused_dec"})
    else:
        calls |= {"history_fix_dec", "spatial_filter_dec"}
    return calls


def check_frames(name, frames, calls, ports, settings):
    for i, frame in enumerate(frames):
        for label, res in frame.items():
            for key, (got, want) in res.items():
                if isinstance(key, str):  # the accumulation speed
                    assert np.mean(got == want) >= 0.999, f"{name} {label} {key} frame {i}"
                    continue
                assert got.shape == want.shape and np.isfinite(got).all(), (name, label, key)
                p = psnr(got, want)
                print(f"{name} {label} {key.name} frame {i}: {p:.2f} dB against JAX")
                assert p >= PSNR_BAR_DB, f"{name} {label} {key.name} frame {i}: {p:.2f} dB"
    for label, (variant, band) in ports.items():
        rec = calls[label]
        called = {k for k, v in rec.items() if v and k in KM.DEC_INSTANCES}
        assert called == expected_dec_calls(variant, band, settings), (name, label, called)
        assert all(all(v) for k, v in rec.items() if k in KM.DEC_INSTANCES), (name, label)
        # the previous normals along the virtual motion: bilinear, no stochastic nearest fetch
        assert not rec["nearest_multi"], (name, label)
        assert len(rec["bilinear_resolve"]) == FRAMES * ("spec" in signals_of(variant))


@pytest.mark.parametrize("name", list(RUNS))
def test_port_matches_jax(name):
    """Every output of every port engine >= 60 dB against JAX on every frame, the accumulation
    speeds equal on >= 99.9 % of the pixels, the kernels on the decoded plane."""
    frames, calls = run(name)
    check_frames(name, frames, calls, RUNS[name][5], RUNS[name][3])


def test_reference_fault_curvature():
    """The reference's fault (ROADMAP.md Queue 3): the specular TA decodes .xy of
    IN_NORMAL_ROUGHNESS as an octahedral normal for the curvature at every encoding
    (`nrdtpu/passes/reblur/kernels.py:1094-1097`, `:1126-1128`). Two unquantized RGBA8_UNORM
    planes that decode to the same normals, the best-fit one and one with .xyz moved toward 0.5
    by 0.9 ((p - 0.5) * 0.9 + 0.5): an encoding-correct REBLUR_SPECULAR gives the same output for
    both (the bilinear previous-normal fetch commutes with the affine map, and safe_normalize
    removes the scale), the JAX Engine's moves. Frames 0 and 1, the history cleared between the
    planes. This test fails once `nrdtpu/` is repaired."""
    variant, encoding = "REBLUR_SPECULAR", "RGBA8_UNORM"
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    je = jax_engine(variant, encoding)
    outs = {}
    for scaled in (False, True):
        for i in range(2):
            fd = gen.frame(i)
            fd.common_settings.timeDeltaBetweenFrames = 16.66
            if i == 0:
                fd.common_settings.accumulationMode = JAccumulationMode.CLEAR_AND_RESTART
            pool = pool_of(fd, i, variant, encoding)
            p = tfe.pack_normal_roughness(torch.from_numpy(fd.normal),
                                          torch.from_numpy(fd.roughness),
                                          normal_encoding=NE[encoding]).numpy()
            if scaled:
                p[..., :3] = (p[..., :3] - 0.5) * np.float32(0.9) + np.float32(0.5)
            pool[RT.IN_NORMAL_ROUGHNESS] = p
            outs[scaled, i] = jax_denoise(je, fd.common_settings, pool)[
                JRT.OUT_SPEC_RADIANCE_HITDIST]
    moved = [float(np.abs(outs[True, i] - outs[False, i]).max()) for i in range(2)]
    print(f"JAX {variant} at {encoding}, .xyz moved toward 0.5 by 0.9: max |d| {moved[0]:.3g} "
          f"(frame 0), {moved[1]:.3g} (frame 1); "
          f"{psnr(outs[True, 1], outs[False, 1]):.2f} dB between the two on frame 1")
    assert max(moved) > 0.0
