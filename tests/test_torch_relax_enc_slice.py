"""RELAX and SIGMA at the four RGBA normal encodings end to end: the JAX Engine (run op by op,
`jax.disable_jit()`) against the port's Engine on the CPU, 3 frames of the orbit scene at
64x48 (frame 2 is the first whose TA reprojects a history of two frames, so the specular TA's
virtual motion and the history fix both bite; a fourth frame adds ~15 s of JAX dispatch a case
and nothing these cases do not already reach). IN_NORMAL_ROUGHNESS packed at the encoding
(`nrdtpu_torch.utils.scene.SceneGenerator.packed_normal_roughness`, quantized); the RGBA formats
carry no material.

Cases (`CASES`): RELAX_DIFFUSE_SPECULAR at RGBA8_UNORM and RGBA16_SNORM and under checkerboard
BLACK at RGBA8_SNORM, RELAX_SPECULAR_SH at RGBA16_UNORM, RELAX_SPECULAR at RGBA8_SNORM with
SQ_LINEAR roughness, SIGMA_SHADOW at RGBA8_UNORM and SIGMA_SHADOW_TRANSLUCENCY at RGBA16_SNORM:
each encoding on RELAX, each signedness on SIGMA. The four encodings reach the same kernel
instances (`kDec`) and differ only in `frontend.decode_normal_plane` and the host's encoding
error, which `tests/test_torch_normal_encoding.py` holds at every pixel, so a case a variant
and encoding more would reach nothing new. Bars: every output >= 60 dB PSNR against JAX on
every frame, the history length (SIGMA's history_len) equal on >= 99.9 % of the pixels, and
every call of the eight kernels with a decoded mode (`kernels.DEC_INSTANCES`) made on the
decoded plane.

The SNORM cases pack the sky's normal as (0, 0, 1): an application writes a valid normal
there, and with the scene's own sky normal of 0 the reference fails. SNORM packs 0 exactly,
`safe_normalize(0)` is 0, so N.V is 0 on the sky, and the specular TA's surface-motion
confidence divides 0 by 0 there (`nrdtpu/passes/relax/kernels.py:911-914`, max angle
lobe_half_angle x N.V / framerate scale in `get_encoding_aware_normal_weight`,
`nrdtpu/math.py:680-688`); the NaN sky pixels reach the geometry through taps weighted 0.
`test_reference_fault_snorm_sky` holds that fault of the reference (ROADMAP.md Queue 3), so
the record flips when `nrdtpu/` is repaired. The UNORM cases use the scene as it is: 0 packs
to 0.502 there, which decodes to a non-zero normal.

`test_encoding_moves_the_output` shows that the encoding matters: RELAX_SPECULAR's JAX output
at RGBA8_UNORM is below the bar against its own R10G10B10A2 run.

Run alone: python -m pytest tests/test_torch_relax_enc_slice.py -q (~3.5 min: the JAX Engine op
by op).
"""

import numpy as np
import pytest
import torch

import jax

from nrdtpu.engine import Engine as JEngine
from nrdtpu.settings import AccumulationMode as JAccumulationMode, CheckerboardMode as JCB
from nrdtpu.settings import Denoiser as JDenoiser, NormalEncoding as JNE
from nrdtpu.settings import ResourceType as JRT, RoughnessEncoding as JRE, replace as jreplace
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, NormalEncoding as NE
from nrdtpu_torch.settings import ResourceType as RT, RoughnessEncoding as RE, replace
from nrdtpu_torch.utils.scene import SceneGenerator as TSceneGenerator

from test_torch_reblur_cb import half_width
from test_torch_relax_slice import psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
FRAMES = 3
PSNR_BAR_DB = 60.0
RGBA = ("RGBA8_UNORM", "RGBA8_SNORM", "RGBA16_UNORM", "RGBA16_SNORM")
TRANSLUCENCY_RGB = (0.3, 0.6, 0.2)
# name: (variant, normal encoding, roughness encoding, denoiser settings)
CASES = {
    **{f"DS-{e}": ("RELAX_DIFFUSE_SPECULAR", e, "LINEAR", {})
       for e in ("RGBA8_UNORM", "RGBA16_SNORM")},
    "S_SH-RGBA16_UNORM": ("RELAX_SPECULAR_SH", "RGBA16_UNORM", "LINEAR", {}),
    "DS_CB-RGBA8_SNORM": ("RELAX_DIFFUSE_SPECULAR", "RGBA8_SNORM", "LINEAR",
                          dict(checkerboardMode=CB.BLACK)),
    "S-RGBA8_SNORM-SQ_LINEAR": ("RELAX_SPECULAR", "RGBA8_SNORM", "SQ_LINEAR", {}),
    "SS-RGBA8_UNORM": ("SIGMA_SHADOW", "RGBA8_UNORM", "LINEAR", {}),
    "ST-RGBA16_SNORM": ("SIGMA_SHADOW_TRANSLUCENCY", "RGBA16_SNORM", "LINEAR", {}),
}
RELAX_SIGNALS = {"diff": (RT.IN_DIFF_RADIANCE_HITDIST, RT.OUT_DIFF_RADIANCE_HITDIST,
                          RT.IN_DIFF_SH0, RT.IN_DIFF_SH1, RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1),
                 "spec": (RT.IN_SPEC_RADIANCE_HITDIST, RT.OUT_SPEC_RADIANCE_HITDIST,
                          RT.IN_SPEC_SH0, RT.IN_SPEC_SH1, RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1)}


def outputs_of(variant):
    """The outputs of a variant that the slice compares."""
    if variant.startswith("SIGMA"):
        return (RT.OUT_SHADOW_TRANSLUCENCY,)
    sigs = [sig for sig, part in (("diff", "DIFFUSE"), ("spec", "SPECULAR")) if part in variant]
    if variant.endswith("_SH"):
        return tuple(rt for sig in sigs for rt in RELAX_SIGNALS[sig][4:6])
    return tuple(RELAX_SIGNALS[sig][1] for sig in sigs)


def frames_of(variant, encoding, roughness="LINEAR", checkerboard=CB.OFF, frames=FRAMES,
              sky=True, size=SIZE):
    """(common settings, pool) of each frame of `variant` at the encodings: RELAX's radiance
    and raw hit distance (`relax_pack_radiance_hitdist`; with SH SH0 / SH1, SH1 along the
    normal; under checkerboard at half width), SIGMA's penumbra from the scene's distance to
    the occluder (and a constant translucency). With `sky` the SNORM encodings pack the sky's
    normal as (0, 0, 1)."""
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    snorm = sky and encoding in ("RGBA8_SNORM", "RGBA16_SNORM")
    for i in range(frames):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                RT.IN_NORMAL_ROUGHNESS: TSceneGenerator.packed_normal_roughness(
                    fd, encoding, roughness, sky_normal=(0.0, 0.0, 1.0) if snorm else None)}
        if variant.startswith("SIGMA"):
            dist = torch.from_numpy(fd.dist_to_occluder)
            pool[RT.IN_PENUMBRA] = tfe.sigma_pack_penumbra_directional(
                dist, gen.spec.light_tan_angular_radius).numpy()
            if variant == "SIGMA_SHADOW_TRANSLUCENCY":
                rgb = torch.tensor(TRANSLUCENCY_RGB).expand(size[1], size[0], 3)
                pool[RT.IN_TRANSLUCENCY] = tfe.sigma_pack_translucency(dist, rgb).numpy()
            yield fd.common_settings, pool
            continue
        normal = torch.from_numpy(fd.normal.astype(np.float32))
        for sig, noisy, hit in (("diff", fd.diff_noisy, fd.diff_hit_dist),
                                ("spec", fd.spec_noisy, fd.spec_hit_dist)):
            if {"diff": "DIFFUSE", "spec": "SPECULAR"}[sig] not in variant:
                continue
            rts = RELAX_SIGNALS[sig]
            noisy, hit = torch.from_numpy(noisy), torch.from_numpy(hit)
            if variant.endswith("_SH"):
                planes = zip(rts[2:4], tfe.relax_pack_sh(noisy, hit, normal))
            else:
                planes = [(rts[0], tfe.relax_pack_radiance_hitdist(noisy, hit))]
            for rt, p in planes:
                p = p.numpy()
                pool[rt] = (p if checkerboard == CB.OFF
                            else half_width(p, fd.common_settings.frameIndex, checkerboard))
        yield fd.common_settings, pool


def jax_engine(variant, encoding, roughness="LINEAR", settings=None, size=SIZE):
    je = JEngine({0: JDenoiser[variant]}, resource_size=size, normal_encoding=JNE[encoding],
                 roughness_encoding=JRE[roughness])
    if settings:
        js = {k: (JCB[v.name] if isinstance(v, CB) else v) for k, v in settings.items()}
        je.set_denoiser_settings(0, jreplace(je._settings[0], **js))
    return je


def jax_denoise(je, cs, pool):
    """One frame of the JAX Engine, op by op: one dispatch a primitive, whose per-shape
    compiles every case shares, in place of one whole-graph compile a configuration."""
    je.set_common_settings(cs)
    with jax.disable_jit():
        out = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """A case through both Engines: per frame each output of both, the history lengths, and
    each call's `decoded` of the kernels with a decoded mode."""
    variant, encoding, roughness, settings = CASES[request.param]
    je = jax_engine(variant, encoding, roughness, settings)
    te = TEngine({0: Denoiser[variant]}, resource_size=SIZE, normal_encoding=NE[encoding],
                 roughness_encoding=RE[roughness], device="cpu")
    if settings:
        te.set_denoiser_settings(0, replace(te._settings[0], **settings))
    decoded = {name: [] for name in KM.DEC_INSTANCES}

    def recorder(name, wrapper):
        def rec(*a, **k):
            decoded[name].append(k.get("decoded", False))
            return wrapper(*a, **k)
        return rec
    frames = []
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in KM.DEC_INSTANCES.items():
            base = name[:-len("_dec")]
            mp.setattr(mod, base, recorder(name, getattr(mod, base)))
        for cs, pool in frames_of(variant, encoding, roughness,
                                  settings.get("checkerboardMode", CB.OFF)):
            jo = jax_denoise(je, cs, pool)
            te.set_common_settings(cs)
            to = te.denoise([0], pool)
            r = {rt: (interop.tensor_to_numpy(to[rt]), jo[JRT(int(rt))])
                 for rt in outputs_of(variant)}
            hl = "history_length" if variant.startswith("RELAX") else "history_len"
            r["history_length"] = (interop.tensor_to_numpy(te.get_state(0)[hl]),
                                   np.asarray(je.get_state(0)[hl]))
            frames.append(r)
    return request.param, frames, decoded


@pytest.mark.parametrize("frame", range(FRAMES))
def test_outputs_match_jax(runs, frame):
    name, frames, _ = runs
    for rt, (got, want) in frames[frame].items():
        if rt == "history_length":
            continue
        assert got.shape == want.shape and np.isfinite(got).all(), (name, rt)
        p = psnr(got, want)
        print(f"{name} frame {frame} {rt.name}: {p:.2f} dB against JAX")
        assert p >= PSNR_BAR_DB, f"{name} frame {frame} {rt.name}: {p:.2f} dB"


def test_history_length_matches_jax(runs):
    """RELAX's history length, SIGMA's history_len state."""
    name, frames, _ = runs
    for f in frames:
        got, want = f["history_length"]
        assert np.mean(got == want) >= 0.999, name


def test_kernels_read_the_decoded_plane(runs):
    """Every call of a kernel with a decoded mode reads the decoded plane; each of the
    variant's kernels is called."""
    name, _, decoded = runs
    variant = CASES[name][0]
    expected = ({"sigma_blur_dec"} if variant.startswith("SIGMA") else
                {"relax_prepass_dec", "relax_smb_resolve_dec", "relax_history_fix_dec",
                 "relax_atrous_dec"} | ({"relax_vmb_resolve_dec"} if "SPEC" in variant else set()))
    assert {k for k, v in decoded.items() if v} == expected, name
    assert all(all(v) for v in decoded.values()), name


def test_reference_fault_snorm_sky():
    """The reference's fault (ROADMAP.md Queue 3): RELAX_SPECULAR at RGBA8_SNORM on the scene as
    it is, its sky normals 0, gives non-finite values on geometry on frame 0. This test fails
    once `nrdtpu/` is repaired; then the SNORM cases may drop their sky normal."""
    variant, encoding = "RELAX_SPECULAR", "RGBA8_SNORM"
    je = jax_engine(variant, encoding)
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    hit = gen.frame(0).hit_mask > 0
    cs, pool = next(frames_of(variant, encoding, frames=1, sky=False))
    out = jax_denoise(je, cs, pool)[JRT.OUT_SPEC_RADIANCE_HITDIST]
    bad = ~np.isfinite(out).all(-1)
    print(f"JAX {variant} {encoding}, sky normal 0: {int(bad.sum())} of {bad.size} pixels "
          f"non-finite, {int((bad & hit).sum())} on geometry")
    assert (bad & hit).any()


def test_encoding_moves_the_output():
    """The encoding is not a no-op: RELAX_SPECULAR's JAX output at RGBA8_UNORM is below the bar
    against its R10G10B10A2 run on frame 0."""
    variant = "RELAX_SPECULAR"
    outs = {}
    for encoding in ("R10_G10_B10_A2_UNORM", "RGBA8_UNORM"):
        cs, pool = next(frames_of(variant, encoding, frames=1))
        outs[encoding] = jax_denoise(jax_engine(variant, encoding), cs, pool)[
            JRT.OUT_SPEC_RADIANCE_HITDIST]
    p = psnr(outs["RGBA8_UNORM"], outs["R10_G10_B10_A2_UNORM"])
    print(f"JAX {variant} frame 0, RGBA8_UNORM against R10G10B10A2: {p:.2f} dB")
    assert p < PSNR_BAR_DB


def test_reference_fault_sigma_pallas_rgba(pallas_interpret, monkeypatch):
    """The reference's fault (ROADMAP.md Queue 3): SIGMA's TPU kernels decode .xy of the normal
    plane as an octahedral normal at every encoding (`nrdtpu/kernels/sigma_blur2.py:122`), where
    XLA unpacks the encoding's normal (`nrdtpu/passes/sigma/kernels.py:166`). SIGMA_SHADOW at
    RGBA8_SNORM on frame 0, the JAX Engine's XLA path and its Pallas path (interpret mode), each
    also on the plane with the normal's z negated (the same engine, its history cleared, which a
third run of the first plane checks): the
    XLA path's output moves, the Pallas path's does not (it never reads .z). The gap between
    the two paths is printed. This test fails once `nrdtpu/` is repaired."""
    cs, pool = next(frames_of("SIGMA_SHADOW", "RGBA8_SNORM", frames=1))
    cs.accumulationMode = JAccumulationMode.CLEAR_AND_RESTART
    flipped = dict(pool)
    flipped[RT.IN_NORMAL_ROUGHNESS] = pool[RT.IN_NORMAL_ROUGHNESS] * np.float32((1, 1, -1, 1))
    out = {}
    for impl in ("xla", "pallas"):
        monkeypatch.setenv("NRDTPU_IMPL", impl)
        je = jax_engine("SIGMA_SHADOW", "RGBA8_SNORM")
        je.set_common_settings(cs)
        for key, p in ((False, pool), (True, flipped), ("again", pool)):
            o = je.denoise([0], {JRT(int(k)): v for k, v in p.items()})
            out[impl, key] = np.asarray(o[JRT.OUT_SHADOW_TRANSLUCENCY])
        assert np.array_equal(out[impl, "again"], out[impl, False]), "history not cleared"
    moved = {impl: float(np.abs(out[impl, True] - out[impl, False]).max())
             for impl in ("xla", "pallas")}
    print(f"JAX SIGMA_SHADOW at RGBA8_SNORM, max |d| with the normal's z negated: xla "
          f"{moved['xla']:.3g}, pallas {moved['pallas']:.3g}; Pallas against XLA: "
          f"{psnr(out['pallas', False], out['xla', False]):.2f} dB")
    assert moved["xla"] > 0.0 and moved["pallas"] == 0.0
