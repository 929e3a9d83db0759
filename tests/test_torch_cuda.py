"""Hand-written kernels on the card (marker `cuda`; skips where there is no CUDA device).

Each kernel runs on the inputs the main paths give it (frame 4 of the orbit scene at 128x96:
REBLUR_DIFFUSE, REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR, each with and without the
anti-firefly ring and with AREA_3X3 and AREA_5X5 hit-distance reconstruction on inputs with
hit-distance holes; REBLUR_DIFFUSE and REBLUR_SPECULAR in performance mode and with both min
materials 0, REBLUR_SPECULAR with usePrepassOnlyForSpecularMotionEstimation; REBLUR_DIFFUSE_SPECULAR under NRDTPU_REBLUR_BAND=1, by default, with the anti-firefly ring
and in performance mode; SIGMA_SHADOW and SIGMA_SHADOW_TRANSLUCENCY; RELAX_DIFFUSE,
RELAX_SPECULAR and RELAX_DIFFUSE_SPECULAR (the two-signal modes of K16, K19, K20 and K22), each
also with the anti-firefly pass and with AREA_3X3: their kernels, the à-trous at iteration 0
and at the jittered strides; RELAX_DIFFUSE_SH, RELAX_SPECULAR_SH and RELAX_DIFFUSE_SPECULAR_SH,
the SH modes of K15, K16, K17, K19, K20 and K22; REBLUR_DIFFUSE_SH, REBLUR_SPECULAR_SH and
REBLUR_DIFFUSE_SPECULAR_SH, each with and without the anti-firefly ring, the last also in
performance mode, with AREA_3X3 on inputs with holes and under NRDTPU_REBLUR_BAND=1 (default,
the ring, performance mode): the SH modes of H1, N3, H2, H3, N4, N5 and K23; the checkerboard
PrePass of H2 and N4 on
half-width inputs, BLACK and WHITE, REBLUR_SPECULAR also with
usePrepassOnlyForSpecularMotionEstimation (its fallback at every pixel without data); the halo
launcher's `box` body on 1 and 4 channels at two blocks)
and is held against its plain PyTorch version on the same card; the Engine on the card is held
against the Engine on the CPU, for every path and output (the checkerboard paths of REBLUR,
under NRDTPU_REBLUR_BAND=1 too, and of RELAX included), and RELAX_DIFFUSE_SPECULAR's outputs
on the card against RELAX_DIFFUSE's and RELAX_SPECULAR's on the card (with SH likewise). At the
RGBA normal encodings (`RGBA_PATHS`: RELAX_DIFFUSE, RELAX_SPECULAR, RELAX_DIFFUSE_SPECULAR, two
SH variants and both SIGMA variants, with AREA_3X3 / AREA_5X5 and the anti-firefly pass; every
REBLUR variant, with the band, checkerboard, performance mode, the anti-firefly ring and
AREA_3X3 / AREA_5X5 between them) each kernel's decoded-plane instances are held against the
plain versions (H2's, N4's and K23's also at the other tap count), and the Engine on the card
against the Engine on the CPU; K20 `relax_clamp_moments` on NaN histories keeps NaN exactly
where its plain version does. The debug and host surface: OUT_VALIDATION, the printfAt dict
and the SHOW planes on the card against the CPU, the memory query (the state's bytes, a
transient peak > 0, the caller's peak reading kept) and the C ABI on "cuda" against the Engine
on the card (max abs 0). The row-sharded slice: H1, H2, H3, H4, K13 and K14 on bands of rows at a
row origin (`parallel.sharding.band_call`) against their plain versions and the whole-frame launch, and
the Engine on 2 gloo ranks sharing the card (`parallel.launch.spawn`) against the Engine
unsharded. Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: |kernel - plain| <= 1e-4 + 1e-4 |plain| on all but 1e-4 of the values. Both
sides run the same float32 op order (nvcc --fmad=false); exp/rsqrt/division may differ in
the last bit, which can flip a step function (floor snap, plane-distance test) at a pixel
sitting on its threshold.
"""

import numpy as np
import pytest
import torch

from nrdtpu_torch import frontend as fe
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.parallel.sharding import band_call
from nrdtpu_torch.passes.validation import viewport4_masks
from nrdtpu_torch.settings import CheckerboardMode as CB
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode, ResourceType as RT
from nrdtpu_torch.settings import NormalEncoding, replace
from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
SIZE = (128, 96)
ATOL, RTOL, FLIP_FRACTION = 1e-4, 1e-4, 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


VARIANTS = (Denoiser.REBLUR_DIFFUSE, Denoiser.REBLUR_SPECULAR, Denoiser.REBLUR_DIFFUSE_SPECULAR)
SIGMA = (Denoiser.SIGMA_SHADOW, Denoiser.SIGMA_SHADOW_TRANSLUCENCY)
RELAX = (Denoiser.RELAX_DIFFUSE, Denoiser.RELAX_SPECULAR, Denoiser.RELAX_DIFFUSE_SPECULAR)
RELAX_SH = (Denoiser.RELAX_DIFFUSE_SH, Denoiser.RELAX_SPECULAR_SH,
            Denoiser.RELAX_DIFFUSE_SPECULAR_SH)
REBLUR_SH = (Denoiser.REBLUR_DIFFUSE_SH, Denoiser.REBLUR_SPECULAR_SH,
             Denoiser.REBLUR_DIFFUSE_SPECULAR_SH)
REBLUR_OCC = (Denoiser.REBLUR_DIFFUSE_OCCLUSION, Denoiser.REBLUR_SPECULAR_OCCLUSION,
              Denoiser.REBLUR_DIFFUSE_SPECULAR_OCCLUSION)
OCC_RESOURCES = {"DIFFUSE": (RT.IN_DIFF_HITDIST, RT.OUT_DIFF_HITDIST),
                 "SPECULAR": (RT.IN_SPEC_HITDIST, RT.OUT_SPEC_HITDIST)}
DO = Denoiser.REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION
SH_RESOURCES = {"DIFFUSE": (RT.IN_DIFF_SH0, RT.IN_DIFF_SH1, RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1),
                "SPECULAR": (RT.IN_SPEC_SH0, RT.IN_SPEC_SH1, RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1)}
AREA_3X3 = dict(hitDistanceReconstructionMode=HitDistanceReconstructionMode.AREA_3X3)
AREA_5X5 = dict(hitDistanceReconstructionMode=HitDistanceReconstructionMode.AREA_5X5)
# H2's other modes on the one-signal REBLUR paths: performance mode's 6 taps, both min
# materials 0, and the specular PrePass with usePrepassOnlyForSpecularMotionEstimation
SF_SETTINGS = (dict(enablePerformanceMode=True),
               dict(minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0))
PREPASS_ONLY = dict(usePrepassOnlyForSpecularMotionEstimation=True)
# the band's switch, set only while its engines run
BAND = ("NRDTPU_REBLUR_BAND", "1")
BLACK, WHITE = dict(checkerboardMode=CB.BLACK), dict(checkerboardMode=CB.WHITE)


def _half_width(plane, frame, mode):
    """The checkerboard's half-width input of a full-width plane: half texel x holds the pixel
    of the pair (2x, 2x + 1) that has data in this frame under `mode`."""
    h, w = plane.shape[:2]
    has = ((np.arange(w)[None, :] + np.arange(h)[:, None] + frame) & 1) == int(mode) - 1
    sel = np.where(has[:, ::2], 0, 1) + np.arange(0, w, 2)[None, :]
    return np.ascontiguousarray(plane[np.arange(h)[:, None], sel])


def _pools(denoiser, n, holes=False, checkerboard=CB.OFF):
    """Both signals' inputs (with holes: the hit distance zeroed on a seeded 30 % of the
    geometry pixels; under a `checkerboard` mode at half width) and SIGMA's; each path reads
    its own."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    hdp = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
    rng = np.random.default_rng(7)
    for i in range(n):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                RT.IN_MV: fd.mv}
        if denoiser == DO:  # the AO times the surface normal, and the AO
            pool[RT.IN_DIFF_DIRECTION_HITDIST] = fe.reblur_pack_directional_occlusion(
                torch.from_numpy(fd.normal), torch.from_numpy(fd.ao_noisy)).numpy()
        elif denoiser in REBLUR_OCC:  # a binary AO a signal: the scene's, and a second draw
            pool[RT.IN_DIFF_HITDIST] = fd.ao_noisy
            pool[RT.IN_SPEC_HITDIST] = (rng.random(fd.ao_clean.shape) < fd.ao_clean).astype(
                np.float32)
        elif denoiser in RELAX_SH:  # SH0 / SH1 along the normal
            normal = torch.from_numpy(fd.normal.astype(np.float32))
            for part, noisy, hit in (("DIFFUSE", fd.diff_noisy, fd.diff_hit_dist),
                                     ("SPECULAR", fd.spec_noisy, fd.spec_hit_dist)):
                sh0, sh1 = fe.relax_pack_sh(torch.from_numpy(noisy), torch.from_numpy(hit),
                                            normal)
                pool[SH_RESOURCES[part][0]], pool[SH_RESOURCES[part][1]] = sh0.numpy(), sh1.numpy()
        elif denoiser in REBLUR_SH:  # SH0 / SH1 along the normal, SH1's .w drawn per pixel
            normal = torch.from_numpy(fd.normal.astype(np.float32))
            for part, noisy, hit, rough in (
                    ("DIFFUSE", fd.diff_noisy, fd.diff_hit_dist, np.ones_like(fd.roughness)),
                    ("SPECULAR", fd.spec_noisy, fd.spec_hit_dist, fd.roughness)):
                nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(hit),
                                                  torch.from_numpy(fd.view_z), hdp,
                                                  torch.from_numpy(rough))
                sh0, sh1 = fe.reblur_pack_sh(torch.from_numpy(noisy), nhd, normal)
                sh1[..., 3] = torch.from_numpy(rng.random(fd.view_z.shape, dtype=np.float32))
                pool[SH_RESOURCES[part][0]], pool[SH_RESOURCES[part][1]] = sh0.numpy(), sh1.numpy()
        elif denoiser in RELAX:  # raw radiance and raw hit distance
            pool[RT.IN_DIFF_RADIANCE_HITDIST] = fe.relax_pack_radiance_hitdist(
                torch.from_numpy(fd.diff_noisy), torch.from_numpy(fd.diff_hit_dist)).numpy()
            pool[RT.IN_SPEC_RADIANCE_HITDIST] = fe.relax_pack_radiance_hitdist(
                torch.from_numpy(fd.spec_noisy), torch.from_numpy(fd.spec_hit_dist)).numpy()
        else:
            pool[RT.IN_DIFF_RADIANCE_HITDIST] = np.concatenate(
                [fd.diff_noisy, np.full(fd.view_z.shape + (1,), 0.5, np.float32)], -1)
            nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(fd.spec_hit_dist),
                                              torch.from_numpy(fd.view_z), hdp,
                                              torch.from_numpy(fd.roughness))
            pool[RT.IN_SPEC_RADIANCE_HITDIST] = fe.reblur_pack_radiance_hitdist(
                torch.from_numpy(fd.spec_noisy), nhd).numpy()
        if holes:
            hole = (rng.random(fd.view_z.shape) < 0.3) & (fd.hit_mask > 0)
            if denoiser in REBLUR_OCC:
                for rt in (RT.IN_DIFF_HITDIST, RT.IN_SPEC_HITDIST):
                    pool[rt] = np.where(hole, 0.0, pool[rt]).astype(np.float32)
            for rt in ((RT.IN_DIFF_SH0, RT.IN_SPEC_SH0) if denoiser in REBLUR_SH
                       else () if denoiser in REBLUR_OCC
                       else (RT.IN_DIFF_RADIANCE_HITDIST, RT.IN_SPEC_RADIANCE_HITDIST)):
                pool[rt] = pool[rt].copy()
                pool[rt][..., 3][hole] = 0.0
        if checkerboard != CB.OFF:
            for rt in ((RT.IN_DIFF_HITDIST, RT.IN_SPEC_HITDIST) if denoiser in REBLUR_OCC
                       else (RT.IN_DIFF_RADIANCE_HITDIST, RT.IN_SPEC_RADIANCE_HITDIST)):
                pool[rt] = _half_width(pool[rt], i, checkerboard)
        dist = torch.from_numpy(fd.dist_to_occluder)
        pool[RT.IN_PENUMBRA] = fe.sigma_pack_penumbra_directional(
            dist, gen.spec.light_tan_angular_radius).numpy()
        pool[RT.IN_TRANSLUCENCY] = fe.sigma_pack_translucency(
            dist, torch.tensor([0.3, 0.6, 0.2]).expand(SIZE[1], SIZE[0], 3)).numpy()
        yield fd.common_settings, pool


def _outs(denoiser):
    if denoiser == DO:
        return [RT.OUT_DIFF_DIRECTION_HITDIST]
    if denoiser in SIGMA:
        return [RT.OUT_SHADOW_TRANSLUCENCY]
    if denoiser in REBLUR_OCC:
        return [rts[1] for part, rts in OCC_RESOURCES.items() if part in denoiser.name]
    if denoiser in RELAX_SH + REBLUR_SH:
        return [rt for part, rts in SH_RESOURCES.items() if part in denoiser.name
                for rt in rts[2:]]
    return [rt for rt, present in ((RT.OUT_DIFF_RADIANCE_HITDIST, "DIFFUSE" in denoiser.name),
                                   (RT.OUT_SPEC_RADIANCE_HITDIST, "SPECULAR" in denoiser.name))
            if present]


def _engine(denoiser, device, anti_firefly=False, **settings):
    eng = Engine({0: denoiser}, resource_size=SIZE, device=device)
    if denoiser not in SIGMA:
        eng.set_denoiser_settings(0, replace(eng._settings[0], enableAntiFirefly=anti_firefly,
                                             **settings))
    return eng


# (denoiser, anti-firefly ring, settings, inputs with hit-distance holes, band) of every path
PATHS = ([(d, af, {}, False, False) for d in VARIANTS for af in (False, True)]
         + [(d, False, area, True, False) for d in VARIANTS for area in (AREA_3X3, AREA_5X5)]
         + [(d, False, s, False, False) for d in VARIANTS[:2] for s in SF_SETTINGS]
         + [(Denoiser.REBLUR_SPECULAR, False, PREPASS_ONLY, False, False)]
         + [(d, False, {}, False, False) for d in SIGMA]
         + [(d, af, s, h, False) for d in RELAX
            for af, s, h in ((False, {}, False), (True, {}, False), (False, AREA_3X3, True))]
         + [(d, False, {}, False, False) for d in RELAX_SH]
         + [(Denoiser.REBLUR_DIFFUSE_SPECULAR, af, s, False, True)
            for af, s in ((False, {}), (True, {}), (False, dict(enablePerformanceMode=True)))]
         + [(d, False, cb, False, False) for d in VARIANTS for cb in (BLACK, WHITE)]
         + [(Denoiser.REBLUR_SPECULAR, False, dict(WHITE, **PREPASS_ONLY), False, False)]
         + [(d, af, {}, False, False) for d in REBLUR_SH for af in (False, True)]
         + [(REBLUR_SH[2], False, dict(enablePerformanceMode=True), False, False),
            (REBLUR_SH[2], False, AREA_3X3, True, False)]
         + [(REBLUR_SH[2], af, s, False, True)
            for af, s in ((False, {}), (True, {}), (False, dict(enablePerformanceMode=True)))]
         # the occlusion variants: every kernel's one-channel mode
         + [(d, False, {}, False, False) for d in REBLUR_OCC]
         + [(REBLUR_OCC[2], False, s, h, False)
            for s, h in ((AREA_3X3, True), (AREA_5X5, True), (dict(enablePerformanceMode=True),
                                                              False))]
         + [(REBLUR_OCC[2], False, s, False, True)
            for s in ({}, dict(enablePerformanceMode=True))])


@pytest.fixture(scope="module")
def recorded(cuda):
    calls = []
    originals = {n: getattr(m, n) for n, m in KM.MODULES.items()}
    for denoiser, anti_firefly, settings, holes, band in PATHS:
        eng = _engine(denoiser, cuda, anti_firefly, **settings)
        pools = list(_pools(denoiser, 4, holes, settings.get("checkerboardMode", CB.OFF)))
        try:
            with pytest.MonkeyPatch.context() as mp:
                if band:
                    mp.setenv(*BAND)
                for i, (cs, pool) in enumerate(pools):
                    if i == len(pools) - 1:
                        for n, m in KM.MODULES.items():
                            def rec(*a, _n=n, _f=originals[n], **k):
                                calls.append((_n, a, k))
                                return _f(*a, **k)
                            setattr(m, n, rec)
                    eng.set_common_settings(cs)
                    eng.denoise([0], pool)
        finally:
            for n, m in KM.MODULES.items():
                setattr(m, n, originals[n])
    # the halo launcher, which no path calls: `box` on 1 and 4 channels, at a block that
    # divides the image and at one that does not
    rng = np.random.default_rng(3)
    for c in (1, 4):
        img = torch.from_numpy(rng.random((SIZE[1], SIZE[0]) + (() if c == 1 else (c,)),
                                          dtype=np.float32)).to(cuda)
        for block in ((64, 256), (16, 24)):
            calls.append(("halo_call", ("box", [img], [c], 4, block), {}))
    return calls


def _flat(r):
    if isinstance(r, dict):
        return {k: r[k] for k in sorted(r)}
    return {str(i): v for i, v in enumerate(r)} if isinstance(r, tuple) else {"out": r}


@pytest.mark.parametrize("name", sorted(KM.MODULES))
def test_kernel_matches_plain_version(recorded, name):
    calls = [(a, k) for n, a, k in recorded if n == name]
    assert calls
    mod = KM.MODULES[name]
    for a, k in calls:
        before = mod.launches
        got = _flat(getattr(mod, name)(*a, **k))
        assert mod.launches == before + 1
        want = _flat(getattr(mod, name + "_ref")(*a, **k))
        torch.cuda.synchronize()
        for key, w in want.items():
            g, w = got[key].float(), w.float()
            over = ((g - w).abs() > ATOL + RTOL * w.abs()).float().mean().item()
            assert over <= FLIP_FRACTION, f"{name}.{key}: {over:.3g} of values out of tolerance"


@pytest.mark.parametrize("denoiser", VARIANTS + RELAX, ids=lambda d: d.name)
@pytest.mark.parametrize("anti_firefly", [False, True], ids=["default", "anti_firefly"])
def test_engine_card_matches_cpu(cuda, denoiser, anti_firefly):
    card = _engine(denoiser, cuda, anti_firefly)
    cpu = _engine(denoiser, "cpu", anti_firefly)
    for cs, pool in _pools(denoiser, 4):
        outs = []
        for eng in (card, cpu):
            eng.set_common_settings(cs)
            outs.append(eng.denoise([0], pool))
        for rt in _outs(denoiser):
            a, b = outs[0][rt].cpu().double(), outs[1][rt].cpu().double()
            mse = float(((a - b) ** 2).mean())
            peak = float(b.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, rt


@pytest.mark.parametrize("anti_firefly,settings", [(False, {}), (True, {}),
                                                   (False, dict(enablePerformanceMode=True))],
                         ids=["default", "anti_firefly", "perf"])
def test_engine_card_matches_cpu_band(cuda, anti_firefly, settings, monkeypatch):
    """REBLUR_DIFFUSE_SPECULAR under NRDTPU_REBLUR_BAND=1: the band kernel on the card."""
    monkeypatch.setenv(*BAND)
    card = _engine(Denoiser.REBLUR_DIFFUSE_SPECULAR, cuda, anti_firefly, **settings)
    cpu = _engine(Denoiser.REBLUR_DIFFUSE_SPECULAR, "cpu", anti_firefly, **settings)
    for cs, pool in _pools(Denoiser.REBLUR_DIFFUSE_SPECULAR, 4):
        outs = []
        for eng in (card, cpu):
            eng.set_common_settings(cs)
            outs.append(eng.denoise([0], pool))
        for rt in _outs(Denoiser.REBLUR_DIFFUSE_SPECULAR):
            a, b = outs[0][rt].cpu().double(), outs[1][rt].cpu().double()
            mse = float(((a - b) ** 2).mean())
            peak = float(b.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, rt


@pytest.mark.parametrize("denoiser,settings,holes,band",
                         [(d, AREA_3X3, True, False) for d in VARIANTS + RELAX + REBLUR_SH[2:]]
                         + [(d, {}, False, False) for d in SIGMA + RELAX + RELAX_SH + REBLUR_SH]
                         + [(REBLUR_SH[2], {}, False, True)],
                         ids=[f"{d.name}-AREA_3X3" for d in VARIANTS + RELAX + REBLUR_SH[2:]]
                         + [d.name for d in SIGMA + RELAX + RELAX_SH + REBLUR_SH]
                         + [f"{REBLUR_SH[2].name}-BAND"])
def test_engine_card_matches_cpu_new_paths(cuda, denoiser, settings, holes, band, monkeypatch):
    """Hit-distance reconstruction on inputs with holes, the SIGMA variants, and the RELAX and
    REBLUR variants with and without SH (REBLUR_DIFFUSE_SPECULAR_SH also under the band)."""
    if band:
        monkeypatch.setenv(*BAND)
    card = _engine(denoiser, cuda, **settings)
    cpu = _engine(denoiser, "cpu", **settings)
    for cs, pool in _pools(denoiser, 4, holes):
        outs = []
        for eng in (card, cpu):
            eng.set_common_settings(cs)
            outs.append(eng.denoise([0], pool))
        for rt in _outs(denoiser):
            a, b = outs[0][rt].cpu().double(), outs[1][rt].cpu().double()
            mse = float(((a - b) ** 2).mean())
            peak = float(b.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, rt


@pytest.mark.parametrize("sh", [False, True], ids=["default", "sh"])
def test_relax_pair_matches_one_signal_variants(cuda, sh):
    """RELAX_DIFFUSE_SPECULAR's outputs on the card against RELAX_DIFFUSE's and RELAX_SPECULAR's
    on the card, frame by frame (the JAX package gives them bit for bit): the two-signal
    kernel modes compute each signal as the one-signal modes do; with `sh` the same of the SH
    variants' four outputs."""
    pair_d = RELAX_SH[2] if sh else Denoiser.RELAX_DIFFUSE_SPECULAR
    pair = _engine(pair_d, cuda)
    singles = {rt: _engine(d, cuda) for d in ((RELAX_SH[:2]) if sh else RELAX[:2])
               for rt in _outs(d)}
    for cs, pool in _pools(pair_d, 4):
        pair.set_common_settings(cs)
        outs = pair.denoise([0], pool)
        for rt, eng in singles.items():
            eng.set_common_settings(cs)
            w = eng.denoise([0], pool)[rt].float()
            over = ((outs[rt].float() - w).abs() > ATOL + RTOL * w.abs()).float().mean().item()
            assert over <= FLIP_FRACTION, f"{rt.name}: {over:.3g} of values out of tolerance"


@pytest.mark.parametrize("denoiser,settings,band",
                         [(d, cb, False) for d in VARIANTS + RELAX for cb in (BLACK, WHITE)]
                         + [(Denoiser.REBLUR_DIFFUSE_SPECULAR, BLACK, True)],
                         ids=[f"{d.name}-{cb['checkerboardMode'].name}" for d in VARIANTS + RELAX
                              for cb in (BLACK, WHITE)] + ["REBLUR_DIFFUSE_SPECULAR-BLACK-band"])
def test_engine_card_matches_cpu_checkerboard(cuda, denoiser, settings, band, monkeypatch):
    """The checkerboard paths on half-width inputs: H2's and N4's checkerboard PrePass, the
    RELAX front resolve and the TA's slower accumulation where a pixel has no data."""
    if band:
        monkeypatch.setenv(*BAND)
    card = _engine(denoiser, cuda, **settings)
    cpu = _engine(denoiser, "cpu", **settings)
    for cs, pool in _pools(denoiser, 4, checkerboard=settings["checkerboardMode"]):
        outs = []
        for eng in (card, cpu):
            eng.set_common_settings(cs)
            outs.append(eng.denoise([0], pool))
        for rt in _outs(denoiser):
            a, b = outs[0][rt].cpu().double(), outs[1][rt].cpu().double()
            mse = float(((a - b) ** 2).mean())
            peak = float(b.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, rt


@pytest.mark.parametrize("denoiser,settings,band",
                         [(d, {}, False) for d in REBLUR_OCC]
                         + [(REBLUR_OCC[2], {}, True), (REBLUR_OCC[2], BLACK, False),
                            (REBLUR_OCC[2], BLACK, True)],
                         ids=[d.name for d in REBLUR_OCC]
                         + ["REBLUR_DIFFUSE_SPECULAR_OCCLUSION-band",
                            "REBLUR_DIFFUSE_SPECULAR_OCCLUSION-BLACK",
                            "REBLUR_DIFFUSE_SPECULAR_OCCLUSION-BLACK-band"])
def test_engine_card_matches_cpu_occlusion(cuda, denoiser, settings, band, monkeypatch):
    """The occlusion variants on the binary AO: the kernels' one-channel modes, also under the
    band and under checkerboard (the neighbour resolve as glue)."""
    if band:
        monkeypatch.setenv(*BAND)
    card = _engine(denoiser, cuda, **settings)
    cpu = _engine(denoiser, "cpu", **settings)
    for cs, pool in _pools(denoiser, 4, checkerboard=settings.get("checkerboardMode", CB.OFF)):
        outs = []
        for eng in (card, cpu):
            eng.set_common_settings(cs)
            outs.append(eng.denoise([0], pool))
        for rt in _outs(denoiser):
            a, b = outs[0][rt].cpu().double(), outs[1][rt].cpu().double()
            assert a.shape == (SIZE[1], SIZE[0], 1)
            mse = float(((a - b) ** 2).mean())
            peak = float(b.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, rt


# The RGBA normal encodings: (denoiser, normal encoding, settings, inputs with holes) of the
# paths whose kernels read the decoded plane (`kDec`), the SNORM ones with the sky's normal
# (0, 0, 1) (`tests/test_torch_relax_enc_slice.py` says why)
NE = NormalEncoding
PERF = dict(enablePerformanceMode=True)
RGBA_PATHS = [(Denoiser.RELAX_DIFFUSE_SPECULAR, NE.RGBA8_UNORM, AREA_3X3, True),
              (Denoiser.RELAX_DIFFUSE_SPECULAR, NE.RGBA16_SNORM,
               dict(enableAntiFirefly=True), False),
              (Denoiser.RELAX_SPECULAR, NE.RGBA8_SNORM, AREA_5X5, True),
              (Denoiser.RELAX_DIFFUSE, NE.RGBA16_UNORM, {}, False),
              (Denoiser.RELAX_SPECULAR_SH, NE.RGBA8_SNORM, {}, False),
              (Denoiser.RELAX_DIFFUSE_SPECULAR_SH, NE.RGBA16_UNORM, {}, False),
              (Denoiser.SIGMA_SHADOW, NE.RGBA8_SNORM, {}, False),
              (Denoiser.SIGMA_SHADOW_TRANSLUCENCY, NE.RGBA8_UNORM, {}, False),
              # REBLUR: every kDec instance's structure between them (`BAND` in the settings:
              # NRDTPU_REBLUR_BAND=1 around the engine)
              (Denoiser.REBLUR_DIFFUSE_SPECULAR, NE.RGBA8_UNORM, dict(enableAntiFirefly=True),
               False),
              (Denoiser.REBLUR_DIFFUSE_SPECULAR, NE.RGBA16_SNORM, dict(AREA_3X3, BAND=True), True),
              (Denoiser.REBLUR_DIFFUSE_SPECULAR, NE.RGBA16_UNORM, dict(BLACK, **PERF), False),
              (REBLUR_SH[2], NE.RGBA8_SNORM, dict(BAND=True), False),
              (REBLUR_SH[2], NE.RGBA16_UNORM, {}, False),
              (REBLUR_OCC[2], NE.RGBA16_UNORM, AREA_5X5, True),
              (REBLUR_OCC[2], NE.RGBA8_UNORM, dict(BAND=True), False),
              (Denoiser.REBLUR_DIFFUSE, NE.RGBA16_UNORM, dict(WHITE, **PERF), False),
              (Denoiser.REBLUR_DIFFUSE, NE.RGBA8_SNORM, dict(enableAntiFirefly=True), False),
              (Denoiser.REBLUR_SPECULAR, NE.RGBA8_SNORM,
               dict(responsiveAccumulationRoughnessThreshold=0.5), False),
              (Denoiser.REBLUR_SPECULAR, NE.RGBA16_SNORM, BLACK, False),
              (REBLUR_SH[0], NE.RGBA16_SNORM, {}, False),
              (REBLUR_SH[1], NE.RGBA8_UNORM, PERF, False),
              (REBLUR_OCC[0], NE.RGBA8_SNORM, {}, False),
              (REBLUR_OCC[1], NE.RGBA16_UNORM, AREA_3X3, True),
              (DO, NE.RGBA8_UNORM, {}, False)]


def _rgba_pools(denoiser, encoding, n, holes=False, settings=None):
    """`_pools` with IN_NORMAL_ROUGHNESS packed at the RGBA encoding (quantized), at half width
    under the settings' checkerboard mode."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    cb = (settings or {}).get("checkerboardMode", CB.OFF)
    for i, (cs, pool) in enumerate(_pools(denoiser, n, holes, cb)):
        sky = (0.0, 0.0, 1.0) if encoding in fe.SNORM_ENCODINGS else None
        pool[RT.IN_NORMAL_ROUGHNESS] = gen.packed_normal_roughness(gen.frame(i), encoding,
                                                                   sky_normal=sky)
        yield cs, pool


def _rgba_engine(denoiser, encoding, device, settings):
    eng = Engine({0: denoiser}, resource_size=SIZE, device=device, normal_encoding=encoding)
    if denoiser not in SIGMA:
        eng.set_denoiser_settings(0, replace(eng._settings[0], **{
            k: v for k, v in settings.items() if k != "BAND"}))
    return eng


def _band(monkeypatch, settings):
    """NRDTPU_REBLUR_BAND=1 where the path's settings ask for the band."""
    if settings.get("BAND"):
        monkeypatch.setenv("NRDTPU_REBLUR_BAND", "1")
    else:
        monkeypatch.delenv("NRDTPU_REBLUR_BAND", raising=False)


@pytest.fixture(scope="module")
def recorded_dec(cuda):
    """The last frame's calls of the kernels with a decoded mode on every RGBA path (TS's
    diffuse half, which reads no normal, left out)."""
    calls = []
    names = [name.removesuffix("_dec") for name in KM.DEC_INSTANCES]
    originals = {n: getattr(KM.MODULES[n], n) for n in names}
    for denoiser, encoding, settings, holes in RGBA_PATHS:
        eng = _rgba_engine(denoiser, encoding, cuda, settings)
        pools = list(_rgba_pools(denoiser, encoding, 4, holes, settings))
        mp = pytest.MonkeyPatch()
        _band(mp, settings)
        try:
            for i, (cs, pool) in enumerate(pools):
                if i == len(pools) - 1:
                    for n in names:
                        def rec(*a, _n=n, _f=originals[n], **k):
                            if not (_n == "ts_prelude" and len(a) < 6):
                                calls.append((_n, a, k))
                            return _f(*a, **k)
                        setattr(KM.MODULES[n], n, rec)
                eng.set_common_settings(cs)
                eng.denoise([0], pool)
        finally:
            mp.undo()
            for n in names:
                setattr(KM.MODULES[n], n, originals[n])
    return calls


def _other_taps(kernel, k):
    """H2, N4 and K23 also at the other tap count (performance mode's 6, or 8)."""
    if kernel not in ("spatial_filter", "spatial_filter_fused", "reblur_band"):
        return [k]
    return [k, dict(k, perf_mode=not k.get("perf_mode", False))]


@pytest.mark.parametrize("name", sorted(KM.DEC_INSTANCES))
def test_dec_instance_matches_plain_version(recorded_dec, name):
    """Each kernel's decoded-plane instances (`kDec`) on the RGBA paths' inputs."""
    kernel = name.removesuffix("_dec")
    calls = [(a, k2) for n, a, k in recorded_dec if n == kernel for k2 in _other_taps(n, k)]
    assert calls and all(k["decoded"] for _, k in calls)
    mod = KM.MODULES[kernel]
    for a, k in calls:
        before = mod.dec_launches
        got = _flat(getattr(mod, kernel)(*a, **k))
        assert mod.dec_launches == before + 1
        want = _flat(getattr(mod, kernel + "_ref")(*a, **k))
        torch.cuda.synchronize()
        for key, w in want.items():
            g, w = got[key].float(), w.float()
            over = ((g - w).abs() > ATOL + RTOL * w.abs()).float().mean().item()
            assert over <= FLIP_FRACTION, f"{name}.{key}: {over:.3g} of values out of tolerance"


@pytest.mark.parametrize("denoiser,encoding,settings,holes", RGBA_PATHS,
                         ids=[f"{d.name}-{e.name}-{i}" for i, (d, e, _, _)
                              in enumerate(RGBA_PATHS)])
def test_engine_card_matches_cpu_rgba(cuda, denoiser, encoding, settings, holes, monkeypatch):
    """Every variant at the RGBA normal encodings: the Engine on the card against the Engine
    on the CPU, every output >= 50 dB."""
    _band(monkeypatch, settings)
    card = _rgba_engine(denoiser, encoding, cuda, settings)
    cpu = _rgba_engine(denoiser, encoding, "cpu", settings)
    for cs, pool in _rgba_pools(denoiser, encoding, 4, holes, settings):
        outs = []
        for eng in (card, cpu):
            eng.set_common_settings(cs)
            outs.append(eng.denoise([0], pool))
        for rt in _outs(denoiser):
            a, b = outs[0][rt].cpu().double(), outs[1][rt].cpu().double()
            assert bool(torch.isfinite(a).all())
            mse = float(((a - b) ** 2).mean())
            peak = float(b.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, rt


def test_clamp_moments_keeps_nan(cuda):
    """K20 on NaN inputs (ROADMAP.md Queue 3, closed): RELAX_DIFFUSE's history clamping on the
    last frame at RGBA8_SNORM, its responsive and slow histories NaN on a seeded 5 % of the
    pixels each: the kernel's outputs are non-finite exactly where the plain version's are, and
    the finite values agree within the tolerance."""
    mod = KM.MODULES["relax_clamp_moments"]
    f, rec = mod.relax_clamp_moments, []

    def r(*a, **k):
        rec.append((a, k))
        return f(*a, **k)
    eng = _rgba_engine(Denoiser.RELAX_DIFFUSE, NE.RGBA8_SNORM, cuda, {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "relax_clamp_moments", r)
        for cs, pool in _rgba_pools(Denoiser.RELAX_DIFFUSE, NE.RGBA8_SNORM, 4):
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    a, k = rec[-1]
    a = list(a)
    gen = torch.Generator(device="cpu").manual_seed(97)
    for i in (1, 5):  # fast, slow
        t = a[i].clone()
        t[(torch.rand(t.shape[:2], generator=gen) < 0.05).to(t.device)] = float("nan")
        a[i] = t
    got, want = mod.relax_clamp_moments(*a, **k), mod.relax_clamp_moments_ref(*a, **k)
    for g, w in zip(got, want):
        assert bool(torch.isnan(w).any())
        assert torch.equal(~torch.isfinite(g), ~torch.isfinite(w))
        fin = torch.isfinite(w)
        over = ((g[fin] - w[fin]).abs() > ATOL + RTOL * w[fin].abs()).float().mean().item()
        assert over <= FLIP_FRACTION


NAN_KERNELS = ("relax_smb_resolve", "relax_vmb_resolve", "relax_atrous")


@pytest.fixture(scope="module")
def snorm_fault_calls(cuda):
    """Every card call of K16, K17 and K22 over 4 frames of RELAX_SPECULAR at RGBA8_SNORM with
    the scene's zero sky normal: the reference's fault leaves NaN in the specular TA's output
    (ROADMAP.md Queue 3), which reaches the histories K16 and K17 sample and the signal K22
    filters."""
    rec = {n: [] for n in NAN_KERNELS}
    eng = _rgba_engine(Denoiser.RELAX_SPECULAR, NE.RGBA8_SNORM, cuda, {})
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")

    def recorder(n, wrapper):
        def r(*a, **k):
            rec[n].append((a, k))
            return wrapper(*a, **k)
        return r
    with pytest.MonkeyPatch.context() as mp:
        for n in NAN_KERNELS:
            mp.setattr(KM.MODULES[n], n, recorder(n, getattr(KM.MODULES[n], n)))
        for i, (cs, pool) in enumerate(_pools(Denoiser.RELAX_SPECULAR, 4)):
            pool[RT.IN_NORMAL_ROUGHNESS] = gen.packed_normal_roughness(gen.frame(i),
                                                                       NE.RGBA8_SNORM)
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
    return rec


@pytest.mark.parametrize("name", NAN_KERNELS)
def test_relax_kernels_keep_nan(snorm_fault_calls, name):
    """K16, K17 and K22 on the SNORM sky fault's frames (ROADMAP.md Queue 3, closed): on every
    call each output's non-finite values lie exactly where the plain version's do, and the
    finite values agree within the tolerance."""
    mod = KM.MODULES[name]
    nonfinite = 0
    for a, k in snorm_fault_calls[name]:
        got, want = _flat(getattr(mod, name)(*a, **k)), _flat(getattr(mod, name + "_ref")(*a, **k))
        for key, w in want.items():
            if not isinstance(w, torch.Tensor):
                continue
            g, w = got[key].float(), w.float()
            nonfinite += int((~torch.isfinite(w)).sum())
            assert torch.equal(~torch.isfinite(g), ~torch.isfinite(w)), (name, key)
            fin = torch.isfinite(w)
            over = ((g[fin] - w[fin]).abs() > ATOL + RTOL * w[fin].abs()).sum().item()
            assert over <= FLIP_FRACTION * max(int(fin.sum()), 1), (name, key)
    assert nonfinite, name


RECT_SEQUENCE = [(128, 96), (128, 96), (101, 77), (117, 83), (128, 96)]


@pytest.mark.parametrize("denoiser", [Denoiser.REBLUR_DIFFUSE_SPECULAR,
                                      Denoiser.RELAX_DIFFUSE_SPECULAR,
                                      Denoiser.SIGMA_SHADOW_TRANSLUCENCY], ids=lambda d: d.name)
def test_engine_card_matches_cpu_rect_change(cuda, denoiser):
    """Dynamic resolution on the card: the resource 128x96 and rects 128x96, 101x77, 117x83,
    128x96 (`cs.rectSize`, `cs.rectSizePrev` the rect before), the scene's frames at the
    resource with NaN outside the rect. Every output >= 50 dB against the Engine on the CPU
    inside the rect and 0 outside; the state has the rect's shape."""
    card, cpu = _engine(denoiser, cuda), _engine(denoiser, "cpu")
    for i, (cs, pool) in enumerate(_pools(denoiser, len(RECT_SEQUENCE))):
        rw, rh = RECT_SEQUENCE[i]
        cs.rectSize, cs.rectSizePrev = (rw, rh), RECT_SEQUENCE[max(i - 1, 0)]
        pool = {key: v.copy() for key, v in pool.items()}
        for v in pool.values():
            v[rh:] = np.nan
            v[:, rw:] = np.nan
        outs = []
        for eng in (card, cpu):
            eng.set_common_settings(cs)
            outs.append(eng.denoise([0], pool))
        for rt in _outs(denoiser):
            a, b = outs[0][rt].cpu().double(), outs[1][rt].cpu().double()
            assert tuple(a.shape[:2]) == (SIZE[1], SIZE[0])
            assert bool(torch.isfinite(a[:rh, :rw]).all())
            assert not a[rh:].any() and not a[:, rw:].any()
            mse = float(((a - b) ** 2).mean())
            peak = float(b.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, (i, rt)
        assert all(tuple(t.shape[:2]) == (rh, rw) for t in card.get_state(0).values()
                   if t.ndim >= 2)


# ---------------------------------------------------------------------------------------------
# the debug and host surface on the card: the overlay, the probe and SHOW, the memory query and
# the C ABI, each against the same on the CPU
# ---------------------------------------------------------------------------------------------

PROBE_AT = (80, 60)  # a geometry pixel of the orbit scene's frames at SIZE


def _debug_run(device, denoiser, n, validation=True, printf=True, show=None):
    eng = _engine(denoiser, device)
    eng.set_debug_show(show)
    out = []
    for cs, pool in _pools(denoiser, n):
        cs.enableValidation = validation
        cs.printfAt = PROBE_AT if printf else (9999, 9999)
        eng.set_common_settings(cs)
        o = eng.denoise([0], pool)
        out.append({k: (v if k == Engine.PROBE_KEY or v is None else v.cpu())
                    for k, v in o.items()})
    return eng, out


@pytest.mark.parametrize("denoiser", [Denoiser.REBLUR_DIFFUSE_SPECULAR, Denoiser.RELAX_DIFFUSE],
                         ids=lambda d: d.name)
def test_overlay_card_matches_cpu(cuda, denoiser):
    """OUT_VALIDATION on the card against the CPU over 3 frames: frame 0 all zeros, then every
    channel within 1e-4 abs + 1e-4 rel, the world-units layer by the wrap-aware distance
    min(|d|, 1 - |d|); every other output equal to the card's run without the debug modes."""
    _, card = _debug_run(cuda, denoiser, 3)
    _, cpu = _debug_run("cpu", denoiser, 3)
    _, plain = _debug_run(cuda, denoiser, 3, validation=False, printf=False)
    units = np.repeat(viewport4_masks(SIZE[1], SIZE[0])[1][..., None], 4, -1)
    units[..., 3] = False  # the alpha is exact
    for i, (a, b, c) in enumerate(zip(card, cpu, plain)):
        got, want = a[RT.OUT_VALIDATION].numpy(), b[RT.OUT_VALIDATION].numpy()
        if i == 0:
            assert not got.any() and not want.any()
        d = np.abs(got - want)
        d[units] = np.minimum(d[units], 1.0 - d[units])
        assert (d <= ATOL + RTOL * np.abs(want)).all(), (i, float(d.max()))
        for rt in _outs(denoiser):
            assert torch.equal(a[rt], c[rt]), (i, rt)


def test_probe_and_show_card_match_cpu(cuda):
    """REBLUR_DIFFUSE_SPECULAR's printfAt dict on the card has the CPU's keys and values within
    1e-4 abs + 1e-4 rel; its SHOW planes ("reblur/ta/virtual_history_confidence",
    "reblur/hfix/spec_fast_history") >= 50 dB against the CPU's, the bar of every output card
    against CPU: the confidences are step functions of the TA's glue, whose transcendental
    functions differ in the last bit between the card and the CPU."""
    _, card = _debug_run(cuda, Denoiser.REBLUR_DIFFUSE_SPECULAR, 2)
    _, cpu = _debug_run("cpu", Denoiser.REBLUR_DIFFUSE_SPECULAR, 2)
    for a, b in zip(card, cpu):
        pa, pb = a[Engine.PROBE_KEY], b[Engine.PROBE_KEY]
        assert set(pa) == set(pb) and len(pb) == 14
        for k in pb:
            assert pa[k].device.type == "cuda"
            np.testing.assert_allclose(pa[k].cpu().float().numpy(), pb[k].float().numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    for tag in ("reblur/ta/virtual_history_confidence", "reblur/hfix/spec_fast_history"):
        _, card = _debug_run(cuda, Denoiser.REBLUR_DIFFUSE_SPECULAR, 2, False, False, tag)
        _, cpu = _debug_run("cpu", Denoiser.REBLUR_DIFFUSE_SPECULAR, 2, False, False, tag)
        for a, b in zip(card, cpu):
            got, want = a[Engine.SHOW_KEY].double(), b[Engine.SHOW_KEY].double()
            assert tuple(got.shape) == (SIZE[1], SIZE[0])
            mse = float(((got - want) ** 2).mean())
            peak = float(want.abs().max())
            assert mse == 0.0 or 10.0 * np.log10(peak * peak / mse) >= 50.0, tag


@pytest.mark.parametrize("denoiser", [Denoiser.REBLUR_DIFFUSE_SPECULAR,
                                      Denoiser.RELAX_DIFFUSE_SPECULAR,
                                      Denoiser.SIGMA_SHADOW_TRANSLUCENCY], ids=lambda d: d.name)
def test_memory_query_on_card(cuda, denoiser):
    """`persistent_mb` is the state's bytes (the overlay's too), `aliasable_mb` the first
    frame's transient peak (> 0), and the caller's peak reading is never lowered by it."""
    torch.cuda.synchronize()
    big = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    del big  # a transient peak of the caller's, before the engine's first frame
    before = torch.cuda.max_memory_allocated()
    eng, _ = _debug_run(cuda, denoiser, 2, printf=False)
    mem = eng.get_memory_usage(0)
    state = sum(t.numel() * t.element_size() for t in eng.get_state(0).values())
    assert mem["persistent_mb"] == state / 2 ** 20
    assert mem["aliasable_mb"] > 0.0
    assert mem["total_mb"] == mem["persistent_mb"] + mem["aliasable_mb"]
    assert torch.cuda.max_memory_allocated() >= before


def test_c_abi_on_card(cuda):
    """Through the C ABI on "cuda", REBLUR_DIFFUSE_SPECULAR with the overlay over 3 frames equals
    the port's Engine on the card on the same inputs (max abs 0), OUT_VALIDATION included."""
    import ctypes

    from nrdtpu_torch.native import bindings as B

    lib = B.load()
    w, h = SIZE
    d = Denoiser.REBLUR_DIFFUSE_SPECULAR
    descs = (B.DenoiserDescC * 1)(B.DenoiserDescC(0, int(d)))
    inst = ctypes.c_void_p()
    assert lib.nrdtpu_create_instance(descs, 1, w, h, 2, 1, ctypes.byref(inst)) == 0, \
        lib.nrdtpu_get_last_error()
    eng = Engine({0: d}, resource_size=SIZE, device=cuda)
    rts = _outs(d) + [RT.OUT_VALIDATION]
    try:
        for cs, pool in _pools(d, 3):
            cs.enableValidation = True
            c = B.common_settings_c(cs)
            assert lib.nrdtpu_set_common_settings(inst, ctypes.byref(c)) == 0
            planes = {k: np.ascontiguousarray(v, np.float32) for k, v in pool.items()
                      if k in (RT.IN_VIEWZ, RT.IN_MV, RT.IN_NORMAL_ROUGHNESS,
                               RT.IN_DIFF_RADIANCE_HITDIST, RT.IN_SPEC_RADIANCE_HITDIST)}
            outs = {rt: np.full((h, w, 4), np.nan, np.float32) for rt in rts}
            slots = [B.slot(k, v) for k, v in {**planes, **outs}.items()]
            assert lib.nrdtpu_denoise(inst, (ctypes.c_uint32 * 1)(0), 1,
                                      (B.ResourceSlotC * len(slots))(*slots), len(slots)) == 0
            eng.set_common_settings(B.common_settings_from_c(c))
            want = eng.denoise([0], planes)
            for rt in rts:
                np.testing.assert_array_equal(outs[rt], want[rt].cpu().numpy(), err_msg=rt.name)
    finally:
        assert lib.nrdtpu_destroy_instance(inst) == 0


@pytest.mark.parametrize("name", KM.ROW_ORIGIN)
def test_row_origin_matches_plain_version(recorded, name):
    """Every recorded call of a kernel of the sharded slice on the top, a middle and the bottom
    band of a quarter of the rows: with a halo of 6 rows and of the frame's height, against its
    plain version on the same band; with the frame's height also against the rows of the
    whole-frame launch."""
    mod = KM.MODULES[name]
    h, rows = SIZE[1], SIZE[1] // 4
    calls = [(a, k) for n, a, k in recorded if n == name]
    assert calls
    for a, k in calls:
        whole = _flat(getattr(mod, name)(*a, **k))
        for row0 in (0, h // 2, h - rows):
            for halo in (6, h):
                ba, bk = band_call(getattr(mod, name), a, k, row0, rows, halo, h)
                got = _flat(getattr(mod, name)(*ba, **bk))
                want = _flat(getattr(mod, name + "_ref")(*ba, **bk))
                pairs = [(got[key], want[key], "plain") for key in want]
                if halo == h:
                    pairs += [(got[key][halo:halo + rows], whole[key][row0:row0 + rows], "whole")
                              for key in whole]
                for g, w, what in pairs:
                    g, w = g.float(), w.float()
                    over = ((g - w).abs() > ATOL + RTOL * w.abs()).float().mean().item()
                    assert over <= FLIP_FRACTION, (name, row0, halo, what, over)


def test_sharded_engine_on_card(cuda):
    """REFERENCE, SIGMA_SHADOW and REBLUR_DIFFUSE on 2 gloo ranks sharing the card, gathered,
    against the Engine on the card unsharded: the kernels' tolerance. The frame time is left at
    0: both ranks time their frames by rank 0's clock, and the unsharded run takes those times."""
    from nrdtpu_torch.parallel import launch

    variants = ("REFERENCE", "SIGMA_SHADOW", "REBLUR_DIFFUSE")
    cases = [dict(denoiser=v, size=SIZE, frames=3) for v in variants]
    for case, r in zip(cases, launch.spawn(launch.run_engine_ranks, 2, "gloo", "cuda", cases)):
        times = r["time_delta_ms"]
        assert times[1] == times[0], times
        want = launch.run_engine(None, **case, device="cuda", frame_times=times[0])["outputs"]
        for key, w in want.items():
            g = r["outputs"][key]
            over = float((np.abs(g - w) > ATOL + RTOL * np.abs(w)).mean())
            assert over <= FLIP_FRACTION, (case["denoiser"], key, over)
        assert all(shape[0] == SIZE[1] // 2 for shapes in r["state_shapes"]
                   for shape in shapes.values())
