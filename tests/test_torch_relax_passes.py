"""RELAX_DIFFUSE in the PyTorch port, pass by pass: each pass (its plain CPU path, the
kernels' `*_ref`) against the JAX package's XLA function from identical inputs and identical
state, and the TA / history-clamping / à-trous formulas against the numpy transliteration of
the HLSL (`tests/oracle/relax.py`, diffuse halves).

The JAX Engine runs 3 frames of the orbit scene at 72x40 (not a multiple of the 16-pixel
block or tile); its state and the frame-4 constants are carried across with
`nrdtpu_torch.interop`, and both sides run frame 4 pass by pass, each pass from the JAX
chain's own intermediate. Inputs are packed with `relax_pack_radiance_hitdist` from the
scene's raw diffuse hit distance, as `tests/test_relax.py` packs them.

Tolerance: rtol=1e-4, atol=1e-5 (the port keeps the XLA op order; what remains is last-bit
differences of atan, exp, pow and rsqrt between XLA and PyTorch's CPU kernels). The oracle bar
is 40 dB, as `tests/test_oracle.py` holds the JAX package to it.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.passes.reblur import kernels as JRK
from nrdtpu.passes.relax import kernels as JK
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch.engine import DenoiserConfig, Engine as TEngine
from nrdtpu_torch.ops import resample as trs
from nrdtpu_torch.passes import relax as TC
from nrdtpu_torch.passes.reblur import kernels as TRK
from nrdtpu_torch.passes.relax import kernels as TK
from nrdtpu_torch.passes.relax.denoiser import RelaxDenoiser
from nrdtpu_torch.settings import CommonSettings, Denoiser, RelaxSettings, ResourceType as RT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import relax as OR  # noqa: E402

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
SIZE = (72, 40)
ATROUS_STEPS = (1, 2, 4, 8, 16)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


def relax_pool(gen, fd):
    sig = np.asarray(jfe.relax_pack_radiance_hitdist(jnp.asarray(fd.diff_noisy),
                                                     jnp.asarray(fd.diff_hit_dist)))
    return {JRT.IN_VIEWZ: fd.view_z, JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            JRT.IN_MV: fd.mv, JRT.IN_DIFF_RADIANCE_HITDIST: sig}


@pytest.fixture(scope="module")
def ctx():
    """JAX runs frames 0-2; returns frame 3's inputs, constants, state and the XLA chain."""
    gen = SceneGenerator(SceneSpec(size=SIZE, noise=0.4), camera_mode="orbit")
    eng = JEngine({0: JDenoiser.RELAX_DIFFUSE}, resource_size=SIZE)
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        fd.common_settings.splitScreen = 0.3 if i == 3 else 0.0
        eng.set_common_settings(fd.common_settings)
        if i < 3:
            eng.denoise([0], relax_pool(gen, fd))
    inst = eng._instances[0]
    cfg = inst.config
    sc = dict(eng._shared_consts())
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    jsc = inst._relax_sc(sc)
    state = {k: np.asarray(v) for k, v in eng.get_state(0).items()}
    pool = relax_pool(gen, fd)
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    vz, nr, diff = ja[JRT.IN_VIEWZ], ja[JRT.IN_NORMAL_ROUGHNESS], ja[JRT.IN_DIFF_RADIANCE_HITDIST]
    j = {}
    j["tile_map"] = JK.classify_tiles(jsc, vz)
    j["dead"] = JK.dead_mask(jsc, j["tile_map"], vz)
    j["pre"] = JK.pre_pass(jsc, dc, diff, None, vz, nr, cfg, pallas=False)[0]
    j["ta"] = JK.temporal_accumulation(jsc, dc, vz, nr, ja[JRT.IN_MV], j["pre"], None, js, cfg,
                                       pallas=False)
    hl = j["ta"]["history_length"]
    j["fix"] = JK.history_fix(jsc, dc, vz, nr, hl, j["ta"]["diff"], None, cfg, pallas=False)[0]
    fixmask = (hl <= dc["history_fix_frame_num"])[..., None]
    j["resp"] = jnp.where(fixmask, jnp.concatenate([j["fix"][..., :3],
                                                    j["ta"]["diff_fast"][..., 3:]], -1),
                          j["ta"]["diff_fast"])
    j["hc"] = JK.history_clamping(jsc, dc, vz, j["pre"], None, j["ta"]["diff"], None, j["resp"],
                                  None, hl, cfg, pallas=False)
    cur = j["hc"]["diff_slow"]
    j["atrous_in"], j["atrous"] = {}, {}
    for i, step in enumerate(ATROUS_STEPS):
        j["atrous_in"][step] = cur
        cur = JK.atrous(jsc, dc, vz, nr, hl, None, cur, None, cfg, step_size=step,
                        is_first=i == 0, is_last=i == len(ATROUS_STEPS) - 1, pallas=False)["diff"]
        j["atrous"][step] = cur
    j["split"] = JK.split_screen(jsc, vz, diff, cur)
    jout = np.asarray(eng.denoise([0], pool)[JRT.OUT_DIFF_RADIANCE_HITDIST])
    tcfg = DenoiserConfig(Denoiser.RELAX_DIFFUSE, SIZE, SIZE)
    tsc = interop.consts_from_numpy(sc)
    return dict(gen=gen, fd=fd, pool=pool, raw_sc=sc, jsc=jsc, dc_j=dc, cfg=tcfg,
                sc=RelaxDenoiser._relax_sc(tsc), tsc=tsc, dc=interop.consts_from_numpy(dc),
                jstate=state, state=interop.state_from_numpy(state), j=j, jout=jout,
                jnew_state={k: np.asarray(v) for k, v in eng.get_state(0).items()},
                eng=eng)


def _in(ctx, key):
    return t(ctx["pool"][key])


def test_frame_constants_match_jax(ctx):
    """The port's own frame constants and frustum vectors equal the JAX package's."""
    port = RelaxDenoiser(ctx["cfg"], "cpu")
    dc = port.frame_constants(ctx["tsc"], RelaxSettings())
    assert dc.keys() == ctx["dc_j"].keys()
    for k, v in ctx["dc_j"].items():
        np.testing.assert_array_equal(np.asarray(dc[k]), np.asarray(v), err_msg=k)
    for k in ("frustum_right", "frustum_up", "frustum_forward", "prev_frustum_right",
              "prev_frustum_up", "prev_frustum_forward"):
        np.testing.assert_allclose(ctx["sc"][k], np.asarray(ctx["jsc"][k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_classify_tiles_and_dead_mask(ctx):
    vz = _in(ctx, RT.IN_VIEWZ)
    tile_map = TK.classify_tiles(ctx["sc"], vz)
    np.testing.assert_array_equal(tile_map.numpy(), np.asarray(ctx["j"]["tile_map"]))
    np.testing.assert_array_equal(TK.dead_mask(ctx["sc"], tile_map, vz).numpy(),
                                  np.asarray(ctx["j"]["dead"]))


def test_pre_pass(ctx):
    got = TK.pre_pass(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_DIFF_RADIANCE_HITDIST),
                      _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS), ctx["cfg"])
    close("pre_pass", got, ctx["j"]["pre"])


def test_pre_pass_radius_disabled(ctx):
    """diffusePrepassBlurRadius = 0: the signal passes through (clipped)."""
    dc = dict(ctx["dc"], diff_blur_radius=0.0)
    sig = _in(ctx, RT.IN_DIFF_RADIANCE_HITDIST)
    got = TK.pre_pass(ctx["sc"], dc, sig, _in(ctx, RT.IN_VIEWZ),
                      _in(ctx, RT.IN_NORMAL_ROUGHNESS), ctx["cfg"])
    jdc = dict(ctx["dc_j"], diff_blur_radius=np.float32(0.0))
    want = JK.pre_pass(ctx["jsc"], jdc, jnp.asarray(sig.numpy()), None,
                       jnp.asarray(ctx["pool"][JRT.IN_VIEWZ]),
                       jnp.asarray(ctx["pool"][JRT.IN_NORMAL_ROUGHNESS]), ctx["eng"]._instances[0]
                       .config, pallas=False)[0]
    close("pre_pass radius 0", got, want)


@pytest.fixture(scope="module")
def ta(ctx):
    return TK.temporal_accumulation(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                                    _in(ctx, RT.IN_NORMAL_ROUGHNESS), _in(ctx, RT.IN_MV),
                                    t(ctx["j"]["pre"]), ctx["state"], ctx["cfg"])


@pytest.mark.parametrize("key", ["history_length", "diff", "diff_fast"])
def test_temporal_accumulation(ctx, ta, key):
    close(f"TA {key}", ta[key], ctx["j"]["ta"][key])


def test_history_fix(ctx):
    hl = np.asarray(ctx["j"]["ta"]["history_length"])
    assert (hl <= ctx["dc_j"]["history_fix_frame_num"]).any(), "no short history to fix"
    got = TK.history_fix(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                         _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(hl), t(ctx["j"]["ta"]["diff"]),
                         ctx["cfg"])
    close("history_fix", got, ctx["j"]["fix"])
    resp = TK.apply_history_fix(ctx["dc"], t(hl), got, t(ctx["j"]["ta"]["diff_fast"]))
    close("responsive history after the fix", resp, ctx["j"]["resp"])


@pytest.mark.parametrize("key", ["diff_slow", "diff_resp"])
def test_history_clamping(ctx, key):
    got = TK.history_clamping(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), t(ctx["j"]["pre"]),
                              t(ctx["j"]["ta"]["diff"]), t(ctx["j"]["resp"]),
                              t(ctx["j"]["ta"]["history_length"]))
    close(f"history_clamping {key}", got[key], ctx["j"]["hc"][key])


@pytest.mark.parametrize("step", ATROUS_STEPS)
def test_atrous(ctx, step):
    """Iteration 0 (variance prefilter, 5x5 estimation of short histories), 2, 4 and the
    jittered strides 8 and 16, each from the JAX chain's input."""
    hl = t(ctx["j"]["ta"]["history_length"])
    if step == 1:
        assert bool((hl < ctx["dc"]["history_threshold"]).any()), "no short history"
    got = TK.atrous(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_NORMAL_ROUGHNESS),
                    hl, t(ctx["j"]["atrous_in"][step]), ctx["cfg"], step_size=step,
                    is_first=step == 1)
    close(f"atrous step {step}", got, ctx["j"]["atrous"][step])


def test_split_screen(ctx):
    got = TK.split_screen(ctx["sc"], _in(ctx, RT.IN_VIEWZ), _in(ctx, RT.IN_DIFF_RADIANCE_HITDIST),
                          t(ctx["j"]["atrous"][ATROUS_STEPS[-1]]))
    close("split_screen", got, ctx["j"]["split"])


def test_frame_from_carried_state(ctx):
    """The JAX state after 3 frames, carried into the port: frame 4's output and new state."""
    port = RelaxDenoiser(ctx["cfg"], "cpu")
    inputs = {RT(int(k)): t(v) for k, v in ctx["pool"].items()}
    outs, new_state = port.frame(ctx["tsc"], ctx["dc"], ctx["state"], inputs)
    close("frame 4 output", outs[RT.OUT_DIFF_RADIANCE_HITDIST], ctx["jout"])
    assert new_state.keys() == ctx["jnew_state"].keys()
    for k, v in new_state.items():
        close(f"new state {k}", v, ctx["jnew_state"][k])


# --- RELAX_Common helpers ------------------------------------------------------------------


def test_common_helpers_match_jax():
    rng = np.random.default_rng(5)
    n = rng.normal(size=(8, 8, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    r = rng.uniform(0, 1, (8, 8)).astype(np.float32)
    close("pack_prev_normal_roughness", TC.pack_prev_normal_roughness(t(n), t(r)),
          JK.pack_prev_normal_roughness(jnp.asarray(n), jnp.asarray(r)))
    packed = np.asarray(JK.pack_prev_normal_roughness(jnp.asarray(n), jnp.asarray(r)))
    for got, want in zip(TC.unpack_prev_normal_roughness(t(packed)),
                         JK.unpack_prev_normal_roughness(jnp.asarray(packed))):
        close("unpack_prev_normal_roughness", got, want)
    z, zc = rng.uniform(1, 2, (2, 8, 8)).astype(np.float32)
    close("get_bilateral_weight", TC.get_bilateral_weight(t(z), t(zc)),
          JK.get_bilateral_weight(jnp.asarray(z), jnp.asarray(zc)))
    for frac in (0.125, 0.5, r):
        tf = t(frac) if isinstance(frac, np.ndarray) else frac
        close("get_normal_weight_param2", TC.get_normal_weight_param2(t(r), tf),
              JK.get_normal_weight_param2(jnp.asarray(r), jnp.asarray(frac, jnp.float32)))
    x, xs = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    close("get_plane_distance_weight",
          TC.get_plane_distance_weight(t(x), t(n), t(z), t(xs), 0.5),
          JK.get_plane_distance_weight(jnp.asarray(x), jnp.asarray(n), jnp.asarray(z),
                                       jnp.asarray(xs), 0.5))
    close("get_plane_distance_weight_atrous",
          TC.get_plane_distance_weight_atrous(t(x), t(n), t(xs), 0.5),
          JK.get_plane_distance_weight_atrous(jnp.asarray(x), jnp.asarray(n), jnp.asarray(xs),
                                              0.5))


def test_world_positions_match_jax(ctx):
    uv = trs.pixel_uv_grid(SIZE[1], SIZE[0]).numpy()
    z = np.abs(ctx["pool"][JRT.IN_VIEWZ])
    for prev in (False, True):
        close("world_pos_from_uv", TC.world_pos_from_uv(ctx["sc"], t(uv), t(z), prev),
              JK.world_pos_from_uv(ctx["jsc"], jnp.asarray(uv), jnp.asarray(z), prev))
        p3 = TC.world_pos_from_uv3(ctx["sc"], t(uv[..., 0]), t(uv[..., 1]), t(z), prev)
        j3 = JK.world_pos_from_uv3(ctx["jsc"], jnp.asarray(uv[..., 0]), jnp.asarray(uv[..., 1]),
                                   jnp.asarray(z), prev)
        for a, b in zip(p3, j3):
            close("world_pos_from_uv3", a, b)


def test_front_end_packs_as_jax(ctx):
    fd = ctx["fd"]
    ours = tfe.relax_pack_radiance_hitdist(t(fd.diff_noisy), t(fd.diff_hit_dist))
    np.testing.assert_array_equal(ours.numpy(), ctx["pool"][JRT.IN_DIFF_RADIANCE_HITDIST])
    assert tfe.relax_unpack_radiance(ours) is ours


# --- hit-distance reconstruction on RELAX's constants (`denoiser.py:249-255`) --------------


@pytest.mark.parametrize("radius", [1, 2])
def test_hit_dist_reconstruction(ctx, radius):
    """REBLUR's reconstruction with RELAX's sc / dc on the frame with hit-distance holes."""
    sig = ctx["pool"][JRT.IN_DIFF_RADIANCE_HITDIST].copy()
    holes = (np.random.default_rng(3).random(sig.shape[:2]) < 0.3) & (ctx["fd"].hit_mask > 0)
    sig[..., 3][holes] = 0.0
    got, _ = TRK.hit_dist_reconstruction(ctx["sc"], ctx["dc"], _in(ctx, RT.IN_VIEWZ),
                                         _in(ctx, RT.IN_NORMAL_ROUGHNESS), t(sig), None,
                                         ctx["cfg"], radius=radius)
    want, _ = JRK.hit_dist_reconstruction(ctx["jsc"], ctx["dc_j"],
                                          jnp.asarray(ctx["pool"][JRT.IN_VIEWZ]),
                                          jnp.asarray(ctx["pool"][JRT.IN_NORMAL_ROUGHNESS]),
                                          jnp.asarray(sig), None,
                                          ctx["eng"]._instances[0].config, radius=radius,
                                          pallas=False)
    close(f"hit_dist_reconstruction radius {radius}", got, want)
    assert float((got[..., 3][t(holes.astype(np.float32)) > 0] > 0).float().mean()) > 0.9


def test_hit_dist_reconstruction_engine_matches_jax():
    """RELAX_DIFFUSE with AREA_3X3 through both Engines on 3 orbit frames whose hit distance
    is zeroed on a seeded 30 % of the geometry pixels: >= 60 dB on every frame."""
    from nrdtpu.settings import HitDistanceReconstructionMode as JHM, RelaxSettings as JRS
    from nrdtpu_torch.settings import HitDistanceReconstructionMode as HM

    size = (48, 32)
    gen = SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")
    je = JEngine({0: JDenoiser.RELAX_DIFFUSE}, resource_size=size)
    te = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=size, device="cpu")
    je.set_denoiser_settings(0, JRS(hitDistanceReconstructionMode=JHM.AREA_3X3))
    te.set_denoiser_settings(0, RelaxSettings(hitDistanceReconstructionMode=HM.AREA_3X3))
    for i in range(3):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        pool = relax_pool(gen, fd)
        holes = (np.random.default_rng(i).random(fd.view_z.shape) < 0.3) & (fd.hit_mask > 0)
        pool[JRT.IN_DIFF_RADIANCE_HITDIST] = pool[JRT.IN_DIFF_RADIANCE_HITDIST].copy()
        pool[JRT.IN_DIFF_RADIANCE_HITDIST][..., 3][holes] = 0.0
        je.set_common_settings(fd.common_settings)
        te.set_common_settings(fd.common_settings)
        want = np.asarray(je.denoise([0], pool)[JRT.OUT_DIFF_RADIANCE_HITDIST])
        got = te.denoise([0], {RT(int(k)): v for k, v in pool.items()})
        p = psnr(want, got[RT.OUT_DIFF_RADIANCE_HITDIST].numpy())
        assert p >= 60.0, f"frame {i}: {p:.2f} dB"


# --- the HLSL oracles (tests/test_oracle.py:375-502), diffuse halves -----------------------

OW, OH = 96, 64
BAR_DB = 40.0


def psnr(ref, x):
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    mse = np.mean((ref - x) ** 2)
    peak = max(np.max(np.abs(ref)), 1e-6)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-30))


def _oracle_camera(translate_x=0.0):
    """The slanted-wall camera pair of tests/test_oracle.py through the port's FrameMath."""
    eng = TEngine({0: Denoiser.RELAX_DIFFUSE}, resource_size=(OW, OH), device="cpu")
    cs = CommonSettings()
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = proj[1, 1] = 1.0
    proj[2, 2] = 1.0
    proj[2, 3] = -0.1
    proj[3, 2] = 1.0
    view = np.eye(4, dtype=np.float32)
    view[0, 3] = -translate_x
    cs.viewToClipMatrix = cs.viewToClipMatrixPrev = proj.flatten(order="F")
    cs.worldToViewMatrix = view.flatten(order="F")
    cs.worldToViewMatrixPrev = np.eye(4, dtype=np.float32).flatten(order="F")
    cs.resourceSize = cs.resourceSizePrev = cs.rectSize = cs.rectSizePrev = (OW, OH)
    cs.motionVectorScale = (1.0, 1.0, 0.0)
    eng.set_common_settings(cs)
    eng.set_common_settings(cs)  # 2nd frame: prev state valid, no reset
    sc, dc = eng.frame_constants(0)
    return RelaxDenoiser._relax_sc(sc), dc, eng._instances[0].config


def _oracle_scene(sc):
    """Depth / normals / MV of the slanted wall with a box (tests/test_oracle.py:_scene)."""
    from oracle import hlsl as H
    from oracle import reblur as O

    uv = O._pixel_uv(OH, OW)
    view_z = 8.0 + 3.0 * uv[..., 0] + 1.5 * uv[..., 1]
    box = (np.abs(uv[..., 0] - 0.55) < 0.15) & (np.abs(uv[..., 1] - 0.5) < 0.2)
    view_z = np.where(box, view_z - 2.0, view_z).astype(np.float32)
    n = np.stack([0.25 * np.sin(uv[..., 0] * 21.0), 0.2 * np.cos(uv[..., 1] * 17.0),
                  np.ones((OH, OW), np.float32)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    roughness = (0.3 + 0.4 * uv[..., 0]).astype(np.float32)
    nr = tfe.pack_normal_roughness(t(n), t(roughness), torch.zeros(OH, OW)).numpy()
    xv = H.reconstruct_view_position(uv, np.asarray(sc["frustum"], np.float32), view_z, 0.0)
    x = H.rotate_vector(sc["view_to_world"], xv)
    uv_prev = H.get_screen_uv(sc["world_to_clip_prev"], x + np.asarray(sc["camera_delta"]))
    mv = np.concatenate([uv_prev - uv, np.zeros((OH, OW, 1), np.float32)], -1).astype(np.float32)
    return dict(view_z=view_z, nr=nr, mv=mv, n=n, roughness=roughness)


@pytest.mark.parametrize("step_size", [1, 4, 32])
def test_atrous_matches_oracle(step_size):
    """Iterations >= 1 (RELAX_Atrous.hlsli); 32 exercises the per-pixel jitter."""
    rng = np.random.default_rng(42)
    sc, dc, cfg = _oracle_camera()
    s = _oracle_scene(sc)
    history_length = rng.uniform(0.0, 30.0, (OH, OW)).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (OH, OW)).astype(np.float32)
    diff = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    spec = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    diff[..., 3] = rng.uniform(0.0, 0.2, (OH, OW))
    spec[..., 3] = rng.uniform(0.0, 0.2, (OH, OW))
    ref = OR.atrous(sc, dc, s["view_z"], s["nr"], history_length, conf, diff, spec,
                    step_size=step_size)
    got = TK.atrous(sc, dc, t(s["view_z"]), t(s["nr"]), t(history_length), t(diff), cfg,
                    step_size=step_size, is_first=False).numpy()
    assert psnr(ref["diff"][..., :3], got[..., :3]) >= BAR_DB
    assert psnr(ref["diff"][..., 3], got[..., 3]) >= BAR_DB


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_ta_matches_oracle(translate_x):
    """RELAX TemporalAccumulation (RELAX_TemporalAccumulation.hlsli:15-929), diffuse half."""
    rng = np.random.default_rng(42)
    sc, dc, cfg = _oracle_camera(translate_x)
    s = _oracle_scene(sc)
    s["mv"] = s["mv"] + np.asarray([0.37 / OW, 0.23 / OH, 0.0], np.float32)
    diff = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    spec = rng.uniform(0.0, 1.0, (OH, OW, 4)).astype(np.float32)
    spec[..., 3] = rng.uniform(0.0, 4.0, (OH, OW))
    prev_nr = TC.pack_prev_normal_roughness(t(s["n"]), t(s["roughness"])).numpy()
    state = {
        "history_length": rng.uniform(0.0, 30.0, (OH, OW)).astype(np.float32),
        "normal_roughness_prev": prev_nr,
        "material_id_prev": np.zeros((OH, OW), np.float32),
        "view_z_prev": (s["view_z"] + rng.uniform(-0.005, 0.005, (OH, OW))).astype(np.float32),
        "diff_illum_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "diff_responsive_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "spec_illum_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "spec_responsive_prev": rng.uniform(0, 1, (OH, OW, 4)).astype(np.float32),
        "reflection_hit_t": rng.uniform(0.01, 4.0, (OH, OW)).astype(np.float32),
    }
    ref = OR.temporal_accumulation(sc, dc, s["view_z"], s["nr"], s["mv"], diff, spec, state)
    got = TK.temporal_accumulation(sc, dc, t(s["view_z"]), t(s["nr"]), t(s["mv"]), t(diff),
                                   {k: t(v) for k, v in state.items()}, cfg)
    for name in ("history_length", "diff", "diff_fast"):
        p = psnr(ref[name], got[name].numpy())
        assert p >= BAR_DB, f"RELAX TA {name}: {p:.1f} dB vs HLSL oracle"


def test_history_clamping_matches_oracle():
    """RELAX HistoryClamping (RELAX_HistoryClamping.hlsli:52-330), diffuse half."""
    rng = np.random.default_rng(42)
    sc, dc, cfg = _oracle_camera()
    s = _oracle_scene(sc)
    noisy_d, noisy_s, slow_d, slow_s, resp_d, resp_s = rng.uniform(
        0.0, 1.0, (6, OH, OW, 4)).astype(np.float32)
    hl = rng.uniform(0.0, 30.0, (OH, OW)).astype(np.float32)
    ref = OR.history_clamping(sc, dc, s["view_z"], noisy_d, noisy_s, slow_d, slow_s, resp_d,
                              resp_s, hl)
    got = TK.history_clamping(sc, dc, t(s["view_z"]), t(noisy_d), t(slow_d), t(resp_d), t(hl))
    assert psnr(ref["diff"], got["diff_slow"].numpy()) >= BAR_DB
    # .a of the responsive history: the HLSL writes 0, the port carries TA's (0 in the pipeline)
    assert psnr(ref["diff_fast"][..., :3], got["diff_resp"][..., :3].numpy()) >= BAR_DB
