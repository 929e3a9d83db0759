"""SIGMA in the PyTorch port, pass by pass: each pass (its plain CPU path, the kernels' `*_ref`)
against the JAX package's XLA function from identical inputs and identical state, and the
Blur / TS formulas against the numpy transliteration of the HLSL (`tests/oracle/sigma.py`).

The JAX Engine runs 3 frames of the orbit scene; its state (the bf16 shadow history among it)
and the frame-4 constants are carried across with `nrdtpu_torch.interop`, and both sides run
frame 4 pass by pass, each pass from the JAX chain's own intermediate. SIGMA_SHADOW runs at
72x40, not a multiple of the 16-pixel tile (the tile reductions pad), SIGMA_SHADOW_TRANSLUCENCY
at 64x48 with 4 channels.

Tolerance: rtol=1e-4, atol=1e-5 (the port keeps the XLA op order; what remains is last-bit
differences of exp2, rsqrt and 3-term dot products between XLA and PyTorch's CPU kernels).
The oracle bar is 40 dB, as `tests/test_oracle.py` holds the JAX package to it.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.engine import Engine as JEngine
from nrdtpu.ops import tiles as jtiles
from nrdtpu.passes.sigma import kernels as JS
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import interop
from nrdtpu_torch import math as tm
from nrdtpu_torch.engine import Engine as TEngine
from nrdtpu_torch.ops import resample as trs
from nrdtpu_torch.ops import tiles as ttiles
from nrdtpu_torch.passes.sigma import kernels as TS
from nrdtpu_torch.settings import CommonSettings, Denoiser, ResourceType as RT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import reblur as O  # noqa: E402
from oracle import sigma as OS  # noqa: E402

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TRANSLUCENCY_RGB = np.array([0.3, 0.6, 0.2], np.float32)
CASES = {"SIGMA_SHADOW": (72, 40), "SIGMA_SHADOW_TRANSLUCENCY": (64, 48)}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} values differ, max |d| = "
                           f"{np.abs(got - want).max():.3g}")


def sigma_pool(gen, fd, translucent):
    pen = np.asarray(jfe.sigma_pack_penumbra_directional(
        jnp.asarray(fd.dist_to_occluder), gen.spec.light_tan_angular_radius))
    pool = {JRT.IN_PENUMBRA: pen, JRT.IN_VIEWZ: fd.view_z, JRT.IN_MV: fd.mv,
            JRT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd)}
    if translucent:
        rgb = jnp.broadcast_to(jnp.asarray(TRANSLUCENCY_RGB), fd.view_z.shape + (3,))
        pool[JRT.IN_TRANSLUCENCY] = np.asarray(jfe.sigma_pack_translucency(
            jnp.asarray(fd.dist_to_occluder), rgb))
    return pool


@pytest.fixture(scope="module", params=list(CASES))
def ctx(request):
    """JAX runs frames 0-2; returns frame 3's inputs, constants, state and the XLA chain."""
    variant = request.param
    size = CASES[variant]
    translucent = variant == "SIGMA_SHADOW_TRANSLUCENCY"
    gen = SceneGenerator(SceneSpec(size=size), camera_mode="orbit")
    eng = JEngine({0: JDenoiser[variant]}, resource_size=size)
    css = []
    for i in range(4):
        fd = gen.frame(i)
        fd.common_settings.timeDeltaBetweenFrames = 16.66
        fd.common_settings.splitScreen = 0.3 if i == 3 else 0.0
        css.append(fd.common_settings)
        eng.set_common_settings(fd.common_settings)
        if i < 3:
            eng.denoise([0], sigma_pool(gen, fd, translucent))
    inst = eng._instances[0]
    sc = dict(eng._shared_consts())
    dc = inst.frame_constants(eng._consts, eng._settings[0])
    jsc = dict(sc, plane_dist_sensitivity=dc["plane_dist_sensitivity"])
    state = {k: np.asarray(v) for k, v in eng.get_state(0).items()}
    pool = sigma_pool(gen, fd, translucent)
    c = 4 if translucent else 1
    kw = dict(translucent=translucent, channels=c, normal_encoding=inst.config.normal_encoding,
              roughness_encoding=inst.config.roughness_encoding)
    j = {}
    ja = {k: jnp.asarray(v) for k, v in pool.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    tr = ja.get(JRT.IN_TRANSLUCENCY)
    j["tile_map"] = JS.classify_tiles(jsc, ja[JRT.IN_PENUMBRA], ja[JRT.IN_VIEWZ], tr)
    j["tiles"] = JS.smooth_tiles(j["tile_map"])
    j["blur"] = JS.blur(jsc, dc, ja[JRT.IN_PENUMBRA], tr, ja[JRT.IN_VIEWZ],
                        ja[JRT.IN_NORMAL_ROUGHNESS], j["tiles"], first_pass=True, **kw)
    j["post"] = JS.blur(jsc, dc, *j["blur"][:1], j["blur"][1], ja[JRT.IN_VIEWZ],
                        ja[JRT.IN_NORMAL_ROUGHNESS], j["tiles"], first_pass=False, **kw)
    j["ts"] = JS.temporal_stabilization(
        jsc, dc, ja[JRT.IN_VIEWZ], ja[JRT.IN_MV], j["post"][0], j["post"][1],
        js["shadow_history"], js["prev_view_z"], js["history_len"], j["tiles"], channels=c)
    j["split"] = JS.split_screen(jsc, ja[JRT.IN_PENUMBRA], ja[JRT.IN_VIEWZ], j["ts"][0], tr,
                                 channels=c)
    return dict(variant=variant, size=size, css=css, c=c, sc=interop.consts_from_numpy(sc),
                dc=interop.consts_from_numpy(dc), jsc=jsc, jdc=dc, jstate=state, pool=pool, j=j,
                jout=np.asarray(eng.denoise([0], pool)[JRT.OUT_SHADOW_TRANSLUCENCY]),
                state=interop.state_from_numpy(state))


def _tp(ctx, key):
    v = ctx["pool"].get(key)
    return None if v is None else t(v)


def _tile(ctx):
    w, h = ctx["size"]
    return TS.tile_planes(ctx["sc"], t(ctx["j"]["tiles"]), h, w)


def test_classify_and_smooth_tiles(ctx):
    got = TS.classify_tiles(ctx["sc"], _tp(ctx, JRT.IN_PENUMBRA), _tp(ctx, JRT.IN_VIEWZ),
                            _tp(ctx, JRT.IN_TRANSLUCENCY))
    want = np.asarray(ctx["j"]["tile_map"])
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    np.testing.assert_array_equal(got[..., 2].numpy(), want[..., 2])
    close("max radius", got[..., 1], want[..., 1])
    close("smooth_tiles", TS.smooth_tiles(t(want)), ctx["j"]["tiles"])


def test_tile_planes(ctx):
    """The tile value (sky zeroed) and the sky mask against the JAX tile upsampling."""
    w, h = ctx["size"]
    tiles = jnp.asarray(ctx["j"]["tiles"])
    tile = _tile(ctx)
    close("tile value", tile[0], jtiles.upsample_tile_value(tiles, h, w,
                                                           ctx["sc"]["resolution_scale"]))
    np.testing.assert_array_equal(tile[1].numpy(),
                                  np.asarray(jtiles.tile_upsample_nearest(tiles[..., 0], h, w)))


@pytest.mark.parametrize("first_pass", [True, False], ids=["blur", "post_blur"])
def test_blur(ctx, first_pass):
    j = ctx["j"]
    if first_pass:
        pen, shadow = _tp(ctx, JRT.IN_PENUMBRA), _tp(ctx, JRT.IN_TRANSLUCENCY)
    else:
        pen, shadow = t(j["blur"][0]), t(j["blur"][1])
    got = TS.blur(ctx["sc"], ctx["dc"], pen, shadow, _tp(ctx, JRT.IN_VIEWZ),
                  _tp(ctx, JRT.IN_NORMAL_ROUGHNESS), _tile(ctx), first_pass=first_pass)
    want = j["blur" if first_pass else "post"]
    close("penumbra", got[0], want[0])
    close("shadow", got[1], want[1])


def _ts(ctx):
    j, st = ctx["j"], ctx["state"]
    return TS.temporal_stabilization(ctx["sc"], ctx["dc"], _tp(ctx, JRT.IN_VIEWZ),
                                     _tp(ctx, JRT.IN_MV), t(j["post"][0]), t(j["post"][1]),
                                     st["shadow_history"], st["prev_view_z"],
                                     st["history_len"], _tile(ctx))


def test_temporal_stabilization(ctx, monkeypatch):
    """With the reference's own Gaussian weights: XLA's float32 exp is 1 ulp off the
    correctly rounded value at some radii (|o| = sqrt(2) / 2 among the 5x5's), the port's
    (torch.exp) is not, and where the translucency is uniform the clamp's
    sqrt(|m2 - m1^2|) of a vanishing variance turns that ulp into ~1e-4. With the port's
    own weights the output stays within 3e-4 of XLA's."""
    from nrdtpu import math as jm
    from nrdtpu_torch.kernels import sigma_ts as k_sigma_ts

    own = _ts(ctx)
    assert np.abs(own[0].numpy() - np.asarray(ctx["j"]["ts"][0])).max() < 3e-4
    xla_taps = [(dy, dx, float(jm.get_gaussian_weight(float((dx * dx + dy * dy) ** 0.5) / 2)))
                for dy, dx, _ in k_sigma_ts.TAPS]
    monkeypatch.setattr(k_sigma_ts, "TAPS", xla_taps)
    for name, g, w in zip(("shadow", "prev_view_z", "history_len"), _ts(ctx), ctx["j"]["ts"]):
        close(name, g, w)


@pytest.mark.parametrize("motion", ["mv_z_computed", "world_mv"])
def test_temporal_stabilization_mv_branches(ctx, motion, monkeypatch):
    """TS under the motion-vector branches that the orbit frames (motionVectorScale (1, 1, 1):
    screen space, the mv's z given, as in test_temporal_stabilization) do not take: the z scaled
    by 0 (TS computes the viewZ delta from world_to_view_prev), and
    isMotionVectorInWorldSpace with IN_MV zeroed (the true world motion of the static scene,
    projected by world_to_clip_prev), each against the XLA function with the same constants,
    with the reference's Gaussian weights as there."""
    from nrdtpu import math as jm
    from nrdtpu_torch.kernels import sigma_ts as k_sigma_ts

    j, st = ctx["j"], ctx["state"]
    mvs = np.array(ctx["jsc"]["mv_scale"], np.float32)
    mv = ctx["pool"][JRT.IN_MV]
    assert mvs[2] != 0.0 and mvs[3] == 0.0
    if motion == "mv_z_computed":
        mvs[2] = 0.0
    else:
        mvs[3] = 1.0
        mv = np.zeros_like(mv)
    jsc = dict(ctx["jsc"], mv_scale=mvs)
    want = JS.temporal_stabilization(
        jsc, ctx["jdc"], jnp.asarray(ctx["pool"][JRT.IN_VIEWZ]), jnp.asarray(mv),
        j["post"][0], j["post"][1], jnp.asarray(ctx["jstate"]["shadow_history"]),
        jnp.asarray(ctx["jstate"]["prev_view_z"]), jnp.asarray(ctx["jstate"]["history_len"]),
        j["tiles"], channels=ctx["c"])
    xla_taps = [(dy, dx, float(jm.get_gaussian_weight(float((dx * dx + dy * dy) ** 0.5) / 2)))
                for dy, dx, _ in k_sigma_ts.TAPS]
    monkeypatch.setattr(k_sigma_ts, "TAPS", xla_taps)
    got = TS.temporal_stabilization(dict(ctx["sc"], mv_scale=mvs), ctx["dc"],
                                    _tp(ctx, JRT.IN_VIEWZ), t(mv), t(j["post"][0]),
                                    t(j["post"][1]), st["shadow_history"], st["prev_view_z"],
                                    st["history_len"], _tile(ctx))
    for name, g, w in zip(("shadow", "prev_view_z", "history_len"), got, want):
        close(f"{motion} {name}", g, w)
    # the scene's motion vectors are exact, so every branch reprojects to the same place: the
    # output is the default branch's within the last bits
    assert psnr(np.asarray(want[0]), np.asarray(j["ts"][0])) >= 60.0


def test_split_screen(ctx):
    got = TS.split_screen(ctx["sc"], _tp(ctx, JRT.IN_PENUMBRA), _tp(ctx, JRT.IN_VIEWZ),
                          t(ctx["j"]["ts"][0]), _tp(ctx, JRT.IN_TRANSLUCENCY),
                          channels=ctx["c"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ctx["j"]["split"]))


def test_state_carried_from_jax(ctx):
    """The JAX Engine's state after 3 frames, bf16 shadow history included, carried into the
    port's Engine gives frame 4's output of the JAX Engine (>= 60 dB, the slice bar: the
    jitted JAX frame fuses its arithmetic, and the TS clamp amplifies last bits, see
    test_temporal_stabilization)."""
    w, h = ctx["size"]
    eng = TEngine({0: Denoiser[ctx["variant"]]}, resource_size=(w, h), device="cpu")
    for cs in ctx["css"][:3]:
        eng.set_common_settings(cs)
    eng._states[0] = ctx["state"]
    assert eng._states[0]["shadow_history"].dtype == torch.bfloat16
    assert torch.equal(eng._states[0]["shadow_history"].float(),
                       torch.from_numpy(ctx["jstate"]["shadow_history"].astype(np.float32)))
    eng.set_common_settings(ctx["css"][3])
    out = eng.denoise([0], {RT(int(k)): v for k, v in ctx["pool"].items()})
    got = out[RT.OUT_SHADOW_TRANSLUCENCY].numpy()
    assert got.shape == ctx["jout"].shape
    assert psnr(got, ctx["jout"]) >= 60.0


# --- ops and front end of the SIGMA path ------------------------------------------------


@pytest.mark.parametrize("op", ["min", "max", "sum"])
@pytest.mark.parametrize("shape", [(40, 72), (48, 64)])
def test_tile_reduce(op, shape):
    """min / max of floats; sum of 0/1 votes, as ClassifyTiles counts them (exact)."""
    rng = np.random.default_rng(5)
    img = (rng.uniform(-1.0, 1.0, shape) if op != "sum"
           else rng.random(shape) < 0.7).astype(np.float32)
    np.testing.assert_array_equal(ttiles.tile_reduce(t(img), op).numpy(),
                                  np.asarray(jtiles.tile_reduce(jnp.asarray(img), op)))


def test_sample_bicubic_bspline():
    from nrdtpu.ops import resample as jrs

    rng = np.random.default_rng(6)
    img = rng.uniform(0.0, 1.0, (5, 7)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (30, 20, 2)).astype(np.float32)
    close("bspline", trs.sample_bicubic_bspline(t(img), t(uv)),
          jrs.sample_bicubic_bspline(jnp.asarray(img), jnp.asarray(uv)))


def test_sigma_front_end():
    rng = np.random.default_rng(8)
    dist = np.where(rng.random((20, 30)) < 0.3, 65504.0,
                    rng.uniform(0.0, 50.0, (20, 30))).astype(np.float32)
    light = rng.uniform(10.0, 100.0, (20, 30)).astype(np.float32)
    rgb = rng.uniform(-0.2, 1.2, (20, 30, 3)).astype(np.float32)
    close("directional", tfe.sigma_pack_penumbra_directional(t(dist), 0.15),
          jfe.sigma_pack_penumbra_directional(jnp.asarray(dist), 0.15))
    close("local", tfe.sigma_pack_penumbra_local(t(dist), t(light), 0.5),
          jfe.sigma_pack_penumbra_local(jnp.asarray(dist), jnp.asarray(light), 0.5))
    close("translucency", tfe.sigma_pack_translucency(t(dist), t(rgb)),
          jfe.sigma_pack_translucency(jnp.asarray(dist), jnp.asarray(rgb)))
    close("unpack", tfe.sigma_unpack_shadow(t(rgb)), jfe.sigma_unpack_shadow(jnp.asarray(rgb)))


def test_rotator_and_geometry_weights():
    from nrdtpu import math as jm

    rng = np.random.default_rng(9)
    rot = rng.uniform(-1.0, 1.0, (6, 5, 4)).astype(np.float32)
    for v in tm.SPECIAL_8[:, :2]:
        np.testing.assert_array_equal(
            tm.rotate_vector2(t(rot), v).numpy(),
            np.asarray(jm.rotate_vector2(jnp.asarray(rot),
                                         jnp.broadcast_to(jnp.asarray(v), (6, 5, 2)))))
    xv = rng.uniform(-2.0, 2.0, (6, 5, 3)).astype(np.float32)
    nv = rng.uniform(-1.0, 1.0, (6, 5, 3)).astype(np.float32)
    fs = rng.uniform(0.5, 2.0, (6, 5)).astype(np.float32)
    for g, w in zip(tm.get_geometry_weight_params(0.02, t(fs), t(xv), t(nv)),
                    jm.get_geometry_weight_params(np.float32(0.02), jnp.asarray(fs),
                                                  jnp.asarray(xv), jnp.asarray(nv))):
        close("geometry weight", g, w)


# --- the HLSL oracle (tests/test_oracle.py:287-372, on the port) -------------------------

W, H_ = 96, 64
RNG = np.random.default_rng(42)


def psnr(ref, x):
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    mse = np.mean((ref - x) ** 2)
    peak = max(np.max(np.abs(ref)), 1e-6)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-30))


def _camera(translate_x=0.0):
    eng = TEngine({0: Denoiser.SIGMA_SHADOW}, resource_size=(W, H_), device="cpu")
    cs = CommonSettings()
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = proj[1, 1] = 1.0
    proj[2, 2] = 1.0
    proj[2, 3] = -0.1
    proj[3, 2] = 1.0
    view = np.eye(4, dtype=np.float32)
    view[0, 3] = -translate_x  # world-to-view: camera moved +x
    cs.viewToClipMatrix = cs.viewToClipMatrixPrev = proj.flatten(order="F")
    cs.worldToViewMatrix = view.flatten(order="F")
    cs.worldToViewMatrixPrev = np.eye(4, dtype=np.float32).flatten(order="F")
    cs.resourceSize = cs.resourceSizePrev = cs.rectSize = cs.rectSizePrev = (W, H_)
    cs.motionVectorScale = (1.0, 1.0, 0.0)
    eng.set_common_settings(cs)
    eng.set_common_settings(cs)  # 2nd frame: prev state valid, no reset
    sc, dc = eng.frame_constants(0)
    return dict(sc, plane_dist_sensitivity=dc["plane_dist_sensitivity"]), dc


def _oracle_scene(sc):
    """The slanted wall of tests/test_oracle.py with its penumbra blob and true MV."""
    from oracle import hlsl as HL

    uv = O._pixel_uv(H_, W)
    view_z = 8.0 + 3.0 * uv[..., 0] + 1.5 * uv[..., 1]
    box = (np.abs(uv[..., 0] - 0.55) < 0.15) & (np.abs(uv[..., 1] - 0.5) < 0.2)
    view_z = np.where(box, view_z - 2.0, view_z).astype(np.float32)
    n = np.stack([0.25 * np.sin(uv[..., 0] * 21.0), 0.2 * np.cos(uv[..., 1] * 17.0),
                  np.ones((H_, W), np.float32)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    roughness = (0.3 + 0.4 * uv[..., 0]).astype(np.float32)
    nr = tfe.pack_normal_roughness(t(n), t(roughness), 0.0).numpy()
    xv = HL.reconstruct_view_position(uv, np.asarray(sc["frustum"], np.float32), view_z, 0.0)
    x = HL.rotate_vector(sc["view_to_world"], xv)
    uv_prev = HL.get_screen_uv(sc["world_to_clip_prev"],
                               x + np.asarray(sc["camera_delta"])[None, None, :])
    mv = np.concatenate([(uv_prev - uv), np.zeros((H_, W, 1), np.float32)], -1)
    blob = (np.sin(6.0 * uv[..., 0] * 2 - 1) * np.sin(5.0 * uv[..., 1] * 2 + 1.3)
            + 0.3 * np.sin(13.0 * (2 * uv[..., 0] - 1) * (2 * uv[..., 1] - 1)))
    penumbra = np.where(blob > 0.8, np.float32(65504.0),
                        np.where(blob < -0.9, 0.0, 0.2 + 2.5 * (blob + 0.9) / 1.7))
    return dict(view_z=view_z, nr=nr, mv=mv.astype(np.float32),
                penumbra=penumbra.astype(np.float32))


def _live_tiles():
    """Uniform live tiles (tile value 1, no sky), as the oracle assumes."""
    return torch.stack([torch.ones(H_, W), torch.zeros(H_, W)])


@pytest.mark.parametrize("first_pass", [True, False])
def test_blur_matches_oracle(first_pass):
    sc, dc = _camera()
    s = _oracle_scene(sc)
    shadow_in = (None if first_pass
                 else np.sqrt(RNG.uniform(0.0, 1.0, (H_, W, 1)).astype(np.float32)))
    ref_pen, ref_shadow = OS.blur(sc, dc, s["penumbra"], shadow_in, s["view_z"], s["nr"],
                                  first_pass=first_pass, translucent=False)
    got_pen, got_shadow = TS.blur(sc, dc, t(s["penumbra"]),
                                  None if shadow_in is None else t(shadow_in), t(s["view_z"]),
                                  t(s["nr"]), _live_tiles(), first_pass=first_pass)
    live = ref_pen < 1e4  # lit pixels carry FP16_MAX penumbra
    assert psnr(ref_pen[live], got_pen.numpy()[live]) >= 40.0
    assert psnr(ref_shadow, got_shadow.numpy()) >= 40.0


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_ts_matches_oracle(translate_x):
    sc, dc = _camera(translate_x)
    s = _oracle_scene(sc)
    s["mv"] = s["mv"] + np.asarray([0.37 / W, 0.23 / H_, 0.0], np.float32)  # off-lattice
    shadow_packed = np.sqrt(RNG.uniform(0.0, 1.0, (H_, W, 1))).astype(np.float32)
    history = np.sqrt(RNG.uniform(0.0, 1.0, (H_, W, 1))).astype(np.float32)
    prev_view_z = s["view_z"] + RNG.uniform(-0.01, 0.01, (H_, W)).astype(np.float32)
    prev_len = RNG.integers(0, 8, (H_, W)).astype(np.float32)
    ref_out, ref_z, ref_len = OS.temporal_stabilization(
        sc, dc, s["view_z"], s["mv"], s["penumbra"], shadow_packed, history, prev_view_z,
        prev_len)
    got_out, got_z, got_len = TS.temporal_stabilization(
        sc, dc, t(s["view_z"]), t(s["mv"]), t(s["penumbra"]), t(shadow_packed),
        t(history).to(torch.bfloat16), t(prev_view_z), t(prev_len), _live_tiles())
    assert psnr(ref_out, got_out.numpy()) >= 40.0
    assert psnr(ref_z, got_z.numpy()) >= 40.0
    # history length is 3-bit integral: exact on >= 99 % of pixels
    assert np.mean(got_len.numpy() == ref_len) >= 0.99
