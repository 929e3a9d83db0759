"""The PyTorch port's REBLUR diffuse and specular passes against the numpy transliterations of
the NRD HLSL (`tests/oracle/reblur.py`), at the same >= 40 dB PSNR bar `tests/test_oracle.py`
holds the JAX package to, on the same synthetic slanted-wall scene. The frame constants come
from the port's own FrameMath; the passes run their plain CPU path (the kernels' `*_ref`).
"""

import os
import sys

import numpy as np
import pytest
import torch

from nrdtpu_torch import frontend as fe
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.kernels import history_fix as k_hf
from nrdtpu_torch.passes.reblur import kernels as K
from nrdtpu_torch.settings import CommonSettings, Denoiser

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import hlsl as H  # noqa: E402
from oracle import reblur as O  # noqa: E402

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

W, H_ = 96, 64
RNG = np.random.default_rng(42)
BAR_DB = 40.0


def psnr(ref, x):
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    mse = np.mean((ref - x) ** 2)
    peak = max(np.max(np.abs(ref)), 1e-6)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-30))


def _camera(translate_x=0.0):
    eng = Engine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=(W, H_), device="cpu")
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
    return sc, dc, eng._instances[0].config


def _scene(sc, rng=RNG):
    """Slanted wall with a closer box, lumpy normals, noisy YCoCg signal, true MV."""
    uv = O._pixel_uv(H_, W)
    view_z = 8.0 + 3.0 * uv[..., 0] + 1.5 * uv[..., 1]
    box = (np.abs(uv[..., 0] - 0.55) < 0.15) & (np.abs(uv[..., 1] - 0.5) < 0.2)
    view_z = np.where(box, view_z - 2.0, view_z).astype(np.float32)
    n = np.stack([0.25 * np.sin(uv[..., 0] * 21.0), 0.2 * np.cos(uv[..., 1] * 17.0),
                  np.ones((H_, W), np.float32)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    roughness = (0.3 + 0.4 * uv[..., 0]).astype(np.float32)
    nr = fe.pack_normal_roughness(torch.from_numpy(n.astype(np.float32)),
                                  torch.from_numpy(roughness), 0.0).numpy()
    frustum = np.asarray(sc["frustum"], np.float32)
    xv = H.reconstruct_view_position(uv, frustum, view_z, 0.0)
    x = H.rotate_vector(sc["view_to_world"], xv)
    uv_prev = H.get_screen_uv(sc["world_to_clip_prev"],
                              x + np.asarray(sc["camera_delta"])[None, None, :])
    mv = np.concatenate([(uv_prev - uv), np.zeros((H_, W, 1), np.float32)],
                        -1).astype(np.float32)
    signal = rng.uniform(0.0, 1.0, (H_, W, 4)).astype(np.float32)
    signal[..., 1:3] -= 0.5  # YCoCg chroma is signed
    return dict(view_z=view_z, nr=nr, mv=mv, signal=signal)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("mode", ["blur", "post_blur"])
def test_spatial_filter_matches_oracle(mode):
    sc, dc, cfg = _camera()
    s = _scene(sc)
    data1 = RNG.uniform(0.0, 30.0, (H_, W)).astype(np.float32)
    ref = O.diffuse_spatial_filter(sc, dc, mode, s["signal"], s["view_z"], s["nr"], data1)
    plane = k_hf.tap_geometry_ref(t(s["nr"]), t(s["view_z"]), float(sc["view_z_scale"]))
    got = K.diffuse_spatial_filter(sc, dc, K.BLUR if mode == "blur" else K.POST_BLUR,
                                   t(s["signal"]), t(s["view_z"]), t(s["nr"]), t(data1), cfg,
                                   tap_geometry=plane)
    p = psnr(ref, got.numpy())
    assert p >= BAR_DB, f"{mode}: PSNR vs HLSL oracle = {p:.1f} dB"


def test_history_fix_matches_oracle():
    sc, dc, cfg = _camera()
    s = _scene(sc)
    # mixed regime: converged in some areas, fresh (stride > 0) in others
    data1 = np.broadcast_to(np.where(np.arange(W)[None, :] < W // 2, 1.0, 20.0),
                            (H_, W)).astype(np.float32)
    fast = RNG.uniform(0.0, 1.0, (H_, W)).astype(np.float32)
    ref_sig, ref_fast = O.history_fix_diffuse(sc, dc, s["view_z"], s["nr"], data1,
                                              s["signal"], fast)
    got_sig, got_fast, _ = K.history_fix(sc, dc, t(s["view_z"]), t(s["nr"]), t(data1),
                                         t(s["signal"]), t(fast), cfg)
    assert psnr(ref_sig, got_sig.numpy()) >= BAR_DB
    assert psnr(ref_fast, got_fast.numpy()) >= BAR_DB


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_ta_diffuse_matches_oracle(translate_x):
    sc, dc, cfg = _camera(translate_x)
    s = _scene(sc)
    accum = RNG.uniform(0.0, 40.0, (H_, W)).astype(np.float32)
    history = RNG.uniform(0.0, 1.0, (H_, W, 4)).astype(np.float32)
    fast_hist = RNG.uniform(0.0, 1.0, (H_, W)).astype(np.float32)
    ref = O.ta_diffuse(sc, dc, s["view_z"], s["nr"], s["mv"], s["view_z"], s["nr"], accum,
                       accum, np.zeros((H_, W), np.float32), s["signal"], history, fast_hist)
    prev_internal = dict(diff_accum=t(accum), spec_accum=t(accum),
                         material_id=torch.zeros((H_, W)))
    sm = K.surface_motion_reprojection(sc, dc, t(s["view_z"]), t(s["nr"]), t(s["mv"]),
                                       t(s["view_z"]), t(s["nr"]), prev_internal, cfg,
                                       {"diff": (t(history), t(fast_hist))})
    got_diff, got_fast, got_accum = K.temporal_accumulation_diffuse(sc, dc, sm, t(s["signal"]))
    for name, r, g in (("fbits", ref["fbits"], sm["fbits"]),
                       ("accum speed", ref["accum_speed"], got_accum),
                       ("TA diffuse", ref["diff"], got_diff), ("TA fast", ref["fast"], got_fast)):
        p = psnr(r, g.numpy())
        assert p >= BAR_DB, f"{name}: {p:.1f} dB vs HLSL oracle"


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_ts_diffuse_matches_oracle(translate_x):
    sc, dc, cfg = _camera(translate_x)
    s = _scene(sc)
    # off the texel-centre lattice, as tests/test_oracle.py does: a static camera lands
    # the smb uv exactly on texel centres, where floor(pos - 0.5) legitimately ties
    s["mv"] = s["mv"] + np.asarray([0.37 / W, 0.23 / H_, 0.0], np.float32)
    data1 = RNG.uniform(0.0, 30.0, (H_, W)).astype(np.float32)
    fbits = RNG.integers(0, 256, (H_, W)).astype(np.float32)
    diff = RNG.uniform(0.0, 1.0, (H_, W, 4)).astype(np.float32)
    spec = RNG.uniform(0.0, 1.0, (H_, W, 4)).astype(np.float32)
    diff[..., 1:3] -= 0.5
    spec[..., 1:3] -= 0.5
    hist = RNG.uniform(0.0, 1.0, (H_, W)).astype(np.float32)
    zeros = np.zeros((H_, W), np.float32)
    ref = O.temporal_stabilization(sc, dc, s["view_z"], s["nr"], s["mv"], data1, data1, fbits,
                                   zeros, zeros, diff, spec, hist, hist)
    got = K.temporal_stabilization(sc, dc, t(s["view_z"]), t(s["nr"]), t(s["mv"]), t(data1),
                                   t(fbits), t(diff), t(hist), cfg)
    for name in ("diff", "diff_luma_stab", "data1_diff"):
        p = psnr(ref[name], got[name].numpy())
        assert p >= BAR_DB, f"TS {name}: {p:.1f} dB vs HLSL oracle"


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_ta_specular_matches_oracle(translate_x):
    """Specular TA (REBLUR_TemporalAccumulation.hlsli:306-830): curvature along the motion,
    GetXvirtual, the virtual-motion confidences, the smb/vmb blend, firefly and fast history.
    Curvature is compared under real parallax only: with a static camera its mixing
    direction is float noise (the reference's own comment, as tests/test_oracle.py says)."""
    sc, dc, cfg = _camera(translate_x)
    s = _scene(sc)
    accum = RNG.uniform(0.0, 40.0, (H_, W)).astype(np.float32)
    spec_input = RNG.uniform(0.0, 1.0, (H_, W, 4)).astype(np.float32)
    spec_input[..., 1:3] -= 0.5
    history = RNG.uniform(0.0, 1.0, (H_, W, 4)).astype(np.float32)
    fast_hist = RNG.uniform(0.0, 1.0, (H_, W)).astype(np.float32)
    prev_hdt = RNG.uniform(0.0, 5.0, (H_, W)).astype(np.float32)
    hdt_in = spec_input[..., 3]  # ExtractHitDist(spec): PrePass off
    zeros = np.zeros((H_, W), np.float32)
    ref = O.ta_specular(sc, dc, s["view_z"], s["nr"], s["mv"], s["view_z"], s["nr"], accum,
                        accum, zeros, spec_input, history, fast_hist, hdt_in, prev_hdt,
                        has_prepass_hitdist=False)
    prev_internal = dict(diff_accum=t(accum), spec_accum=t(accum), material_id=t(zeros))
    sm = K.surface_motion_reprojection(sc, dc, t(s["view_z"]), t(s["nr"]), t(s["mv"]),
                                       t(s["view_z"]), t(s["nr"]), prev_internal, cfg,
                                       {"spec": (t(history), t(fast_hist))})
    got = K.temporal_accumulation_specular(
        sc, dc, sm, t(spec_input), t(history), t(fast_hist), t(s["view_z"]), t(s["nr"]),
        t(s["view_z"]), t(s["nr"]), prev_internal, t(hdt_in), t(prev_hdt), cfg,
        has_prepass_hitdist=False)
    names = [("hdt", "hit_dist_for_tracking"), ("virtual_history_amount",) * 2,
             ("accum_speed",) * 2, ("spec",) * 2, ("fast",) * 2]
    if translate_x != 0.0:
        names.append(("curvature",) * 2)
    for r, g in names:
        p = psnr(ref[r], got[g].numpy())
        assert p >= BAR_DB, f"TA specular {g}: {p:.1f} dB vs HLSL oracle"
    # fbits are binary: a tap on its plane-distance threshold legitimately flips
    flips = np.mean(np.asarray(ref["fbits"]).astype(np.int64)
                    != (sm["fbits"] + got["fbits_vmb"]).numpy().astype(np.int64))
    assert flips < 0.01, f"TA specular fbits: {flips:.2%} of pixels flipped"


@pytest.mark.parametrize("translate_x", [0.0, 0.013])
def test_ts_specular_matches_oracle(translate_x):
    """Specular TS (REBLUR_TemporalStabilization.hlsli:233-343): the surface- and
    virtual-motion histories combined by the virtual history amount."""
    sc, dc, cfg = _camera(translate_x)
    s = _scene(sc)
    s["mv"] = s["mv"] + np.asarray([0.37 / W, 0.23 / H_, 0.0], np.float32)  # off-lattice
    data1 = RNG.uniform(0.0, 30.0, (H_, W)).astype(np.float32)
    fbits = RNG.integers(0, 256, (H_, W)).astype(np.float32)
    curvature = RNG.uniform(-0.2, 0.2, (H_, W)).astype(np.float32)
    amount = RNG.uniform(0.0, 1.0, (H_, W)).astype(np.float32)
    sig = RNG.uniform(0.0, 1.0, (2, H_, W, 4)).astype(np.float32)
    sig[..., 1:3] -= 0.5
    hist = RNG.uniform(0.0, 1.0, (H_, W)).astype(np.float32)
    ref = O.temporal_stabilization(sc, dc, s["view_z"], s["nr"], s["mv"], data1, data1, fbits,
                                   curvature, amount, sig[0], sig[1], hist, hist)
    got = K.temporal_stabilization_specular(
        sc, dc, t(s["view_z"]), t(s["nr"]), t(s["mv"]), t(data1), t(fbits), t(curvature),
        t(amount), t(sig[1]), t(hist), None, None, cfg, has_prepass=False)
    for name in ("spec", "spec_luma_stab", "data1_spec"):
        p = psnr(ref[name], got[name].numpy())
        assert p >= BAR_DB, f"TS {name}: {p:.1f} dB vs HLSL oracle"
