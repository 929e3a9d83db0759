"""RELAX diffuse passes - counterpart of the XLA functions in `nrdtpu/passes/relax/kernels.py`
(RELAX_*.hlsli). Pipeline (Relax.cpp:182-293): ClassifyTiles -> [HitDistReconstruction] ->
PrePass -> TemporalAccumulation -> HistoryFix -> HistoryClamping -> A-trous x N -> SplitScreen.

Each pass is elementwise torch glue around hand-written kernels of `nrdtpu_torch.kernels`:

  pre_pass                -> relax_prepass        (Poisson-8 taps at the per-pixel radius)
  temporal_accumulation   -> relax_smb_resolve    (surface-motion footprint, history length,
                                                   CatRom of the slow and responsive history)
  history_fix             -> relax_history_fix    (5x5 stride taps of short histories)
  history_clamping        -> relax_clamp_moments  (5x5 validity-weighted moments)
  atrous                  -> relax_atrous         (one 3x3 iteration; iteration 0 with the
                                                   variance prefilter and the 5x5 estimation)

Signals are (h, w, 4): radiance and, depending on the stage, raw hitT, the luminance's second
moment or its variance. The glue keeps the op order of the XLA functions; the kernels compute
the per-pixel formulas of the XLA gathers, not the TPU kernels' workarounds. Only the diffuse
branches are ported; each function takes its signal by name, so that the specular slice adds
its own beside it. Frame constants (`sc`, `dc`) are host values.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ... import math as nm
from ... import vec3 as v3
from ...kernels import relax_atrous as k_atrous
from ...kernels import relax_clamp_moments as k_clamp_moments
from ...kernels import relax_history_fix as k_history_fix
from ...kernels import relax_prepass as k_prepass
from ...kernels import relax_smb_resolve as k_smb_resolve
from ...ops import resample, tiles
from . import (
    F32,
    RELAX_ANTILAG_ACCELERATION_AMOUNT_SCALE,
    frustum_consts,
    get_normal_weight_param2,
    unpack_view_z,
    world_pos_from_uv3,
)


def _v(x):
    return [float(c) for c in np.asarray(x, np.float32).reshape(-1)]


def _frame_geometry(sc):
    """The constants every RELAX kernel reads: frustum vectors, ortho mode, viewZ scale."""
    return dict(frustum=frustum_consts(sc), ortho_mode=float(sc["ortho_mode"]),
                view_z_scale=float(sc["view_z_scale"]))


# ---------------------------------------------------------------------------
# ClassifyTiles (sky-only map, as REBLUR)
# ---------------------------------------------------------------------------


def classify_tiles(sc, view_z):
    return tiles.classify_sky_tiles(unpack_view_z(sc, view_z), float(sc["denoising_range"]))


def dead_mask(sc, tile_map, view_z):
    """Sky tile or beyond the denoising range (True = pass the input through)."""
    h, w = view_z.shape
    sky = tiles.tile_upsample_nearest(tile_map, h, w)
    return (sky > 0.0) | (unpack_view_z(sc, view_z) > float(sc["denoising_range"]))


# ---------------------------------------------------------------------------
# PrePass (RELAX_PrePass.hlsli), diffuse
# ---------------------------------------------------------------------------


def pre_pass(sc, dc, diff, view_z_in, normal_roughness, config):
    """Poisson spatial reuse of the diffuse signal (`kernels.py:160-306`, diffuse branch).
    Checkerboard off. Returns (h, w, 4)."""
    offsets, gauss = k_prepass.poisson_taps(sc["rotator_pre"])
    # get_normal_weight_param2(1, 0.25 lobe fraction) and the hit-distance weight's scale
    # (get_hit_distance_weight_params(hitT, 1/9), roughness 1): frame constants in float32
    nwp = float(get_normal_weight_param2(torch.ones(()), float(F32(0.25) * F32(
        dc["lobe_angle_fraction"]))))
    norm = F32(0.0005) + F32(1.0 - 0.0005) * F32(1.0 / 9.0)
    return k_prepass.relax_prepass(
        diff, view_z_in, normal_roughness, **_frame_geometry(sc),
        denoising_range=float(sc["denoising_range"]),
        frustum_size_scale=float(F32(min(config.rect_size)) * F32(sc["unproject"])),
        blur_radius=float(dc["diff_blur_radius"]), normal_weight_param=nwp,
        hit_dist_a=float(F32(1.0) / norm), min_hit_dist_weight=float(dc["min_hit_distance_weight"]),
        depth_threshold=float(dc["depth_threshold"]), min_material=float(dc["diff_min_material"]),
        offsets=offsets, gaussian_weights=gauss)


# ---------------------------------------------------------------------------
# TemporalAccumulation (RELAX_TemporalAccumulation.hlsli), diffuse
# ---------------------------------------------------------------------------


def temporal_accumulation(sc, dc, view_z_in, normal_roughness, mv_in, diff, state, config,
                          diff_confidence=None, dt_mix=None):
    """The RELAX TA for the diffuse signal (`kernels.py:319-612`): surface-motion uv,
    parallax, disocclusion threshold, the footprint (one `relax_smb_resolve` launch that also
    samples both diffuse histories), the footprint-quality refinements and the accumulation.
    Returns dict(history_length, diff, diff_fast)."""
    h, w = view_z_in.shape
    dev = view_z_in.device
    view_z = unpack_view_z(sc, view_z_in)
    uv = resample.pixel_uv_grid(h, w, dev)
    n3 = v3.decode_oct_raw(normal_roughness[..., 0], normal_roughness[..., 1])
    material_id = normal_roughness[..., 3] * 3.0
    u_p, v_p = uv[..., 0], uv[..., 1]
    x3 = world_pos_from_uv3(sc, u_p, v_p, view_z)
    ortho = float(sc["ortho_mode"])
    is_persp = ortho == 0.0
    if is_persp:
        view_vec3 = x3
    else:
        f = np.asarray(sc["frustum_forward"], F32)
        fwd_n = f / np.sqrt(np.maximum(np.sum(f * f), F32(1e-15)))
        view_vec3 = v3.V3(view_z * float(fwd_n[0]), view_z * float(fwd_n[1]),
                          view_z * float(fwd_n[2]))
    v_3 = -v3.normalize(view_vec3)
    nov = torch.abs(v3.dot(n3, v_3))
    rw_, rh_ = _v(sc["rect_size"])
    rect_prev = _v(sc["rect_size_prev"])

    # previous position / smb uv (lines 398-415)
    mvs = _v(sc["mv_scale"])
    mv0 = mv_in[..., 0] * mvs[0]
    mv1 = mv_in[..., 1] * mvs[1]
    mv2 = mv_in[..., 2] * mvs[2]
    cd3 = v3.V3(*_v(sc["camera_delta"]))
    if mvs[3] != 0.0:  # world-space motion
        xp3 = x3 + v3.V3(mv0, mv1, mv2)
        smb_u, smb_v = v3.get_screen_uv(sc["world_to_clip_prev"], xp3)
    else:
        smb_u, smb_v = u_p + mv0, v_p + mv1
        mv_z = (v3.affine(sc["world_to_view_prev"], x3).z - view_z) if mvs[2] == 0.0 else mv2
        xp3 = world_pos_from_uv3(sc, smb_u, smb_v, view_z + mv_z, prev=True) + cd3
    uv_smb = torch.stack([smb_u, smb_v], -1)

    # parallax (lines 470-477)
    zp1_u, zp1_v = (smb_u, smb_v) if is_persp else (u_p, v_p)
    zp2_u, zp2_v = (u_p, v_p) if is_persp else (smb_u, smb_v)
    p1u, p1v = v3.get_screen_uv(sc["world_to_clip_prev"], xp3 + cd3)
    p2u, p2v = v3.get_screen_uv(sc["world_to_clip"], xp3 - cd3)
    d1x = (p1u - zp1_u) * rw_
    d1y = (p1v - zp1_v) * rh_
    d2x = (p2u - zp2_u) * rw_
    d2y = (p2v - zp2_v) * rh_
    parallax_max = torch.maximum(torch.sqrt(d1x * d1x + d1y * d1y),
                                 torch.sqrt(d2x * d2x + d2y * d2y))
    pixel_size = nm.pixel_radius_to_world(float(sc["unproject"]), ortho, 1.0, view_z)

    # disocclusion threshold (lines 479-486)
    if dt_mix is not None:
        mix_ = dt_mix
    else:
        mix_ = torch.where(material_id == float(sc["strand_material_id"]),
                           fe.get_normalized_strand_thickness(float(sc["strand_thickness"]),
                                                              pixel_size), 0.0)
    bonus = F32(sc["disocclusion_threshold_bonus"])
    dt0 = F32(sc["disocclusion_threshold"]) + bonus
    dt1 = F32(sc["disocclusion_threshold_alternate"]) + bonus
    disocclusion_threshold = float(dt0) + float(dt1 - dt0) * mix_

    # the footprint's thresholds (lines 426-432)
    frustum_size = pixel_size * min(config.rect_size)
    slope_scale = 1.0 / nm.lerp(nm.lerp(0.05, 1.0, nov), 1.0, nm.saturate(parallax_max / 30.0))
    base_thr = nm.saturate(disocclusion_threshold * slope_scale) * frustum_size
    m = np.asarray(sc["world_to_view_prev"], F32)
    xv_prev_z = (xp3.x * float(m[2, 0]) + xp3.y * float(m[2, 1]) + xp3.z * float(m[2, 2])
                 + float(m[2, 3]))

    smb = k_smb_resolve.relax_smb_resolve(
        uv_smb, xv_prev_z, base_thr, normal_roughness, state["view_z_prev"],
        state["material_id_prev"], state["history_length"], state["normal_roughness_prev"],
        (state["diff_illum_prev"], state["diff_responsive_prev"]),
        view_z_scale=float(sc["view_z_scale"]), rect_size_prev=rect_prev,
        resource_size=_v(sc["resource_size"]),
        min_material=float(min(F32(dc["spec_min_material"]), F32(dc["diff_min_material"]))),
        world_prev_to_world=sc["world_prev_to_world"])
    history_length = smb["history_length"]
    footprint_quality = smb["footprint_quality"]

    # footprint quality refinements (lines 547-562)
    if is_persp:
        v_prev = -v3.normalize(xp3 - cd3)
    else:
        f = np.asarray(sc["prev_frustum_forward"], F32)
        v_prev = v3.V3(*[float(c) for c in -f / np.sqrt(np.maximum(np.sum(f * f), F32(1e-15)))])
    nov_prev = torch.abs(v3.dot(n3, v_prev))
    size_quality = (nov_prev + 1e-3) / (nov + 1e-3)
    size_quality = size_quality * size_quality
    size_quality = size_quality * size_quality
    footprint_quality = footprint_quality * nm.lerp(0.1, 1.0,
                                                    nm.saturate(size_quality + abs(ortho)))
    history_length = torch.where(footprint_quality < 1.0,
                                 torch.clamp_min(history_length * torch.sqrt(footprint_quality),
                                                 1.0),
                                 history_length)
    if float(sc["reset_history"]) != 0.0:
        history_length = torch.ones_like(history_length)
    max_frames = F32(1.0) + max(F32(dc["diff_max_accumulated_frame_num"]),
                                F32(dc["spec_max_accumulated_frame_num"]))
    history_length = torch.clamp_max(history_length, float(max_frames))

    # diffuse accumulation (lines 580-621)
    dmax = F32(dc["diff_max_accumulated_frame_num"])
    dmax_fast = F32(dc["diff_max_fast_accumulated_frame_num"])
    inv_hl = 1.0 / history_length
    if diff_confidence is not None:
        alpha = torch.maximum(1.0 / (diff_confidence * float(dmax) + 1.0), inv_hl)
        alpha_resp = torch.maximum(1.0 / (diff_confidence * float(dmax_fast) + 1.0), inv_hl)
    else:
        alpha = torch.clamp_min(inv_hl, float(F32(1.0) / (dmax + F32(1.0))))
        alpha_resp = torch.clamp_min(inv_hl, float(F32(1.0) / (dmax_fast + F32(1.0))))
    found = smb["smb_found"] > 0.0
    alpha = torch.where(found, alpha, 1.0)
    alpha_resp = torch.where(found, alpha_resp, 1.0)
    prev_diff = torch.clamp_min(smb["histories"][0], 0.0)
    prev_diff_resp = torch.clamp_min(smb["histories"][1], 0.0)
    m1 = nm.luminance(diff[..., :3])
    diff_and_m2 = torch.cat([diff[..., :3], (m1 * m1)[..., None]], -1)
    out_diff = nm.lerp(prev_diff, diff_and_m2, alpha[..., None])
    out_fast = torch.cat([nm.lerp(prev_diff_resp[..., :3], diff[..., :3], alpha_resp[..., None]),
                          torch.zeros_like(m1)[..., None]], -1)
    return dict(history_length=history_length, diff=out_diff, diff_fast=out_fast)


# ---------------------------------------------------------------------------
# HistoryFix (RELAX_HistoryFix.hlsli), diffuse
# ---------------------------------------------------------------------------


def history_fix(sc, dc, view_z_in, normal_roughness, history_length, diff, config):
    """Sparse 5x5 cross-bilateral reconstruction of short histories (`kernels.py:1017-1131`,
    diffuse part): one `relax_history_fix` launch. Returns (h, w, 4)."""
    return k_history_fix.relax_history_fix(
        diff, view_z_in, normal_roughness, history_length, **_frame_geometry(sc),
        depth_threshold=float(dc["depth_threshold"]),
        base_stride=float(dc["history_fix_base_pixel_stride"]),
        frame_num=float(dc["history_fix_frame_num"]),
        normal_power=float(dc["history_fix_edge_stopping_normal_power"]),
        min_material=float(dc["diff_min_material"]))


def apply_history_fix(dc, history_length, diff_fix, diff_resp):
    """The fixed rgb goes into the responsive history where the history is short
    (`denoiser.py:278-282`)."""
    fixmask = (history_length <= float(dc["history_fix_frame_num"]))[..., None]
    return torch.where(fixmask, torch.cat([diff_fix[..., :3], diff_resp[..., 3:]], -1),
                       diff_resp)


# ---------------------------------------------------------------------------
# HistoryClamping (RELAX_HistoryClamping.hlsli), diffuse
# ---------------------------------------------------------------------------


def history_clamping(sc, dc, view_z_in, noisy_diff, diff_slow, diff_resp, history_length):
    """Sigma colour-box clamp of the slow history to the responsive one + antilag
    acceleration and reset + 2nd-moment correction (`kernels.py:1140-1271`, diffuse part);
    the 5x5 moments in one `relax_clamp_moments` launch. Returns dict(history_length,
    diff_slow, diff_resp)."""
    m1, m2, nm1, nm2 = k_clamp_moments.relax_clamp_moments(
        view_z_in, diff_resp, noisy_diff, view_z_scale=float(sc["view_z_scale"]),
        denoising_range=float(sc["denoising_range"]))
    slow, resp, noisy = diff_slow, diff_resp, noisy_diff
    resp_ycocg = nm.linear_to_ycocg(resp[..., :3])
    sigma = torch.sqrt(torch.clamp_min(m2 - m1 * m1, 0.0))
    cbss = float(dc["color_box_sigma_scale"])
    cmin = torch.minimum(m1 - cbss * sigma, resp_ycocg)
    cmax = torch.maximum(m1 + cbss * sigma, resp_ycocg)
    slow_ycocg = nm.linear_to_ycocg(slow[..., :3])
    if F32(dc["diff_max_fast_accumulated_frame_num"]) < F32(dc["diff_max_accumulated_frame_num"]):
        clamped_ycocg = torch.minimum(torch.maximum(slow_ycocg, cmin), cmax)
    else:
        clamped_ycocg = slow_ycocg
    clamped = nm.ycocg_to_linear(clamped_ycocg)

    in_fix = history_length <= float(dc["history_fix_frame_num"])
    out_slow_rgb = torch.where(in_fix[..., None], resp[..., :3], clamped)
    out_resp_rgb = resp[..., :3]

    dy_clamp = clamped_ycocg[..., 0] - slow_ycocg[..., 0]
    denom = resp_ycocg[..., 0] - slow_ycocg[..., 0]
    clamping_factor = torch.where(
        dy_clamp == 0.0, 0.0,
        nm.saturate(dy_clamp / torch.where(torch.abs(denom) < 1e-15, 1e-15, denom)))
    clamping_factor = torch.where(in_fix, 1.0, clamping_factor)

    accel_scale = F32(RELAX_ANTILAG_ACCELERATION_AMOUNT_SCALE) * F32(
        dc["history_acceleration_amount"])
    hist_diff_l = float(accel_scale) * nm.luminance(torch.abs(out_resp_rgb - slow[..., :3]))
    hist_diff_l = hist_diff_l * clamping_factor
    hist_diff_l = torch.where(in_fix, 0.0, hist_diff_l)

    dist = nm1 - out_resp_rgb
    dist_l = nm.luminance(torch.abs(dist))
    accel = torch.where((dist_l == 0.0)[..., None], 0.0,
                        dist * (hist_diff_l / torch.clamp_min(dist_l, 1e-15))[..., None])
    accel_l = nm.luminance(torch.abs(accel))
    ratio = torch.where(accel_l == 0.0, 0.0, dist_l / torch.clamp_min(accel_l, 1e-15))
    accel = torch.where((ratio < 1.0)[..., None], accel * ratio[..., None], accel)
    accel = torch.where((ratio <= 0.0)[..., None], 0.0, accel)
    out_slow_rgb = out_slow_rgb + accel
    out_resp_rgb = out_resp_rgb + accel

    # history reset (antilag reset)
    slow_l = nm.luminance(slow[..., :3])
    noisy_l = nm.luminance(nm1)
    t_sigma = float(dc["history_reset_temporal_sigma_scale"]) * torch.sqrt(
        torch.clamp_min(nm2 - noisy_l * noisy_l, 0.0))
    s_sigma = float(dc["history_reset_spatial_sigma_scale"]) * sigma[..., 0]
    reset = float(dc["history_reset_amount"]) * torch.clamp_min(
        torch.abs(slow_l - noisy_l) - s_sigma - t_sigma, 0.0) / (
        1e-6 + torch.maximum(slow_l, noisy_l) + s_sigma + t_sigma)
    reset = nm.saturate(reset)
    out_slow_rgb = nm.lerp(out_slow_rgb, noisy[..., :3], reset[..., None])
    out_resp_rgb = nm.lerp(out_resp_rgb, noisy[..., :3], reset[..., None])

    # 2nd moment correction
    out_l = nm.luminance(out_slow_rgb)
    out_m2 = torch.clamp_min(slow[..., 3] + (out_l * out_l - slow_l * slow_l), 0.0)
    return dict(history_length=history_length,
                diff_slow=torch.cat([out_slow_rgb, out_m2[..., None]], -1),
                diff_resp=torch.cat([out_resp_rgb, resp[..., 3:]], -1))


# ---------------------------------------------------------------------------
# A-trous (RELAX_AtrousSmem.hlsli + RELAX_Atrous.hlsli), diffuse
# ---------------------------------------------------------------------------


def atrous(sc, dc, view_z_in, normal_roughness, history_length, diff, config, *,
           step_size: int, is_first: bool):
    """One à-trous iteration of the diffuse signal (`kernels.py:1340-1606`): one
    `relax_atrous` launch. Returns (h, w, 4) = (rgb, variance)."""
    return k_atrous.relax_atrous(
        diff, view_z_in, normal_roughness, history_length, step_size=step_size,
        is_first=is_first, frame_index=int(sc["frame_index"]), **_frame_geometry(sc),
        denoising_range=float(sc["denoising_range"]),
        depth_threshold=float(dc["depth_threshold"]),
        lobe_fraction=k_atrous.lobe_fraction(dc["lobe_angle_fraction"], step_size, is_first),
        lobe_angle_fraction=float(dc["lobe_angle_fraction"]),
        phi_luminance=float(dc["diff_phi_luminance"]),
        max_luminance_relative_difference=float(dc["diff_max_luminance_relative_difference"]),
        min_material=float(dc["diff_min_material"]),
        history_threshold=float(dc["history_threshold"]))


def split_screen(sc, view_z_in, noisy, out_signal):
    """SplitScreen: the noisy input (0 beyond the denoising range) left of the split."""
    h, w = view_z_in.shape
    view_z = unpack_view_z(sc, view_z_in)
    u = nm.div(torch.arange(w, dtype=torch.float32, device=view_z_in.device) + 0.5, w)
    s = noisy * (view_z < float(sc["denoising_range"])).to(torch.float32)[..., None]
    return torch.where(u[None, :, None] <= float(sc["split_screen"]), s, out_signal)
