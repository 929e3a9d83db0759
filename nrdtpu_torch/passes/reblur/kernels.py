"""REBLUR diffuse passes - counterpart of the XLA functions in
`nrdtpu/passes/reblur/kernels.py` (REBLUR_*.hlsli).

Each pass is elementwise torch glue around one hand-written kernel of `nrdtpu_torch.kernels`:

  surface_motion_reprojection -> smb_resolve     (prev footprint + history sampling)
  diffuse_pre_pass,
  diffuse_spatial_filter      -> spatial_filter  (PrePass / Blur / PostBlur tap loop)
  history_fix                 -> history_fix     (stride taps + 3x3 fast-history moments)
  temporal_stabilization      -> ts_prelude      (3x3 luma moments + history sampling)

The glue keeps the op order of the XLA functions; the kernels compute the per-pixel formula
of the XLA gathers, not the TPU kernels' workarounds. Frame constants (`sc`, `dc`) are host
values, so nothing but pixel planes lives on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ... import math as nm
from ... import vec3 as v3
from ...frontend import NRD_EPS
from ...kernels import history_fix as k_history_fix
from ...kernels import smb_resolve as k_smb_resolve
from ...kernels import spatial_filter as k_spatial_filter
from ...kernels import ts_prelude as k_ts_prelude
from ...ops import resample, tiles
from . import common as C

BLUR = 1
POST_BLUR = 2


def _v(x):
    return [float(c) for c in np.asarray(x, np.float32).reshape(-1)]


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def unpack_view_z(sc, z):
    return torch.abs(z) * float(sc["view_z_scale"])


def unpack_nr(normal_roughness, config):
    return fe.unpack_normal_roughness(normal_roughness, config.normal_encoding,
                                      config.roughness_encoding)


def unpack_nr3(normal_roughness, config):
    """unpack_nr returning a plane-wise V3 normal (R10G10B10A2)."""
    if config.normal_encoding.name != "R10_G10_B10_A2_UNORM":
        raise NotImplementedError("the port takes R10G10B10A2 normals only (ROADMAP.md)")
    n3 = v3.decode_oct_raw(normal_roughness[..., 0], normal_roughness[..., 1])
    return n3, normal_roughness[..., 2], normal_roughness[..., 3] * 3.0


def classify_tiles(sc, view_z):
    return tiles.classify_sky_tiles(unpack_view_z(sc, view_z), float(sc["denoising_range"]))


def sky_pixel_mask(sc, tile_map, view_z):
    """Combined early-out mask: sky tile or beyond denoising range (True = skip)."""
    h, w = view_z.shape
    sky = tiles.tile_upsample_nearest(tile_map, h, w)
    return (sky > 0.0) | (unpack_view_z(sc, view_z) > float(sc["denoising_range"]))


def _smb_pixel_uv(sc, uv, view_z, x, mv_in):
    """Surface-motion previous position and uv (TA lines 131-150, TS lines 50-70)."""
    mvs = _v(sc["mv_scale"])
    mv = torch.stack([mv_in[..., i] * mvs[i] for i in range(3)], -1)
    is_world_mv = mvs[3] != 0.0
    smb_uv_screen = uv + mv[..., :2]
    mv_z_computed = nm.affine_transform(sc["world_to_view_prev"], x)[..., 2] - view_z
    mv_z = mv_z_computed if mvs[2] == 0.0 else mv[..., 2]
    view_z_prev = view_z + mv_z
    xv_prev_local = nm.reconstruct_view_position(smb_uv_screen, sc["frustum_prev"],
                                                 view_z_prev, sc["ortho_mode"])
    cd = _v(sc["camera_delta"])
    x_prev_screen = nm.rotate_vector_transposed(sc["world_to_view_prev"], xv_prev_local)
    x_prev_screen = torch.stack([x_prev_screen[..., i] + cd[i] for i in range(3)], -1)
    if is_world_mv:
        x_prev_world = x + mv
        return x_prev_world, nm.get_screen_uv(sc["world_to_clip_prev"], x_prev_world)
    return x_prev_screen, smb_uv_screen


# ---------------------------------------------------------------------------
# TemporalAccumulation (REBLUR_TemporalAccumulation.hlsli) - diffuse
# ---------------------------------------------------------------------------


def surface_motion_reprojection(sc, dc, view_z_in, normal_roughness, mv_in, prev_view_z,
                                prev_normal_roughness, prev_internal, config, history,
                                fast_history, disocclusion_threshold_mix=None):
    """The surface-motion machinery of TA (lines 131-305) plus the history samples at the
    reprojected position (`sample_history` / `sample_history_bilinear`, lines 451-456).

    prev_internal: dict(diff_accum, material_id). The footprint gathers and the
    history sampling run in `kernels.smb_resolve`; the rest is elementwise here."""
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    view_z = unpack_view_z(sc, view_z_in)
    n, roughness, material_id = unpack_nr(normal_roughness, config)

    xv = nm.reconstruct_view_position(uv, sc["frustum"], view_z, sc["ortho_mode"])
    x = nm.rotate_vector(sc["view_to_world"], xv)
    x_prev, smb_pixel_uv = _smb_pixel_uv(sc, uv, view_z, x, mv_in)

    # parallax (lines 206-211)
    ortho = float(sc["ortho_mode"])
    cd = _v(sc["camera_delta"])
    uv_zp1 = smb_pixel_uv if ortho == 0.0 else uv
    uv_zp2 = uv if ortho == 0.0 else smb_pixel_uv
    p1_uv = nm.get_screen_uv(sc["world_to_clip_prev"],
                             torch.stack([x_prev[..., i] + cd[i] for i in range(3)], -1))
    p2_uv = nm.get_screen_uv(sc["world_to_clip"],
                             torch.stack([x_prev[..., i] - cd[i] for i in range(3)], -1))
    rw, rh = _v(sc["rect_size"])
    parallax1 = nm.length(nm.scale2(p1_uv - uv_zp1, rw, rh))
    parallax2 = nm.length(nm.scale2(p2_uv - uv_zp2, rw, rh))
    parallax_max = torch.maximum(parallax1, parallax2)

    # disocclusion threshold (lines 213-234)
    pixel_size = nm.pixel_radius_to_world(float(sc["unproject"]), ortho, 1.0, view_z)
    frustum_size = nm.get_frustum_size(float(sc["min_rect_dim_mul_unproject"]), ortho, view_z)
    mix_ = torch.where(material_id == float(sc["strand_material_id"]),
                       fe.get_normalized_strand_thickness(float(sc["strand_thickness"]),
                                                          pixel_size), 0.0)
    if disocclusion_threshold_mix is not None:
        mix_ = disocclusion_threshold_mix
    bonus = np.float32(sc["disocclusion_threshold_bonus"])
    disocclusion_threshold = nm.lerp(float(np.float32(sc["disocclusion_threshold"]) + bonus),
                                     float(np.float32(sc["disocclusion_threshold_alternate"])
                                           + bonus), mix_)
    small_parallax = nm.linearstep(0.25, 0.0, parallax_max)
    disocclusion_threshold = disocclusion_threshold + 0.05 * small_parallax

    v = C.get_view_vector(sc, x)
    nov = torch.abs(nm.dot(n, v))
    nov_strict = nm.lerp(nov, 1.0, nm.saturate(parallax_max / 30.0))
    base_threshold = nm.get_disocclusion_threshold(disocclusion_threshold, frustum_size,
                                                   nov_strict)
    navg_thr = C.REBLUR_ALMOST_ZERO_ANGLE - 0.25 * small_parallax
    xv_prev = nm.affine_transform(sc["world_to_view_prev"], x_prev)

    # the material test takes the smaller minimum even for diffuse
    # (nrdtpu/passes/reblur/kernels.py:214)
    min_material = min(float(dc["spec_min_material"]), float(dc["diff_min_material"]))
    res = k_smb_resolve.smb_resolve(
        smb_pixel_uv.contiguous(), xv_prev[..., 2].contiguous(), base_threshold.contiguous(),
        navg_thr.contiguous(), normal_roughness, prev_view_z, prev_normal_roughness,
        prev_internal["material_id"], prev_internal["diff_accum"], history, fast_history,
        view_z_scale=float(sc["view_z_scale"]), denoising_range=float(sc["denoising_range"]),
        rect_size_prev=_v(sc["rect_size_prev"]), min_material=min_material,
        world_prev_to_world=np.asarray(sc["world_prev_to_world"], np.float32)[:3, :3])

    # footprint quality (lines 296-305)
    smb_vprev = C.get_view_vector_prev(sc, x_prev)
    nov_prev = torch.abs(nm.dot(n, smb_vprev))
    size_quality = (nov_prev + 1e-3) / (nov + 1e-3)
    size_quality = size_quality * size_quality
    size_quality = nm.lerp(0.1, 1.0, nm.saturate(size_quality))
    footprint_quality = torch.sqrt(nm.saturate(res["footprint_raw"])) * size_quality

    return dict(material_id=material_id, allow_catrom=res["allow_catrom"], fbits=res["fbits"],
                diff_accum_speed=res["diff_accum_speed"], footprint_quality=footprint_quality,
                history=res["history"], fast=res["fast"])


def temporal_accumulation_diffuse(sc, dc, sm, diff_input, diff_confidence=None):
    """Diffuse half of TA (lines 826-930) for the radiance signal.
    Returns (diff_out, fast_out, accum_speed_out)."""
    diff_accum_speed = sm["diff_accum_speed"]
    confidence = sm["footprint_quality"]
    if diff_confidence is not None:
        confidence = confidence * diff_confidence
    diff_accum_speed = diff_accum_speed * nm.lerp(confidence, 1.0,
                                                  1.0 / (1.0 + diff_accum_speed))
    diff_accum_speed = torch.clamp_max(diff_accum_speed, float(dc["max_accumulated_frame_num"]))

    smb_diff_history = C.clamp_negative_to_zero(sm["history"])
    smb_diff_fast = sm["fast"]

    diff_nlas = 1.0 / (1.0 + diff_accum_speed)
    diff_result = C.mix_history_and_current(dc, smb_diff_history, diff_input, diff_nlas,
                                            torch.ones_like(diff_nlas))

    # firefly suppressor (lines 888-903)
    max_rel = (float(dc["firefly_suppressor_min_relative_scale"])
               + C.REBLUR_FIREFLY_SUPPRESSOR_MAX_RELATIVE_INTENSITY / (diff_accum_speed + 1.0))
    antifirefly = diff_accum_speed * float(dc["max_blur_radius"]) \
        * C.REBLUR_FIREFLY_SUPPRESSOR_RADIUS_SCALE
    antifirefly = antifirefly / (1.0 + antifirefly)
    luma = C.get_luma(diff_result)
    luma_clamped = torch.minimum(luma, C.get_luma(smb_diff_history) * max_rel)
    luma_clamped = nm.lerp(luma, luma_clamped, antifirefly)
    diff_result = C.change_luma(diff_result, luma_clamped)

    # fast history (lines 911-924)
    fast_accum_speed = torch.clamp_max(diff_accum_speed,
                                       float(dc["max_fast_accumulated_frame_num"]))
    fast_nlas = 1.0 / (1.0 + fast_accum_speed)
    fast_result = nm.lerp(smb_diff_fast, C.get_luma(diff_input), fast_nlas)
    fast_clamped = torch.minimum(fast_result, C.get_luma(smb_diff_history) * max_rel
                                 * C.REBLUR_FIREFLY_SUPPRESSOR_FAST_RELATIVE_INTENSITY)
    fast_result = nm.lerp(fast_result, fast_clamped, antifirefly)
    return diff_result, fast_result, diff_accum_speed


# ---------------------------------------------------------------------------
# HistoryFix (REBLUR_HistoryFix.hlsli) - diffuse
# ---------------------------------------------------------------------------


def history_fix(sc, dc, view_z_in, normal_roughness, data1_diff, signal, fast_history, config,
                *, anti_firefly: bool = False):
    """Sparse 5x5-no-corners history reconstruction + fast-history color clamping.

    signal: (h, w, 4) output of TA; fast_history: (h, w). Returns (signal_out, fast_out)."""
    if anti_firefly:
        raise NotImplementedError(
            "REBLUR anti-firefly (the 9x9 ring of HistoryFix) is not ported yet (ROADMAP.md)")
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    view_z = unpack_view_z(sc, view_z_in)
    n3, roughness, _ = unpack_nr3(normal_roughness, config)
    ortho = float(sc["ortho_mode"])
    frustum_size = nm.get_frustum_size(float(sc["min_rect_dim_mul_unproject"]), ortho, view_z)
    xv3 = v3.reconstruct_view_position(uv[..., 0], uv[..., 1], sc["frustum"], view_z, ortho)
    nv3 = v3.rotate(sc["world_to_view"], n3)

    frame_num = data1_diff
    stride = float(dc["history_fix_base_pixel_stride"]) / (2.0 + frame_num)
    stride = stride * (frame_num < float(dc["history_fix_frame_num"])).to(torch.float32)
    stride = torch.floor(stride)

    ones = torch.ones_like(roughness)
    nlas = 1.0 / (1.0 + frame_num)
    enc_err = nm.normal_encoding_error(int(config.normal_encoding))
    normal_weight_param = nm.get_normal_weight_param(nlas, float(dc["lobe_angle_fraction"]), ones,
                                                     enc_err)
    ga = 1.0 / (float(dc["plane_dist_sensitivity"]) * frustum_size)
    gb = -v3.dot(nv3, xv3) * ga
    hit_dist_scale = fe.get_hit_distance_normalization(view_z, dc["hit_dist_params"], ones)
    hit_dist = C.extract_hit_dist(signal) * hit_dist_scale
    hit_dist_factor = nm.get_hit_dist_factor(hit_dist, frustum_size)
    ha, hb = nm.get_hit_distance_weight_params(hit_dist_factor, nlas, ones)

    params = torch.stack([stride, ga, gb, normal_weight_param, ha, hb, hit_dist_scale,
                          frustum_size, n3.x, n3.y, n3.z, nv3.x, nv3.y, nv3.z])
    signal_out, m1, m2 = k_history_fix.history_fix(
        signal, view_z_in, normal_roughness, data1_diff, fast_history, params,
        frustum=_v(sc["frustum"]), rect_size_inv=_v(sc["rect_size_inv"]),
        view_z_scale=float(sc["view_z_scale"]), ortho_mode=ortho,
        min_material=float(dc["diff_min_material"]))

    # local variance over 3x3 fast history + fast history adjustments (lines 169-244)
    f = nm.saturate(frame_num / float(np.float32(dc["history_fix_frame_num"])
                                      + np.float32(NRD_EPS)))
    luma = C.get_luma(signal_out)
    fast_out = nm.lerp(luma, fast_history, f)
    sigma = nm.get_std_dev(m1, m2) * C.color_clamping_sigma_scale(False)
    luma_clamped = torch.clamp(luma, m1 - sigma, m1 + sigma)
    fast_enabled = 1.0 if (float(dc["max_fast_accumulated_frame_num"])
                           < float(dc["max_accumulated_frame_num"])) else 0.0
    luma = nm.lerp(luma_clamped, luma, 1.0 / (1.0 + fast_enabled * frame_num * 2.0))
    return C.change_luma(signal_out, luma), fast_out


# ---------------------------------------------------------------------------
# Spatial filters (REBLUR_Blur.hlsli, REBLUR_PrePass.hlsli,
# REBLUR_Common_DiffuseSpatialFilter.hlsli)
# ---------------------------------------------------------------------------


def _geometry(sc, view_z_in, normal_roughness, config):
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    view_z = unpack_view_z(sc, view_z_in)
    n3, roughness, _ = unpack_nr3(normal_roughness, config)
    nv3 = v3.rotate(sc["world_to_view"], n3)
    ortho = float(sc["ortho_mode"])
    xv3 = v3.reconstruct_view_position(uv[..., 0], uv[..., 1], sc["frustum"], view_z, ortho)
    frustum_size = nm.get_frustum_size(float(sc["min_rect_dim_mul_unproject"]), ortho, view_z)
    return uv, view_z, n3, roughness, nv3, xv3, frustum_size


def _spatial_taps(sc, dc, signal, view_z_in, normal_roughness, config, scaled_rotator, ga, gb,
                  normal_weight_param, ha, hb, min_hit_dist_weight, n3, nv3, perf_mode):
    params = torch.stack([scaled_rotator[..., 0], scaled_rotator[..., 1],
                          scaled_rotator[..., 2], scaled_rotator[..., 3], ga, gb,
                          normal_weight_param, ha, hb, min_hit_dist_weight,
                          n3.x, n3.y, n3.z, nv3.x, nv3.y, nv3.z])
    return k_spatial_filter.spatial_filter(
        signal, view_z_in, normal_roughness, params, frustum=_v(sc["frustum"]),
        rect_size=_v(sc["rect_size"]), view_z_scale=float(sc["view_z_scale"]),
        ortho_mode=float(sc["ortho_mode"]), min_material=float(dc["diff_min_material"]),
        perf_mode=perf_mode)


def diffuse_spatial_filter(sc, dc, mode, signal, view_z_in, normal_roughness, data1, config,
                           *, perf_mode: bool = False):
    """Adaptive-radius 8-tap Poisson blur, screen-space sampling. mode: BLUR or POST_BLUR."""
    uv, view_z, n3, roughness, nv3, xv3, frustum_size = _geometry(sc, view_z_in,
                                                                  normal_roughness, config)
    vv3 = (v3.normalize(v3.V3(-xv3.x, -xv3.y, -xv3.z)) if float(sc["ortho_mode"]) == 0.0
           else v3.V3.full_like(view_z, 0.0, 0.0, -1.0))
    nov = torch.abs(v3.dot(nv3, vv3))
    rotator = _v(sc["rotator"] if mode == BLUR else sc["rotator_post"])
    fraction_scale = (C.REBLUR_BLUR_FRACTION_SCALE if mode == BLUR
                      else C.REBLUR_POST_BLUR_FRACTION_SCALE)
    radius_scale = 1.0 if mode == BLUR else C.REBLUR_POST_BLUR_RADIUS_SCALE

    ones = torch.ones_like(roughness)
    hit_dist_scale = fe.get_hit_distance_normalization(view_z, dc["hit_dist_params"], ones)
    hit_dist = C.extract_hit_dist(signal) * hit_dist_scale
    hit_dist_factor = nm.get_hit_dist_factor(hit_dist, frustum_size)

    boost = 1.0 - C.get_fade_based_on_accumulated_frames(dc, data1)
    boost = boost * (1.0 - torch.pow(nm.saturate(1.0 - nov), 5.0))
    nlas = 1.0 / (1.0 + C.REBLUR_SAMPLES_PER_FRAME * (1.0 - boost) * data1)

    blur_radius = float(dc["max_blur_radius"]) * torch.sqrt(nm.saturate(hit_dist_factor * nlas))
    blur_radius = blur_radius * radius_scale
    blur_radius = torch.clamp_min(blur_radius, float(dc["min_blur_radius"]))

    enc_err = nm.normal_encoding_error(int(config.normal_encoding))
    ga = 1.0 / (float(dc["plane_dist_sensitivity"]) * frustum_size)
    gb = -v3.dot(nv3, xv3) * ga
    normal_weight_param = nm.get_normal_weight_param(
        nlas, float(dc["lobe_angle_fraction"]), ones, enc_err) / fraction_scale
    ha, hb = nm.get_hit_distance_weight_params(C.extract_hit_dist(signal), nlas, ones)
    min_hit_dist_weight = float(np.float32(dc["min_hit_distance_weight"])
                                * np.float32(fraction_scale)) * torch.sqrt(nlas)

    # screen-space sampling (REBLUR_USE_SCREEN_SPACE_SAMPLING_FOR_DIFFUSE == 1)
    skew_x = nm.lerp(1.0 - torch.abs(nv3.x), 1.0, nov)
    skew_y = nm.lerp(1.0 - torch.abs(nv3.y), 1.0, nov)
    skew_max = torch.maximum(skew_x, skew_y)
    rinv = _v(sc["rect_size_inv"])
    skew = torch.stack([skew_x / skew_max * rinv[0] * blur_radius,
                        skew_y / skew_max * rinv[1] * blur_radius], -1)
    scaled_rotator = nm.scale_rotator(_rotator_planes(rotator, view_z), skew)
    return _spatial_taps(sc, dc, signal, view_z_in, normal_roughness, config, scaled_rotator,
                         ga, gb, normal_weight_param, ha, hb, min_hit_dist_weight, n3, nv3,
                         perf_mode)


def _rotator_planes(rotator, like):
    return torch.stack([torch.full_like(like, r) for r in rotator], -1)


def diffuse_pre_pass(sc, dc, signal, view_z_in, normal_roughness, config, *,
                     perf_mode: bool = False):
    """Diffuse PrePass: the spatial filter with pre-pass constants and no skew."""
    uv, view_z, n3, roughness, nv3, xv3, frustum_size = _geometry(sc, view_z_in,
                                                                  normal_roughness, config)
    ones = torch.ones_like(roughness)
    nlas = torch.full_like(view_z, C.REBLUR_PRE_BLUR_NON_LINEAR_ACCUM_SPEED)
    fraction_scale = C.REBLUR_PRE_BLUR_FRACTION_SCALE

    hit_dist_scale = fe.get_hit_distance_normalization(view_z, dc["hit_dist_params"], ones)
    hit_dist = C.extract_hit_dist(signal) * hit_dist_scale
    hit_dist_factor = nm.get_hit_dist_factor(hit_dist, frustum_size)
    blur_radius = float(dc["diff_prepass_blur_radius"]) * torch.sqrt(nm.saturate(hit_dist_factor))
    blur_radius = torch.clamp_min(blur_radius, float(dc["min_blur_radius"]))

    enc_err = nm.normal_encoding_error(int(config.normal_encoding))
    ga = 1.0 / (float(dc["plane_dist_sensitivity"]) * frustum_size)
    gb = -v3.dot(nv3, xv3) * ga
    normal_weight_param = nm.get_normal_weight_param(
        nlas, float(dc["lobe_angle_fraction"]), ones, enc_err) / fraction_scale
    ha, hb = nm.get_hit_distance_weight_params(C.extract_hit_dist(signal), nlas, ones)
    min_hit_dist_weight = torch.full_like(
        view_z, float(np.float32(dc["min_hit_distance_weight"]) * np.float32(fraction_scale)))

    rinv = _v(sc["rect_size_inv"])
    skew = torch.stack([rinv[0] * blur_radius, rinv[1] * blur_radius], -1)
    scaled_rotator = nm.scale_rotator(_rotator_planes(_v(sc["rotator_pre"]), view_z), skew)
    out = _spatial_taps(sc, dc, signal, view_z_in, normal_roughness, config, scaled_rotator,
                        ga, gb, normal_weight_param, ha, hb, min_hit_dist_weight, n3, nv3,
                        perf_mode)
    return signal if float(dc["diff_prepass_blur_radius"]) == 0.0 else out


# ---------------------------------------------------------------------------
# SplitScreen (REBLUR_SplitScreen.hlsli)
# ---------------------------------------------------------------------------


def split_screen(sc, noisy_input, view_z_in, out_signal):
    h, w = view_z_in.shape
    view_z = unpack_view_z(sc, view_z_in)
    u = nm.div(torch.arange(w, dtype=torch.float32, device=view_z_in.device) + 0.5, w)
    noisy = noisy_input * (view_z < float(sc["denoising_range"])).to(torch.float32)[..., None]
    show_input = u[None, :, None] <= float(sc["split_screen"])
    return torch.where(show_input, noisy, out_signal)


# ---------------------------------------------------------------------------
# TemporalStabilization (REBLUR_TemporalStabilization.hlsli) - diffuse
# ---------------------------------------------------------------------------


def temporal_stabilization(sc, dc, view_z_in, normal_roughness, mv_in, data1_diff, fbits, diff,
                           diff_luma_stab_history, config):
    """Anti-lag output filter, diffuse half.
    Returns dict(diff, diff_luma_stab, data1_diff, mv_out)."""
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    view_z = unpack_view_z(sc, view_z_in)
    xv = nm.reconstruct_view_position(uv, sc["frustum"], view_z, sc["ortho_mode"])
    x = nm.rotate_vector(sc["view_to_world"], xv)
    _, smb_pixel_uv = _smb_pixel_uv(sc, uv, view_z, x, mv_in)

    _, smb_frac = nm.bilinear_filter(smb_pixel_uv, _v(sc["rect_size_prev"]))
    bits = fbits.to(torch.int32)
    smb_occ = torch.stack([((bits >> b) & 1).to(torch.float32) for b in range(4)], -1)
    bw = nm.bilinear_weights(smb_frac)
    smb_quality = torch.sqrt(nm.saturate(torch.sum(smb_occ * bw, -1)))

    luma = C.get_luma(diff)
    pre = k_ts_prelude.ts_prelude(luma.contiguous(), diff_luma_stab_history,
                                  smb_pixel_uv.contiguous(), fbits,
                                  rect_size_prev=_v(sc["rect_size_prev"]))
    m1, m2 = pre["m1"], pre["m2"]
    sigma = nm.get_std_dev(m1, m2)
    luma_rcrs = (torch.clamp(luma, pre["lmin"], pre["lmax"])
                 if float(dc["max_blur_radius"]) != 0.0 else luma)
    smb_hist = torch.clamp_min(pre["history"], 0.0)

    antilag = C.compute_antilag(sc, dc, smb_hist, m1, sigma, smb_quality * data1_diff)
    taw, ta_sigma_scale = C.get_temporal_accumulation_params(sc, smb_quality, data1_diff)
    history_weight = taw * antilag
    history_weight = history_weight * (uv[..., 0] >= float(sc["split_screen"])).to(torch.float32)
    history_weight = history_weight * (smb_pixel_uv[..., 0]
                                       >= float(sc["split_screen_prev"])).to(torch.float32)
    hist_clamped = torch.clamp(smb_hist, m1 - sigma * ta_sigma_scale,
                               m1 + sigma * ta_sigma_scale)
    luma_stab = nm.lerp(luma_rcrs, hist_clamped,
                        torch.clamp_max(history_weight, float(dc["stabilization_strength"])))
    d1 = data1_diff + 1.0
    dmin = torch.clamp_max(d1, float(dc["history_fix_frame_num"]))
    return dict(diff=C.change_luma(diff, luma_stab), diff_luma_stab=luma_stab,
                data1_diff=nm.lerp(dmin, d1, antilag), mv_out=mv_in)
