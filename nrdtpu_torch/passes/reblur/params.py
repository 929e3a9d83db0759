"""REBLUR's per-pixel parameters of the spatial stages and the history-fix clamp - the one
torch definition that the pass glue (`kernels.py`) and the band kernel's plain version
(`nrdtpu_torch/kernels/reblur_band.py`) both call, and whose host constants the band kernel
takes (`nrdtpu/passes/reblur/kernels.py:685-732`, `:763-843`, `:1592-1656`).

`geom` is `filter_geometry`'s dict, or any dict with the planes a function reads.
The evaluation order is the XLA functions', op by op in float32: a Python scalar meets a
tensor as a float32 value, and the host products below are evaluated in float32 as XLA does.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ... import math as nm
from ... import vec3 as v3
from ...frontend import NRD_EPS
from ...ops import resample
from . import common as C

PRE_BLUR = 0
BLUR = 1
POST_BLUR = 2

# per stage: (fraction scale, radius scale) (REBLUR_Config.hlsli)
STAGE_SCALES = {PRE_BLUR: (C.REBLUR_PRE_BLUR_FRACTION_SCALE, 1.0),
                BLUR: (C.REBLUR_BLUR_FRACTION_SCALE, 1.0),
                POST_BLUR: (C.REBLUR_POST_BLUR_FRACTION_SCALE, C.REBLUR_POST_BLUR_RADIUS_SCALE)}


def _v(x):
    return [float(c) for c in np.asarray(x, np.float32).reshape(-1)]


def min_hit_dist_weight_scale(dc, fraction_scale) -> float:
    """minHitDistanceWeight * fractionScale, a float32 product on the host."""
    return float(np.float32(dc["min_hit_distance_weight"]) * np.float32(fraction_scale))


def roughness_fraction_scaled(dc, fraction_scale) -> float:
    """saturate(roughnessFraction * fractionScale), a float32 product on the host."""
    return float(np.clip(np.float32(dc["roughness_fraction"]) * np.float32(fraction_scale),
                         0.0, 1.0))


def history_fix_frame_div(dc) -> float:
    """historyFixFrameNum + NRD_EPS in float32: the divisor of the clamp's fast-history mix."""
    return float(np.float32(dc["history_fix_frame_num"]) + np.float32(NRD_EPS))


def fast_history_enabled(dc) -> float:
    return 1.0 if (float(dc["max_fast_accumulated_frame_num"])
                   < float(dc["max_accumulated_frame_num"])) else 0.0


# ---------------------------------------------------------------------------
# Filter geometry shared by the spatial filters and HistoryFix
# ---------------------------------------------------------------------------


def filter_geometry(sc, dc, view_z_in, normal_roughness, enc_err, signals=("diff", "spec"), *,
                    decoded=False, row0=0, frame_h=None):
    """The per-frame geometry of the spatial stages and HistoryFix
    (`nrdtpu/passes/reblur/kernels.py:1783-1816`): view_z, n3, nv3, xv3, vv3, nov, frustum
    size, the plane-distance parameters ga/gb, and per signal its hit-distance scale (and the
    specular magic curve). It depends only on the G-buffer and the frame constants: at
    R10G10B10A2 the octahedral normal of .xy and the roughness .z as packed; with `decoded`
    (the RGBA formats) the plane that the frame decodes once, its normal .xyz and its roughness
    .w (`unpack_nr3` at these formats). enc_err is the normal encoding's error. H2's kernel
    computes the same per pixel (`csrc/reblur_filters.cuh:filter_geometry`). The dict records
    `decoded`, which the kernels that read its planes take as their mode. row0, frame_h: the
    planes' rows in the frame (`resample.pixel_uv_grid`)."""
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device, row0, frame_h)
    view_z = torch.abs(view_z_in) * float(sc["view_z_scale"])
    if decoded:
        n3 = v3.V3(normal_roughness[..., 0], normal_roughness[..., 1], normal_roughness[..., 2])
        roughness = normal_roughness[..., 3]
    else:
        n3 = v3.decode_oct_raw(normal_roughness[..., 0], normal_roughness[..., 1])
        roughness = normal_roughness[..., 2]
    nv3 = v3.rotate(sc["world_to_view"], n3)
    ortho = float(sc["ortho_mode"])
    xv3 = v3.reconstruct_view_position(uv[..., 0], uv[..., 1], sc["frustum"], view_z, ortho)
    vv3 = (v3.normalize(v3.V3(-xv3.x, -xv3.y, -xv3.z)) if ortho == 0.0
           else v3.V3.full_like(view_z, 0.0, 0.0, -1.0))
    frustum_size = nm.get_frustum_size(float(sc["min_rect_dim_mul_unproject"]), ortho, view_z)
    ga = 1.0 / (float(dc["plane_dist_sensitivity"]) * frustum_size)
    geom = dict(view_z=view_z, n3=n3, roughness=roughness, nv3=nv3, xv3=xv3, vv3=vv3,
                nov=torch.abs(v3.dot(nv3, vv3)), frustum_size=frustum_size, ga=ga,
                gb=-v3.dot(nv3, xv3) * ga, enc_err=enc_err, decoded=decoded)
    if "diff" in signals:
        geom["hd_scale_diff"] = fe.get_hit_distance_normalization(
            view_z, dc["hit_dist_params"], torch.ones_like(roughness))
    if "spec" in signals:
        geom["smc"] = nm.get_spec_magic_curve(roughness)
        geom["hd_scale_spec"] = fe.get_hit_distance_normalization(view_z, dc["hit_dist_params"],
                                                                  roughness)
    return geom


# ---------------------------------------------------------------------------
# HistoryFix clamp (REBLUR_HistoryFix.hlsli:169-244)
# ---------------------------------------------------------------------------


def history_fix_clamp(dc, geom, frame_num, signal_out, fast_history, m1, m2, ring, is_diffuse,
                      sh=None, occlusion=False, directional=False):
    """The fast-history adjustments after the taps (lines 169-244; `kernels.py:685-732`): the
    anti-firefly clamp to the ring's moments where `ring` = (m1, m2) is given, then the clamp
    to the 3x3 moments. Returns (signal_out, fast_out), and with the SH variants' `sh` (the
    taps' SH1) also the SH scaled to the clamped luma (`:729-731`). occlusion: the (h, w, 1)
    hit distance is the luma, the sigma scale 1, and the clamped luma the signal. directional
    (REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION): .w is the luma, the sigma scale 1, and the
    directional ChangeLuma (`kernels.py:686-728` with `directional`)."""
    f = nm.saturate(frame_num / history_fix_frame_div(dc))
    if not is_diffuse:
        f = nm.lerp(1.0, f, geom["smc"])
    luma = C.get_luma(signal_out, occlusion, directional)
    fast_out = nm.lerp(luma, fast_history, f)
    sigma = nm.get_std_dev(m1, m2) * C.color_clamping_sigma_scale(occlusion or directional)
    if ring is not None:
        am1, am2 = ring
        asig = nm.get_std_dev(am1, am2) * C.REBLUR_ANTI_FIREFLY_SIGMA_SCALE
        luma = torch.clamp(luma, am1 - asig, am1 + asig)
    luma_clamped = torch.clamp(luma, m1 - sigma, m1 + sigma)
    luma = nm.lerp(luma_clamped, luma,
                   1.0 / (1.0 + fast_history_enabled(dc) * frame_num * 2.0))
    if sh is not None:
        return C.change_luma(signal_out, luma), fast_out, C.sh_luma_scale(sh, luma)
    return C.change_luma(signal_out, luma, occlusion, directional), fast_out


# ---------------------------------------------------------------------------
# Spatial filter parameters (REBLUR_Common_DiffuseSpatialFilter.hlsli,
# REBLUR_Common_SpecularSpatialFilter.hlsli)
# ---------------------------------------------------------------------------


def scaled_rotator(rotator, skew_x, skew_y):
    """The 4 planes of ScaleRotator(rotator, skew): x terms by skew_x, y terms by skew_y."""
    r = _v(rotator)
    return [r[0] * skew_x, r[1] * skew_y, r[2] * skew_x, r[3] * skew_y]


def diff_spatial_params(sc, dc, mode, geom, signal, data1, occlusion=False):
    """The diffuse planes of PrePass, Blur or PostBlur (`diffuse_pre_pass`,
    `kernels.py:2104-2120`; `diffuse_spatial_filter`, `:763-843`; the fused
    `_fused_diff_params`, `:1819-1854`), in the order of `kernels.spatial_filter.PARAMS`.
    Blur and PostBlur sample in screen space: the radius is skewed by the view-space normal
    (REBLUR_USE_SCREEN_SPACE_SAMPLING_FOR_DIFFUSE == 1). occlusion: the min hit-distance weight
    of Blur and PostBlur without its sqrt(nlas) (`:814`, `:1844`)."""
    view_z = geom["view_z"]
    ones = torch.ones_like(view_z)
    hit_dist = C.extract_hit_dist(signal) * geom["hd_scale_diff"]
    hit_dist_factor = nm.get_hit_dist_factor(hit_dist, geom["frustum_size"])
    rinv = _v(sc["rect_size_inv"])
    fraction_scale, radius_scale = STAGE_SCALES[mode]
    if mode == PRE_BLUR:
        rotator = sc["rotator_pre"]
        nlas = torch.full_like(view_z, C.REBLUR_PRE_BLUR_NON_LINEAR_ACCUM_SPEED)
        blur_radius = float(dc["diff_prepass_blur_radius"]) * torch.sqrt(
            nm.saturate(hit_dist_factor))
        blur_radius = torch.clamp_min(blur_radius, float(dc["min_blur_radius"]))
        min_hit_dist_weight = torch.full_like(
            view_z, min_hit_dist_weight_scale(dc, fraction_scale))
        skew_x, skew_y = rinv[0] * blur_radius, rinv[1] * blur_radius
    else:
        rotator = sc["rotator"] if mode == BLUR else sc["rotator_post"]
        nov = geom["nov"]
        boost = 1.0 - C.get_fade_based_on_accumulated_frames(dc, data1)
        boost = boost * (1.0 - torch.pow(nm.saturate(1.0 - nov), 5.0))
        nlas = 1.0 / (1.0 + C.REBLUR_SAMPLES_PER_FRAME * (1.0 - boost) * data1)
        blur_radius = float(dc["max_blur_radius"]) * torch.sqrt(
            nm.saturate(hit_dist_factor * nlas))
        blur_radius = blur_radius * radius_scale
        blur_radius = torch.clamp_min(blur_radius, float(dc["min_blur_radius"]))
        min_hit_dist_weight = torch.full_like(view_z, min_hit_dist_weight_scale(dc, fraction_scale))
        if not occlusion:
            min_hit_dist_weight = min_hit_dist_weight * torch.sqrt(nlas)
        nv3 = geom["nv3"]
        skew_x = nm.lerp(1.0 - torch.abs(nv3.x), 1.0, nov)
        skew_y = nm.lerp(1.0 - torch.abs(nv3.y), 1.0, nov)
        skew_max = torch.maximum(skew_x, skew_y)
        skew_x = skew_x / skew_max * rinv[0] * blur_radius
        skew_y = skew_y / skew_max * rinv[1] * blur_radius
    normal_weight_param = nm.get_normal_weight_param(
        nlas, float(dc["lobe_angle_fraction"]), ones, geom["enc_err"]) / fraction_scale
    ha, hb = nm.get_hit_distance_weight_params(C.extract_hit_dist(signal), nlas, ones)
    return torch.stack(scaled_rotator(rotator, skew_x, skew_y)
                       + [normal_weight_param, ha, hb, min_hit_dist_weight])


def spec_spatial_params(sc, dc, mode, geom, spec, data1, occlusion=False):
    """The specular planes of PrePass, Blur or PostBlur (`specular_spatial_filter`,
    `kernels.py:1592-1656`; the fused `_fused_spec_params`, `:1857-1912`), in the order of
    `kernels.spatial_filter.PARAMS + SPEC_PARAMS` (+ PREPASS_PARAMS in the PrePass, whose
    radius is bound by the specular lobe, REBLUR_PrePass.hlsli:71-80). occlusion: as for
    diff_spatial_params (`:1655`, `:1903`)."""
    prepass = mode == PRE_BLUR
    view_z, roughness, smc = geom["view_z"], geom["roughness"], geom["smc"]
    nv3, nov = geom["nv3"], geom["nov"]
    rotator = sc[{PRE_BLUR: "rotator_pre", BLUR: "rotator", POST_BLUR: "rotator_post"}[mode]]
    fraction_scale, radius_scale = STAGE_SCALES[mode]

    hit_dist = C.extract_hit_dist(spec) * geom["hd_scale_spec"]
    hit_dist_factor = nm.get_hit_dist_factor(hit_dist, geom["frustum_size"])
    if prepass:
        blur_radius = float(dc["spec_prepass_blur_radius"])
        area_factor = roughness * hit_dist_factor
        nlas = torch.full_like(view_z, C.REBLUR_PRE_BLUR_NON_LINEAR_ACCUM_SPEED)
    else:
        boost = 1.0 - C.get_fade_based_on_accumulated_frames(dc, data1)
        boost = boost * (1.0 - torch.pow(nm.saturate(1.0 - nov), 5.0))
        boost = boost * smc
        nlas = 1.0 / (1.0 + C.REBLUR_SAMPLES_PER_FRAME * (1.0 - boost) * data1)
        blur_radius = float(dc["max_blur_radius"])
        area_factor = roughness * hit_dist_factor * nlas
    blur_radius = blur_radius * torch.sqrt(nm.saturate(area_factor))
    if prepass:
        dv3, dvf = v3.get_specular_dominant_direction(nv3, geom["vv3"], roughness,
                                                      nm.get_specular_dominant_factor)
        nod = torch.abs(v3.dot(nv3, dv3))
        lobe_tan = nm.get_specular_lobe_tan_half_angle(
            roughness, C.REBLUR_MAX_PERCENT_OF_LOBE_VOLUME_FOR_PRE_PASS)
        lobe_radius = hit_dist * nod * lobe_tan
        min_blur_radius = lobe_radius / nm.pixel_radius_to_world(
            float(sc["unproject"]), float(sc["ortho_mode"]), 1.0, view_z + hit_dist * dvf)
        blur_radius = torch.minimum(blur_radius, min_blur_radius)
    blur_radius = blur_radius * radius_scale
    blur_radius = torch.maximum(blur_radius, float(dc["min_blur_radius"]) * smc)

    normal_weight_param = nm.get_normal_weight_param(
        nlas, float(dc["lobe_angle_fraction"]), roughness, geom["enc_err"]) / fraction_scale
    wr_a, wr_b = nm.get_roughness_weight_params(roughness,
                                                roughness_fraction_scaled(dc, fraction_scale))
    ha, hb = nm.get_hit_distance_weight_params(C.extract_hit_dist(spec), nlas, roughness)
    min_hit_dist_weight = min_hit_dist_weight_scale(dc, fraction_scale) * smc
    if not prepass and not occlusion:
        min_hit_dist_weight = min_hit_dist_weight * torch.sqrt(nlas)

    rinv = _v(sc["rect_size_inv"])
    planes = scaled_rotator(rotator, rinv[0] * blur_radius, rinv[1] * blur_radius) + [
        normal_weight_param, ha, hb, min_hit_dist_weight, wr_a, wr_b]
    if prepass:
        xv3 = geom["xv3"]
        planes += [hit_dist, roughness, xv3.x, xv3.y, xv3.z]
    return torch.stack(planes)
