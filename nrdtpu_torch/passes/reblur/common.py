"""REBLUR shared helpers (REBLUR_Common.hlsli + REBLUR_Config.hlsli); counterpart of
`nrdtpu/passes/reblur/common.py`.

Signals are (h, w, 4): YCoCg + normalized hit distance, for the radiance variants, or (h, w,
1): the normalized hit distance, for the occlusion variants (`occlusion=True` below); the hit
distance is the last channel.
Frame constants (`sc`, `dc`) are host values: Python floats or small numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import math as nm

REBLUR_ACCUMSPEED_BITS = 6
REBLUR_MATERIALID_BITS = 4
REBLUR_MAX_ACCUM_FRAME_NUM = (1 << REBLUR_ACCUMSPEED_BITS) - 1  # 63
REBLUR_MAX_MATERIALID_NUM = (1 << REBLUR_MATERIALID_BITS) - 1

REBLUR_PRE_BLUR_FRACTION_SCALE = 2.0
REBLUR_PRE_BLUR_NON_LINEAR_ACCUM_SPEED = 1.0 / (1.0 + 10.0)
REBLUR_BLUR_FRACTION_SCALE = 1.0
REBLUR_POST_BLUR_FRACTION_SCALE = 0.5
REBLUR_POST_BLUR_RADIUS_SCALE = 2.0

REBLUR_ALMOST_ZERO_ANGLE = 0.017452383413910866  # float32 cos(89 degrees)
REBLUR_FIREFLY_SUPPRESSOR_MAX_RELATIVE_INTENSITY = 38.0
REBLUR_FIREFLY_SUPPRESSOR_RADIUS_SCALE = 0.1
REBLUR_FIREFLY_SUPPRESSOR_FAST_RELATIVE_INTENSITY = 4.0
REBLUR_SAMPLES_PER_FRAME = 1.0
REBLUR_VIRTUAL_MOTION_PREV_PREV_WEIGHT_ITERATION_NUM = 1
REBLUR_ROUGHNESS_SENSITIVITY_IN_TA = nm.NRD_ROUGHNESS_SENSITIVITY * 0.3
REBLUR_MAX_PERCENT_OF_LOBE_VOLUME_FOR_PRE_PASS = 0.3
NRD_CURVATURE_Z_THRESHOLD = 0.1
REBLUR_ANTI_FIREFLY_SIGMA_SCALE = 2.0  # the ring's radius is kernels.history_fix's

f32 = np.float32


def color_clamping_sigma_scale(occlusion: bool) -> float:
    return 1.0 if occlusion else 2.0


def quantize_accum_speed(a):
    """6-bit round-trip of accumSpeed / 63 - the R16_UINT feedback precision."""
    return torch.round(nm.saturate(a / REBLUR_MAX_ACCUM_FRAME_NUM) * REBLUR_MAX_ACCUM_FRAME_NUM)


def quantize_material_id(m):
    return torch.round(torch.clamp(m, 0, REBLUR_MAX_MATERIALID_NUM))


def get_view_vector(sc, x_world):
    """GetViewVector (world space): normalize(-X) for perspective (camera at origin)."""
    if float(sc["ortho_mode"]) == 0.0:
        return nm.normalize(-x_world)
    vv = [float(c) for c in sc["view_vector_world"]]
    return torch.tensor(vv, dtype=torch.float32, device=x_world.device).expand_as(x_world)


def get_view_vector_prev(sc, x_prev):
    if float(sc["ortho_mode"]) == 0.0:
        cd = torch.tensor([float(c) for c in sc["camera_delta"]], dtype=torch.float32,
                          device=x_prev.device)
        return nm.normalize(cd - x_prev)
    vv = [float(c) for c in sc["view_vector_world_prev"]]
    return torch.tensor(vv, dtype=torch.float32, device=x_prev.device).expand_as(x_prev)


def get_min_allowed_limit_for_hit_dist_non_linear_accum_speed(dc, roughness):
    """REBLUR_Common.hlsli:94-102."""
    frame_num = 0.5 * nm.get_spec_magic_curve(roughness) * float(dc["max_accumulated_frame_num"])
    return 1.0 / (1.0 + frame_num)


def fade_bounds(dc):
    """(a, b - a) of GetFadeBasedOnAccumulatedFrames, evaluated in float32 as on the device."""
    n = f32(dc["history_fix_frame_num"])
    a = n * f32(2.0) / f32(3.0) + f32(1e-6)
    b = n * f32(4.0) / f32(3.0) + f32(2e-6)
    return float(a), float(b - a)


def get_fade_based_on_accumulated_frames(dc, accum_speed):
    """REBLUR_Common.hlsli:104-110."""
    a, ba = fade_bounds(dc)
    return nm.saturate((accum_speed - a) / ba)


def get_non_linear_accum_speed(sc, accum_speed, max_accum_speed, confidence, has_data=None):
    """GetNonLinearAccumSpeed (REBLUR_Common.hlsli:112-124), confidence variant; has_data:
    the (h, w) bool plane of the pixels with data under checkerboard, None without it."""
    nlas = torch.maximum(1.0 - confidence,
                         1.0 / (1.0 + torch.clamp_max(accum_speed, max_accum_speed)))
    if has_data is None:
        return nlas
    return torch.where(has_data, nlas, nlas * no_data_scale(sc, nlas))


def no_data_scale(sc, nlas):
    """lerp(1 - checkerboardResolveAccumSpeed, 1, nlas): the slower accumulation of a pixel
    without data under checkerboard (REBLUR_TemporalAccumulation.hlsli:731-735, :878-880)."""
    a = f32(1.0) - f32(sc["checkerboard_resolve_accum_speed"])
    return float(a) + float(f32(1.0) - a) * nlas


def cb_expand(sig_half, w_full):
    """Expand a half-width checkerboard input to full resolution: full-res pixel x reads
    half-res texel x >> 1, as the reference's `pos.x >>= 1` reads (REBLUR_PrePass.hlsli:62-64).
    Works for (h, w/2) and (h, w/2, c)."""
    return torch.repeat_interleave(sig_half, 2, dim=1)[:, :w_full].contiguous()


def remap_roughness_to_responsive_factor(dc, roughness):
    """REBLUR_Common.hlsli:126-131."""
    amount = (roughness + nm.EPS) / float(
        f32(dc["responsive_accumulation_roughness_threshold"]) + f32(nm.EPS))
    return nm.smoothstep01(amount)


def get_modified_roughness_from_normal_variance(roughness, n_avg_unnormalized):
    """Filtering::GetModifiedRoughnessFromNormalVariance: widen roughness by the normal
    variance of the 2x2 footprint (vMF fit)."""
    l = nm.length(n_avg_unnormalized)  # noqa: E741
    kappa = nm.saturate(1.0 - l * l) / torch.clamp_min(l * (3.0 - l * l), 1e-15)
    return torch.sqrt(nm.saturate(roughness * roughness + kappa))


def extract_hit_dist(signal):
    return signal[..., -1]


def get_luma(signal, occlusion: bool = False, directional: bool = False):
    """GetLuma: YCoCg .x for radiance signals, the hit distance for occlusion and for
    directional occlusion (its .w)."""
    return signal[..., -1] if occlusion or directional else signal[..., 0]


def get_luma_scale(curr_luma, new_luma):
    return (new_luma + nm.EPS) / (curr_luma + nm.EPS)


def change_luma(signal, new_luma, occlusion: bool = False, directional: bool = False):
    """ChangeLuma: the YCoCg scaled to the new luma; for occlusion the new luma itself; for
    directional occlusion .xyz scaled by the luma change of .w, and .w the new luma
    (`nrdtpu/passes/reblur/common.py:139-147`)."""
    if occlusion:
        return new_luma[..., None]
    if directional:
        scale = get_luma_scale(signal[..., 3], new_luma)
        return torch.cat([signal[..., :3] * scale[..., None], new_luma[..., None]], -1)
    scale = get_luma_scale(get_luma(signal), new_luma)
    return torch.cat([signal[..., :3] * scale[..., None], signal[..., 3:]], -1)


def sh_luma_scale(sh, new_luma):
    """The SH variants' luma rule (`nrdtpu/passes/reblur/kernels.py:493-495`, `:729-731`,
    `:2407-2410`): SH1's .xyz scaled by get_luma_scale(length(.xyz), new_luma), .w kept."""
    scale = get_luma_scale(nm.length(sh[..., :3]), new_luma)
    return torch.cat([sh[..., :3] * scale[..., None], sh[..., 3:]], -1)


def clamp_negative_to_zero(signal, occlusion: bool = False, directional: bool = False):
    """ClampNegativeToZero (REBLUR_Common.hlsli:168-240): for occlusion the saturated hit
    distance; for directional occlusion the saturated .w, .xyz scaled by its change
    (`nrdtpu/passes/reblur/common.py:149-158`)."""
    hit = nm.saturate(signal[..., -1:])
    if occlusion:
        return hit
    if directional:
        return torch.cat([signal[..., :3] * get_luma_scale(signal[..., 3:4], hit), hit], -1)
    return torch.cat([nm.linear_to_ycocg(nm.ycocg_to_linear(signal[..., :3])), hit], -1)


def mix_history_and_current(dc, history, current, f, roughness, occlusion: bool = False):
    """MixHistoryAndCurrent (REBLUR_Common.hlsli:152-207): for occlusion the hit distance
    lerped by f_hit alone."""
    min_limit = get_min_allowed_limit_for_hit_dist_non_linear_accum_speed(dc, roughness)
    f_hit = torch.maximum(f, min_limit)
    if occlusion:
        return nm.lerp(history, current, f_hit[..., None])
    out_rgb = nm.lerp(history[..., :3], current[..., :3], f[..., None])
    out_hit = nm.lerp(history[..., 3], current[..., 3], f_hit)
    return torch.cat([out_rgb, out_hit[..., None]], -1)
