"""REBLUR shared helpers (REBLUR_Common.hlsli + REBLUR_Config.hlsli) - the part the diffuse
path uses; counterpart of `nrdtpu/passes/reblur/common.py`.

Signals are (h, w, 4): YCoCg + normalized hit distance, hit distance the last channel.
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


def get_non_linear_accum_speed(accum_speed, max_accum_speed, confidence):
    """GetNonLinearAccumSpeed (REBLUR_Common.hlsli:112-124), confidence variant, with
    data on every pixel (no checkerboard)."""
    return torch.maximum(1.0 - confidence,
                         1.0 / (1.0 + torch.clamp_max(accum_speed, max_accum_speed)))


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


def get_luma(signal):
    """GetLuma: YCoCg .x for radiance signals."""
    return signal[..., 0]


def get_luma_scale(curr_luma, new_luma):
    return (new_luma + nm.EPS) / (curr_luma + nm.EPS)


def change_luma(signal, new_luma):
    scale = get_luma_scale(get_luma(signal), new_luma)
    return torch.cat([signal[..., :3] * scale[..., None], signal[..., 3:]], -1)


def clamp_negative_to_zero(signal):
    """ClampNegativeToZero (REBLUR_Common.hlsli:168-240) for radiance."""
    hit = nm.saturate(signal[..., -1:])
    return torch.cat([nm.linear_to_ycocg(nm.ycocg_to_linear(signal[..., :3])), hit], -1)


def mix_history_and_current(dc, history, current, f, roughness):
    """MixHistoryAndCurrent (REBLUR_Common.hlsli:152-207) for radiance."""
    min_limit = get_min_allowed_limit_for_hit_dist_non_linear_accum_speed(dc, roughness)
    f_hit = torch.maximum(f, min_limit)
    out_rgb = nm.lerp(history[..., :3], current[..., :3], f[..., None])
    out_hit = nm.lerp(history[..., 3], current[..., 3], f_hit)
    return torch.cat([out_rgb, out_hit[..., None]], -1)
