"""SIGMA_SHADOW / SIGMA_SHADOW_TRANSLUCENCY for the PyTorch port - counterpart of
`nrdtpu/passes/sigma/`. The helpers of SIGMA_Common.hlsli live here, so that the kernel
modules' plain versions and the pass glue (`kernels.py`) share them without an import cycle.
"""

from __future__ import annotations

import torch

from ...frontend import NRD_FP16_MAX

# SIGMA_Config.hlsli:29-36
SIGMA_MAX_PIXEL_RADIUS = 32.0
SIGMA_TS_SIGMA_SCALE = 3.0
SIGMA_MAX_ACCUM_FRAME_NUM = 7.0
NRD_DISOCCLUSION_THRESHOLD = 0.02  # Common.hlsli:67


def is_lit(penumbra):
    """IsLit (SIGMA_Common.hlsli:16)."""
    return (penumbra >= NRD_FP16_MAX).to(torch.float32)


def pack_shadow(s):
    """PackShadow = Math::Sqrt01 (SIGMA_Common.hlsli:15)."""
    return torch.sqrt(torch.clamp(s, 0.0, 1.0))


def unpack_shadow(s):
    return s * s


def get_kernel_radius_in_pixels(hit_dist, unproject_z, scale=1.0):
    """GetKernelRadiusInPixels (SIGMA_Common.hlsli:23-35), 5x5 estimation variant."""
    unclamped = hit_dist / unproject_z * scale
    min_radius = torch.clamp_max(unclamped, 2.0)
    return torch.clamp_max(torch.maximum(unclamped, min_radius), SIGMA_MAX_PIXEL_RADIUS)


def are_both_lit_or_unlit(penumbra1, penumbra2):
    """AreBothLitOrUnlit (SIGMA_Common.hlsli:37-43): NoL-invalid (== 0) agreement."""
    return ((penumbra1 == 0.0) == (penumbra2 == 0.0)).to(torch.float32)
