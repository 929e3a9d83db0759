"""RELAX for the PyTorch port - counterpart of `nrdtpu/passes/relax/`. The helpers of
RELAX_Common.hlsli (`nrdtpu/passes/relax/kernels.py:36-136`) live here, so that the kernel
modules' plain versions and the pass glue (`kernels.py`) share them without an import cycle.

World positions are camera-relative and come from the frustum right / up / forward vectors
(RELAX_Common.hlsli:72-97), not from REBLUR's frustum rect. The vectors are host float32
numpy, made once a frame by `frustum_vectors` (Relax.cpp:70-80), and enter the math as
Python floats, so no frame constant is copied to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ... import math as nm
from ... import vec3 as v3

RELAX_NORMAL_ULP = 1.5 / 255.0           # RELAX_Config.hlsli:15
RELAX_ANTILAG_ACCELERATION_AMOUNT_SCALE = 10.0
F32 = np.float32


def unpack_view_z(sc, z):
    return torch.abs(z) * float(sc["view_z_scale"])


def unpack_nr(normal_roughness, config):
    """(normal (..., 3), roughness, material id) of the normal-roughness plane that the passes
    read (`frontend.decode_normal_plane`): packed R10G10B10A2, or the RGBA normal encodings
    decoded (material 0)."""
    return fe.unpack_normal_plane(normal_roughness, fe.decoded_normals(config.normal_encoding),
                                  config.roughness_encoding)


def pack_prev_normal_roughness(normal, roughness):
    """PackPrevNormalRoughness + the RGBA8 quantization of the stored previous normals."""
    p = torch.cat([normal * 0.5 + 0.5, roughness[..., None]], -1)
    return nm.quantize_unorm(p, 8)


def unpack_prev_normal_roughness(packed):
    return nm.safe_normalize(packed[..., :3] * 2.0 - 1.0), packed[..., 3]


def frustum_vectors(world_to_view, view_to_clip, view_to_world, frustum):
    """(right, up, forward) float32 world vectors of one camera (Relax.cpp:70-80), in the
    op order of `nrdtpu/passes/relax/denoiser.py:143-152`."""
    w2v, v2c, v2w, fr = (np.asarray(a, F32) for a in (world_to_view, view_to_clip,
                                                      view_to_world, frustum))
    tan_half = F32(1.0) / v2c[0, 0]
    aspect = v2c[0, 0] / v2c[1, 1]
    right = w2v[0, :3] * tan_half
    up = w2v[1, :3] * tan_half * aspect
    fwd_view = np.array([F32(0.5) * fr[2] + fr[0], F32(0.5) * fr[3] + fr[1], F32(1.0)], F32)
    fwd = np.array([v2w[i, 0] * fwd_view[0] + v2w[i, 1] * fwd_view[1] + v2w[i, 2] * fwd_view[2]
                    for i in range(3)], F32)
    return right.astype(F32), up.astype(F32), fwd


def frustum(sc, prev: bool = False):
    """(right, up, forward) of the current or the previous camera as Python floats."""
    pre = "prev_" if prev else ""
    return tuple([float(c) for c in np.asarray(sc[pre + k], F32)]
                 for k in ("frustum_right", "frustum_up", "frustum_forward"))


def frustum_consts(sc, prev: bool = False):
    """The 9 floats right, up, forward in the order the kernels read them."""
    right, up, fwd = frustum(sc, prev)
    return [*right, *up, *fwd]


def world_pos(frustum9, ortho_mode, uv, view_z):
    """GetCurrentWorldPosFromClipSpaceXY (RELAX_Common.hlsli:72-97) on a (..., 2) uv, y down,
    from the 9 floats right, up, forward (`frustum_consts`); the op order of
    `nrdtpu/passes/relax/kernels.py:73-84`. Returns (..., 3)."""
    right, up, fwd = frustum9[0:3], frustum9[3:6], frustum9[6:9]
    cx = uv[..., 0] * 2.0 - 1.0
    cy = uv[..., 1] * 2.0 - 1.0
    if float(ortho_mode) == 0.0:
        comps = [view_z * ((fwd[i] + right[i] * cx) - up[i] * cy) for i in range(3)]
    else:
        comps = [(view_z * fwd[i] + right[i] * cx) - up[i] * cy for i in range(3)]
    return torch.stack(comps, -1)


def world_pos_from_uv(sc, uv, view_z, prev: bool = False):
    """world_pos of the current or the previous camera of the frame constants."""
    return world_pos(frustum_consts(sc, prev), sc["ortho_mode"], uv, view_z)


def world_pos_from_uv3(sc, u, v, view_z, prev: bool = False):
    """world_pos_from_uv on uv planes -> V3, in the op order of
    `nrdtpu/passes/relax/kernels.py:56-70` (the right/up part summed first)."""
    right, up, fwd = frustum(sc, prev)
    cx = u * 2.0 - 1.0
    cy = v * 2.0 - 1.0
    persp = float(sc["ortho_mode"]) == 0.0

    def comp(i):
        base = right[i] * cx - up[i] * cy
        return view_z * (fwd[i] + base) if persp else view_z * fwd[i] + base

    return v3.V3(comp(0), comp(1), comp(2))


def get_plane_distance_weight(center_pos, center_normal, center_view_z, sample_pos, threshold):
    """GetPlaneDistanceWeight (RELAX_Common.hlsli:99-105)."""
    d = torch.abs(nm.dot(sample_pos - center_pos, center_normal))
    return (d / center_view_z <= threshold).to(torch.float32)


def get_plane_distance_weight_atrous(center_pos, center_normal, sample_pos, threshold):
    """GetPlaneDistanceWeight_Atrous (RELAX_Common.hlsli)."""
    d = torch.abs(nm.dot(sample_pos - center_pos, center_normal))
    return (d < threshold).to(torch.float32)


def get_spec_lobe_tan_half_angle(roughness, percent_of_volume=0.75):
    """RELAX's GetSpecLobeTanHalfAngle (RELAX_Common.hlsli:107-115); a host percentage is
    evaluated in float32."""
    r = nm.saturate(roughness)
    p = percent_of_volume
    if isinstance(p, torch.Tensor):
        return r * r * p / (1.0 - p + fe.NRD_EPS)
    return r * r * float(F32(p)) / float(F32(F32(1.0) - F32(p)) + F32(fe.NRD_EPS))


def get_normal_weight_param2(roughness, angle_fraction):
    """GetNormalWeightParam2: 1 / max(atan(lobe tan), RELAX_NORMAL_ULP)."""
    angle = torch.atan(get_spec_lobe_tan_half_angle(roughness, angle_fraction))
    return 1.0 / torch.clamp_min(angle, RELAX_NORMAL_ULP)


def get_normal_weight_params_atrous(roughness, history_length, reprojection_confidence,
                                    normal_edge_stopping_relaxation, lobe_angle_fraction,
                                    lobe_angle_slack):
    """GetNormalWeightParams_ATrous (RELAX_Common.hlsli:117-137), op for op as
    `nrdtpu/passes/relax/kernels.py:111-123`. Returns (angle, f)."""
    relaxation = nm.saturate(history_length / 5.0)
    relaxation = relaxation * nm.lerp(1.0, reprojection_confidence,
                                      normal_edge_stopping_relaxation)
    f = 0.9 + 0.1 * relaxation
    angle = torch.atan(get_spec_lobe_tan_half_angle(roughness, lobe_angle_fraction))
    angle = angle * (10.0 - 9.0 * relaxation)
    angle = angle + lobe_angle_slack
    return torch.clamp_max(angle, nm.PI * 0.5), f


def get_specular_normal_weight_atrous(angle0, f0, n0, n, v0, v):
    """GetSpecularNormalWeight_ATrous (RELAX_Common.hlsli:139-148) on (..., 3) vectors."""
    cosa = torch.minimum(nm.dot(n0, n), nm.dot(v0, v))
    a = nm.smoothstep(0.0, angle0, nm.acos_approx(cosa))
    return nm.saturate(1.0 - a * f0)


def get_bilateral_weight(z, zc):
    return nm.linearstep(0.03, 0.0, torch.abs(z - zc) / torch.clamp_min(torch.maximum(z, zc),
                                                                         1e-15))
