"""RELAX PrePass - kernel `csrc/relax_prepass.cu` (K15).

Replaces `nrdtpu/kernels/relax_pallas.py:751` (`relax_prepass_taps_pallas`). Computes
`pre_pass` (`nrdtpu/passes/relax/kernels.py:160-306`) per pixel. The diffuse branch: the blur
radius `diffusePrepassBlurRadius * hit_dist_factor` (at least 1 where hitT == 0, `:201-210`),
8 rotated Poisson taps snapped to texel centres (`(floor(uv rect + off r) + 0.5) / rect`,
`:238-241`), each weighted by in-screen, denoising range, material, normal angle, plane
distance, hit distance and its Gaussian weight, then the radius-disabled select and the
FP16_MAX clip (`:293-298`). The radius is each pixel's own: the TPU kernel's radius lattice
(`relax_pallas.py:558-575`) and its 32-px cap (`:755-756`) are not carried over. The specular
branch (`:176-199`, `:252-273`, `:286-289`) clamps the hit distance to the denoising range,
takes the radius from the dominant direction, the hit-distance factor and the spec magic
curve, capped by the lobe radius, weights each tap also by roughness, by the normal weight at
half the lobe fraction with the pixel's roughness and by lerp(saturate(t), 1,
linearstep(0.5, 1, roughness)), and writes the min hitT of the kept taps. The centre's and
every tap's roughness are unpacked with the roughness encoding (`:169`, `:243`), a template
parameter of the kernel. At the RGBA normal encodings the kernel reads the decoded plane
(`decoded=`, its kDec instances: normal .xyz, roughness .w) and tests no material (`:249`).
With `sh` (the SH variants' second plane) the SH plane accumulates with each tap's final
weight over the same weight sum (`:281-284`, `:292`), passes through
where the radius is disabled and is clipped to +-FP16_MAX (`:294-298`), in the same launch:
the counterpart of the TPU kernel's `n_sh` (`relax_pallas.py:576-747`).

Bound on the H100: gathers. Per pixel it reads the centre's signal, viewZ and packed normal
(36 B) and 8 taps of the same (8 x 36 B, neighbours up to 30 px x the hit-distance factor
away) and writes 16 B; with SH 16 B more a tap and 32 B more at the centre. The kernel is one
instance per mode (specular, roughness encoding, SH), one thread per pixel in 16x16 CTAs, a
rolled tap loop reading each tap's signal, packed normal and SH as one float4 each, ahead of
its weights (`csrc/relax_prepass.cu`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample
from ..passes import relax as RC
from ..settings import RoughnessEncoding
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instances (kDec)
OFFSETS = 8  # g_Poisson8 taps
# sqrt(0.75 / 0.25) in float32: GetSpecularLobeTanHalfAngle(roughness) = roughness^2 x this
LOBE_TAN_SCALE = float(np.sqrt(np.float32(0.75) / np.float32(0.25)))


def poisson_taps(rotator):
    """(offsets (8, 2), Gaussian weights (8,)) of the rotated Poisson-8 taps, float32 on the
    host: `rotate_vector2(rotator, tap)` and `get_gaussian_weight(tap radius)`."""
    r = np.asarray(rotator, np.float32)
    offs, gauss = [], []
    for tx, ty, rad in POISSON_8:
        tx, ty = np.float32(tx), np.float32(ty)
        offs.append((tx * r[0] + ty * r[2], tx * r[1] + ty * r[3]))
        gauss.append(nm.get_gaussian_weight(float(rad)))
    return np.asarray(offs, np.float32), np.asarray(gauss, np.float32)


# g_Poisson8 (x, y, radius), RELAX_PrePass.hlsli:12 (`nrdtpu/math.py:540`)
POISSON_8 = np.array([
    (-0.4706069, -0.4427112, 0.6461146),
    (-0.9057375, 0.3003471, 0.9542373),
    (-0.3487388, 0.4037880, 0.5335386),
    (0.1023042, 0.6439373, 0.6520134),
    (0.5699277, 0.3513750, 0.6695386),
    (0.2939128, -0.1131226, 0.3149309),
    (0.7836658, -0.4208784, 0.8895339),
    (0.1564120, -0.8198990, 0.8346850),
], np.float32)


def _specular_params(signal, n, roughness, x, view_z, frustum, ortho_mode, frustum_size,
                     denoising_range, blur_radius, min_hit_dist_weight, specular):
    """The specular branch's per-pixel parameters (`kernels.py:178-199`): the hit distance
    clamped to the denoising range, the radius, the normal and roughness weights' and the
    hit-distance weight's parameters, the hit-distance weight's floor and the first min
    hitT."""
    hit = torch.clamp_min(torch.clamp_max(signal[..., 3], denoising_range), 0.0)
    signal = torch.cat([signal[..., :3], hit[..., None]], -1)
    if ortho_mode == 0.0:
        view_vec = nm.normalize(-x)
    else:
        view_vec = torch.tensor(frustum[6:9], dtype=torch.float32, device=x.device).expand_as(x)
    d4 = nm.get_specular_dominant_direction(n, view_vec, roughness)
    nod = torch.abs(nm.dot(n, d4[..., :3]))
    hd = torch.where(hit == 0.0, 1.0, hit)
    smc = nm.get_spec_magic_curve(roughness)
    radius = blur_radius * nm.get_hit_dist_factor(hd * nod, frustum_size) * smc
    lobe_radius = hd * nod * nm.get_specular_lobe_tan_half_angle(roughness, 0.75)
    min_blur = lobe_radius / nm.pixel_radius_to_world(specular["unproject"], ortho_mode, 1.0,
                                                      view_z + hd * d4[..., 3])
    radius = torch.minimum(radius, min_blur)
    nwp = RC.get_normal_weight_param2(roughness, specular["normal_lobe_fraction"])
    # get_hit_distance_weight_params(hit, 1 / 9, roughness)
    ha = 1.0 / nm.lerp(0.0005, 1.0, torch.clamp_max(smc, 1.0 / 9.0))
    hb = -(hit * ha)
    ra, rb = nm.get_roughness_weight_params(roughness, specular["roughness_fraction"])
    min_hd_weight = torch.where(hit == 0.0, 1.0, min_hit_dist_weight * smc)
    min_hit = torch.where(hit == 0.0, fe.NRD_INF, hit)
    return signal, hit, radius, nwp, ha, hb, ra, rb, min_hd_weight, min_hit


def relax_prepass_ref(signal, view_z_in, normal_roughness, *, frustum, ortho_mode, view_z_scale,
                      denoising_range, frustum_size_scale, blur_radius, normal_weight_param,
                      hit_dist_a, min_hit_dist_weight, depth_threshold, min_material,
                      offsets, gaussian_weights, specular=None,
                      roughness_encoding=RoughnessEncoding.LINEAR, sh=None, decoded=False):
    """Plain PyTorch version of the kernel (the XLA tap loop, op for op, then the
    radius-disabled select and the FP16_MAX clip)."""
    h, w = view_z_in.shape
    dev = signal.device
    uv = resample.pixel_uv_grid(h, w, dev)
    view_z = torch.abs(view_z_in) * view_z_scale
    n, roughness, material_id = fe.unpack_normal_plane(normal_roughness, decoded,
                                                       roughness_encoding)
    x = RC.world_pos(frustum, ortho_mode, uv, view_z)
    frustum_size = frustum_size_scale * nm.lerp(view_z, 1.0, abs(ortho_mode))
    if specular is None:
        hit = signal[..., 3]
        hd = torch.where(hit == 0.0, 1.0, hit)
        radius = blur_radius * nm.get_hit_dist_factor(hd, frustum_size)
        nwp, ha, hb = normal_weight_param, hit_dist_a, -(hit * hit_dist_a)
        min_hd_weight = min_hit_dist_weight
    else:
        (signal, hit, radius, nwp, ha, hb, ra, rb, min_hd_weight,
         min_hit) = _specular_params(signal, n, roughness, x, view_z, frustum, ortho_mode,
                                     frustum_size, denoising_range, blur_radius,
                                     min_hit_dist_weight, specular)
    radius = torch.where(hit == 0.0, torch.clamp_min(radius, 1.0), radius)
    dts = view_z if ortho_mode == 0.0 else torch.ones_like(view_z)
    mat_c = torch.clamp_min(material_id, min_material)

    acc = signal
    acc_sh = sh
    wsum = torch.ones_like(view_z)
    for k in range(OFFSETS):
        ox, oy = float(offsets[k][0]), float(offsets[k][1])
        # the snap of :241; a true division after the floor on every device (math.div)
        uv_s = torch.stack([nm.div(torch.floor(uv[..., 0] * w + ox * radius) + 0.5, w),
                            nm.div(torch.floor(uv[..., 1] * h + oy * radius) + 0.5, h)], -1)
        ns, rs, ms = fe.unpack_normal_plane(resample.sample_nearest(normal_roughness, uv_s),
                                            decoded, roughness_encoding)
        zs = torch.abs(resample.sample_nearest(view_z_in, uv_s)) * view_z_scale
        xs = RC.world_pos(frustum, ortho_mode, uv_s, zs)
        w_ = resample.is_in_screen_nearest(uv_s)
        w_ = w_ * (zs < denoising_range).to(torch.float32)
        w_ = w_ * (mat_c == torch.clamp_min(ms, min_material)).to(torch.float32)
        if specular is not None:
            w_ = w_ * nm.compute_weight(rs, ra, rb)
        w_ = w_ * nm.compute_weight(nm.acos_approx(nm.dot(n, ns)), nwp, 0.0)
        pd = torch.abs(nm.dot(xs - x, n))
        w_ = w_ * (pd / dts <= depth_threshold).to(torch.float32)
        s = resample.sample_nearest(signal, uv_s)
        s = torch.where((w_ == 0.0)[..., None], 0.0, s)
        w_ = w_ * nm.lerp(min_hd_weight, 1.0, nm.compute_exponential_weight(s[..., 3], ha, hb))
        w_ = w_ * float(gaussian_weights[k])
        if specular is None:
            wsum = wsum + w_
            acc = acc + s * w_[..., None]
        else:
            t = s[..., 3] / (hit + nm.length(xs - x) + fe.NRD_EPS)
            w_ = w_ * nm.lerp(nm.saturate(t), 1.0, nm.linearstep(0.5, 1.0, roughness))
            min_hit = torch.where((w_ != 0.0) & (s[..., 3] != 0.0),
                                  torch.minimum(min_hit, torch.where(s[..., 3] == 0.0, fe.NRD_INF,
                                                                     s[..., 3])), min_hit)
            wsum = wsum + w_
            acc = acc + torch.cat([s[..., :3] * w_[..., None], torch.zeros_like(s[..., 3:])], -1)
        if sh is not None:
            sh_s = torch.where((w_ == 0.0)[..., None], 0.0, resample.sample_nearest(sh, uv_s))
            acc_sh = acc_sh + sh_s * w_[..., None]
    if specular is None:
        out = acc / wsum[..., None]
    else:
        out = torch.cat([acc[..., :3] / wsum[..., None],
                         torch.where(min_hit == fe.NRD_INF, 0.0, min_hit)[..., None]], -1)
    out = signal if blur_radius <= 0.0 else out
    out = torch.clamp(out, 0.0, fe.NRD_FP16_MAX)
    if sh is None:
        return out
    out_sh = sh if blur_radius <= 0.0 else acc_sh / wsum[..., None]
    return out, torch.clamp(out_sh, -fe.NRD_FP16_MAX, fe.NRD_FP16_MAX)


def relax_prepass(signal, view_z_in, normal_roughness, *, frustum, ortho_mode, view_z_scale,
                  denoising_range, frustum_size_scale, blur_radius, normal_weight_param,
                  hit_dist_a, min_hit_dist_weight, depth_threshold, min_material, offsets,
                  gaussian_weights, specular=None, roughness_encoding=RoughnessEncoding.LINEAR,
                  sh=None, decoded=False):
    """signal (h, w, 4) = (radiance, raw hitT); frustum = the 9 floats right, up, forward;
    frustum_size_scale = min(rect) x unproject (float32); blur_radius = the settings' radius
    (<= 0 disables the pass); normal_weight_param and hit_dist_a are the diffuse frame
    constants; offsets (8, 2) and gaussian_weights (8,) from `poisson_taps`. specular = None
    for the diffuse signal, else dict(unproject, normal_lobe_fraction (0.5 x the settings'
    lobe fraction), roughness_fraction): the specular branch with its per-pixel radius and
    weights and the min hitT of the kept taps; roughness_encoding: how the packed roughness
    is unpacked; sh: None, or the (h, w, 4) SH plane filtered with the signal's weights;
    decoded: normal_roughness is the RGBA formats' decoded plane (`frontend.decode_normal_plane`,
    the kernel's kDec instances), else packed R10G10B10A2. Returns (h, w, 4), or with `sh` the
    pair (signal, SH)."""
    global launches, dec_launches
    kw = dict(frustum=frustum, ortho_mode=ortho_mode, view_z_scale=view_z_scale,
              denoising_range=denoising_range, frustum_size_scale=frustum_size_scale,
              blur_radius=blur_radius, normal_weight_param=normal_weight_param,
              hit_dist_a=hit_dist_a, min_hit_dist_weight=min_hit_dist_weight,
              depth_threshold=depth_threshold, min_material=min_material, offsets=offsets,
              gaussian_weights=gaussian_weights, specular=specular,
              roughness_encoding=roughness_encoding, sh=sh, decoded=decoded)
    dev = build.kernel_device(signal)
    if dev is None:
        return relax_prepass_ref(signal, view_z_in, normal_roughness, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("signal", signal, (h, w, 4)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4))]
    if sh is not None:
        ins.append(("sh", sh, (h, w, 4)))
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((h, w, 4), dtype=f32, device=dev)
    out_sh = None if sh is None else torch.empty((h, w, 4), dtype=f32, device=dev)
    sp = specular or {}
    consts = [*frustum, ortho_mode, view_z_scale, denoising_range, frustum_size_scale,
              blur_radius, normal_weight_param, hit_dist_a, min_hit_dist_weight,
              depth_threshold, min_material,
              *np.asarray(offsets, np.float32).reshape(-1), *np.asarray(gaussian_weights),
              specular is not None, sp.get("unproject", 0.0), sp.get("normal_lobe_fraction", 0.0),
              sp.get("roughness_fraction", 0.0), LOBE_TAN_SCALE,
              build.ROUGHNESS_MODE[roughness_encoding], decoded]
    build.launch("nrd_relax_prepass", [signal, view_z_in, normal_roughness, out, sh, out_sh],
                 consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    return out if sh is None else (out, out_sh)
