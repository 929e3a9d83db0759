"""SIGMA Blur / PostBlur - kernel `csrc/sigma_blur.cu`.

Replaces `nrdtpu/kernels/sigma_blur2.py:281` (`sigma_blur_pallas2`) and its v1 twin
`nrdtpu/kernels/sigma_pallas.py:291` (`sigma_blur_pallas`, the same pass under
`NRDTPU_BLUR=1`). Computes, per pixel, the whole body of the XLA function
`nrdtpu/passes/sigma/kernels.py:133-281`:

  - the centre's geometry: view position, view-space normal, pixel size, plane-distance
    parameters, N.V;
  - the dense 5x5 penumbra estimation (geometry weight, lit/unlit agreement, Gaussian), the
    smoothstep blend towards the centre and the f4 boost;
  - the 8 Poisson taps of SPECIAL_8, rotated by the frame's rotator, skewed per pixel by
    N.V, scaled by the blur radius (tile value x penumbra in pixels), snapped to the pixel
    centre and read nearest, weighted by in-screen, geometry, lit/unlit, Gaussian and the
    umbra-leak guard;
  - the final normalisation, the sqrt packing and the pass-through masks (no-denoise tiles,
    umbra centre, sky, beyond the denoising range).

The TPU kernels' quantised radius levels, static tap lattice, per-block predication and bf16
windows are not carried over. Modes: first pass or PostBlur (which unpacks its input), 1 or
4 shadow channels (SIGMA_SHADOW, SIGMA_SHADOW_TRANSLUCENCY), and, on the first pass of
SIGMA_SHADOW, no shadow input at all (it is IsLit(penumbra)); and at the RGBA normal
encodings the decoded normal plane (`decoded=`, the kDec instances: the normal .xyz, as the
XLA function unpacks it, `:166`; the TPU kernels decode .xy as octahedral at every
encoding).

Bound on the H100: memory. Per pixel it reads penumbra, viewZ (4 B each), the packed normal
(16 B), the shadow (4 or 16 B) and the tile value and sky planes (8 B), and writes the
penumbra and the packed shadow (8-20 B): ~44-72 B/px, 0.05-0.08 ms at 2560x1440 at
3.35 TB/s. The 33 taps are L1/L2 neighbours within 32 px. One thread per pixel in 16x16
blocks, one kernel per mode (channels, first pass, shadow input); each block stages its tile's
20x20 window of derived texels (penumbra, scaled viewZ, the view position's scale, the
unpacked shadow) in shared memory for the dense 5x5; a Poisson tap reads it there where it
falls inside, else global memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..passes import sigma as S
from ..ops import resample, stencil
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instances (kDec)
BORDER = 2  # the dense estimation's 5x5
# (dy, dx, Gaussian weight of |o| / BORDER) of the 5x5, row by row
DENSE_TAPS = [(dy, dx, nm.get_gaussian_weight(float((dx * dx + dy * dy) ** 0.5) / BORDER))
              for dy, dx in stencil.offsets_square(BORDER)]
# (x, y, Gaussian weight) of the 8 Poisson taps (SPECIAL_8)
POISSON_TAPS = [(float(x), float(y), nm.get_gaussian_weight(float(r)))
                for x, y, r in nm.SPECIAL_8]


def _unpacked(shadow, first_pass):
    return shadow if first_pass else S.unpack_shadow(shadow)


def sigma_blur_ref(penumbra_in, shadow_in, view_z_in, normal_roughness, tile, *, first_pass,
                   rotator, view_z_scale, frustum, ortho_mode, unproject,
                   min_rect_dim_mul_unproject, plane_dist_sensitivity, world_to_view, rect_size,
                   rect_size_inv, denoising_range, decoded=False, row0=0, frame_h=None):
    """Plain PyTorch version of the kernel (the XLA `blur`, op for op). shadow_in: (h, w, c)
    or None; tile: (2, h, w) = the tile value and the sky-tile mask per pixel; row0, frame_h:
    the planes' rows in the frame (`resample.pixel_uv_grid`). Returns (penumbra (h, w), packed
    shadow (h, w, c))."""
    h, w = penumbra_in.shape
    dev = penumbra_in.device
    uv = resample.pixel_uv_grid(h, w, dev, row0, frame_h)
    view_z = torch.abs(view_z_in) * view_z_scale
    ortho = float(ortho_mode)
    shadow = (S.is_lit(penumbra_in)[..., None] if shadow_in is None
              else _unpacked(shadow_in, first_pass))
    center_penumbra, center_shadow = penumbra_in, shadow
    tile_value, sky_tile = tile[0], tile[1]

    xv = nm.reconstruct_view_position(uv, frustum, view_z, ortho)
    n, _, _ = fe.unpack_normal_plane(normal_roughness, decoded)
    nv = nm.rotate_vector(world_to_view, n)
    pixel_size = nm.pixel_radius_to_world(float(unproject), ortho, 1.0, view_z)
    frustum_size = nm.get_frustum_size(float(min_rect_dim_mul_unproject), ortho, view_z)
    vv = (nm.normalize(-xv) if ortho == 0.0
          else torch.tensor([0.0, 0.0, -1.0], device=dev).expand_as(xv))
    nov = torch.abs(nm.dot(nv, vv))
    ga, gb = nm.get_geometry_weight_params(float(plane_dist_sensitivity), frustum_size, xv, nv)

    # dense 5x5 estimation (:178-213)
    rinv = [float(v) for v in np.asarray(rect_size_inv, np.float32)]
    sum_x = torch.zeros_like(view_z)
    sum_y = torch.zeros_like(view_z)
    result = torch.zeros_like(center_shadow)
    penumbra_acc = torch.zeros_like(view_z)
    for dy, dx, gauss in DENSE_TAPS:
        penum = stencil.shifted(penumbra_in, dy, dx)
        zs = stencil.shifted(view_z, dy, dx)
        s = stencil.shifted(shadow, dy, dx)
        if dy == 0 and dx == 0:
            w_ = torch.ones_like(view_z)
        else:
            uv_s = torch.stack([uv[..., 0] + dx * rinv[0], uv[..., 1] + dy * rinv[1]], -1)
            xvs = nm.reconstruct_view_position(uv_s, frustum, zs, ortho)
            w_ = nm.compute_weight(nm.dot(nv, xvs), ga, gb)
            w_ = w_ * S.are_both_lit_or_unlit(center_penumbra, penum)
            w_ = w_ * gauss
        result = result + torch.where((w_ == 0.0)[..., None], 0.0, s * w_[..., None])
        sum_x = sum_x + w_
        w_ = w_ * pixel_size / (pixel_size + penum)
        w_ = w_ * (1.0 - S.is_lit(penum))
        penumbra_acc = penumbra_acc + torch.where(w_ == 0.0, 0.0, penum * w_)
        sum_y = sum_y + w_

    result = result / sum_x[..., None]
    penumbra = penumbra_acc / torch.clamp_min(sum_y, fe.NRD_EPS)
    sum_y = (sum_y != 0.0).to(torch.float32)
    f = nm.smoothstep(0.0, float(BORDER), penumbra / pixel_size)
    result = nm.lerp(center_shadow, result, f[..., None])

    # sparse 8-tap Poisson (:215-263)
    f4 = nm.lerp(4.0, 1.0, f)
    result = result * f4[..., None]
    penumbra = penumbra * f4
    sum_x = f4
    sum_y = sum_y * f4
    blur_radius = S.get_kernel_radius_in_pixels(penumbra, pixel_size, tile_value)
    r = [float(v) for v in np.asarray(rotator, np.float32)]
    skew = [nm.lerp(1.0 - torch.abs(nv[..., a]), 1.0, nov) for a in (0, 1)]
    skew_max = torch.maximum(skew[0], skew[1])
    skew = [skew[a] / skew_max * rinv[a] * blur_radius for a in (0, 1)]
    scaled_rotator = torch.stack([r[0] * skew[0], r[1] * skew[1], r[2] * skew[0],
                                  r[3] * skew[1]], -1)
    inv_estimated_penumbra = 1.0 / torch.clamp_min(penumbra, fe.NRD_EPS)
    rs = [float(v) for v in np.asarray(rect_size, np.float32)]
    for ox, oy, gauss in POISSON_TAPS:
        uv_s = uv + nm.rotate_vector2(scaled_rotator, (ox, oy))
        # snap to the pixel centre (:238), a true division as in the kernel
        uv_s = torch.stack([nm.div(torch.floor(uv_s[..., a] * rs[a]) + 0.5, rs[a])
                            for a in (0, 1)], -1)
        penum = resample.sample_nearest(penumbra_in, uv_s, row0, frame_h)
        zs = torch.abs(resample.sample_nearest(view_z_in, uv_s, row0, frame_h)) * view_z_scale
        s = (S.is_lit(penum)[..., None] if shadow_in is None
             else _unpacked(resample.sample_nearest(shadow_in, uv_s, row0, frame_h), first_pass))
        xvs = nm.reconstruct_view_position(uv_s, frustum, zs, ortho)
        w_ = resample.is_in_screen_nearest(uv_s)
        w_ = w_ * nm.compute_weight(nm.dot(nv, xvs), ga, gb)
        w_ = w_ * S.are_both_lit_or_unlit(center_penumbra, penum)
        w_ = w_ * gauss
        w_ = w_ * nm.saturate(penum * inv_estimated_penumbra)  # umbra-leak guard (:256)
        result = result + torch.where((w_ == 0.0)[..., None], 0.0, s * w_[..., None])
        sum_x = sum_x + w_
        w_ = w_ * pixel_size / (pixel_size + penum)
        w_ = w_ * (1.0 - S.is_lit(penum))
        penumbra = penumbra + torch.where(w_ == 0.0, 0.0, penum * w_)
        sum_y = sum_y + w_

    # final normalisation and the pass-through masks (:265-281)
    result_out = result / sum_x[..., None]
    penumbra_out = torch.where(sum_y == 0.0, center_penumbra,
                               penumbra / torch.clamp_min(sum_y, fe.NRD_EPS))
    no_denoise = ((tile_value == 0.0) | (center_penumbra == 0.0) | (sky_tile > 0.0)
                  | (view_z > float(denoising_range)))
    shadow_final = torch.where(no_denoise[..., None], S.pack_shadow(center_shadow),
                               S.pack_shadow(result_out))
    return torch.where(no_denoise, center_penumbra, penumbra_out), shadow_final


# the wrapper's arguments that are previous-frame planes: whole frames under a mesh, while
# the current planes are a band of rows (`parallel.sharding.band_call`)
PREVIOUS_PLANES = ()


def sigma_blur(penumbra_in, shadow_in, view_z_in, normal_roughness, tile, *, first_pass,
               rotator, view_z_scale, frustum, ortho_mode, unproject,
               min_rect_dim_mul_unproject, plane_dist_sensitivity, world_to_view, rect_size,
               rect_size_inv, denoising_range, decoded=False, row0=0, frame_h=None):
    """penumbra_in, view_z_in (h, w), normal_roughness (h, w, 4), shadow_in (h, w, c) with
    c = 1 or 4, or None (then c = 1), tile (2, h, w) = tile value and sky mask; decoded:
    normal_roughness is the RGBA formats' decoded plane (`frontend.decode_normal_plane`, the
    kernel's kDec instances), else packed R10G10B10A2; row0, frame_h: the planes are the frame
    rows row0 .. row0 + h - 1 of a frame frame_h high (a band of `parallel.shard_stencil`;
    default the whole frame). Returns (penumbra (h, w), packed shadow (h, w, c))."""
    global launches, dec_launches
    kw = dict(first_pass=first_pass, rotator=rotator, view_z_scale=view_z_scale,
              frustum=frustum, ortho_mode=ortho_mode, unproject=unproject,
              min_rect_dim_mul_unproject=min_rect_dim_mul_unproject,
              plane_dist_sensitivity=plane_dist_sensitivity, world_to_view=world_to_view,
              rect_size=rect_size, rect_size_inv=rect_size_inv, denoising_range=denoising_range,
              decoded=decoded, row0=row0, frame_h=frame_h)
    dev = build.kernel_device(penumbra_in)
    if dev is None:
        return sigma_blur_ref(penumbra_in, shadow_in, view_z_in, normal_roughness, tile, **kw)
    h, w = penumbra_in.shape
    c = 1 if shadow_in is None else shadow_in.shape[-1]
    if c not in (1, 4):
        raise ValueError(f"shadow_in: {c} channels, the kernel takes 1 or 4")
    f32 = torch.float32
    ins = [("penumbra_in", penumbra_in, (h, w)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)), ("tile", tile, (2, h, w))]
    if shadow_in is not None:
        ins.append(("shadow_in", shadow_in, (h, w, c)))
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    penumbra_out = torch.empty((h, w), dtype=f32, device=dev)
    shadow_out = torch.empty((h, w, c), dtype=f32, device=dev)
    consts = [c, first_pass, shadow_in is not None, view_z_scale, *_v(frustum), ortho_mode,
              unproject, min_rect_dim_mul_unproject, plane_dist_sensitivity,
              *np.asarray(world_to_view, np.float32)[:3, :3].reshape(-1), *_v(rotator),
              *_v(rect_size), *_v(rect_size_inv), denoising_range,
              *[g for _, _, g in DENSE_TAPS], *[v for tap in POISSON_TAPS for v in tap], decoded,
              row0, h if frame_h is None else frame_h]
    # without a shadow input the kernel gets the penumbra in its place and does not read it
    shadow = shadow_in if shadow_in is not None else penumbra_in
    build.launch("nrd_sigma_blur", [penumbra_in, shadow, view_z_in, normal_roughness, tile,
                                    penumbra_out, shadow_out], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    return penumbra_out, shadow_out


def _v(x):
    return [float(v) for v in np.asarray(x, np.float32).reshape(-1)]
