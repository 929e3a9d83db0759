"""SIGMA temporal stabilization - kernel `csrc/sigma_ts.cu`.

Replaces `nrdtpu/kernels/sigma_pallas.py:449` (`sigma_ts_pallas`). Computes, per pixel, the
XLA function `nrdtpu/passes/sigma/kernels.py:290-414`, the surface-motion reprojection
included:

  - the 5x5 moments of the unpacked shadow with the lit/unlit weight;
  - the reprojected position and the previous view z of the previous position (`:329-352`),
    both motion-vector branches (screen space with the mv's z computed or given, world
    space through `world_to_clip_prev`), as `passes/reblur/kernels.py:
    surface_motion_position` computes them;
  - the 2x2 gathers of the previous viewZ and history length at the reprojected position,
    with the plane-distance occlusion against the disocclusion threshold;
  - the CatRom-or-bilinear-custom sample of the bf16 packed history (`:379-383`; the XLA
    test `sum(weights) > 3.5` keeps the bilinear-custom branch), saturated and unpacked;
  - the sigma clamp, the antilag, the "street magic" and the stabilization blend;
  - the hard-shadow and dead-pixel masks, the sqrt packing and the rounded history length.

The TPU kernel's block-base + tent-residual reprojection is not carried over: the history is
sampled at each pixel's own position, as XLA does.

Bound on the H100: memory. Per pixel it reads the shadow (4 or 16 B), the penumbra and viewZ
(8 B), IN_MV (12 B), the previous viewZ and history length (8 B, L2-resident neighbours),
the bf16 history (2 or 8 B) and the tile planes (8 B), and writes the shadow and two state
planes (12-24 B): ~54-84 B/px, 0.06-0.09 ms at 2560x1440 at 3.35 TB/s. The design for that
card is in the source's header.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as nm
from ..passes import sigma as S
from ..ops import resample, stencil
from . import build

launches = 0
BORDER = 2  # the 5x5 moments
# (dy, dx, Gaussian weight of |o| / BORDER) of the 5x5, row by row
TAPS = [(dy, dx, nm.get_gaussian_weight(float((dx * dx + dy * dy) ** 0.5) / BORDER))
        for dy, dx in stencil.offsets_square(BORDER)]


def sigma_ts_ref(shadow_packed, penumbra, view_z_in, mv_in, prev_view_z, prev_history_len,
                 history, tile, *, view_z_scale, min_rect_dim_mul_unproject, rect_size_prev,
                 stabilization_strength, denoising_range, reprojection, row0=0, frame_h=None):
    """Plain PyTorch version of the kernel (the XLA `temporal_stabilization`, op for op).
    shadow_packed (h, w, c) float32, mv_in (h, w, 3) IN_MV, history (ph, w, c) bf16, tile
    (2, h, w); reprojection: the frame constants of `surface_motion_position` (REPROJECTION);
    row0, frame_h: the current planes' rows in the frame; the previous planes (prev_view_z,
    prev_history_len, history) are whole frames. Returns (packed shadow (h, w, c), new
    prev_view_z, new history_len)."""
    # the pass glue's own function; its module imports this package, so it is imported here
    from ..passes.reblur.kernels import surface_motion_position

    h, w = view_z_in.shape
    ortho_mode = float(reprojection["ortho_mode"])
    # the reprojected position (:329-352)
    uv = resample.pixel_uv_grid(h, w, view_z_in.device, row0, frame_h)
    view_z = torch.abs(view_z_in) * view_z_scale
    xv = nm.reconstruct_view_position(uv, reprojection["frustum"], view_z, ortho_mode)
    x = nm.rotate_vector_transposed(reprojection["world_to_view"], xv)
    x_prev, smb_uv = surface_motion_position(reprojection, uv, view_z, x, mv_in)
    xv_prev_z = nm.affine_transform(reprojection["world_to_view_prev"], x_prev)[..., 2]

    shadow = S.unpack_shadow(shadow_packed)
    input_center = shadow
    tile_value, sky_tile = tile[0], tile[1]
    is_hard_shadow = (tile_value == 0.0) | (penumbra == 0.0)

    # local 5x5 moments (:309-327)
    m1 = torch.zeros_like(shadow)
    m2 = torch.zeros_like(shadow)
    wsum = torch.zeros_like(view_z)
    for dy, dx, gauss in TAPS:
        s = stencil.shifted(shadow, dy, dx)
        if dy == 0 and dx == 0:
            w_ = torch.ones_like(view_z)
        else:
            w_ = S.are_both_lit_or_unlit(penumbra, stencil.shifted(penumbra, dy, dx))
            w_ = w_ * gauss
        m1 = m1 + s * w_[..., None]
        m2 = m2 + s * s * w_[..., None]
        wsum = wsum + w_
    m1 = m1 / wsum[..., None]
    m2 = m2 / wsum[..., None]
    sigma = nm.get_std_dev(m1, m2)

    # history length gather with disocclusion (:354-376)
    rp = [float(v) for v in np.asarray(rect_size_prev, np.float32)]
    origin, frac = nm.bilinear_filter(smb_uv, rp)
    prev_z4 = torch.stack(resample.gather_2x2(prev_view_z, origin), -1)
    prev_len4 = torch.stack(resample.gather_2x2(prev_history_len, origin), -1)
    frustum_size = nm.get_frustum_size(float(min_rect_dim_mul_unproject), ortho_mode, view_z)
    # GetDisocclusionThreshold(NRD_DISOCCLUSION_THRESHOLD, frustumSize, NoV = 1)
    disocclusion_threshold = frustum_size * S.NRD_DISOCCLUSION_THRESHOLD
    disocclusion_threshold = disocclusion_threshold * resample.is_in_screen_nearest(smb_uv)
    disocclusion_threshold = disocclusion_threshold - 1e-6
    smb_occlusion = (torch.abs(prev_z4 - xv_prev_z[..., None])
                     <= disocclusion_threshold[..., None]).to(torch.float32)
    occ_weights = nm.get_bilinear_custom_weights(frac, smb_occlusion)
    history_length = nm.apply_bilinear_custom_weights(
        prev_len4[..., 0:1], prev_len4[..., 1:2], prev_len4[..., 2:3], prev_len4[..., 3:4],
        occ_weights)[..., 0]

    # sample history (:378-383)
    is_catrom = torch.sum(occ_weights, -1) > 3.5
    sample_pos = nm.scale2(nm.saturate(smb_uv), rp[0], rp[1])
    hist = resample.sample_catrom(history.float(), sample_pos, is_catrom, occ_weights)
    hist = S.unpack_shadow(nm.saturate(hist))

    # clamp, antilag, street magic (:385-400)
    sigma = sigma * nm.lerp(S.SIGMA_TS_SIGMA_SCALE, 1.0, 1.0 / (1.0 + history_length))[..., None]
    history_clamped = torch.clamp(hist, m1 - sigma, m1 + sigma)
    antilag = torch.abs(history_clamped[..., 0] - hist[..., 0])
    antilag = torch.sqrt(nm.saturate(antilag))
    antilag = nm.saturate(1.0 - antilag)
    history_length = history_length * antilag
    history_weight = history_length / (1.0 + history_length)
    street_magic = 0.6 * history_weight * antilag
    history_clamped = nm.lerp(history_clamped, hist, street_magic[..., None])
    result = nm.lerp(input_center, history_clamped,
                     torch.clamp_max(history_weight, float(stabilization_strength))[..., None])

    # hard-shadow pass-through, dead pixels, packing (:402-414)
    result = torch.where(is_hard_shadow[..., None], input_center, result)
    history_length = torch.where(is_hard_shadow, S.SIGMA_MAX_ACCUM_FRAME_NUM, history_length)
    new_history_length = torch.clamp_max(history_length + 1.0, S.SIGMA_MAX_ACCUM_FRAME_NUM)
    dead = (sky_tile > 0.0) | (view_z > float(denoising_range))
    out = torch.where(dead[..., None], shadow_packed, S.pack_shadow(result))
    new_history_length = torch.round(torch.where(
        dead, resample.frame_rows(prev_history_len, row0, h), new_history_length))
    return (out, torch.where(dead, resample.frame_rows(prev_view_z, row0, h), view_z),
            new_history_length)


# the frame constants of the reprojection (`surface_motion_position`'s `sc` keys)
REPROJECTION = ("frustum", "frustum_prev", "world_to_view", "world_to_view_prev",
                "world_to_clip_prev", "camera_delta", "mv_scale", "ortho_mode")


def reprojection_consts(reprojection):
    """The kernel's reprojection constants (`csrc/sigma_ts.cu:nrd_sigma_ts`), float32 as the
    plain version's torch ops see them: the frustums, world_to_view[:3, :3],
    world_to_view_prev[:3, :4], world_to_clip_prev's rows 0, 1 and 3, the camera delta, the
    mv scale (x, y, z; then whether z and w are non-zero) and the ortho mode."""
    def f32(key):
        return np.asarray(reprojection[key], np.float32)
    mvs = f32("mv_scale").reshape(-1)
    return [*f32("frustum").reshape(-1), *f32("frustum_prev").reshape(-1),
            *f32("world_to_view")[:3, :3].reshape(-1),
            *f32("world_to_view_prev")[:3, :4].reshape(-1),
            *f32("world_to_clip_prev")[[0, 1, 3], :].reshape(-1),
            *f32("camera_delta").reshape(-1), *mvs[:3], mvs[2] != 0.0, mvs[3] != 0.0,
            float(reprojection["ortho_mode"])]


# the wrapper's arguments that are previous-frame planes: whole frames under a mesh, while
# the current planes are a band of rows (`parallel.sharding.band_call`)
PREVIOUS_PLANES = ("prev_view_z", "prev_history_len", "history")


def sigma_ts(shadow_packed, penumbra, view_z_in, mv_in, prev_view_z, prev_history_len, history,
             tile, *, view_z_scale, min_rect_dim_mul_unproject, rect_size_prev,
             stabilization_strength, denoising_range, reprojection, row0=0, frame_h=None):
    """See `sigma_ts_ref`; c = 1 or 4; the previous planes (ph, w), a height of their own (the
    whole frame's when the current planes are a band of its rows). Returns (packed shadow,
    prev_view_z, history_len)."""
    global launches
    kw = dict(view_z_scale=view_z_scale, min_rect_dim_mul_unproject=min_rect_dim_mul_unproject,
              rect_size_prev=rect_size_prev, stabilization_strength=stabilization_strength,
              denoising_range=denoising_range, reprojection=reprojection, row0=row0,
              frame_h=frame_h)
    dev = build.kernel_device(shadow_packed)
    if dev is None:
        return sigma_ts_ref(shadow_packed, penumbra, view_z_in, mv_in, prev_view_z,
                            prev_history_len, history, tile, **kw)
    h, w, c = shadow_packed.shape
    ph = prev_view_z.shape[0]
    if c not in (1, 4):
        raise ValueError(f"shadow_packed: {c} channels, the kernel takes 1 or 4")
    f32 = torch.float32
    ins = [("shadow_packed", shadow_packed, f32, (h, w, c)), ("penumbra", penumbra, f32, (h, w)),
           ("view_z_in", view_z_in, f32, (h, w)), ("mv_in", mv_in, f32, (h, w, 3)),
           ("prev_view_z", prev_view_z, f32, (ph, w)),
           ("prev_history_len", prev_history_len, f32, (ph, w)),
           ("history", history, torch.bfloat16, (ph, w, c)), ("tile", tile, f32, (2, h, w))]
    for name, t, dt, shape in ins:
        build.check(name, t, dev, dt, shape)
    out = torch.empty((h, w, c), dtype=f32, device=dev)
    state = torch.empty((2, h, w), dtype=f32, device=dev)
    consts = [c, view_z_scale, min_rect_dim_mul_unproject,
              *[float(v) for v in np.asarray(rect_size_prev, np.float32)],
              stabilization_strength, denoising_range, *[g for _, _, g in TAPS],
              *reprojection_consts(reprojection), row0, h if frame_h is None else frame_h, ph]
    build.launch("nrd_sigma_ts", [t for _, t, _, _ in ins] + [out, state], consts, w, h)
    launches += 1
    return out, state[0], state[1]
