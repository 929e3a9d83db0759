"""SIGMA shadow passes - counterpart of the XLA functions in `nrdtpu/passes/sigma/kernels.py`
(SIGMA_*.hlsli).

  classify_tiles, smooth_tiles  torch glue on the 1/16-resolution tile maps
  tile_planes                   the per-pixel tile value and sky mask, once a frame
  blur                          -> sigma_blur (the whole Blur / PostBlur body)
  temporal_stabilization        -> sigma_ts   (the reprojection included)
  split_screen                  torch glue

The XLA path recomputes the tile value in Blur, PostBlur and TS from the same tile map; the
port computes it once a frame (`tile_planes`) and hands the same planes to the three
launches. Frame constants (`sc`, `dc`) are host values.
"""

from __future__ import annotations

import torch

from ... import math as nm
from ...kernels import sigma_blur as k_sigma_blur
from ...kernels import sigma_ts as k_sigma_ts
from ...ops import stencil, tiles
from ..reblur.kernels import unpack_view_z
from . import get_kernel_radius_in_pixels, is_lit


def classify_tiles(sc, penumbra, view_z_in, translucency=None):
    """Per-16x16-tile masks (SIGMA_ClassifyTiles.hlsli). Returns (th, tw, 3): x =
    needs-denoising, y = maxRadius / 16, z = all-sky."""
    view_z = unpack_view_z(sc, view_z_in)
    is_inf = (view_z > float(sc["denoising_range"])).to(torch.float32)
    is_shadow = (penumbra == 0.0).to(torch.float32)
    lit = is_lit(penumbra)
    is_opaque = ((nm.luminance(translucency[..., 1:4]) < 0.003).to(torch.float32)
                 if translucency is not None else torch.ones_like(penumbra))
    lit_vote = torch.maximum(torch.maximum(lit, is_inf), is_shadow)
    umbra_vote = torch.maximum(torch.maximum((1.0 - lit) * is_opaque, is_inf), is_shadow)
    hit_dist = torch.where((lit > 0) | (is_inf > 0), 0.0, penumbra)
    pixel_size = nm.pixel_radius_to_world(float(sc["unproject"]), float(sc["ortho_mode"]), 1.0,
                                          view_z)
    pixel_radius = get_kernel_radius_in_pixels(hit_dist, pixel_size)
    n = float(tiles.TILE * tiles.TILE)
    all_lit = (tiles.tile_reduce(lit_vote, "sum") == n).to(torch.float32)
    all_umbra = (tiles.tile_reduce(umbra_vote, "sum") == n).to(torch.float32)
    all_inf = (tiles.tile_reduce(is_inf, "sum") == n).to(torch.float32)
    max_radius = tiles.tile_reduce(pixel_radius, "max")
    x = 1.0 - torch.maximum(all_lit, all_umbra)
    y = nm.saturate(max_radius / 16.0)
    return torch.stack([x, y, all_inf], -1)


def smooth_tiles(tile_map):
    """Gaussian dilation of the needs-denoising channel, its width driven by the centre's
    radius (SIGMA_SmoothTiles.hlsli, 3x3). Returns (th, tw, 2): (all-sky, blurred)."""
    center_y = tile_map[..., 1]
    k = 1.01 / (center_y + 0.01)
    blurry = torch.zeros_like(center_y)
    wsum = torch.zeros_like(center_y)
    for dy, dx in stencil.offsets_square(1):
        w = torch.exp2(-k * float(dy * dy + dx * dx))
        blurry = blurry + stencil.shifted(tile_map[..., 0], dy, dx) * w
        wsum = wsum + w
    return torch.stack([tile_map[..., 2], blurry / wsum], -1)


def tile_planes(sc, tiles_smoothed, h: int, w: int, row0=0, frame_h=None):
    """(2, h, w): the tile value (B-spline upsampled, 0 on sky tiles) and the sky-tile mask,
    the per-pixel tile data of Blur, PostBlur and TS (`kernels.py:158-161`, `:304-306`), of
    the frame rows row0 .. row0 + h - 1 (a frame frame_h high, default h). A sky pixel is
    passed through by all three either way, so zeroing its tile value changes no output."""
    return torch.stack([tiles.upsample_tile_value(tiles_smoothed, h, w, sc["resolution_scale"],
                                                  row0=row0, frame_h=frame_h),
                        tiles.tile_upsample_nearest(tiles_smoothed[..., 0], h, w, row0=row0)])


def _blur_consts(sc, dc, first_pass):
    return dict(first_pass=first_pass, rotator=sc["rotator"] if first_pass else sc["rotator_post"],
                view_z_scale=float(sc["view_z_scale"]), frustum=sc["frustum"],
                ortho_mode=float(sc["ortho_mode"]), unproject=float(sc["unproject"]),
                min_rect_dim_mul_unproject=float(sc["min_rect_dim_mul_unproject"]),
                plane_dist_sensitivity=float(dc["plane_dist_sensitivity"]),
                world_to_view=sc["world_to_view"], rect_size=sc["rect_size"],
                rect_size_inv=sc["rect_size_inv"], denoising_range=float(sc["denoising_range"]))


def blur(sc, dc, penumbra_in, shadow_in, view_z_in, normal_roughness, tile, *, first_pass,
         decoded=False, row0=0, frame_h=None):
    """Dense 5x5 penumbra estimation + sparse 8-tap Poisson shadow filter (`kernels.py:133`),
    one `sigma_blur` launch. shadow_in: None on the first pass of SIGMA_SHADOW (then
    IsLit(penumbra)), the packed translucency on the first pass of
    SIGMA_SHADOW_TRANSLUCENCY, the sqrt-packed Blur output on PostBlur. decoded:
    normal_roughness is the RGBA formats' decoded plane (`frontend.decode_normal_plane`).
    row0, frame_h: the planes' rows in the frame. Returns (penumbra_out, shadow_packed_out)."""
    return k_sigma_blur.sigma_blur(penumbra_in, shadow_in, view_z_in, normal_roughness, tile,
                                   **_blur_consts(sc, dc, first_pass), decoded=decoded,
                                   row0=row0, frame_h=frame_h)


def temporal_stabilization(sc, dc, view_z_in, mv_in, penumbra, shadow_packed, history_packed,
                           prev_view_z, prev_history_len, tile, row0=0, frame_h=None):
    """Surface-motion reprojection + sigma-clamped history blend + antilag (`kernels.py:290`),
    one `sigma_ts` launch (both MV branches in the kernel). row0, frame_h: the current planes'
    rows in the frame; the previous planes are whole frames. Returns (out_shadow_packed,
    new_prev_view_z, new_history_len)."""
    return k_sigma_ts.sigma_ts(
        shadow_packed, penumbra, view_z_in, mv_in.contiguous(), prev_view_z, prev_history_len,
        history_packed, tile, view_z_scale=float(sc["view_z_scale"]),
        min_rect_dim_mul_unproject=float(sc["min_rect_dim_mul_unproject"]),
        rect_size_prev=sc["rect_size_prev"],
        stabilization_strength=float(dc["stabilization_strength"]),
        denoising_range=float(sc["denoising_range"]),
        reprojection={k: sc[k] for k in k_sigma_ts.REPROJECTION}, row0=row0, frame_h=frame_h)


def split_screen(sc, penumbra, view_z_in, out_shadow, translucency=None, *, channels: int):
    """The left `splitScreen` fraction shows the raw (hard) shadow input."""
    h, w = penumbra.shape
    view_z = unpack_view_z(sc, view_z_in)
    u = nm.div(torch.arange(w, dtype=torch.float32, device=penumbra.device) + 0.5, w)
    s = translucency if translucency is not None else is_lit(penumbra)[..., None]
    s = s * (view_z < float(sc["denoising_range"])).to(torch.float32)[..., None]
    if channels == 1:
        s = s[..., :1]
    return torch.where(u[None, :, None] <= float(sc["split_screen"]), s, out_shadow)

