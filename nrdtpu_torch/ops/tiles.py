"""1/16-resolution tile maps - counterpart of `nrdtpu/ops/tiles.py` (REBLUR sky tiles, SIGMA
tile classification)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
_PAD = {"max": -float("inf"), "min": float("inf"), "sum": 0.0}


def tile_reduce(img, op: str = "max", tile: int = TILE):
    """(H, W) -> (ceil(H/t), ceil(W/t)) min / max / sum over each t x t tile; the ragged edge
    is padded with the operation's identity."""
    h, w = img.shape
    ph, pw = (-h) % tile, (-w) % tile
    x = F.pad(img, (0, pw, 0, ph), value=_PAD[op])
    x = x.reshape((h + ph) // tile, tile, (w + pw) // tile, tile)
    if op == "max":
        return x.amax(dim=(1, 3))
    if op == "min":
        return x.amin(dim=(1, 3))
    return x.sum(dim=(1, 3))


def tile_upsample_nearest(tile_map, h: int, w: int, tile: int = TILE, row0: int = 0):
    """Broadcast a (th, tw) tile map back to (h, w) pixels: the frame rows row0 .. row0 + h - 1
    (clamped to the frame's tiles: a band's padding rows beyond the frame read the edge)."""
    rows = torch.clamp(torch.arange(row0, row0 + h, device=tile_map.device) // tile, 0,
                       tile_map.shape[0] - 1)
    return tile_map.index_select(0, rows).repeat_interleave(tile, dim=1)[:, :w]


def classify_sky_tiles(view_z, denoising_range: float, tile: int = TILE):
    """REBLUR ClassifyTiles: 1 where ALL pixels of the tile are beyond denoisingRange."""
    return tile_reduce((torch.abs(view_z) > denoising_range).to(torch.float32), "min", tile)


def upsample_tile_value(tiles_smoothed, h: int, w: int, resolution_scale, tile: int = TILE,
                        row0: int = 0, frame_h=None):
    """The tile value (channel 1, cubic B-spline upsampled to pixels) with the sky tiles
    (channel 0) zeroed - `nrdtpu/ops/tiles.py:upsample_tile_value`. The port always takes
    its gather path (`resample.sample_bicubic_bspline`, the XLA SIGMA passes' own formula);
    the phase-aligned matmul form there is a TPU workaround for slow gathers. row0, frame_h:
    the plane's rows in the frame (`resample.pixel_uv_grid`)."""
    from . import resample

    uv = resample.pixel_uv_grid(h, w, tiles_smoothed.device, row0, frame_h)
    rs = np.broadcast_to(np.asarray(resolution_scale, np.float32), (2,))
    tile_value = resample.sample_bicubic_bspline(
        tiles_smoothed[..., 1], torch.stack([uv[..., 0] * float(rs[0]),
                                             uv[..., 1] * float(rs[1])], -1))
    sky = tile_upsample_nearest(tiles_smoothed[..., 0], h, w, tile, row0)
    return torch.where(sky > 0.0, 0.0, tile_value)
