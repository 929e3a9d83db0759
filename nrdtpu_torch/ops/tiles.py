"""1/16-resolution tile maps - counterpart of `nrdtpu/ops/tiles.py` (REBLUR sky tiles)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE = 16


def tile_reduce_min(img, tile: int = TILE):
    """(H, W) -> (ceil(H/t), ceil(W/t)) minimum over each t x t tile."""
    h, w = img.shape
    ph, pw = (-h) % tile, (-w) % tile
    x = F.pad(img, (0, pw, 0, ph), value=float("inf"))
    return x.reshape((h + ph) // tile, tile, (w + pw) // tile, tile).amin(dim=(1, 3))


def tile_upsample_nearest(tile_map, h: int, w: int, tile: int = TILE):
    """Broadcast a (th, tw) tile map back to (h, w) pixels."""
    up = tile_map.repeat_interleave(tile, dim=0).repeat_interleave(tile, dim=1)
    return up[:h, :w]


def classify_sky_tiles(view_z, denoising_range: float, tile: int = TILE):
    """REBLUR ClassifyTiles: 1 where ALL pixels of the tile are beyond denoisingRange."""
    return tile_reduce_min((torch.abs(view_z) > denoising_range).to(torch.float32), tile)
