"""Fixed-offset stencil helpers - counterpart of `nrdtpu/ops/stencil.py`."""

from __future__ import annotations

import torch


def shifted(img, dy: int, dx: int):
    """View of `img` shifted so that out[y, x] = img[y + dy, x + dx], clamp-to-edge."""
    if dy == 0 and dx == 0:
        return img
    h, w = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, rows).index_select(1, cols)


def offsets_square(radius: int, exclude_center: bool = False):
    """Static list of (dy, dx) offsets for a (2r+1)^2 stencil, row by row."""
    return [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
            if not (exclude_center and dy == 0 and dx == 0)]
