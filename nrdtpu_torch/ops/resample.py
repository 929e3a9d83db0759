"""Texture-sampling equivalents - counterpart of `nrdtpu/ops/resample.py`.

Conventions: images are (H, W) or (H, W, C); pixel (x, y) lives at [y, x]; uv is (..., 2) in
[0, 1] with texel centres at (i + 0.5) / size; addressing is clamp-to-edge. These are the
plain versions the hand kernels are held against (`kernels/csrc/common.cuh` mirrors them).

Row origin (a band of rows of a frame, `parallel/sharding.py`): `pixel_uv_grid` and
`sample_nearest` take `row0`, the frame row of the plane's first row, and `frame_h`, the
frame's height. uv stays the frame's; a texel is fetched at its frame row minus row0, clamped to
the plane. Unsharded row0 is 0 and frame_h the plane's height.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as nm


def _chanify(img):
    return (img[..., None], False) if img.dim() == 2 else (img, True)


def texel_fetch(img, x, y):
    """Integer fetch with clamp addressing; x, y integer tensors of one shape."""
    img_c, had_c = _chanify(img)
    h, w = img_c.shape[0], img_c.shape[1]
    xc = torch.clamp(x.long(), 0, w - 1)
    yc = torch.clamp(y.long(), 0, h - 1)
    out = img_c[yc, xc]
    return out if had_c else out[..., 0]


def to_index(origin):
    """Float texel coordinate -> int64, bounded first so that no value overflows (any
    coordinate beyond +-2^20 clamps to the same edge texel)."""
    return torch.clamp(origin, -1048576.0, 1048576.0).long()


def sample_nearest(img, uv, row0: int = 0, frame_h=None):
    img_c, _ = _chanify(img)
    h, w = img_c.shape[0], img_c.shape[1]
    fh = h if frame_h is None else frame_h
    return texel_fetch(img, to_index(torch.floor(uv[..., 0] * w)),
                       to_index(torch.floor(uv[..., 1] * fh)) - row0)


def gather_2x2(img, origin):
    """2x2 footprint at integer origin (..., 2) = (x, y): (s00, s10, s01, s11)."""
    x0 = to_index(origin[..., 0])
    y0 = to_index(origin[..., 1])
    return (texel_fetch(img, x0, y0), texel_fetch(img, x0 + 1, y0),
            texel_fetch(img, x0, y0 + 1), texel_fetch(img, x0 + 1, y0 + 1))


def sample_bilinear(img, uv):
    """Linear-clamp sampler (SampleLevel with gLinearClamp)."""
    img_c, had_c = _chanify(img)
    h, w = img_c.shape[0], img_c.shape[1]
    origin, f = nm.bilinear_filter(uv, (w, h))
    s00, s10, s01, s11 = gather_2x2(img_c, origin)
    wts = nm.bilinear_weights(f)
    out = (s00 * wts[..., 0:1] + s10 * wts[..., 1:2]
           + s01 * wts[..., 2:3] + s11 * wts[..., 3:4])
    return out if had_c else out[..., 0]


def bilinear_custom(img, origin, weights):
    """_BilinearFilterWithCustomWeights_Color (Common.hlsli:648-656); 0 where the weight
    sum is ~0."""
    img_c, had_c = _chanify(img)
    s00, s10, s01, s11 = gather_2x2(img_c, origin)
    out = nm.apply_bilinear_custom_weights(s00, s10, s01, s11, weights)
    return out if had_c else out[..., 0]


def sample_catrom(img, sample_pos, use_bicubic=None, bilinear_custom_weights=None,
                  sharpness: float = 0.5):
    """13-tap Catmull-Rom (no corners) with per-pixel fallback to the custom bilinear
    weights (Common.hlsli:602-646). `sample_pos` is in pixels of `img`; returns 0 where the
    weight sum vanishes."""
    img_c, had_c = _chanify(img)
    h, w = img_c.shape[0], img_c.shape[1]
    inv_w, inv_h = float(np.float32(1.0) / np.float32(w)), float(np.float32(1.0) / np.float32(h))

    center_pos = torch.floor(sample_pos - 0.5) + 0.5
    f = nm.saturate(sample_pos - center_pos)
    w0x, w1x, w2x, w3x = nm.catmull_rom_weights(f[..., 0], sharpness)
    w0y, w1y, w2y, w3y = nm.catmull_rom_weights(f[..., 1], sharpness)
    w12x, w12y = w1x + w2x, w1y + w2y
    tcx = w2x / w12x
    tcy = w2y / w12y

    wa = w12x * w0y
    wb = w0x * w12y
    wc = w12x * w12y
    wd = w3x * w12y
    we = w12x * w3y

    cx, cy = center_pos[..., 0], center_pos[..., 1]
    if use_bicubic is not None:
        ub = use_bicubic
        bw = bilinear_custom_weights
        wa = torch.where(ub, wa, bw[..., 0])
        wb = torch.where(ub, wb, bw[..., 1])
        wc = torch.where(ub, wc, bw[..., 2])
        wd = torch.where(ub, wd, bw[..., 3])
        we = torch.where(ub, we, 0.0)
        taps = ((torch.where(ub, cx + tcx, cx), torch.where(ub, cy - 1.0, cy)),
                (torch.where(ub, cx - 1.0, cx + 1.0), torch.where(ub, cy + tcy, cy)),
                (torch.where(ub, cx + tcx, cx), torch.where(ub, cy + tcy, cy + 1.0)),
                (torch.where(ub, cx + 2.0, cx + 1.0), torch.where(ub, cy + tcy, cy + 1.0)),
                (torch.where(ub, cx + tcx, cx + f[..., 0]),
                 torch.where(ub, cy + 2.0, cy + f[..., 1])))
    else:
        taps = ((cx + tcx, cy - 1.0), (cx - 1.0, cy + tcy), (cx + tcx, cy + tcy),
                (cx + 2.0, cy + tcy), (cx + tcx, cy + 2.0))
    wsum = wa + wb + wc + wd + we

    color = None
    for (px, py), wt in zip(taps, (wa, wb, wc, wd, we)):
        t = sample_bilinear(img_c, torch.stack([px * inv_w, py * inv_h], -1)) * wt[..., None]
        color = t if color is None else color + t
    color = torch.where((wsum < 0.0001)[..., None], 0.0,
                        color / torch.where(torch.abs(wsum) < 0.0001, 1.0, wsum)[..., None])
    return color if had_c else color[..., 0]


def _bspline_weights(t):
    """Cubic B-spline basis at offsets -1..2."""
    t2 = t * t
    t3 = t2 * t
    return ((1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0, (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0,
            (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0, t3 / 6.0)


def sample_bicubic_bspline(img, uv):
    """Cubic B-spline texture filter (TextureCubic, SIGMA_Common.hlsli:44-93), evaluated as
    its 16 taps; smooths the 1/16-resolution tile maps up to pixels."""
    img_c, had_c = _chanify(img)
    h, w = img_c.shape[0], img_c.shape[1]
    pos = nm.scale2(uv, float(w), float(h)) - 0.5
    base = torch.floor(pos)
    f = pos - base
    wx = _bspline_weights(f[..., 0])
    wy = _bspline_weights(f[..., 1])
    x0 = base[..., 0].to(torch.int32)
    y0 = base[..., 1].to(torch.int32)
    out = 0.0
    for j in range(4):
        row = 0.0
        for i in range(4):
            row = row + texel_fetch(img_c, x0 + (i - 1), y0 + (j - 1)) * wx[i][..., None]
        out = out + row * wy[j][..., None]
    return out if had_c else out[..., 0]


def pixel_uv_grid(h: int, w: int, device=None, row0: int = 0, frame_h=None):
    """uv of every pixel centre of an (h, w) plane: (h, w, 2), y-down; the plane's rows are
    the frame rows row0 .. row0 + h - 1 of a frame frame_h high (default: the plane itself)."""
    fh = h if frame_h is None else frame_h
    x = nm.div(torch.arange(w, dtype=torch.float32, device=device) + 0.5, w)
    y = nm.div(torch.arange(row0, row0 + h, dtype=torch.float32, device=device) + 0.5, fh)
    v, u = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([u, v], -1)


def frame_rows(plane, row0: int, h: int):
    """The rows row0 .. row0 + h - 1 of a whole-frame plane, clamped to the frame: what a band
    of h rows at row0 reads of a previous-frame plane at its own pixels."""
    if row0 == 0 and plane.shape[0] == h:
        return plane
    rows = torch.clamp(torch.arange(row0, row0 + h, device=plane.device), 0, plane.shape[0] - 1)
    return plane.index_select(0, rows)


def is_in_screen_nearest(uv):
    """IsInScreenNearest (Common.hlsli:280-283)."""
    inside = (uv > 0.0).all(-1) & (uv < 1.0).all(-1)
    return inside.to(torch.float32)


def is_in_screen_bilinear(footprint_origin, rect_size):
    """IsInScreenBilinear (Common.hlsli:287-295): per-tap validity of a 2x2 footprint."""
    px, py = footprint_origin[..., 0], footprint_origin[..., 1]
    rx, ry = float(rect_size[0]), float(rect_size[1])

    def ok(p, r):
        return ((p >= 0.0) & (p < r)).to(torch.float32)

    x0, x1 = ok(px, rx), ok(px + 1.0, rx)
    y0, y1 = ok(py, ry), ok(py + 1.0, ry)
    return torch.stack([x0 * y0, x1 * y0, x0 * y1, x1 * y1], -1)
