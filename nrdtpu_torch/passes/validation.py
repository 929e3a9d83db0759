"""OUT_VALIDATION debug overlay - counterpart of `nrdtpu/passes/validation.py`
(REBLUR_Validation.cs.hlsl / RELAX_Validation), torch glue on the engine's device: the JAX
package computes it in XLA with no Pallas kernel, so it has no hand kernel here either.

A 4x4 grid of viewports (NRD README.md:281-314), each the whole frame at quarter size sampled
nearest (`viewportUv = frac(pixelUv / 0.25)`, REBLUR_Validation.cs.hlsl:43-53), which is a 4x
decimation at offset 2:

  0  normals | 1 roughness | 2 viewZ (+green / -blue / beyond the denoising range red)
  3  MV against the static-scene reprojection | 4 world-units grid + jitter and rotator trails
  7  virtual history amount (REBLUR) | 8 / 11 diffuse / specular accumulated frames (Zucconi
  colours, a checker where the history was reset) | 12 / 15 diffuse / specular normalized hitT.

The other viewports keep the previous overlay, transparent (`result = gOut_Validation[...]`,
:76), so the trails of viewport 4 persist: the previous overlay rides the state under
"validation". A history reset clears the whole overlay (:36-40). The text labels
(Text::Print_ch) are not rendered, as in the JAX package.

Every frame constant (colours, matrices, the jitter, the rotators' taps) enters as a Python
float, per channel where the JAX package broadcasts a vector: a host tensor copied to the card
would make the stream wait for the frame's work at each copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm

# Zucconi's six constants a channel (MathLib ColorizeZucconi): (c1, x1, y1, c2, x2, y2)
_ZUCCONI = [[float(v) for v in np.array(c, np.float32)] for c in (
    (3.54585104, 0.69549072, 0.02312639, 3.90307140, 0.11748627, 0.84897130),
    (2.93225262, 0.49228336, 0.15225084, 3.21182957, 0.86755042, 0.88445281),
    (2.41593945, 0.27699880, 0.52607955, 3.96587128, 0.66077860, 0.73949448))]


def _zucconi6(x):
    """Spectral colours (Alan Zucconi's 6-constant fit); (..., 3) of x (...)."""
    x = torch.clamp(x, 0.0, 1.0)

    def bump(center, width, yoff):
        t = (x - center) * width
        return torch.clamp(1.0 - t * t - yoff, 0.0, 1.0)

    return torch.stack([torch.clamp(bump(x1, c1, y1) + bump(x2, c2, y2), 0.0, 1.0)
                        for c1, x1, y1, c2, x2, y2 in _ZUCCONI], -1)


def _decimate4(img, h4, w4):
    """The frame sampled nearest at the viewport's pixel centres: rows and columns 2, 6, 10,
    ..., past the edge the last one (the JAX package's edge padding)."""
    h, w = img.shape[:2]
    rows = torch.clamp(torch.arange(h4, device=img.device) * 4 + 2, max=h - 1)
    cols = torch.clamp(torch.arange(w4, device=img.device) * 4 + 2, max=w - 1)
    return img[rows][:, cols]


def _screen_uv(m, x):
    """Geometry::GetScreenUv of the positions x (..., 3) by a host (4, 4) matrix, as XLA's
    product of the homogeneous position with the matrix's transpose sums its four terms on the
    CPU, in pairs (`nrdtpu/math.py:projective_transform`): the MV viewport subtracts two of
    these, so a different order shows. Returns (u, v)."""
    m = np.asarray(m, np.float32)

    def row(i):
        r = [float(v) for v in m[i]]
        return (x[..., 0] * r[0] + x[..., 1] * r[1]) + (x[..., 2] * r[2] + r[3])

    cw = row(3)
    cw = torch.where(torch.abs(cw) < 1e-15, 1e-15, cw)
    return row(0) / cw * 0.5 + 0.5, 0.5 - row(1) / cw * 0.5


def _where_rgb(mask, rgb, other):
    """`other` (..., 3) with the constant colour `rgb` where `mask` (...)."""
    return torch.stack([torch.where(mask, float(c), other[..., i]) for i, c in enumerate(rgb)],
                       -1)


def render_validation(sc, view_z_in, normal_roughness, mv_in, config,
                      diff_accum=None, spec_accum=None, virtual_history_amount=None,
                      max_accumulated_frame_num=63.0, diff_hit_t=None, spec_hit_t=None,
                      prev_validation=None):
    """The (h, w, 4) overlay; alpha is the layer's opacity for compositing. `normal_roughness`
    is IN_NORMAL_ROUGHNESS as packed at the config's encodings."""
    h, w = view_z_in.shape
    h4, w4 = -(-h // 4), -(-w // 4)
    dev = view_z_in.device

    def dec(x):
        return _decimate4(x, h4, w4)

    view_z_raw = dec(view_z_in) * float(sc["view_z_scale"])
    view_z = torch.abs(view_z_raw)
    mv = dec(mv_in)
    n, roughness, _ = fe.unpack_normal_roughness(dec(normal_roughness), config.normal_encoding,
                                                 config.roughness_encoding)
    is_inf = view_z > float(sc["denoising_range"])
    live = 1.0 - is_inf.to(torch.float32)

    # the uv of the sampled pixels (the centres of the decimated grid)
    us = (torch.arange(w4, dtype=torch.float32, device=dev) * 4.0 + 2.5) / (4.0 * w4)
    vs = (torch.arange(h4, dtype=torch.float32, device=dev) * 4.0 + 2.5) / (4.0 * h4)
    uv = torch.stack(torch.meshgrid(us, vs, indexing="xy"), -1)  # (h4, w4, 2) x, y

    xv = nm.reconstruct_view_position(uv, sc["frustum"], view_z, float(sc["ortho_mode"]))
    x_world = nm.rotate_vector(sc["view_to_world"], xv)

    prev = (prev_validation if prev_validation is not None
            else torch.zeros((h, w, 4), dtype=torch.float32, device=dev))
    if prev.shape[0] != 4 * h4 or prev.shape[1] != 4 * w4:  # edge-padded to the 4x4 grid
        rows = torch.clamp(torch.arange(4 * h4, device=dev), max=prev.shape[0] - 1)
        cols = torch.clamp(torch.arange(4 * w4, device=dev), max=prev.shape[1] - 1)
        prev = prev[rows][:, cols]

    def cell_prev(cy, cx):
        return prev[cy * h4:(cy + 1) * h4, cx * w4:(cx + 1) * w4]

    def rgba(rgb, a=1.0):
        return torch.cat([rgb, torch.full_like(rgb[..., :1], a)], -1)

    def gray(t):
        return t[..., None].expand(t.shape + (3,))

    cells = {}
    # 0: world-space normals; 1: linear roughness
    cells[0] = rgba(n * 0.5 + 0.5)
    cells[1] = rgba(gray(roughness))
    # 2: viewZ - green +, blue -, red beyond the denoising range (Validation.cs.hlsl:110-120)
    f = 0.1 * view_z / (1.0 + 0.1 * view_z)
    negative = view_z_raw < 0.0
    zcol = torch.stack([0.0 * f, torch.where(negative, 0.0 * f, 1.0 * f),
                        torch.where(negative, 1.0 * f, 0.0 * f)], -1)
    cells[2] = rgba(_where_rgb(is_inf, (1.0, 0.0, 0.0), zcol))
    # 3: MV against the expected static-scene reprojection (:122-136)
    mv_scale = [float(v) for v in np.asarray(sc["mv_scale"], np.float32)]
    mv_s = torch.stack([mv[..., c] * mv_scale[c] for c in range(3)], -1) if mv.shape[-1] == 3 \
        else torch.stack([mv[..., 0] * mv_scale[0], mv[..., 1] * mv_scale[1],
                          torch.zeros_like(mv[..., 0])], -1)
    u_exp, v_exp = _screen_uv(sc["world_to_clip_prev"], x_world)
    if mv_scale[3] != 0.0:
        u_prev, v_prev = _screen_uv(sc["world_to_clip_prev"], x_world + mv_s)
    else:
        u_prev, v_prev = uv[..., 0] + mv_s[..., 0], uv[..., 1] + mv_s[..., 1]
    rect_w, rect_h = (float(v) for v in np.asarray(sc["rect_size"], np.float32))
    on_screen = (u_prev >= 0.0) & (u_prev <= 1.0) & (v_prev >= 0.0) & (v_prev <= 1.0)
    mv_rgb = torch.stack([torch.abs((u_prev - u_exp) * rect_w),
                          torch.abs((v_prev - v_exp) * rect_h), torch.zeros_like(u_prev)], -1)
    cells[3] = rgba(_where_rgb(~on_screen, (0.0, 0.0, 1.0), mv_rgb))
    # 4: the world grid, the jitter trail and the rotator trail (:140-238)
    cells[4] = rgba(_units_jitter_rotators(sc, uv, x_world, view_z, live,
                                           cell_prev(1, 0)[..., :3], h4, w4))
    # 7: virtual history amount (REBLUR)
    if virtual_history_amount is not None:
        cells[7] = rgba(gray(dec(virtual_history_amount)) * live[..., None])

    # 8 / 11: accumulated frames in Zucconi colours; a checker marks a reset history (:260-301)
    def frames_cell(accum, cy, cx):
        a = dec(accum)
        fago = 1.0 - torch.clamp(a / max(max_accumulated_frame_num, 1.0), 0.0, 1.0)
        # the checker on the output pixel >> 2 (the cell's origin + the local position)
        py = torch.arange(h4, device=dev)[:, None] + cy * h4
        px = torch.arange(w4, device=dev)[None, :] + cx * w4
        checker = ((px >> 2) + (py >> 2)) & 1
        fago = torch.where((checker == 0) & (a < 1.0), 0.75, fago)
        t = torch.where(uv[..., 1] > 0.95, 1.0 - uv[..., 0], fago * live)
        return rgba(_zucconi6(t))

    if diff_accum is not None:
        cells[8] = frames_cell(diff_accum, 2, 0)
    if spec_accum is not None:
        cells[11] = frames_cell(spec_accum, 2, 3)

    # 12 / 15: the input's normalized hitT (:303-330): red at 0, magenta outside [0, 1]
    def hit_cell(ht):
        t = dec(ht)
        base = _where_rgb(t != torch.clamp(t, 0.0, 1.0), (1.0, 0.0, 1.0), gray(t))
        return rgba(_where_rgb(t == 0.0, (1.0, 0.0, 0.0), base) * live[..., None])

    if diff_hit_t is not None:
        cells[12] = hit_cell(diff_hit_t)
    if spec_hit_t is not None:
        cells[15] = hit_cell(spec_hit_t)

    def unused(cy, cx):  # an unused viewport: the previous content, transparent
        c = cell_prev(cy, cx)
        return torch.cat([c[..., :3] * 1.0, c[..., 3:] * 0.0], -1)

    rows = [torch.cat([cells[cy * 4 + cx] if cy * 4 + cx in cells else unused(cy, cx)
                       for cx in range(4)], 1) for cy in range(4)]
    out = torch.cat(rows, 0)[:h, :w]
    if float(sc["reset_history"]) > 0.0:  # gResetHistory clears the whole overlay (:36-40)
        return torch.zeros_like(out)
    return out.contiguous()


def viewport4_masks(h: int, w: int):
    """(squares, units): host boolean (h, w) masks of viewport 4 of an (h, w) overlay, its jitter
    and rotator squares (whose trails are exact) and the rest of it, the world-units layer (a
    value mod 1, compared by the wrap-aware distance min(|d|, 1 - |d|)); as
    `_units_jitter_rotators` places them."""
    h4, w4 = -(-h // 4), -(-w // 4)
    f32 = np.float32
    us = (np.arange(w4, dtype=f32) * f32(4.0) + f32(2.5)) / f32(4.0 * w4)
    vs = (np.arange(h4, dtype=f32) * f32(4.0) + f32(2.5)) / f32(4.0 * h4)
    u, v = np.meshgrid(us, vs, indexing="xy")
    dim = np.array([f32(0.5) * f32(h4 / w4), f32(0.5)], f32)
    in_sq = ((u - (f32(1.0) - dim[0])) / dim[0] > 0) & ((v - (f32(1.0) - dim[1])) / dim[1] > 0)
    in_sq2 = ((u - (f32(1.0) - dim[0])) / dim[0] > 0) & (v / dim[1] > 0)
    squares = np.zeros((4 * h4, 4 * w4), bool)
    units = np.zeros((4 * h4, 4 * w4), bool)
    squares[h4:2 * h4, :w4] = in_sq | in_sq2
    units[h4:2 * h4, :w4] = ~(in_sq | in_sq2)
    return squares[:h, :w], units[:h, :w]


def _units_jitter_rotators(sc, uv, x_world, view_z, live, prev_rgb, h4, w4):
    """Viewport 4: the world-unit grid, the camera-jitter trail (the bottom-right square, red
    where the jitter leaves the pixel) and the rotators' tap trail (the top-right square). The
    trails accumulate because the untouched pixels keep the previous overlay (:171-229). The
    jitter and the taps are frame constants: their positions are worked out on the host in
    float32, as the JAX package's scalar ops give them."""
    f32 = np.float32
    aspect = f32(h4 / w4)
    dim = np.array([f32(0.5) * aspect, f32(0.5)], f32)
    dim_px = np.array([dim[0] * f32(w4), dim[1] * f32(h4)], f32)
    dx, dy = float(dim[0]), float(dim[1])
    px_x, px_y = float(dim_px[0]), float(dim_px[1])
    u, v = uv[..., 0], uv[..., 1]

    # the world-units layer
    units = torch.remainder(x_world + (view_z * 0.001)[..., None], 1.0) * live[..., None]

    # the bottom-right square and the top-right one beside it
    rem_x, rem_y = (u - float(f32(1.0) - dim[0])) / dx, (v - float(f32(1.0) - dim[1])) / dy
    rem2_x, rem2_y = (u - float(f32(1.0) - dim[0])) / dx, (v - 0.0) / dy
    in_sq = (rem_x > 0.0) & (rem_y > 0.0)
    in_sq2 = (rem2_x > 0.0) & (rem2_y > 0.0) & ~in_sq

    # the jitter dot
    juv = np.asarray(sc["jitter"], f32) + f32(0.5)
    jvalid = bool((np.clip(juv, f32(0.0), f32(1.0)) == juv).all())
    a = np.floor(np.clip(juv, f32(0.0), f32(1.0)) * dim_px)
    dist_x = torch.abs(float(a[0]) - torch.floor(rem_x * px_x))
    dist_y = torch.abs(float(a[1]) - torch.floor(rem_y * px_y))
    sq = prev_rgb  # the old dots stay: the trail
    if jvalid:
        sq = torch.where(((dist_x <= 1.0) & (dist_y <= 1.0))[..., None], 0.66, sq)
    else:
        sq = _where_rgb((dist_x <= 3.0) & (dist_y <= 3.0), (1.0, 0.0, 0.0), sq)

    # the rotators' taps (an additive trail, cleared every 256 frames)
    scale = f32(0.5) * f32(nm._reverse_bits_4(int(sc["frame_index"]))) / f32(16.0)
    b2_x, b2_y = torch.floor(rem2_x * px_x), torch.floor(rem2_y * px_y)
    add = []
    for name in ("rotator_pre", "rotator", "rotator_post"):
        r = np.asarray(sc[name], f32)
        hits = torch.zeros_like(u)
        for tap in nm.SPECIAL_8:
            t = tap[:2].astype(f32) * scale
            off = np.array([t[0] * r[0] + t[1] * r[2], t[0] * r[1] + t[1] * r[3]], f32)
            ta = np.floor(np.clip(f32(0.5) + off, f32(0.0), f32(1.0)) * dim_px)
            hits = hits + ((torch.abs(float(ta[0]) - b2_x) <= 1.0)
                           & (torch.abs(float(ta[1]) - b2_y) <= 1.0)).to(torch.float32)
        add.append(hits)
    rot = torch.clamp(prev_rgb + torch.stack(add, -1), 0.0, 1.0)
    if int(sc["frame_index"]) % 256 == 0:
        rot = torch.zeros_like(rot)

    out = torch.where(in_sq[..., None], sq, units)
    return torch.where(in_sq2[..., None], rot, out)
