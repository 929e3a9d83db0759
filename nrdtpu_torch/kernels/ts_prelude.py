"""REBLUR temporal-stabilization prelude - kernel `csrc/ts_prelude.cu`.

Replaces two TPU kernels in one launch, because both read around the same pixel in TS:
`nrdtpu/kernels/reblur_pallas.py:1754` (`moments_minmax_pallas`: 3x3 mean, second moment and
min/max over the 8 neighbours of luma, `nrdtpu/passes/reblur/kernels.py:2365-2378`) and
`nrdtpu/kernels/reblur_pallas.py:1705` (`hist_sample_pallas`: CatRom-13 / bilinear-custom
sample of the bf16 luma-stabilization history at the surface-motion position, with the
occlusion taken from fbits, `:2338-2342`, `:2383-2385`). For the specular signal the same
launch also samples the history at the virtual-motion position, with the occlusion of fbits
bits 4-7 (`:2458-2485`), the second `hist_sample_pallas` call of the TPU path.

Bound on the H100: memory. Per pixel at 2560x1440 it reads 9 luma taps (L1-resident, 4 B
from device memory), 13 bf16 history taps near the reprojected position (~2-4 B from device
memory), the uv and fbits (12 B), and writes 20 B: ~40 B/px, ~150 MB a frame, ~45 us at
3.35 TB/s; the virtual-motion sample adds ~16 B/px. One thread per pixel in 16x16 blocks
with plain global loads.
"""

from __future__ import annotations

import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from . import build

launches = 0

PLANES = ("m1", "m2", "lmin", "lmax", "history", "vmb_history")


def _sample(history, uv, fbits, first_bit, rect_size_prev):
    """sample_history at uv with the occlusion of fbits bits first_bit..first_bit+3."""
    _, frac = nm.bilinear_filter(uv, rect_size_prev)
    bits = fbits.to(torch.int32)
    occ = torch.stack([((bits >> b) & 1).to(torch.float32)
                       for b in range(first_bit, first_bit + 4)], -1)
    weights = nm.get_bilinear_custom_weights(frac, occ)
    allow_catrom = torch.sum(occ, -1) > 3.5
    sample_pos = nm.scale2(nm.saturate(uv), rect_size_prev[0], rect_size_prev[1])
    return resample.sample_catrom(history.float(), sample_pos, allow_catrom, weights)


def ts_prelude_ref(luma, history, smb_uv, fbits, *, rect_size_prev, vmb_uv=None):
    """Plain PyTorch version of the kernel (the XLA moments + sample_history)."""
    m1 = torch.zeros_like(luma)
    m2 = torch.zeros_like(luma)
    lmin = torch.full_like(luma, fe.NRD_INF)
    lmax = torch.full_like(luma, -fe.NRD_INF)
    for dy, dx in stencil.offsets_square(1):
        t = stencil.shifted(luma, dy, dx)
        m1 = m1 + t
        m2 = m2 + t * t
        if not (dy == 0 and dx == 0):
            lmin = torch.minimum(lmin, t)
            lmax = torch.maximum(lmax, t)

    out = dict(m1=m1 / 9.0, m2=m2 / 9.0, lmin=lmin, lmax=lmax,
               history=_sample(history, smb_uv, fbits, 0, rect_size_prev))
    if vmb_uv is not None:
        out["vmb_history"] = _sample(history, vmb_uv, fbits, 4, rect_size_prev)
    return out


def ts_prelude(luma, history, smb_uv, fbits, *, rect_size_prev, vmb_uv=None):
    """luma (h, w) float32, history (h, w) bf16, smb_uv (h, w, 2), fbits (h, w) float32,
    optional vmb_uv (h, w, 2). Returns dict(m1, m2, lmin, lmax, history[, vmb_history]) of
    (h, w) planes."""
    global launches
    dev = build.kernel_device(luma)
    if dev is None:
        return ts_prelude_ref(luma, history, smb_uv, fbits, rect_size_prev=rect_size_prev,
                              vmb_uv=vmb_uv)
    h, w = luma.shape
    f32 = torch.float32
    ins = [("luma", luma, f32, (h, w)), ("history", history, torch.bfloat16, (h, w)),
           ("smb_uv", smb_uv, f32, (h, w, 2)), ("fbits", fbits, f32, (h, w))]
    if vmb_uv is not None:
        ins.append(("vmb_uv", vmb_uv, f32, (h, w, 2)))
    for name, t, dt, shape in ins:
        build.check(name, t, dev, dt, shape)
    n = len(PLANES) if vmb_uv is not None else len(PLANES) - 1
    planes = torch.empty((n, h, w), dtype=f32, device=dev)
    # without a vmb set the kernel gets smb_uv in its place and writes 5 planes
    uvs = [smb_uv, vmb_uv if vmb_uv is not None else smb_uv]
    build.launch("nrd_ts_prelude", [luma, history, *uvs, fbits, planes],
                 [rect_size_prev[0], rect_size_prev[1], vmb_uv is not None], w, h)
    launches += 1
    return {name: planes[k] for k, name in enumerate(PLANES[:n])}
