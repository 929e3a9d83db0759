"""RELAX history-clamping moments - kernel `csrc/relax_clamp_moments.cu` (K20).

Replaces `nrdtpu/kernels/relax_pallas.py:479` (`relax_clamp_moments_pallas`). Computes the 5x5
moments of `history_clamping` (`nrdtpu/passes/relax/kernels.py:1169-1192`) per pixel: over
the clamp-to-edge 5x5 (edge pixels repeat, they are not zero), each tap weighted by its
in-range validity (`viewZ < denoisingRange`), the mean and second moment of the responsive
history in YCoCg and the mean of the noisy radiance and second moment of its luminance,
divided by `max(weight sum, 1)`.

Bound on the H100: bytes. Per pixel it reads viewZ, the responsive history and the noisy
signal (36 B, every tap an L1 neighbour) and writes 10 planes (40 B).
"""

from __future__ import annotations

import torch

from .. import math as nm
from ..ops import stencil
from . import build

launches = 0


def relax_clamp_moments_ref(view_z_in, responsive, noisy, *, view_z_scale, denoising_range):
    """Plain PyTorch version of the kernel (the XLA 5x5 loop)."""
    view_z = torch.abs(view_z_in) * view_z_scale
    is_valid = (view_z < denoising_range).to(torch.float32)
    resp_ycocg = nm.linear_to_ycocg(responsive[..., :3])
    m1 = torch.zeros_like(resp_ycocg)
    m2 = torch.zeros_like(resp_ycocg)
    nm1 = torch.zeros_like(resp_ycocg)
    nm2 = torch.zeros_like(view_z)
    wsum = torch.zeros_like(view_z)
    for dy, dx in stencil.offsets_square(2):
        w_ = stencil.shifted(is_valid, dy, dx)
        ry = stencil.shifted(resp_ycocg, dy, dx)
        nz = stencil.shifted(noisy[..., :3], dy, dx)
        m1 = m1 + ry * w_[..., None]
        m2 = m2 + ry * ry * w_[..., None]
        nl = nm.luminance(nz)
        nm1 = nm1 + nz * w_[..., None]
        nm2 = nm2 + nl * nl * w_
        wsum = wsum + w_
    wsum = torch.clamp_min(wsum, 1.0)
    return m1 / wsum[..., None], m2 / wsum[..., None], nm1 / wsum[..., None], nm2 / wsum


def relax_clamp_moments(view_z_in, responsive, noisy, *, view_z_scale, denoising_range):
    """responsive (h, w, 4) history after the history fix (rgb), noisy (h, w, 4) the PrePass
    output (rgb). Returns (m1, m2) of the responsive YCoCg (h, w, 3) each, the noisy mean
    (h, w, 3) and the noisy luminance's second moment (h, w)."""
    global launches
    kw = dict(view_z_scale=view_z_scale, denoising_range=denoising_range)
    dev = build.kernel_device(responsive)
    if dev is None:
        return relax_clamp_moments_ref(view_z_in, responsive, noisy, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("view_z_in", view_z_in, (h, w)), ("responsive", responsive, (h, w, 4)),
           ("noisy", noisy, (h, w, 4))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    vec = torch.empty((3, h, w, 3), dtype=f32, device=dev)
    nm2 = torch.empty((h, w), dtype=f32, device=dev)
    build.launch("nrd_relax_clamp_moments", [t for _, t, _ in ins] + [vec, nm2],
                 [view_z_scale, denoising_range], w, h)
    launches += 1
    return vec[0], vec[1], vec[2], nm2
