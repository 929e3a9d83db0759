"""Nearest fetches of the packed previous normals at several uv sets - kernel
`csrc/nearest_multi.cu`.

Replaces `nrdtpu/kernels/reblur_pallas.py:219` (`nearest_resolve_multi`). The specular TA
reads the previous packed normal/roughness texel nearest to S stochastically rounded uvs
(`nrdtpu/passes/reblur/kernels.py:1199-1221`, `:1374-1375`): the virtual-motion normal and
the prev-prev taps. The stochastic rounding (`_stochastic_bilinear_uv`, one hash stream per
pixel in the reference's order) stays in the pass glue; this kernel does the S fetches in
one launch, clamp addressing, no validity mask (the TPU kernel's block-base residual is not
carried over).

Bound on the H100: memory. Per pixel and uv set it reads 8 B of uv and writes 16 B; the 16 B
texels it fetches lie near the pixel, so the image is read about once from device memory:
~64 B/px for S = 2, ~240 MB a frame, ~70 us at 3.35 TB/s. One thread per pixel in 16x16
blocks, one float4 load per set.
"""

from __future__ import annotations

import torch

from ..ops import resample
from . import build

launches = 0


def nearest_multi_ref(packed, uvs):
    """Plain PyTorch version of the kernel: sample_nearest of every uv set."""
    return torch.stack([resample.sample_nearest(packed, uv) for uv in uvs])


def nearest_multi(packed, uvs):
    """packed (h, w, 4), uvs (S, h, w, 2). Returns (S, h, w, 4): the texel nearest to each
    uv (clamp addressing)."""
    global launches
    dev = build.kernel_device(packed)
    if dev is None:
        return nearest_multi_ref(packed, uvs)
    h, w = packed.shape[:2]
    s = uvs.shape[0]
    build.check("packed", packed, dev, torch.float32, (h, w, 4))
    build.check("uvs", uvs, dev, torch.float32, (s, h, w, 2))
    if packed.data_ptr() % 16:
        raise ValueError("packed: the kernel reads 16-byte texels, the tensor is not aligned")
    out = torch.empty((s, h, w, 4), dtype=torch.float32, device=dev)
    build.launch("nrd_nearest_multi", [packed, uvs, out], [s], w, h)
    launches += 1
    return out
