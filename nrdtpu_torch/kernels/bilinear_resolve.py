"""Bilinear samples of a packed (h, w, 4) image at S uv sets - kernel
`csrc/bilinear_resolve.cu`.

Replaces `nrdtpu/kernels/reblur_pallas.py:1813` (`bilinear_resolve`). The RELAX specular TA
looks back along the virtual motion 1 and 2 steps and reads the previous packed
normal/roughness there (`nrdtpu/passes/relax/kernels.py:853-877`); this kernel does both
look-backs in one launch, each `sample_bilinear(image, uv x scale)` with the linear-clamp
addressing of the XLA path. The in-screen test of each uv stays in the glue, as XLA's
`is_in_screen_nearest`: the TPU kernel's renormalised off-screen taps and validity output
(`reblur_pallas.py:1813-1816`) are not carried over.

Bound on the H100: memory. Per pixel and uv set it reads 8 B of uv and writes 16 B; the 4
texels it blends lie near the pixel, so the image is read about once from device memory:
~64 B/px for S = 2, ~240 MB a frame at 2560x1440, ~70 us at 3.35 TB/s. One thread per
pixel in 16x16 blocks.
"""

from __future__ import annotations

import torch

from .. import math as nm
from ..ops import resample
from . import build

launches = 0


def bilinear_resolve_ref(image, uvs, *, scale):
    """Plain PyTorch version of the kernel: sample_bilinear of every uv set x scale."""
    return torch.stack([resample.sample_bilinear(image, nm.scale2(uv, float(scale[0]),
                                                                  float(scale[1])))
                        for uv in uvs])


def bilinear_resolve(image, uvs, *, scale):
    """image (h, w, 4), uvs (S, h, w, 2), scale the host (x, y) factor of the uvs
    (resolution_scale_prev). Returns (S, h, w, 4)."""
    global launches
    dev = build.kernel_device(image)
    if dev is None:
        return bilinear_resolve_ref(image, uvs, scale=scale)
    h, w = image.shape[:2]
    s = uvs.shape[0]
    build.check("image", image, dev, torch.float32, (h, w, 4))
    build.check("uvs", uvs, dev, torch.float32, (s, h, w, 2))
    out = torch.empty((s, h, w, 4), dtype=torch.float32, device=dev)
    build.launch("nrd_bilinear_resolve", [image, uvs, out], [s, scale[0], scale[1]], w, h)
    launches += 1
    return out
