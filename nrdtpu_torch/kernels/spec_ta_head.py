"""Specular TA head - kernel `csrc/spec_ta_head.cu`.

Replaces `nrdtpu/kernels/reblur_pallas.py:942` (`spec_ta_head`), the fused form of three TPU
kernels: `:882` `spec_prelude`, `:847` `shift_planes` and `:171` `nearest_resolve`. Computes,
per pixel, the gathers at the head of `temporal_accumulation_specular` with the XLA
semantics (`nrdtpu/passes/reblur/kernels.py:1005-1022`, `:1093-1097`, `:1125-1128`):

  - the 3x3 minimum of hitDistForTracking, zeros read as NRD_INF (`:1006`);
  - the 3x3 mean and second moment of roughness^2 (row by row, as the XLA loop sums);
  - the packed normal planes 0-1 at (dy, dx) = (0, 1) and (1, 0), clamp-to-edge, for the
    curvature edge;
  - viewZ and packed normal planes 0-1 nearest (clamp addressing) at the high-parallax uv.
    There is no validity mask: the TPU kernel's block-base residual is not carried over.

Bound on the H100: memory. Per pixel at 2560x1440 it reads 9 hitDist taps and 9 packed
normals (L1-resident neighbourhood, ~20 B from device memory), the uv (8 B) and one viewZ +
packed normal near it (~20 B), and writes 40 B: ~90 B/px, ~330 MB a frame, ~0.1 ms at
3.35 TB/s. One thread per pixel in 16x16 blocks with plain global loads.
"""

from __future__ import annotations

import torch

from .. import frontend as fe
from ..ops import resample, stencil
from . import build

launches = 0

PLANES = ("hdt_min", "rough_m1", "rough_m2", "nr01_0", "nr01_1", "nr10_0", "nr10_1",
          "z_high", "nr_high_0", "nr_high_1")


def spec_ta_head_ref(hdt_in, normal_roughness, view_z_in, motion_uv_high):
    """Plain PyTorch version of the kernel (the XLA stencils and nearest fetches)."""
    hdt_src = torch.where(hdt_in == 0.0, fe.NRD_INF, hdt_in)
    hdt_min = hdt_src
    m1 = torch.zeros_like(hdt_in)
    m2 = torch.zeros_like(hdt_in)
    roughness = normal_roughness[..., 2]
    for dy, dx in stencil.offsets_square(1):
        hdt_min = torch.minimum(hdt_min, stencil.shifted(hdt_src, dy, dx))
        rsq = stencil.shifted(roughness, dy, dx)
        rsq = rsq * rsq
        m1 = m1 + rsq
        m2 = m2 + rsq * rsq
    nr01 = stencil.shifted(normal_roughness, 0, 1)
    nr10 = stencil.shifted(normal_roughness, 1, 0)
    nr_high = resample.sample_nearest(normal_roughness, motion_uv_high)
    planes = [hdt_min, m1 / 9.0, m2 / 9.0, nr01[..., 0], nr01[..., 1], nr10[..., 0],
              nr10[..., 1], resample.sample_nearest(view_z_in, motion_uv_high),
              nr_high[..., 0], nr_high[..., 1]]
    return dict(zip(PLANES, planes))


def spec_ta_head(hdt_in, normal_roughness, view_z_in, motion_uv_high):
    """hdt_in (h, w) hitDistForTracking (0 = none), normal_roughness (h, w, 4) packed
    (linear roughness), view_z_in (h, w) raw, motion_uv_high (h, w, 2). Returns a dict of
    (h, w) planes named by PLANES; z_high is the raw viewZ."""
    global launches
    dev = build.kernel_device(hdt_in)
    if dev is None:
        return spec_ta_head_ref(hdt_in, normal_roughness, view_z_in, motion_uv_high)
    h, w = hdt_in.shape
    f32 = torch.float32
    ins = [("hdt_in", hdt_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4)),
           ("view_z_in", view_z_in, (h, w)), ("motion_uv_high", motion_uv_high, (h, w, 2))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    planes = torch.empty((len(PLANES), h, w), dtype=f32, device=dev)
    build.launch("nrd_spec_ta_head", [t for _, t, _ in ins] + [planes], [], w, h)
    launches += 1
    return {name: planes[k] for k, name in enumerate(PLANES)}
