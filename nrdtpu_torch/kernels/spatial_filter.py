"""REBLUR diffuse spatial-filter tap loop - kernel `csrc/spatial_filter.cu`.

Replaces `nrdtpu/kernels/reblur_blur2.py:264` (`spatial_filter_taps_pallas2`), run three times
a frame: PrePass, Blur and PostBlur. Computes the tap loop shared by `diffuse_pre_pass`
(`nrdtpu/passes/reblur/kernels.py:2164-2189`) and `diffuse_spatial_filter` (`:844-873`): for
each of the 8 Poisson taps (6 in performance mode) the per-pixel scaled rotator places the
tap, which snaps to a pixel centre; plane-distance, material, normal-angle, hit-distance and
Gaussian weights multiply, and the float4 signal accumulates. The two passes differ only in
the rotator, the skew and the constants, all of which arrive in the `params` planes.

Bound on the H100: gathers. Per pixel at 2560x1440 it reads 16 param planes (64 B), the
centre signal, and 8 taps of viewZ, packed normal and signal (8 x 36 B = 288 B) scattered
over a radius of up to 60 px; taps land in L1/L2 for small radii and miss for large ones.
This first version is one thread per pixel in 16x16 blocks with plain global loads; the
TPU kernel's static tap lattice (which ignored the rotator) is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample
from . import build

launches = 0

# params planes, in order (the pass glue stacks them)
PARAMS = ("rot0", "rot1", "rot2", "rot3", "ga", "gb", "normal_weight_param", "ha", "hb",
          "min_hit_dist_weight", "nx", "ny", "nz", "nvx", "nvy", "nvz")


def tap_table(perf_mode: bool) -> np.ndarray:
    """(taps, 3) float32: offset x, offset y, Gaussian weight of the tap radius."""
    taps = nm.SPECIAL_6 if perf_mode else nm.SPECIAL_8
    return np.array([(t[0], t[1], nm.get_gaussian_weight(float(t[2]))) for t in taps],
                    np.float32)


_TAPS = {}


def _device_taps(perf_mode, device):
    key = (perf_mode, str(device))
    if key not in _TAPS:
        _TAPS[key] = torch.as_tensor(tap_table(perf_mode), device=device)
    return _TAPS[key]


def spatial_filter_ref(signal, view_z_in, normal_roughness, params, *, frustum, rect_size,
                       view_z_scale, ortho_mode, min_material, perf_mode):
    """Plain PyTorch version of the kernel (the XLA tap loop)."""
    h, w = view_z_in.shape
    p = dict(zip(PARAMS, params))
    uv = resample.pixel_uv_grid(h, w, signal.device)
    rot = torch.stack([p["rot0"], p["rot1"], p["rot2"], p["rot3"]], -1)
    n = torch.stack([p["nx"], p["ny"], p["nz"]], -1)
    nv = torch.stack([p["nvx"], p["nvy"], p["nvz"]], -1)
    material_id = normal_roughness[..., 3] * 3.0
    rw, rh = float(rect_size[0]), float(rect_size[1])

    sum_ = torch.ones_like(view_z_in)
    acc = signal
    for ox, oy, gw in tap_table(perf_mode):
        ox, oy = float(ox), float(oy)
        us = uv[..., 0] + (ox * rot[..., 0] + oy * rot[..., 2])
        vs = uv[..., 1] + (ox * rot[..., 1] + oy * rot[..., 3])
        uv_s = torch.stack([nm.div(torch.floor(us * rw) + 0.5, rw),
                            nm.div(torch.floor(vs * rh) + 0.5, rh)], -1)
        zs = torch.abs(resample.sample_nearest(view_z_in, uv_s)) * view_z_scale
        nr_s = resample.sample_nearest(normal_roughness, uv_s)
        ns, _, ms = fe.unpack_normal_roughness(nr_s)
        angle = nm.acos_approx(nm.dot(n, ns))
        xvs = nm.reconstruct_view_position(uv_s, frustum, zs, ortho_mode)
        w_ = resample.is_in_screen_nearest(uv_s)
        w_ = w_ * nm.compute_weight(nm.dot(nv, xvs), p["ga"], p["gb"])
        w_ = w_ * (torch.clamp_min(material_id, min_material)
                   == torch.clamp_min(ms, min_material)).to(torch.float32)
        w_ = w_ * nm.compute_weight(angle, p["normal_weight_param"], 0.0)
        s = resample.sample_nearest(signal, uv_s)
        s = torch.where((w_ == 0.0)[..., None], 0.0, s)
        w_ = w_ * nm.lerp(p["min_hit_dist_weight"], 1.0,
                          nm.compute_exponential_weight(s[..., -1], p["ha"], p["hb"]))
        w_ = w_ * float(gw)
        sum_ = sum_ + w_
        acc = acc + s * w_[..., None]
    return acc * (1.0 / torch.clamp_min(sum_, 1e-15))[..., None]


def spatial_filter(signal, view_z_in, normal_roughness, params, *, frustum, rect_size,
                   view_z_scale, ortho_mode, min_material, perf_mode):
    """signal (h, w, 4), view_z_in (h, w), normal_roughness (h, w, 4), params (16, h, w)
    float32 planes named by PARAMS. Returns the filtered signal (h, w, 4)."""
    global launches
    kw = dict(frustum=frustum, rect_size=rect_size, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, min_material=min_material, perf_mode=perf_mode)
    dev = build.kernel_device(signal)
    if dev is None:
        return spatial_filter_ref(signal, view_z_in, normal_roughness, params, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("signal", signal, (h, w, 4)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)),
           ("params", params, (len(PARAMS), h, w))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    taps = _device_taps(perf_mode, dev)
    out = torch.empty((h, w, 4), dtype=f32, device=dev)
    consts = [*frustum, rect_size[0], rect_size[1], view_z_scale, ortho_mode, min_material,
              taps.shape[0]]
    build.launch("nrd_spatial_filter", [t for _, t, _ in ins] + [taps, out], consts, w, h)
    launches += 1
    return out
