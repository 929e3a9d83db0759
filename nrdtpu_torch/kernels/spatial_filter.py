"""REBLUR spatial-filter tap loop, diffuse and specular - kernel `csrc/spatial_filter.cu`.

Replaces `nrdtpu/kernels/reblur_blur2.py:264` (`spatial_filter_taps_pallas2`), run three times
a frame: PrePass, Blur and PostBlur. Computes the tap loop shared by `diffuse_pre_pass`
(`nrdtpu/passes/reblur/kernels.py:2164-2189`), `diffuse_spatial_filter` (`:844-873`) and
`specular_spatial_filter` (`:1710-1756`): for each of the 8 Poisson taps (6 in performance
mode) the per-pixel scaled rotator places the tap, which snaps to a pixel centre;
plane-distance, material, normal-angle, hit-distance and Gaussian weights multiply, and the
float4 signal accumulates. The passes differ in the rotator, the skew and the constants,
all of which arrive in per-pixel planes: `shared` (the centre's plane-distance parameters,
normal and view-space normal, the same for every signal of the pixel) and `params` (the
signal's own), whose count chooses one of three modes:

  - diffuse (PARAMS);
  - specular (+ SPEC_PARAMS): the roughness weight of each tap (`:1727`);
  - specular PrePass (+ PREPASS_PARAMS): also the stochastic minimum of the taps' hit
    distances, hitDistForTracking (`:1732-1743`), with 8 (6) random numbers drawn per pixel
    from `hash_init(pixel, frame_index)` in tap order, as the XLA loop draws them, and the
    taps' weights scaled by `use_prepass_not_only_for_specular_motion_estimation` and the
    hit-distance / roughness lerp.

The tap loop is the device function `sf_filter` of `csrc/reblur_filters.cuh`, shared with
the fused two-signal kernel (`spatial_filter_fused`).

Bound on the H100: gathers. Per pixel at 2560x1440 it reads 16 param planes (64 B), the
centre signal, and 8 taps of viewZ, packed normal and signal (8 x 36 B = 288 B) scattered
over a radius of up to 60 px; taps land in L1/L2 for small radii and miss for large ones.
The specular modes read 2 (Blur, PostBlur) or 7 (PrePass) more param planes, 8-28 B/px.
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

# per-pixel planes, in order (the pass glue stacks them): shared by the signals of a pixel,
# and the signal's own
SHARED = ("ga", "gb", "nx", "ny", "nz", "nvx", "nvy", "nvz")
PARAMS = ("rot0", "rot1", "rot2", "rot3", "normal_weight_param", "ha", "hb",
          "min_hit_dist_weight")
SPEC_PARAMS = ("wr_a", "wr_b")
PREPASS_PARAMS = ("hit_dist", "roughness", "xvx", "xvy", "xvz")
MODES = {len(PARAMS): "diffuse", len(PARAMS + SPEC_PARAMS): "spec",
         len(PARAMS + SPEC_PARAMS + PREPASS_PARAMS): "spec_prepass"}


def tap_table(perf_mode: bool) -> np.ndarray:
    """(taps, 3) float32: offset x, offset y, Gaussian weight of the tap radius."""
    taps = nm.SPECIAL_6 if perf_mode else nm.SPECIAL_8
    return np.array([(t[0], t[1], nm.get_gaussian_weight(float(t[2]))) for t in taps],
                    np.float32)


_TAPS = {}


def device_taps(perf_mode, device):
    key = (perf_mode, str(device))
    if key not in _TAPS:
        _TAPS[key] = torch.as_tensor(tap_table(perf_mode), device=device)
    return _TAPS[key]


def spatial_filter_ref(signal, view_z_in, normal_roughness, shared, params, *, frustum,
                       rect_size, view_z_scale, ortho_mode, min_material, perf_mode,
                       prepass=None):
    """Plain PyTorch version of the kernel (the XLA tap loop)."""
    h, w = view_z_in.shape
    mode = MODES[params.shape[0]]
    p = dict(zip(SHARED, shared))
    p.update(zip(PARAMS + SPEC_PARAMS + PREPASS_PARAMS, params))
    uv = resample.pixel_uv_grid(h, w, signal.device)
    rot = torch.stack([p["rot0"], p["rot1"], p["rot2"], p["rot3"]], -1)
    n = torch.stack([p["nx"], p["ny"], p["nz"]], -1)
    nv = torch.stack([p["nvx"], p["nvy"], p["nvz"]], -1)
    material_id = normal_roughness[..., 3] * 3.0
    rw, rh = float(rect_size[0]), float(rect_size[1])

    sum_ = torch.ones_like(view_z_in)
    acc = signal
    if mode == "spec_prepass":
        hit_dist = p["hit_dist"]
        hdt = torch.where(hit_dist == 0.0, fe.NRD_INF, hit_dist)
        xv = torch.stack([p["xvx"], p["xvy"], p["xvz"]], -1)
        state = nm.hash_init(torch.arange(w, device=signal.device)[None, :].expand(h, w),
                             torch.arange(h, device=signal.device)[:, None].expand(h, w),
                             prepass["frame_index"])
        rough_lerp = nm.linearstep(0.5, 1.0, p["roughness"])
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
        if mode != "diffuse":
            w_ = w_ * nm.compute_weight(nr_s[..., 2], p["wr_a"], p["wr_b"])
        s = resample.sample_nearest(signal, uv_s)
        s = torch.where((w_ == 0.0)[..., None], 0.0, s)
        if mode == "spec_prepass":
            hs = s[..., -1] * fe.get_hit_distance_normalization(zs, prepass["hit_dist_params"],
                                                                nr_s[..., 2])
            d = nm.length(xvs - xv) + fe.NRD_EPS
            geometry_weight = w_ * nm.saturate(hs / d)
            state, rnd = nm.hash_float(state)
            take = (rnd < geometry_weight) & (hs > 0.0)
            hdt = torch.where(take, torch.minimum(hdt, hs), hdt)
            w_ = w_ * prepass["use_prepass_not_only"]
            t = hs / (d + hit_dist)
            w_ = w_ * nm.lerp(nm.saturate(t), 1.0, rough_lerp)
        w_ = w_ * nm.lerp(p["min_hit_dist_weight"], 1.0,
                          nm.compute_exponential_weight(s[..., -1], p["ha"], p["hb"]))
        w_ = w_ * float(gw)
        sum_ = sum_ + w_
        acc = acc + s * w_[..., None]
    out = acc * (1.0 / torch.clamp_min(sum_, 1e-15))[..., None]
    if mode == "spec_prepass":
        return out, torch.where(hdt == fe.NRD_INF, 0.0, hdt)
    return out


def check_params(params, prepass):
    """The mode of `params` (8 | 10 | 15 planes); raise unless `prepass` goes with it."""
    if params.shape[0] not in MODES:
        raise ValueError(f"params: {params.shape[0]} planes")
    prepass_mode = MODES[params.shape[0]] == "spec_prepass"
    if prepass_mode != (prepass is not None):
        raise ValueError("the specular PrePass mode and only it takes `prepass`")
    return prepass_mode


def prepass_consts(prepass):
    """Launch constants of the specular PrePass: hit-distance parameters, the prepass-only
    flag and the frame index as two 16-bit halves (a float carries neither half exactly
    beyond 2^24)."""
    f = int(prepass["frame_index"]) & 0xFFFFFFFF
    return [*prepass["hit_dist_params"], prepass["use_prepass_not_only"], f & 0xFFFF, f >> 16]


def spatial_filter(signal, view_z_in, normal_roughness, shared, params, *, frustum, rect_size,
                   view_z_scale, ortho_mode, min_material, perf_mode, prepass=None):
    """signal (h, w, 4), view_z_in (h, w), normal_roughness (h, w, 4) with linear roughness,
    shared float32 planes named by SHARED (8, h, w), params float32 planes named by PARAMS
    (+ SPEC_PARAMS (+ PREPASS_PARAMS)): (8 | 10 | 15, h, w). The specular PrePass mode takes
    `prepass` = dict(hit_dist_params (A, B, C, D), use_prepass_not_only, frame_index).
    Returns the filtered signal (h, w, 4), and in the PrePass mode also hitDistForTracking
    (h, w)."""
    global launches
    kw = dict(frustum=frustum, rect_size=rect_size, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, min_material=min_material, perf_mode=perf_mode,
              prepass=prepass)
    prepass_mode = check_params(params, prepass)
    dev = build.kernel_device(signal)
    if dev is None:
        return spatial_filter_ref(signal, view_z_in, normal_roughness, shared, params, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("signal", signal, (h, w, 4)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)),
           ("shared", shared, (len(SHARED), h, w)), ("params", params, (params.shape[0], h, w))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    taps = device_taps(perf_mode, dev)
    out = torch.empty((h, w, 4), dtype=f32, device=dev)
    hdt = torch.empty((h, w) if prepass_mode else (1,), dtype=f32, device=dev)
    consts = [*frustum, rect_size[0], rect_size[1], view_z_scale, ortho_mode, min_material,
              taps.shape[0], params.shape[0]]
    if prepass_mode:
        consts += prepass_consts(prepass)
    build.launch("nrd_spatial_filter", [t for _, t, _ in ins] + [taps, out, hdt], consts, w, h)
    launches += 1
    return (out, hdt) if prepass_mode else out
