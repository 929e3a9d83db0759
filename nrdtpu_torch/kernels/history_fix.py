"""REBLUR history fix, diffuse and specular, the fast-history clamp included - kernel
`csrc/history_fix.cu`.

Replaces `nrdtpu/kernels/reblur_hfix2.py:222` (`history_fix_taps_pallas2`). Computes
`history_fix` (`nrdtpu/passes/reblur/kernels.py:546-552`, `:629-732`): 20 taps of the 5x5
grid without centre and corners at the per-pixel floored stride, weighted by plane distance,
material, normal angle, accumulation speed and hit distance, replacing the signal where the
stride is non-zero; the 3x3 mean and second moment of the fast history (`:693-700`); then the
clamp (`passes/reblur/params.py:history_fix_clamp`: the fast-history mix, the luminance
clamp to the 3x3 moments). The specular mode (`params` with the specular planes) adds the
relaxed roughness weight of each tap and the low-roughness hit-distance guide (`:653-668`).
With `anti_firefly=True` the luminance is first clamped to the moments of the fast history
over the 9x9 square minus the 3x3 (72 taps, radius 4 in every mode, `:705-719`; the TPU
kernel's ring is `reblur_hfix2.py:209-212`). It returns the clamped signal, the fast history
and the tap-geometry plane (each pixel's unpacked normal and scaled viewZ) that the kernel
writes for its taps, which H2's Blur and PostBlur then read; the moments stay in the kernel.

With the SH variants (`sh`, the signal's SH1 after TA) the SH rides the same taps: all four
channels weighed by each tap's final weight and the centre by 1 + its accumulation speed, passed
through where the stride is 0, then .xyz scaled to the clamped luma (`:622`, `:671-675`,
`:680-683`, `:729-731`; on the specular signal .w, the TA's modified roughness, is averaged
too, as XLA does).

With the occlusion variants the signal is the (h, w, 1) hit distance: the one-channel
instances take it through the taps and clamp it as its own luma with sigma scale 1
(`params.history_fix_clamp(occlusion=True)`, `:685-728`).

With REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (`directional=True`, diffuse only) the (h, w, 4)
signal, the direction times the normalized hit distance and the hit distance, takes the
radiance taps; the clamp takes .w as the luma with sigma scale 1, and its ChangeLuma scales
.xyz by (luma + 1e-6) / (.w + 1e-6) and sets .w to the luma
(`params.history_fix_clamp(directional=True)`, `:686-728`; the kernel's `kDir` instance).

The kernel is the one-signal instance of the body that N5 and K23 run for two signals
(`csrc/reblur_filters.cuh:history_fix_cta`).

At the RGBA normal encodings (`decoded`) the planes are the ones that the frame decodes once
(`frontend.decode_normal_plane`, the roughness decoded as well): the tap geometry copies their
normal, and the kernel's `kDec` instances read the roughness from .w and test no material.

Bound on the H100: bytes. Per pixel at 2560x1440 it reads 9 shared planes, 5 (diffuse) or 9
(specular) of the signal's own planes, the specular magic curve, the signal, viewZ, the packed
normal, the accumulation speed and the fast history (88-108 B), and writes the clamped signal
and the fast history (20 B); the 20 taps (pixels with stride 0 skip them) and the fast-history
window hit L1/L2. The TPU kernel's hat-blended stride levels are not carried over (the stride
is per pixel, as in XLA).
"""

from __future__ import annotations

import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from ..passes.reblur import params as P
from . import build

launches = 0
dec_launches = 0  # of them, the instances on the decoded plane of the RGBA formats (kDec)

# per-pixel planes, in order (the pass glue stacks them): shared by the signals of a pixel,
# and the signal's own
SHARED = ("ga", "gb", "frustum_size", "nx", "ny", "nz", "nvx", "nvy", "nvz")
PARAMS = ("stride", "normal_weight_param", "ha", "hb", "hit_dist_scale")
# specular mode appends these planes: the roughness weight and the low-roughness hitT guide
SPEC_PARAMS = ("ra", "rb", "hit_dist", "guide_b")
ANTI_FIREFLY_RADIUS = 4  # REBLUR_ANTI_FIREFLY_FILTER_RADIUS, in every mode (kernels.py:706)


def _moments(fast_history, offsets):
    """Mean and second moment over the offsets; the divisions are true divisions on every
    device (`math.div`), as in XLA and the kernels: on the card a division by a Python scalar is
    a multiplication by its reciprocal, and where the window is flat (the occlusion variants'
    binary AO) sqrt(|m2 - m1^2|) turns that last bit into 3e-4 of the clamp."""
    m1 = torch.zeros_like(fast_history)
    m2 = torch.zeros_like(fast_history)
    for dy, dx in offsets:
        t = stencil.shifted(fast_history, dy, dx)
        m1 = m1 + t
        m2 = m2 + t * t
    return nm.div(m1, float(len(offsets))), nm.div(m2, float(len(offsets)))


def anti_firefly_offsets():
    """(dy, dx) of the anti-firefly ring, row by row: the 9x9 square minus the 3x3."""
    return [(dy, dx) for dy, dx in stencil.offsets_square(ANTI_FIREFLY_RADIUS)
            if not (abs(dy) <= 1 and abs(dx) <= 1)]


def tap_geometry_ref(normal_roughness, view_z_in, view_z_scale, decoded=False):
    """(h, w, 4): each pixel's unpacked normal and scaled viewZ, what a tap reads of its texel
    (`csrc/reblur_filters.cuh:unpacked_geometry`); decoded: the RGBA formats' decoded plane."""
    n, _, _ = fe.unpack_normal_plane(normal_roughness, decoded)
    return torch.cat([n, (torch.abs(view_z_in) * view_z_scale)[..., None]], -1)


def taps_and_clamp_ref(signal, view_z_in, normal_roughness, data1, fast_history, shared, params,
                    smc, *, frustum, rect_size_inv, view_z_scale, ortho_mode, min_material, dc,
                    anti_firefly=False, sh=None, directional=False, decoded=False, row0=0,
                    frame_h=None):
    """The XLA stride-tap loop, the 3x3 moments and the ring, then
    `params.history_fix_clamp`. Returns (signal_out, fast_out), and with `sh` (the signal's
    SH1) also its history fix, scaled to the clamped luma. decoded: normal_roughness is the
    RGBA formats' decoded plane (its material 0); row0, frame_h: the planes' rows in the frame
    (the uv and a tap's row, clamped to the frame, are the frame's)."""
    h, w = view_z_in.shape
    spec = params.shape[0] == len(PARAMS) + len(SPEC_PARAMS)
    p = dict(zip(SHARED, shared))
    p.update(zip(PARAMS + SPEC_PARAMS, params))
    stride = p["stride"]
    n = torch.stack([p["nx"], p["ny"], p["nz"]], -1)
    nv = torch.stack([p["nvx"], p["nvy"], p["nvz"]], -1)
    material_id = fe.unpack_normal_plane(normal_roughness, decoded)[2]
    fh = h if frame_h is None else frame_h
    uv = resample.pixel_uv_grid(h, w, signal.device, row0, fh)
    xs = torch.arange(w, dtype=torch.float32, device=signal.device)[None, :].expand(h, w)
    ys = torch.arange(row0, row0 + h, dtype=torch.float32,
                      device=signal.device)[:, None].expand(h, w)

    sum_ = 1.0 + data1
    acc = signal * sum_[..., None]
    acc_sh = sh * sum_[..., None] if sh is not None else None
    for j in range(-2, 3):
        for i in range(-2, 3):
            if (i == 0 and j == 0) or abs(i) + abs(j) == 4:
                continue
            ofx, ofy = float(i) * stride, float(j) * stride
            uv_s = torch.stack([uv[..., 0] + ofx * float(rect_size_inv[0]),
                                uv[..., 1] + ofy * float(rect_size_inv[1])], -1)
            px = torch.clamp(xs + ofx, 0, w - 1).long()
            py = torch.clamp(ys + ofy, 0, fh - 1).long() - row0
            zs = torch.abs(resample.texel_fetch(view_z_in, px, py)) * view_z_scale
            ns, rs, ms = fe.unpack_normal_plane(resample.texel_fetch(normal_roughness, px, py),
                                                decoded)
            angle = nm.acos_approx(nm.dot(ns, n))
            xvs = nm.reconstruct_view_position(uv_s, frustum, zs, ortho_mode)
            w_ = resample.is_in_screen_nearest(uv_s)
            w_ = w_ * nm.compute_weight(nm.dot(nv, xvs), p["ga"], p["gb"])
            w_ = w_ * (torch.clamp_min(material_id, min_material)
                       == torch.clamp_min(ms, min_material)).to(torch.float32)
            w_ = w_ * nm.compute_exponential_weight(angle, p["normal_weight_param"], 0.0)
            if spec:
                w_ = w_ * nm.compute_exponential_weight(rs * rs, p["ra"], p["rb"])
            w_ = w_ * (1.0 + resample.texel_fetch(data1, px, py))
            s = resample.texel_fetch(signal, px, py)
            s = torch.where((w_ == 0.0)[..., None], 0.0, s)
            hs = s[..., -1] * p["hit_dist_scale"]
            w_ = w_ * nm.compute_exponential_weight(nm.get_hit_dist_factor(hs, p["frustum_size"]),
                                                    p["ha"], p["hb"])
            if spec:
                hd, b = p["hit_dist"], p["guide_b"]
                d = torch.abs(hd - hs) / (torch.maximum(hd, hs) + 0.001)
                w_ = w_ * nm.smoothstep(0.2 + b, 0.05 + b, d)
            sum_ = sum_ + w_
            acc = acc + s * w_[..., None]
            if sh is not None:
                sh_s = resample.texel_fetch(sh, px, py)
                sh_s = torch.where((w_ == 0.0)[..., None], 0.0, sh_s)
                acc_sh = acc_sh + sh_s * w_[..., None]
    inv = (1.0 / torch.clamp_min(sum_, 1e-15))[..., None]
    use_fix = (stride != 0.0)[..., None]
    out = torch.where(use_fix, acc * inv, signal)
    sh_out = torch.where(use_fix, acc_sh * inv, sh) if sh is not None else None
    m1, m2 = _moments(fast_history, stencil.offsets_square(1))
    ring = _moments(fast_history, anti_firefly_offsets()) if anti_firefly else None
    return P.history_fix_clamp(dc, dict(smc=smc), data1, out, fast_history, m1, m2, ring,
                               not spec, sh=sh_out, occlusion=signal.shape[-1] == 1,
                               directional=directional)


def history_fix_ref(signal, view_z_in, normal_roughness, data1, fast_history, shared, params,
                    smc, *, frustum, rect_size_inv, view_z_scale, ortho_mode, min_material, dc,
                    anti_firefly=False, sh=None, directional=False, decoded=False, row0=0,
                    frame_h=None):
    """Plain PyTorch version of the kernel: the XLA stride-tap loop, the 3x3 moments and the
    ring, then `params.history_fix_clamp`; and the tap geometry. Returns dict(signal, fast,
    geometry[, sh])."""
    res = taps_and_clamp_ref(
        signal, view_z_in, normal_roughness, data1, fast_history, shared, params, smc,
        frustum=frustum, rect_size_inv=rect_size_inv, view_z_scale=view_z_scale,
        ortho_mode=ortho_mode, min_material=min_material, dc=dc, anti_firefly=anti_firefly,
        sh=sh, directional=directional, decoded=decoded, row0=row0, frame_h=frame_h)
    out = dict(signal=res[0], fast=res[1],
               geometry=tap_geometry_ref(normal_roughness, view_z_in, view_z_scale, decoded))
    if sh is not None:
        out["sh"] = res[2]
    return out


def check_params(shared, params):
    if shared.shape[0] != len(SHARED):
        raise ValueError(f"shared: {shared.shape[0]} planes")
    if params.shape[0] not in (len(PARAMS), len(PARAMS) + len(SPEC_PARAMS)):
        raise ValueError(f"params: {params.shape[0]} planes")


# the wrapper's arguments that are previous-frame planes: whole frames under a mesh, while
# the current planes are a band of rows (`parallel.sharding.band_call`)
PREVIOUS_PLANES = ()


def history_fix(signal, view_z_in, normal_roughness, data1, fast_history, shared, params, smc,
                *, frustum, rect_size_inv, view_z_scale, ortho_mode, min_material, dc,
                anti_firefly=False, sh=None, directional=False, decoded=False, row0=0,
                frame_h=None):
    """signal (h, w, 4), or (h, w, 1) with the occlusion variants (no SH), data1 = accumulated
    frames (h, w), fast_history (h, w), shared float32
    planes named by SHARED (9, h, w), params named by PARAMS (5, h, w; diffuse) or PARAMS +
    SPEC_PARAMS (9, h, w; specular); smc (h, w): the specular magic curve of the roughness,
    None for diffuse; dc: the REBLUR frame constants (the clamp's). Returns dict(signal (of
    the input's shape), fast (h, w), geometry (h, w, 4)): the clamped signal, the fast history
    and the tap geometry; with the SH variants' `sh` (the signal's SH1, (h, w, 4)) also sh (h,
    w, 4); directional: REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION's clamp (diffuse, four channels,
    no SH); decoded: normal_roughness is the RGBA formats' decoded plane
    (`frontend.decode_normal_plane`, its roughness decoded; the kernel's kDec instances), else
    packed R10G10B10A2; row0, frame_h: the planes are the frame rows row0 .. row0 + h - 1 of a
    frame frame_h high (a band of `parallel.shard_stencil`; default the whole frame)."""
    global launches, dec_launches
    kw = dict(frustum=frustum, rect_size_inv=rect_size_inv, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, min_material=min_material, dc=dc,
              anti_firefly=anti_firefly, sh=sh, directional=directional, decoded=decoded,
              row0=row0, frame_h=frame_h)
    check_params(shared, params)
    spec = params.shape[0] != len(PARAMS)
    if (smc is None) == spec:
        raise ValueError("smc: the specular magic curve for the specular mode, None for diffuse")
    c = build.channels("signal", signal, sh)
    if directional and (spec or c != 4 or sh is not None):
        raise ValueError("directional: the diffuse four-channel signal, without SH")
    dev = build.kernel_device(signal)
    if dev is None:
        return history_fix_ref(signal, view_z_in, normal_roughness, data1, fast_history, shared,
                               params, smc, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("signal", signal, (h, w, c)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)), ("data1", data1, (h, w)),
           ("fast_history", fast_history, (h, w)), ("shared", shared, (len(SHARED), h, w)),
           ("params", params, (params.shape[0], h, w))]
    if spec:
        ins.append(("smc", smc, (h, w)))
    if sh is not None:
        ins.append(("sh", sh, (h, w, 4)))
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((h, w, c), dtype=f32, device=dev)
    fast = torch.empty((h, w), dtype=f32, device=dev)
    geometry = torch.empty((h, w, 4), dtype=f32, device=dev)  # the taps' geometry
    out_sh = None if sh is None else torch.empty((h, w, 4), dtype=f32, device=dev)
    consts = [*frustum, rect_size_inv[0], rect_size_inv[1], view_z_scale, ortho_mode,
              min_material, spec, anti_firefly, P.history_fix_frame_div(dc),
              P.fast_history_enabled(dc), sh is not None, c == 1, directional, decoded, row0,
              h if frame_h is None else frame_h]
    build.launch("nrd_history_fix", [t for _, t, _ in ins[:7]] + [smc, out, fast, geometry,
                                                                 sh, out_sh],
                 consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    res = dict(signal=out, fast=fast, geometry=geometry)
    if sh is not None:
        res["sh"] = out_sh
    return res
