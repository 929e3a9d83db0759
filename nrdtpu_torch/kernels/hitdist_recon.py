"""REBLUR hit-distance reconstruction - kernel `csrc/hitdist_recon.cu` (K12).

Replaces `nrdtpu/kernels/reblur_pallas.py:1596` (`hitdist_recon_pallas`). Computes the XLA
function `nrdtpu/passes/reblur/kernels.py:2212-2293`: where a signal's hit distance is 0 (a
pixel the renderer traced no hit for), it is refilled from the (2r+1)^2 neighbourhood, r = 1
(AREA_3X3) or 2 (AREA_5X5), centre excluded. A non-zero centre keeps its value through a
1000x weight. Each tap is weighted by in-screen (strict `0 < uv < 1`, as XLA's
`is_in_screen_nearest`; the TPU kernel's own test is not carried over), a Gaussian of |o|/2,
the plane distance to the centre's plane, the normal angle (the signal's normal-weight
parameter) and, for specular, the roughness^2 weight; zero taps weigh 0. Diffuse, specular or
both in one launch. The kernel computes the centre's parameters (`centre_params`) from viewZ,
the packed normal and the frame constants, and writes each signal whole: .xyz copied, .w
reconstructed. The occlusion variants' signals are (h, w, 1), the hit distance alone: the
kernel's one-channel instances read and write one float a pixel. The roughness is unpacked
with the roughness encoding, a template parameter of the kernel; at the RGBA normal encodings
(`decoded=`) the kernel reads the decoded plane (its kDec instances: RELAX's and REBLUR's
four-channel calls, and REBLUR's occlusion variants on one channel, whose plane has its
roughness decoded too, so their instances are LINEAR only). REBLUR and RELAX (its raw hit
distance) both call it.

Bound on the H100: memory. Per pixel at 2560x1440 it reads viewZ (4 B), the packed normal
(16 B) and each signal (16 B), and writes each signal (16 B): 52 B/px with one signal, 84 B/px
with both. Each CTA stages its (16 + 2r)^2 window of derived texels (normal, scaled viewZ,
decoded roughness, each signal's hit distance) in shared memory, where the taps read them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from ..settings import RoughnessEncoding
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instances (kDec)
MAX_TAPS = 24  # the kernel's Gaussian slots, radius 2's taps
# (dy, dx, Gaussian weight of |o|/2) of each tap, row by row, for radius 1 and 2
TAPS = {r: [(dy, dx, nm.get_gaussian_weight(float((dx * dx + dy * dy) ** 0.5) * 0.5))
            for dy, dx in stencil.offsets_square(r, exclude_center=True)] for r in (1, 2)}


def centre_params(view_z_in, normal_roughness, has_diff, has_spec, *, view_z_scale, frustum,
                  ortho_mode, world_to_view, min_rect_dim_mul_unproject, plane_dist_sensitivity,
                  enc_err, roughness_encoding=RoughnessEncoding.LINEAR, decoded=False):
    """(P, h, w) = ga, gb, then the diffuse normal-weight parameter if has_diff, then the
    specular one, ra and rb if has_spec: the centre's parameters that the kernel computes per
    pixel, in the XLA function's op order (`kernels.py:2212-2254`)."""
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    view_z = torch.abs(view_z_in) * view_z_scale
    n, roughness, _ = fe.unpack_normal_plane(normal_roughness, decoded, roughness_encoding)
    nv = nm.rotate_vector(world_to_view, n)
    xv = nm.reconstruct_view_position(uv, frustum, view_z, ortho_mode)
    frustum_size = nm.get_frustum_size(min_rect_dim_mul_unproject, ortho_mode, view_z)
    ones = torch.ones_like(view_z)
    params = list(nm.get_geometry_weight_params(plane_dist_sensitivity, frustum_size, xv, nv))
    if has_diff:
        params.append(nm.get_normal_weight_param(ones, 1.0, ones, enc_err))
    if has_spec:
        ra, rb = nm.get_relaxed_roughness_weight_params(roughness * roughness)
        params += [nm.get_normal_weight_param(ones, 1.0, roughness, enc_err), ra, rb]
    return torch.stack(params)


def hitdist_recon_ref(view_z_in, normal_roughness, diff, spec, *, radius, view_z_scale, frustum,
                      ortho_mode, rect_size_inv, world_to_view, min_rect_dim_mul_unproject,
                      plane_dist_sensitivity, enc_err,
                      roughness_encoding=RoughnessEncoding.LINEAR, decoded=False):
    """Plain PyTorch version of the kernel: the centre's parameters (`centre_params`), the tap
    loop of the XLA function, and each signal with its reconstructed hit distance. diff, spec:
    (h, w, 4) or (h, w, 1) signals or None, the hit distance the last channel. Returns
    {signal: its shape}."""
    h, w = view_z_in.shape
    params = centre_params(
        view_z_in, normal_roughness, diff is not None, spec is not None,
        view_z_scale=view_z_scale, frustum=frustum, ortho_mode=ortho_mode,
        world_to_view=world_to_view, min_rect_dim_mul_unproject=min_rect_dim_mul_unproject,
        plane_dist_sensitivity=plane_dist_sensitivity, enc_err=enc_err,
        roughness_encoding=roughness_encoding, decoded=decoded)
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    view_z = torch.abs(view_z_in) * view_z_scale
    n, _, _ = fe.unpack_normal_plane(normal_roughness, decoded)
    nv = nm.rotate_vector(world_to_view, n)
    rest = iter(params[2:])
    ga, gb = params[0], params[1]
    sig = {}
    if diff is not None:
        sig["diff"] = dict(src=diff, hd=diff[..., -1], nwp=next(rest))
    if spec is not None:
        sig["spec"] = dict(src=spec, hd=spec[..., -1], nwp=next(rest), ra=next(rest),
                           rb=next(rest))
    for s in sig.values():
        s["sum"] = 1000.0 * (s["hd"] != 0.0).to(torch.float32)
        s["acc"] = s["hd"] * s["sum"]
    rinv = [float(v) for v in np.asarray(rect_size_inv, np.float32)]
    for dy, dx, gauss in TAPS[radius]:
        zs = stencil.shifted(view_z, dy, dx)
        nr_s = stencil.shifted(normal_roughness, dy, dx)
        ns, rs, _ = fe.unpack_normal_plane(nr_s, decoded, roughness_encoding)
        uv_s = torch.stack([uv[..., 0] + dx * rinv[0], uv[..., 1] + dy * rinv[1]], -1)
        xvs = nm.reconstruct_view_position(uv_s, frustum, zs, ortho_mode)
        w_ = resample.is_in_screen_nearest(uv_s)
        w_ = w_ * gauss
        w_ = w_ * nm.compute_weight(nm.dot(nv, xvs), ga, gb)
        angle = nm.acos_approx(nm.dot(n, ns))
        for name, s in sig.items():
            ws = w_ * nm.compute_exponential_weight(angle, s["nwp"], 0.0)
            if name == "spec":
                ws = ws * nm.compute_exponential_weight(rs * rs, s["ra"], s["rb"])
            tap = stencil.shifted(s["hd"], dy, dx)
            ws = ws * (tap != 0.0).to(torch.float32)
            s["acc"] = s["acc"] + tap * ws
            s["sum"] = s["sum"] + ws
    return {name: torch.cat([s["src"][..., :-1],
                             (s["acc"] / torch.clamp_min(s["sum"], fe.NRD_EPS))[..., None]], -1)
            for name, s in sig.items()}


def hitdist_recon(view_z_in, normal_roughness, diff, spec, *, radius, view_z_scale, frustum,
                  ortho_mode, rect_size_inv, world_to_view, min_rect_dim_mul_unproject,
                  plane_dist_sensitivity, enc_err, roughness_encoding=RoughnessEncoding.LINEAR,
                  decoded=False):
    """view_z_in (h, w), normal_roughness (h, w, 4), diff / spec (h, w, 4), or (h, w, 1) with
    the occlusion variants, or None (at least one given, both of one shape); radius 1 or 2; the
    frame constants of `centre_params`; roughness_encoding: how the packed roughness is
    unpacked; decoded: normal_roughness is the RGBA formats' decoded plane
    (`frontend.decode_normal_plane`, the kernel's kDec instances; with one-channel signals at
    LINEAR only), else packed R10G10B10A2. Returns {"diff": ..., "spec": ...} for the signals
    given, each of its input's shape with its reconstructed hit distance."""
    global launches, dec_launches
    kw = dict(radius=radius, view_z_scale=view_z_scale, frustum=frustum, ortho_mode=ortho_mode,
              rect_size_inv=rect_size_inv, world_to_view=world_to_view,
              min_rect_dim_mul_unproject=min_rect_dim_mul_unproject,
              plane_dist_sensitivity=plane_dist_sensitivity, enc_err=enc_err,
              roughness_encoding=roughness_encoding, decoded=decoded)
    if diff is None and spec is None:
        raise ValueError("hitdist_recon: no signal given")
    dev = build.kernel_device(view_z_in)
    if dev is None:
        return hitdist_recon_ref(view_z_in, normal_roughness, diff, spec, **kw)
    if radius not in (1, 2):
        raise ValueError(f"radius {radius}: the kernel takes 1 (3x3) or 2 (5x5)")
    h, w = view_z_in.shape
    f32 = torch.float32
    given = [(name, s) for name, s in (("diff", diff), ("spec", spec)) if s is not None]
    c = build.channels(*given[0])
    if decoded and c == 1 and roughness_encoding != RoughnessEncoding.LINEAR:
        raise ValueError("decoded one-channel signals: the plane's roughness is decoded, LINEAR")
    ins = [("view_z_in", view_z_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4))]
    ins += [(name, s, (h, w, c)) for name, s in given]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = {name: torch.empty((h, w, c), dtype=f32, device=dev) for name, _ in given}
    gauss = [g for _, _, g in TAPS[radius]]
    m = np.asarray(world_to_view, np.float32)[:3, :3].reshape(-1)
    consts = [radius, diff is not None, spec is not None, view_z_scale, *_v(frustum),
              ortho_mode, *_v(rect_size_inv), *m, build.ROUGHNESS_MODE[roughness_encoding],
              min_rect_dim_mul_unproject, plane_dist_sensitivity, enc_err, c == 1, *gauss,
              *[0.0] * (MAX_TAPS - len(gauss)), decoded]
    build.launch("nrd_hitdist_recon", [view_z_in, normal_roughness, diff, spec, out.get("diff"),
                                       out.get("spec")], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    return out


def _v(x):
    return [float(c) for c in np.asarray(x, np.float32).reshape(-1)]
