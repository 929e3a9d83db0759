"""REBLUR spatial-filter tap loops of both signals in one launch - kernel
`csrc/spatial_filter_fused.cu` (N4).

Replaces `nrdtpu/kernels/reblur_fused.py:787` (`spatial_filter_fused_pallas`, K2), run three
times a frame by REBLUR_DIFFUSE_SPECULAR: PrePass, Blur and PostBlur. One CTA per (16x16 tile,
signal) runs the diffuse mode of `spatial_filter` (H2) or its specular mode (or specular
PrePass mode, with the stochastic hitDistForTracking), each signal at its own scaled-rotator
tap positions with its own weights, accumulators and min material, exactly as the two
per-signal XLA calls compute them (`diffuse_pre_pass` / `diffuse_spatial_filter` and
`specular_spatial_filter`, `nrdtpu/passes/reblur/kernels.py:844-873`, `:2164-2189`,
`:1710-1756`). Its inputs are the glue's parameter planes, as the TPU kernel's are. The tap
loop is H2's own device function (`csrc/reblur_filters.cuh:sf_filter`) over the compile-time
Poisson table. The Blur and PostBlur take the frame's tap geometry (`geometry`, the (h, w, 4)
plane that N5 returns) and read each texel's unpacked normal and viewZ from it; the PrePass,
which runs before N5, takes none and unpacks the packed normal at every tap.

The checkerboard PrePass (`cb`; `FSig.has_cb`, `reblur_fused.py:153-158`) gives each signal's
centre the weight has_data, which the kernel computes from the pixel's position, the frame
index and the mode's parity; the parameter planes already read the centre signal zeroed where
it has no data (`params.diff_spatial_params` / `spec_spatial_params` on the zeroed signal, as
JAX's `_fused_diff_params` / `_fused_spec_params`). Where a signal's weight sum is 0 the kernel
writes that signal's horizontal neighbour resolve (`spatial_filter.cb_neighbor_resolve`), which
JAX applies as glue after K2 (`nrdtpu/passes/reblur/kernels.py:1977-1986`).

With the SH variants (`sh`, both signals' SH1) each signal's SH rides its taps as in H2's SH
mode (TPU `FSig.has_sh`, `reblur_fused.py:775-777`, `:804`): the diffuse sum of all four
channels, the specular sum of three with the centre's .w kept.

With the occlusion variants (Blur and PostBlur; they run no PrePass) each signal is the (h, w,
1) hit distance: the one-channel instance reads and writes one float a pixel a signal, and the
parameter planes (`params.diff_spatial_params(occlusion=True)`) carry the min hit-distance
weight without its sqrt(nlas).

Not carried over from the TPU kernel: the shared static tap lattice and hat-blended radius
levels (`reblur_fused.py:17-20`), bf16 windows, and the zeroed radius of sky pixels.

Bound on the H100: gathers. Per pixel at 2560x1440 it reads 8 shared planes, 8 + 10 (15 in
the PrePass) per-signal planes, both centre signals and 2 x 8 taps of viewZ, packed normal and
signal (16 x 36 B; 16 x 48 B from the geometry plane), and writes 32 B (+ 4 B hdt): ~130-170
B/px of compulsory traffic.
"""

from __future__ import annotations

import torch

from .. import math as nm
from .. import vec3 as v3
from ..ops import resample
from . import build
from . import spatial_filter as sf

launches = 0
cb_launches = 0  # of them, the checkerboard PrePass instance


def cb_centre(view_z_in, nv3, *, frustum, view_z_scale, ortho_mode,
              min_rect_dim_mul_unproject):
    """(scaled viewZ, frustum size, nov) of each pixel from its view-space normal nv3, as
    `params.filter_geometry` computes them: what the checkerboard fallback reads, as the
    kernel's `cb_centre` computes it where a weight sum is 0."""
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    view_z = torch.abs(view_z_in) * view_z_scale
    xv3 = v3.reconstruct_view_position(uv[..., 0], uv[..., 1], frustum, view_z, ortho_mode)
    vv3 = (v3.normalize(v3.V3(-xv3.x, -xv3.y, -xv3.z)) if ortho_mode == 0.0
           else v3.V3.full_like(view_z, 0.0, 0.0, -1.0))
    return (view_z, nm.get_frustum_size(min_rect_dim_mul_unproject, ortho_mode, view_z),
            torch.abs(v3.dot(nv3, vv3)))


def spatial_filter_fused_ref(diff, spec, view_z_in, normal_roughness, shared, diff_params,
                             spec_params, *, frustum, rect_size, view_z_scale, ortho_mode,
                             diff_min_material, spec_min_material, perf_mode, prepass=None,
                             geometry=None, cb=None, sh=None):
    """Plain version: H2's tap loop (`spatial_filter.taps_ref`) run once per signal (the tap
    geometry it computes from normal_roughness and view_z_in, the values of `geometry`); under
    checkerboard with each signal's has-data plane and fallback (`spatial_filter.cb_ref`)."""
    sh = (None, None) if sh is None else sh
    kw = dict(frustum=frustum, rect_size=rect_size, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, perf_mode=perf_mode)
    cbs = dict(diff=None, spec=None)
    if cb is not None:
        centre = cb_centre(view_z_in, v3.V3(shared[5], shared[6], shared[7]),
                              frustum=frustum, view_z_scale=view_z_scale,
                              ortho_mode=ortho_mode,
                              min_rect_dim_mul_unproject=cb["min_rect_dim_mul_unproject"])
        cbs = {name: sf.cb_ref(sig, *centre, frame_index=prepass["frame_index"],
                               parity=cb["parity"], denoising_range=cb["denoising_range"])
               for name, sig in (("diff", diff), ("spec", spec))}
    out = {}
    res = sf.taps_ref(diff, view_z_in, normal_roughness, shared, diff_params,
                      min_material=diff_min_material, cb=cbs["diff"], sh=sh[0], **kw)
    if sh[0] is None:
        out["diff"] = res
    else:
        out["diff"], out["diff_sh"] = res
    res = sf.taps_ref(spec, view_z_in, normal_roughness, shared, spec_params,
                      min_material=spec_min_material, prepass=prepass, cb=cbs["spec"], sh=sh[1],
                      **kw)
    res = res if isinstance(res, tuple) else (res,)
    out["spec"] = res[0]
    if prepass is not None:
        out["hdt"] = res[1]
    if sh[1] is not None:
        out["spec_sh"] = res[-1]
    return out


def spatial_filter_fused(diff, spec, view_z_in, normal_roughness, shared, diff_params,
                         spec_params, *, frustum, rect_size, view_z_scale, ortho_mode,
                         diff_min_material, spec_min_material, perf_mode, prepass=None,
                         geometry=None, cb=None, sh=None):
    """diff, spec (h, w, 4), or (h, w, 1) each with the occlusion variants (Blur and PostBlur,
    no SH); shared (8, h, w) planes named by spatial_filter.SHARED;
    diff_params (8, h, w) named by spatial_filter.PARAMS; spec_params (10 | 15, h, w) named by
    PARAMS + SPEC_PARAMS (+ PREPASS_PARAMS, with `prepass` as for spatial_filter); geometry:
    the frame's tap geometry (h, w, 4) from history_fix_fused, required in Blur and PostBlur
    mode, None in PrePass mode; cb: in a checkerboard PrePass dict(parity: the mode's has-data
    parity, int(CheckerboardMode) - 1; denoising_range; min_rect_dim_mul_unproject), the
    signals expanded from half width and the parameter planes computed on the centre signals
    zeroed where they have no data; else None; sh: with the SH variants the (diffuse,
    specular) SH1, (h, w, 4) each, not under checkerboard. Returns dict(diff, spec[, hdt][,
    diff_sh, spec_sh])."""
    global launches, cb_launches
    sh = None if sh is None else tuple(sh)
    kw = dict(frustum=frustum, rect_size=rect_size, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, diff_min_material=diff_min_material,
              spec_min_material=spec_min_material, perf_mode=perf_mode, prepass=prepass,
              geometry=geometry, cb=cb, sh=sh)
    if sh is not None and (len(sh) != 2 or any(t is None for t in sh) or cb is not None):
        raise ValueError("sh: the SH1 of both signals, and not under checkerboard")
    if sf.MODES.get(diff_params.shape[0]) != "diffuse":
        raise ValueError(f"diff_params: {diff_params.shape[0]} planes")
    if sf.MODES.get(spec_params.shape[0]) not in ("spec", "spec_prepass"):
        raise ValueError(f"spec_params: {spec_params.shape[0]} planes")
    prepass_mode = sf.check_params(spec_params, prepass)
    if prepass_mode != (geometry is None):
        raise ValueError("geometry: the tap-geometry plane goes with Blur and PostBlur, not "
                         "with the PrePass")
    if cb is not None and (not prepass_mode or cb["parity"] not in (0, 1)):
        raise ValueError(f"cb: {cb!r}; the checkerboard parity (0 or 1) goes with the PrePass")
    c = build.channels("diff", diff, sh)
    if c == 1 and prepass_mode:
        raise ValueError("the one-channel (occlusion) signals go with Blur and PostBlur")
    dev = build.kernel_device(diff)
    if dev is None:
        return spatial_filter_fused_ref(diff, spec, view_z_in, normal_roughness, shared,
                                        diff_params, spec_params, **kw)
    h, w = view_z_in.shape
    ins = [("diff", diff, (h, w, c)), ("spec", spec, (h, w, c)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)),
           ("shared", shared, (len(sf.SHARED), h, w)),
           ("diff_params", diff_params, (diff_params.shape[0], h, w)),
           ("spec_params", spec_params, (spec_params.shape[0], h, w))]
    if not prepass_mode:
        ins.append(("geometry", geometry, (h, w, 4)))
    if sh is not None:
        ins += [("diff_sh", sh[0], (h, w, 4)), ("spec_sh", sh[1], (h, w, 4))]
    for name, t, shape in ins:
        build.check(name, t, dev, torch.float32, shape)
    out = torch.empty((2, h, w, c), dtype=torch.float32, device=dev)
    hdt = torch.empty((h, w) if prepass_mode else (1,), dtype=torch.float32, device=dev)
    out_sh = None if sh is None else torch.empty((2, h, w, 4), dtype=torch.float32, device=dev)
    consts = [*frustum, rect_size[0], rect_size[1], view_z_scale, ortho_mode, diff_min_material,
              spec_min_material, sf.ntaps(perf_mode), spec_params.shape[0], sh is not None, c == 1]
    if prepass_mode:
        consts += sf.prepass_consts(prepass)
        consts += ([-1, 0.0, 0.0] if cb is None else
                   [cb["parity"], cb["denoising_range"], cb["min_rect_dim_mul_unproject"]])
    build.launch("nrd_spatial_filter_fused",
                 [t for _, t, _ in ins[:7]] + [geometry, out, hdt] + list(sh or (None, None))
                 + [out_sh], consts, w, h)
    launches += 1
    cb_launches += cb is not None
    res = dict(diff=out[0], spec=out[1])
    if prepass_mode:
        res["hdt"] = hdt
    if sh is not None:
        res.update(diff_sh=out_sh[0], spec_sh=out_sh[1])
    return res
