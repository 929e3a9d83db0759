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

Not carried over from the TPU kernel: the shared static tap lattice and hat-blended radius
levels (`reblur_fused.py:17-20`), bf16 windows, and the zeroed radius of sky pixels.

Bound on the H100: gathers. Per pixel at 2560x1440 it reads 8 shared planes, 8 + 10 (15 in
the PrePass) per-signal planes, both centre signals and 2 x 8 taps of viewZ, packed normal and
signal (16 x 36 B; 16 x 48 B from the geometry plane), and writes 32 B (+ 4 B hdt): ~130-170
B/px of compulsory traffic.
"""

from __future__ import annotations

import torch

from . import build
from . import spatial_filter as sf

launches = 0


def spatial_filter_fused_ref(diff, spec, view_z_in, normal_roughness, shared, diff_params,
                             spec_params, *, frustum, rect_size, view_z_scale, ortho_mode,
                             diff_min_material, spec_min_material, perf_mode, prepass=None,
                             geometry=None):
    """Plain version: H2's plain version run once per signal (the tap geometry it computes
    from normal_roughness and view_z_in, the values of `geometry`)."""
    kw = dict(frustum=frustum, rect_size=rect_size, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, perf_mode=perf_mode)
    out = dict(diff=sf.spatial_filter_ref(diff, view_z_in, normal_roughness, shared, diff_params,
                                          min_material=diff_min_material, **kw))
    res = sf.spatial_filter_ref(spec, view_z_in, normal_roughness, shared, spec_params,
                                min_material=spec_min_material, prepass=prepass, **kw)
    if prepass is None:
        out["spec"] = res
    else:
        out["spec"], out["hdt"] = res
    return out


def spatial_filter_fused(diff, spec, view_z_in, normal_roughness, shared, diff_params,
                         spec_params, *, frustum, rect_size, view_z_scale, ortho_mode,
                         diff_min_material, spec_min_material, perf_mode, prepass=None,
                         geometry=None):
    """diff, spec (h, w, 4); shared (8, h, w) planes named by spatial_filter.SHARED;
    diff_params (8, h, w) named by spatial_filter.PARAMS; spec_params (10 | 15, h, w) named by
    PARAMS + SPEC_PARAMS (+ PREPASS_PARAMS, with `prepass` as for spatial_filter); geometry:
    the frame's tap geometry (h, w, 4) from history_fix_fused, required in Blur and PostBlur
    mode, None in PrePass mode. Returns dict(diff, spec[, hdt])."""
    global launches
    kw = dict(frustum=frustum, rect_size=rect_size, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, diff_min_material=diff_min_material,
              spec_min_material=spec_min_material, perf_mode=perf_mode, prepass=prepass,
              geometry=geometry)
    if sf.MODES.get(diff_params.shape[0]) != "diffuse":
        raise ValueError(f"diff_params: {diff_params.shape[0]} planes")
    if sf.MODES.get(spec_params.shape[0]) not in ("spec", "spec_prepass"):
        raise ValueError(f"spec_params: {spec_params.shape[0]} planes")
    prepass_mode = sf.check_params(spec_params, prepass)
    if prepass_mode != (geometry is None):
        raise ValueError("geometry: the tap-geometry plane goes with Blur and PostBlur, not "
                         "with the PrePass")
    dev = build.kernel_device(diff)
    if dev is None:
        return spatial_filter_fused_ref(diff, spec, view_z_in, normal_roughness, shared,
                                        diff_params, spec_params, **kw)
    h, w = view_z_in.shape
    ins = [("diff", diff, (h, w, 4)), ("spec", spec, (h, w, 4)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)),
           ("shared", shared, (len(sf.SHARED), h, w)),
           ("diff_params", diff_params, (diff_params.shape[0], h, w)),
           ("spec_params", spec_params, (spec_params.shape[0], h, w))]
    if not prepass_mode:
        ins.append(("geometry", geometry, (h, w, 4)))
    for name, t, shape in ins:
        build.check(name, t, dev, torch.float32, shape)
    out = torch.empty((2, h, w, 4), dtype=torch.float32, device=dev)
    hdt = torch.empty((h, w) if prepass_mode else (1,), dtype=torch.float32, device=dev)
    consts = [*frustum, rect_size[0], rect_size[1], view_z_scale, ortho_mode, diff_min_material,
              spec_min_material, sf.ntaps(perf_mode), spec_params.shape[0]]
    if prepass_mode:
        consts += sf.prepass_consts(prepass)
    build.launch("nrd_spatial_filter_fused",
                 [t for _, t, _ in ins[:7]] + [geometry, out, hdt], consts, w, h)
    launches += 1
    res = dict(diff=out[0], spec=out[1])
    if prepass_mode:
        res["hdt"] = hdt
    return res
