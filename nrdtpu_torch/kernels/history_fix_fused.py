"""REBLUR history fix of both signals, the fast-history clamp included, in one entry - kernel
`csrc/history_fix_fused.cu` (N5).

Replaces `nrdtpu/kernels/reblur_fused.py:668` (`history_fix_fused_pallas`, K3), run once a
frame by REBLUR_DIFFUSE_SPECULAR, which runs the clamp chain inside the kernel
(`reblur_fused.py:76-113`). For each signal it computes what `history_fix` computes
(`nrdtpu/passes/reblur/kernels.py:546-552`, `:629-732`, the two per-signal XLA calls): the 20
stride taps at the signal's own stride with diffuse or specular weights and its own min
material, the 3x3 moments of its fast history and, where asked for that signal, the
anti-firefly ring, then the clamp (`passes/reblur/params.py:history_fix_clamp`: the
fast-history mix, the ring's and the 3x3's luminance clamps). It returns the clamped signals
and the fast histories; the moments stay in the kernel.

The entry makes two launches on the caller's stream and counts one: a prologue that writes
each pixel's tap geometry (unpacked normal, scaled viewZ) into a (h, w, 4) plane, which the
entry returns for the Blur and PostBlur launches of N4 (`spatial_filter_fused`, `geometry=`);
then one CTA per (16x16 tile, signal) running the body that K23's phase 1 runs
(`csrc/reblur_filters.cuh:history_fix_cta`).

Not carried over from the TPU kernel: the hat-blended stride levels, bf16 windows, the zeroed
stride of sky pixels and the performance-mode ring radius of 3 (`reblur_fused.py:754`).

Bound on the H100: bytes. Per pixel at 2560x1440 it reads 9 shared planes, the specular magic
curve, 5 + 9 per-signal planes, both signals, accumulation speeds and fast histories, viewZ
and the packed normal (168 B), and writes both clamped signals, both fast histories and the
tap geometry (56 B); the 2 x 20 taps (pixels with stride 0 skip them) hit L1/L2.
"""

from __future__ import annotations

import torch

from .. import frontend as fe
from ..passes.reblur import params as P
from . import build
from . import history_fix as hf

launches = 0

SIGNALS = ("diff", "spec")


def tap_geometry_ref(normal_roughness, view_z_in, view_z_scale):
    """(h, w, 4): each pixel's unpacked normal and scaled viewZ, what a tap reads of its texel
    (`csrc/reblur_filters.cuh:unpacked_geometry`)."""
    n, _, _ = fe.unpack_normal_roughness(normal_roughness)
    return torch.cat([n, (torch.abs(view_z_in) * view_z_scale)[..., None]], -1)


def history_fix_fused_ref(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1,
                          diff_fast, spec_fast, shared, diff_params, spec_params, smc, *,
                          frustum, rect_size_inv, view_z_scale, ortho_mode, diff_min_material,
                          spec_min_material, dc, anti_firefly=(False, False)):
    """Plain version: per signal, H3's plain version, then `params.history_fix_clamp`."""
    kw = dict(frustum=frustum, rect_size_inv=rect_size_inv, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode)
    out = {}
    for name, sig, data1, fast, params, mm, af in (
            ("diff", diff, diff_data1, diff_fast, diff_params, diff_min_material,
             anti_firefly[0]),
            ("spec", spec, spec_data1, spec_fast, spec_params, spec_min_material,
             anti_firefly[1])):
        res = hf.history_fix_ref(sig, view_z_in, normal_roughness, data1, fast, shared, params,
                                 min_material=mm, anti_firefly=af, **kw)
        out[name], out[f"{name}_fast"] = P.history_fix_clamp(
            dc, dict(smc=smc), data1, res[0], fast, res[1], res[2], res[3:] if af else None,
            name == "diff")
    out["geometry"] = tap_geometry_ref(normal_roughness, view_z_in, view_z_scale)
    return out


def history_fix_fused(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1,
                      diff_fast, spec_fast, shared, diff_params, spec_params, smc, *, frustum,
                      rect_size_inv, view_z_scale, ortho_mode, diff_min_material,
                      spec_min_material, dc, anti_firefly=(False, False)):
    """diff, spec (h, w, 4); *_data1, *_fast (h, w); shared (9, h, w) named by
    history_fix.SHARED; diff_params (5, h, w) named by history_fix.PARAMS, spec_params (9, h,
    w) by PARAMS + SPEC_PARAMS; smc (h, w) the specular magic curve; dc: the REBLUR frame
    constants (the clamp's); anti_firefly: (diffuse, specular) ring flags. Returns dict(diff,
    spec, diff_fast, spec_fast, geometry): the clamped signals, the fast histories and the
    frame's tap geometry (h, w, 4)."""
    global launches
    kw = dict(frustum=frustum, rect_size_inv=rect_size_inv, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, diff_min_material=diff_min_material,
              spec_min_material=spec_min_material, dc=dc, anti_firefly=tuple(anti_firefly))
    hf.check_params(shared, diff_params)
    hf.check_params(shared, spec_params)
    if diff_params.shape[0] != len(hf.PARAMS) or spec_params.shape[0] == len(hf.PARAMS):
        raise ValueError("diff_params takes the diffuse planes, spec_params the specular ones")
    dev = build.kernel_device(diff)
    if dev is None:
        return history_fix_fused_ref(diff, spec, view_z_in, normal_roughness, diff_data1,
                                     spec_data1, diff_fast, spec_fast, shared, diff_params,
                                     spec_params, smc, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("diff", diff, (h, w, 4)), ("spec", spec, (h, w, 4)), ("diff_data1", diff_data1, (h, w)),
           ("spec_data1", spec_data1, (h, w)), ("diff_fast", diff_fast, (h, w)),
           ("spec_fast", spec_fast, (h, w)),
           ("diff_params", diff_params, (diff_params.shape[0], h, w)),
           ("spec_params", spec_params, (spec_params.shape[0], h, w)),
           ("view_z_in", view_z_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4)),
           ("shared", shared, (len(hf.SHARED), h, w)), ("smc", smc, (h, w))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((2, h, w, 4), dtype=f32, device=dev)
    fast = torch.empty((2, h, w), dtype=f32, device=dev)
    geometry = torch.empty((h, w, 4), dtype=f32, device=dev)
    consts = [*frustum, rect_size_inv[0], rect_size_inv[1], view_z_scale, ortho_mode,
              diff_min_material, spec_min_material, *map(bool, anti_firefly),
              P.history_fix_frame_div(dc), P.fast_history_enabled(dc)]
    build.launch("nrd_history_fix_fused", [t for _, t, _ in ins] + [out, fast, geometry], consts,
                 w, h)
    launches += 1
    return dict(diff=out[0], spec=out[1], diff_fast=fast[0], spec_fast=fast[1],
                geometry=geometry)
