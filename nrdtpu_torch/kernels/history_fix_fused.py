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
and the fast histories; the moments stay in the kernel. With the SH variants (`sh`, both
signals' SH1) each signal's SH rides its taps and is scaled to its clamped luma, as H3's SH
mode (TPU `reblur_fused.py:683`, `:721-722`). With the occlusion variants both signals are
(h, w, 1) hit distances, each clamped as its own luma with sigma scale 1, as H3's one-channel
mode (TPU `occlusion`, `reblur_fused.py:671`, `_hfix_post :76-108`).

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

from ..passes.reblur import params as P
from . import build
from . import history_fix as hf
from .history_fix import tap_geometry_ref

launches = 0
dec_launches = 0  # of them, the instances on the decoded plane of the RGBA formats (kDec)

SIGNALS = ("diff", "spec")


def history_fix_fused_ref(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1,
                          diff_fast, spec_fast, shared, diff_params, spec_params, smc, *,
                          frustum, rect_size_inv, view_z_scale, ortho_mode, diff_min_material,
                          spec_min_material, dc, anti_firefly=(False, False), sh=None,
                          decoded=False):
    """Plain version: H3's plain version (the taps and the clamp) of each signal, and the tap
    geometry."""
    kw = dict(frustum=frustum, rect_size_inv=rect_size_inv, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, dc=dc, decoded=decoded)
    sh = (None, None) if sh is None else sh
    out = {}
    for k, (name, sig, data1, fast, params, smc_, mm) in enumerate((
            ("diff", diff, diff_data1, diff_fast, diff_params, None, diff_min_material),
            ("spec", spec, spec_data1, spec_fast, spec_params, smc, spec_min_material))):
        res = hf.taps_and_clamp_ref(sig, view_z_in, normal_roughness, data1, fast, shared,
                                    params, smc_, min_material=mm, anti_firefly=anti_firefly[k],
                                    sh=sh[k], **kw)
        out[name], out[name + "_fast"] = res[:2]
        if sh[k] is not None:
            out[name + "_sh"] = res[2]
    out["geometry"] = tap_geometry_ref(normal_roughness, view_z_in, view_z_scale, decoded)
    return out


def history_fix_fused(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1,
                      diff_fast, spec_fast, shared, diff_params, spec_params, smc, *, frustum,
                      rect_size_inv, view_z_scale, ortho_mode, diff_min_material,
                      spec_min_material, dc, anti_firefly=(False, False), sh=None,
                      decoded=False):
    """diff, spec (h, w, 4), or (h, w, 1) each with the occlusion variants (no SH); *_data1,
    *_fast (h, w); shared (9, h, w) named by history_fix.SHARED; diff_params (5, h, w) named
    by history_fix.PARAMS, spec_params (9, h, w) by PARAMS + SPEC_PARAMS; smc (h, w) the specular magic curve; dc: the REBLUR frame
    constants (the clamp's); anti_firefly: (diffuse, specular) ring flags; sh: with the SH
    variants the (diffuse, specular) SH1, (h, w, 4) each; decoded: normal_roughness is the RGBA
    formats' decoded plane (`frontend.decode_normal_plane`, its roughness decoded; the kernel's
    kDec instances), else packed R10G10B10A2. Returns dict(diff, spec, diff_fast, spec_fast,
    geometry[, diff_sh, spec_sh]): the clamped signals, the fast histories, the frame's tap
    geometry (h, w, 4) and the SH after the history fix."""
    global launches, dec_launches
    sh = None if sh is None else tuple(sh)
    kw = dict(frustum=frustum, rect_size_inv=rect_size_inv, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, diff_min_material=diff_min_material,
              spec_min_material=spec_min_material, dc=dc, anti_firefly=tuple(anti_firefly),
              sh=sh, decoded=decoded)
    if sh is not None and (len(sh) != 2 or any(t is None for t in sh)):
        raise ValueError("sh: the SH1 of both signals")
    hf.check_params(shared, diff_params)
    hf.check_params(shared, spec_params)
    if diff_params.shape[0] != len(hf.PARAMS) or spec_params.shape[0] == len(hf.PARAMS):
        raise ValueError("diff_params takes the diffuse planes, spec_params the specular ones")
    c = build.channels("diff", diff, sh)
    dev = build.kernel_device(diff)
    if dev is None:
        return history_fix_fused_ref(diff, spec, view_z_in, normal_roughness, diff_data1,
                                     spec_data1, diff_fast, spec_fast, shared, diff_params,
                                     spec_params, smc, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("diff", diff, (h, w, c)), ("spec", spec, (h, w, c)), ("diff_data1", diff_data1, (h, w)),
           ("spec_data1", spec_data1, (h, w)), ("diff_fast", diff_fast, (h, w)),
           ("spec_fast", spec_fast, (h, w)),
           ("diff_params", diff_params, (diff_params.shape[0], h, w)),
           ("spec_params", spec_params, (spec_params.shape[0], h, w)),
           ("view_z_in", view_z_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4)),
           ("shared", shared, (len(hf.SHARED), h, w)), ("smc", smc, (h, w))]
    sh_ins = [] if sh is None else [("diff_sh", sh[0], (h, w, 4)), ("spec_sh", sh[1], (h, w, 4))]
    for name, t, shape in ins + sh_ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((2, h, w, c), dtype=f32, device=dev)
    fast = torch.empty((2, h, w), dtype=f32, device=dev)
    geometry = torch.empty((h, w, 4), dtype=f32, device=dev)
    out_sh = None if sh is None else torch.empty((2, h, w, 4), dtype=f32, device=dev)
    consts = [*frustum, rect_size_inv[0], rect_size_inv[1], view_z_scale, ortho_mode,
              diff_min_material, spec_min_material, *map(bool, anti_firefly),
              P.history_fix_frame_div(dc), P.fast_history_enabled(dc), sh is not None, c == 1,
              decoded]
    build.launch("nrd_history_fix_fused", [t for _, t, _ in ins] + [out, fast, geometry]
                 + list(sh or (None, None)) + [out_sh], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    res = dict(diff=out[0], spec=out[1], diff_fast=fast[0], spec_fast=fast[1],
               geometry=geometry)
    if sh is not None:
        res.update(diff_sh=out_sh[0], spec_sh=out_sh[1])
    return res
