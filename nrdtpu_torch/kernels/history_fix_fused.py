"""REBLUR history fix of both signals in one launch - kernel `csrc/history_fix_fused.cu` (N5).

Replaces `nrdtpu/kernels/reblur_fused.py:668` (`history_fix_fused_pallas`, K3), run once a
frame by REBLUR_DIFFUSE_SPECULAR. One thread per pixel runs, for the diffuse and then the
specular signal, what `history_fix` (H3) runs for one: the 20 stride taps at the signal's own
stride with diffuse or specular weights and its own min material, the 3x3 moments of its fast
history and, where asked for that signal, the anti-firefly ring (`nrdtpu/passes/reblur/
kernels.py:546-552`, `:629-719`, the two per-signal XLA calls). The centre pixel's `shared`
planes are loaded once; the per-signal work is H3's own device functions
(`csrc/reblur_filters.cuh`). The fast-history clamp chain after the taps stays in the glue
(`nrdtpu_torch/passes/reblur/kernels.py:_history_fix_clamp`), where the TPU kernel runs it
inside (`reblur_fused.py:76-113`); the result is the XLA one either way.

Not carried over from the TPU kernel: the hat-blended stride levels, bf16 windows, the zeroed
stride of sky pixels and the performance-mode ring radius of 3 (`reblur_fused.py:754`).

Bound on the H100: gathers. Per pixel at 2560x1440 it reads 9 shared and 5 + 9 per-signal
planes, both signals, accumulation speeds and fast histories, and up to 2 x 20 taps (pixels
with stride 0 skip them); writes 32 B + 8 or 16 B of moments a signal.
"""

from __future__ import annotations

import torch

from . import build
from . import history_fix as hf

launches = 0

SIGNALS = ("diff", "spec")


def history_fix_fused_ref(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1,
                          diff_fast, spec_fast, shared, diff_params, spec_params, *, frustum,
                          rect_size_inv, view_z_scale, ortho_mode, diff_min_material,
                          spec_min_material, anti_firefly=(False, False)):
    """Plain version: H3's plain version run once per signal."""
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
        out.update(_named(name, res))
    return out


def _named(name, res):
    keys = ("", "_m1", "_m2", "_am1", "_am2")
    return {name + k: v for k, v in zip(keys, res)}


def history_fix_fused(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1,
                      diff_fast, spec_fast, shared, diff_params, spec_params, *, frustum,
                      rect_size_inv, view_z_scale, ortho_mode, diff_min_material,
                      spec_min_material, anti_firefly=(False, False)):
    """diff, spec (h, w, 4); *_data1, *_fast (h, w); shared (9, h, w) named by
    history_fix.SHARED; diff_params (5, h, w) named by history_fix.PARAMS, spec_params (9, h,
    w) by PARAMS + SPEC_PARAMS; anti_firefly: (diffuse, specular) ring flags. Returns
    dict(diff, diff_m1, diff_m2[, diff_am1, diff_am2], spec, spec_m1, ...)."""
    global launches
    kw = dict(frustum=frustum, rect_size_inv=rect_size_inv, view_z_scale=view_z_scale,
              ortho_mode=ortho_mode, diff_min_material=diff_min_material,
              spec_min_material=spec_min_material, anti_firefly=tuple(anti_firefly))
    hf.check_params(shared, diff_params)
    hf.check_params(shared, spec_params)
    if diff_params.shape[0] != len(hf.PARAMS) or spec_params.shape[0] == len(hf.PARAMS):
        raise ValueError("diff_params takes the diffuse planes, spec_params the specular ones")
    dev = build.kernel_device(diff)
    if dev is None:
        return history_fix_fused_ref(diff, spec, view_z_in, normal_roughness, diff_data1,
                                     spec_data1, diff_fast, spec_fast, shared, diff_params,
                                     spec_params, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("diff", diff, (h, w, 4)), ("spec", spec, (h, w, 4)), ("diff_data1", diff_data1, (h, w)),
           ("spec_data1", spec_data1, (h, w)), ("diff_fast", diff_fast, (h, w)),
           ("spec_fast", spec_fast, (h, w)),
           ("diff_params", diff_params, (diff_params.shape[0], h, w)),
           ("spec_params", spec_params, (spec_params.shape[0], h, w)),
           ("view_z_in", view_z_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4)),
           ("shared", shared, (len(hf.SHARED), h, w))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((2, h, w, 4), dtype=f32, device=dev)
    moments = torch.empty((2, 4, h, w), dtype=f32, device=dev)
    consts = [*frustum, rect_size_inv[0], rect_size_inv[1], view_z_scale, ortho_mode,
              diff_min_material, spec_min_material, *map(bool, anti_firefly)]
    build.launch("nrd_history_fix_fused", [t for _, t, _ in ins] + [out, moments], consts, w, h)
    launches += 1
    res = {}
    for s, name in enumerate(SIGNALS):
        n = 4 if anti_firefly[s] else 2
        res.update(_named(name, (out[s], *moments[s, :n])))
    return res
