"""RELAX virtual-motion loader - kernel `csrc/relax_vmb_resolve.cu` (K17).

Replaces `nrdtpu/kernels/relax_pallas.py:1219` (`relax_vmb_resolve`). Computes, per pixel,
the gathers of `temporal_accumulation`'s loadVirtualMotionBasedPrevData as XLA does them
(`nrdtpu/passes/relax/kernels.py:742-796`):

  - the 2x2 footprint at the virtual-motion uv: each previous texel's world position in the
    previous camera (its texel-centre uv, the previous frustum vectors), tested by plane
    distance |(x - camera_delta - x_prev) . n| against the per-tap in-screen threshold, and
    its material against `spec_min_material` (at R10G10B10A2: the RGBA formats carry no
    material, `decoded=`); `any` and `all` of the four;
  - the specular slow and responsive histories at uv_vmb x rect_prev through the CatRom
    footprint where the surface-motion footprint was bicubic and all four taps pass, else
    with the custom bilinear weights (`sample_catrom`, the code K16 uses);
  - the previous reflection hitT and the packed previous normal/roughness, plain bilinear at
    uv_vmb x resolution_scale_prev;
  - with the SH variants (`sh_history`, `sh_responsive_history`), the bf16 specular SH slow
    and responsive histories, `resample.bilinear_custom(sh, vmb_origin, vmb_custom_w)`
    (`:992-995`): the custom-weight bilinear at the 2x2, never the CatRom (the TPU kernel's
    `sh_prev` / `sh_resp_prev`, `relax_pallas.py:1222`, `:1246-1249`).

The TPU kernel's block-base capture (`relax_pallas.py:1239-1241`) is not carried over: the
footprint is each pixel's own.

Bound on the H100: gathers. Per pixel it reads the uv, the normal, x - delta, the threshold,
the packed current normal and smb_found (56 B), 4 previous viewZ and material taps (32 B), 4
taps of the reflection hitT and of the packed previous normal (80 B) and the 12 texels of the
CatRom-12 footprint of two (h, w, 4) histories (mostly shared with the neighbours); it writes
3 x 16 B and 3 planes; with SH two bf16 2x2 footprints (2 x 32 B) more read and 2 x 16 B
written. Both histories go through one loop over the footprint's 5 bilinear
samples, each texel read as one float4 for both and only where its weight is non-zero
(`csrc/common.cuh:catrom_apply4`), and every (h, w, 4) output is one float4 store.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample
from ..passes import relax as RC
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instances (kDec)
SIGNALS = ("spec_vmb", "spec_vmb_resp", "nr_packed")
PLANES = ("hit_t", "any", "all")
TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx) of the 2x2


def relax_vmb_resolve_ref(uv_vmb, n, x_minus_delta, threshold_base, normal_roughness,
                          smb_found, prev_view_z, prev_material_id, prev_reflection_hit_t,
                          prev_normal_roughness, spec_history, spec_responsive_history,
                          sh_history=None, sh_responsive_history=None, *, prev_frustum,
                          ortho_mode, view_z_scale, rect_size_prev, resolution_scale_prev,
                          min_material, decoded=False):
    """Plain PyTorch version of the kernel (the XLA formulas, gather by gather)."""
    rw, rh = (float(v) for v in rect_size_prev)
    origin, frac = nm.bilinear_filter(uv_vmb, rect_size_prev)
    in_screen = resample.is_in_screen_bilinear(origin, rect_size_prev)
    vx0 = resample.to_index(origin[..., 0])
    vy0 = resample.to_index(origin[..., 1])
    mat_c = torch.clamp_min(fe.unpack_normal_plane(normal_roughness, decoded)[2], min_material)
    valid = []
    for k, (dy, dx) in enumerate(TAPS):
        zp = torch.abs(resample.texel_fetch(prev_view_z, vx0 + dx, vy0 + dy)) * view_z_scale
        tap_uv = torch.stack([nm.div((vx0 + dx).to(torch.float32) + 0.5, rw),
                              nm.div((vy0 + dy).to(torch.float32) + 0.5, rh)], -1)
        xp = RC.world_pos(prev_frustum, ortho_mode, tap_uv, zp)
        thr = threshold_base * in_screen[..., k] - fe.NRD_EPS
        ok = (torch.abs(nm.dot(x_minus_delta - xp, n)) <= thr).to(torch.float32)
        mp = resample.texel_fetch(prev_material_id, vx0 + dx, vy0 + dy)
        valid.append(ok * (mat_c == torch.clamp_min(mp, min_material)).to(torch.float32))
    valid4 = torch.stack(valid, -1)
    any_ = (valid4 > 0.0).any(-1)
    all_ = (valid4 > 0.0).all(-1)
    custom_w = nm.get_bilinear_custom_weights(frac, valid4)
    use_bicubic = (smb_found == 2.0) & all_
    pos = nm.scale2(uv_vmb, rw, rh)
    uv_res = nm.scale2(uv_vmb, float(resolution_scale_prev[0]), float(resolution_scale_prev[1]))
    out = {}
    if sh_history is not None:
        out = dict(sh_vmb=resample.bilinear_custom(sh_history, origin, custom_w),
                   sh_vmb_resp=resample.bilinear_custom(sh_responsive_history, origin, custom_w))
    return dict(
        spec_vmb=resample.sample_catrom(spec_history, pos, use_bicubic, custom_w),
        spec_vmb_resp=resample.sample_catrom(spec_responsive_history, pos, use_bicubic,
                                             custom_w),
        nr_packed=resample.sample_bilinear(prev_normal_roughness, uv_res),
        hit_t=resample.sample_bilinear(prev_reflection_hit_t, uv_res),
        any=any_.to(torch.float32), all=all_.to(torch.float32), **out)


def relax_vmb_resolve(uv_vmb, n, x_minus_delta, threshold_base, normal_roughness, smb_found,
                      prev_view_z, prev_material_id, prev_reflection_hit_t,
                      prev_normal_roughness, spec_history, spec_responsive_history,
                      sh_history=None, sh_responsive_history=None, *, prev_frustum, ortho_mode,
                      view_z_scale, rect_size_prev, resolution_scale_prev, min_material,
                      decoded=False):
    """uv_vmb (h, w, 2) virtual-motion uv; n and x_minus_delta (h, w, 3) the TA's normal and
    world position minus the camera delta; threshold_base (h, w) the disocclusion threshold
    x viewZ (x 1 in ortho); normal_roughness (h, w, 4) current (material in .w);
    smb_found (h, w) K16's (2 where its footprint was bicubic); the previous raw viewZ,
    material id, reflection hitT (h, w), packed normal/roughness (h, w, 4) and the specular
    slow and responsive histories (h, w, 4); prev_frustum = the previous camera's 9 floats
    right, up, forward; with the SH variants sh_history and sh_responsive_history, the
    specular SH histories (h, w, 4) bfloat16; decoded: normal_roughness is the RGBA formats'
    decoded plane (`frontend.decode_normal_plane`, the kernel's kDec instances: no material
    test). Returns dict(spec_vmb, spec_vmb_resp, nr_packed
    (h, w, 4), hit_t, any, all (h, w), any / all as 0 or 1), and with the SH histories
    sh_vmb, sh_vmb_resp (h, w, 4) float32."""
    global launches, dec_launches
    kw = dict(prev_frustum=prev_frustum, ortho_mode=ortho_mode, view_z_scale=view_z_scale,
              rect_size_prev=rect_size_prev, resolution_scale_prev=resolution_scale_prev,
              min_material=min_material, decoded=decoded)
    args = (uv_vmb, n, x_minus_delta, threshold_base, normal_roughness, smb_found, prev_view_z,
            prev_material_id, prev_reflection_hit_t, prev_normal_roughness, spec_history,
            spec_responsive_history)
    sh = (sh_history, sh_responsive_history)
    if (sh_history is None) != (sh_responsive_history is None):
        raise ValueError("sh_history and sh_responsive_history come together")
    dev = build.kernel_device(normal_roughness)
    if dev is None:
        return relax_vmb_resolve_ref(*args, *sh, **kw)
    h, w = threshold_base.shape
    shapes = ((h, w, 2), (h, w, 3), (h, w, 3), (h, w), (h, w, 4), (h, w), (h, w), (h, w),
              (h, w), (h, w, 4), (h, w, 4), (h, w, 4))
    names = ("uv_vmb", "n", "x_minus_delta", "threshold_base", "normal_roughness", "smb_found",
             "prev_view_z", "prev_material_id", "prev_reflection_hit_t",
             "prev_normal_roughness", "spec_history", "spec_responsive_history")
    for name, t, shape in zip(names, args, shapes):
        build.check(name, t, dev, torch.float32, shape)
    sig = torch.empty((len(SIGNALS), h, w, 4), dtype=torch.float32, device=dev)
    planes = torch.empty((len(PLANES), h, w), dtype=torch.float32, device=dev)
    sh_out = None
    if sh_history is not None:
        for name, t in zip(("sh_history", "sh_responsive_history"), sh):
            build.check(name, t, dev, torch.bfloat16, (h, w, 4))
        sh_out = torch.empty((2, h, w, 4), dtype=torch.float32, device=dev)
    consts = [*prev_frustum, ortho_mode, view_z_scale, rect_size_prev[0], rect_size_prev[1],
              resolution_scale_prev[0], resolution_scale_prev[1], min_material, decoded]
    build.launch("nrd_relax_vmb_resolve", [*args, sig, planes, *sh, sh_out], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    out = dict(zip(SIGNALS, sig), **dict(zip(PLANES, planes)))
    if sh_out is not None:
        out.update(sh_vmb=sh_out[0], sh_vmb_resp=sh_out[1])
    return out
