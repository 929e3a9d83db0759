"""RELAX surface-motion loader - kernel `csrc/relax_smb_resolve.cu` (K16).

Replaces `nrdtpu/kernels/relax_pallas.py:1000` (`relax_smb_resolve`). Computes, per pixel, the
gathers of `temporal_accumulation`'s loadSurfaceMotionBasedPrevData
(`nrdtpu/passes/relax/kernels.py:376-389`, `:426`, `:485-549`, `:580-583`) as XLA does them:

  - the current 3x3 normal average (unit length, for the backface test);
  - the 4x4 previous viewZ and material taps around the reprojected footprint, rooted at
    bilinear_origin - 1 with clamp addressing, tested against the per-quad in-screen
    thresholds (`:485-516`); bicubic where all 12 non-corner taps pass;
  - the backface test against the previous normal, bilinear at the footprint centre
    ((origin + 1) / resource size, `:519-529`), rotated into this frame;
  - the history length, bilinear with the custom weights (`:543-549`), + 1, at most 255;
  - the footprint quality before its refinements (1 for bicubic, else the custom weights'
    sum; 0 where no tap is valid) and smb_found (2 bicubic, 1 bilinear, 0 none);
  - `sample_catrom(history, uv_smb x rect_prev, use_bicubic, custom_w)` of every history
    plane set given (`:580-583`, `:805-808`): the slow and the responsive history of each
    signal, four histories with both signals (JAX's `hist_planes` order: diffuse, then
    specular);
  - with the specular signal (`spec_hit` and `prev_reflection_hit_t` given, `:376-394`,
    `:809-814`): the un-normalised 3x3 normal average (h, w, 3), the 3x3 min of the current
    specular hitT (0 counts as NRD_INF) and the previous reflection hitT, bilinear with the
    custom weights at the footprint's 2x2;
  - with the SH variants (`sh_histories`), the bf16 SH histories, the slow and the responsive
    one of each signal: `resample.bilinear_custom(sh, bilinear_origin, custom_w)` (`:607-610`,
    `:988-991`), the custom-weight bilinear even where the footprint is bicubic, never the
    CatRom (the TPU kernel's `bil_planes`, `relax_pallas.py:1003`, `:1028-1035`).

The TPU kernel's block-base + tent-residual capture (`relax_pallas.py:1020-1022`,
`:847-851`) is not carried over: the footprint is each pixel's own.

Bound on the H100: gathers. Per pixel it reads the current packed normal (and with the
specular signal the hitT) of a 3x3 neighbourhood, 12 previous viewZ and 12 material taps
around the footprint, 4 previous packed normals and 4 history lengths, and the 12 texels of
the CatRom-12 footprint of each (h, w, 4) history (mostly shared with the neighbours); it
writes 3 planes (8 with the specular signal) and 16 B per history; each SH history adds its
2x2 (4 x 8 B of bf16) read and 16 B written. One kernel instance per
mode (the specular planes, the number of histories); each CTA decodes its 18x18 window of
current normals once into shared memory, and all histories go through one loop over the
footprint's 5 bilinear samples, each texel read as one float4 and only where its weight is
non-zero: the footprint's 12 texels each once where the samples land on their texels
(`csrc/common.cuh:catrom_apply4`, the plain version's arithmetic, operation for operation).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from ..passes import relax as RC
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instances (kDec)
PLANES = ("history_length", "footprint_quality", "smb_found")
SPEC_PLANES = ("n_avg_x", "n_avg_y", "n_avg_z", "min_hit", "reflection_hit_t")
CORNERS = ((0, 0), (3, 0), (0, 3), (3, 3))  # (x, y) inside the 4x4


def relax_smb_resolve_ref(smb_uv, xv_prev_z, base_threshold, normal_roughness, prev_view_z,
                          prev_material_id, prev_history_length, prev_normal_roughness,
                          histories, spec_hit=None, prev_reflection_hit_t=None, sh_histories=(),
                          *, view_z_scale, rect_size_prev, resource_size, min_material,
                          world_prev_to_world, decoded=False):
    """Plain PyTorch version of the kernel (the XLA formulas, gather by gather)."""
    n_avg = torch.zeros_like(normal_roughness[..., :3])
    if spec_hit is not None:
        min_hit = torch.where(spec_hit == 0.0, fe.NRD_INF, spec_hit)
    for dy, dx in stencil.offsets_square(1):
        n_avg = n_avg + fe.unpack_normal_plane(stencil.shifted(normal_roughness, dy, dx),
                                               decoded)[0]
        if spec_hit is not None and (dy, dx) != (0, 0):
            h_ = stencil.shifted(spec_hit, dy, dx)
            min_hit = torch.minimum(min_hit, torch.where(h_ == 0.0, fe.NRD_INF, h_))
    n_avg = nm.div(n_avg, 9.0)
    n_avg_unit = nm.normalize(n_avg)

    origin, frac = nm.bilinear_filter(smb_uv, rect_size_prev)
    in_screen4 = resample.is_in_screen_bilinear(origin, rect_size_prev)
    quad_thr = [base_threshold * in_screen4[..., q] - fe.NRD_EPS for q in range(4)]
    x0 = resample.to_index(origin[..., 0]) - 1
    y0 = resample.to_index(origin[..., 1]) - 1
    mat_c = torch.clamp_min(fe.unpack_normal_plane(normal_roughness, decoded)[2], min_material)
    occ = [[None] * 4 for _ in range(4)]
    for j in range(4):
        for i in range(4):
            q = (1 if i >= 2 else 0) + (2 if j >= 2 else 0)
            z = torch.abs(resample.texel_fetch(prev_view_z, x0 + i, y0 + j)) * view_z_scale
            ok = (torch.abs(z - xv_prev_z) <= quad_thr[q]).to(torch.float32)
            mat = resample.texel_fetch(prev_material_id, x0 + i, y0 + j)
            occ[j][i] = ok * (mat_c == torch.clamp_min(mat, min_material)).to(torch.float32)
    occ12 = sum(occ[j][i] for j in range(4) for i in range(4) if (i, j) not in CORNERS)
    bicubic_valid = (occ12 > 11.5).to(torch.float32)
    bilinear_valid = torch.stack([occ[1][1], occ[1][2], occ[2][1], occ[2][2]], -1)

    rw, rh = (float(v) for v in np.asarray(resource_size, np.float32))
    center_uv = torch.stack([nm.div(origin[..., 0] + 1.0, rw), nm.div(origin[..., 1] + 1.0, rh)],
                            -1)
    prev_normal, _ = RC.unpack_prev_normal_roughness(
        resample.sample_bilinear(prev_normal_roughness, center_uv))
    prev_normal = nm.rotate_vector(world_prev_to_world, prev_normal)
    backface = nm.dot(n_avg_unit, prev_normal) < 0.0
    bilinear_valid = torch.where(backface[..., None], 0.0, bilinear_valid)
    bicubic_valid = torch.where(backface, 0.0, bicubic_valid)

    custom_w = nm.get_bilinear_custom_weights(frac, bilinear_valid)
    use_bicubic = bicubic_valid > 0.0
    any_valid = (bilinear_valid > 0.0).any(-1)
    smb_found = torch.where(any_valid, torch.where(use_bicubic, 2.0, 1.0), 0.0)
    quality = torch.where(use_bicubic, 1.0, torch.sum(custom_w, -1))
    quality = torch.where(any_valid, quality, 0.0)

    taps = [resample.texel_fetch(prev_history_length, x0 + 1 + dx, y0 + 1 + dy)[..., None]
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
    history_length = nm.apply_bilinear_custom_weights(*taps, custom_w)[..., 0]
    history_length = torch.clamp_max(history_length + 1.0, 255.0)

    sample_pos = nm.scale2(smb_uv, float(rect_size_prev[0]), float(rect_size_prev[1]))
    hist = torch.stack([resample.sample_catrom(img, sample_pos, use_bicubic, custom_w)
                        for img in histories])
    out = dict(history_length=history_length, footprint_quality=quality, smb_found=smb_found,
               histories=hist)
    if sh_histories:
        out["sh"] = torch.stack([resample.bilinear_custom(img, origin, custom_w)
                                 for img in sh_histories])
    if spec_hit is not None:
        taps = [resample.texel_fetch(prev_reflection_hit_t, x0 + 1 + dx, y0 + 1 + dy)[..., None]
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
        out.update(n_avg=n_avg, min_hit=min_hit,
                   reflection_hit_t=nm.apply_bilinear_custom_weights(*taps, custom_w)[..., 0])
    return out


def relax_smb_resolve(smb_uv, xv_prev_z, base_threshold, normal_roughness, prev_view_z,
                      prev_material_id, prev_history_length, prev_normal_roughness, histories,
                      spec_hit=None, prev_reflection_hit_t=None, sh_histories=(), *,
                      view_z_scale, rect_size_prev, resource_size, min_material,
                      world_prev_to_world, decoded=False):
    """smb_uv (h, w, 2) surface-motion uv; xv_prev_z, base_threshold (h, w) from the glue;
    normal_roughness (h, w, 4) current; the previous frame's raw viewZ, material id, history
    length (h, w) and 8-bit packed normal/roughness (h, w, 4); histories: a sequence of
    (h, w, 4) float32 history planes sampled with the same footprint; for the specular
    signal, spec_hit (h, w) the PrePass's hitT and prev_reflection_hit_t (h, w); with the SH
    variants sh_histories: as many (h, w, 4) bfloat16 SH histories as histories (2 or 4), in
    the same order; decoded: normal_roughness is the RGBA formats' decoded plane
    (`frontend.decode_normal_plane`, the kernel's kDec instances: no material test), else
    packed R10G10B10A2. Returns dict(history_length, footprint_quality, smb_found (h, w),
    histories (k, h, w, 4)), with the specular signal n_avg (h, w, 3), min_hit and
    reflection_hit_t (h, w), and with SH histories sh (k, h, w, 4) float32."""
    global launches, dec_launches
    kw = dict(view_z_scale=view_z_scale, rect_size_prev=rect_size_prev,
              resource_size=resource_size, min_material=min_material,
              world_prev_to_world=world_prev_to_world, decoded=decoded)
    histories, sh_histories = tuple(histories), tuple(sh_histories)
    if sh_histories and (len(sh_histories) != len(histories) or len(histories) not in (2, 4)):
        raise ValueError(f"sh_histories: {len(sh_histories)} planes, one a history of 2 or 4")
    dev = build.kernel_device(normal_roughness)
    if dev is None:
        return relax_smb_resolve_ref(smb_uv, xv_prev_z, base_threshold, normal_roughness,
                                     prev_view_z, prev_material_id, prev_history_length,
                                     prev_normal_roughness, histories, spec_hit,
                                     prev_reflection_hit_t, sh_histories, **kw)
    h, w = xv_prev_z.shape
    if not 1 <= len(histories) <= 4:
        raise ValueError(f"histories: {len(histories)} planes, 1 to 4 supported")
    f32 = torch.float32
    ins = [("smb_uv", smb_uv, (h, w, 2)), ("xv_prev_z", xv_prev_z, (h, w)),
           ("base_threshold", base_threshold, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)), ("prev_view_z", prev_view_z, (h, w)),
           ("prev_material_id", prev_material_id, (h, w)),
           ("prev_history_length", prev_history_length, (h, w)),
           ("prev_normal_roughness", prev_normal_roughness, (h, w, 4))]
    spec = spec_hit is not None
    if spec != (prev_reflection_hit_t is not None):
        raise ValueError("spec_hit and prev_reflection_hit_t come together")
    if spec:
        ins += [("spec_hit", spec_hit, (h, w)),
                ("prev_reflection_hit_t", prev_reflection_hit_t, (h, w))]
    hist_ins = [(f"histories[{k}]", t, (h, w, 4)) for k, t in enumerate(histories)]
    for name, t, shape in ins + hist_ins:
        build.check(name, t, dev, f32, shape)
    for k, t in enumerate(sh_histories):
        build.check(f"sh_histories[{k}]", t, dev, torch.bfloat16, (h, w, 4))
    nsh = len(sh_histories)
    sh = torch.empty((nsh, h, w, 4), dtype=f32, device=dev) if nsh else None
    names = PLANES + (SPEC_PLANES if spec else ())
    planes = torch.empty((len(names), h, w), dtype=f32, device=dev)
    hist = torch.empty((len(histories), h, w, 4), dtype=f32, device=dev)
    m = np.asarray(world_prev_to_world, np.float32)[:3, :3].reshape(-1)
    consts = [view_z_scale, rect_size_prev[0], rect_size_prev[1], resource_size[0],
              resource_size[1], min_material, *m, len(histories), spec, nsh, decoded]
    build.launch("nrd_relax_smb_resolve",
                 [t for _, t, _ in ins[:8]] + [planes, hist]
                 + [t for _, t, _ in hist_ins] + [None] * (4 - len(histories))
                 + ([spec_hit, prev_reflection_hit_t] if spec else [None, None])
                 + [sh, *sh_histories] + [None] * (4 - nsh),
                 consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    out = dict(zip(PLANES, planes), histories=hist)
    if nsh:
        out["sh"] = sh
    if spec:
        out.update(n_avg=planes[3:6].permute(1, 2, 0), min_hit=planes[6],
                   reflection_hit_t=planes[7])
    return out
