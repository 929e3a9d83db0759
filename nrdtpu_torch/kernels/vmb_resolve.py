"""Virtual-motion footprint resolve + specular history sampling - kernel
`csrc/vmb_resolve.cu`.

Replaces `nrdtpu/kernels/reblur_pallas.py:779` (`reblur_vmb_resolve`). Computes, per pixel,
every gather of `temporal_accumulation_specular` at the virtual-motion position, with the
XLA semantics (`nrdtpu/passes/reblur/kernels.py:1163-1174`, `:1272-1310`, `:1338-1340`,
`:1457-1462`):

  - the 2x2 roughness weights of the previous packed normals and their bilinear sum,
    `virtual_roughness_confidence`;
  - the 2x2 plane-distance occlusion against the previous viewZ, gated by the roughness
    weight and the material test; fbits bits 4-7 (`fbits_vmb`), the raw footprint quality
    and the bilinear-custom specular accumulation speed;
  - allow-CatRom (all four taps and the surface-motion footprint), the CatRom-13 /
    bilinear-custom specular history, the bilinear-custom fast history, and the plain
    bilinear previous hitDistForTracking;
  - with the SH variants (`sh_history`, bf16), the specular SH history as the fast history:
    bilinear with the virtual-motion occlusion weights, never the CatRom (`:1491-1494`; the
    TPU kernel's `n_sh`, `reblur_pallas.py:800`, `:829-830`);
  - with the occlusion variants, the (h, w, 1) bf16 hit-distance history through the same
    CatRom in one channel (the kernel's one-channel instance, `vmb_resolve_occ_kernel`).

At the RGBA normal encodings (`decoded=True`) the previous plane is the one that the frame
decodes once (`frontend.decode_normal_plane`, its roughness decoded): the roughness weights read
.w and the footprint tests no material (the kernels' `kDec` instances; the TPU kernel's
mat_occ=False, `reblur_pallas.py:798`).

The TPU kernel's block-base residual and its `valid` mask are not carried over.

Bound on the H100: gathers. Per pixel at 2560x1440 it reads 14 parameter planes (56 B), 4
previous viewZ, packed normal, material and accumulation taps (64 B), 13 x 4 bf16 history
taps, 4 fast-history and 4 hitDist taps near the reprojected position, and writes 44 B;
device-memory traffic is near ~150 B/px. One thread per pixel in 16x16 blocks with plain
global loads; the CatRom and bilinear-custom helpers are H1's (`csrc/common.cuh`).
"""

from __future__ import annotations

import torch

from .. import math as nm
from ..ops import resample
from . import build

launches = 0
dec_launches = 0  # of them, the instances on the decoded plane of the RGBA formats (kDec)

# params planes, in order (the pass glue stacks them)
PARAMS = ("nox_curr", "vmb_thr", "nx", "ny", "nz", "vvx", "vvy", "vvz", "ra", "rb",
          "roughness_sigma", "parallax_sm", "material_id", "smb_allow_catrom")
PLANES = ("rough_conf", "fbits_vmb", "footprint_raw", "accum_raw", "allow_catrom", "fast",
          "hdt_prev")


def _pack(history, planes):
    out = {name: planes[k] for k, name in enumerate(PLANES)}
    out["allow_catrom"] = out["allow_catrom"] > 0.5
    out["history"] = history
    return out


def vmb_resolve_ref(vmb_uv, params, prev_view_z, prev_normal_roughness, prev_material_id,
                    prev_accum, history, fast_history, prev_hdt, *, view_z_scale, ortho_mode,
                    rect_size_prev, min_material, resolution_scale_prev, sh_history=None,
                    decoded=False):
    """Plain PyTorch version of the kernel (the XLA formulas, gather by gather)."""
    p = dict(zip(PARAMS, params))
    origin, frac = nm.bilinear_filter(vmb_uv, rect_size_prev)
    bw = nm.bilinear_weights(frac)
    in_screen = resample.is_in_screen_bilinear(origin, rect_size_prev)
    z_taps = resample.gather_2x2(prev_view_z, origin)
    nr_taps = resample.gather_2x2(prev_normal_roughness, origin)
    mat_taps = resample.gather_2x2(prev_material_id, origin)
    mat_c = torch.clamp_min(p["material_id"], min_material)

    rough_w, occ = [], []
    for k in range(4):
        r_t = nr_taps[k][..., 3 if decoded else 2]
        w_ = nm.compute_non_exponential_weight_with_sigma(r_t * r_t, p["ra"], p["rb"],
                                                          p["roughness_sigma"])
        rough_w.append(nm.lerp(p["parallax_sm"], 1.0, w_))
        z_t = torch.abs(z_taps[k]) * view_z_scale
        zscale = z_t if ortho_mode == 0.0 else ortho_mode
        nox_prev = (p["nx"] * p["vvx"] + p["ny"] * p["vvy"]) * zscale + p["nz"] * p["vvz"] * z_t
        plane_dist = torch.abs(nox_prev - p["nox_curr"])
        o = (plane_dist <= p["vmb_thr"] * in_screen[..., k] - 1e-6).to(torch.float32)
        o = o * (rough_w[k] >= 0.5).to(torch.float32)
        if not decoded:  # the RGBA formats carry no material
            o = o * (mat_c == torch.clamp_min(mat_taps[k], min_material)).to(torch.float32)
        occ.append(o)
    rough_w4 = torch.stack(rough_w, -1)
    occ4 = torch.stack(occ, -1)
    rough_conf = torch.sum(rough_w4 * bw, -1)
    fbits_vmb = occ4[..., 0] * 16.0 + occ4[..., 1] * 32.0 + occ4[..., 2] * 64.0 \
        + occ4[..., 3] * 128.0
    weights = nm.get_bilinear_custom_weights(frac, occ4)
    accum_raw = resample.bilinear_custom(prev_accum, origin, weights)
    footprint_raw = torch.sum(occ4 * bw, -1)
    allow_catrom = (torch.sum(occ4, -1) > 3.5) & (p["smb_allow_catrom"] > 0.5)

    sample_pos = nm.scale2(nm.saturate(vmb_uv), rect_size_prev[0], rect_size_prev[1])
    hist = resample.sample_catrom(history.float(), sample_pos, allow_catrom, weights)
    fast = resample.bilinear_custom(fast_history.float(), torch.floor(sample_pos - 0.5),
                                    weights)
    hdt_prev = resample.sample_bilinear(prev_hdt, nm.scale2(vmb_uv, resolution_scale_prev[0],
                                                            resolution_scale_prev[1]))
    planes = torch.stack([rough_conf, fbits_vmb, footprint_raw, accum_raw,
                          allow_catrom.to(torch.float32), fast, hdt_prev])
    out = _pack(hist, planes)
    if sh_history is not None:
        out["sh"] = resample.bilinear_custom(sh_history.float(), torch.floor(sample_pos - 0.5),
                                             weights)
    return out


def vmb_resolve(vmb_uv, params, prev_view_z, prev_normal_roughness, prev_material_id,
                prev_accum, history, fast_history, prev_hdt, *, view_z_scale, ortho_mode,
                rect_size_prev, min_material, resolution_scale_prev, sh_history=None,
                decoded=False):
    """vmb_uv (h, w, 2), params (14, h, w) float32 planes named by PARAMS; the previous
    frame's viewZ, packed normals, material, specular accumulation speed, bf16 specular
    history (h, w, 4), or (h, w, 1) with the occlusion variants, and fast history, and
    hitDistForTracking; sh_history: with the SH variants the bf16 specular SH history (h, w,
    4); decoded: prev_normal_roughness is the RGBA formats' decoded plane (the kernels' kDec
    instances: no material test), else packed R10G10B10A2. Returns dict(history (h, w, 4) or
    (h, w, 1), allow_catrom (bool), the (h, w) planes named by PLANES, and with sh_history sh
    (h, w, 4))."""
    global launches, dec_launches
    kw = dict(view_z_scale=view_z_scale, ortho_mode=ortho_mode, rect_size_prev=rect_size_prev,
              min_material=min_material, resolution_scale_prev=resolution_scale_prev,
              sh_history=sh_history, decoded=decoded)
    dev = build.kernel_device(vmb_uv)
    if dev is None:
        return vmb_resolve_ref(vmb_uv, params, prev_view_z, prev_normal_roughness,
                               prev_material_id, prev_accum, history, fast_history, prev_hdt,
                               **kw)
    h, w = prev_view_z.shape
    f32, bf16 = torch.float32, torch.bfloat16
    c = build.channels("history", history, sh_history)
    ins = [("vmb_uv", vmb_uv, f32, (h, w, 2)), ("params", params, f32, (len(PARAMS), h, w)),
           ("prev_view_z", prev_view_z, f32, (h, w)),
           ("prev_normal_roughness", prev_normal_roughness, f32, (h, w, 4)),
           ("prev_material_id", prev_material_id, f32, (h, w)),
           ("prev_accum", prev_accum, f32, (h, w)), ("history", history, bf16, (h, w, c)),
           ("fast_history", fast_history, bf16, (h, w)), ("prev_hdt", prev_hdt, f32, (h, w))]
    if sh_history is not None:
        ins.append(("sh_history", sh_history, bf16, (h, w, 4)))
    for name, t, dt, shape in ins:
        build.check(name, t, dev, dt, shape)
    out_hist = torch.empty((h, w, c), dtype=f32, device=dev)
    planes = torch.empty((len(PLANES), h, w), dtype=f32, device=dev)
    out_sh = None if sh_history is None else torch.empty((h, w, 4), dtype=f32, device=dev)
    consts = [view_z_scale, ortho_mode, rect_size_prev[0], rect_size_prev[1], min_material,
              resolution_scale_prev[0], resolution_scale_prev[1], sh_history is not None, c == 1,
              decoded]
    build.launch("nrd_vmb_resolve", [t for _, t, _, _ in ins[:9]] + [out_hist, planes]
                 + [sh_history, out_sh], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    out = _pack(out_hist, planes)
    if sh_history is not None:
        out["sh"] = out_sh
    return out
