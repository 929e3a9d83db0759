"""Surface-motion footprint resolve + history sampling - kernel `csrc/smb_resolve.cu`.

Replaces `nrdtpu/kernels/reblur_pallas.py:577` (`reblur_smb_resolve`). Computes, per pixel,
every gather of `surface_motion_reprojection` at the reprojected position
(`nrdtpu/passes/reblur/kernels.py:142-249`) and, in the same pass, the CatRom-13 sample of
the history (bilinear-custom fallback) and the bilinear-custom sample of the fast history
(`:451-456`):

  - the current 2x2 normal average and the previous one over the centre 2x2 of the
    footprint, weighted by in-range viewZ;
  - 4x4 previous viewZ and material taps, rooted at bilinear_origin - 1 with clamp
    addressing, tested against the per-quad threshold;
  - occlusion weights, fbits, allow_catrom, the accumulation speed of the signal being
    denoised (bilinear-custom: diff_accum or spec_accum) and the raw footprint-quality sum;
  - the two normal averages themselves, which the specular TA reads (`:398-411`).

With a second signal (`second=`, REBLUR_DIFFUSE_SPECULAR) the same launch samples both
signals' histories, fast histories and accumulation planes, the CatRom taps and bilinear
weights computed once; the footprint's outputs are written once. With the SH variants (`sh=`,
one bf16 SH history a signal) the same launch also samples each SH history as it samples the
fast history: bilinear with the occlusion-weighted custom weights at the footprint's 2x2,
never through the CatRom (`sample_history_bilinear`, `:473-476`; the TPU kernel's `bil_planes`,
`nrdtpu/kernels/reblur_pallas.py:580`, `:605`). With the occlusion variants each history is the
(h, w, 1) bf16 hit distance: the one-channel instances sample it through the same CatRom
footprint and write (nsig, h, w, 1) (the TPU kernel's `n_hist` planes at c = 1,
`nrdtpu/passes/reblur/denoiser.py:311-320`). At the RGBA normal encodings (`decoded=True`) the
current and previous planes are the ones that the frame decodes once
(`frontend.decode_normal_plane`): the normals are read from .xyz as they are and the footprint
tests no material (the kernel's `kDec` instances; the TPU kernel's mat_occ=False,
`reblur_pallas.py:603`).

Bound on the H100: gathers. Per pixel at 2560x1440 it reads 12 viewZ + 12 material taps
(96 B), 4 current (staged once a CTA) and 4 previous packed normals, 4 accumulation taps (16 B),
the history's CatRom footprint (12 bf16 records of 8 B where the samples land on their texels)
and 4 fast-history taps, mostly L1/L2-resident neighbourhood, for 68 B of output;
device-memory traffic is near the compulsory ~125 B/px (a second signal adds ~30 B/px, an SH
history the 2x2 of 8-byte bf16 texels and 16 B written). The
kernel is one instance per signal count, one thread per pixel in 16x16 CTAs, with the current
normals decoded once into a shared-memory window and every signal's history read through one
loop over the CatRom's 5 samples (`csrc/smb_resolve.cu`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from . import build

launches = 0
dec_launches = 0  # of them, the instances on the decoded planes of the RGBA formats (kDec)

CENTER_TAPS = ((1, 1), (2, 1), (1, 2), (2, 2))  # (x, y) of the bilinear 2x2 inside the 4x4
CORNER_TAPS = ((0, 0), (3, 0), (0, 3), (3, 3))
PLANES = ("fbits", "allow_catrom", "footprint_raw", "accum_speed", "fast")
PER_SIGNAL = ("history", "fast", "accum_speed")  # a second signal adds these, suffixed _2


def _pack(history, planes, navg):
    out = {name: planes[k] for k, name in enumerate(PLANES)}
    out["allow_catrom"] = out["allow_catrom"] > 0.5
    out["history"] = history
    out["n_avg"], out["smb_navg"] = navg[0], navg[1]
    return out


def smb_resolve_ref(smb_uv, xv_prev_z, base_threshold, navg_thr, normal_roughness,
                    prev_view_z, prev_normal_roughness, prev_material_id, prev_accum,
                    history, fast_history, *, view_z_scale, denoising_range,
                    rect_size_prev, min_material, world_prev_to_world, second=None, sh=None,
                    decoded=False):
    """Plain PyTorch version of the kernel (the XLA formulas, gather by gather); with a
    second signal, the one-signal version run per signal."""
    kw = dict(view_z_scale=view_z_scale, denoising_range=denoising_range,
              rect_size_prev=rect_size_prev, min_material=min_material,
              world_prev_to_world=world_prev_to_world, decoded=decoded)
    if second is not None:
        args = (smb_uv, xv_prev_z, base_threshold, navg_thr, normal_roughness, prev_view_z,
                prev_normal_roughness, prev_material_id)
        out = smb_resolve_ref(*args, prev_accum, history, fast_history,
                              sh=None if sh is None else sh[:1], **kw)
        two = smb_resolve_ref(*args, *second, sh=None if sh is None else sh[1:], **kw)
        out.update({k + "_2": two[k] for k in PER_SIGNAL + (("sh",) if sh is not None else ())})
        return out

    def unpack(p):
        return fe.unpack_normal_plane(p, decoded)[0]

    # current Navg over the 2x2 at offsets {-1, 0} (TA lines 70-97)
    n_avg = torch.zeros_like(normal_roughness[..., :3])
    for dy, dx in ((-1, -1), (-1, 0), (0, -1), (0, 0)):
        n_avg = n_avg + unpack(stencil.shifted(normal_roughness, dy, dx))
    n_avg = n_avg / 4.0

    origin, frac = nm.bilinear_filter(smb_uv, rect_size_prev)
    x0 = resample.to_index(origin[..., 0])
    y0 = resample.to_index(origin[..., 1])

    z_taps = [[torch.abs(resample.texel_fetch(prev_view_z, x0 - 1 + i, y0 - 1 + j))
               * view_z_scale for i in range(4)] for j in range(4)]

    smb_navg = torch.zeros_like(n_avg)
    wsum = torch.zeros_like(xv_prev_z)
    for tx, ty in CENTER_TAPS:
        w_ = (z_taps[ty][tx] < denoising_range).to(torch.float32)
        npv = unpack(resample.texel_fetch(prev_normal_roughness, x0 + tx - 1, y0 + ty - 1))
        smb_navg = smb_navg + npv * w_[..., None]
        wsum = wsum + w_
    smb_navg = smb_navg / torch.where(wsum == 0.0, 1.0, wsum)[..., None]
    smb_navg = nm.rotate_vector(world_prev_to_world, smb_navg)

    navg_ok = (nm.dot(smb_navg, n_avg) > navg_thr).to(torch.float32)
    in_screen4 = resample.is_in_screen_bilinear(origin, rect_size_prev)
    quad_threshold = [base_threshold * navg_ok * in_screen4[..., q] - fe.NRD_EPS
                      for q in range(4)]

    material_id = normal_roughness[..., 3] * 3.0
    mat_c = torch.clamp_min(material_id, min_material)
    occ = [[None] * 4 for _ in range(4)]
    for j in range(4):
        for i in range(4):
            q = (1 if i >= 2 else 0) + (2 if j >= 2 else 0)
            plane_dist = torch.abs(z_taps[j][i] - xv_prev_z)
            o = (plane_dist <= quad_threshold[q]).to(torch.float32)
            if not decoded:  # the RGBA formats carry no material
                mat = resample.texel_fetch(prev_material_id, x0 - 1 + i, y0 - 1 + j)
                o = o * (mat_c == torch.clamp_min(mat, min_material)).to(torch.float32)
            occ[j][i] = o

    occ_center = torch.stack([occ[ty][tx] for tx, ty in CENTER_TAPS], -1)
    weights = nm.get_bilinear_custom_weights(frac, occ_center)
    occ12_sum = sum(occ[j][i] for j in range(4) for i in range(4) if (i, j) not in CORNER_TAPS)
    allow_catrom = occ12_sum > 11.5
    fbits = (occ_center[..., 0] * 1.0 + occ_center[..., 1] * 2.0
             + occ_center[..., 2] * 4.0 + occ_center[..., 3] * 8.0)

    footprint_raw = torch.sum(occ_center * nm.bilinear_weights(frac), -1)

    sample_pos = nm.scale2(nm.saturate(smb_uv), rect_size_prev[0], rect_size_prev[1])
    hist = resample.sample_catrom(history.float(), sample_pos, allow_catrom, weights)
    fast = resample.bilinear_custom(fast_history.float(), torch.floor(sample_pos - 0.5),
                                    weights)
    accum_speed = resample.bilinear_custom(prev_accum, origin, weights)
    planes = torch.stack([fbits, allow_catrom.to(torch.float32), footprint_raw, accum_speed,
                          fast])
    out = _pack(hist, planes, torch.stack([n_avg, smb_navg]))
    if sh is not None:
        (sh_history,) = sh
        out["sh"] = resample.bilinear_custom(sh_history.float(), torch.floor(sample_pos - 0.5),
                                             weights)
    return out


def _check_sh(sh, nsig):
    if sh is not None and len(sh) != nsig:
        raise ValueError(f"sh: {len(sh)} SH histories for {nsig} signal(s); one a signal")


def smb_resolve(smb_uv, xv_prev_z, base_threshold, navg_thr, normal_roughness, prev_view_z,
                prev_normal_roughness, prev_material_id, prev_accum, history, fast_history,
                *, view_z_scale, denoising_range, rect_size_prev, min_material,
                world_prev_to_world, second=None, sh=None, decoded=False):
    """prev_accum: the previous accumulation speed of the signal whose history is sampled;
    history: its bf16 history, (h, w, 4), or (h, w, 1) with the occlusion variants.
    Returns dict(history (h, w, 4) or (h, w, 1), fast, fbits, allow_catrom (bool), footprint_raw,
    accum_speed, n_avg (h, w, 3), smb_navg (h, w, 3)). All planes share the (h, w) of the
    current frame;
    the previous-frame planes and the histories have the same size (rect = resource).
    second: (prev_accum, history, fast_history) of a second signal, sampled in the same
    launch; its results come as history_2, fast_2 and accum_speed_2. sh: with the SH variants
    the (h, w, 4) bf16 SH history of each signal (one or two), sampled in the same launch: sh
    (h, w, 4) float32, and sh_2 for the second signal. decoded: normal_roughness and
    prev_normal_roughness are the RGBA formats' decoded planes (the kernel's kDec instances),
    else packed R10G10B10A2."""
    global launches, dec_launches
    kw = dict(view_z_scale=view_z_scale, denoising_range=denoising_range,
              rect_size_prev=rect_size_prev, min_material=min_material,
              world_prev_to_world=world_prev_to_world, decoded=decoded)
    sh = None if sh is None else tuple(sh)
    _check_sh(sh, 1 if second is None else 2)
    c = build.channels("history", history, sh)
    dev = build.kernel_device(normal_roughness)
    if dev is None:
        return smb_resolve_ref(smb_uv, xv_prev_z, base_threshold, navg_thr, normal_roughness,
                               prev_view_z, prev_normal_roughness, prev_material_id,
                               prev_accum, history, fast_history, second=second, sh=sh, **kw)
    h, w = xv_prev_z.shape
    f32, bf16 = torch.float32, torch.bfloat16
    ins = [("smb_uv", smb_uv, f32, (h, w, 2)), ("xv_prev_z", xv_prev_z, f32, (h, w)),
           ("base_threshold", base_threshold, f32, (h, w)), ("navg_thr", navg_thr, f32, (h, w)),
           ("normal_roughness", normal_roughness, f32, (h, w, 4)),
           ("prev_view_z", prev_view_z, f32, (h, w)),
           ("prev_normal_roughness", prev_normal_roughness, f32, (h, w, 4)),
           ("prev_material_id", prev_material_id, f32, (h, w)),
           ("prev_accum", prev_accum, f32, (h, w)),
           ("history", history, bf16, (h, w, c)), ("fast_history", fast_history, bf16, (h, w))]
    extra = []
    if second is not None:
        extra = [("prev_accum_2", second[0], f32, (h, w)),
                 ("history_2", second[1], bf16, (h, w, c)),
                 ("fast_history_2", second[2], bf16, (h, w))]
    sh_ins = [(f"sh[{k}]", t, bf16, (h, w, 4)) for k, t in enumerate(sh or ())]
    for name, t, dt, shape in ins + extra + sh_ins:
        build.check(name, t, dev, dt, shape)
    nsig = 1 + len(extra) // 3
    out_hist = torch.empty((nsig, h, w, c), dtype=f32, device=dev)
    planes = torch.empty((len(PLANES) + 2 * (nsig - 1), h, w), dtype=f32, device=dev)
    navg = torch.empty((2, h, w, 3), dtype=f32, device=dev)
    m = np.asarray(world_prev_to_world, np.float32)[:3, :3].reshape(-1)
    out_sh = torch.empty((nsig, h, w, 4), dtype=f32, device=dev) if sh else None
    consts = [view_z_scale, denoising_range, rect_size_prev[0], rect_size_prev[1],
              min_material, *m, nsig, sh is not None, c == 1, decoded]
    extra_ptrs = [t for _, t, _, _ in extra] + [None] * (3 - len(extra))
    build.launch("nrd_smb_resolve",
                 [t for _, t, _, _ in ins] + [out_hist, planes, navg] + extra_ptrs
                 + [out_sh] + [t for _, t, _, _ in sh_ins] + [None] * (2 - len(sh_ins)),
                 consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    out = _pack(out_hist[0], planes, navg)
    if second is not None:
        out.update(history_2=out_hist[1], accum_speed_2=planes[len(PLANES)],
                   fast_2=planes[len(PLANES) + 1])
    if sh:
        out["sh"] = out_sh[0]
        if second is not None:
            out["sh_2"] = out_sh[1]
    return out
