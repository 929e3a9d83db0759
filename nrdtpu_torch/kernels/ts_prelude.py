"""REBLUR temporal stabilization, one half - kernel `csrc/ts_prelude.cu` (H4).

Replaces two TPU kernels in one launch, because both read around the same pixel in TS:
`nrdtpu/kernels/reblur_pallas.py:1754` (`moments_minmax_pallas`: 3x3 mean, second moment and
min/max over the 8 neighbours of luma, `nrdtpu/passes/reblur/kernels.py:2365-2378`) and
`nrdtpu/kernels/reblur_pallas.py:1705` (`hist_sample_pallas`: CatRom-13 / bilinear-custom
sample of the bf16 luma-stabilization history at the surface-motion position, with the
occlusion taken from fbits, `:2338-2342`, `:2383-2385`; for the specular signal also at the
virtual-motion position with fbits bits 4-7, `:2458-2485`, the second `hist_sample_pallas` call
of the TPU path). Around them it computes the rest of the half per pixel (`:2338-2410` diffuse,
`:2458-2540` specular): the footprint qualities, the RCRS clamp, ComputeAntilag, the
temporal-accumulation weight, the split-screen tests on the pixel's and the reprojected uv, the
history clamp and the blend capped by the stabilization strength, for specular the histories'
and qualities' lerps by the virtual history amount, the responsive factor, the spec magic
curve and the strand material; then the new accumulation speed and ChangeLuma.

With REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (`directional=True`, the diffuse half) the luma is the
signal's .w (`luma_is_last`, `:2400-2404`) and the luma change the directional one: .xyz scaled
by (luma_stab + 1e-6) / (.w + 1e-6), .w set to luma_stab (the kernel's `kDir` instance).

At the RGBA normal encodings (`decoded=True`, the specular half) IN_NORMAL_ROUGHNESS is the plane
that the frame decodes once (`frontend.decode_normal_plane`, its roughness decoded): the roughness
.w and the material 0, still compared with the strand material id as the reference compares it
(the kernel's `kDec` instance). The diffuse half reads no normal.

Bound on the H100: memory. Per pixel the diffuse half reads the signal (16 B), the bf16 history
near the reprojected position (~2-4 B from device memory), the uv, fbits and accumulation
speed (16 B), and writes the signal, its luma and the accumulation speed (24 B): ~58 B/px,
~0.063 ms at 2560x1440 at 3.35 TB/s; the specular half adds the virtual-motion uv, the virtual
history amount and IN_NORMAL_ROUGHNESS (28 B/px). The design for that card is in the source's
header.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from ..passes.reblur import common as C
from . import build

launches = 0
dec_launches = 0  # of them, the specular instance on the decoded plane of the RGBA formats


def _sample(history, uv, fbits, first_bit, rect_size_prev):
    """(sample_history at uv with the occlusion of fbits bits first_bit..first_bit+3, the
    footprint quality: sqrt(saturate(sum of the bilinear weights of the unoccluded taps)))."""
    _, frac = nm.bilinear_filter(uv, rect_size_prev)
    bits = fbits.to(torch.int32)
    occ = torch.stack([((bits >> b) & 1).to(torch.float32)
                       for b in range(first_bit, first_bit + 4)], -1)
    weights = nm.get_bilinear_custom_weights(frac, occ)
    allow_catrom = torch.sum(occ, -1) > 3.5
    sample_pos = nm.scale2(nm.saturate(uv), rect_size_prev[0], rect_size_prev[1])
    hist = resample.sample_catrom(history.float(), sample_pos, allow_catrom, weights)
    quality = torch.sqrt(nm.saturate(torch.sum(occ * nm.bilinear_weights(frac), -1)))
    return hist, quality


def ts_prelude_ref(signal, history, smb_uv, fbits, data1, vmb_uv=None,
                   virtual_history_amount=None, normal_roughness=None, *, rect_size_prev,
                   max_blur_radius, split_screen, split_screen_prev, antilag_params,
                   framerate_scale, stabilization_strength, history_fix_frame_num,
                   responsive_roughness_threshold=None, strand_material_id=None,
                   directional=False, decoded=False):
    """Plain PyTorch version of the kernel (the XLA half, op for op). Returns dict(signal,
    luma_stab, data1)."""
    h, w = data1.shape
    luma = C.get_luma(signal, directional=directional)
    m1 = torch.zeros_like(luma)
    m2 = torch.zeros_like(luma)
    lmin = torch.full_like(luma, fe.NRD_INF)
    lmax = torch.full_like(luma, -fe.NRD_INF)
    for dy, dx in stencil.offsets_square(1):
        t = stencil.shifted(luma, dy, dx)
        m1 = m1 + t
        m2 = m2 + t * t
        if not (dy == 0 and dx == 0):
            lmin = torch.minimum(lmin, t)
            lmax = torch.maximum(lmax, t)
    # true divisions by host scalars on every device (math.div), as XLA and the kernel divide:
    # sigma's m2 - m1^2 cancels, and one ulp of m1 moves it past the tolerance
    m1 = nm.div(m1, 9.0)
    sigma = nm.get_std_dev(m1, nm.div(m2, 9.0))
    luma_rcrs = torch.clamp(luma, lmin, lmax) if max_blur_radius != 0.0 else luma

    smb_hist, quality = _sample(history, smb_uv, fbits, 0, rect_size_prev)
    hist = torch.clamp_min(smb_hist, 0.0)
    if vmb_uv is not None:
        vmb_hist, vmb_quality = _sample(history, vmb_uv, fbits, 4, rect_size_prev)
        hist = nm.lerp(hist, torch.clamp_min(vmb_hist, 0.0), virtual_history_amount)
        quality = nm.lerp(quality, vmb_quality, virtual_history_amount)

    # ComputeAntilag mode 2 (REBLUR_Common.hlsli:244-274)
    s = sigma * float(antilag_params[0])
    frs = np.float32(framerate_scale)
    magic = float(np.float32(antilag_params[1]) * frs * frs)
    hc = torch.clamp(hist, m1 - s, m1 + s)
    d = torch.abs(hist - hc) / (torch.maximum(hist, hc) + nm.EPS)
    antilag = 1.0 / (1.0 + nm.div(d * (quality * data1), magic))

    # REBLUR_Common.hlsli:297-306
    a = data1 * C.REBLUR_SAMPLES_PER_FRAME
    taw = quality * a / (1.0 + a)
    ta_sigma_scale = 1.0 + 3.0 * float(framerate_scale) * taw

    history_weight = taw * antilag
    uv = resample.pixel_uv_grid(h, w, data1.device)
    history_weight = history_weight * (uv[..., 0] >= split_screen).to(torch.float32)
    smb_ok = (smb_uv[..., 0] >= split_screen_prev).to(torch.float32)
    if vmb_uv is None:
        history_weight = history_weight * smb_ok
    else:
        vmb_ok = (vmb_uv[..., 0] >= split_screen_prev).to(torch.float32)
        history_weight = history_weight * torch.where(virtual_history_amount != 1.0, smb_ok, 1.0)
        history_weight = history_weight * torch.where(virtual_history_amount != 0.0, vmb_ok, 1.0)
        # LINEAR: the glue passes the plane with its roughness decoded
        _, roughness, material_id = fe.unpack_normal_plane(normal_roughness, decoded)
        # RemapRoughnessToResponsiveFactor (REBLUR_Common.hlsli:126-131)
        responsive_factor = nm.smoothstep01(nm.div(roughness + nm.EPS, float(
            np.float32(responsive_roughness_threshold) + np.float32(nm.EPS))))
        smc = nm.get_spec_magic_curve(roughness)
        acceleration = nm.lerp(smc, 1.0, 0.5 + responsive_factor * 0.5)
        history_weight = history_weight * torch.where(material_id == strand_material_id, 0.5,
                                                      acceleration)

    hist_clamped = torch.clamp(hist, m1 - sigma * ta_sigma_scale, m1 + sigma * ta_sigma_scale)
    luma_stab = nm.lerp(luma_rcrs, hist_clamped,
                        torch.clamp_max(history_weight, stabilization_strength))
    d1 = data1 + 1.0
    dmin = torch.clamp_max(d1, history_fix_frame_num)
    return dict(signal=C.change_luma(signal, luma_stab, directional=directional),
                luma_stab=luma_stab,
                data1=nm.lerp(dmin, d1, antilag))


# the wrapper's arguments that are previous-frame planes: whole frames under a mesh, while
# the current planes are a band of rows (`parallel.sharding.band_call`)
PREVIOUS_PLANES = ("history",)


def ts_prelude(signal, history, smb_uv, fbits, data1, vmb_uv=None, virtual_history_amount=None,
               normal_roughness=None, *, rect_size_prev, max_blur_radius, split_screen,
               split_screen_prev, antilag_params, framerate_scale, stabilization_strength,
               history_fix_frame_num, responsive_roughness_threshold=None,
               strand_material_id=None, directional=False, decoded=False):
    """signal (h, w, 4) float32 (its .x the luma; .w with `directional`, the diffuse half of
    REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION), history (ph, w) bf16 (the current planes' height, or
    the whole frame's where they are a band of its rows: the kernel derives no position from
    its row index, its uv are the inputs), smb_uv (h, w, 2), fbits
    and data1 (h, w) float32; for the specular half also vmb_uv (h, w, 2), the virtual history
    amount (h, w) and IN_NORMAL_ROUGHNESS (h, w, 4) at LINEAR roughness, with the responsive
    roughness threshold and the strand material id; decoded (specular): IN_NORMAL_ROUGHNESS is the
    RGBA formats' decoded plane (the kernel's kDec instance), else packed R10G10B10A2. The
    constants are host values as the pass reads them. Returns dict(signal (h, w, 4), luma_stab
    (h, w), data1 (h, w))."""
    global launches, dec_launches
    kw = dict(rect_size_prev=rect_size_prev, max_blur_radius=max_blur_radius,
              split_screen=split_screen, split_screen_prev=split_screen_prev,
              antilag_params=antilag_params, framerate_scale=framerate_scale,
              stabilization_strength=stabilization_strength,
              history_fix_frame_num=history_fix_frame_num,
              responsive_roughness_threshold=responsive_roughness_threshold,
              strand_material_id=strand_material_id, directional=directional, decoded=decoded)
    spec = vmb_uv is not None
    if spec and directional:
        raise ValueError("directional: the diffuse half only")
    if decoded and not spec:
        raise ValueError("decoded: the specular half only (the diffuse half reads no normal)")
    dev = build.kernel_device(signal)
    if dev is None:
        return ts_prelude_ref(signal, history, smb_uv, fbits, data1, vmb_uv,
                              virtual_history_amount, normal_roughness, **kw)
    h, w = data1.shape
    f32 = torch.float32
    ph = history.shape[0]
    ins = [("signal", signal, f32, (h, w, 4)), ("history", history, torch.bfloat16, (ph, w)),
           ("smb_uv", smb_uv, f32, (h, w, 2)), ("fbits", fbits, f32, (h, w)),
           ("data1", data1, f32, (h, w))]
    spec_ins = [("vmb_uv", vmb_uv, f32, (h, w, 2)),
                ("virtual_history_amount", virtual_history_amount, f32, (h, w)),
                ("normal_roughness", normal_roughness, f32, (h, w, 4))]
    for name, t, dt, shape in ins + (spec_ins if spec else []):
        build.check(name, t, dev, dt, shape)
    out = torch.empty((h, w, 4), dtype=f32, device=dev)
    planes = torch.empty((2, h, w), dtype=f32, device=dev)
    f = np.float32
    consts = [*[float(v) for v in np.asarray(rect_size_prev, f)], max_blur_radius != 0.0,
              split_screen, split_screen_prev, float(antilag_params[0]),
              float(f(antilag_params[1]) * f(framerate_scale) * f(framerate_scale)),
              3.0 * float(framerate_scale), stabilization_strength, history_fix_frame_num, spec,
              float(f(responsive_roughness_threshold) + f(nm.EPS)) if spec else 0.0,
              strand_material_id if spec else 0.0, directional, decoded, ph]
    build.launch("nrd_ts_prelude", [t for _, t, _, _ in ins]
                 + [t if spec else None for _, t, _, _ in spec_ins] + [out, planes], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    return dict(signal=out, luma_stab=planes[0], data1=planes[1])
