"""RELAX HistoryClamping - kernel `csrc/relax_clamp_moments.cu` (K20).

Replaces `nrdtpu/kernels/relax_pallas.py:479` (`relax_clamp_moments_pallas`) and computes the
whole pass of one signal, or of the diffuse and the specular signal in one launch as the TPU
function's `n_sig` does, around it (`nrdtpu/passes/relax/kernels.py:1140-1271`, with the
responsive history's select of `nrdtpu/passes/relax/denoiser.py:278-286` before it), per
pixel and signal:

  - the responsive history: HistoryFix's rgb where the history is short
    (`history_length <= historyFixFrameNum`), the TA's fast history elsewhere;
  - the 5x5 moments over the clamp-to-edge window (edge pixels repeat, they are not zero),
    each tap weighted by its in-range validity (`viewZ < denoisingRange`): the mean and second
    moment of the responsive history in YCoCg, the mean of the noisy radiance and the second
    moment of its luminance, divided by `max(weight sum, 1)`;
  - the sigma colour box and the clamp of the slow history in YCoCg (where
    `maxFastAccumulatedFrameNum < maxAccumulatedFrameNum`), the clamping factor, the antilag
    acceleration and reset towards the noisy signal, and the slow history's second-moment
    correction;
  - with the SH variants (`sh`, `sh_fast`), the SH: `lerp(sh, sh_fast, clamping_factor)`
    (`:1260-1262`). In JAX this is glue beside the TPU kernel; the clamping factor exists only
    inside this pass, so the launch takes each signal's two SH planes and writes the lerp.

Bound on the H100: bytes. Per pixel it reads viewZ, the fast and fixed histories, the history
length, the noisy signal and the slow history (72 B, every tap an L1 neighbour) and writes the
slow and responsive histories (32 B): 104 B/px, 0.114 ms at 2560x1440 at 3.35 TB/s; with
both signals viewZ and the history length are read once (200 B/px); SH adds 32 B read and
16 B written a signal. The design for that card
is in the source's header. Each signal has its own clamp flag, acceleration and reset amount
(the specular one's scaled by 0.33 and 0.5, `:1219`, `:1244`).
"""

from __future__ import annotations

import torch

from .. import math as nm
from ..ops import stencil
from . import build

launches = 0


def responsive_history(fast, fixed, history_length, *, history_fix_frame_num):
    """The fixed rgb in place of the fast history's where the history is short."""
    fixmask = (history_length <= history_fix_frame_num)[..., None]
    return torch.where(fixmask, torch.cat([fixed[..., :3], fast[..., 3:]], -1), fast)


def _moments(view_z_in, responsive, noisy, view_z_scale, denoising_range):
    """The 5x5 validity-weighted moments (the XLA loop): (m1, m2) of the responsive YCoCg,
    the noisy mean and the noisy luminance's second moment."""
    view_z = torch.abs(view_z_in) * view_z_scale
    is_valid = (view_z < denoising_range).to(torch.float32)
    resp_ycocg = nm.linear_to_ycocg(responsive[..., :3])
    m1 = torch.zeros_like(resp_ycocg)
    m2 = torch.zeros_like(resp_ycocg)
    nm1 = torch.zeros_like(resp_ycocg)
    nm2 = torch.zeros_like(view_z)
    wsum = torch.zeros_like(view_z)
    for dy, dx in stencil.offsets_square(2):
        w_ = stencil.shifted(is_valid, dy, dx)
        ry = stencil.shifted(resp_ycocg, dy, dx)
        nz = stencil.shifted(noisy[..., :3], dy, dx)
        m1 = m1 + ry * w_[..., None]
        m2 = m2 + ry * ry * w_[..., None]
        nl = nm.luminance(nz)
        nm1 = nm1 + nz * w_[..., None]
        nm2 = nm2 + nl * nl * w_
        wsum = wsum + w_
    wsum = torch.clamp_min(wsum, 1.0)
    return m1 / wsum[..., None], m2 / wsum[..., None], nm1 / wsum[..., None], nm2 / wsum


def _clamp_one(view_z_in, fast, fixed, history_length, noisy, slow, *, view_z_scale,
               denoising_range, history_fix_frame_num, color_box_sigma_scale, clamp,
               acceleration, reset_temporal_sigma_scale, reset_spatial_sigma_scale,
               reset_amount, sh=None, sh_fast=None):
    """The plain version of one signal (the XLA pass, op for op). Returns (slow, responsive)
    histories, (h, w, 4) each, and with `sh` the lerped SH third."""
    resp = responsive_history(fast, fixed, history_length,
                              history_fix_frame_num=history_fix_frame_num)
    m1, m2, nm1, nm2 = _moments(view_z_in, resp, noisy, view_z_scale, denoising_range)
    resp_ycocg = nm.linear_to_ycocg(resp[..., :3])
    sigma = torch.sqrt(torch.clamp_min(m2 - m1 * m1, 0.0))
    cmin = torch.minimum(m1 - color_box_sigma_scale * sigma, resp_ycocg)
    cmax = torch.maximum(m1 + color_box_sigma_scale * sigma, resp_ycocg)
    slow_ycocg = nm.linear_to_ycocg(slow[..., :3])
    clamped_ycocg = torch.minimum(torch.maximum(slow_ycocg, cmin), cmax) if clamp else slow_ycocg
    clamped = nm.ycocg_to_linear(clamped_ycocg)

    in_fix = history_length <= history_fix_frame_num
    out_slow_rgb = torch.where(in_fix[..., None], resp[..., :3], clamped)
    out_resp_rgb = resp[..., :3]

    dy_clamp = clamped_ycocg[..., 0] - slow_ycocg[..., 0]
    denom = resp_ycocg[..., 0] - slow_ycocg[..., 0]
    clamping_factor = torch.where(
        dy_clamp == 0.0, 0.0,
        nm.saturate(dy_clamp / torch.where(torch.abs(denom) < 1e-15, 1e-15, denom)))
    clamping_factor = torch.where(in_fix, 1.0, clamping_factor)
    sh_out = () if sh is None else (nm.lerp(sh, sh_fast, clamping_factor[..., None]),)

    hist_diff_l = acceleration * nm.luminance(torch.abs(out_resp_rgb - slow[..., :3]))
    hist_diff_l = hist_diff_l * clamping_factor
    hist_diff_l = torch.where(in_fix, 0.0, hist_diff_l)

    dist = nm1 - out_resp_rgb
    dist_l = nm.luminance(torch.abs(dist))
    accel = torch.where((dist_l == 0.0)[..., None], 0.0,
                        dist * (hist_diff_l / torch.clamp_min(dist_l, 1e-15))[..., None])
    accel_l = nm.luminance(torch.abs(accel))
    ratio = torch.where(accel_l == 0.0, 0.0, dist_l / torch.clamp_min(accel_l, 1e-15))
    accel = torch.where((ratio < 1.0)[..., None], accel * ratio[..., None], accel)
    accel = torch.where((ratio <= 0.0)[..., None], 0.0, accel)
    out_slow_rgb = out_slow_rgb + accel
    out_resp_rgb = out_resp_rgb + accel

    # history reset (antilag reset)
    slow_l = nm.luminance(slow[..., :3])
    noisy_l = nm.luminance(nm1)
    t_sigma = reset_temporal_sigma_scale * torch.sqrt(
        torch.clamp_min(nm2 - noisy_l * noisy_l, 0.0))
    s_sigma = reset_spatial_sigma_scale * sigma[..., 0]
    reset = reset_amount * torch.clamp_min(
        torch.abs(slow_l - noisy_l) - s_sigma - t_sigma, 0.0) / (
        1e-6 + torch.maximum(slow_l, noisy_l) + s_sigma + t_sigma)
    reset = nm.saturate(reset)
    out_slow_rgb = nm.lerp(out_slow_rgb, noisy[..., :3], reset[..., None])
    out_resp_rgb = nm.lerp(out_resp_rgb, noisy[..., :3], reset[..., None])

    # 2nd moment correction
    out_l = nm.luminance(out_slow_rgb)
    out_m2 = torch.clamp_min(slow[..., 3] + (out_l * out_l - slow_l * slow_l), 0.0)
    return (torch.cat([out_slow_rgb, out_m2[..., None]], -1),
            torch.cat([out_resp_rgb, resp[..., 3:]], -1)) + sh_out


# the constants each signal has its own of; the others are shared
SIGNAL_CONSTS = ("clamp", "acceleration", "reset_amount")


def relax_clamp_moments_ref(view_z_in, fast, fixed, history_length, noisy, slow, sh=None,
                            sh_fast=None, **kw):
    """Plain PyTorch version of the kernel: `_clamp_one` of the signal, or with both signals
    (the planes and SIGNAL_CONSTS pairs) of each signal with its own constants, returning
    (diffuse slow, diffuse responsive, specular slow, specular responsive), and with `sh`
    each signal's lerped SH after them."""
    if not isinstance(fast, (tuple, list)):
        return _clamp_one(view_z_in, fast, fixed, history_length, noisy, slow, sh=sh,
                          sh_fast=sh_fast, **kw)
    out, shs = (), ()
    for k in range(2):
        kk = {n: (v[k] if n in SIGNAL_CONSTS else v) for n, v in kw.items()}
        r = _clamp_one(view_z_in, fast[k], fixed[k], history_length, noisy[k], slow[k],
                       sh=None if sh is None else sh[k],
                       sh_fast=None if sh is None else sh_fast[k], **kk)
        out, shs = out + r[:2], shs + r[2:]
    return out + shs


def relax_clamp_moments(view_z_in, fast, fixed, history_length, noisy, slow, *, view_z_scale,
                        denoising_range, history_fix_frame_num, color_box_sigma_scale, clamp,
                        acceleration, reset_temporal_sigma_scale, reset_spatial_sigma_scale,
                        reset_amount, sh=None, sh_fast=None):
    """fast (h, w, 4) the TA's responsive history, fixed (h, w, 4) HistoryFix's output (rgb),
    noisy (h, w, 4) the PrePass output (rgb), slow (h, w, 4) the TA's slow history (rgb, second
    moment); the constants float32 host values as the pass computes them. Returns (slow,
    responsive) histories, (h, w, 4) each. With both signals fast, fixed, noisy, slow and the
    constants of SIGNAL_CONSTS are (diffuse, specular) pairs, and it returns (diffuse slow,
    diffuse responsive, specular slow, specular responsive). With the SH variants sh and
    sh_fast are the TA's slow and responsive SH (h, w, 4) of the signal (pairs with both), and
    each signal's lerp(sh, sh_fast, clamping factor) follows the histories in the result."""
    global launches
    kw = dict(view_z_scale=view_z_scale, denoising_range=denoising_range,
              history_fix_frame_num=history_fix_frame_num,
              color_box_sigma_scale=color_box_sigma_scale, clamp=clamp, acceleration=acceleration,
              reset_temporal_sigma_scale=reset_temporal_sigma_scale,
              reset_spatial_sigma_scale=reset_spatial_sigma_scale, reset_amount=reset_amount)
    pair = isinstance(fast, (tuple, list))
    if (sh is None) != (sh_fast is None):
        raise ValueError("sh and sh_fast come together")
    sigs = [tuple(x) if pair else (x,) for x in (fast, fixed, noisy, slow)]
    shs = [] if sh is None else [tuple(x) if pair else (x,) for x in (sh, sh_fast)]
    per = [tuple(kw[n]) if pair else (kw[n],) for n in SIGNAL_CONSTS]
    n = len(sigs[0])
    if any(len(x) != n for x in sigs + per + shs) or not 1 <= n <= 2:
        raise ValueError("one signal, or the pair (diffuse, specular) of each plane and "
                         "of clamp, acceleration, reset_amount")
    dev = build.kernel_device(sigs[0][0])
    if dev is None:
        return relax_clamp_moments_ref(view_z_in, fast, fixed, history_length, noisy, slow, sh,
                                       sh_fast, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    build.check("view_z_in", view_z_in, dev, f32, (h, w))
    build.check("history_length", history_length, dev, f32, (h, w))
    for name, planes in zip(("fast", "fixed", "noisy", "slow", "sh", "sh_fast"), sigs + shs):
        for k, t in enumerate(planes):
            build.check(f"{name}[{k}]", t, dev, f32, (h, w, 4))
    out = torch.empty((n, 2, h, w, 4), dtype=f32, device=dev)
    out_sh = torch.empty((n, h, w, 4), dtype=f32, device=dev) if shs else None
    fa, fi, no, sl = sigs
    ptrs = [view_z_in, fa[0], fi[0], history_length, no[0], sl[0], out[0, 0], out[0, 1]]
    ptrs += [fa[1], fi[1], no[1], sl[1], out[1, 0], out[1, 1]] if n == 2 else [None] * 6
    ptrs += [t for k in range(2) for t in ((shs[0][k], shs[1][k], out_sh[k])
                                           if shs and k < n else (None,) * 3)]
    consts = [view_z_scale, denoising_range, history_fix_frame_num, color_box_sigma_scale,
              per[0][0], per[1][0], reset_temporal_sigma_scale, reset_spatial_sigma_scale,
              per[2][0], n]
    if n == 2:
        consts += [per[0][1], per[1][1], per[2][1]]
    build.launch("nrd_relax_clamp_moments", ptrs, consts, w, h)
    launches += 1
    return tuple(out.reshape(2 * n, h, w, 4)) + (tuple(out_sh) if shs else ())
