"""RELAX HistoryClamping - kernel `csrc/relax_clamp_moments.cu` (K20).

Replaces `nrdtpu/kernels/relax_pallas.py:479` (`relax_clamp_moments_pallas`) and computes the
whole pass of one signal around it (`nrdtpu/passes/relax/kernels.py:1140-1271`, with the
responsive history's select of `nrdtpu/passes/relax/denoiser.py:278-286` before it), per
pixel:

  - the responsive history: HistoryFix's rgb where the history is short
    (`history_length <= historyFixFrameNum`), the TA's fast history elsewhere;
  - the 5x5 moments over the clamp-to-edge window (edge pixels repeat, they are not zero),
    each tap weighted by its in-range validity (`viewZ < denoisingRange`): the mean and second
    moment of the responsive history in YCoCg, the mean of the noisy radiance and the second
    moment of its luminance, divided by `max(weight sum, 1)`;
  - the sigma colour box and the clamp of the slow history in YCoCg (where
    `maxFastAccumulatedFrameNum < maxAccumulatedFrameNum`), the clamping factor, the antilag
    acceleration and reset towards the noisy signal, and the slow history's second-moment
    correction.

Bound on the H100: bytes. Per pixel it reads viewZ, the fast and fixed histories, the history
length, the noisy signal and the slow history (72 B, every tap an L1 neighbour) and writes the
slow and responsive histories (32 B): 104 B/px, 0.114 ms at 2560x1440 at 3.35 TB/s. The
design for that card is in the source's header.
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


def relax_clamp_moments_ref(view_z_in, fast, fixed, history_length, noisy, slow, *,
                            view_z_scale, denoising_range, history_fix_frame_num,
                            color_box_sigma_scale, clamp, acceleration,
                            reset_temporal_sigma_scale, reset_spatial_sigma_scale, reset_amount):
    """Plain PyTorch version of the kernel (the XLA pass, op for op). Returns (slow,
    responsive) histories, (h, w, 4) each."""
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
            torch.cat([out_resp_rgb, resp[..., 3:]], -1))


def relax_clamp_moments(view_z_in, fast, fixed, history_length, noisy, slow, *, view_z_scale,
                        denoising_range, history_fix_frame_num, color_box_sigma_scale, clamp,
                        acceleration, reset_temporal_sigma_scale, reset_spatial_sigma_scale,
                        reset_amount):
    """fast (h, w, 4) the TA's responsive history, fixed (h, w, 4) HistoryFix's output (rgb),
    noisy (h, w, 4) the PrePass output (rgb), slow (h, w, 4) the TA's slow history (rgb, second
    moment); the constants float32 host values as the pass computes them. Returns (slow,
    responsive) histories, (h, w, 4) each."""
    global launches
    kw = dict(view_z_scale=view_z_scale, denoising_range=denoising_range,
              history_fix_frame_num=history_fix_frame_num,
              color_box_sigma_scale=color_box_sigma_scale, clamp=clamp, acceleration=acceleration,
              reset_temporal_sigma_scale=reset_temporal_sigma_scale,
              reset_spatial_sigma_scale=reset_spatial_sigma_scale, reset_amount=reset_amount)
    dev = build.kernel_device(fast)
    if dev is None:
        return relax_clamp_moments_ref(view_z_in, fast, fixed, history_length, noisy, slow, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("view_z_in", view_z_in, (h, w)), ("fast", fast, (h, w, 4)),
           ("fixed", fixed, (h, w, 4)), ("history_length", history_length, (h, w)),
           ("noisy", noisy, (h, w, 4)), ("slow", slow, (h, w, 4))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((2, h, w, 4), dtype=f32, device=dev)
    build.launch("nrd_relax_clamp_moments", [t for _, t, _ in ins] + [out[0], out[1]],
                 list(kw.values()), w, h)
    launches += 1
    return out[0], out[1]
