"""RELAX à-trous iteration - kernel `csrc/relax_atrous.cu` (K22).

Replaces `nrdtpu/kernels/relax_pallas.py:338` (`relax_atrous_pallas`). Computes `atrous`
(`nrdtpu/passes/relax/kernels.py:1340-1606`) for one signal, or for the diffuse and the
specular signal in one launch (the TPU function's `has_diff` / `has_spec`), per pixel, in two
modes:

  - iteration 0 (`is_first`): the 3x3 Gaussian prefilter of the centre's variance
    (`:1456-1463`), the 3x3 à-trous taps accumulating (rgb, 2nd moment) with the variance
    taken at the end (`:1538-1542`), and where `history_length < history_threshold` the 5x5
    spatial variance estimation in its place (`:1560-1598`, clamp-to-edge);
  - later iterations: the signal's .w is the variance, propagated with w^2 (`:1534`,
    `:1544`); the diffuse lobe fraction relaxes with the stride and the history length
    (`:1363-1366`), and strides above 4 jitter each pixel's taps by
    `floor(step / 2 (rnd - 0.5))`, rnd from the PCG hash of (pixel, frame index)
    (`:1472-1477`, bit-exact with `nrdtpu_torch.math.hash_*`). The TPU kernel's per-block
    jitter (`relax_pallas.py:6-9`) is not carried over.

Each tap is `sample_nearest(uv + duv)` with XLA's float uv and its in-screen test, weighted
by plane distance, the 3x3 Gaussian, denoising range, normal angle, material and luminance.
IN_DIFF_CONFIDENCE relaxes the diffuse lobe fraction and the luminance weight per pixel
(`:1385-1391`). The specular signal (`specular` given) relaxes its luminance weight by the
TA's reprojection confidence at strides <= 4 (`:1368-1373`) and by IN_SPEC_CONFIDENCE
(`:1377-1384`), and after iteration 0 weights its taps by the specular normal weight (angle0
/ f0 per pixel from roughness, history length and reprojection confidence) x the roughness
weight, or by the simplified normal weight without roughness edge stopping (`:1513-1519`);
iteration 0 keeps the diffuse normal weight, as XLA does (`use_variance_estimation`). Every
texel's roughness is unpacked with the roughness encoding (`:1352`, `:1507`), a template
parameter of the kernel. At the RGBA normal encodings every texel comes from the decoded plane
(`decoded=`, the kDec instances) and no tap tests the material (`:1522`, `:1575`). With both
signals each tap's geometry (plane distance, Gaussian,
in-screen test, denoising range, normal angle) serves both, and each signal keeps its own
normal weight, phi, max luminance difference, min material and confidence relaxation, as
the XLA function's per-signal `taps_loop` does. With the SH variants (`sh`) each signal's SH
plane is filtered with the signal's weights (not squared after iteration 0, `:1494`,
`:1535-1537`, `:1545`), at iteration 0 with the 5x5 estimation's SH in its place where the
history is short (`:1568`, `:1585-1586`, `:1596-1598`), and after iteration 0 the diffuse lobe
fraction's base is 1.0 in place of the settings' fraction (`:1363`, `lobe_fraction(sh=True)`),
in the same launch: the counterpart of the TPU kernel's `d_sh` / `s_sh` (`relax_pallas.py:
350-351`). The last iteration's YCoCg of the SH variants' signal (`:1600-1602`) stays in the
pass glue.

Bound on the H100: gathers. Per pixel it reads the centre's signal, viewZ, packed normal and
history length (40 B) and 8 taps of viewZ, packed normal and signal (8 x 36 B, `step` px
away: 1 to 16 at the default 5 iterations); iteration 0 reads 8 more signal taps of the 3x3
and, where the history is short, the 25 taps of the 5x5 (L1 neighbours); it writes 16 B. A
tap is three loads (a float4 of signal, a float4 of `nr`, a float of viewZ); iteration 0 reads
the tile's window staged in shared memory. With both signals a tap reads one float4 more, and
with SH one float4 more a signal (its SH, staged at iteration 0 too).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from ..passes import relax as RC
from ..settings import RoughnessEncoding
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instances (kDec)
G3 = (0.44198, 0.27901)                    # kernelWeightGaussian3x3, RELAX_Atrous.hlsli:120
PREFILTER = ((0.25, 0.125), (0.125, 0.0625))  # the 3x3 variance prefilter, [|dx|][|dy|]
F32 = np.float32
# the specular constants of `specular`, in the order the kernel reads them
SPECULAR_CONSTS = ("roughness_fraction", "normal_edge_stopping_relaxation", "lobe_angle_slack",
                   "luminance_edge_stopping_relaxation", "roughness_edge_stopping_relaxation",
                   "roughness_edge_stopping_enabled")


def normal_weight_param2(angle_fraction):
    """get_normal_weight_param2 of roughness 1 (the diffuse lobe) and a tensor or host
    angle fraction."""
    return RC.get_normal_weight_param2(torch.ones(()), angle_fraction)


def lobe_fraction(lobe_angle_fraction, step_size, is_first, sh=False):
    """The diffuse lobe fraction before its history-length relaxation (`:1360-1364`): the
    settings' fraction at iteration 0, else base / sqrt(step), the base the settings' fraction
    (float32), or with the SH variants 1.0 (`:1363`: a Python double in XLA, as the result)."""
    if is_first:
        return float(F32(lobe_angle_fraction))
    if sh:
        return 1.0 / step_size ** 0.5
    return float(F32(lobe_angle_fraction) / F32(step_size ** 0.5))


def lobe_span(lobe_fraction, sh=False):
    """The span (fraction - 0.99) of the relaxation lerp(0.99, fraction, saturate(hl / 5))
    after iteration 0, as XLA takes it: float32 minus float32, or with the SH variants the
    Python double's difference rounded to float32 once."""
    if sh:
        return float(F32(lobe_fraction - 0.99))
    return float(F32(lobe_fraction) - F32(0.99))


def _relaxation(confidence, relaxation):
    """(normal, luminance) edge-stopping relaxation of a confidence plane (`:1377-1391`):
    r0 = saturate(multiplier (1 - confidence)), then saturate(r0 x each relaxation)."""
    mult, normal, lum = relaxation
    r0 = nm.saturate(mult * (1.0 - confidence))
    return nm.saturate(r0 * normal), nm.saturate(r0 * lum)


def _toward_one(fraction, t):
    """lerp(fraction, 1, t) of a host or per-pixel fraction, (1 - fraction) in float32."""
    if isinstance(fraction, torch.Tensor):
        return fraction + (1.0 - fraction) * t
    return fraction + float(F32(1.0) - F32(fraction)) * t


def _atrous_one(signal, view_z_in, normal_roughness, history_length, diff_confidence=None,
                spec_confidence=None, reprojection_confidence=None, *, step_size, is_first,
                frame_index, frustum, ortho_mode, view_z_scale, denoising_range, depth_threshold,
                lobe_fraction, lobe_angle_fraction, phi_luminance,
                max_luminance_relative_difference, min_material, history_threshold,
                confidence_relaxation, specular=None,
                roughness_encoding=RoughnessEncoding.LINEAR, sh=None, decoded=False):
    """The plain version of one signal (the XLA iteration, op for op). lobe_fraction is
    `lobe_fraction(...)` of this iteration, lobe_angle_fraction the settings' (the 5x5
    estimation's normal weight and the specular lobe). With `sh` it returns (signal, SH)."""
    h, w = view_z_in.shape
    dev = signal.device
    uv = resample.pixel_uv_grid(h, w, dev)
    view_z = torch.abs(view_z_in) * view_z_scale
    n, roughness, material_id = fe.unpack_normal_plane(normal_roughness, decoded,
                                                       roughness_encoding)
    x = RC.world_pos(frustum, ortho_mode, uv, view_z)
    thr = depth_threshold * (view_z if ortho_mode == 0.0 else torch.ones_like(view_z))
    mat_c = torch.clamp_min(material_id, min_material)
    ones = torch.ones_like(view_z)

    # the diffuse lobe fraction (`:1360-1366`), relaxed by IN_DIFF_CONFIDENCE (`:1385-1391`)
    if is_first:
        dlf0 = float(F32(lobe_fraction))
    else:
        # lerp(0.99, fraction, saturate(hl / 5)) with XLA's (fraction - 0.99)
        dlf0 = 0.99 + lobe_span(lobe_fraction, sh is not None) * nm.saturate(
            history_length / 5.0)
    dlf, lum_relax = dlf0, ones
    if diff_confidence is not None:
        rr, rl = _relaxation(diff_confidence, confidence_relaxation)
        dlf = _toward_one(dlf0, rr)
        lum_relax = 1.0 - rl
    nwp = normal_weight_param2(dlf) * ones

    spec_taps = specular is not None and not is_first
    if specular is not None:
        # the specular relaxations (`:1368-1384`); iteration 0 keeps the diffuse normal
        # weight for the specular signal (use_variance_estimation, `:1513`)
        lum_relax = ones
        if (step_size <= 4 or is_first) and reprojection_confidence is not None:
            lum_relax = nm.lerp(1.0, reprojection_confidence,
                                specular["luminance_edge_stopping_relaxation"])
        spec_lobe, dlf_simpl = lobe_angle_fraction, dlf0
        if spec_confidence is not None:
            rr, rl = _relaxation(spec_confidence, confidence_relaxation)
            dlf_simpl = _toward_one(dlf0, rr)
            spec_lobe = _toward_one(lobe_angle_fraction, rr)
            lum_relax = lum_relax * (1.0 - rl)
    if spec_taps:
        nwp_simpl = normal_weight_param2(dlf_simpl) * ones
        ra, rb = nm.get_roughness_weight_params(roughness, specular["roughness_fraction"])
        angle0, f0 = RC.get_normal_weight_params_atrous(
            roughness, history_length,
            reprojection_confidence if reprojection_confidence is not None else ones,
            specular["normal_edge_stopping_relaxation"], spec_lobe,
            specular["lobe_angle_slack"])
        cv = -nm.normalize(x)
        resr = specular["roughness_edge_stopping_relaxation"]

    if is_first:
        acc = torch.zeros_like(signal)
        for dy, dx in stencil.offsets_square(1):
            acc = acc + stencil.shifted(signal, dy, dx) * PREFILTER[abs(dx)][abs(dy)]
        m1 = nm.luminance(acc[..., :3])
        var = torch.clamp_min(acc[..., 3] - m1 * m1, 0.0)
    else:
        var = signal[..., 3]

    off_x = off_y = 0.0
    if not is_first and step_size > 4:
        xs_ = torch.arange(w, device=dev)[None, :].expand(h, w)
        ys_ = torch.arange(h, device=dev)[:, None].expand(h, w)
        _, rnd = nm.hash_float2(nm.hash_init(xs_, ys_, frame_index))
        off_x = torch.floor(step_size * 0.5 * (rnd[..., 0] - 0.5))
        off_y = torch.floor(step_size * 0.5 * (rnd[..., 1] - 0.5))

    phi_inv = 1.0 / torch.clamp_min(phi_luminance * torch.sqrt(var), 1e-4)
    center_l = nm.luminance(signal[..., :3])
    w0 = G3[0] * G3[0]
    wsum = torch.full_like(view_z, w0)
    if is_first:
        acc = signal * w0
    else:
        acc = signal * torch.tensor([w0, w0, w0, w0 * w0], dtype=torch.float32, device=dev)
    acc_sh = None if sh is None else sh * w0
    rinv_x, rinv_y = float(F32(1.0) / F32(w)), float(F32(1.0) / F32(h))
    for yy in range(-1, 2):
        for xx in range(-1, 2):
            if xx == 0 and yy == 0:
                continue
            kern = G3[abs(xx)] * G3[abs(yy)]
            uv_s = torch.stack([uv[..., 0] + (float(xx * step_size) + off_x) * rinv_x,
                                uv[..., 1] + (float(yy * step_size) + off_y) * rinv_y], -1)
            inside = resample.is_in_screen_nearest(uv_s)
            zs = torch.abs(resample.sample_nearest(view_z_in, uv_s)) * view_z_scale
            ns, rs, ms = fe.unpack_normal_plane(
                resample.sample_nearest(normal_roughness, uv_s), decoded, roughness_encoding)
            xs = RC.world_pos(frustum, ortho_mode, uv_s, zs)
            gw = RC.get_plane_distance_weight_atrous(x, n, xs, thr) * kern
            gw = gw * inside * (zs < denoising_range).to(torch.float32)
            angle = nm.acos_approx(nm.dot(n, ns))
            if spec_taps:
                sv = -nm.normalize(xs + resr * x)
                nw = RC.get_specular_normal_weight_atrous(angle0, f0, n, ns, cv, sv)
                if specular["roughness_edge_stopping_enabled"] != 0.0:
                    w_ = gw * (nw * nm.compute_weight(rs, ra, rb))
                else:
                    w_ = gw * nm.compute_weight(angle, nwp_simpl, 0.0)
            else:
                w_ = gw * nm.compute_weight(angle, nwp, 0.0)
            w_ = w_ * (torch.clamp_min(ms, min_material) == mat_c).to(torch.float32)
            s = resample.sample_nearest(signal, uv_s)
            sl = nm.luminance(s[..., :3])
            lw = torch.clamp_max(torch.abs(center_l - sl) * phi_inv,
                                 max_luminance_relative_difference) * lum_relax
            w_ = w_ * torch.exp(-lw)
            wsum = wsum + w_
            if is_first:
                acc = acc + s * w_[..., None]
            else:
                acc = acc + s * torch.stack([w_, w_, w_, w_ * w_], -1)
            if sh is not None:
                acc_sh = acc_sh + resample.sample_nearest(sh, uv_s) * w_[..., None]
    out_sh = None if sh is None else acc_sh / wsum[..., None]
    if is_first:
        out = acc / wsum[..., None]
        m1 = nm.luminance(out[..., :3])
        out = torch.cat([out[..., :3], torch.clamp_min(out[..., 3] - m1 * m1, 0.0)[..., None]], -1)
        sve = _variance_estimation(signal, normal_roughness, history_length, n, mat_c,
                                   lobe_angle_fraction, min_material, roughness_encoding, sh,
                                   decoded)
        use_atrous = (history_length >= history_threshold)[..., None]
        out = torch.where(use_atrous, out, sve[0])
        if sh is not None:
            out_sh = torch.where(use_atrous, out_sh, sve[1])
    else:
        out = acc / torch.stack([wsum, wsum, wsum, wsum * wsum], -1)
    return out if sh is None else (out, out_sh)


def _variance_estimation(signal, normal_roughness, history_length, n, mat_c,
                         lobe_angle_fraction, min_material, roughness_encoding, sh=None,
                         decoded=False):
    """The 5x5 spatial variance estimation of short histories (`:1560-1598`): (signal, SH or
    None)."""
    nwp = normal_weight_param2(lobe_angle_fraction)
    swsum = torch.zeros_like(history_length)
    s_rgb = torch.zeros_like(signal[..., :3])
    s_m1 = torch.zeros_like(history_length)
    s_m2 = torch.zeros_like(history_length)
    s_sh = None if sh is None else torch.zeros_like(sh)
    for dy, dx in stencil.offsets_square(2):
        ns, _, ms = fe.unpack_normal_plane(stencil.shifted(normal_roughness, dy, dx), decoded,
                                           roughness_encoding)
        w_ = nm.compute_weight(nm.acos_approx(nm.dot(n, ns)), nwp, 0.0)
        w_ = w_ * (torch.clamp_min(ms, min_material) == mat_c).to(torch.float32)
        s = stencil.shifted(signal, dy, dx)
        swsum = swsum + w_
        s_rgb = s_rgb + s[..., :3] * w_[..., None]
        s_m1 = s_m1 + nm.luminance(s[..., :3]) * w_
        s_m2 = s_m2 + s[..., 3] * w_
        if sh is not None:
            s_sh = s_sh + stencil.shifted(sh, dy, dx) * w_[..., None]
    swsum = torch.clamp_min(swsum, 1e-6)
    s_rgb = s_rgb / swsum[..., None]
    s_m1 = s_m1 / swsum
    s_m2 = s_m2 / swsum
    boost = torch.clamp_min(torch.full_like(history_length, 4.0) / (history_length + 1.0), 1.0)
    s_var = torch.clamp_min(s_m2 - s_m1 * s_m1, 0.0) * boost
    return torch.cat([s_rgb, s_var[..., None]], -1), (None if sh is None
                                                      else s_sh / swsum[..., None])


def _frame_halves(frame_index):
    f = int(frame_index) & 0xFFFFFFFF
    return float(f & 0xFFFF), float(f >> 16)


# the constants each signal has its own of; the others are shared
SIGNAL_CONSTS = ("phi_luminance", "max_luminance_relative_difference", "min_material")


def relax_atrous_ref(signal, *planes, specular=None, sh=None, **kw):
    """Plain PyTorch version of the kernel: `_atrous_one` of the signal, or with both signals
    (`signal` the pair (diffuse, specular), SIGNAL_CONSTS pairs, `sh` a pair) of each signal
    with its own constants, the diffuse one without `specular`; the outputs as the wrapper
    returns them."""
    if not isinstance(signal, (tuple, list)):
        return _atrous_one(signal, *planes, specular=specular, sh=sh, **kw)
    outs = [_atrous_one(sig, *planes, specular=sp, sh=None if sh is None else sh[k],
                        **{n: (v[k] if n in SIGNAL_CONSTS else v) for n, v in kw.items()})
            for k, (sig, sp) in enumerate(zip(signal, (None, specular)))]
    if sh is None:
        return tuple(outs)
    return tuple(o[0] for o in outs) + tuple(o[1] for o in outs)


def relax_atrous(signal, view_z_in, normal_roughness, history_length, diff_confidence=None,
                 spec_confidence=None, reprojection_confidence=None, *, step_size, is_first,
                 frame_index, frustum, ortho_mode, view_z_scale, denoising_range,
                 depth_threshold, lobe_fraction, lobe_angle_fraction, phi_luminance,
                 max_luminance_relative_difference, min_material, history_threshold,
                 confidence_relaxation, specular=None,
                 roughness_encoding=RoughnessEncoding.LINEAR, sh=None, decoded=False):
    """signal (h, w, 4): at iteration 0 (rgb, 2nd moment), later (rgb, variance);
    history_length (h, w); the optional (h, w) planes IN_DIFF_CONFIDENCE, IN_SPEC_CONFIDENCE
    and the TA's specular reprojection confidence; frustum = the 9 floats right, up, forward;
    confidence_relaxation = the settings' (multiplier, normal, luminance) relaxations;
    specular = None for the diffuse signal, else the dict of the specular constants
    (roughness_fraction, normal_edge_stopping_relaxation, lobe_angle_slack,
    luminance_edge_stopping_relaxation, roughness_edge_stopping_relaxation,
    roughness_edge_stopping_enabled); roughness_encoding: how the packed roughness is
    unpacked; decoded: normal_roughness is the RGBA formats' decoded plane
    (`frontend.decode_normal_plane`, the kernel's kDec instances: no material test), else
    packed R10G10B10A2. Returns (h, w, 4) = (rgb, variance). With both signals `signal` and the
    constants of SIGNAL_CONSTS are (diffuse, specular) pairs, `specular` is given, and it
    returns the pair of outputs. With the SH variants sh is the signal's (h, w, 4) SH (a pair
    with both signals, and lobe_fraction `lobe_fraction(..., sh=True)`), and the SH outputs
    follow the signals': (signal, SH), or (diffuse, specular, diffuse SH, specular SH)."""
    global launches, dec_launches
    kw = dict(step_size=step_size, is_first=is_first, frame_index=frame_index, frustum=frustum,
              ortho_mode=ortho_mode, view_z_scale=view_z_scale,
              denoising_range=denoising_range, depth_threshold=depth_threshold,
              lobe_fraction=lobe_fraction, lobe_angle_fraction=lobe_angle_fraction,
              phi_luminance=phi_luminance,
              max_luminance_relative_difference=max_luminance_relative_difference,
              min_material=min_material, history_threshold=history_threshold,
              confidence_relaxation=confidence_relaxation, specular=specular,
              roughness_encoding=roughness_encoding, sh=sh, decoded=decoded)
    planes = (diff_confidence, spec_confidence, reprojection_confidence)
    pair = isinstance(signal, (tuple, list))
    if pair and (len(signal) != 2 or specular is None
                 or any(len(kw[n]) != 2 for n in SIGNAL_CONSTS)
                 or (sh is not None and len(sh) != 2)):
        raise ValueError("both signals: (diffuse, specular), a pair of each of "
                         f"{SIGNAL_CONSTS}, `specular`, and an SH plane each or none")
    signals = tuple(signal) if pair else (signal,)
    shs = () if sh is None else tuple(sh) if pair else (sh,)
    dev = build.kernel_device(signals[0])
    if dev is None:
        return relax_atrous_ref(signal, view_z_in, normal_roughness, history_length, *planes,
                                **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("view_z_in", view_z_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4)),
           ("history_length", history_length, (h, w))]
    ins += [(f"signal[{k}]", t, (h, w, 4)) for k, t in enumerate(signals)]
    ins += [(name, t, (h, w)) for name, t in zip(
        ("diff_confidence", "spec_confidence", "reprojection_confidence"), planes)
        if t is not None]
    ins += [(f"sh[{k}]", t, (h, w, 4)) for k, t in enumerate(shs)]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((len(signals), h, w, 4), dtype=f32, device=dev)
    out_sh = torch.empty((len(shs), h, w, 4), dtype=f32, device=dev) if shs else None
    per = [tuple(kw[n]) if pair else (kw[n], 0.0) for n in SIGNAL_CONSTS]
    w0 = G3[0] * G3[0]
    sp = specular or {}
    consts = [*frustum, ortho_mode, view_z_scale, denoising_range, depth_threshold,
              lobe_fraction, float(normal_weight_param2(lobe_angle_fraction)), per[0][0],
              per[1][0], per[2][0], history_threshold, step_size, is_first,
              *_frame_halves(frame_index), w0, w0 * w0, G3[0] * G3[1], G3[1] * G3[1],
              *confidence_relaxation, specular is not None, lobe_angle_fraction,
              *[sp.get(k, 0.0) for k in SPECULAR_CONSTS],
              build.ROUGHNESS_MODE[roughness_encoding], len(signals), *[v[1] for v in per],
              lobe_span(lobe_fraction, bool(shs)), decoded]
    second = [signals[1], out[1]] if pair else [None, None]
    sh_ptrs = [t for k in range(2) for t in ((shs[k], out_sh[k]) if k < len(shs)
                                             else (None, None))]
    build.launch("nrd_relax_atrous", [signals[0], view_z_in, normal_roughness, history_length,
                                      out[0], *planes, *second, *sh_ptrs], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    if not (pair or shs):
        return out[0]
    return tuple(out) + (tuple(out_sh) if shs else ())
