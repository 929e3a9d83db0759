"""RELAX history fix - kernel `csrc/relax_history_fix.cu` (K19).

Replaces `nrdtpu/kernels/relax_pallas.py:1499` (`relax_history_fix_pallas`). Computes
`history_fix` (`nrdtpu/passes/relax/kernels.py:1017-1131`) for one signal, or for the diffuse
and the specular signal in one launch, per pixel: where
the history is short (`history_length <= history_fix_frame_num`, and the frame number is not
1), the 24 taps of the 5x5 grid at the pixel's own stride `floor(14 / (1 + hl) + 0.5)`
(`:1034`), clamp addressing with the in-screen test (`:1069-1077`), each weighted by plane
distance, `pow(max(0.01, n . ns), power)` and material and counted only where its weight is
above 1e-4 (`:1083-1094`); elsewhere the signal passes through. The specular signal weights
its taps by the specular normal weight instead (`:1099-1114`): `angle0` / `f0` of
`get_normal_weight_params_atrous(roughness, 5, 1, 0, ...)` (`:1030-1032`) and the tap's view
vector relaxed by `roughness_edge_stopping_relaxation`. The stride is continuous, as
in XLA: the TPU kernel's hat-blended stride levels (`relax_pallas.py:1502-1503`) are not
carried over. Pixels whose history is long skip the taps. The centre's roughness, which the
specular weight reads, is unpacked with the roughness encoding (`:1024`), a template
parameter of the specular kernel. At the RGBA normal encodings it reads the decoded plane
(`decoded=`, the kDec instances: the normal .xyz, the roughness .w) and tests no material
(`:1087`, `:1103`; the record's material lane is 0). With both signals each tap's plane
distance and in-screen test serve both, and each signal has its own normal weight, min
material and accumulator (`:1083-1114`). With the SH variants (`sh`) each signal's SH plane accumulates with its
signal's tap weight where it is above 1e-4, over the same weight sum, and passes through where
the fix does not apply (`:1095-1098`, `:1111-1114`, `:1124-1130`), in the same launch: the
counterpart of the TPU kernel's `d_sh` / `s_sh` (`relax_pallas.py:1290`, `:1297-1298`).

Bound on the H100: gathers. Per pixel it reads the centre's signal, viewZ, packed normal and
history length (40 B) and, where the fix applies, 24 taps up to 2 x 14 px away; it writes
16 B (with both signals 16 B more read a tap and written; with SH 16 B more a tap and 32 B
at the centre a signal). The entry makes two launches on
the caller's stream and counts one: a prologue writes
each texel's tap record (world position and material, unpacked normal and viewZ: 32 B) into
a (h, w, 8) scratch plane that the wrapper allocates and drops after the call (118 MB at
2560x1440), then each tap reads its record and signal as three float4 (48 B) in place of
recomputing them. Where `frame_num` is 1 no pixel runs the taps: no plane, no prologue.
"""

from __future__ import annotations

import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample
from ..passes import relax as RC
from ..settings import RoughnessEncoding
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instances (kDec)
# the constants of `specular`, in the order the kernel reads them
SPECULAR_CONSTS = ("lobe_angle_fraction", "lobe_angle_slack",
                   "roughness_edge_stopping_relaxation")


def _history_fix_one(signal, view_z_in, normal_roughness, history_length, *, frustum,
                     ortho_mode, view_z_scale, depth_threshold, base_stride, frame_num,
                     normal_power, min_material, specular=None,
                     roughness_encoding=RoughnessEncoding.LINEAR, sh=None, decoded=False):
    """The plain version of one signal (the XLA stride-tap loop and the select); with `sh`
    also its SH plane, returning the pair."""
    h, w = view_z_in.shape
    dev = signal.device
    uv = resample.pixel_uv_grid(h, w, dev)
    view_z = torch.abs(view_z_in) * view_z_scale
    n, roughness, material_id = fe.unpack_normal_plane(normal_roughness, decoded,
                                                       roughness_encoding)
    x = RC.world_pos(frustum, ortho_mode, uv, view_z)
    if specular is not None:
        cv = -nm.normalize(x)
        angle0, f0 = RC.get_normal_weight_params_atrous(
            roughness, torch.full_like(roughness, 5.0), torch.ones_like(roughness), 0.0,
            specular["lobe_angle_fraction"], specular["lobe_angle_slack"])
    thr = depth_threshold * (view_z if ortho_mode == 0.0 else torch.ones_like(view_z))
    stride = torch.floor(torch.full_like(history_length, base_stride) / (1.0 + history_length)
                         + 0.5)
    apply_fix = (history_length <= frame_num) & (frame_num != 1.0)
    mat_c = torch.clamp_min(material_id, min_material)
    xs_grid = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ys_grid = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)

    acc = signal
    acc_sh = sh
    wsum = torch.ones_like(view_z)
    for j in range(-2, 3):
        for i in range(-2, 3):
            if i == 0 and j == 0:
                continue
            pos_x = xs_grid + float(i) * stride
            pos_y = ys_grid + float(j) * stride
            inside = ((pos_x >= 0) & (pos_x < w) & (pos_y >= 0) & (pos_y < h)).to(torch.float32)
            px = torch.clamp(pos_x, 0, w - 1).long()
            py = torch.clamp(pos_y, 0, h - 1).long()
            ns, _, ms = fe.unpack_normal_plane(resample.texel_fetch(normal_roughness, px, py),
                                               decoded)
            zs = torch.abs(resample.texel_fetch(view_z_in, px, py)) * view_z_scale
            uv_s = torch.stack([nm.div(px.to(torch.float32) + 0.5, w),
                                nm.div(py.to(torch.float32) + 0.5, h)], -1)
            xs = RC.world_pos(frustum, ortho_mode, uv_s, zs)
            gw = RC.get_plane_distance_weight_atrous(x, n, xs, thr)
            if specular is None:
                dw = gw * torch.pow(torch.clamp_min(nm.dot(n, ns), 0.01),
                                    max(normal_power, 0.01))
            else:
                sv = -nm.normalize(xs + specular["roughness_edge_stopping_relaxation"] * x)
                dw = gw * RC.get_specular_normal_weight_atrous(angle0, f0, n, ns, cv, sv)
            dw = dw * inside
            dw = dw * (torch.clamp_min(ms, min_material) == mat_c).to(torch.float32)
            s = resample.texel_fetch(signal, px, py)
            acc = acc + torch.where((dw > 1e-4)[..., None], s * dw[..., None], 0.0)
            wsum = wsum + torch.where(dw > 1e-4, dw, 0.0)
            if sh is not None:
                acc_sh = acc_sh + torch.where((dw > 1e-4)[..., None],
                                              resample.texel_fetch(sh, px, py) * dw[..., None], 0.0)
    fixed = torch.where(apply_fix[..., None], acc / wsum[..., None], signal)
    if sh is None:
        return fixed
    return fixed, torch.where(apply_fix[..., None], acc_sh / wsum[..., None], sh)


def relax_history_fix_ref(signal, *planes, min_material, specular=None, sh=None, **kw):
    """Plain PyTorch version of the kernel: `_history_fix_one` of the signal, or with both
    signals (`signal`, `min_material` and `sh` the pairs of the diffuse and the specular
    one's) of each signal at its own min material, the diffuse one without `specular`; the
    outputs as the wrapper returns them."""
    if not isinstance(signal, (tuple, list)):
        return _history_fix_one(signal, *planes, min_material=min_material, specular=specular,
                                sh=sh, **kw)
    outs = [_history_fix_one(sig, *planes, min_material=m, specular=sp, sh=h_, **kw)
            for sig, m, sp, h_ in zip(signal, min_material, (None, specular), sh or (None,) * 2)]
    if sh is None:
        return tuple(outs)
    return tuple(o[0] for o in outs) + tuple(o[1] for o in outs)


def relax_history_fix(signal, view_z_in, normal_roughness, history_length, *, frustum,
                      ortho_mode, view_z_scale, depth_threshold, base_stride, frame_num,
                      normal_power, min_material, specular=None,
                      roughness_encoding=RoughnessEncoding.LINEAR, sh=None, decoded=False):
    """signal (h, w, 4) = the accumulated history (rgb, 2nd moment), or the pair (diffuse,
    specular) of them with min_material the pair of their min materials and `specular` given;
    history_length (h, w) after TA; frustum = the 9 floats right, up, forward; base_stride =
    historyFixBasePixelStride, frame_num = historyFixFrameNum + 1; specular = None for the
    diffuse signal, else dict(lobe_angle_fraction, lobe_angle_slack,
    roughness_edge_stopping_relaxation); roughness_encoding: how the packed roughness is
    unpacked; sh: None, or the signal's (h, w, 4) SH plane (the pair with both signals);
    decoded: normal_roughness is the RGBA formats' decoded plane (`frontend.decode_normal_plane`,
    the kernel's kDec instances: no material test), else packed R10G10B10A2. Returns (h, w, 4),
    or the pair of them: the reconstruction where the fix applies, the signal elsewhere; with
    `sh` (signal, SH), or with both signals (diffuse, specular, diffuse SH, specular SH)."""
    global launches, dec_launches
    kw = dict(frustum=frustum, ortho_mode=ortho_mode, view_z_scale=view_z_scale,
              depth_threshold=depth_threshold, base_stride=base_stride, frame_num=frame_num,
              normal_power=normal_power, min_material=min_material, specular=specular,
              roughness_encoding=roughness_encoding, sh=sh, decoded=decoded)
    pair = isinstance(signal, (tuple, list))
    if pair and (len(signal) != 2 or len(min_material) != 2 or specular is None
                 or (sh is not None and len(sh) != 2)):
        raise ValueError("both signals: (diffuse, specular), a min material each, `specular`, "
                         "an SH plane each or none")
    signals = tuple(signal) if pair else (signal,)
    shs = () if sh is None else tuple(sh) if pair else (sh,)
    dev = build.kernel_device(signals[0])
    if dev is None:
        return relax_history_fix_ref(signal, view_z_in, normal_roughness, history_length, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("view_z_in", view_z_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4)),
           ("history_length", history_length, (h, w))]
    for name, t, shape in ins + [(f"signal[{k}]", t, (h, w, 4)) for k, t in enumerate(signals)]:
        build.check(name, t, dev, f32, shape)
    for k, t in enumerate(shs):
        build.check(f"sh[{k}]", t, dev, f32, (h, w, 4))
    out = torch.empty((len(signals), h, w, 4), dtype=f32, device=dev)
    out_sh = torch.empty((len(shs), h, w, 4), dtype=f32, device=dev) if shs else None
    records = (torch.empty((h, w, 8), dtype=f32, device=dev) if frame_num != 1.0 else None)
    sp = specular or {}
    mats = tuple(min_material) if pair else (min_material, 0.0)
    consts = [*frustum, ortho_mode, view_z_scale, depth_threshold, base_stride, frame_num,
              max(normal_power, 0.01), mats[0], specular is not None,
              *[sp.get(k, 0.0) for k in SPECULAR_CONSTS],
              build.ROUGHNESS_MODE[roughness_encoding], len(signals), mats[1], decoded]
    second = [signals[1], out[1]] if pair else [None, None]
    sh_ptrs = [t for k in range(2) for t in ((shs[k], out_sh[k]) if k < len(shs)
                                             else (None, None))]
    build.launch("nrd_relax_history_fix", [signals[0]] + [t for _, t, _ in ins]
                 + [out[0], records] + second + sh_ptrs, consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    if not (pair or shs):
        return out[0]
    return tuple(out) + (tuple(out_sh) if shs else ())
