"""RELAX history fix - kernel `csrc/relax_history_fix.cu` (K19).

Replaces `nrdtpu/kernels/relax_pallas.py:1499` (`relax_history_fix_pallas`). Computes
`history_fix` (`nrdtpu/passes/relax/kernels.py:1017-1131`) for one signal per pixel: where
the history is short (`history_length <= history_fix_frame_num`, and the frame number is not
1), the 24 taps of the 5x5 grid at the pixel's own stride `floor(14 / (1 + hl) + 0.5)`
(`:1034`), clamp addressing with the in-screen test (`:1069-1077`), each weighted by plane
distance, `pow(max(0.01, n . ns), power)` and material and counted only where its weight is
above 1e-4 (`:1083-1094`); elsewhere the signal passes through. The specular signal weights
its taps by the specular normal weight instead (`:1099-1114`): `angle0` / `f0` of
`get_normal_weight_params_atrous(roughness, 5, 1, 0, ...)` (`:1030-1032`) and the tap's view
vector relaxed by `roughness_edge_stopping_relaxation`. The stride is continuous, as
in XLA: the TPU kernel's hat-blended stride levels (`relax_pallas.py:1502-1503`) are not
carried over. Pixels whose history is long skip the taps.

Bound on the H100: gathers. Per pixel it reads the centre's signal, viewZ, packed normal and
history length (40 B) and, where the fix applies, 24 taps up to 2 x 14 px away; it writes
16 B. The entry makes two launches on the caller's stream and counts one: a prologue writes
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
from . import build

launches = 0
# the constants of `specular`, in the order the kernel reads them
SPECULAR_CONSTS = ("lobe_angle_fraction", "lobe_angle_slack",
                   "roughness_edge_stopping_relaxation")


def relax_history_fix_ref(signal, view_z_in, normal_roughness, history_length, *, frustum,
                          ortho_mode, view_z_scale, depth_threshold, base_stride, frame_num,
                          normal_power, min_material, specular=None):
    """Plain PyTorch version of the kernel (the XLA stride-tap loop and the select)."""
    h, w = view_z_in.shape
    dev = signal.device
    uv = resample.pixel_uv_grid(h, w, dev)
    view_z = torch.abs(view_z_in) * view_z_scale
    n, roughness, material_id = fe.unpack_normal_roughness(normal_roughness)
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
            ns, _, ms = fe.unpack_normal_roughness(resample.texel_fetch(normal_roughness, px, py))
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
    return torch.where(apply_fix[..., None], acc / wsum[..., None], signal)


def relax_history_fix(signal, view_z_in, normal_roughness, history_length, *, frustum,
                      ortho_mode, view_z_scale, depth_threshold, base_stride, frame_num,
                      normal_power, min_material, specular=None):
    """signal (h, w, 4) = the accumulated history (rgb, 2nd moment); history_length (h, w)
    after TA; frustum = the 9 floats right, up, forward; base_stride =
    historyFixBasePixelStride, frame_num = historyFixFrameNum + 1; specular = None for the
    diffuse signal, else dict(lobe_angle_fraction, lobe_angle_slack,
    roughness_edge_stopping_relaxation). Returns (h, w, 4): the reconstruction where the fix
    applies, the signal elsewhere."""
    global launches
    kw = dict(frustum=frustum, ortho_mode=ortho_mode, view_z_scale=view_z_scale,
              depth_threshold=depth_threshold, base_stride=base_stride, frame_num=frame_num,
              normal_power=normal_power, min_material=min_material, specular=specular)
    dev = build.kernel_device(signal)
    if dev is None:
        return relax_history_fix_ref(signal, view_z_in, normal_roughness, history_length, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("signal", signal, (h, w, 4)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4)),
           ("history_length", history_length, (h, w))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((h, w, 4), dtype=f32, device=dev)
    records = (torch.empty((h, w, 8), dtype=f32, device=dev) if frame_num != 1.0 else None)
    sp = specular or {}
    consts = [*frustum, ortho_mode, view_z_scale, depth_threshold, base_stride, frame_num,
              max(normal_power, 0.01), min_material, specular is not None,
              *[sp.get(k, 0.0) for k in SPECULAR_CONSTS]]
    build.launch("nrd_relax_history_fix", [t for _, t, _ in ins] + [out, records], consts, w,
                 h)
    launches += 1
    return out
