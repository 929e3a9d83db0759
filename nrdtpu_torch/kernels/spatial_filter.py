"""REBLUR spatial filter of one signal, diffuse and specular, its centre's geometry and
parameters included - kernel `csrc/spatial_filter.cu` (H2).

Replaces `nrdtpu/kernels/reblur_blur2.py:264` (`spatial_filter_taps_pallas2`) and v1
`reblur_pallas.py:1207`, run three times a frame by REBLUR_DIFFUSE and REBLUR_SPECULAR: PrePass,
Blur and PostBlur. Computes `diffuse_pre_pass` (`nrdtpu/passes/reblur/kernels.py:2075`),
`diffuse_spatial_filter` (`:763`) and `specular_spatial_filter` (`:1564`) with their geometry
(`:1783`): per pixel, the frame geometry (`passes/reblur/params.py:filter_geometry`: viewZ,
the normal and its view-space rotation, the view position and direction, the frustum size, the
plane-distance parameters, the hit-distance scale and the specular magic curve), the stage's
parameters (`params.diff_spatial_params`, `spec_spatial_params`: the scaled rotator, the
radius, the normal, hit-distance and roughness weights), then for each of the 8 Poisson taps
(6 in performance mode) the tap snapped to a pixel centre, its plane-distance, material,
normal-angle, hit-distance and Gaussian weights, and the float4 signal accumulated. The
specular PrePass also takes the stochastic minimum of the taps' hit distances,
hitDistForTracking (`:1732-1743`), with 8 (6) random numbers drawn per pixel from
`hash_init(pixel, frame_index)` in tap order, as the XLA loop draws them.

The checkerboard PrePass (`cb`, the mode's has-data parity; `reblur_blur2.py:270` `has_cb`)
takes the signal expanded from half width. The kernel computes each pixel's has_data from its
position, the frame index and the parity; the centre's hit distance is zeroed where it has no
data before its parameters are computed, the centre weighs has_data in the sum, the taps read
the expanded signal, and where the weight sum is 0 the kernel writes the horizontal neighbour
resolve (`cb_neighbor_resolve`, `nrdtpu/passes/reblur/kernels.py:743-762`). This is what
`diffuse_pre_pass(cb_mask=)` and `specular_spatial_filter(PRE_BLUR, cb_mask=)` compute, with the
fallback that JAX applies as glue after the TPU kernel.

With the SH variants (`sh`, the signal's SH1, (h, w, 4)) the SH rides the same taps: each
tap's SH weighed by the tap's final weight (`nrdtpu/passes/reblur/kernels.py:870-877`,
`:1751-1761`, `:2186-2193`). The diffuse filter sums all four channels; the specular filter
sums three and keeps the centre's `.w`, as the XLA functions do. The checkerboard PrePass takes
no SH (the SH variants raise under checkerboard).

The occlusion variants' signal is the (h, w, 1) normalized hit distance, which their Blur and
PostBlur filter (they run no PrePass): the kernel's one-channel instances (`kOcc`) read and
write one float a pixel, and the min hit-distance weight of their parameters drops its
sqrt(nlas) (`params.diff_spatial_params(occlusion=True)`, `nrdtpu/passes/reblur/kernels.py:814`,
`:1655`).

At SQRT_LINEAR and SQ_LINEAR roughness (`roughness_encoding`, the specular filter) the kernel
takes IN_NORMAL_ROUGHNESS as packed: the reference computes the centre's geometry and
parameters from the packed roughness (`unpack_nr3`, `nrdtpu/passes/reblur/kernels.py:37-42`,
`:1576`) and decodes each tap's (`:1716`), so the `kRough` instances decode at the taps only.

At the RGBA normal encodings (`decoded`) the kernel takes the plane that the frame decodes once
(`frontend.decode_normal_plane`, its roughness decoded as well, at LINEAR): the reference reads
the centre decoded there too (`unpack_nr3` falls back to `unpack_nr`), so its `kDec` instances
read the normal from .xyz and the roughness from .w at the centre and the taps, and test no
material (the RGBA formats carry none).

The kernel takes the raw planes (the signal, viewZ, the packed normal and, for Blur and
PostBlur, the accumulation speed and `geometry`, the (unpacked normal, scaled viewZ) plane that
H3 (`history_fix`) returns) and the frame constants (`sc`, `dc`); no parameter plane. The
PrePass's taps unpack their geometry from the packed planes. The tap loop is the
device function `sf_filter` of `csrc/reblur_filters.cuh`, shared with N4 and K23, whose glue
still passes parameter planes (`taps_ref` is its plain version).

Bound on the H100: gathers. Per pixel at 2560x1440 it reads the signal, viewZ, the packed
normal and the accumulation speed (40 B), writes the signal (16 B, + 4 B hitDistForTracking),
and reads 8 taps of signal and geometry (8 x 36 B) scattered over a radius of up to 60 px; taps
land in L1/L2 for small radii and miss for large ones. The centre computes ~150-250
operations (`chip_smoke.py:SF_GEOM_OPS`, `SF_PARAM_OPS`) against ~8 x 110 in the taps.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import resample, stencil
from ..passes.reblur import common as C
from ..passes.reblur import params as P
from ..settings import RoughnessEncoding
from . import build

launches = 0
cb_launches = 0  # of them, the checkerboard PrePass instances
rough_launches = 0  # of them, the specular instances that decode the taps' roughness (kRough)
dec_launches = 0  # of them, the instances on the decoded plane of the RGBA formats (kDec)
NRD_DISOCCLUSION_THRESHOLD = 0.02  # `nrdtpu/passes/reblur/common.py:42`

# per-pixel planes of the tap loop, in order (`taps_ref`; N4's and K23's glue stacks them):
# shared by the signals of a pixel, and the signal's own
SHARED = ("ga", "gb", "nx", "ny", "nz", "nvx", "nvy", "nvz")
PARAMS = ("rot0", "rot1", "rot2", "rot3", "normal_weight_param", "ha", "hb",
          "min_hit_dist_weight")
SPEC_PARAMS = ("wr_a", "wr_b")
PREPASS_PARAMS = ("hit_dist", "roughness", "xvx", "xvy", "xvz")
MODES = {len(PARAMS): "diffuse", len(PARAMS + SPEC_PARAMS): "spec",
         len(PARAMS + SPEC_PARAMS + PREPASS_PARAMS): "spec_prepass"}


def tap_table(perf_mode: bool) -> np.ndarray:
    """(taps, 3) float32: offset x, offset y, Gaussian weight of the tap radius."""
    taps = nm.SPECIAL_6 if perf_mode else nm.SPECIAL_8
    return np.array([(t[0], t[1], nm.get_gaussian_weight(float(t[2]))) for t in taps],
                    np.float32)


def ntaps(perf_mode: bool) -> int:
    """The kernels' tap count: their table is `tap_table` at compile time
    (`csrc/reblur_filters.cuh:poisson_tap`)."""
    return len(nm.SPECIAL_6 if perf_mode else nm.SPECIAL_8)


def cb_mask(h, w, frame_index, parity, device=None):
    """(h, w) float32: 1 where a pixel has data under the checkerboard of has-data parity
    `parity` (int(mode) - 1), else 0 (`nrdtpu/passes/reblur/denoiser.py:189-195`)."""
    return nm.checkerboard_has_data(h, w, frame_index, parity + 1, device).to(torch.float32)


def cb_neighbor_resolve(signal, view_z, frustum_size, nov, denoising_range):
    """The checkerboard fallback (`nrdtpu/passes/reblur/kernels.py:743-762`,
    REBLUR_PrePass.hlsli:45-57): the expanded signal (h, w, 4) at x - 1 and x + 1, each weighed
    1 where its scaled viewZ lies within the disocclusion threshold of the centre's, 0 beyond
    the denoising range or off the edge columns, normalized by the weights' sum (0 where both
    are 0)."""
    w = view_z.shape[1]
    thr = nm.get_disocclusion_threshold(NRD_DISOCCLUSION_THRESHOLD, frustum_size, nov)
    z0 = stencil.shifted(view_z, 0, -1)
    z1 = stencil.shifted(view_z, 0, 1)
    col = torch.arange(w, device=view_z.device)[None, :]
    w0 = (torch.abs(z0 - view_z) <= thr).to(torch.float32)
    w1 = (torch.abs(z1 - view_z) <= thr).to(torch.float32)
    w0 = torch.where((z0 > denoising_range) | (col < 1), 0.0, w0)
    w1 = torch.where((z1 > denoising_range) | (col >= w - 1), 0.0, w1)
    wsum = w0 + w1
    inv = torch.where(wsum == 0.0, 0.0, 1.0 / torch.clamp_min(wsum, 1e-15))
    return (stencil.shifted(signal, 0, -1) * (w0 * inv)[..., None]
            + stencil.shifted(signal, 0, 1) * (w1 * inv)[..., None])


def taps_ref(signal, view_z_in, normal_roughness, shared, params, *, frustum, rect_size,
             view_z_scale, ortho_mode, min_material, perf_mode, prepass=None, cb=None, sh=None,
             roughness_encoding=RoughnessEncoding.LINEAR, decoded=False):
    """The XLA tap loop on the centre's planes: shared named by SHARED (8, h, w), params by
    PARAMS (+ SPEC_PARAMS (+ PREPASS_PARAMS)); the specular PrePass mode takes `prepass` =
    dict(hit_dist_params (A, B, C, D), use_prepass_not_only, frame_index); the checkerboard
    PrePass `cb` = dict(mask: the (h, w) has-data plane, the centre's weight; resolve: the
    (h, w, 4) fallback written where the weight sum is 0); `sh`: the signal's SH1 (h, w, 4),
    filtered with the taps' final weights (all four channels in the diffuse mode; three, the
    centre's `.w` kept, in the specular modes); roughness_encoding: how the taps' roughness
    in normal_roughness is packed; decoded: normal_roughness is the RGBA formats' decoded plane
    (its material 0). Returns the filtered signal (h, w, 4), in the PrePass mode also
    hitDistForTracking (h, w), and with `sh` last the filtered SH."""
    h, w = view_z_in.shape
    mode = MODES[params.shape[0]]
    p = dict(zip(SHARED, shared))
    p.update(zip(PARAMS + SPEC_PARAMS + PREPASS_PARAMS, params))
    uv = resample.pixel_uv_grid(h, w, signal.device)
    rot = torch.stack([p["rot0"], p["rot1"], p["rot2"], p["rot3"]], -1)
    n = torch.stack([p["nx"], p["ny"], p["nz"]], -1)
    nv = torch.stack([p["nvx"], p["nvy"], p["nvz"]], -1)
    material_id = fe.unpack_normal_plane(normal_roughness, decoded)[2]
    rw, rh = float(rect_size[0]), float(rect_size[1])

    if sh is not None and cb is not None:
        raise ValueError("the checkerboard PrePass takes no SH")
    sum_ = torch.ones_like(view_z_in) if cb is None else cb["mask"]
    acc = signal if cb is None else signal * cb["mask"][..., None]
    acc_sh = sh
    if mode == "spec_prepass":
        hit_dist = p["hit_dist"]
        hdt = torch.where(hit_dist == 0.0, fe.NRD_INF, hit_dist)
        xv = torch.stack([p["xvx"], p["xvy"], p["xvz"]], -1)
        state = nm.hash_init(torch.arange(w, device=signal.device)[None, :].expand(h, w),
                             torch.arange(h, device=signal.device)[:, None].expand(h, w),
                             prepass["frame_index"])
        rough_lerp = nm.linearstep(0.5, 1.0, p["roughness"])
    for ox, oy, gw in tap_table(perf_mode):
        ox, oy = float(ox), float(oy)
        us = uv[..., 0] + (ox * rot[..., 0] + oy * rot[..., 2])
        vs = uv[..., 1] + (ox * rot[..., 1] + oy * rot[..., 3])
        uv_s = torch.stack([nm.div(torch.floor(us * rw) + 0.5, rw),
                            nm.div(torch.floor(vs * rh) + 0.5, rh)], -1)
        zs = torch.abs(resample.sample_nearest(view_z_in, uv_s)) * view_z_scale
        nr_s = resample.sample_nearest(normal_roughness, uv_s)
        ns, rs, ms = fe.unpack_normal_plane(nr_s, decoded, roughness_encoding)
        angle = nm.acos_approx(nm.dot(n, ns))
        xvs = nm.reconstruct_view_position(uv_s, frustum, zs, ortho_mode)
        w_ = resample.is_in_screen_nearest(uv_s)
        w_ = w_ * nm.compute_weight(nm.dot(nv, xvs), p["ga"], p["gb"])
        w_ = w_ * (torch.clamp_min(material_id, min_material)
                   == torch.clamp_min(ms, min_material)).to(torch.float32)
        w_ = w_ * nm.compute_weight(angle, p["normal_weight_param"], 0.0)
        if mode != "diffuse":
            w_ = w_ * nm.compute_weight(rs, p["wr_a"], p["wr_b"])
        s = resample.sample_nearest(signal, uv_s)
        s = torch.where((w_ == 0.0)[..., None], 0.0, s)
        if mode == "spec_prepass":
            hs = s[..., -1] * fe.get_hit_distance_normalization(zs, prepass["hit_dist_params"],
                                                                rs)
            d = nm.length(xvs - xv) + fe.NRD_EPS
            geometry_weight = w_ * nm.saturate(hs / d)
            state, rnd = nm.hash_float(state)
            take = (rnd < geometry_weight) & (hs > 0.0)
            hdt = torch.where(take, torch.minimum(hdt, hs), hdt)
            w_ = w_ * prepass["use_prepass_not_only"]
            t = hs / (d + hit_dist)
            w_ = w_ * nm.lerp(nm.saturate(t), 1.0, rough_lerp)
        w_ = w_ * nm.lerp(p["min_hit_dist_weight"], 1.0,
                          nm.compute_exponential_weight(s[..., -1], p["ha"], p["hb"]))
        w_ = w_ * float(gw)
        sum_ = sum_ + w_
        acc = acc + s * w_[..., None]
        if sh is not None:
            sh_s = resample.sample_nearest(sh, uv_s)
            sh_s = torch.where((w_ == 0.0)[..., None], 0.0, sh_s)
            if mode == "diffuse":
                acc_sh = acc_sh + sh_s * w_[..., None]
            else:
                acc_sh = torch.cat([acc_sh[..., :3] + sh_s[..., :3] * w_[..., None],
                                    acc_sh[..., 3:]], -1)
    inv = (1.0 / torch.clamp_min(sum_, 1e-15))[..., None]
    out = acc * inv
    if cb is not None:
        out = torch.where((sum_ == 0.0)[..., None], cb["resolve"], out)
    res = (out, torch.where(hdt == fe.NRD_INF, 0.0, hdt)) if mode == "spec_prepass" else (out,)
    if sh is not None:
        res += (acc_sh * inv if mode == "diffuse"
                else torch.cat([acc_sh[..., :3] * inv, acc_sh[..., 3:]], -1),)
    return res if len(res) > 1 else out


def check_params(params, prepass):
    """The mode of `params` (8 | 10 | 15 planes); raise unless `prepass` goes with it."""
    if params.shape[0] not in MODES:
        raise ValueError(f"params: {params.shape[0]} planes")
    prepass_mode = MODES[params.shape[0]] == "spec_prepass"
    if prepass_mode != (prepass is not None):
        raise ValueError("the specular PrePass mode and only it takes `prepass`")
    return prepass_mode


def prepass_inputs(sc, dc):
    """`taps_ref`'s `prepass` of the frame: hit-distance parameters, the prepass-only flag and
    the frame index."""
    not_only = float(dc["use_prepass_not_only_for_specular_motion_estimation"])
    return dict(hit_dist_params=_v(dc["hit_dist_params"]), use_prepass_not_only=not_only,
                frame_index=int(sc["frame_index"]))


def prepass_consts(prepass):
    """Launch constants of the specular PrePass: hit-distance parameters, the prepass-only
    flag and the frame index as two 16-bit halves (a float carries neither half exactly
    beyond 2^24)."""
    f = int(prepass["frame_index"]) & 0xFFFFFFFF
    return [*prepass["hit_dist_params"], prepass["use_prepass_not_only"], f & 0xFFFF, f >> 16]


ROTATORS = {P.PRE_BLUR: "rotator_pre", P.BLUR: "rotator", P.POST_BLUR: "rotator_post"}


def min_material(dc, spec):
    return float(dc["spec_min_material" if spec else "diff_min_material"])


def cb_ref(signal, view_z, frustum_size, nov, *, frame_index, parity, denoising_range):
    """`taps_ref`'s `cb` of a checkerboard PrePass: the has-data plane and the fallback."""
    h, w = view_z.shape
    return dict(mask=cb_mask(h, w, frame_index, parity, signal.device),
                resolve=cb_neighbor_resolve(signal, view_z, frustum_size, nov, denoising_range))


def spatial_filter_ref(signal, view_z_in, normal_roughness, data1=None, *, sc, dc, mode, spec,
                       enc_err, perf_mode, geometry=None, cb=None, sh=None,
                       roughness_encoding=RoughnessEncoding.LINEAR, decoded=False):
    """Plain PyTorch version of the kernel: the centre's planes that the kernel computes per
    pixel, from the pass glue's torch functions (`params.filter_geometry`,
    `diff_spatial_params`, `spec_spatial_params`; under checkerboard on the centre signal
    zeroed where it has no data), then the XLA tap loop (`taps_ref`); the taps unpack their
    geometry from normal_roughness and view_z_in, the values of `geometry`, and decode their
    roughness by `roughness_encoding` (the centre's stays as packed); decoded: the RGBA
    formats' decoded plane, read as it is at the centre and the taps."""
    geom = P.filter_geometry(sc, dc, view_z_in, normal_roughness, enc_err,
                             ("spec",) if spec else ("diff",), decoded=decoded)
    shared = torch.stack([geom["ga"], geom["gb"], *geom["n3"], *geom["nv3"]])
    centre, cbd = signal, None
    if cb is not None:
        cbd = cb_ref(signal, geom["view_z"], geom["frustum_size"], geom["nov"],
                     frame_index=int(sc["frame_index"]), parity=cb,
                     denoising_range=float(sc["denoising_range"]))
        centre = signal * cbd["mask"][..., None]
    params = (P.spec_spatial_params if spec else P.diff_spatial_params)(
        sc, dc, mode, geom, centre, data1, occlusion=signal.shape[-1] == 1)
    prepass = prepass_inputs(sc, dc) if spec and mode == P.PRE_BLUR else None
    return taps_ref(signal, view_z_in, normal_roughness, shared, params,
                    frustum=_v(sc["frustum"]), rect_size=_v(sc["rect_size"]),
                    view_z_scale=float(sc["view_z_scale"]), ortho_mode=float(sc["ortho_mode"]),
                    min_material=min_material(dc, spec), perf_mode=perf_mode, prepass=prepass,
                    cb=cbd, sh=sh, roughness_encoding=roughness_encoding, decoded=decoded)


def launch_consts(sc, dc, mode, spec, enc_err, perf_mode, cb=None, sh=False, occlusion=False,
                  roughness_encoding=RoughnessEncoding.LINEAR, decoded=False):
    """The kernel's host constants, each the float32 value that the plain version's torch ops
    see (`csrc/spatial_filter.cu:nrd_spatial_filter` lists them)."""
    fraction_scale, radius_scale = P.STAGE_SCALES[mode]
    fade_a, fade_ba = C.fade_bounds(dc)
    laf = float(dc["lobe_angle_fraction"])
    wtv = np.asarray(sc["world_to_view"], np.float32)[:3, :3].reshape(-1)
    radius = dc["spec_prepass_blur_radius" if spec else "diff_prepass_blur_radius"]
    prepass = prepass_inputs(sc, dc)
    return [*_v(sc["frustum"]), *_v(sc["rect_size"]), *_v(sc["rect_size_inv"]),
            float(sc["view_z_scale"]), float(sc["ortho_mode"]), *wtv,
            float(sc["min_rect_dim_mul_unproject"]), float(sc["unproject"]),
            float(dc["plane_dist_sensitivity"]), *prepass["hit_dist_params"], laf, 1.0 - laf,
            enc_err, float(dc["max_blur_radius"]), float(dc["min_blur_radius"]), float(radius),
            fade_a, fade_ba, *_v(sc[ROTATORS[mode]]), fraction_scale, radius_scale,
            P.min_hit_dist_weight_scale(dc, fraction_scale),
            P.roughness_fraction_scaled(dc, fraction_scale), min_material(dc, spec),
            ntaps(perf_mode), mode, spec, *prepass_consts(prepass)[4:],
            -1 if cb is None else int(cb), float(sc["denoising_range"]), bool(sh),
            bool(occlusion), build.ROUGHNESS_MODE[roughness_encoding], bool(decoded)]


def spatial_filter(signal, view_z_in, normal_roughness, data1=None, *, sc, dc, mode, spec,
                   enc_err, perf_mode, geometry=None, cb=None, sh=None,
                   roughness_encoding=RoughnessEncoding.LINEAR, decoded=False):
    """signal (h, w, 4), or with the occlusion variants (h, w, 1) (Blur and PostBlur only, no
    SH), view_z_in (h, w), normal_roughness (h, w, 4), its roughness packed by
    `roughness_encoding` (only the specular filter reads it; the diffuse filter takes LINEAR),
    data1 (h, w) the accumulation speed (Blur and PostBlur; None in the PrePass); sc, dc: the
    frame constants; mode: params.PRE_BLUR, BLUR or POST_BLUR; spec: the specular filter;
    enc_err: the normal encoding's error; geometry: in Blur and PostBlur the tap geometry (h, w,
    4) that `history_fix` returns, None in the PrePass; cb: in a checkerboard PrePass the
    mode's has-data parity (int(CheckerboardMode) - 1, 0 or 1), the signal expanded from half
    width; else None; sh: with the SH variants the signal's SH1 (h, w, 4), not under
    checkerboard; decoded: normal_roughness is the RGBA formats' decoded plane
    (`frontend.decode_normal_plane` with its roughness decoded, at LINEAR; the kernel's kDec
    instances), else packed R10G10B10A2. Returns the filtered signal (of the input's shape), in
    the specular PrePass also hitDistForTracking (h, w), and with `sh` last the filtered SH
    (h, w, 4)."""
    global launches, cb_launches, rough_launches, dec_launches
    if not spec and roughness_encoding != RoughnessEncoding.LINEAR:
        raise ValueError("the diffuse filter reads no roughness: it takes LINEAR")
    if decoded and roughness_encoding != RoughnessEncoding.LINEAR:
        raise ValueError("decoded: the plane's roughness is decoded: it takes LINEAR")
    kw = dict(sc=sc, dc=dc, mode=mode, spec=bool(spec), enc_err=enc_err, perf_mode=perf_mode,
              geometry=geometry, cb=cb, sh=sh, roughness_encoding=roughness_encoding,
              decoded=decoded)
    prepass = mode == P.PRE_BLUR
    if prepass != (data1 is None) or prepass != (geometry is None):
        raise ValueError("data1 and geometry (the history fix's tap-geometry plane) go with "
                         "Blur and PostBlur, not with the PrePass")
    if cb not in (None, 0, 1) or (cb is not None and not prepass):
        raise ValueError(f"cb: {cb!r}; the checkerboard parity (0 or 1) goes with the PrePass")
    if cb is not None and sh is not None:
        raise ValueError("the checkerboard PrePass takes no SH")
    c = build.channels("signal", signal, sh)
    if c == 1 and prepass:
        raise ValueError("the one-channel (occlusion) signal goes with Blur and PostBlur")
    dev = build.kernel_device(signal)
    if dev is None:
        return spatial_filter_ref(signal, view_z_in, normal_roughness, data1, **kw)
    h, w = view_z_in.shape
    ins = [("signal", signal, (h, w, c)), ("view_z_in", view_z_in, (h, w)),
           ("normal_roughness", normal_roughness, (h, w, 4))]
    if not prepass:
        ins += [("data1", data1, (h, w)), ("geometry", geometry, (h, w, 4))]
    if sh is not None:
        ins.append(("sh", sh, (h, w, 4)))
    for name, t, shape in ins:
        build.check(name, t, dev, torch.float32, shape)
    out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    hdt = torch.empty((h, w), dtype=torch.float32, device=dev) if spec and prepass else None
    out_sh = None if sh is None else torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    build.launch("nrd_spatial_filter", [signal, view_z_in, normal_roughness, data1, geometry,
                                        out, hdt, sh, out_sh],
                 launch_consts(sc, dc, mode, bool(spec), enc_err, perf_mode, cb, sh is not None,
                               c == 1, roughness_encoding, decoded), w, h)
    launches += 1
    cb_launches += cb is not None
    rough_launches += roughness_encoding != RoughnessEncoding.LINEAR
    dec_launches += bool(decoded)
    res = (out, hdt) if spec and prepass else (out,)
    if sh is not None:
        res += (out_sh,)
    return res if len(res) > 1 else out


def _v(x):
    return [float(c) for c in np.asarray(x, np.float32).reshape(-1)]
