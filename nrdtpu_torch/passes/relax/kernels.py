"""RELAX passes, diffuse and specular - counterpart of the XLA functions in
`nrdtpu/passes/relax/kernels.py` (RELAX_*.hlsli). Pipeline (Relax.cpp:182-293): ClassifyTiles
-> [HitDistReconstruction] -> PrePass -> TemporalAccumulation -> HistoryFix ->
HistoryClamping -> [AntiFirefly] -> A-trous x N -> SplitScreen.

Each pass is elementwise torch glue around hand-written kernels of `nrdtpu_torch.kernels`:

  pre_pass                -> relax_prepass        (Poisson-8 taps at the per-pixel radius)
  temporal_accumulation   -> relax_smb_resolve    (surface-motion footprint, history length,
                                                   CatRom of the slow and responsive history)
  temporal_accumulation_specular
                          -> relax_smb_resolve    (the same, with the specular 3x3 planes)
                          -> nearest_multi        (the curvature's high-parallax texel)
                          -> relax_vmb_resolve    (virtual-motion footprint and histories)
                          -> bilinear_resolve     (the previous normals 1 and 2 steps back)
  history_fix             -> relax_history_fix    (5x5 stride taps of short histories)
  history_clamping        -> relax_clamp_moments  (the responsive history's select, the 5x5
                                                   moments and the whole clamp, one launch)
  anti_firefly            -> relax_antifirefly    (3x3 RCRS of the slow history)
  atrous                  -> relax_atrous         (one 3x3 iteration; iteration 0 with the
                                                   variance prefilter and the 5x5 estimation)

Signals are (h, w, 4): radiance and, depending on the stage, raw hitT, the luminance's second
moment or its variance. The glue keeps the op order of the XLA functions; the kernels compute
the per-pixel formulas of the XLA gathers, not the TPU kernels' workarounds. Each pass takes
one signal, named by `which` ("diff" / "spec"); the TA has one function a signal around a
shared head (`_surface_motion`), so that the two-signal frame adds its own beside them. The
SH and checkerboard branches are not ported. Frame constants (`sc`, `dc`) are host values.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ... import math as nm
from ... import vec3 as v3
from ...kernels import bilinear_resolve as k_bilinear
from ...kernels import nearest_multi as k_nearest_multi
from ...kernels import relax_antifirefly as k_antifirefly
from ...kernels import relax_atrous as k_atrous
from ...kernels import relax_clamp_moments as k_clamp_moments
from ...kernels import relax_history_fix as k_history_fix
from ...kernels import relax_prepass as k_prepass
from ...kernels import relax_smb_resolve as k_smb_resolve
from ...kernels import relax_vmb_resolve as k_vmb_resolve
from ...ops import resample, stencil, tiles
from ..reblur import kernels as RK
from . import (
    F32,
    RELAX_ANTILAG_ACCELERATION_AMOUNT_SCALE,
    RELAX_NORMAL_ULP,
    frustum_consts,
    get_normal_weight_param2,
    get_spec_lobe_tan_half_angle,
    unpack_prev_normal_roughness,
    unpack_view_z,
    world_pos_from_uv3,
)

NRD_CURVATURE_Z_THRESHOLD = 0.1


def _v(x):
    return [float(c) for c in np.asarray(x, np.float32).reshape(-1)]


def _frame_geometry(sc):
    """The constants every RELAX kernel reads: frustum vectors, ortho mode, viewZ scale."""
    return dict(frustum=frustum_consts(sc), ortho_mode=float(sc["ortho_mode"]),
                view_z_scale=float(sc["view_z_scale"]))


# ---------------------------------------------------------------------------
# ClassifyTiles (sky-only map, as REBLUR)
# ---------------------------------------------------------------------------


def classify_tiles(sc, view_z):
    return tiles.classify_sky_tiles(unpack_view_z(sc, view_z), float(sc["denoising_range"]))


def dead_mask(sc, tile_map, view_z):
    """Sky tile or beyond the denoising range (True = pass the input through)."""
    h, w = view_z.shape
    sky = tiles.tile_upsample_nearest(tile_map, h, w)
    return (sky > 0.0) | (unpack_view_z(sc, view_z) > float(sc["denoising_range"]))


# ---------------------------------------------------------------------------
# PrePass (RELAX_PrePass.hlsli), diffuse
# ---------------------------------------------------------------------------


def pre_pass(sc, dc, signal, view_z_in, normal_roughness, config, which: str = "diff"):
    """Poisson spatial reuse of one signal (`kernels.py:160-306`), checkerboard off: one
    `relax_prepass` launch. The specular signal also re-estimates its hitT as the min over
    the kept taps. Returns (h, w, 4)."""
    offsets, gauss = k_prepass.poisson_taps(sc["rotator_pre"])
    # get_normal_weight_param2(1, 0.25 lobe fraction) and the hit-distance weight's scale
    # (get_hit_distance_weight_params(hitT, 1/9), roughness 1): frame constants in float32
    nwp = float(get_normal_weight_param2(torch.ones(()), float(F32(0.25) * F32(
        dc["lobe_angle_fraction"]))))
    norm = F32(0.0005) + F32(1.0 - 0.0005) * F32(1.0 / 9.0)
    specular = None
    if which == "spec":
        specular = dict(unproject=float(sc["unproject"]),
                        normal_lobe_fraction=float(F32(0.5) * F32(dc["lobe_angle_fraction"])),
                        roughness_fraction=float(dc["roughness_fraction"]))
    return k_prepass.relax_prepass(
        signal, view_z_in, normal_roughness, **_frame_geometry(sc),
        denoising_range=float(sc["denoising_range"]),
        frustum_size_scale=float(F32(min(config.rect_size)) * F32(sc["unproject"])),
        blur_radius=float(dc[which + "_blur_radius"]), normal_weight_param=nwp,
        hit_dist_a=float(F32(1.0) / norm), min_hit_dist_weight=float(dc["min_hit_distance_weight"]),
        depth_threshold=float(dc["depth_threshold"]),
        min_material=float(dc[which + "_min_material"]), offsets=offsets,
        gaussian_weights=gauss, specular=specular,
        roughness_encoding=config.roughness_encoding)


# ---------------------------------------------------------------------------
# TemporalAccumulation (RELAX_TemporalAccumulation.hlsli), diffuse
# ---------------------------------------------------------------------------


def _surface_motion(sc, dc, view_z_in, normal_roughness, mv_in, state, config, histories,
                    spec_hit=None, dt_mix=None):
    """The TA's head, shared by both signals (`kernels.py:331-567`): surface-motion uv,
    parallax, disocclusion threshold, the footprint (one `relax_smb_resolve` launch that
    also samples the signal's two histories and, with `spec_hit`, gathers the specular 3x3
    planes), the footprint-quality refinements and the history length. Returns the planes
    the accumulations read."""
    h, w = view_z_in.shape
    dev = view_z_in.device
    view_z = unpack_view_z(sc, view_z_in)
    uv = resample.pixel_uv_grid(h, w, dev)
    n3 = v3.decode_oct_raw(normal_roughness[..., 0], normal_roughness[..., 1])
    material_id = normal_roughness[..., 3] * 3.0
    u_p, v_p = uv[..., 0], uv[..., 1]
    x3 = world_pos_from_uv3(sc, u_p, v_p, view_z)
    ortho = float(sc["ortho_mode"])
    is_persp = ortho == 0.0
    if is_persp:
        view_vec3 = x3
    else:
        f = np.asarray(sc["frustum_forward"], F32)
        fwd_n = f / np.sqrt(np.maximum(np.sum(f * f), F32(1e-15)))
        view_vec3 = v3.V3(view_z * float(fwd_n[0]), view_z * float(fwd_n[1]),
                          view_z * float(fwd_n[2]))
    v_3 = -v3.normalize(view_vec3)
    nov = torch.abs(v3.dot(n3, v_3))
    rw_, rh_ = _v(sc["rect_size"])
    rect_prev = _v(sc["rect_size_prev"])

    # previous position / smb uv (lines 398-415)
    mvs = _v(sc["mv_scale"])
    mv0 = mv_in[..., 0] * mvs[0]
    mv1 = mv_in[..., 1] * mvs[1]
    mv2 = mv_in[..., 2] * mvs[2]
    cd3 = v3.V3(*_v(sc["camera_delta"]))
    if mvs[3] != 0.0:  # world-space motion
        xp3 = x3 + v3.V3(mv0, mv1, mv2)
        smb_u, smb_v = v3.get_screen_uv(sc["world_to_clip_prev"], xp3)
    else:
        smb_u, smb_v = u_p + mv0, v_p + mv1
        mv_z = (v3.affine(sc["world_to_view_prev"], x3).z - view_z) if mvs[2] == 0.0 else mv2
        xp3 = world_pos_from_uv3(sc, smb_u, smb_v, view_z + mv_z, prev=True) + cd3
    uv_smb = torch.stack([smb_u, smb_v], -1)

    # parallax (lines 470-477)
    zp1_u, zp1_v = (smb_u, smb_v) if is_persp else (u_p, v_p)
    zp2_u, zp2_v = (u_p, v_p) if is_persp else (smb_u, smb_v)
    p1u, p1v = v3.get_screen_uv(sc["world_to_clip_prev"], xp3 + cd3)
    p2u, p2v = v3.get_screen_uv(sc["world_to_clip"], xp3 - cd3)
    d1x = (p1u - zp1_u) * rw_
    d1y = (p1v - zp1_v) * rh_
    d2x = (p2u - zp2_u) * rw_
    d2y = (p2v - zp2_v) * rh_
    parallax1 = torch.sqrt(d1x * d1x + d1y * d1y)
    parallax2 = torch.sqrt(d2x * d2x + d2y * d2y)
    parallax_max = torch.maximum(parallax1, parallax2)
    pixel_size = nm.pixel_radius_to_world(float(sc["unproject"]), ortho, 1.0, view_z)

    # disocclusion threshold (lines 479-486)
    if dt_mix is not None:
        mix_ = dt_mix
    else:
        mix_ = torch.where(material_id == float(sc["strand_material_id"]),
                           fe.get_normalized_strand_thickness(float(sc["strand_thickness"]),
                                                              pixel_size), 0.0)
    bonus = F32(sc["disocclusion_threshold_bonus"])
    dt0 = F32(sc["disocclusion_threshold"]) + bonus
    dt1 = F32(sc["disocclusion_threshold_alternate"]) + bonus
    disocclusion_threshold = float(dt0) + float(dt1 - dt0) * mix_

    # the footprint's thresholds (lines 426-432)
    frustum_size = pixel_size * min(config.rect_size)
    slope_scale = 1.0 / nm.lerp(nm.lerp(0.05, 1.0, nov), 1.0, nm.saturate(parallax_max / 30.0))
    base_thr = nm.saturate(disocclusion_threshold * slope_scale) * frustum_size
    m = np.asarray(sc["world_to_view_prev"], F32)
    xv_prev_z = (xp3.x * float(m[2, 0]) + xp3.y * float(m[2, 1]) + xp3.z * float(m[2, 2])
                 + float(m[2, 3]))

    smb = k_smb_resolve.relax_smb_resolve(
        uv_smb, xv_prev_z, base_thr, normal_roughness, state["view_z_prev"],
        state["material_id_prev"], state["history_length"], state["normal_roughness_prev"],
        histories, spec_hit, state["reflection_hit_t"] if spec_hit is not None else None,
        view_z_scale=float(sc["view_z_scale"]), rect_size_prev=rect_prev,
        resource_size=_v(sc["resource_size"]),
        min_material=float(min(F32(dc["spec_min_material"]), F32(dc["diff_min_material"]))),
        world_prev_to_world=sc["world_prev_to_world"])
    history_length = smb["history_length"]
    footprint_quality = smb["footprint_quality"]

    # footprint quality refinements (lines 547-562)
    if is_persp:
        v_prev = -v3.normalize(xp3 - cd3)
    else:
        f = np.asarray(sc["prev_frustum_forward"], F32)
        v_prev = v3.V3(*[float(c) for c in -f / np.sqrt(np.maximum(np.sum(f * f), F32(1e-15)))])
    nov_prev = torch.abs(v3.dot(n3, v_prev))
    size_quality = (nov_prev + 1e-3) / (nov + 1e-3)
    size_quality = size_quality * size_quality
    size_quality = size_quality * size_quality
    footprint_quality = footprint_quality * nm.lerp(0.1, 1.0,
                                                    nm.saturate(size_quality + abs(ortho)))
    history_length = torch.where(footprint_quality < 1.0,
                                 torch.clamp_min(history_length * torch.sqrt(footprint_quality),
                                                 1.0),
                                 history_length)
    if float(sc["reset_history"]) != 0.0:
        history_length = torch.ones_like(history_length)
    max_frames = F32(1.0) + max(F32(dc["diff_max_accumulated_frame_num"]),
                                F32(dc["spec_max_accumulated_frame_num"]))
    history_length = torch.clamp_max(history_length, float(max_frames))
    return dict(smb=smb, history_length=history_length, view_z=view_z, n3=n3, x3=x3, xp3=xp3,
                cd3=cd3, v_3=v_3, v_prev=v_prev, view_vec3=view_vec3, nov=nov,
                material_id=material_id, u_p=u_p, v_p=v_p, smb_u=smb_u, smb_v=smb_v,
                uv_smb=uv_smb, p1u=p1u, p1v=p1v, parallax1=parallax1,
                parallax_min=torch.minimum(parallax1, parallax2), pixel_size=pixel_size,
                disocclusion_threshold=disocclusion_threshold)


def temporal_accumulation(sc, dc, view_z_in, normal_roughness, mv_in, diff, state, config,
                          diff_confidence=None, dt_mix=None):
    """The RELAX TA for the diffuse signal (`kernels.py:319-612`): the shared head
    (`_surface_motion`, one `relax_smb_resolve` launch that also samples both diffuse
    histories) and the accumulation. Returns dict(history_length, diff, diff_fast)."""
    g = _surface_motion(sc, dc, view_z_in, normal_roughness, mv_in, state, config,
                        (state["diff_illum_prev"], state["diff_responsive_prev"]), dt_mix=dt_mix)
    smb, history_length = g["smb"], g["history_length"]

    # diffuse accumulation (lines 580-621)
    dmax = F32(dc["diff_max_accumulated_frame_num"])
    dmax_fast = F32(dc["diff_max_fast_accumulated_frame_num"])
    inv_hl = 1.0 / history_length
    if diff_confidence is not None:
        alpha = torch.maximum(1.0 / (diff_confidence * float(dmax) + 1.0), inv_hl)
        alpha_resp = torch.maximum(1.0 / (diff_confidence * float(dmax_fast) + 1.0), inv_hl)
    else:
        alpha = torch.clamp_min(inv_hl, float(F32(1.0) / (dmax + F32(1.0))))
        alpha_resp = torch.clamp_min(inv_hl, float(F32(1.0) / (dmax_fast + F32(1.0))))
    found = smb["smb_found"] > 0.0
    alpha = torch.where(found, alpha, 1.0)
    alpha_resp = torch.where(found, alpha_resp, 1.0)
    prev_diff = torch.clamp_min(smb["histories"][0], 0.0)
    prev_diff_resp = torch.clamp_min(smb["histories"][1], 0.0)
    m1 = nm.luminance(diff[..., :3])
    diff_and_m2 = torch.cat([diff[..., :3], (m1 * m1)[..., None]], -1)
    out_diff = nm.lerp(prev_diff, diff_and_m2, alpha[..., None])
    out_fast = torch.cat([nm.lerp(prev_diff_resp[..., :3], diff[..., :3], alpha_resp[..., None]),
                          torch.zeros_like(m1)[..., None]], -1)
    return dict(history_length=history_length, diff=out_diff, diff_fast=out_fast)


def _curvature(sc, g, normal_roughness, view_z_in):
    """The curvature along the predicted motion (`kernels.py:626-700`): the edge points of
    the pixel's plane at the next texels, or where the parallax is high the texel dulf pixels
    along the motion, fetched nearest in one `nearest_multi` launch (S = 1) from a (h, w, 4)
    plane of (raw viewZ, packed normal x, y, 0)."""
    h, w = view_z_in.shape
    ortho = float(sc["ortho_mode"])
    is_persp = ortho == 0.0
    rw_, rh_ = _v(sc["rect_size"])
    riw_, rih_ = _v(sc["rect_size_inv"])
    u_p, v_p, x3, n3, view_z = g["u_p"], g["v_p"], g["x3"], g["n3"], g["view_z"]
    uvzp_u, uvzp_v = (g["smb_u"], g["smb_v"]) if is_persp else (u_p, v_p)
    inv_par = 1.0 / torch.clamp_min(g["parallax1"], 1.0 / 256.0)
    dux = (uvzp_u - g["p1u"]) * rw_ * inv_par
    duy = (uvzp_v - g["p1v"]) * rh_ * inv_par
    ones = torch.ones_like(view_z)
    ffn = _v(sc["frustum_forward"])

    def edge_point(du_, dv_):
        xe = world_pos_from_uv3(sc, u_p + du_ * riw_, v_p + dv_ * rih_, ones)
        if is_persp:
            ve = v3.normalize(-xe)
            ndv = v3.dot(n3, ve)
            return ve * (v3.dot(x3, n3) / torch.where(torch.abs(ndv) < 1e-9, 1e-9, ndv))
        ve = v3.V3.full_like(view_z, *ffn)
        ndv = v3.dot(n3, ve)
        return xe + ve * (v3.dot(x3 - xe, n3) / torch.where(torch.abs(ndv) < 1e-9, 1e-9, ndv))

    x10 = edge_point(1.0, 0.0)
    x01 = edge_point(0.0, 1.0)
    nr01 = stencil.shifted(normal_roughness, 0, 1)
    nr10 = stencil.shifted(normal_roughness, 1, 0)
    n10 = v3.decode_oct_raw(nr01[..., 0], nr01[..., 1])
    n01 = v3.decode_oct_raw(nr10[..., 0], nr10[..., 1])
    wmx = torch.abs(dux) + 1.0 / 256.0
    wmy = torch.abs(duy) + 1.0 / 256.0
    wnorm = 1.0 / (wmx + wmy)
    wmx = wmx * wnorm
    wmy = wmy * wnorm
    x_edge = x10 * wmx + x01 * wmy
    n_edge = v3.normalize(n10 * wmx + n01 * wmy)

    bayer = nm.bayer4x4_planes(h, w, sc["frame_index"], view_z.device)
    dulf = g["parallax_min"] * (1.0 + float(sc["framerate_scale"]) * bayer)
    mu = (torch.floor((u_p + dulf * dux * riw_) * rw_) + 0.5) * riw_
    mv_ = (torch.floor((v_p + dulf * duy * rih_) * rh_) + 0.5) * rih_
    in_screen_high = (mu > 0.0) & (mu < 1.0) & (mv_ > 0.0) & (mv_ < 1.0)
    zn = torch.stack([view_z_in, normal_roughness[..., 0], normal_roughness[..., 1],
                      torch.zeros_like(view_z_in)], -1)
    high = k_nearest_multi.nearest_multi(zn, torch.stack([mu, mv_], -1)[None])[0]
    z_high = unpack_view_z(sc, high[..., 0])
    n_high = v3.decode_oct_raw(high[..., 1], high[..., 2])
    x_high = world_pos_from_uv3(sc, mu, mv_, z_high)
    z_err = torch.abs(z_high - view_z) / torch.clamp_min(torch.maximum(z_high, view_z), 1e-15)
    rep = (z_err < NRD_CURVATURE_Z_THRESHOLD) & (dulf > 1.0) & in_screen_high
    x_edge = v3.where(rep, x_high, x_edge)
    n_edge = v3.where(rep, n_high, n_edge)
    edge = x_edge - x3
    edge_len_sq = v3.dot(edge, edge)
    curvature = v3.dot(n_edge - n3, edge) / torch.clamp_min(edge_len_sq, 1e-15)
    return torch.where(edge_len_sq < 1e-15, 0.0, curvature)


def _arr(p):
    return torch.stack([p.x, p.y, p.z], -1)


def _normal_to_this_frame(sc, packed):
    """(normal rotated into this frame, roughness) of RGBA8-packed previous normals."""
    n, r = unpack_prev_normal_roughness(packed)
    return nm.rotate_vector(sc["world_prev_to_world"], n), r


def temporal_accumulation_specular(sc, dc, view_z_in, normal_roughness, mv_in, spec, state,
                                   config, spec_confidence=None, dt_mix=None):
    """The RELAX TA for the specular signal (`kernels.py:614-979`, without the SH and
    checkerboard branches): the shared head (one `relax_smb_resolve` launch with the
    specular planes), the curvature (one `nearest_multi` launch), thin lens and the
    virtual-motion uv, the virtual-motion footprint (one `relax_vmb_resolve` launch), the
    virtual amount and its look-back 1 and 2 steps (one `bilinear_resolve` launch), the
    hit-distance and surface-motion confidences, both accumulations and the variance boost.
    Returns dict(history_length, spec, spec_fast, reflection_hit_t,
    spec_reprojection_confidence)."""
    g = _surface_motion(sc, dc, view_z_in, normal_roughness, mv_in, state, config,
                        (state["spec_illum_prev"], state["spec_responsive_prev"]),
                        spec_hit=spec[..., 3].contiguous(), dt_mix=dt_mix)
    smb, history_length = g["smb"], g["history_length"]
    ortho = float(sc["ortho_mode"])
    is_persp = ortho == 0.0
    view_z, nov, pixel_size = g["view_z"], g["nov"], g["pixel_size"]
    rect = _v(sc["rect_size"])
    rect_prev = _v(sc["rect_size_prev"])
    res_prev = _v(sc["resolution_scale_prev"])
    roughness = normal_roughness[..., 2]
    n, x, x_prev, v = _arr(g["n3"]), _arr(g["x3"]), _arr(g["xp3"]), _arr(g["v_3"])
    uv_smb = g["uv_smb"]

    smax = float(dc["spec_max_accumulated_frame_num"])
    smax_fast = float(dc["spec_max_fast_accumulated_frame_num"])
    if spec_confidence is not None:
        spec_frames = torch.minimum(smax * spec_confidence, history_length)
        spec_resp_frames = torch.minimum(smax_fast * spec_confidence, history_length)
    else:
        spec_frames = torch.clamp_max(history_length, smax)
        spec_resp_frames = torch.clamp_max(history_length, smax_fast)

    min_hit = smb["min_hit"]
    hit_dist = torch.where(min_hit == fe.NRD_INF, 0.0, min_hit)
    n_avg = smb["n_avg"]
    n_avg_len = nm.length(n_avg)
    roughness_modified = torch.sqrt(nm.saturate(
        roughness * roughness + nm.saturate(1.0 - n_avg_len ** 2)
        / torch.clamp_min(n_avg_len * (3.0 - n_avg_len ** 2), 1e-15)))

    curvature = _curvature(sc, g, normal_roughness, view_z_in)
    hit_dist_focused = nm.apply_thin_lens_equation(hit_dist, curvature)

    # loadVirtualMotionBasedPrevData (lines 704-796)
    prev_virtual_pos3 = g["xp3"] + v3.normalize(g["view_vec3"]) * hit_dist_focused
    vmb_u, vmb_v = v3.get_screen_uv(sc["world_to_clip_prev"], prev_virtual_pos3)
    is_cam_attached = g["material_id"] == float(sc["camera_attached_reflection_material_id"])
    vmb_u = torch.where(is_cam_attached, g["smb_u"], vmb_u)
    vmb_v = torch.where(is_cam_attached, g["smb_v"], vmb_v)
    uv_vmb = torch.stack([vmb_u, vmb_v], -1)
    cd = _v(sc["camera_delta"])
    x_minus_delta = torch.stack([x[..., i] - cd[i] for i in range(3)], -1)
    vmb_thr_base = g["disocclusion_threshold"] * (view_z if is_persp
                                                  else torch.ones_like(view_z))
    vmb = k_vmb_resolve.relax_vmb_resolve(
        uv_vmb, n, x_minus_delta, vmb_thr_base, normal_roughness, smb["smb_found"],
        state["view_z_prev"], state["material_id_prev"], state["reflection_hit_t"],
        state["normal_roughness_prev"], state["spec_illum_prev"], state["spec_responsive_prev"],
        prev_frustum=frustum_consts(sc, prev=True), ortho_mode=ortho,
        view_z_scale=float(sc["view_z_scale"]), rect_size_prev=rect_prev,
        resolution_scale_prev=res_prev, min_material=float(dc["spec_min_material"]))
    vmb_any = vmb["any"] > 0.0
    vmb_found = vmb["all"]
    prev_normal_vmb, prev_roughness_vmb = _normal_to_this_frame(sc, vmb["nr_packed"])
    prev_normal_vmb = torch.where(vmb_any[..., None], prev_normal_vmb, n)
    prev_roughness_vmb = torch.where(vmb_any, prev_roughness_vmb, 0.0)
    prev_hit_t_vmb = torch.where(vmb_any, torch.clamp_min(vmb["hit_t"], 0.001),
                                 float(sc["denoising_range"]))
    prev_spec_vmb = torch.where(vmb_any[..., None], torch.clamp_min(vmb["spec_vmb"], 0.0), 0.0)
    prev_spec_vmb_resp = torch.where(vmb_any[..., None],
                                     torch.clamp_min(vmb["spec_vmb_resp"], 0.0), 0.0)

    # the surface-motion specular history (from the smb loader)
    prev_spec_smb = torch.clamp_min(smb["histories"][0], 0.0)
    prev_spec_smb_resp = torch.clamp_min(smb["histories"][1], 0.0)
    prev_hit_t_smb = torch.clamp_min(smb["reflection_hit_t"], 0.001)

    # virtual history amount (lines 819-845)
    d4 = nm.get_specular_dominant_direction(n, v, roughness_modified)
    virtual_amount = vmb_found * d4[..., 3]
    if not is_persp:
        virtual_amount = virtual_amount * 0.75
    virtual_amount = virtual_amount * (nm.dot(prev_normal_vmb, n_avg) > 0.0).to(torch.float32)
    uv_diff = uv_vmb - uv_smb
    uv_diff_px = nm.length(nm.scale2(uv_diff, rect[0], rect[1]))
    tan_curv = torch.abs(curvature * pixel_size)
    tan_curv = tan_curv * torch.clamp_min(uv_diff_px / torch.clamp_min(nov, 0.01), 1.0)
    curvature_angle = torch.atan(tan_curv)
    lobe_half_angle = torch.clamp_min(
        torch.atan(get_spec_lobe_tan_half_angle(roughness_modified)), RELAX_NORMAL_ULP)
    normal_weight = nm.get_encoding_aware_normal_weight(n, prev_normal_vmb, lobe_half_angle,
                                                        curvature_angle, RELAX_NORMAL_ULP,
                                                        remap=True)
    near = 1.0 - nm.saturate(uv_diff_px)
    virtual_amount = virtual_amount * nm.lerp(near, 1.0, normal_weight)
    ra, rb = nm.get_relaxed_roughness_weight_params(roughness * roughness,
                                                    float(dc["roughness_fraction"]))
    vrw = nm.compute_weight(prev_roughness_vmb * prev_roughness_vmb, ra, rb)
    vrw = nm.lerp(near, 1.0, vrw)
    if is_persp:
        virtual_amount = virtual_amount * vrw
    spec_vmb_confidence = vrw * 0.9 + 0.1

    # looking back 1 and 2 frames (lines 847-881), both in one bilinear_resolve launch
    uv_dir = uv_diff * nm.rsqrt_safe(torch.sum(uv_diff * uv_diff, -1, keepdim=True))
    uv_dir = torch.stack([nm.div(uv_dir[..., 0], rect_prev[0]),
                          nm.div(uv_dir[..., 1], rect_prev[1])], -1)
    uv_dir = uv_dir * (nm.saturate(uv_diff_px / 0.1) + uv_diff_px / 2.0)[..., None]
    back_uvs = torch.stack([uv_vmb + 1.0 * uv_dir, uv_vmb + 2.0 * uv_dir])
    back_nr = k_bilinear.bilinear_resolve(state["normal_roughness_prev"], back_uvs,
                                          scale=res_prev)
    ppw = torch.ones_like(view_z)
    rw = torch.ones_like(view_z)
    for k in (1, 2):
        bn, br = _normal_to_this_frame(sc, back_nr[k - 1])
        in_s = resample.is_in_screen_nearest(back_uvs[k - 1]) > 0.0
        wk = nm.get_encoding_aware_normal_weight(prev_normal_vmb, bn, lobe_half_angle,
                                                 curvature_angle * (k + 1.0),
                                                 RELAX_NORMAL_ULP, remap=True)
        ppw = ppw * torch.where(in_s, wk, 1.0)
        rw = rw * nm.compute_weight(br * br, ra, rb)
    virtual_amount = virtual_amount * (0.33 + 0.67 * ppw)
    spec_vmb_confidence = spec_vmb_confidence * (0.33 + 0.67 * ppw)
    if is_persp:
        virtual_amount = virtual_amount * (rw * 0.9 + 0.1)

    # hit distance confidence (lines 883-909)
    smc = nm.get_spec_magic_curve(roughness_modified)
    hit_dist_c = nm.lerp(spec[..., 3], prev_hit_t_smb, smc)
    hd1 = nm.apply_thin_lens_equation(hit_dist_c, curvature)
    hd2 = nm.apply_thin_lens_equation(prev_hit_t_vmb, curvature)
    max_dist = torch.maximum(hd1, hd2)
    d_hit = torch.abs(hd1 - hd2)
    mult = nm.lerp(20.0, 0.0, smc)
    vhd_conf = 1.0 - nm.saturate(mult * d_hit / (view_z + max_dist))
    vhd_conf = nm.lerp(vhd_conf, 1.0, smc)
    xv1 = RK.get_xvirtual(hit_dist, curvature, x, x_prev, n, v, roughness)
    hdt_prev = prev_spec_vmb_resp[..., 3]
    xv2 = RK.get_xvirtual(hdt_prev, curvature, x, x_prev, n, v, roughness)
    uv_vmb_test = nm.get_screen_uv(sc["world_to_clip_prev"], xv2)
    uv_vmb_test = torch.where(is_cam_attached[..., None], uv_smb, uv_vmb_test)
    lobe_tan2 = torch.clamp_min(get_spec_lobe_tan_half_angle(roughness, 0.6),
                                float(F32(0.5) * F32(_v(sc["rect_size_inv"])[0])))
    unproj1 = torch.minimum(hit_dist, hdt_prev) / torch.clamp_min(
        nm.pixel_radius_to_world(float(sc["unproject"]), ortho, 1.0,
                                 torch.maximum(nm.length(xv1), nm.length(xv2))), 1e-15)
    lobe_radius_px = lobe_tan2 * unproj1
    delta_par_px = nm.length(nm.scale2(uv_vmb_test - uv_vmb, rect[0], rect[1]))
    vhd_conf = vhd_conf * nm.smoothstep(lobe_radius_px + 0.25, 0.0, delta_par_px)

    # surface motion confidence (lines 911-918)
    # the array form of `:552-554` (v . v_prev is near 1, where acos amplifies rounding)
    if is_persp:
        v_prev = -nm.normalize(x_prev - torch.tensor(cd, dtype=torch.float32, device=v.device))
    else:
        vp = g["v_prev"]
        v_prev = torch.tensor([vp.x, vp.y, vp.z], dtype=torch.float32,
                              device=v.device).expand_as(v)
    spec_smb_confidence = (smb["smb_found"] > 0).to(torch.float32) \
        * nm.get_encoding_aware_normal_weight(
            v, v_prev, lobe_half_angle * nov / float(sc["framerate_scale"]),
            torch.zeros_like(nov), 0.0)
    spec_smb_alpha = torch.maximum(1.0 - spec_smb_confidence, 1.0 / (1.0 + spec_frames))
    spec_smb_resp_alpha = torch.maximum(spec_smb_alpha, 1.0 / (1.0 + spec_resp_frames))

    # both accumulations (lines 928-979)
    m1s = nm.luminance(spec[..., :3])
    spec_m2 = m1s * m1s
    acc_smb_rgb = nm.lerp(prev_spec_smb[..., :3], spec[..., :3], spec_smb_alpha[..., None])
    acc_smb_hit = nm.lerp(prev_hit_t_smb, spec[..., 3], torch.clamp_min(spec_smb_alpha, 0.1))
    acc_smb_m2 = nm.lerp(prev_spec_smb[..., 3], spec_m2, spec_smb_alpha)
    acc_smb_resp = nm.lerp(prev_spec_smb_resp[..., :3], spec[..., :3],
                           spec_smb_resp_alpha[..., None])
    vmb_conf_hd = spec_vmb_confidence * vhd_conf
    spec_vmb_alpha = torch.maximum(1.0 - spec_vmb_confidence, 1.0 / (1.0 + spec_frames))
    spec_vmb_resp_alpha = torch.maximum(1.0 - vmb_conf_hd, 1.0 / (1.0 + spec_resp_frames))
    spec_vmb_hit_alpha = torch.maximum(1.0 - vmb_conf_hd, 1.0 / (1.0 + spec_frames))
    acc_vmb_rgb = nm.lerp(prev_spec_vmb[..., :3], spec[..., :3], spec_vmb_alpha[..., None])
    acc_vmb_hit = nm.lerp(prev_hit_t_vmb, spec[..., 3], torch.clamp_min(spec_vmb_hit_alpha, 0.1))
    acc_vmb_m2 = nm.lerp(prev_spec_vmb[..., 3], spec_m2, spec_vmb_alpha)
    acc_vmb_resp = nm.lerp(prev_spec_vmb_resp[..., :3], spec[..., :3],
                           spec_vmb_resp_alpha[..., None])
    virtual_amount = virtual_amount * nm.saturate(
        spec_vmb_confidence / (spec_smb_confidence + fe.NRD_EPS))
    acc_hit_t = nm.lerp(acc_smb_hit, acc_vmb_hit, virtual_amount)
    acc_rgb = nm.lerp(acc_smb_rgb, acc_vmb_rgb, virtual_amount[..., None])
    acc_resp = nm.lerp(acc_smb_resp, acc_vmb_resp, virtual_amount[..., None])
    acc_m2 = nm.lerp(acc_smb_m2, acc_vmb_m2, virtual_amount)
    confidence = nm.lerp(spec_smb_confidence, spec_vmb_confidence, virtual_amount)
    acc_m2 = torch.where(acc_m2 == 0.0,
                         float(dc["spec_variance_boost"]) * (1.0 - confidence), acc_m2)
    return dict(history_length=history_length,
                spec=torch.cat([acc_rgb, acc_m2[..., None]], -1),
                spec_fast=torch.cat([acc_resp, hit_dist[..., None]], -1),
                reflection_hit_t=acc_hit_t, spec_reprojection_confidence=confidence)


# ---------------------------------------------------------------------------
# HistoryFix (RELAX_HistoryFix.hlsli), diffuse
# ---------------------------------------------------------------------------


def history_fix(sc, dc, view_z_in, normal_roughness, history_length, signal, config,
                which: str = "diff"):
    """Sparse 5x5 cross-bilateral reconstruction of short histories (`kernels.py:1017-1131`)
    of one signal: one `relax_history_fix` launch. Returns (h, w, 4)."""
    specular = None
    if which == "spec":
        specular = dict(lobe_angle_fraction=float(dc["lobe_angle_fraction"]),
                        lobe_angle_slack=float(dc["spec_lobe_angle_slack"]),
                        roughness_edge_stopping_relaxation=float(
                            dc["roughness_edge_stopping_relaxation"]))
    return k_history_fix.relax_history_fix(
        signal, view_z_in, normal_roughness, history_length, **_frame_geometry(sc),
        depth_threshold=float(dc["depth_threshold"]),
        base_stride=float(dc["history_fix_base_pixel_stride"]),
        frame_num=float(dc["history_fix_frame_num"]),
        normal_power=float(dc["history_fix_edge_stopping_normal_power"]),
        min_material=float(dc[which + "_min_material"]), specular=specular,
        roughness_encoding=config.roughness_encoding)


# ---------------------------------------------------------------------------
# HistoryClamping (RELAX_HistoryClamping.hlsli), diffuse
# ---------------------------------------------------------------------------


def history_clamping(sc, dc, view_z_in, noisy, slow, fast, fixed, history_length,
                     which: str = "diff"):
    """Sigma colour-box clamp of the slow history to the responsive one + antilag
    acceleration and reset + 2nd-moment correction (`kernels.py:1140-1271`) of one signal,
    the responsive history being HistoryFix's output `fixed` where the history is short and
    the TA's `fast` elsewhere (`denoiser.py:278-286`): one `relax_clamp_moments` launch. The
    specular signal scales the acceleration by 0.33 and the reset by 0.5 (`:1219`, `:1244`).
    Returns dict(history_length, <which>_slow, <which>_resp)."""
    spec = which == "spec"
    accel_scale = F32((0.33 if spec else 1.0) * RELAX_ANTILAG_ACCELERATION_AMOUNT_SCALE) * F32(
        dc["history_acceleration_amount"])
    reset_amount = F32(0.5 if spec else 1.0) * F32(dc["history_reset_amount"])
    out_slow, out_resp = k_clamp_moments.relax_clamp_moments(
        view_z_in, fast, fixed, history_length, noisy, slow,
        view_z_scale=float(sc["view_z_scale"]), denoising_range=float(sc["denoising_range"]),
        history_fix_frame_num=float(dc["history_fix_frame_num"]),
        color_box_sigma_scale=float(dc["color_box_sigma_scale"]),
        clamp=bool(F32(dc[which + "_max_fast_accumulated_frame_num"])
                   < F32(dc[which + "_max_accumulated_frame_num"])),
        acceleration=float(accel_scale),
        reset_temporal_sigma_scale=float(dc["history_reset_temporal_sigma_scale"]),
        reset_spatial_sigma_scale=float(dc["history_reset_spatial_sigma_scale"]),
        reset_amount=float(reset_amount))
    return {"history_length": history_length, which + "_slow": out_slow,
            which + "_resp": out_resp}


# ---------------------------------------------------------------------------
# AntiFirefly (RELAX_AntiFirefly.hlsli)
# ---------------------------------------------------------------------------


def anti_firefly(dc, normal_roughness, signals, which):
    """RCRS of each slow history over its material-matched 3x3 (`kernels.py:1279-1330`): one
    `relax_antifirefly` launch for every signal; `which` names each signal ("diff" /
    "spec"). Returns a tuple of (h, w, 4)."""
    return k_antifirefly.relax_antifirefly(
        normal_roughness, signals,
        min_materials=[float(dc[wh + "_min_material"]) for wh in which])


# ---------------------------------------------------------------------------
# A-trous (RELAX_AtrousSmem.hlsli + RELAX_Atrous.hlsli), diffuse
# ---------------------------------------------------------------------------


def atrous(sc, dc, view_z_in, normal_roughness, history_length, signal, config, *,
           step_size: int, is_first: bool, which: str = "diff", diff_confidence=None,
           spec_confidence=None, reprojection_confidence=None):
    """One à-trous iteration of the diffuse or the specular signal (`kernels.py:1340-1606`):
    one `relax_atrous` launch. IN_DIFF_CONFIDENCE / IN_SPEC_CONFIDENCE and the TA's specular
    reprojection confidence relax the edge stopping per pixel (`:1368-1391`). Returns
    (h, w, 4) = (rgb, variance)."""
    specular = None
    if which == "spec":
        specular = dict(
            roughness_fraction=float(dc["roughness_fraction"]),
            normal_edge_stopping_relaxation=float(dc["normal_edge_stopping_relaxation"]),
            lobe_angle_slack=float(dc["spec_lobe_angle_slack"]),
            luminance_edge_stopping_relaxation=float(dc["luminance_edge_stopping_relaxation"]),
            roughness_edge_stopping_relaxation=float(dc["roughness_edge_stopping_relaxation"]),
            roughness_edge_stopping_enabled=float(dc["roughness_edge_stopping_enabled"]))
    return k_atrous.relax_atrous(
        signal, view_z_in, normal_roughness, history_length, diff_confidence, spec_confidence,
        reprojection_confidence, step_size=step_size, is_first=is_first,
        frame_index=int(sc["frame_index"]), **_frame_geometry(sc),
        denoising_range=float(sc["denoising_range"]),
        depth_threshold=float(dc["depth_threshold"]),
        lobe_fraction=k_atrous.lobe_fraction(dc["lobe_angle_fraction"], step_size, is_first),
        lobe_angle_fraction=float(dc["lobe_angle_fraction"]),
        phi_luminance=float(dc[which + "_phi_luminance"]),
        max_luminance_relative_difference=float(
            dc[which + "_max_luminance_relative_difference"]),
        min_material=float(dc[which + "_min_material"]),
        history_threshold=float(dc["history_threshold"]),
        confidence_relaxation=(
            float(dc["confidence_driven_relaxation_multiplier"]),
            float(dc["confidence_driven_normal_edge_stopping_relaxation"]),
            float(dc["confidence_driven_luminance_edge_stopping_relaxation"])),
        specular=specular, roughness_encoding=config.roughness_encoding)


def split_screen(sc, view_z_in, noisy, out_signal):
    """SplitScreen: the noisy input (0 beyond the denoising range) left of the split."""
    h, w = view_z_in.shape
    view_z = unpack_view_z(sc, view_z_in)
    u = nm.div(torch.arange(w, dtype=torch.float32, device=view_z_in.device) + 0.5, w)
    s = noisy * (view_z < float(sc["denoising_range"])).to(torch.float32)[..., None]
    return torch.where(u[None, :, None] <= float(sc["split_screen"]), s, out_signal)
