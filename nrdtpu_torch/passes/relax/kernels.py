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
the per-pixel formulas of the XLA gathers, not the TPU kernels' workarounds. A pass takes one
signal, named by `which` ("diff" / "spec"), or both in one launch where the XLA function runs
them together (`which` = ("diff", "spec") and the signals a pair: history_fix,
history_clamping, atrous); the PrePass runs once a signal, as `relax_prepass_taps_pallas`
does. The TA has one accumulation a signal (`_diffuse_accumulation`,
`_specular_accumulation`) after one shared head (`_surface_motion`), which samples every
history of the signals present in one `relax_smb_resolve` launch. The SH variants' second
plane (SH1, "sh") rides the same launches: every pass that filters or resamples the signal
takes the signal's SH plane too (`sh=`; in pairs with both signals) and the kernel returns
it beside the signal; the SH lerps of the TA stay glue, as in XLA. Under checkerboard the
signals arrive expanded from half width and `checkerboard_resolve` fills the pixels without data
before the PrePass, torch glue as in JAX; the TA takes the plane of the pixels with data
(`has_data`) and accumulates slower on the others. Frame constants (`sc`, `dc`) are host values.

`normal_roughness` is the plane of `frontend.decode_normal_plane`: the packed input at
R10G10B10A2, or at the four RGBA normal encodings the normal decoded once a frame (.xyz) with
the packed roughness (.w). There every pass and kernel reads the decoded plane (`decoded=` on
the wrappers, the kernels' kDec instances), and no material test applies: the RGBA formats
carry no material (0), and the reference's material tests are off at these encodings
(`kernels.py:249`, `:509`, `:759`, `:1087`, `:1103`, `:1312`, `:1522`, `:1575`,
`denoiser.py:218`).
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
    get_bilateral_weight,
    get_normal_weight_param2,
    get_spec_lobe_tan_half_angle,
    unpack_nr,
    unpack_prev_normal_roughness,
    unpack_view_z,
    world_pos_from_uv3,
)

NRD_CURVATURE_Z_THRESHOLD = 0.1


def _v(x):
    return [float(c) for c in np.asarray(x, np.float32).reshape(-1)]


def _normal3(p, decoded_plane):
    """The normal of a (..., >= 3) plane as a V3: the decoded plane's .xyz as it is, or the
    packed plane's octahedral .xy (`unpack_nr3`, `nrdtpu/passes/reblur/kernels.py:37-43`)."""
    if decoded_plane:
        return v3.V3(p[..., 0], p[..., 1], p[..., 2])
    return v3.decode_oct_raw(p[..., 0], p[..., 1])


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
# Checkerboard resolve (RELAX_PrePass.hlsli:28-110)
# ---------------------------------------------------------------------------


def checkerboard_resolve(sc, dc, view_z_in, normal_roughness, has_data, signals, config):
    """The checkerboard resolve at the pipeline's front (`nrdtpu/passes/relax/denoiser.py:
    198-239`): each pixel without data takes its horizontal neighbours' expanded signal, each
    weighed by its bilateral viewZ weight and its material test against the centre's (the
    smaller of the two min materials; at the RGBA normal encodings every material is 0 and
    the test passes, as the reference skips it), none beyond the denoising range or off the edge
    columns, normalized by the weights' sum (0 where both are 0). signals: (h, w, c) planes
    expanded from half width (`reblur.common.cb_expand`), or None; each is resolved with the
    same weights. Returns them in order."""
    w = view_z_in.shape[1]
    vz = unpack_view_z(sc, view_z_in)
    _, _, mat = unpack_nr(normal_roughness, config)
    z0 = stencil.shifted(vz, 0, -1)
    z1 = stencil.shifted(vz, 0, 1)
    m0 = stencil.shifted(mat, 0, -1)
    m1 = stencil.shifted(mat, 0, 1)
    w0 = get_bilateral_weight(z0, vz)
    w1 = get_bilateral_weight(z1, vz)
    col = torch.arange(w, device=vz.device)[None, :]
    dr = float(sc["denoising_range"])
    w0 = torch.where((z0 > dr) | (col < 1), 0.0, w0)
    w1 = torch.where((z1 > dr) | (col > w - 2), 0.0, w1)
    min_mat = float(min(F32(dc["diff_min_material"]), F32(dc["spec_min_material"])))
    mc = torch.clamp_min(mat, min_mat)
    w0 = w0 * (mc == torch.clamp_min(m0, min_mat)).to(torch.float32)
    w1 = w1 * (mc == torch.clamp_min(m1, min_mat)).to(torch.float32)
    wsum = w0 + w1
    winv = torch.where(wsum == 0.0, 0.0, 1.0 / torch.clamp_min(wsum, 1e-15))
    w0 = w0 * winv
    w1 = w1 * winv
    return tuple(None if t is None else torch.where(
        has_data[..., None], t,
        stencil.shifted(t, 0, -1) * w0[..., None] + stencil.shifted(t, 0, 1) * w1[..., None])
        for t in signals)


# ---------------------------------------------------------------------------
# PrePass (RELAX_PrePass.hlsli)
# ---------------------------------------------------------------------------


def pre_pass(sc, dc, signal, view_z_in, normal_roughness, config, which: str = "diff",
             sh=None):
    """Poisson spatial reuse of one signal (`kernels.py:160-306`), checkerboard off: one
    `relax_prepass` launch. The specular signal also re-estimates its hitT as the min over
    the kept taps. With `sh` (the SH variants' SH1) the SH plane is filtered with the same
    weights in that launch. Returns (h, w, 4), or with `sh` (signal, SH)."""
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
        roughness_encoding=config.roughness_encoding, sh=sh,
        decoded=fe.decoded_normals(config.normal_encoding))


# ---------------------------------------------------------------------------
# TemporalAccumulation (RELAX_TemporalAccumulation.hlsli)
# ---------------------------------------------------------------------------


def _surface_motion(sc, dc, view_z_in, normal_roughness, mv_in, state, config, histories,
                    spec_hit=None, dt_mix=None, sh_histories=(), has_data=None):
    """The TA's head, shared by both signals (`kernels.py:331-567`): surface-motion uv,
    parallax, disocclusion threshold, the footprint (one `relax_smb_resolve` launch that
    also samples the histories, in `hist_planes` order the slow and responsive history of
    each signal present, with the SH variants the SH histories in `bil_planes` order, and,
    with `spec_hit`, gathers the specular 3x3 planes), the footprint-quality refinements and
    the history length. Returns the planes the accumulations read, with `has_data` (the
    pixels with data under checkerboard, or None) and the checkerboard's accumulation speed."""
    h, w = view_z_in.shape
    dev = view_z_in.device
    view_z = unpack_view_z(sc, view_z_in)
    uv = resample.pixel_uv_grid(h, w, dev)
    # unpack_nr3: packed, the roughness as packed; decoded, the roughness decoded
    dec = fe.decoded_normals(config.normal_encoding)
    n3 = _normal3(normal_roughness, dec)
    if dec:
        _, roughness, material_id = unpack_nr(normal_roughness, config)
    else:
        roughness, material_id = normal_roughness[..., 2], normal_roughness[..., 3] * 3.0
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
        sh_histories, view_z_scale=float(sc["view_z_scale"]), rect_size_prev=rect_prev,
        resource_size=_v(sc["resource_size"]),
        min_material=float(min(F32(dc["spec_min_material"]), F32(dc["diff_min_material"]))),
        world_prev_to_world=sc["world_prev_to_world"], decoded=dec)
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
    return dict(smb=smb, history_length=history_length, has_data=has_data,
                cbra=F32(sc["checkerboard_resolve_accum_speed"]), parallax_max=parallax_max,
                view_z=view_z, n3=n3, x3=x3, xp3=xp3, decoded=dec, roughness=roughness,
                cd3=cd3, v_3=v_3, v_prev=v_prev, view_vec3=view_vec3, nov=nov,
                material_id=material_id, u_p=u_p, v_p=v_p, smb_u=smb_u, smb_v=smb_v,
                uv_smb=uv_smb, p1u=p1u, p1v=p1v, parallax1=parallax1,
                parallax_min=torch.minimum(parallax1, parallax2), pixel_size=pixel_size,
                disocclusion_threshold=disocclusion_threshold)


def _histories(state, which):
    """The slow and the responsive history of each signal of `which`, in `hist_planes` order."""
    return tuple(state[f"{wh}_{kind}_prev"] for wh in which for kind in ("illum", "responsive"))


def _sh_histories(state, which, sh):
    """With the SH variants (`sh`), the slow and the responsive SH history (bfloat16) of each
    signal of `which`, in `bil_planes` order; else none."""
    if not sh:
        return ()
    return tuple(state[f"{wh}_{kind}_prev"] for wh in which
                 for kind in ("sh", "sh_responsive"))


def temporal_accumulation(sc, dc, view_z_in, normal_roughness, mv_in, diff, state, config,
                          diff_confidence=None, dt_mix=None, diff_sh=None, has_data=None):
    """The RELAX TA for the diffuse signal (`kernels.py:319-612`): the shared head
    (`_surface_motion`, one `relax_smb_resolve` launch that also samples both diffuse
    histories, and both SH histories with `diff_sh`) and the accumulation. has_data: under
    checkerboard the (h, w) bool plane of the pixels with data, else None. Returns
    dict(history_length, diff, diff_fast), and with `diff_sh` diff_sh, diff_sh_fast."""
    g = _surface_motion(sc, dc, view_z_in, normal_roughness, mv_in, state, config,
                        _histories(state, ("diff",)), dt_mix=dt_mix,
                        sh_histories=_sh_histories(state, ("diff",), diff_sh is not None),
                        has_data=has_data)
    return dict(history_length=g["history_length"], **_diffuse_accumulation(
        dc, g, diff, g["smb"]["histories"][0:2], diff_confidence, diff_sh,
        g["smb"].get("sh", ())[0:2]))


def temporal_accumulation_diffuse_specular(sc, dc, view_z_in, normal_roughness, mv_in, diff,
                                           spec, state, config, diff_confidence=None,
                                           spec_confidence=None, dt_mix=None, diff_sh=None,
                                           spec_sh=None, has_data=None):
    """The RELAX TA for both signals (`kernels.py:319-979`): one shared head (one
    `relax_smb_resolve` launch of four histories, diffuse then specular, with the specular
    planes, and with the SH variants the four SH histories), then each signal's
    accumulation; has_data as for `temporal_accumulation`. Returns the union of
    `temporal_accumulation`'s and `temporal_accumulation_specular`'s dicts."""
    g = _surface_motion(sc, dc, view_z_in, normal_roughness, mv_in, state, config,
                        _histories(state, ("diff", "spec")),
                        spec_hit=spec[..., 3].contiguous(), dt_mix=dt_mix,
                        sh_histories=_sh_histories(state, ("diff", "spec"), diff_sh is not None),
                        has_data=has_data)
    hist = g["smb"]["histories"]
    sh_hist = g["smb"].get("sh", ())
    return dict(history_length=g["history_length"],
                **_diffuse_accumulation(dc, g, diff, hist[0:2], diff_confidence, diff_sh,
                                        sh_hist[0:2]),
                **_specular_accumulation(sc, dc, g, normal_roughness, view_z_in, spec, state,
                                         hist[2:4], spec_confidence, spec_sh, sh_hist[2:4]))


def _diffuse_accumulation(dc, g, diff, histories, diff_confidence=None, sh=None, sh_hist=()):
    """The diffuse accumulation (lines 580-621) of the head's planes `g` and the diffuse slow
    and responsive histories it sampled; with the SH variants also the SH (`sh`, the PrePass's
    SH) against the SH histories `sh_hist` the head sampled, lerped with the same alphas and not
    clamped at 0 (`:602-612`). Returns dict(diff, diff_fast), and with `sh` diff_sh,
    diff_sh_fast."""
    smb, history_length = g["smb"], g["history_length"]
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
    if g["has_data"] is not None:  # checkerboard: slower where no data (`:590-595`)
        nd = ~g["has_data"] & (history_length > 1.0)
        cb_f = float(F32(1.0) - g["cbra"])
        alpha = torch.where(nd, alpha * cb_f, alpha)
        alpha_resp = torch.where(nd, alpha_resp * cb_f, alpha_resp)
    prev_diff = torch.clamp_min(histories[0], 0.0)
    prev_diff_resp = torch.clamp_min(histories[1], 0.0)
    m1 = nm.luminance(diff[..., :3])
    diff_and_m2 = torch.cat([diff[..., :3], (m1 * m1)[..., None]], -1)
    out_diff = nm.lerp(prev_diff, diff_and_m2, alpha[..., None])
    out_fast = torch.cat([nm.lerp(prev_diff_resp[..., :3], diff[..., :3], alpha_resp[..., None]),
                          torch.zeros_like(m1)[..., None]], -1)
    out = dict(diff=out_diff, diff_fast=out_fast)
    if sh is not None:
        out.update(diff_sh=nm.lerp(sh_hist[0], sh, alpha[..., None]),
                   diff_sh_fast=nm.lerp(sh_hist[1], sh, alpha_resp[..., None]))
    return out


def _curvature(sc, g, normal_roughness, view_z_in):
    """The curvature along the predicted motion (`kernels.py:626-700`): the edge points of
    the pixel's plane at the next texels, or where the parallax is high the texel dulf pixels
    along the motion, fetched nearest in one `nearest_multi` launch (S = 1) from a (h, w, 4)
    plane of raw viewZ and the plane's .xyz, whose normal is read as `_normal3` reads it (the
    decoded one as it is, `nrdtpu/passes/relax/kernels.py:650-656`, `:686-690`)."""
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
    n10 = _normal3(nr01, g["decoded"])
    n01 = _normal3(nr10, g["decoded"])
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
    zn = torch.cat([view_z_in[..., None], normal_roughness[..., :3]], -1)
    high = k_nearest_multi.nearest_multi(zn, torch.stack([mu, mv_], -1)[None])[0]
    z_high = unpack_view_z(sc, high[..., 0])
    n_high = _normal3(high[..., 1:], g["decoded"])
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
                                   config, spec_confidence=None, dt_mix=None, spec_sh=None,
                                   has_data=None):
    """The RELAX TA for the specular signal (`kernels.py:614-1006`): the shared head (one
    `relax_smb_resolve` launch with the specular planes, and both SH histories with
    `spec_sh`) and the specular accumulation (`_specular_accumulation`); has_data as for
    `temporal_accumulation`. Returns dict(history_length, spec, spec_fast, reflection_hit_t,
    spec_reprojection_confidence), and with `spec_sh` spec_sh, spec_sh_fast."""
    g = _surface_motion(sc, dc, view_z_in, normal_roughness, mv_in, state, config,
                        _histories(state, ("spec",)), spec_hit=spec[..., 3].contiguous(),
                        dt_mix=dt_mix,
                        sh_histories=_sh_histories(state, ("spec",), spec_sh is not None),
                        has_data=has_data)
    return dict(history_length=g["history_length"],
                **_specular_accumulation(sc, dc, g, normal_roughness, view_z_in, spec, state,
                                         g["smb"]["histories"][0:2], spec_confidence, spec_sh,
                                         g["smb"].get("sh", ())[0:2]))


def _specular_accumulation(sc, dc, g, normal_roughness, view_z_in, spec, state, histories,
                           spec_confidence=None, sh=None, sh_hist=()):
    """The specular accumulation (lines 625-1006) of the head's planes `g` and the specular
    slow and responsive histories it sampled: the curvature (one `nearest_multi` launch), thin
    lens and the virtual-motion uv, the virtual-motion footprint (one `relax_vmb_resolve`
    launch, which with `sh` also samples both SH histories), the virtual amount and its
    look-back 1 and 2 steps (one `bilinear_resolve` launch), the hit-distance and
    surface-motion confidences, both accumulations and the variance boost; with the SH
    variants also the SH (`sh`, the PrePass's SH, against the surface-motion SH histories
    `sh_hist`): both motions' lerps, then the lerp by the virtual amount, the slow SH's .w
    the modified roughness (`:980-1006`). Returns dict(spec, spec_fast, reflection_hit_t,
    spec_reprojection_confidence), and with `sh` spec_sh, spec_sh_fast."""
    smb, history_length = g["smb"], g["history_length"]
    ortho = float(sc["ortho_mode"])
    is_persp = ortho == 0.0
    view_z, nov, pixel_size = g["view_z"], g["nov"], g["pixel_size"]
    rect = _v(sc["rect_size"])
    rect_prev = _v(sc["rect_size_prev"])
    res_prev = _v(sc["resolution_scale_prev"])
    roughness = g["roughness"]
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
        *_sh_histories(state, ("spec",), sh is not None),
        prev_frustum=frustum_consts(sc, prev=True), ortho_mode=ortho,
        view_z_scale=float(sc["view_z_scale"]), rect_size_prev=rect_prev,
        resolution_scale_prev=res_prev, min_material=float(dc["spec_min_material"]),
        decoded=g["decoded"])
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
    prev_spec_smb = torch.clamp_min(histories[0], 0.0)
    prev_spec_smb_resp = torch.clamp_min(histories[1], 0.0)
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
    no_data = None
    if g["has_data"] is not None:  # checkerboard: slower where no data, smb half (`:919-925`)
        no_data = ~g["has_data"] & (g["parallax_max"] < 0.5)
        f_smb = 1.0 - float(g["cbra"]) * (smb["smb_found"] > 0).to(torch.float32)
        spec_smb_alpha = torch.where(no_data, spec_smb_alpha * f_smb, spec_smb_alpha)
        spec_smb_resp_alpha = torch.where(no_data, spec_smb_resp_alpha * f_smb,
                                          spec_smb_resp_alpha)

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
    if no_data is not None:  # the virtual-motion half (`:944-952`)
        f_vmb = 1.0 - float(g["cbra"]) * vmb_found
        spec_vmb_alpha = torch.where(no_data, spec_vmb_alpha * f_vmb, spec_vmb_alpha)
        spec_vmb_resp_alpha = torch.where(no_data, spec_vmb_resp_alpha * f_vmb,
                                          spec_vmb_resp_alpha)
        spec_vmb_hit_alpha = torch.where(no_data, spec_vmb_hit_alpha * f_vmb, spec_vmb_hit_alpha)
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
    out = dict(spec=torch.cat([acc_rgb, acc_m2[..., None]], -1),
               spec_fast=torch.cat([acc_resp, hit_dist[..., None]], -1),
               reflection_hit_t=acc_hit_t, spec_reprojection_confidence=confidence)
    if sh is not None:  # the SH of both motions, not clamped at 0 (`:980-1006`)
        acc_sh_smb = nm.lerp(sh_hist[0], sh, spec_smb_alpha[..., None])
        acc_sh_smb_resp = nm.lerp(sh_hist[1], sh, spec_smb_resp_alpha[..., None])
        acc_sh_vmb = nm.lerp(vmb["sh_vmb"], sh, spec_vmb_alpha[..., None])
        acc_sh_vmb_resp = nm.lerp(vmb["sh_vmb_resp"], sh, spec_vmb_resp_alpha[..., None])
        sh_acc = nm.lerp(acc_sh_smb, acc_sh_vmb, virtual_amount[..., None])
        out.update(spec_sh=torch.cat([sh_acc[..., :3], roughness_modified[..., None]], -1),
                   spec_sh_fast=nm.lerp(acc_sh_smb_resp, acc_sh_vmb_resp,
                                        virtual_amount[..., None]))
    return out


# ---------------------------------------------------------------------------
# HistoryFix (RELAX_HistoryFix.hlsli)
# ---------------------------------------------------------------------------


def history_fix(sc, dc, view_z_in, normal_roughness, history_length, signal, config,
                which="diff", sh=None):
    """Sparse 5x5 cross-bilateral reconstruction of short histories (`kernels.py:1017-1131`)
    of one signal, or of both (`which` = ("diff", "spec"), `signal` the pair): one
    `relax_history_fix` launch, which with `sh` (the signal's SH, or the pair) reconstructs the
    SH too. Returns (h, w, 4), or the pair; with `sh` (signal, SH), or (diffuse, specular,
    diffuse SH, specular SH)."""
    both = not isinstance(which, str)
    specular = None
    if both or which == "spec":
        specular = dict(lobe_angle_fraction=float(dc["lobe_angle_fraction"]),
                        lobe_angle_slack=float(dc["spec_lobe_angle_slack"]),
                        roughness_edge_stopping_relaxation=float(
                            dc["roughness_edge_stopping_relaxation"]))
    min_material = (tuple(float(dc[wh + "_min_material"]) for wh in which) if both
                    else float(dc[which + "_min_material"]))
    return k_history_fix.relax_history_fix(
        signal, view_z_in, normal_roughness, history_length, **_frame_geometry(sc),
        depth_threshold=float(dc["depth_threshold"]),
        base_stride=float(dc["history_fix_base_pixel_stride"]),
        frame_num=float(dc["history_fix_frame_num"]),
        normal_power=float(dc["history_fix_edge_stopping_normal_power"]),
        min_material=min_material, specular=specular,
        roughness_encoding=config.roughness_encoding, sh=sh,
        decoded=fe.decoded_normals(config.normal_encoding))


# ---------------------------------------------------------------------------
# HistoryClamping (RELAX_HistoryClamping.hlsli)
# ---------------------------------------------------------------------------


def _clamp_consts(dc, which):
    """One signal's constants of the history clamp: the clamp flag, the acceleration (the
    specular one scaled by 0.33, `:1219`) and the reset amount (x 0.5, `:1244`)."""
    spec = which == "spec"
    accel = F32((0.33 if spec else 1.0) * RELAX_ANTILAG_ACCELERATION_AMOUNT_SCALE) * F32(
        dc["history_acceleration_amount"])
    reset_amount = F32(0.5 if spec else 1.0) * F32(dc["history_reset_amount"])
    clamp = bool(F32(dc[which + "_max_fast_accumulated_frame_num"])
                 < F32(dc[which + "_max_accumulated_frame_num"]))
    return clamp, float(accel), float(reset_amount)


def history_clamping(sc, dc, view_z_in, noisy, slow, fast, fixed, history_length,
                     which="diff", sh=None, sh_fast=None):
    """Sigma colour-box clamp of the slow history to the responsive one + antilag
    acceleration and reset + 2nd-moment correction (`kernels.py:1140-1271`) of one signal,
    the responsive history being HistoryFix's output `fixed` where the history is short and
    the TA's `fast` elsewhere (`denoiser.py:278-286`): one `relax_clamp_moments` launch; with
    `which` = ("diff", "spec") and the planes pairs, both signals in that one launch. Each
    signal has its own clamp flag, acceleration and reset amount (`_clamp_consts`). With the
    SH variants (`sh`, `sh_fast`: the TA's slow and responsive SH, pairs with both signals) the
    launch also lerps the SH by the clamping factor (`:1260-1262`). Returns
    dict(history_length, <which>_slow, <which>_resp) for each signal, and with `sh`
    <which>_sh (the lerp) and <which>_sh_fast (`sh_fast` as it came)."""
    both = not isinstance(which, str)
    names = tuple(which) if both else (which,)
    per = list(zip(*[_clamp_consts(dc, wh) for wh in names]))
    if not both:
        per = [v[0] for v in per]
    outs = k_clamp_moments.relax_clamp_moments(
        view_z_in, fast, fixed, history_length, noisy, slow,
        view_z_scale=float(sc["view_z_scale"]), denoising_range=float(sc["denoising_range"]),
        history_fix_frame_num=float(dc["history_fix_frame_num"]),
        color_box_sigma_scale=float(dc["color_box_sigma_scale"]), clamp=per[0],
        acceleration=per[1],
        reset_temporal_sigma_scale=float(dc["history_reset_temporal_sigma_scale"]),
        reset_spatial_sigma_scale=float(dc["history_reset_spatial_sigma_scale"]),
        reset_amount=per[2], sh=sh, sh_fast=sh_fast)
    out = {"history_length": history_length}
    for k, wh in enumerate(names):
        out[wh + "_slow"], out[wh + "_resp"] = outs[2 * k], outs[2 * k + 1]
        if sh is not None:
            out[wh + "_sh"] = outs[2 * len(names) + k]
            out[wh + "_sh_fast"] = sh_fast[k] if both else sh_fast
    return out


# ---------------------------------------------------------------------------
# AntiFirefly (RELAX_AntiFirefly.hlsli)
# ---------------------------------------------------------------------------


def anti_firefly(dc, normal_roughness, signals, which, config=None):
    """RCRS of each slow history over its material-matched 3x3 (`kernels.py:1279-1330`): one
    `relax_antifirefly` launch for every signal; `which` names each signal ("diff" /
    "spec"); at the RGBA normal encodings of `config` (R10G10B10A2 where None)
    normal_roughness is the decoded plane (no material test). Returns a tuple of
    (h, w, 4)."""
    return k_antifirefly.relax_antifirefly(
        normal_roughness, signals,
        min_materials=[float(dc[wh + "_min_material"]) for wh in which],
        decoded=config is not None and fe.decoded_normals(config.normal_encoding))


# ---------------------------------------------------------------------------
# A-trous (RELAX_AtrousSmem.hlsli + RELAX_Atrous.hlsli)
# ---------------------------------------------------------------------------


def atrous(sc, dc, view_z_in, normal_roughness, history_length, signal, config, *,
           step_size: int, is_first: bool, which="diff", diff_confidence=None,
           spec_confidence=None, reprojection_confidence=None, sh=None, is_last=False):
    """One à-trous iteration of the diffuse or the specular signal, or of both (`which` =
    ("diff", "spec"), `signal` the pair) (`kernels.py:1340-1606`): one `relax_atrous` launch.
    IN_DIFF_CONFIDENCE / IN_SPEC_CONFIDENCE and the TA's specular reprojection confidence
    relax the edge stopping per pixel (`:1368-1391`). With the SH variants (`sh`: the signal's
    SH, or the pair) the launch filters the SH too, the diffuse lobe fraction's base is 1.0
    after iteration 0 (`:1363`), and on the last iteration (`is_last`) the signal's rgb is
    converted to YCoCg after the launch (`:1600-1602`; the SH is not). Returns (h, w, 4) =
    (rgb, variance), or the pair; with `sh` (that, SH or the SH pair)."""
    both = not isinstance(which, str)
    names = tuple(which) if both else (which,)
    specular = None
    if "spec" in names:
        specular = dict(
            roughness_fraction=float(dc["roughness_fraction"]),
            normal_edge_stopping_relaxation=float(dc["normal_edge_stopping_relaxation"]),
            lobe_angle_slack=float(dc["spec_lobe_angle_slack"]),
            luminance_edge_stopping_relaxation=float(dc["luminance_edge_stopping_relaxation"]),
            roughness_edge_stopping_relaxation=float(dc["roughness_edge_stopping_relaxation"]),
            roughness_edge_stopping_enabled=float(dc["roughness_edge_stopping_enabled"]))

    def per(key):
        vals = tuple(float(dc[wh + key]) for wh in names)
        return vals if both else vals[0]
    out = k_atrous.relax_atrous(
        signal, view_z_in, normal_roughness, history_length, diff_confidence, spec_confidence,
        reprojection_confidence, step_size=step_size, is_first=is_first,
        frame_index=int(sc["frame_index"]), **_frame_geometry(sc),
        denoising_range=float(sc["denoising_range"]),
        depth_threshold=float(dc["depth_threshold"]),
        lobe_fraction=k_atrous.lobe_fraction(dc["lobe_angle_fraction"], step_size, is_first,
                                             sh=sh is not None),
        lobe_angle_fraction=float(dc["lobe_angle_fraction"]),
        phi_luminance=per("_phi_luminance"),
        max_luminance_relative_difference=per("_max_luminance_relative_difference"),
        min_material=per("_min_material"),
        history_threshold=float(dc["history_threshold"]),
        confidence_relaxation=(
            float(dc["confidence_driven_relaxation_multiplier"]),
            float(dc["confidence_driven_normal_edge_stopping_relaxation"]),
            float(dc["confidence_driven_luminance_edge_stopping_relaxation"])),
        specular=specular, roughness_encoding=config.roughness_encoding, sh=sh,
        decoded=fe.decoded_normals(config.normal_encoding))
    if sh is None:
        return out
    n = len(names)
    cur, cur_sh = (out[:n], out[n:]) if both else out
    if is_last:
        cur = tuple(_to_ycocg(c) for c in cur) if both else _to_ycocg(cur)
    return cur, cur_sh


def _to_ycocg(signal):
    return torch.cat([nm.linear_to_ycocg(signal[..., :3]), signal[..., 3:]], -1)


def split_screen(sc, view_z_in, noisy, out_signal, sh_mode=False):
    """SplitScreen: the noisy input (0 beyond the denoising range) left of the split; with the
    SH variants (`sh_mode`) the noisy rgb in YCoCg, as the denoised SH0 is."""
    h, w = view_z_in.shape
    view_z = unpack_view_z(sc, view_z_in)
    u = nm.div(torch.arange(w, dtype=torch.float32, device=view_z_in.device) + 0.5, w)
    s = _to_ycocg(noisy) if sh_mode else noisy
    s = s * (view_z < float(sc["denoising_range"])).to(torch.float32)[..., None]
    return torch.where(u[None, :, None] <= float(sc["split_screen"]), s, out_signal)
