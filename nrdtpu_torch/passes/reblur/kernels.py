"""REBLUR diffuse and specular passes - counterpart of the XLA functions in
`nrdtpu/passes/reblur/kernels.py` (REBLUR_*.hlsli).

Each pass is elementwise torch glue around hand-written kernels of `nrdtpu_torch.kernels`:

  surface_motion_reprojection     -> smb_resolve     (prev footprint + history sampling,
                                                      one launch for one or both signals)
  temporal_accumulation_specular  -> spec_ta_head    (3x3 stencils, curvature neighbours)
                                     nearest_multi   (stochastic nearest previous normals; at
                                                      the RGBA formats bilinear_resolve)
                                     vmb_resolve     (virtual-motion footprint + history)
  diffuse_pre_pass, diffuse_spatial_filter,
  specular_spatial_filter         -> spatial_filter  (PrePass / Blur / PostBlur tap loop)
  fused_spatial_filter            -> spatial_filter_fused (the same, both signals at once)
  history_fix                     -> history_fix     (stride taps + 3x3 fast-history moments
                                                      + the anti-firefly ring + the clamp)
  fused_history_fix               -> history_fix_fused (the same, both signals at once)
  spatial_band                    -> reblur_band     (history fix, its clamp, Blur and PostBlur
                                                      of both signals, one launch)
  temporal_stabilization,
  temporal_stabilization_specular -> ts_prelude      (3x3 luma moments, history sampling and
                                                      the rest of the half, one launch each)
  hit_dist_reconstruction         -> hitdist_recon   (3x3 / 5x5 refill of hitT == 0)

With the SH variants (REBLUR_*_SH) each pass also carries each signal's SH1 (`sh=`): its SH
rides the same launches (the kernels' SH modes), and its lerps and luma scales are glue here,
as in the XLA functions; a pass given `sh` returns the SH last.

With the occlusion variants (REBLUR_*_OCCLUSION) every signal and history is (h, w, 1), the
normalized hit distance: the kernels take their one-channel modes from the signal's shape,
the TA halves take `occlusion=True` (the one-channel mixes, no firefly suppressor), and under
checkerboard `cb_resolve` fills the pixels without data (glue, as in JAX).

With REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (`directional=True` on the diffuse TA, the history fix
and TS) the (h, w, 4) signal is the direction times the normalized hit distance and the hit
distance: the luma is .w, the luma changes scale .xyz by the change of .w, and the radiance
mixes, taps and spatial filters serve unchanged (`nrdtpu/passes/reblur/common.py:139-158`).

At SQ_LINEAR and SQRT_LINEAR roughness the denoiser decodes IN_NORMAL_ROUGHNESS and the
previous frame's copy once a frame (`frontend.decode_roughness_plane`) and hands the decoded
planes to every reader of the roughness, as the reference's `unpack_nr` decodes at each read,
with one exception that the reference makes: HistoryFix, PrePass, Blur and PostBlur take their
centre pixel's roughness as packed (`unpack_nr3`, `nrdtpu/passes/reblur/kernels.py:37-42`)
and only their taps' decoded (`:642`, `:850`, `:1716`, `:2169`). So their centre geometry is
built from the packed plane and their taps read `tap_normal_roughness`, the decoded copy; H2,
which computes its centre itself, takes the packed plane and decodes at its taps (its
`kRough` instances, `roughness_encoding=`). That exception is R10G10B10A2's alone.

At the RGBA normal encodings (RGBA8 / RGBA16, UNORM / SNORM) the reference decodes every read
of IN_NORMAL_ROUGHNESS, the centres' too (`unpack_nr3` falls back to `unpack_nr`), and tests
no material. The denoiser decodes the input and the previous frame's copy once a frame
(`frontend.decode_normal_plane`, then the roughness, `decode_roughness_plane(decoded=True)`)
and every reader takes those planes at LINEAR: the glue through `unpack_nr`, the kernels in
their decoded modes (`decoded=`, `kDec`; `geom["decoded"]` for the fused passes). Two readers
keep the packed planes (`packed=` on the specular TA): the previous normals along the virtual
motion, which the reference samples bilinearly from the packed plane and only then unpacks
(`bilinear_resolve`, no hash draws, no lerp of the prev-prev weights), and the curvature
neighbours, whose .xy the reference decodes as octahedral at every encoding (ROADMAP.md Queue
3).

The glue keeps the op order of the XLA functions; the kernels compute the per-pixel formula
of the XLA gathers, not the TPU kernels' workarounds. Frame constants (`sc`, `dc`) are host
values, so nothing but pixel planes lives on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ... import math as nm
from ... import vec3 as v3
from ...frontend import NRD_EPS
from ...kernels import bilinear_resolve as k_bilinear
from ...kernels import history_fix as k_history_fix
from ...kernels import history_fix_fused as k_history_fix_fused
from ...kernels import hitdist_recon as k_hitdist_recon
from ...kernels import nearest_multi as k_nearest_multi
from ...kernels import reblur_band as k_reblur_band
from ...kernels import smb_resolve as k_smb_resolve
from ...kernels import spatial_filter as k_spatial_filter
from ...kernels import spatial_filter_fused as k_spatial_filter_fused
from ...kernels import spec_ta_head as k_spec_ta_head
from ...kernels import ts_prelude as k_ts_prelude
from ...kernels import vmb_resolve as k_vmb_resolve
from ...ops import resample, tiles
from . import common as C
from .params import (BLUR, POST_BLUR, PRE_BLUR, _v, diff_spatial_params, filter_geometry,
                     spec_spatial_params)


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def unpack_view_z(sc, z):
    return torch.abs(z) * float(sc["view_z_scale"])


def unpack_nr(normal_roughness, config):
    """(normal, roughness, material) of the plane a reader takes: packed R10G10B10A2, or at
    the RGBA formats the plane that the denoiser decodes once a frame (material 0)."""
    return fe.unpack_normal_plane(normal_roughness, _decoded(config), config.roughness_encoding)


def _decoded(config):
    """Whether the frame's planes are the RGBA formats' decoded ones (the kernels' kDec)."""
    return fe.decoded_normals(config.normal_encoding)


def classify_tiles(sc, view_z):
    return tiles.classify_sky_tiles(unpack_view_z(sc, view_z), float(sc["denoising_range"]))


def sky_pixel_mask(sc, tile_map, view_z, row0=0):
    """Combined early-out mask: sky tile or beyond denoising range (True = skip); view_z's rows
    are the frame rows row0 .. row0 + h - 1 of the frame whose tile map is given."""
    h, w = view_z.shape
    sky = tiles.tile_upsample_nearest(tile_map, h, w, row0=row0)
    return (sky > 0.0) | (unpack_view_z(sc, view_z) > float(sc["denoising_range"]))


def surface_motion_position(sc, uv, view_z, x, mv_in):
    """Surface-motion previous position and uv (TA lines 131-150, TS lines 50-70)."""
    mvs = _v(sc["mv_scale"])
    mv = torch.stack([mv_in[..., i] * mvs[i] for i in range(3)], -1)
    is_world_mv = mvs[3] != 0.0
    smb_uv_screen = uv + mv[..., :2]
    mv_z_computed = nm.affine_transform(sc["world_to_view_prev"], x)[..., 2] - view_z
    mv_z = mv_z_computed if mvs[2] == 0.0 else mv[..., 2]
    view_z_prev = view_z + mv_z
    xv_prev_local = nm.reconstruct_view_position(smb_uv_screen, sc["frustum_prev"],
                                                 view_z_prev, sc["ortho_mode"])
    cd = _v(sc["camera_delta"])
    x_prev_screen = nm.rotate_vector_transposed(sc["world_to_view_prev"], xv_prev_local)
    x_prev_screen = torch.stack([x_prev_screen[..., i] + cd[i] for i in range(3)], -1)
    if is_world_mv:
        x_prev_world = x + mv
        return x_prev_world, nm.get_screen_uv(sc["world_to_clip_prev"], x_prev_world)
    return x_prev_screen, smb_uv_screen


# ---------------------------------------------------------------------------
# TemporalAccumulation (REBLUR_TemporalAccumulation.hlsli) - diffuse
# ---------------------------------------------------------------------------


def surface_motion_reprojection(sc, dc, view_z_in, normal_roughness, mv_in, prev_view_z,
                                prev_normal_roughness, prev_internal, config, histories,
                                disocclusion_threshold_mix=None, sh_histories=None, row0=0,
                                frame_h=None):
    """The surface-motion machinery of TA (lines 131-305) plus the history samples at the
    reprojected position (`sample_history` / `sample_history_bilinear`, lines 451-456).

    prev_internal: dict(diff_accum, spec_accum, material_id); histories: {signal: (history,
    fast_history)} for the signals present ("diff", "spec" or both), whose histories, fast
    histories and accumulation speeds are sampled. The footprint gathers and the history
    sampling run in one `kernels.smb_resolve` launch; the rest is elementwise here. Returns
    the `sm` dict both TA halves read, with `{signal}_history`, `{signal}_fast` and
    `{signal}_accum_speed` per signal; with the SH variants' `sh_histories` ({signal: bf16 SH
    history}) also `{signal}_sh`, each sampled as the fast history is (`:473-476`). row0,
    frame_h: the current planes are the frame rows row0 .. row0 + h - 1 of a frame frame_h high
    (a band of `parallel.shard_stencil`); the previous planes and histories are whole frames."""
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device, row0, frame_h)
    view_z = unpack_view_z(sc, view_z_in)
    n, roughness, material_id = unpack_nr(normal_roughness, config)

    xv = nm.reconstruct_view_position(uv, sc["frustum"], view_z, sc["ortho_mode"])
    x = nm.rotate_vector(sc["view_to_world"], xv)
    x_prev, smb_pixel_uv = surface_motion_position(sc, uv, view_z, x, mv_in)

    # parallax (lines 206-211)
    ortho = float(sc["ortho_mode"])
    cd = _v(sc["camera_delta"])
    uv_zp1 = smb_pixel_uv if ortho == 0.0 else uv
    uv_zp2 = uv if ortho == 0.0 else smb_pixel_uv
    p1_uv = nm.get_screen_uv(sc["world_to_clip_prev"],
                             torch.stack([x_prev[..., i] + cd[i] for i in range(3)], -1))
    p2_uv = nm.get_screen_uv(sc["world_to_clip"],
                             torch.stack([x_prev[..., i] - cd[i] for i in range(3)], -1))
    rw, rh = _v(sc["rect_size"])
    parallax1 = nm.length(nm.scale2(p1_uv - uv_zp1, rw, rh))
    parallax2 = nm.length(nm.scale2(p2_uv - uv_zp2, rw, rh))
    parallax_max = torch.maximum(parallax1, parallax2)
    parallax_min = torch.minimum(parallax1, parallax2)

    # disocclusion threshold (lines 213-234)
    pixel_size = nm.pixel_radius_to_world(float(sc["unproject"]), ortho, 1.0, view_z)
    frustum_size = nm.get_frustum_size(float(sc["min_rect_dim_mul_unproject"]), ortho, view_z)
    mix_ = torch.where(material_id == float(sc["strand_material_id"]),
                       fe.get_normalized_strand_thickness(float(sc["strand_thickness"]),
                                                          pixel_size), 0.0)
    if disocclusion_threshold_mix is not None:
        mix_ = disocclusion_threshold_mix
    bonus = np.float32(sc["disocclusion_threshold_bonus"])
    disocclusion_threshold = nm.lerp(float(np.float32(sc["disocclusion_threshold"]) + bonus),
                                     float(np.float32(sc["disocclusion_threshold_alternate"])
                                           + bonus), mix_)
    small_parallax = nm.linearstep(0.25, 0.0, parallax_max)
    disocclusion_threshold = disocclusion_threshold + 0.05 * small_parallax

    v = C.get_view_vector(sc, x)
    nov = torch.abs(nm.dot(n, v))
    nov_strict = nm.lerp(nov, 1.0, nm.saturate(parallax_max / 30.0))
    base_threshold = nm.get_disocclusion_threshold(disocclusion_threshold, frustum_size,
                                                   nov_strict)
    navg_thr = C.REBLUR_ALMOST_ZERO_ANGLE - 0.25 * small_parallax
    xv_prev = nm.affine_transform(sc["world_to_view_prev"], x_prev)

    # the material test takes the smaller minimum even for diffuse
    # (nrdtpu/passes/reblur/kernels.py:214)
    min_material = min(float(dc["spec_min_material"]), float(dc["diff_min_material"]))
    signals = [sig for sig in ("diff", "spec") if sig in histories]
    per_signal = [(prev_internal[f"{sig}_accum"], *histories[sig]) for sig in signals]
    res = k_smb_resolve.smb_resolve(
        smb_pixel_uv.contiguous(), xv_prev[..., 2].contiguous(), base_threshold.contiguous(),
        navg_thr.contiguous(), normal_roughness, prev_view_z, prev_normal_roughness,
        prev_internal["material_id"], *per_signal[0],
        view_z_scale=float(sc["view_z_scale"]), denoising_range=float(sc["denoising_range"]),
        rect_size_prev=_v(sc["rect_size_prev"]), min_material=min_material,
        world_prev_to_world=np.asarray(sc["world_prev_to_world"], np.float32)[:3, :3],
        second=per_signal[1] if len(signals) == 2 else None,
        sh=None if sh_histories is None else [sh_histories[sig] for sig in signals],
        decoded=_decoded(config))

    # footprint quality (lines 296-305)
    smb_vprev = C.get_view_vector_prev(sc, x_prev)
    nov_prev = torch.abs(nm.dot(n, smb_vprev))
    size_quality = (nov_prev + 1e-3) / (nov + 1e-3)
    size_quality = size_quality * size_quality
    size_quality = nm.lerp(0.1, 1.0, nm.saturate(size_quality))
    footprint_quality = torch.sqrt(nm.saturate(res["footprint_raw"])) * size_quality

    sm = {"uv": uv, "view_z": view_z, "n": n, "roughness": roughness,
          "material_id": material_id, "x": x, "v": v, "nov": nov, "n_avg": res["n_avg"],
          "smb_navg": res["smb_navg"], "x_prev": x_prev, "smb_pixel_uv": smb_pixel_uv,
          "parallax_max": parallax_max, "parallax_min": parallax_min,
          "pixel_size": pixel_size, "frustum_size": frustum_size,
          "allow_catrom": res["allow_catrom"], "fbits": res["fbits"],
          "footprint_quality": footprint_quality, "dis_thr": disocclusion_threshold}
    for sig, suffix in zip(signals, ("", "_2")):
        sm[f"{sig}_accum_speed"] = res["accum_speed" + suffix]
        sm[f"{sig}_history"] = res["history" + suffix]
        sm[f"{sig}_fast"] = res["fast" + suffix]
        if sh_histories is not None:
            sm[f"{sig}_sh"] = res["sh" + suffix]
    return sm


def temporal_accumulation_diffuse(sc, dc, sm, diff_input, diff_confidence=None, has_data=None,
                                  sh_input=None, occlusion=False, directional=False):
    """Diffuse half of TA (lines 826-930) for the radiance signal; has_data: under
    checkerboard the (h, w) bool plane of the pixels with data, whose neighbours accumulate
    slower (`nrdtpu/passes/reblur/kernels.py:459-464`, `:499-503`), else None; sh_input: with
    the SH variants the SH1 input, mixed with `sm["diff_sh"]` over all four channels and
    scaled by the anti-firefly luma (`:469-478`, `:492-495`); occlusion: the (h, w, 1) hit
    distance, mixed by f_hit alone, no firefly suppressor (`:457`, `:465-468`, `:481`, `:506`);
    directional: the (h, w, 4) directional occlusion, its history's .xyz scaled with the
    saturated .w, the radiance mix, no firefly suppressor, the fast history from .w.
    Returns (diff_out, fast_out, accum_speed_out[, sh_out])."""
    diff_accum_speed = sm["diff_accum_speed"]
    confidence = sm["footprint_quality"]
    if diff_confidence is not None:
        confidence = confidence * diff_confidence
    diff_accum_speed = diff_accum_speed * nm.lerp(confidence, 1.0,
                                                  1.0 / (1.0 + diff_accum_speed))
    diff_accum_speed = torch.clamp_max(diff_accum_speed, float(dc["max_accumulated_frame_num"]))

    smb_diff_history = C.clamp_negative_to_zero(sm["diff_history"], occlusion, directional)
    smb_diff_fast = sm["diff_fast"]

    diff_nlas = 1.0 / (1.0 + diff_accum_speed)
    if has_data is not None:
        diff_nlas = torch.where(has_data, diff_nlas, diff_nlas * C.no_data_scale(sc, diff_nlas))
    diff_result = C.mix_history_and_current(dc, smb_diff_history, diff_input, diff_nlas,
                                            torch.ones_like(diff_nlas), occlusion)

    # firefly suppressor (lines 888-903), not for occlusion
    sh_result = None
    if not occlusion and not directional:
        max_rel = (float(dc["firefly_suppressor_min_relative_scale"])
                   + C.REBLUR_FIREFLY_SUPPRESSOR_MAX_RELATIVE_INTENSITY
                   / (diff_accum_speed + 1.0))
        antifirefly = diff_accum_speed * float(dc["max_blur_radius"]) \
            * C.REBLUR_FIREFLY_SUPPRESSOR_RADIUS_SCALE
        antifirefly = antifirefly / (1.0 + antifirefly)
        luma = C.get_luma(diff_result)
        luma_clamped = torch.minimum(luma, C.get_luma(smb_diff_history) * max_rel)
        luma_clamped = nm.lerp(luma, luma_clamped, antifirefly)
        diff_result = C.change_luma(diff_result, luma_clamped)
        if sh_input is not None:
            sh_result = C.mix_history_and_current(dc, sm["diff_sh"], sh_input, diff_nlas,
                                                  torch.ones_like(diff_nlas))
            sh_result = C.sh_luma_scale(sh_result, luma_clamped)

    # fast history (lines 911-924)
    fast_accum_speed = torch.clamp_max(diff_accum_speed,
                                       float(dc["max_fast_accumulated_frame_num"]))
    fast_nlas = 1.0 / (1.0 + fast_accum_speed)
    if has_data is not None:
        fast_nlas = torch.where(has_data, fast_nlas, fast_nlas * C.no_data_scale(sc, fast_nlas))
    fast_result = nm.lerp(smb_diff_fast, C.get_luma(diff_input, occlusion, directional),
                          fast_nlas)
    if not occlusion and not directional:
        fast_clamped = torch.minimum(fast_result, C.get_luma(smb_diff_history) * max_rel
                                     * C.REBLUR_FIREFLY_SUPPRESSOR_FAST_RELATIVE_INTENSITY)
        fast_result = nm.lerp(fast_result, fast_clamped, antifirefly)
    if sh_input is not None:
        return diff_result, fast_result, diff_accum_speed, sh_result
    return diff_result, fast_result, diff_accum_speed


# ---------------------------------------------------------------------------
# TemporalAccumulation - specular half (REBLUR_TemporalAccumulation.hlsli:323-814)
# ---------------------------------------------------------------------------


def get_xvirtual(hit_dist, curvature, x, x_prev, n, v, roughness):
    """GetXvirtual, NRD_USE_SPECULAR_MOTION_V2 == 1 (Common.hlsli:411-461), on (..., 3)."""
    d4 = nm.get_specular_dominant_direction(n, v, roughness)
    d, dw = d4[..., :3], d4[..., 3]
    reflection_ray = d * hit_dist[..., None]
    t, b = nm.get_basis(n)
    o = nm.rotate_vector_by_basis(t, b, n, reflection_ray)
    oz = -o[..., 2]
    mag = 1.0 / (2.0 * curvature * oz - 1.0)
    f = nm.length(x)
    f = f * (1.0 - torch.abs(nm.dot(n, v)))
    f = f * torch.clamp_min(curvature, 0.0)
    mag = mag / (1.0 + f)
    iw_len = nm.length(o * mag[..., None])
    closeness = nm.saturate(iw_len / (hit_dist + NRD_EPS))
    origin = nm.lerp(x_prev, x, (closeness * dw)[..., None])
    return origin - v * (iw_len * dw)[..., None]


def get_xvirtual3(hit_dist, curvature, x, x_prev, n, v, roughness):
    """get_xvirtual on plane-wise V3s."""
    d, dw = v3.get_specular_dominant_direction(n, v, roughness, nm.get_specular_dominant_factor)
    reflection_ray = d * hit_dist
    t, b = v3.get_basis(n)
    o = v3.V3(v3.dot(t, reflection_ray), v3.dot(b, reflection_ray), v3.dot(n, reflection_ray))
    mag = 1.0 / (2.0 * curvature * -o.z - 1.0)
    f = v3.length(x)
    f = f * (1.0 - torch.abs(v3.dot(n, v)))
    f = f * torch.clamp_min(curvature, 0.0)
    mag = mag / (1.0 + f)
    iw_len = v3.length(o * mag)
    closeness = nm.saturate(iw_len / (hit_dist + NRD_EPS))
    origin = v3.lerp(x_prev, x, closeness * dw)
    return origin - v * (iw_len * dw)


def _stochastic_bilinear_uvs(sc, uvs, tex_size):
    """StochasticBilinear (Common.hlsli:359-372) of each uv in turn: one Rng stream per pixel
    (Rng::Hash::Initialize at TA :117), two draws per fetch, in the reference's order."""
    h, w = uvs[0].shape[:2]
    dev = uvs[0].device
    state = nm.hash_init(torch.arange(w, device=dev)[None, :].expand(h, w),
                         torch.arange(h, device=dev)[:, None].expand(h, w), sc["frame_index"])
    out = []
    for uv in uvs:
        state, rnd = nm.hash_float2(state)
        origin, f = nm.bilinear_filter(uv, tex_size)
        origin = origin + (rnd < f).to(torch.float32)
        out.append(torch.stack([nm.div(origin[..., 0] + 0.5, tex_size[0]),
                                nm.div(origin[..., 1] + 0.5, tex_size[1])], -1))
    return torch.stack(out)


def temporal_accumulation_specular(sc, dc, sm, spec_input, spec_history, spec_fast_history,
                                   view_z_in, normal_roughness, prev_view_z,
                                   prev_normal_roughness, prev_internal,
                                   hit_dist_for_tracking_in, prev_spec_hitdist_for_tracking,
                                   config, spec_confidence=None, *, has_prepass_hitdist,
                                   has_data=None, sh_input=None, sh_history=None,
                                   occlusion=False, packed=None):
    """Specular half of TA (`nrdtpu/passes/reblur/kernels.py:978-1548`, XLA path) for the
    radiance signal; `sm` is surface_motion_reprojection with the "spec" signal. The gathers run
    in three kernels: spec_ta_head (3x3 stencils, curvature neighbours, high-parallax
    nearest), nearest_multi (stochastic nearest previous normals) and vmb_resolve (the
    virtual-motion footprint and history samples); has_data as for
    temporal_accumulation_diffuse (`:1466-1474`, `:1524-1529`); sh_input, sh_history: with the
    SH variants the SH1 input and the bf16 SH history, sampled at the virtual-motion position
    in vmb_resolve's launch, its surface-motion sample `sm["spec_sh"]`; the two SH lerps, .w
    set to the modified roughness, and the anti-firefly scale (`:1483-1500`, `:1516-1521`);
    occlusion: the (h, w, 1) hit distance and history (vmb_resolve's one-channel mode), mixed
    by f_hit alone, no firefly suppressor (`:1464-1480`, `:1507`, `:1533`).
    At the RGBA formats normal_roughness and prev_normal_roughness are the decoded planes and
    `packed` is (IN_NORMAL_ROUGHNESS, the previous frame's copy) as packed, in config's
    encodings: spec_ta_head reads the first with its roughness decoded, and the virtual-motion
    normal and the prev-prev taps are bilinear samples of the second (`bilinear_resolve`),
    unpacked after the blend (`_sample_normal_roughness_stochastic`, `:920-931`), without hash
    draws and without the lerp of the prev-prev weights (`:1383-1385`). At R10G10B10A2 config
    is the planes' (LINEAR where the denoiser decoded the roughness) and `packed` None.
    Returns dict(spec, fast, accum_speed, fbits_vmb, curvature, virtual_history_amount,
    hit_dist_for_tracking[, sh])."""
    h, w = view_z_in.shape
    uv, view_z = sm["uv"], sm["view_z"]
    n, roughness, nov = sm["n"], sm["roughness"], sm["nov"]
    enc_err = nm.normal_encoding_error(int(config.normal_encoding))
    decoded = _decoded(config)
    if decoded == (packed is None):
        raise ValueError("packed: the packed planes at the RGBA formats, and only there")
    ortho = float(sc["ortho_mode"])
    is_persp = ortho == 0.0
    rw_, rh_ = _v(sc["rect_size"])
    riw_, rih_ = _v(sc["rect_size_inv"])
    rect_prev = _v(sc["rect_size_prev"])
    mafn = float(dc["max_accumulated_frame_num"])
    hffn = float(dc["history_fix_frame_num"])

    x3, xp3, n3, vv3 = v3.V3.of(sm["x"]), v3.V3.of(sm["x_prev"]), v3.V3.of(n), v3.V3.of(sm["v"])
    u_p, v_p = uv[..., 0], uv[..., 1]
    smb_u, smb_v = sm["smb_pixel_uv"][..., 0], sm["smb_pixel_uv"][..., 1]
    cd = _v(sc["camera_delta"])
    cd3 = v3.V3(cd[0], cd[1], cd[2])

    # curvature direction: predicted motion (lines 356-380)
    p1u, p1v = v3.get_screen_uv(sc["world_to_clip_prev"], xp3 + cd3)
    dux = ((smb_u if is_persp else u_p) - p1u) * rw_
    duy = ((smb_v if is_persp else v_p) - p1v) * rh_
    parallax1 = torch.sqrt(dux * dux + duy * duy)
    inv_par = 1.0 / torch.clamp_min(parallax1, 1.0 / 256.0)
    dux = dux * inv_par
    duy = duy * inv_par

    # high-parallax flattening position (lines 404-429)
    bayer = nm.bayer4x4_planes(h, w, sc["frame_index"], view_z.device)
    delta_uv_len_fixed = sm["parallax_min"] * (1.0 + float(sc["framerate_scale"]) * bayer)
    mu = u_p + delta_uv_len_fixed * dux * riw_
    mv_ = v_p + delta_uv_len_fixed * duy * rih_
    mu = (torch.floor(mu * rw_) + 0.5) * riw_
    mv_ = (torch.floor(mv_ * rh_) + 0.5) * rih_
    in_screen_high = (mu > 0.0) & (mu < 1.0) & (mv_ > 0.0) & (mv_ < 1.0)

    # 3x3 min hitDist for tracking + roughness variance (lines 62-111), the curvature
    # neighbours and the high-parallax nearest fetches: one launch. At the RGBA formats its
    # plane is the packed input with its roughness .w decoded: the curvature lanes read .xy
    # of the packed texel, as the reference does (its fault, ROADMAP.md Queue 3)
    head_nr = (fe.decode_roughness_plane(packed[0], config.roughness_encoding, decoded=True)
               if decoded else normal_roughness)
    head = k_spec_ta_head.spec_ta_head(hit_dist_for_tracking_in.contiguous(), head_nr,
                                       view_z_in, torch.stack([mu, mv_], -1), decoded=decoded)
    roughness_sigma = nm.get_std_dev(head["rough_m1"], head["rough_m2"])
    roughness_modified = C.get_modified_roughness_from_normal_variance(roughness, sm["n_avg"])
    hit_dist_normalization = fe.get_hit_distance_normalization(view_z, dc["hit_dist_params"],
                                                               roughness)
    hit_dist_for_tracking = torch.where(head["hdt_min"] == fe.NRD_INF, 0.0, head["hdt_min"])
    if not has_prepass_hitdist:
        hit_dist_for_tracking = hit_dist_for_tracking * hit_dist_normalization

    # accumulation speed (lines 325-331)
    confidence = sm["footprint_quality"]
    if spec_confidence is not None:
        confidence = confidence * spec_confidence
    smb_accum = sm["spec_accum_speed"]
    smb_accum = smb_accum * nm.lerp(confidence, 1.0, 1.0 / (1.0 + smb_accum))
    smb_accum = torch.clamp_max(smb_accum, mafn)
    spec = spec_input

    # curvature estimation along the predicted motion (lines 381-447)
    v2w = sc["view_to_world"]
    vvw = _v(sc["view_vector_world"])
    ones = torch.ones_like(view_z)

    def edge_point(du_, dv_):
        xe = v3.reconstruct_view_position(u_p + du_ * riw_, v_p + dv_ * rih_, sc["frustum"],
                                          ones, ortho)
        xw = v3.rotate(v2w, xe)
        vw = v3.normalize(-xw) if is_persp else v3.V3.full_like(view_z, *vvw)
        o = v3.V3.full_like(view_z, 0.0, 0.0, 0.0) if is_persp else xw
        ndv = v3.dot(n3, vw)
        t = v3.dot(x3 - o, n3) / torch.where(torch.abs(ndv) < 1e-9, 1e-9, ndv)
        return o + vw * t

    x10 = edge_point(1.0, 0.0)
    x01 = edge_point(0.0, 1.0)
    # octahedral .xy at every encoding, the reference's reads (`kernels.py:1094-1097`,
    # `:1126-1128`); at the RGBA formats a fault of the reference (ROADMAP.md Queue 3)
    n10 = v3.decode_oct_raw(head["nr01_0"], head["nr01_1"])
    n01 = v3.decode_oct_raw(head["nr10_0"], head["nr10_1"])
    wmx = torch.abs(dux) + 1.0 / 256.0
    wmy = torch.abs(duy) + 1.0 / 256.0
    wnorm = 1.0 / (wmx + wmy)
    wmx = wmx * wnorm
    wmy = wmy * wnorm
    x_edge = x10 * wmx + x01 * wmy
    n_edge = v3.normalize(n10 * wmx + n01 * wmy)

    z_high = unpack_view_z(sc, head["z_high"])
    n_high = v3.decode_oct_raw(head["nr_high_0"], head["nr_high_1"])
    x_high = v3.rotate(v2w, v3.reconstruct_view_position(mu, mv_, sc["frustum"], z_high, ortho))
    z_error = torch.abs(z_high - view_z) / torch.clamp_min(torch.maximum(z_high, view_z), 1e-15)
    replace = (z_error < C.NRD_CURVATURE_Z_THRESHOLD) & (delta_uv_len_fixed > 1.0) \
        & in_screen_high
    x_edge = v3.where(replace, x_high, x_edge)
    n_edge = v3.where(replace, n_high, n_edge)
    edge = x_edge - x3
    edge_len_sq = v3.dot(edge, edge)
    curvature = v3.dot(n_edge - n3, edge) / torch.clamp_min(edge_len_sq, 1e-15)
    curvature = torch.where(edge_len_sq < 1e-15, 0.0, curvature)

    # virtual motion coordinates (lines 449-457)
    x_virtual3 = get_xvirtual3(hit_dist_for_tracking, curvature, x3, xp3, n3, vv3, roughness)
    x_virtual_length = v3.length(x_virtual3)
    vmb_u, vmb_v = v3.get_screen_uv(sc["world_to_clip_prev"], x_virtual3)
    is_camera_attached = sm["material_id"] == float(sc["camera_attached_reflection_material_id"])
    vmb_u = torch.where(is_camera_attached, smb_u, vmb_u)
    vmb_v = torch.where(is_camera_attached, smb_v, vmb_v)
    vmb_pixel_uv = torch.stack([vmb_u, vmb_v], -1)
    vdx = (vmb_u - smb_u) * rw_
    vdy = (vmb_v - smb_v) * rh_
    vmb_pixels_traveled = torch.sqrt(vdx * vdx + vdy * vdy)
    ra, rb = nm.get_relaxed_roughness_weight_params(
        roughness * roughness, float(dc["roughness_fraction"]),
        C.REBLUR_ROUGHNESS_SENSITIVITY_IN_TA)

    # virtual normal confidence: the vmb normal and the prev-prev taps (lines 472-479,
    # 579-585), fetched stochastically-nearest in one launch; at the RGBA formats bilinear
    # samples of the packed previous plane, unpacked after the blend (`kernels.py:920-931`)
    iters = C.REBLUR_VIRTUAL_MOTION_PREV_PREV_WEIGHT_ITERATION_NUM
    step_between_taps = torch.clamp_max(vmb_pixels_traveled * float(sc["framerate_scale"]),
                                        2.0) + vmb_pixels_traveled / iters
    duv_u = vmb_u - smb_u
    duv_v = vmb_v - smb_v
    inv_vd = torch.rsqrt(torch.clamp_min(duv_u * duv_u + duv_v * duv_v, 1e-15))
    vmb_dir_u = nm.div(duv_u * inv_vd, rect_prev[0])
    vmb_dir_v = nm.div(duv_v * inv_vd, rect_prev[1])
    pp_uvs, pp_inscreen = [], []
    for it in range(1, iters + 1):
        ppu = vmb_u + vmb_dir_u * (it * step_between_taps)
        ppv = vmb_v + vmb_dir_v * (it * step_between_taps)
        pp_uvs.append(torch.stack([ppu, ppv], -1))
        pp_inscreen.append((ppu > 0.0) & (ppu < 1.0) & (ppv > 0.0) & (ppv < 1.0))
    if decoded:
        taps = [fe.unpack_normal_roughness(t, config.normal_encoding, config.roughness_encoding)
                for t in k_bilinear.bilinear_resolve(
                    packed[1], torch.stack([vmb_pixel_uv] + pp_uvs), scale=(1.0, 1.0))]
    else:
        ph, pw = prev_normal_roughness.shape[:2]
        taps = [unpack_nr(t, config) for t in k_nearest_multi.nearest_multi(
            prev_normal_roughness,
            _stochastic_bilinear_uvs(sc, [vmb_pixel_uv] + pp_uvs, (float(pw), float(ph))))]
    vmb_n, vmb_roughness, _ = taps[0]
    vmb_n3 = v3.rotate(sc["world_prev_to_world"], v3.V3.of(vmb_n))
    dfactor = nm.get_specular_dominant_factor(nov, roughness)
    virtual_normal_confidence = 1.0 / (
        1.0 + 0.5 * dfactor * nm.saturate(v3.length(n3 - vmb_n3) - enc_err)
        * vmb_pixels_traveled)
    smb_navg3 = v3.where(sm["footprint_quality"] == 0.0, vmb_n3, v3.V3.of(sm["smb_navg"]))

    # virtual motion disocclusion (lines 481-519): the footprint gathers in one launch
    vmb_thr = sm["dis_thr"] * sm["frustum_size"]
    vmb_thr = vmb_thr * nm.lerp(0.25, 1.0, nov)
    vmb_thr = vmb_thr * (v3.dot(vmb_n3, n3) > C.REBLUR_ALMOST_ZERO_ANGLE).to(torch.float32)
    vmb_thr = vmb_thr * (v3.dot(vmb_n3, smb_navg3) > C.REBLUR_ALMOST_ZERO_ANGLE).to(torch.float32)
    vmb_vv3 = v3.reconstruct_view_position(vmb_u, vmb_v, sc["frustum_prev"], ones, 0.0)
    vmb_v3_ = v3.rotate_inv(sc["world_to_view_prev"], vmb_vv3)
    nox_curr = v3.dot(n3, xp3 - cd3)
    params = torch.stack([nox_curr, vmb_thr, n3.x, n3.y, n3.z, vmb_v3_.x, vmb_v3_.y, vmb_v3_.z,
                          ra, rb, roughness_sigma, nm.smoothstep(1.0, 0.0, sm["parallax_max"]),
                          sm["material_id"], sm["allow_catrom"].to(torch.float32)])
    vmb = k_vmb_resolve.vmb_resolve(
        vmb_pixel_uv, params, prev_view_z, prev_normal_roughness, prev_internal["material_id"],
        prev_internal["spec_accum"], spec_history, spec_fast_history,
        prev_spec_hitdist_for_tracking, view_z_scale=float(sc["view_z_scale"]),
        ortho_mode=ortho, rect_size_prev=rect_prev, min_material=float(dc["spec_min_material"]),
        resolution_scale_prev=_v(sc["resolution_scale_prev"]),
        sh_history=sh_history if sh_input is not None else None, decoded=decoded)
    virtual_roughness_confidence = vmb["rough_conf"]
    vmb_footprint_quality = torch.sqrt(nm.saturate(vmb["footprint_raw"]))
    vmb_accum = vmb["accum_raw"]
    vmb_accum = vmb_accum * nm.lerp(vmb_footprint_quality, 1.0, 1.0 / (1.0 + vmb_accum))

    # curvature / lobe angles (lines 532-554)
    curvature_angle_tan = sm["pixel_size"] * torch.abs(curvature)
    curvature_angle_tan = curvature_angle_tan * torch.clamp_min(
        vmb_pixels_traveled / torch.clamp_min(nov, 0.01), 1.0)
    curvature_angle_tan = curvature_angle_tan * 2.0
    curvature_angle = torch.atan(curvature_angle_tan)
    percent_of_volume = nm.NRD_MAX_PERCENT_OF_LOBE_VOLUME / (1.0 + vmb_accum)
    lobe_tan_half = nm.get_specular_lobe_tan_half_angle(roughness_modified, percent_of_volume)
    lobe_half_angle = torch.clamp_min(torch.atan(lobe_tan_half), enc_err)
    angle_nw = nm.acos_approx(v3.dot(n3, vmb_n3))
    normal_weight = nm.smoothstep01(
        1.0 - (angle_nw - curvature_angle - enc_err) / lobe_half_angle)
    normal_weight = nm.lerp(nm.smoothstep(1.0, 0.0, vmb_pixels_traveled), 1.0, normal_weight)
    virtual_normal_confidence = torch.minimum(virtual_normal_confidence, normal_weight)
    virtual_history_amount = nm.smoothstep(0.05, 0.95, dfactor)
    virtual_history_amount = virtual_history_amount * virtual_normal_confidence

    # parallax confidence (lines 561-577)
    hdt_prev = vmb["hdt_prev"]
    x_virtual_prev3 = get_xvirtual3(hdt_prev, curvature, x3, xp3, n3, vv3, roughness)
    vpu, vpv = v3.get_screen_uv(sc["world_to_clip_prev"], x_virtual_prev3)
    vpu = torch.where(is_camera_attached, smb_u, vpu)
    vpv = torch.where(is_camera_attached, smb_v, vpv)
    pixel_size_at_xvirtual = nm.pixel_radius_to_world(float(sc["unproject"]), ortho, 1.0,
                                                      x_virtual_length)
    r_conf = (lobe_tan_half + curvature_angle) * torch.minimum(
        hit_dist_for_tracking, hdt_prev) / torch.clamp_min(pixel_size_at_xvirtual, 1e-15)
    dcx = (vpu - vmb_u) * rw_
    dcy = (vpv - vmb_v) * rh_
    d_conf = torch.sqrt(dcx * dcx + dcy * dcy)
    r_conf = torch.clamp_min(r_conf, 0.1)
    virtual_parallax_confidence = nm.linearstep(r_conf, 0.0, d_conf)

    # prev-prev taps (lines 579-608)
    ra2, rb2 = nm.get_relaxed_roughness_weight_params(
        vmb_roughness * vmb_roughness, float(dc["roughness_fraction"]),
        C.REBLUR_ROUGHNESS_SENSITIVITY_IN_TA)
    for it in range(1, iters + 1):
        n_pp, r_pp, _ = taps[it]
        angle_pp = nm.acos_approx(v3.dot(vmb_n3, v3.V3.of(n_pp)))
        wx = nm.smoothstep01(
            1.0 - (angle_pp - curvature_angle * (1.0 + it * step_between_taps) - enc_err)
            / lobe_half_angle)
        wy = nm.compute_non_exponential_weight_with_sigma(r_pp * r_pp, ra2, rb2,
                                                          roughness_sigma)
        if not decoded:  # R10G10B10A2 only (`kernels.py:1383-1385`)
            wx = nm.lerp(1.0, wx, nm.saturate(step_between_taps))
            wy = nm.lerp(1.0, wy, nm.saturate(step_between_taps))
        wx = torch.where(pp_inscreen[it - 1], wx, 1.0)
        wy = torch.where(pp_inscreen[it - 1], wy, 1.0)
        virtual_normal_confidence = torch.minimum(virtual_normal_confidence, wx)
        virtual_roughness_confidence = torch.minimum(virtual_roughness_confidence, wy)

    virtual_confidence_for_smb = virtual_normal_confidence * virtual_roughness_confidence
    virtual_confidence = virtual_confidence_for_smb * virtual_parallax_confidence
    virtual_history_amount = virtual_history_amount * virtual_roughness_confidence

    # surface history confidence (lines 617-654)
    smb_history = sm["spec_history"]
    a_par = torch.atan(sm["parallax_max"] * sm["pixel_size"]
                       / torch.clamp_min(v3.length(x3), 1e-9))
    nlas_smb = 1.0 / (1.0 + smb_accum)
    h_conf = nm.lerp(C.extract_hit_dist(smb_history), C.extract_hit_dist(spec),
                     nlas_smb) * hit_dist_normalization
    tana0 = nm.get_specular_lobe_tan_half_angle(roughness_modified,
                                                nm.NRD_MAX_PERCENT_OF_LOBE_VOLUME)
    tana0 = tana0 * nm.lerp(nov, 1.0, roughness_modified)
    tana0 = tana0 * nlas_smb
    tana0 = tana0 / (nm.get_hit_dist_factor(h_conf, sm["frustum_size"]) + NRD_EPS)
    a0 = torch.clamp_min(torch.atan(tana0), enc_err)
    surface_history_confidence = torch.pow(nm.saturate(nm.linearstep(a0, 0.0, a_par)), 4.0)

    # responsive accumulation (lines 656-702)
    responsive_factor = C.remap_roughness_to_responsive_factor(dc, roughness)
    smc = nm.get_spec_magic_curve(roughness_modified)
    fx = v3.dot(n3, v3.normalize(smb_navg3))
    fy = v3.dot(n3, vmb_n3)
    power = nm.lerp(32.0, 1.0, smc) * (1.0 - responsive_factor)
    fx = nm.lerp(smc, 1.0, responsive_factor) * nm.pow01(fx, power)
    fy = nm.lerp(smc, 1.0, responsive_factor) * nm.pow01(fy, power)
    smb_max_frame_num = torch.minimum(mafn * surface_history_confidence,
                                      torch.clamp_min(mafn * fx, hffn))
    smb_boosted_max = torch.maximum(smb_max_frame_num, hffn * (1.0 - virtual_confidence_for_smb))
    smb_accum_boosted = torch.minimum(smb_accum, smb_boosted_max)
    vmb_max_frame_num = torch.minimum(mafn * virtual_confidence, torch.clamp_min(mafn * fy, hffn))
    smb_accum = torch.minimum(smb_accum, smb_max_frame_num)
    vmb_accum = torch.minimum(vmb_accum, vmb_max_frame_num)
    magic = torch.where(vmb_accum > smb_accum, 8.0, 0.5)
    virtual_history_amount = virtual_history_amount * (
        1.0 + (vmb_accum - smb_accum) / (magic * torch.maximum(vmb_accum, smb_accum) + 1.0))
    virtual_history_amount = nm.saturate(virtual_history_amount)

    # virtual history + accumulation (lines 708-754)
    smb_history = C.clamp_negative_to_zero(smb_history, occlusion)
    vmb_history = C.clamp_negative_to_zero(vmb["history"], occlusion)
    smb_nlas = 1.0 / (1.0 + smb_accum)
    vmb_nlas = 1.0 / (1.0 + vmb_accum)
    if has_data is not None:  # checkerboard: slower on the pixels without data (:1469-1474)
        smb_nlas = torch.where(has_data, smb_nlas, smb_nlas * C.no_data_scale(sc, smb_nlas))
        vmb_nlas = torch.where(has_data, vmb_nlas, vmb_nlas * C.no_data_scale(sc, vmb_nlas))
    smb_spec = C.mix_history_and_current(dc, smb_history, spec, smb_nlas, roughness_modified,
                                         occlusion)
    vmb_spec = C.mix_history_and_current(dc, vmb_history, spec, vmb_nlas, roughness_modified,
                                         occlusion)
    vha4 = virtual_history_amount[..., None]
    spec_result = nm.lerp(smb_spec, vmb_spec, vha4)
    spec_accum_speed = nm.lerp(smb_accum_boosted, vmb_accum, virtual_history_amount)
    history_mixed = nm.lerp(smb_history, vmb_history, vha4)
    sh_result = None
    if sh_input is not None:
        smb_sh = nm.lerp(sm["spec_sh"], sh_input, smb_nlas[..., None])
        vmb_sh = nm.lerp(vmb["sh"], sh_input, vmb_nlas[..., None])
        sh_result = nm.lerp(smb_sh, vmb_sh, vha4)
        sh_result = torch.cat([sh_result[..., :3], roughness_modified[..., None]], -1)

    # firefly suppressor (lines 756-771), not for occlusion
    if not occlusion:
        max_rel = (float(dc["firefly_suppressor_min_relative_scale"])
                   + C.REBLUR_FIREFLY_SUPPRESSOR_MAX_RELATIVE_INTENSITY
                   / (spec_accum_speed + 1.0))
        antifirefly = spec_accum_speed * float(dc["max_blur_radius"]) \
            * C.REBLUR_FIREFLY_SUPPRESSOR_RADIUS_SCALE
        antifirefly = antifirefly / (1.0 + antifirefly)
        luma = C.get_luma(spec_result)
        luma_clamped = torch.minimum(luma, C.get_luma(history_mixed) * max_rel)
        luma_clamped = nm.lerp(luma, luma_clamped, antifirefly)
        spec_result = C.change_luma(spec_result, luma_clamped)
        if sh_result is not None:
            sh_result = C.sh_luma_scale(sh_result, luma_clamped)

    # fast history (lines 779-794)
    mfafn = float(dc["max_fast_accumulated_frame_num"])
    smb_fast_nlas = C.get_non_linear_accum_speed(sc, smb_accum, mfafn,
                                                 surface_history_confidence, has_data)
    vmb_fast_nlas = C.get_non_linear_accum_speed(sc, vmb_accum, mfafn, virtual_confidence,
                                                 has_data)
    smb_fast = nm.lerp(sm["spec_fast"], C.get_luma(spec, occlusion), smb_fast_nlas)
    vmb_fast = nm.lerp(vmb["fast"], C.get_luma(spec, occlusion), vmb_fast_nlas)
    fast_result = nm.lerp(smb_fast, vmb_fast, virtual_history_amount)
    if not occlusion:
        fast_clamped = torch.minimum(fast_result, C.get_luma(history_mixed) * max_rel
                                     * C.REBLUR_FIREFLY_SUPPRESSOR_FAST_RELATIVE_INTENSITY)
        fast_result = nm.lerp(fast_result, fast_clamped, antifirefly)
    out = dict(spec=spec_result, fast=fast_result, accum_speed=spec_accum_speed,
               fbits_vmb=vmb["fbits_vmb"], curvature=curvature,
               virtual_history_amount=virtual_history_amount,
               hit_dist_for_tracking=hit_dist_for_tracking,
               # the probe's and SHOW's confidences (REBLUR_Config.hlsli:43-48,
               # `nrdtpu/passes/reblur/kernels.py:1544-1548`)
               surface_history_confidence=surface_history_confidence,
               virtual_history_confidence=virtual_confidence,
               virtual_normal_confidence=virtual_normal_confidence,
               virtual_roughness_confidence=virtual_roughness_confidence,
               virtual_parallax_confidence=virtual_parallax_confidence)
    if sh_result is not None:
        out["sh"] = sh_result
    return out


# ---------------------------------------------------------------------------
# Filter geometry shared by the spatial filters and HistoryFix
# ---------------------------------------------------------------------------


def make_filter_geometry(sc, dc, view_z_in, normal_roughness, config, signals=("diff", "spec"),
                         row0=0, frame_h=None):
    """`params.filter_geometry` for the config's normal encoding (at the RGBA formats on the
    decoded plane). It depends only on the G-buffer, so REBLUR_DIFFUSE_SPECULAR computes it once
    a frame."""
    return filter_geometry(sc, dc, view_z_in, normal_roughness, _enc_err(config), signals,
                           decoded=_decoded(config), row0=row0, frame_h=frame_h)


def _enc_err(config):
    """The normal encoding's error (NRD_NORMAL_ENCODING_ERROR), a host constant."""
    return nm.normal_encoding_error(int(config.normal_encoding))


def _shared_planes(geom, key, planes):
    """Stack the geometry planes a kernel shares between signals once per geometry."""
    if key not in geom:
        geom[key] = torch.stack(planes(geom))
    return geom[key]


# ---------------------------------------------------------------------------
# HistoryFix (REBLUR_HistoryFix.hlsli)
# ---------------------------------------------------------------------------


def _hfix_shared(geom):
    return _shared_planes(geom, "hfix_shared", lambda g: [
        g["ga"], g["gb"], g["frustum_size"], g["n3"].x, g["n3"].y, g["n3"].z,
        g["nv3"].x, g["nv3"].y, g["nv3"].z])


def _hfix_params(dc, geom, signal, data1, is_diffuse):
    """The signal's planes of the stride taps (`history_fix`, `kernels.py:544-571`; the fused
    `_fused_hfix_params`, `:2003-2031`), in the order of `kernels.history_fix.PARAMS` (+
    SPEC_PARAMS)."""
    roughness = geom["roughness"]
    frame_num = data1
    stride = float(dc["history_fix_base_pixel_stride"]) / (2.0 + frame_num)
    stride = stride * (frame_num < float(dc["history_fix_frame_num"])).to(torch.float32)
    if not is_diffuse:
        stride = stride * nm.lerp(0.5, 1.0, geom["smc"])
    stride = torch.floor(stride)
    nlas = 1.0 / (1.0 + frame_num)
    # the signal's roughness for specular, 1 for diffuse
    rough = torch.ones_like(roughness) if is_diffuse else roughness
    normal_weight_param = nm.get_normal_weight_param(nlas, float(dc["lobe_angle_fraction"]), rough,
                                                     geom["enc_err"])
    hit_dist_scale = geom["hd_scale_diff" if is_diffuse else "hd_scale_spec"]
    hit_dist = C.extract_hit_dist(signal) * hit_dist_scale
    hit_dist_factor = nm.get_hit_dist_factor(hit_dist, geom["frustum_size"])
    ha, hb = nm.get_hit_distance_weight_params(hit_dist_factor, nlas, rough)
    planes = [stride, normal_weight_param, ha, hb, hit_dist_scale]
    if not is_diffuse:
        # roughness weight and low-roughness hitT guide (lines 349-352)
        ra, rb = nm.get_relaxed_roughness_weight_params(
            roughness * roughness, float(np.sqrt(np.float32(dc["roughness_fraction"]))))
        planes += [ra, rb, hit_dist, nm.linearstep(0.03, 0.05, roughness)]
    return torch.stack(planes)


def _taps_nr(normal_roughness, tap_normal_roughness):
    """The plane a filter's taps read: the decoded copy where the denoiser made one."""
    return normal_roughness if tap_normal_roughness is None else tap_normal_roughness


def _hfix_consts(sc):
    return dict(frustum=_v(sc["frustum"]), rect_size_inv=_v(sc["rect_size_inv"]),
                view_z_scale=float(sc["view_z_scale"]), ortho_mode=float(sc["ortho_mode"]))


def history_fix(sc, dc, view_z_in, normal_roughness, data1, signal, fast_history, config, *,
                is_diffuse: bool = True, anti_firefly: bool = False, sh=None,
                directional: bool = False, tap_normal_roughness=None, row0=0, frame_h=None):
    """Sparse 5x5-no-corners history reconstruction + fast-history color clamping, with the
    9x9 anti-firefly clamp when `anti_firefly`, in one `history_fix` launch.

    data1: accumulated frames of the signal (data1_diff or data1_spec); signal: (h, w, 4)
    output of TA; fast_history: (h, w). Returns (signal_out, fast_out, tap_geometry): the last
    is the frame's tap geometry (h, w, 4) that the launch writes, for the Blur and PostBlur of
    `diffuse_spatial_filter` / `specular_spatial_filter`; with the SH variants' `sh` (the
    signal's SH1) the SH after the history fix comes fourth. directional: the clamp of
    REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (diffuse). tap_normal_roughness: the plane the taps
    read, the decoded copy at a non-linear roughness encoding (the centre's geometry is built
    from `normal_roughness` as packed); None: `normal_roughness`. row0, frame_h: the planes'
    rows in the frame (a band of `parallel.shard_stencil`)."""
    geom = make_filter_geometry(sc, dc, view_z_in, normal_roughness, config,
                                ("diff",) if is_diffuse else ("spec",), row0, frame_h)
    min_material = dc["diff_min_material"] if is_diffuse else dc["spec_min_material"]
    res = k_history_fix.history_fix(
        signal, view_z_in, _taps_nr(normal_roughness, tap_normal_roughness), data1,
        fast_history, _hfix_shared(geom), _hfix_params(dc, geom, signal, data1, is_diffuse),
        None if is_diffuse else geom["smc"], min_material=float(min_material), dc=dc,
        anti_firefly=anti_firefly, sh=sh, directional=directional, decoded=_decoded(config),
        row0=row0, frame_h=frame_h, **_hfix_consts(sc))
    if sh is not None:
        return res["signal"], res["fast"], res["geometry"], res["sh"]
    return res["signal"], res["fast"], res["geometry"]


def fused_history_fix(sc, dc, geom, view_z_in, normal_roughness, diff, spec, *,
                      anti_firefly=(False, False), sh=None, tap_normal_roughness=None):
    """HistoryFix of both signals, the clamp included, in one `history_fix_fused` launch
    (`kernels.py:2035-2071`), computing what `history_fix` computes per signal. diff, spec:
    (signal, data1, fast_history); anti_firefly: the (diffuse, specular) flags. Returns
    ((diff_out, diff_fast), (spec_out, spec_fast), tap_geometry): the last is the frame's tap
    geometry (h, w, 4) that the launch writes, for the Blur and PostBlur of
    `fused_spatial_filter`; with the SH variants' `sh` (the diffuse and specular SH1) the pair
    of SH after the history fix comes fourth; tap_normal_roughness as for history_fix (`geom`
    from the packed plane)."""
    res = k_history_fix_fused.history_fix_fused(
        diff[0], spec[0], view_z_in, _taps_nr(normal_roughness, tap_normal_roughness), diff[1],
        spec[1], diff[2], spec[2],
        _hfix_shared(geom), _hfix_params(dc, geom, diff[0], diff[1], True),
        _hfix_params(dc, geom, spec[0], spec[1], False), geom["smc"],
        diff_min_material=float(dc["diff_min_material"]),
        spec_min_material=float(dc["spec_min_material"]), dc=dc, anti_firefly=anti_firefly,
        sh=sh, decoded=geom["decoded"], **_hfix_consts(sc))
    out = (res["diff"], res["diff_fast"]), (res["spec"], res["spec_fast"]), res["geometry"]
    return out if sh is None else out + ((res["diff_sh"], res["spec_sh"]),)


# ---------------------------------------------------------------------------
# Spatial filters (REBLUR_Blur.hlsli, REBLUR_PrePass.hlsli,
# REBLUR_Common_DiffuseSpatialFilter.hlsli, REBLUR_Common_SpecularSpatialFilter.hlsli)
# ---------------------------------------------------------------------------


def _sf_shared(geom):
    return _shared_planes(geom, "sf_shared", lambda g: [
        g["ga"], g["gb"], g["n3"].x, g["n3"].y, g["n3"].z, g["nv3"].x, g["nv3"].y, g["nv3"].z])


def _sf_consts(sc):
    return dict(frustum=_v(sc["frustum"]), rect_size=_v(sc["rect_size"]),
                view_z_scale=float(sc["view_z_scale"]), ortho_mode=float(sc["ortho_mode"]))


def _prepass_off_hit_dist(spec):
    """hitDistForTracking of a specular PrePass with radius 0 (`kernels.py:1776-1778`)."""
    hit = C.extract_hit_dist(spec)
    return torch.where(hit == 0.0, 0.0, hit)


def diffuse_spatial_filter(sc, dc, mode, signal, view_z_in, normal_roughness, data1, config,
                           *, perf_mode: bool = False, tap_geometry=None, sh=None, row0=0,
                           frame_h=None):
    """Adaptive-radius 8-tap Poisson blur, screen-space sampling: one `spatial_filter` launch
    that computes the geometry and the parameters itself. mode: PRE_BLUR (see
    diffuse_pre_pass), BLUR or POST_BLUR; tap_geometry: the plane that `history_fix` returns,
    which Blur and PostBlur require; sh: with the SH variants the signal's SH1, then
    (signal, sh) is returned; row0, frame_h: the planes' rows in the frame."""
    return k_spatial_filter.spatial_filter(
        signal, view_z_in, normal_roughness, None if mode == PRE_BLUR else data1, sc=sc, dc=dc,
        mode=mode, spec=False, enc_err=_enc_err(config), perf_mode=perf_mode,
        geometry=tap_geometry, sh=sh, decoded=_decoded(config), row0=row0, frame_h=frame_h)


def diffuse_pre_pass(sc, dc, signal, view_z_in, normal_roughness, config, *,
                     perf_mode: bool = False, cb=None, sh=None, row0=0, frame_h=None):
    """Diffuse PrePass: the spatial filter with pre-pass constants and no skew. cb: under
    checkerboard the mode's has-data parity (the signal expanded from half width), else None.
    A PrePass whose radius is 0 passes the signal through, but not under checkerboard, whose
    PrePass runs at any radius (`kernels.py:2145-2150`). sh, row0, frame_h: as for
    diffuse_spatial_filter."""
    if cb is None and float(dc["diff_prepass_blur_radius"]) == 0.0:
        return signal if sh is None else (signal, sh)
    return k_spatial_filter.spatial_filter(
        signal, view_z_in, normal_roughness, None, sc=sc, dc=dc, mode=PRE_BLUR, spec=False,
        enc_err=_enc_err(config), perf_mode=perf_mode, geometry=None, cb=cb, sh=sh,
        decoded=_decoded(config), row0=row0, frame_h=frame_h)


def specular_spatial_filter(sc, dc, mode, spec, view_z_in, normal_roughness, data1, config, *,
                            perf_mode: bool = False, tap_geometry=None, cb=None, sh=None):
    """Adaptive Poisson specular blur (REBLUR_Common_SpecularSpatialFilter.hlsli), one
    `spatial_filter` launch. mode: PRE_BLUR, BLUR or POST_BLUR; normal_roughness as packed,
    with `config.roughness_encoding` (the kernel decodes its taps' roughness, the reference's
    centre reads it as packed); tap_geometry as for diffuse_spatial_filter; cb as for
    diffuse_pre_pass (the PrePass only; under checkerboard
    the PrePass runs at any radius and its hitDistForTracking comes from the kernel,
    `kernels.py:1688-1694`). Returns (spec_out, hit_dist_for_tracking); the second is the
    PrePass's stochastic hitDist minimum, None in the other modes; with the SH variants' `sh`
    (the signal's SH1) the filtered SH comes third."""
    prepass = mode == PRE_BLUR
    if prepass and cb is None and float(dc["spec_prepass_blur_radius"]) == 0.0:
        out = spec, _prepass_off_hit_dist(spec)
        return out if sh is None else out + (sh,)
    res = k_spatial_filter.spatial_filter(
        spec, view_z_in, normal_roughness, None if prepass else data1, sc=sc, dc=dc, mode=mode,
        spec=True, enc_err=_enc_err(config), perf_mode=perf_mode, geometry=tap_geometry, cb=cb,
        sh=sh, roughness_encoding=config.roughness_encoding, decoded=_decoded(config))
    if sh is not None:
        return res if prepass else (res[0], None, res[1])
    return res if prepass else (res, None)


def fused_spatial_filter(sc, dc, mode, geom, view_z_in, normal_roughness, diff, spec, *,
                         data1_diff=None, data1_spec=None, tap_geometry=None,
                         perf_mode: bool = False, cb=None, sh=None, tap_normal_roughness=None):
    """PrePass, Blur or PostBlur of both signals in one `spatial_filter_fused` launch
    (`kernels.py:1916-2000`), computing what diffuse_pre_pass / diffuse_spatial_filter and
    specular_spatial_filter compute per signal, each at its own tap positions. Blur and
    PostBlur take `tap_geometry`, the frame's tap geometry that `fused_history_fix` returns. A
    PrePass whose radius is 0 passes its signal through (and, for specular, its hit distance),
    but not under checkerboard (cb: the PrePass's has-data parity, as for diffuse_pre_pass),
    whose parameters read the centre signals zeroed where they have no data
    (`_fused_diff_params` / `_fused_spec_params`, `kernels.py:1819-1862`).
    tap_normal_roughness as for history_fix (`geom` from the packed plane).
    Returns (diff_out, spec_out, hit_dist_for_tracking or None), and with the SH variants' `sh`
    (the diffuse and specular SH1) the pair of filtered SH fourth."""
    prepass = mode == PRE_BLUR
    centre = dict(diff=diff, spec=spec)
    kcb = None
    if cb is not None:
        h, w = view_z_in.shape
        mask = k_spatial_filter.cb_mask(h, w, sc["frame_index"], cb, view_z_in.device)
        centre = {name: sig * mask[..., None] for name, sig in centre.items()}
        kcb = dict(parity=cb, denoising_range=float(sc["denoising_range"]),
                   min_rect_dim_mul_unproject=float(sc["min_rect_dim_mul_unproject"]))
    occ = diff.shape[-1] == 1  # the occlusion variants' rule of the min hit-distance weight
    res = k_spatial_filter_fused.spatial_filter_fused(
        diff, spec, view_z_in, _taps_nr(normal_roughness, tap_normal_roughness),
        _sf_shared(geom),
        diff_spatial_params(sc, dc, mode, geom, centre["diff"], data1_diff, occlusion=occ),
        spec_spatial_params(sc, dc, mode, geom, centre["spec"], data1_spec, occlusion=occ),
        diff_min_material=float(dc["diff_min_material"]),
        spec_min_material=float(dc["spec_min_material"]), perf_mode=perf_mode,
        prepass=k_spatial_filter.prepass_inputs(sc, dc) if prepass else None,
        geometry=tap_geometry, cb=kcb, sh=sh, decoded=geom["decoded"], **_sf_consts(sc))
    diff_out, spec_out, hdt = res["diff"], res["spec"], res.get("hdt")
    sh_out = None if sh is None else [res["diff_sh"], res["spec_sh"]]
    if prepass and cb is None and float(dc["diff_prepass_blur_radius"]) == 0.0:
        diff_out = diff
        if sh is not None:
            sh_out[0] = sh[0]
    if prepass and cb is None and float(dc["spec_prepass_blur_radius"]) == 0.0:
        spec_out, hdt = spec, _prepass_off_hit_dist(spec)
        if sh is not None:
            sh_out[1] = sh[1]
    if sh is not None:
        return diff_out, spec_out, hdt, tuple(sh_out)
    return diff_out, spec_out, hdt


def spatial_chain(sc, dc, geom, view_z_in, normal_roughness, diff, spec, *, anti_firefly,
                  perf_mode, sh=None, tap_normal_roughness=None):
    """HistoryFix, Blur and PostBlur of both signals as three launches with the glue between
    them (`fused_history_fix`, then `fused_spatial_filter` in BLUR and POST_BLUR mode). diff,
    spec: (TA output, data1, fast history); anti_firefly: the (diffuse, specular) flags; sh:
    with the SH variants the (diffuse, specular) SH1 after TA; tap_normal_roughness as for
    history_fix.
    Returns ((diff4, diff_fast2), (spec4, spec_fast2)[, (diff_sh4, spec_sh4)])."""
    res = fused_history_fix(sc, dc, geom, view_z_in, normal_roughness, diff, spec,
                            anti_firefly=anti_firefly, sh=sh,
                            tap_normal_roughness=tap_normal_roughness)
    (d2, d_fast), (s2, s_fast), tap_geometry = res[:3]
    kw = dict(data1_diff=diff[1], data1_spec=spec[1], tap_geometry=tap_geometry,
              perf_mode=perf_mode, tap_normal_roughness=tap_normal_roughness)
    res = fused_spatial_filter(sc, dc, BLUR, geom, view_z_in, normal_roughness, d2, s2,
                               sh=None if sh is None else res[3], **kw)
    d3, s3 = res[:2]
    res = fused_spatial_filter(sc, dc, POST_BLUR, geom, view_z_in, normal_roughness, d3, s3,
                               sh=None if sh is None else res[3], **kw)
    out = (res[0], d_fast), (res[1], s_fast)
    return out if sh is None else out + (res[3],)


def _band_planes(geom):
    return _shared_planes(geom, "band_planes", lambda g: list(_hfix_shared(g)) + [
        g["nov"], g["roughness"], g["smc"], g["hd_scale_diff"], g["hd_scale_spec"]])


def spatial_band(sc, dc, geom, view_z_in, normal_roughness, diff, spec, *, anti_firefly,
                 perf_mode, sh=None, tap_normal_roughness=None):
    """What `spatial_chain` computes, in one `reblur_band` launch: the history fix, its clamp
    and both spatial stages with their parameters computed in the kernel (the band pipeline,
    `nrdtpu/passes/reblur/denoiser.py:403-428`). Only the history fix's parameter planes are
    computed here, from the TA outputs. Same arguments and result as `spatial_chain`."""
    res = k_reblur_band.reblur_band(
        diff[0], spec[0], view_z_in, _taps_nr(normal_roughness, tap_normal_roughness), diff[1],
        spec[1], diff[2], spec[2],
        _band_planes(geom), _hfix_params(dc, geom, diff[0], diff[1], True),
        _hfix_params(dc, geom, spec[0], spec[1], False),
        rect_size=_v(sc["rect_size"]), diff_min_material=float(dc["diff_min_material"]),
        spec_min_material=float(dc["spec_min_material"]), rotator=sc["rotator"],
        rotator_post=sc["rotator_post"], enc_err=geom["enc_err"], dc=dc, perf_mode=perf_mode,
        anti_firefly=anti_firefly, sh=sh, decoded=geom["decoded"], **_hfix_consts(sc))
    out = (res["diff"], res["diff_fast"]), (res["spec"], res["spec_fast"])
    return out if sh is None else out + ((res["diff_sh"], res["spec_sh"]),)


# ---------------------------------------------------------------------------
# Hit distance reconstruction (REBLUR_HitDistReconstruction.hlsli)
# ---------------------------------------------------------------------------


def hit_dist_reconstruction(sc, dc, view_z_in, normal_roughness, diff, spec, config, *,
                            radius: int):
    """Refill hitT == 0 holes from the 3x3 (radius 1) or 5x5 (radius 2) neighbourhood
    (`kernels.py:2212-2293`) in one `hitdist_recon` launch, which computes the centre's
    parameters itself. diff / spec: (h, w, 4) signals, (h, w, 1) with the occlusion variants,
    or None; only the hit-distance channel changes. normal_roughness: the plane of
    `frontend.decode_normal_plane` for the config's normal encoding (RELAX's and REBLUR's calls
    at the RGBA formats read it decoded, REBLUR's with its roughness decoded too, at LINEAR).
    Returns (diff_out, spec_out)."""
    out = k_hitdist_recon.hitdist_recon(
        view_z_in, normal_roughness, diff, spec, radius=radius,
        view_z_scale=float(sc["view_z_scale"]), frustum=sc["frustum"],
        ortho_mode=float(sc["ortho_mode"]), rect_size_inv=sc["rect_size_inv"],
        world_to_view=sc["world_to_view"],
        min_rect_dim_mul_unproject=float(sc["min_rect_dim_mul_unproject"]),
        plane_dist_sensitivity=float(dc["plane_dist_sensitivity"]), enc_err=_enc_err(config),
        roughness_encoding=config.roughness_encoding,
        decoded=_decoded(config))
    return out.get("diff"), out.get("spec")


# ---------------------------------------------------------------------------
# Checkerboard resolve of the occlusion variants (REBLUR_TemporalAccumulation.hlsli:309-320)
# ---------------------------------------------------------------------------


def cb_resolve(sc, view_z_in, normal_roughness, signals, has_data, decoded=False):
    """The occlusion variants under checkerboard (`nrdtpu/passes/reblur/denoiser.py:278-298`):
    they run no PrePass, so each expanded signal takes on the pixels without data the
    horizontal neighbour resolve (`kernels.py:743-762`, the plain helper
    `kernels.spatial_filter.cb_neighbor_resolve`), from the centre's scaled viewZ, frustum size
    and nov. Torch glue, as in JAX. signals: {name: (h, w, c)}; has_data: the (h, w) bool plane
    of the pixels with data; normal_roughness: packed R10G10B10A2, or with `decoded` the RGBA
    formats' decoded plane. Returns the signals resolved."""
    h, w = view_z_in.shape
    ortho = float(sc["ortho_mode"])
    view_z = unpack_view_z(sc, view_z_in)
    frustum_size = nm.get_frustum_size(float(sc["min_rect_dim_mul_unproject"]), ortho, view_z)
    n, _, _ = fe.unpack_normal_plane(normal_roughness, decoded)
    uv = resample.pixel_uv_grid(h, w, view_z_in.device)
    xv = nm.reconstruct_view_position(uv, sc["frustum"], view_z, ortho)
    nv = nm.rotate_vector(sc["world_to_view"], n)
    if ortho == 0.0:
        vv = nm.normalize(-xv)
    else:
        vv = torch.tensor([0.0, 0.0, -1.0], device=view_z_in.device).expand_as(xv)
    nov = torch.abs(nm.dot(nv, vv))
    return {name: torch.where(has_data[..., None], sig, k_spatial_filter.cb_neighbor_resolve(
        sig, view_z, frustum_size, nov, float(sc["denoising_range"])))
        for name, sig in signals.items()}


# ---------------------------------------------------------------------------
# SplitScreen (REBLUR_SplitScreen.hlsli)
# ---------------------------------------------------------------------------


def split_screen(sc, noisy_input, view_z_in, out_signal):
    h, w = view_z_in.shape
    view_z = unpack_view_z(sc, view_z_in)
    u = nm.div(torch.arange(w, dtype=torch.float32, device=view_z_in.device) + 0.5, w)
    noisy = noisy_input * (view_z < float(sc["denoising_range"])).to(torch.float32)[..., None]
    show_input = u[None, :, None] <= float(sc["split_screen"])
    return torch.where(show_input, noisy, out_signal)


# ---------------------------------------------------------------------------
# TemporalStabilization (REBLUR_TemporalStabilization.hlsli) - diffuse
# ---------------------------------------------------------------------------


def ts_surface_motion(sc, view_z_in, mv_in, row0=0, frame_h=None):
    """TS lines 50-70: the surface-motion position, shared by both halves of TS; row0,
    frame_h: the planes' rows in the frame. Returns (uv, view_z, x, x_prev, smb_pixel_uv)."""
    h, w = view_z_in.shape
    uv = resample.pixel_uv_grid(h, w, view_z_in.device, row0, frame_h)
    view_z = unpack_view_z(sc, view_z_in)
    xv = nm.reconstruct_view_position(uv, sc["frustum"], view_z, sc["ortho_mode"])
    x = nm.rotate_vector(sc["view_to_world"], xv)
    x_prev, smb_pixel_uv = surface_motion_position(sc, uv, view_z, x, mv_in)
    return uv, view_z, x, x_prev, smb_pixel_uv


def _ts_consts(sc, dc):
    """The host constants of a TS half (`ts_prelude`)."""
    return dict(rect_size_prev=_v(sc["rect_size_prev"]),
                max_blur_radius=float(dc["max_blur_radius"]),
                split_screen=float(sc["split_screen"]),
                split_screen_prev=float(sc["split_screen_prev"]),
                antilag_params=_v(dc["antilag_params"]),
                framerate_scale=float(sc["framerate_scale"]),
                stabilization_strength=float(dc["stabilization_strength"]),
                history_fix_frame_num=float(dc["history_fix_frame_num"]))


def temporal_stabilization(sc, dc, view_z_in, normal_roughness, mv_in, data1_diff, fbits, diff,
                           diff_luma_stab_history, config, *, surface_motion=None, sh=None,
                           directional=False):
    """Anti-lag output filter, diffuse half: one `ts_prelude` launch. surface_motion:
    ts_surface_motion(...) when the specular half shares it; sh: with the SH variants the
    PostBlur SH1, scaled to the stabilized luma (`kernels.py:2407-2410`); directional:
    REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION, the luma .w and the directional luma change
    (`:2400-2404`). Returns dict(diff, diff_luma_stab, data1_diff, mv_out[, diff_sh])."""
    smb_pixel_uv = (surface_motion or ts_surface_motion(sc, view_z_in, mv_in))[4]
    ts = k_ts_prelude.ts_prelude(diff, diff_luma_stab_history, smb_pixel_uv, fbits, data1_diff,
                                 directional=directional, **_ts_consts(sc, dc))
    out = dict(diff=ts["signal"], diff_luma_stab=ts["luma_stab"], data1_diff=ts["data1"],
               mv_out=mv_in)
    if sh is not None:
        out["diff_sh"] = C.sh_luma_scale(sh, ts["luma_stab"])
    return out


def temporal_stabilization_specular(sc, dc, view_z_in, normal_roughness, mv_in, data1_spec,
                                    fbits, curvature, virtual_history_amount, spec,
                                    spec_luma_stab_history, spec_hitdist_for_tracking,
                                    base_color_metalness, config, *, has_prepass,
                                    surface_motion=None, sh=None):
    """Anti-lag output filter, specular half (TS lines 233-343): the surface- and
    virtual-motion histories (fbits bits 0-3 and 4-7) combined by the virtual history
    amount, and the MV patching under IN_BASECOLOR_METALNESS (lines 250-285).
    surface_motion: ts_surface_motion(...) when the diffuse half shares it; sh: as for
    temporal_stabilization (`kernels.py:2540-2543`).
    Returns dict(spec, spec_luma_stab, data1_spec, mv_out[, spec_sh])."""
    uv, view_z, x, x_prev, smb_pixel_uv = (surface_motion
                                            or ts_surface_motion(sc, view_z_in, mv_in))
    n, roughness, material_id = unpack_nr(normal_roughness, config)

    # hit dist for tracking (lines 233-240)
    hdt = C.extract_hit_dist(spec) * fe.get_hit_distance_normalization(
        view_z, dc["hit_dist_params"], roughness)
    if (has_prepass and spec_hitdist_for_tracking is not None
            and float(dc["spec_prepass_blur_radius"]) != 0.0):
        hdt = torch.minimum(hdt, spec_hitdist_for_tracking)
    v = C.get_view_vector(sc, x)
    nov = torch.abs(nm.dot(n, v))
    x_virtual = get_xvirtual(hdt, curvature, x, x_prev, n, v, roughness)
    vmb_pixel_uv = nm.get_screen_uv(sc["world_to_clip_prev"], x_virtual)
    is_cam_attached = material_id == float(sc["camera_attached_reflection_material_id"])
    vmb_pixel_uv = torch.where(is_cam_attached[..., None], uv, vmb_pixel_uv)

    mv_out = mv_in
    if base_color_metalness is not None:
        # MV patching (lines 250-285)
        base_color = base_color_metalness[..., :3]
        metalness = base_color_metalness[..., 3]
        albedo = base_color * (1.0 - metalness[..., None])
        rf0 = nm.lerp(torch.full_like(base_color, 0.04), base_color, metalness[..., None])
        fenv = fe.environment_term_rtg(rf0, nov, roughness)
        lum_spec = nm.luminance(fenv)
        lum_diff = nm.luminance(albedo * (1.0 - fenv))
        spec_prob = lum_spec / (lum_diff + lum_spec + NRD_EPS)
        th = np.asarray(dc["spec_probability_thresholds"], np.float32)
        f = nm.saturate((spec_prob - float(th[0])) / float(th[1] - th[0]))
        f = f * f * (3.0 - 2.0 * f)
        f = f * (1.0 - nm.get_spec_magic_curve(roughness))
        f = f * (1.0 - torch.sqrt(nm.saturate(torch.abs(curvature))))
        spec_mv_z = nm.affine_transform(sc["world_to_view_prev"], x_virtual)[..., 2] - view_z
        mvs = _v(sc["mv_scale"])
        new_mv = [nm.div(vmb_pixel_uv[..., 0] - uv[..., 0], mvs[0]),
                  nm.div(vmb_pixel_uv[..., 1] - uv[..., 1], mvs[1]),
                  mv_in[..., 2] if mvs[2] == 0.0 else nm.div(spec_mv_z, mvs[2])]
        mv_out3 = nm.lerp(mv_in[..., :3], torch.stack(new_mv, -1), f[..., None])
        mv_out = mv_out3 if mv_in.shape[-1] == 3 else torch.cat([mv_out3, mv_in[..., 3:]], -1)

    # combine surface & virtual motion (lines 287-343): one `ts_prelude` launch
    ts = k_ts_prelude.ts_prelude(
        spec, spec_luma_stab_history, smb_pixel_uv, fbits, data1_spec, vmb_pixel_uv,
        virtual_history_amount, normal_roughness, **_ts_consts(sc, dc),
        responsive_roughness_threshold=float(dc["responsive_accumulation_roughness_threshold"]),
        strand_material_id=float(sc["strand_material_id"]), decoded=_decoded(config))
    out = dict(spec=ts["signal"], spec_luma_stab=ts["luma_stab"], data1_spec=ts["data1"],
               mv_out=mv_out)
    if sh is not None:
        out["spec_sh"] = C.sh_luma_scale(sh, ts["luma_stab"])
    return out
