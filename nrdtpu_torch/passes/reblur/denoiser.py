"""REBLUR pass graph for the PyTorch port - counterpart of `nrdtpu/passes/reblur/denoiser.py`.

This port runs REBLUR_DIFFUSE and REBLUR_SPECULAR (`denoiser.py:162-606` with one signal):
PrePass, TemporalAccumulation, HistoryFix, Blur, PostBlur and TemporalStabilization. Every
other variant, and the settings paths not ported yet (checkerboard, hit-distance
reconstruction, anti-firefly), raise NotImplementedError; ROADMAP.md lists them.

State (the permanent pool; histories in bf16, the RGBA16f-history analogue):
  prev_view_z (h, w), prev_normal_roughness (h, w, 4), diff_accum / spec_accum / material_id
  (h, w); per signal s in {diff, spec}: s_history (h, w, 4), s_fast_history (h, w),
  s_luma_stab (h, w); for specular also prev_spec_hitdist_for_tracking (h, w) float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import requantize_state
from ...settings import (
    REBLUR_MAX_HISTORY_FRAME_NUM,
    CheckerboardMode,
    Denoiser,
    HitDistanceReconstructionMode,
    ReblurSettings,
    ResourceType,
    RoughnessEncoding,
)
from . import common as C
from . import kernels as K

RT = ResourceType
PORTED = (Denoiser.REBLUR_DIFFUSE, Denoiser.REBLUR_SPECULAR)


class ReblurDenoiser:
    def __init__(self, config, device):
        if config.denoiser not in PORTED:
            raise NotImplementedError(
                f"{config.denoiser.name} is not ported yet; the port runs REBLUR_DIFFUSE and "
                "REBLUR_SPECULAR (ROADMAP.md lists the next slices)")
        self.config = config
        self.device = torch.device(device)
        self.which = "diff" if config.denoiser == Denoiser.REBLUR_DIFFUSE else "spec"
        if self.which == "spec" and config.roughness_encoding != RoughnessEncoding.LINEAR:
            raise NotImplementedError(
                "the port's specular path takes linear roughness only (ROADMAP.md)")
        self._s = ReblurSettings()

    def static_key(self, s: ReblurSettings):
        return (s.enablePerformanceMode, s.enableAntiFirefly, s.checkerboardMode,
                s.hitDistanceReconstructionMode, s.maxStabilizedFrameNum == 0,
                self._skip_prepass(s))

    def _skip_prepass(self, s: ReblurSettings):
        """`nrdtpu/passes/reblur/denoiser.py:58-63` for one signal."""
        radius = (s.diffusePrepassBlurRadius if self.which == "diff"
                  else s.specularPrepassBlurRadius)
        return radius == 0.0 and s.checkerboardMode == CheckerboardMode.OFF

    def specialize(self, s: ReblurSettings):
        if s.checkerboardMode != CheckerboardMode.OFF:
            raise NotImplementedError("REBLUR checkerboard is not ported yet (ROADMAP.md)")
        if s.hitDistanceReconstructionMode != HitDistanceReconstructionMode.OFF:
            raise NotImplementedError(
                "REBLUR hit-distance reconstruction is not ported yet (ROADMAP.md)")
        if s.enableAntiFirefly:
            raise NotImplementedError("REBLUR anti-firefly is not ported yet (ROADMAP.md)")
        self._s = s

    def init_state(self):
        w, h = self.config.rect_size
        kw = dict(device=self.device)
        f32, bf16 = torch.float32, torch.bfloat16
        sig = self.which
        state = {
            "prev_view_z": torch.full((h, w), 1e7, dtype=f32, **kw),
            "prev_normal_roughness": torch.zeros((h, w, 4), dtype=f32, **kw),
            "diff_accum": torch.zeros((h, w), dtype=f32, **kw),
            "spec_accum": torch.zeros((h, w), dtype=f32, **kw),
            "material_id": torch.zeros((h, w), dtype=f32, **kw),
            f"{sig}_history": torch.zeros((h, w, 4), dtype=bf16, **kw),
            f"{sig}_fast_history": torch.zeros((h, w), dtype=bf16, **kw),
            f"{sig}_luma_stab": torch.zeros((h, w), dtype=bf16, **kw),
        }
        if sig == "spec":
            state["prev_spec_hitdist_for_tracking"] = torch.zeros((h, w), dtype=f32, **kw)
        return state

    # -- AddSharedConstants_Reblur (Reblur.cpp:297-406), denoiser part -------------
    def frame_constants(self, consts: dict, s: ReblurSettings) -> dict:
        rect_w, rect_h = self.config.rect_size
        res_w, res_h = self.config.resource_size
        worst = min(rect_w / res_w, rect_h / res_h)
        reset = consts["reset_history"] > 0.0
        max_accum = min(s.maxAccumulatedFrameNum, REBLUR_MAX_HISTORY_FRAME_NUM)
        stab = s.maxStabilizedFrameNum / (1.0 + s.maxStabilizedFrameNum)
        stab_hit = (s.maxStabilizedFrameNumForHitDistance
                    / (1.0 + s.maxStabilizedFrameNumForHitDistance))
        hp = s.hitDistanceParameters
        f32 = np.float32
        return {
            "hit_dist_params": np.array([hp.A, hp.B, hp.C, hp.D], f32),
            "antilag_params": np.array([s.antilagSettings.luminanceSigmaScale,
                                        s.antilagSettings.luminanceSensitivity], f32),
            "max_blur_radius": f32(max(s.maxBlurRadius * worst, s.minBlurRadius)),
            "min_blur_radius": f32(s.minBlurRadius),
            "diff_prepass_blur_radius": f32(s.diffusePrepassBlurRadius * worst),
            "spec_prepass_blur_radius": f32(s.specularPrepassBlurRadius * worst),
            "stabilization_strength": f32(0.0 if reset else stab),
            "hit_dist_stabilization_strength": f32(0.0 if reset else stab_hit),
            "max_accumulated_frame_num": f32(0.0 if reset else max_accum),
            "max_fast_accumulated_frame_num": f32(
                0.0 if reset else s.maxFastAccumulatedFrameNum),
            "anti_firefly": f32(1.0 if s.enableAntiFirefly else 0.0),
            "lobe_angle_fraction": f32(s.lobeAngleFraction * s.lobeAngleFraction),
            "roughness_fraction": f32(s.roughnessFraction),
            "responsive_accumulation_roughness_threshold": f32(
                s.responsiveAccumulationRoughnessThreshold),
            "history_fix_frame_num": f32(s.historyFixFrameNum),
            "history_fix_base_pixel_stride": f32(s.historyFixBasePixelStride),
            "use_prepass_not_only_for_specular_motion_estimation": f32(
                0.0 if s.usePrepassOnlyForSpecularMotionEstimation else 1.0),
            "firefly_suppressor_min_relative_scale": f32(s.fireflySuppressorMinRelativeScale),
            "min_hit_distance_weight": f32(s.minHitDistanceWeight),
            "diff_min_material": f32(s.minMaterialForDiffuse),
            "spec_min_material": f32(s.minMaterialForSpecular),
            "plane_dist_sensitivity": f32(s.planeDistanceSensitivity),
            "spec_probability_thresholds": np.array(
                s.specularProbabilityThresholdsForMvModification, f32),
        }

    # -- frame ------------------------------------------------------------------------
    def frame(self, sc: dict, dc: dict, state: dict, inputs: dict):
        cfg = self.config
        s = self._s
        sig = self.which
        spec_path = sig == "spec"
        view_z = inputs[RT.IN_VIEWZ]
        normal_roughness = inputs[RT.IN_NORMAL_ROUGHNESS]
        mv = inputs[RT.IN_MV]
        raw_in = inputs[RT.IN_SPEC_RADIANCE_HITDIST if spec_path else RT.IN_DIFF_RADIANCE_HITDIST]
        perf = s.enablePerformanceMode
        skip_prepass = self._skip_prepass(s)

        tile_map = K.classify_tiles(sc, view_z)
        dead = K.sky_pixel_mask(sc, tile_map, view_z)

        # PREPASS
        signal = raw_in
        hdt_prepass = None
        if not skip_prepass:
            if spec_path:
                signal, hdt_prepass = K.specular_spatial_filter(
                    sc, dc, K.PRE_BLUR, signal, view_z, normal_roughness, None, cfg,
                    perf_mode=perf)
            else:
                signal = K.diffuse_pre_pass(sc, dc, signal, view_z, normal_roughness, cfg,
                                            perf_mode=perf)

        # TEMPORAL ACCUMULATION
        prev_internal = {k: state[k] for k in ("diff_accum", "spec_accum", "material_id")}
        sm = K.surface_motion_reprojection(
            sc, dc, view_z, normal_roughness, mv, state["prev_view_z"],
            state["prev_normal_roughness"], prev_internal, cfg, state[f"{sig}_history"],
            state[f"{sig}_fast_history"],
            disocclusion_threshold_mix=inputs.get(RT.IN_DISOCCLUSION_THRESHOLD_MIX), which=sig)
        fbits = sm["fbits"]
        if spec_path:
            ta = K.temporal_accumulation_specular(
                sc, dc, sm, signal, state["spec_history"], state["spec_fast_history"], view_z,
                normal_roughness, state["prev_view_z"], state["prev_normal_roughness"],
                prev_internal, C.extract_hit_dist(signal) if skip_prepass else hdt_prepass,
                state["prev_spec_hitdist_for_tracking"], cfg, inputs.get(RT.IN_SPEC_CONFIDENCE),
                has_prepass_hitdist=not skip_prepass)
            sig1, fast1, data1 = ta["spec"], ta["fast"], ta["accum_speed"]
            fbits = fbits + ta["fbits_vmb"]
        else:
            sig1, fast1, data1 = K.temporal_accumulation_diffuse(
                sc, dc, sm, signal, inputs.get(RT.IN_DIFF_CONFIDENCE))
        material_id = sm["material_id"]
        del sm  # its full-resolution planes are dead after TA: free them for the later passes

        # HISTORY FIX, BLUR, POST BLUR
        sig2, fast2 = K.history_fix(sc, dc, view_z, normal_roughness, data1, sig1, fast1, cfg,
                                    is_diffuse=not spec_path)
        if spec_path:
            sig3, _ = K.specular_spatial_filter(sc, dc, K.BLUR, sig2, view_z, normal_roughness,
                                                data1, cfg, perf_mode=perf)
            sig4, _ = K.specular_spatial_filter(sc, dc, K.POST_BLUR, sig3, view_z,
                                                normal_roughness, data1, cfg, perf_mode=perf)
        else:
            sig3 = K.diffuse_spatial_filter(sc, dc, K.BLUR, sig2, view_z, normal_roughness,
                                            data1, cfg, perf_mode=perf)
            sig4 = K.diffuse_spatial_filter(sc, dc, K.POST_BLUR, sig3, view_z,
                                            normal_roughness, data1, cfg, perf_mode=perf)

        new_state = dict(state)
        keep = dead
        outs = {}
        # TEMPORAL STABILIZATION or direct output
        if s.maxStabilizedFrameNum == 0:
            out_sig = sig4
            inc = data1 + 1.0
        else:
            if spec_path:
                ts = K.temporal_stabilization_specular(
                    sc, dc, view_z, normal_roughness, mv, data1, fbits, ta["curvature"],
                    ta["virtual_history_amount"], sig4, state["spec_luma_stab"],
                    ta["hit_dist_for_tracking"], inputs.get(RT.IN_BASECOLOR_METALNESS), cfg,
                    has_prepass=not skip_prepass)
                if RT.IN_BASECOLOR_METALNESS in inputs:
                    outs[RT.IN_MV] = ts["mv_out"]  # patched MV, as the reference writes it
            else:
                ts = K.temporal_stabilization(sc, dc, view_z, normal_roughness, mv, data1,
                                              fbits, sig4, state["diff_luma_stab"], cfg)
            out_sig = ts[sig]
            new_state[f"{sig}_luma_stab"] = torch.where(keep, state[f"{sig}_luma_stab"],
                                                        ts[f"{sig}_luma_stab"])
            inc = ts[f"data1_{sig}"]

        new_state["prev_view_z"] = view_z.clone()  # the caller may reuse its input buffer
        new_state["prev_normal_roughness"] = torch.where(
            keep[..., None], state["prev_normal_roughness"], normal_roughness)
        new_state["material_id"] = torch.where(keep, state["material_id"],
                                               C.quantize_material_id(material_id))
        new_state[f"{sig}_accum"] = torch.where(keep, state[f"{sig}_accum"],
                                                C.quantize_accum_speed(inc))
        if spec_path:
            new_state["prev_spec_hitdist_for_tracking"] = torch.where(
                keep, state["prev_spec_hitdist_for_tracking"], ta["hit_dist_for_tracking"])

        out_sig = torch.where(dead[..., None], raw_in, out_sig)
        out_rt = RT.OUT_SPEC_RADIANCE_HITDIST if spec_path else RT.OUT_DIFF_RADIANCE_HITDIST
        outs[out_rt] = K.split_screen(sc, raw_in, view_z, out_sig)
        # history for the next frame = PostBlur output (PostBlur writes the history)
        new_state[f"{sig}_history"] = torch.where(keep[..., None], state[f"{sig}_history"], sig4)
        new_state[f"{sig}_fast_history"] = torch.where(keep, state[f"{sig}_fast_history"], fast2)
        return outs, requantize_state(state, new_state)
