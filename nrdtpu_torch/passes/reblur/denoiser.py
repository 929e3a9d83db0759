"""REBLUR pass graph for the PyTorch port - counterpart of `nrdtpu/passes/reblur/denoiser.py`.

This slice runs REBLUR_DIFFUSE (`denoiser.py:199-606` with has_specular=False): PrePass,
TemporalAccumulation, HistoryFix, Blur, PostBlur and TemporalStabilization. Every other
variant, and the settings paths not ported yet (checkerboard, hit-distance reconstruction,
anti-firefly), raise NotImplementedError; ROADMAP.md lists them.

State (the permanent pool; histories in bf16, the RGBA16f-history analogue):
  prev_view_z (h, w), prev_normal_roughness (h, w, 4), diff_accum / spec_accum / material_id
  (h, w), diff_history (h, w, 4), diff_fast_history (h, w), diff_luma_stab (h, w).
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
)
from . import common as C
from . import kernels as K

RT = ResourceType


class ReblurDenoiser:
    def __init__(self, config, device):
        if config.denoiser != Denoiser.REBLUR_DIFFUSE:
            raise NotImplementedError(
                f"{config.denoiser.name} is not ported yet; the port runs REBLUR_DIFFUSE "
                "(ROADMAP.md lists the next slices)")
        self.config = config
        self.device = torch.device(device)
        self._s = ReblurSettings()

    def static_key(self, s: ReblurSettings):
        return (s.enablePerformanceMode, s.enableAntiFirefly, s.checkerboardMode,
                s.hitDistanceReconstructionMode, s.maxStabilizedFrameNum == 0,
                s.diffusePrepassBlurRadius == 0.0)

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
        return {
            "prev_view_z": torch.full((h, w), 1e7, dtype=f32, **kw),
            "prev_normal_roughness": torch.zeros((h, w, 4), dtype=f32, **kw),
            "diff_accum": torch.zeros((h, w), dtype=f32, **kw),
            "spec_accum": torch.zeros((h, w), dtype=f32, **kw),
            "material_id": torch.zeros((h, w), dtype=f32, **kw),
            "diff_history": torch.zeros((h, w, 4), dtype=bf16, **kw),
            "diff_fast_history": torch.zeros((h, w), dtype=bf16, **kw),
            "diff_luma_stab": torch.zeros((h, w), dtype=bf16, **kw),
        }

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
        view_z = inputs[RT.IN_VIEWZ]
        normal_roughness = inputs[RT.IN_NORMAL_ROUGHNESS]
        mv = inputs[RT.IN_MV]
        raw_in = inputs[RT.IN_DIFF_RADIANCE_HITDIST]
        perf = s.enablePerformanceMode

        tile_map = K.classify_tiles(sc, view_z)
        dead = K.sky_pixel_mask(sc, tile_map, view_z)

        diff_in = raw_in
        if s.diffusePrepassBlurRadius != 0.0:  # PREPASS
            diff_in = K.diffuse_pre_pass(sc, dc, diff_in, view_z, normal_roughness, cfg,
                                         perf_mode=perf)

        # TEMPORAL ACCUMULATION
        prev_internal = {k: state[k] for k in ("diff_accum", "spec_accum", "material_id")}
        sm = K.surface_motion_reprojection(
            sc, dc, view_z, normal_roughness, mv, state["prev_view_z"],
            state["prev_normal_roughness"], prev_internal, cfg, state["diff_history"],
            state["diff_fast_history"],
            disocclusion_threshold_mix=inputs.get(RT.IN_DISOCCLUSION_THRESHOLD_MIX))
        diff1, diff_fast1, data1_diff = K.temporal_accumulation_diffuse(
            sc, dc, sm, diff_in, inputs.get(RT.IN_DIFF_CONFIDENCE))

        # HISTORY FIX, BLUR, POST BLUR
        diff2, diff_fast2 = K.history_fix(sc, dc, view_z, normal_roughness, data1_diff, diff1,
                                          diff_fast1, cfg)
        diff3 = K.diffuse_spatial_filter(sc, dc, K.BLUR, diff2, view_z, normal_roughness,
                                         data1_diff, cfg, perf_mode=perf)
        diff4 = K.diffuse_spatial_filter(sc, dc, K.POST_BLUR, diff3, view_z, normal_roughness,
                                         data1_diff, cfg, perf_mode=perf)

        new_state = dict(state)
        keep = dead
        # TEMPORAL STABILIZATION or direct output
        if s.maxStabilizedFrameNum == 0:
            diff_out = diff4
            inc_diff = data1_diff + 1.0
        else:
            ts = K.temporal_stabilization(sc, dc, view_z, normal_roughness, mv, data1_diff,
                                          sm["fbits"], diff4, state["diff_luma_stab"], cfg)
            diff_out = ts["diff"]
            new_state["diff_luma_stab"] = torch.where(keep, state["diff_luma_stab"],
                                                      ts["diff_luma_stab"])
            inc_diff = ts["data1_diff"]

        new_state["prev_view_z"] = view_z.clone()  # the caller may reuse its input buffer
        new_state["prev_normal_roughness"] = torch.where(
            keep[..., None], state["prev_normal_roughness"], normal_roughness)
        new_state["material_id"] = torch.where(keep, state["material_id"],
                                               C.quantize_material_id(sm["material_id"]))
        new_state["diff_accum"] = torch.where(keep, state["diff_accum"],
                                              C.quantize_accum_speed(inc_diff))

        out_sig = torch.where(dead[..., None], raw_in, diff_out)
        outs = {RT.OUT_DIFF_RADIANCE_HITDIST: K.split_screen(sc, raw_in, view_z, out_sig)}
        # history for the next frame = PostBlur output (PostBlur writes DIFF_HISTORY)
        new_state["diff_history"] = torch.where(keep[..., None], state["diff_history"], diff4)
        new_state["diff_fast_history"] = torch.where(keep, state["diff_fast_history"],
                                                     diff_fast2)
        return outs, requantize_state(state, new_state)
