"""REBLUR pass graph for the PyTorch port - counterpart of `nrdtpu/passes/reblur/denoiser.py`.

This port runs REBLUR_DIFFUSE, REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR
(`denoiser.py:162-606`): hit-distance reconstruction (AREA_3X3 / AREA_5X5, off under
checkerboard, `:225-237`), PrePass, TemporalAccumulation, HistoryFix, Blur, PostBlur and
TemporalStabilization, with or without the anti-firefly ring of HistoryFix. With both signals
the spatial stages and HistoryFix run one fused launch for the two (`fused_spatial_filter`,
`fused_history_fix`) on the card and on the CPU alike, and TA samples both histories in one
launch; the reconstruction refills both signals in one launch. With NRDTPU_REBLUR_BAND=1 (the
JAX package's switch, off by default) HistoryFix, Blur and PostBlur of both signals run as one
band launch (`spatial_band`). Every other variant, and the
settings path not ported yet (checkerboard), raise NotImplementedError; ROADMAP.md lists them.

State (the permanent pool; histories in bf16, the RGBA16f-history analogue):
  prev_view_z (h, w), prev_normal_roughness (h, w, 4), diff_accum / spec_accum / material_id
  (h, w); per signal s present in {diff, spec}: s_history (h, w, 4), s_fast_history (h, w),
  s_luma_stab (h, w); with specular also prev_spec_hitdist_for_tracking (h, w) float32.
"""

from __future__ import annotations

import os

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
PORTED = (Denoiser.REBLUR_DIFFUSE, Denoiser.REBLUR_SPECULAR, Denoiser.REBLUR_DIFFUSE_SPECULAR)
IN_RT = {"diff": RT.IN_DIFF_RADIANCE_HITDIST, "spec": RT.IN_SPEC_RADIANCE_HITDIST}
OUT_RT = {"diff": RT.OUT_DIFF_RADIANCE_HITDIST, "spec": RT.OUT_SPEC_RADIANCE_HITDIST}


class ReblurDenoiser:
    def __init__(self, config, device):
        if config.denoiser not in PORTED:
            raise NotImplementedError(
                f"{config.denoiser.name} is not ported yet; the port runs "
                + ", ".join(d.name for d in PORTED) + " (ROADMAP.md lists the next slices)")
        self.config = config
        self.device = torch.device(device)
        self.has_diffuse = "DIFFUSE" in config.denoiser.name
        self.has_specular = "SPECULAR" in config.denoiser.name
        self.signals = tuple(sig for sig, present in (("diff", self.has_diffuse),
                                                      ("spec", self.has_specular)) if present)
        if self.has_specular and config.roughness_encoding != RoughnessEncoding.LINEAR:
            raise NotImplementedError(
                "the port's specular path takes linear roughness only (ROADMAP.md)")
        self._s = ReblurSettings()

    def static_key(self, s: ReblurSettings):
        return (s.enablePerformanceMode, s.enableAntiFirefly, s.checkerboardMode,
                s.hitDistanceReconstructionMode, s.maxStabilizedFrameNum == 0,
                self._skip_prepass(s))

    def _skip_prepass(self, s: ReblurSettings):
        """`nrdtpu/passes/reblur/denoiser.py:58-63`: no PrePass only if every signal's
        radius is 0."""
        radius = {"diff": s.diffusePrepassBlurRadius, "spec": s.specularPrepassBlurRadius}
        return (all(radius[sig] == 0.0 for sig in self.signals)
                and s.checkerboardMode == CheckerboardMode.OFF)

    def specialize(self, s: ReblurSettings):
        if s.checkerboardMode != CheckerboardMode.OFF:
            raise NotImplementedError("REBLUR checkerboard is not ported yet (ROADMAP.md)")
        self._s = s

    def init_state(self):
        w, h = self.config.rect_size
        kw = dict(device=self.device)
        f32, bf16 = torch.float32, torch.bfloat16
        state = {
            "prev_view_z": torch.full((h, w), 1e7, dtype=f32, **kw),
            "prev_normal_roughness": torch.zeros((h, w, 4), dtype=f32, **kw),
            "diff_accum": torch.zeros((h, w), dtype=f32, **kw),
            "spec_accum": torch.zeros((h, w), dtype=f32, **kw),
            "material_id": torch.zeros((h, w), dtype=f32, **kw),
        }
        for sig in self.signals:
            state[f"{sig}_history"] = torch.zeros((h, w, 4), dtype=bf16, **kw)
            state[f"{sig}_fast_history"] = torch.zeros((h, w), dtype=bf16, **kw)
            state[f"{sig}_luma_stab"] = torch.zeros((h, w), dtype=bf16, **kw)
        if self.has_specular:
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
        view_z = inputs[RT.IN_VIEWZ]
        normal_roughness = inputs[RT.IN_NORMAL_ROUGHNESS]
        mv = inputs[RT.IN_MV]
        raw_in = {sig: inputs[IN_RT[sig]] for sig in self.signals}
        perf = s.enablePerformanceMode
        skip_prepass = self._skip_prepass(s)
        # both signals: the spatial stages and HistoryFix run fused (denoiser.py:245-246)
        fused = self.has_diffuse and self.has_specular
        anti_firefly = {sig: s.enableAntiFirefly for sig in self.signals}

        tile_map = K.classify_tiles(sc, view_z)
        dead = K.sky_pixel_mask(sc, tile_map, view_z)
        geom = (K.make_filter_geometry(sc, dc, view_z, normal_roughness, cfg)
                if fused else None)

        # HITDIST_RECONSTRUCTION: off under checkerboard (`denoiser.py:225-237`)
        signal = dict(raw_in)
        if (s.hitDistanceReconstructionMode != HitDistanceReconstructionMode.OFF
                and s.checkerboardMode == CheckerboardMode.OFF):
            radius = (2 if s.hitDistanceReconstructionMode
                      == HitDistanceReconstructionMode.AREA_5X5 else 1)
            signal["diff"], signal["spec"] = K.hit_dist_reconstruction(
                sc, dc, view_z, normal_roughness, signal.get("diff"), signal.get("spec"), cfg,
                radius=radius)
            signal = {sig: signal[sig] for sig in self.signals}

        # PREPASS
        hdt_prepass = None
        if not skip_prepass:
            if fused:
                signal["diff"], signal["spec"], hdt_prepass = K.fused_spatial_filter(
                    sc, dc, K.PRE_BLUR, geom, view_z, normal_roughness, signal["diff"],
                    signal["spec"], perf_mode=perf)
            elif self.has_specular:
                signal["spec"], hdt_prepass = K.specular_spatial_filter(
                    sc, dc, K.PRE_BLUR, signal["spec"], view_z, normal_roughness, None, cfg,
                    perf_mode=perf)
            else:
                signal["diff"] = K.diffuse_pre_pass(sc, dc, signal["diff"], view_z,
                                                    normal_roughness, cfg, perf_mode=perf)

        # TEMPORAL ACCUMULATION: one surface-motion footprint, both signals' samples
        prev_internal = {k: state[k] for k in ("diff_accum", "spec_accum", "material_id")}
        sm = K.surface_motion_reprojection(
            sc, dc, view_z, normal_roughness, mv, state["prev_view_z"],
            state["prev_normal_roughness"], prev_internal, cfg,
            {sig: (state[f"{sig}_history"], state[f"{sig}_fast_history"])
             for sig in self.signals},
            disocclusion_threshold_mix=inputs.get(RT.IN_DISOCCLUSION_THRESHOLD_MIX))
        fbits = sm["fbits"]
        sig1, fast1, data1 = {}, {}, {}
        ta = None
        if self.has_diffuse:
            sig1["diff"], fast1["diff"], data1["diff"] = K.temporal_accumulation_diffuse(
                sc, dc, sm, signal["diff"], inputs.get(RT.IN_DIFF_CONFIDENCE))
        if self.has_specular:
            ta = K.temporal_accumulation_specular(
                sc, dc, sm, signal["spec"], state["spec_history"], state["spec_fast_history"],
                view_z, normal_roughness, state["prev_view_z"], state["prev_normal_roughness"],
                prev_internal,
                C.extract_hit_dist(signal["spec"]) if skip_prepass else hdt_prepass,
                state["prev_spec_hitdist_for_tracking"], cfg, inputs.get(RT.IN_SPEC_CONFIDENCE),
                has_prepass_hitdist=not skip_prepass)
            sig1["spec"], fast1["spec"], data1["spec"] = ta["spec"], ta["fast"], ta["accum_speed"]
            fbits = fbits + ta["fbits_vmb"]
        material_id = sm["material_id"]
        del sm  # its full-resolution planes are dead after TA: free them for the later passes

        # HISTORY FIX, BLUR, POST BLUR: with both signals, in one band launch under
        # NRDTPU_REBLUR_BAND=1 (`denoiser.py:403-428`), else three launches
        sig4, fast2 = {}, {}
        if fused:
            band = os.environ.get("NRDTPU_REBLUR_BAND", "0") == "1"
            (sig4["diff"], fast2["diff"]), (sig4["spec"], fast2["spec"]) = (
                K.spatial_band if band else K.spatial_chain)(
                sc, dc, geom, view_z, normal_roughness,
                (sig1["diff"], data1["diff"], fast1["diff"]),
                (sig1["spec"], data1["spec"], fast1["spec"]),
                anti_firefly=(anti_firefly["diff"], anti_firefly["spec"]), perf_mode=perf)
        else:
            (sig,) = self.signals
            spec_path = sig == "spec"
            sig2, fast2[sig] = K.history_fix(sc, dc, view_z, normal_roughness, data1[sig],
                                             sig1[sig], fast1[sig], cfg,
                                             is_diffuse=not spec_path,
                                             anti_firefly=anti_firefly[sig])
            if spec_path:
                sig3, _ = K.specular_spatial_filter(sc, dc, K.BLUR, sig2, view_z,
                                                    normal_roughness, data1[sig], cfg,
                                                    perf_mode=perf)
                sig4[sig], _ = K.specular_spatial_filter(sc, dc, K.POST_BLUR, sig3, view_z,
                                                         normal_roughness, data1[sig], cfg,
                                                         perf_mode=perf)
            else:
                sig3 = K.diffuse_spatial_filter(sc, dc, K.BLUR, sig2, view_z, normal_roughness,
                                                data1[sig], cfg, perf_mode=perf)
                sig4[sig] = K.diffuse_spatial_filter(sc, dc, K.POST_BLUR, sig3, view_z,
                                                     normal_roughness, data1[sig], cfg,
                                                     perf_mode=perf)
        del geom

        new_state = dict(state)
        keep = dead
        outs = {}
        # TEMPORAL STABILIZATION or direct output
        if s.maxStabilizedFrameNum == 0:
            out_sig = dict(sig4)
            inc = {sig: data1[sig] + 1.0 for sig in self.signals}
        else:
            ts_sm = K.ts_surface_motion(sc, view_z, mv)
            ts = {}
            if self.has_diffuse:
                ts["diff"] = K.temporal_stabilization(
                    sc, dc, view_z, normal_roughness, mv, data1["diff"], fbits, sig4["diff"],
                    state["diff_luma_stab"], cfg, surface_motion=ts_sm)
            if self.has_specular:
                ts["spec"] = K.temporal_stabilization_specular(
                    sc, dc, view_z, normal_roughness, mv, data1["spec"], fbits, ta["curvature"],
                    ta["virtual_history_amount"], sig4["spec"], state["spec_luma_stab"],
                    ta["hit_dist_for_tracking"], inputs.get(RT.IN_BASECOLOR_METALNESS), cfg,
                    has_prepass=not skip_prepass, surface_motion=ts_sm)
                if RT.IN_BASECOLOR_METALNESS in inputs:
                    outs[RT.IN_MV] = ts["spec"]["mv_out"]  # patched MV, as the reference writes it
            out_sig = {sig: ts[sig][sig] for sig in self.signals}
            inc = {sig: ts[sig][f"data1_{sig}"] for sig in self.signals}
            for sig in self.signals:
                new_state[f"{sig}_luma_stab"] = torch.where(keep, state[f"{sig}_luma_stab"],
                                                            ts[sig][f"{sig}_luma_stab"])

        new_state["prev_view_z"] = view_z.clone()  # the caller may reuse its input buffer
        new_state["prev_normal_roughness"] = torch.where(
            keep[..., None], state["prev_normal_roughness"], normal_roughness)
        new_state["material_id"] = torch.where(keep, state["material_id"],
                                               C.quantize_material_id(material_id))
        if self.has_specular:
            new_state["prev_spec_hitdist_for_tracking"] = torch.where(
                keep, state["prev_spec_hitdist_for_tracking"], ta["hit_dist_for_tracking"])
        for sig in self.signals:
            new_state[f"{sig}_accum"] = torch.where(keep, state[f"{sig}_accum"],
                                                    C.quantize_accum_speed(inc[sig]))
            out = torch.where(dead[..., None], raw_in[sig], out_sig[sig])
            outs[OUT_RT[sig]] = K.split_screen(sc, raw_in[sig], view_z, out)
            # history for the next frame = PostBlur output (PostBlur writes the history)
            new_state[f"{sig}_history"] = torch.where(keep[..., None], state[f"{sig}_history"],
                                                      sig4[sig])
            new_state[f"{sig}_fast_history"] = torch.where(keep, state[f"{sig}_fast_history"],
                                                           fast2[sig])
        return outs, requantize_state(state, new_state)
