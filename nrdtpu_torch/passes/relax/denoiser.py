"""RELAX pass graph for the PyTorch port - counterpart of `nrdtpu/passes/relax/denoiser.py`.

This port runs RELAX_DIFFUSE and RELAX_SPECULAR (`denoiser.py:166-392`, one signal each):
hit-distance reconstruction (AREA_3X3 / AREA_5X5 through REBLUR's kernel, off under
checkerboard, `:249-255`), PrePass, TemporalAccumulation, HistoryFix (into the responsive
history), HistoryClamping, the optional anti-firefly pass, the à-trous ladder (2 to 8
iterations, 5 by default) with IN_DIFF_CONFIDENCE / IN_SPEC_CONFIDENCE and the TA's specular
reprojection confidence in every iteration, and SplitScreen. The other RELAX variants and
the checkerboard resolve raise NotImplementedError; ROADMAP.md lists them.

State (the permanent pool, all float32 as the JAX package keeps it for RELAX):
  history_length (h, w) 0..255, rounded to whole frames; normal_roughness_prev (h, w, 4) the
  RGBA8-quantized 0.5 n + 0.5 and roughness; material_id_prev, view_z_prev (h, w);
  <diff|spec>_illum_prev (h, w, 4) slow history (rgb + 2nd moment) after the anti-firefly
  pass, <diff|spec>_responsive_prev (h, w, 4); RELAX_SPECULAR also reflection_hit_t (h, w).
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import requantize_state
from ...settings import (
    RELAX_MAX_HISTORY_FRAME_NUM,
    CheckerboardMode,
    Denoiser,
    HitDistanceReconstructionMode,
    RelaxSettings,
    ResourceType,
)
from ..reblur import kernels as RK  # hit-distance reconstruction is shared machinery
from . import frustum_vectors, pack_prev_normal_roughness, unpack_nr
from . import kernels as K

RT = ResourceType
PORTED = (Denoiser.RELAX_DIFFUSE, Denoiser.RELAX_SPECULAR)
# per signal: its input and output resources and its confidence input
SIGNAL_RESOURCES = {
    "diff": (RT.IN_DIFF_RADIANCE_HITDIST, RT.OUT_DIFF_RADIANCE_HITDIST, RT.IN_DIFF_CONFIDENCE),
    "spec": (RT.IN_SPEC_RADIANCE_HITDIST, RT.OUT_SPEC_RADIANCE_HITDIST, RT.IN_SPEC_CONFIDENCE),
}


class RelaxDenoiser:
    def __init__(self, config, device):
        if config.denoiser not in PORTED:
            raise NotImplementedError(
                f"{config.denoiser.name} is not ported yet; the port runs "
                + ", ".join(d.name for d in PORTED) + " of RELAX (ROADMAP.md lists the next "
                "slices)")
        self.config = config
        self.device = torch.device(device)
        self.which = "spec" if config.denoiser == Denoiser.RELAX_SPECULAR else "diff"
        self._s = RelaxSettings()

    def static_key(self, s: RelaxSettings):
        return (s.checkerboardMode, s.hitDistanceReconstructionMode, s.enableAntiFirefly,
                min(max(s.atrousIterationNum, 2), 8), s.enableRoughnessEdgeStopping)

    def specialize(self, s: RelaxSettings):
        if s.checkerboardMode != CheckerboardMode.OFF:
            raise NotImplementedError("RELAX checkerboard is not ported yet (ROADMAP.md)")
        self._s = s

    def init_state(self):
        w, h = self.config.rect_size
        kw = dict(dtype=torch.float32, device=self.device)
        state = {
            "history_length": torch.zeros((h, w), **kw),
            "normal_roughness_prev": torch.full((h, w, 4), 1.0 / 255.0, **kw),
            "material_id_prev": torch.zeros((h, w), **kw),
            "view_z_prev": torch.full((h, w), 1e7, **kw),
            f"{self.which}_illum_prev": torch.zeros((h, w, 4), **kw),
            f"{self.which}_responsive_prev": torch.zeros((h, w, 4), **kw),
        }
        if self.which == "spec":
            state["reflection_hit_t"] = torch.zeros((h, w), **kw)
        return state

    # -- AddSharedConstants_Relax (Relax.cpp:60-180), denoiser part -----------------
    def frame_constants(self, consts: dict, s: RelaxSettings) -> dict:
        reset = consts["reset_history"] > 0.0
        f32 = np.float32

        def cap(v):
            return 0.0 if reset else float(min(v, RELAX_MAX_HISTORY_FRAME_NUM))

        return {
            "spec_max_accumulated_frame_num": f32(cap(s.specularMaxAccumulatedFrameNum)),
            "spec_max_fast_accumulated_frame_num": f32(
                cap(s.specularMaxFastAccumulatedFrameNum)),
            "diff_max_accumulated_frame_num": f32(cap(s.diffuseMaxAccumulatedFrameNum)),
            "diff_max_fast_accumulated_frame_num": f32(
                cap(s.diffuseMaxFastAccumulatedFrameNum)),
            "roughness_fraction": f32(s.roughnessFraction),
            "spec_variance_boost": f32(s.specularVarianceBoost),
            "diff_blur_radius": f32(s.diffusePrepassBlurRadius),
            "spec_blur_radius": f32(s.specularPrepassBlurRadius),
            "depth_threshold": f32(s.depthThreshold),
            "lobe_angle_fraction": f32(s.lobeAngleFraction),
            "spec_lobe_angle_slack": f32(np.radians(s.specularLobeAngleSlack)),
            "history_fix_edge_stopping_normal_power": f32(
                s.historyFixEdgeStoppingNormalPower),
            "roughness_edge_stopping_relaxation": f32(s.roughnessEdgeStoppingRelaxation),
            "normal_edge_stopping_relaxation": f32(s.normalEdgeStoppingRelaxation),
            "color_box_sigma_scale": f32(s.historyClampingColorBoxSigmaScale),
            "history_acceleration_amount": f32(s.antilagSettings.accelerationAmount),
            "history_reset_temporal_sigma_scale": f32(s.antilagSettings.temporalSigmaScale),
            "history_reset_spatial_sigma_scale": f32(s.antilagSettings.spatialSigmaScale),
            "history_reset_amount": f32(s.antilagSettings.resetAmount),
            "spec_phi_luminance": f32(s.specularPhiLuminance),
            "diff_phi_luminance": f32(s.diffusePhiLuminance),
            "diff_max_luminance_relative_difference": f32(
                -np.log(max(min(s.diffuseMinLuminanceWeight, 1.0), 1e-6))),
            "spec_max_luminance_relative_difference": f32(
                -np.log(max(min(s.specularMinLuminanceWeight, 1.0), 1e-6))),
            "luminance_edge_stopping_relaxation": f32(s.roughnessEdgeStoppingRelaxation),
            "confidence_driven_relaxation_multiplier": f32(
                s.confidenceDrivenRelaxationMultiplier),
            "confidence_driven_luminance_edge_stopping_relaxation": f32(
                s.confidenceDrivenLuminanceEdgeStoppingRelaxation),
            "confidence_driven_normal_edge_stopping_relaxation": f32(
                s.confidenceDrivenNormalEdgeStoppingRelaxation),
            # gFramerateScale uses a different clamp than REBLUR (Relax.cpp:166)
            "framerate_scale": f32(np.clip(16.66 / max(consts["time_delta"], 1e-3),
                                           0.25, 4.0)),
            "history_fix_frame_num": f32(s.historyFixFrameNum + 1.0),
            "history_fix_base_pixel_stride": f32(s.historyFixBasePixelStride),
            "history_threshold": f32(s.spatialVarianceEstimationHistoryThreshold),
            # x2 to match REBLUR units (Relax.cpp:172)
            "min_hit_distance_weight": f32(s.minHitDistanceWeight * 2.0),
            "diff_min_material": f32(s.minMaterialForDiffuse),
            "spec_min_material": f32(s.minMaterialForSpecular),
            "roughness_edge_stopping_enabled": f32(
                1.0 if s.enableRoughnessEdgeStopping else 0.0),
            # RELAX's stand-in for the shared hit-distance helpers' parameters
            "hit_dist_params": np.array([3.0, 0.1, 20.0, -25.0], f32),
            "plane_dist_sensitivity": f32(0.02),
        }

    @staticmethod
    def _relax_sc(sc):
        """The shared constants with the frustum right / up / forward vectors of both cameras
        (Relax.cpp:70-80), as host float32 numpy."""
        sc = dict(sc)
        for pre, suf in (("", ""), ("prev_", "_prev")):
            r, u, f = frustum_vectors(sc["world_to_view" + suf], sc["view_to_clip" + suf],
                                      sc["view_to_world" + suf], sc["frustum" + suf])
            sc[pre + "frustum_right"], sc[pre + "frustum_up"], sc[pre + "frustum_forward"] = r, u, f
        return sc

    # -- frame -----------------------------------------------------------------------
    def frame(self, sc: dict, dc: dict, state: dict, inputs: dict):
        cfg = self.config
        s = self._s
        which = self.which
        rt_in, rt_out, rt_conf = SIGNAL_RESOURCES[which]
        sc = self._relax_sc(sc)
        view_z = inputs[RT.IN_VIEWZ]
        normal_roughness = inputs[RT.IN_NORMAL_ROUGHNESS]
        mv = inputs[RT.IN_MV]
        raw = inputs[rt_in]
        dt_mix = inputs.get(RT.IN_DISOCCLUSION_THRESHOLD_MIX)
        if mv.shape[-1] == 2:
            mv = torch.cat([mv, torch.zeros_like(mv[..., :1])], -1)

        dead = K.dead_mask(sc, K.classify_tiles(sc, view_z), view_z)

        sig = raw
        if s.hitDistanceReconstructionMode != HitDistanceReconstructionMode.OFF:
            radius = (2 if s.hitDistanceReconstructionMode
                      == HitDistanceReconstructionMode.AREA_5X5 else 1)
            pair = (sig, None) if which == "diff" else (None, sig)
            rec = RK.hit_dist_reconstruction(sc, dc, view_z, normal_roughness, *pair, cfg,
                                             radius=radius)
            sig = rec[0] if which == "diff" else rec[1]

        pre = K.pre_pass(sc, dc, sig, view_z, normal_roughness, cfg, which)
        if which == "diff":
            ta = K.temporal_accumulation(sc, dc, view_z, normal_roughness, mv, pre, state, cfg,
                                         diff_confidence=inputs.get(rt_conf), dt_mix=dt_mix)
        else:
            ta = K.temporal_accumulation_specular(sc, dc, view_z, normal_roughness, mv, pre,
                                                  state, cfg, spec_confidence=inputs.get(rt_conf),
                                                  dt_mix=dt_mix)
        history_length = ta["history_length"]
        fixed = K.history_fix(sc, dc, view_z, normal_roughness, history_length, ta[which], cfg,
                              which)
        hc = K.history_clamping(sc, dc, view_z, pre, ta[which], ta[which + "_fast"], fixed,
                                history_length, which)
        del fixed, pre

        slow = hc[which + "_slow"]
        if s.enableAntiFirefly:
            (slow,) = K.anti_firefly(dc, normal_roughness, (slow,), (which,))
        cur = slow
        iterations = int(np.clip(s.atrousIterationNum, 2, 8))
        for i in range(iterations):
            cur = K.atrous(sc, dc, view_z, normal_roughness, history_length, cur, cfg,
                           step_size=1 << i, is_first=i == 0, which=which,
                           diff_confidence=inputs.get(RT.IN_DIFF_CONFIDENCE),
                           spec_confidence=inputs.get(RT.IN_SPEC_CONFIDENCE),
                           reprojection_confidence=ta.get("spec_reprojection_confidence"))

        keep = dead
        n, rough, mat = unpack_nr(normal_roughness, cfg)
        new_state = dict(state)
        # stored as R8_UNORM frames / 255 in the reference: whole frames
        new_state["history_length"] = torch.where(keep, state["history_length"],
                                                  torch.round(hc["history_length"]))
        # the AtrousSmem pass re-saves the recurrent G-buffer (`denoiser.py:337-343`)
        new_state["normal_roughness_prev"] = pack_prev_normal_roughness(
            torch.where(dead[..., None], 1.0 / 255.0, n), torch.where(dead, 1.0 / 255.0, rough))
        new_state["material_id_prev"] = mat
        new_state["view_z_prev"] = view_z.clone()  # the caller may reuse its input buffer
        # the slow history after the anti-firefly pass (`denoiser.py:299-304`, `:358-362`)
        new_state[which + "_illum_prev"] = torch.where(keep[..., None],
                                                       state[which + "_illum_prev"], slow)
        new_state[which + "_responsive_prev"] = torch.where(
            keep[..., None], state[which + "_responsive_prev"], hc[which + "_resp"])
        if which == "spec":
            new_state["reflection_hit_t"] = torch.where(keep, state["reflection_hit_t"],
                                                        ta["reflection_hit_t"])
        out = K.split_screen(sc, view_z, raw, torch.where(dead[..., None], raw, cur))
        return {rt_out: out}, requantize_state(state, new_state)
