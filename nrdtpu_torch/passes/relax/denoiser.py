"""RELAX pass graph for the PyTorch port - counterpart of `nrdtpu/passes/relax/denoiser.py`.

This port runs RELAX_DIFFUSE, RELAX_SPECULAR and RELAX_DIFFUSE_SPECULAR and their SH variants
RELAX_DIFFUSE_SH, RELAX_SPECULAR_SH and RELAX_DIFFUSE_SPECULAR_SH (`denoiser.py:166-392`):
hit-distance reconstruction (AREA_3X3 / AREA_5X5 through REBLUR's kernel, off under
checkerboard, `:249-255`), PrePass, TemporalAccumulation, HistoryFix (into the responsive
history), HistoryClamping, the optional anti-firefly pass, the à-trous ladder (2 to 8
iterations, 5 by default) with IN_DIFF_CONFIDENCE / IN_SPEC_CONFIDENCE and the TA's specular
reprojection confidence in every iteration, and SplitScreen. With both signals each pass runs
once for both where JAX runs it so: the reconstruction, the TA's head, the history fix, the
history clamp, the anti-firefly pass and each à-trous iteration take both signals in one
launch; the PrePass runs once a signal, and the TA accumulates each signal on the shared
head. The SH variants (`denoiser.py:41`, `:181-195`, `:345-378`) take IN_*_SH0 in place of the
radiance input and IN_*_SH1 as a second plane a signal, which rides the launches the variant
already makes; the last à-trous iteration's signal and the split screen's noisy side are
YCoCg, and dead pixels pass the raw SH0 (linear, as in JAX) and SH1 through. Under
checkerboard (`checkerboardMode` BLACK or WHITE) each signal input is half width: it is expanded
with `cb_expand` and `checkerboard_resolve` fills the pixels without data from their
horizontal neighbours (`denoiser.py:176-239`), hit-distance reconstruction is off, the TA
accumulates slower on the pixels without data, and the dead pass-through and SplitScreen show
the expanded input. The SH variants under checkerboard raise NotImplementedError: the JAX
reference passes the half-width SH1 through its dead pixels unexpanded
(`nrdtpu/passes/relax/denoiser.py:367-369`) and fails on frame 0, so the port has nothing to
hold them against (ROADMAP.md). Every variant runs at the five normal encodings: the frame
decodes IN_NORMAL_ROUGHNESS once (`frontend.decode_normal_plane`; at R10G10B10A2 the packed
input itself) and every pass reads that plane, the kernels in their decoded mode at the RGBA
encodings, with no material test (`denoiser.py:218`, `:245-247`).

State (the permanent pool, all float32 as the JAX package keeps it for RELAX):
  history_length (h, w) 0..255, rounded to whole frames; normal_roughness_prev (h, w, 4) the
  RGBA8-quantized 0.5 n + 0.5 and roughness; material_id_prev, view_z_prev (h, w); for each
  signal present <diff|spec>_illum_prev (h, w, 4) slow history (rgb + 2nd moment) after the
  anti-firefly pass, <diff|spec>_responsive_prev (h, w, 4); with the specular signal also
  reflection_hit_t (h, w); with the SH variants <diff|spec>_sh_prev and
  <diff|spec>_sh_responsive_prev (h, w, 4) bfloat16, as JAX keeps them (`denoiser.py:70-73`):
  every pass reads them in float32, and `requantize_state` rounds them back each frame.
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
from ... import frontend as fe
from ... import math as nm
from ..reblur import common as RC  # cb_expand, as the JAX package shares it
from ..reblur import kernels as RK  # hit-distance reconstruction is shared machinery
from ..validation import render_validation
from . import frustum_vectors, pack_prev_normal_roughness, unpack_nr
from . import kernels as K

RT = ResourceType
PORTED = (Denoiser.RELAX_DIFFUSE, Denoiser.RELAX_SPECULAR, Denoiser.RELAX_DIFFUSE_SPECULAR,
          Denoiser.RELAX_DIFFUSE_SH, Denoiser.RELAX_SPECULAR_SH,
          Denoiser.RELAX_DIFFUSE_SPECULAR_SH)
# per signal: its input and output resources and its confidence input
SIGNAL_RESOURCES = {
    "diff": (RT.IN_DIFF_RADIANCE_HITDIST, RT.OUT_DIFF_RADIANCE_HITDIST, RT.IN_DIFF_CONFIDENCE),
    "spec": (RT.IN_SPEC_RADIANCE_HITDIST, RT.OUT_SPEC_RADIANCE_HITDIST, RT.IN_SPEC_CONFIDENCE),
}
# the SH variants' per signal: SH0 in and out (in place of the radiance), SH1 in and out
SH_RESOURCES = {
    "diff": (RT.IN_DIFF_SH0, RT.OUT_DIFF_SH0, RT.IN_DIFF_SH1, RT.OUT_DIFF_SH1),
    "spec": (RT.IN_SPEC_SH0, RT.OUT_SPEC_SH0, RT.IN_SPEC_SH1, RT.OUT_SPEC_SH1),
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
        # the signals present, as `has_diffuse` / `has_specular` in JAX (`denoiser.py:42-43`)
        self.signals = tuple(sig for sig, part in (("diff", "DIFFUSE"), ("spec", "SPECULAR"))
                             if part in config.denoiser.name)
        self.sh = config.denoiser.name.endswith("_SH")  # `denoiser.py:41`
        self.enable_validation = False  # OUT_VALIDATION, set by the Engine a frame
        self._s = RelaxSettings()

    def static_key(self, s: RelaxSettings):
        return (s.checkerboardMode, s.hitDistanceReconstructionMode, s.enableAntiFirefly,
                min(max(s.atrousIterationNum, 2), 8), s.enableRoughnessEdgeStopping)

    def specialize(self, s: RelaxSettings):
        if self.sh and s.checkerboardMode != CheckerboardMode.OFF:
            raise NotImplementedError(
                f"{self.config.denoiser.name} with checkerboard is not ported: the JAX "
                "reference passes the half-width IN_*_SH1 through its dead pixels unexpanded "
                "(nrdtpu/passes/relax/denoiser.py:367-369) and fails on frame 0, so there is "
                "nothing to hold the port against (ROADMAP.md)")
        self._s = s

    def init_state(self):
        w, h = self.config.rect_size
        kw = dict(dtype=torch.float32, device=self.device)
        state = {
            "history_length": torch.zeros((h, w), **kw),
            "normal_roughness_prev": torch.full((h, w, 4), 1.0 / 255.0, **kw),
            "material_id_prev": torch.zeros((h, w), **kw),
            "view_z_prev": torch.full((h, w), 1e7, **kw),
        }
        for sig in self.signals:
            state[f"{sig}_illum_prev"] = torch.zeros((h, w, 4), **kw)
            state[f"{sig}_responsive_prev"] = torch.zeros((h, w, 4), **kw)
            if self.sh:
                for kind in ("sh", "sh_responsive"):
                    state[f"{sig}_{kind}_prev"] = torch.zeros(
                        (h, w, 4), dtype=torch.bfloat16, device=self.device)
        if "spec" in self.signals:
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
        sigs = self.signals
        both = len(sigs) == 2
        # a pass of both signals takes the pair and the names; of one, the signal and its name
        which = sigs if both else sigs[0]

        def one_or_pair(d):
            return tuple(d[sig] for sig in sigs) if both else d[sigs[0]]

        sc = self._relax_sc(sc)
        view_z = inputs[RT.IN_VIEWZ]
        # the plane every pass reads: packed R10G10B10A2, or the RGBA formats decoded
        normal_roughness = fe.decode_normal_plane(inputs[RT.IN_NORMAL_ROUGHNESS],
                                                  cfg.normal_encoding)
        mv = inputs[RT.IN_MV]
        h, w = view_z.shape
        # checkerboard (never with SH, `specialize`): the half-width input at full width
        cb_on = s.checkerboardMode != CheckerboardMode.OFF
        # the signal: the radiance input, or SH0; with SH also SH1 (`denoiser.py:181-195`)
        raw = {sig: inputs[(SH_RESOURCES if self.sh else SIGNAL_RESOURCES)[sig][0]]
               for sig in sigs}
        if cb_on:
            raw = {name: RC.cb_expand(t, w) for name, t in raw.items()}
        raw_sh = {sig: inputs[SH_RESOURCES[sig][2]] if self.sh else None for sig in sigs}
        conf = {sig: inputs.get(SIGNAL_RESOURCES[sig][2]) for sig in sigs}
        dt_mix = inputs.get(RT.IN_DISOCCLUSION_THRESHOLD_MIX)
        if mv.shape[-1] == 2:
            mv = torch.cat([mv, torch.zeros_like(mv[..., :1])], -1)

        dead = K.dead_mask(sc, K.classify_tiles(sc, view_z), view_z)

        sig = dict(raw)
        has_data = None
        if cb_on:  # the checkerboard resolve at the front (`denoiser.py:196-239`)
            has_data = nm.checkerboard_has_data(h, w, sc["frame_index"], int(s.checkerboardMode),
                                                view_z.device)
            sig = dict(zip(sigs, K.checkerboard_resolve(
                sc, dc, view_z, normal_roughness, has_data, [sig[name] for name in sigs], cfg)))
        # off under checkerboard (`denoiser.py:249-250`)
        if (s.hitDistanceReconstructionMode != HitDistanceReconstructionMode.OFF
                and not cb_on):
            radius = (2 if s.hitDistanceReconstructionMode
                      == HitDistanceReconstructionMode.AREA_5X5 else 1)
            rec = RK.hit_dist_reconstruction(sc, dc, view_z, normal_roughness, sig.get("diff"),
                                             sig.get("spec"), cfg, radius=radius)
            sig = {name: rec[0 if name == "diff" else 1] for name in sigs}

        # the PrePass once a signal (`relax_prepass_taps_pallas(is_spec)`), with SH1 beside it
        pre, pre_sh = {}, {}
        for name in sigs:
            r = K.pre_pass(sc, dc, sig[name], view_z, normal_roughness, cfg, name,
                           sh=raw_sh[name])
            pre[name], pre_sh[name] = r if self.sh else (r, None)
        if both:
            ta = K.temporal_accumulation_diffuse_specular(
                sc, dc, view_z, normal_roughness, mv, pre["diff"], pre["spec"], state, cfg,
                diff_confidence=conf["diff"], spec_confidence=conf["spec"], dt_mix=dt_mix,
                diff_sh=pre_sh["diff"], spec_sh=pre_sh["spec"], has_data=has_data)
        elif which == "diff":
            ta = K.temporal_accumulation(sc, dc, view_z, normal_roughness, mv, pre["diff"],
                                         state, cfg, diff_confidence=conf["diff"], dt_mix=dt_mix,
                                         diff_sh=pre_sh["diff"], has_data=has_data)
        else:
            ta = K.temporal_accumulation_specular(sc, dc, view_z, normal_roughness, mv,
                                                  pre["spec"], state, cfg,
                                                  spec_confidence=conf["spec"], dt_mix=dt_mix,
                                                  spec_sh=pre_sh["spec"], has_data=has_data)
        history_length = ta["history_length"]
        ta_sh = {kind: one_or_pair({name: ta[f"{name}_{kind}"] for name in sigs})
                 if self.sh else None for kind in ("sh", "sh_fast")}
        # with SH the fix reconstructs the TA's slow SH too, and, as in JAX, HistoryClamping
        # then reads the TA's SH, not the fixed one (`denoiser.py:262-292`)
        fixed = K.history_fix(sc, dc, view_z, normal_roughness, history_length, one_or_pair(ta),
                              cfg, which, sh=ta_sh["sh"])
        if self.sh:
            fixed = fixed[:len(sigs)] if both else fixed[0]
        hc = K.history_clamping(sc, dc, view_z, one_or_pair(pre), one_or_pair(ta),
                                tuple(ta[name + "_fast"] for name in sigs) if both
                                else ta[which + "_fast"], fixed, history_length, which,
                                sh=ta_sh["sh"], sh_fast=ta_sh["sh_fast"])
        del fixed, pre, pre_sh

        slow = {name: hc[name + "_slow"] for name in sigs}
        if s.enableAntiFirefly:
            slow = dict(zip(sigs, K.anti_firefly(dc, normal_roughness,
                                                 tuple(slow[name] for name in sigs), sigs,
                                                 cfg)))
        cur = one_or_pair(slow)
        cur_sh = one_or_pair({name: hc[name + "_sh"] for name in sigs}) if self.sh else None
        iterations = int(np.clip(s.atrousIterationNum, 2, 8))
        for i in range(iterations):
            cur = K.atrous(sc, dc, view_z, normal_roughness, history_length, cur, cfg,
                           step_size=1 << i, is_first=i == 0, which=which,
                           diff_confidence=inputs.get(RT.IN_DIFF_CONFIDENCE),
                           spec_confidence=inputs.get(RT.IN_SPEC_CONFIDENCE),
                           reprojection_confidence=ta.get("spec_reprojection_confidence"),
                           sh=cur_sh, is_last=i == iterations - 1)
            if self.sh:
                cur, cur_sh = cur
        cur = dict(zip(sigs, cur if both else (cur,)))
        cur_sh = dict(zip(sigs, cur_sh if both else (cur_sh,))) if self.sh else None

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
        outs = {}
        for name in sigs:  # the dead pass-through, SplitScreen and the state (`:345-378`)
            # the slow history after the anti-firefly pass (`denoiser.py:299-304`, `:358-362`)
            new_state[name + "_illum_prev"] = torch.where(
                keep[..., None], state[name + "_illum_prev"], slow[name])
            new_state[name + "_responsive_prev"] = torch.where(
                keep[..., None], state[name + "_responsive_prev"], hc[name + "_resp"])
            out_rt = (SH_RESOURCES if self.sh else SIGNAL_RESOURCES)[name][1]
            outs[out_rt] = K.split_screen(
                sc, view_z, raw[name], torch.where(dead[..., None], raw[name], cur[name]),
                sh_mode=self.sh)
            if self.sh:  # SH1 out, and the SH histories (`:365-372`)
                outs[SH_RESOURCES[name][3]] = torch.where(dead[..., None], raw_sh[name],
                                                          cur_sh[name])
                for kind, key in (("sh", "_sh"), ("sh_responsive", "_sh_fast")):
                    new_state[f"{name}_{kind}_prev"] = torch.where(
                        keep[..., None], state[f"{name}_{kind}_prev"], hc[name + key])
        if "spec" in sigs:
            new_state["reflection_hit_t"] = torch.where(keep, state["reflection_hit_t"],
                                                        ta["reflection_hit_t"])
        if self.enable_validation:  # viewports 0-4 and 8 only (`denoiser.py:380-389`)
            overlay = render_validation(sc, view_z, inputs[RT.IN_NORMAL_ROUGHNESS], mv, cfg,
                                        diff_accum=history_length, max_accumulated_frame_num=255.0,
                                        prev_validation=state.get("validation"))
            outs[RT.OUT_VALIDATION] = overlay
            new_state["validation"] = overlay
        return outs, requantize_state(state, new_state)
