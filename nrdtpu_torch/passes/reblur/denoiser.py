"""REBLUR pass graph for the PyTorch port - counterpart of `nrdtpu/passes/reblur/denoiser.py`.

This port runs REBLUR_DIFFUSE, REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR
(`denoiser.py:162-606`): hit-distance reconstruction (AREA_3X3 / AREA_5X5, off under
checkerboard, `:225-237`), PrePass, TemporalAccumulation, HistoryFix, Blur, PostBlur and
TemporalStabilization, with or without the anti-firefly ring of HistoryFix. With both signals
the spatial stages and HistoryFix run one fused launch for the two (`fused_spatial_filter`,
`fused_history_fix`) on the card and on the CPU alike, and TA samples both histories in one
launch; the reconstruction refills both signals in one launch. With NRDTPU_REBLUR_BAND=1 (the
JAX package's switch, off by default) HistoryFix, Blur and PostBlur of both signals run as one
band launch (`spatial_band`). Under checkerboard (`checkerboardMode` BLACK or WHITE,
`denoiser.py:169-195`) each signal input is half width: it is expanded with `cb_expand`, the
PrePass runs at any radius in its checkerboard mode (the centre weighs the pixel's has_data and
where no weight is left the kernel writes the horizontal neighbour resolve), and TA accumulates
slower on the pixels without data; the dead pass-through and SplitScreen show the expanded
input. The SH variants (REBLUR_DIFFUSE_SH, REBLUR_SPECULAR_SH, REBLUR_DIFFUSE_SPECULAR_SH)
take IN_*_SH0 in place of the radiance and IN_*_SH1 as each signal's second plane, which rides
every pass of its signal (the kernels' SH modes); OUT_*_SH0 takes the radiance's path through
TS, the dead pass-through and SplitScreen, OUT_*_SH1 passes the raw IN_*_SH1 in dead pixels
and no SplitScreen (`denoiser.py:581-589`). Under checkerboard they raise NotImplementedError:
the JAX reference passes the half-width IN_*_SH1 through its dead pixels unexpanded
(`nrdtpu/passes/reblur/denoiser.py:585-587`) and fails on frame 0, so there is nothing to hold
the port against (ROADMAP.md). The occlusion variants (REBLUR_DIFFUSE_OCCLUSION,
REBLUR_SPECULAR_OCCLUSION, REBLUR_DIFFUSE_SPECULAR_OCCLUSION, `denoiser.py:49`, `:58-60`,
`:229`) denoise IN_DIFF_HITDIST / IN_SPEC_HITDIST, the (h, w) normalized hit distance (half
width under checkerboard), into OUT_DIFF_HITDIST / OUT_SPEC_HITDIST (h, w, 1): one channel
through every pass (the kernels' one-channel modes), never a PrePass or TS, anti-firefly forced
off; under checkerboard the expanded input takes the horizontal neighbour resolve on the pixels
without data (`cb_resolve`, `:278-298`), also under the band. REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION
(`denoiser.py:45`, `:141-159`) denoises IN_DIFF_DIRECTION_HITDIST, (h, w, 4): the direction times
the normalized hit distance and the hit distance (`frontend.reblur_pack_directional_occlusion`),
into OUT_DIFF_DIRECTION_HITDIST. Its state is REBLUR_DIFFUSE's; it runs no PrePass, ever
(`:267`), and so under checkerboard no neighbour resolve either (`:278`: the expanded input
goes to TA, which accumulates slower on the pixels without data); TA, the history fix and TS
take its luma from .w and scale .xyz by the luma's change (the kernels' `kDir` modes of the
history fix and TS), its Blur and PostBlur are the radiance diffuse filter's, and anti-firefly
is forced off (`:434-435`, `:448-449`).

Every variant runs at the three roughness encodings of IN_NORMAL_ROUGHNESS. At SQRT_LINEAR and
SQ_LINEAR the frame decodes the input and the previous frame's copy once (`frontend.
decode_roughness_plane`): every reader of the roughness takes the decoded planes at LINEAR,
but, at R10G10B10A2 alone, for the centre pixel of HistoryFix, PrePass, Blur and PostBlur,
which the reference reads as packed there (`unpack_nr3`, `nrdtpu/passes/reblur/kernels.py:
37-42`): their centre geometry comes from the packed plane and their taps read the decoded one
(`tap_normal_roughness`; H2 decodes at its taps itself). The state keeps the packed input, as
the reference does (`:548-550`).

Every variant runs at the four RGBA normal encodings too (RGBA8_UNORM, RGBA8_SNORM,
RGBA16_UNORM, RGBA16_SNORM). There the reference decodes every read, the centres' too, and
tests no material (`denoiser.py:204-207`: the XLA path). The frame decodes the input and the
previous frame's copy once (`frontend.decode_normal_plane`, then `decode_roughness_plane(
decoded=True)`) and every reader, the filters' centres included, takes those planes at LINEAR
(the kernels' `kDec` modes; no `kRough` instance, no `tap_normal_roughness`). The specular TA
also takes the packed planes (`packed=`): it samples the previous normals along the virtual
motion bilinearly from the packed plane, and reads the curvature neighbours' .xy as the
reference does (`nrdtpu/passes/reblur/kernels.py:910-931`, `:1094-1097`).

State (the permanent pool; histories in bf16, the RGBA16f-history analogue):
  prev_view_z (h, w), prev_normal_roughness (h, w, 4), diff_accum / spec_accum / material_id
  (h, w); per signal s present in {diff, spec}: s_history (h, w, 4) ((h, w, 1) with
  occlusion), s_fast_history (h, w), s_luma_stab (h, w) (none with occlusion: no TS), and with
  SH s_sh_history (h, w, 4); with specular also prev_spec_hitdist_for_tracking (h, w) float32.
"""

from __future__ import annotations

import os
from dataclasses import replace

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
from ... import frontend as fe
from ... import math as nm
from . import common as C
from . import kernels as K

RT = ResourceType
OCCLUSION = (Denoiser.REBLUR_DIFFUSE_OCCLUSION, Denoiser.REBLUR_SPECULAR_OCCLUSION,
             Denoiser.REBLUR_DIFFUSE_SPECULAR_OCCLUSION)
DIRECTIONAL = Denoiser.REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION
PORTED = (Denoiser.REBLUR_DIFFUSE, Denoiser.REBLUR_SPECULAR, Denoiser.REBLUR_DIFFUSE_SPECULAR,
          Denoiser.REBLUR_DIFFUSE_SH, Denoiser.REBLUR_SPECULAR_SH,
          Denoiser.REBLUR_DIFFUSE_SPECULAR_SH) + OCCLUSION + (DIRECTIONAL,)
IN_RT = {"diff": RT.IN_DIFF_RADIANCE_HITDIST, "spec": RT.IN_SPEC_RADIANCE_HITDIST}
OUT_RT = {"diff": RT.OUT_DIFF_RADIANCE_HITDIST, "spec": RT.OUT_SPEC_RADIANCE_HITDIST}
# the occlusion variants: the normalized hit distance in and out (`denoiser.py:141-159`)
OCC_IN_RT = {"diff": RT.IN_DIFF_HITDIST, "spec": RT.IN_SPEC_HITDIST}
OCC_OUT_RT = {"diff": RT.OUT_DIFF_HITDIST, "spec": RT.OUT_SPEC_HITDIST}
# directional occlusion: (direction x normHitDist, normHitDist) in and out (`denoiser.py:141-159`)
DIR_IN_RT = {"diff": RT.IN_DIFF_DIRECTION_HITDIST}
DIR_OUT_RT = {"diff": RT.OUT_DIFF_DIRECTION_HITDIST}
# the SH variants: (SH0, SH1) of each signal (`denoiser.py:146-159`, `:181-182`, `:584`)
SH_IN_RT = {"diff": (RT.IN_DIFF_SH0, RT.IN_DIFF_SH1), "spec": (RT.IN_SPEC_SH0, RT.IN_SPEC_SH1)}
SH_OUT_RT = {"diff": (RT.OUT_DIFF_SH0, RT.OUT_DIFF_SH1),
             "spec": (RT.OUT_SPEC_SH0, RT.OUT_SPEC_SH1)}


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
        self.sh = config.denoiser.name.endswith("_SH")
        self.occlusion = config.denoiser in OCCLUSION
        self.directional = config.denoiser == DIRECTIONAL
        self.channels = 1 if self.occlusion else 4
        self.signals = tuple(sig for sig, present in (("diff", self.has_diffuse),
                                                      ("spec", self.has_specular)) if present)
        # the frame's readers of a decoded roughness plane take it at LINEAR
        self.linear_config = replace(config, roughness_encoding=RoughnessEncoding.LINEAR)
        # the RGBA normal encodings: every reader takes the planes decoded once a frame
        self.decoded = fe.decoded_normals(config.normal_encoding)
        self._s = ReblurSettings()

    def static_key(self, s: ReblurSettings):
        return (s.enablePerformanceMode, s.enableAntiFirefly, s.checkerboardMode,
                s.hitDistanceReconstructionMode, s.maxStabilizedFrameNum == 0,
                self._skip_prepass(s))

    def _skip_prepass(self, s: ReblurSettings):
        """`nrdtpu/passes/reblur/denoiser.py:58-63`: no PrePass for occlusion, else only if
        every signal's radius is 0."""
        if self.occlusion:
            return True
        radius = {"diff": s.diffusePrepassBlurRadius, "spec": s.specularPrepassBlurRadius}
        return (all(radius[sig] == 0.0 for sig in self.signals)
                and s.checkerboardMode == CheckerboardMode.OFF)

    def specialize(self, s: ReblurSettings):
        if self.sh and s.checkerboardMode != CheckerboardMode.OFF:
            raise NotImplementedError(
                f"{self.config.denoiser.name} with checkerboard is not ported: the JAX "
                "reference passes the half-width IN_*_SH1 through its dead pixels unexpanded "
                "(nrdtpu/passes/reblur/denoiser.py:585-587) and fails on frame 0, so there is "
                "nothing to hold the port against (ROADMAP.md)")
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
            state[f"{sig}_history"] = torch.zeros((h, w, self.channels), dtype=bf16, **kw)
            state[f"{sig}_fast_history"] = torch.zeros((h, w), dtype=bf16, **kw)
            if not self.occlusion:  # no TS
                state[f"{sig}_luma_stab"] = torch.zeros((h, w), dtype=bf16, **kw)
            if self.sh:
                state[f"{sig}_sh_history"] = torch.zeros((h, w, 4), dtype=bf16, **kw)
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
        # IN_NORMAL_ROUGHNESS as packed: the state reads it, and at R10G10B10A2 the filters'
        # centre geometry (`unpack_nr3`), with `fcfg`; every other reader takes `nr` / `prev_nr`,
        # decoded once a frame, with `lin` (the config at LINEAR); the filters' taps read
        # `taps_nr`. At the RGBA formats `nr` / `prev_nr` are the decoded planes, which every
        # reader takes, the filters' centres too (`centre_nr`), and the specular TA also
        # samples the packed planes (`packed`)
        normal_roughness = inputs[RT.IN_NORMAL_ROUGHNESS]
        lin = self.linear_config
        if self.decoded:
            nr, prev_nr = (fe.decode_roughness_plane(
                fe.decode_normal_plane(p, cfg.normal_encoding), cfg.roughness_encoding,
                decoded=True) for p in (normal_roughness, state["prev_normal_roughness"]))
            centre_nr, taps_nr, fcfg = nr, None, lin
            packed = (normal_roughness, state["prev_normal_roughness"])
        else:
            nr = fe.decode_roughness_plane(normal_roughness, cfg.roughness_encoding)
            prev_nr = fe.decode_roughness_plane(state["prev_normal_roughness"],
                                                cfg.roughness_encoding)
            centre_nr, fcfg, packed = normal_roughness, cfg, None
            taps_nr = None if nr is normal_roughness else nr
        mv = inputs[RT.IN_MV]
        h, w = view_z.shape
        # checkerboard: half-width inputs expanded to full width (`denoiser.py:169-176`), the
        # has-data parity of the mode, and the pixels with data this frame (`:189-195`)
        cb = (None if s.checkerboardMode == CheckerboardMode.OFF
              else int(s.checkerboardMode) - 1)
        in_rt = {sig: SH_IN_RT[sig][0] if self.sh else OCC_IN_RT[sig] if self.occlusion
                 else DIR_IN_RT[sig] if self.directional else IN_RT[sig]
                 for sig in self.signals}
        # the occlusion variants' (h, w) input gains its channel (`denoiser.py:173-176`)
        given = {sig: inputs[in_rt[sig]][..., None] if self.occlusion else inputs[in_rt[sig]]
                 for sig in self.signals}
        raw_in = {sig: given[sig] if cb is None else C.cb_expand(given[sig], w)
                  for sig in self.signals}
        # the SH variants' SH1 of each signal, none without SH (no checkerboard: `specialize`
        # raises)
        sh = {sig: inputs[SH_IN_RT[sig][1]] for sig in self.signals} if self.sh else {}
        has_data = (None if cb is None else nm.checkerboard_has_data(
            h, w, sc["frame_index"], cb + 1, view_z.device))
        perf = s.enablePerformanceMode
        skip_prepass = self._skip_prepass(s)
        # both signals: the spatial stages and HistoryFix run fused (denoiser.py:245-246)
        fused = self.has_diffuse and self.has_specular
        # anti-firefly: forced off for occlusion (`denoiser.py:416-418`, `:434-438`, `:448`) and
        # for directional occlusion (`:434-435`, `:448-449`)
        anti_firefly = {sig: s.enableAntiFirefly and not self.occlusion and not self.directional
                        for sig in self.signals}

        tile_map = K.classify_tiles(sc, view_z)
        dead = K.sky_pixel_mask(sc, tile_map, view_z)
        geom = K.make_filter_geometry(sc, dc, view_z, centre_nr, fcfg) if fused else None

        # HITDIST_RECONSTRUCTION: off under checkerboard (`denoiser.py:225-237`)
        signal = dict(raw_in)
        if (s.hitDistanceReconstructionMode != HitDistanceReconstructionMode.OFF
                and s.checkerboardMode == CheckerboardMode.OFF):
            radius = (2 if s.hitDistanceReconstructionMode
                      == HitDistanceReconstructionMode.AREA_5X5 else 1)
            signal["diff"], signal["spec"] = K.hit_dist_reconstruction(
                sc, dc, view_z, nr, signal.get("diff"), signal.get("spec"), lin, radius=radius)
            signal = {sig: signal[sig] for sig in self.signals}

        # PREPASS (always under checkerboard, `_skip_prepass`; never for directional occlusion,
        # `denoiser.py:267`)
        hdt_prepass = None
        sh1 = dict(sh)
        if not skip_prepass and not self.directional:
            if fused:
                res = K.fused_spatial_filter(
                    sc, dc, K.PRE_BLUR, geom, view_z, centre_nr, signal["diff"],
                    signal["spec"], perf_mode=perf, cb=cb,
                    sh=(sh["diff"], sh["spec"]) if self.sh else None,
                    tap_normal_roughness=taps_nr)
                signal["diff"], signal["spec"], hdt_prepass = res[:3]
                if self.sh:
                    sh1["diff"], sh1["spec"] = res[3]
            elif self.has_specular:
                res = K.specular_spatial_filter(
                    sc, dc, K.PRE_BLUR, signal["spec"], view_z, centre_nr, None, fcfg,
                    perf_mode=perf, cb=cb, sh=sh.get("spec"))
                signal["spec"], hdt_prepass = res[:2]
                if self.sh:
                    sh1["spec"] = res[2]
            else:
                res = K.diffuse_pre_pass(sc, dc, signal["diff"], view_z, centre_nr, fcfg,
                                         perf_mode=perf, cb=cb, sh=sh.get("diff"))
                if self.sh:
                    signal["diff"], sh1["diff"] = res
                else:
                    signal["diff"] = res

        # the occlusion variants under checkerboard: no PrePass, so the neighbour resolve fills
        # the pixels without data (`denoiser.py:278-298`)
        if cb is not None and self.occlusion:
            signal = K.cb_resolve(sc, view_z, centre_nr, signal, has_data, self.decoded)

        # TEMPORAL ACCUMULATION: one surface-motion footprint, both signals' samples
        prev_internal = {k: state[k] for k in ("diff_accum", "spec_accum", "material_id")}
        sm = K.surface_motion_reprojection(
            sc, dc, view_z, nr, mv, state["prev_view_z"], prev_nr, prev_internal, lin,
            {sig: (state[f"{sig}_history"], state[f"{sig}_fast_history"])
             for sig in self.signals},
            disocclusion_threshold_mix=inputs.get(RT.IN_DISOCCLUSION_THRESHOLD_MIX),
            sh_histories={sig: state[f"{sig}_sh_history"] for sig in self.signals}
            if self.sh else None)
        fbits = sm["fbits"]
        sig1, fast1, data1, sh2 = {}, {}, {}, {}
        ta = None
        if self.has_diffuse:
            res = K.temporal_accumulation_diffuse(
                sc, dc, sm, signal["diff"], inputs.get(RT.IN_DIFF_CONFIDENCE), has_data,
                sh_input=sh1.get("diff"), occlusion=self.occlusion, directional=self.directional)
            sig1["diff"], fast1["diff"], data1["diff"] = res[:3]
            if self.sh:
                sh2["diff"] = res[3]
        if self.has_specular:
            ta = K.temporal_accumulation_specular(
                sc, dc, sm, signal["spec"], state["spec_history"], state["spec_fast_history"],
                view_z, nr, state["prev_view_z"], prev_nr, prev_internal,
                C.extract_hit_dist(signal["spec"]) if skip_prepass else hdt_prepass,
                state["prev_spec_hitdist_for_tracking"], cfg if self.decoded else lin,
                inputs.get(RT.IN_SPEC_CONFIDENCE), has_prepass_hitdist=not skip_prepass,
                has_data=has_data, sh_input=sh1.get("spec"),
                sh_history=state.get("spec_sh_history"), occlusion=self.occlusion, packed=packed)
            sig1["spec"], fast1["spec"], data1["spec"] = ta["spec"], ta["fast"], ta["accum_speed"]
            if self.sh:
                sh2["spec"] = ta["sh"]
            fbits = fbits + ta["fbits_vmb"]
        material_id = sm["material_id"]
        del sm  # its full-resolution planes are dead after TA: free them for the later passes

        # HISTORY FIX, BLUR, POST BLUR: with both signals, in one band launch under
        # NRDTPU_REBLUR_BAND=1 (`denoiser.py:403-428`), else three launches
        sig4, fast2, sh4 = {}, {}, {}
        if fused:
            band = os.environ.get("NRDTPU_REBLUR_BAND", "0") == "1"
            res = (K.spatial_band if band else K.spatial_chain)(
                sc, dc, geom, view_z, centre_nr,
                (sig1["diff"], data1["diff"], fast1["diff"]),
                (sig1["spec"], data1["spec"], fast1["spec"]),
                anti_firefly=(anti_firefly["diff"], anti_firefly["spec"]), perf_mode=perf,
                sh=(sh2["diff"], sh2["spec"]) if self.sh else None, tap_normal_roughness=taps_nr)
            (sig4["diff"], fast2["diff"]), (sig4["spec"], fast2["spec"]) = res[:2]
            if self.sh:
                sh4["diff"], sh4["spec"] = res[2]
        else:
            (sig,) = self.signals
            spec_path = sig == "spec"
            res = K.history_fix(
                sc, dc, view_z, centre_nr, data1[sig], sig1[sig], fast1[sig], fcfg,
                is_diffuse=not spec_path, anti_firefly=anti_firefly[sig], sh=sh2.get(sig),
                directional=self.directional, tap_normal_roughness=taps_nr)
            sig2, fast2[sig], tap_geometry = res[:3]
            sh3 = res[3] if self.sh else None
            # Blur and PostBlur read the tap geometry that the history fix wrote
            kw = dict(perf_mode=perf, tap_geometry=tap_geometry)
            sig3 = sig2
            for stage in (K.BLUR, K.POST_BLUR):
                if spec_path:
                    res = K.specular_spatial_filter(sc, dc, stage, sig3, view_z, centre_nr,
                                                    data1[sig], fcfg, sh=sh3, **kw)
                    sig3, sh3 = res[0], res[2] if self.sh else None
                else:
                    res = K.diffuse_spatial_filter(sc, dc, stage, sig3, view_z, centre_nr,
                                                   data1[sig], fcfg, sh=sh3, **kw)
                    sig3, sh3 = res if self.sh else (res, None)
            sig4[sig] = sig3
            if self.sh:
                sh4[sig] = sh3
            del tap_geometry
        del geom

        new_state = dict(state)
        keep = dead
        outs = {}
        # TEMPORAL STABILIZATION or direct output; never TS for occlusion (`denoiser.py:229`)
        if self.occlusion or s.maxStabilizedFrameNum == 0:
            out_sig = dict(sig4)
            out_sh = dict(sh4)
            inc = {sig: data1[sig] + 1.0 for sig in self.signals}
        else:
            ts_sm = K.ts_surface_motion(sc, view_z, mv)
            ts = {}
            if self.has_diffuse:
                ts["diff"] = K.temporal_stabilization(
                    sc, dc, view_z, nr, mv, data1["diff"], fbits, sig4["diff"],
                    state["diff_luma_stab"], lin, surface_motion=ts_sm, sh=sh4.get("diff"),
                    directional=self.directional)
            if self.has_specular:
                ts["spec"] = K.temporal_stabilization_specular(
                    sc, dc, view_z, nr, mv, data1["spec"], fbits, ta["curvature"],
                    ta["virtual_history_amount"], sig4["spec"], state["spec_luma_stab"],
                    ta["hit_dist_for_tracking"], inputs.get(RT.IN_BASECOLOR_METALNESS), lin,
                    has_prepass=not skip_prepass, surface_motion=ts_sm, sh=sh4.get("spec"))
                if RT.IN_BASECOLOR_METALNESS in inputs:
                    outs[RT.IN_MV] = ts["spec"]["mv_out"]  # patched MV, as the reference writes it
            out_sig = {sig: ts[sig][sig] for sig in self.signals}
            out_sh = {sig: ts[sig][f"{sig}_sh"] for sig in self.signals} if self.sh else {}
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
            out_rt = (SH_OUT_RT[sig][0] if self.sh else OCC_OUT_RT[sig] if self.occlusion
                      else DIR_OUT_RT[sig] if self.directional else OUT_RT[sig])
            outs[out_rt] = K.split_screen(sc, raw_in[sig], view_z, out)
            # history for the next frame = PostBlur output (PostBlur writes the history)
            new_state[f"{sig}_history"] = torch.where(keep[..., None], state[f"{sig}_history"],
                                                      sig4[sig])
            new_state[f"{sig}_fast_history"] = torch.where(keep, state[f"{sig}_fast_history"],
                                                           fast2[sig])
            if self.sh:  # SH1: the raw input in dead pixels, no SplitScreen (`:581-589`)
                outs[SH_OUT_RT[sig][1]] = torch.where(dead[..., None], sh[sig], out_sh[sig])
                new_state[f"{sig}_sh_history"] = torch.where(
                    keep[..., None], state[f"{sig}_sh_history"], sh4[sig])
        return outs, requantize_state(state, new_state)
