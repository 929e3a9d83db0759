#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py   # the REBLUR, SIGMA and RELAX paths of PATHS, 2560x1440

Paths: REBLUR_DIFFUSE, REBLUR_SPECULAR, REBLUR_DIFFUSE_SPECULAR on the orbit scene;
REBLUR_DIFFUSE_SPECULAR with NRDTPU_REBLUR_BAND=1 set for its engines only (HistoryFix, Blur and
PostBlur in one band launch); REBLUR_DIFFUSE_SPECULAR with hitDistanceReconstructionMode
AREA_3X3 on the same frames with
holes punched into the hit distance (.w = 0 on a seeded 30 % of the geometry pixels, as a
renderer that traces some pixels and not others sends them); SIGMA_SHADOW and
SIGMA_SHADOW_TRANSLUCENCY with the penumbra packed from the scene's distance to the occluder;
RELAX_DIFFUSE, RELAX_SPECULAR and RELAX_DIFFUSE_SPECULAR with the radiance and the raw hit
distance packed by `relax_pack_radiance_hitdist`, and RELAX_SPECULAR with
`enableAntiFirefly=True` on the same frames (the anti-firefly pass, off by default, on a main
path of its own); RELAX_DIFFUSE_SH, RELAX_SPECULAR_SH and RELAX_DIFFUSE_SPECULAR_SH with each
signal's SH0 / SH1 packed by `relax_pack_sh` from the same radiance and raw hit distance along
the scene's normal (the SH planes ride the non-SH variant's launches); REBLUR_DIFFUSE_SH,
REBLUR_SPECULAR_SH and REBLUR_DIFFUSE_SPECULAR_SH (also with NRDTPU_REBLUR_BAND=1) with each
signal's SH0 / SH1 packed by `reblur_pack_sh` from the same radiance and normalized hit
distance along the scene's normal (the SH planes ride the REBLUR kernels' SH modes in the
non-SH variant's launches); REBLUR_DIFFUSE_OCCLUSION, REBLUR_SPECULAR_OCCLUSION and
REBLUR_DIFFUSE_SPECULAR_OCCLUSION (also with NRDTPU_REBLUR_BAND=1) on a binary one-sample AO
estimate a signal (the scene's `ao_noisy`, and a second draw from the clean AO for the specular
signal), one channel through the kernels' one-channel modes; and under checkerboard,
with each signal input at half width (the has-data pixel of each horizontal pair, as a
renderer that traces half the pixels sends it): REBLUR_DIFFUSE_SPECULAR in BLACK (also with
NRDTPU_REBLUR_BAND=1), REBLUR_DIFFUSE in WHITE, REBLUR_SPECULAR in BLACK and
RELAX_DIFFUSE_SPECULAR in BLACK (`CB_PATHS`); REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION on the
scene's binary AO with the surface normal as the direction (`reblur_pack_directional_occlusion`;
the history fix and TS in their directional modes); REBLUR_DIFFUSE_SPECULAR in performance
mode (`+PERF`: N4's 6-tap instances); and REBLUR_SPECULAR at SQ_LINEAR and
REBLUR_DIFFUSE_SPECULAR at SQRT_LINEAR roughness (IN_NORMAL_ROUGHNESS packed with the encoding:
the denoiser decodes it once a frame, and H2's specular instances decode at their taps, counted
apart as `spatial_filter_rough`); and at the RGBA normal encodings (`NORMAL_ENCODED`):
RELAX_DIFFUSE_SPECULAR at RGBA8_UNORM with AREA_3X3 on frames with hit-distance holes and at
RGBA16_SNORM with the anti-firefly pass, RELAX_SPECULAR_SH at RGBA8_SNORM and
SIGMA_SHADOW_TRANSLUCENCY at RGBA8_UNORM, IN_NORMAL_ROUGHNESS packed with
`pack_normal_roughness(..., quantized=True)` at the encoding (the SNORM ones with the sky's
normal (0, 0, 1): with the scene's own sky normal of 0 RELAX's specular TA divides 0 by 0 there,
in the port as in the JAX reference, `snorm_sky_fault`), and REBLUR_DIFFUSE_SPECULAR at
RGBA8_UNORM and at RGBA16_SNORM, REBLUR_DIFFUSE_SPECULAR_SH at RGBA8_SNORM and
REBLUR_DIFFUSE_SPECULAR_OCCLUSION with AREA_3X3 on AO frames with holes at RGBA16_UNORM (the
specular TA's previous normals bilinear from the packed previous plane, `bilinear_resolve`, in
place of nearest_multi's stochastic fetch), REBLUR_DIFFUSE at RGBA16_UNORM, REBLUR_SPECULAR at
RGBA8_SNORM and REBLUR_DIFFUSE_SPECULAR with NRDTPU_REBLUR_BAND=1 at RGBA8_SNORM (H2's, H3's and
K23's decoded instances); the denoisers decode it once a frame and the kernels
read it in their decoded modes (`kDec`), counted apart as `<kernel>_dec`
(`kernels.DEC_INSTANCES`).

Phases, each of which raises on failure (exit code != 0):
  1. build the hand-written kernels from `nrdtpu_torch/kernels/csrc/` with nvcc, one process
     per source, all started together;
  2. per REBLUR variant: run 3 frames of the orbit scene through `Engine(device="cuda")`,
     record every kernel call of frame 4, and hold each kernel against its plain PyTorch
     version on the same inputs on the card (N4 `spatial_filter_fused` and H2
     `spatial_filter` by stage: PrePass, Blur, PostBlur); time both, and compute each
     call's bound (compulsory bytes over the card's memory rate, or operations over its
     float32 rate); read each device kernel's
     registers and spills from the build log's ptxas lines, work out its CTAs an SM, and
     count its SASS instructions (`cuobjdump -sass` of the library; null where the toolkit
     has no cuobjdump). An entry that launches several device kernels (N5, K23) lists each.
     The same again with `enableAntiFirefly=True` (the anti-firefly ring of history_fix and
     history_fix_fused), REBLUR_DIFFUSE_SPECULAR in performance mode (N4 only, held, not
     timed), REBLUR_DIFFUSE and REBLUR_SPECULAR in performance mode and with both min
     materials 0 and REBLUR_SPECULAR with usePrepassOnlyForSpecularMotionEstimation (H2 only,
     held), and with hit-distance reconstruction at radius 1 and 2 on the
     punched frames (hitdist_recon only); then each SIGMA variant (K13 `sigma_blur` by
     pass, Blur and PostBlur: with the variant, its four modes); then RELAX_DIFFUSE,
     RELAX_SPECULAR and RELAX_DIFFUSE_SPECULAR (every kernel of each, all five à-trous calls,
     the last one's K16, K19, K20 and K22 in their two-signal modes; the share of pixels that
     run K19 `relax_history_fix`'s taps is printed), each with
     `enableAntiFirefly=True` (relax_antifirefly timed, the rest held only), each with
     AREA_3X3 on RELAX-packed punched frames (hitdist_recon on RELAX's constants, not
     timed) and each with the history clamp's colour box off (relax_clamp_moments, held);
     then the three RELAX SH variants (every kernel of each in its SH mode, timed by path
     beside the non-SH variant's); the three REBLUR SH variants (every kernel of each in its
     SH mode, timed by path), each with the anti-firefly ring (the history fixes, held), in
     performance mode (the spatial filters, held), REBLUR_DIFFUSE_SPECULAR_SH with AREA_3X3 on
     the punched frames (every kernel, held), and the band in its SH mode (default, with the
     ring and in performance mode, each beside the chain it replaces);
     the three REBLUR occlusion variants (every kernel of each in its one-channel mode, timed
     by path), REBLUR_DIFFUSE_SPECULAR_OCCLUSION with AREA_3X3 on AO frames with holes (a
     seeded 30 % of the geometry pixels zeroed; hitdist_recon's one-channel mode, timed) and
     the band's one-channel mode with the band's runs;
     the checkerboard PrePass of H2 (REBLUR_DIFFUSE in WHITE and BLACK, REBLUR_SPECULAR in
     BLACK and WHITE) and N4 (REBLUR_DIFFUSE_SPECULAR in BLACK and WHITE) on the half-width
     frames, one run of each kernel on frames whose fallback fires (`CB_FALLBACK`: a material
     drawn per pixel, both min materials 0 and minBlurRadius 3; and
     usePrepassOnlyForSpecularMotionEstimation), timed and listed apart from the kernel's other
     modes as `spatial_filter_cb` and `spatial_filter_fused_cb`, with the share of pixels that
     fall back;
     REBLUR_DIFFUSE and REBLUR_DIFFUSE_SPECULAR with maxBlurRadius 0 (ts_prelude in each TS
     half without the RCRS clamp, held); then RELAX_SPECULAR with IN_NORMAL_ROUGHNESS packed
     as SQ_LINEAR and as
     SQRT_LINEAR, AREA_3X3 on the punched frames (`ENCODED`: K15, K19, K22 and K12 in each
     roughness mode, timed); REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (every kernel, timed: H3 and
     H4 in their `kDir` modes) and with AREA_3X3 on AO frames with holes (held); REBLUR_SPECULAR
     and REBLUR_DIFFUSE_SPECULAR at SQ_LINEAR and SQRT_LINEAR (every kernel held, H2's `kRough`
     instances timed on REBLUR_SPECULAR, `spatial_filter_rough`); the decoded-plane instances
     of K12, K13, K15, K16, K17, K19, K21 and K22 on NORMAL_ENCODED's paths (timed) and on
     `DEC_RUNS` (SIGMA_SHADOW, RELAX_DIFFUSE, RELAX_SPECULAR, RELAX_DIFFUSE_SH and
     RELAX_DIFFUSE_SPECULAR_SH at an RGBA encoding each, held), each recorded call of K12,
     K15, K19 and K22 also held at the two other roughness encodings and K12's at the other
     radius and on each signal alone (`dec_variants`), so that every kDec instance is held,
     listed apart as `<kernel>_dec`; the same for REBLUR's kDec instances (H1, N1, N3, H2, H3,
     H4, N4, N5, K23 and K12's one-channel ones) on NORMAL_ENCODED's seven REBLUR paths (timed)
     and on DEC_RUNS' REBLUR runs (every variant, checkerboard, the band, held), each call of
     H2, N4 and K23 also held at the other tap count (`dec_variants`); then the band of
     REBLUR_DIFFUSE_SPECULAR+BAND, by default, with the anti-firefly ring and in performance mode, each timed beside the
     three-launch chain it replaces (the history fix, its clamp, the Blur and PostBlur
     parameters and two spatial-filter launches, glue included) on the same inputs; then the
     halo launcher (its `box` body on 1 and 4 channels, halo 4, blocks 64x256 and 16x16, at the
     slice's size). Every kernel
     module but `halo_call` must be called by one of the paths, and `halo_call`, which no
     path calls (as in the JAX package), by the halo phase;
  3. slices: for each path a fresh `Engine(device="cuda")` runs 3 warm-up + 24 frames with
     the launch counts set to 0 just before and read just after; every output must be
     finite and every kernel of the path launched exactly its count a frame (the checkerboard
     PrePass instances and H2's `kRough` instances counted apart); each REBLUR
     and RELAX output (SH0 taken from YCoCg to linear; REBLUR's with `sg_extract_color`)
     must beat its noisy input by >= 3 dB
     against the scene's clean image, each occlusion output must lie in [0, 1] and, on the last
     frame, lie closer to the scene's clean AO on the geometry (mean absolute error) than its
     binary input (directional occlusion: its .w), each SIGMA
     output must lie in [0, 1], be lit on average (> 0.99) where the 9x9 neighbourhood is lit
     and dark (< 0.15) in the umbra core; prints the median ms/frame (CUDA events), the host
     ms/frame and the peak allocator bytes;
  3b. dynamic resolution (`rect_phase`): REBLUR_DIFFUSE_SPECULAR, RELAX_DIFFUSE_SPECULAR and
     SIGMA_SHADOW_TRANSLUCENCY sliced at a rect of 3/4 of the resource (1920x1080 in 2560x1440;
     each frame downsampled by nearest texel into the top-left of NaN resource planes, outputs
     0 outside the rect), the device time a frame of those cells, of their full-rect cells
     and of the performance-mode path (torch.profiler, also without `--profile`; with it, the
     full-rect cells' traces are those of `--profile`), and each of `RECT_HELD`'s paths through
     the rects 2560x1440, 1920x1080, 1707x960, 2560x1440 (two frames each, the state migrated
     at each change) with every card call held on its own against its plain version
     (`held_calls`, `check_held`);
  4. lit scene: both SIGMA variants on a scene without occluders at 256x160 keep every lit
     pixel above 0.99; RELAX pair: RELAX_DIFFUSE_SPECULAR's two outputs on the card hold to
     RELAX_DIFFUSE's and RELAX_SPECULAR's on the card on every frame of the slices (the JAX
     package gives them bit for bit), within the kernels' tolerance, and
     RELAX_DIFFUSE_SPECULAR_SH's four outputs to RELAX_DIFFUSE_SH's and RELAX_SPECULAR_SH's
     exactly (max abs 0);
  5. card vs CPU: the same 3 frames at 256x160 on the card and on the CPU plain path must
     agree to >= 50 dB PSNR, for every output of every path (the checkerboard ones included),
     of RELAX_SPECULAR at SQ_LINEAR
     (AREA_3X3 on the punched frames), of REBLUR_DIFFUSE_SPECULAR_OCCLUSION under checkerboard
     BLACK (`OCC_CB`), of REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION under checkerboard BLACK and with
     AREA_3X3 on the AO with holes (`DIR_EXTRA`), of REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR
     at both encodings, and of REFERENCE on a static camera (plain torch ops on both, no
     kernel); the rect sequence 256x160, 200x121, 171x107, 256x160 (a frame a rect) of the
     three rect paths on both, every card call held on its own (`rect_card_vs_cpu`); and
     RELAX_SPECULAR at RGBA8_SNORM on the
     scene's own sky normal of 0 on both, with the non-finite values each gives printed
     (`snorm_sky_fault`, no bar on the reference's fault), every card call held against its
     plain version there: K16 `relax_smb_resolve`, K17 `relax_vmb_resolve`, K20
     `relax_clamp_moments` and K22 `relax_atrous` must give non-finite values exactly where their
     plain versions do.

With `--profile` it also traces 3 frames of each path (after 4 warm-up) with
torch.profiler and prints the device time a frame, the device's idle share against the
slice's median ms/frame, the device time by kernel, and on the RELAX paths the share of
pixels that run the history fix's taps on each traced frame.

It prints the card's name and power limit, one JSON line of per-kernel results, and as its
last line `{"ok": true, "device": {...}}`. It imports torch, numpy and nrdtpu_torch only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import inspect
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

NRD_WORKING_SET_MB = 135.06  # NRD REBLUR_DIFFUSE at 1440p (BASELINE.md:22)
# the card's peaks (NVIDIA H100 SXM data sheet): device memory rate and float32 rate outside
# the tensor cores; the kernels do float32 arithmetic on gathered texels
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# kernel vs plain version on the card: |a - b| <= ATOL + RTOL |b| on all but a fraction
# FLIP_FRACTION of values. Both sides run the same float32 op order (nvcc --fmad=false);
# what remains is last-bit differences of exp/rsqrt/division between the kernel and
# PyTorch's CUDA ops, which can flip a step function (plane-distance test, floor snap) at a
# rare pixel that sits on its threshold.
ATOL, RTOL, FLIP_FRACTION = 1e-4, 1e-4, 1e-4
P = "nrdtpu/kernels/reblur_pallas.py"
F = "nrdtpu/kernels/reblur_fused.py"
SP = "nrdtpu/kernels/sigma_pallas.py"
RP = "nrdtpu/kernels/relax_pallas.py"
# kernel: (source, TPU kernel it replaces, the other TPU kernels it also replaces: another
# computation fused into it, or the v1 kernel that `nrdtpu/kernels/__init__.py` selects in its
# place for the same pass under NRDTPU_BLUR=1)
SOURCES = {
    "smb_resolve": ("nrdtpu_torch/kernels/csrc/smb_resolve.cu", f"{P}:577", None),
    "spatial_filter": ("nrdtpu_torch/kernels/csrc/spatial_filter.cu",
                       "nrdtpu/kernels/reblur_blur2.py:264", f"{P}:1207"),
    "history_fix": ("nrdtpu_torch/kernels/csrc/history_fix.cu",
                    "nrdtpu/kernels/reblur_hfix2.py:222", f"{P}:1446"),
    "ts_prelude": ("nrdtpu_torch/kernels/csrc/ts_prelude.cu", f"{P}:1754", f"{P}:1705"),
    "spec_ta_head": ("nrdtpu_torch/kernels/csrc/spec_ta_head.cu", f"{P}:942",
                     f"{P}:882, {P}:847, {P}:171"),
    "nearest_multi": ("nrdtpu_torch/kernels/csrc/nearest_multi.cu", f"{P}:219", None),
    "vmb_resolve": ("nrdtpu_torch/kernels/csrc/vmb_resolve.cu", f"{P}:779", None),
    "spatial_filter_fused": ("nrdtpu_torch/kernels/csrc/spatial_filter_fused.cu", f"{F}:787",
                             None),
    "history_fix_fused": ("nrdtpu_torch/kernels/csrc/history_fix_fused.cu", f"{F}:668", None),
    "hitdist_recon": ("nrdtpu_torch/kernels/csrc/hitdist_recon.cu", f"{P}:1596", None),
    "sigma_blur": ("nrdtpu_torch/kernels/csrc/sigma_blur.cu",
                   "nrdtpu/kernels/sigma_blur2.py:281", f"{SP}:291"),
    "sigma_ts": ("nrdtpu_torch/kernels/csrc/sigma_ts.cu", f"{SP}:449", None),
    "relax_prepass": ("nrdtpu_torch/kernels/csrc/relax_prepass.cu", f"{RP}:751", None),
    "relax_smb_resolve": ("nrdtpu_torch/kernels/csrc/relax_smb_resolve.cu", f"{RP}:1000", None),
    "relax_history_fix": ("nrdtpu_torch/kernels/csrc/relax_history_fix.cu", f"{RP}:1499", None),
    "relax_clamp_moments": ("nrdtpu_torch/kernels/csrc/relax_clamp_moments.cu", f"{RP}:479",
                            None),
    "relax_atrous": ("nrdtpu_torch/kernels/csrc/relax_atrous.cu", f"{RP}:338", None),
    "relax_vmb_resolve": ("nrdtpu_torch/kernels/csrc/relax_vmb_resolve.cu", f"{RP}:1219", None),
    "relax_antifirefly": ("nrdtpu_torch/kernels/csrc/relax_antifirefly.cu", f"{RP}:537", None),
    "bilinear_resolve": ("nrdtpu_torch/kernels/csrc/bilinear_resolve.cu", f"{P}:1813", None),
    "reblur_band": ("nrdtpu_torch/kernels/csrc/reblur_band.cu",
                    "nrdtpu/kernels/reblur_band.py:496", None),
    "halo_call": ("nrdtpu_torch/kernels/csrc/halo.cu", "nrdtpu/kernels/halo.py:30", None),
    # the checkerboard PrePass instances of H2 and N4 (their `has_cb` modes), listed apart
    "spatial_filter_cb": ("nrdtpu_torch/kernels/csrc/spatial_filter.cu",
                          "nrdtpu/kernels/reblur_blur2.py:270", f"{P}:1207"),
    "spatial_filter_fused_cb": ("nrdtpu_torch/kernels/csrc/spatial_filter_fused.cu",
                                f"{F}:796", f"{F}:153"),
    # H2's specular instances that decode the taps' roughness (the v1 kernel's `rough_sq`
    # mode; the v2 kernel takes a roughness plane the glue decoded), listed apart
    "spatial_filter_rough": ("nrdtpu_torch/kernels/csrc/spatial_filter.cu", f"{P}:1224",
                             "nrdtpu/kernels/reblur_blur2.py:303"),
    # the decoded-plane instances (`kDec`) of the RGBA normal encodings, listed apart: the
    # RELAX kernels' mat_occ=False modes (which the TPU path leaves to XLA at these encodings,
    # nrdtpu/passes/relax/denoiser.py:245-247), K12 and K13 on the decoded plane (the XLA
    # functions nrdtpu/passes/reblur/kernels.py:2212 and nrdtpu/passes/sigma/kernels.py:133:
    # the TPU kernels read the packed plane at every encoding)
    "relax_prepass_dec": ("nrdtpu_torch/kernels/csrc/relax_prepass.cu", f"{RP}:759", None),
    "relax_smb_resolve_dec": ("nrdtpu_torch/kernels/csrc/relax_smb_resolve.cu", f"{RP}:1011",
                              None),
    "relax_vmb_resolve_dec": ("nrdtpu_torch/kernels/csrc/relax_vmb_resolve.cu", f"{RP}:1228",
                              None),
    "relax_history_fix_dec": ("nrdtpu_torch/kernels/csrc/relax_history_fix.cu", f"{RP}:1506",
                              None),
    "relax_antifirefly_dec": ("nrdtpu_torch/kernels/csrc/relax_antifirefly.cu", f"{RP}:540",
                              None),
    "relax_atrous_dec": ("nrdtpu_torch/kernels/csrc/relax_atrous.cu", f"{RP}:352", None),
    "hitdist_recon_dec": ("nrdtpu_torch/kernels/csrc/hitdist_recon.cu", f"{P}:1596",
                          "nrdtpu/passes/reblur/kernels.py:2212"),
    "sigma_blur_dec": ("nrdtpu_torch/kernels/csrc/sigma_blur.cu",
                       "nrdtpu/kernels/sigma_blur2.py:281", "nrdtpu/passes/sigma/kernels.py:133"),
    # REBLUR's kDec instances: the TPU kernels' mat_occ=False modes (which the TPU path leaves
    # to XLA at these encodings, nrdtpu/passes/reblur/denoiser.py:204-207); N1 and H4 read the
    # roughness from .w (the XLA functions nrdtpu/passes/reblur/kernels.py:1017, :2314)
    "smb_resolve_dec": ("nrdtpu_torch/kernels/csrc/smb_resolve.cu", f"{P}:603", None),
    "spec_ta_head_dec": ("nrdtpu_torch/kernels/csrc/spec_ta_head.cu", f"{P}:942",
                         "nrdtpu/passes/reblur/kernels.py:1017"),
    "vmb_resolve_dec": ("nrdtpu_torch/kernels/csrc/vmb_resolve.cu", f"{P}:798", None),
    "spatial_filter_dec": ("nrdtpu_torch/kernels/csrc/spatial_filter.cu", f"{P}:1223",
                           "nrdtpu/kernels/reblur_blur2.py:264"),
    "history_fix_dec": ("nrdtpu_torch/kernels/csrc/history_fix.cu", f"{P}:1459",
                        "nrdtpu/kernels/reblur_hfix2.py:222"),
    "ts_prelude_dec": ("nrdtpu_torch/kernels/csrc/ts_prelude.cu", f"{P}:1754",
                       "nrdtpu/passes/reblur/kernels.py:2314"),
    "spatial_filter_fused_dec": ("nrdtpu_torch/kernels/csrc/spatial_filter_fused.cu", f"{F}:161",
                                 None),
    "history_fix_fused_dec": ("nrdtpu_torch/kernels/csrc/history_fix_fused.cu", f"{F}:389",
                              None),
    "reblur_band_dec": ("nrdtpu_torch/kernels/csrc/reblur_band.cu",
                        "nrdtpu/kernels/reblur_band.py:203", "nrdtpu/kernels/reblur_band.py:299"),
}
# the kernels that no main path launches (as in the JAX package); a phase of their own
# holds them
NO_MAIN_PATH = ("halo_call",)
D_LAUNCHES = {"smb_resolve": 1, "spatial_filter": 3, "history_fix": 1, "ts_prelude": 1}
S_LAUNCHES = {**D_LAUNCHES, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1}
DS_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
               "spatial_filter_fused": 3, "history_fix_fused": 1, "ts_prelude": 2}
# the occlusion variants: no PrePass, no TS
D_OCC_LAUNCHES = {"smb_resolve": 1, "history_fix": 1, "spatial_filter": 2}
S_OCC_LAUNCHES = {**D_OCC_LAUNCHES, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1}
DS_OCC_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
                   "history_fix_fused": 1, "spatial_filter_fused": 2}
BAND_OCC_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
                     "reblur_band": 1}
BAND_LAUNCHES = {"smb_resolve": 1, "spec_ta_head": 1, "nearest_multi": 1, "vmb_resolve": 1,
                 "spatial_filter_fused": 1, "reblur_band": 1, "ts_prelude": 2}
# directional occlusion: no PrePass, TS's diffuse half
DIR_LAUNCHES = {"smb_resolve": 1, "spatial_filter": 2, "history_fix": 1, "ts_prelude": 1}
DIR = "REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION"
SIGMA_LAUNCHES = {"sigma_blur": 2, "sigma_ts": 1}
RS_LAUNCHES = {"relax_prepass": 1, "relax_smb_resolve": 1, "relax_vmb_resolve": 1,
               "nearest_multi": 1, "bilinear_resolve": 1, "relax_history_fix": 1,
               "relax_clamp_moments": 1, "relax_atrous": 5}
# RELAX_DIFFUSE_SPECULAR: K15 once a signal, every other kernel once for both signals
RDS_LAUNCHES = {**RS_LAUNCHES, "relax_prepass": 2}
RD_LAUNCHES = {"relax_prepass": 1, "relax_smb_resolve": 1, "relax_history_fix": 1,
               "relax_clamp_moments": 1, "relax_atrous": 5}
# per path: its denoiser, its signals (outputs), settings changed from the defaults, whether
# its frames have hit-distance holes, the environment its engines run in, and its launches
# per frame
PATHS = {
    "REBLUR_DIFFUSE": dict(signals=("diff",), launches=D_LAUNCHES),
    "REBLUR_SPECULAR": dict(signals=("spec",), launches=S_LAUNCHES),
    "REBLUR_DIFFUSE_SPECULAR": dict(signals=("diff", "spec"), launches=DS_LAUNCHES),
    "REBLUR_DIFFUSE_SPECULAR+BAND": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR", signals=("diff", "spec"),
        env={"NRDTPU_REBLUR_BAND": "1"}, launches=BAND_LAUNCHES),
    "REBLUR_DIFFUSE_SPECULAR+AREA_3X3": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR", signals=("diff", "spec"), holes=True,
        settings=dict(hitDistanceReconstructionMode="AREA_3X3"),
        launches={**DS_LAUNCHES, "hitdist_recon": 1}),
    "SIGMA_SHADOW": dict(signals=("shadow",), launches=SIGMA_LAUNCHES),
    "SIGMA_SHADOW_TRANSLUCENCY": dict(signals=("shadow",), launches=SIGMA_LAUNCHES),
    "RELAX_DIFFUSE": dict(signals=("diff",), relax=True, launches=RD_LAUNCHES),
    "RELAX_SPECULAR": dict(signals=("spec",), relax=True, launches=RS_LAUNCHES),
    "RELAX_DIFFUSE_SPECULAR": dict(signals=("diff", "spec"), relax=True, launches=RDS_LAUNCHES),
    "RELAX_SPECULAR+ANTI_FIREFLY": dict(
        denoiser="RELAX_SPECULAR", signals=("spec",), relax=True,
        settings=dict(enableAntiFirefly=True), launches={**RS_LAUNCHES, "relax_antifirefly": 1}),
    # the SH variants: SH0 / SH1 a signal, the non-SH variant's launches
    "RELAX_DIFFUSE_SH": dict(signals=("diff",), relax=True, sh=True, launches=RD_LAUNCHES),
    "RELAX_SPECULAR_SH": dict(signals=("spec",), relax=True, sh=True, launches=RS_LAUNCHES),
    "RELAX_DIFFUSE_SPECULAR_SH": dict(signals=("diff", "spec"), relax=True, sh=True,
                                      launches=RDS_LAUNCHES),
    # REBLUR's SH variants: SH0 / SH1 a signal from `reblur_pack_sh`, the non-SH launches
    "REBLUR_DIFFUSE_SH": dict(signals=("diff",), sh=True, launches=D_LAUNCHES),
    "REBLUR_SPECULAR_SH": dict(signals=("spec",), sh=True, launches=S_LAUNCHES),
    "REBLUR_DIFFUSE_SPECULAR_SH": dict(signals=("diff", "spec"), sh=True, launches=DS_LAUNCHES),
    "REBLUR_DIFFUSE_SPECULAR_SH+BAND": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR_SH", signals=("diff", "spec"), sh=True,
        env={"NRDTPU_REBLUR_BAND": "1"}, launches=BAND_LAUNCHES),
    # the occlusion variants: a binary AO a signal (IN_*_HITDIST), one channel
    "REBLUR_DIFFUSE_OCCLUSION": dict(signals=("diff",), occ=True, launches=D_OCC_LAUNCHES),
    "REBLUR_SPECULAR_OCCLUSION": dict(signals=("spec",), occ=True, launches=S_OCC_LAUNCHES),
    "REBLUR_DIFFUSE_SPECULAR_OCCLUSION": dict(signals=("diff", "spec"), occ=True,
                                              launches=DS_OCC_LAUNCHES),
    "REBLUR_DIFFUSE_SPECULAR_OCCLUSION+BAND": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR_OCCLUSION", signals=("diff", "spec"), occ=True,
        env={"NRDTPU_REBLUR_BAND": "1"}, launches=BAND_OCC_LAUNCHES),
    # directional occlusion: the binary AO times the surface normal, and the AO
    DIR: dict(signals=("diff",), dir=True, launches=DIR_LAUNCHES),
    # the specular path at a roughness encoding other than LINEAR: H2's kRough instances
    "REBLUR_SPECULAR+SQ_LINEAR": dict(denoiser="REBLUR_SPECULAR", signals=("spec",),
                                      encoding="SQ_LINEAR",
                                      launches={**S_LAUNCHES, "spatial_filter_rough": 3}),
    "REBLUR_DIFFUSE_SPECULAR+SQRT_LINEAR": dict(denoiser="REBLUR_DIFFUSE_SPECULAR",
                                                signals=("diff", "spec"), encoding="SQRT_LINEAR",
                                                launches=DS_LAUNCHES),
    # performance mode (N4's 6-tap instances), DS's launches
    "REBLUR_DIFFUSE_SPECULAR+PERF": dict(denoiser="REBLUR_DIFFUSE_SPECULAR",
                                         signals=("diff", "spec"),
                                         settings=dict(enablePerformanceMode=True),
                                         launches=DS_LAUNCHES),
}
# dynamic resolution (`Engine` at a rect smaller than the resource, `rect_phase`): the paths run
# at a rect, the rect sequences as fractions of the resource (at 2560x1440: 1920x1080 and
# 1707x960) and, for the card against the CPU, at 256x160; RECT_FRAMES_EACH frames a rect at
# the full size, one at 256x160
RECT_PATHS = ("REBLUR_DIFFUSE_SPECULAR", "RELAX_DIFFUSE_SPECULAR", "SIGMA_SHADOW_TRANSLUCENCY")
RECT_SLICE_SCALE = 0.75
RECT_SCALES = (1.0, 0.75, 2.0 / 3.0, 1.0)
SMALL_RECTS = ((256, 160), (200, 121), (171, 107), (256, 160))
RECT_FRAMES_EACH = 2
# the paths that the full-size rect sequence also runs, so that every kernel of a main path is
# held at a rect on the card: H2 and H3 (REBLUR_SPECULAR), K12 (on the frames with holes), K23
# and K21
RECT_HELD = RECT_PATHS + ("REBLUR_SPECULAR", "REBLUR_DIFFUSE_SPECULAR+AREA_3X3",
                          "REBLUR_DIFFUSE_SPECULAR+BAND", "RELAX_SPECULAR+ANTI_FIREFLY")
# the paths whose device time the rect phase traces (with their cells at the rect)
PROFILED = RECT_PATHS + ("REBLUR_DIFFUSE_SPECULAR+PERF",)
# the checkerboard paths: half-width signal inputs in the mode `cb`, the non-cb path's launches
# with the PrePass in its checkerboard instance (counted apart as well)
# the RGBA normal encodings (`kDec`): per path its normal encoding; the kernels of the
# non-RGBA path, and the decoded-plane instances counted apart as `<kernel>_dec`
RS_DEC = {"relax_prepass_dec": 1, "relax_smb_resolve_dec": 1, "relax_vmb_resolve_dec": 1,
          "relax_history_fix_dec": 1, "relax_atrous_dec": 5}
RDS_DEC = {**RS_DEC, "relax_prepass_dec": 2}
# REBLUR at the RGBA formats: the specular TA's previous normals from bilinear_resolve in place
# of nearest_multi; ts_prelude_dec counts TS's specular half (the diffuse half reads no normal)
REBLUR_RGBA = {"nearest_multi": 0, "bilinear_resolve": 1, "smb_resolve_dec": 1,
               "spec_ta_head_dec": 1, "vmb_resolve_dec": 1}
DS_DEC = {**REBLUR_RGBA, "spatial_filter_fused_dec": 3, "history_fix_fused_dec": 1,
          "ts_prelude_dec": 1}
DS_OCC_DEC = {**REBLUR_RGBA, "spatial_filter_fused_dec": 2, "history_fix_fused_dec": 1}
NORMAL_ENCODED = {
    "RELAX_DIFFUSE_SPECULAR+RGBA8_UNORM": dict(
        denoiser="RELAX_DIFFUSE_SPECULAR", signals=("diff", "spec"), relax=True, holes=True,
        normal_encoding="RGBA8_UNORM", settings=dict(hitDistanceReconstructionMode="AREA_3X3"),
        launches={**RDS_LAUNCHES, **RDS_DEC, "hitdist_recon": 1, "hitdist_recon_dec": 1}),
    "RELAX_DIFFUSE_SPECULAR+RGBA16_SNORM": dict(
        denoiser="RELAX_DIFFUSE_SPECULAR", signals=("diff", "spec"), relax=True,
        normal_encoding="RGBA16_SNORM", settings=dict(enableAntiFirefly=True),
        launches={**RDS_LAUNCHES, **RDS_DEC, "relax_antifirefly": 1,
                  "relax_antifirefly_dec": 1}),
    "RELAX_SPECULAR_SH+RGBA8_SNORM": dict(
        denoiser="RELAX_SPECULAR_SH", signals=("spec",), relax=True, sh=True,
        normal_encoding="RGBA8_SNORM", launches={**RS_LAUNCHES, **RS_DEC}),
    "SIGMA_SHADOW_TRANSLUCENCY+RGBA8_UNORM": dict(
        denoiser="SIGMA_SHADOW_TRANSLUCENCY", signals=("shadow",), normal_encoding="RGBA8_UNORM",
        launches={**SIGMA_LAUNCHES, "sigma_blur_dec": 2}),
    "REBLUR_DIFFUSE_SPECULAR+RGBA8_UNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR", signals=("diff", "spec"),
        normal_encoding="RGBA8_UNORM", launches={**DS_LAUNCHES, **DS_DEC}),
    "REBLUR_DIFFUSE_SPECULAR+RGBA16_SNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR", signals=("diff", "spec"),
        normal_encoding="RGBA16_SNORM", launches={**DS_LAUNCHES, **DS_DEC}),
    "REBLUR_DIFFUSE_SPECULAR_SH+RGBA8_SNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR_SH", signals=("diff", "spec"), sh=True,
        normal_encoding="RGBA8_SNORM", launches={**DS_LAUNCHES, **DS_DEC}),
    "REBLUR_DIFFUSE_SPECULAR_OCCLUSION+AREA_3X3+RGBA16_UNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR_OCCLUSION", signals=("diff", "spec"), occ=True,
        holes=True, normal_encoding="RGBA16_UNORM",
        settings=dict(hitDistanceReconstructionMode="AREA_3X3"),
        launches={**DS_OCC_LAUNCHES, **DS_OCC_DEC, "hitdist_recon": 1,
                  "hitdist_recon_dec": 1}),
    # the one-signal paths (H2's and H3's kDec instances) and the band (K23's); TS's specular
    # half with a responsive threshold, so that its roughness read matters
    "REBLUR_DIFFUSE+RGBA16_UNORM": dict(
        denoiser="REBLUR_DIFFUSE", signals=("diff",), normal_encoding="RGBA16_UNORM",
        launches={**D_LAUNCHES, "smb_resolve_dec": 1, "spatial_filter_dec": 3,
                  "history_fix_dec": 1}),
    "REBLUR_SPECULAR+RGBA8_SNORM": dict(
        denoiser="REBLUR_SPECULAR", signals=("spec",), normal_encoding="RGBA8_SNORM",
        settings=dict(responsiveAccumulationRoughnessThreshold=0.5),
        launches={**S_LAUNCHES, **REBLUR_RGBA, "spatial_filter_dec": 3, "history_fix_dec": 1,
                  "ts_prelude_dec": 1}),
    "REBLUR_DIFFUSE_SPECULAR+BAND+RGBA8_SNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR", signals=("diff", "spec"),
        normal_encoding="RGBA8_SNORM", env={"NRDTPU_REBLUR_BAND": "1"},
        launches={**BAND_LAUNCHES, **REBLUR_RGBA, "spatial_filter_fused_dec": 1,
                  "reblur_band_dec": 1, "ts_prelude_dec": 1}),
}
PATHS.update(NORMAL_ENCODED)
SNORM = ("RGBA8_SNORM", "RGBA16_SNORM")
# the kernel phase's other decoded-plane runs, each on frames of its own pool: with
# NORMAL_ENCODED's they reach every kDec instance's structure (one or two signals, SH, the
# history fix's three phases, K16's four modes, K13's four); each recorded call of the kernels
# that decode the roughness is also held at the two other roughness encodings, and K12's at
# the other radius and each signal alone (`dec_variants`)
DEC_RUNS = {
    "SIGMA_SHADOW+RGBA8_SNORM": dict(denoiser="SIGMA_SHADOW", signals=("shadow",),
                                     normal_encoding="RGBA8_SNORM"),
    "RELAX_DIFFUSE+RGBA16_UNORM": dict(denoiser="RELAX_DIFFUSE", signals=("diff",), relax=True,
                                       normal_encoding="RGBA16_UNORM"),
    "RELAX_SPECULAR+RGBA8_SNORM": dict(denoiser="RELAX_SPECULAR", signals=("spec",), relax=True,
                                       normal_encoding="RGBA8_SNORM"),
    "RELAX_DIFFUSE_SH+RGBA8_UNORM": dict(denoiser="RELAX_DIFFUSE_SH", signals=("diff",),
                                         relax=True, sh=True, normal_encoding="RGBA8_UNORM"),
    "RELAX_DIFFUSE_SPECULAR_SH+RGBA16_UNORM": dict(
        denoiser="RELAX_DIFFUSE_SPECULAR_SH", signals=("diff", "spec"), relax=True, sh=True,
        normal_encoding="RGBA16_UNORM"),
    # REBLUR: with NORMAL_ENCODED's seven REBLUR paths every kDec instance's structure: H1
    # with one and two signals, SH and one channel; N3 plain, SH and one channel; H2's stages
    # on each signal plain, SH, checkerboard and one channel (and at the other tap count,
    # `dec_variants`); H3 on each signal plain, with the ring, SH, one channel and the
    # directional clamp; N4, N5 and K23 plain, SH, checkerboard (N4) and one channel
    "REBLUR_DIFFUSE+RING+RGBA8_SNORM": dict(denoiser="REBLUR_DIFFUSE", signals=("diff",),
                                            normal_encoding="RGBA8_SNORM",
                                            settings=dict(enableAntiFirefly=True)),
    "REBLUR_DIFFUSE_SH+RGBA16_SNORM": dict(denoiser="REBLUR_DIFFUSE_SH", signals=("diff",),
                                           sh=True, normal_encoding="RGBA16_SNORM"),
    "REBLUR_SPECULAR_SH+RGBA8_UNORM": dict(denoiser="REBLUR_SPECULAR_SH", signals=("spec",),
                                           sh=True, normal_encoding="RGBA8_UNORM"),
    "REBLUR_DIFFUSE+CB+RGBA8_UNORM": dict(denoiser="REBLUR_DIFFUSE", signals=("diff",),
                                          cb="WHITE", normal_encoding="RGBA8_UNORM",
                                          settings=dict(checkerboardMode="WHITE")),
    "REBLUR_SPECULAR+CB+RGBA16_SNORM": dict(denoiser="REBLUR_SPECULAR", signals=("spec",),
                                            cb="BLACK", normal_encoding="RGBA16_SNORM",
                                            settings=dict(checkerboardMode="BLACK")),
    "REBLUR_DIFFUSE_SPECULAR+CB+RGBA16_UNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR", signals=("diff", "spec"), cb="BLACK",
        normal_encoding="RGBA16_UNORM", settings=dict(checkerboardMode="BLACK")),
    "REBLUR_DIFFUSE_OCCLUSION+RGBA8_SNORM": dict(denoiser="REBLUR_DIFFUSE_OCCLUSION",
                                                 signals=("diff",), occ=True,
                                                 normal_encoding="RGBA8_SNORM"),
    "REBLUR_SPECULAR_OCCLUSION+RGBA16_UNORM": dict(denoiser="REBLUR_SPECULAR_OCCLUSION",
                                                   signals=("spec",), occ=True,
                                                   normal_encoding="RGBA16_UNORM"),
    f"{DIR}+RGBA8_UNORM": dict(denoiser=DIR, signals=("diff",), dir=True,
                               normal_encoding="RGBA8_UNORM"),
    "REBLUR_DIFFUSE_SPECULAR_SH+BAND+RGBA16_UNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR_SH", signals=("diff", "spec"), sh=True,
        normal_encoding="RGBA16_UNORM", env={"NRDTPU_REBLUR_BAND": "1"}),
    "REBLUR_DIFFUSE_SPECULAR_OCCLUSION+BAND+RGBA8_SNORM": dict(
        denoiser="REBLUR_DIFFUSE_SPECULAR_OCCLUSION", signals=("diff", "spec"), occ=True,
        normal_encoding="RGBA8_SNORM", env={"NRDTPU_REBLUR_BAND": "1"}),
}

CB_PATHS = {
    "REBLUR_DIFFUSE_SPECULAR+CB": dict(denoiser="REBLUR_DIFFUSE_SPECULAR", cb="BLACK",
                                       launches={**DS_LAUNCHES, "spatial_filter_fused_cb": 1}),
    "REBLUR_DIFFUSE+CB": dict(denoiser="REBLUR_DIFFUSE", cb="WHITE",
                              launches={**PATHS["REBLUR_DIFFUSE"]["launches"],
                                        "spatial_filter_cb": 1}),
    "REBLUR_SPECULAR+CB": dict(denoiser="REBLUR_SPECULAR", cb="BLACK",
                               launches={**PATHS["REBLUR_SPECULAR"]["launches"],
                                         "spatial_filter_cb": 1}),
    "REBLUR_DIFFUSE_SPECULAR+BAND+CB": dict(denoiser="REBLUR_DIFFUSE_SPECULAR", cb="BLACK",
                                            env={"NRDTPU_REBLUR_BAND": "1"},
                                            launches={**BAND_LAUNCHES,
                                                      "spatial_filter_fused_cb": 1}),
    "RELAX_DIFFUSE_SPECULAR+CB": dict(denoiser="RELAX_DIFFUSE_SPECULAR", relax=True, cb="BLACK",
                                      launches=RDS_LAUNCHES),
}
for _name, _v in CB_PATHS.items():
    _v.update(signals=PATHS[_v["denoiser"]]["signals"],
              settings=dict(checkerboardMode=_v["cb"]))
    PATHS[_name] = _v
RELAX_VARIANTS = ("RELAX_DIFFUSE", "RELAX_SPECULAR", "RELAX_DIFFUSE_SPECULAR")
RELAX_SH_VARIANTS = ("RELAX_DIFFUSE_SH", "RELAX_SPECULAR_SH", "RELAX_DIFFUSE_SPECULAR_SH")
REBLUR_SH_VARIANTS = ("REBLUR_DIFFUSE_SH", "REBLUR_SPECULAR_SH", "REBLUR_DIFFUSE_SPECULAR_SH")
REBLUR_OCC_VARIANTS = ("REBLUR_DIFFUSE_OCCLUSION", "REBLUR_SPECULAR_OCCLUSION",
                       "REBLUR_DIFFUSE_SPECULAR_OCCLUSION")
# REBLUR_DIFFUSE_SPECULAR_OCCLUSION's AO frames with holes: the kernel phase's AREA_3X3 run
REBLUR_OCC_HOLES = "REBLUR_DIFFUSE_SPECULAR_OCCLUSION+holes"
# REBLUR_DIFFUSE_SPECULAR_SH's frames with hit-distance holes (SH0's .w zeroed): the kernel
# phase's AREA_3X3 run of the SH variants
REBLUR_SH_HOLES = "REBLUR_DIFFUSE_SPECULAR_SH+holes"
# the band's paths, whose kernel-phase runs also time the chain it replaces
BAND_PATHS = ("REBLUR_DIFFUSE_SPECULAR+BAND", "REBLUR_DIFFUSE_SPECULAR_SH+BAND",
              "REBLUR_DIFFUSE_SPECULAR_OCCLUSION+BAND")
# RELAX_SPECULAR with IN_NORMAL_ROUGHNESS packed at the roughness encodings other than LINEAR,
# with AREA_3X3 on the frames with hit-distance holes, so that every kernel that unpacks the
# roughness (ENCODED_KERNELS) runs in the encoding's mode: held and timed in the kernel phase,
# and SQ_LINEAR card against CPU; not sliced
ENCODED_KERNELS = ("relax_prepass", "relax_history_fix", "relax_atrous", "hitdist_recon")
ENCODED = {f"RELAX_SPECULAR+{e}": dict(denoiser="RELAX_SPECULAR", signals=("spec",), relax=True,
                                       encoding=e,
                                       settings=dict(hitDistanceReconstructionMode="AREA_3X3"))
           for e in ("SQ_LINEAR", "SQRT_LINEAR")}
# REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR at the two encodings: every kernel held in the
# kernel phase (H2's kRough instances timed on REBLUR_SPECULAR), card against CPU; the two that
# PATHS slices (REBLUR_SPECULAR+SQ_LINEAR, REBLUR_DIFFUSE_SPECULAR+SQRT_LINEAR) are its entries
REBLUR_ENCODED = {f"{d}+{e}": dict(denoiser=d, signals=PATHS[d]["signals"], encoding=e)
                  for d in ("REBLUR_SPECULAR", "REBLUR_DIFFUSE_SPECULAR")
                  for e in ("SQ_LINEAR", "SQRT_LINEAR")}
ENCODED.update({k: v for k, v in REBLUR_ENCODED.items() if k not in PATHS})
# REBLUR_DIFFUSE_SPECULAR_OCCLUSION under checkerboard BLACK, the AO at half width: card
# against CPU only, not sliced
OCC_CB = {"REBLUR_DIFFUSE_SPECULAR_OCCLUSION+CB": dict(
    denoiser="REBLUR_DIFFUSE_SPECULAR_OCCLUSION", signals=("diff", "spec"), occ=True,
    cb="BLACK", settings=dict(checkerboardMode="BLACK"))}
# directional occlusion under checkerboard BLACK (the input at half width: no PrePass, no
# neighbour resolve) and with AREA_3X3 on the AO with holes: card against CPU only, the
# second also held in the kernel phase; not sliced
DIR_EXTRA = {f"{DIR}+CB": dict(denoiser=DIR, signals=("diff",), dir=True, cb="BLACK",
                               settings=dict(checkerboardMode="BLACK")),
             f"{DIR}+AREA_3X3": dict(denoiser=DIR, signals=("diff",), dir=True, holes=True,
                                     settings=dict(hitDistanceReconstructionMode="AREA_3X3"))}
NO_MIN_MATERIAL = dict(minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0)
# RELAX's fast history at the slow one's frame num: the history clamp's colour box off
NO_FAST_CLAMP = dict(diffuseMaxFastAccumulatedFrameNum=30, specularMaxFastAccumulatedFrameNum=30)
# RELAX-packed frames with hit-distance holes: the kernel phase's RELAX AREA_3X3 runs
RELAX_HOLES = {v: f"{v}+holes" for v in RELAX_VARIANTS}
REBLUR_VARIANTS = ("REBLUR_DIFFUSE", "REBLUR_SPECULAR", "REBLUR_DIFFUSE_SPECULAR")
# the spatial filters' calls of a frame (N4 of REBLUR_DIFFUSE_SPECULAR, H2 of the others); H2's
# `mode` indexes them
SF_STAGES = ("prepass", "blur", "post_blur")
HOLE_FRACTION = 0.3  # of the geometry pixels whose hit distance the frames with holes zero
# the checkerboard PrePass's runs of the kernel phase on frames whose fallback fires: at the
# minimum radius of 1 px, which a pixel without data takes (its hit distance is zeroed), some
# tap lands on its own expanded texel; a 3 px minimum and a material drawn per pixel (both
# min materials 0) make every tap fail at about a tenth of those pixels, and
# usePrepassOnlyForSpecularMotionEstimation weighs every specular tap 0
CB_FALLBACK = dict(minBlurRadius=3.0, minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0)
CB_SPLIT = ("spatial_filter", "spatial_filter_cb", "spatial_filter_fused",
            "spatial_filter_fused_cb")
CB_STATE_OPS, CB_RESOLVE_OPS = 6, 30        # reblur_filters.cuh: has_data and the centre's
                                            # zeroing and weight a pixel; cb_neighbor_resolve
                                            # (+ N4's cb_centre) a pixel that falls back
TRANSLUCENCY_RGB = (0.3, 0.6, 0.2)
# Float operations a pixel, counted from the kernel sources (transcendentals count as one):
# the fixed part of each kernel, and the parts that depend on the call (taps, signals)
SF_TAP_OPS, SF_PREPASS_TAP_OPS = 110, 40   # reblur_filters.cuh:sf_filter, one tap
SF_GEOM_OPS = 90                            # reblur_filters.cuh:filter_geometry (H2's centre)
ROUGH_DECODE_OPS = 2                        # common.cuh:decode_roughness at a tap (kRough)
# H2's parameters of one signal (reblur_filters.cuh): the PrePass's by signal
# (diff_prepass_params, spec_prepass_params); Blur and PostBlur take BAND_PARAM_OPS
SF_PREPASS_PARAM_OPS = {False: 50, True: 120}
HF_TAP_OPS, HF_MOMENT_OPS, HF_RING_OPS = 100, 27, 216  # :hf_filter tap, 3x3, the 72-tap ring
FIXED_OPS = {"reblur_band": 0, "smb_resolve": 450, "ts_prelude": 80, "spec_ta_head": 120, "vmb_resolve": 600,
             "nearest_multi": 0, "spatial_filter": 0, "spatial_filter_fused": 0,
             "history_fix": 0, "history_fix_fused": 0, "hitdist_recon": 0, "sigma_blur": 90,
             "sigma_ts": 150, "relax_prepass": 60, "relax_smb_resolve": 260,
             "relax_history_fix": 10, "relax_clamp_moments": 820, "relax_atrous": 80,
             "relax_vmb_resolve": 250, "relax_antifirefly": 0, "bilinear_resolve": 0}
SMB_SIGNAL_OPS, TS_SAMPLE_OPS, NEAREST_SET_OPS = 200, 200, 12
TS_SPEC_OPS = 30                            # ts_prelude.cu: the specular half's lerps, split
                                            # tests, responsive factor and magic curve
HD_TAP_OPS, HD_SIGNAL_TAP_OPS = 60, 15      # hitdist_recon.cu: one tap, and per signal
HD_CENTRE_OPS, HD_SPEC_CENTRE_OPS = 55, 35  # hitdist_recon.cu: the centre's parameters (+ the
                                            # specular normal weight and roughness weight)
HD_TEXEL_OPS = 20                           # hitdist_recon.cu: a staged texel (normal, z,
                                            # roughness), (16 + 2r)^2 of them a 16x16 tile
SB_DENSE_TAP_OPS, SB_POISSON_TAP_OPS = 30, 76  # sigma_blur.cu: one tap, + 3 a channel
SB_TEXEL_OPS = 5                            # sigma_blur.cu: a staged texel (+ 1 a channel
                                            # on PostBlur), 20x20 of them a 16x16 tile
ST_TAP_OPS, ST_CHANNEL_OPS = 5, 80          # sigma_ts.cu: a moment tap (+ 4 a channel),
                                            # and the CatRom sample + clamp of a channel
ST_REPROJECT_OPS = 76                       # common.cuh:surface_motion, screen-space branch
RP_TAP_OPS = 100                            # relax_prepass.cu: one Poisson tap
# the SH modes' extra operations: a tap's SH select and its 4 multiply-adds (K15, K19, K22 and
# K22's 5x5 estimation), an SH history's custom-weight bilinear (K16, K17: 4 texels x 4
# channels, the weight sum and 4 divisions), the SH lerp of K20 (3 a channel) and each
# SH output's 4 divisions (K15, K19, K22)
SH_TAP_OPS, SH_HISTORY_OPS, SH_LERP_OPS, SH_OUT_OPS = 9, 39, 12, 4
SH_SCALE_OPS = 9                            # reblur_filters.cuh:sh_luma_scale: the length
                                            # and the scale of SH1.xyz
RS_HISTORY_OPS = 100                        # relax_smb_resolve.cu: one history through the
                                            # CatRom footprint (12 texels x 4 channels)
RH_TAP_OPS, RH_RECORD_OPS = 40, 43          # relax_history_fix.cu: one stride tap, and
                                            # one texel's tap record (the prologue)
RA_TAP_OPS, RA_SVE_TAP_OPS = 90, 45         # relax_atrous.cu: an à-trous tap, a 5x5 tap
RA_SPEC_OPS, RA_SPEC_TAP_OPS = 60, 50       # the specular mode's parameters, + a tap
RA_PAIR_OPS = 40                            # relax_atrous.cu with both signals: the second
RA_PAIR_TAP_OPS, RA_PAIR_SVE_TAP_OPS = 35, 12  # signal's centre, + its part of a tap (normal,
                                            # material and luminance weights, exp, the sums)
                                            # and of a 5x5 tap (material test, the sums)
RP_SPEC_OPS, RP_SPEC_TAP_OPS = 120, 30      # relax_prepass.cu's specular mode, + a tap
RS_SPEC_OPS = 40                            # relax_smb_resolve.cu's specular planes
RH_SPEC_TAP_OPS = 40                        # relax_history_fix.cu's specular tap weight
RH_PAIR_TAP_OPS = 15                        # relax_history_fix.cu with both signals: the
                                            # second one's material test and sums a tap
RV_HISTORY_OPS = 100                        # relax_vmb_resolve.cu: the same, one history
AF_SIGNAL_OPS = 8 * 12 + 10                 # relax_antifirefly.cu: 8 taps of one signal
BR_SET_OPS = 30                             # bilinear_resolve.cu: one bilinear sample
BAND_CLAMP_OPS, BAND_PARAM_OPS = 30, 90     # reblur_filters.cuh: hf_clamp (N5 and K23),
                                            # and the Blur/PostBlur parameters of one signal
BAND_SCRATCH_BYTES_PER_PX = 128             # reblur_band.cu: sig2 and sig3 written and read
                                            # (32 with one channel)
# the one-channel (occlusion) instances do the weights of the four-channel ones, without the
# other three channels' work: a multiply-add a channel a tap, and in H1 / N3 a history's
# CatRom (5 bilinear samples of 4 texels, a multiply-add each) a channel
TAP_CHANNEL_OPS, CATROM_CHANNEL_OPS = 2, 40
# the H100's limits an SM (NVIDIA's data sheet), against which each kernel's CTAs an SM
# are worked out from its registers, its shared memory and its block size; the runtime keeps
# 1 KB of shared memory per CTA
SM_REGISTERS, SM_SHARED_BYTES, SM_THREADS, SM_CTAS = 65536, 232448, 2048, 32
REGISTER_UNIT, CTA_RESERVED_SHARED = 256, 1024  # registers are given a warp in units of 256
CTA_THREADS = 256                               # every kernel of csrc/ launches 256 threads


def log(*a):
    print(*a, flush=True)


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    peak = max(float(np.abs(b).max()), 1e-9)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def in_rt(sig, occ=False, dirocc=False):
    from nrdtpu_torch.settings import ResourceType as RT

    if dirocc:
        return RT.IN_DIFF_DIRECTION_HITDIST
    if occ:
        return RT.IN_DIFF_HITDIST if sig == "diff" else RT.IN_SPEC_HITDIST
    return RT.IN_DIFF_RADIANCE_HITDIST if sig == "diff" else RT.IN_SPEC_RADIANCE_HITDIST


def out_rt(sig, occ=False, dirocc=False):
    from nrdtpu_torch.settings import ResourceType as RT

    if dirocc:
        return RT.OUT_DIFF_DIRECTION_HITDIST
    if occ:
        return RT.OUT_DIFF_HITDIST if sig == "diff" else RT.OUT_SPEC_HITDIST
    return {"diff": RT.OUT_DIFF_RADIANCE_HITDIST, "spec": RT.OUT_SPEC_RADIANCE_HITDIST,
            "shadow": RT.OUT_SHADOW_TRANSLUCENCY}[sig]


def path_spec(path):
    """A path's entry: of PATHS, ENCODED, OCC_CB, DIR_EXTRA or DEC_RUNS."""
    return {**PATHS, **ENCODED, **OCC_CB, **DIR_EXTRA, **DEC_RUNS}[path]


def sh_rts(sig):
    """The SH variants' (SH0 in, SH0 out, SH1 in, SH1 out) of a signal."""
    from nrdtpu_torch.passes.relax.denoiser import SH_RESOURCES

    return SH_RESOURCES[sig]


def outputs_of(path):
    """(label, signal, resource) of every output of a path: a signal's output, or with SH its
    SH0 and SH1."""
    v = path_spec(path)
    if not v.get("sh"):
        return [(sig, sig, out_rt(sig, v.get("occ", False), v.get("dir", False)))
                for sig in v["signals"]]
    return [(f"{sig} {n}", sig, sh_rts(sig)[k]) for sig in v["signals"]
            for n, k in (("SH0", 1), ("SH1", 3))]


class Scene:
    """Frames of the port's orbit scene as input pools (numpy) for every path."""

    def __init__(self, w, h, seed=0):
        from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

        self.w, self.h, self.seed = w, h, seed
        self.gen = SceneGenerator(SceneSpec(size=(w, h), noise=0.4, seed=seed),
                                  camera_mode="orbit")

    def frame(self, i, truth=False):
        """(common settings, {path: pool}, truth or None)."""
        from nrdtpu_torch import frontend as fe
        from nrdtpu_torch.settings import ResourceType as RT, RoughnessEncoding

        fd = self.gen.frame(i)
        cs = fd.common_settings
        cs.timeDeltaBetweenFrames = 16.66
        hdp = np.array([3.0, 0.1, 20.0, -25.0], np.float32)
        view_z = torch.from_numpy(fd.view_z)
        base = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                RT.IN_NORMAL_ROUGHNESS: self.gen.packed_normal_roughness(fd)}
        holes = ((np.random.default_rng((self.seed, i)).random(fd.view_z.shape) < HOLE_FRACTION)
                 & (fd.hit_mask > 0))
        packed, punched = {}, {}
        normal = torch.from_numpy(fd.normal.astype(np.float32))
        reblur_sh, reblur_sh_punched = {}, {}  # the REBLUR SH variants' SH0 / SH1 (the normal)
        for sig, noisy, hit, rough in (
                ("diff", fd.diff_noisy, fd.diff_hit_dist, torch.ones(self.h, self.w)),
                ("spec", fd.spec_noisy, fd.spec_hit_dist, torch.from_numpy(fd.roughness))):
            nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(hit), view_z, hdp, rough)
            packed[sig] = fe.reblur_pack_radiance_hitdist(torch.from_numpy(noisy), nhd).numpy()
            punched[sig] = packed[sig].copy()
            punched[sig][..., 3][holes] = 0.0
            sh0, sh1 = fe.reblur_pack_sh(torch.from_numpy(noisy), nhd, normal)
            sh0, sh1 = sh0.numpy(), sh1.numpy()
            reblur_sh[sh_rts(sig)[0]], reblur_sh[sh_rts(sig)[2]] = sh0, sh1
            reblur_sh_punched[sh_rts(sig)[0]] = sh0.copy()
            reblur_sh_punched[sh_rts(sig)[0]][..., 3][holes] = 0.0
            reblur_sh_punched[sh_rts(sig)[2]] = sh1
        # RELAX takes the radiance and the raw hit distance; its SH variants SH0 and SH1 (along
        # the normal)
        relax, relax_punched, relax_sh = {}, {}, {}
        for sig, noisy, hit in (("diff", fd.diff_noisy, fd.diff_hit_dist),
                                ("spec", fd.spec_noisy, fd.spec_hit_dist)):
            relax[sig] = fe.relax_pack_radiance_hitdist(torch.from_numpy(noisy),
                                                        torch.from_numpy(hit)).numpy()
            relax_punched[sig] = relax[sig].copy()
            relax_punched[sig][..., 3][holes] = 0.0
            sh0, sh1 = fe.relax_pack_sh(torch.from_numpy(noisy), torch.from_numpy(hit), normal)
            relax_sh[sh_rts(sig)[0]], relax_sh[sh_rts(sig)[2]] = sh0.numpy(), sh1.numpy()
        # the occlusion variants' binary AO: the scene's draw (diffuse) and a second one from
        # the clean AO (specular); with holes on the punched pixels
        rng = np.random.default_rng((self.seed, i, 1))
        ao = {"diff": fd.ao_noisy,
              "spec": (rng.random(fd.ao_clean.shape) < fd.ao_clean).astype(np.float32)}
        ao_punched = {sig: np.where(holes, 0.0, a).astype(np.float32) for sig, a in ao.items()}
        dist = torch.from_numpy(fd.dist_to_occluder)
        penumbra = fe.sigma_pack_penumbra_directional(
            dist, self.gen.spec.light_tan_angular_radius).numpy()
        rgb = torch.tensor(TRANSLUCENCY_RGB).expand(self.h, self.w, 3)
        sigma = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv, RT.IN_PENUMBRA: penumbra,
                 RT.IN_NORMAL_ROUGHNESS: base[RT.IN_NORMAL_ROUGHNESS]}
        # directional occlusion: the AO times the surface normal, and the AO (with holes: zeroed on
        # the punched pixels)
        dirocc = {holed: fe.reblur_pack_directional_occlusion(
            normal, torch.from_numpy(ao_punched["diff"] if holed else ao["diff"])).numpy()
            for holed in (False, True)}
        pools = {}
        for name, v in {**PATHS, **OCC_CB, **DIR_EXTRA}.items():
            if v.get("normal_encoding"):  # below
                continue
            if v.get("dir"):
                sig = dirocc[bool(v.get("holes"))]
                pools[name] = {**base, in_rt("diff", dirocc=True): (
                    sig if not v.get("cb") else half_width(sig, cs.frameIndex, v["cb"]))}
            elif v.get("occ"):
                pools[name] = {**base, **{in_rt(sig, True): ao[sig] if not v.get("cb") else
                                          half_width(ao[sig], cs.frameIndex, v["cb"])
                                          for sig in v["signals"]}}
            elif v.get("cb"):  # half width: the has-data pixel of each pair
                src = relax if v.get("relax") else packed
                pools[name] = {**base, **{in_rt(sig): half_width(src[sig], cs.frameIndex,
                                                                  v["cb"])
                                          for sig in v["signals"]}}
            elif name.startswith("SIGMA"):
                pools[name] = dict(sigma)
                if name == "SIGMA_SHADOW_TRANSLUCENCY":
                    pools[name][RT.IN_TRANSLUCENCY] = fe.sigma_pack_translucency(dist, rgb).numpy()
            elif v.get("sh"):
                src = relax_sh if v.get("relax") else reblur_sh
                pools[name] = {**base, **{rt: src[rt] for sig in v["signals"]
                                          for rt in sh_rts(sig)[::2]}}
            elif v.get("relax"):
                pools[name] = {**base, **{in_rt(sig): relax[sig] for sig in v["signals"]}}
            else:
                src = punched if v.get("holes") else packed
                pools[name] = {**base, **{in_rt(sig): src[sig] for sig in v["signals"]}}
            if v.get("encoding"):  # IN_NORMAL_ROUGHNESS packed with the path's encoding
                pools[name][RT.IN_NORMAL_ROUGHNESS] = self.gen.packed_normal_roughness(
                    fd, re_=RoughnessEncoding[v["encoding"]])
        for name, holes_name in RELAX_HOLES.items():
            pools[holes_name] = {**base, **{in_rt(sig): relax_punched[sig]
                                            for sig in PATHS[name]["signals"]}}
        pools[REBLUR_SH_HOLES] = {**base, **reblur_sh_punched}
        pools[REBLUR_OCC_HOLES] = {**base, **{in_rt(sig, True): ao_punched[sig]
                                              for sig in ("diff", "spec")}}
        # the RGBA normal encodings: IN_NORMAL_ROUGHNESS packed at the path's encoding, the
        # SNORM ones with the sky's normal (0, 0, 1); the signals as the R10G10B10A2 paths'
        # (REBLUR's, RELAX's, SIGMA's; with holes, one channel, SH, directional, half width)
        nr_enc = {}
        for name, v in {**NORMAL_ENCODED, **DEC_RUNS}.items():
            enc = v["normal_encoding"]
            if enc not in nr_enc:
                nr_enc[enc] = self.gen.packed_normal_roughness(
                    fd, enc, sky_normal=(0.0, 0.0, 1.0) if enc in SNORM else None)
            if name.startswith("SIGMA"):
                pools[name] = dict(sigma)
                if v["denoiser"] == "SIGMA_SHADOW_TRANSLUCENCY":
                    pools[name][RT.IN_TRANSLUCENCY] = fe.sigma_pack_translucency(dist, rgb).numpy()
            elif v.get("dir"):
                pools[name] = {**base, in_rt("diff", dirocc=True): dirocc[bool(v.get("holes"))]}
            elif v.get("occ"):
                src = ao_punched if v.get("holes") else ao
                pools[name] = {**base, **{in_rt(sig, True): src[sig] for sig in v["signals"]}}
            elif v.get("sh"):
                src = relax_sh if v.get("relax") else reblur_sh
                pools[name] = {**base, **{rt: src[rt] for sig in v["signals"]
                                          for rt in sh_rts(sig)[::2]}}
            elif v.get("relax"):
                src = relax_punched if v.get("holes") else relax
                pools[name] = {**base, **{in_rt(sig): src[sig] for sig in v["signals"]}}
            else:  # REBLUR's radiance and normalized hit distance
                src = punched if v.get("holes") else packed
                pools[name] = {**base, **{in_rt(sig): src[sig] for sig in v["signals"]}}
            if v.get("cb"):  # half width: the has-data pixel of each pair
                pools[name] = {rt: half_width(p, cs.frameIndex, v["cb"]) if rt not in base
                               else p for rt, p in pools[name].items()}
            pools[name][RT.IN_NORMAL_ROUGHNESS] = nr_enc[enc]
        for name, v in ENCODED.items():
            nr = self.gen.packed_normal_roughness(fd, re_=RoughnessEncoding[v["encoding"]])
            pools[name] = {**base, RT.IN_NORMAL_ROUGHNESS: nr, **(
                {in_rt("spec"): relax_punched["spec"]} if v.get("relax")
                else {in_rt(sig): packed[sig] for sig in v["signals"]})}
        t = None
        if truth:
            t = dict(mask=fd.hit_mask > 0, diff=(fd.diff_clean, fd.diff_noisy),
                     spec=(fd.spec_clean, fd.spec_noisy), shadow_clean=fd.shadow_clean,
                     ao_clean=fd.ao_clean, ao=ao, ao_punched=ao_punched)
        return cs, pools, t

    def frames(self, n, workers=4):
        """Frames 0..n-1 in order, generated ahead on a few threads (numpy frees the GIL);
        the truth planes come with the last frame only."""
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            def submit(i):
                return ex.submit(self.frame, i, i == n - 1)
            pending = {i: submit(i) for i in range(min(n, workers))}
            for i in range(n):
                if i + workers < n:
                    pending[i + workers] = submit(i + workers)
                yield pending.pop(i).result()


def half_width(plane, frame_index, mode):
    """The half-width checkerboard input of a full-width plane in `mode` ("BLACK" or "WHITE"):
    half texel x holds the pixel of the pair (2x, 2x + 1) that has data in this frame, where
    (x + y + frame index) & 1 is the mode's parity (tests/test_reblur_full.py:244-250)."""
    from nrdtpu_torch.settings import CheckerboardMode

    h, w = plane.shape[:2]
    has = (((np.arange(w)[None, :] + np.arange(h)[:, None] + int(frame_index)) & 1)
           == int(CheckerboardMode[mode]) - 1)
    sel = np.where(has[:, ::2], 0, 1) + np.arange(0, w, 2)[None, :]
    return np.ascontiguousarray(plane[np.arange(h)[:, None], sel])


def scattered_materials(pool, seed):
    """The pool with a material 0-3 drawn per pixel from `seed` in IN_NORMAL_ROUGHNESS (its .w
    is material / 3), so that any tap may fail the material test."""
    from nrdtpu_torch.settings import ResourceType as RT

    nr = pool[RT.IN_NORMAL_ROUGHNESS].copy()
    m = np.random.default_rng(seed).integers(0, 4, nr.shape[:2]).astype(np.float32)
    nr[..., 3] = m / np.float32(3.0)
    return {**pool, RT.IN_NORMAL_ROUGHNESS: nr}


def engine(denoiser, w, h, device, roughness_encoding="LINEAR",
           normal_encoding="R10_G10_B10_A2_UNORM", **settings):
    """A fresh Engine of the denoiser on the device at the roughness and normal encodings,
    with `settings` changed from the defaults (enum fields by name)."""
    from nrdtpu_torch import settings as S
    from nrdtpu_torch.engine import Engine

    eng = Engine({0: S.Denoiser[denoiser]}, resource_size=(w, h), device=device,
                 roughness_encoding=S.RoughnessEncoding[roughness_encoding],
                 normal_encoding=S.NormalEncoding[normal_encoding])
    if settings:
        if "hitDistanceReconstructionMode" in settings:
            settings["hitDistanceReconstructionMode"] = S.HitDistanceReconstructionMode[
                settings["hitDistanceReconstructionMode"]]
        if "checkerboardMode" in settings:
            settings["checkerboardMode"] = S.CheckerboardMode[settings["checkerboardMode"]]
        eng.set_denoiser_settings(0, S.replace(eng._settings[0], **settings))
    return eng


@contextlib.contextmanager
def path_env(path):
    """The environment a path's engines run in (the band's switch), set only while they do."""
    env = {**PATHS, **DEC_RUNS}.get(path, {}).get("env", {})
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def path_engine(path, w, h, device):
    v = path_spec(path)
    return engine(v.get("denoiser", path), w, h, device, v.get("encoding", "LINEAR"),
                  v.get("normal_encoding", "R10_G10_B10_A2_UNORM"), **v.get("settings", {}))


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _outputs(r, prefix=""):
    """{name: tensor} of a kernel's result: a tensor ("out"), or dicts, tuples and lists of
    them, nested names joined by "." (a tuple's i-th tensor is "i"); None left out."""
    if isinstance(r, torch.Tensor):
        return {prefix or "out": r}
    items = (r.items() if isinstance(r, dict) else enumerate(r) if isinstance(r, (tuple, list))
             else ())
    out = {}
    for k, v in items:
        out.update(_outputs(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def time_ms(fn, reps):
    """Mean ms of one call of `fn` over `reps` calls after one warm-up call, CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _ops(name, a, k):
    """Float operations of one call on its inputs, counted as FIXED_OPS says; the history
    fixes count the taps only of the pixels whose stride is non-zero in this call."""
    from nrdtpu_torch.kernels import build
    from nrdtpu_torch.kernels import spatial_filter as sf
    from nrdtpu_torch.settings import RoughnessEncoding

    if name == "halo_call":  # box: (2 halo + 1)^2 adds and a division a channel
        body, images, out_channels, halo = a[:4]
        return sum(t.numel() for t in images) * ((2 * halo + 1) ** 2 + 1)
    # every other kernel's first argument is a (h, w, ...) plane, or the pair of the two
    # RELAX signals in a two-signal mode
    pair = isinstance(a[0], tuple)
    h, w = (a[0][0] if pair else a[0]).shape[:2]
    px = h * w
    ops = FIXED_OPS[name] * px
    if name == "relax_clamp_moments" and isinstance(a[1], tuple):  # the pass of each signal
        ops *= len(a[1])
    ntaps = len(sf.tap_table(bool(k.get("perf_mode", False))))
    # REBLUR's SH modes: the SH a tap (H2, H3, N4, N5, K23), an SH history's bilinear (H1, N3),
    # the SH luma scale after the clamp (H3, N5, K23)
    nsh = 0 if k.get("sh") is None and k.get("sh_history") is None else (
        len(k["sh"]) if isinstance(k.get("sh"), (tuple, list)) else 1)
    # the one-channel (occlusion) instances: three channels' multiply-adds fewer a tap
    occ = name in ("spatial_filter", "spatial_filter_fused", "history_fix", "history_fix_fused",
                   "reblur_band") and a[0].shape[-1] == 1
    tap_saved = 3 * TAP_CHANNEL_OPS if occ else 0
    if name == "smb_resolve":
        nsig = 2 if k.get("second") is not None else 1
        ops += SMB_SIGNAL_OPS * px * nsig
        ops += SH_HISTORY_OPS * nsh * px
        ops -= 3 * CATROM_CHANNEL_OPS * px * nsig if a[9].shape[-1] == 1 else 0
    elif name == "vmb_resolve":
        ops += SH_HISTORY_OPS * nsh * px
        ops -= 3 * CATROM_CHANNEL_OPS * px if a[6].shape[-1] == 1 else 0
    elif name == "ts_prelude":  # the specular half samples both motions
        spec = len(a) > 5 and a[5] is not None
        ops += (TS_SAMPLE_OPS * 2 + TS_SPEC_OPS if spec else TS_SAMPLE_OPS) * px
    elif name == "nearest_multi":
        ops += NEAREST_SET_OPS * px * a[1].shape[0]
    elif name == "spatial_filter":  # the centre's geometry and parameters, then the taps
        prepass = k["mode"] == 0
        params = SF_PREPASS_PARAM_OPS[k["spec"]] if prepass else BAND_PARAM_OPS
        ops += (SF_GEOM_OPS + params) * px
        ops += (SF_TAP_OPS + (SF_PREPASS_TAP_OPS if prepass and k["spec"] else 0)
                - tap_saved) * ntaps * px
        ops += CB_STATE_OPS * px if k.get("cb") is not None else 0
        ops += (SH_TAP_OPS * ntaps + SH_OUT_OPS) * nsh * px
        rough = build.ROUGHNESS_MODE[k.get("roughness_encoding", RoughnessEncoding.LINEAR)]
        ops += ROUGH_DECODE_OPS * ntaps * px if rough else 0
    elif name == "spatial_filter_fused":
        for params in (a[5], a[6]):
            extra = SF_PREPASS_TAP_OPS if sf.MODES[params.shape[0]] == "spec_prepass" else 0
            ops += (SF_TAP_OPS + extra - tap_saved) * ntaps * px
        ops += 2 * CB_STATE_OPS * px if k.get("cb") is not None else 0
        ops += (SH_TAP_OPS * ntaps + SH_OUT_OPS) * nsh * px
    elif name == "history_fix":
        live = int((a[6][0] != 0.0).sum())
        ops += HF_MOMENT_OPS * px + (HF_RING_OPS * px if k.get("anti_firefly") else 0)
        ops += (HF_TAP_OPS - tap_saved) * 20 * live + BAND_CLAMP_OPS * px
        ops += (SH_TAP_OPS * 20 * live + (SH_OUT_OPS + SH_SCALE_OPS) * px) * nsh
    elif name in ("history_fix_fused", "reblur_band"):
        af = k["anti_firefly"]
        per = [(a[9], af[0]), (a[10], af[1])]
        ops += 2 * BAND_CLAMP_OPS * px  # the clamp of each signal
        if name == "reblur_band":  # then the Blur and PostBlur of each signal
            ops += 2 * 2 * (BAND_PARAM_OPS + (SF_TAP_OPS - tap_saved) * ntaps) * px
            ops += 2 * (SH_TAP_OPS * ntaps + SH_OUT_OPS) * nsh * px
        for params, ring in per:
            live = int((params[0] != 0.0).sum())
            ops += (HF_MOMENT_OPS * px + (HF_RING_OPS * px if ring else 0)
                    + (HF_TAP_OPS - tap_saved) * 20 * live)
            ops += (SH_TAP_OPS * 20 * live + (SH_OUT_OPS + SH_SCALE_OPS) * px) * (nsh // 2)
    elif name == "hitdist_recon":
        taps = (2 * k["radius"] + 1) ** 2 - 1
        nsig = sum(x is not None for x in a[2:4])
        ops += (HD_TAP_OPS + HD_SIGNAL_TAP_OPS * nsig) * taps * px
        ops += (HD_CENTRE_OPS + (HD_SPEC_CENTRE_OPS if a[3] is not None else 0)) * px
        ops += HD_TEXEL_OPS * px * (16 + 2 * k["radius"]) ** 2 // (16 * 16)
    elif name == "sigma_blur":
        c = 1 if a[1] is None else a[1].shape[-1]
        ops += ((SB_DENSE_TAP_OPS + 3 * c) * 24 + (SB_POISSON_TAP_OPS + 3 * c) * 8) * px
        unpack = c if a[1] is not None and not k["first_pass"] else 0
        ops += (SB_TEXEL_OPS + unpack) * px * 20 * 20 // (16 * 16)
    elif name == "sigma_ts":  # hard-shadow and dead pixels pass through
        c = a[0].shape[-1]
        ops += ((ST_TAP_OPS + 4 * c) * 25 + ST_CHANNEL_OPS * c + ST_REPROJECT_OPS) * \
            sigma_ts_live(a, k)
    elif name == "relax_prepass":
        spec = k.get("specular") is not None
        nsh = 1 if k.get("sh") is not None else 0
        if k["blur_radius"] > 0.0:
            ops += (RP_TAP_OPS + (RP_SPEC_TAP_OPS if spec else 0) + SH_TAP_OPS * nsh) * 8 * px
            ops += (RP_SPEC_OPS if spec else 0) * px + SH_OUT_OPS * nsh * px
    elif name == "relax_smb_resolve":
        ops += RS_HISTORY_OPS * len(a[8]) * px
        ops += RS_SPEC_OPS * px if len(a) > 9 and a[9] is not None else 0
        ops += SH_HISTORY_OPS * len(a[11]) * px if len(a) > 11 else 0
    elif name == "relax_history_fix":  # the taps run only where the fix applies
        live = history_fix_live(a, k)
        spec = k.get("specular") is not None
        nsh = 0 if k.get("sh") is None else 2 if pair else 1
        tap = RH_TAP_OPS + (RH_SPEC_TAP_OPS if spec else 0) + (RH_PAIR_TAP_OPS if pair else 0)
        ops += (tap + SH_TAP_OPS * nsh) * 24 * live + SH_OUT_OPS * nsh * live
        ops += RH_RECORD_OPS * px if k["frame_num"] != 1.0 else 0
    elif name == "relax_clamp_moments":
        ops += SH_LERP_OPS * px * (0 if k.get("sh") is None else len(a[1]) if pair else 1)
    elif name == "relax_atrous":  # iteration 0: the 5x5 estimation in place of short histories
        short = int((a[3] < k["history_threshold"]).sum()) if k["is_first"] else 0
        spec = k.get("specular") is not None and not k["is_first"]
        nsh = 0 if k.get("sh") is None else 2 if pair else 1
        tap = RA_TAP_OPS + (RA_SPEC_TAP_OPS if spec else 0) + (RA_PAIR_TAP_OPS if pair else 0)
        ops += (tap + SH_TAP_OPS * nsh) * 8 * (px - short)
        ops += (RA_SVE_TAP_OPS + (RA_PAIR_SVE_TAP_OPS if pair else 0)
                + SH_TAP_OPS * nsh) * 25 * short
        ops += (RA_SPEC_OPS if spec else 0) * px + (RA_PAIR_OPS if pair else 0) * px
        ops += SH_OUT_OPS * nsh * px
    elif name == "relax_vmb_resolve":
        ops += RV_HISTORY_OPS * 2 * px
        ops += SH_HISTORY_OPS * 2 * px if len(a) > 12 and a[12] is not None else 0
    elif name == "relax_antifirefly":
        ops += AF_SIGNAL_OPS * len(a[1]) * px
    elif name == "bilinear_resolve":
        ops += BR_SET_OPS * a[1].shape[0] * px
    return ops


def sigma_ts_live(a, k):
    """The pixels of one sigma_ts call that run the moments, the reprojection and the history
    sample: not hard shadow (tile value 0 or penumbra 0) and not dead (sky tile, beyond the
    denoising range)."""
    penumbra, view_z_in, tile = a[1], a[2], a[7]
    live = ((tile[0] != 0.0) & (penumbra != 0.0) & (tile[1] <= 0.0)
            & (view_z_in.abs() * k["view_z_scale"] <= k["denoising_range"]))
    return int(live.sum())


def history_fix_live(a, k):
    """The pixels of one relax_history_fix call that run the taps (history length <= frame
    num, frame num != 1); the rest pass the signal through."""
    return int((a[3] <= k["frame_num"]).sum()) if k["frame_num"] != 1.0 else 0


# the inputs that a decoded-plane call (kDec) never reads: the decoded plane has no material,
# so no tap reads the previous material, and K21 and K17 read the current plane only for its
# material
DEC_UNREAD = {"relax_antifirefly": ("normal_roughness",),
              "relax_vmb_resolve": ("normal_roughness", "prev_material_id"),
              "relax_smb_resolve": ("prev_material_id",),
              "smb_resolve": ("prev_material_id",), "vmb_resolve": ("prev_material_id",)}


def read_inputs(name, a, k):
    """(args, kwargs) of one call with the inputs that its instance does not read set to
    None (`DEC_UNREAD`)."""
    if not k.get("decoded") or name not in DEC_UNREAD:
        return a, k
    from nrdtpu_torch import kernels as KM

    ref = getattr(KM.MODULES[name], f"{name}_ref")
    bound = inspect.signature(ref).bind(*a, **k)
    for p in DEC_UNREAD[name]:
        bound.arguments[p] = None
    return bound.args, bound.kwargs


def _bound(name, a, k, outputs, extra_bytes=0, extra_ops=0):
    """(bound ms, "bytes" or "operations"): each input that the call's instance reads read
    once (`read_inputs`) and each output written once (plus `extra_bytes`) at the memory
    rate, against the operations (plus `extra_ops`) at the float32 rate. The tap-geometry
    plane that N5 writes and N4's Blur and PostBlur read is left out: it holds only what the
    packed normal and viewZ, counted as inputs, hold."""
    ra, rk = read_inputs(name, a, k)
    rk = {x: v for x, v in rk.items() if x != "geometry"}
    outputs = {x: v for x, v in outputs.items() if x != "geometry"}
    nbytes = sum(t.nbytes for t in _tensors(ra) + _tensors(rk) + _tensors(outputs)) + extra_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (_ops(name, a, k) + extra_ops) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library(name, a, k):
    """One PyTorch call computing the same function on the same inputs, where there is one:
    nearest_multi is a nearest-texel sample and bilinear_resolve a bilinear sample at S uv
    sets (grid_sample with border padding and align_corners=False: the texel centres at
    (i + 0.5) / size and the clamp-to-edge addressing of the kernels). It is a yardstick
    here only; the port never calls it."""
    if name not in ("nearest_multi", "bilinear_resolve"):
        return None
    packed, uvs = a
    img = packed.permute(2, 0, 1)[None].contiguous()
    s, h, w = uvs.shape[:3]
    if name == "bilinear_resolve":
        sx, sy = k["scale"]
        uvs = torch.stack([uvs[..., 0] * float(sx), uvs[..., 1] * float(sy)], -1)
    grid = (uvs.reshape(1, s * h, w, 2) * 2.0 - 1.0).contiguous()
    mode = "nearest" if name == "nearest_multi" else "bilinear"
    return lambda: torch.nn.functional.grid_sample(img, grid, mode=mode, padding_mode="border",
                                                   align_corners=False)


def _template_args(rest):
    """The bool, int and enum literals of a mangled template argument list (`I...E`), or None
    where it holds anything else."""
    if not rest.startswith("I"):
        return None
    i, vals = 1, []
    while rest[i:i + 1] == "L":
        i += 1
        if rest[i] in "bi":
            kind = rest[i]
            i += 1
        elif rest[i] == "N":  # an enum: its nested name, then the value
            i, parts = i + 1, []
            while rest[i].isdigit():
                n = re.match(r"\d+", rest[i:])[0]
                parts.append(rest[i + len(n):i + len(n) + int(n)])
                i += len(n) + int(n)
            kind, i = parts[-1], i + 1
        else:
            return None
        v = re.match(r"\d+", rest[i:])
        if v is None or rest[i + len(v[0]):i + len(v[0]) + 1] != "E":
            return None
        i += len(v[0]) + 1
        vals.append(("false", "true")[int(v[0])] if kind == "b" else v[0] if kind == "i"
                    else f"{kind}({v[0]})")
    return vals if rest[i:i + 1] == "E" else None


def kernel_name(mangled):
    """The function name of a mangled kernel entry (its last nested name), with its template
    arguments where they are bool, int or enum literals."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    names = []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest)[0]
        names.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    if not names:
        return mangled
    args = _template_args(rest)
    if args is not None:
        return names[-1] + f"<{', '.join(args)}>"
    return names[-1] + ("<...>" if rest[:1] == "I" else "")


def sass_listing(library):
    """{mangled kernel: its lines of `cuobjdump -sass`} of the built library; None where the
    toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m[1], [])
        elif cur is not None:
            cur.append(line)
    return funcs


def sass_instructions(library):
    """{mangled kernel: SASS instructions, NOPs left out} of the built library; None where
    the toolkit has no cuobjdump."""
    funcs = sass_listing(library)
    if funcs is None:
        return None
    ins = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(\S+)")
    return {f: sum(1 for line in lines if (m := ins.match(line)) and not m[1].startswith("NOP"))
            for f, lines in funcs.items()}


def ptxas_usage(text):
    """{source file: [dict(kernel, registers, spill_bytes, static_smem)]} from the
    `-Xptxas -v` lines of the kernels' build log."""
    usage, src, cur, props = {}, None, None, None
    for line in text.splitlines():
        if " -c -o " in line:  # the nvcc command of one source
            src, cur = os.path.basename(line.split()[-1]), None
            usage[src] = []
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and src is not None:
            cur = dict(mangled=m[1], kernel=kernel_name(m[1]), registers=0, spill_bytes=0,
                       static_smem=0)
            usage[src].append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = cur if cur is not None and m[1] == cur["mangled"] else None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur is not None and props is cur:
            cur["spill_bytes"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(smem[1]) if smem else 0
    return usage


def ctas_per_sm(registers, shared_bytes, threads=CTA_THREADS):
    """CTAs an SM can hold at once, by registers, shared memory, threads and the CTA limit."""
    warps = -(-threads // 32)
    per_warp = -(-max(registers, 1) * 32 // REGISTER_UNIT) * REGISTER_UNIT
    return min((SM_REGISTERS // per_warp) // warps,
               SM_SHARED_BYTES // (shared_bytes + CTA_RESERVED_SHARED), SM_THREADS // threads,
               SM_CTAS)


def _dynamic_smem(name, a, k):
    """{device kernel: dynamic shared memory} of one launch, as the entry sizes it: K22 stages
    the tile's window (three float4 a texel, four with both signals) at iteration 0; K24 the
    windows of one strip of output rows. With SH K22's texel holds each signal's SH too."""
    from nrdtpu_torch.kernels import build
    from nrdtpu_torch.settings import RoughnessEncoding

    if name == "relax_atrous":
        src = (build.CSRC / "relax_atrous.cu").read_text()
        tx, ty = map(int, re.search(r"kTileX = (\d+), kTileY = (\d+)", src).groups())
        if not k["is_first"]:
            return {}
        halo = max(k["step_size"], 2)
        mode = build.ROUGHNESS_MODE[k.get("roughness_encoding", RoughnessEncoding.LINEAR)]
        both = isinstance(a[0], tuple)
        sh = k.get("sh") is not None
        dec = bool(k.get("decoded", False))
        planes = 2 + (2 if both else 1) * (2 if sh else 1)
        return {f"relax_atrous_kernel<true, {mode}, {str(both).lower()}, {str(sh).lower()}, "
                f"{str(dec).lower()}>": (tx + 2 * halo) * (ty + 2 * halo) * 16 * planes}
    if name == "halo_call":
        _, images, _, halo, (bh, bw) = a[:5]
        channels = sum(1 if t.dim() == 2 else t.shape[-1] for t in images)
        row = (bw + 2 * halo) * channels * 4
        fit = SM_SHARED_BYTES // row - 2 * halo  # a CTA may take all 227 KB
        strips = -(-bh // fit)
        return {"halo_call_kernel<...>": (-(-bh // strips) + 2 * halo) * row}
    return {}


def owns(name, kernel):
    """Whether the device kernel `kernel` (its demangled name) of a SOURCES entry's source goes
    under that entry: H2's and N4's checkerboard instances (their template argument kCb) under
    the `_cb` entry, H2's kRough instances (its seventh template argument, 1 or 2) under the
    `_rough` entry, the decoded-plane instances (their last template argument kDec, or N3's
    kernels named `*_dec_kernel`) under the `_dec` entry and no other, the rest under the
    kernel's own."""
    from nrdtpu_torch import kernels as KM

    args = kernel[kernel.find("<") + 1:-1].split(", ") if "<" in kernel else []
    h2 = os.path.basename(SOURCES[name][0]) == "spatial_filter.cu"
    if name in CB_SPLIT and (args[5 if h2 else 4] == "true") != name.endswith("_cb"):
        return False
    if h2 and (args[6] != "0") != name.endswith("_rough"):
        return False
    dec = args[-1] == "true" if args else "_dec_" in kernel
    base = re.sub(r"_(dec|cb|rough)$", "", name)
    dec_split = {n.removesuffix("_dec") for n in KM.DEC_INSTANCES}
    return base not in dec_split or dec == name.endswith("_dec")


def occupancy(name, dynamic_smem, sass):
    """Registers, spill bytes, CTAs an SM and SASS instructions (None without cuobjdump) of
    each device kernel of a kernel module; dynamic_smem: the largest dynamic shared memory of
    each device kernel in this run; sass: `sass_instructions` of the library."""
    from nrdtpu_torch import kernels as KM
    from nrdtpu_torch.kernels import build

    usage = ptxas_usage((build.BUILD_DIR / "build.log").read_text())
    out = []
    for u in usage.get(os.path.basename(SOURCES[name][0]), []):
        if not owns(name, u["kernel"]):
            continue
        smem = u["static_smem"] + dynamic_smem.get(u["kernel"], 0)
        out.append(dict(kernel=u["kernel"], registers=u["registers"],
                        spill_bytes=u["spill_bytes"], shared_bytes=smem,
                        ctas_per_sm=ctas_per_sm(u["registers"], smem),
                        sass_instructions=None if sass is None else sass.get(u["mangled"])))
    if not out:
        raise AssertionError(f"{name}: no ptxas lines for {SOURCES[name][0]} in build.log")
    return out


@contextlib.contextmanager
def recording(kernels, passes=()):
    """While open, every call of the kernel wrappers of a kernels package (`kernels.MODULES`:
    this tree's or another's) and of the pass functions `passes` ((module, name) pairs) goes
    into the list it yields as (name, args, kwargs); a pass is named "pass <name>" and its
    dict arguments (the frame constants, the geometry) copied as they stood."""
    calls = []
    saved = [(m, name, getattr(m, name)) for name, m in kernels.MODULES.items()]
    saved += [(m, name, getattr(m, name)) for m, name in passes]
    try:
        for m, name, f in saved[:len(kernels.MODULES)]:
            def rec(*a, _n=name, _f=f, **k):
                calls.append((_n, a, k))
                return _f(*a, **k)
            setattr(m, name, rec)
        for m, name, f in saved[len(kernels.MODULES):]:
            def rec_pass(*a, _n=name, _f=f, **k):
                calls.append((f"pass {_n}", copied(a), k))
                return _f(*a, **k)
            setattr(m, name, rec_pass)
        yield calls
    finally:
        for m, name, f in saved:
            setattr(m, name, f)


def copied(args):
    """The arguments with each dict copied, so that a pass called again on them finds them as
    they stood (the glue caches stacked planes in its geometry dict)."""
    return tuple(dict(x) if isinstance(x, dict) else x for x in args)


def record_calls(denoiser, pool, w, h, frames, **settings):
    """Every kernel call of the last of `frames` (their pools[pool]) through a fresh
    Engine(device="cuda") in the environment of the path `pool`, and the pass calls of the
    band (`spatial_band`, name "pass spatial_band", with the geometry as it stood)."""
    from nrdtpu_torch import kernels as KM
    from nrdtpu_torch.passes.reblur import kernels as RK

    eng = engine(denoiser, w, h, "cuda", **settings)

    def run(cs, pools):
        eng.set_common_settings(cs)
        eng.denoise([0], pools[pool])

    with path_env(pool):
        for cs, pools, _ in frames[:-1]:
            run(cs, pools)
        with recording(KM, [(RK, "spatial_band")]) as calls:
            run(*frames[-1][:2])
    torch.cuda.synchronize()
    return calls


def kernel_runs():
    """(label, denoiser, pool, settings, kernels to hold or None for all, timed: True, False
    or the kernels to time) of the kernel phase: each REBLUR variant with and without the
    anti-firefly ring (the ring's history-fix calls timed apart), each with hit-distance
    reconstruction at radius 1 and 2 on the frames with holes (the AREA_3X3 slice's pools),
    each SIGMA variant, RELAX_DIFFUSE and RELAX_SPECULAR (every call of their kernels), both
    with the anti-firefly pass (relax_antifirefly timed, the rest held only) and, not timed,
    both with AREA_3X3 reconstruction on RELAX-packed frames with holes and both with the
    history clamp's colour box off (relax_clamp_moments only); REBLUR_DIFFUSE and
    REBLUR_DIFFUSE_SPECULAR with maxBlurRadius 0 (ts_prelude without the RCRS clamp, each half,
    held only); then the kernels that unpack the roughness on RELAX_SPECULAR at each encoding of
    ENCODED, timed; directional occlusion (every call timed) and with AREA_3X3 on the AO with
    holes (held); REBLUR_SPECULAR and REBLUR_DIFFUSE_SPECULAR at SQ_LINEAR and SQRT_LINEAR
    (every call held, H2's timed on REBLUR_SPECULAR); then the three RELAX SH variants (every
    call of their kernels in the SH modes, timed); then the three REBLUR SH variants (every call in the SH modes, timed),
    each with the anti-firefly ring (the history fixes, held) and in performance mode (the
    spatial filters, held), REBLUR_DIFFUSE_SPECULAR_SH with AREA_3X3 on its frames with
    holes (every call, held), the three REBLUR occlusion variants (every call in the
    one-channel modes, timed), REBLUR_DIFFUSE_SPECULAR_OCCLUSION with AREA_3X3 on its AO frames
    with holes (hitdist_recon, timed), and the band's SH and one-channel modes with the band's
    runs."""
    runs = []
    for v in REBLUR_VARIANTS:
        runs.append((v, v, v, {}, None, True))
        runs.append((v, v, v, dict(enableAntiFirefly=True), None, False))
    ds = "REBLUR_DIFFUSE_SPECULAR"
    runs.append((f"{ds} perf", ds, ds, dict(enablePerformanceMode=True),
                 {"spatial_filter_fused"}, False))
    # H2's other modes, held: performance mode's 6 taps, the material test with both min
    # materials 0, the specular PrePass with usePrepassOnlyForSpecularMotionEstimation
    for v in ("REBLUR_DIFFUSE", "REBLUR_SPECULAR"):
        runs.append((f"{v} perf", v, v, dict(enablePerformanceMode=True), {"spatial_filter"},
                     False))
        runs.append((f"{v} min material 0", v, v, NO_MIN_MATERIAL, {"spatial_filter"}, False))
    runs.append(("REBLUR_SPECULAR prepass only", "REBLUR_SPECULAR", "REBLUR_SPECULAR",
                 dict(usePrepassOnlyForSpecularMotionEstimation=True), {"spatial_filter"}, False))
    for v in REBLUR_VARIANTS:
        for mode in ("AREA_3X3", "AREA_5X5"):
            runs.append((f"{v} {mode}", v, "REBLUR_DIFFUSE_SPECULAR+AREA_3X3",
                         dict(hitDistanceReconstructionMode=mode), {"hitdist_recon"}, True))
    for v in ("SIGMA_SHADOW", "SIGMA_SHADOW_TRANSLUCENCY"):
        runs.append((v, v, v, {}, None, True))
    for v in RELAX_VARIANTS:
        runs.append((v, v, v, {}, None, True))
        runs.append((f"{v} anti-firefly", v, v, dict(enableAntiFirefly=True), None,
                     {"relax_antifirefly"}))
        runs.append((f"{v} AREA_3X3", v, RELAX_HOLES[v],
                     dict(hitDistanceReconstructionMode="AREA_3X3"), {"hitdist_recon"}, False))
        runs.append((f"{v} no clamp", v, v, NO_FAST_CLAMP, {"relax_clamp_moments"}, False))
    for v in RELAX_SH_VARIANTS:
        runs.append((v, v, v, {}, None, True))
    for v in REBLUR_SH_VARIANTS:
        runs.append((v, v, v, {}, None, True))
        runs.append((f"{v} anti-firefly", v, v, dict(enableAntiFirefly=True),
                     {"history_fix", "history_fix_fused"}, False))
        runs.append((f"{v} perf", v, v, dict(enablePerformanceMode=True),
                     {"spatial_filter", "spatial_filter_fused"}, False))
    ds_sh = "REBLUR_DIFFUSE_SPECULAR_SH"
    runs.append((f"{ds_sh} AREA_3X3", ds_sh, REBLUR_SH_HOLES,
                 dict(hitDistanceReconstructionMode="AREA_3X3"), None, False))
    # the occlusion variants: every kernel in its one-channel mode, timed; hitdist_recon's
    # one-channel mode on the AO frames with holes, timed
    for v in REBLUR_OCC_VARIANTS:
        runs.append((v, v, v, {}, None, True))
    ds_occ = "REBLUR_DIFFUSE_SPECULAR_OCCLUSION"
    runs.append((f"{ds_occ} AREA_3X3", ds_occ, REBLUR_OCC_HOLES,
                 dict(hitDistanceReconstructionMode="AREA_3X3"), {"hitdist_recon"}, True))
    for v in ("REBLUR_DIFFUSE", "REBLUR_DIFFUSE_SPECULAR"):
        runs.append((f"{v} maxBlurRadius 0", v, v, dict(maxBlurRadius=0.0, minBlurRadius=0.0),
                     {"ts_prelude"}, False))
    for pool, v in ENCODED.items():
        if v.get("relax"):
            runs.append((f"{v['denoiser']} {v['encoding']}", v["denoiser"], pool,
                         dict(v["settings"], roughness_encoding=v["encoding"]),
                         set(ENCODED_KERNELS), set(ENCODED_KERNELS)))
    # directional occlusion: every kernel timed (H3's and H4's kDir), and with AREA_3X3 on the
    # AO with holes, held; REBLUR's specular paths at the encodings: every kernel held, H2's
    # kRough instances timed on REBLUR_SPECULAR
    runs.append((DIR, DIR, DIR, {}, None, True))
    runs.append((f"{DIR} AREA_3X3", DIR, f"{DIR}+AREA_3X3",
                 dict(hitDistanceReconstructionMode="AREA_3X3"), None, False))
    for pool, v in REBLUR_ENCODED.items():
        runs.append((f"{v['denoiser']} {v['encoding']}", v["denoiser"], pool,
                     dict(roughness_encoding=v["encoding"]), None,
                     {"spatial_filter"} if v["denoiser"] == "REBLUR_SPECULAR" else False))
    # the checkerboard PrePass of H2 and N4, timed: (label, path, the pool's suffix, settings)
    # of each run; "+fallback" pools have a material drawn per pixel (`scattered_materials`)
    for label, path, suffix, settings in (
            ("REBLUR_DIFFUSE cb WHITE", "REBLUR_DIFFUSE+CB", "", {}),
            ("REBLUR_DIFFUSE cb WHITE fallback", "REBLUR_DIFFUSE+CB", "+fallback", CB_FALLBACK),
            ("REBLUR_SPECULAR cb BLACK", "REBLUR_SPECULAR+CB", "", {}),
            ("REBLUR_SPECULAR cb BLACK fallback", "REBLUR_SPECULAR+CB", "+fallback",
             CB_FALLBACK),
            ("REBLUR_SPECULAR cb BLACK prepass only", "REBLUR_SPECULAR+CB", "",
             dict(usePrepassOnlyForSpecularMotionEstimation=True)),
            ("REBLUR_DIFFUSE_SPECULAR cb BLACK", "REBLUR_DIFFUSE_SPECULAR+CB", "", {}),
            ("REBLUR_DIFFUSE_SPECULAR cb BLACK fallback", "REBLUR_DIFFUSE_SPECULAR+CB",
             "+fallback", CB_FALLBACK)):
        v = PATHS[path]
        runs.append((label, v["denoiser"], path + suffix, dict(v["settings"], **settings),
                     {"spatial_filter_cb", "spatial_filter_fused_cb"}, True))
    # and the other parity of each signal, held
    for label, path in (("REBLUR_DIFFUSE cb BLACK", "REBLUR_DIFFUSE+CB"),
                        ("REBLUR_SPECULAR cb WHITE", "REBLUR_SPECULAR+CB"),
                        ("REBLUR_DIFFUSE_SPECULAR cb WHITE", "REBLUR_DIFFUSE_SPECULAR+CB")):
        other = "WHITE" if PATHS[path]["cb"] == "BLACK" else "BLACK"
        runs.append((label, PATHS[path]["denoiser"], f"{path}+{other}",
                     dict(checkerboardMode=other),
                     {"spatial_filter_cb", "spatial_filter_fused_cb"}, False))
    # the decoded-plane instances: NORMAL_ENCODED's paths, every call timed; DEC_RUNS, every
    # call held (`dec_variants` adds the other roughness encodings, K12's other modes and H2's,
    # N4's and K23's other tap count)
    for pool, v in {**NORMAL_ENCODED, **DEC_RUNS}.items():
        runs.append((pool, v["denoiser"], pool,
                     dict(v.get("settings", {}), normal_encoding=v["normal_encoding"]), None,
                     pool in NORMAL_ENCODED))
    for band in BAND_PATHS:
        for label, settings in (("", {}), (" anti-firefly", dict(enableAntiFirefly=True)),
                                (" perf", dict(enablePerformanceMode=True))):
            runs.append((band + label, PATHS[band]["denoiser"], band, settings,
                         {"reblur_band"}, {"reblur_band"}))
    return runs


def disagreement(got, want):
    """{output: (max |got - want|, max |got - want| / |want|, values outside ATOL + RTOL
    |want|, values)} of a kernel's result against its plain version's."""
    got, want = _outputs(got), _outputs(want)
    out = {}
    for key in want:
        g, wv = got[key].float(), want[key].float()
        d = (g - wv).abs()
        out[key] = (float(d.max()), float((d / wv.abs().clamp_min(1e-6)).max()),
                    int((d > ATOL + RTOL * wv.abs()).sum()), d.numel())
    return out


def cb_fallback_pixels(name, a, k):
    """The pixels of one checkerboard PrePass call (of kernel module `name`) where a signal's
    weight sum is 0, which take the neighbour resolve: the plain version with a NaN resolve
    marks them."""
    from nrdtpu_torch import kernels as KM

    sf = KM.MODULES["spatial_filter"]
    orig = sf.cb_neighbor_resolve
    sf.cb_neighbor_resolve = lambda signal, *r: torch.full_like(signal, float("nan"))
    try:
        out = _outputs(getattr(KM.MODULES[name], name + "_ref")(*a, **k))
    finally:
        sf.cb_neighbor_resolve = orig
    return sum(int(torch.isnan(v[..., 0]).sum()) for key, v in out.items() if v.dim() == 3)


def _hold(results, name, lab, a, k, timed, extra_bytes=0, key=None):
    """Hold one call of a kernel against its plain version on the same inputs and add it to
    `results` under `key` (the kernel module's name by default); when `timed`, time both, with
    the call's bound and library time. A checkerboard PrePass call also counts the pixels that
    fall back, whose resolve enters the bound's operations."""
    from nrdtpu_torch import kernels as KM

    m = KM.MODULES[name]
    kern, ref = getattr(m, name), getattr(m, name + "_ref")
    got = _outputs(kern(*a, **k))
    diffs = disagreement(got, ref(*a, **k))
    torch.cuda.synchronize()
    fallback = cb_fallback_pixels(name, a, k) if k.get("cb") is not None else 0
    r = results.setdefault(key or name, dict(
        max_abs_err=0.0, max_rel_err=0.0, over=0, count=0, ms={}, plain_ms={}, bound_ms={},
        bound_by=set(), library_ms={}, ms_anti_firefly={}, outputs={}, scratch_bound_ms={},
        dynamic_smem={}, fallback={}))
    if k.get("cb") is not None:  # the pixels that fall back, of the signals' pixels
        fell, px = r["fallback"].get(lab, (0, 0))
        r["fallback"][lab] = (fell + fallback, px + a[0].shape[0] * a[0].shape[1]
                              * (2 if name == "spatial_filter_fused" else 1))
    for kernel, nbytes in _dynamic_smem(name, a, k).items():
        r["dynamic_smem"][kernel] = max(r["dynamic_smem"].get(kernel, 0), nbytes)
    for key, (mx, rel, over, count) in diffs.items():
        o = r["outputs"].setdefault(key, dict(max_abs_err=0.0, over=0, count=0))
        o["max_abs_err"] = max(o["max_abs_err"], mx)
        o["over"] += over
        o["count"] += count
        r["max_abs_err"] = max(r["max_abs_err"], mx)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        r["over"] += over
        r["count"] += count
    if not timed:
        if name in ("history_fix", "history_fix_fused"):
            r["ms_anti_firefly"].setdefault(lab, []).append(time_ms(lambda: kern(*a, **k), 20))
        return
    r["ms"].setdefault(lab, []).append(time_ms(lambda: kern(*a, **k), 20))
    r["plain_ms"].setdefault(lab, []).append(time_ms(lambda: ref(*a, **k), 3))
    b, by = _bound(name, a, k, got, extra_ops=CB_RESOLVE_OPS * fallback)
    r["bound_ms"].setdefault(lab, []).append(b)
    r["bound_by"].add(by)
    if extra_bytes:
        r["scratch_bound_ms"].setdefault(lab, []).append(_bound(name, a, k, got, extra_bytes)[0])
    lib = _library(name, a, k)
    if lib is not None:
        r["library_ms"].setdefault(lab, []).append(time_ms(lib, 20))


def band_chain(label, a, k):
    """The band pass (`spatial_band`: its glue and one launch) and the three-launch chain it
    replaces (`spatial_chain`: N5, the clamp, the parameters and N4 twice, glue included) on
    the same inputs: their times, and how far apart their outputs are."""
    from nrdtpu_torch.passes.reblur import kernels as RK

    runs = {fn.__name__: (lambda fn=fn: fn(*copied(a), **k))
            for fn in (RK.spatial_band, RK.spatial_chain)}
    band, chain = runs["spatial_band"](), runs["spatial_chain"]()  # with SH a third pair
    torch.cuda.synchronize()
    err = max(float((x - y).abs().max()) for p, q in zip(band, chain) for x, y in zip(p, q))
    res = {name: time_ms(fn, 20) for name, fn in runs.items()}
    log(f"band {label}: spatial_band (glue + 1 launch) {res['spatial_band']:.4f} ms, "
        f"spatial_chain (glue + 3 launches) {res['spatial_chain']:.4f} ms, max |band - chain| "
        f"{err:.3g}")
    return dict(pass_ms=res["spatial_band"], chain_ms=res["spatial_chain"], chain_max_abs=err)


def halo_phase(w, h, results):
    """The halo launcher at the slice's size: `box` on 1 and 4 channels, halo 4, blocks
    64x256 and 16x16, each held against its plain version and timed."""
    rng = np.random.default_rng(0)
    for c in (1, 4):
        img = torch.from_numpy(rng.random((h, w) + (() if c == 1 else (c,)),
                                          dtype=np.float32)).cuda()
        for block in ((64, 256), (16, 16)):
            _hold(results, "halo_call", f"box {c} ch, block {block[0]}x{block[1]}",
                  ("box", [img], [c], 4, block), {}, True)


def kernel_phase(w, h, frames):
    """Record the kernel calls of one frame of each run of `kernel_runs` and hold each kernel
    against its plain version on the same inputs, then the halo launcher (`halo_phase`).
    Times and bounds are of the timed runs; the anti-firefly ring's calls of the history
    fixes are timed apart; the band is also timed against the chain it replaces. N4's calls
    are kept apart by stage (PrePass, Blur, PostBlur)."""
    from nrdtpu_torch import kernels as KM
    from nrdtpu_torch.kernels import build
    from nrdtpu_torch.settings import RoughnessEncoding

    LINEAR = RoughnessEncoding.LINEAR
    # the checkerboard runs' pools: materials drawn per pixel, and the other parity
    frames = [(cs, dict(pools), t) for cs, pools, t in frames]
    for cs, pools, _ in frames:
        for path, v in CB_PATHS.items():
            if v.get("relax"):
                continue
            pools[path + "+fallback"] = scattered_materials(pools[path], cs.frameIndex)
            other = "WHITE" if v["cb"] == "BLACK" else "BLACK"
            full = {in_rt(sig): pools[v["denoiser"]][in_rt(sig)] for sig in v["signals"]}
            pools[f"{path}+{other}"] = {**pools[path], **{
                rt: half_width(p, cs.frameIndex, other) for rt, p in full.items()}}
    results, chain = {}, {}
    for label, denoiser, pool, settings, only, timed in kernel_runs():
        stages = iter(SF_STAGES)
        for name, a, k in record_calls(denoiser, pool, w, h, frames, **settings):
            if name == "pass spatial_band":  # timed on the band's own runs
                if pool in BAND_PATHS:
                    chain[label] = band_chain(label, a, k)
                continue
            lab = label
            if name == "spatial_filter_fused":  # a frame's calls: PrePass, Blur, PostBlur
                stage = next(stages)  # the occlusion variants run no PrePass
                if stage == "prepass" and k.get("prepass") is None:
                    stage = next(stages)
                lab = f"{label} {stage}"
            if name == "spatial_filter":
                lab = f"{label} {SF_STAGES[k['mode']]}"
            key = name + "_cb" if k.get("cb") is not None else name
            if name == "spatial_filter" and k.get("roughness_encoding", LINEAR) != LINEAR:
                key = name + "_rough"  # H2's kRough instances
            if k.get("decoded"):  # the decoded-plane instances (kDec)
                key = name + "_dec"
            if name == "sigma_blur":  # a frame's calls: Blur, then PostBlur
                lab = f"{label} {'blur' if k['first_pass'] else 'post_blur'}"
            if name == "relax_history_fix" and timed is True:
                px = a[3].numel()
                live = history_fix_live(a, k)
                log(f"kernel relax_history_fix {label}: {live} of {px} pixels run the taps "
                    f"({live / px:.4f}) on frame {len(frames)}")
            if only is not None and key not in only:
                continue
            # the à-trous ladder's calls are kept apart by stride
            if name == "relax_atrous":
                lab = f"{label} step {k['step_size']}"
            scratch = (BAND_SCRATCH_BYTES_PER_PX * a[0].shape[-1] // 4 * a[0].shape[0]
                       * a[0].shape[1] if name == "reblur_band" else 0)
            _hold(results, name, lab, a, k, timed is True or bool(timed and name in timed),
                  scratch, key)
            if k.get("decoded"):
                for suffix, a2, k2 in dec_variants(name, a, k):
                    _hold(results, name, f"{lab} {suffix}", a2, k2, False, 0, key)
    missing = ((set(KM.MODULES) | set(KM.CB_INSTANCES) | set(KM.ROUGH_INSTANCES)
                | set(KM.DEC_INSTANCES)) - set(results))
    if missing != set(NO_MAIN_PATH):
        raise AssertionError(f"kernels called by no main path: {sorted(missing)}; only "
                             f"{list(NO_MAIN_PATH)} may be")
    halo_phase(w, h, results)
    sass = sass_instructions(build.library_path())
    for name, r in results.items():
        for lab, (fell, px) in r.pop("fallback").items():
            log(f"kernel {name} {lab}: {fell} of {px} pixels fall back to the neighbour "
                f"resolve ({fell / px:.4f})")
        frac = r["over"] / max(r["count"], 1)
        r["over_fraction"] = frac
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "ms_anti_firefly",
                    "scratch_bound_ms"):
            r[key + "_by_path"] = {v: float(np.mean(t)) for v, t in r[key].items()}
            vals = [x for t in r[key].values() for x in t]
            r[key] = float(np.mean(vals)) if vals else None
        r["bound_by"] = "operations" if "operations" in r["bound_by"] else "bytes"
        if name == "reblur_band":
            r["chain_by_path"] = chain
        r["device_kernels"] = occupancy(name, r.pop("dynamic_smem"), sass)
        log(f"kernel {name}: " + ", ".join(
            f"{d['kernel']} {d['registers']} registers, {d['spill_bytes']} B spill, "
            f"{d['shared_bytes']} B shared, {d['ctas_per_sm']} CTAs/SM, "
            f"{d['sass_instructions']} SASS instructions"
            for d in r["device_kernels"]) + f" | max_abs_err {r['max_abs_err']:.3g} max_rel_err "
            f"{r['max_rel_err']:.3g} over-tolerance fraction {frac:.3g} | mean per launch "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']} ms | by path "
            + ", ".join(f"{v}: {r['ms_by_path'][v]:.4f} vs {r['plain_ms_by_path'][v]:.4f} ms, "
                        f"bound {r['bound_ms_by_path'][v]:.4f}" for v in r["ms_by_path"])
            + (" | with the anti-firefly ring "
               + ", ".join(f"{v}: {t:.4f} ms" for v, t in r["ms_anti_firefly_by_path"].items())
               if r["ms_anti_firefly_by_path"] else "")
            + (" | bound with the scratch round trips "
               + ", ".join(f"{v}: {t:.4f} ms" for v, t in r["scratch_bound_ms_by_path"].items())
               if r["scratch_bound_ms_by_path"] else "")
            + " | per output "
            + ", ".join(f"{k}: max_abs {v['max_abs_err']:.3g} over {v['over'] / v['count']:.3g}"
                        for k, v in r["outputs"].items()))
        if frac > FLIP_FRACTION:
            raise AssertionError(f"{name} disagrees with its plain version: {frac:.3g} of "
                                 f"values outside atol={ATOL}, rtol={RTOL}")
    if not set(NO_MAIN_PATH) <= set(results):
        raise AssertionError(f"the halo phase did not run {list(NO_MAIN_PATH)}")
    if len(chain) != 3 * len(BAND_PATHS):
        raise AssertionError(f"the band's pass ran in {sorted(chain)}, not in its "
                             f"{3 * len(BAND_PATHS)} runs")
    return results


def dec_variants(name, a, k):
    """(label suffix, args, kwargs) of the other instances that one decoded-plane call of a
    kernel can be held in on the same inputs: the two other roughness encodings of the kernels
    that decode the roughness (ENCODED_KERNELS), and K12 also at the other radius and, with both
    signals, on each signal alone, at every roughness encoding (its one-channel calls at
    LINEAR); H2, N4 and K23 at the other tap count (performance mode's 6, or 8)."""
    from nrdtpu_torch.settings import RoughnessEncoding

    if name in ("spatial_filter", "spatial_filter_fused", "reblur_band"):
        perf = not k.get("perf_mode", False)  # the other tap count
        return [(f"{'6' if perf else '8'} taps", a, dict(k, perf_mode=perf))]
    if name not in ENCODED_KERNELS:
        return []
    own = k.get("roughness_encoding", RoughnessEncoding.LINEAR)
    # REBLUR's one-channel calls read a plane whose roughness is decoded: LINEAR only
    encodings = ([RoughnessEncoding.LINEAR] if name == "hitdist_recon"
                 and (a[2] if a[2] is not None else a[3]).shape[-1] == 1 else RoughnessEncoding)
    argsets = [("", a)]
    radii = [k.get("radius")]
    if name == "hitdist_recon":
        radii = [1, 2]
        if a[2] is not None and a[3] is not None:
            argsets += [("diffuse alone", (*a[:3], None)), ("specular alone", (*a[:2], None,
                                                                                a[3]))]
    out = []
    for label, args in argsets:
        for radius in radii:
            for enc in encodings:
                if label == "" and radius == k.get("radius") and enc == own:
                    continue  # the call itself
                k2 = dict(k, roughness_encoding=enc)
                if name == "hitdist_recon":
                    k2["radius"] = radius
                suffix = " ".join(x for x in (label, f"radius {radius}" if name ==
                                              "hitdist_recon" else "", enc.name) if x)
                out.append((suffix, args, k2))
    return out


def _min_filter(x, size=9):
    """Minimum over each size x size neighbourhood (in-image pixels only), (h, w) float."""
    t = torch.as_tensor(x, dtype=torch.float32)[None, None]
    return (-torch.nn.functional.max_pool2d(-t, size, stride=1, padding=size // 2))[0, 0].numpy()


def check_shadow(path, out, truth):
    """SIGMA's output criteria (tests/test_sigma.py) on a frame of the orbit scene: in [0, 1],
    dark (< 0.15) in the umbra core (the 9x9 neighbourhood in the analytic umbra), lit on
    average (> 0.99) in the lit core. TS lets the history through where it was darker (the
    "street magic", 0.6 x history weight x antilag), so single lit-core pixels may dip;
    `lit_scene_check` holds every pixel of a scene without occluders above 0.99."""
    out = out.cpu().numpy()
    if not (out.min() >= 0.0 and out.max() <= 1.0):
        raise AssertionError(f"{path}: output outside [0, 1]: [{out.min()}, {out.max()}]")
    shadow = out[..., 0] * out[..., 0]  # SIGMA_BackEnd_UnpackShadow
    geometry = truth["mask"].astype(np.float32)
    lit_core = _min_filter(truth["shadow_clean"] * geometry) > 0.5
    umbra_core = (_min_filter((1.0 - truth["shadow_clean"]) * geometry) > 0.5)
    lit = shadow[lit_core]
    umbra_max = float(shadow[umbra_core].max()) if umbra_core.any() else None
    lit_mean = float(lit.mean()) if lit.size else None
    if lit.size:
        log(f"slice {path}: {lit.size} lit-core pixels, mean {lit_mean}, min {lit.min()}, "
            f"below 0.99 {float((lit < 0.99).mean())}")
    log(f"slice {path}: {int(umbra_core.sum())} umbra-core pixels, max {umbra_max}")
    if lit_mean is None or umbra_max is None:
        if shadow.size >= 1_000_000:  # every full-size orbit frame has both cores
            raise AssertionError(f"{path}: the frame has no lit or no umbra core to check")
        return
    if not (lit_mean > 0.99 and umbra_max < 0.15):
        raise AssertionError(f"{path}: lit core mean {lit_mean} (> 0.99 expected), umbra core "
                             f"max {umbra_max} (< 0.15 expected)")


def lit_scene_check(w=256, h=160, frames=3):
    """tests/test_sigma.py's "fully lit stays lit" on the card: a scene without occluders,
    static camera; every lit geometry pixel of both SIGMA variants' output > 0.99."""
    from nrdtpu_torch import frontend as fe
    from nrdtpu_torch.settings import ResourceType as RT
    from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

    gen = SceneGenerator(SceneSpec(size=(w, h), spheres=()), camera_mode="static")
    for path in ("SIGMA_SHADOW", "SIGMA_SHADOW_TRANSLUCENCY"):
        eng = path_engine(path, w, h, "cuda")
        for i in range(frames):
            fd = gen.frame(i)
            dist = torch.from_numpy(fd.dist_to_occluder)
            pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                    RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
                    RT.IN_PENUMBRA: fe.sigma_pack_penumbra_directional(
                        dist, gen.spec.light_tan_angular_radius).numpy(),
                    RT.IN_TRANSLUCENCY: fe.sigma_pack_translucency(
                        dist, torch.tensor(TRANSLUCENCY_RGB).expand(h, w, 3)).numpy()}
            eng.set_common_settings(fd.common_settings)
            out = eng.denoise([0], pool)[RT.OUT_SHADOW_TRANSLUCENCY].cpu().numpy()
        lit = (fd.hit_mask > 0) & (fd.shadow_clean > 0.5)
        low = float((out[..., 0] ** 2)[lit].min())
        log(f"lit scene {path}: {int(lit.sum())} lit geometry pixels, min {low}")
        if not low > 0.99:
            raise AssertionError(f"{path}: a lit pixel of the occluder-free scene is {low}")


def downsampled(x, rect):
    """A (h, w, ...) plane at the rect by nearest texel: the scene as a renderer at the rect's
    resolution sees it (the motion vectors are in uv, which the rect does not change); dicts
    and tuples of planes plane by plane."""
    if isinstance(x, dict):
        return {k: downsampled(v, rect) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(downsampled(v, rect) for v in x)
    h, w = x.shape[:2]
    rw, rh = rect
    if (rw, rh) == (w, h):
        return x
    ys = ((np.arange(rh) + 0.5) * (h / rh)).astype(np.int64)
    xs = ((np.arange(rw) + 0.5) * (w / rw)).astype(np.int64)
    return x[ys[:, None], xs[None, :]]


def rect_inputs(pool, rect, w, h, device):
    """A path's pool at the rect: each plane downsampled to the rect and pasted into the
    top-left of a resource-sized plane that is NaN elsewhere (the engine must not read there),
    on `device`."""
    out = {}
    for k, v in pool.items():
        small = torch.from_numpy(np.ascontiguousarray(downsampled(v, rect))).to(device)
        full = torch.full((h, w) + tuple(small.shape[2:]), float("nan"), device=device)
        full[:rect[1], :rect[0]] = small
        out[k] = full
    return out


def at_rect(cs, rect, prev):
    """A copy of the common settings with rectSize `rect` and rectSizePrev `prev`."""
    cs = copy.copy(cs)
    cs.rectSize, cs.rectSizePrev = tuple(rect), tuple(prev)
    return cs


def rect_of(w, h, scale):
    return round(w * scale), round(h * scale)


def slice_phase(path, w, h, frames, warmup, rect=None):
    """One main path through the Engine, with its own launch counts; with `rect` at that rect
    of the resource (w, h) (`rect_inputs`, `cs.rectSize`): the outputs resource-sized, 0
    outside the rect and checked inside it. Returns the counts, the median ms/frame and the
    peak allocated bytes."""
    from nrdtpu_torch import frontend as fe
    from nrdtpu_torch import kernels as KM
    from nrdtpu_torch import math as nm

    n = len(frames)
    sh = PATHS[path].get("sh", False)
    eng = path_engine(path, w, h, "cuda")
    name = path if rect is None else f"{path}@{rect[0]}x{rect[1]}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms = [], []
    gains, ao_err = {}, {}
    KM.reset_launch_counts()
    for i, (cs, pools, truth) in enumerate(frames):
        if rect is None:
            pool = {k: torch.from_numpy(v).cuda() for k, v in pools[path].items()}
        else:
            pool = rect_inputs(pools[path], rect, w, h, "cuda")
            cs = at_rect(cs, rect, rect)
            truth = None if truth is None else downsampled(truth, rect)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        eng.set_common_settings(cs)
        with path_env(path):
            outs = eng.denoise([0], pool)
        e1.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        occ = PATHS[path].get("occ", False)
        dirocc = PATHS[path].get("dir", False)
        for label, sig, rt in outputs_of(path):
            out = outs[rt]
            c = 1 if path == "SIGMA_SHADOW" or occ else 4
            if tuple(out.shape) != (h, w, c):
                raise AssertionError(f"{name} frame {i} {label}: output of shape "
                                     f"{tuple(out.shape)}")
            if rect is not None:
                if bool(out[rect[1]:].any()) or bool(out[:, rect[0]:].any()):
                    raise AssertionError(f"{name} frame {i} {label}: not 0 outside the rect")
                out = out[:rect[1], :rect[0]]
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} frame {i} {label}: output not finite")
            if occ and not (float(out.min()) >= 0.0 and float(out.max()) <= 1.0):
                raise AssertionError(f"{name} frame {i} {label}: output outside [0, 1]: "
                                     f"[{float(out.min())}, {float(out.max())}]")
            if truth is None or label.endswith("SH1"):  # SH1: finite and of its shape
                continue
            if occ or dirocc:  # the mean absolute error to the clean AO on the geometry (.w),
                m = truth["mask"]  # against the input's (with its holes where it has them)
                given = truth["ao_punched" if PATHS[path].get("holes") else "ao"][sig]
                ao_err[label] = (float(np.abs(given - truth["ao_clean"])[m].mean()),
                                 float(np.abs(out[..., c - 1].cpu().numpy()
                                              - truth["ao_clean"])[m].mean()))
                continue
            if sig == "shadow":
                check_shadow(name, out, truth)
                continue
            if sh and not PATHS[path].get("relax"):  # REBLUR's SH0: YCoCg and normHitDist
                rgb = fe.sg_extract_color(fe.reblur_unpack_sh(
                    out, outs[sh_rts(sig)[3]])).cpu().numpy()
            elif sh:  # RELAX's SH0 leaves the last à-trous iteration in YCoCg
                rgb = nm.ycocg_to_linear(out[..., :3]).cpu().numpy()
            else:
                unpack = (fe.relax_unpack_radiance if PATHS[path].get("relax")
                          else fe.reblur_unpack_radiance_hitdist)
                rgb = unpack(out)[..., :3].cpu().numpy()
            clean, noisy = truth[sig]
            m = truth["mask"]
            gains[label] = (psnr(noisy[m], clean[m]), psnr(rgb[m], clean[m]))
        if i >= warmup:
            ms.append(e0.elapsed_time(e1))
            host_ms.append(host)
    counts = KM.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: n * PATHS[path]["launches"].get(k, 0) for k in KM.launch_counts()}
    log(f"slice {name}: {n} frames at {w}x{h}, launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{name} launch counts {counts} != {expected}")
    log(f"slice {name}: median {np.median(ms):.3f} ms/frame (CUDA events, {len(ms)} frames "
        f"after {warmup} warm-up; min {min(ms):.3f}, max {max(ms):.3f}); host wall "
        f"{np.median(host_ms):.3f} ms/frame")
    log(f"slice {name}: peak allocated {peak / 1e6:.2f} MB (NRD REBLUR_DIFFUSE working set "
        f"{NRD_WORKING_SET_MB} MB)")
    for sig, (noisy_db, out_db) in gains.items():
        log(f"slice {name} {sig}: PSNR vs clean on geometry: noisy input {noisy_db:.2f} dB, "
            f"denoised {out_db:.2f} dB")
        if not out_db >= noisy_db + 3.0:
            raise AssertionError(f"{name} {sig}: denoised output does not beat the noisy "
                                 f"input by 3 dB: {gains[sig]}")
    for sig, (noisy_err, out_err) in ao_err.items():
        log(f"slice {name} {sig}: mean absolute error to the clean AO on geometry: binary "
            f"input {noisy_err:.4f}, denoised {out_err:.4f}")
        if not out_err < noisy_err:
            raise AssertionError(f"{name} {sig}: denoised AO is no closer to the clean AO than "
                                 f"its binary input: {ao_err[sig]}")
    return counts, float(np.median(ms)), peak


def relax_pair_check(w, h, frames, sh=False):
    """RELAX_DIFFUSE_SPECULAR shares only the TA's head between its signals, and its history
    length is RELAX_DIFFUSE's and RELAX_SPECULAR's (the larger max frame num, the smaller min
    material, the same defaults for both): the JAX package gives its two outputs bit for bit as
    the one-signal variants' on every frame. On the card the two-signal kernel modes must give
    them within the kernels' tolerance, on every frame. With `sh` the same of
    RELAX_DIFFUSE_SPECULAR_SH's four outputs (SH0 and SH1 a signal) against RELAX_DIFFUSE_SH's
    and RELAX_SPECULAR_SH's, which must agree exactly (max abs 0)."""
    suffix = "_SH" if sh else ""
    pair = "RELAX_DIFFUSE_SPECULAR" + suffix
    singles = {"diff": "RELAX_DIFFUSE" + suffix, "spec": "RELAX_SPECULAR" + suffix}
    engs = {p: path_engine(p, w, h, "cuda") for p in (pair, *singles.values())}
    worst = {}  # label: [max abs, values out, values]
    for cs, pools, _ in frames:
        outs = {}
        for p, eng in engs.items():
            eng.set_common_settings(cs)
            pool = {k: torch.from_numpy(v).cuda() for k, v in pools[p].items()}
            outs[p] = eng.denoise([0], pool)
        for label, sig, rt in outputs_of(pair):
            got, want = outs[pair][rt], outs[singles[sig]][rt]
            d = (got - want).abs()
            r = worst.setdefault(label, [0.0, 0, 0])
            r[0] = max(r[0], float(d.max()))
            r[1] += int((d > ATOL + RTOL * want.abs()).sum())
            r[2] += d.numel()
    for label, (mx, over, count) in worst.items():
        log(f"relax pair {label}: {pair} vs the one-signal variant over "
            f"{len(frames)} frames: max abs {mx:.3g}, {over} of {count} values outside "
            f"atol={ATOL}, rtol={RTOL}")
        if over > FLIP_FRACTION * count or (sh and mx != 0.0):
            raise AssertionError(f"{pair} {label} disagrees with the one-signal variant on the "
                                 f"card: max abs {mx:.3g}, {over} of {count} values")
    return {label: dict(max_abs=v[0], over=v[1], count=v[2]) for label, v in worst.items()}


def profile_phase(path, w, h, frames, slice_ms, warmup=4, n=3, rect=None):
    """Device time a frame by kernel name over n traced frames after `warmup` frames (with
    `rect`, the path at that rect, as `slice_phase`); returns the device's busy ms a frame."""
    from torch.profiler import ProfilerActivity, profile

    from nrdtpu_torch import kernels as KM

    eng = path_engine(path, w, h, "cuda")
    if rect is None:
        pools = [(cs, {k: torch.from_numpy(v).cuda() for k, v in p[path].items()})
                 for cs, p, _ in frames[:warmup + n]]
    else:
        pools = [(at_rect(cs, rect, rect), rect_inputs(p[path], rect, w, h, "cuda"))
                 for cs, p, _ in frames[:warmup + n]]
    label = path if rect is None else f"{path}@{rect[0]}x{rect[1]}"
    # the history fix's calls of the traced frames, for its share of pixels that run the taps
    history_fix = types.SimpleNamespace(MODULES={"relax_history_fix":
                                                 KM.MODULES["relax_history_fix"]})
    with path_env(path):
        for cs, pool in pools[:warmup]:
            eng.set_common_settings(cs)
            eng.denoise([0], pool)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                recording(history_fix) as fixes:
            for cs, pool in pools[warmup:]:
                eng.set_common_settings(cs)
                eng.denoise([0], pool)
            torch.cuda.synchronize()
    if fixes:
        shares = [history_fix_live(a, k) / a[3].numel() for _, a, k in fixes]
        log(f"profile {label}: relax_history_fix runs the taps on "
            + ", ".join(f"{x:.4f}" for x in shares) + " of the pixels of the traced frames "
            f"{warmup + 1}-{warmup + n}")

    # device-side events only (kernels, copies): the aten ops that launch them carry the
    # same time as their "self device time" and would count it twice
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError(f"profile {label}: the trace holds no device events")
    by_name = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3 / n, c + 1)
    busy = sum(t for t, _ in by_name.values())
    groups = {"hand kernels": 0.0, "torch.cat / torch.stack copies": 0.0, "rest of the glue": 0.0}
    for name, (t, _) in by_name.items():
        key = ("hand kernels" if any(f"{k}_kernel" in name for k in KM.MODULES)
               else "torch.cat / torch.stack copies" if "CatArrayBatchedCopy" in name
               else "rest of the glue")
        groups[key] += t
    log(f"profile {label}: device busy {busy:.3f} ms/frame, idle share "
        f"{1.0 - busy / slice_ms:.3f} of the slice's {slice_ms:.3f} ms/frame; "
        f"{len(events) / n:.0f} device events a frame; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, c) in ranked[:12]:
        log(f"profile {label}:   {t:8.3f} ms/frame  {c / n:5.0f} x  {name[:90]}")
    for name, (t, c) in ranked:  # every hand kernel of the path, in or below the top 12
        if any(f"{k}_kernel" in name for k in KM.MODULES):
            log(f"profile {label}: hand kernel {t:8.3f} ms/frame  {c / n:5.0f} x  {name[:90]}")
    return busy


def card_vs_cpu_phase(w=256, h=160, frames=3):
    """Every path's outputs on the card against the CPU's plain path on the same frames at
    256x160, REFERENCE, the rect sequence and the SNORM sky fault."""
    frames = list(Scene(w, h).frames(frames, workers=1))
    sq = "RELAX_SPECULAR+SQ_LINEAR"
    encoded = [p for p in ENCODED if not ENCODED[p].get("relax")]
    for path in (*PATHS, sq, *encoded, *OCC_CB, *DIR_EXTRA):
        cuda, cpu = path_engine(path, w, h, "cuda"), path_engine(path, w, h, "cpu")
        worst = {label: float("inf") for label, _, _ in outputs_of(path)}
        for i, (cs, pools, _) in enumerate(frames):
            outs = []
            for eng in (cuda, cpu):
                eng.set_common_settings(cs)
                with path_env(path):
                    outs.append(eng.denoise([0], pools[path]))
            for label, _, rt in outputs_of(path):
                p = psnr(outs[0][rt].cpu().numpy(), outs[1][rt].cpu().numpy())
                worst[label] = min(worst[label], p)
                log(f"card vs cpu {path} {label} frame {i}: {p:.2f} dB")
        for label, p in worst.items():
            if p < 50.0:
                raise AssertionError(f"{path} {label}: card and CPU disagree: {p:.2f} dB < 50 dB")
    reference_card_vs_cpu(w, h, len(frames))
    rect_card_vs_cpu(w, h)
    snorm_sky_fault(w, h, len(frames))


def snorm_sky_fault(w, h, n):
    """RELAX_SPECULAR at RGBA8_SNORM on the scene's own sky normal of 0, which SNORM packs as
    0 and decodes to 0: N.V is 0 there, and the specular TA's surface-motion confidence divides
    0 by 0 (the JAX reference's fault, ROADMAP.md Queue 3, which the port does not guard). The
    non-finite output pixels of the card's kernels and of the CPU's plain versions on each
    frame, on geometry and in all; printed, no bar. Every kernel call of the card's engine is
    also held against its plain version on the same inputs (`held_calls`), and the calls
    whose outputs hold non-finite values elsewhere than the plain version's are printed: they
    name the kernels that turn the NaN finite or keep it. K16 `relax_smb_resolve`, K17
    `relax_vmb_resolve`, K20 `relax_clamp_moments` and K22 `relax_atrous` must be none of them
    (their CatRom reads every texel the plain version multiplies, a weight of 0 included, and
    their min, max and saturate keep NaN as the plain version's do)."""
    from nrdtpu_torch import frontend as fe
    from nrdtpu_torch.settings import ResourceType as RT

    scene = Scene(w, h)
    engs = {d: engine("RELAX_SPECULAR", w, h, d, normal_encoding="RGBA8_SNORM")
            for d in ("cuda", "cpu")}
    kept = ("relax_smb_resolve", "relax_vmb_resolve", "relax_clamp_moments", "relax_atrous")
    kept_calls, kept_split = {n: 0 for n in kept}, []
    for i in range(n):
        fd = scene.gen.frame(i)
        cs = fd.common_settings
        cs.timeDeltaBetweenFrames = 16.66
        pool = {RT.IN_VIEWZ: fd.view_z, RT.IN_MV: fd.mv,
                RT.IN_NORMAL_ROUGHNESS: scene.gen.packed_normal_roughness(fd, "RGBA8_SNORM"),
                RT.IN_SPEC_RADIANCE_HITDIST: fe.relax_pack_radiance_hitdist(
                    torch.from_numpy(fd.spec_noisy), torch.from_numpy(fd.spec_hit_dist)).numpy()}
        geometry = torch.from_numpy(fd.hit_mask > 0)
        counts, split = [], []
        for d, eng in engs.items():
            eng.set_common_settings(cs)
            with held_calls() if d == "cuda" else contextlib.nullcontext(split) as got:
                out = eng.denoise([0], pool)[RT.OUT_SPEC_RADIANCE_HITDIST].cpu()
            split = got
            bad = ~torch.isfinite(out).all(-1)
            counts.append(f"{d} {int((bad & geometry).sum())} on geometry, {int(bad.sum())} "
                          f"in all")
        log(f"snorm sky fault RELAX_SPECULAR RGBA8_SNORM frame {i}, sky normal 0: non-finite "
            f"pixels of {w * h}: " + "; ".join(counts))
        for c, (name, dec, key, n_in, n_kern, n_plain) in split.entries:
            log(f"snorm sky fault frame {i} call {c} {name}{'_dec' if dec else ''} output "
                f"{key}: non-finite values: inputs {n_in}, kernel {n_kern}, plain {n_plain}")
            if name in kept:
                kept_split.append((i, c, name, key, n_in, n_kern, n_plain))
        for n_ in kept:
            kept_calls[n_] += split.calls.get(n_, 0)
        log(f"snorm sky fault frame {i}: {len(split.entries)} card outputs hold non-finite "
            f"values elsewhere than their plain versions'; " + "; ".join(
                f"{n_} {split.non_finite.get(n_, (0, 0))} non-finite values (kernel, plain) in "
                f"its {split.calls.get(n_, 0)} call(s)" for n_ in kept))
    if not all(kept_calls.values()) or kept_split:
        raise AssertionError(f"K16, K17, K20 and K22 on NaN inputs: calls {kept_calls}, the "
                             f"kernels' non-finite values differ from the plain versions' in "
                             f"{kept_split}")


@contextlib.contextmanager
def held_calls():
    """While open, every kernel call on the card (`kernels.MODULES`; a CPU engine's plain
    calls pass through) also runs its plain version on the same inputs. It yields a namespace:
    `held` gets (call index, kernel, values outside ATOL + RTOL |plain| (`disagreement`, on the
    values the plain version has finite), values, largest |kernel - plain| there) for each
    call; `entries` gets (call index, (kernel, decoded, output, non-finite input values,
    non-finite values of the kernel's output, of the plain version's)) for each output whose
    non-finite values lie elsewhere than the plain version's; `calls` counts each kernel's
    calls and `non_finite` sums, per kernel, the non-finite values of its outputs (kernel,
    plain)."""
    from nrdtpu_torch import kernels as KM

    split = types.SimpleNamespace(held=[], entries=[], calls={}, non_finite={})
    index = [0]
    saved = [(m, name, getattr(m, name)) for name, m in KM.MODULES.items()]

    def check(name, f, ref):
        def call(*a, **k):
            r = f(*a, **k)
            if not any(t.is_cuda for t in _tensors((a, k))):
                return r
            got, want = _outputs(r), _outputs(ref(*a, **k))
            n_in = sum(int((~torch.isfinite(t)).sum()) for t in _tensors((a, k))
                       if t.is_floating_point())
            split.calls[name] = split.calls.get(name, 0) + 1
            over = count = 0
            worst = 0.0
            for key in want:
                bad = [~torch.isfinite(o[key].float()) for o in (got, want)]
                nk, npl = (int(b.sum()) for b in bad)
                tk, tp = split.non_finite.get(name, (0, 0))
                split.non_finite[name] = (tk + nk, tp + npl)
                if not torch.equal(*bad):
                    split.entries.append(
                        (index[0], (name, bool(k.get("decoded")), key, n_in, nk, npl)))
                fin = ~bad[1]
                if bool(fin.any()):
                    mx, _, o, n = disagreement({key: got[key][fin]}, {key: want[key][fin]})[key]
                    over, count, worst = over + o, count + n, max(worst, mx)
            split.held.append((index[0], name, over, count, worst))
            index[0] += 1
            return r
        return call
    try:
        for m, name, f in saved:
            setattr(m, name, check(name, f, getattr(m, name + "_ref")))
        yield split
    finally:
        for m, name, f in saved:
            setattr(m, name, f)


def reference_card_vs_cpu(w, h, n):
    """REFERENCE (plain accumulation, no kernel) on a static camera, so that the history
    builds up: the card's output against the CPU's, and the accumulation against the running
    mean of its inputs."""
    from nrdtpu_torch import settings as S
    from nrdtpu_torch.engine import Engine
    from nrdtpu_torch.settings import ResourceType as RT
    from nrdtpu_torch.utils.scene import SceneGenerator, SceneSpec

    gen = SceneGenerator(SceneSpec(size=(w, h), noise=0.5), camera_mode="static")
    engs = [Engine({0: S.Denoiser.REFERENCE}, resource_size=(w, h), device=d)
            for d in ("cuda", "cpu")]
    signals = []
    for i in range(n):
        fd = gen.frame(i)
        signals.append(np.concatenate([fd.diff_noisy, fd.diff_hit_dist[..., None]], -1))
        outs = []
        for eng in engs:
            eng.set_common_settings(fd.common_settings)
            outs.append(eng.denoise([0], {RT.IN_SIGNAL: signals[-1]})[RT.OUT_SIGNAL].cpu().numpy())
        p = psnr(outs[0], outs[1])
        log(f"card vs cpu REFERENCE frame {i}: {p:.2f} dB")
        if p < 50.0:
            raise AssertionError(f"REFERENCE: card and CPU disagree: {p:.2f} dB < 50 dB")
    err = float(np.abs(outs[0] - np.mean(signals, axis=0)).max())
    log(f"REFERENCE: max |output - running mean of {n} frames| {err:.3g}")
    if not err < 1e-4:
        raise AssertionError(f"REFERENCE does not accumulate the running mean: {err}")


def check_held(label, split):
    """Each call of `held_calls` on its own: at most FLIP_FRACTION of its values outside the
    tolerance, and its non-finite values where the plain version's are. Logs each kernel's
    calls and its worst call."""
    by_kernel = {}
    for c, name, over, count, worst in split.held:
        by_kernel.setdefault(name, []).append((over / max(count, 1), over, count, worst, c))
    for name, calls in sorted(by_kernel.items()):
        frac, over, count, _, c = max(calls)
        log(f"{label}: {name} held on {len(calls)} call(s) one by one: worst call {c} {over} "
            f"of {count} values out of tolerance; max |d| {max(x[3] for x in calls):.3g}")
        if frac > FLIP_FRACTION:
            raise AssertionError(f"{label}: {name} call {c} disagrees with its plain version: "
                                 f"{over} of {count} values")
    if split.entries:
        raise AssertionError(f"{label}: non-finite values elsewhere than the plain versions' "
                             f"in {split.entries}")
    if not by_kernel:
        raise AssertionError(f"{label}: no kernel call")


def rect_sequence(path, w, h, frames, rects, each, cpu=False):
    """One engine of the path on the card through a rect sequence, `each` frames at each rect
    of the resource (w, h), `cs.rectSizePrev` the rect of the frame before (so the history
    migrates at each change): every kernel call held on its own against its plain version
    (`held_calls`, `check_held`), the outputs resource-sized, finite inside the rect and 0
    outside, the state at the rect's shape. With `cpu` an engine on the CPU runs the same
    frames, and every card output must be >= 50 dB against it inside the rect."""
    label = f"rect sequence {path} at {w}x{h} (" + ", ".join(f"{a}x{b}" for a, b in rects) + ")"
    engs = {d: path_engine(path, w, h, d) for d in (("cuda", "cpu") if cpu else ("cuda",))}
    seq = [r for r in rects for _ in range(each)]
    worst = {}
    with held_calls() as split:
        for i, (rect, (cs, pools, _)) in enumerate(zip(seq, frames)):
            rw, rh = rect
            cs = at_rect(cs, rect, seq[max(i - 1, 0)])
            outs = {}
            for d, eng in engs.items():
                eng.set_common_settings(cs)
                with path_env(path):
                    outs[d] = eng.denoise([0], rect_inputs(pools[path], rect, w, h, d))
                st = eng.get_state(0)
                bad = [k for k, t in st.items() if t.ndim >= 2 and tuple(t.shape[:2]) != (rh, rw)]
                if bad:
                    raise AssertionError(f"{label} frame {i} {d}: state {bad} not at the rect")
            for name, _, rt in outputs_of(path):
                out = outs["cuda"][rt]
                if tuple(out.shape[:2]) != (h, w):
                    raise AssertionError(f"{label} frame {i} {name}: shape {tuple(out.shape)}")
                if bool(out[rh:].any()) or bool(out[:, rw:].any()):
                    raise AssertionError(f"{label} frame {i} {name}: not 0 outside the rect")
                inside = out[:rh, :rw]
                if not bool(torch.isfinite(inside).all()):
                    raise AssertionError(f"{label} frame {i} {name}: not finite in the rect")
                if cpu:
                    p = psnr(inside.cpu().numpy(), outs["cpu"][rt][:rh, :rw].cpu().numpy())
                    worst[name] = min(worst.get(name, float("inf")), p)
        torch.cuda.synchronize()
    check_held(label, split)
    for name, p in worst.items():
        log(f"{label} {name}: card vs cpu worst frame {p:.2f} dB")
        if p < 50.0:
            raise AssertionError(f"{label} {name}: card and CPU disagree: {p:.2f} dB < 50 dB")


def rect_phase(w, h, frames, warmup, counts, slice_ms, peaks, busy):
    """Dynamic resolution at the full size: each RECT_PATHS path's slice at the rect
    RECT_SLICE_SCALE of the resource (its counts, ms/frame and peak memory added under
    `<path>@<w>x<h>`), the device time a frame of it, of its full-rect slice and of the
    performance-mode path (`PROFILED`; `busy` holds those that `--profile` has traced), a
    summary line a path, then the rect sequence (RECT_SCALES) of each RECT_HELD path with every
    kernel call held."""
    rect = rect_of(w, h, RECT_SLICE_SCALE)
    for path in PROFILED:
        if path not in busy:
            busy[path] = profile_phase(path, w, h, frames, slice_ms[path])
    for path in RECT_PATHS:
        key = f"{path}@{rect[0]}x{rect[1]}"
        counts[key], slice_ms[key], peaks[key] = slice_phase(path, w, h, frames, warmup, rect)
        busy[key] = profile_phase(path, w, h, frames, slice_ms[key], rect=rect)
        log(f"rect cell {path}: at {w}x{h} {slice_ms[path]:.3f} ms/frame, device busy "
            f"{busy[path]:.3f} ms, peak {peaks[path] / 1e6:.2f} MB; at the rect {rect[0]}x"
            f"{rect[1]} {slice_ms[key]:.3f} ms/frame, device busy {busy[key]:.3f} ms, peak "
            f"{peaks[key] / 1e6:.2f} MB; launches a frame {PATHS[path]['launches']} in both")
    perf = "REBLUR_DIFFUSE_SPECULAR+PERF"
    log(f"performance mode {perf}: {slice_ms[perf]:.3f} ms/frame, device busy {busy[perf]:.3f} "
        f"ms at {w}x{h}; REBLUR_DIFFUSE_SPECULAR {slice_ms['REBLUR_DIFFUSE_SPECULAR']:.3f} "
        f"ms/frame, device busy {busy['REBLUR_DIFFUSE_SPECULAR']:.3f} ms")
    rects = [rect_of(w, h, f) for f in RECT_SCALES]
    for path in RECT_HELD:
        rect_sequence(path, w, h, frames, rects, RECT_FRAMES_EACH)


def rect_card_vs_cpu(w, h):
    """The rect sequence SMALL_RECTS at 256x160, a frame a rect, on the card and on the CPU
    (`rect_sequence`)."""
    frames = list(Scene(w, h).frames(len(SMALL_RECTS), workers=1))
    for path in RECT_PATHS:
        rect_sequence(path, w, h, frames, SMALL_RECTS, 1, cpu=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--frames", type=int, default=24, help="timed frames of each slice")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each path with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from nrdtpu_torch.kernels import build

    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    build.library()
    log(f"build: {build.build_seconds:.2f} s")

    warmup = 3
    # the frames are made first, so that the scene generator's threads do not compete with
    # the denoiser for the host while it is timed; every path reads the same frames
    t0 = time.perf_counter()
    frames = list(Scene(args.width, args.height).frames(warmup + args.frames))
    log(f"scene: {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    kr = kernel_phase(args.width, args.height, frames[:4])
    log(f"phase kernels: done at {time.perf_counter() - t_start:.1f} s")
    counts, slice_ms, peaks = {}, {}, {}
    for path in PATHS:
        counts[path], slice_ms[path], peaks[path] = slice_phase(path, args.width, args.height,
                                                                frames, warmup)
        log(f"phase slice {path}: done at {time.perf_counter() - t_start:.1f} s")
    relax_pair_check(args.width, args.height, frames)
    relax_pair_check(args.width, args.height, frames, sh=True)
    log(f"phase relax pair: done at {time.perf_counter() - t_start:.1f} s")
    busy = {}
    if args.profile:
        for path in PATHS:
            busy[path] = profile_phase(path, args.width, args.height, frames, slice_ms[path])
        log(f"phase profile: done at {time.perf_counter() - t_start:.1f} s")
    rect_phase(args.width, args.height, frames, warmup, counts, slice_ms, peaks, busy)
    log(f"phase dynamic resolution: done at {time.perf_counter() - t_start:.1f} s")
    del frames
    lit_scene_check()
    card_vs_cpu_phase()
    log(f"phase card vs cpu: done at {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces, also) in SOURCES.items():
        r = kr[name]
        k = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=sum(c[name] for c in counts.values()),
                 max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                 registers=max(d["registers"] for d in r["device_kernels"]),
                 spill_bytes=max(d["spill_bytes"] for d in r["device_kernels"]),
                 ctas_per_sm=min(d["ctas_per_sm"] for d in r["device_kernels"]),
                 sass_instructions=(None if any(d["sass_instructions"] is None
                                                for d in r["device_kernels"])
                                    else sum(d["sass_instructions"]
                                             for d in r["device_kernels"])),
                 device_kernels=r["device_kernels"],
                 launches_by_path={v: c[name] for v, c in counts.items()},
                 ms_by_path=r["ms_by_path"], plain_ms_by_path=r["plain_ms_by_path"],
                 bound_ms_by_path=r["bound_ms_by_path"])
        if r["ms_anti_firefly_by_path"]:
            k["ms_anti_firefly_by_path"] = r["ms_anti_firefly_by_path"]
        if r["scratch_bound_ms_by_path"]:
            k["bound_ms_with_scratch_by_path"] = r["scratch_bound_ms_by_path"]
        if "chain_by_path" in r:
            k["band_vs_chain_by_path"] = r["chain_by_path"]
        if also:
            k["also_replaces"] = also
        kernels.append(k)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
