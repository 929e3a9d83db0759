"""Hand-written CUDA kernels (sm_90a) of the REBLUR_DIFFUSE, REBLUR_SPECULAR,
REBLUR_DIFFUSE_SPECULAR (also under NRDTPU_REBLUR_BAND=1), SIGMA_SHADOW,
SIGMA_SHADOW_TRANSLUCENCY, RELAX_DIFFUSE, RELAX_SPECULAR and RELAX_DIFFUSE_SPECULAR paths (the
REBLUR and RELAX ones also with SH, the REBLUR ones also on one channel for the occlusion
variants and for REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION; the REBLUR and the non-SH RELAX ones also
under checkerboard and at every roughness encoding; all of them also at the RGBA normal
encodings, on the decoded normal plane), one module each, and
the halo-window launcher, which no path calls (as in the JAX package).

Every module holds the kernel's wrapper, its plain PyTorch version (`*_ref`) and a launch
count (`launches`). The wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other. A v1 twin below is the
kernel that `nrdtpu/kernels/__init__.py` selects for the same pass under NRDTPU_BLUR=1.

  smb_resolve    <- nrdtpu/kernels/reblur_pallas.py:577 reblur_smb_resolve
  spatial_filter <- nrdtpu/kernels/reblur_blur2.py:264 spatial_filter_taps_pallas2
                    (and its v1 twin nrdtpu/kernels/reblur_pallas.py:1207), with its
                    checkerboard PrePass (`has_cb`, :270)
  history_fix    <- nrdtpu/kernels/reblur_hfix2.py:222 history_fix_taps_pallas2
                    (and its v1 twin nrdtpu/kernels/reblur_pallas.py:1446)
  ts_prelude     <- nrdtpu/kernels/reblur_pallas.py:1754 moments_minmax_pallas
                    + nrdtpu/kernels/reblur_pallas.py:1705 hist_sample_pallas
  spec_ta_head   <- nrdtpu/kernels/reblur_pallas.py:942 spec_ta_head
                    (= :882 spec_prelude + :847 shift_planes + :171 nearest_resolve)
  nearest_multi  <- nrdtpu/kernels/reblur_pallas.py:219 nearest_resolve_multi
  vmb_resolve    <- nrdtpu/kernels/reblur_pallas.py:779 reblur_vmb_resolve
  spatial_filter_fused <- nrdtpu/kernels/reblur_fused.py:787 spatial_filter_fused_pallas,
                          with its checkerboard PrePass (`FSig.has_cb`, :153-158)
  history_fix_fused    <- nrdtpu/kernels/reblur_fused.py:668 history_fix_fused_pallas
  hitdist_recon  <- nrdtpu/kernels/reblur_pallas.py:1596 hitdist_recon_pallas
  sigma_blur     <- nrdtpu/kernels/sigma_blur2.py:281 sigma_blur_pallas2
                    (and its v1 twin nrdtpu/kernels/sigma_pallas.py:291 sigma_blur_pallas)
  sigma_ts       <- nrdtpu/kernels/sigma_pallas.py:449 sigma_ts_pallas
  relax_prepass       <- nrdtpu/kernels/relax_pallas.py:751 relax_prepass_taps_pallas (K15)
  relax_smb_resolve   <- nrdtpu/kernels/relax_pallas.py:1000 relax_smb_resolve (K16)
  relax_history_fix   <- nrdtpu/kernels/relax_pallas.py:1499 relax_history_fix_pallas (K19)
  relax_clamp_moments <- nrdtpu/kernels/relax_pallas.py:479 relax_clamp_moments_pallas (K20)
  relax_atrous        <- nrdtpu/kernels/relax_pallas.py:338 relax_atrous_pallas (K22)
  relax_vmb_resolve   <- nrdtpu/kernels/relax_pallas.py:1219 relax_vmb_resolve (K17)
  relax_antifirefly   <- nrdtpu/kernels/relax_pallas.py:537 relax_antifirefly_pallas (K21)
  bilinear_resolve    <- nrdtpu/kernels/reblur_pallas.py:1813 bilinear_resolve
  reblur_band         <- nrdtpu/kernels/reblur_band.py:496 reblur_spatial_band (K23)
  halo_call           <- nrdtpu/kernels/halo.py:30 halo_call (K24)
"""

from . import (bilinear_resolve, halo, history_fix, history_fix_fused, hitdist_recon,
               nearest_multi, reblur_band, relax_antifirefly, relax_atrous, relax_clamp_moments,
               relax_history_fix, relax_prepass, relax_smb_resolve, relax_vmb_resolve,
               sigma_blur, sigma_ts, smb_resolve, spatial_filter, spatial_filter_fused,
               spec_ta_head, ts_prelude, vmb_resolve)

MODULES = {
    "smb_resolve": smb_resolve,
    "spatial_filter": spatial_filter,
    "history_fix": history_fix,
    "ts_prelude": ts_prelude,
    "spec_ta_head": spec_ta_head,
    "nearest_multi": nearest_multi,
    "vmb_resolve": vmb_resolve,
    "spatial_filter_fused": spatial_filter_fused,
    "history_fix_fused": history_fix_fused,
    "hitdist_recon": hitdist_recon,
    "sigma_blur": sigma_blur,
    "sigma_ts": sigma_ts,
    "relax_prepass": relax_prepass,
    "relax_smb_resolve": relax_smb_resolve,
    "relax_history_fix": relax_history_fix,
    "relax_clamp_moments": relax_clamp_moments,
    "relax_atrous": relax_atrous,
    "relax_vmb_resolve": relax_vmb_resolve,
    "relax_antifirefly": relax_antifirefly,
    "bilinear_resolve": bilinear_resolve,
    "reblur_band": reblur_band,
    "halo_call": halo,
}


# the checkerboard PrePass instances of H2 and N4: their launches are also counted apart
# (`cb_launches`), under these names
CB_INSTANCES = {"spatial_filter_cb": spatial_filter,
                "spatial_filter_fused_cb": spatial_filter_fused}
# H2's specular instances that decode the taps' roughness at SQRT_LINEAR / SQ_LINEAR (`kRough`):
# their launches are also counted apart (`rough_launches`), under this name
ROUGH_INSTANCES = {"spatial_filter_rough": spatial_filter}
# the instances that read the RGBA normal encodings' decoded plane (`kDec`,
# `frontend.decode_normal_plane`): their launches are also counted apart (`dec_launches`), under
# these names
DEC_INSTANCES = {"relax_prepass_dec": relax_prepass, "relax_smb_resolve_dec": relax_smb_resolve,
                 "relax_vmb_resolve_dec": relax_vmb_resolve,
                 "relax_history_fix_dec": relax_history_fix,
                 "relax_antifirefly_dec": relax_antifirefly, "relax_atrous_dec": relax_atrous,
                 "hitdist_recon_dec": hitdist_recon, "sigma_blur_dec": sigma_blur,
                 "smb_resolve_dec": smb_resolve, "spec_ta_head_dec": spec_ta_head,
                 "vmb_resolve_dec": vmb_resolve, "spatial_filter_dec": spatial_filter,
                 "history_fix_dec": history_fix, "ts_prelude_dec": ts_prelude,
                 "spatial_filter_fused_dec": spatial_filter_fused,
                 "history_fix_fused_dec": history_fix_fused, "reblur_band_dec": reblur_band}


# the kernels with a row-origin mode (`parallel.shard_stencil`): each module names its wrapper's
# previous-frame arguments in PREVIOUS_PLANES
ROW_ORIGIN = tuple(name for name, m in MODULES.items() if hasattr(m, "PREVIOUS_PLANES"))


def reset_launch_counts():
    for m in MODULES.values():
        m.launches = 0
    for m in CB_INSTANCES.values():
        m.cb_launches = 0
    for m in ROUGH_INSTANCES.values():
        m.rough_launches = 0
    for m in DEC_INSTANCES.values():
        m.dec_launches = 0


def launch_counts() -> dict:
    """{module: its launches}, {CB_INSTANCES name: its checkerboard launches},
    {ROUGH_INSTANCES name: its launches at a non-linear roughness encoding} and
    {DEC_INSTANCES name: its launches on the decoded normal plane}."""
    return ({name: m.launches for name, m in MODULES.items()}
            | {name: m.cb_launches for name, m in CB_INSTANCES.items()}
            | {name: m.rough_launches for name, m in ROUGH_INSTANCES.items()}
            | {name: m.dec_launches for name, m in DEC_INSTANCES.items()})
