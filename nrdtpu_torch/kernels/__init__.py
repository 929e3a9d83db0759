"""Hand-written CUDA kernels (sm_90a) of the REBLUR_DIFFUSE, REBLUR_SPECULAR and
REBLUR_DIFFUSE_SPECULAR paths, one module each.

Every module holds the kernel's wrapper, its plain PyTorch version (`*_ref`) and a launch
count (`launches`). The wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.

  smb_resolve    <- nrdtpu/kernels/reblur_pallas.py:577 reblur_smb_resolve
  spatial_filter <- nrdtpu/kernels/reblur_blur2.py:264 spatial_filter_taps_pallas2
  history_fix    <- nrdtpu/kernels/reblur_hfix2.py:222 history_fix_taps_pallas2
  ts_prelude     <- nrdtpu/kernels/reblur_pallas.py:1754 moments_minmax_pallas
                    + nrdtpu/kernels/reblur_pallas.py:1705 hist_sample_pallas
  spec_ta_head   <- nrdtpu/kernels/reblur_pallas.py:942 spec_ta_head
                    (= :882 spec_prelude + :847 shift_planes + :171 nearest_resolve)
  nearest_multi  <- nrdtpu/kernels/reblur_pallas.py:219 nearest_resolve_multi
  vmb_resolve    <- nrdtpu/kernels/reblur_pallas.py:779 reblur_vmb_resolve
  spatial_filter_fused <- nrdtpu/kernels/reblur_fused.py:787 spatial_filter_fused_pallas
  history_fix_fused    <- nrdtpu/kernels/reblur_fused.py:668 history_fix_fused_pallas
"""

from . import (history_fix, history_fix_fused, nearest_multi, smb_resolve, spatial_filter,
               spatial_filter_fused, spec_ta_head, ts_prelude, vmb_resolve)

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
}


def reset_launch_counts():
    for m in MODULES.values():
        m.launches = 0


def launch_counts() -> dict:
    return {name: m.launches for name, m in MODULES.items()}
