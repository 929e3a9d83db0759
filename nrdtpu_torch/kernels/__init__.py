"""Hand-written CUDA kernels (sm_90a) of the REBLUR_DIFFUSE path, one module each.

Every module holds the kernel's wrapper, its plain PyTorch version (`*_ref`) and a launch
count (`launches`). The wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.

  smb_resolve    <- nrdtpu/kernels/reblur_pallas.py:577 reblur_smb_resolve
  spatial_filter <- nrdtpu/kernels/reblur_blur2.py:264 spatial_filter_taps_pallas2
  history_fix    <- nrdtpu/kernels/reblur_hfix2.py:222 history_fix_taps_pallas2
  ts_prelude     <- nrdtpu/kernels/reblur_pallas.py:1754 moments_minmax_pallas
                    + nrdtpu/kernels/reblur_pallas.py:1705 hist_sample_pallas
"""

from . import history_fix, smb_resolve, spatial_filter, ts_prelude

MODULES = {
    "smb_resolve": smb_resolve,
    "spatial_filter": spatial_filter,
    "history_fix": history_fix,
    "ts_prelude": ts_prelude,
}


def reset_launch_counts():
    for m in MODULES.values():
        m.launches = 0


def launch_counts() -> dict:
    return {name: m.launches for name, m in MODULES.items()}
