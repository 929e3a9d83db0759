"""Rehearsal on the CPU of the hand kernels at a rect smaller than the resource and across rect
changes: the `.cu` sources as they are in the tree, compiled as C++ by g++ through
`tests/cuda_shim.h` and bound through the same ctypes entry points as on the card (the
machinery of `tests/test_torch_kernel_rehearsal.py`).

The calls are those the port's Engine makes on the CPU over the rect sequence of
`tests/test_torch_rect_slice.py` (resource 64x48; rects 56x41, 56x41, 48x37, 56x41, the scene
made at each rect and NaN outside it): every call of frames 2 and 3, where the planes have the
new rect's shape and `rect_size_prev` is the rect before (48x37 after 56x41, a shrink; 56x41
after 48x37, a grow), and where 48x37 and 56x41 leave partial 16x16 CTAs at the bottom and
right edges. The runs (`RUNS`): REBLUR_DIFFUSE_SPECULAR (H1, H4, N1, N2, N3, N4,
N5), the same under the band (K23), REBLUR_SPECULAR (H2, H3), RELAX_DIFFUSE_SPECULAR (K15,
K16, K17, N2, `bilinear_resolve`, K19, K20, K22, every à-trous stride with the staged
iteration 0), SIGMA_SHADOW_TRANSLUCENCY (K13 Blur and PostBlur, K14),
REBLUR_DIFFUSE_SPECULAR with AREA_3X3 (K12's staged (16 + 2r)^2 window) and RELAX_SPECULAR with
the anti-firefly pass (K21). Each kernel is held against its plain version on all its calls
(`test_rect_rehearsal`).

Mutations run on a copy of the tree, each of which failed the run: H1's history window clamped
to `rect_prev` in place of the plane's dims (`smb_resolve.cu`, col / row: `[DS-smb_resolve]`
fails), K16's the same (`[RDS-relax_smb_resolve]` fails), and N2's and K22's partial-CTA guard
dropped (`if (x >= a.w || y >= a.h) return;`, or its x test alone: the threads past the right
edge write out of bounds, which crashes the rehearsal's process).

Run alone: python -m pytest tests/test_torch_rect_rehearsal.py -q

Tolerance: that of `chip_smoke.py` on the card, |kernel - plain| <= 1e-4 + 1e-4 |plain| on all
but 1e-4 of the values.
"""

import pytest
import torch

from nrdtpu_torch import kernels as KM
from nrdtpu_torch.engine import Engine
from nrdtpu_torch.settings import Denoiser, HitDistanceReconstructionMode as HM, replace

from test_torch_kernel_rehearsal import _hold, shared_library
from test_torch_rect_slice import RECTS, SIZE, frames

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

FLIP_FRACTION = 1e-4
HELD_FRAMES = (2, 3)
# run: (variant, band, the kernels it calls)
RUNS = {
    "DS": ("REBLUR_DIFFUSE_SPECULAR", False,
           ("smb_resolve", "ts_prelude", "spec_ta_head", "nearest_multi", "vmb_resolve",
            "spatial_filter_fused", "history_fix_fused")),
    "DS_BAND": ("REBLUR_DIFFUSE_SPECULAR", True, ("reblur_band",)),
    "S": ("REBLUR_SPECULAR", False, ("spatial_filter", "history_fix")),
    "RDS": ("RELAX_DIFFUSE_SPECULAR", False,
            ("relax_prepass", "relax_smb_resolve", "relax_vmb_resolve", "nearest_multi",
             "bilinear_resolve", "relax_history_fix", "relax_clamp_moments", "relax_atrous")),
    "ST": ("SIGMA_SHADOW_TRANSLUCENCY", False, ("sigma_blur", "sigma_ts")),
    "DS_AREA_3X3": ("REBLUR_DIFFUSE_SPECULAR", False, ("hitdist_recon",)),
    "RS_AF": ("RELAX_SPECULAR", False, ("relax_antifirefly",)),
}
# settings changed from the defaults, per run
SETTINGS = {"DS_AREA_3X3": dict(hitDistanceReconstructionMode=HM.AREA_3X3),
            "RS_AF": dict(enableAntiFirefly=True)}
CASES = [(run, k) for run, (_, _, ks) in RUNS.items() for k in ks]


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    return shared_library(tmp_path_factory)


@pytest.fixture(scope="module")
def calls():
    """{run: {kernel: [(rect, rect_prev, call), ...]}} of frames 2 and 3 of RECTS."""
    out = {}
    rects = RECTS
    for run, (variant, band, kernels) in RUNS.items():
        rec = {n: [] for n in kernels}
        frame = [0]
        eng = Engine({0: Denoiser[variant]}, resource_size=SIZE, device="cpu")
        eng.set_denoiser_settings(0, replace(eng._settings[0], **SETTINGS.get(run, {})))

        def recorder(n, wrapper):
            def r(*a, **k):
                i = frame[0]
                if i in HELD_FRAMES:
                    rec[n].append((rects[i], rects[i - 1], (a, k)))
                return wrapper(*a, **k)
            return r
        with pytest.MonkeyPatch.context() as mp:
            if band:
                mp.setenv("NRDTPU_REBLUR_BAND", "1")
            for n in kernels:
                mp.setattr(KM.MODULES[n], n, recorder(n, getattr(KM.MODULES[n], n)))
            for i, (cs, pool) in enumerate(frames(variant, rects)):
                frame[0] = i
                eng.set_common_settings(cs)
                eng.denoise([0], pool)
        out[run] = rec
    return out


def _planes(a, k):
    return [t for t in list(a) + list(k.values()) if isinstance(t, torch.Tensor) and t.ndim >= 2]


@pytest.mark.parametrize("run,kernel", CASES)
def test_rect_rehearsal(library, calls, run, kernel):
    """Every call of frames 2 and 3 against the plain version: each frame's planes at its
    rect, `rect_size_prev` the rect before."""
    recorded = calls[run][kernel]
    assert {(rect, prev) for rect, prev, _ in recorded} == {
        (RECTS[i], RECTS[i - 1]) for i in HELD_FRAMES}, kernel
    for rect, _, (a, k) in recorded:  # the planes are the rect's, not the resource's
        assert any(tuple(t.shape[:2]) == (rect[1], rect[0]) for t in _planes(a, k)), kernel
    over, count, worst = _hold(library, kernel, [call for _, _, call in recorded])
    assert over <= FLIP_FRACTION * count, (f"{run} {kernel}: {over} of {count} values out of "
                                           f"tolerance, max |d| {worst:.3g}")
