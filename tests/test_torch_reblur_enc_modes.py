"""REBLUR's other paths at the RGBA normal encodings end to end, with the machinery of
`tests/test_torch_reblur_enc_slice.py` (the JAX Engine op by op against the port's Engine on the
CPU, 3 orbit frames at 64x48, >= 60 dB on every output and frame, the accumulation speeds equal
on >= 99.9 % of the pixels, every kernel with a decoded mode called on the decoded plane and no
nearest_multi launch), one JAX run each, an encoding each:
- REBLUR_DIFFUSE_SPECULAR_SH at RGBA16_UNORM (SH0 / SH1 as `tests/test_torch_reblur_sh_slice.py`
  packs them), which also holds REBLUR_SPECULAR_SH;
- REBLUR_DIFFUSE_SPECULAR_OCCLUSION with AREA_3X3 at RGBA8_SNORM, the AO zeroed on a seeded 30 %
  of the geometry pixels (K12's one-channel instances on the decoded plane);
- REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION at RGBA16_SNORM;
- REBLUR_DIFFUSE_SPECULAR under checkerboard BLACK at RGBA8_UNORM (H2's and N4's checkerboard
  PrePass on the decoded plane), which also holds REBLUR_DIFFUSE there.
`test_every_variant_runs` runs each of the ten REBLUR variants at each of the four encodings
through the port's Engine alone (2 frames at 32x24): finite outputs of their shapes, every call of
a kernel with a decoded mode on the decoded plane.

Run alone: python -m pytest tests/test_torch_reblur_enc_modes.py -q
"""

import functools

import numpy as np
import pytest

from nrdtpu_torch import interop
from nrdtpu_torch import kernels as KM
from nrdtpu_torch.settings import CheckerboardMode as CB, Denoiser
from nrdtpu_torch.settings import HitDistanceReconstructionMode as HM

from test_torch_reblur_enc_slice import (check_frames, frames_of, kind_of, outputs_of,
                                         port_engine, recording, run_case)

RGBA = ("RGBA8_UNORM", "RGBA8_SNORM", "RGBA16_UNORM", "RGBA16_SNORM")
REBLUR = tuple(d.name for d in Denoiser if d.name.startswith("REBLUR"))

# run: as test_torch_reblur_enc_slice.RUNS, and whether the hit distance has holes
RUNS = {
    "DS_SH-RGBA16_UNORM": ("REBLUR_DIFFUSE_SPECULAR_SH", "RGBA16_UNORM", "LINEAR", {}, {},
                           {"DS_SH": ("REBLUR_DIFFUSE_SPECULAR_SH", False),
                            "S_SH": ("REBLUR_SPECULAR_SH", False)}, False),
    "DS_OCC-AREA_3X3-RGBA8_SNORM": (
        "REBLUR_DIFFUSE_SPECULAR_OCCLUSION", "RGBA8_SNORM", "LINEAR",
        dict(hitDistanceReconstructionMode=HM.AREA_3X3), {},
        {"DS_OCC": ("REBLUR_DIFFUSE_SPECULAR_OCCLUSION", False)}, True),
    "DO-RGBA16_SNORM": ("REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION", "RGBA16_SNORM", "LINEAR", {}, {},
                        {"DO": ("REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION", False)}, False),
    "DS_CB_BLACK-RGBA8_UNORM": ("REBLUR_DIFFUSE_SPECULAR", "RGBA8_UNORM", "LINEAR",
                                dict(checkerboardMode=CB.BLACK), {},
                                {"DS": ("REBLUR_DIFFUSE_SPECULAR", False),
                                 "D": ("REBLUR_DIFFUSE", False)}, False),
}


@functools.lru_cache(maxsize=None)
def run(name):
    return run_case(*RUNS[name][:6], holes=RUNS[name][6])


@pytest.mark.parametrize("name", list(RUNS))
def test_port_matches_jax(name):
    """Every output of every port engine >= 60 dB against JAX on every frame, the accumulation
    speeds equal on >= 99.9 % of the pixels, the kernels on the decoded plane."""
    frames, calls = run(name)
    check_frames(name, frames, calls, RUNS[name][5], RUNS[name][3])


@pytest.mark.parametrize("encoding", RGBA)
@pytest.mark.parametrize("variant", REBLUR)
def test_every_variant_runs(variant, encoding):
    """Each REBLUR variant at each RGBA encoding through the port's Engine (no JAX): 2 frames at
    32x24, every output finite and of its shape, every call of a kernel with a decoded mode on
    the decoded plane, the TA's previous normals from bilinear_resolve."""
    size = (32, 24)
    te = port_engine(variant, encoding, size=size)
    with recording() as rec:
        for cs, pool in frames_of(variant, encoding, frames=2, size=size):
            te.set_common_settings(cs)
            out = te.denoise([0], pool)
    channels = 1 if kind_of(variant) == "occ" else 4
    for rt in outputs_of(variant):
        got = interop.tensor_to_numpy(out[rt])
        assert got.shape == (size[1], size[0], channels) and np.isfinite(got).all(), rt
    assert any(rec[name] for name in KM.DEC_INSTANCES)
    assert all(all(v) for name, v in rec.items() if name in KM.DEC_INSTANCES)
    assert not rec["nearest_multi"] and bool(rec["bilinear_resolve"]) == ("SPECULAR" in variant)
