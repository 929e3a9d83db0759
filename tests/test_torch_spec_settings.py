"""The other settings paths the port takes for REBLUR_SPECULAR, against the JAX Engine at
64x48 over 3 frames, each at the slice's >= 60 dB bar: 6-tap spatial filters (performance
mode), specular PrePass off and TS off.

PrePass off is switched on after the first frame: the Engine re-specializes a denoiser only
when its static key changes, so the key must see `specularPrepassBlurRadius`
(`nrdtpu/passes/reblur/denoiser.py:53-63`).
"""

import pytest

from test_torch_spec_slice import PSNR_BAR_DB, psnr, run


@pytest.mark.parametrize("settings,from_frame", [
    (dict(enablePerformanceMode=True), 0),
    (dict(specularPrepassBlurRadius=0.0), 1),
    (dict(maxStabilizedFrameNum=0), 0),
], ids=["performance_mode", "no_prepass", "no_stabilization"])
def test_settings_paths_match_jax(settings, from_frame):
    for frame, r in enumerate(run((64, 48), 3, settings, from_frame)):
        p = psnr(r["torch"], r["jax"])
        assert p >= PSNR_BAR_DB, f"frame {frame}: {p:.2f} dB"
