"""The other settings paths the port takes for REBLUR_SPECULAR, against the JAX Engine at
64x48 over 3 frames, each at the slice's >= 60 dB bar: 6-tap spatial filters (performance
mode), specular PrePass off and TS off; and over 4 frames the settings whose math H2 (the
spatial filter with its centre's parameters) and H3 take in: historyFixFrameNum 0, both min
materials 0, usePrepassOnlyForSpecularMotionEstimation, and max accumulated frames 10 / 2
(ROADMAP.md, Queue 3's probe table).

PrePass off is switched on after the first frame: the Engine re-specializes a denoiser only
when its static key changes, so the key must see `specularPrepassBlurRadius`
(`nrdtpu/passes/reblur/denoiser.py:53-63`).
"""

import pytest

from test_torch_spec_slice import PSNR_BAR_DB, psnr, run


@pytest.mark.parametrize("settings,from_frame,frames", [
    (dict(enablePerformanceMode=True), 0, 3),
    (dict(specularPrepassBlurRadius=0.0), 1, 3),
    (dict(maxStabilizedFrameNum=0), 0, 3),
    (dict(historyFixFrameNum=0), 0, 4),
    (dict(minMaterialForDiffuse=0.0, minMaterialForSpecular=0.0), 0, 4),
    (dict(usePrepassOnlyForSpecularMotionEstimation=True), 0, 4),
    (dict(maxAccumulatedFrameNum=10, maxFastAccumulatedFrameNum=2), 0, 4),
], ids=["performance_mode", "no_prepass", "no_stabilization", "history_fix_frame_num_0",
        "min_material_0", "prepass_only_for_motion", "max_accumulated_10_2"])
def test_settings_paths_match_jax(settings, from_frame, frames):
    for frame, r in enumerate(run((64, 48), frames, settings, from_frame)):
        p = psnr(r["torch"], r["jax"])
        assert p >= PSNR_BAR_DB, f"frame {frame}: {p:.2f} dB"
