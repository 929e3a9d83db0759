"""REFERENCE denoiser for the PyTorch port - counterpart of `nrdtpu/passes/reference.py`.

Plain temporal accumulation and copy (REFERENCE_TemporalAccumulation.cs.hlsl,
REFERENCE_Copy.cs.hlsl), run as torch ops: the JAX pass has no kernel either. The host keeps
the accumulation counter of Update_Reference (Reference.hpp:55-74): it resets on a camera
matrix or rect change or a history reset, and otherwise grows to the maximum.

State (the permanent pool, Reference.hpp:21-26): one float32 RGBA history plane.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as nm
from ..settings import REFERENCE_MAX_HISTORY_FRAME_NUM, ReferenceSettings, ResourceType

RT = ResourceType


class ReferenceDenoiser:
    mesh = None  # the Engine's RowMesh: every pass is per pixel, so a band of rows runs as is

    def __init__(self, config, device):
        self.config = config
        self.device = torch.device(device)
        self._accumulated_frame_num = 0

    def static_key(self, settings: ReferenceSettings):
        return ()

    def specialize(self, settings: ReferenceSettings):
        pass

    def init_state(self):
        w, h = self.config.rect_size
        return {"history": torch.zeros((h, w, 4), dtype=torch.float32, device=self.device)}

    def frame_constants(self, consts: dict, settings: ReferenceSettings) -> dict:
        """Reference.hpp:55-89: the camera-relative world-to-clip matrix of this frame against
        the previous frame's, as the JAX package compares them (`reference.py:35-52`)."""
        changed = (not np.array_equal(np.asarray(consts["world_to_clip"]),
                                      np.asarray(consts["world_to_clip_prev"]))
                   or consts["reset_history"] > 0.0
                   or consts["is_rect_changed"] > 0.0)
        if changed:
            self._accumulated_frame_num = 0
        else:
            max_frames = min(settings.maxAccumulatedFrameNum, REFERENCE_MAX_HISTORY_FRAME_NUM)
            self._accumulated_frame_num = min(self._accumulated_frame_num + 1, max_frames)
        return {"accum_speed": np.float32(1.0 / (1.0 + self._accumulated_frame_num)),
                "split_screen": consts["split_screen"]}

    def frame(self, sc: dict, dc: dict, state: dict, inputs: dict):
        signal = inputs[RT.IN_SIGNAL]
        if signal.ndim == 2:
            signal = signal[..., None]
        history = state["history"]
        chans = signal.shape[-1]

        # REFERENCE_TemporalAccumulation.cs.hlsl:29-35
        accumulated = history[..., :chans] + (signal - history[..., :chans]) * float(
            dc["accum_speed"])
        new_history = torch.cat([accumulated, history[..., chans:]], -1)

        # REFERENCE_Copy.cs.hlsl:22-26 + split screen: the left strip passes the noisy input
        w = signal.shape[1]
        u = nm.div(torch.arange(w, dtype=torch.float32, device=signal.device) + 0.5, w)
        use_out = (u > float(dc["split_screen"]))[None, :, None]
        out = torch.where(use_out, accumulated, signal)
        return {RT.OUT_SIGNAL: out}, {"history": new_history}
