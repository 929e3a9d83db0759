"""SIGMA_SHADOW / SIGMA_SHADOW_TRANSLUCENCY pass graph for the PyTorch port - counterpart of
`nrdtpu/passes/sigma/denoiser.py:28-143`.

ClassifyTiles -> SmoothTiles -> Blur -> PostBlur -> [TemporalStabilization] -> SplitScreen.
The tile value and sky mask are upsampled once a frame and shared by Blur, PostBlur and TS.

State (the permanent pool; the history in bf16, as the JAX package keeps it):
  shadow_history (h, w, c) sqrt-packed previous output, c = 1 or 4 (translucency)
  prev_view_z    (h, w)    viewZ beside the history length (the R32_UINT pack split in two)
  history_len    (h, w)    0..7
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ...config import requantize_state
from ...settings import SIGMA_MAX_HISTORY_FRAME_NUM, Denoiser, ResourceType, SigmaSettings
from ...utils import probe
from . import kernels as K

RT = ResourceType


class SigmaDenoiser:
    def __init__(self, config, device):
        self.config = config
        self.device = torch.device(device)
        self.translucent = config.denoiser == Denoiser.SIGMA_SHADOW_TRANSLUCENCY
        self.channels = 4 if self.translucent else 1
        self._stabilization = True

    def static_key(self, settings: SigmaSettings):
        return (settings.maxStabilizedFrameNum > 0,)

    def specialize(self, settings: SigmaSettings):
        self._stabilization = settings.maxStabilizedFrameNum > 0

    def init_state(self):
        w, h = self.config.rect_size
        kw = dict(dtype=torch.float32, device=self.device)
        return {"shadow_history": torch.zeros((h, w, self.channels), dtype=torch.bfloat16,
                                              device=self.device),
                "prev_view_z": torch.zeros((h, w), **kw),
                "history_len": torch.zeros((h, w), **kw)}

    def frame_constants(self, consts: dict, settings: SigmaSettings) -> dict:
        """AddSharedConstants_Sigma (Sigma.cpp:92-145), denoiser part."""
        frame_num = min(settings.maxStabilizedFrameNum, SIGMA_MAX_HISTORY_FRAME_NUM)
        stabilization_strength = frame_num / (1.0 + frame_num)
        if consts["reset_history"] > 0.0:
            stabilization_strength = 0.0
        ld = np.asarray(settings.lightDirection, np.float32)
        light_dir_view = np.asarray(consts["world_to_view"])[:3, :3] @ ld
        return {"stabilization_strength": np.float32(stabilization_strength),
                "plane_dist_sensitivity": np.float32(settings.planeDistanceSensitivity),
                "light_direction_view": light_dir_view.astype(np.float32)}

    def frame(self, sc: dict, dc: dict, state: dict, inputs: dict):
        penumbra = inputs[RT.IN_PENUMBRA]
        view_z = inputs[RT.IN_VIEWZ]
        # the normal plane Blur and PostBlur read: packed R10G10B10A2, or the RGBA formats
        # decoded (`frontend.decode_normal_plane`)
        enc = self.config.normal_encoding
        normal_roughness = fe.decode_normal_plane(inputs[RT.IN_NORMAL_ROUGHNESS], enc)
        mv = inputs.get(RT.IN_MV)
        translucency = inputs.get(RT.IN_TRANSLUCENCY) if self.translucent else None
        h, w = view_z.shape

        tiles_smoothed = K.smooth_tiles(K.classify_tiles(sc, penumbra, view_z, translucency))
        tile = K.tile_planes(sc, tiles_smoothed, h, w)
        penum1, shadow1 = K.blur(sc, dc, penumbra, translucency, view_z, normal_roughness, tile,
                                 first_pass=True, decoded=fe.decoded_normals(enc))
        penum2, shadow2 = K.blur(sc, dc, penum1, shadow1, view_z, normal_roughness, tile,
                                 first_pass=False, decoded=fe.decoded_normals(enc))
        if probe.active():  # printfAt only, so a SHOW tag of SIGMA captures nothing
            # (`nrdtpu/passes/sigma/denoiser.py:110-115`)
            probe.emit("sigma/tiles_smoothed", tiles_smoothed)
            probe.emit("sigma/blur/penumbra1", penum1)
            probe.emit("sigma/postblur/penumbra2", penum2)
            probe.emit("sigma/history_len", state["history_len"])
        if self._stabilization and mv is not None:
            if mv.shape[-1] == 2:
                mv = torch.cat([mv, torch.zeros_like(mv[..., :1])], -1)
            out, prev_view_z, history_len = K.temporal_stabilization(
                sc, dc, view_z, mv, penum2, shadow2, state["shadow_history"],
                state["prev_view_z"], state["history_len"], tile)
            new_state = {"shadow_history": out, "prev_view_z": prev_view_z,
                         "history_len": history_len}
        else:
            out = shadow2
            new_state = {"shadow_history": out, "prev_view_z": torch.abs(view_z),
                         "history_len": state["history_len"]}
        out = K.split_screen(sc, penumbra, view_z, out, translucency, channels=self.channels)
        return {RT.OUT_SHADOW_TRANSLUCENCY: out}, requantize_state(state, new_state)
