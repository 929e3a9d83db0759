"""SIGMA_SHADOW / SIGMA_SHADOW_TRANSLUCENCY pass graph for the PyTorch port - counterpart of
`nrdtpu/passes/sigma/denoiser.py:28-143`.

ClassifyTiles -> SmoothTiles -> Blur -> PostBlur -> [TemporalStabilization] -> SplitScreen.
The tile value and sky mask are upsampled once a frame and shared by Blur, PostBlur and TS.

State (the permanent pool; the history in bf16, as the JAX package keeps it):
  shadow_history (h, w, c) sqrt-packed previous output, c = 1 or 4 (translucency)
  prev_view_z    (h, w)    viewZ beside the history length (the R32_UINT pack split in two)
  history_len    (h, w)    0..7

Under a mesh (`Engine(mesh=)`, SIGMA_SHADOW) each rank holds a band of rows of every plane: the
tile maps are built from the gathered penumbra and viewZ, Blur and PostBlur run on halo-padded
bands at their row origin (`parallel.shard_stencil`), TS on a padded band with the previous
planes gathered whole.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import frontend as fe
from ...config import requantize_state
from ...kernels import sigma_ts as k_sigma_ts
from ...parallel import sharding
from ...settings import SIGMA_MAX_HISTORY_FRAME_NUM, Denoiser, ResourceType, SigmaSettings
from ...utils import probe
from . import SIGMA_MAX_PIXEL_RADIUS
from . import kernels as K

RT = ResourceType


class SigmaDenoiser:
    mesh = None  # the Engine's RowMesh, None unsharded
    halo_override = None  # `parallel.sharding.halo_table`'s override

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

    def halos(self) -> dict:
        """Rows each pass reads beyond a band (PERF.md, the halo table): Blur and PostBlur's
        Poisson taps reach the blur radius, at most SIGMA_MAX_PIXEL_RADIUS (its skew is at most
        1), plus one row for the snap to the pixel centre (their dense 5x5 reaches 2); TS's 5x5
        moments reach 2."""
        return sharding.halo_table({"blur": int(SIGMA_MAX_PIXEL_RADIUS) + 1,
                                    "ts": k_sigma_ts.BORDER}, self.halo_override)

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
        # under a mesh this rank holds h rows of a frame fh high (`parallel.sharding`)
        mesh, fh = self.mesh, self.config.rect_size[1]
        halo = self.halos()

        def gathered(t):
            return None if t is None else sharding.gather_rows(t, mesh)

        tiles_smoothed = K.smooth_tiles(K.classify_tiles(
            sc, gathered(penumbra), gathered(view_z), gathered(translucency)))
        tile = K.tile_planes(sc, tiles_smoothed, h, w) if mesh is None else None

        def band_tile(row0, rows):  # the tile planes of a band of rows
            return tile if mesh is None else K.tile_planes(sc, tiles_smoothed, rows, w, row0, fh)

        def blur(first_pass):
            def run(t, row0):
                return K.blur(sc, dc, t["penumbra"], t["shadow"], t["view_z"], t["nr"],
                              band_tile(row0, t["view_z"].shape[0]), first_pass=first_pass,
                              decoded=fe.decoded_normals(enc), row0=row0, frame_h=fh)
            return run

        penum1, shadow1 = sharding.shard_stencil(
            mesh, blur(True), halo["blur"],
            dict(penumbra=penumbra, shadow=translucency, view_z=view_z, nr=normal_roughness), fh)
        penum2, shadow2 = sharding.shard_stencil(
            mesh, blur(False), halo["blur"],
            dict(penumbra=penum1, shadow=shadow1, view_z=view_z, nr=normal_roughness), fh)
        if probe.active():  # printfAt only, so a SHOW tag of SIGMA captures nothing
            # (`nrdtpu/passes/sigma/denoiser.py:110-115`)
            probe.emit("sigma/tiles_smoothed", tiles_smoothed)
            probe.emit("sigma/blur/penumbra1", penum1)
            probe.emit("sigma/postblur/penumbra2", penum2)
            probe.emit("sigma/history_len", state["history_len"])
        if self._stabilization and mv is not None:
            if mv.shape[-1] == 2:
                mv = torch.cat([mv, torch.zeros_like(mv[..., :1])], -1)
            # the previous planes whole: the reprojection reads them at any motion
            prev = {k: sharding.gather_rows(state[k], mesh)
                    for k in ("shadow_history", "prev_view_z", "history_len")}

            def stabilize(t, row0):
                return K.temporal_stabilization(
                    sc, dc, t["view_z"], t["mv"], t["penumbra"], t["shadow"],
                    prev["shadow_history"], prev["prev_view_z"], prev["history_len"],
                    band_tile(row0, t["view_z"].shape[0]), row0=row0, frame_h=fh)

            out, prev_view_z, history_len = sharding.shard_stencil(
                mesh, stabilize, halo["ts"],
                dict(view_z=view_z, mv=mv, penumbra=penum2, shadow=shadow2), fh)
            new_state = {"shadow_history": out, "prev_view_z": prev_view_z,
                         "history_len": history_len}
        else:
            out = shadow2
            new_state = {"shadow_history": out, "prev_view_z": torch.abs(view_z),
                         "history_len": state["history_len"]}
        out = K.split_screen(sc, penumbra, view_z, out, translucency, channels=self.channels)
        return {RT.OUT_SHADOW_TRANSLUCENCY: out}, requantize_state(state, new_state)
