"""The Engine of the PyTorch port - counterpart of `nrdtpu/engine.py:122-368`.

Same API as the JAX Engine (CreateInstance / SetCommonSettings / SetDenoiserSettings /
Denoise of NRD), run eagerly on one device:

    eng = Engine({0: Denoiser.REBLUR_DIFFUSE}, resource_size=(w, h), device="cuda")
    eng.set_common_settings(cs)
    outputs = eng.denoise([0], {ResourceType.IN_VIEWZ: view_z, ...})

Inputs may be numpy arrays or tensors; they are moved to the engine's device. The state is
a dict of tensors on that device. The engine runs on the card unless the caller asks for
`device="cpu"`: on "cuda" (the default) every kernel of the pass graph is a hand-written CUDA
kernel; on "cpu" each runs its plain PyTorch version. On a machine without CUDA the default
raises - the engine never carries on on the CPU unless asked to.

Dynamic resolution (`nrdtpu/engine.py:251-275`, NRD's rectSize / rectSizePrev): inputs stay
resource-sized with the image in the top-left `rect_size` (`Engine(rect_size=)`, or a per-frame
`cs.rectSize` clipped to the resource). Each instance runs at its rect's shape; a new rect
re-creates the instance and crops or zero-pads the state (`_migrate_state`), and the outputs
come back resource-sized, zero outside the rect.

Debug and host surface (`nrdtpu/engine.py:134-135`, `:202-236`, `:274-367`):
`cs.enableValidation` renders OUT_VALIDATION (REBLUR and RELAX; `passes/validation.py`), its
previous overlay carried in the state under "validation"; a `cs.printfAt` inside this frame's
rect returns each tagged plane's value at that pixel under `outputs[Engine.PROBE_KEY]` (a dict
of tag -> 0-d or (C,) tensor on the engine's device, `utils/probe.py`); `set_debug_show(tag)`
returns the whole rect-sized plane of one tag under `outputs[Engine.SHOW_KEY]` (None where no
pass emits it). Each of them re-specializes the instance, as a changed setting does.
`get_memory_usage(identifier)` gives the state's bytes and, on the card, the transient peak of
the frame that last specialized the instance.

Row sharding (`nrdtpu/engine.py:142-188`, `:290-294`, `:341-346`): `Engine(..., mesh=RowMesh)`
runs on one rank of a `torch.distributed` group (`parallel.make_mesh`, `parallel.launch.spawn`),
each rank holding a band of rows. Inputs are the whole frame, as the JAX Engine takes them
(a plane of the band's height is taken as this rank's rows); `denoise` returns this rank's rows
of each output, which `parallel.gather_rows` assembles (the JAX Engine returns global arrays);
the state is created row-sharded and `get_state` gives this rank's rows; the frame constants
are computed whole on every rank, from rank 0's frame time where the frame gives none
(`timeDeltaBetweenFrames` 0: `set_common_settings` takes the time since the last call from rank
0, so that every rank smooths the same times). Under a mesh the port runs REFERENCE,
SIGMA_SHADOW and REBLUR_DIFFUSE at R10G10B10A2 and LINEAR, rect = resource, without
checkerboard, hit-distance reconstruction or the debug surface; anything else raises
NotImplementedError (ROADMAP.md Queue 1.1), and a frame height that the ranks do not divide
raises ValueError.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import camera
from .interop import consts_from_numpy
from .parallel import sharding, spmd
from .utils import probe
from .settings import (
    AccumulationMode,
    CheckerboardMode,
    CommonSettings,
    Denoiser,
    HitDistanceReconstructionMode,
    NormalEncoding,
    ResourceType,
    RoughnessEncoding,
    default_settings,
)


@dataclass(frozen=True)
class DenoiserConfig:
    """Static configuration of one denoiser instance."""

    denoiser: Denoiser
    rect_size: Tuple[int, int]          # (w, h)
    resource_size: Tuple[int, int]
    normal_encoding: NormalEncoding = NormalEncoding.R10_G10_B10_A2_UNORM
    roughness_encoding: RoughnessEncoding = RoughnessEncoding.LINEAR


def _denoiser_class(d: Denoiser):
    if d == Denoiser.REFERENCE:
        from .passes.reference import ReferenceDenoiser

        return ReferenceDenoiser
    if d.name.startswith("REBLUR"):
        from .passes.reblur.denoiser import ReblurDenoiser

        return ReblurDenoiser
    if d in (Denoiser.SIGMA_SHADOW, Denoiser.SIGMA_SHADOW_TRANSLUCENCY):
        from .passes.sigma.denoiser import SigmaDenoiser

        return SigmaDenoiser
    if d.name.startswith("RELAX"):
        from .passes.relax.denoiser import RelaxDenoiser

        return RelaxDenoiser
    raise NotImplementedError(f"{d.name} is not ported yet (ROADMAP.md lists the next slices)")


# the variants that run under a mesh
MESH_DENOISERS = (Denoiser.REFERENCE, Denoiser.SIGMA_SHADOW, Denoiser.REBLUR_DIFFUSE)


def _not_under_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(f"Engine(mesh=): {what} is not ported under a mesh yet (ROADMAP.md "
                               "Queue 1.1 lists the mesh slices)")


def _migrate_state(state: dict, old_rect, new_rect) -> dict:
    """Crop or zero-pad every (old_h, old_w, ...) state tensor to the new rect's shape, its
    dtype kept (`nrdtpu/engine.py:_migrate_state`): grown rows and columns read as fresh
    history, shrunk ones are dropped. Rects are (w, h), tensors (h, w[, c])."""
    ow, oh = old_rect
    nw, nh = new_rect

    def mig(t):
        if not isinstance(t, torch.Tensor) or t.ndim < 2 or tuple(t.shape[:2]) != (oh, ow):
            return t
        out = t.new_zeros((nh, nw) + tuple(t.shape[2:]))
        ch, cw = min(oh, nh), min(ow, nw)
        out[:ch, :cw] = t[:ch, :cw]
        return out

    return {k: mig(v) for k, v in state.items()}


def _crop(t: torch.Tensor, rect) -> torch.Tensor:
    """The top-left rect of a resource-sized plane, dense: the kernels assume a (h, w, C) row
    pitch, so the copy is made after the crop."""
    rw, rh = rect
    if t.ndim >= 2 and t.shape[0] >= rh and t.shape[1] >= rw:
        return t[:rh, :rw].contiguous()
    return t


def _pad(t: torch.Tensor, rect, resource) -> torch.Tensor:
    """A rect-sized output zero-padded to the resource size."""
    (rw, rh), (res_w, res_h) = rect, resource
    if t.ndim < 2 or tuple(t.shape[:2]) != (rh, rw):
        return t
    out = t.new_zeros((res_h, res_w) + tuple(t.shape[2:]))
    out[:rh, :rw] = t
    return out


class Engine:
    PROBE_KEY = "__probe__"  # outputs key of the printfAt values (utils/probe.py)
    SHOW_KEY = "__show__"    # outputs key of the SHOW-mode plane

    def __init__(self, denoisers: Dict[int, Denoiser], resource_size: Tuple[int, int],
                 rect_size: Optional[Tuple[int, int]] = None,
                 normal_encoding: NormalEncoding = NormalEncoding.R10_G10_B10_A2_UNORM,
                 roughness_encoding: RoughnessEncoding = RoughnessEncoding.LINEAR,
                 mesh=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): CUDA is not available on this machine; "
                               "pass device='cpu' to run the plain PyTorch versions")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if mesh is not None:
            if mesh.device.type != self.device.type or (
                    self.device.index is not None and mesh.device != self.device):
                raise ValueError(f"Engine(device={device!r}): the mesh's device is {mesh.device}")
            self.device = mesh.device
            for d in denoisers.values():
                if d not in MESH_DENOISERS:
                    raise _not_under_mesh(d.name)
            if (normal_encoding != NormalEncoding.R10_G10_B10_A2_UNORM
                    or roughness_encoding != RoughnessEncoding.LINEAR):
                raise _not_under_mesh("encoding")
            if rect_size is not None and tuple(rect_size) != tuple(resource_size):
                raise _not_under_mesh("rect")
            sharding.rows(resource_size[1], mesh)  # raises unless the ranks divide the height
        self.mesh = mesh
        rect_size = tuple(rect_size or resource_size)
        self._frame_math = camera.FrameMath()
        self._consts: Optional[dict] = None
        self._cs: Optional[CommonSettings] = None
        self._last_time: Optional[float] = None
        self._instances: Dict[int, Any] = {}
        self._settings: Dict[int, Any] = {}
        self._states: Dict[int, Any] = {}
        self._static_keys: Dict[int, Any] = {}
        self._aliasable: Dict[int, int] = {}
        self._debug_show: Optional[str] = None
        for ident, d in denoisers.items():
            cfg = DenoiserConfig(d, rect_size, tuple(resource_size), normal_encoding,
                                 roughness_encoding)
            self._instances[ident] = _denoiser_class(d)(cfg, self.device)
            self._instances[ident].mesh = mesh
            self._settings[ident] = default_settings(d)
            self._states[ident] = None

    # ------------------------------------------------------------------ API
    def set_common_settings(self, cs: CommonSettings):
        now = time.perf_counter()
        raw_dt_ms = None if self._last_time is None else (now - self._last_time) * 1e3
        self._last_time = now
        if raw_dt_ms is not None:  # under a mesh every rank times its frames by rank 0's clock
            raw_dt_ms = sharding.from_rank0(raw_dt_ms, self.mesh)
        self._cs = cs
        self._consts = consts_from_numpy(self._frame_math.set_common_settings(cs, raw_dt_ms))

    def set_denoiser_settings(self, identifier: int, settings):
        self._settings[identifier] = settings

    def set_debug_show(self, tag: Optional[str]):
        """Capture the whole plane of one probe tag (e.g. "reblur/ta/curvature",
        "reblur/hfix/spec_fast_history") and return it under `Engine.SHOW_KEY`, the analogue of
        NRD's REBLUR_SHOW_* switches (REBLUR_Config.hlsli:39-50); None turns it off."""
        self._debug_show = tag

    def get_state(self, identifier: int):
        return self._states[identifier]

    def get_memory_usage(self, identifier: int) -> Dict[str, float]:
        """GetTotal/Persistent/AliasableMemoryUsageInMb (Integration/NRDIntegration.h:116-123).

        persistent_mb: the bytes of the state's tensors (NRD's permanent pool), the overlay's
            too while it is carried; 0 before the first frame.
        aliasable_mb: on the card, the transient peak of the frame that last specialized the
            instance (its first frame, or one after a change of settings, debug mode or rect):
            the allocator's peak during that frame minus what was allocated at its start, the
            analogue of the compile whose temporaries the JAX Engine reads. 0.0 on the CPU, as
            the JAX Engine gives where its backend has no memory analysis.
        total_mb: the sum."""
        if self.mesh is not None:
            raise _not_under_mesh("get_memory_usage")
        state = self._states.get(identifier)
        persistent = sum(t.numel() * t.element_size() for t in (state or {}).values()
                         if isinstance(t, torch.Tensor))
        aliasable = self._aliasable.get(identifier, 0)
        mb = 1.0 / (1024 * 1024)
        return {"persistent_mb": persistent * mb, "aliasable_mb": aliasable * mb,
                "total_mb": (persistent + aliasable) * mb}

    def frame_constants(self, identifier: int) -> Tuple[dict, dict]:
        """(shared, denoiser) constants of the current frame, as `denoise` passes them."""
        inst = self._instances[identifier]
        dc = consts_from_numpy(inst.frame_constants(self._consts, self._settings[identifier]))
        return dict(self._consts), dc

    @staticmethod
    def _rect(inst, cs: Optional[CommonSettings]) -> Tuple[int, int]:
        """This frame's rect of an instance: `cs.rectSize` clipped to the resource, else the
        instance's own (`nrdtpu/engine.py:260-264`)."""
        res_w, res_h = inst.config.resource_size
        if cs is not None and all(cs.rectSize):
            return min(int(cs.rectSize[0]), res_w), min(int(cs.rectSize[1]), res_h)
        return tuple(inst.config.rect_size)

    def _check_mesh_frame(self, inst, settings, rect, cb):
        """Raise for what a frame asks that the mesh does not run yet."""
        if rect != tuple(inst.config.resource_size):
            raise _not_under_mesh("rect")
        if cb != CheckerboardMode.OFF:
            raise _not_under_mesh("checkerboard")
        if getattr(settings, "hitDistanceReconstructionMode",
                   HitDistanceReconstructionMode.OFF) != HitDistanceReconstructionMode.OFF:
            raise _not_under_mesh("hit-distance reconstruction")
        px, py = self._cs.printfAt
        if (self._cs.enableValidation or self._debug_show is not None
                or (0 <= px < rect[0] and 0 <= py < rect[1])):
            raise _not_under_mesh("debug surface")

    def _to_device(self, v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        if t.dtype != torch.float32:
            raise ValueError(f"inputs are float32 planes, got {t.dtype}")
        return t.to(self.device).contiguous()

    def denoise(self, identifiers, user_pool: Dict[ResourceType, Any]
                ) -> Dict[ResourceType, torch.Tensor]:
        """Run the requested denoisers; returns the OUT_* resources (merged dict)."""
        if self._consts is None:
            raise RuntimeError("call set_common_settings before denoise")
        clear = (self._cs is not None
                 and self._cs.accumulationMode == AccumulationMode.CLEAR_AND_RESTART)
        if self.mesh is not None:  # this rank's rows of the whole frame's planes
            res_w, res_h = next(iter(self._instances.values())).config.resource_size
            user_pool = spmd.shard_frame_tree(self.mesh, user_pool, res_h, res_w)
        pool = {k: self._to_device(v) for k, v in user_pool.items()}
        outputs: Dict[ResourceType, torch.Tensor] = {}
        for ident in identifiers:
            inst = self._instances[ident]
            settings = self._settings[ident]
            rect = self._rect(inst, self._cs)
            cb = getattr(settings, "checkerboardMode", CheckerboardMode.OFF)
            if self.mesh is not None:
                self._check_mesh_frame(inst, settings, rect, cb)
            if rect != tuple(inst.config.resource_size) and cb != CheckerboardMode.OFF:
                raise NotImplementedError(
                    "checkerboard at a rect smaller than the resource is not ported: the JAX "
                    "reference crops only the inputs at least as wide as the rect "
                    "(nrdtpu/engine.py:322-328), so its half-width checkerboard inputs keep the "
                    "resource's height and its frame fails on their shape; there is nothing to "
                    "hold the port against (ROADMAP.md Queue 3)")
            # a new rect: the instance at the new shape, the state cropped or padded to it
            if rect != tuple(inst.config.rect_size):
                old_rect = tuple(inst.config.rect_size)
                inst = type(inst)(dataclasses.replace(inst.config, rect_size=rect), self.device)
                self._instances[ident] = inst
                if self._states[ident] is not None:
                    self._states[ident] = _migrate_state(self._states[ident], old_rect, rect)
            if self._states[ident] is None or clear:
                self._states[ident] = inst.init_state()
                if self.mesh is not None:  # row-sharded at creation (`nrdtpu/engine.py:290-294`)
                    res_w, res_h = inst.config.resource_size
                    self._states[ident] = {k: v.clone() for k, v in spmd.shard_frame_tree(
                        self.mesh, self._states[ident], res_h, res_w).items()}
            # the debug modes: the overlay per instance, printfAt when it falls in this frame's
            # rect, the SHOW tag; each re-specializes the instance (`nrdtpu/engine.py:274-293`)
            inst.enable_validation = bool(self._cs.enableValidation)
            px, py = self._cs.printfAt
            probe_at = (int(px), int(py)) if 0 <= px < rect[0] and 0 <= py < rect[1] else None
            show_tag = self._debug_show
            key = (inst.static_key(settings), inst.enable_validation, probe_at, rect, show_tag)
            specialized = self._static_keys.get(ident) != key
            if specialized:
                inst.specialize(settings)
                self._static_keys[ident] = key
            sc, dc = self.frame_constants(ident)
            resource = tuple(inst.config.resource_size)
            pool_i = pool if rect == resource else {k: _crop(v, rect) for k, v in pool.items()}
            measure = specialized and self.device.type == "cuda" and self.mesh is None
            if measure:
                caller_peak = torch.cuda.max_memory_allocated(self.device)
                start = torch.cuda.memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            with contextlib.ExitStack() as stack:
                collector = (stack.enter_context(probe.collect(probe_at))
                             if probe_at is not None else None)
                shown = (stack.enter_context(probe.collect_show(show_tag))
                         if show_tag is not None else None)
                outs, self._states[ident] = inst.frame(sc, dc, self._states[ident], pool_i)
            if measure:
                peak = torch.cuda.max_memory_allocated(self.device)
                self._aliasable[ident] = peak - start
                if peak < caller_peak:  # give the caller's peak reading back: one block of
                    # the difference, allocated and freed (block sizes are multiples of 512 B)
                    torch.empty(caller_peak - torch.cuda.memory_allocated(self.device),
                                dtype=torch.uint8, device=self.device)
            if shown is not None:
                outputs[Engine.SHOW_KEY] = shown.plane  # rect-sized, as the JAX Engine's
            if collector is not None:
                outputs[Engine.PROBE_KEY] = dict(collector.values)
            if rect != resource:
                outs = {k: _pad(v, rect, resource) for k, v in outs.items()}
            outputs.update(outs)
        return outputs
