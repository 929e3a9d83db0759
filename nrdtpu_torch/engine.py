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
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import camera
from .interop import consts_from_numpy
from .settings import (
    AccumulationMode,
    CheckerboardMode,
    CommonSettings,
    Denoiser,
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
            raise NotImplementedError("Engine(mesh=) is not ported yet (ROADMAP.md)")
        rect_size = tuple(rect_size or resource_size)
        self._frame_math = camera.FrameMath()
        self._consts: Optional[dict] = None
        self._cs: Optional[CommonSettings] = None
        self._last_time: Optional[float] = None
        self._instances: Dict[int, Any] = {}
        self._settings: Dict[int, Any] = {}
        self._states: Dict[int, Any] = {}
        self._static_keys: Dict[int, Any] = {}
        for ident, d in denoisers.items():
            cfg = DenoiserConfig(d, rect_size, tuple(resource_size), normal_encoding,
                                 roughness_encoding)
            self._instances[ident] = _denoiser_class(d)(cfg, self.device)
            self._settings[ident] = default_settings(d)
            self._states[ident] = None

    # ------------------------------------------------------------------ API
    def set_common_settings(self, cs: CommonSettings):
        now = time.perf_counter()
        raw_dt_ms = None if self._last_time is None else (now - self._last_time) * 1e3
        self._last_time = now
        if cs.enableValidation:
            raise NotImplementedError("the validation overlay is not ported yet (ROADMAP.md)")
        for inst in self._instances.values():
            w_, h_ = self._rect(inst, cs)
            if 0 <= cs.printfAt[0] < w_ and 0 <= cs.printfAt[1] < h_:
                raise NotImplementedError("printfAt is not ported yet (ROADMAP.md)")
        self._cs = cs
        self._consts = consts_from_numpy(self._frame_math.set_common_settings(cs, raw_dt_ms))

    def set_denoiser_settings(self, identifier: int, settings):
        self._settings[identifier] = settings

    def set_debug_show(self, tag: Optional[str]):
        raise NotImplementedError("SHOW-mode capture is not ported yet (ROADMAP.md)")

    def get_state(self, identifier: int):
        return self._states[identifier]

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
        pool = {k: self._to_device(v) for k, v in user_pool.items()}
        outputs: Dict[ResourceType, torch.Tensor] = {}
        for ident in identifiers:
            inst = self._instances[ident]
            settings = self._settings[ident]
            rect = self._rect(inst, self._cs)
            cb = getattr(settings, "checkerboardMode", CheckerboardMode.OFF)
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
            key = (inst.static_key(settings), rect)
            if self._static_keys.get(ident) != key:
                inst.specialize(settings)
                self._static_keys[ident] = key
            sc, dc = self.frame_constants(ident)
            resource = tuple(inst.config.resource_size)
            pool_i = pool if rect == resource else {k: _crop(v, rect) for k, v in pool.items()}
            outs, self._states[ident] = inst.frame(sc, dc, self._states[ident], pool_i)
            if rect != resource:
                outs = {k: _pad(v, rect, resource) for k, v in outs.items()}
            outputs.update(outs)
        return outputs
