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
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import camera
from .interop import consts_from_numpy
from .settings import (
    AccumulationMode,
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
        if rect_size != tuple(resource_size):
            raise NotImplementedError("rect_size != resource_size is not ported yet (ROADMAP.md)")
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
        res = tuple(int(v) for v in cs.resourceSize)
        for inst in self._instances.values():
            if all(cs.rectSize) and tuple(int(v) for v in cs.rectSize) != res:
                raise NotImplementedError("a rect smaller than the resource is not ported yet")
            w_, h_ = inst.config.rect_size
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
            if self._states[ident] is None or clear:
                self._states[ident] = inst.init_state()
            key = inst.static_key(settings)
            if self._static_keys.get(ident) != key:
                inst.specialize(settings)
                self._static_keys[ident] = key
            sc, dc = self.frame_constants(ident)
            outs, self._states[ident] = inst.frame(sc, dc, self._states[ident], pool)
            outputs.update(outs)
        return outputs
