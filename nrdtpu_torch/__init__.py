"""nrdtpu_torch - the PyTorch + CUDA port of nrdtpu for one NVIDIA H100.

A second package beside `nrdtpu` (the JAX reference): the same settings, resource contract
and state, with every TPU kernel of the ported path written by hand in CUDA C++ for sm_90a
(`kernels/csrc/`). It imports torch and numpy only. It runs REBLUR_DIFFUSE,
REBLUR_SPECULAR, REBLUR_DIFFUSE_SPECULAR (with hit-distance reconstruction), SIGMA_SHADOW and
SIGMA_SHADOW_TRANSLUCENCY through `engine.Engine`; ROADMAP.md lists what is still to be
ported.
"""

from . import settings  # noqa: F401
from .settings import (  # noqa: F401
    AccumulationMode,
    CheckerboardMode,
    CommonSettings,
    Denoiser,
    HitDistanceReconstructionMode,
    NormalEncoding,
    ReblurSettings,
    ResourceType,
    RoughnessEncoding,
)

__version__ = "0.1.0"
