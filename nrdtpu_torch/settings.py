"""Public settings / descriptor surface of the TPU-native NRD rebuild.

Mirrors the reference public API:
  - enums: Include/NRDDescs.h:37-370 (ResourceType, Denoiser, encodings) and
    Include/NRDSettings.h:45-84 (CheckerboardMode, AccumulationMode, ...)
  - settings structs: Include/NRDSettings.h:88-461

Settings are plain Python dataclasses with the same field names and defaults, so existing NRD
integrations translate 1:1. Matrices are given as 4x4 column-major "vector is a column" arrays
(list/np array of 16, or (4,4) numpy) exactly like the reference contract
(NRDSettings.h:90-114).

Static vs dynamic split (SURVEY.md §5.6): fields that select pass permutations in the reference
(checkerboardMode, hitDistanceReconstructionMode, enablePerformanceMode, enableAntiFirefly,
atrousIterationNum, ...) trigger jit re-specialization; numeric fields are traced per frame.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Enums (NRDDescs.h / NRDSettings.h)
# ---------------------------------------------------------------------------


class Denoiser(enum.IntEnum):
    """Denoiser enum - NRDDescs.h:156-259."""

    REBLUR_DIFFUSE = 0
    REBLUR_DIFFUSE_OCCLUSION = 1
    REBLUR_DIFFUSE_SH = 2
    REBLUR_SPECULAR = 3
    REBLUR_SPECULAR_OCCLUSION = 4
    REBLUR_SPECULAR_SH = 5
    REBLUR_DIFFUSE_SPECULAR = 6
    REBLUR_DIFFUSE_SPECULAR_OCCLUSION = 7
    REBLUR_DIFFUSE_SPECULAR_SH = 8
    REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION = 9
    RELAX_DIFFUSE = 10
    RELAX_DIFFUSE_SH = 11
    RELAX_SPECULAR = 12
    RELAX_SPECULAR_SH = 13
    RELAX_DIFFUSE_SPECULAR = 14
    RELAX_DIFFUSE_SPECULAR_SH = 15
    SIGMA_SHADOW = 16
    SIGMA_SHADOW_TRANSLUCENCY = 17
    REFERENCE = 18


class ResourceType(enum.IntEnum):
    """ResourceType enum - NRDDescs.h:37-154. Used as keys of the user I/O dict."""

    IN_MV = 0
    IN_NORMAL_ROUGHNESS = 1
    IN_VIEWZ = 2
    IN_DIFF_CONFIDENCE = 3
    IN_SPEC_CONFIDENCE = 4
    IN_DISOCCLUSION_THRESHOLD_MIX = 5
    IN_BASECOLOR_METALNESS = 6
    IN_DIFF_RADIANCE_HITDIST = 7
    IN_SPEC_RADIANCE_HITDIST = 8
    IN_DIFF_HITDIST = 9
    IN_SPEC_HITDIST = 10
    IN_DIFF_DIRECTION_HITDIST = 11
    IN_DIFF_SH0 = 12
    IN_DIFF_SH1 = 13
    IN_SPEC_SH0 = 14
    IN_SPEC_SH1 = 15
    IN_PENUMBRA = 16
    IN_TRANSLUCENCY = 17
    IN_SIGNAL = 18
    OUT_DIFF_RADIANCE_HITDIST = 19
    OUT_SPEC_RADIANCE_HITDIST = 20
    OUT_DIFF_SH0 = 21
    OUT_DIFF_SH1 = 22
    OUT_SPEC_SH0 = 23
    OUT_SPEC_SH1 = 24
    OUT_DIFF_HITDIST = 25
    OUT_SPEC_HITDIST = 26
    OUT_DIFF_DIRECTION_HITDIST = 27
    OUT_SHADOW_TRANSLUCENCY = 28
    OUT_SIGNAL = 29
    OUT_VALIDATION = 30


class NormalEncoding(enum.IntEnum):
    """NormalEncoding - NRDDescs.h:340-359 / NRD.hlsli:300-304."""

    RGBA8_UNORM = 0
    RGBA8_SNORM = 1
    R10_G10_B10_A2_UNORM = 2  # supports material ID bits
    RGBA16_UNORM = 3
    RGBA16_SNORM = 4


class RoughnessEncoding(enum.IntEnum):
    """RoughnessEncoding - NRDDescs.h:361-370."""

    SQ_LINEAR = 0
    LINEAR = 1
    SQRT_LINEAR = 2


class CheckerboardMode(enum.IntEnum):
    """CheckerboardMode - NRDSettings.h:45-52."""

    OFF = 0
    BLACK = 1
    WHITE = 2


class AccumulationMode(enum.IntEnum):
    """AccumulationMode - NRDSettings.h:54-66."""

    CONTINUE = 0
    RESTART = 1
    CLEAR_AND_RESTART = 2


class HitDistanceReconstructionMode(enum.IntEnum):
    """HitDistanceReconstructionMode - NRDSettings.h:68-84."""

    OFF = 0
    AREA_3X3 = 1
    AREA_5X5 = 2


# ---------------------------------------------------------------------------
# Accumulation constants (NRDSettings.h:201,318,433,454)
# ---------------------------------------------------------------------------

REBLUR_MAX_HISTORY_FRAME_NUM = 63
REBLUR_DEFAULT_ACCUMULATION_TIME = 0.5
RELAX_MAX_HISTORY_FRAME_NUM = 255
RELAX_DEFAULT_ACCUMULATION_TIME = 0.5
SIGMA_MAX_HISTORY_FRAME_NUM = 7
SIGMA_DEFAULT_ACCUMULATION_TIME = 0.084
REFERENCE_MAX_HISTORY_FRAME_NUM = 4095
REFERENCE_DEFAULT_ACCUMULATION_TIME = 17.0


def get_max_accumulated_frame_num(accumulation_time: float, fps: float) -> int:
    """GetMaxAccumulatedFrameNum helper - NRDSettings.h:28-31."""
    return int(accumulation_time * fps)


_IDENTITY16 = (
    1.0, 0.0, 0.0, 0.0,
    0.0, 1.0, 0.0, 0.0,
    0.0, 0.0, 1.0, 0.0,
    0.0, 0.0, 0.0, 1.0,
)


def _mat16():
    return field(default_factory=lambda: np.zeros(16, np.float32))


def _identity16():
    return field(default_factory=lambda: np.array(_IDENTITY16, np.float32))


# ---------------------------------------------------------------------------
# CommonSettings (NRDSettings.h:88-195)
# ---------------------------------------------------------------------------


@dataclass
class CommonSettings:
    """CommonSettings - NRDSettings.h:88-195. Field semantics match the reference exactly."""

    # Matrices: column-major, vector-is-a-column, non-jittered (NRDSettings.h:90-114)
    viewToClipMatrix: np.ndarray = _mat16()
    viewToClipMatrixPrev: np.ndarray = _mat16()
    worldToViewMatrix: np.ndarray = _mat16()
    worldToViewMatrixPrev: np.ndarray = _mat16()
    worldPrevToWorldMatrix: np.ndarray = _identity16()

    # mv = IN_MV * motionVectorScale; pixelUvPrev = pixelUv + mv.xy (NRDSettings.h:117-118)
    motionVectorScale: Tuple[float, float, float] = (1.0, 1.0, 0.0)

    # [-0.5; 0.5] - sampleUv = pixelUv + cameraJitter
    cameraJitter: Tuple[float, float] = (0.0, 0.0)
    cameraJitterPrev: Tuple[float, float] = (0.0, 0.0)

    resourceSize: Tuple[int, int] = (0, 0)
    resourceSizePrev: Tuple[int, int] = (0, 0)
    rectSize: Tuple[int, int] = (0, 0)
    rectSizePrev: Tuple[int, int] = (0, 0)

    viewZScale: float = 1.0
    timeDeltaBetweenFrames: float = 0.0
    denoisingRange: float = 500000.0
    disocclusionThreshold: float = 0.01
    disocclusionThresholdAlternate: float = 0.05
    cameraAttachedReflectionMaterialID: float = 999.0
    strandMaterialID: float = 999.0
    strandThickness: float = 80e-6
    splitScreen: float = 0.0
    printfAt: Tuple[int, int] = (9999, 9999)
    debug: float = 0.0
    rectOrigin: Tuple[int, int] = (0, 0)
    frameIndex: int = 0
    accumulationMode: AccumulationMode = AccumulationMode.CONTINUE
    isMotionVectorInWorldSpace: bool = False
    isHistoryConfidenceAvailable: bool = False
    isDisocclusionThresholdMixAvailable: bool = False
    isBaseColorMetalnessAvailable: bool = False
    enableValidation: bool = False


# ---------------------------------------------------------------------------
# REBLUR settings (NRDSettings.h:201-312)
# ---------------------------------------------------------------------------


@dataclass
class HitDistanceParameters:
    """HitDistanceParameters - NRDSettings.h:206-219.

    normHitDist = saturate(hitDist / f), f = (A + viewZ*B) * lerp(1, C, exp2(D*roughness^2)).
    """

    A: float = 3.0
    B: float = 0.1
    C: float = 20.0
    D: float = -25.0


@dataclass
class ReblurAntilagSettings:
    """ReblurAntilagSettings - NRDSettings.h:221-228."""

    luminanceSigmaScale: float = 4.0
    luminanceSensitivity: float = 3.0


@dataclass
class ReblurSettings:
    """ReblurSettings - NRDSettings.h:230-312."""

    hitDistanceParameters: HitDistanceParameters = field(default_factory=HitDistanceParameters)
    antilagSettings: ReblurAntilagSettings = field(default_factory=ReblurAntilagSettings)
    maxAccumulatedFrameNum: int = 30
    maxFastAccumulatedFrameNum: int = 6
    maxStabilizedFrameNum: int = REBLUR_MAX_HISTORY_FRAME_NUM
    maxStabilizedFrameNumForHitDistance: int = REBLUR_MAX_HISTORY_FRAME_NUM
    historyFixFrameNum: int = 3
    historyFixBasePixelStride: int = 14
    diffusePrepassBlurRadius: float = 30.0
    specularPrepassBlurRadius: float = 50.0
    minHitDistanceWeight: float = 0.1
    minBlurRadius: float = 1.0
    maxBlurRadius: float = 30.0
    lobeAngleFraction: float = 0.15
    roughnessFraction: float = 0.15
    responsiveAccumulationRoughnessThreshold: float = 0.0
    planeDistanceSensitivity: float = 0.02
    specularProbabilityThresholdsForMvModification: Tuple[float, float] = (0.5, 0.9)
    fireflySuppressorMinRelativeScale: float = 2.0
    checkerboardMode: CheckerboardMode = CheckerboardMode.OFF
    hitDistanceReconstructionMode: HitDistanceReconstructionMode = HitDistanceReconstructionMode.OFF
    enableAntiFirefly: bool = False
    enablePerformanceMode: bool = False
    minMaterialForDiffuse: float = 4.0
    minMaterialForSpecular: float = 4.0
    usePrepassOnlyForSpecularMotionEstimation: bool = False


# ---------------------------------------------------------------------------
# RELAX settings (NRDSettings.h:318-427)
# ---------------------------------------------------------------------------


@dataclass
class RelaxAntilagSettings:
    """RelaxAntilagSettings - NRDSettings.h:321-332."""

    accelerationAmount: float = 0.3
    spatialSigmaScale: float = 4.5
    temporalSigmaScale: float = 0.5
    resetAmount: float = 0.5


@dataclass
class RelaxSettings:
    """RelaxSettings - NRDSettings.h:334-427."""

    antilagSettings: RelaxAntilagSettings = field(default_factory=RelaxAntilagSettings)
    diffuseMaxAccumulatedFrameNum: int = 30
    specularMaxAccumulatedFrameNum: int = 30
    diffuseMaxFastAccumulatedFrameNum: int = 6
    specularMaxFastAccumulatedFrameNum: int = 6
    historyFixFrameNum: int = 3
    historyFixBasePixelStride: int = 14
    historyFixEdgeStoppingNormalPower: float = 8.0
    spatialVarianceEstimationHistoryThreshold: int = 3
    diffusePrepassBlurRadius: float = 30.0
    specularPrepassBlurRadius: float = 50.0
    minHitDistanceWeight: float = 0.1
    diffusePhiLuminance: float = 2.0
    specularPhiLuminance: float = 1.0
    lobeAngleFraction: float = 0.5
    roughnessFraction: float = 0.15
    specularVarianceBoost: float = 0.0
    specularLobeAngleSlack: float = 0.15
    historyClampingColorBoxSigmaScale: float = 2.0
    atrousIterationNum: int = 5
    diffuseMinLuminanceWeight: float = 0.0
    specularMinLuminanceWeight: float = 0.0
    depthThreshold: float = 0.003
    confidenceDrivenRelaxationMultiplier: float = 0.0
    confidenceDrivenLuminanceEdgeStoppingRelaxation: float = 0.0
    confidenceDrivenNormalEdgeStoppingRelaxation: float = 0.0
    luminanceEdgeStoppingRelaxation: float = 0.5
    normalEdgeStoppingRelaxation: float = 0.3
    roughnessEdgeStoppingRelaxation: float = 1.0
    checkerboardMode: CheckerboardMode = CheckerboardMode.OFF
    hitDistanceReconstructionMode: HitDistanceReconstructionMode = HitDistanceReconstructionMode.OFF
    enableAntiFirefly: bool = False
    enableRoughnessEdgeStopping: bool = True
    minMaterialForDiffuse: float = 4.0
    minMaterialForSpecular: float = 4.0


# ---------------------------------------------------------------------------
# SIGMA / REFERENCE settings (NRDSettings.h:436-461)
# ---------------------------------------------------------------------------


@dataclass
class SigmaSettings:
    """SigmaSettings - NRDSettings.h:436-448."""

    lightDirection: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    planeDistanceSensitivity: float = 0.02
    maxStabilizedFrameNum: int = 5


@dataclass
class ReferenceSettings:
    """ReferenceSettings - NRDSettings.h:457-461."""

    maxAccumulatedFrameNum: int = 1020


DENOISER_SETTINGS_TYPE = {
    Denoiser.REFERENCE: ReferenceSettings,
    Denoiser.SIGMA_SHADOW: SigmaSettings,
    Denoiser.SIGMA_SHADOW_TRANSLUCENCY: SigmaSettings,
}
for _d in Denoiser:
    if _d.name.startswith("REBLUR"):
        DENOISER_SETTINGS_TYPE[_d] = ReblurSettings
    elif _d.name.startswith("RELAX"):
        DENOISER_SETTINGS_TYPE[_d] = RelaxSettings


def default_settings(denoiser: Denoiser):
    return DENOISER_SETTINGS_TYPE[denoiser]()


def replace(settings, **kwargs):
    """Functional settings update (settings are frozen-by-convention dataclasses)."""
    return dataclasses.replace(settings, **kwargs)
