"""ctypes bindings of the port's C ABI (`include/nrdtpu_c.h`) for Python callers and checks:
the structs a caller fills, and `load()`, which builds the shim at first use and declares the
return types of its entry points.

    lib = bindings.load()
    inst = ctypes.c_void_p()
    lib.nrdtpu_create_instance_device(descs, 1, w, h, 2, 0, b"cuda", ctypes.byref(inst))
    lib.nrdtpu_set_common_settings(inst, ctypes.byref(bindings.common_settings_c(cs)))
    lib.nrdtpu_denoise(inst, idents, 1, slots, len(slots))
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build


class CommonSettingsC(ctypes.Structure):
    _fields_ = [
        ("view_to_clip_matrix", ctypes.c_float * 16),
        ("view_to_clip_matrix_prev", ctypes.c_float * 16),
        ("world_to_view_matrix", ctypes.c_float * 16),
        ("world_to_view_matrix_prev", ctypes.c_float * 16),
        ("world_prev_to_world_matrix", ctypes.c_float * 16),
        ("motion_vector_scale", ctypes.c_float * 3),
        ("camera_jitter", ctypes.c_float * 2),
        ("camera_jitter_prev", ctypes.c_float * 2),
        ("resource_size", ctypes.c_uint16 * 2),
        ("resource_size_prev", ctypes.c_uint16 * 2),
        ("rect_size", ctypes.c_uint16 * 2),
        ("rect_size_prev", ctypes.c_uint16 * 2),
        ("view_z_scale", ctypes.c_float),
        ("time_delta_between_frames", ctypes.c_float),
        ("denoising_range", ctypes.c_float),
        ("disocclusion_threshold", ctypes.c_float),
        ("disocclusion_threshold_alternate", ctypes.c_float),
        ("camera_attached_reflection_material_id", ctypes.c_float),
        ("strand_material_id", ctypes.c_float),
        ("strand_thickness", ctypes.c_float),
        ("split_screen", ctypes.c_float),
        ("debug", ctypes.c_float),
        ("rect_origin", ctypes.c_uint32 * 2),
        ("frame_index", ctypes.c_uint32),
        ("accumulation_mode", ctypes.c_uint8),
        ("is_motion_vector_in_world_space", ctypes.c_uint8),
        ("is_history_confidence_available", ctypes.c_uint8),
        ("is_disocclusion_threshold_mix_available", ctypes.c_uint8),
        ("is_base_color_metalness_available", ctypes.c_uint8),
        ("enable_validation", ctypes.c_uint8),
    ]


class DenoiserDescC(ctypes.Structure):
    _fields_ = [("identifier", ctypes.c_uint32), ("denoiser", ctypes.c_int)]


class ResourceSlotC(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("data", ctypes.POINTER(ctypes.c_float)),
                ("channels", ctypes.c_uint32)]


# CommonSettingsC field <- CommonSettings attribute (the shim's own mapping, in reverse)
_FIELDS = {
    "view_to_clip_matrix": "viewToClipMatrix", "view_to_clip_matrix_prev": "viewToClipMatrixPrev",
    "world_to_view_matrix": "worldToViewMatrix",
    "world_to_view_matrix_prev": "worldToViewMatrixPrev",
    "world_prev_to_world_matrix": "worldPrevToWorldMatrix",
    "motion_vector_scale": "motionVectorScale", "camera_jitter": "cameraJitter",
    "camera_jitter_prev": "cameraJitterPrev", "resource_size": "resourceSize",
    "resource_size_prev": "resourceSizePrev", "rect_size": "rectSize",
    "rect_size_prev": "rectSizePrev", "view_z_scale": "viewZScale",
    "time_delta_between_frames": "timeDeltaBetweenFrames", "denoising_range": "denoisingRange",
    "disocclusion_threshold": "disocclusionThreshold",
    "disocclusion_threshold_alternate": "disocclusionThresholdAlternate",
    "camera_attached_reflection_material_id": "cameraAttachedReflectionMaterialID",
    "strand_material_id": "strandMaterialID", "strand_thickness": "strandThickness",
    "split_screen": "splitScreen", "debug": "debug", "rect_origin": "rectOrigin",
    "frame_index": "frameIndex", "accumulation_mode": "accumulationMode",
    "is_motion_vector_in_world_space": "isMotionVectorInWorldSpace",
    "is_history_confidence_available": "isHistoryConfidenceAvailable",
    "is_disocclusion_threshold_mix_available": "isDisocclusionThresholdMixAvailable",
    "is_base_color_metalness_available": "isBaseColorMetalnessAvailable",
    "enable_validation": "enableValidation",
}


def common_settings_c(cs) -> CommonSettingsC:
    """The C struct of a CommonSettings: each field the struct has, as float32 or integers."""
    out = CommonSettingsC()
    for field, ctype in CommonSettingsC._fields_:
        v = getattr(cs, _FIELDS[field])
        if issubclass(ctype, ctypes.Array):
            conv = float if ctype._type_ is ctypes.c_float else int
            getattr(out, field)[:] = [conv(x) for x in np.asarray(v).reshape(-1)]
        else:
            setattr(out, field, float(v) if ctype is ctypes.c_float else int(v))
    return out


def common_settings_from_c(c: CommonSettingsC):
    """The CommonSettings that the shim makes of the struct (`nrdtpu_set_common_settings`):
    a C caller's frame as the Engine sees it, its floats rounded to float32."""
    from ..settings import AccumulationMode, CommonSettings

    cs = CommonSettings()
    for field, ctype in CommonSettingsC._fields_:
        v = getattr(c, field)
        attr = _FIELDS[field]
        if issubclass(ctype, ctypes.Array):
            v = list(v) if len(v) == 16 else tuple(v)  # the matrices as lists, as the shim
        elif attr == "accumulationMode":
            v = AccumulationMode(v)
        elif ctype is ctypes.c_uint8:
            v = bool(v)
        setattr(cs, attr, v)
    return cs


def load() -> ctypes.CDLL:
    """The shim, built at first use, with the argument and return types of the entry points
    that these bindings cover declared."""
    lib = ctypes.CDLL(str(build.build()))
    c = ctypes
    ptr, u16, u32 = c.c_void_p, c.c_uint16, c.c_uint32
    create = [c.POINTER(DenoiserDescC), u32, u16, u16, u32, u32]
    for name, args, res in (
            ("nrdtpu_create_instance", create + [c.POINTER(ptr)], c.c_int),
            ("nrdtpu_create_instance_device", create + [c.c_char_p, c.POINTER(ptr)], c.c_int),
            ("nrdtpu_set_common_settings", [ptr, c.POINTER(CommonSettingsC)], c.c_int),
            ("nrdtpu_set_denoiser_settings", [ptr, u32, c.c_char_p], c.c_int),
            ("nrdtpu_denoise", [ptr, c.POINTER(u32), u32, c.POINTER(ResourceSlotC), u32],
             c.c_int),
            ("nrdtpu_destroy_instance", [ptr], c.c_int),
            ("nrdtpu_get_last_error", [], c.c_char_p),
            ("nrdtpu_get_version_string", [], c.c_char_p),
            ("nrdtpu_get_denoiser_string", [c.c_int], c.c_char_p),
            ("nrdtpu_get_resource_type_string", [c.c_int], c.c_char_p)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def slot(resource, plane: np.ndarray) -> ResourceSlotC:
    """A resource slot over a C-contiguous float32 (h, w[, c]) array (kept alive by the
    caller)."""
    if plane.dtype != np.float32 or not plane.flags.c_contiguous:
        raise ValueError("a slot needs a C-contiguous float32 plane")
    channels = 1 if plane.ndim == 2 else plane.shape[2]
    return ResourceSlotC(int(resource), plane.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         channels)
