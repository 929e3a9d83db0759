"""Per-frame host math: CommonSettings -> FrameConstants (numpy only).

Counterpart of `nrdtpu/camera.py`, itself a port of `InstanceImpl::SetCommonSettings`
(Source/InstanceImpl.cpp:269-473) and the shared-constant derivations repeated in every
`AddSharedConstants_*` (e.g. Source/Reblur.cpp:297-406).

All of this runs on the host in numpy once per frame; the result is a flat dict of small
float32 arrays (`FrameConstants`) that enter the torch glue as Python scalars and the
hand kernels as launch arguments - nothing is copied to the device.

Conventions (identical to the reference):
  - matrices are column-major storage, vector-is-a-column usage (NRDSettings.h:90-94);
    internally we keep (4, 4) numpy arrays with `clip = M @ view` semantics.
  - everything is converted to LEFT-handed view space (+z into the screen),
    InstanceImpl.cpp:392-408.
  - matrices are made camera-relative: current camera position is the world origin;
    the previous view matrix gets the translation delta (InstanceImpl.cpp:417-428).
    This is the precision-critical trick that lets FP32 world positions survive huge scenes.
  - frustum = (x0, y0, dx, dy): view-space x/z, y/z at uv=(0,0) (y-down uv) plus uv->xy
    scales, consumed by `math.reconstruct_view_position`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import math as nm
from .settings import AccumulationMode, CommonSettings

# ---------------------------------------------------------------------------
# Matrix helpers (MathLib float4x4 subset)
# ---------------------------------------------------------------------------


def mat_from_flat(flat) -> np.ndarray:
    """Column-major 16-float array -> (4,4) numpy with `M @ column_vector` usage."""
    a = np.asarray(flat, np.float32)
    if a.shape == (4, 4):
        return a.astype(np.float32)
    return a.reshape(4, 4, order="F").astype(np.float32)


def invert_ortho(m: np.ndarray) -> np.ndarray:
    """float4x4::InvertOrtho - rigid (rotation+translation) inverse."""
    r = m[:3, :3]
    t = m[:3, 3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def perspective_lh(fov_y: float, aspect: float, znear: float, zfar: float | None = None,
                   jitter_xy=(0.0, 0.0)) -> np.ndarray:
    """Build a left-handed D3D-style projection (clip z in [0,1], +z forward).

    Helper for tests / the synthetic scene generator; the reference receives this matrix
    from the application. `jitter_xy` are NDC offsets (NRD itself wants NON-jittered).
    """
    f = 1.0 / np.tan(0.5 * fov_y)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    if zfar is None:  # infinite far plane
        m[2, 2] = 1.0
        m[2, 3] = -znear
    else:
        m[2, 2] = zfar / (zfar - znear)
        m[2, 3] = -znear * zfar / (zfar - znear)
    m[3, 2] = 1.0
    m[0, 2] = jitter_xy[0]
    m[1, 2] = jitter_xy[1]
    return m


def perspective_rh(fov_y: float, aspect: float, znear: float, zfar: float | None = None,
                   jitter_xy=(0.0, 0.0)) -> np.ndarray:
    """Right-handed D3D-style projection (camera looks down -z), pairs with `look_at_rh`."""
    m = perspective_lh(fov_y, aspect, znear, zfar, jitter_xy)
    m[:, 2] = -m[:, 2]
    return m


def look_at_rh(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Right-handed world->view matrix (camera looks down -z), for tests/scenes."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(target, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


# ---------------------------------------------------------------------------
# DecomposeProjection subset (MathLib) - flags + frustum + project scale
# ---------------------------------------------------------------------------


@dataclass
class ProjectionInfo:
    is_ortho: bool
    is_left_handed: bool
    frustum: np.ndarray  # (4,) x0, y0, dx, dy for y-down uv
    project_y: float     # m[1,1] - 1/tan(fovY/2) for perspective


def decompose_projection(p: np.ndarray) -> ProjectionInfo:
    """Subset of MathLib `DecomposeProjection` used by InstanceImpl.cpp:394,446.

    Supports axis-aligned (optionally off-center / jittered) perspective & ortho matrices in
    D3D clip conventions (z/w in [0,1], y up in NDC).
    """
    p = np.asarray(p, np.float32)
    w_row_z = float(p[3, 2])
    is_ortho = abs(w_row_z) < 1e-9
    if is_ortho:
        is_lh = float(p[2, 2]) > 0.0
        # ndc_x = x*p00 + p03 -> x(u) = ((2u-1) - p03)/p00, z-independent
        x0 = (-1.0 - float(p[0, 3])) / float(p[0, 0])
        dx = 2.0 / float(p[0, 0])
        y0 = (1.0 - float(p[1, 3])) / float(p[1, 1])
        dy = -2.0 / float(p[1, 1])
    else:
        is_lh = w_row_z > 0.0
        s = 1.0 if is_lh else -1.0
        # ndc_x = (x*p00 + z*p02) / (s*z) -> x/z(u) = ((2u-1)*s - p02)/p00
        x0 = (-1.0 * s - float(p[0, 2])) / float(p[0, 0])
        dx = 2.0 * s / float(p[0, 0])
        y0 = (1.0 * s - float(p[1, 2])) / float(p[1, 1])
        dy = -2.0 * s / float(p[1, 1])
    return ProjectionInfo(
        is_ortho=is_ortho,
        is_left_handed=is_lh,
        frustum=np.array([x0, y0, dx, dy], np.float32),
        project_y=float(p[1, 1]),
    )


# ---------------------------------------------------------------------------
# FrameConstants
# ---------------------------------------------------------------------------


def _rotators(frame_index: int):
    """Per-frame kernel rotators - InstanceImpl.cpp:339-349."""
    a1 = float(nm.weyl1d(0.5, frame_index)) * np.radians(90.0)
    rot_pre = np.asarray(nm.get_rotator(a1), np.float32)

    a0 = float(nm.weyl1d(0.0, frame_index * 2)) * np.radians(90.0)
    b0 = float(nm.bayer4x4((0, 0), frame_index * 2)) * np.radians(360.0)
    rot = np.asarray(nm.combine_rotators(nm.get_rotator(a0), nm.get_rotator(b0)), np.float32)

    a2 = float(nm.weyl1d(0.0, frame_index * 2 + 1)) * np.radians(90.0)
    b2 = float(nm.bayer4x4((0, 0), frame_index * 2 + 1)) * np.radians(360.0)
    rot_post = np.asarray(nm.combine_rotators(nm.get_rotator(a2), nm.get_rotator(b2)), np.float32)
    return rot_pre, rot, rot_post


class FrameMath:
    """Stateful per-frame host math - the `SetCommonSettings` half of InstanceImpl.

    Holds the tiny bits of host state the reference keeps between frames (prev matrices for
    history-reset snapping, smoothed frame time) and produces a fresh `FrameConstants` dict
    each frame.
    """

    def __init__(self):
        self._is_first_use = True
        self._split_screen_prev = 0.0
        self._smoothed_dt_ms = 1000.0 / 60.0
        self._world_to_clip_prev_for_ref = None  # REFERENCE-style change detection

    # -- timer (Source/Timer.cpp:53-64 exponential smoothing) ---------------
    def update_timer(self, raw_dt_ms: float | None):
        if raw_dt_ms is not None and raw_dt_ms > 0:
            f = max(min(raw_dt_ms / self._smoothed_dt_ms - 1.0, 1.0), -1.0)
            weight = 0.25 * abs(f)
            self._smoothed_dt_ms = nm.lerp(self._smoothed_dt_ms, raw_dt_ms, max(weight, 0.1))
        return self._smoothed_dt_ms

    def set_common_settings(self, cs: CommonSettings, raw_dt_ms: float | None = None) -> dict:
        split_screen_prev = self._split_screen_prev
        self._split_screen_prev = cs.splitScreen

        # Work on an internal copy: the reference mutates ITS copy of the settings
        # (m_CommonSettings, InstanceImpl.cpp:276-297), never the app's struct. The
        # previous in-place mutation latched first-use CLEAR_AND_RESTART into the
        # caller's object, so any app reusing one CommonSettings across frames was
        # stuck in permanent-reset (max_accumulated_frame_num forced to 0 forever) -
        # this poisoned every bench.py number before round 3.
        import copy as _copy

        cs = _copy.copy(cs)
        if self._is_first_use:
            cs.accumulationMode = AccumulationMode.CLEAR_AND_RESTART
            self._is_first_use = False

        if cs.accumulationMode != AccumulationMode.CONTINUE:
            # snap prev state to current - InstanceImpl.cpp:282-297
            split_screen_prev = 0.0
            cs.worldToViewMatrixPrev = np.array(cs.worldToViewMatrix, np.float32).copy()
            cs.viewToClipMatrixPrev = np.array(cs.viewToClipMatrix, np.float32).copy()
            cs.resourceSizePrev = tuple(cs.resourceSize)
            cs.rectSizePrev = tuple(cs.rectSize)
            cs.cameraJitterPrev = tuple(cs.cameraJitter)

        # -- validation (InstanceImpl.cpp:300-337) --------------------------
        assert cs.viewZScale > 0.0, "'viewZScale' can't be <= 0"
        assert all(cs.resourceSize) and all(cs.rectSize), "'resourceSize'/'rectSize' can't be 0"
        assert all(cs.resourceSizePrev) and all(cs.rectSizePrev)
        assert (cs.motionVectorScale[0] != 0 and cs.motionVectorScale[1] != 0) \
            or cs.isMotionVectorInWorldSpace, "'mvScale.xy' can't be 0"
        assert all(-0.5 <= j <= 0.5 for j in cs.cameraJitter + cs.cameraJitterPrev)
        assert cs.denoisingRange > 0.0
        assert cs.disocclusionThreshold > 0.0 and cs.disocclusionThresholdAlternate > 0.0

        rotator_pre, rotator, rotator_post = _rotators(cs.frameIndex)

        # -- matrix pipeline (InstanceImpl.cpp:351-456) ----------------------
        view_to_clip = mat_from_flat(cs.viewToClipMatrix)
        view_to_clip_prev = mat_from_flat(cs.viewToClipMatrixPrev)
        world_to_view = mat_from_flat(cs.worldToViewMatrix)
        world_to_view_prev = mat_from_flat(cs.worldToViewMatrixPrev)
        world_prev_to_world = mat_from_flat(cs.worldPrevToWorldMatrix)

        info = decompose_projection(view_to_clip)
        if not info.is_left_handed and not info.is_ortho:
            view_to_clip = view_to_clip.copy()
            view_to_clip[:, 2] = -view_to_clip[:, 2]
            view_to_clip_prev = view_to_clip_prev.copy()
            view_to_clip_prev[:, 2] = -view_to_clip_prev[:, 2]
            world_to_view = world_to_view.copy()
            world_to_view[2, :] = -world_to_view[2, :]
            world_to_view_prev = world_to_view_prev.copy()
            world_to_view_prev[2, :] = -world_to_view_prev[2, :]

        view_to_world = invert_ortho(world_to_view)
        view_to_world_prev = invert_ortho(world_to_view_prev)

        camera_position = view_to_world[:3, 3].copy()
        camera_position_prev = view_to_world_prev[:3, 3].copy()
        translation_delta = camera_position_prev - camera_position

        # camera-relative matrices - InstanceImpl.cpp:421-428 (precision-critical)
        view_to_world[:3, 3] = 0.0
        world_to_view = invert_ortho(view_to_world)
        view_to_world_prev[:3, 3] = translation_delta
        world_to_view_prev = invert_ortho(view_to_world_prev)

        world_to_clip = view_to_clip @ world_to_view
        world_to_clip_prev = view_to_clip_prev @ world_to_view_prev
        clip_to_world_prev = np.linalg.inv(world_to_clip_prev).astype(np.float32)
        clip_to_view = np.linalg.inv(view_to_clip).astype(np.float32)
        clip_to_view_prev = np.linalg.inv(view_to_clip_prev).astype(np.float32)
        clip_to_world = np.linalg.inv(world_to_clip).astype(np.float32)

        info = decompose_projection(view_to_clip)
        info_prev = decompose_projection(view_to_clip_prev)
        project_y = info.project_y
        ortho_mode = -1.0 if info.is_ortho else 0.0

        view_direction = -view_to_world[:3, 2].copy()
        view_direction_prev = -view_to_world_prev[:3, 2].copy()

        # -- timing (InstanceImpl.cpp:458-470) -------------------------------
        smoothed = self.update_timer(raw_dt_ms)
        time_delta = cs.timeDeltaBetweenFrames if cs.timeDeltaBetweenFrames > 0 else smoothed
        frame_rate_scale = max(33.333 / time_delta, 1.0)

        dx = abs(cs.cameraJitter[0] - cs.cameraJitterPrev[0])
        dy = abs(cs.cameraJitter[1] - cs.cameraJitterPrev[1])
        jitter_delta = max(dx, dy)

        fps = frame_rate_scale * 30.0
        non_linear_accum_speed = fps * 0.25 / (1.0 + fps * 0.25)
        checkerboard_resolve_accum_speed = nm.lerp(non_linear_accum_speed, 0.5, jitter_delta)

        # -- shared derived constants (Reblur.cpp:304-315 etc.) --------------
        rect_w, rect_h = int(cs.rectSize[0]), int(cs.rectSize[1])
        rect_wp, rect_hp = int(cs.rectSizePrev[0]), int(cs.rectSizePrev[1])
        res_w, res_h = int(cs.resourceSize[0]), int(cs.resourceSize[1])
        res_wp, res_hp = int(cs.resourceSizePrev[0]), int(cs.resourceSizePrev[1])
        unproject = 1.0 / (0.5 * rect_h * project_y)
        is_history_reset = cs.accumulationMode != AccumulationMode.CONTINUE
        is_rect_changed = rect_w != rect_wp or rect_h != rect_hp

        f32 = np.float32
        consts = {
            "world_to_clip": world_to_clip,
            "view_to_clip": view_to_clip,
            "view_to_world": view_to_world,
            "world_to_view": world_to_view,
            "world_to_view_prev": world_to_view_prev,
            "world_to_clip_prev": world_to_clip_prev,
            "view_to_world_prev": view_to_world_prev,
            "view_to_clip_prev": view_to_clip_prev,
            "clip_to_world": clip_to_world,
            "clip_to_world_prev": clip_to_world_prev,
            "clip_to_view": clip_to_view,
            "clip_to_view_prev": clip_to_view_prev,
            "world_prev_to_world": world_prev_to_world,
            "rotator_pre": rotator_pre,
            "rotator": rotator,
            "rotator_post": rotator_post,
            "frustum": info.frustum,
            "frustum_prev": info_prev.frustum,
            "camera_delta": translation_delta.astype(f32),
            "view_vector_world": view_direction.astype(f32),
            "view_vector_world_prev": view_direction_prev.astype(f32),
            "mv_scale": np.array([cs.motionVectorScale[0], cs.motionVectorScale[1],
                                  cs.motionVectorScale[2],
                                  1.0 if cs.isMotionVectorInWorldSpace else 0.0], f32),
            "resource_size": np.array([res_w, res_h], f32),
            "resource_size_inv": np.array([1.0 / res_w, 1.0 / res_h], f32),
            "resource_size_inv_prev": np.array([1.0 / res_wp, 1.0 / res_hp], f32),
            "rect_size": np.array([rect_w, rect_h], f32),
            "rect_size_inv": np.array([1.0 / rect_w, 1.0 / rect_h], f32),
            "rect_size_prev": np.array([rect_wp, rect_hp], f32),
            "resolution_scale": np.array([rect_w / res_w, rect_h / res_h], f32),
            "resolution_scale_prev": np.array([rect_wp / res_wp, rect_hp / res_hp], f32),
            "rect_offset": np.array([cs.rectOrigin[0] / res_w, cs.rectOrigin[1] / res_h], f32),
            "jitter": np.array(cs.cameraJitter, f32),
            "jitter_prev": np.array(cs.cameraJitterPrev, f32),
            "rect_origin": np.array(cs.rectOrigin, f32),
            "disocclusion_threshold": f32(cs.disocclusionThreshold),
            "disocclusion_threshold_alternate": f32(cs.disocclusionThresholdAlternate),
            "disocclusion_threshold_bonus": f32((1.0 + jitter_delta) / rect_h),
            "camera_attached_reflection_material_id": f32(cs.cameraAttachedReflectionMaterialID),
            "strand_material_id": f32(cs.strandMaterialID),
            "strand_thickness": f32(cs.strandThickness),
            "debug": f32(cs.debug),
            "ortho_mode": f32(ortho_mode),
            "unproject": f32(unproject),
            "project_y": f32(project_y),
            "min_rect_dim_mul_unproject": f32(min(rect_w, rect_h) * unproject),
            "denoising_range": f32(cs.denoisingRange),
            "framerate_scale": f32(frame_rate_scale),
            "time_delta": f32(time_delta),
            "jitter_delta": f32(jitter_delta),
            "checkerboard_resolve_accum_speed": f32(checkerboard_resolve_accum_speed),
            "split_screen": f32(cs.splitScreen),
            "split_screen_prev": f32(split_screen_prev),
            "view_z_scale": f32(cs.viewZScale),
            "frame_index": np.int32(cs.frameIndex),
            "is_rect_changed": f32(1.0 if is_rect_changed else 0.0),
            "reset_history": f32(1.0 if is_history_reset else 0.0),
        }
        return consts
