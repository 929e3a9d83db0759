// Device functions shared by the RELAX kernels (RELAX_Common.hlsli): the camera-relative
// world position from the frustum right / up / forward vectors, the plane distance, the
// luminance and YCoCg. Each mirrors, operation for operation, the plain version it is held
// against (nrdtpu_torch/passes/relax/__init__.py and the kernels' *_ref, themselves the XLA
// functions of nrdtpu/passes/relax/kernels.py:36-136). Built with --fmad=false, as every
// kernel of the library.
#pragma once

#include "common.cuh"

namespace relax {

using nrd::V3;

constexpr float kNormalUlp = 1.5f / 255.0f;  // RELAX_NORMAL_ULP

// The per-frame geometry every RELAX kernel reads: consts[0..10] of its launch are right[3],
// up[3], forward[3], ortho mode, viewZ scale.
struct Frame {
  float right[3], up[3], fwd[3];
  float ortho, view_z_scale;
  int w, h;
};

constexpr int kFrameConsts = 11;

inline Frame load_frame(const float* c, int w, int h) {
  Frame f;
  for (int k = 0; k < 3; ++k) {
    f.right[k] = c[k];
    f.up[k] = c[3 + k];
    f.fwd[k] = c[6 + k];
  }
  f.ortho = c[9];
  f.view_z_scale = c[10];
  f.w = w;
  f.h = h;
  return f;
}

__device__ __forceinline__ float view_z(const Frame& f, float raw) {
  return fabsf(raw) * f.view_z_scale;
}

// GetCurrentWorldPosFromClipSpaceXY on a uv (y down): the array form of
// nrdtpu/passes/relax/kernels.py:73-84, (forward + right cx) - up cy, times viewZ
__device__ __forceinline__ V3 world_pos(const Frame& f, float u, float v, float z) {
  const float cx = u * 2.0f - 1.0f, cy = v * 2.0f - 1.0f;
  if (f.ortho == 0.0f)
    return V3{z * ((f.fwd[0] + f.right[0] * cx) - f.up[0] * cy),
              z * ((f.fwd[1] + f.right[1] * cx) - f.up[1] * cy),
              z * ((f.fwd[2] + f.right[2] * cx) - f.up[2] * cy)};
  return V3{(z * f.fwd[0] + f.right[0] * cx) - f.up[0] * cy,
            (z * f.fwd[1] + f.right[1] * cx) - f.up[1] * cy,
            (z * f.fwd[2] + f.right[2] * cx) - f.up[2] * cy};
}

// |dot(xs - x, n)|, the plane distance of a tap
__device__ __forceinline__ float plane_dist(V3 xs, V3 x, V3 n) {
  return fabsf(nrd::dot3(V3{xs.x - x.x, xs.y - x.y, xs.z - x.z}, n));
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return r * 0.2126f + g * 0.7152f + b * 0.0722f;
}

__device__ __forceinline__ void linear_to_ycocg(float r, float g, float b, float out[3]) {
  out[0] = 0.25f * r + 0.5f * g + 0.25f * b;
  out[1] = 0.5f * r - 0.5f * b;
  out[2] = -0.25f * r + 0.5f * g - 0.25f * b;
}

// get_normal_weight_param2(roughness 1, fraction): 1 / max(atan(p / (1 - p + 1e-6)), ULP)
__device__ __forceinline__ float normal_weight_param2(float p) {
  const float tan_half = p / (1.0f - p + 1e-6f);
  return 1.0f / fmaxf(atanf(tan_half), kNormalUlp);
}

}  // namespace relax
