// Device functions shared by the RELAX kernels (RELAX_Common.hlsli): the camera-relative
// world position from the frustum right / up / forward vectors, the plane distance, the
// luminance and YCoCg, the normal-weight parameters, the specular normal weight, the spec
// magic curve and the specular dominant direction. Each mirrors, operation for operation,
// the plain version it is held against (nrdtpu_torch/passes/relax/__init__.py,
// nrdtpu_torch/math.py and the kernels' *_ref, themselves the XLA functions of
// nrdtpu/passes/relax/kernels.py:36-136 and nrdtpu/math.py). Built with --fmad=false, as
// every kernel of the library.
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

// YCoCg -> linear rgb, negative channels clamped to 0
__device__ __forceinline__ void ycocg_to_linear(const float c[3], float out[3]) {
  const float t = c[0] - c[2];
  out[0] = fmaxf(t + c[1], 0.0f);
  out[1] = fmaxf(c[0] + c[2], 0.0f);
  out[2] = fmaxf(t - c[1], 0.0f);
}

// get_normal_weight_param2(roughness 1, fraction): 1 / max(atan(p / (1 - p + 1e-6)), ULP)
__device__ __forceinline__ float normal_weight_param2(float p) {
  const float tan_half = p / (1.0f - p + 1e-6f);
  return 1.0f / fmaxf(atanf(tan_half), kNormalUlp);
}

// GetSpecMagicCurve with the default power 0.25
__device__ __forceinline__ float spec_magic_curve(float r) {
  const float f = 1.0f - exp2f(-200.0f * r * r);
  return f * sqrtf(sqrtf(nrd::saturate(r)));
}

// ImportanceSampling::GetSpecularDominantDirection (G2 fit): the unit direction, and the
// dominant factor in *factor
__device__ __forceinline__ V3 specular_dominant_direction(V3 n, V3 v, float roughness,
                                                          float* factor) {
  const float nov = fabsf(nrd::dot3(n, v));
  const float a = 0.298475f * logf(39.4115f - 39.0029f * roughness);
  const float f = nrd::saturate(powf(nrd::saturate(1.0f - nov), 10.8649f) * (1.0f - a) + a);
  const V3 i{-v.x, -v.y, -v.z};
  const float d2 = 2.0f * nrd::dot3(n, i);
  const V3 r{i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z};
  const V3 d{n.x + (r.x - n.x) * f, n.y + (r.y - n.y) * f, n.z + (r.z - n.z) * f};
  const float inv = rsqrtf(fmaxf(d.x * d.x + d.y * d.y + d.z * d.z, 1e-15f));
  *factor = f;
  return V3{d.x * inv, d.y * inv, d.z * inv};
}

// -normalize(v), normalize guarding a zero vector with 1e-15
__device__ __forceinline__ V3 neg_normalize(V3 v) {
  const float inv = rsqrtf(fmaxf(v.x * v.x + v.y * v.y + v.z * v.z, 1e-15f));
  return V3{-(v.x * inv), -(v.y * inv), -(v.z * inv)};
}

// GetNormalWeightParams_ATrous (passes/relax/__init__.py:get_normal_weight_params_atrous)
__device__ __forceinline__ void normal_weight_params_atrous(float roughness, float hl,
                                                            float reproj, float nesr,
                                                            float lobe_fraction, float slack,
                                                            float* angle0, float* f0) {
  float relaxation = nrd::saturate(hl / 5.0f);
  relaxation = relaxation * (1.0f + (reproj - 1.0f) * nesr);
  *f0 = 0.9f + 0.1f * relaxation;
  const float r = nrd::saturate(roughness);
  const float tan_half = r * r * lobe_fraction / (1.0f - lobe_fraction + 1e-6f);
  float angle = atanf(tan_half) * (10.0f - 9.0f * relaxation);
  angle = angle + slack;
  *angle0 = fminf(nrd::kHalfPi, angle);
}

// GetSpecularNormalWeight_ATrous: saturate(1 - smoothstep(0, angle0, acos(min(n0.n, v0.v))) f0)
__device__ __forceinline__ float specular_normal_weight_atrous(float angle0, float f0, V3 n0,
                                                               V3 n, V3 v0, V3 v) {
  const float cosa = fminf(nrd::dot3(n0, n), nrd::dot3(v0, v));
  const float a = nrd::smoothstep(0.0f, angle0, nrd::acos_approx(cosa));
  return nrd::saturate(1.0f - a * f0);
}

}  // namespace relax
