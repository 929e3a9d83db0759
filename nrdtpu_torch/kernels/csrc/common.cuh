// Device functions shared by the REBLUR kernels. Each mirrors, operation for operation, the
// plain version it is held against: nrdtpu_torch/math.py, nrdtpu_torch/frontend.py and
// nrdtpu_torch/ops/resample.py (themselves the XLA functions of nrdtpu/math.py and
// nrdtpu/ops/resample.py). The library is built with --fmad=false, so a*b+c stays two
// roundings, as in the plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nrd {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr int kBlock = 16;  // 16x16 threads, one per pixel

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// float texel coordinate -> int, bounded first (any coordinate beyond +-2^20 clamps to the
// same edge texel)
__device__ __forceinline__ int to_index(float v) {
  return (int)fminf(fmaxf(v, -1048576.0f), 1048576.0f);
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// (h, w, C) image with clamp-to-edge addressing
template <typename T, int C>
struct Image {
  const T* p;
  int w, h;
  __device__ __forceinline__ size_t index(int x, int y) const {
    return (size_t)clampi(y, 0, h - 1) * w + clampi(x, 0, w - 1);
  }
  __device__ __forceinline__ float at(int x, int y, int c) const {
    return load(p + index(x, y) * C + c);
  }
  // Through the read-only path, for images that the launch does not write; the index is
  // clamped once. at4: a float (h, w, 4) record as one 16-byte load (the wrappers check that
  // such images are 16-byte aligned); ldg: a float (h, w) texel.
  __device__ __forceinline__ float4 at4(int x, int y) const {
    return __ldg(reinterpret_cast<const float4*>(p) + index(x, y));
  }
  __device__ __forceinline__ float ldg(int x, int y) const { return __ldg(p + index(x, y)); }
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// NRD_FrontEnd_UnpackNormalAndRoughness normal: octahedral decode + _NRD_SafeNormalize
__device__ __forceinline__ V3 unpack_normal(float px, float py) {
  float qx = px * 2.0f - 1.0f;
  float qy = py * 2.0f - 1.0f;
  float z = 1.0f - fabsf(qx) - fabsf(qy);
  float t = saturate(-z);
  float x = qx - t * (qx >= 0.0f ? 1.0f : -1.0f);
  float y = qy - t * (qy >= 0.0f ? 1.0f : -1.0f);
  float inv = rsqrtf(x * x + y * y + z * z + 1e-9f);
  return V3{x * inv, y * inv, z * inv};
}

// The roughness of a packed normal's .z under the roughness encoding (NRD.hlsli:600-628), a
// kernel's template parameter: 0 LINEAR as packed, 1 SQRT_LINEAR squared, 2 SQ_LINEAR
// sqrt(saturate(.)) (nrdtpu_torch/kernels/build.py:ROUGHNESS_MODE)
template <int kRough>
__device__ __forceinline__ float decode_roughness(float r) {
  static_assert(kRough >= 0 && kRough <= 2, "roughness mode 0, 1 or 2");
  if constexpr (kRough == 1) return r * r;
  if constexpr (kRough == 2) return sqrtf(saturate(r));
  return r;
}

// Math::AcosApprox as the JAX package defines it
__device__ __forceinline__ float acos_approx(float x) {
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  float res = sqrtf(saturate(1.0f - fabsf(x))) * kHalfPi;
  return x >= 0.0f ? res : kPi - res;
}

// ComputeNonExponentialWeight: SmoothStep(1, 0, |x px + py|)
__device__ __forceinline__ float compute_weight(float x, float px, float py) {
  float t = saturate((fabsf(x * px + py) - 1.0f) / -1.0f);
  return t * t * (3.0f - 2.0f * t);
}

// HLSL smoothstep(a, b, x), also for a > b
__device__ __forceinline__ float smoothstep(float a, float b, float x) {
  float t = saturate((x - a) / (b - a));
  return t * t * (3.0f - 2.0f * t);
}

// ComputeNonExponentialWeightWithSigma: SmoothStep(1, 0, |x px + py| - sigma px)
__device__ __forceinline__ float compute_weight_with_sigma(float x, float px, float py,
                                                           float sigma) {
  float t = saturate((fabsf(x * px + py) - sigma * px - 1.0f) / -1.0f);
  return t * t * (3.0f - 2.0f * t);
}

// Rng::Hash (PCG), as nrdtpu_torch/math.py:hash_* emulates it in int64
__device__ __forceinline__ uint32_t hash_init(uint32_t x, uint32_t y, uint32_t frame) {
  uint32_t s = (x * 1597334677u) ^ (y * 3812015801u) ^ (frame * 2798796415u);
  return s * 747796405u + 2891336453u;
}

__device__ __forceinline__ float hash_float(uint32_t& s) {
  s = s * 747796405u + 2891336453u;
  uint32_t word = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
  uint32_t bits = (word >> 22u) ^ word;
  return (float)(bits >> 8u) * (1.0f / 16777216.0f);
}

// ComputeExponentialWeight with the true exponential
__device__ __forceinline__ float compute_exponential_weight(float x, float px, float py) {
  return expf(-3.0f * fabsf(x * px + py));
}

__device__ __forceinline__ float in_screen_nearest(float u, float v) {
  return (u > 0.0f && v > 0.0f && u < 1.0f && v < 1.0f) ? 1.0f : 0.0f;
}

// Geometry::ReconstructViewPosition; fr = (x0, y0, dx, dy)
__device__ __forceinline__ V3 reconstruct_view_position(float u, float v, const float fr[4],
                                                        float z, float ortho) {
  float scale = z + (1.0f - z) * fabsf(ortho);
  return V3{(u * fr[2] + fr[0]) * scale, (v * fr[3] + fr[1]) * scale, z};
}

// bilinear weights of fractional offsets, order (00, 10, 01, 11)
__device__ __forceinline__ void bilinear_weights(float fx, float fy, float w[4]) {
  w[0] = (1.0f - fx) * (1.0f - fy);
  w[1] = fx * (1.0f - fy);
  w[2] = (1.0f - fx) * fy;
  w[3] = fx * fy;
}

// Filtering::ApplyBilinearCustomWeights over the 2x2 at integer origin (x0, y0):
// renormalized, 0 where the weight sum is ~0
template <typename T, int C>
__device__ __forceinline__ void bilinear_custom(const Image<T, C>& img, int x0, int y0,
                                                const float w[4], float out[C]) {
  float wsum = w[0] + w[1] + w[2] + w[3];
  bool small = wsum < 0.0001f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s = img.at(x0, y0, c) * w[0] + img.at(x0 + 1, y0, c) * w[1] +
              img.at(x0, y0 + 1, c) * w[2] + img.at(x0 + 1, y0 + 1, c) * w[3];
    out[c] = small ? 0.0f : s / wsum;
  }
}

// linear-clamp sample at uv (SampleLevel with gLinearClamp)
template <typename T, int C>
__device__ __forceinline__ void sample_bilinear(const Image<T, C>& img, float u, float v,
                                                float out[C]) {
  float posx = u * (float)img.w - 0.5f;
  float posy = v * (float)img.h - 0.5f;
  float ox = floorf(posx), oy = floorf(posy);
  float w[4];
  bilinear_weights(posx - ox, posy - oy, w);
  int x0 = to_index(ox), y0 = to_index(oy);
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[c] = img.at(x0, y0, c) * w[0] + img.at(x0 + 1, y0, c) * w[1] +
             img.at(x0, y0 + 1, c) * w[2] + img.at(x0 + 1, y0 + 1, c) * w[3];
}

// Catmull-Rom weights per axis, sharpness 0.5
__device__ __forceinline__ void catmull_rom_weights(float f, float w[4]) {
  w[0] = f * (f * (-0.5f * f + 1.0f) - 0.5f);
  w[1] = f * (f * (1.5f * f - 2.5f)) + 1.0f;
  w[2] = f * (f * (-1.5f * f + 2.0f) + 0.5f);
  w[3] = f * (f * (0.5f * f - 0.5f));
}

// The 5 bilinear taps of _BicubicFilterNoCornersWithFallbackToBilinearFilterWithCustomWeights
// (Common.hlsli:602-646): 13-tap Catmull-Rom, or the custom bilinear weights bw where
// use_bicubic is false. (spx, spy) is the sample position in pixels. Computed once, they
// apply to every image of the same size (catrom_apply).
struct CatromTaps {
  float wt[5], tx[5], ty[5], wsum;
};

__device__ __forceinline__ CatromTaps catrom_taps(float spx, float spy, bool use_bicubic,
                                                  const float bw[4]) {
  float cx = floorf(spx - 0.5f) + 0.5f;
  float cy = floorf(spy - 0.5f) + 0.5f;
  float fx = saturate(spx - cx);
  float fy = saturate(spy - cy);
  float wx[4], wy[4];
  catmull_rom_weights(fx, wx);
  catmull_rom_weights(fy, wy);
  float w12x = wx[1] + wx[2], w12y = wy[1] + wy[2];
  float tcx = wx[2] / w12x;
  float tcy = wy[2] / w12y;

  CatromTaps t;
  if (use_bicubic) {
    t.wt[0] = w12x * wy[0]; t.tx[0] = cx + tcx; t.ty[0] = cy - 1.0f;
    t.wt[1] = wx[0] * w12y; t.tx[1] = cx - 1.0f; t.ty[1] = cy + tcy;
    t.wt[2] = w12x * w12y;  t.tx[2] = cx + tcx; t.ty[2] = cy + tcy;
    t.wt[3] = wx[3] * w12y; t.tx[3] = cx + 2.0f; t.ty[3] = cy + tcy;
    t.wt[4] = w12x * wy[3]; t.tx[4] = cx + tcx; t.ty[4] = cy + 2.0f;
  } else {
    t.wt[0] = bw[0]; t.tx[0] = cx;        t.ty[0] = cy;
    t.wt[1] = bw[1]; t.tx[1] = cx + 1.0f; t.ty[1] = cy;
    t.wt[2] = bw[2]; t.tx[2] = cx;        t.ty[2] = cy + 1.0f;
    t.wt[3] = bw[3]; t.tx[3] = cx + 1.0f; t.ty[3] = cy + 1.0f;
    t.wt[4] = 0.0f;  t.tx[4] = cx + fx;   t.ty[4] = cy + fy;
  }
  t.wsum = t.wt[0] + t.wt[1] + t.wt[2] + t.wt[3] + t.wt[4];
  return t;
}

template <typename T, int C>
__device__ __forceinline__ void catrom_apply(const Image<T, C>& img, const CatromTaps& t,
                                             float out[C]) {
  float inv_w = 1.0f / (float)img.w, inv_h = 1.0f / (float)img.h;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float s[C];
    sample_bilinear(img, t.tx[k] * inv_w, t.ty[k] * inv_h, s);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = acc[c] + s[c] * t.wt[k];
  }
  float div = fabsf(t.wsum) < 0.0001f ? 1.0f : t.wsum;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = t.wsum < 0.0001f ? 0.0f : acc[c] / div;
}

template <typename T, int C>
__device__ __forceinline__ void sample_catrom(const Image<T, C>& img, float spx, float spy,
                                              bool use_bicubic, const float bw[4],
                                              float out[C]) {
  catrom_apply(img, catrom_taps(spx, spy, use_bicubic, bw), out);
}

// catrom_apply of N float (h, w, 4) images through one footprint, operation for operation:
// the 5 bilinear samples in order, each sample's position, origin and weights computed once
// for all images. A texel is read, as one float4 through the read-only path, only where its
// bilinear weight is non-zero, and a sample only where its CatRom weight is: a term of weight
// 0 adds an exact 0. In the bicubic footprint whose positions land on their texels exactly,
// that reads each of the 12 texels it covers once, in place of the 20 of 5 full bilinears.
template <int N>
__device__ __forceinline__ void catrom_apply4(const float4* const img[N], int w, int h,
                                              const CatromTaps& t, float4 out[N]) {
  const float inv_w = 1.0f / (float)w, inv_h = 1.0f / (float)h;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc[N];
#pragma unroll
  for (int s = 0; s < N; ++s) acc[s] = zero;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (t.wt[k] == 0.0f) continue;
    const float posx = (t.tx[k] * inv_w) * (float)w - 0.5f;
    const float posy = (t.ty[k] * inv_h) * (float)h - 0.5f;
    const float ox = floorf(posx), oy = floorf(posy);
    float bw[4];
    bilinear_weights(posx - ox, posy - oy, bw);
    const int x0 = to_index(ox), y0 = to_index(oy);
    const size_t r0 = (size_t)clampi(y0, 0, h - 1) * w, r1 = (size_t)clampi(y0 + 1, 0, h - 1) * w;
    const int c0 = clampi(x0, 0, w - 1), c1 = clampi(x0 + 1, 0, w - 1);
    const size_t idx[4] = {r0 + c0, r0 + c1, r1 + c0, r1 + c1};
#pragma unroll
    for (int s = 0; s < N; ++s) {
      float4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = bw[q] != 0.0f ? __ldg(img[s] + idx[q]) : zero;
      const float4 b = make_float4(
          v[0].x * bw[0] + v[1].x * bw[1] + v[2].x * bw[2] + v[3].x * bw[3],
          v[0].y * bw[0] + v[1].y * bw[1] + v[2].y * bw[2] + v[3].y * bw[3],
          v[0].z * bw[0] + v[1].z * bw[1] + v[2].z * bw[2] + v[3].z * bw[3],
          v[0].w * bw[0] + v[1].w * bw[1] + v[2].w * bw[2] + v[3].w * bw[3]);
      acc[s] = make_float4(acc[s].x + b.x * t.wt[k], acc[s].y + b.y * t.wt[k],
                           acc[s].z + b.z * t.wt[k], acc[s].w + b.w * t.wt[k]);
    }
  }
  const bool small = t.wsum < 0.0001f;
  const float div = fabsf(t.wsum) < 0.0001f ? 1.0f : t.wsum;
#pragma unroll
  for (int s = 0; s < N; ++s)
    out[s] = small ? zero
                   : make_float4(acc[s].x / div, acc[s].y / div, acc[s].z / div, acc[s].w / div);
}

// sample_bilinear of a float (h, w, 4) image: four float4 reads through the read-only path,
// the same arithmetic per channel
__device__ __forceinline__ float4 sample_bilinear4(const Image<float, 4>& img, float u,
                                                   float v) {
  const float posx = u * (float)img.w - 0.5f;
  const float posy = v * (float)img.h - 0.5f;
  const float ox = floorf(posx), oy = floorf(posy);
  float w[4];
  bilinear_weights(posx - ox, posy - oy, w);
  const int x0 = to_index(ox), y0 = to_index(oy);
  const float4 a = img.at4(x0, y0), b = img.at4(x0 + 1, y0), c = img.at4(x0, y0 + 1),
               d = img.at4(x0 + 1, y0 + 1);
  return make_float4(a.x * w[0] + b.x * w[1] + c.x * w[2] + d.x * w[3],
                     a.y * w[0] + b.y * w[1] + c.y * w[2] + d.y * w[3],
                     a.z * w[0] + b.z * w[1] + c.z * w[2] + d.z * w[3],
                     a.w * w[0] + b.w * w[1] + c.w * w[2] + d.w * w[3]);
}

__device__ __forceinline__ float pixel_u(int x, int w) { return ((float)x + 0.5f) / (float)w; }

}  // namespace nrd

extern "C" const char* nrd_error_string(int err);
