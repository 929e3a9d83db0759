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

// min / max that return NaN where either operand is NaN, as torch.minimum / torch.maximum
// and clamp_min do (fminf / fmaxf return the other operand)
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float saturate_nan(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }
// min / max / saturate of x against a bound that is never NaN (a literal or a host constant):
// NaN where x is, as torch.clamp_max / clamp_min / clamp, in one compare and one select each
__device__ __forceinline__ float min_bound(float x, float hi) { return hi < x ? hi : x; }
__device__ __forceinline__ float max_bound(float x, float lo) { return lo > x ? lo : x; }
__device__ __forceinline__ float saturate_bound(float x) {
  return min_bound(max_bound(x, 0.0f), 1.0f);
}

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

// One texel of the normal-roughness plane that a kernel reads (frontend.py:
// decode_normal_plane), a kernel's template mode kDec:
//   - false, R10G10B10A2 as packed: the octahedral normal of .xy (unpack_normal), the
//     roughness .z, the material .w x 3;
//   - true, the four RGBA formats decoded once a frame: the normal .xyz as it is (already unit
//     length, not normalized again), the roughness .w, the material 0. The RGBA formats carry
//     no material, and the kernels compile their material tests out in this mode (the TPU
//     kernels' mat_occ=False): with the material 0 everywhere every such test passes.
// The roughness is as packed either way: decode_roughness<kRough> decodes it.
struct NormalRoughness {
  V3 n;
  float rough, mat;
};

template <bool kDec>
__device__ __forceinline__ NormalRoughness unpack_nr(float4 p) {
  if constexpr (kDec) return NormalRoughness{V3{p.x, p.y, p.z}, p.w, 0.0f};
  return NormalRoughness{unpack_normal(p.x, p.y), p.z, p.w * 3.0f};
}

// the channel of the packed roughness in a texel of the plane
template <bool kDec>
constexpr int kRoughLane = kDec ? 3 : 2;

// GetSpecMagicCurve, power 0.25 (math.py:get_spec_magic_curve)
__device__ __forceinline__ float spec_magic_curve(float roughness) {
  const float f = 1.0f - exp2f(-200.0f * roughness * roughness);
  return f * sqrtf(sqrtf(saturate(roughness)));
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

// One texel through the read-only path, each channel widened exactly to float: a float (h, w,
// 4) record as float4 in one 16-byte load, a bf16 (h, w, 4) record as float4 in one 8-byte load
// (uint2), a bf16 (h, w) texel (its bits as unsigned short) as float.
__device__ __forceinline__ float4 texel4(const float4* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float4 texel4(const uint2* p, size_t i) {
  const uint2 b = __ldg(p + i);
  return make_float4(__uint_as_float(b.x << 16), __uint_as_float(b.x & 0xffff0000u),
                     __uint_as_float(b.y << 16), __uint_as_float(b.y & 0xffff0000u));
}
__device__ __forceinline__ float texel4(const unsigned short* p, size_t i) {
  return __uint_as_float((uint32_t)__ldg(p + i) << 16);
}

// The per-channel steps of catrom_apply4 on a float4 texel or a float one: the bilinear sum
// of a sample, the sample times its CatRom weight into the sum, the final division.
__device__ __forceinline__ float4 bilinear_sum(const float4 v[4], const float bw[4]) {
  return make_float4(v[0].x * bw[0] + v[1].x * bw[1] + v[2].x * bw[2] + v[3].x * bw[3],
                     v[0].y * bw[0] + v[1].y * bw[1] + v[2].y * bw[2] + v[3].y * bw[3],
                     v[0].z * bw[0] + v[1].z * bw[1] + v[2].z * bw[2] + v[3].z * bw[3],
                     v[0].w * bw[0] + v[1].w * bw[1] + v[2].w * bw[2] + v[3].w * bw[3]);
}
__device__ __forceinline__ float bilinear_sum(const float v[4], const float bw[4]) {
  return v[0] * bw[0] + v[1] * bw[1] + v[2] * bw[2] + v[3] * bw[3];
}
__device__ __forceinline__ float4 add_weighted(float4 acc, float4 b, float wt) {
  return make_float4(acc.x + b.x * wt, acc.y + b.y * wt, acc.z + b.z * wt, acc.w + b.w * wt);
}
__device__ __forceinline__ float add_weighted(float acc, float b, float wt) {
  return acc + b * wt;
}
__device__ __forceinline__ float4 divide(float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}
__device__ __forceinline__ float divide(float a, float d) { return a / d; }

// catrom_apply of N images through one footprint, operation for operation: float (h, w, 4)
// images as float4 (K16, K17), bf16 (h, w, 4) ones as uint2 (H1, K14 with four channels), bf16
// (h, w) ones as unsigned short (K14 with one), each texel widened to float before the
// multiply-adds of sample_bilinear (the wrappers check that (h, w, 4) images are aligned to
// their record). V, the texel's type, is float4 or float. The 5 bilinear samples in order,
// each sample's position, origin and weights computed once for all images. A texel is read,
// as one wide load (texel4), only where its bilinear weight is non-zero, and a sample only
// where its CatRom weight is: a term of weight 0 adds an exact 0 where the texel is finite. In
// the bicubic footprint whose positions land on their texels exactly, that reads each of the
// 12 texels it covers once, in place of the 20 of 5 full bilinears. A non-finite texel times 0
// is NaN in the plain version, so where a history may hold NaN (K16's and K17's float
// histories after a NaN input) kKeepNaN reads all 20 texels and adds every term, a weight of 0
// included: the result is NaN exactly where the plain version's is. H1, H4 and K14 skip.
template <int N, bool kKeepNaN = false, typename T, typename V>
__device__ __forceinline__ void catrom_apply4(const T* const img[N], int w, int h,
                                              const CatromTaps& t, V out[N]) {
  const float inv_w = 1.0f / (float)w, inv_h = 1.0f / (float)h;
  const V zero{};
  V acc[N];
#pragma unroll
  for (int s = 0; s < N; ++s) acc[s] = zero;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (!kKeepNaN && t.wt[k] == 0.0f) continue;
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
      V v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = kKeepNaN || bw[q] != 0.0f ? texel4(img[s], idx[q]) : zero;
      acc[s] = add_weighted(acc[s], bilinear_sum(v, bw), t.wt[k]);
    }
  }
  const bool small = t.wsum < 0.0001f;
  const float div = fabsf(t.wsum) < 0.0001f ? 1.0f : t.wsum;
#pragma unroll
  for (int s = 0; s < N; ++s) out[s] = small ? zero : divide(acc[s], div);
}

// bilinear_custom of a bf16 (h, w, 4) image (its records read as uint2, each channel widened
// exactly to float) over the 2x2 at integer origin (x0, y0) with clamp addressing: the four
// texels weighted in the order (00, 10, 01, 11), renormalised by the weights' sum, 0 where
// the sum is ~0 (RELAX's SH histories, K16 and K17)
__device__ __forceinline__ float4 bilinear_custom4(const uint2* img, int w, int h, int x0,
                                                   int y0, const float cw[4]) {
  const size_t r0 = (size_t)clampi(y0, 0, h - 1) * w, r1 = (size_t)clampi(y0 + 1, 0, h - 1) * w;
  const int c0 = clampi(x0, 0, w - 1), c1 = clampi(x0 + 1, 0, w - 1);
  const float4 v[4] = {texel4(img, r0 + c0), texel4(img, r0 + c1), texel4(img, r1 + c0),
                       texel4(img, r1 + c1)};
  const float wsum = cw[0] + cw[1] + cw[2] + cw[3];
  return wsum < 0.0001f ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : divide(bilinear_sum(v, cw), wsum);
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

// The host constants of the surface-motion reprojection: the frame's matrices (row-major,
// float32), frustums and motion-vector scale.
struct SurfaceMotionConsts {
  float fr[4], fr_prev[4];  // frustum, frustum_prev: (x0, y0, dx, dy)
  float wtv[9];             // world_to_view[:3, :3]
  float wtv_prev[12];       // world_to_view_prev[:3, :4]
  float wtc_prev[12];       // world_to_clip_prev rows 0, 1 and 3
  float cd[3];              // camera_delta
  float mvs[3];             // motion-vector scale x, y, z
  float ortho;
  bool mv_z_given;          // mv scale z != 0: the mv's z is the viewZ delta
  bool world_mv;            // mv scale w != 0: the mv is a world-space motion
};

// The reprojected uv of a pixel and the previous view z of its previous position.
struct SurfaceMotion {
  float u, v, xv_prev_z;
};

// m[:3, :3] (row-major, row stride S) applied to p, or its transpose
template <int S>
__device__ __forceinline__ V3 rotate(const float* m, V3 p) {
  return V3{p.x * m[0] + p.y * m[1] + p.z * m[2], p.x * m[S] + p.y * m[S + 1] + p.z * m[S + 2],
            p.x * m[2 * S] + p.y * m[2 * S + 1] + p.z * m[2 * S + 2]};
}
template <int S>
__device__ __forceinline__ V3 rotate_transposed(const float* m, V3 p) {
  return V3{p.x * m[0] + p.y * m[S] + p.z * m[2 * S],
            p.x * m[1] + p.y * m[S + 1] + p.z * m[2 * S + 1],
            p.x * m[2] + p.y * m[S + 2] + p.z * m[2 * S + 2]};
}

// What the SIGMA pass glue computed before its TS kernel, term by term as nrdtpu_torch/math.py
// and nrdtpu_torch/passes/reblur/kernels.py:surface_motion_position compute it (explicit sums,
// left to right): the pixel's view position at (u, v) and viewZ view_z, its world position,
// the previous position and uv by either motion-vector branch (screen space, mv z given or
// computed; world space, projected by world_to_clip_prev), and the previous view z
// (affine_transform(world_to_view_prev, x_prev).z). mv: the pixel's IN_MV, unscaled.
__device__ __forceinline__ SurfaceMotion surface_motion(const SurfaceMotionConsts& k, float u,
                                                        float v, float view_z,
                                                        const float mv_in[3]) {
  const V3 xv = reconstruct_view_position(u, v, k.fr, view_z, k.ortho);
  const V3 x = rotate_transposed<3>(k.wtv, xv);
  const V3 mv{mv_in[0] * k.mvs[0], mv_in[1] * k.mvs[1], mv_in[2] * k.mvs[2]};
  SurfaceMotion r;
  V3 x_prev;
  if (k.world_mv) {
    x_prev = V3{x.x + mv.x, x.y + mv.y, x.z + mv.z};
    // Geometry::GetScreenUv (math.py:get_screen_uv)
    const float* m = k.wtc_prev;
    const float cx = x_prev.x * m[0] + x_prev.y * m[1] + x_prev.z * m[2] + m[3];
    const float cy = x_prev.x * m[4] + x_prev.y * m[5] + x_prev.z * m[6] + m[7];
    float cw = x_prev.x * m[8] + x_prev.y * m[9] + x_prev.z * m[10] + m[11];
    cw = fabsf(cw) < 1e-15f ? 1e-15f : cw;
    r.u = cx / cw * 0.5f + 0.5f;
    r.v = 0.5f - cy / cw * 0.5f;
  } else {
    r.u = u + mv.x;
    r.v = v + mv.y;
    const float mv_z = k.mv_z_given ? mv.z : rotate<4>(k.wtv_prev, x).z + k.wtv_prev[11] - view_z;
    const V3 xv_prev = reconstruct_view_position(r.u, r.v, k.fr_prev, view_z + mv_z, k.ortho);
    const V3 xp = rotate_transposed<4>(k.wtv_prev, xv_prev);
    x_prev = V3{xp.x + k.cd[0], xp.y + k.cd[1], xp.z + k.cd[2]};
  }
  r.xv_prev_z = rotate<4>(k.wtv_prev, x_prev).z + k.wtv_prev[11];
  return r;
}

}  // namespace nrd

extern "C" const char* nrd_error_string(int err);
