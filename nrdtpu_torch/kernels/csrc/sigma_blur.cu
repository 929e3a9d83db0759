// K13: SIGMA Blur / PostBlur: the dense 5x5 penumbra estimation and the 8-tap Poisson shadow
// filter of nrdtpu/passes/sigma/kernels.py:133-281, per pixel. Replaces
// nrdtpu/kernels/sigma_blur2.py:281 sigma_blur_pallas2 and its v1 twin
// nrdtpu/kernels/sigma_pallas.py:291 sigma_blur_pallas. Templated on the shadow's channel
// count (1: SIGMA_SHADOW, 4: SIGMA_SHADOW_TRANSLUCENCY). The plain version is
// nrdtpu_torch/kernels/sigma_blur.py:sigma_blur_ref. One thread per pixel.
#include "common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr float kFp16Max = 65504.0f;
constexpr float kEps = 1e-6f;
constexpr int kBorder = 2;
constexpr int kDenseTaps = (2 * kBorder + 1) * (2 * kBorder + 1);
constexpr int kPoissonTaps = 8;

struct BlurArgs {
  const float* penumbra;  // (h, w)
  const float* shadow;    // (h, w, C), read when has_shadow
  const float* view_z;    // (h, w) raw viewZ
  const float* nr;        // (h, w, 4) packed normal/roughness/material
  const float* tile;      // (2, h, w): tile value, sky-tile mask
  float* out_penumbra;    // (h, w)
  float* out_shadow;      // (h, w, C) sqrt-packed
  int w, h;
  bool first_pass, has_shadow;
  float view_z_scale, fr[4], ortho, unproject, mrdu, pds;
  float m[9];             // world_to_view rotation, row-major
  float rot[4];           // the pass's rotator
  float rect_w, rect_h, rinv_x, rinv_y, denoising_range;
  float dense_gauss[kDenseTaps];
  float poisson[kPoissonTaps][3];  // x, y, Gaussian weight
};

__device__ __forceinline__ float is_lit(float p) { return p >= kFp16Max ? 1.0f : 0.0f; }

__device__ __forceinline__ float both_lit_or_unlit(float p1, float p2) {
  return (p1 == 0.0f) == (p2 == 0.0f) ? 1.0f : 0.0f;
}

// the shadow at texel (x, y), unpacked on PostBlur; IsLit(penumbra) without a shadow input
template <int C>
__device__ __forceinline__ void shadow_tap(const BlurArgs& a, int x, int y, float penum,
                                           float s[C]) {
  if (!a.has_shadow) {
    s[0] = is_lit(penum);
    return;
  }
  const float* p = a.shadow + ((size_t)y * a.w + x) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = a.first_pass ? p[c] : p[c] * p[c];
}

template <int C>
__global__ void __launch_bounds__(256) sigma_blur_kernel(BlurArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 1> pen{a.penumbra, a.w, a.h};
  const Image<float, 1> vz{a.view_z, a.w, a.h};
  const Image<float, 4> nr{a.nr, a.w, a.h};

  const float u = nrd::pixel_u(x, a.w), v = nrd::pixel_u(y, a.h);
  const float view_z = fabsf(a.view_z[i]) * a.view_z_scale;
  const float pc = a.penumbra[i];
  float center[C];
  shadow_tap<C>(a, x, y, pc, center);
  const float tile_value = a.tile[i], sky = a.tile[plane + i];

  // the centre's geometry (:163-176)
  const V3 xv = nrd::reconstruct_view_position(u, v, a.fr, view_z, a.ortho);
  const V3 n = nrd::unpack_normal(nr.at(x, y, 0), nr.at(x, y, 1));
  const V3 nv{a.m[0] * n.x + a.m[1] * n.y + a.m[2] * n.z,
              a.m[3] * n.x + a.m[4] * n.y + a.m[5] * n.z,
              a.m[6] * n.x + a.m[7] * n.y + a.m[8] * n.z};
  const float lz = view_z + (1.0f - view_z) * fabsf(a.ortho);
  const float pixel_size = a.unproject * lz;
  const float frustum_size = a.mrdu * lz;
  V3 vv{0.0f, 0.0f, -1.0f};
  if (a.ortho == 0.0f) {
    const float inv = rsqrtf(fmaxf(xv.x * xv.x + xv.y * xv.y + xv.z * xv.z, 1e-15f));
    vv = V3{-xv.x * inv, -xv.y * inv, -xv.z * inv};
  }
  const float nov = fabsf(nrd::dot3(nv, vv));
  const float ga = 1.0f / (a.pds * frustum_size);
  const float gb = -(nrd::dot3(nv, xv) * ga);

  // dense 5x5 estimation (:178-213)
  float result[C], sum_x = 0.0f, sum_y = 0.0f, penumbra = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) result[c] = 0.0f;
  int t = 0;
  for (int dy = -kBorder; dy <= kBorder; ++dy)
    for (int dx = -kBorder; dx <= kBorder; ++dx, ++t) {
      const int tx = nrd::clampi(x + dx, 0, a.w - 1), ty = nrd::clampi(y + dy, 0, a.h - 1);
      const float penum = pen.at(tx, ty, 0);
      const float zs = fabsf(vz.at(tx, ty, 0)) * a.view_z_scale;
      float s[C];
      shadow_tap<C>(a, tx, ty, penum, s);
      float w_ = 1.0f;
      if (dx != 0 || dy != 0) {
        const float us = u + (float)dx * a.rinv_x, vs = v + (float)dy * a.rinv_y;
        const V3 xvs = nrd::reconstruct_view_position(us, vs, a.fr, zs, a.ortho);
        w_ = nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
        w_ = w_ * both_lit_or_unlit(pc, penum);
        w_ = w_ * a.dense_gauss[t];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) result[c] = result[c] + (w_ == 0.0f ? 0.0f : s[c] * w_);
      sum_x = sum_x + w_;
      w_ = w_ * pixel_size / (pixel_size + penum);
      w_ = w_ * (1.0f - is_lit(penum));
      penumbra = penumbra + (w_ == 0.0f ? 0.0f : penum * w_);
      sum_y = sum_y + w_;
    }
#pragma unroll
  for (int c = 0; c < C; ++c) result[c] = result[c] / sum_x;
  penumbra = penumbra / fmaxf(sum_y, kEps);
  sum_y = sum_y != 0.0f ? 1.0f : 0.0f;
  const float f = nrd::smoothstep(0.0f, (float)kBorder, penumbra / pixel_size);
#pragma unroll
  for (int c = 0; c < C; ++c) result[c] = center[c] + (result[c] - center[c]) * f;

  // sparse 8-tap Poisson (:215-263)
  const float f4 = 4.0f + (1.0f - 4.0f) * f;
#pragma unroll
  for (int c = 0; c < C; ++c) result[c] = result[c] * f4;
  penumbra = penumbra * f4;
  sum_x = f4;
  sum_y = sum_y * f4;
  const float unclamped = penumbra / pixel_size * tile_value;
  const float blur_radius = fminf(fmaxf(unclamped, fminf(unclamped, 2.0f)), 32.0f);
  float skx = (1.0f - fabsf(nv.x)) + (1.0f - (1.0f - fabsf(nv.x))) * nov;
  float sky_ = (1.0f - fabsf(nv.y)) + (1.0f - (1.0f - fabsf(nv.y))) * nov;
  const float skew_max = fmaxf(skx, sky_);
  skx = skx / skew_max * a.rinv_x * blur_radius;
  sky_ = sky_ / skew_max * a.rinv_y * blur_radius;
  const float r0 = a.rot[0] * skx, r1 = a.rot[1] * sky_, r2 = a.rot[2] * skx,
              r3 = a.rot[3] * sky_;
  const float inv_estimated_penumbra = 1.0f / fmaxf(penumbra, kEps);
#pragma unroll
  for (int k = 0; k < kPoissonTaps; ++k) {
    const float ox = a.poisson[k][0], oy = a.poisson[k][1];
    float us = u + (ox * r0 + oy * r2), vs = v + (ox * r1 + oy * r3);
    us = (floorf(us * a.rect_w) + 0.5f) / a.rect_w;  // snap to the pixel centre (:238)
    vs = (floorf(vs * a.rect_h) + 0.5f) / a.rect_h;
    const int tx = nrd::clampi(nrd::to_index(floorf(us * (float)a.w)), 0, a.w - 1);
    const int ty = nrd::clampi(nrd::to_index(floorf(vs * (float)a.h)), 0, a.h - 1);
    const float penum = pen.at(tx, ty, 0);
    const float zs = fabsf(vz.at(tx, ty, 0)) * a.view_z_scale;
    float s[C];
    shadow_tap<C>(a, tx, ty, penum, s);
    const V3 xvs = nrd::reconstruct_view_position(us, vs, a.fr, zs, a.ortho);
    float w_ = nrd::in_screen_nearest(us, vs);
    w_ = w_ * nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
    w_ = w_ * both_lit_or_unlit(pc, penum);
    w_ = w_ * a.poisson[k][2];
    w_ = w_ * nrd::saturate(penum * inv_estimated_penumbra);  // umbra-leak guard (:256)
#pragma unroll
    for (int c = 0; c < C; ++c) result[c] = result[c] + (w_ == 0.0f ? 0.0f : s[c] * w_);
    sum_x = sum_x + w_;
    w_ = w_ * pixel_size / (pixel_size + penum);
    w_ = w_ * (1.0f - is_lit(penum));
    penumbra = penumbra + (w_ == 0.0f ? 0.0f : penum * w_);
    sum_y = sum_y + w_;
  }

  // final normalisation and the pass-through masks (:265-281)
  const bool no_denoise = tile_value == 0.0f || pc == 0.0f || sky > 0.0f ||
                          view_z > a.denoising_range;
  a.out_penumbra[i] = no_denoise ? pc
                      : (sum_y == 0.0f ? pc : penumbra / fmaxf(sum_y, kEps));
#pragma unroll
  for (int c = 0; c < C; ++c)
    a.out_shadow[i * C + c] = sqrtf(nrd::saturate(no_denoise ? center[c] : result[c] / sum_x));
}

}  // namespace

// ptrs: penumbra, shadow (the penumbra in its place without one), view_z, nr, tile,
//       out_penumbra, out_shadow
// consts: channels, first_pass, has_shadow, view_z_scale, frustum[4], ortho, unproject,
//         min_rect_dim_mul_unproject, plane_dist_sensitivity, m[9], rotator[4],
//         rect_size[2], rect_size_inv[2], denoising_range, 25 dense Gaussian weights,
//         8 x (x, y, Gaussian weight) Poisson taps
extern "C" int nrd_sigma_blur(void* const* p, const float* c, int w, int h, void* stream) {
  BlurArgs a;
  a.penumbra = (const float*)p[0];
  a.shadow = (const float*)p[1];
  a.view_z = (const float*)p[2];
  a.nr = (const float*)p[3];
  a.tile = (const float*)p[4];
  a.out_penumbra = (float*)p[5];
  a.out_shadow = (float*)p[6];
  a.w = w;
  a.h = h;
  const int channels = (int)c[0];
  a.first_pass = c[1] != 0.0f;
  a.has_shadow = c[2] != 0.0f;
  if (channels != 1 && channels != 4) return (int)cudaErrorInvalidValue;
  if (!a.has_shadow && channels != 1) return (int)cudaErrorInvalidValue;
  a.view_z_scale = c[3];
  for (int k = 0; k < 4; ++k) a.fr[k] = c[4 + k];
  a.ortho = c[8];
  a.unproject = c[9];
  a.mrdu = c[10];
  a.pds = c[11];
  for (int k = 0; k < 9; ++k) a.m[k] = c[12 + k];
  for (int k = 0; k < 4; ++k) a.rot[k] = c[21 + k];
  a.rect_w = c[25];
  a.rect_h = c[26];
  a.rinv_x = c[27];
  a.rinv_y = c[28];
  a.denoising_range = c[29];
  for (int k = 0; k < kDenseTaps; ++k) a.dense_gauss[k] = c[30 + k];
  for (int k = 0; k < kPoissonTaps; ++k)
    for (int j = 0; j < 3; ++j) a.poisson[k][j] = c[30 + kDenseTaps + 3 * k + j];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (channels == 1)
    sigma_blur_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    sigma_blur_kernel<4><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
