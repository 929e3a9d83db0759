// H2: REBLUR diffuse spatial-filter tap loop (PrePass, Blur, PostBlur).
// Replaces nrdtpu/kernels/reblur_blur2.py:264 spatial_filter_taps_pallas2; computes the tap
// loop of nrdtpu/passes/reblur/kernels.py:844-873 / :2164-2189 per pixel. The plain version
// is nrdtpu_torch/kernels/spatial_filter.py:spatial_filter_ref. One thread per pixel.
#include "common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

enum Param { ROT0, ROT1, ROT2, ROT3, GA, GB, NWP, HA, HB, MHDW, NX, NY, NZ, NVX, NVY, NVZ };

struct SfArgs {
  const float* signal;  // (h, w, 4)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* params;  // (16, h, w), order of Param
  const float* taps;    // (ntaps, 3): offset x, offset y, Gaussian weight
  float* out;           // (h, w, 4)
  int w, h, ntaps;
  float fr[4];
  float rect_w, rect_h, view_z_scale, ortho, min_material;
};

__global__ void __launch_bounds__(256) spatial_filter_kernel(SfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const float* P = a.params + i;
  const float r0 = P[ROT0 * plane], r1 = P[ROT1 * plane], r2 = P[ROT2 * plane], r3 = P[ROT3 * plane];
  const float ga = P[GA * plane], gb = P[GB * plane], nwp = P[NWP * plane];
  const float ha = P[HA * plane], hb = P[HB * plane], mhdw = P[MHDW * plane];
  const V3 n{P[NX * plane], P[NY * plane], P[NZ * plane]};
  const V3 nv{P[NVX * plane], P[NVY * plane], P[NVZ * plane]};
  const Image<float, 4> nr{a.nr, a.w, a.h};
  const Image<float, 4> sig{a.signal, a.w, a.h};
  const Image<float, 1> vz{a.view_z, a.w, a.h};

  const float u = nrd::pixel_u(x, a.w), v = nrd::pixel_u(y, a.h);
  const float mat_c = fmaxf(nr.at(x, y, 3) * 3.0f, a.min_material);

  float sum = 1.0f;
  float acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = sig.at(x, y, c);

  for (int t = 0; t < a.ntaps; ++t) {
    const float ox = a.taps[3 * t], oy = a.taps[3 * t + 1], gauss = a.taps[3 * t + 2];
    float us = u + (ox * r0 + oy * r2);
    float vs = v + (ox * r1 + oy * r3);
    us = (floorf(us * a.rect_w) + 0.5f) / a.rect_w;  // snap to the pixel centre
    vs = (floorf(vs * a.rect_h) + 0.5f) / a.rect_h;
    const int sx = nrd::to_index(floorf(us * (float)a.w));
    const int sy = nrd::to_index(floorf(vs * (float)a.h));

    const float zs = fabsf(vz.at(sx, sy, 0)) * a.view_z_scale;
    const V3 ns = nrd::unpack_normal(nr.at(sx, sy, 0), nr.at(sx, sy, 1));
    const float ms = fmaxf(nr.at(sx, sy, 3) * 3.0f, a.min_material);
    const float angle = nrd::acos_approx(nrd::dot3(n, ns));
    const V3 xvs = nrd::reconstruct_view_position(us, vs, a.fr, zs, a.ortho);

    float w_ = nrd::in_screen_nearest(us, vs);
    w_ = w_ * nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
    w_ = w_ * (mat_c == ms ? 1.0f : 0.0f);
    w_ = w_ * nrd::compute_weight(angle, nwp, 0.0f);
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = w_ == 0.0f ? 0.0f : sig.at(sx, sy, c);
    const float e = nrd::compute_exponential_weight(s[3], ha, hb);
    w_ = w_ * (mhdw + (1.0f - mhdw) * e);
    w_ = w_ * gauss;
    sum = sum + w_;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + s[c] * w_;
  }
  const float inv = 1.0f / fmaxf(sum, 1e-15f);
#pragma unroll
  for (int c = 0; c < 4; ++c) a.out[4 * i + c] = acc[c] * inv;
}

}  // namespace

// ptrs: signal, view_z, nr, params, taps, out
// consts: frustum[4], rect_w, rect_h, view_z_scale, ortho_mode, min_material, ntaps
extern "C" int nrd_spatial_filter(void* const* p, const float* c, int w, int h, void* stream) {
  SfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.params = (const float*)p[3];
  a.taps = (const float*)p[4];
  a.out = (float*)p[5];
  a.w = w;
  a.h = h;
  for (int k = 0; k < 4; ++k) a.fr[k] = c[k];
  a.rect_w = c[4];
  a.rect_h = c[5];
  a.view_z_scale = c[6];
  a.ortho = c[7];
  a.min_material = c[8];
  a.ntaps = (int)c[9];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  spatial_filter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
