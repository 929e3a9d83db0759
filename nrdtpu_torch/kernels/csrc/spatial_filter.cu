// H2: REBLUR spatial-filter tap loop (PrePass, Blur, PostBlur), diffuse or specular.
// Replaces nrdtpu/kernels/reblur_blur2.py:264 spatial_filter_taps_pallas2; computes the tap
// loop of nrdtpu/passes/reblur/kernels.py:844-873 / :2164-2189 (diffuse) and :1710-1756
// (specular, with the PrePass hitDistForTracking minimum) per pixel. The plain version is
// nrdtpu_torch/kernels/spatial_filter.py:spatial_filter_ref. One thread per pixel.
#include "common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

enum Param { ROT0, ROT1, ROT2, ROT3, GA, GB, NWP, HA, HB, MHDW, NX, NY, NZ, NVX, NVY, NVZ,
             WR_A, WR_B,                        // specular
             HIT_DIST, ROUGH, XVX, XVY, XVZ };  // specular PrePass
constexpr int kDiffParams = 16, kSpecParams = 18, kPrepassParams = 23;

struct SfArgs {
  const float* signal;  // (h, w, 4)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* params;  // (nparams, h, w), order of Param
  const float* taps;    // (ntaps, 3): offset x, offset y, Gaussian weight
  float* out;           // (h, w, 4)
  float* hdt;           // (h, w) hitDistForTracking, specular PrePass only
  int w, h, ntaps, nparams;
  float fr[4];
  float rect_w, rect_h, view_z_scale, ortho, min_material;
  float hdp[4];         // hit-distance parameters A, B, C, D (PrePass)
  float use_prepass_not_only;
  uint32_t frame_index;
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

  const bool spec = a.nparams >= kSpecParams, prepass = a.nparams == kPrepassParams;
  const float wr_a = spec ? P[WR_A * plane] : 0.0f, wr_b = spec ? P[WR_B * plane] : 0.0f;
  float hit_dist = 0.0f, rough_lerp = 0.0f, hdt = 0.0f;
  V3 xv{0.0f, 0.0f, 0.0f};
  uint32_t rng = 0;
  if (prepass) {
    hit_dist = P[HIT_DIST * plane];
    rough_lerp = nrd::saturate((P[ROUGH * plane] - 0.5f) / 0.5f);
    xv = V3{P[XVX * plane], P[XVY * plane], P[XVZ * plane]};
    hdt = hit_dist == 0.0f ? 1e6f : hit_dist;  // NRD_INF
    rng = nrd::hash_init((uint32_t)x, (uint32_t)y, a.frame_index);
  }

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
    if (spec) w_ = w_ * nrd::compute_weight(nr.at(sx, sy, 2), wr_a, wr_b);
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = w_ == 0.0f ? 0.0f : sig.at(sx, sy, c);
    if (prepass) {
      // stochastic hitDistForTracking minimum (REBLUR_PrePass.hlsli)
      const float rs = nr.at(sx, sy, 2);
      const float norm = (a.hdp[0] + fabsf(zs) * a.hdp[1]) *
                         (1.0f + (a.hdp[2] - 1.0f) * nrd::saturate(exp2f(a.hdp[3] * rs * rs)));
      const float hs = s[3] * norm;
      const float dx = xvs.x - xv.x, dy = xvs.y - xv.y, dz = xvs.z - xv.z;
      const float d = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 0.0f)) + 1e-6f;
      const float geometry_weight = w_ * nrd::saturate(hs / d);
      const float rnd = nrd::hash_float(rng);
      if (rnd < geometry_weight && hs > 0.0f) hdt = fminf(hdt, hs);
      w_ = w_ * a.use_prepass_not_only;
      const float t = nrd::saturate(hs / (d + hit_dist));
      w_ = w_ * (t + (1.0f - t) * rough_lerp);
    }
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
  if (prepass) a.hdt[i] = hdt == 1e6f ? 0.0f : hdt;
}

}  // namespace

// ptrs: signal, view_z, nr, params, taps, out, hdt
// consts: frustum[4], rect_w, rect_h, view_z_scale, ortho_mode, min_material, ntaps,
//         nparams; in PrePass mode also hit-distance params[4], use_prepass_not_only,
//         frame index low 16 bits, high 16 bits
extern "C" int nrd_spatial_filter(void* const* p, const float* c, int w, int h, void* stream) {
  SfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.params = (const float*)p[3];
  a.taps = (const float*)p[4];
  a.out = (float*)p[5];
  a.hdt = (float*)p[6];
  a.w = w;
  a.h = h;
  for (int k = 0; k < 4; ++k) a.fr[k] = c[k];
  a.rect_w = c[4];
  a.rect_h = c[5];
  a.view_z_scale = c[6];
  a.ortho = c[7];
  a.min_material = c[8];
  a.ntaps = (int)c[9];
  a.nparams = (int)c[10];
  if (a.nparams != kDiffParams && a.nparams != kSpecParams && a.nparams != kPrepassParams)
    return (int)cudaErrorInvalidValue;
  if (a.nparams == kPrepassParams) {
    for (int k = 0; k < 4; ++k) a.hdp[k] = c[11 + k];
    a.use_prepass_not_only = c[15];
    a.frame_index = (uint32_t)c[16] | ((uint32_t)c[17] << 16);
  }
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  spatial_filter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
