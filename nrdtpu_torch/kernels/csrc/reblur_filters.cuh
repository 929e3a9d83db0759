// Per-signal device functions of the REBLUR spatial filter and history fix. H2
// (spatial_filter.cu) and H3 (history_fix.cu) call them once per pixel for their one signal;
// N4 (spatial_filter_fused.cu) and N5 (history_fix_fused.cu) call them once per signal, with
// the centre pixel's shared planes loaded once. The plain versions they are held against are
// nrdtpu_torch/kernels/spatial_filter.py:spatial_filter_ref and
// nrdtpu_torch/kernels/history_fix.py:history_fix_ref; the op order below is theirs.
#pragma once

#include "common.cuh"

namespace nrd {

// ---------------------------------------------------------------------------------------
// Spatial filter (PrePass, Blur, PostBlur): nrdtpu/passes/reblur/kernels.py:844-873,
// :2164-2189 (diffuse) and :1710-1756 (specular, with the PrePass hitDistForTracking)
// ---------------------------------------------------------------------------------------

// planes shared by the signals of a pixel (spatial_filter.py:SHARED)
enum SfShared { SF_GA, SF_GB, SF_NX, SF_NY, SF_NZ, SF_NVX, SF_NVY, SF_NVZ, kSfShared };
// planes of one signal (spatial_filter.py:PARAMS, SPEC_PARAMS, PREPASS_PARAMS)
enum SfParam { SF_ROT0, SF_ROT1, SF_ROT2, SF_ROT3, SF_NWP, SF_HA, SF_HB, SF_MHDW,
               SF_WR_A, SF_WR_B,                                  // specular
               SF_HIT_DIST, SF_ROUGH, SF_XVX, SF_XVY, SF_XVZ };   // specular PrePass
constexpr int kSfDiffParams = 8, kSfSpecParams = 10, kSfPrepassParams = 15;

struct SfFrame {
  const float* taps;  // (ntaps, 3): offset x, offset y, Gaussian weight
  int w, h, ntaps;
  float fr[4];
  float rect_w, rect_h, view_z_scale, ortho;
  float hdp[4];       // hit-distance parameters A, B, C, D (specular PrePass)
  float use_prepass_not_only;
  uint32_t frame_index;
};

struct Centre {
  int x, y;
  float u, v, material;
  float ga, gb, fsz;  // fsz: history fix only
  V3 n, nv;
};

// the centre pixel's geometry from the shared planes; P points at the pixel in plane 0
__device__ __forceinline__ Centre sf_centre(const float* P, size_t plane,
                                            const Image<float, 4>& nr, int x, int y) {
  Centre c;
  c.x = x;
  c.y = y;
  c.u = pixel_u(x, nr.w);
  c.v = pixel_u(y, nr.h);
  c.material = nr.at(x, y, 3) * 3.0f;
  c.ga = P[SF_GA * plane];
  c.gb = P[SF_GB * plane];
  c.fsz = 0.0f;
  c.n = V3{P[SF_NX * plane], P[SF_NY * plane], P[SF_NZ * plane]};
  c.nv = V3{P[SF_NVX * plane], P[SF_NVY * plane], P[SF_NVZ * plane]};
  return c;
}

// One signal's tap loop. P points at the pixel in the signal's (nparams, h, w) planes, whose
// count selects the mode: diffuse, specular (roughness weight) or specular PrePass (also the
// stochastic minimum of the taps' hit distances, hitDistForTracking, written to *hdt_out,
// with one PCG draw per tap from hash_init(pixel, frame index)).
__device__ __forceinline__ void sf_filter(const SfFrame& f, const Centre& c, const float* P,
                                          size_t plane, int nparams, float min_material,
                                          const Image<float, 4>& sig,
                                          const Image<float, 4>& nr,
                                          const Image<float, 1>& vz, float out[4],
                                          float* hdt_out) {
  const float r0 = P[SF_ROT0 * plane], r1 = P[SF_ROT1 * plane], r2 = P[SF_ROT2 * plane],
              r3 = P[SF_ROT3 * plane];
  const float nwp = P[SF_NWP * plane], ha = P[SF_HA * plane], hb = P[SF_HB * plane];
  const float mhdw = P[SF_MHDW * plane];
  const float mat_c = fmaxf(c.material, min_material);
  const bool spec = nparams >= kSfSpecParams, prepass = nparams == kSfPrepassParams;
  const float wr_a = spec ? P[SF_WR_A * plane] : 0.0f, wr_b = spec ? P[SF_WR_B * plane] : 0.0f;
  float hit_dist = 0.0f, rough_lerp = 0.0f, hdt = 0.0f;
  V3 xv{0.0f, 0.0f, 0.0f};
  uint32_t rng = 0;
  if (prepass) {
    hit_dist = P[SF_HIT_DIST * plane];
    rough_lerp = saturate((P[SF_ROUGH * plane] - 0.5f) / 0.5f);
    xv = V3{P[SF_XVX * plane], P[SF_XVY * plane], P[SF_XVZ * plane]};
    hdt = hit_dist == 0.0f ? 1e6f : hit_dist;  // NRD_INF
    rng = hash_init((uint32_t)c.x, (uint32_t)c.y, f.frame_index);
  }

  float sum = 1.0f;
  float acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = sig.at(c.x, c.y, k);

  for (int t = 0; t < f.ntaps; ++t) {
    const float ox = f.taps[3 * t], oy = f.taps[3 * t + 1], gauss = f.taps[3 * t + 2];
    float us = c.u + (ox * r0 + oy * r2);
    float vs = c.v + (ox * r1 + oy * r3);
    us = (floorf(us * f.rect_w) + 0.5f) / f.rect_w;  // snap to the pixel centre
    vs = (floorf(vs * f.rect_h) + 0.5f) / f.rect_h;
    const int sx = to_index(floorf(us * (float)f.w));
    const int sy = to_index(floorf(vs * (float)f.h));

    const float zs = fabsf(vz.at(sx, sy, 0)) * f.view_z_scale;
    const V3 ns = unpack_normal(nr.at(sx, sy, 0), nr.at(sx, sy, 1));
    const float ms = fmaxf(nr.at(sx, sy, 3) * 3.0f, min_material);
    const float angle = acos_approx(dot3(c.n, ns));
    const V3 xvs = reconstruct_view_position(us, vs, f.fr, zs, f.ortho);

    float w_ = in_screen_nearest(us, vs);
    w_ = w_ * compute_weight(dot3(c.nv, xvs), c.ga, c.gb);
    w_ = w_ * (mat_c == ms ? 1.0f : 0.0f);
    w_ = w_ * compute_weight(angle, nwp, 0.0f);
    if (spec) w_ = w_ * compute_weight(nr.at(sx, sy, 2), wr_a, wr_b);
    float s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = w_ == 0.0f ? 0.0f : sig.at(sx, sy, k);
    if (prepass) {
      // stochastic hitDistForTracking minimum (REBLUR_PrePass.hlsli)
      const float rs = nr.at(sx, sy, 2);
      const float norm = (f.hdp[0] + fabsf(zs) * f.hdp[1]) *
                         (1.0f + (f.hdp[2] - 1.0f) * saturate(exp2f(f.hdp[3] * rs * rs)));
      const float hs = s[3] * norm;
      const float dx = xvs.x - xv.x, dy = xvs.y - xv.y, dz = xvs.z - xv.z;
      const float d = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 0.0f)) + 1e-6f;
      const float geometry_weight = w_ * saturate(hs / d);
      const float rnd = hash_float(rng);
      if (rnd < geometry_weight && hs > 0.0f) hdt = fminf(hdt, hs);
      w_ = w_ * f.use_prepass_not_only;
      const float tt = saturate(hs / (d + hit_dist));
      w_ = w_ * (tt + (1.0f - tt) * rough_lerp);
    }
    const float e = compute_exponential_weight(s[3], ha, hb);
    w_ = w_ * (mhdw + (1.0f - mhdw) * e);
    w_ = w_ * gauss;
    sum = sum + w_;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = acc[k] + s[k] * w_;
  }
  const float inv = 1.0f / fmaxf(sum, 1e-15f);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = acc[k] * inv;
  if (prepass) *hdt_out = hdt == 1e6f ? 0.0f : hdt;
}

// ---------------------------------------------------------------------------------------
// History fix: nrdtpu/passes/reblur/kernels.py:629-683 (stride taps), :693-700 (3x3
// moments of the fast history) and :705-719 (the anti-firefly ring)
// ---------------------------------------------------------------------------------------

// planes shared by the signals of a pixel (history_fix.py:SHARED)
enum HfShared { HF_GA, HF_GB, HF_FSZ, HF_NX, HF_NY, HF_NZ, HF_NVX, HF_NVY, HF_NVZ, kHfShared };
// planes of one signal (history_fix.py:PARAMS, SPEC_PARAMS)
enum HfParam { HF_STRIDE, HF_NWP, HF_HA, HF_HB, HF_HDS,
               HF_RA, HF_RB, HF_HIT_DIST, HF_GUIDE_B };  // the last four: specular
constexpr int kHfDiffParams = 5, kHfSpecParams = 9;
constexpr int kAntiFireflyRadius = 4;  // REBLUR_ANTI_FIREFLY_FILTER_RADIUS, every mode

struct HfFrame {
  int w, h;
  float fr[4];
  float rect_inv_w, rect_inv_h, view_z_scale, ortho;
};

__device__ __forceinline__ Centre hf_centre(const float* P, size_t plane,
                                            const Image<float, 4>& nr, int x, int y) {
  Centre c;
  c.x = x;
  c.y = y;
  c.u = pixel_u(x, nr.w);
  c.v = pixel_u(y, nr.h);
  c.material = nr.at(x, y, 3) * 3.0f;
  c.ga = P[HF_GA * plane];
  c.gb = P[HF_GB * plane];
  c.fsz = P[HF_FSZ * plane];
  c.n = V3{P[HF_NX * plane], P[HF_NY * plane], P[HF_NZ * plane]};
  c.nv = V3{P[HF_NVX * plane], P[HF_NVY * plane], P[HF_NVZ * plane]};
  return c;
}

// mean and second moment of the fast history over the 3x3, (dy, dx) row by row
__device__ __forceinline__ void fast_moments(const Image<float, 1>& fast, int x, int y,
                                             float* m1, float* m2) {
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float t = fast.at(x + dx, y + dy, 0);
      a = a + t;
      b = b + t * t;
    }
  *m1 = a / 9.0f;
  *m2 = b / 9.0f;
}

// the anti-firefly ring: the same moments over the 9x9 square minus the 3x3 (72 taps)
__device__ __forceinline__ void anti_firefly_moments(const Image<float, 1>& fast, int x, int y,
                                                     float* m1, float* m2) {
  const int r = kAntiFireflyRadius;
  float a = 0.0f, b = 0.0f;
  for (int dy = -r; dy <= r; ++dy)
#pragma unroll
    for (int dx = -r; dx <= r; ++dx) {
      if (abs(dy) <= 1 && abs(dx) <= 1) continue;
      const float t = fast.at(x + dx, y + dy, 0);
      a = a + t;
      b = b + t * t;
    }
  const float cnt = (float)((2 * r + 1) * (2 * r + 1) - 9);
  *m1 = a / cnt;
  *m2 = b / cnt;
}

// One signal's 20 stride taps (5x5 without centre and corners). P points at the pixel in the
// signal's (5 | 9, h, w) planes; `spec` adds the relaxed roughness weight and the
// low-roughness hitT guide. Writes the reconstructed signal, or the centre where the stride
// is 0.
__device__ __forceinline__ void hf_filter(const HfFrame& f, const Centre& c, const float* P,
                                          size_t plane, bool spec, float min_material,
                                          const Image<float, 4>& sig,
                                          const Image<float, 1>& data1,
                                          const Image<float, 4>& nr,
                                          const Image<float, 1>& vz, float out[4]) {
  const float stride = P[HF_STRIDE * plane];
  float center[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) center[k] = sig.at(c.x, c.y, k);
  if (stride == 0.0f) {  // converged history: the signal passes through
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = center[k];
    return;
  }
  const float nwp = P[HF_NWP * plane], ha = P[HF_HA * plane], hb = P[HF_HB * plane];
  const float hds = P[HF_HDS * plane];
  float ra = 0.0f, rb = 0.0f, hit_dist = 0.0f, gb_lo = 0.0f, gb_hi = 0.0f;
  if (spec) {
    ra = P[HF_RA * plane];
    rb = P[HF_RB * plane];
    hit_dist = P[HF_HIT_DIST * plane];
    gb_lo = 0.2f + P[HF_GUIDE_B * plane];
    gb_hi = 0.05f + P[HF_GUIDE_B * plane];
  }
  const float mat_c = fmaxf(c.material, min_material);
  float sum = 1.0f + data1.at(c.x, c.y, 0);
  float acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = center[k] * sum;

  for (int j = -2; j <= 2; ++j)
    for (int k = -2; k <= 2; ++k) {
      if ((j == 0 && k == 0) || abs(j) + abs(k) == 4) continue;
      const float ofx = (float)k * stride, ofy = (float)j * stride;
      const float us = c.u + ofx * f.rect_inv_w, vs = c.v + ofy * f.rect_inv_h;
      const int px = (int)fminf(fmaxf((float)c.x + ofx, 0.0f), (float)(f.w - 1));
      const int py = (int)fminf(fmaxf((float)c.y + ofy, 0.0f), (float)(f.h - 1));

      const float zs = fabsf(vz.at(px, py, 0)) * f.view_z_scale;
      const V3 ns = unpack_normal(nr.at(px, py, 0), nr.at(px, py, 1));
      const float ms = fmaxf(nr.at(px, py, 3) * 3.0f, min_material);
      const float angle = acos_approx(dot3(ns, c.n));
      const V3 xvs = reconstruct_view_position(us, vs, f.fr, zs, f.ortho);

      float w_ = in_screen_nearest(us, vs);
      w_ = w_ * compute_weight(dot3(c.nv, xvs), c.ga, c.gb);
      w_ = w_ * (mat_c == ms ? 1.0f : 0.0f);
      w_ = w_ * compute_exponential_weight(angle, nwp, 0.0f);
      if (spec) {
        const float rs = nr.at(px, py, 2);
        w_ = w_ * compute_exponential_weight(rs * rs, ra, rb);
      }
      w_ = w_ * (1.0f + data1.at(px, py, 0));
      float s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] = w_ == 0.0f ? 0.0f : sig.at(px, py, q);
      const float hs = s[3] * hds;
      w_ = w_ * compute_exponential_weight(saturate(hs / c.fsz), ha, hb);
      if (spec) {
        const float d = fabsf(hit_dist - hs) / (fmaxf(hit_dist, hs) + 0.001f);
        w_ = w_ * smoothstep(gb_lo, gb_hi, d);
      }
      sum = sum + w_;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = acc[q] + s[q] * w_;
    }
  const float inv = 1.0f / fmaxf(sum, 1e-15f);
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = acc[q] * inv;
}

}  // namespace nrd
