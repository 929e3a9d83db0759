// H3: REBLUR history fix: stride-tap reconstruction + 3x3 fast-history moments, diffuse
// or specular (roughness weight + low-roughness hitT guide).
// Replaces nrdtpu/kernels/reblur_hfix2.py:222 history_fix_taps_pallas2; computes
// nrdtpu/passes/reblur/kernels.py:546-552, :629-683 and :693-700 per pixel, for is_diffuse
// True or False. The plain version is nrdtpu_torch/kernels/history_fix.py:history_fix_ref.
// One thread per pixel.
#include "common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

enum Param { STRIDE, GA, GB, NWP, HA, HB, HDS, FSZ, NX, NY, NZ, NVX, NVY, NVZ,
             RA, RB, HIT_DIST, GUIDE_B };  // the last four in specular mode only

struct HfArgs {
  const float* signal;  // (h, w, 4)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* data1;   // (h, w) accumulated frames
  const float* fast;    // (h, w) fast history
  const float* params;  // (14 or 18, h, w), order of Param
  float* out;           // (h, w, 4)
  float* moments;       // (2, h, w): m1, m2 of the 3x3 fast history
  int w, h;
  float fr[4];
  float rect_inv_w, rect_inv_h, view_z_scale, ortho, min_material;
  bool spec;
};

__global__ void __launch_bounds__(256) history_fix_kernel(HfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 4> sig{a.signal, a.w, a.h};
  const Image<float, 1> fast{a.fast, a.w, a.h};

  // 3x3 moments of the fast history, (dy, dx) row by row
  float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float t = fast.at(x + dx, y + dy, 0);
      m1 = m1 + t;
      m2 = m2 + t * t;
    }
  a.moments[i] = m1 / 9.0f;
  a.moments[plane + i] = m2 / 9.0f;

  const float* P = a.params + i;
  const float stride = P[STRIDE * plane];
  float center[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) center[c] = sig.at(x, y, c);
  if (stride == 0.0f) {  // converged history: the signal passes through
#pragma unroll
    for (int c = 0; c < 4; ++c) a.out[4 * i + c] = center[c];
    return;
  }

  const float ga = P[GA * plane], gb = P[GB * plane], nwp = P[NWP * plane];
  const float ha = P[HA * plane], hb = P[HB * plane];
  const float hds = P[HDS * plane], fsz = P[FSZ * plane];
  const V3 n{P[NX * plane], P[NY * plane], P[NZ * plane]};
  const V3 nv{P[NVX * plane], P[NVY * plane], P[NVZ * plane]};
  float ra = 0.0f, rb = 0.0f, hit_dist = 0.0f, gb_lo = 0.0f, gb_hi = 0.0f;
  if (a.spec) {
    ra = P[RA * plane];
    rb = P[RB * plane];
    hit_dist = P[HIT_DIST * plane];
    gb_lo = 0.2f + P[GUIDE_B * plane];
    gb_hi = 0.05f + P[GUIDE_B * plane];
  }
  const Image<float, 4> nr{a.nr, a.w, a.h};
  const Image<float, 1> vz{a.view_z, a.w, a.h};
  const Image<float, 1> data1{a.data1, a.w, a.h};

  const float u = nrd::pixel_u(x, a.w), v = nrd::pixel_u(y, a.h);
  const float mat_c = fmaxf(nr.at(x, y, 3) * 3.0f, a.min_material);
  float sum = 1.0f + a.data1[i];
  float acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = center[c] * sum;

  for (int j = -2; j <= 2; ++j)
    for (int k = -2; k <= 2; ++k) {
      if ((j == 0 && k == 0) || abs(j) + abs(k) == 4) continue;
      const float ofx = (float)k * stride, ofy = (float)j * stride;
      const float us = u + ofx * a.rect_inv_w, vs = v + ofy * a.rect_inv_h;
      const int px = (int)fminf(fmaxf((float)x + ofx, 0.0f), (float)(a.w - 1));
      const int py = (int)fminf(fmaxf((float)y + ofy, 0.0f), (float)(a.h - 1));

      const float zs = fabsf(vz.at(px, py, 0)) * a.view_z_scale;
      const V3 ns = nrd::unpack_normal(nr.at(px, py, 0), nr.at(px, py, 1));
      const float ms = fmaxf(nr.at(px, py, 3) * 3.0f, a.min_material);
      const float angle = nrd::acos_approx(nrd::dot3(ns, n));
      const V3 xvs = nrd::reconstruct_view_position(us, vs, a.fr, zs, a.ortho);

      float w_ = nrd::in_screen_nearest(us, vs);
      w_ = w_ * nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
      w_ = w_ * (mat_c == ms ? 1.0f : 0.0f);
      w_ = w_ * nrd::compute_exponential_weight(angle, nwp, 0.0f);
      if (a.spec) {
        const float rs = nr.at(px, py, 2);
        w_ = w_ * nrd::compute_exponential_weight(rs * rs, ra, rb);
      }
      w_ = w_ * (1.0f + data1.at(px, py, 0));
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = w_ == 0.0f ? 0.0f : sig.at(px, py, c);
      const float hs = s[3] * hds;
      w_ = w_ * nrd::compute_exponential_weight(nrd::saturate(hs / fsz), ha, hb);
      if (a.spec) {
        const float d = fabsf(hit_dist - hs) / (fmaxf(hit_dist, hs) + 0.001f);
        w_ = w_ * nrd::smoothstep(gb_lo, gb_hi, d);
      }
      sum = sum + w_;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = acc[c] + s[c] * w_;
    }
  const float inv = 1.0f / fmaxf(sum, 1e-15f);
#pragma unroll
  for (int c = 0; c < 4; ++c) a.out[4 * i + c] = acc[c] * inv;
}

}  // namespace

// ptrs: signal, view_z, nr, data1, fast, params, out, moments
// consts: frustum[4], rect_inv_w, rect_inv_h, view_z_scale, ortho_mode, min_material,
//         specular mode (0 or 1)
extern "C" int nrd_history_fix(void* const* p, const float* c, int w, int h, void* stream) {
  HfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.data1 = (const float*)p[3];
  a.fast = (const float*)p[4];
  a.params = (const float*)p[5];
  a.out = (float*)p[6];
  a.moments = (float*)p[7];
  a.w = w;
  a.h = h;
  for (int k = 0; k < 4; ++k) a.fr[k] = c[k];
  a.rect_inv_w = c[4];
  a.rect_inv_h = c[5];
  a.view_z_scale = c[6];
  a.ortho = c[7];
  a.min_material = c[8];
  a.spec = c[9] != 0.0f;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  history_fix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
