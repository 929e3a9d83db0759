// K12: REBLUR hit-distance reconstruction: a hit distance of 0 is refilled from the 3x3
// (radius 1) or 5x5 (radius 2) neighbourhood, centre excluded, weighted by in-screen,
// Gaussian, plane distance, normal angle and (specular) roughness; diffuse, specular or both
// in one launch. Replaces nrdtpu/kernels/reblur_pallas.py:1596 hitdist_recon_pallas; computes
// the taps of nrdtpu/passes/reblur/kernels.py:2255-2293. The plain version is
// nrdtpu_torch/kernels/hitdist_recon.py:hitdist_recon_ref. One thread per pixel. The roughness
// encoding is the template parameter kRough (common.cuh:decode_roughness), applied to each
// tap's roughness, as the TPU kernel's rough_sq.
#include "common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr int kMaxTaps = 24;

struct HdArgs {
  const float* view_z;    // (h, w) raw viewZ
  const float* nr;        // (h, w, 4) packed normal/roughness/material
  const float* sig[2];    // (h, w, 4) diffuse and specular signals; .w is the hit distance
  const float* params;    // (P, h, w): ga, gb [, diffuse nwp] [, specular nwp, ra, rb]
  float* out;             // (signal count, h, w) reconstructed hit distances
  int w, h, radius;
  bool has[2];
  float view_z_scale, fr[4], ortho, rinv_x, rinv_y;
  float m[9];             // world_to_view rotation, row-major
  float gauss[kMaxTaps];  // Gaussian weight of each tap, row by row
};

template <int kRough>
__global__ void __launch_bounds__(256) hitdist_recon_kernel(HdArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 1> vz{a.view_z, a.w, a.h};
  const Image<float, 4> nr{a.nr, a.w, a.h};

  const V3 n = nrd::unpack_normal(nr.at(x, y, 0), nr.at(x, y, 1));
  const V3 nv{a.m[0] * n.x + a.m[1] * n.y + a.m[2] * n.z,
              a.m[3] * n.x + a.m[4] * n.y + a.m[5] * n.z,
              a.m[6] * n.x + a.m[7] * n.y + a.m[8] * n.z};
  const float ga = a.params[i], gb = a.params[plane + i];
  int k = 2;
  float nwp[2] = {0.0f, 0.0f}, ra = 0.0f, rb = 0.0f;
  if (a.has[0]) nwp[0] = a.params[(k++) * plane + i];
  if (a.has[1]) {
    nwp[1] = a.params[k * plane + i];
    ra = a.params[(k + 1) * plane + i];
    rb = a.params[(k + 2) * plane + i];
  }

  float acc[2] = {0.0f, 0.0f}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!a.has[s]) continue;
    const float hd = a.sig[s][4 * i + 3];
    sum[s] = 1000.0f * (hd != 0.0f ? 1.0f : 0.0f);
    acc[s] = hd * sum[s];
  }

  const float u = nrd::pixel_u(x, a.w), v = nrd::pixel_u(y, a.h);
  int t = 0;
  for (int dy = -a.radius; dy <= a.radius; ++dy)
    for (int dx = -a.radius; dx <= a.radius; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const int tx = nrd::clampi(x + dx, 0, a.w - 1), ty = nrd::clampi(y + dy, 0, a.h - 1);
      const size_t ti = (size_t)ty * a.w + tx;
      const float zs = fabsf(vz.at(tx, ty, 0)) * a.view_z_scale;
      const V3 ns = nrd::unpack_normal(nr.at(tx, ty, 0), nr.at(tx, ty, 1));
      const float rs = nrd::decode_roughness<kRough>(nr.at(tx, ty, 2));
      const float us = u + (float)dx * a.rinv_x, vs = v + (float)dy * a.rinv_y;
      const V3 xvs = nrd::reconstruct_view_position(us, vs, a.fr, zs, a.ortho);
      float w_ = nrd::in_screen_nearest(us, vs);
      w_ = w_ * a.gauss[t++];
      w_ = w_ * nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
      const float angle = nrd::acos_approx(nrd::dot3(n, ns));
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (!a.has[s]) continue;
        float ws = w_ * nrd::compute_exponential_weight(angle, nwp[s], 0.0f);
        if (s == 1) ws = ws * nrd::compute_exponential_weight(rs * rs, ra, rb);
        const float tap = a.sig[s][4 * ti + 3];
        ws = ws * (tap != 0.0f ? 1.0f : 0.0f);
        acc[s] = acc[s] + tap * ws;
        sum[s] = sum[s] + ws;
      }
    }

  int o = 0;
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (a.has[s]) a.out[(o++) * plane + i] = acc[s] / fmaxf(sum[s], 1e-6f);
}

}  // namespace

// ptrs: view_z, nr, diff signal, spec signal, params, out
// consts: radius, has_diff, has_spec, view_z_scale, frustum[4], ortho, rinv[2], m[9],
//         roughness mode (0 LINEAR, 1 SQRT_LINEAR, 2 SQ_LINEAR), the Gaussian weight of each
//         tap
extern "C" int nrd_hitdist_recon(void* const* p, const float* c, int w, int h, void* stream) {
  HdArgs a;
  a.view_z = (const float*)p[0];
  a.nr = (const float*)p[1];
  a.sig[0] = (const float*)p[2];
  a.sig[1] = (const float*)p[3];
  a.params = (const float*)p[4];
  a.out = (float*)p[5];
  a.w = w;
  a.h = h;
  a.radius = (int)c[0];
  if (a.radius != 1 && a.radius != 2) return (int)cudaErrorInvalidValue;
  a.has[0] = c[1] != 0.0f;
  a.has[1] = c[2] != 0.0f;
  a.view_z_scale = c[3];
  for (int k = 0; k < 4; ++k) a.fr[k] = c[4 + k];
  a.ortho = c[8];
  a.rinv_x = c[9];
  a.rinv_y = c[10];
  for (int k = 0; k < 9; ++k) a.m[k] = c[11 + k];
  const int taps = (2 * a.radius + 1) * (2 * a.radius + 1) - 1;
  const int rough = (int)c[20];
  for (int k = 0; k < kMaxTaps; ++k) a.gauss[k] = k < taps ? c[21 + k] : 0.0f;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (rough == 0)
    hitdist_recon_kernel<0><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (rough == 1)
    hitdist_recon_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (rough == 2)
    hitdist_recon_kernel<2><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
