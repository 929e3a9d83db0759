// K21: RELAX anti-firefly (RCRS) of 1 or 2 signals in one launch: over the 8 neighbours of the
// clamp-to-edge 3x3 (row by row, centre excluded) whose material matches the centre's, the
// brightest and the darkest rgb by luminance (the first wins a tie); the centre's rgb becomes
// the brightest where it is brighter than all, then the darkest where it is darker than all;
// .w passes through. Replaces nrdtpu/kernels/relax_pallas.py:537 relax_antifirefly_pallas;
// computes nrdtpu/passes/relax/kernels.py:1302-1326 per pixel. The plain version is
// nrdtpu_torch/kernels/relax_antifirefly.py:relax_antifirefly_ref. One thread per pixel, one
// instance per mode <kDec>: R10G10B10A2, the material of the packed plane's .w; the RGBA
// formats (kDec), no material and no material test (the TPU kernel's mat_occ=False), so
// the instance reads no normal plane.
#include "relax_common.cuh"

namespace {

using nrd::Image;

constexpr int kMaxSignals = 2;

struct RelaxAfArgs {
  const float* nr;                   // (h, w, 4) current packed normal/roughness/material
  float* out;                        // (nsig, h, w, 4)
  const float* sig[kMaxSignals];     // (h, w, 4) each
  float min_material[kMaxSignals];
  int w, h, nsig;
};

template <bool kDec = false>
__global__ void __launch_bounds__(256) relax_antifirefly_kernel(RelaxAfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 4> nr{a.nr, a.w, a.h};
  const float mat = kDec ? 0.0f : nr.at(x, y, 3) * 3.0f;
#pragma unroll
  for (int k = 0; k < kMaxSignals; ++k) {  // unrolled: the pointers stay in registers
    if (k >= a.nsig) break;
    const Image<float, 4> sig{a.sig[k], a.w, a.h};
    const float mm = a.min_material[k];
    const float mat_c = fmaxf(mat, mm);
    float c[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) c[ch] = sig.at(x, y, ch);
    const float luma = relax::luminance(c[0], c[1], c[2]);
    float max_l = -1.0f, min_l = 1e6f;
    float max_rgb[3] = {c[0], c[1], c[2]}, min_rgb[3] = {c[0], c[1], c[2]};
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (dx == 0 && dy == 0) continue;
        const float s[3] = {sig.at(x + dx, y + dy, 0), sig.at(x + dx, y + dy, 1),
                            sig.at(x + dx, y + dy, 2)};
        const float sl = relax::luminance(s[0], s[1], s[2]);
        const bool ok = kDec || fmaxf(nr.at(x + dx, y + dy, 3) * 3.0f, mm) == mat_c;
        if (ok && sl > max_l) {
          max_l = sl;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) max_rgb[ch] = s[ch];
        }
        if (ok && sl < min_l) {
          min_l = sl;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) min_rgb[ch] = s[ch];
        }
      }
    float o[3] = {c[0], c[1], c[2]};
    if (luma > max_l)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = max_rgb[ch];
    if (luma < min_l)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = min_rgb[ch];
    float* out = a.out + 4 * (k * plane + i);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[ch] = o[ch];
    out[3] = c[3];
  }
}

}  // namespace

// ptrs: nr, out, then kMaxSignals signal slots (the first nsig used)
// consts: nsig, then kMaxSignals min materials, then the plane decoded (kDec: 0 or 1)
extern "C" int nrd_relax_antifirefly(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  RelaxAfArgs a;
  a.nr = (const float*)p[0];
  a.out = (float*)p[1];
  a.w = w;
  a.h = h;
  a.nsig = (int)c[0];
  if (a.nsig < 1 || a.nsig > kMaxSignals) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kMaxSignals; ++k) {
    a.sig[k] = (const float*)p[2 + (k < a.nsig ? k : 0)];
    a.min_material[k] = c[1 + k];
  }
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (c[1 + kMaxSignals] != 0.0f)
    relax_antifirefly_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    relax_antifirefly_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
