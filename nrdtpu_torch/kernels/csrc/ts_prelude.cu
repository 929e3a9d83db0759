// H4: REBLUR temporal-stabilization prelude: 3x3 luma moments + min/max over the 8
// neighbours, and the luma-stabilization history sampled at the surface-motion position
// with the occlusion of fbits bits 0-3 and, for specular, at the virtual-motion position
// with bits 4-7. Replaces nrdtpu/kernels/reblur_pallas.py:1754 moments_minmax_pallas and
// :1705 hist_sample_pallas (nrdtpu/passes/reblur/kernels.py:2338-2342, 2365-2385,
// 2458-2485). The plain version is nrdtpu_torch/kernels/ts_prelude.py:ts_prelude_ref.
// One thread per pixel.
#include "common.cuh"

namespace {

using nrd::Image;

struct TsArgs {
  const float* luma;           // (h, w)
  const __nv_bfloat16* hist;   // (h, w)
  const float* smb_uv;         // (h, w, 2)
  const float* vmb_uv;         // (h, w, 2), read when has_vmb
  const float* fbits;          // (h, w)
  float* out;                  // (5 or 6, h, w): m1, m2, lmin, lmax, history[, vmb history]
  int w, h;
  float rect_prev_w, rect_prev_h;
  bool has_vmb;
};

// sample_history at uv with the occlusion of fbits bits first_bit..first_bit+3
__device__ __forceinline__ float sample_history(const TsArgs& a, const float* uv, int bits,
                                                int first_bit) {
  const float u = uv[0], v = uv[1];
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  float bw[4];
  nrd::bilinear_weights(posx - floorf(posx), posy - floorf(posy), bw);
  float ow[4], occ_sum = 0.0f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float o = (float)((bits >> (first_bit + b)) & 1);
    ow[b] = bw[b] * o;
    occ_sum = occ_sum + o;
  }
  float hist;
  nrd::sample_catrom(Image<__nv_bfloat16, 1>{a.hist, a.w, a.h},
                     nrd::saturate(u) * a.rect_prev_w, nrd::saturate(v) * a.rect_prev_h,
                     occ_sum > 3.5f, ow, &hist);
  return hist;
}

__global__ void __launch_bounds__(256) ts_prelude_kernel(TsArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 1> luma{a.luma, a.w, a.h};

  float m1 = 0.0f, m2 = 0.0f, lmin = 1e6f, lmax = -1e6f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float t = luma.at(x + dx, y + dy, 0);
      m1 = m1 + t;
      m2 = m2 + t * t;
      if (dy != 0 || dx != 0) {
        lmin = fminf(lmin, t);
        lmax = fmaxf(lmax, t);
      }
    }

  const int bits = (int)a.fbits[i];
  a.out[i] = m1 / 9.0f;
  a.out[plane + i] = m2 / 9.0f;
  a.out[2 * plane + i] = lmin;
  a.out[3 * plane + i] = lmax;
  a.out[4 * plane + i] = sample_history(a, a.smb_uv + 2 * i, bits, 0);
  if (a.has_vmb) a.out[5 * plane + i] = sample_history(a, a.vmb_uv + 2 * i, bits, 4);
}

}  // namespace

// ptrs: luma, hist, smb_uv, vmb_uv, fbits, out;  consts: rect_prev_w, rect_prev_h, has_vmb
extern "C" int nrd_ts_prelude(void* const* p, const float* c, int w, int h, void* stream) {
  TsArgs a;
  a.luma = (const float*)p[0];
  a.hist = (const __nv_bfloat16*)p[1];
  a.smb_uv = (const float*)p[2];
  a.vmb_uv = (const float*)p[3];
  a.fbits = (const float*)p[4];
  a.out = (float*)p[5];
  a.w = w;
  a.h = h;
  a.rect_prev_w = c[0];
  a.rect_prev_h = c[1];
  a.has_vmb = c[2] != 0.0f;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  ts_prelude_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
