// H3: REBLUR history fix: stride-tap reconstruction + 3x3 fast-history moments, diffuse
// or specular (roughness weight + low-roughness hitT guide), and on request the anti-firefly
// ring (mean and second moment of the fast history over the 9x9 square minus the 3x3).
// Replaces nrdtpu/kernels/reblur_hfix2.py:222 history_fix_taps_pallas2 (ring: :209-212);
// computes nrdtpu/passes/reblur/kernels.py:546-552, :629-683, :693-700 and :705-719 per pixel
// through reblur_filters.cuh. The plain version is
// nrdtpu_torch/kernels/history_fix.py:history_fix_ref. One thread per pixel.
#include "reblur_filters.cuh"

namespace {

using nrd::Image;

struct HfArgs {
  const float* signal;  // (h, w, 4)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* data1;   // (h, w) accumulated frames
  const float* fast;    // (h, w) fast history
  const float* shared;  // (kHfShared, h, w), order of nrd::HfShared
  const float* params;  // (kHfDiffParams | kHfSpecParams, h, w), order of nrd::HfParam
  float* out;           // (h, w, 4)
  float* moments;       // (2 | 4, h, w): m1, m2 of the 3x3 [, of the anti-firefly ring]
  float min_material;
  bool anti_firefly;
  nrd::HfFrame f;
};

template <bool kSpec>
__global__ void __launch_bounds__(256) history_fix_kernel(HfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const size_t plane = (size_t)a.f.w * a.f.h;
  const Image<float, 1> fast{a.fast, a.f.w, a.f.h};
  nrd::fast_moments(fast, x, y, a.moments + i, a.moments + plane + i);
  if (a.anti_firefly)
    nrd::anti_firefly_moments(fast, x, y, a.moments + 2 * plane + i, a.moments + 3 * plane + i);

  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const nrd::Centre c = nrd::hf_centre(a.shared + i, plane, nr, x, y);
  float out[4];
  nrd::hf_filter<kSpec>(a.f, c, a.params + i, plane, a.min_material,
                 Image<float, 4>{a.signal, a.f.w, a.f.h}, Image<float, 1>{a.data1, a.f.w, a.f.h},
                 nrd::PackedTaps{nr, Image<float, 1>{a.view_z, a.f.w, a.f.h}, a.f.view_z_scale},
                 out);
#pragma unroll
  for (int k = 0; k < 4; ++k) a.out[4 * i + k] = out[k];
}

}  // namespace

// ptrs: signal, view_z, nr, data1, fast, shared, params, out, moments
// consts: frustum[4], rect_inv_w, rect_inv_h, view_z_scale, ortho_mode, min_material,
//         specular mode (0 or 1), anti-firefly ring (0 or 1)
extern "C" int nrd_history_fix(void* const* p, const float* c, int w, int h, void* stream) {
  HfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.data1 = (const float*)p[3];
  a.fast = (const float*)p[4];
  a.shared = (const float*)p[5];
  a.params = (const float*)p[6];
  a.out = (float*)p[7];
  a.moments = (float*)p[8];
  a.f.w = w;
  a.f.h = h;
  for (int k = 0; k < 4; ++k) a.f.fr[k] = c[k];
  a.f.rect_inv_w = c[4];
  a.f.rect_inv_h = c[5];
  a.f.view_z_scale = c[6];
  a.f.ortho = c[7];
  a.min_material = c[8];
  a.anti_firefly = c[10] != 0.0f;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (c[9] != 0.0f)
    history_fix_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    history_fix_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
