// N5: REBLUR history fix of both signals in one launch: each signal's 20 stride taps at its
// own stride (diffuse or specular weights, its own min material), each signal's 3x3
// fast-history moments and, per signal on request, the anti-firefly ring.
// Replaces nrdtpu/kernels/reblur_fused.py:668 history_fix_fused_pallas (K3); computes what the
// two per-signal XLA calls of history_fix compute (nrdtpu/passes/reblur/kernels.py:546-552,
// :629-683, :693-719) through reblur_filters.cuh, with the centre pixel's shared planes loaded
// once; the clamp chain after the taps stays in the glue. The plain version is
// nrdtpu_torch/kernels/history_fix_fused.py:history_fix_fused_ref (H3's plain version run
// once per signal). One thread per pixel.
#include "reblur_filters.cuh"

namespace {

using nrd::Image;

struct HffArgs {
  const float* signal[2];  // (h, w, 4) diffuse, specular
  const float* data1[2];   // (h, w)
  const float* fast[2];    // (h, w)
  const float* params[2];  // (kHfDiffParams, h, w), (kHfSpecParams, h, w)
  const float* view_z;     // (h, w) raw
  const float* nr;         // (h, w, 4)
  const float* shared;     // (kHfShared, h, w)
  float* out;              // (2, h, w, 4)
  float* moments;          // (2, 4, h, w): per signal m1, m2 [, ring m1, ring m2]
  float min_material[2];
  bool anti_firefly[2];
  nrd::HfFrame f;
};

__global__ void __launch_bounds__(256) history_fix_fused_kernel(HffArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const size_t plane = (size_t)a.f.w * a.f.h;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const Image<float, 1> vz{a.view_z, a.f.w, a.f.h};
  const nrd::Centre c = nrd::hf_centre(a.shared + i, plane, nr, x, y);
  const nrd::PackedTaps taps{nr, vz, a.f.view_z_scale};
#pragma unroll
  for (int s = 0; s < 2; ++s) {  // unrolled: s is constant, the arrays stay in registers
    const Image<float, 1> fast{a.fast[s], a.f.w, a.f.h};
    float* m = a.moments + 4 * s * plane + i;
    nrd::fast_moments(fast, x, y, m, m + plane);
    if (a.anti_firefly[s]) nrd::anti_firefly_moments(fast, x, y, m + 2 * plane, m + 3 * plane);
    float out[4];
    nrd::hf_filter(a.f, c, a.params[s] + i, plane, s == 1, a.min_material[s],
                   Image<float, 4>{a.signal[s], a.f.w, a.f.h},
                   Image<float, 1>{a.data1[s], a.f.w, a.f.h}, taps, out);
    float* o = a.out + 4 * (s * plane + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = out[k];
  }
}

}  // namespace

// ptrs: diff, spec, diff_data1, spec_data1, diff_fast, spec_fast, diff_params, spec_params,
//       view_z, nr, shared, out, moments
// consts: frustum[4], rect_inv_w, rect_inv_h, view_z_scale, ortho_mode, diff_min_material,
//         spec_min_material, diffuse anti-firefly ring (0 or 1), specular ring (0 or 1)
extern "C" int nrd_history_fix_fused(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  HffArgs a;
  for (int s = 0; s < 2; ++s) {
    a.signal[s] = (const float*)p[s];
    a.data1[s] = (const float*)p[2 + s];
    a.fast[s] = (const float*)p[4 + s];
    a.params[s] = (const float*)p[6 + s];
  }
  a.view_z = (const float*)p[8];
  a.nr = (const float*)p[9];
  a.shared = (const float*)p[10];
  a.out = (float*)p[11];
  a.moments = (float*)p[12];
  a.f.w = w;
  a.f.h = h;
  for (int k = 0; k < 4; ++k) a.f.fr[k] = c[k];
  a.f.rect_inv_w = c[4];
  a.f.rect_inv_h = c[5];
  a.f.view_z_scale = c[6];
  a.f.ortho = c[7];
  a.min_material[0] = c[8];
  a.min_material[1] = c[9];
  a.anti_firefly[0] = c[10] != 0.0f;
  a.anti_firefly[1] = c[11] != 0.0f;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  history_fix_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
