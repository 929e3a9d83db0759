// H2: REBLUR spatial-filter tap loop (PrePass, Blur, PostBlur), diffuse or specular.
// Replaces nrdtpu/kernels/reblur_blur2.py:264 spatial_filter_taps_pallas2; computes the tap
// loop of nrdtpu/passes/reblur/kernels.py:844-873 / :2164-2189 (diffuse) and :1710-1756
// (specular, with the PrePass hitDistForTracking minimum) per pixel, in
// reblur_filters.cuh:sf_filter, one kernel per tap count and mode. The plain version is
// nrdtpu_torch/kernels/spatial_filter.py:spatial_filter_ref. One thread per pixel.
#include "reblur_filters.cuh"

namespace {

using nrd::Image;

struct SfArgs {
  const float* signal;  // (h, w, 4)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* shared;  // (kSfShared, h, w), order of nrd::SfShared
  const float* params;  // (nparams, h, w), order of nrd::SfParam
  float* out;           // (h, w, 4)
  float* hdt;           // (h, w) hitDistForTracking, specular PrePass only
  float min_material;
  nrd::SfFrame f;
};

template <int kTaps, nrd::SfMode kMode>
__global__ void __launch_bounds__(256) spatial_filter_kernel(SfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const size_t plane = (size_t)a.f.w * a.f.h;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const nrd::Centre c = nrd::sf_centre(a.shared + i, plane, nr, x, y);
  float out[4];
  nrd::sf_filter<kTaps, kMode>(
      a.f, c, a.params + i, plane, a.min_material, Image<float, 4>{a.signal, a.f.w, a.f.h},
      nrd::PackedTaps{nr, Image<float, 1>{a.view_z, a.f.w, a.f.h}, a.f.view_z_scale}, out,
      a.hdt + i);
  reinterpret_cast<float4*>(a.out)[i] = make_float4(out[0], out[1], out[2], out[3]);
}

using Kernel = void (*)(SfArgs);

template <int kTaps>
Kernel pick(int nparams) {
  using nrd::SfMode;
  return nparams == nrd::kSfDiffParams   ? spatial_filter_kernel<kTaps, SfMode::kDiffuse>
         : nparams == nrd::kSfSpecParams ? spatial_filter_kernel<kTaps, SfMode::kSpec>
                                         : spatial_filter_kernel<kTaps, SfMode::kPrepass>;
}

}  // namespace

// ptrs: signal, view_z, nr, shared, params, out, hdt
// consts: frustum[4], rect_w, rect_h, view_z_scale, ortho_mode, min_material, ntaps (8 or 6),
//         nparams; in PrePass mode also hit-distance params[4], use_prepass_not_only,
//         frame index low 16 bits, high 16 bits
extern "C" int nrd_spatial_filter(void* const* p, const float* c, int w, int h, void* stream) {
  SfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.shared = (const float*)p[3];
  a.params = (const float*)p[4];
  a.out = (float*)p[5];
  a.hdt = (float*)p[6];
  a.f.w = w;
  a.f.h = h;
  for (int k = 0; k < 4; ++k) a.f.fr[k] = c[k];
  a.f.rect_w = c[4];
  a.f.rect_h = c[5];
  a.f.inv_rect_w = 1.0f / c[4];
  a.f.inv_rect_h = 1.0f / c[5];
  a.f.view_z_scale = c[6];
  a.f.ortho = c[7];
  a.min_material = c[8];
  const int ntaps = (int)c[9], nparams = (int)c[10];
  if ((ntaps != 8 && ntaps != 6) || (nparams != nrd::kSfDiffParams &&
                                     nparams != nrd::kSfSpecParams &&
                                     nparams != nrd::kSfPrepassParams))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) a.f.hdp[k] = 0.0f;
  a.f.use_prepass_not_only = 0.0f;
  a.f.frame_index = 0;
  if (nparams == nrd::kSfPrepassParams) {
    for (int k = 0; k < 4; ++k) a.f.hdp[k] = c[11 + k];
    a.f.use_prepass_not_only = c[15];
    a.f.frame_index = (uint32_t)c[16] | ((uint32_t)c[17] << 16);
  }
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const Kernel kernel = ntaps == 8 ? pick<8>(nparams) : pick<6>(nparams);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
