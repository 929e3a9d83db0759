// N4: REBLUR spatial-filter tap loops of both signals (PrePass, Blur, PostBlur) in one launch.
// Replaces nrdtpu/kernels/reblur_fused.py:787 spatial_filter_fused_pallas (K2); computes what
// the two per-signal XLA calls compute (diffuse_pre_pass / diffuse_spatial_filter and
// specular_spatial_filter, nrdtpu/passes/reblur/kernels.py:844-873, :2164-2189, :1710-1756):
// the diffuse mode of H2 and the specular (or specular PrePass) mode of H2, each at its own
// scaled-rotator tap positions, through reblur_filters.cuh:sf_filter. Its inputs are the
// glue's parameter planes, as K2's are; it computes no parameter itself. The plain version is
// nrdtpu_torch/kernels/spatial_filter_fused.py:spatial_filter_fused_ref (H2's plain version
// run once per signal).
//
// Design for the H100: one CTA per (16x16 tile, signal), the signal in the low bit of
// blockIdx.x, so a thread runs one signal's tap loop and the register budget is the larger
// signal's, not the sum of both (measured 8-10 % faster than both signals a thread for Blur
// and PostBlur, 1-3 % slower for the PrePass, PERF.md); kSfCtas is the CTAs an SM that ptxas
// is asked to fit (4 and 6 measured no faster). One kernel per tap count (8, or 6 in
// performance mode) and stage. The Blur and PostBlur read each tap's unpacked normal and
// scaled viewZ from the frame's tap-geometry plane that N5 writes (UnpackedTaps); the PrePass,
// which runs before N5, unpacks each texel (PackedTaps: a plane and its prologue there
// measured no faster).
#include "reblur_filters.cuh"

namespace {

using nrd::Image;
using nrd::SfMode;

constexpr int kSfCtas = 5;

struct SffArgs {
  const float* signal[2];    // (h, w, 4) diffuse, specular
  const float* params[2];    // (kSfDiffParams, h, w), (kSfSpecParams | kSfPrepassParams, h, w)
  const float* view_z;       // (h, w) raw
  const float* nr;           // (h, w, 4)
  const float* shared;       // (kSfShared, h, w)
  const float4* geometry;    // (h, w) the taps' unpacked normal and scaled viewZ; null in PrePass
  float* out;                // (2, h, w, 4): diffuse, specular
  float* hdt;                // (h, w) hitDistForTracking, PrePass only
  float min_material[2];
  nrd::SfFrame f;
};

template <int kTaps, SfMode kSpecMode, typename Taps>
__device__ __forceinline__ void filter_pixel(const SffArgs& a, const Taps& taps, int s, int x,
                                             int y) {
  const size_t i = (size_t)y * a.f.w + x;
  const size_t plane = (size_t)a.f.w * a.f.h;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const nrd::Centre c = nrd::sf_centre(a.shared + i, plane, nr, x, y);
  float out[4];
  if (s == 0)
    nrd::sf_filter<kTaps, SfMode::kDiffuse>(a.f, c, a.params[0] + i, plane, a.min_material[0],
                                            Image<float, 4>{a.signal[0], a.f.w, a.f.h}, taps, out,
                                            nullptr);
  else
    nrd::sf_filter<kTaps, kSpecMode>(a.f, c, a.params[1] + i, plane, a.min_material[1],
                                     Image<float, 4>{a.signal[1], a.f.w, a.f.h}, taps, out,
                                     a.hdt + i);
  reinterpret_cast<float4*>(a.out)[s * plane + i] = make_float4(out[0], out[1], out[2], out[3]);
}

template <int kTaps, bool kPrepass>
__global__ void __launch_bounds__(256, kSfCtas) spatial_filter_fused_kernel(SffArgs a) {
  const int s = (int)(blockIdx.x & 1u);
  const int x = (int)(blockIdx.x >> 1) * nrd::kBlock + (int)threadIdx.x;
  const int y = (int)blockIdx.y * nrd::kBlock + (int)threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  if constexpr (kPrepass)
    filter_pixel<kTaps, SfMode::kPrepass>(
        a, nrd::PackedTaps{nr, Image<float, 1>{a.view_z, a.f.w, a.f.h}, a.f.view_z_scale}, s, x,
        y);
  else
    filter_pixel<kTaps, SfMode::kSpec>(a, nrd::UnpackedTaps{a.geometry, nr}, s, x, y);
}

using Kernel = void (*)(SffArgs);

template <int kTaps>
Kernel pick(bool prepass) {
  return prepass ? spatial_filter_fused_kernel<kTaps, true>
                 : spatial_filter_fused_kernel<kTaps, false>;
}

}  // namespace

// ptrs: diff, spec, view_z, nr, shared, diff_params, spec_params, geometry (null in PrePass
//       mode, required otherwise), out, hdt
// consts: frustum[4], rect_w, rect_h, view_z_scale, ortho_mode, diff_min_material,
//         spec_min_material, ntaps (8 or 6), spec nparams; in PrePass mode also hit-distance
//         params[4], use_prepass_not_only, frame index low 16 bits, high 16 bits
extern "C" int nrd_spatial_filter_fused(void* const* p, const float* c, int w, int h,
                                        void* stream) {
  SffArgs a;
  a.signal[0] = (const float*)p[0];
  a.signal[1] = (const float*)p[1];
  a.view_z = (const float*)p[2];
  a.nr = (const float*)p[3];
  a.shared = (const float*)p[4];
  a.params[0] = (const float*)p[5];
  a.params[1] = (const float*)p[6];
  a.geometry = (const float4*)p[7];
  a.out = (float*)p[8];
  a.hdt = (float*)p[9];
  a.f.w = w;
  a.f.h = h;
  for (int k = 0; k < 4; ++k) a.f.fr[k] = c[k];
  a.f.rect_w = c[4];
  a.f.rect_h = c[5];
  a.f.inv_rect_w = 1.0f / c[4];
  a.f.inv_rect_h = 1.0f / c[5];
  a.f.view_z_scale = c[6];
  a.f.ortho = c[7];
  a.min_material[0] = c[8];
  a.min_material[1] = c[9];
  const int ntaps = (int)c[10], spec_nparams = (int)c[11];
  if ((ntaps != 8 && ntaps != 6) ||
      (spec_nparams != nrd::kSfSpecParams && spec_nparams != nrd::kSfPrepassParams))
    return (int)cudaErrorInvalidValue;
  const bool prepass = spec_nparams == nrd::kSfPrepassParams;
  if (prepass != (a.geometry == nullptr)) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) a.f.hdp[k] = 0.0f;
  a.f.use_prepass_not_only = 0.0f;
  a.f.frame_index = 0;
  if (prepass) {
    for (int k = 0; k < 4; ++k) a.f.hdp[k] = c[12 + k];
    a.f.use_prepass_not_only = c[16];
    a.f.frame_index = (uint32_t)c[17] | ((uint32_t)c[18] << 16);
  }
  const Kernel kernel = ntaps == 8 ? pick<8>(prepass) : pick<6>(prepass);
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 tiles((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const dim3 grid(2 * tiles.x, tiles.y);  // one CTA per (tile, signal)
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
