// N4: REBLUR spatial-filter tap loops of both signals (PrePass, Blur, PostBlur) in one launch.
// Replaces nrdtpu/kernels/reblur_fused.py:787 spatial_filter_fused_pallas (K2); computes what
// the two per-signal XLA calls compute (diffuse_pre_pass / diffuse_spatial_filter and
// specular_spatial_filter, nrdtpu/passes/reblur/kernels.py:844-873, :2164-2189, :1710-1756):
// the diffuse mode of H2 and the specular (or specular PrePass) mode of H2 over one thread per
// pixel, each at its own scaled-rotator tap positions, through reblur_filters.cuh:sf_filter.
// The centre pixel's normal, view normal, material and plane-distance parameters are loaded
// once. The plain version is nrdtpu_torch/kernels/spatial_filter_fused.py:
// spatial_filter_fused_ref (H2's plain version run once per signal).
#include "reblur_filters.cuh"

namespace {

using nrd::Image;

struct SffArgs {
  const float* diff;         // (h, w, 4)
  const float* spec;         // (h, w, 4)
  const float* view_z;       // (h, w) raw
  const float* nr;           // (h, w, 4)
  const float* shared;       // (kSfShared, h, w)
  const float* diff_params;  // (kSfDiffParams, h, w)
  const float* spec_params;  // (kSfSpecParams | kSfPrepassParams, h, w)
  float* out;                // (2, h, w, 4): diffuse, specular
  float* hdt;                // (h, w) hitDistForTracking, PrePass only
  int spec_nparams;
  float diff_min_material, spec_min_material;
  nrd::SfFrame f;
};

__global__ void __launch_bounds__(256) spatial_filter_fused_kernel(SffArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const size_t plane = (size_t)a.f.w * a.f.h;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const Image<float, 1> vz{a.view_z, a.f.w, a.f.h};
  const nrd::Centre c = nrd::sf_centre(a.shared + i, plane, nr, x, y);
  const nrd::PackedTaps taps{nr, vz, a.f.view_z_scale};
  float out[4];
  nrd::sf_filter(a.f, c, a.diff_params + i, plane, nrd::kSfDiffParams, a.diff_min_material,
                 Image<float, 4>{a.diff, a.f.w, a.f.h}, taps, out, nullptr);
#pragma unroll
  for (int k = 0; k < 4; ++k) a.out[4 * i + k] = out[k];
  nrd::sf_filter(a.f, c, a.spec_params + i, plane, a.spec_nparams, a.spec_min_material,
                 Image<float, 4>{a.spec, a.f.w, a.f.h}, taps, out, a.hdt + i);
#pragma unroll
  for (int k = 0; k < 4; ++k) a.out[4 * (plane + i) + k] = out[k];
}

}  // namespace

// ptrs: diff, spec, view_z, nr, shared, diff_params, spec_params, taps, out, hdt
// consts: frustum[4], rect_w, rect_h, view_z_scale, ortho_mode, diff_min_material,
//         spec_min_material, ntaps, spec nparams; in PrePass mode also hit-distance
//         params[4], use_prepass_not_only, frame index low 16 bits, high 16 bits
extern "C" int nrd_spatial_filter_fused(void* const* p, const float* c, int w, int h,
                                        void* stream) {
  SffArgs a;
  a.diff = (const float*)p[0];
  a.spec = (const float*)p[1];
  a.view_z = (const float*)p[2];
  a.nr = (const float*)p[3];
  a.shared = (const float*)p[4];
  a.diff_params = (const float*)p[5];
  a.spec_params = (const float*)p[6];
  a.f.taps = (const float*)p[7];
  a.out = (float*)p[8];
  a.hdt = (float*)p[9];
  a.f.w = w;
  a.f.h = h;
  for (int k = 0; k < 4; ++k) a.f.fr[k] = c[k];
  a.f.rect_w = c[4];
  a.f.rect_h = c[5];
  a.f.view_z_scale = c[6];
  a.f.ortho = c[7];
  a.diff_min_material = c[8];
  a.spec_min_material = c[9];
  a.f.ntaps = (int)c[10];
  a.spec_nparams = (int)c[11];
  if (a.spec_nparams != nrd::kSfSpecParams && a.spec_nparams != nrd::kSfPrepassParams)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) a.f.hdp[k] = 0.0f;
  a.f.use_prepass_not_only = 0.0f;
  a.f.frame_index = 0;
  if (a.spec_nparams == nrd::kSfPrepassParams) {
    for (int k = 0; k < 4; ++k) a.f.hdp[k] = c[12 + k];
    a.f.use_prepass_not_only = c[16];
    a.f.frame_index = (uint32_t)c[17] | ((uint32_t)c[18] << 16);
  }
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  spatial_filter_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
