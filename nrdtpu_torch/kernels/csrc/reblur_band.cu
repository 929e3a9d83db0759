// K23: REBLUR HistoryFix + Blur + PostBlur of both signals in one cooperative launch.
// Replaces nrdtpu/kernels/reblur_band.py:496 reblur_spatial_band (its pallas_call at :614);
// computes what the port's three-launch chain computes (nrdtpu_torch/passes/reblur/
// kernels.py:spatial_chain), in three phases over one thread per pixel:
//   A. N5's per-pixel body (hf_filter, the 3x3 and ring moments) for each signal, then the
//      clamp (hf_clamp); writes sig2 and fast2;
//   B. the BLUR parameters of each signal from sig2's hit distance (diff_blur_params,
//      spec_blur_params), then N4's tap loop (sf_filter) on sig2; writes sig3;
//   C. the same with the POST_BLUR constants on sig3; writes sig4.
// A phase reads the previous phase's output at its taps, so the grid is persistent (as many
// 16x16-thread CTAs as the card holds at once, each walking the 16x16 tiles) and the phases
// are separated by grid-wide barriers. The plain version is nrdtpu_torch/kernels/
// reblur_band.py:reblur_band_ref.
#include <cooperative_groups.h>

#include "reblur_filters.cuh"

namespace cg = cooperative_groups;

namespace {

using nrd::Image;

// the frame's planes (reblur_band.py:PLANES): the history fix's shared planes, then these
enum BandPlane { BP_NOV = nrd::kHfShared, BP_ROUGH, BP_SMC, BP_HDS_DIFF, BP_HDS_SPEC,
                 kBandPlanes };

struct BandArgs {
  const float* signal[2];  // (h, w, 4) TA outputs: diffuse, specular
  const float* data1[2];   // (h, w) accumulation speeds
  const float* fast[2];    // (h, w) fast histories
  const float* params[2];  // (kHfDiffParams | kHfSpecParams, h, w) history-fix planes
  const float* view_z;     // (h, w) raw
  const float* nr;         // (h, w, 4)
  const float* planes;     // (kBandPlanes, h, w)
  float* sig2;             // (2, h, w, 4) scratch: history-fix output
  float* sig3;             // (2, h, w, 4) scratch: Blur output
  float* fast2;            // (2, h, w) the history fix's fast histories
  float* out;              // (2, h, w, 4) PostBlur output
  float min_material[2];
  bool anti_firefly[2];
  nrd::HfFrame hf;
  nrd::SfFrame sf;
  nrd::HfClampConsts clamp;
  nrd::BlurConsts blur;
  nrd::StageConsts stage[2];  // Blur, PostBlur
  int tiles_x, tiles;
};

__device__ __forceinline__ void history_fix_pixel(const BandArgs& a, int x, int y) {
  const int w = a.hf.w, h = a.hf.h;
  const size_t i = (size_t)y * w + x, plane = (size_t)w * h;
  const Image<float, 4> nr{a.nr, w, h};
  const Image<float, 1> vz{a.view_z, w, h};
  const nrd::Centre c = nrd::hf_centre(a.planes + i, plane, nr, x, y);
#pragma unroll
  for (int s = 0; s < 2; ++s) {  // unrolled: s is constant, the arrays stay in registers
    const Image<float, 1> fast{a.fast[s], w, h};
    float m1, m2, am1 = 0.0f, am2 = 0.0f;
    nrd::fast_moments(fast, x, y, &m1, &m2);
    if (a.anti_firefly[s]) nrd::anti_firefly_moments(fast, x, y, &am1, &am2);
    float sig[4];
    nrd::hf_filter(a.hf, c, a.params[s] + i, plane, s == 1, a.min_material[s],
                   Image<float, 4>{a.signal[s], w, h}, Image<float, 1>{a.data1[s], w, h}, nr,
                   vz, sig);
    const float smc = s == 1 ? a.planes[BP_SMC * plane + i] : 0.0f;
    float fast_out;
    nrd::hf_clamp(a.clamp, sig, a.data1[s][i], a.fast[s][i], m1, m2, a.anti_firefly[s], am1,
                  am2, s == 1, smc, &fast_out);
    float* o = a.sig2 + 4 * (s * plane + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = sig[k];
    a.fast2[s * plane + i] = fast_out;
  }
}

// Blur (stage 0: sig2 -> sig3) or PostBlur (stage 1: sig3 -> out) of both signals
__device__ __forceinline__ void blur_pixel(const BandArgs& a, int stage, int x, int y) {
  const int w = a.hf.w, h = a.hf.h;
  const size_t i = (size_t)y * w + x, plane = (size_t)w * h;
  const Image<float, 4> nr{a.nr, w, h};
  const Image<float, 1> vz{a.view_z, w, h};
  const float* src = stage == 0 ? a.sig2 : a.sig3;
  float* dst = stage == 0 ? a.sig3 : a.out;
  const nrd::StageConsts& k = a.stage[stage];
  // the centre's geometry: sf_filter reads what hf_centre loads but the frustum size
  const nrd::Centre c = nrd::hf_centre(a.planes + i, plane, nr, x, y);
  const float* P = a.planes + i;
  const float nov = P[BP_NOV * plane];
  float out[4];
  {
    const float* sig = src + 4 * i;
    float prm[nrd::kSfDiffParams];
    nrd::diff_blur_params(a.blur, k, sig[3], a.data1[0][i], P[BP_HDS_DIFF * plane], c.fsz, nov,
                          c.nv.x, c.nv.y, prm);
    nrd::sf_filter(a.sf, c, prm, 1, nrd::kSfDiffParams, a.min_material[0],
                   Image<float, 4>{src, w, h}, nr, vz, out, nullptr);
    float* o = dst + 4 * i;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = out[q];
  }
  {
    const float* sig = src + 4 * (plane + i);
    float prm[nrd::kSfSpecParams];
    nrd::spec_blur_params(a.blur, k, sig[3], a.data1[1][i], P[BP_HDS_SPEC * plane], c.fsz, nov,
                          P[BP_ROUGH * plane], P[BP_SMC * plane], prm);
    nrd::sf_filter(a.sf, c, prm, 1, nrd::kSfSpecParams, a.min_material[1],
                   Image<float, 4>{src + 4 * plane, w, h}, nr, vz, out, nullptr);
    float* o = dst + 4 * (plane + i);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = out[q];
  }
}

// phase 0: history fix, 1: Blur, 2: PostBlur, of the pixel (x, y)
__device__ __forceinline__ void band_pixel(const BandArgs& a, int phase, int x, int y) {
  if (phase == 0)
    history_fix_pixel(a, x, y);
  else
    blur_pixel(a, phase - 1, x, y);
}

__global__ void __launch_bounds__(256) reblur_band_kernel(BandArgs a) {
  cg::grid_group grid = cg::this_grid();
  for (int phase = 0; phase < 3; ++phase) {
    if (phase > 0) grid.sync();  // every pixel of the previous phase is written
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int x = (t % a.tiles_x) * nrd::kBlock + threadIdx.x;
      const int y = (t / a.tiles_x) * nrd::kBlock + threadIdx.y;
      if (x < a.hf.w && y < a.hf.h) band_pixel(a, phase, x, y);
    }
  }
}

}  // namespace

// ptrs: diff, spec, diff_data1, spec_data1, diff_fast, spec_fast, diff_params, spec_params,
//       view_z, nr, planes, taps, scratch (sig2, sig3), fast2, out
// consts: frustum[4], rect_w, rect_h, rect_inv_w, rect_inv_h, view_z_scale, ortho_mode,
//         diff_min_material, spec_min_material, diffuse ring (0 or 1), specular ring (0 or 1),
//         ntaps, then reblur_band.py:band_consts: the clamp's frame divisor and fast-history
//         flag, the fade's a and b - a, max and min blur radius, lobe angle fraction and
//         1 - it, encoding error, the Blur and PostBlur rotators, and per stage (Blur,
//         PostBlur) fraction scale, radius scale, min hit-distance weight scale, scaled
//         roughness fraction
extern "C" int nrd_reblur_band(void* const* p, const float* c, int w, int h, void* stream) {
  BandArgs a;
  for (int s = 0; s < 2; ++s) {
    a.signal[s] = (const float*)p[s];
    a.data1[s] = (const float*)p[2 + s];
    a.fast[s] = (const float*)p[4 + s];
    a.params[s] = (const float*)p[6 + s];
  }
  a.view_z = (const float*)p[8];
  a.nr = (const float*)p[9];
  a.planes = (const float*)p[10];
  a.sf.taps = (const float*)p[11];
  a.sig2 = (float*)p[12];
  a.sig3 = a.sig2 + (size_t)2 * w * h * 4;
  a.fast2 = (float*)p[13];
  a.out = (float*)p[14];

  a.hf.w = a.sf.w = w;
  a.hf.h = a.sf.h = h;
  for (int k = 0; k < 4; ++k) a.hf.fr[k] = a.sf.fr[k] = c[k];
  a.sf.rect_w = c[4];
  a.sf.rect_h = c[5];
  a.hf.rect_inv_w = a.blur.rect_inv_w = c[6];
  a.hf.rect_inv_h = a.blur.rect_inv_h = c[7];
  a.hf.view_z_scale = a.sf.view_z_scale = c[8];
  a.hf.ortho = a.sf.ortho = c[9];
  a.min_material[0] = c[10];
  a.min_material[1] = c[11];
  a.anti_firefly[0] = c[12] != 0.0f;
  a.anti_firefly[1] = c[13] != 0.0f;
  a.sf.ntaps = (int)c[14];
  for (int k = 0; k < 4; ++k) a.sf.hdp[k] = 0.0f;  // no PrePass mode here
  a.sf.use_prepass_not_only = 0.0f;
  a.sf.frame_index = 0;
  a.clamp.frame_div = c[15];
  a.clamp.fast_enabled = c[16];
  a.blur.fade_a = c[17];
  a.blur.fade_ba = c[18];
  a.blur.max_blur_radius = c[19];
  a.blur.min_blur_radius = c[20];
  a.blur.laf = c[21];
  a.blur.one_minus_laf = c[22];
  a.blur.enc_err = c[23];
  for (int s = 0; s < 2; ++s) {
    for (int k = 0; k < 4; ++k) a.stage[s].rot[k] = c[24 + 4 * s + k];
    const float* sc = c + 32 + 4 * s;
    a.stage[s].fraction_scale = sc[0];
    a.stage[s].radius_scale = sc[1];
    a.stage[s].mhdw_scale = sc[2];
    a.stage[s].rf_scaled = sc[3];
  }
  a.tiles_x = (w + nrd::kBlock - 1) / nrd::kBlock;
  a.tiles = a.tiles_x * ((h + nrd::kBlock - 1) / nrd::kBlock);

  // the persistent grid: every CTA must be resident at once for the grid-wide barrier
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reblur_band_kernel,
                                                        nrd::kBlock * nrd::kBlock, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms < a.tiles ? per_sm * sms : a.tiles;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)reblur_band_kernel, dim3(grid),
                                    dim3(nrd::kBlock, nrd::kBlock), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
