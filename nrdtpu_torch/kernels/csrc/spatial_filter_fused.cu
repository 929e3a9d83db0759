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
// The checkerboard PrePass (kCb, PrePass kernels only) gives each signal's centre the weight
// has_data, computed from (x, y), the frame index and the mode's parity (host integers); the
// glue's parameter planes already read the zeroed centre signal. Where a signal's weight sum is
// 0 the kernel writes reblur_filters.cuh's cb_neighbor_resolve of that signal, computing the
// centre's scaled viewZ, frustum size and nov as filter_geometry does, from the shared
// view-space normal (JAX does this as glue after K2, nrdtpu/passes/reblur/kernels.py:1977-1986).
// The SH variants (kSh, no checkerboard): each signal's SH1 rides its taps with each tap's final
// weight (reblur_filters.cuh:sf_filter; TPU reblur_fused.py:775-777, :804); the non-SH
// instances compile as before.
// The occlusion variants (kOcc, after kSh; Blur and PostBlur only: their path has no PrePass):
// each signal is the (h, w, 1) hit distance, one float a tap, written as one float a pixel (TPU
// reblur_fused.py:787 at c = 1); the glue's planes carry the occlusion rule of the min
// hit-distance weight. The four-channel instances compile as before.
// The RGBA normal encodings (kDec, the last template parameter, every mode above): nr is the
// plane that the frame decodes once (its normal .xyz, its roughness .w decoded), the tap
// geometry plane N5's kDec prologue wrote from it; the centres and the taps test no material
// (reblur_filters.cuh). The R10G10B10A2 instances compile as before.
#include "reblur_filters.cuh"

namespace {

using nrd::Image;
using nrd::SfMode;

constexpr int kSfCtas = 5;

struct SffArgs {
  const float* signal[2];    // (h, w, 4) diffuse, specular ((h, w, 1) with kOcc)
  const float* params[2];    // (kSfDiffParams, h, w), (kSfSpecParams | kSfPrepassParams, h, w)
  const float* view_z;       // (h, w) raw
  const float* nr;           // (h, w, 4)
  const float* shared;       // (kSfShared, h, w)
  const float4* geometry;    // (h, w) the taps' unpacked normal and scaled viewZ; null in PrePass
  float* out;                // (2, h, w, 4): diffuse, specular ((2, h, w, 1) with kOcc)
  float* hdt;                // (h, w) hitDistForTracking, PrePass only
  const float* sh[2];        // (h, w, 4) each signal's SH1 (kSh)
  float* out_sh;             // (2, h, w, 4) (kSh)
  float min_material[2];
  float min_rect_dim_mul_unproject;  // the checkerboard PrePass's fallback only
  nrd::CbConsts cb;
  nrd::SfFrame f;
};

// the centre's scaled viewZ, frustum size and nov of reblur_filters.cuh:filter_geometry, from
// the shared view-space normal: what the checkerboard fallback reads
__device__ __forceinline__ void cb_centre(const SffArgs& a, const nrd::Centre& c, float raw_z,
                                          float* z, float* fsz, float* nov) {
  *z = fabsf(raw_z) * a.f.view_z_scale;
  const nrd::V3 xv = nrd::reconstruct_view_position(c.u, c.v, a.f.fr, *z, a.f.ortho);
  nrd::V3 vv{0.0f, 0.0f, -1.0f};
  if (a.f.ortho == 0.0f) {
    const nrd::V3 m{-xv.x, -xv.y, -xv.z};
    const float inv = rsqrtf(fmaxf(nrd::dot3(m, m), (float)1e-15));
    vv = nrd::V3{m.x * inv, m.y * inv, m.z * inv};
  }
  *nov = fabsf(nrd::dot3(c.nv, vv));
  *fsz = a.min_rect_dim_mul_unproject * (*z + (1.0f - *z) * fabsf(a.f.ortho));
}

template <int kTaps, SfMode kSpecMode, bool kCb, bool kSh, bool kOcc, typename Taps>
__device__ __forceinline__ void filter_pixel(const SffArgs& a, const Taps& taps, int s, int x,
                                             int y) {
  const size_t i = (size_t)y * a.f.w + x;
  const size_t plane = (size_t)a.f.w * a.f.h;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const nrd::Centre c = nrd::sf_centre<Taps::kDecoded>(a.shared + i, plane, nr, x, y);
  const Image<float, 4> sig{a.signal[s], a.f.w, a.f.h};
  const float has_data = kCb ? nrd::cb_has_data(x, y, a.f.frame_index, a.cb.parity) : 1.0f;
  float out[4], sh_out[4];
  float sum;
  if (s == 0)
    sum = nrd::sf_filter<kTaps, SfMode::kDiffuse, kCb, kSh, kOcc>(
        a.f, c, a.params[0] + i, plane, a.min_material[0], sig, taps, out, nullptr, has_data,
        a.sh[0], sh_out);
  else
    sum = nrd::sf_filter<kTaps, kSpecMode, kCb, kSh, kOcc>(a.f, c, a.params[1] + i, plane,
                                                           a.min_material[1], sig, taps, out,
                                                           a.hdt + i, has_data, a.sh[1], sh_out);
  if constexpr (kCb) {
    if (sum == 0.0f) {
      float z, fsz, nov;
      cb_centre(a, c, __ldg(a.view_z + i), &z, &fsz, &nov);
      nrd::cb_neighbor_resolve(sig, taps, x, y, z, fsz, nov, a.cb.denoising_range, out);
    }
  }
  if constexpr (kOcc)
    a.out[s * plane + i] = out[3];
  else
    reinterpret_cast<float4*>(a.out)[s * plane + i] =
        make_float4(out[0], out[1], out[2], out[3]);
  if constexpr (kSh)
    reinterpret_cast<float4*>(a.out_sh)[s * plane + i] =
        make_float4(sh_out[0], sh_out[1], sh_out[2], sh_out[3]);
}

template <int kTaps, bool kPrepass, bool kSh, bool kOcc, bool kCb, bool kDec = false>
__global__ void __launch_bounds__(256, kSfCtas) spatial_filter_fused_kernel(SffArgs a) {
  static_assert(!kCb || kPrepass, "the checkerboard mode is the PrePass's");
  static_assert(!kOcc || (!kPrepass && !kSh), "the occlusion mode is Blur's and PostBlur's");
  const int s = (int)(blockIdx.x & 1u);
  const int x = (int)(blockIdx.x >> 1) * nrd::kBlock + (int)threadIdx.x;
  const int y = (int)blockIdx.y * nrd::kBlock + (int)threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  if constexpr (kPrepass)
    filter_pixel<kTaps, SfMode::kPrepass, kCb, kSh, false>(
        a,
        nrd::PackedTapsT<0, kDec>{nr, Image<float, 1>{a.view_z, a.f.w, a.f.h},
                                  a.f.view_z_scale},
        s, x, y);
  else
    filter_pixel<kTaps, SfMode::kSpec, false, kSh, kOcc>(
        a, nrd::UnpackedTapsT<0, kDec>{a.geometry, nr}, s, x, y);
}

using Kernel = void (*)(SffArgs);

template <int kTaps, bool kDec>
Kernel pick_mode(bool prepass, bool cb, bool sh, bool occ) {
  if (prepass && cb) return spatial_filter_fused_kernel<kTaps, true, false, false, true, kDec>;
  if (occ) return spatial_filter_fused_kernel<kTaps, false, false, true, false, kDec>;
  if (sh)
    return prepass ? spatial_filter_fused_kernel<kTaps, true, true, false, false, kDec>
                   : spatial_filter_fused_kernel<kTaps, false, true, false, false, kDec>;
  return prepass ? spatial_filter_fused_kernel<kTaps, true, false, false, false, kDec>
                 : spatial_filter_fused_kernel<kTaps, false, false, false, false, kDec>;
}

template <int kTaps>
Kernel pick(bool prepass, bool cb, bool sh, bool occ, bool dec) {
  return dec ? pick_mode<kTaps, true>(prepass, cb, sh, occ)
             : pick_mode<kTaps, false>(prepass, cb, sh, occ);
}

}  // namespace

// ptrs: diff, spec, view_z, nr, shared, diff_params, spec_params, geometry (null in PrePass
//       mode, required otherwise), out, hdt, diff_sh, spec_sh, out_sh (the last three SH only)
// consts: frustum[4], rect_w, rect_h, view_z_scale, ortho_mode, diff_min_material,
//         spec_min_material, ntaps (8 or 6), spec nparams, SH (0 or 1), one-channel occlusion
//         signals (0 or 1; Blur and PostBlur only, no SH), nr the RGBA formats' decoded plane
//         (0 or 1); in PrePass mode also hit-distance params[4], use_prepass_not_only, frame
//         index low 16 bits, high 16 bits, the checkerboard's has-data parity (-1: off),
//         denoising range, min_rect_dim_mul_unproject
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
  a.sh[0] = (const float*)p[10];
  a.sh[1] = (const float*)p[11];
  a.out_sh = (float*)p[12];
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
  const bool sh = c[12] != 0.0f;
  const bool occ = c[13] != 0.0f;
  const bool dec = c[14] != 0.0f;
  if (prepass != (a.geometry == nullptr) || (occ && (prepass || sh)) ||
      (sh && (a.sh[0] == nullptr || a.sh[1] == nullptr || a.out_sh == nullptr)))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) a.f.hdp[k] = 0.0f;
  a.f.use_prepass_not_only = 0.0f;
  a.f.frame_index = 0;
  a.cb = nrd::CbConsts{-1, 0.0f};
  a.min_rect_dim_mul_unproject = 0.0f;
  if (prepass) {
    for (int k = 0; k < 4; ++k) a.f.hdp[k] = c[15 + k];
    a.f.use_prepass_not_only = c[19];
    a.f.frame_index = (uint32_t)c[20] | ((uint32_t)c[21] << 16);
    a.cb = nrd::CbConsts{(int)c[22], c[23]};
    a.min_rect_dim_mul_unproject = c[24];
  }
  if (a.cb.parity > 1) return (int)cudaErrorInvalidValue;
  const bool cb = a.cb.parity >= 0;
  if (cb && sh) return (int)cudaErrorInvalidValue;
  const Kernel kernel =
      ntaps == 8 ? pick<8>(prepass, cb, sh, occ, dec) : pick<6>(prepass, cb, sh, occ, dec);
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 tiles((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const dim3 grid(2 * tiles.x, tiles.y);  // one CTA per (tile, signal)
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
