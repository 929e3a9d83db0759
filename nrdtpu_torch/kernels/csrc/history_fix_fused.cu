// N5: REBLUR history fix of both signals, the fast-history clamp included, in one entry.
// Replaces nrdtpu/kernels/reblur_fused.py:668 history_fix_fused_pallas (K3), which runs the
// clamp chain inside the kernel (:76-113 _hfix_post); computes what the two per-signal XLA
// calls of history_fix compute (nrdtpu/passes/reblur/kernels.py:546-552, :629-732): each
// signal's 20 stride taps at its own stride (diffuse or specular weights, its own min
// material), its 3x3 fast-history moments and, per signal on request, the anti-firefly ring,
// then the clamp. The plain version is nrdtpu_torch/kernels/history_fix_fused.py:
// history_fix_fused_ref (H3's plain version, the clamp included, per signal).
//
// Design for the H100: two stream-ordered launches.
//   0. one thread a pixel: each pixel's tap geometry (unpacked normal, scaled viewZ) into a
//      (h, w, 4) plane, which the taps here and the Blur and PostBlur launches of N4 read
//      (reblur_filters.cuh:UnpackedTaps) instead of unpacking a texel at every tap;
//   1. one CTA per (16x16 tile, signal): K23's phase-1 body, H3's for two signals
//      (reblur_filters.cuh:history_fix_cta), the fast history staged over the tile and the
//      ring's margin in shared memory, the taps, the clamp; it writes the clamped signal and
//      the fast history. No moment plane leaves the kernel.
// kFixCtas: the CTAs an SM that ptxas is asked to fit (5: 4 and 6 measured no faster, PERF.md).
// The SH variants (kSh): each signal's SH1 rides its taps and is scaled to its clamped luma
// (reblur_filters.cuh:hf_filter, sh_luma_scale; TPU reblur_fused.py:683, :721-722); the non-SH
// instance compiles as before.
// The occlusion variants (kOcc; TPU `occlusion`, reblur_fused.py:671, _hfix_post :76-108):
// both signals are (h, w, 1) hit distances, one float a tap, each clamped as its own luma with
// sigma scale 1 (reblur_filters.cuh:hf_clamp), written as one float a pixel; the four-channel
// instances compile as before.
// The RGBA normal encodings (kDec, the last template parameter, both phases): nr is the plane
// that the frame decodes once (its normal .xyz, its roughness .w decoded); the prologue copies
// its normal, and the centres and the taps test no material (reblur_filters.cuh). The
// R10G10B10A2 instances compile as before.
#include "reblur_filters.cuh"

namespace {

constexpr int kFixCtas = 5;

// phase 0: the tap geometry, one thread a pixel; 1: the history fix and the clamp
template <int kPhase, bool kSh, bool kOcc = false, bool kDec = false>
__global__ void __launch_bounds__(256, kPhase == 1 ? kFixCtas : 1)
    history_fix_fused_kernel(nrd::HistoryFixArgs a) {
  if constexpr (kPhase == 0) {
    const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
    const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
    if (x >= a.f.w || y >= a.f.h) return;
    nrd::write_tap_geometry<kDec>(const_cast<float4*>(a.geometry), a.nr, a.view_z,
                                  a.f.view_z_scale, (size_t)y * a.f.w + x);
  } else {
    nrd::history_fix_cta<nrd::kBothSignals, kSh, kOcc, false, kDec>(a);
  }
}

template <bool kDec>
cudaError_t launch(const nrd::HistoryFixArgs& x, bool sh, bool occ, dim3 tiles, dim3 block,
                   cudaStream_t st) {
  history_fix_fused_kernel<0, false, false, kDec><<<tiles, block, 0, st>>>(x);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * tiles.x, tiles.y);  // one CTA per (tile, signal)
  if (occ)
    history_fix_fused_kernel<1, false, true, kDec><<<grid, block, 0, st>>>(x);
  else if (sh)
    history_fix_fused_kernel<1, true, false, kDec><<<grid, block, 0, st>>>(x);
  else
    history_fix_fused_kernel<1, false, false, kDec><<<grid, block, 0, st>>>(x);
  return cudaGetLastError();
}

}  // namespace

// ptrs: diff, spec, diff_data1, spec_data1, diff_fast, spec_fast, diff_params, spec_params,
//       view_z, nr, shared, smc, out, fast, geometry, diff_sh, spec_sh, out_sh (the last three
//       SH only)
// consts: frustum[4], rect_inv_w, rect_inv_h, view_z_scale, ortho_mode, diff_min_material,
//         spec_min_material, diffuse anti-firefly ring (0 or 1), specular ring (0 or 1), the
//         clamp's frame divisor and fast-history flag, SH (0 or 1), one-channel occlusion
//         signals (0 or 1; not with SH: then diff, spec, out are (h, w, 1) a signal), nr the
//         RGBA formats' decoded plane (0 or 1)
extern "C" int nrd_history_fix_fused(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  nrd::HistoryFixArgs x;
  const bool occ = c[15] != 0.0f;
  const size_t channels = occ ? 1 : 4;
  for (int s = 0; s < 2; ++s) {
    x.signal[s] = (const float*)p[s];
    x.data1[s] = (const float*)p[2 + s];
    x.fast[s] = (const float*)p[4 + s];
    x.params[s] = (const float*)p[6 + s];
    x.out[s] = (float*)p[12] + (size_t)s * w * h * channels;
    x.fast_out[s] = (float*)p[13] + (size_t)s * w * h;
    x.sh[s] = (const float*)p[15 + s];
    x.sh_out[s] = p[17] == nullptr ? nullptr : (float*)p[17] + (size_t)s * w * h * 4;
  }
  const bool sh = c[14] != 0.0f;
  if ((sh && (x.sh[0] == nullptr || x.sh[1] == nullptr || p[17] == nullptr)) || (sh && occ))
    return (int)cudaErrorInvalidValue;
  x.view_z = (const float*)p[8];
  x.nr = (const float*)p[9];
  x.shared = (const float*)p[10];
  x.smc = (const float*)p[11];
  x.geometry = (const float4*)p[14];
  x.f.w = w;
  x.f.h = h;
  x.f.row0 = 0;  // a whole frame
  x.f.fh = h;
  for (int k = 0; k < 4; ++k) x.f.fr[k] = c[k];
  x.f.rect_inv_w = c[4];
  x.f.rect_inv_h = c[5];
  x.f.view_z_scale = c[6];
  x.f.ortho = c[7];
  x.min_material[0] = c[8];
  x.min_material[1] = c[9];
  x.anti_firefly[0] = c[10] != 0.0f;
  x.anti_firefly[1] = c[11] != 0.0f;
  x.clamp.frame_div = c[12];
  x.clamp.fast_enabled = c[13];
  const bool dec = c[16] != 0.0f;
  const dim3 block(nrd::kFixTile, nrd::kFixTile);
  const dim3 tiles((w + nrd::kFixTile - 1) / nrd::kFixTile,
                   (h + nrd::kFixTile - 1) / nrd::kFixTile);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dec ? launch<true>(x, sh, occ, tiles, block, st)
                   : launch<false>(x, sh, occ, tiles, block, st));
}
