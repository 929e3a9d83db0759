// H3: REBLUR history fix of one signal, diffuse or specular, the fast-history clamp included:
// the 20 stride taps (the specular mode adds the roughness weight and the low-roughness hitT
// guide), the 3x3 moments of the fast history and, on request, the anti-firefly ring (the 9x9
// square minus the 3x3), then the clamp. Replaces nrdtpu/kernels/reblur_hfix2.py:222
// history_fix_taps_pallas2 (ring: :209-212) and v1 nrdtpu/kernels/reblur_pallas.py:1446;
// computes nrdtpu/passes/reblur/kernels.py:546-552 and :629-732 per pixel. The plain version
// is nrdtpu_torch/kernels/history_fix.py:history_fix_ref.
//
// Design for the H100: the one-signal instance of N5's body, two stream-ordered launches.
//   0. one thread a pixel: each pixel's tap geometry (unpacked normal, scaled viewZ) into the
//      wrapper's (h, w, 4) scratch plane, which the taps read (reblur_filters.cuh:
//      UnpackedTaps) instead of unpacking a texel at every tap (2-5 % faster on frame 4 at
//      2560x1440 than PackedTaps without the prologue, PERF.md);
//   1. one CTA per 16x16 tile (reblur_filters.cuh:history_fix_cta<kSig>): the fast history
//      staged over the tile and the ring's margin in shared memory, the taps, the clamp; it
//      writes the clamped signal and the fast history, and no moment plane leaves the kernel.
// kFixCtas: the CTAs an SM that ptxas is asked to fit (4: 56 / 64 registers and no spill; 5
// spilled 32 / 76 B and ran 4 % slower on REBLUR_SPECULAR, PERF.md).
// The SH variants (kSh): the signal's SH1 rides the taps and is scaled to the clamped luma
// (reblur_filters.cuh:hf_filter, sh_luma_scale); the non-SH instances compile as before.
// The occlusion variants (kOcc): the signal is the (h, w, 1) hit distance, one float a tap, and
// the clamp takes it as the luma with sigma scale 1 and writes the clamped luma (reblur_filters.
// cuh:hf_clamp; TPU reblur_hfix2.py:229 at c = 1, the XLA clamp kernels.py:685-728 with
// occlusion); no ring (the occlusion variants force anti-firefly off). The four-channel
// instances compile as before.
// REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (kDir, diffuse only, one instance <1, 0, false, false,
// true>): the (h, w, 4) signal (direction x normalized hit distance, the hit distance) takes the
// radiance taps; the clamp takes .w as the luma with sigma scale 1 and its ChangeLuma scales
// .xyz by the luma change of .w and sets .w (reblur_filters.cuh:hf_clamp; the XLA clamp
// nrdtpu/passes/reblur/kernels.py:686-728 with directional; anti-firefly forced off). The other
// instances compile as before.
// The RGBA normal encodings (kDec, the last template parameter, every mode above and the
// prologue): nr is the plane that the frame decodes once (its normal .xyz, its roughness .w
// decoded), which the reference's centre and taps read decoded at these formats; the prologue
// copies its normal, and the centre and the taps test no material (reblur_filters.cuh). The
// R10G10B10A2 instances compile as before.
#include "reblur_filters.cuh"

namespace {

constexpr int kFixCtas = 4;

// phase 0: the tap geometry, one thread a pixel; 1: the history fix and the clamp of signal
// kSig
template <int kPhase, int kSig, bool kSh, bool kOcc = false, bool kDir = false, bool kDec = false>
__global__ void __launch_bounds__(256, kPhase == 1 ? kFixCtas : 1)
    history_fix_kernel(nrd::HistoryFixArgs a) {
  if constexpr (kPhase == 0) {
    const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
    const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
    if (x >= a.f.w || y >= a.f.h) return;
    nrd::write_tap_geometry<kDec>(const_cast<float4*>(a.geometry), a.nr, a.view_z,
                                  a.f.view_z_scale, (size_t)y * a.f.w + x);
  } else {
    nrd::history_fix_cta<kSig, kSh, kOcc, kDir, kDec>(a);
  }
}

// phase 1 of the signal's mode (kSig the slot: 0 diffuse, 1 specular)
template <bool kDec>
cudaError_t launch_fix(const nrd::HistoryFixArgs& a, int s, bool sh, bool occ, bool dir,
                       dim3 tiles, dim3 block, cudaStream_t st) {
  if (occ) {
    if (s == 0)
      history_fix_kernel<1, 0, false, true, false, kDec><<<tiles, block, 0, st>>>(a);
    else
      history_fix_kernel<1, 1, false, true, false, kDec><<<tiles, block, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (dir) {
    history_fix_kernel<1, 0, false, false, true, kDec><<<tiles, block, 0, st>>>(a);
    return cudaGetLastError();
  }
  switch (s * 2 + (sh ? 1 : 0)) {
    case 0: history_fix_kernel<1, 0, false, false, false, kDec><<<tiles, block, 0, st>>>(a); break;
    case 1: history_fix_kernel<1, 0, true, false, false, kDec><<<tiles, block, 0, st>>>(a); break;
    case 2: history_fix_kernel<1, 1, false, false, false, kDec><<<tiles, block, 0, st>>>(a); break;
    default: history_fix_kernel<1, 1, true, false, false, kDec><<<tiles, block, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

// ptrs: signal, view_z, nr, data1, fast, shared, params, smc (specular only), out, fast_out,
//       geometry (scratch), sh and sh_out (SH only)
// consts: frustum[4], rect_inv_w, rect_inv_h, view_z_scale, ortho_mode, min_material,
//         specular mode (0 or 1), anti-firefly ring (0 or 1), the clamp's frame divisor and
//         fast-history flag, SH (0 or 1), one-channel occlusion signal (0 or 1; not with SH),
//         directional occlusion (0 or 1; diffuse only, not with SH or one channel), nr the RGBA
//         formats' decoded plane (0 or 1)
extern "C" int nrd_history_fix(void* const* p, const float* c, int w, int h, void* stream) {
  const int s = c[9] != 0.0f ? 1 : 0;  // the signal's slot: 0 diffuse, 1 specular
  nrd::HistoryFixArgs a{};
  a.signal[s] = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.data1[s] = (const float*)p[3];
  a.fast[s] = (const float*)p[4];
  a.shared = (const float*)p[5];
  a.params[s] = (const float*)p[6];
  a.smc = (const float*)p[7];
  a.out[s] = (float*)p[8];
  a.fast_out[s] = (float*)p[9];
  a.geometry = (const float4*)p[10];
  a.sh[s] = (const float*)p[11];
  a.sh_out[s] = (float*)p[12];
  const bool sh = c[13] != 0.0f;
  a.f.w = w;
  a.f.h = h;
  for (int k = 0; k < 4; ++k) a.f.fr[k] = c[k];
  a.f.rect_inv_w = c[4];
  a.f.rect_inv_h = c[5];
  a.f.view_z_scale = c[6];
  a.f.ortho = c[7];
  a.min_material[s] = c[8];
  a.anti_firefly[s] = c[10] != 0.0f;
  a.clamp.frame_div = c[11];
  a.clamp.fast_enabled = c[12];
  const bool occ = c[14] != 0.0f;
  const bool dir = c[15] != 0.0f;
  if ((s == 1 && a.smc == nullptr) || (sh && (a.sh[s] == nullptr || a.sh_out[s] == nullptr)) ||
      (sh && occ) || (dir && (s != 0 || sh || occ)))
    return (int)cudaErrorInvalidValue;
  const bool dec = c[16] != 0.0f;
  const dim3 block(nrd::kFixTile, nrd::kFixTile);
  const dim3 tiles((w + nrd::kFixTile - 1) / nrd::kFixTile,
                   (h + nrd::kFixTile - 1) / nrd::kFixTile);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dec)
    history_fix_kernel<0, 0, false, false, false, true><<<tiles, block, 0, st>>>(a);
  else
    history_fix_kernel<0, 0, false><<<tiles, block, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(dec ? launch_fix<true>(a, s, sh, occ, dir, tiles, block, st)
                   : launch_fix<false>(a, s, sh, occ, dir, tiles, block, st));
}
