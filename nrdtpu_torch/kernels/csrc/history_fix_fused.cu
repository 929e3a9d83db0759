// N5: REBLUR history fix of both signals, the fast-history clamp included, in one entry.
// Replaces nrdtpu/kernels/reblur_fused.py:668 history_fix_fused_pallas (K3), which runs the
// clamp chain inside the kernel (:76-113 _hfix_post); computes what the two per-signal XLA
// calls of history_fix compute (nrdtpu/passes/reblur/kernels.py:546-552, :629-732): each
// signal's 20 stride taps at its own stride (diffuse or specular weights, its own min
// material), its 3x3 fast-history moments and, per signal on request, the anti-firefly ring,
// then the clamp. The plain version is nrdtpu_torch/kernels/history_fix_fused.py:
// history_fix_fused_ref (H3's plain version, then params.history_fix_clamp, per signal).
//
// Design for the H100: two stream-ordered launches.
//   0. one thread a pixel: each pixel's tap geometry (unpacked normal, scaled viewZ) into a
//      (h, w, 4) plane, which the taps here and the Blur and PostBlur launches of N4 read
//      (reblur_filters.cuh:UnpackedTaps) instead of unpacking a texel at every tap;
//   1. one CTA per (16x16 tile, signal): K23's phase-1 body (reblur_filters.cuh:
//      history_fix_cta), the fast history staged over the tile and the ring's margin in shared
//      memory, the taps, the clamp; it writes the clamped signal and the fast history. No
//      moment plane leaves the kernel.
// kFixCtas: the CTAs an SM that ptxas is asked to fit (5: 4 and 6 measured no faster, PERF.md).
#include "reblur_filters.cuh"

namespace {

constexpr int kFixCtas = 5;

struct HffArgs {
  nrd::HistoryFixArgs fix;
  const float* view_z;  // (h, w) raw
};

// phase 0: the tap geometry, one thread a pixel; 1: the history fix and the clamp
template <int kPhase>
__global__ void __launch_bounds__(256, kPhase == 1 ? kFixCtas : 1)
    history_fix_fused_kernel(HffArgs a) {
  if constexpr (kPhase == 0) {
    const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
    const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
    if (x >= a.fix.f.w || y >= a.fix.f.h) return;
    nrd::write_tap_geometry(const_cast<float4*>(a.fix.geometry), a.fix.nr, a.view_z,
                            a.fix.f.view_z_scale, (size_t)y * a.fix.f.w + x);
  } else {
    nrd::history_fix_cta(a.fix);
  }
}

}  // namespace

// ptrs: diff, spec, diff_data1, spec_data1, diff_fast, spec_fast, diff_params, spec_params,
//       view_z, nr, shared, smc, out, fast, geometry
// consts: frustum[4], rect_inv_w, rect_inv_h, view_z_scale, ortho_mode, diff_min_material,
//         spec_min_material, diffuse anti-firefly ring (0 or 1), specular ring (0 or 1), the
//         clamp's frame divisor and fast-history flag
extern "C" int nrd_history_fix_fused(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  HffArgs a;
  nrd::HistoryFixArgs& x = a.fix;
  for (int s = 0; s < 2; ++s) {
    x.signal[s] = (const float*)p[s];
    x.data1[s] = (const float*)p[2 + s];
    x.fast[s] = (const float*)p[4 + s];
    x.params[s] = (const float*)p[6 + s];
  }
  a.view_z = (const float*)p[8];
  x.nr = (const float*)p[9];
  x.shared = (const float*)p[10];
  x.smc = (const float*)p[11];
  x.out = (float*)p[12];
  x.fast_out = (float*)p[13];
  x.geometry = (const float4*)p[14];
  x.f.w = w;
  x.f.h = h;
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
  const dim3 block(nrd::kFixTile, nrd::kFixTile);
  const dim3 tiles((w + nrd::kFixTile - 1) / nrd::kFixTile,
                   (h + nrd::kFixTile - 1) / nrd::kFixTile);
  history_fix_fused_kernel<0><<<tiles, block, 0, (cudaStream_t)stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2 * tiles.x, tiles.y);  // one CTA per (tile, signal)
  history_fix_fused_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
