// K23: REBLUR HistoryFix + Blur + PostBlur of both signals in one entry, four launches.
// Replaces nrdtpu/kernels/reblur_band.py:496 reblur_spatial_band (its pallas_call at :614);
// computes what the port's three-launch chain computes (nrdtpu_torch/passes/reblur/
// kernels.py:spatial_chain), in three phases over one thread per (pixel, signal), after a
// prologue that unpacks each pixel's tap geometry once:
//   0. the normal and the scaled viewZ of every pixel (unpacked_geometry); writes geometry;
//   A. the history fix and its clamp, the body that N5 runs (reblur_filters.cuh:
//      history_fix_cta: hf_filter, the 3x3 and ring moments, hf_clamp); writes sig2 and fast2;
//   B. the BLUR parameters from sig2's hit distance (diff_blur_params, spec_blur_params), then
//      N4's tap loop (sf_filter) on sig2; writes sig3;
//   C. the same with the POST_BLUR constants on sig3; writes sig4.
// The plain version is nrdtpu_torch/kernels/reblur_band.py:reblur_band_ref.
//
// Design for the H100. A phase reads the previous phase's output at its taps, so each phase
// is its own launch on the caller's stream, in order: stream order is the barrier between
// them. One CTA per (16x16 tile, signal), the signal in the low bit of blockIdx.x so that the
// two CTAs of a tile run side by side and share the centre's planes in L2; the hardware
// schedules the CTAs, so the uneven history-fix tiles (stride-0 pixels skip the 20 taps)
// balance themselves. Each phase has its own register budget (kFixCtas, kBlurCtas: the CTAs
// an SM that ptxas is asked to fit), and a thread runs one signal, so the budget is the
// larger signal's and not the sum of both. A pixel's 36 taps a signal (20 + 8 + 8) each need
// the tapped texel's unpacked normal and viewZ, the same for every pixel that taps it: the
// prologue computes them once a pixel into a float4 plane, and the taps read it and nr as
// float4 records through the read-only path (reblur_filters.cuh:UnpackedTaps). Phase A
// (as N5) stages its signal's fast history over the tile and the ring's 4-pixel margin
// (24x24 floats, clamp-to-edge) in shared memory, where the 3x3 and the 72-tap ring read it.
// sig2, sig3 and the geometry stay in float32 scratch (the wrapper's), so every phase sees the
// plain version's float32 values.
// The SH variants (kSh; TPU reblur_band.py:512, :546, :631-634): each phase carries its
// signal's SH1 as N5's and N4's SH modes do (reblur_filters.cuh:hf_filter, sh_luma_scale,
// sf_filter), sh2 and sh3 in two more float32 scratch planes; the non-SH instances compile as
// before.
// The occlusion variants (kOcc; TPU `occlusion`, reblur_band.py:497, _blur_params :192): both
// signals are (h, w, 1) hit distances, one float a tap, in phases 1-3: N5's one-channel body,
// then H2's rule in the Blur / PostBlur parameters (the min hit-distance weight without its
// sqrt(nlas)); sig2, sig3 and the output are one float a pixel a signal. The four-channel
// instances compile as before.
// The RGBA normal encodings (kDec, the last template parameter, every phase): nr is the plane
// that the frame decodes once (its normal .xyz, its roughness .w decoded); phase 0 copies its
// normal, and the centres and the taps test no material (reblur_filters.cuh; TPU
// reblur_band.py:203, :299 with mat_occ=False). The R10G10B10A2 instances compile as before.
#include "reblur_filters.cuh"

namespace {

using nrd::Image;

constexpr int kTileX = nrd::kFixTile, kTileY = nrd::kFixTile, kThreads = kTileX * kTileY;
constexpr int kFixCtas = 5, kBlurCtas = 5;

// the frame's planes (reblur_band.py:PLANES): the history fix's shared planes, then these
enum BandPlane { BP_NOV = nrd::kHfShared, BP_ROUGH, BP_SMC, BP_HDS_DIFF, BP_HDS_SPEC,
                 kBandPlanes };

struct BandArgs {
  // phase 1's inputs and outputs: the TA outputs, the history-fix planes, the planes (as
  // `shared`), the tap geometry (scratch), sig2 (scratch) and fast2
  nrd::HistoryFixArgs fix;
  const float* planes;     // (kBandPlanes, h, w)
  float* sig3;             // (2, h, w, 4) scratch: Blur output ((2, h, w, 1) with kOcc)
  float* out;              // (2, h, w, 4) PostBlur output ((2, h, w, 1) with kOcc)
  float* sh3;              // (2, h, w, 4) scratch: the Blur's SH (kSh; sh2 is fix.sh_out)
  float* out_sh;           // (2, h, w, 4) the PostBlur's SH (kSh)
  nrd::SfFrame sf;
  nrd::BlurConsts blur;
  nrd::StageConsts stage[2];  // Blur, PostBlur
};

// the tile and the signal of this CTA
struct Cta {
  int s, x, y;
};

__device__ __forceinline__ Cta cta() {
  return Cta{(int)(blockIdx.x & 1u), (int)(blockIdx.x >> 1) * kTileX + (int)threadIdx.x,
             (int)blockIdx.y * kTileY + (int)threadIdx.y};
}

// Blur (stage 0: sig2 -> sig3) or PostBlur (stage 1: sig3 -> out) of one signal; kSh: its SH
// too (sh2 -> sh3, sh3 -> out_sh); kOcc: the one-channel signal
template <int kTaps, bool kSpec, bool kSh, bool kOcc, bool kDec>
__device__ __forceinline__ void blur_pixel(const BandArgs& a, int stage, int x, int y) {
  constexpr int s = kSpec ? 1 : 0;
  constexpr int kC = kOcc ? 1 : 4;  // the signal's channels, the hit distance the last
  const nrd::HistoryFixArgs& fx = a.fix;
  const int w = fx.f.w, h = fx.f.h;
  const size_t i = (size_t)y * w + x, plane = (size_t)w * h;
  const Image<float, 4> nr{fx.nr, w, h};
  const float* src = stage == 0 ? fx.out[s] : a.sig3 + kC * s * plane;
  float* dst = (stage == 0 ? a.sig3 : a.out) + kC * s * plane;
  const nrd::StageConsts& k = a.stage[stage];
  // the centre's geometry: sf_filter reads what hf_centre loads but the frustum size
  const nrd::Centre c = nrd::hf_centre<kDec>(fx.f, a.planes + i, plane, nr, x, y);
  const float* P = a.planes + i;
  const float nov = __ldg(P + BP_NOV * plane);
  const float hit_dist = __ldg(src + kC * i + (kC - 1));
  const float data1 = __ldg(fx.data1[s] + i);
  constexpr int nparams = kSpec ? nrd::kSfSpecParams : nrd::kSfDiffParams;
  constexpr nrd::SfMode mode = kSpec ? nrd::SfMode::kSpec : nrd::SfMode::kDiffuse;
  float prm[nparams];
  if constexpr (kSpec)
    nrd::spec_blur_params<kOcc>(a.blur, k, hit_dist, data1, __ldg(P + BP_HDS_SPEC * plane),
                                c.fsz, nov, __ldg(P + BP_ROUGH * plane),
                                __ldg(P + BP_SMC * plane), prm);
  else
    nrd::diff_blur_params<kOcc>(a.blur, k, hit_dist, data1, __ldg(P + BP_HDS_DIFF * plane),
                                c.fsz, nov, c.nv.x, c.nv.y, prm);
  float out[4], sh_out[4];
  const float* sh_src = stage == 0 ? fx.sh_out[s] : a.sh3 + 4 * s * plane;
  nrd::sf_filter<kTaps, mode, false, kSh, kOcc>(a.sf, c, prm, 1, fx.min_material[s],
                                                Image<float, 4>{src, w, h},
                                                nrd::UnpackedTapsT<0, kDec>{fx.geometry, nr}, out,
                                                nullptr, 1.0f, sh_src, sh_out);
  if constexpr (kOcc)
    dst[i] = out[3];
  else
    reinterpret_cast<float4*>(dst)[i] = make_float4(out[0], out[1], out[2], out[3]);
  if constexpr (kSh) {
    float* sh_dst = (stage == 0 ? a.sh3 : a.out_sh) + 4 * s * plane;
    reinterpret_cast<float4*>(sh_dst)[i] = make_float4(sh_out[0], sh_out[1], sh_out[2], sh_out[3]);
  }
}

// phase 0: the geometry; 1: the history fix and the clamp; 2: Blur; 3: PostBlur. kTaps: the
// Poisson taps of phases 2 and 3 (8, or 6 in performance mode); kOcc: the one-channel signals
template <int kPhase, int kTaps, bool kSh, bool kOcc = false, bool kDec = false>
__global__ void __launch_bounds__(kThreads, kPhase == 1 ? kFixCtas : kBlurCtas)
    reblur_band_kernel(BandArgs a) {
  const int w = a.fix.f.w, h = a.fix.f.h;
  if constexpr (kPhase == 0) {  // one thread a pixel
    const int x = blockIdx.x * kTileX + threadIdx.x, y = blockIdx.y * kTileY + threadIdx.y;
    if (x >= w || y >= h) return;
    nrd::write_tap_geometry<kDec>(const_cast<float4*>(a.fix.geometry), a.fix.nr, a.fix.view_z,
                                  a.fix.f.view_z_scale, (size_t)y * w + x);
  } else if constexpr (kPhase == 1) {
    nrd::history_fix_cta<nrd::kBothSignals, kSh, kOcc, false, kDec>(a.fix);
  } else {
    const Cta t = cta();
    if (t.x >= w || t.y >= h) return;
    if (t.s == 0)
      blur_pixel<kTaps, false, kSh, kOcc, kDec>(a, kPhase - 2, t.x, t.y);
    else
      blur_pixel<kTaps, true, kSh, kOcc, kDec>(a, kPhase - 2, t.x, t.y);
  }
}

using Kernel = void (*)(BandArgs);

// the four launches of one mode, in stream order
template <bool kSh, bool kOcc = false, bool kDec = false>
cudaError_t launch(const BandArgs& a, int ntaps, dim3 tiles, dim3 grid, dim3 block,
                   cudaStream_t st) {
  const Kernel blur = ntaps == 8 ? reblur_band_kernel<2, 8, kSh, kOcc, kDec>
                                 : reblur_band_kernel<2, 6, kSh, kOcc, kDec>;
  const Kernel post = ntaps == 8 ? reblur_band_kernel<3, 8, kSh, kOcc, kDec>
                                 : reblur_band_kernel<3, 6, kSh, kOcc, kDec>;
  reblur_band_kernel<0, 8, false, false, kDec><<<tiles, block, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reblur_band_kernel<1, 8, kSh, kOcc, kDec><<<grid, block, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blur<<<grid, block, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  post<<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ptrs: diff, spec, diff_data1, spec_data1, diff_fast, spec_fast, diff_params, spec_params,
//       view_z, nr, planes, scratch (sig2, sig3, geometry, and with SH sh2, sh3), fast2, out,
//       diff_sh, spec_sh, out_sh (the last three SH only)
// consts: frustum[4], rect_w, rect_h, rect_inv_w, rect_inv_h, view_z_scale, ortho_mode,
//         diff_min_material, spec_min_material, diffuse ring (0 or 1), specular ring (0 or 1),
//         ntaps (8 or 6), then reblur_band.py:band_consts: the clamp's frame divisor and
//         fast-history flag, the fade's a and b - a, max and min blur radius, lobe angle
//         fraction and 1 - it, encoding error, the Blur and PostBlur rotators, and per stage
//         (Blur, PostBlur) fraction scale, radius scale, min hit-distance weight scale, scaled
//         roughness fraction; then SH (0 or 1), one-channel occlusion signals (0 or 1; not with
//         SH: diff, spec, sig2, sig3 and out one float a pixel a signal), nr the RGBA formats'
//         decoded plane (0 or 1)
extern "C" int nrd_reblur_band(void* const* p, const float* c, int w, int h, void* stream) {
  BandArgs a;
  nrd::HistoryFixArgs& x = a.fix;
  const bool occ = c[41] != 0.0f;
  const size_t channels = occ ? 1 : 4;
  for (int s = 0; s < 2; ++s) {
    x.signal[s] = (const float*)p[s];
    x.data1[s] = (const float*)p[2 + s];
    x.fast[s] = (const float*)p[4 + s];
    x.params[s] = (const float*)p[6 + s];
  }
  x.view_z = (const float*)p[8];
  x.nr = (const float*)p[9];
  a.planes = (const float*)p[10];
  x.shared = a.planes;
  x.smc = a.planes + (size_t)BP_SMC * w * h;
  float* sig2 = (float*)p[11];
  a.sig3 = sig2 + (size_t)2 * w * h * channels;
  x.geometry = reinterpret_cast<const float4*>(a.sig3 + (size_t)2 * w * h * channels);
  for (int s = 0; s < 2; ++s) {
    x.out[s] = sig2 + (size_t)s * w * h * channels;
    x.fast_out[s] = (float*)p[12] + (size_t)s * w * h;
  }
  a.out = (float*)p[13];
  const bool sh = c[40] != 0.0f;
  float* sh2 = sig2 + (size_t)5 * w * h * 4;  // after sig2, sig3 and the geometry
  a.sh3 = sh2 + (size_t)2 * w * h * 4;
  a.out_sh = (float*)p[16];
  for (int s = 0; s < 2; ++s) {
    x.sh[s] = (const float*)p[14 + s];
    x.sh_out[s] = sh2 + (size_t)s * w * h * 4;
  }
  if ((sh && (x.sh[0] == nullptr || x.sh[1] == nullptr || a.out_sh == nullptr)) || (sh && occ))
    return (int)cudaErrorInvalidValue;

  x.f.w = a.sf.w = w;
  x.f.h = a.sf.h = h;
  x.f.row0 = a.sf.row0 = 0;  // a whole frame
  x.f.fh = a.sf.fh = h;
  for (int k = 0; k < 4; ++k) x.f.fr[k] = a.sf.fr[k] = c[k];
  a.sf.rect_w = c[4];
  a.sf.rect_h = c[5];
  a.sf.inv_rect_w = 1.0f / c[4];
  a.sf.inv_rect_h = 1.0f / c[5];
  x.f.rect_inv_w = a.blur.rect_inv_w = c[6];
  x.f.rect_inv_h = a.blur.rect_inv_h = c[7];
  x.f.view_z_scale = a.sf.view_z_scale = c[8];
  x.f.ortho = a.sf.ortho = c[9];
  x.min_material[0] = c[10];
  x.min_material[1] = c[11];
  x.anti_firefly[0] = c[12] != 0.0f;
  x.anti_firefly[1] = c[13] != 0.0f;
  const int ntaps = (int)c[14];
  if (ntaps != 8 && ntaps != 6) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) a.sf.hdp[k] = 0.0f;  // no PrePass mode here
  a.sf.use_prepass_not_only = 0.0f;
  a.sf.frame_index = 0;
  x.clamp.frame_div = c[15];
  x.clamp.fast_enabled = c[16];
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

  // the geometry one CTA per tile, then the phases one CTA per (tile, signal), in stream order
  const dim3 block(kTileX, kTileY);
  const dim3 tiles((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const dim3 grid(2 * tiles.x, tiles.y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (c[42] != 0.0f)  // the decoded plane
    return (int)(occ  ? launch<false, true, true>(a, ntaps, tiles, grid, block, st)
                 : sh ? launch<true, false, true>(a, ntaps, tiles, grid, block, st)
                      : launch<false, false, true>(a, ntaps, tiles, grid, block, st));
  return (int)(occ  ? launch<false, true>(a, ntaps, tiles, grid, block, st)
               : sh ? launch<true>(a, ntaps, tiles, grid, block, st)
                    : launch<false>(a, ntaps, tiles, grid, block, st));
}
