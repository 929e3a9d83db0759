// Per-signal device functions of the REBLUR spatial filter and history fix. H2
// (spatial_filter.cu) calls them for its one signal; N4 (spatial_filter_fused.cu), N5
// (history_fix_fused.cu) and K23 (reblur_band.cu) run one CTA per (tile, signal) and call them
// for the CTA's signal, and H3 (history_fix.cu) runs the same CTA body for its one signal.
// The plain versions they are held against are
// nrdtpu_torch/kernels/spatial_filter.py:spatial_filter_ref and
// nrdtpu_torch/kernels/history_fix.py:history_fix_ref; the op order below is theirs. A tap
// reads the signal as one float4 through the read-only path, its index clamped once (every
// image they tap is an input of the launch, never its output), and its geometry through a
// Taps policy: PackedTaps (H2, the PrePass of N4) or UnpackedTaps (H3, N5, N4's Blur and
// PostBlur, K23), whose plane the entry of H3, N5 or K23 writes once a call.
//
// Fewer instructions a tap (chosen by A/B timing on the H100, PERF.md): the tap loops stay
// rolled (unrolled, their code outgrew the instruction cache and ran slower); the Poisson table
// is a compile-time table in constant memory, not a device array; a tap's signal is loaded
// before its weight chain and dropped where the weight is zero, so the load overlaps the
// arithmetic. Three divisions by a constant of the pixel or the frame are multiplications by
// its reciprocal: the history fix's hit distance over the frustum size and its hitT-guide
// smoothstep, and the spatial filter's snap to the pixel centre. They may differ from the
// plain version's division in the last bit (measured: no value of frame 4 at 2560x1440 moves
// outside the tolerance that chip_smoke.py holds, PERF.md); every other step is the plain
// version's float32 op, in its order.
//
// The occlusion variants (kOcc, a template parameter of the tap loops, the clamp and the
// Blur / PostBlur parameters) filter one channel, the (h, w, 1) normalized hit distance: a
// tap reads it as one float into the .w lane of the radiance code's float4 (signal_texel), the
// lane that every weight reads as the hit distance, so the loops run the radiance code
// unchanged and the sums of .xyz, zeros that no output reads, are dead code. The callers then
// write .w alone. The four-channel instances compile as before.
//
// The RGBA normal encodings (kDec, a template parameter of the Taps policies, the centres and
// the geometry): every plane a kernel reads is the one that the frame decodes once
// (frontend.py:decode_normal_plane, its roughness decoded as well): the normal .xyz as it is,
// the roughness .w, the material 0 (common.cuh:unpack_nr). The formats carry no material, so
// the tap loops' material tests are compiled out (the TPU kernels' mat_occ=False; with the
// material 0 everywhere every such test passes). The R10G10B10A2 instances compile as before.
#pragma once

#include "common.cuh"

namespace nrd {

// What a tap reads of its texel's geometry: the unpacked normal, material (nr.w x 3),
// roughness and the scaled viewZ.
struct TapGeometry {
  V3 n;
  float material, roughness, z;
};

// from the frame's packed planes, unpacked at every tap: nr (h, w, 4) and raw viewZ, read a
// channel at a time (H2, N4 and N5 measured no faster with one float4 on the H100: PERF.md).
// kRough: the roughness encoding of nr (common.cuh:decode_roughness), decoded at the tap; H2's
// specular instances at SQRT_LINEAR / SQ_LINEAR take the packed plane, whose centre the
// reference reads as packed and whose taps it decodes (nrdtpu/passes/reblur/kernels.py:37-42,
// :1716); every other reader gets a plane decoded once a frame, at kRough 0. kDec: the
// decoded plane of the RGBA formats (its normal .xyz, roughness .w, no material), at kRough 0.
template <int kRough = 0, bool kDec = false>
struct PackedTapsT {
  static_assert(!(kDec && kRough != 0), "the decoded plane's roughness is decoded");
  static constexpr bool kDecoded = kDec;
  Image<float, 4> nr;
  Image<float, 1> vz;
  float view_z_scale;
  __device__ __forceinline__ TapGeometry at(int x, int y) const {
    if constexpr (kDec)
      return TapGeometry{V3{nr.at(x, y, 0), nr.at(x, y, 1), nr.at(x, y, 2)}, 0.0f,
                         nr.at(x, y, 3), fabsf(vz.at(x, y, 0)) * view_z_scale};
    return TapGeometry{unpack_normal(nr.at(x, y, 0), nr.at(x, y, 1)), nr.at(x, y, 3) * 3.0f,
                       decode_roughness<kRough>(nr.at(x, y, 2)),
                       fabsf(vz.at(x, y, 0)) * view_z_scale};
  }
  __device__ __forceinline__ float view_z(int x, int y) const {
    return fabsf(vz.at(x, y, 0)) * view_z_scale;
  }
};

using PackedTaps = PackedTapsT<0>;

// from a (h, w, 4) plane unpacked once a frame, (n.x, n.y, n.z, scaled viewZ), and nr for the
// material and the roughness: the same values as PackedTaps; kRough and kDec as for
// PackedTapsT (kDec: the roughness .w, no material)
template <int kRough = 0, bool kDec = false>
struct UnpackedTapsT {
  static_assert(!(kDec && kRough != 0), "the decoded plane's roughness is decoded");
  static constexpr bool kDecoded = kDec;
  const float4* geometry;
  Image<float, 4> nr;
  __device__ __forceinline__ TapGeometry at(int x, int y) const {
    const size_t k = nr.index(x, y);
    const float4 g = __ldg(geometry + k);
    if constexpr (kDec) return TapGeometry{V3{g.x, g.y, g.z}, 0.0f, __ldg(nr.p + 4 * k + 3), g.w};
    const float4 p = __ldg(reinterpret_cast<const float4*>(nr.p) + k);
    return TapGeometry{V3{g.x, g.y, g.z}, p.w * 3.0f, decode_roughness<kRough>(p.z), g.w};
  }
};
using UnpackedTaps = UnpackedTapsT<0>;

// the (n.x, n.y, n.z, scaled viewZ) record of UnpackedTaps, as PackedTaps computes it (kDec:
// the decoded plane's normal as it is)
template <bool kDec = false>
__device__ __forceinline__ float4 unpacked_geometry(float4 nr, float raw_z, float view_z_scale) {
  const V3 n = kDec ? V3{nr.x, nr.y, nr.z} : unpack_normal(nr.x, nr.y);
  return make_float4(n.x, n.y, n.z, fabsf(raw_z) * view_z_scale);
}

// A signal's texel through the read-only path: the (h, w, 4) record as one float4, or with kOcc
// the (h, w, 1) hit distance as one float, in .w (the index is sig's pixel index either way)
template <bool kOcc>
__device__ __forceinline__ float4 signal_texel(const Image<float, 4>& sig, int x, int y) {
  if constexpr (kOcc)
    return make_float4(0.0f, 0.0f, 0.0f, __ldg(sig.p + sig.index(x, y)));
  else
    return sig.at4(x, y);
}

// the record of pixel i, written by the prologue of H3, N5 and K23 (one thread a pixel)
template <bool kDec = false>
__device__ __forceinline__ void write_tap_geometry(float4* geometry, const float* nr,
                                                   const float* view_z, float view_z_scale,
                                                   size_t i) {
  geometry[i] = unpacked_geometry<kDec>(__ldg(reinterpret_cast<const float4*>(nr) + i),
                                        __ldg(view_z + i), view_z_scale);
}

// ---------------------------------------------------------------------------------------
// Spatial filter (PrePass, Blur, PostBlur): nrdtpu/passes/reblur/kernels.py:844-873,
// :2164-2189 (diffuse) and :1710-1756 (specular, with the PrePass hitDistForTracking)
// ---------------------------------------------------------------------------------------

// planes shared by the signals of a pixel (spatial_filter.py:SHARED)
enum SfShared { SF_GA, SF_GB, SF_NX, SF_NY, SF_NZ, SF_NVX, SF_NVY, SF_NVZ, kSfShared };
// planes of one signal (spatial_filter.py:PARAMS, SPEC_PARAMS, PREPASS_PARAMS)
enum SfParam { SF_ROT0, SF_ROT1, SF_ROT2, SF_ROT3, SF_NWP, SF_HA, SF_HB, SF_MHDW,
               SF_WR_A, SF_WR_B,                                  // specular
               SF_HIT_DIST, SF_ROUGH, SF_XVX, SF_XVY, SF_XVZ };   // specular PrePass
constexpr int kSfDiffParams = 8, kSfSpecParams = 10, kSfPrepassParams = 15;

// the three modes of the tap loop, by their plane count
enum class SfMode { kDiffuse, kSpec, kPrepass };

struct PoissonTap {
  float ox, oy, gauss;
};

// The Poisson taps (spatial_filter.py:tap_table): offset x, offset y and the Gaussian weight
// of the tap radius, float32 as the host computes them; 8 taps (SPECIAL_8), 6 in performance
// mode (SPECIAL_6). tests/test_torch_kernel_rehearsal.py holds these literals to tap_table.
namespace {
__constant__ float kPoissonTaps8[8 * 3] = {
    -1.0f, 0.0f, 0x1.08a0bcp-1f,  0.0f, 1.0f, 0x1.08a0bcp-1f,
    1.0f, 0.0f, 0x1.08a0bcp-1f,   0.0f, -1.0f, 0x1.08a0bcp-1f,
    -0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.b21f2p-1f,
    0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.b21f2p-1f,
    0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.b21f2p-1f,
    -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.b21f2p-1f};
__constant__ float kPoissonTaps6[6 * 3] = {
    -0x1.bb67aep-1f, -0.5f, 0x1.08a0bcp-1f,  0.0f, 1.0f, 0x1.08a0bcp-1f,
    0x1.bb67aep-1f, -0.5f, 0x1.08a0bcp-1f,   0.0f, -0x1.333334p-2f, 0x1.e2790cp-1f,
    0x1.0a0b02p-2f, 0x1.333334p-3f, 0x1.e2790cp-1f,
    -0x1.0a0b02p-2f, 0x1.333334p-3f, 0x1.e2790cp-1f};
}  // namespace

template <int kTaps>
__device__ __forceinline__ PoissonTap poisson_tap(int t) {
  static_assert(kTaps == 8 || kTaps == 6, "8 taps, or 6 in performance mode");
  const float* p = kTaps == 8 ? kPoissonTaps8 : kPoissonTaps6;
  return PoissonTap{p[3 * t], p[3 * t + 1], p[3 * t + 2]};
}

struct SfFrame {
  int w, h;
  float fr[4];
  float rect_w, rect_h, view_z_scale, ortho;
  float inv_rect_w, inv_rect_h;  // 1 / rect_w, 1 / rect_h
  float hdp[4];       // hit-distance parameters A, B, C, D (specular PrePass)
  float use_prepass_not_only;
  uint32_t frame_index;
};

struct Centre {
  int x, y;
  float u, v, material;
  float ga, gb, fsz;  // fsz: history fix only
  V3 n, nv;
};

// the centre pixel's geometry from the shared planes; P points at the pixel in plane 0 (kDec:
// the decoded plane, no material)
template <bool kDec = false>
__device__ __forceinline__ Centre sf_centre(const float* P, size_t plane,
                                            const Image<float, 4>& nr, int x, int y) {
  Centre c;
  c.x = x;
  c.y = y;
  c.u = pixel_u(x, nr.w);
  c.v = pixel_u(y, nr.h);
  c.material = kDec ? 0.0f : nr.at(x, y, 3) * 3.0f;
  c.ga = P[SF_GA * plane];
  c.gb = P[SF_GB * plane];
  c.fsz = 0.0f;
  c.n = V3{P[SF_NX * plane], P[SF_NY * plane], P[SF_NZ * plane]};
  c.nv = V3{P[SF_NVX * plane], P[SF_NVY * plane], P[SF_NVZ * plane]};
  return c;
}

// One signal's tap loop over kTaps Poisson taps. P points at the pixel in the signal's
// (nparams, h, w) planes, whose count is the mode's: diffuse, specular (roughness weight) or
// specular PrePass (also the stochastic minimum of the taps' hit distances,
// hitDistForTracking, written to *hdt_out, with one PCG draw per tap from hash_init(pixel,
// frame index), dead taps included). kCb, the checkerboard PrePass: the centre weighs
// centre_weight (1 where the pixel has data, else 0) in the sum and in the accumulator; the
// taps read the expanded signal. kSh, the SH variants: the signal's SH1 (sh, (h, w, 4)) rides
// the taps, each tap's SH weighed by the tap's final weight and the centre by 1; the diffuse
// mode sums all four channels, the specular modes three and keep the centre's .w
// (nrdtpu/passes/reblur/kernels.py:870-877, :1751-1761, :2186-2193); written to sh_out. kOcc:
// the one-channel signal (signal_texel), its result in out[3]. Returns the weight sum.
template <int kTaps, SfMode kMode, bool kCb = false, bool kSh = false, bool kOcc = false,
          typename Taps>
__device__ __forceinline__ float sf_filter(const SfFrame& f, const Centre& c, const float* P,
                                           size_t plane, float min_material,
                                           const Image<float, 4>& sig, const Taps& taps,
                                           float out[4], float* hdt_out,
                                           float centre_weight = 1.0f,
                                           const float* sh = nullptr, float* sh_out = nullptr) {
  static_assert(!(kCb && kSh), "the checkerboard PrePass takes no SH");
  static_assert(!(kOcc && (kCb || kSh || kMode == SfMode::kPrepass)),
                "the occlusion variants run Blur and PostBlur only, without SH");
  constexpr bool spec = kMode != SfMode::kDiffuse, prepass = kMode == SfMode::kPrepass;
  const float r0 = P[SF_ROT0 * plane], r1 = P[SF_ROT1 * plane], r2 = P[SF_ROT2 * plane],
              r3 = P[SF_ROT3 * plane];
  const float nwp = P[SF_NWP * plane], ha = P[SF_HA * plane], hb = P[SF_HB * plane];
  const float mhdw = P[SF_MHDW * plane];
  const float mat_c = fmaxf(c.material, min_material);
  const float wr_a = spec ? P[SF_WR_A * plane] : 0.0f, wr_b = spec ? P[SF_WR_B * plane] : 0.0f;
  float hit_dist = 0.0f, rough_lerp = 0.0f, hdt = 0.0f;
  V3 xv{0.0f, 0.0f, 0.0f};
  uint32_t rng = 0;
  if constexpr (prepass) {
    hit_dist = P[SF_HIT_DIST * plane];
    rough_lerp = saturate((P[SF_ROUGH * plane] - 0.5f) / 0.5f);
    xv = V3{P[SF_XVX * plane], P[SF_XVY * plane], P[SF_XVZ * plane]};
    hdt = hit_dist == 0.0f ? 1e6f : hit_dist;  // NRD_INF
    rng = hash_init((uint32_t)c.x, (uint32_t)c.y, f.frame_index);
  }

  float sum = kCb ? centre_weight : 1.0f;
  const float4 cs = signal_texel<kOcc>(sig, c.x, c.y);
  float acc[4] = {cs.x, cs.y, cs.z, cs.w};
  if constexpr (kCb) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = acc[k] * centre_weight;
  }
  const Image<float, 4> shi{sh, sig.w, sig.h};
  float sacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kSh) {
    const float4 cs4 = shi.at4(c.x, c.y);
    sacc[0] = cs4.x;
    sacc[1] = cs4.y;
    sacc[2] = cs4.z;
    sacc[3] = cs4.w;
  }

#pragma unroll 1
  for (int t = 0; t < kTaps; ++t) {
    const PoissonTap tap = poisson_tap<kTaps>(t);
    float us = c.u + (tap.ox * r0 + tap.oy * r2);
    float vs = c.v + (tap.ox * r1 + tap.oy * r3);
    us = (floorf(us * f.rect_w) + 0.5f) * f.inv_rect_w;  // snap to the pixel centre
    vs = (floorf(vs * f.rect_h) + 0.5f) * f.inv_rect_h;
    const int sx = to_index(floorf(us * (float)f.w));
    const int sy = to_index(floorf(vs * (float)f.h));

    const TapGeometry g = taps.at(sx, sy);
    const float zs = g.z;
    const V3 xvs = reconstruct_view_position(us, vs, f.fr, zs, f.ortho);
    const float4 s_tap = signal_texel<kOcc>(sig, sx, sy);  // issued before the weights, used
                                                           // where w_ != 0
    float4 sh_tap = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kSh) sh_tap = shi.at4(sx, sy);
    float w_ = in_screen_nearest(us, vs);
    w_ = w_ * compute_weight(dot3(c.nv, xvs), c.ga, c.gb);
    if constexpr (!Taps::kDecoded)  // the RGBA formats carry no material
      w_ = w_ * (mat_c == fmaxf(g.material, min_material) ? 1.0f : 0.0f);
    float rnd = 0.0f;
    if constexpr (prepass) rnd = hash_float(rng);  // one draw a tap, as the XLA loop draws
    const float angle = acos_approx(dot3(c.n, g.n));
    w_ = w_ * compute_weight(angle, nwp, 0.0f);
    if constexpr (spec) w_ = w_ * compute_weight(g.roughness, wr_a, wr_b);
    const float4 s4 = w_ != 0.0f ? s_tap : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    if constexpr (prepass) {
      // stochastic hitDistForTracking minimum (REBLUR_PrePass.hlsli)
      const float rs = g.roughness;
      const float norm = (f.hdp[0] + fabsf(zs) * f.hdp[1]) *
                         (1.0f + (f.hdp[2] - 1.0f) * saturate(exp2f(f.hdp[3] * rs * rs)));
      const float hs = s[3] * norm;
      const float dx = xvs.x - xv.x, dy = xvs.y - xv.y, dz = xvs.z - xv.z;
      const float d = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 0.0f)) + 1e-6f;
      const float geometry_weight = w_ * saturate(hs / d);
      if (rnd < geometry_weight && hs > 0.0f) hdt = fminf(hdt, hs);
      w_ = w_ * f.use_prepass_not_only;
      const float tt = saturate(hs / (d + hit_dist));
      w_ = w_ * (tt + (1.0f - tt) * rough_lerp);
    }
    const float e = compute_exponential_weight(s[3], ha, hb);
    w_ = w_ * (mhdw + (1.0f - mhdw) * e);
    w_ = w_ * tap.gauss;
    sum = sum + w_;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = acc[k] + s[k] * w_;
    if constexpr (kSh) {  // the SH where the final weight is non-zero, as the XLA loop selects
      const float4 h4 = w_ != 0.0f ? sh_tap : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      sacc[0] = sacc[0] + h4.x * w_;
      sacc[1] = sacc[1] + h4.y * w_;
      sacc[2] = sacc[2] + h4.z * w_;
      if constexpr (!spec) sacc[3] = sacc[3] + h4.w * w_;
    }
  }
  const float inv = 1.0f / fmaxf(sum, 1e-15f);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = acc[k] * inv;
  if constexpr (kSh) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sh_out[k] = sacc[k] * inv;
    sh_out[3] = spec ? sacc[3] : sacc[3] * inv;  // specular: the centre's .w
  }
  if constexpr (prepass) *hdt_out = hdt == 1e6f ? 0.0f : hdt;
  return sum;
}

// ---------------------------------------------------------------------------------------
// Checkerboard PrePass (REBLUR_PrePass.hlsli:45-78; nrdtpu/passes/reblur/kernels.py:743-762,
// :1607-1608, :2100-2128): the signal arrives expanded from half width; a pixel has data
// where (x + y + frame index) & 1 is the mode's parity (Sequence::CheckerBoard). Its centre
// weighs has_data, and where no weight is left the pass writes the horizontal neighbour
// resolve below. Only the cb instances of H2 and N4 reach this code.
// ---------------------------------------------------------------------------------------

struct CbConsts {
  int parity;             // has-data value of the checkerboard: int(mode) - 1
  float denoising_range;
};

__device__ __forceinline__ float cb_has_data(int x, int y, uint32_t frame_index, int parity) {
  return (int)(((uint32_t)x + (uint32_t)y + frame_index) & 1u) == parity ? 1.0f : 0.0f;
}

// cb_neighbor_resolve: the expanded signal at x - 1 and x + 1, each weighed 1 where its scaled
// viewZ lies within the disocclusion threshold of the centre's (z, frustum size fsz, nov), 0
// beyond the denoising range or off the image's edge columns, normalized by the weights' sum
// (0 where both are 0). vz: any view with view_z(x, y), the scaled viewZ of a texel.
template <typename Vz>
__device__ __forceinline__ void cb_neighbor_resolve(const Image<float, 4>& sig, const Vz& vz,
                                                    int x, int y, float z, float fsz,
                                                    float nov, float denoising_range,
                                                    float out[4]) {
  const float thr = fsz * saturate((float)0.02 / fmaxf(nov, (float)0.01));
  const float z0 = vz.view_z(x - 1, y), z1 = vz.view_z(x + 1, y);
  float w0 = fabsf(z0 - z) <= thr ? 1.0f : 0.0f;
  float w1 = fabsf(z1 - z) <= thr ? 1.0f : 0.0f;
  if (z0 > denoising_range || x < 1) w0 = 0.0f;
  if (z1 > denoising_range || x >= sig.w - 1) w1 = 0.0f;
  const float wsum = w0 + w1;
  const float inv = wsum == 0.0f ? 0.0f : 1.0f / fmaxf(wsum, (float)1e-15);
  const float a = w0 * inv, b = w1 * inv;
  const float4 s0 = sig.at4(x - 1, y), s1 = sig.at4(x + 1, y);
  out[0] = s0.x * a + s1.x * b;
  out[1] = s0.y * a + s1.y * b;
  out[2] = s0.z * a + s1.z * b;
  out[3] = s0.w * a + s1.w * b;
}

// ---------------------------------------------------------------------------------------
// History fix: nrdtpu/passes/reblur/kernels.py:629-683 (stride taps), :693-700 (3x3
// moments of the fast history) and :705-719 (the anti-firefly ring)
// ---------------------------------------------------------------------------------------

// planes shared by the signals of a pixel (history_fix.py:SHARED)
enum HfShared { HF_GA, HF_GB, HF_FSZ, HF_NX, HF_NY, HF_NZ, HF_NVX, HF_NVY, HF_NVZ, kHfShared };
// planes of one signal (history_fix.py:PARAMS, SPEC_PARAMS)
enum HfParam { HF_STRIDE, HF_NWP, HF_HA, HF_HB, HF_HDS,
               HF_RA, HF_RB, HF_HIT_DIST, HF_GUIDE_B };  // the last four: specular
constexpr int kHfDiffParams = 5, kHfSpecParams = 9;
constexpr int kAntiFireflyRadius = 4;  // REBLUR_ANTI_FIREFLY_FILTER_RADIUS, every mode

struct HfFrame {
  int w, h;
  float fr[4];
  float rect_inv_w, rect_inv_h, view_z_scale, ortho;
};

template <bool kDec = false>
__device__ __forceinline__ Centre hf_centre(const float* P, size_t plane,
                                            const Image<float, 4>& nr, int x, int y) {
  Centre c;
  c.x = x;
  c.y = y;
  c.u = pixel_u(x, nr.w);
  c.v = pixel_u(y, nr.h);
  c.material = kDec ? 0.0f : nr.at(x, y, 3) * 3.0f;
  c.ga = P[HF_GA * plane];
  c.gb = P[HF_GB * plane];
  c.fsz = P[HF_FSZ * plane];
  c.n = V3{P[HF_NX * plane], P[HF_NY * plane], P[HF_NZ * plane]};
  c.nv = V3{P[HF_NVX * plane], P[HF_NVY * plane], P[HF_NVZ * plane]};
  return c;
}

// mean and second moment of the fast history over the 3x3, (dy, dx) row by row; Img: any
// (h, w) image with at(x, y, 0) and clamp-to-edge addressing (Image, or a staged window)
template <typename Img>
__device__ __forceinline__ void fast_moments(const Img& fast, int x, int y, float* m1,
                                             float* m2) {
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float t = fast.at(x + dx, y + dy, 0);
      a = a + t;
      b = b + t * t;
    }
  *m1 = a / 9.0f;
  *m2 = b / 9.0f;
}

// the anti-firefly ring: the same moments over the 9x9 square minus the 3x3 (72 taps)
template <typename Img>
__device__ __forceinline__ void anti_firefly_moments(const Img& fast, int x, int y, float* m1,
                                                     float* m2) {
  const int r = kAntiFireflyRadius;
  float a = 0.0f, b = 0.0f;
  for (int dy = -r; dy <= r; ++dy)
#pragma unroll
    for (int dx = -r; dx <= r; ++dx) {
      if (abs(dy) <= 1 && abs(dx) <= 1) continue;
      const float t = fast.at(x + dx, y + dy, 0);
      a = a + t;
      b = b + t * t;
    }
  const float cnt = (float)((2 * r + 1) * (2 * r + 1) - 9);
  *m1 = a / cnt;
  *m2 = b / cnt;
}

// One signal's 20 stride taps (5x5 without centre and corners). P points at the pixel in the
// signal's (5 | 9, h, w) planes; kSpec adds the relaxed roughness weight and the low-roughness
// hitT guide. Writes the reconstructed signal, or the centre where the stride is 0 (kOcc: the
// one-channel signal, in out[3]). kSh, the SH
// variants: the signal's SH1 (sh, (h, w, 4)) rides the taps, all four channels weighed by each
// tap's final weight and the centre by 1 + its accumulation speed
// (nrdtpu/passes/reblur/kernels.py:622, :671-675, :680-683: on the specular signal this
// averages the TA's roughness in .w too), written to sh_out; where the stride is 0 it passes.
template <bool kSpec, bool kSh = false, bool kOcc = false, typename Taps>
__device__ __forceinline__ void hf_filter(const HfFrame& f, const Centre& c, const float* P,
                                          size_t plane, float min_material,
                                          const Image<float, 4>& sig,
                                          const Image<float, 1>& data1, const Taps& taps,
                                          float out[4], const float* sh = nullptr,
                                          float* sh_out = nullptr) {
  static_assert(!(kOcc && kSh), "the occlusion variants have no SH");
  const float stride = P[HF_STRIDE * plane];
  const float4 cs = signal_texel<kOcc>(sig, c.x, c.y);
  const float center[4] = {cs.x, cs.y, cs.z, cs.w};
  const Image<float, 4> shi{sh, sig.w, sig.h};
  float4 shc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kSh) shc = shi.at4(c.x, c.y);
  if (stride == 0.0f) {  // converged history: the signal passes through
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = center[k];
    if constexpr (kSh) {
      sh_out[0] = shc.x;
      sh_out[1] = shc.y;
      sh_out[2] = shc.z;
      sh_out[3] = shc.w;
    }
    return;
  }
  const float nwp = P[HF_NWP * plane], ha = P[HF_HA * plane], hb = P[HF_HB * plane];
  const float hds = P[HF_HDS * plane];
  float ra = 0.0f, rb = 0.0f, hit_dist = 0.0f, gb_lo = 0.0f, gb_hi = 0.0f;
  if constexpr (kSpec) {
    ra = P[HF_RA * plane];
    rb = P[HF_RB * plane];
    hit_dist = P[HF_HIT_DIST * plane];
    gb_lo = 0.2f + P[HF_GUIDE_B * plane];
    gb_hi = 0.05f + P[HF_GUIDE_B * plane];
  }
  const float mat_c = fmaxf(c.material, min_material);
  const float inv_fsz = 1.0f / c.fsz, inv_gb = 1.0f / (gb_hi - gb_lo);
  float sum = 1.0f + data1.ldg(c.x, c.y);
  float acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = center[k] * sum;
  float sacc[4] = {shc.x * sum, shc.y * sum, shc.z * sum, shc.w * sum};

  for (int j = -2; j <= 2; ++j)
    for (int k = -2; k <= 2; ++k) {
      if ((j == 0 && k == 0) || abs(j) + abs(k) == 4) continue;
      const float ofx = (float)k * stride, ofy = (float)j * stride;
      const float us = c.u + ofx * f.rect_inv_w, vs = c.v + ofy * f.rect_inv_h;
      const int px = (int)fminf(fmaxf((float)c.x + ofx, 0.0f), (float)(f.w - 1));
      const int py = (int)fminf(fmaxf((float)c.y + ofy, 0.0f), (float)(f.h - 1));

      const TapGeometry g = taps.at(px, py);
      const V3 xvs = reconstruct_view_position(us, vs, f.fr, g.z, f.ortho);
      const float4 s_tap = signal_texel<kOcc>(sig, px, py);  // issued before the weights
      float4 sh_tap = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (kSh) sh_tap = shi.at4(px, py);
      float w_ = in_screen_nearest(us, vs);
      w_ = w_ * compute_weight(dot3(c.nv, xvs), c.ga, c.gb);
      if constexpr (!Taps::kDecoded)  // the RGBA formats carry no material
        w_ = w_ * (mat_c == fmaxf(g.material, min_material) ? 1.0f : 0.0f);
      const float angle = acos_approx(dot3(g.n, c.n));
      w_ = w_ * compute_exponential_weight(angle, nwp, 0.0f);
      if constexpr (kSpec) {
        const float rs = g.roughness;
        w_ = w_ * compute_exponential_weight(rs * rs, ra, rb);
      }
      w_ = w_ * (1.0f + data1.ldg(px, py));
      const float4 s4 = w_ != 0.0f ? s_tap : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      const float hs = s[3] * hds;
      w_ = w_ * compute_exponential_weight(saturate(hs * inv_fsz), ha, hb);
      if constexpr (kSpec) {
        const float d = fabsf(hit_dist - hs) / (fmaxf(hit_dist, hs) + 0.001f);
        const float tt = saturate((d - gb_lo) * inv_gb);  // smoothstep(gb_lo, gb_hi, d)
        w_ = w_ * (tt * tt * (3.0f - 2.0f * tt));
      }
      sum = sum + w_;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = acc[q] + s[q] * w_;
      if constexpr (kSh) {  // where the final weight is non-zero, as the XLA loop selects
        const float4 h4 = w_ != 0.0f ? sh_tap : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        sacc[0] = sacc[0] + h4.x * w_;
        sacc[1] = sacc[1] + h4.y * w_;
        sacc[2] = sacc[2] + h4.z * w_;
        sacc[3] = sacc[3] + h4.w * w_;
      }
    }
  const float inv = 1.0f / fmaxf(sum, 1e-15f);
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = acc[q] * inv;
  if constexpr (kSh) {
#pragma unroll
    for (int q = 0; q < 4; ++q) sh_out[q] = sacc[q] * inv;
  }
}

// ---------------------------------------------------------------------------------------
// REBLUR parameter math (nrdtpu_torch/math.py) and the per-pixel parameters of the band
// kernel's stages (nrdtpu_torch/passes/reblur/params.py), line by line in float32. A
// decimal constant of the torch code is a Python double that meets a float32 tensor rounded
// to float32: it is written (float)<double> here, and a host difference such as 1.0 - 0.01
// is taken in double before that rounding, as Python takes it.
// ---------------------------------------------------------------------------------------

// the JAX package's atan: odd minimax polynomial with range reduction (math.py:atan_approx)
__device__ __forceinline__ float atan_approx(float x) {
  const float ax = fabsf(x);
  const bool hi = ax > 1.0f;
  const float a = hi ? 1.0f / fmaxf(ax, (float)1e-30) : ax;
  const float s = a * a;
  const float p =
      a * ((float)0.99988660 +
           s * ((float)-0.33029950 +
                s * ((float)0.18014100 + s * ((float)-0.08513300 + s * (float)0.02083510))));
  const float r = hi ? (float)(3.141592653589793 / 2.0) - p : p;
  return x < 0.0f ? -r : r;
}

// GetNormalWeightParam (math.py:get_normal_weight_param): percent of volume
// 0.75 lerp(laf, 1, nlas), then 1 / max(atan(tan half angle), encoding error)
__device__ __forceinline__ float normal_weight_param(float nlas, float laf, float one_minus_laf,
                                                     float roughness, float enc_err) {
  const float p = 0.75f * (laf + one_minus_laf * nlas);
  const float m = roughness * roughness;
  const float tan_half = m * sqrtf(p / fmaxf(1.0f - p, (float)1e-6));
  return 1.0f / fmaxf(atan_approx(tan_half), enc_err);
}

// GetHitDistanceWeightParams (math.py:get_hit_distance_weight_params), smc the magic curve
// of the roughness
__device__ __forceinline__ void hit_distance_weight_params(float hit_dist, float nlas,
                                                           float smc, float* a, float* b) {
  const float norm = (float)0.0005 + (float)(1.0 - 0.0005) * fminf(nlas, smc);
  *a = 1.0f / norm;
  *b = -(hit_dist * *a);
}

// GetRoughnessWeightParams (math.py:get_roughness_weight_params), sensitivity 0.01
__device__ __forceinline__ void roughness_weight_params(float roughness, float fraction,
                                                        float* a, float* b) {
  *a = 1.0f / ((float)0.01 + (float)(1.0 - 0.01) * saturate(roughness * fraction));
  *b = -(roughness * *a);
}

// the history fix's clamp (params.py:history_fix_clamp) of one signal, in place: the
// fast-history mix, the anti-firefly clamp to the ring's moments (ring), the clamp to the
// 3x3 moments, ChangeLuma. smc: the specular magic curve (spec only). Returns the clamped
// luma, which the SH variants' SH1 is scaled to (sh_luma_scale). kOcc: the luma is the hit
// distance in sig[3], the sigma scale 1, and the clamped luma replaces it. kDir, directional
// occlusion: the luma is sig[3] with the sigma scale 1, as for kOcc, and ChangeLuma scales the
// direction in sig[0..2] by (luma + 1e-6) / (sig[3] + 1e-6) and sets sig[3] to the luma
// (nrdtpu/passes/reblur/common.py:139-147).
struct HfClampConsts {
  float frame_div, fast_enabled;  // historyFixFrameNum + NRD_EPS; 1 if the fast history is on
};

template <bool kOcc = false, bool kDir = false>
__device__ __forceinline__ float hf_clamp(const HfClampConsts& k, float sig[4], float frame_num,
                                          float fast, float m1, float m2, bool ring, float am1,
                                          float am2, bool spec, float smc, float* fast_out) {
  static_assert(!(kOcc && kDir), "one-channel occlusion, or directional occlusion");
  constexpr bool kLumaW = kOcc || kDir;  // the luma is the hit distance in sig[3]
  float f = saturate(frame_num / k.frame_div);
  if (spec) f = 1.0f + (f - 1.0f) * smc;
  float luma = kLumaW ? sig[3] : sig[0];
  *fast_out = luma + (fast - luma) * f;
  const float sigma = kLumaW ? sqrtf(fabsf(m2 - m1 * m1)) : sqrtf(fabsf(m2 - m1 * m1)) * 2.0f;
  if (ring) {
    const float asig = sqrtf(fabsf(am2 - am1 * am1)) * 2.0f;
    luma = fminf(fmaxf(luma, am1 - asig), am1 + asig);
  }
  const float clamped = fminf(fmaxf(luma, m1 - sigma), m1 + sigma);
  luma = clamped + (luma - clamped) * (1.0f / (1.0f + k.fast_enabled * frame_num * 2.0f));
  if constexpr (kOcc) {
    sig[3] = luma;
    return luma;
  }
  if constexpr (kDir) {
    const float dscale = (luma + (float)1e-6) / (sig[3] + (float)1e-6);
#pragma unroll
    for (int q = 0; q < 3; ++q) sig[q] = sig[q] * dscale;
    sig[3] = luma;
    return luma;
  }
  const float scale = (luma + (float)1e-6) / (sig[0] + (float)1e-6);
#pragma unroll
  for (int q = 0; q < 3; ++q) sig[q] = sig[q] * scale;
  return luma;
}

// the SH variants' luma rule (nrdtpu/passes/reblur/kernels.py:493-495, :729-731): SH1's .xyz
// scaled by get_luma_scale(length(.xyz), luma), .w kept
__device__ __forceinline__ void sh_luma_scale(float sh[4], float luma) {
  const float len = sqrtf(fmaxf(sh[0] * sh[0] + sh[1] * sh[1] + sh[2] * sh[2], 0.0f));
  const float scale = (luma + (float)1e-6) / (len + (float)1e-6);
#pragma unroll
  for (int q = 0; q < 3; ++q) sh[q] = sh[q] * scale;
}

// The Blur / PostBlur parameters of one signal (params.py:diff_spatial_params,
// spec_spatial_params outside the PrePass), written in the order of SfParam.
struct StageConsts {
  float fraction_scale, radius_scale;
  float mhdw_scale;  // minHitDistanceWeight * fraction scale
  float rf_scaled;   // saturate(roughnessFraction * fraction scale)
  float rot[4];
};

struct BlurConsts {
  float fade_a, fade_ba;  // GetFadeBasedOnAccumulatedFrames: (a, b - a)
  float max_blur_radius, min_blur_radius;
  float laf, one_minus_laf, enc_err;
  float rect_inv_w, rect_inv_h;
};

// the non-linear accumulation speed of the blur radius; boost scaled by smc (specular) or 1
__device__ __forceinline__ float blur_nlas(const BlurConsts& k, float data1, float nov,
                                           bool spec, float smc) {
  float boost = 1.0f - saturate((data1 - k.fade_a) / k.fade_ba);
  boost = boost * (1.0f - powf(saturate(1.0f - nov), 5.0f));
  if (spec) boost = boost * smc;
  return 1.0f / (1.0f + (1.0f - boost) * data1);
}

// diffuse: hit_dist the signal's normalized hit distance; hds, fsz the hit-distance scale
// and the frustum size; nvx, nvy the view-space normal (screen-space skew). kOcc: the min
// hit-distance weight without its sqrt(nlas) (params.py, nrdtpu/passes/reblur/kernels.py:814)
template <bool kOcc = false>
__device__ __forceinline__ void diff_blur_params(const BlurConsts& k, const StageConsts& s,
                                                 float hit_dist, float data1, float hds,
                                                 float fsz, float nov, float nvx, float nvy,
                                                 float prm[kSfDiffParams]) {
  const float hit_dist_factor = saturate(hit_dist * hds / fsz);
  const float nlas = blur_nlas(k, data1, nov, false, 0.0f);
  float blur_radius = k.max_blur_radius * sqrtf(saturate(hit_dist_factor * nlas));
  blur_radius = blur_radius * s.radius_scale;
  blur_radius = fmaxf(blur_radius, k.min_blur_radius);
  const float mhdw = kOcc ? s.mhdw_scale : s.mhdw_scale * sqrtf(nlas);
  const float ax = 1.0f - fabsf(nvx), ay = 1.0f - fabsf(nvy);
  float skew_x = ax + (1.0f - ax) * nov;
  float skew_y = ay + (1.0f - ay) * nov;
  const float skew_max = fmaxf(skew_x, skew_y);
  skew_x = skew_x / skew_max * k.rect_inv_w * blur_radius;
  skew_y = skew_y / skew_max * k.rect_inv_h * blur_radius;
  prm[SF_ROT0] = s.rot[0] * skew_x;
  prm[SF_ROT1] = s.rot[1] * skew_y;
  prm[SF_ROT2] = s.rot[2] * skew_x;
  prm[SF_ROT3] = s.rot[3] * skew_y;
  prm[SF_NWP] = normal_weight_param(nlas, k.laf, k.one_minus_laf, 1.0f, k.enc_err) /
                s.fraction_scale;
  hit_distance_weight_params(hit_dist, nlas, spec_magic_curve(1.0f), &prm[SF_HA], &prm[SF_HB]);
  prm[SF_MHDW] = mhdw;
}

// specular: as diffuse, with the roughness, its magic curve and the roughness weight; no
// skew. kOcc: as diffuse (nrdtpu/passes/reblur/kernels.py:1655)
template <bool kOcc = false>
__device__ __forceinline__ void spec_blur_params(const BlurConsts& k, const StageConsts& s,
                                                 float hit_dist, float data1, float hds,
                                                 float fsz, float nov, float roughness,
                                                 float smc, float prm[kSfSpecParams]) {
  const float hit_dist_factor = saturate(hit_dist * hds / fsz);
  const float nlas = blur_nlas(k, data1, nov, true, smc);
  float blur_radius = k.max_blur_radius * sqrtf(saturate(roughness * hit_dist_factor * nlas));
  blur_radius = blur_radius * s.radius_scale;
  blur_radius = fmaxf(blur_radius, k.min_blur_radius * smc);
  const float skew_x = k.rect_inv_w * blur_radius, skew_y = k.rect_inv_h * blur_radius;
  prm[SF_ROT0] = s.rot[0] * skew_x;
  prm[SF_ROT1] = s.rot[1] * skew_y;
  prm[SF_ROT2] = s.rot[2] * skew_x;
  prm[SF_ROT3] = s.rot[3] * skew_y;
  prm[SF_NWP] = normal_weight_param(nlas, k.laf, k.one_minus_laf, roughness, k.enc_err) /
                s.fraction_scale;
  hit_distance_weight_params(hit_dist, nlas, smc, &prm[SF_HA], &prm[SF_HB]);
  prm[SF_MHDW] = kOcc ? s.mhdw_scale * smc : s.mhdw_scale * smc * sqrtf(nlas);
  roughness_weight_params(roughness, s.rf_scaled, &prm[SF_WR_A], &prm[SF_WR_B]);
}

// ---------------------------------------------------------------------------------------
// The centre of H2 (spatial_filter.cu), computed in the kernel: the geometry of
// nrdtpu_torch/passes/reblur/params.py:filter_geometry and the PrePass parameters of
// diff_spatial_params / spec_spatial_params, line by line in float32 under the rules above
// ---------------------------------------------------------------------------------------

// vec3.py:decode_oct_raw: the octahedral decode normalized by rsqrt(max(|n|^2, 1e-15)) (the
// taps' unpack_normal adds 1e-9 instead: the same value for every decoded normal, whose |n|^2
// is at least 1/3, but each side is written as its torch code writes it)
__device__ __forceinline__ V3 decode_oct_raw(float px, float py) {
  const float qx = px * 2.0f - 1.0f, qy = py * 2.0f - 1.0f;
  const float z = 1.0f - fabsf(qx) - fabsf(qy);
  const float t = saturate(-z);
  const float x = qx - t * (qx >= 0.0f ? 1.0f : -1.0f);
  const float y = qy - t * (qy >= 0.0f ? 1.0f : -1.0f);
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, (float)1e-15));
  return V3{x * inv, y * inv, z * inv};
}

// _REBLUR_GetHitDistanceNormalization (frontend.py:get_hit_distance_normalization); hdp: A, B,
// C, D
__device__ __forceinline__ float hit_distance_normalization(const float hdp[4], float view_z,
                                                            float roughness) {
  return (hdp[0] + fabsf(view_z) * hdp[1]) *
         (1.0f + (hdp[2] - 1.0f) * saturate(exp2f(hdp[3] * roughness * roughness)));
}

// _NRD_GetSpecularDominantFactor (math.py:get_specular_dominant_factor)
__device__ __forceinline__ float specular_dominant_factor(float nov, float roughness) {
  const float a = (float)0.298475 * logf((float)39.4115 - (float)39.0029 * roughness);
  return saturate(powf(saturate(1.0f - nov), (float)10.8649) * (1.0f - a) + a);
}

// the host constants of the geometry beyond SfFrame's (frustum, viewZ scale, ortho, hit-distance
// parameters)
struct GeometryConsts {
  float wtv[9];  // world_to_view[:3, :3], row-major
  float min_rect_dim_mul_unproject, plane_dist_sensitivity, unproject;
};

// one pixel's filter_geometry for one signal: hds its hit-distance scale, smc the specular
// magic curve (specular only)
struct FilterGeometry {
  float view_z, roughness, nov, fsz, ga, gb, hds, smc;
  V3 n, nv, xv, vv;
};

// kDec: nr is the decoded plane's texel, its normal .xyz as it is and its roughness .w
// (params.py:filter_geometry with decoded)
template <bool kSpec, bool kDec = false>
__device__ __forceinline__ FilterGeometry filter_geometry(const SfFrame& f,
                                                          const GeometryConsts& k, float u,
                                                          float v, float raw_z, float4 nr) {
  FilterGeometry g;
  g.view_z = fabsf(raw_z) * f.view_z_scale;
  g.n = kDec ? V3{nr.x, nr.y, nr.z} : decode_oct_raw(nr.x, nr.y);
  g.roughness = kDec ? nr.w : nr.z;
  g.nv = rotate<3>(k.wtv, g.n);
  g.xv = reconstruct_view_position(u, v, f.fr, g.view_z, f.ortho);
  if (f.ortho == 0.0f) {  // a frame constant: a uniform branch
    const V3 m{-g.xv.x, -g.xv.y, -g.xv.z};
    const float inv = rsqrtf(fmaxf(dot3(m, m), (float)1e-15));
    g.vv = V3{m.x * inv, m.y * inv, m.z * inv};
  } else {
    g.vv = V3{0.0f, 0.0f, -1.0f};
  }
  g.nov = fabsf(dot3(g.nv, g.vv));
  g.fsz = k.min_rect_dim_mul_unproject * (g.view_z + (1.0f - g.view_z) * fabsf(f.ortho));
  g.ga = 1.0f / (k.plane_dist_sensitivity * g.fsz);
  g.gb = -dot3(g.nv, g.xv) * g.ga;
  g.smc = kSpec ? spec_magic_curve(g.roughness) : 0.0f;
  g.hds = hit_distance_normalization(f.hdp, g.view_z, kSpec ? g.roughness : 1.0f);
  return g;
}

// REBLUR_PRE_BLUR_NON_LINEAR_ACCUM_SPEED
constexpr float kPrepassNlas = (float)(1.0 / (1.0 + 10.0));

// the scaled rotator of a stage: the x terms by skew_x, the y terms by skew_y
__device__ __forceinline__ void scaled_rotator(const StageConsts& s, float skew_x, float skew_y,
                                               float* prm) {
  prm[SF_ROT0] = s.rot[0] * skew_x;
  prm[SF_ROT1] = s.rot[1] * skew_y;
  prm[SF_ROT2] = s.rot[2] * skew_x;
  prm[SF_ROT3] = s.rot[3] * skew_y;
}

// diffuse PrePass (params.py:diff_spatial_params, PRE_BLUR): hit_dist the signal's normalized
// hit distance, radius the PrePass blur radius; no skew
__device__ __forceinline__ void diff_prepass_params(const BlurConsts& k, const StageConsts& s,
                                                    float radius, float hit_dist,
                                                    const FilterGeometry& g,
                                                    float prm[kSfDiffParams]) {
  const float hit_dist_factor = saturate(hit_dist * g.hds / g.fsz);
  float blur_radius = radius * sqrtf(saturate(hit_dist_factor));
  blur_radius = fmaxf(blur_radius, k.min_blur_radius);
  scaled_rotator(s, k.rect_inv_w * blur_radius, k.rect_inv_h * blur_radius, prm);
  prm[SF_NWP] = normal_weight_param(kPrepassNlas, k.laf, k.one_minus_laf, 1.0f, k.enc_err) /
                s.fraction_scale;
  hit_distance_weight_params(hit_dist, kPrepassNlas, spec_magic_curve(1.0f), &prm[SF_HA],
                             &prm[SF_HB]);
  prm[SF_MHDW] = s.mhdw_scale;
}

// specular PrePass (params.py:spec_spatial_params, PRE_BLUR): the radius bound by the
// specular lobe (REBLUR_PrePass.hlsli:71-80: the dominant direction, the lobe's tangent and
// pixel_radius_to_world), the minimum radius scaled by the magic curve, and the planes of the
// hitDistForTracking minimum
__device__ __forceinline__ void spec_prepass_params(const BlurConsts& k, const StageConsts& s,
                                                    const GeometryConsts& gk, float ortho,
                                                    float radius, float hit_dist,
                                                    const FilterGeometry& g,
                                                    float prm[kSfPrepassParams]) {
  const float hd = hit_dist * g.hds;
  const float hit_dist_factor = saturate(hd / g.fsz);
  float blur_radius = radius * sqrtf(saturate(g.roughness * hit_dist_factor));
  // GetSpecularDominantDirection(nv, vv, roughness): lerp(n, reflect(-v, n), f), normalized
  const float dvf = specular_dominant_factor(g.nov, g.roughness);
  const V3 i{-g.vv.x, -g.vv.y, -g.vv.z};
  const float d = 2.0f * dot3(g.nv, i);
  const V3 r{i.x - d * g.nv.x, i.y - d * g.nv.y, i.z - d * g.nv.z};
  const V3 l{g.nv.x + (r.x - g.nv.x) * dvf, g.nv.y + (r.y - g.nv.y) * dvf,
             g.nv.z + (r.z - g.nv.z) * dvf};
  const float inv = rsqrtf(fmaxf(dot3(l, l), (float)1e-15));
  const V3 dv{l.x * inv, l.y * inv, l.z * inv};
  const float nod = fabsf(dot3(g.nv, dv));
  // GetSpecularLobeTanHalfAngle(roughness, REBLUR_MAX_PERCENT_OF_LOBE_VOLUME_FOR_PRE_PASS)
  const float m = g.roughness * g.roughness;
  const float p = (float)0.3;
  const float lobe_tan = m * sqrtf(p / fmaxf(1.0f - p, (float)1e-6));
  const float lobe_radius = hd * nod * lobe_tan;
  const float z = g.view_z + hd * dvf;
  const float min_blur_radius = lobe_radius / (gk.unproject * (z + (1.0f - z) * fabsf(ortho)));
  blur_radius = fminf(blur_radius, min_blur_radius);
  blur_radius = blur_radius * s.radius_scale;
  blur_radius = fmaxf(blur_radius, k.min_blur_radius * g.smc);
  scaled_rotator(s, k.rect_inv_w * blur_radius, k.rect_inv_h * blur_radius, prm);
  prm[SF_NWP] = normal_weight_param(kPrepassNlas, k.laf, k.one_minus_laf, g.roughness,
                                    k.enc_err) / s.fraction_scale;
  hit_distance_weight_params(hit_dist, kPrepassNlas, g.smc, &prm[SF_HA], &prm[SF_HB]);
  prm[SF_MHDW] = s.mhdw_scale * g.smc;
  roughness_weight_params(g.roughness, s.rf_scaled, &prm[SF_WR_A], &prm[SF_WR_B]);
  prm[SF_HIT_DIST] = hd;
  prm[SF_ROUGH] = g.roughness;
  prm[SF_XVX] = g.xv.x;
  prm[SF_XVY] = g.xv.y;
  prm[SF_XVZ] = g.xv.z;
}

// ---------------------------------------------------------------------------------------
// The history fix and its clamp for one (16x16 tile, signal) CTA: H3 (history_fix.cu, one
// signal), N5 (history_fix_fused.cu) and phase 1 of K23 (reblur_band.cu, two signals) run this
// one body. The plain version is nrdtpu_torch/kernels/history_fix.py:history_fix_ref.
// ---------------------------------------------------------------------------------------

constexpr int kFixTile = 16;
constexpr int kFixWin = kFixTile + 2 * kAntiFireflyRadius;  // the tile and the ring's margin
constexpr int kBothSignals = -1;  // history_fix_cta: one CTA per (tile, signal), both signals

struct HistoryFixArgs {
  const float* signal[2];  // (h, w, 4) TA outputs: diffuse, specular ((h, w, 1) with kOcc)
  const float* data1[2];   // (h, w) accumulation speeds
  const float* fast[2];    // (h, w) fast histories
  const float* params[2];  // (kHfDiffParams | kHfSpecParams, h, w)
  const float* shared;     // the centre's planes in HfShared order, plane stride w * h
  const float* smc;        // (h, w) the specular magic curve of the roughness
  const float* nr;         // (h, w, 4)
  const float* view_z;     // (h, w) raw: the prologue's input
  const float4* geometry;  // (h, w) the taps' unpacked normal and scaled viewZ
  float* out[2];           // (h, w, 4) the clamped signals ((h, w, 1) with kOcc)
  float* fast_out[2];      // (h, w) the fast histories after the mix
  const float* sh[2];      // (h, w, 4) the signals' SH1 (the SH variants)
  float* sh_out[2];        // (h, w, 4) their history fix, scaled to the clamped luma
  float min_material[2];
  bool anti_firefly[2];
  HfFrame f;
  HfClampConsts clamp;
};

// a signal's fast history staged over a tile and the ring's margin: rows of kFixWin texels
// from (ox, oy), clamp-to-edge
struct FastWindow {
  const float* p;
  int ox, oy;
  __device__ __forceinline__ float at(int x, int y, int) const {
    return p[(y - oy) * kFixWin + (x - ox)];
  }
};

// one pixel: the 3x3 (and ring) moments from the window, the stride taps (their geometry from
// the plane), the clamp; kSh: the SH1 through the taps and scaled to the clamped luma; kOcc:
// the one-channel signal; kDir: the directional-occlusion clamp (hf_clamp), the taps those of
// the radiance signal; kDec: nr is the RGBA formats' decoded plane
template <bool kSpec, bool kSh, bool kOcc, bool kDir = false, bool kDec = false>
__device__ __forceinline__ void history_fix_pixel(const HistoryFixArgs& a, const FastWindow& win,
                                                  int x, int y) {
  constexpr int s = kSpec ? 1 : 0;
  const int w = a.f.w, h = a.f.h;
  const size_t i = (size_t)y * w + x, plane = (size_t)w * h;
  const Image<float, 4> nr{a.nr, w, h};
  const Centre c = hf_centre<kDec>(a.shared + i, plane, nr, x, y);
  float m1, m2, am1 = 0.0f, am2 = 0.0f;
  fast_moments(win, x, y, &m1, &m2);
  if (a.anti_firefly[s]) anti_firefly_moments(win, x, y, &am1, &am2);
  float sig[4], sh[4];
  hf_filter<kSpec, kSh, kOcc>(a.f, c, a.params[s] + i, plane, a.min_material[s],
                        Image<float, 4>{a.signal[s], w, h}, Image<float, 1>{a.data1[s], w, h},
                        UnpackedTapsT<0, kDec>{a.geometry, nr}, sig, a.sh[s], sh);
  const float smc = kSpec ? __ldg(a.smc + i) : 0.0f;
  float fast_out;
  const float luma = hf_clamp<kOcc, kDir>(a.clamp, sig, __ldg(a.data1[s] + i), win.at(x, y, 0),
                                          m1, m2, a.anti_firefly[s], am1, am2, kSpec, smc,
                                          &fast_out);
  if constexpr (kOcc)
    a.out[s][i] = sig[3];
  else
    reinterpret_cast<float4*>(a.out[s])[i] = make_float4(sig[0], sig[1], sig[2], sig[3]);
  a.fast_out[s][i] = fast_out;
  if constexpr (kSh) {
    sh_luma_scale(sh, luma);
    reinterpret_cast<float4*>(a.sh_out[s])[i] = make_float4(sh[0], sh[1], sh[2], sh[3]);
  }
}

// kSig: the CTA's signal (0 diffuse, 1 specular), or kBothSignals: the low bit of blockIdx.x,
// so that the two CTAs of a tile run side by side and share the centre's planes in L2. Every
// thread stages the window, then the threads outside the image leave. kSh: the SH variants;
// kOcc: the occlusion variants; kDir: REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (diffuse only); kDec:
// the RGBA formats' decoded plane.
template <int kSig, bool kSh = false, bool kOcc = false, bool kDir = false, bool kDec = false>
__device__ __forceinline__ void history_fix_cta(const HistoryFixArgs& a) {
  static_assert(kSig == kBothSignals || kSig == 0 || kSig == 1, "a signal, or both");
  static_assert(!kDir || (kSig == 0 && !kSh && !kOcc), "directional occlusion: diffuse only");
  constexpr bool kBoth = kSig == kBothSignals;
  __shared__ float window[kFixWin * kFixWin];
  const int s = kBoth ? (int)(blockIdx.x & 1u) : kSig;
  const int x0 = (int)(kBoth ? blockIdx.x >> 1 : blockIdx.x) * kFixTile;
  const int y0 = (int)blockIdx.y * kFixTile;
  const FastWindow win{window, x0 - kAntiFireflyRadius, y0 - kAntiFireflyRadius};
  const Image<float, 1> src{a.fast[s], a.f.w, a.f.h};
  for (int k = threadIdx.y * kFixTile + threadIdx.x; k < kFixWin * kFixWin;
       k += kFixTile * kFixTile)
    window[k] = src.ldg(win.ox + k % kFixWin, win.oy + k / kFixWin);
  __syncthreads();
  const int x = x0 + (int)threadIdx.x, y = y0 + (int)threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  if (s == 0)
    history_fix_pixel<false, kSh, kOcc, kDir, kDec>(a, win, x, y);
  else
    history_fix_pixel<true, kSh, kOcc, false, kDec>(a, win, x, y);
}

}  // namespace nrd
