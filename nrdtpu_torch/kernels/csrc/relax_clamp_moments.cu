// K20: RELAX HistoryClamping of one signal, or of both, in one launch: for each signal the
// responsive history picked per
// texel (HistoryFix's output where the history is short, the TA's fast history elsewhere),
// the 5x5 moments over the clamp-to-edge window (each tap weighted by its validity, viewZ <
// denoisingRange: the mean and second moment of the responsive history in YCoCg, the mean of
// the noisy radiance and the second moment of its luminance, over max(weight sum, 1)), then
// the rest of the pass per pixel: the sigma colour box and the clamp of the slow history in
// YCoCg, the clamping factor, the antilag acceleration and reset, the second-moment
// correction (nrdtpu/passes/relax/kernels.py:1140-1271); with the SH variants (kSh) also each
// signal's SH, lerp(sh, sh_fast, clamping factor) (kernels.py:1260-1262: glue beside the TPU
// kernel, here in the launch, where the clamping factor exists). Replaces
// nrdtpu/kernels/relax_pallas.py:479 relax_clamp_moments_pallas (its `n_sig` signals in one
// launch). The plain version is
// nrdtpu_torch/kernels/relax_clamp_moments.py:relax_clamp_moments_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, `relax_clamp_moments_kernel<kNSig>`
// for 1 or 2 signals, each at 40 registers and 6 CTAs an SM, no spill (PERF.md: one signal 6 %
// faster than at 4 CTAs; two 5 % faster than at 5 CTAs and 10 % faster than at 4).
//   - Every texel is a tap of 25 pixels: each CTA first stages its 20x20 window (halo 2,
//     clamp-to-edge) in shared memory, once a texel, as derived values: the validity and the
//     responsive history in YCoCg (one float4), the noisy rgb and its luminance (another).
//     Each thread stages two texels with one float4 load a plane, all loads of both issued
//     before the first is used, the fast and the fixed history both read so that none waits
//     on the history length that picks one (3 % faster than a loop of dependent loads). With
//     both signals the window holds each signal's two planes (the validity in each), and a
//     thread's loads of both signals' texels are all issued before the first is staged.
//   - Each signal has its own constants (the clamp flag, acceleration and reset amount) and
//     runs the per-pixel part after the other, so that the second adds no registers there.
//   - The taps sum in the plain version's order (dy outer, dx inner) with its operations, so
//     the moments are the plain version's bit for bit: m2 - m1^2 cancels.
//   - The pass glue that read the moments back (~60 full-resolution torch launches, and the
//     responsive history's select before them) is per-pixel arithmetic on host constants:
//     it runs here term by term, true divisions kept (each feeds a threshold or saturate),
//     and writes the slow and responsive histories as two float4 planes.
#include "relax_common.cuh"

namespace {

constexpr int kBorder = 2;
constexpr int kTile = nrd::kBlock;         // 16x16 pixels a CTA
constexpr int kWin = kTile + 2 * kBorder;  // its 20x20 window of texels
constexpr int kMinCtas = 6;
static_assert(kWin * kWin <= 2 * kTile * kTile, "two window texels a thread");

// One signal's planes and constants.
struct ClampSignal {
  const float* fast;   // (h, w, 4) the TA's responsive history
  const float* fixed;  // (h, w, 4) HistoryFix's output (rgb)
  const float* noisy;  // (h, w, 4) the PrePass output (rgb)
  const float* slow;   // (h, w, 4) the TA's slow history (rgb, second moment)
  float* out_slow;     // (h, w, 4)
  float* out_resp;     // (h, w, 4)
  const float* sh;       // (h, w, 4) the TA's slow SH (kSh only)
  const float* sh_fast;  // (h, w, 4) the TA's responsive SH (kSh only)
  float* out_sh;         // (h, w, 4) (kSh only)
  float acceleration, reset_amount;
  bool clamp;  // maxFastAccumulatedFrameNum < maxAccumulatedFrameNum
};

struct ClampArgs {
  const float* view_z;          // (h, w) raw
  const float* history_length;  // (h, w)
  ClampSignal sig[2];           // the diffuse signal first where there are two
  int w, h;
  float view_z_scale, denoising_range, fix_frame_num, color_box_sigma_scale;
  float reset_temporal_sigma_scale, reset_spatial_sigma_scale;
};

// The staged window of one signal: each texel's (validity, responsive history in YCoCg) and
// (noisy rgb, its luminance).
struct Window {
  float4 resp[kWin * kWin];
  float4 noisy[kWin * kWin];
};

// What the window stages of a texel, as loaded: each signal's both histories, so that no load
// waits on the history length that selects one.
template <int kNSig>
struct Texel {
  float view_z, history_length;
  float4 fast[kNSig], fixed[kNSig], noisy[kNSig];
};

template <int kNSig>
__device__ __forceinline__ Texel<kNSig> load_texel(const ClampArgs& a, int ox, int oy, int k) {
  const int tx = nrd::clampi(ox + k % kWin, 0, a.w - 1);
  const int ty = nrd::clampi(oy + k / kWin, 0, a.h - 1);
  const size_t j = (size_t)ty * a.w + tx;
  Texel<kNSig> t;
  t.view_z = __ldg(a.view_z + j);
  t.history_length = __ldg(a.history_length + j);
#pragma unroll
  for (int s = 0; s < kNSig; ++s) {
    t.fast[s] = __ldg(reinterpret_cast<const float4*>(a.sig[s].fast) + j);
    t.fixed[s] = __ldg(reinterpret_cast<const float4*>(a.sig[s].fixed) + j);
    t.noisy[s] = __ldg(reinterpret_cast<const float4*>(a.sig[s].noisy) + j);
  }
  return t;
}

// Window texel k of each signal: its validity and responsive history in YCoCg, its noisy rgb
// and luminance.
template <int kNSig>
__device__ __forceinline__ void stage(const ClampArgs& a, Window* wnd, int k,
                                      const Texel<kNSig>& t) {
  const float valid = fabsf(t.view_z) * a.view_z_scale < a.denoising_range ? 1.0f : 0.0f;
  const bool in_fix = t.history_length <= a.fix_frame_num;
#pragma unroll
  for (int s = 0; s < kNSig; ++s) {
    const float4 r = in_fix ? t.fixed[s] : t.fast[s];
    float ry[3];
    relax::linear_to_ycocg(r.x, r.y, r.z, ry);
    wnd[s].resp[k] = make_float4(valid, ry[0], ry[1], ry[2]);
    const float4 n = t.noisy[s];
    wnd[s].noisy[k] = make_float4(n.x, n.y, n.z, relax::luminance(n.x, n.y, n.z));
  }
}

__device__ __forceinline__ float luminance_abs(float r, float g, float b) {
  return relax::luminance(fabsf(r), fabsf(g), fabsf(b));
}

// The whole pass of one signal at pixel i, its window staged in wnd; wc: the window index of
// the pixel's own texel; kSh: the SH lerp too.
template <bool kSh>
__device__ __forceinline__ void clamp_pixel(const ClampArgs& a, const ClampSignal& g,
                                            const Window& wnd, size_t i, int wc) {
  // the 5x5 moments (:1169-1192)
  float m1[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f}, nm1[3] = {0.0f, 0.0f, 0.0f};
  float nm2 = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int dy = -kBorder; dy <= kBorder; ++dy)
#pragma unroll
    for (int dx = -kBorder; dx <= kBorder; ++dx) {
      const float4 r = wnd.resp[wc + dy * kWin + dx];
      const float4 n = wnd.noisy[wc + dy * kWin + dx];
      const float w_ = r.x;
      const float ry[3] = {r.y, r.z, r.w}, nz[3] = {n.x, n.y, n.z};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        m1[c] = m1[c] + ry[c] * w_;
        m2[c] = m2[c] + ry[c] * ry[c] * w_;
        nm1[c] = nm1[c] + nz[c] * w_;
      }
      nm2 = nm2 + n.w * n.w * w_;
      wsum = wsum + w_;
    }
  wsum = fmaxf(wsum, 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m1[c] = m1[c] / wsum;
    m2[c] = m2[c] / wsum;
    nm1[c] = nm1[c] / wsum;
  }
  nm2 = nm2 / wsum;

  // the colour box and the clamp of the slow history (:1193-1210)
  const float4 centre = wnd.resp[wc];
  const float resp_ycocg[3] = {centre.y, centre.z, centre.w};
  const float4 slow = __ldg(reinterpret_cast<const float4*>(g.slow) + i);
  float slow_ycocg[3], clamped_ycocg[3], sigma[3];
  relax::linear_to_ycocg(slow.x, slow.y, slow.z, slow_ycocg);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sigma[c] = sqrtf(fmaxf(m2[c] - m1[c] * m1[c], 0.0f));
    const float cmin = fminf(m1[c] - a.color_box_sigma_scale * sigma[c], resp_ycocg[c]);
    const float cmax = fmaxf(m1[c] + a.color_box_sigma_scale * sigma[c], resp_ycocg[c]);
    clamped_ycocg[c] = g.clamp ? fminf(fmaxf(slow_ycocg[c], cmin), cmax) : slow_ycocg[c];
  }
  float clamped[3];
  relax::ycocg_to_linear(clamped_ycocg, clamped);

  const bool in_fix = __ldg(a.history_length + i) <= a.fix_frame_num;
  const float4 fast = __ldg(reinterpret_cast<const float4*>(g.fast) + i);
  const float4 resp = in_fix ? __ldg(reinterpret_cast<const float4*>(g.fixed) + i) : fast;
  float out_slow[3] = {in_fix ? resp.x : clamped[0], in_fix ? resp.y : clamped[1],
                       in_fix ? resp.z : clamped[2]};
  float out_resp[3] = {resp.x, resp.y, resp.z};

  // the clamping factor and the antilag acceleration (:1212-1240)
  const float dy_clamp = clamped_ycocg[0] - slow_ycocg[0];
  const float denom = resp_ycocg[0] - slow_ycocg[0];
  float clamping_factor =
      dy_clamp == 0.0f ? 0.0f
                       : nrd::saturate(dy_clamp / (fabsf(denom) < 1e-15f ? 1e-15f : denom));
  clamping_factor = in_fix ? 1.0f : clamping_factor;
  if constexpr (kSh) {  // lerp(sh, sh_fast, clamping factor)
    const float4 sh = __ldg(reinterpret_cast<const float4*>(g.sh) + i);
    const float4 shf = __ldg(reinterpret_cast<const float4*>(g.sh_fast) + i);
    reinterpret_cast<float4*>(g.out_sh)[i] = make_float4(
        sh.x + (shf.x - sh.x) * clamping_factor, sh.y + (shf.y - sh.y) * clamping_factor,
        sh.z + (shf.z - sh.z) * clamping_factor, sh.w + (shf.w - sh.w) * clamping_factor);
  }
  float hist_diff_l = g.acceleration * luminance_abs(out_resp[0] - slow.x,
                                                     out_resp[1] - slow.y,
                                                     out_resp[2] - slow.z);
  hist_diff_l = hist_diff_l * clamping_factor;
  hist_diff_l = in_fix ? 0.0f : hist_diff_l;
  const float dist[3] = {nm1[0] - out_resp[0], nm1[1] - out_resp[1], nm1[2] - out_resp[2]};
  const float dist_l = luminance_abs(dist[0], dist[1], dist[2]);
  const float q = hist_diff_l / fmaxf(dist_l, 1e-15f);
  float accel[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) accel[c] = dist_l == 0.0f ? 0.0f : dist[c] * q;
  const float accel_l = luminance_abs(accel[0], accel[1], accel[2]);
  const float ratio = accel_l == 0.0f ? 0.0f : dist_l / fmaxf(accel_l, 1e-15f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    accel[c] = ratio < 1.0f ? accel[c] * ratio : accel[c];
    accel[c] = ratio <= 0.0f ? 0.0f : accel[c];
    out_slow[c] = out_slow[c] + accel[c];
    out_resp[c] = out_resp[c] + accel[c];
  }

  // the history reset (:1242-1262)
  const float4 noisy = wnd.noisy[wc];
  const float slow_l = relax::luminance(slow.x, slow.y, slow.z);
  const float noisy_l = relax::luminance(nm1[0], nm1[1], nm1[2]);
  const float t_sigma = a.reset_temporal_sigma_scale * sqrtf(fmaxf(nm2 - noisy_l * noisy_l, 0.0f));
  const float s_sigma = a.reset_spatial_sigma_scale * sigma[0];
  float reset = g.reset_amount * fmaxf(fabsf(slow_l - noisy_l) - s_sigma - t_sigma, 0.0f) /
                (1e-6f + fmaxf(slow_l, noisy_l) + s_sigma + t_sigma);
  reset = nrd::saturate(reset);
  const float nz[3] = {noisy.x, noisy.y, noisy.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out_slow[c] = out_slow[c] + (nz[c] - out_slow[c]) * reset;
    out_resp[c] = out_resp[c] + (nz[c] - out_resp[c]) * reset;
  }

  // the second-moment correction (:1264-1271)
  const float out_l = relax::luminance(out_slow[0], out_slow[1], out_slow[2]);
  const float out_m2 = fmaxf(slow.w + (out_l * out_l - slow_l * slow_l), 0.0f);
  reinterpret_cast<float4*>(g.out_slow)[i] = make_float4(out_slow[0], out_slow[1], out_slow[2],
                                                         out_m2);
  reinterpret_cast<float4*>(g.out_resp)[i] = make_float4(out_resp[0], out_resp[1], out_resp[2],
                                                         fast.w);
}

template <int kNSig, bool kSh>
__global__ void __launch_bounds__(kTile * kTile, kMinCtas)
    relax_clamp_moments_kernel(ClampArgs a) {
  __shared__ Window wnd[kNSig];
  const int ox = (int)blockIdx.x * kTile - kBorder, oy = (int)blockIdx.y * kTile - kBorder;
  // each thread stages texels t0 and t1 of the window, every load of both issued first
  const int t0 = threadIdx.y * kTile + threadIdx.x, t1 = t0 + kTile * kTile;
  const bool two = t1 < kWin * kWin;
  const Texel<kNSig> s0 = load_texel<kNSig>(a, ox, oy, t0);
  const Texel<kNSig> s1 = load_texel<kNSig>(a, ox, oy, two ? t1 : t0);
  stage<kNSig>(a, wnd, t0, s0);
  if (two) stage<kNSig>(a, wnd, t1, s1);
  __syncthreads();
  const int x = ox + kBorder + (int)threadIdx.x, y = oy + kBorder + (int)threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  // the window index of the pixel's own texel
  const int wc = ((int)threadIdx.y + kBorder) * kWin + (int)threadIdx.x + kBorder;
#pragma unroll
  for (int s = 0; s < kNSig; ++s) clamp_pixel<kSh>(a, a.sig[s], wnd[s], i, wc);
}

}  // namespace

// ptrs: view_z, fast, fixed, history_length, noisy, slow, out_slow, out_resp, then with two
//       signals the second's fast, fixed, noisy, slow, out_slow, out_resp, then each
//       signal's sh, sh_fast, out_sh (null without SH)
// consts: view_z_scale, denoising_range, history_fix_frame_num, color_box_sigma_scale, clamp,
//         acceleration, reset_temporal_sigma_scale, reset_spatial_sigma_scale, reset_amount,
//         signals (1 or 2), then the second signal's clamp, acceleration, reset_amount
extern "C" int nrd_relax_clamp_moments(void* const* p, const float* c, int w, int h,
                                       void* stream) {
  ClampArgs a;
  a.view_z = (const float*)p[0];
  a.history_length = (const float*)p[3];
  a.w = w;
  a.h = h;
  a.view_z_scale = c[0];
  a.denoising_range = c[1];
  a.fix_frame_num = c[2];
  a.color_box_sigma_scale = c[3];
  a.reset_temporal_sigma_scale = c[6];
  a.reset_spatial_sigma_scale = c[7];
  const int n = (int)c[9];
  if (n < 1 || n > 2) return (int)cudaErrorInvalidValue;
  // where each signal's fast, fixed, noisy, slow, out_slow, out_resp sit among the ptrs, and
  // its clamp, acceleration, reset amount among the consts
  constexpr int kPtr[2][6] = {{1, 2, 4, 5, 6, 7}, {8, 9, 10, 11, 12, 13}};
  constexpr int kConst[2][3] = {{4, 5, 8}, {10, 11, 12}};
  for (int s = 0; s < n; ++s) {
    ClampSignal& g = a.sig[s];
    g.fast = (const float*)p[kPtr[s][0]];
    g.fixed = (const float*)p[kPtr[s][1]];
    g.noisy = (const float*)p[kPtr[s][2]];
    g.slow = (const float*)p[kPtr[s][3]];
    g.out_slow = (float*)p[kPtr[s][4]];
    g.out_resp = (float*)p[kPtr[s][5]];
    g.clamp = c[kConst[s][0]] != 0.0f;
    g.acceleration = c[kConst[s][1]];
    g.reset_amount = c[kConst[s][2]];
    g.sh = (const float*)p[14 + 3 * s];
    g.sh_fast = (const float*)p[15 + 3 * s];
    g.out_sh = (float*)p[16 + 3 * s];
  }
  const bool sh = a.sig[0].sh != nullptr;
  for (int s = 0; s < n; ++s)  // with SH, every signal's three planes
    if ((a.sig[s].sh != nullptr) != sh || (a.sig[s].sh_fast != nullptr) != sh ||
        (a.sig[s].out_sh != nullptr) != sh)
      return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const cudaStream_t st = (cudaStream_t)stream;
  if (n == 1 && !sh)
    relax_clamp_moments_kernel<1, false><<<grid, block, 0, st>>>(a);
  else if (n == 1)
    relax_clamp_moments_kernel<1, true><<<grid, block, 0, st>>>(a);
  else if (!sh)
    relax_clamp_moments_kernel<2, false><<<grid, block, 0, st>>>(a);
  else
    relax_clamp_moments_kernel<2, true><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}
