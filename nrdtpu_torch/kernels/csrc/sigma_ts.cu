// K14: SIGMA temporal stabilization, the surface-motion reprojection included: 5x5 shadow
// moments with the lit/unlit weight, the reprojected position and its previous view z (both
// motion-vector branches), the 2x2 previous viewZ / history-length gathers with plane-distance
// occlusion, the CatRom-or-bilinear-custom sample of the bf16 history, the sigma clamp,
// antilag and "street magic", and the hard-shadow / dead-pixel masks
// (nrdtpu/passes/sigma/kernels.py:290-414). Replaces nrdtpu/kernels/sigma_pallas.py:449
// sigma_ts_pallas. The plain version is nrdtpu_torch/kernels/sigma_ts.py:sigma_ts_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, one instance per channel count
// <C> (1: SIGMA_SHADOW, 4: SIGMA_SHADOW_TRANSLUCENCY), at most kMinCtas' register budget: 5
// and 4 CTAs an SM, no spill (<4> at 5 spilled 44 B; PERF.md).
//   - The reprojection that the pass glue ran as ~110 full-resolution torch operations is
//     per-pixel arithmetic on host constants (common.cuh:surface_motion): the kernel reads
//     IN_MV (12 B) in place of the glue's uv and previous view z planes (12 B). The
//     motion-vector branches are uniform branches on those constants (a build with the
//     screen-space branch fixed at compile time measured no faster; PERF.md).
//   - The 5x5 moments read every texel 25 times: each CTA first stages its 20x20 window
//     (halo 2, clamp-to-edge) in shared memory, once a texel: the squared shadow (a float4
//     with four channels) and whether its penumbra is 0. The taps keep the plain version's
//     order, row by row, and the IEEE division by the weight sum (the clamp's
//     sqrt(|m2 - m1^2|) of a vanishing variance turns one ulp of m1 into ~1e-4).
//   - A hard-shadow pixel (tile value 0 or penumbra 0) passes its centre through with the
//     full history length, a dead one (sky tile, beyond the denoising range) its input and
//     its state: neither reads the moments, the reprojection or the history, which the plain
//     version computes and then discards.
//   - The bf16 history through common.cuh:catrom_apply4, one wide load a texel where its
//     weight is non-zero (uint2 with four channels, a 16-bit load with one); the output with
//     four channels as one float4 store.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kEps = 1e-6f;
constexpr float kMaxAccumFrameNum = 7.0f;   // SIGMA_MAX_ACCUM_FRAME_NUM
constexpr float kSigmaScale = 3.0f;         // SIGMA_TS_SIGMA_SCALE
constexpr float kDisocclusionThreshold = 0.02f;
constexpr int kBorder = 2;
constexpr int kTaps = (2 * kBorder + 1) * (2 * kBorder + 1);
constexpr int kTile = nrd::kBlock;         // 16x16 pixels a CTA
constexpr int kWin = kTile + 2 * kBorder;  // its 20x20 window of texels
template <int C>
constexpr int kMinCtas = C == 1 ? 5 : 4;

struct TsArgs {
  const float* shadow;          // (h, w, C) sqrt-packed PostBlur output
  const float* penumbra;        // (h, w) PostBlur penumbra
  const float* view_z;          // (h, w) raw viewZ
  const float* mv;              // (h, w, 3) IN_MV
  const float* prev_view_z;     // (ph, w) state
  const float* prev_len;        // (ph, w) state: history length
  const __nv_bfloat16* hist;    // (ph, w, C) state: packed shadow history
  const float* tile;            // (2, h, w): tile value, sky-tile mask
  float* out;                   // (h, w, C) packed shadow
  float* state;                 // (2, h, w): new prev_view_z, new history length
  int w, h;
  int row0, fh;                 // the current planes' first row in the frame, its height
  int ph;                       // the previous planes' height
  float view_z_scale, mrdu, rect_prev_w, rect_prev_h, stab, denoising_range;
  nrd::SurfaceMotionConsts smc;
  float gauss[kTaps];
};

// the channels of one texel as a float4 (C = 4) or a float (C = 1)
template <int C>
using Texel = std::conditional_t<C == 4, float4, float>;

__device__ __forceinline__ float4 load_texel(const float4* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load_texel(const float* p, size_t i) { return __ldg(p + i); }

// The staged window: each texel's squared shadow and whether its penumbra is 0.
template <int C>
struct Window {
  Texel<C> s[kWin * kWin];
  bool umbra[kWin * kWin];
};

template <int C>
__device__ __forceinline__ void channels(Texel<C> t, float out[C]) {
  if constexpr (C == 4) {
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else {
    out[0] = t;
  }
}

template <int C>
__global__ void __launch_bounds__(kTile * kTile, kMinCtas<C>) sigma_ts_kernel(TsArgs a) {
  __shared__ Window<C> wnd;
  const Texel<C>* shadow = reinterpret_cast<const Texel<C>*>(a.shadow);
  const int ox = (int)blockIdx.x * kTile - kBorder, oy = (int)blockIdx.y * kTile - kBorder;
  for (int k = threadIdx.y * kTile + threadIdx.x; k < kWin * kWin; k += kTile * kTile) {
    const int tx = nrd::clampi(ox + k % kWin, 0, a.w - 1);
    const int ty = nrd::clampi(oy + k / kWin, 0, a.h - 1);
    const size_t j = (size_t)ty * a.w + tx;
    float q[C];
    channels<C>(load_texel(shadow, j), q);
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = q[c] * q[c];
    if constexpr (C == 4)
      wnd.s[k] = make_float4(q[0], q[1], q[2], q[3]);
    else
      wnd.s[k] = q[0];
    wnd.umbra[k] = __ldg(a.penumbra + j) == 0.0f;
  }
  __syncthreads();
  const int x = ox + kBorder + (int)threadIdx.x, y = oy + kBorder + (int)threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  // the window index of the pixel's own texel
  const int wc = ((int)threadIdx.y + kBorder) * kWin + (int)threadIdx.x + kBorder;

  const float view_z = fabsf(__ldg(a.view_z + i)) * a.view_z_scale;
  const bool umbra_c = wnd.umbra[wc];
  float center[C];
  channels<C>(wnd.s[wc], center);
  const float tile_value = __ldg(a.tile + i), sky = __ldg(a.tile + plane + i);
  const bool is_hard_shadow = tile_value == 0.0f || umbra_c;
  const bool dead = sky > 0.0f || view_z > a.denoising_range;

  float packed[C];  // the pixel's output (:402-414)
  float new_z, new_len;
  if (dead) {  // the input and the state pass through
    channels<C>(load_texel(shadow, i), packed);
    const size_t pi = (size_t)nrd::clampi(y + a.row0, 0, a.ph - 1) * a.w + x;
    new_z = __ldg(a.prev_view_z + pi);
    new_len = rintf(__ldg(a.prev_len + pi));
  } else if (is_hard_shadow) {  // the centre, with the full history length
#pragma unroll
    for (int c = 0; c < C; ++c) packed[c] = sqrtf(nrd::saturate(center[c]));
    new_z = view_z;
    new_len = kMaxAccumFrameNum;  // min(7 + 1, 7), rounded
  } else {
    // local 5x5 moments (:309-327) from the window, row by row
    float m1[C], m2[C], wsum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) m1[c] = m2[c] = 0.0f;
#pragma unroll
    for (int dy = -kBorder; dy <= kBorder; ++dy)
#pragma unroll
      for (int dx = -kBorder; dx <= kBorder; ++dx) {
        const int k = wc + dy * kWin + dx;
        const int t = (dy + kBorder) * (2 * kBorder + 1) + dx + kBorder;
        const float w_ = dx == 0 && dy == 0 ? 1.0f
                                            : (umbra_c == wnd.umbra[k] ? 1.0f : 0.0f) * a.gauss[t];
        float s[C];
        channels<C>(wnd.s[k], s);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          m1[c] = m1[c] + s[c] * w_;
          m2[c] = m2[c] + s[c] * s[c] * w_;
        }
        wsum = wsum + w_;
      }
    float sigma[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      m1[c] = m1[c] / wsum;
      m2[c] = m2[c] / wsum;
      sigma[c] = sqrtf(fabsf(m2[c] - m1[c] * m1[c]));
    }

    // the reprojected position (:329-352)
    const float mv_in[3] = {__ldg(a.mv + 3 * i), __ldg(a.mv + 3 * i + 1), __ldg(a.mv + 3 * i + 2)};
    const nrd::SurfaceMotion sm =
        nrd::surface_motion(a.smc, nrd::pixel_u(x, a.w), nrd::pixel_u(y + a.row0, a.fh), view_z,
                            mv_in);

    // history length gather with disocclusion (:354-376)
    const float posx = sm.u * a.rect_prev_w - 0.5f, posy = sm.v * a.rect_prev_h - 0.5f;
    const float fx = floorf(posx), fy = floorf(posy);
    const int bx = nrd::to_index(fx), by = nrd::to_index(fy);
    const int c0 = nrd::clampi(bx, 0, a.w - 1), c1 = nrd::clampi(bx + 1, 0, a.w - 1);
    const size_t r0 = (size_t)nrd::clampi(by, 0, a.ph - 1) * a.w;
    const size_t r1 = (size_t)nrd::clampi(by + 1, 0, a.ph - 1) * a.w;
    const size_t idx[4] = {r0 + c0, r0 + c1, r1 + c0, r1 + c1};
    const float lz = view_z + (1.0f - view_z) * fabsf(a.smc.ortho);
    float threshold = a.mrdu * lz * kDisocclusionThreshold;
    threshold = threshold * nrd::in_screen_nearest(sm.u, sm.v);
    threshold = threshold - kEps;
    float bw[4], ow[4], lens[4];
    nrd::bilinear_weights(posx - fx, posy - fy, bw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float occ =
          fabsf(__ldg(a.prev_view_z + idx[k]) - sm.xv_prev_z) <= threshold ? 1.0f : 0.0f;
      ow[k] = bw[k] * occ;
      lens[k] = __ldg(a.prev_len + idx[k]);
    }
    const float osum = ow[0] + ow[1] + ow[2] + ow[3];
    const float lsum = lens[0] * ow[0] + lens[1] * ow[1] + lens[2] * ow[2] + lens[3] * ow[3];
    float history_length = osum < 0.0001f ? 0.0f : lsum / osum;

    // sample history (:378-383)
    const nrd::CatromTaps taps = nrd::catrom_taps(nrd::saturate(sm.u) * a.rect_prev_w,
                                                  nrd::saturate(sm.v) * a.rect_prev_h,
                                                  osum > 3.5f, ow);
    using Bf16Texel = std::conditional_t<C == 4, uint2, unsigned short>;
    const Bf16Texel* img[1] = {reinterpret_cast<const Bf16Texel*>(a.hist)};
    Texel<C> sampled[1];
    nrd::catrom_apply4<1>(img, a.w, a.ph, taps, sampled);
    float hist[C];
    channels<C>(sampled[0], hist);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float s = nrd::saturate(hist[c]);
      hist[c] = s * s;
    }

    // clamp, antilag, street magic (:385-400)
    const float scale = kSigmaScale + (1.0f - kSigmaScale) * (1.0f / (1.0f + history_length));
    float clamped[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float sg = sigma[c] * scale;
      clamped[c] = fminf(fmaxf(hist[c], m1[c] - sg), m1[c] + sg);
    }
    float antilag = fabsf(clamped[0] - hist[0]);
    antilag = sqrtf(nrd::saturate(antilag));
    antilag = nrd::saturate(1.0f - antilag);
    history_length = history_length * antilag;
    const float history_weight = history_length / (1.0f + history_length);
    const float street_magic = 0.6f * history_weight * antilag;
    const float mix = fminf(history_weight, a.stab);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float hc = clamped[c] + (hist[c] - clamped[c]) * street_magic;
      packed[c] = sqrtf(nrd::saturate(center[c] + (hc - center[c]) * mix));
    }
    new_z = view_z;
    new_len = rintf(fminf(history_length + 1.0f, kMaxAccumFrameNum));
  }
  if constexpr (C == 4)
    reinterpret_cast<float4*>(a.out)[i] = make_float4(packed[0], packed[1], packed[2], packed[3]);
  else
    a.out[i] = packed[0];
  a.state[i] = new_z;
  a.state[plane + i] = new_len;
}

}  // namespace

// ptrs: shadow, penumbra, view_z, mv, prev_view_z, prev_len, hist, tile, out, state
// consts: channels, view_z_scale, min_rect_dim_mul_unproject, rect_size_prev[2],
//         stabilization_strength, denoising_range, 25 Gaussian weights of the 5x5, then the
//         reprojection's (sigma_ts.py:reprojection_consts): frustum[4], frustum_prev[4],
//         world_to_view[:3, :3], world_to_view_prev[:3, :4], world_to_clip_prev rows 0, 1, 3,
//         camera_delta[3], mv_scale[:3], mv_scale[2] != 0, mv_scale[3] != 0, ortho_mode,
//         then the current planes' first row in the frame and the frame's height, and the
//         previous planes' height (the whole frame's under a band of its rows; same width)
extern "C" int nrd_sigma_ts(void* const* p, const float* c, int w, int h, void* stream) {
  TsArgs a;
  a.shadow = (const float*)p[0];
  a.penumbra = (const float*)p[1];
  a.view_z = (const float*)p[2];
  a.mv = (const float*)p[3];
  a.prev_view_z = (const float*)p[4];
  a.prev_len = (const float*)p[5];
  a.hist = (const __nv_bfloat16*)p[6];
  a.tile = (const float*)p[7];
  a.out = (float*)p[8];
  a.state = (float*)p[9];
  a.w = w;
  a.h = h;
  const int channels = (int)c[0];
  if (channels != 1 && channels != 4) return (int)cudaErrorInvalidValue;
  a.view_z_scale = c[1];
  a.mrdu = c[2];
  a.rect_prev_w = c[3];
  a.rect_prev_h = c[4];
  a.stab = c[5];
  a.denoising_range = c[6];
  for (int k = 0; k < kTaps; ++k) a.gauss[k] = c[7 + k];
  const float* r = c + 7 + kTaps;
  nrd::SurfaceMotionConsts& k = a.smc;
  for (int j = 0; j < 4; ++j) k.fr[j] = r[j];
  for (int j = 0; j < 4; ++j) k.fr_prev[j] = r[4 + j];
  for (int j = 0; j < 9; ++j) k.wtv[j] = r[8 + j];
  for (int j = 0; j < 12; ++j) k.wtv_prev[j] = r[17 + j];
  for (int j = 0; j < 12; ++j) k.wtc_prev[j] = r[29 + j];
  for (int j = 0; j < 3; ++j) k.cd[j] = r[41 + j];
  for (int j = 0; j < 3; ++j) k.mvs[j] = r[44 + j];
  k.mv_z_given = r[47] != 0.0f;
  k.world_mv = r[48] != 0.0f;
  k.ortho = r[49];
  a.row0 = (int)r[50];
  a.fh = (int)r[51];
  a.ph = (int)r[52];
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  if (channels == 1)
    sigma_ts_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    sigma_ts_kernel<4><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
