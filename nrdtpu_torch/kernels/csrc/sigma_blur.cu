// K13: SIGMA Blur / PostBlur: the dense 5x5 penumbra estimation and the 8-tap Poisson shadow
// filter of nrdtpu/passes/sigma/kernels.py:133-281, per pixel. Replaces
// nrdtpu/kernels/sigma_blur2.py:281 sigma_blur_pallas2 and its v1 twin
// nrdtpu/kernels/sigma_pallas.py:291 sigma_blur_pallas. The plain version is
// nrdtpu_torch/kernels/sigma_blur.py:sigma_blur_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, templated on the launch's modes
// <C, kFirst, kShadow, kDec>: the shadow's channels (1: SIGMA_SHADOW, 4:
// SIGMA_SHADOW_TRANSLUCENCY), the first pass (Blur) or PostBlur (which unpacks its input,
// p * p), whether there is a shadow input at all (not on SIGMA_SHADOW's Blur, where the shadow
// is IsLit(penumbra)), and the normal plane (kDec: the RGBA formats' decoded one,
// common.cuh:unpack_nr, the normal .xyz; the TPU kernel decodes .xy as octahedral at every
// encoding, sigma_blur2.py:122, where the XLA reference unpacks the encoding's normal).
// What a tap derives from its texel alone (the penumbra, the scaled |viewZ|, the view
// position's scale and the unpacked shadow) is the same for every pixel that taps it: the
// CTA first stages its tile's window (halo 2, clamp-to-edge) with those values, once a
// texel, in shared memory, and the dense 5x5 reads it there. A dense tap keeps the unclamped
// uv + d / rect_size of its view position; only its texel is clamped, which the window
// holds already. The 8 Poisson taps land up to 32 px away: each snaps to the pixel centre by
// a multiplication by the reciprocal of rect_size and reads its texel from the window where
// it falls inside, else from global memory through the read-only path, its index clamped
// once. A tap's penumbra weight divides by __fdividef (no value moved outside the tolerance
// at 2560x1440, PERF.md). kMinCtas: the CTAs an SM that ptxas is asked to fit (chosen by A/B
// timing on the card, PERF.md).
#include "common.cuh"

namespace {

using nrd::V3;

constexpr float kFp16Max = 65504.0f;
constexpr float kEps = 1e-6f;
constexpr int kBorder = 2;
constexpr int kDenseTaps = (2 * kBorder + 1) * (2 * kBorder + 1);
constexpr int kPoissonTaps = 8;
constexpr int kTile = nrd::kBlock;         // 16x16 pixels a CTA
constexpr int kWin = kTile + 2 * kBorder;  // its 20x20 window of texels
template <int C>
constexpr int kMinCtas = C == 1 ? 5 : 4;

struct BlurArgs {
  const float* penumbra;  // (h, w)
  const float* shadow;    // (h, w, C), read when there is a shadow input
  const float* view_z;    // (h, w) raw viewZ
  const float* nr;        // (h, w, 4) packed normal/roughness/material
  const float* tile;      // (2, h, w): tile value, sky-tile mask
  float* out_penumbra;    // (h, w)
  float* out_shadow;      // (h, w, C) sqrt-packed
  int w, h;
  int row0, fh;           // the planes' first row in the frame, the frame's height
  float view_z_scale, fr[4], ortho, unproject, mrdu, pds;
  float m[9];             // world_to_view rotation, row-major
  float rot[4];           // the pass's rotator
  float rect_w, rect_h, rinv_x, rinv_y, denoising_range;
  float dense_gauss[kDenseTaps];
  float poisson[kPoissonTaps][3];  // x, y, Gaussian weight
};

__device__ __forceinline__ float is_lit(float p) { return p >= kFp16Max ? 1.0f : 0.0f; }

__device__ __forceinline__ float both_lit_or_unlit(float p1, float p2) {
  return (p1 == 0.0f) == (p2 == 0.0f) ? 1.0f : 0.0f;
}

// One texel as the taps read it: the penumbra, the scaled |viewZ|, the scale of its view
// position (Geometry::ReconstructViewPosition) and the shadow, unpacked on PostBlur.
template <int C>
struct Texel {
  float penum, zs, scale, s[C];
};

template <int C, bool kFirst, bool kShadow>
__device__ __forceinline__ Texel<C> load_texel(const BlurArgs& a, size_t k) {
  Texel<C> t;
  t.penum = __ldg(a.penumbra + k);
  t.zs = fabsf(__ldg(a.view_z + k)) * a.view_z_scale;
  t.scale = t.zs + (1.0f - t.zs) * fabsf(a.ortho);
  if constexpr (!kShadow) {
    t.s[0] = is_lit(t.penum);
  } else if constexpr (C == 4) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(a.shadow) + k);
    const float q[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) t.s[c] = kFirst ? q[c] : q[c] * q[c];
  } else {
    const float p = __ldg(a.shadow + k);
    t.s[0] = kFirst ? p : p * p;
  }
  return t;
}

// The staged window: (penumbra, zs, scale, shadow) a texel with one channel; (penumbra, zs,
// scale, unused) and the shadow's four channels with four.
template <int C>
struct Window {
  float4 g[kWin * kWin];
  float4 s[C == 4 ? kWin * kWin : 1];

  __device__ __forceinline__ void store(int k, const Texel<C>& t) {
    g[k] = make_float4(t.penum, t.zs, t.scale, C == 1 ? t.s[0] : 0.0f);
    if constexpr (C == 4) s[k] = make_float4(t.s[0], t.s[1], t.s[2], t.s[3]);
  }
  __device__ __forceinline__ Texel<C> load(int k) const {
    const float4 q = g[k];
    Texel<C> t;
    t.penum = q.x;
    t.zs = q.y;
    t.scale = q.z;
    if constexpr (C == 1) {
      t.s[0] = q.w;
    } else {
      const float4 p = s[k];
      t.s[0] = p.x;
      t.s[1] = p.y;
      t.s[2] = p.z;
      t.s[3] = p.w;
    }
    return t;
  }
};

// The running sums of the dense and the Poisson taps.
template <int C>
struct Sums {
  float result[C], sum_x, penumbra, sum_y;
};

// one tap of weight w_ into the sums (:205-213, :257-263)
template <int C>
__device__ __forceinline__ void accumulate(Sums<C>& acc, const Texel<C>& t, float w_,
                                           float pixel_size) {
#pragma unroll
  for (int c = 0; c < C; ++c) acc.result[c] = acc.result[c] + (w_ == 0.0f ? 0.0f : t.s[c] * w_);
  acc.sum_x = acc.sum_x + w_;
  w_ = __fdividef(w_ * pixel_size, pixel_size + t.penum);
  w_ = w_ * (1.0f - is_lit(t.penum));
  acc.penumbra = acc.penumbra + (w_ == 0.0f ? 0.0f : t.penum * w_);
  acc.sum_y = acc.sum_y + w_;
}

template <int C, bool kFirst, bool kShadow, bool kDec = false>
__global__ void __launch_bounds__(kTile * kTile, kMinCtas<C>) sigma_blur_kernel(BlurArgs a) {
  __shared__ Window<C> wnd;
  const int ox = (int)blockIdx.x * kTile - kBorder, oy = (int)blockIdx.y * kTile - kBorder;
  for (int k = threadIdx.y * kTile + threadIdx.x; k < kWin * kWin; k += kTile * kTile) {
    const int tx = nrd::clampi(ox + k % kWin, 0, a.w - 1);
    const int ty = nrd::clampi(oy + k / kWin, 0, a.h - 1);
    wnd.store(k, load_texel<C, kFirst, kShadow>(a, (size_t)ty * a.w + tx));
  }
  __syncthreads();
  const int x = ox + kBorder + (int)threadIdx.x, y = oy + kBorder + (int)threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  // the window index of the pixel's own texel
  const int wc = ((int)threadIdx.y + kBorder) * kWin + (int)threadIdx.x + kBorder;

  const float u = nrd::pixel_u(x, a.w), v = nrd::pixel_u(y + a.row0, a.fh);
  const Texel<C> ct = wnd.load(wc);
  const float view_z = ct.zs;
  const float pc = ct.penum;
  const float tile_value = a.tile[i], sky = a.tile[plane + i];

  // the centre's geometry (:163-176)
  const V3 xv = nrd::reconstruct_view_position(u, v, a.fr, view_z, a.ortho);
  const V3 n = nrd::unpack_nr<kDec>(__ldg(reinterpret_cast<const float4*>(a.nr) + i)).n;
  const V3 nv{a.m[0] * n.x + a.m[1] * n.y + a.m[2] * n.z,
              a.m[3] * n.x + a.m[4] * n.y + a.m[5] * n.z,
              a.m[6] * n.x + a.m[7] * n.y + a.m[8] * n.z};
  const float lz = ct.scale;  // view_z + (1 - view_z) |ortho|
  const float pixel_size = a.unproject * lz;
  const float frustum_size = a.mrdu * lz;
  V3 vv{0.0f, 0.0f, -1.0f};
  if (a.ortho == 0.0f) {
    const float inv = rsqrtf(fmaxf(xv.x * xv.x + xv.y * xv.y + xv.z * xv.z, 1e-15f));
    vv = V3{-xv.x * inv, -xv.y * inv, -xv.z * inv};
  }
  const float nov = fabsf(nrd::dot3(nv, vv));
  const float ga = 1.0f / (a.pds * frustum_size);
  const float gb = -(nrd::dot3(nv, xv) * ga);

  // dense 5x5 estimation (:178-213) from the window; a tap's view position is
  // ((u + dx / w) fr[2] + fr[0]) scale, ((v + dy / h) fr[3] + fr[1]) scale, zs
  Sums<C> acc;
#pragma unroll
  for (int c = 0; c < C; ++c) acc.result[c] = 0.0f;
  acc.sum_x = acc.penumbra = acc.sum_y = 0.0f;
  float px[2 * kBorder + 1];
#pragma unroll
  for (int dx = -kBorder; dx <= kBorder; ++dx)
    px[dx + kBorder] = (u + (float)dx * a.rinv_x) * a.fr[2] + a.fr[0];
#pragma unroll
  for (int dy = -kBorder; dy <= kBorder; ++dy) {
    const float py = (v + (float)dy * a.rinv_y) * a.fr[3] + a.fr[1];
    const int row = wc + dy * kWin;
#pragma unroll
    for (int dx = -kBorder; dx <= kBorder; ++dx) {
      const Texel<C> t = wnd.load(row + dx);
      float w_ = 1.0f;
      if (dx != 0 || dy != 0) {
        const V3 xvs{px[dx + kBorder] * t.scale, py * t.scale, t.zs};
        w_ = nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
        w_ = w_ * both_lit_or_unlit(pc, t.penum);
        w_ = w_ * a.dense_gauss[(dy + kBorder) * (2 * kBorder + 1) + dx + kBorder];
      }
      accumulate<C>(acc, t, w_, pixel_size);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) acc.result[c] = acc.result[c] / acc.sum_x;
  acc.penumbra = acc.penumbra / fmaxf(acc.sum_y, kEps);
  acc.sum_y = acc.sum_y != 0.0f ? 1.0f : 0.0f;
  const float f = nrd::smoothstep(0.0f, (float)kBorder, acc.penumbra / pixel_size);
#pragma unroll
  for (int c = 0; c < C; ++c) acc.result[c] = ct.s[c] + (acc.result[c] - ct.s[c]) * f;

  // sparse 8-tap Poisson (:215-263)
  const float f4 = 4.0f + (1.0f - 4.0f) * f;
#pragma unroll
  for (int c = 0; c < C; ++c) acc.result[c] = acc.result[c] * f4;
  acc.penumbra = acc.penumbra * f4;
  acc.sum_x = f4;
  acc.sum_y = acc.sum_y * f4;
  const float unclamped = acc.penumbra / pixel_size * tile_value;
  const float blur_radius = fminf(fmaxf(unclamped, fminf(unclamped, 2.0f)), 32.0f);
  float skx = (1.0f - fabsf(nv.x)) + (1.0f - (1.0f - fabsf(nv.x))) * nov;
  float sky_ = (1.0f - fabsf(nv.y)) + (1.0f - (1.0f - fabsf(nv.y))) * nov;
  const float skew_max = fmaxf(skx, sky_);
  skx = skx / skew_max * a.rinv_x * blur_radius;
  sky_ = sky_ / skew_max * a.rinv_y * blur_radius;
  const float r0 = a.rot[0] * skx, r1 = a.rot[1] * sky_, r2 = a.rot[2] * skx,
              r3 = a.rot[3] * sky_;
  const float inv_estimated_penumbra = 1.0f / fmaxf(acc.penumbra, kEps);
#pragma unroll
  for (int k = 0; k < kPoissonTaps; ++k) {
    const float ox_ = a.poisson[k][0], oy_ = a.poisson[k][1];
    float us = u + (ox_ * r0 + oy_ * r2), vs = v + (ox_ * r1 + oy_ * r3);
    us = (floorf(us * a.rect_w) + 0.5f) * a.rinv_x;  // snap to the pixel centre (:238)
    vs = (floorf(vs * a.rect_h) + 0.5f) * a.rinv_y;
    const int tx = nrd::clampi(nrd::to_index(floorf(us * (float)a.w)), 0, a.w - 1);
    const int ty = nrd::clampi(nrd::to_index(floorf(vs * (float)a.fh)) - a.row0, 0, a.h - 1);
    const int wi = tx - ox, wj = ty - oy;  // the texel's place in the window
    const Texel<C> t = ((unsigned)wi < (unsigned)kWin && (unsigned)wj < (unsigned)kWin)
                           ? wnd.load(wj * kWin + wi)
                           : load_texel<C, kFirst, kShadow>(a, (size_t)ty * a.w + tx);
    const V3 xvs{(us * a.fr[2] + a.fr[0]) * t.scale, (vs * a.fr[3] + a.fr[1]) * t.scale, t.zs};
    float w_ = nrd::in_screen_nearest(us, vs);
    w_ = w_ * nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
    w_ = w_ * both_lit_or_unlit(pc, t.penum);
    w_ = w_ * a.poisson[k][2];
    w_ = w_ * nrd::saturate(t.penum * inv_estimated_penumbra);  // umbra-leak guard (:256)
    accumulate<C>(acc, t, w_, pixel_size);
  }

  // final normalisation and the pass-through masks (:265-281)
  const bool no_denoise = tile_value == 0.0f || pc == 0.0f || sky > 0.0f ||
                          view_z > a.denoising_range;
  a.out_penumbra[i] = no_denoise ? pc
                      : (acc.sum_y == 0.0f ? pc : acc.penumbra / fmaxf(acc.sum_y, kEps));
#pragma unroll
  for (int c = 0; c < C; ++c)
    a.out_shadow[i * C + c] =
        sqrtf(nrd::saturate(no_denoise ? ct.s[c] : acc.result[c] / acc.sum_x));
}

using Kernel = void (*)(BlurArgs);

}  // namespace

// ptrs: penumbra, shadow (the penumbra in its place without one), view_z, nr, tile,
//       out_penumbra, out_shadow
// consts: channels, first_pass, has_shadow, view_z_scale, frustum[4], ortho, unproject,
//         min_rect_dim_mul_unproject, plane_dist_sensitivity, m[9], rotator[4],
//         rect_size[2], rect_size_inv[2], denoising_range, 25 dense Gaussian weights,
//         8 x (x, y, Gaussian weight) Poisson taps, the plane decoded (kDec: 0 or 1), the
//         planes' first row in the frame and the frame's height (a band of rows: the uv and
//         the taps' rows are the frame's, a texel is read at its frame row minus row0)
extern "C" int nrd_sigma_blur(void* const* p, const float* c, int w, int h, void* stream) {
  BlurArgs a;
  a.penumbra = (const float*)p[0];
  a.shadow = (const float*)p[1];
  a.view_z = (const float*)p[2];
  a.nr = (const float*)p[3];
  a.tile = (const float*)p[4];
  a.out_penumbra = (float*)p[5];
  a.out_shadow = (float*)p[6];
  a.w = w;
  a.h = h;
  const int channels = (int)c[0];
  const bool first_pass = c[1] != 0.0f, has_shadow = c[2] != 0.0f;
  if (channels != 1 && channels != 4) return (int)cudaErrorInvalidValue;
  if (!has_shadow && channels != 1) return (int)cudaErrorInvalidValue;
  a.view_z_scale = c[3];
  for (int k = 0; k < 4; ++k) a.fr[k] = c[4 + k];
  a.ortho = c[8];
  a.unproject = c[9];
  a.mrdu = c[10];
  a.pds = c[11];
  for (int k = 0; k < 9; ++k) a.m[k] = c[12 + k];
  for (int k = 0; k < 4; ++k) a.rot[k] = c[21 + k];
  a.rect_w = c[25];
  a.rect_h = c[26];
  a.rinv_x = c[27];
  a.rinv_y = c[28];
  a.denoising_range = c[29];
  for (int k = 0; k < kDenseTaps; ++k) a.dense_gauss[k] = c[30 + k];
  for (int k = 0; k < kPoissonTaps; ++k)
    for (int j = 0; j < 3; ++j) a.poisson[k][j] = c[30 + kDenseTaps + 3 * k + j];
  const bool dec = c[30 + kDenseTaps + 3 * kPoissonTaps] != 0.0f;
  a.row0 = (int)c[31 + kDenseTaps + 3 * kPoissonTaps];
  a.fh = (int)c[32 + kDenseTaps + 3 * kPoissonTaps];
  // without a shadow input the pass reads no shadow, so the first-pass flag does not matter;
  // the decoded plane (kDec) in the modes that the two SIGMA variants launch
  const Kernel kernel = dec ? (!has_shadow      ? sigma_blur_kernel<1, true, false, true>
                               : channels == 1 && first_pass ? nullptr
                               : channels == 1  ? sigma_blur_kernel<1, false, true, true>
                               : first_pass     ? sigma_blur_kernel<4, true, true, true>
                                                : sigma_blur_kernel<4, false, true, true>)
                        : !has_shadow                 ? sigma_blur_kernel<1, true, false>
                        : channels == 1 && first_pass ? sigma_blur_kernel<1, true, true>
                        : channels == 1               ? sigma_blur_kernel<1, false, true>
                        : first_pass                  ? sigma_blur_kernel<4, true, true>
                                                      : sigma_blur_kernel<4, false, true>;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
