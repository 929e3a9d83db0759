// K14: SIGMA temporal stabilization from the reprojected position on: 5x5 shadow moments with
// the lit/unlit weight, the 2x2 previous viewZ / history-length gathers with plane-distance
// occlusion, the CatRom-or-bilinear-custom sample of the bf16 history, the sigma clamp,
// antilag and "street magic", and the hard-shadow / dead-pixel masks
// (nrdtpu/passes/sigma/kernels.py:298-414). Replaces nrdtpu/kernels/sigma_pallas.py:449
// sigma_ts_pallas. Templated on the channel count (1 or 4). The plain version is
// nrdtpu_torch/kernels/sigma_ts.py:sigma_ts_ref. One thread per pixel.
#include "common.cuh"

namespace {

using nrd::Image;

constexpr float kEps = 1e-6f;
constexpr float kMaxAccumFrameNum = 7.0f;   // SIGMA_MAX_ACCUM_FRAME_NUM
constexpr float kSigmaScale = 3.0f;         // SIGMA_TS_SIGMA_SCALE
constexpr float kDisocclusionThreshold = 0.02f;
constexpr int kBorder = 2;
constexpr int kTaps = (2 * kBorder + 1) * (2 * kBorder + 1);

struct TsArgs {
  const float* shadow;          // (h, w, C) sqrt-packed PostBlur output
  const float* penumbra;        // (h, w) PostBlur penumbra
  const float* view_z;          // (h, w) raw viewZ
  const float* smb_uv;          // (h, w, 2) reprojected uv
  const float* xv_prev_z;       // (h, w) previous view z of the reprojected position
  const float* prev_view_z;     // (h, w) state
  const float* prev_len;        // (h, w) state: history length
  const __nv_bfloat16* hist;    // (h, w, C) state: packed shadow history
  const float* tile;            // (2, h, w): tile value, sky-tile mask
  float* out;                   // (h, w, C) packed shadow
  float* state;                 // (2, h, w): new prev_view_z, new history length
  int w, h;
  float view_z_scale, mrdu, ortho, rect_prev_w, rect_prev_h, stab, denoising_range;
  float gauss[kTaps];
};

template <int C>
__global__ void __launch_bounds__(256) sigma_ts_kernel(TsArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 1> pen{a.penumbra, a.w, a.h};
  const Image<float, C> sh{a.shadow, a.w, a.h};

  const float view_z = fabsf(a.view_z[i]) * a.view_z_scale;
  const float pc = a.penumbra[i];
  float center[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float s = a.shadow[i * C + c];
    center[c] = s * s;
  }
  const float tile_value = a.tile[i], sky = a.tile[plane + i];
  const bool is_hard_shadow = tile_value == 0.0f || pc == 0.0f;

  // local 5x5 moments (:309-327)
  float m1[C], m2[C], wsum = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) m1[c] = m2[c] = 0.0f;
  int t = 0;
  for (int dy = -kBorder; dy <= kBorder; ++dy)
    for (int dx = -kBorder; dx <= kBorder; ++dx, ++t) {
      float w_ = 1.0f;
      if (dx != 0 || dy != 0) {
        const float p = pen.at(x + dx, y + dy, 0);
        w_ = ((pc == 0.0f) == (p == 0.0f) ? 1.0f : 0.0f) * a.gauss[t];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = sh.at(x + dx, y + dy, c);
        const float s = v * v;
        m1[c] = m1[c] + s * w_;
        m2[c] = m2[c] + s * s * w_;
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

  // history length gather with disocclusion (:354-376)
  const float u = a.smb_uv[2 * i], v = a.smb_uv[2 * i + 1];
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  const float ox = floorf(posx), oy = floorf(posy);
  const int bx = nrd::to_index(ox), by = nrd::to_index(oy);
  const Image<float, 1> pz{a.prev_view_z, a.w, a.h};
  const Image<float, 1> pl{a.prev_len, a.w, a.h};
  const int tx[4] = {bx, bx + 1, bx, bx + 1}, ty[4] = {by, by, by + 1, by + 1};
  const float lz = view_z + (1.0f - view_z) * fabsf(a.ortho);
  float threshold = a.mrdu * lz * kDisocclusionThreshold;
  threshold = threshold * nrd::in_screen_nearest(u, v);
  threshold = threshold - kEps;
  const float xz = a.xv_prev_z[i];
  float bw[4], ow[4], lens[4];
  nrd::bilinear_weights(posx - ox, posy - oy, bw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float occ = fabsf(pz.at(tx[k], ty[k], 0) - xz) <= threshold ? 1.0f : 0.0f;
    ow[k] = bw[k] * occ;
    lens[k] = pl.at(tx[k], ty[k], 0);
  }
  const float osum = ow[0] + ow[1] + ow[2] + ow[3];
  const float lsum = lens[0] * ow[0] + lens[1] * ow[1] + lens[2] * ow[2] + lens[3] * ow[3];
  float history_length = osum < 0.0001f ? 0.0f : lsum / osum;

  // sample history (:378-383)
  float hist[C];
  nrd::sample_catrom(Image<__nv_bfloat16, C>{a.hist, a.w, a.h},
                     nrd::saturate(u) * a.rect_prev_w, nrd::saturate(v) * a.rect_prev_h,
                     osum > 3.5f, ow, hist);
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
  float result[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float hc = clamped[c] + (hist[c] - clamped[c]) * street_magic;
    result[c] = center[c] + (hc - center[c]) * mix;
  }

  // hard-shadow pass-through, dead pixels, packing (:402-414)
  if (is_hard_shadow) history_length = kMaxAccumFrameNum;
  const float new_len = fminf(history_length + 1.0f, kMaxAccumFrameNum);
  const bool dead = sky > 0.0f || view_z > a.denoising_range;
#pragma unroll
  for (int c = 0; c < C; ++c)
    a.out[i * C + c] = dead ? a.shadow[i * C + c]
                            : sqrtf(nrd::saturate(is_hard_shadow ? center[c] : result[c]));
  a.state[i] = dead ? a.prev_view_z[i] : view_z;
  a.state[plane + i] = rintf(dead ? a.prev_len[i] : new_len);
}

}  // namespace

// ptrs: shadow, penumbra, view_z, smb_uv, xv_prev_z, prev_view_z, prev_len, hist, tile, out,
//       state
// consts: channels, view_z_scale, min_rect_dim_mul_unproject, ortho, rect_size_prev[2],
//         stabilization_strength, denoising_range, 25 Gaussian weights of the 5x5
extern "C" int nrd_sigma_ts(void* const* p, const float* c, int w, int h, void* stream) {
  TsArgs a;
  a.shadow = (const float*)p[0];
  a.penumbra = (const float*)p[1];
  a.view_z = (const float*)p[2];
  a.smb_uv = (const float*)p[3];
  a.xv_prev_z = (const float*)p[4];
  a.prev_view_z = (const float*)p[5];
  a.prev_len = (const float*)p[6];
  a.hist = (const __nv_bfloat16*)p[7];
  a.tile = (const float*)p[8];
  a.out = (float*)p[9];
  a.state = (float*)p[10];
  a.w = w;
  a.h = h;
  const int channels = (int)c[0];
  if (channels != 1 && channels != 4) return (int)cudaErrorInvalidValue;
  a.view_z_scale = c[1];
  a.mrdu = c[2];
  a.ortho = c[3];
  a.rect_prev_w = c[4];
  a.rect_prev_h = c[5];
  a.stab = c[6];
  a.denoising_range = c[7];
  for (int k = 0; k < kTaps; ++k) a.gauss[k] = c[8 + k];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (channels == 1)
    sigma_ts_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    sigma_ts_kernel<4><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
