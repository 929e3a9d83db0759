// H4: REBLUR temporal stabilization, one half (one signal) in one launch: the 3x3 luma moments
// and min/max over the 8 neighbours, the luma-stabilization history sampled at the
// surface-motion position with the occlusion and footprint quality of fbits bits 0-3 (and, for
// specular, at the virtual-motion position with bits 4-7, the two combined by the virtual
// history amount), then the rest of the half per pixel: the RCRS clamp, the antilag, the
// temporal-accumulation weight, the split-screen tests, the history clamp and the blend capped
// by the stabilization strength, the new accumulation speed and the luma change
// (nrdtpu/passes/reblur/kernels.py:2338-2410 diffuse, 2458-2540 specular). Replaces
// nrdtpu/kernels/reblur_pallas.py:1754 moments_minmax_pallas and :1705 hist_sample_pallas. The
// plain version is nrdtpu_torch/kernels/ts_prelude.py:ts_prelude_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, one instance per half <kSpec>, 56
// registers and 4 CTAs an SM, no spill (at 5 CTAs it spills 4-16 B; PERF.md).
//   - Every luma texel is a tap of 9 pixels: each CTA first stages its 18x18 window (halo 1,
//     clamp-to-edge) of the signal's .x in shared memory; the taps read it in the plain
//     version's order (dy outer, dx inner). No separate luma plane is made for the launch.
//     Each thread loads its pixel's uv, fbits and accumulation speed and its two window
//     texels before the barrier, so that their latencies overlap (6-8 % faster than a staging
//     loop followed by the pixel's loads).
//   - The bf16 history through common.cuh:catrom_apply4 (the 5 bilinear samples in order, a
//     texel read only where its weight is non-zero), once for each motion.
//   - The glue that read the moments and samples back (~50-80 full-resolution torch launches a
//     half: the footprint qualities from stacked fbits planes, the antilag, the split-screen
//     masks, the clamp and blend, the luma change with its cat) is per-pixel arithmetic on host
//     constants: it runs here term by term, true divisions kept (the pixel uv feeds the
//     split-screen test, the accumulation speed is next frame's history length), and writes the
//     stabilized signal (float4), its luma and the new accumulation speed.
// REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION (kDir, the diffuse half only, <false, true>): the luma
// is the signal's .w (TS with luma_is_last, nrdtpu/passes/reblur/kernels.py:2400-2404), so the
// window stages .w, and the luma change scales .xyz by (luma_stab + 1e-6) / (.w + 1e-6) and
// sets .w to luma_stab (nrdtpu/passes/reblur/common.py:139-147). The other instances compile as
// before.
// The RGBA normal encodings (kDec, the specular half only, <true, false, true>): nr is the plane
// that the frame decodes once (frontend.py:decode_normal_plane, its roughness decoded): the
// roughness .w and the material 0, which is still compared with the strand material id, as the
// reference compares it (nrdtpu/passes/reblur/kernels.py:2531). The diffuse half reads no
// normal. The other instances compile as before.
#include "common.cuh"

namespace {

constexpr int kBorder = 1;
constexpr int kTile = nrd::kBlock;         // 16x16 pixels a CTA
constexpr int kWin = kTile + 2 * kBorder;  // its 18x18 window of luma texels
constexpr int kMinCtas = 4;
static_assert(kWin * kWin <= 2 * kTile * kTile, "two window texels a thread");
constexpr float kEps = 1e-6f;

struct TsArgs {
  const float* signal;         // (h, w, 4) PostBlur output; .x is its luma
  const __nv_bfloat16* hist;   // (h, w) luma-stabilization history
  const float* smb_uv;         // (h, w, 2) surface-motion uv
  const float* fbits;          // (h, w) footprint bits: 0-3 surface, 4-7 virtual motion
  const float* data1;          // (h, w) accumulation speed
  const float* vmb_uv;         // (h, w, 2) virtual-motion uv (specular)
  const float* vha;            // (h, w) virtual history amount (specular)
  const float* nr;             // (h, w, 4) IN_NORMAL_ROUGHNESS: .z roughness, .w material / 3
                               //   (kDec: the decoded plane, .w roughness, no material)
  float* out;                  // (h, w, 4) stabilized signal
  float* planes;               // (2, h, w): luma_stab, new accumulation speed
  int w, h;
  float rect_prev_w, rect_prev_h;
  bool rcrs;                   // maxBlurRadius != 0
  float split_screen, split_screen_prev;
  float antilag_sigma_scale, antilag_magic, ta_sigma_scale, stab, fix_frame_num;
  float responsive_threshold, strand_material_id;  // specular
};

struct Sample {
  float history, quality;
};

// The history at uv with the occlusion of fbits bits first_bit..first_bit+3, clamped to 0, and
// the footprint quality sqrt(saturate(sum of the unoccluded bilinear weights)).
__device__ __forceinline__ Sample sample_history(const TsArgs& a, float u, float v, int bits,
                                                 int first_bit) {
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  float bw[4];
  nrd::bilinear_weights(posx - floorf(posx), posy - floorf(posy), bw);
  float ow[4], occ_sum = 0.0f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float o = (float)((bits >> (first_bit + b)) & 1);
    ow[b] = bw[b] * o;
    occ_sum = occ_sum + o;
  }
  const nrd::CatromTaps taps = nrd::catrom_taps(nrd::saturate(u) * a.rect_prev_w,
                                                nrd::saturate(v) * a.rect_prev_h,
                                                occ_sum > 3.5f, ow);
  const unsigned short* img[1] = {reinterpret_cast<const unsigned short*>(a.hist)};
  float h[1];
  nrd::catrom_apply4<1>(img, a.w, a.h, taps, h);
  return Sample{fmaxf(h[0], 0.0f),
                sqrtf(nrd::saturate(ow[0] + ow[1] + ow[2] + ow[3]))};
}

// Window texel k: the signal's .x (kDir: its .w)
template <bool kDir = false>
__device__ __forceinline__ float luma_texel(const TsArgs& a, int ox, int oy, int k) {
  const int tx = nrd::clampi(ox + k % kWin, 0, a.w - 1);
  const int ty = nrd::clampi(oy + k / kWin, 0, a.h - 1);
  return __ldg(a.signal + 4 * ((size_t)ty * a.w + tx) + (kDir ? 3 : 0));
}

template <bool kSpec, bool kDir = false, bool kDec = false>
__global__ void __launch_bounds__(kTile * kTile, kMinCtas) ts_prelude_kernel(TsArgs a) {
  static_assert(!(kSpec && kDir), "directional occlusion: the diffuse half only");
  static_assert(!kDec || kSpec, "the decoded plane: the specular half only");
  __shared__ float luma_wnd[kWin * kWin];
  const int ox = (int)blockIdx.x * kTile - kBorder, oy = (int)blockIdx.y * kTile - kBorder;
  // the pixel's own inputs, then its two texels of the window, every load issued before the
  // barrier (a thread outside the image reads the edge's and leaves after it)
  const int x = ox + kBorder + (int)threadIdx.x, y = oy + kBorder + (int)threadIdx.y;
  const size_t i = (size_t)min(y, a.h - 1) * a.w + min(x, a.w - 1);
  const int bits = (int)__ldg(a.fbits + i);
  const float2 smb_uv = __ldg(reinterpret_cast<const float2*>(a.smb_uv) + i);
  const float data1 = __ldg(a.data1 + i);
  const int t0 = threadIdx.y * kTile + threadIdx.x, t1 = t0 + kTile * kTile;
  const bool two = t1 < kWin * kWin;
  const float l0 = luma_texel<kDir>(a, ox, oy, t0);
  const float l1 = luma_texel<kDir>(a, ox, oy, two ? t1 : t0);
  luma_wnd[t0] = l0;
  if (two) luma_wnd[t1] = l1;
  __syncthreads();
  if (x >= a.w || y >= a.h) return;
  const size_t plane = (size_t)a.w * a.h;
  const int wc = ((int)threadIdx.y + kBorder) * kWin + (int)threadIdx.x + kBorder;

  // 3x3 moments and the min/max of the 8 neighbours (lines 131-135)
  float m1 = 0.0f, m2 = 0.0f, lmin = 1e6f, lmax = -1e6f;
#pragma unroll
  for (int dy = -kBorder; dy <= kBorder; ++dy)
#pragma unroll
    for (int dx = -kBorder; dx <= kBorder; ++dx) {
      const float t = luma_wnd[wc + dy * kWin + dx];
      m1 = m1 + t;
      m2 = m2 + t * t;
      if (dy != 0 || dx != 0) {
        lmin = fminf(lmin, t);
        lmax = fmaxf(lmax, t);
      }
    }
  m1 = m1 / 9.0f;
  m2 = m2 / 9.0f;
  const float sigma = sqrtf(fabsf(m2 - m1 * m1));
  const float luma = luma_wnd[wc];
  const float luma_rcrs = a.rcrs ? fminf(fmaxf(luma, lmin), lmax) : luma;

  // the history and the footprint quality at the reprojected position(s)
  const Sample smb = sample_history(a, smb_uv.x, smb_uv.y, bits, 0);
  float history = smb.history, quality = smb.quality;
  float vha = 0.0f;
  float2 vmb_uv = make_float2(0.0f, 0.0f);
  if constexpr (kSpec) {
    vha = __ldg(a.vha + i);
    vmb_uv = __ldg(reinterpret_cast<const float2*>(a.vmb_uv) + i);
    const Sample vmb = sample_history(a, vmb_uv.x, vmb_uv.y, bits, 4);
    history = smb.history + (vmb.history - smb.history) * vha;
    quality = smb.quality + (vmb.quality - smb.quality) * vha;
  }

  // ComputeAntilag (REBLUR_Common.hlsli:244-274)
  const float s = sigma * a.antilag_sigma_scale;
  const float hc = fminf(fmaxf(history, m1 - s), m1 + s);
  const float d = fabsf(history - hc) / (fmaxf(history, hc) + kEps);
  const float antilag = 1.0f / (1.0f + d * (quality * data1) / a.antilag_magic);

  // the temporal-accumulation weight (REBLUR_Common.hlsli:297-306) and the split screen
  const float taw = quality * data1 / (1.0f + data1);
  const float ta_sigma_scale = 1.0f + a.ta_sigma_scale * taw;
  float history_weight = taw * antilag;
  history_weight = history_weight * (nrd::pixel_u(x, a.w) >= a.split_screen ? 1.0f : 0.0f);
  const float smb_ok = smb_uv.x >= a.split_screen_prev ? 1.0f : 0.0f;
  if constexpr (kSpec) {
    const float vmb_ok = vmb_uv.x >= a.split_screen_prev ? 1.0f : 0.0f;
    history_weight = history_weight * (vha != 1.0f ? smb_ok : 1.0f);
    history_weight = history_weight * (vha != 0.0f ? vmb_ok : 1.0f);
    const float4 nr = __ldg(reinterpret_cast<const float4*>(a.nr) + i);
    const float roughness = kDec ? nr.w : nr.z;
    const float material = kDec ? 0.0f : nr.w * 3.0f;
    // RemapRoughnessToResponsiveFactor: smoothstep01((roughness + eps) / threshold)
    const float f = nrd::saturate((roughness + kEps) / a.responsive_threshold);
    const float responsive_factor = f * f * (3.0f - 2.0f * f);
    const float smc = nrd::spec_magic_curve(roughness);
    const float acceleration = smc + (1.0f - smc) * (0.5f + responsive_factor * 0.5f);
    history_weight =
        history_weight * (material == a.strand_material_id ? 0.5f : acceleration);
  } else {
    history_weight = history_weight * smb_ok;
  }

  // the history clamp, the blend, the accumulation speed and ChangeLuma
  const float sg = sigma * ta_sigma_scale;
  const float clamped = fminf(fmaxf(history, m1 - sg), m1 + sg);
  const float luma_stab = luma_rcrs + (clamped - luma_rcrs) * fminf(history_weight, a.stab);
  const float d1 = data1 + 1.0f;
  const float dmin = fminf(d1, a.fix_frame_num);
  const float4 sig = __ldg(reinterpret_cast<const float4*>(a.signal) + i);
  const float scale = (luma_stab + kEps) / (luma + kEps);
  reinterpret_cast<float4*>(a.out)[i] =
      make_float4(sig.x * scale, sig.y * scale, sig.z * scale, kDir ? luma_stab : sig.w);
  a.planes[i] = luma_stab;
  a.planes[plane + i] = dmin + (d1 - dmin) * antilag;
}

}  // namespace

// ptrs: signal, hist, smb_uv, fbits, data1, vmb_uv, vha, nr (the last three null for diffuse),
//       out, planes
// consts: rect_prev_w, rect_prev_h, max_blur_radius != 0, split_screen, split_screen_prev,
//         antilag sigma scale, antilag magic, 3 x framerate scale, stabilization strength,
//         history fix frame num, specular (0 / 1), responsive roughness threshold + eps,
//         strand material id, directional occlusion (0 / 1; diffuse only), nr the RGBA formats'
//         decoded plane (0 / 1; specular only)
extern "C" int nrd_ts_prelude(void* const* p, const float* c, int w, int h, void* stream) {
  TsArgs a;
  a.signal = (const float*)p[0];
  a.hist = (const __nv_bfloat16*)p[1];
  a.smb_uv = (const float*)p[2];
  a.fbits = (const float*)p[3];
  a.data1 = (const float*)p[4];
  a.vmb_uv = (const float*)p[5];
  a.vha = (const float*)p[6];
  a.nr = (const float*)p[7];
  a.out = (float*)p[8];
  a.planes = (float*)p[9];
  a.w = w;
  a.h = h;
  a.rect_prev_w = c[0];
  a.rect_prev_h = c[1];
  a.rcrs = c[2] != 0.0f;
  a.split_screen = c[3];
  a.split_screen_prev = c[4];
  a.antilag_sigma_scale = c[5];
  a.antilag_magic = c[6];
  a.ta_sigma_scale = c[7];
  a.stab = c[8];
  a.fix_frame_num = c[9];
  const bool spec = c[10] != 0.0f;
  a.responsive_threshold = c[11];
  a.strand_material_id = c[12];
  const bool dir = c[13] != 0.0f;
  if ((spec && (a.vmb_uv == nullptr || a.vha == nullptr || a.nr == nullptr)) || (spec && dir))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const bool dec = c[14] != 0.0f;
  if (dec && !spec) return (int)cudaErrorInvalidValue;
  if (dec)
    ts_prelude_kernel<true, false, true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (dir)
    ts_prelude_kernel<false, true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (spec)
    ts_prelude_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    ts_prelude_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
