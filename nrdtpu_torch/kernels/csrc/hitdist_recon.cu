// K12: REBLUR hit-distance reconstruction: a hit distance of 0 is refilled from the 3x3
// (radius 1) or 5x5 (radius 2) neighbourhood, centre excluded, weighted by in-screen,
// Gaussian, plane distance, normal angle and (specular) roughness; diffuse, specular or both
// in one launch. Replaces nrdtpu/kernels/reblur_pallas.py:1596 hitdist_recon_pallas; computes
// nrdtpu/passes/reblur/kernels.py:2212-2293. The plain version is
// nrdtpu_torch/kernels/hitdist_recon.py:hitdist_recon_ref.
//
// Design for the H100: one thread a pixel, 16x16 CTAs, a kernel per (radius, signals,
// roughness encoding, channels, normal plane): hitdist_recon_kernel<kRadius, kSig, kRough,
// kOcc, kDec> (kDec: the RGBA formats' decoded normal plane, common.cuh:unpack_nr; the
// kernel tests no material in either mode).
//   - Every texel is a tap of up to 24 pixels. Each CTA stages its (16 + 2r)^2 window of derived
//     texels in shared memory: the unpacked normal and the scaled |viewZ| (one float4), the
//     roughness decoded by the encoding (common.cuh:decode_roughness) and each signal's hit
//     distance. The window's texels are loaded at clamped coordinates, which is the texel a tap
//     past the border reads; its uv stays out of the screen, where its weight is 0. Each thread
//     stages two texels and issues every load of both, and of its own pixel, before the first
//     store; the taps then read shared memory only.
//   - The centre's parameters come from the window and the host constants, as the glue computed
//     them into planes before (kernels.py:868-883): the plane-distance parameters of its view
//     position and view-space normal with the frustum size, each signal's normal-weight
//     parameter, and the specular relaxed-roughness weight of roughness^2.
//   - A tap's view position is taken at the pixel's uv plus the offset (u + dx / w), not at the
//     tap texel's own uv, as the plain version takes it (the two differ in the last bit), so
//     the window holds the scaled z and not view positions.
//   - Each signal is written whole: .xyz copied, .w reconstructed (the glue concatenated them).
//   - kOcc, the occlusion variants: each signal is its (h, w, 1) hit distance, read and written
//     as one float a pixel (the TPU kernel at c = 1); the four-channel instances compile as
//     before.
#include "reblur_filters.cuh"

namespace {

using nrd::V3;

constexpr int kTile = 16, kThreads = kTile * kTile;
constexpr int kMinCtas = 4;  // 41-63 registers, no spill (at 6: 40, spills of 4-40 B)
constexpr int kMaxTaps = 24;
constexpr int kDiff = 1, kSpec = 2;  // kSig: the signals, a bit each

struct HdArgs {
  const float* view_z;  // (h, w) raw viewZ
  const float* nr;      // (h, w, 4) packed normal/roughness/material
  const float* sig[2];  // (h, w, 4) diffuse and specular signals; .w is the hit distance
                        // (kOcc: (h, w, 1), the hit distance)
  float* out[2];        // (h, w, 4) the signals with the reconstructed hit distance (kOcc:
                        // (h, w, 1))
  int w, h;
  float view_z_scale, fr[4], ortho, rinv_x, rinv_y;
  float m[9];           // world_to_view rotation, row-major
  float min_rect_dim_mul_unproject, plane_dist_sensitivity, enc_err;
  float gauss[kMaxTaps];  // Gaussian weight of each tap, row by row
};

template <int kRadius, int kSig>
struct Window {
  static constexpr int kSide = kTile + 2 * kRadius;
  static constexpr int kTexels = kSide * kSide;
  float4 geometry[kTexels];  // unpacked normal, scaled |viewZ|
  float rough[kTexels];
  float hit[(kSig & kDiff ? 1 : 0) + (kSig & kSpec ? 1 : 0)][kTexels];
};

// what a thread loads of a window texel, before it stages any
struct Texel {
  float z;
  float4 nr;
  float hit[2];
};

template <int kRadius, int kSig, bool kOcc>
__device__ __forceinline__ Texel load_texel(const HdArgs& a, int ox, int oy, int k) {
  constexpr int side = Window<kRadius, kSig>::kSide;
  constexpr int kC = kOcc ? 1 : 4;  // the signal's channels; the hit distance is the last
  const int tx = nrd::clampi(ox + k % side, 0, a.w - 1);
  const int ty = nrd::clampi(oy + k / side, 0, a.h - 1);
  const size_t j = (size_t)ty * a.w + tx;
  Texel t;
  t.z = __ldg(a.view_z + j);
  t.nr = __ldg(reinterpret_cast<const float4*>(a.nr) + j);
  t.hit[0] = kSig & kDiff ? __ldg(a.sig[0] + kC * j + (kC - 1)) : 0.0f;
  t.hit[1] = kSig & kSpec ? __ldg(a.sig[1] + kC * j + (kC - 1)) : 0.0f;
  return t;
}

template <int kRadius, int kSig, int kRough, bool kDec>
__device__ __forceinline__ void stage(const HdArgs& a, Window<kRadius, kSig>& wnd, int k,
                                      const Texel& t) {
  const nrd::NormalRoughness u = nrd::unpack_nr<kDec>(t.nr);
  const V3 n = u.n;
  wnd.geometry[k] = make_float4(n.x, n.y, n.z, fabsf(t.z) * a.view_z_scale);
  wnd.rough[k] = nrd::decode_roughness<kRough>(u.rough);
  int s = 0;
  if constexpr ((kSig & kDiff) != 0) wnd.hit[s++][k] = t.hit[0];
  if constexpr ((kSig & kSpec) != 0) wnd.hit[s][k] = t.hit[1];
}

template <int kRadius, int kSig, int kRough, bool kOcc = false, bool kDec = false>
__global__ void __launch_bounds__(kThreads, kMinCtas) hitdist_recon_kernel(HdArgs a) {
  using Wnd = Window<kRadius, kSig>;
  constexpr int side = Wnd::kSide;
  static_assert(Wnd::kTexels <= 2 * kThreads, "two window texels a thread");
  __shared__ Wnd wnd;
  const int ox = (int)blockIdx.x * kTile - kRadius, oy = (int)blockIdx.y * kTile - kRadius;
  const int x = ox + kRadius + (int)threadIdx.x, y = oy + kRadius + (int)threadIdx.y;
  const bool inside = x < a.w && y < a.h;
  const size_t i = inside ? (size_t)y * a.w + x : 0;
  // the pixel's own signals (kOcc: nothing beside the hit distance), then its two window
  // texels: every load issued first
  float4 centre[2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
    centre[s] = (s == 0 ? kSig & kDiff : kSig & kSpec) && inside && !kOcc
                    ? __ldg(reinterpret_cast<const float4*>(a.sig[s]) + i)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t0 = threadIdx.y * kTile + threadIdx.x, t1 = t0 + kThreads;
  const bool two = t1 < Wnd::kTexels;
  const Texel s0 = load_texel<kRadius, kSig, kOcc>(a, ox, oy, t0);
  const Texel s1 = load_texel<kRadius, kSig, kOcc>(a, ox, oy, two ? t1 : t0);
  stage<kRadius, kSig, kRough, kDec>(a, wnd, t0, s0);
  if (two) stage<kRadius, kSig, kRough, kDec>(a, wnd, t1, s1);
  __syncthreads();
  if (!inside) return;

  // the centre (kernels.py:868-883): its normal, roughness and scaled viewZ from the window
  const int wc = ((int)threadIdx.y + kRadius) * side + (int)threadIdx.x + kRadius;
  const float4 cg = wnd.geometry[wc];
  const V3 n{cg.x, cg.y, cg.z};
  const float view_z = cg.w, roughness = wnd.rough[wc];
  const V3 nv{n.x * a.m[0] + n.y * a.m[1] + n.z * a.m[2],
              n.x * a.m[3] + n.y * a.m[4] + n.z * a.m[5],
              n.x * a.m[6] + n.y * a.m[7] + n.z * a.m[8]};
  const float u = nrd::pixel_u(x, a.w), v = nrd::pixel_u(y, a.h);
  const V3 xv = nrd::reconstruct_view_position(u, v, a.fr, view_z, a.ortho);
  const float fsz = a.min_rect_dim_mul_unproject * (view_z + (1.0f - view_z) * fabsf(a.ortho));
  const float ga = 1.0f / (a.plane_dist_sensitivity * fsz);
  const float gb = -(nrd::dot3(nv, xv) * ga);
  // the signal's normal-weight parameter (roughness 1 for diffuse) and, for specular, the
  // relaxed roughness weight of m = roughness^2 (GetRelaxedRoughnessWeightParams, fraction 1)
  float nwp[2] = {0.0f, 0.0f}, ra = 0.0f, rb = 0.0f;
  if constexpr ((kSig & kDiff) != 0)
    nwp[0] = nrd::normal_weight_param(1.0f, 1.0f, 0.0f, 1.0f, a.enc_err);
  if constexpr ((kSig & kSpec) != 0) {
    nwp[1] = nrd::normal_weight_param(1.0f, 1.0f, 0.0f, roughness, a.enc_err);
    const float m = roughness * roughness;
    ra = 1.0f / ((float)0.01 + (float)(1.0 - 0.01) * (m * m + (m - m * m) * 1.0f));
    rb = -(m * ra);
  }

  float acc[2] = {0.0f, 0.0f}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int s = 0, k = 0; s < 2; ++s) {
    if (!(s == 0 ? kSig & kDiff : kSig & kSpec)) continue;
    const float hd = wnd.hit[k++][wc];
    sum[s] = 1000.0f * (hd != 0.0f ? 1.0f : 0.0f);
    acc[s] = hd * sum[s];
  }

  int t = 0;
#pragma unroll
  for (int dy = -kRadius; dy <= kRadius; ++dy)
#pragma unroll
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const int k = wc + dy * side + dx;
      const float4 g = wnd.geometry[k];
      const V3 ns{g.x, g.y, g.z};
      const float rs = wnd.rough[k];
      const float us = u + (float)dx * a.rinv_x, vs = v + (float)dy * a.rinv_y;
      const V3 xvs = nrd::reconstruct_view_position(us, vs, a.fr, g.w, a.ortho);
      float w_ = nrd::in_screen_nearest(us, vs);
      w_ = w_ * a.gauss[t++];
      w_ = w_ * nrd::compute_weight(nrd::dot3(nv, xvs), ga, gb);
      const float angle = nrd::acos_approx(nrd::dot3(n, ns));
#pragma unroll
      for (int s = 0, q = 0; s < 2; ++s) {
        if (!(s == 0 ? kSig & kDiff : kSig & kSpec)) continue;
        float ws = w_ * nrd::compute_exponential_weight(angle, nwp[s], 0.0f);
        if (s == 1) ws = ws * nrd::compute_exponential_weight(rs * rs, ra, rb);
        const float tap = wnd.hit[q++][k];
        ws = ws * (tap != 0.0f ? 1.0f : 0.0f);
        acc[s] = acc[s] + tap * ws;
        sum[s] = sum[s] + ws;
      }
    }

#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (s == 0 ? kSig & kDiff : kSig & kSpec) {
      if constexpr (kOcc)
        a.out[s][i] = acc[s] / fmaxf(sum[s], 1e-6f);
      else
        reinterpret_cast<float4*>(a.out[s])[i] =
            make_float4(centre[s].x, centre[s].y, centre[s].z, acc[s] / fmaxf(sum[s], 1e-6f));
    }
}

using Kernel = void (*)(HdArgs);

template <int kRadius, int kSig, bool kOcc, bool kDec>
Kernel pick_rough(int rough) {
  return rough == 0   ? hitdist_recon_kernel<kRadius, kSig, 0, kOcc, kDec>
         : rough == 1 ? hitdist_recon_kernel<kRadius, kSig, 1, kOcc, kDec>
                      : hitdist_recon_kernel<kRadius, kSig, 2, kOcc, kDec>;
}

template <int kRadius, bool kOcc, bool kDec>
Kernel pick_sig(int sig, int rough) {
  return sig == kDiff   ? pick_rough<kRadius, kDiff, kOcc, kDec>(rough)
         : sig == kSpec ? pick_rough<kRadius, kSpec, kOcc, kDec>(rough)
                        : pick_rough<kRadius, kDiff | kSpec, kOcc, kDec>(rough);
}

// the decoded plane (kDec) on four channels (RELAX's and REBLUR's calls at the RGBA formats)
// and on one (REBLUR's occlusion variants there, whose plane has its roughness decoded: LINEAR
// only)
template <int kRadius>
Kernel pick(int sig, int rough, bool occ, bool dec) {
  if (dec && occ)
    return rough != 0       ? nullptr
           : sig == kDiff   ? hitdist_recon_kernel<kRadius, kDiff, 0, true, true>
           : sig == kSpec   ? hitdist_recon_kernel<kRadius, kSpec, 0, true, true>
                            : hitdist_recon_kernel<kRadius, kDiff | kSpec, 0, true, true>;
  if (dec) return pick_sig<kRadius, false, true>(sig, rough);
  return occ ? pick_sig<kRadius, true, false>(sig, rough)
             : pick_sig<kRadius, false, false>(sig, rough);
}

}  // namespace

// ptrs: view_z, nr, diff signal, spec signal, diff out, spec out (an absent signal's: null)
// consts: radius, has_diff, has_spec, view_z_scale, frustum[4], ortho, rinv[2], m[9],
//         roughness mode (0 LINEAR, 1 SQRT_LINEAR, 2 SQ_LINEAR), min_rect_dim_mul_unproject,
//         plane_dist_sensitivity, normal encoding error, one-channel signals (0 or 1), the
//         Gaussian weight of each tap (kMaxTaps slots, the first taps used), the plane
//         decoded (kDec: 0 or 1)
extern "C" int nrd_hitdist_recon(void* const* p, const float* c, int w, int h, void* stream) {
  HdArgs a;
  a.view_z = (const float*)p[0];
  a.nr = (const float*)p[1];
  a.sig[0] = (const float*)p[2];
  a.sig[1] = (const float*)p[3];
  a.out[0] = (float*)p[4];
  a.out[1] = (float*)p[5];
  a.w = w;
  a.h = h;
  const int radius = (int)c[0];
  const int sig = (c[1] != 0.0f ? kDiff : 0) | (c[2] != 0.0f ? kSpec : 0);
  a.view_z_scale = c[3];
  for (int k = 0; k < 4; ++k) a.fr[k] = c[4 + k];
  a.ortho = c[8];
  a.rinv_x = c[9];
  a.rinv_y = c[10];
  for (int k = 0; k < 9; ++k) a.m[k] = c[11 + k];
  const int rough = (int)c[20];
  a.min_rect_dim_mul_unproject = c[21];
  a.plane_dist_sensitivity = c[22];
  a.enc_err = c[23];
  if ((radius != 1 && radius != 2) || sig == 0 || rough < 0 || rough > 2 ||
      ((sig & kDiff) && (a.sig[0] == nullptr || a.out[0] == nullptr)) ||
      ((sig & kSpec) && (a.sig[1] == nullptr || a.out[1] == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool occ = c[24] != 0.0f;
  const int taps = (2 * radius + 1) * (2 * radius + 1) - 1;
  for (int k = 0; k < kMaxTaps; ++k) a.gauss[k] = k < taps ? c[25 + k] : 0.0f;
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const bool dec = c[25 + kMaxTaps] != 0.0f;
  const Kernel kernel =
      radius == 1 ? pick<1>(sig, rough, occ, dec) : pick<2>(sig, rough, occ, dec);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
