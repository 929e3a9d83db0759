// K22: one RELAX à-trous iteration, diffuse, specular or both. Iteration 0: the 3x3 Gaussian
// prefilter of the centre's variance, the 3x3 taps accumulating (rgb, 2nd moment) with the
// variance taken at the end, and where history length < threshold the 5x5 spatial variance
// estimation in its place. Later iterations: variance propagated with w^2, the lobe fraction
// relaxed with the stride and the history length, and above stride 4 each pixel's taps
// jittered by floor(step / 2 (rnd - 0.5)) from the PCG hash of (pixel, frame index). Each tap
// is sample_nearest(uv + duv) with XLA's float uv and in-screen test, weighted by plane
// distance, the 3x3 Gaussian, denoising range, normal angle, material and luminance.
// The optional confidence planes relax the edge stopping per pixel: IN_DIFF_CONFIDENCE the
// diffuse lobe fraction and luminance weight, IN_SPEC_CONFIDENCE and the TA's reprojection
// confidence the specular ones. The specular mode weights its later iterations' taps by the
// specular normal weight x the roughness weight (or the simplified normal weight); its
// iteration 0 keeps the diffuse normal weight, as XLA does (use_variance_estimation). With
// both signals (kBoth, the TPU function's has_diff and has_spec) a tap's geometry serves both:
// its plane distance, Gaussian, in-screen test, denoising range and normal angle; each signal
// then takes its own normal weight (the specular one x roughness after iteration 0), material
// test at its own min material and luminance weight at its own phi and max difference.
// With the SH variants (kSh) each signal's SH plane is filtered with the signal's weights, not
// squared after iteration 0 (kernels.py:1494, :1535-1537, :1545), and at iteration 0 the 5x5
// estimation's SH in its place where the history is short (:1568, :1585-1586, :1596-1598); the
// diffuse lobe fraction's base after iteration 0 is 1.0 (:1363), which the host's `lobe_span`
// carries. Replaces nrdtpu/kernels/relax_pallas.py:338 relax_atrous_pallas; computes
// nrdtpu/passes/relax/kernels.py:1349-1598 per pixel. The plain version is
// nrdtpu_torch/kernels/relax_atrous.py:relax_atrous_ref.
//
// Design for the H100: one thread per pixel in kTileX x kTileY CTAs, at most kMinCtas' register
// budget (four 256-thread CTAs an SM; with both signals too: it spills 92-124 B there, and at 3
// CTAs, 80 registers and 0-36 B, the ladder ran 2 % slower, PERF.md). A pixel's 8 taps (iteration
// 0: also the 3x3 prefilter and the 5x5 estimation) gather signal, packed normal and viewZ, and
// each texel is read as one float4 of signal, one float4 of nr (nx, ny, roughness, material / 3)
// and one float of viewZ through the read-only path, its index clamped once. What a tap derives
// from the texel alone (derive: the unpacked normal, viewZ, material, luminance) is the same for
// every pixel that taps it; with both signals a texel is one float4 more (the specular signal,
// its luminance in the third float4's spare lane). Iteration 0, whose prefilter, taps and 5x5
// estimation read 8-33 texels of a 5x5 neighbourhood, first stages the tile's window (halo 2:
// 19.2 KB, 25.6 KB with both signals) into shared memory with those values derived once a texel,
// and reads it there. The later strides read each texel from global memory and derive it at the
// tap: staging their windows (halo = step) was slower at steps 2 and 4 on the H100 (PERF.md), and
// steps 8 and 16 jitter their taps. A tap keeps XLA's float uv + duv and finds its texel by
// floor(us w) as before; the window is indexed by that texel, and a texel outside it is read and
// derived from global memory. The roughness that derive keeps follows the roughness encoding, the
// template parameter kRough (common.cuh:decode_roughness), as the TPU kernel's rough_sq. With SH
// a texel is one float4 more a signal (its SH), staged at iteration 0 as well. At the RGBA
// normal encodings derive reads the decoded plane (kDec: normal .xyz, roughness .w, material 0)
// and no tap tests the material. Every min, max and saturate of the per-pixel part returns NaN
// where its operand is NaN (common.cuh:min_bound, max_bound, saturate_bound: the other operand
// is a constant, one compare and one select), as the plain version's clamp_min, clamp_max and
// clamp do: with fmaxf the variance of a NaN signal's moments was 0 where the plain version's
// is NaN (the SNORM sky fault's frames, ROADMAP.md Queue 3).
#include "relax_common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr int kTileX = 16, kTileY = 16, kMinCtas = 4;

// one signal's planes and constants
struct AtrousSignal {
  const float* signal;  // (h, w, 4) (rgb, 2nd moment) at iteration 0, else (rgb, variance)
  float* out;           // (h, w, 4) (rgb, variance)
  float phi, max_rel, min_material;
  const float* sh;      // (h, w, 4) the signal's SH (kSh only)
  float* out_sh;        // (h, w, 4) (kSh only)
};

struct AtrousArgs {
  AtrousSignal sig[2];  // the one signal, or the diffuse and the specular signal
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* hl;      // (h, w) history length
  const float* diff_conf;  // (h, w) IN_DIFF_CONFIDENCE or null
  const float* spec_conf;  // (h, w) IN_SPEC_CONFIDENCE or null
  const float* reproj;     // (h, w) the TA's specular reprojection confidence or null
  relax::Frame f;
  float denoising_range, depth_threshold, lobe_fraction, nwp_sve, history_threshold;
  float lobe_span;  // after iteration 0: the diffuse lobe fraction's lerp(0.99, ., t) span
  int step, halo;  // halo: the staged window's margin (iteration 0)
  bool is_first, spec;  // spec: the one signal is specular (both signals: the second one is)
  uint32_t frame_index;
  float w0, w0_sq, k01, k11;  // Gaussian 3x3: centre, centre squared, edge, corner
  float conf_mult, conf_normal, conf_lum;  // confidence-driven relaxations
  // specular: the settings' lobe fraction, roughness fraction, normal edge-stopping
  // relaxation, lobe slack, luminance and roughness edge-stopping relaxations
  float laf, rf, nesr, slack, lesr, resr;
  bool roughness_edge_stopping;
};

// 3x3 Gaussian prefilter of the centre's variance, [|dx|][|dy|]
__constant__ float kPrefilter[2][2] = {{0.25f, 0.125f}, {0.125f, 0.0625f}};

// one texel of the tapped images, with what every tap derives from it alone; kN signals
template <int kN>
struct Texel {
  float4 g;       // the unpacked normal (x, y, z), viewZ (relax::view_z)
  float4 m;       // signal 0's luminance, material (nr.w x 3), roughness, signal 1's luminance
  float4 s[kN];   // the signals
  float4 sh[kN];  // the signals' SH (kSh; zero without)
};

// signal k's luminance of a texel
template <int kN>
__device__ __forceinline__ float lum(const Texel<kN>& t, int k) { return k == 0 ? t.m.x : t.m.w; }

// whether signal k takes the specular weights
template <int kN>
__device__ __forceinline__ bool is_spec(const AtrousArgs& a, int k) {
  return kN == 2 ? k == 1 : a.spec;
}

template <int kN, int kRough, bool kDec>
__device__ __forceinline__ Texel<kN> derive(const relax::Frame& f, const float4 s[kN],
                                            const float4 sh[kN], float4 nr, float raw_z) {
  const nrd::NormalRoughness u = nrd::unpack_nr<kDec>(nr);
  const V3 n = u.n;
  Texel<kN> t;
  t.g = make_float4(n.x, n.y, n.z, relax::view_z(f, raw_z));
  t.m = make_float4(relax::luminance(s[0].x, s[0].y, s[0].z), u.mat,
                    nrd::decode_roughness<kRough>(u.rough),
                    kN == 2 ? relax::luminance(s[kN - 1].x, s[kN - 1].y, s[kN - 1].z) : 0.0f);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    t.s[k] = s[k];
    t.sh[k] = sh[k];
  }
  return t;
}

template <int kN, int kRough, bool kSh, bool kDec>
__device__ __forceinline__ Texel<kN> load_texel(const AtrousArgs& a, int tx, int ty) {
  const size_t i = Image<float, 4>{a.sig[0].signal, a.f.w, a.f.h}.index(tx, ty);
  float4 s[kN], sh[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    s[k] = __ldg(reinterpret_cast<const float4*>(a.sig[k].signal) + i);
    sh[k] = kSh ? __ldg(reinterpret_cast<const float4*>(a.sig[k].sh) + i)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return derive<kN, kRough, kDec>(a.f, s, sh,
                                  __ldg(reinterpret_cast<const float4*>(a.nr) + i),
                                  __ldg(a.view_z + i));
}

// The tile's window of texels, clamp-to-edge: wh rows of ww texels from (ox, oy), in shared
// memory (planes g, m, then one a signal, then with SH one a signal's SH), or nothing (g null)
// where the stride is not staged.
template <int kN>
struct Window {
  const float4* g;
  const float4* m;
  const float4* s[kN];
  const float4* sh[kN];
  int ox, oy, ww, wh;
};

template <int kN, int kRough, bool kSh, bool kDec>
__device__ __forceinline__ Texel<kN> fetch(const AtrousArgs& a, const Window<kN>& wnd, int tx,
                                           int ty) {
  const int i = tx - wnd.ox, j = ty - wnd.oy;
  if (wnd.g != nullptr && (unsigned)i < (unsigned)wnd.ww && (unsigned)j < (unsigned)wnd.wh) {
    const int k = j * wnd.ww + i;
    Texel<kN> t;
    t.g = wnd.g[k];
    t.m = wnd.m[k];
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      t.s[c] = wnd.s[c][k];
      t.sh[c] = kSh ? wnd.sh[c][k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return t;
  }
  return load_texel<kN, kRough, kSh, kDec>(a, tx, ty);
}

// the 5x5 spatial variance estimation of a short history (clamp-to-edge), for each signal, and
// with SH of each signal's SH (out_sh)
template <int kN, int kRough, bool kSh, bool kDec>
__device__ __forceinline__ void variance_estimation(const AtrousArgs& a, const Window<kN>& wnd,
                                                    int x, int y, V3 n, const float mat_c[kN],
                                                    float hl, float out[kN][4],
                                                    float4 out_sh[kN]) {
  float swsum[kN], s_rgb[kN][3], s_m1[kN], s_m2[kN];
  float4 s_sh[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    swsum[k] = s_m1[k] = s_m2[k] = 0.0f;
    s_rgb[k][0] = s_rgb[k][1] = s_rgb[k][2] = 0.0f;
    s_sh[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int dy = -2; dy <= 2; ++dy)
    for (int dx = -2; dx <= 2; ++dx) {
      const Texel<kN> t = fetch<kN, kRough, kSh, kDec>(a, wnd, x + dx, y + dy);
      const V3 ns{t.g.x, t.g.y, t.g.z};
      const float wn = nrd::compute_weight(nrd::acos_approx(nrd::dot3(n, ns)), a.nwp_sve, 0.0f);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float w_ =
            kDec ? wn
                 : wn * (nrd::max_bound(t.m.y, a.sig[k].min_material) == mat_c[k] ? 1.0f : 0.0f);
        const float s[4] = {t.s[k].x, t.s[k].y, t.s[k].z, t.s[k].w};
        swsum[k] = swsum[k] + w_;
#pragma unroll
        for (int c = 0; c < 3; ++c) s_rgb[k][c] = s_rgb[k][c] + s[c] * w_;
        s_m1[k] = s_m1[k] + lum(t, k) * w_;
        s_m2[k] = s_m2[k] + s[3] * w_;
        if constexpr (kSh) s_sh[k] = nrd::add_weighted(s_sh[k], t.sh[k], w_);
      }
    }
  const float boost = nrd::max_bound(4.0f / (hl + 1.0f), 1.0f);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    swsum[k] = nrd::max_bound(swsum[k], 1e-6f);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[k][c] = s_rgb[k][c] / swsum[k];
    s_m1[k] = s_m1[k] / swsum[k];
    s_m2[k] = s_m2[k] / swsum[k];
    out[k][3] = nrd::max_bound(s_m2[k] - s_m1[k] * s_m1[k], 0.0f) * boost;
    if constexpr (kSh) out_sh[k] = nrd::divide(s_sh[k], swsum[k]);
  }
}

// saturate(multiplier (1 - confidence)) x a relaxation, saturated
__device__ __forceinline__ float relaxation(const AtrousArgs& a, float conf, float r) {
  return nrd::saturate_bound(nrd::saturate_bound(a.conf_mult * (1.0f - conf)) * r);
}

template <bool kSh>
__device__ __forceinline__ void store(const AtrousSignal& g, size_t i, const float out[4],
                                      float4 out_sh) {
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) g.out[4 * i + ch] = out[ch];
  if constexpr (kSh) reinterpret_cast<float4*>(g.out_sh)[i] = out_sh;
}

// kStaged: iteration 0's staged window; kRough: the roughness encoding; kBoth: the diffuse and
// the specular signal (else one, a.spec saying which); kSh: each signal's SH too; kDec: the
// RGBA formats' decoded normal plane (common.cuh:unpack_nr), no material test (the TPU
// kernel's mat_occ=False)
template <bool kStaged, int kRough, bool kBoth, bool kSh, bool kDec = false>
__global__ void __launch_bounds__(kTileX * kTileY, kMinCtas)
    relax_atrous_kernel(AtrousArgs a) {
  constexpr int kN = kBoth ? 2 : 1;
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  Window<kN> wnd{};
  if constexpr (kStaged) {  // every thread of the CTA stages, then the ones outside the image leave
    extern __shared__ float4 window[];
    wnd.ox = blockIdx.x * kTileX - a.halo;
    wnd.oy = blockIdx.y * kTileY - a.halo;
    wnd.ww = kTileX + 2 * a.halo;
    wnd.wh = kTileY + 2 * a.halo;
    const int n = wnd.ww * wnd.wh;
    float4* g = window;
    float4* m = window + n;
    float4* s[kN];
    float4* sh[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      s[k] = window + (2 + k) * n;
      sh[k] = window + (2 + kN + k) * n;  // with SH only: the window holds them
    }
    for (int j = threadIdx.y; j < wnd.wh; j += kTileY)
      for (int i = threadIdx.x; i < wnd.ww; i += kTileX) {
        const Texel<kN> t = load_texel<kN, kRough, kSh, kDec>(a, wnd.ox + i, wnd.oy + j);
        g[j * wnd.ww + i] = t.g;
        m[j * wnd.ww + i] = t.m;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          s[k][j * wnd.ww + i] = t.s[k];
          if constexpr (kSh) sh[k][j * wnd.ww + i] = t.sh[k];
        }
      }
    wnd.g = g;
    wnd.m = m;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      wnd.s[k] = s[k];
      wnd.sh[k] = sh[k];
    }
    __syncthreads();
  }
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const Texel<kN> ct = fetch<kN, kRough, kSh, kDec>(a, wnd, x, y);
  const float hl = __ldg(a.hl + i);
  const V3 n{ct.g.x, ct.g.y, ct.g.z};
  float mat_c[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) mat_c[k] = nrd::max_bound(ct.m.y, a.sig[k].min_material);
  float out[kN][4];
  float4 out_sh[kN] = {};
  if (a.is_first && !(hl >= a.history_threshold)) {
    variance_estimation<kN, kRough, kSh, kDec>(a, wnd, x, y, n, mat_c, hl, out, out_sh);
#pragma unroll
    for (int k = 0; k < kN; ++k) store<kSh>(a.sig[k], i, out[k], out_sh[k]);
    return;
  }

  const float fw = (float)a.f.w, fh = (float)a.f.h;
  const float u = nrd::pixel_u(x, a.f.w), v = nrd::pixel_u(y, a.f.h);
  const float z = ct.g.w;
  const V3 xc = relax::world_pos(a.f, u, v, z);
  const float thr = a.depth_threshold * (a.f.ortho == 0.0f ? z : 1.0f);

  // the diffuse lobe fraction, relaxed by IN_DIFF_CONFIDENCE
  const float dlf0 =
      a.is_first ? a.lobe_fraction : 0.99f + a.lobe_span * nrd::saturate_bound(hl / 5.0f);
  // each signal's luminance relaxation: the diffuse one's first
  float dlf = dlf0, lum_relax[kN];
  lum_relax[0] = 1.0f;
  if (a.diff_conf != nullptr) {
    const float conf = __ldg(a.diff_conf + i);
    dlf = dlf0 + (1.0f - dlf0) * relaxation(a, conf, a.conf_normal);
    lum_relax[0] = 1.0f - relaxation(a, conf, a.conf_lum);
  }
  const float nwp = relax::normal_weight_param2(dlf);

  // the specular relaxations and, after iteration 0, the specular weights' parameters
  const bool has_spec = kBoth || a.spec;
  const bool spec_taps = has_spec && !a.is_first;
  float nwp_simpl = 0.0f, ra = 0.0f, rb = 0.0f, angle0 = 0.0f, f0 = 0.0f;
  V3 cv{0.0f, 0.0f, 0.0f};
  if (has_spec) {
    float& spec_lum_relax = lum_relax[kN - 1];  // the second signal's, or the one's
    const float reproj = a.reproj != nullptr ? __ldg(a.reproj + i) : 1.0f;
    spec_lum_relax = 1.0f;
    if ((a.step <= 4 || a.is_first) && a.reproj != nullptr)
      spec_lum_relax = 1.0f + (reproj - 1.0f) * a.lesr;
    float spec_lobe = a.laf, dlf_simpl = dlf0;
    if (a.spec_conf != nullptr) {
      const float conf = __ldg(a.spec_conf + i);
      const float rr = relaxation(a, conf, a.conf_normal);
      dlf_simpl = dlf0 + (1.0f - dlf0) * rr;
      spec_lobe = a.laf + (1.0f - a.laf) * rr;
      spec_lum_relax = spec_lum_relax * (1.0f - relaxation(a, conf, a.conf_lum));
    }
    if (spec_taps) {
      nwp_simpl = relax::normal_weight_param2(dlf_simpl);
      const float rough = ct.m.z;
      ra = 1.0f / (0.01f + 0.99f * nrd::saturate_bound(rough * a.rf));
      rb = -(rough * ra);
      relax::normal_weight_params_atrous(rough, hl, reproj, a.nesr, spec_lobe, a.slack,
                                         &angle0, &f0);
      cv = relax::neg_normalize(xc);
    }
  }

  float offx = 0.0f, offy = 0.0f;
  if (!a.is_first && a.step > 4) {
    uint32_t rng = nrd::hash_init((uint32_t)x, (uint32_t)y, a.frame_index);
    const float r0 = nrd::hash_float(rng);
    const float r1 = nrd::hash_float(rng);
    const float half = (float)a.step * 0.5f;
    offx = floorf(half * (r0 - 0.5f));
    offy = floorf(half * (r1 - 0.5f));
  }

  float var[kN];
  if (a.is_first) {
    float pre[kN][4];
#pragma unroll
    for (int k = 0; k < kN; ++k) pre[k][0] = pre[k][1] = pre[k][2] = pre[k][3] = 0.0f;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const float c = kPrefilter[abs(dx)][abs(dy)];
        const Texel<kN> t = fetch<kN, kRough, kSh, kDec>(a, wnd, x + dx, y + dy);
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          pre[k][0] = pre[k][0] + t.s[k].x * c;
          pre[k][1] = pre[k][1] + t.s[k].y * c;
          pre[k][2] = pre[k][2] + t.s[k].z * c;
          pre[k][3] = pre[k][3] + t.s[k].w * c;
        }
      }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const float m1 = relax::luminance(pre[k][0], pre[k][1], pre[k][2]);
      var[k] = nrd::max_bound(pre[k][3] - m1 * m1, 0.0f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) var[k] = ct.s[k].w;
  }

  float phi_inv[kN], wsum[kN], acc[kN][4];
  float4 acc_sh[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    phi_inv[k] = 1.0f / nrd::max_bound(a.sig[k].phi * sqrtf(var[k]), 1e-4f);
    wsum[k] = a.w0;
    acc_sh[k] = make_float4(ct.sh[k].x * a.w0, ct.sh[k].y * a.w0, ct.sh[k].z * a.w0,
                            ct.sh[k].w * a.w0);
    acc[k][0] = ct.s[k].x * a.w0;
    acc[k][1] = ct.s[k].y * a.w0;
    acc[k][2] = ct.s[k].z * a.w0;
    acc[k][3] = ct.s[k].w * (a.is_first ? a.w0 : a.w0_sq);
  }
  const float rinv_x = 1.0f / fw, rinv_y = 1.0f / fh;
  for (int yy = -1; yy <= 1; ++yy)
    for (int xx = -1; xx <= 1; ++xx) {
      if (xx == 0 && yy == 0) continue;
      const float kern = (xx == 0 || yy == 0) ? a.k01 : a.k11;
      const float us = u + ((float)(xx * a.step) + offx) * rinv_x;
      const float vs = v + ((float)(yy * a.step) + offy) * rinv_y;
      const float inside = nrd::in_screen_nearest(us, vs);
      const int tx = nrd::to_index(floorf(us * fw)), ty = nrd::to_index(floorf(vs * fh));
      const Texel<kN> t = fetch<kN, kRough, kSh, kDec>(a, wnd, tx, ty);
      const float zs = t.g.w;
      const V3 ns{t.g.x, t.g.y, t.g.z};
      const float ms = t.m.y;
      const V3 xs = relax::world_pos(a.f, us, vs, zs);
      float gw = (relax::plane_dist(xs, xc, n) < thr ? 1.0f : 0.0f) * kern;
      gw = gw * inside * (zs < a.denoising_range ? 1.0f : 0.0f);
      const float angle = nrd::acos_approx(nrd::dot3(n, ns));
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        float w_;
        if (spec_taps && is_spec<kN>(a, k)) {
          if (a.roughness_edge_stopping) {
            const V3 sv = relax::neg_normalize(
                V3{xs.x + a.resr * xc.x, xs.y + a.resr * xc.y, xs.z + a.resr * xc.z});
            const float nw = relax::specular_normal_weight_atrous(angle0, f0, n, ns, cv, sv);
            w_ = gw * (nw * nrd::compute_weight(t.m.z, ra, rb));
          } else {
            w_ = gw * nrd::compute_weight(angle, nwp_simpl, 0.0f);
          }
        } else {
          w_ = gw * nrd::compute_weight(angle, nwp, 0.0f);
        }
        if constexpr (!kDec)
          w_ = w_ * (nrd::max_bound(ms, a.sig[k].min_material) == mat_c[k] ? 1.0f : 0.0f);
        const float s[4] = {t.s[k].x, t.s[k].y, t.s[k].z, t.s[k].w};
        const float lw =
            nrd::min_bound(fabsf(lum(ct, k) - lum(t, k)) * phi_inv[k], a.sig[k].max_rel) *
            lum_relax[k];
        w_ = w_ * expf(-lw);
        wsum[k] = wsum[k] + w_;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[k][ch] = acc[k][ch] + s[ch] * w_;
        acc[k][3] = acc[k][3] + s[3] * (a.is_first ? w_ : w_ * w_);
        if constexpr (kSh) acc_sh[k] = nrd::add_weighted(acc_sh[k], t.sh[k], w_);
      }
    }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (a.is_first) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) out[k][ch] = acc[k][ch] / wsum[k];
      const float m1 = relax::luminance(out[k][0], out[k][1], out[k][2]);
      out[k][3] = nrd::max_bound(out[k][3] - m1 * m1, 0.0f);
    } else {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out[k][ch] = acc[k][ch] / wsum[k];
      out[k][3] = acc[k][3] / (wsum[k] * wsum[k]);
    }
    store<kSh>(a.sig[k], i, out[k], nrd::divide(acc_sh[k], wsum[k]));
  }
}

template <bool kBoth, bool kSh, bool kDec>
int launch(const AtrousArgs& a, int rough, dim3 grid, dim3 block, cudaStream_t stream) {
  // iteration 0 stages its window: the planes g and m, one a signal and with SH one a
  // signal's SH
  const int planes = 2 + (kBoth ? 2 : 1) * (kSh ? 2 : 1);
  const size_t smem = a.is_first ? (size_t)(kTileX + 2 * a.halo) * (kTileY + 2 * a.halo) *
                                       planes * sizeof(float4)
                                 : 0;
  if (a.is_first && rough == 0)
    relax_atrous_kernel<true, 0, kBoth, kSh, kDec><<<grid, block, smem, stream>>>(a);
  else if (a.is_first && rough == 1)
    relax_atrous_kernel<true, 1, kBoth, kSh, kDec><<<grid, block, smem, stream>>>(a);
  else if (a.is_first && rough == 2)
    relax_atrous_kernel<true, 2, kBoth, kSh, kDec><<<grid, block, smem, stream>>>(a);
  else if (rough == 0)
    relax_atrous_kernel<false, 0, kBoth, kSh, kDec><<<grid, block, 0, stream>>>(a);
  else if (rough == 1)
    relax_atrous_kernel<false, 1, kBoth, kSh, kDec><<<grid, block, 0, stream>>>(a);
  else if (rough == 2)
    relax_atrous_kernel<false, 2, kBoth, kSh, kDec><<<grid, block, 0, stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: signal, view_z, nr, history_length, out, then diff_conf, spec_conf, reproj (each may
//       be null), then with both signals the specular signal and its out (the first being the
//       diffuse one), then the first signal's SH and its out, the second's (null without SH)
// consts: frame geometry (relax::load_frame), denoising_range, depth_threshold,
//         lobe_fraction, nwp_sve, phi, max_rel, min_material, history_threshold, step,
//         is_first (0 or 1), frame index low 16 bits, high 16 bits, w0, w0^2, k01, k11,
//         confidence multiplier, normal and luminance relaxations, specular (0 or 1), the
//         settings' lobe fraction, roughness fraction, normal edge-stopping relaxation, lobe
//         slack, luminance and roughness edge-stopping relaxations, roughness edge stopping
//         (0 or 1), roughness mode (0 LINEAR, 1 SQRT_LINEAR, 2 SQ_LINEAR), signals (1 or 2),
//         the specular signal's phi, max_rel, min_material, the lobe span (after iteration 0
//         the diffuse lobe fraction is 0.99 + span x saturate(hl / 5)), the plane decoded
//         (kDec: 0 or 1)
extern "C" int nrd_relax_atrous(void* const* p, const float* c, int w, int h, void* stream) {
  AtrousArgs a;
  a.sig[0].signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.hl = (const float*)p[3];
  a.sig[0].out = (float*)p[4];
  a.diff_conf = (const float*)p[5];
  a.spec_conf = (const float*)p[6];
  a.reproj = (const float*)p[7];
  a.f = relax::load_frame(c, w, h);
  const float* q = c + relax::kFrameConsts;
  a.denoising_range = q[0];
  a.depth_threshold = q[1];
  a.lobe_fraction = q[2];
  a.nwp_sve = q[3];
  a.sig[0].phi = q[4];
  a.sig[0].max_rel = q[5];
  a.sig[0].min_material = q[6];
  a.history_threshold = q[7];
  a.step = (int)q[8];
  a.is_first = q[9] != 0.0f;
  a.frame_index = (uint32_t)q[10] | ((uint32_t)q[11] << 16);
  a.w0 = q[12];
  a.w0_sq = q[13];
  a.k01 = q[14];
  a.k11 = q[15];
  a.conf_mult = q[16];
  a.conf_normal = q[17];
  a.conf_lum = q[18];
  a.spec = q[19] != 0.0f;
  a.laf = q[20];
  a.rf = q[21];
  a.nesr = q[22];
  a.slack = q[23];
  a.lesr = q[24];
  a.resr = q[25];
  a.roughness_edge_stopping = q[26] != 0.0f;
  const int rough = (int)q[27];
  const int signals = (int)q[28];
  a.sig[1] = AtrousSignal{(const float*)p[8], (float*)p[9], q[29], q[30], q[31]};
  a.lobe_span = q[32];
  const bool dec = q[33] != 0.0f;
  for (int k = 0; k < 2; ++k) {
    a.sig[k].sh = (const float*)p[10 + 2 * k];
    a.sig[k].out_sh = (float*)p[11 + 2 * k];
  }
  if (signals < 1 || signals > 2) return (int)cudaErrorInvalidValue;
  const bool sh = a.sig[0].sh != nullptr;
  for (int k = 0; k < signals; ++k)  // with SH, an SH plane and its out for every signal
    if ((a.sig[k].sh != nullptr) != sh || (a.sig[k].out_sh != nullptr) != sh)
      return (int)cudaErrorInvalidValue;
  // both signals: the diffuse one first, then the specular one
  if (signals == 2 && (!a.spec || a.sig[1].signal == nullptr || a.sig[1].out == nullptr))
    return (int)cudaErrorInvalidValue;
  // iteration 0 reads the 5x5 estimation's neighbours and its taps'
  a.halo = a.step > 2 ? a.step : 2;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dec) {
    if (signals == 2)
      return sh ? launch<true, true, true>(a, rough, grid, block, st)
                : launch<true, false, true>(a, rough, grid, block, st);
    return sh ? launch<false, true, true>(a, rough, grid, block, st)
              : launch<false, false, true>(a, rough, grid, block, st);
  }
  if (signals == 2)
    return sh ? launch<true, true, false>(a, rough, grid, block, st)
              : launch<true, false, false>(a, rough, grid, block, st);
  return sh ? launch<false, true, false>(a, rough, grid, block, st)
            : launch<false, false, false>(a, rough, grid, block, st);
}
