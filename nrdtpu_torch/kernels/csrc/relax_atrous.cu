// K22: one RELAX à-trous iteration, diffuse or specular. Iteration 0: the 3x3 Gaussian
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
// iteration 0 keeps the diffuse normal weight, as XLA does (use_variance_estimation).
// Replaces nrdtpu/kernels/relax_pallas.py:338 relax_atrous_pallas; computes
// nrdtpu/passes/relax/kernels.py:1349-1598 per pixel. The plain version is
// nrdtpu_torch/kernels/relax_atrous.py:relax_atrous_ref.
//
// Design for the H100: one thread per pixel in kTileX x kTileY CTAs, at most kMinCtas'
// register budget (four 256-thread CTAs an SM). A pixel's 8 taps (iteration 0: also the 3x3
// prefilter and the 5x5 estimation) gather signal, packed normal and viewZ, and each texel is
// read as one float4 of signal, one float4 of nr (nx, ny, roughness, material / 3) and one
// float of viewZ through the read-only path, its index clamped once. What a tap derives from
// the texel alone (derive: the unpacked normal, viewZ, material, luminance) is the same for
// every pixel that taps it. Iteration 0, whose prefilter, taps and 5x5 estimation read 8-33
// texels of a 5x5 neighbourhood, first stages the tile's window (halo 2) into shared memory
// with those values derived once a texel, and reads it there. The later strides read each
// texel from global memory and derive it at the tap: staging their windows (halo = step) was
// slower at steps 2 and 4 on the H100 (PERF.md), and steps 8 and 16 jitter their taps. A tap keeps
// XLA's float uv + duv and finds its texel by floor(us w) as before; the window is indexed by
// that texel, and a texel outside it is read and derived from global memory. The roughness
// that derive keeps follows the roughness encoding, the template parameter kRough
// (common.cuh:decode_roughness), as the TPU kernel's rough_sq.
#include "relax_common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr int kTileX = 16, kTileY = 16, kMinCtas = 4;

struct AtrousArgs {
  const float* signal;  // (h, w, 4) (rgb, 2nd moment) at iteration 0, else (rgb, variance)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* hl;      // (h, w) history length
  float* out;           // (h, w, 4) (rgb, variance)
  const float* diff_conf;  // (h, w) IN_DIFF_CONFIDENCE or null
  const float* spec_conf;  // (h, w) IN_SPEC_CONFIDENCE or null
  const float* reproj;     // (h, w) the TA's specular reprojection confidence or null
  relax::Frame f;
  float denoising_range, depth_threshold, lobe_fraction, nwp_sve, phi, max_rel, min_material,
      history_threshold;
  int step, halo;  // halo: the staged window's margin (iteration 0)
  bool is_first, spec;
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

// one texel of the three tapped images, with what every tap derives from it alone
struct Texel {
  float4 g;  // the unpacked normal (x, y, z), viewZ (relax::view_z)
  float4 s;  // the signal
  float4 m;  // the signal's luminance, material (nr.w x 3), roughness, unused
};

template <int kRough>
__device__ __forceinline__ Texel derive(const relax::Frame& f, float4 s, float4 nr, float raw_z) {
  const V3 n = nrd::unpack_normal(nr.x, nr.y);
  return Texel{make_float4(n.x, n.y, n.z, relax::view_z(f, raw_z)), s,
               make_float4(relax::luminance(s.x, s.y, s.z), nr.w * 3.0f,
                           nrd::decode_roughness<kRough>(nr.z), 0.0f)};
}

template <int kRough>
__device__ __forceinline__ Texel load_texel(const AtrousArgs& a, int tx, int ty) {
  const size_t k = Image<float, 4>{a.signal, a.f.w, a.f.h}.index(tx, ty);
  return derive<kRough>(a.f, __ldg(reinterpret_cast<const float4*>(a.signal) + k),
                __ldg(reinterpret_cast<const float4*>(a.nr) + k), __ldg(a.view_z + k));
}

// The tile's window of texels, clamp-to-edge: wh rows of ww texels from (ox, oy), in shared
// memory, or nothing (g null) where the stride is not staged.
struct Window {
  const float4* g;
  const float4* s;
  const float4* m;
  int ox, oy, ww, wh;
};

template <int kRough>
__device__ __forceinline__ Texel fetch(const AtrousArgs& a, const Window& wnd, int tx, int ty) {
  const int i = tx - wnd.ox, j = ty - wnd.oy;
  if (wnd.g != nullptr && (unsigned)i < (unsigned)wnd.ww && (unsigned)j < (unsigned)wnd.wh) {
    const int k = j * wnd.ww + i;
    return Texel{wnd.g[k], wnd.s[k], wnd.m[k]};
  }
  return load_texel<kRough>(a, tx, ty);
}

// the 5x5 spatial variance estimation of a short history (clamp-to-edge)
template <int kRough>
__device__ __forceinline__ void variance_estimation(const AtrousArgs& a, const Window& wnd,
                                                    int x, int y, V3 n, float mat_c, float hl,
                                                    float out[4]) {
  float swsum = 0.0f, s_rgb[3] = {0.0f, 0.0f, 0.0f}, s_m1 = 0.0f, s_m2 = 0.0f;
  for (int dy = -2; dy <= 2; ++dy)
    for (int dx = -2; dx <= 2; ++dx) {
      const Texel t = fetch<kRough>(a, wnd, x + dx, y + dy);
      const V3 ns{t.g.x, t.g.y, t.g.z};
      float w_ = nrd::compute_weight(nrd::acos_approx(nrd::dot3(n, ns)), a.nwp_sve, 0.0f);
      w_ = w_ * (fmaxf(t.m.y, a.min_material) == mat_c ? 1.0f : 0.0f);
      const float s[4] = {t.s.x, t.s.y, t.s.z, t.s.w};
      swsum = swsum + w_;
#pragma unroll
      for (int c = 0; c < 3; ++c) s_rgb[c] = s_rgb[c] + s[c] * w_;
      s_m1 = s_m1 + t.m.x * w_;
      s_m2 = s_m2 + s[3] * w_;
    }
  swsum = fmaxf(swsum, 1e-6f);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = s_rgb[c] / swsum;
  s_m1 = s_m1 / swsum;
  s_m2 = s_m2 / swsum;
  const float boost = fmaxf(4.0f / (hl + 1.0f), 1.0f);
  out[3] = fmaxf(s_m2 - s_m1 * s_m1, 0.0f) * boost;
}

// saturate(multiplier (1 - confidence)) x a relaxation, saturated
__device__ __forceinline__ float relaxation(const AtrousArgs& a, float conf, float r) {
  return nrd::saturate(nrd::saturate(a.conf_mult * (1.0f - conf)) * r);
}

template <bool kStaged, int kRough>
__global__ void __launch_bounds__(kTileX * kTileY, kMinCtas) relax_atrous_kernel(AtrousArgs a) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  Window wnd{nullptr, nullptr, nullptr, 0, 0, 0, 0};
  if constexpr (kStaged) {  // every thread of the CTA stages, then the ones outside the image leave
    extern __shared__ float4 window[];
    wnd.ox = blockIdx.x * kTileX - a.halo;
    wnd.oy = blockIdx.y * kTileY - a.halo;
    wnd.ww = kTileX + 2 * a.halo;
    wnd.wh = kTileY + 2 * a.halo;
    const int n = wnd.ww * wnd.wh;
    float4* g = window;
    float4* s = window + n;
    float4* m = window + 2 * n;
    for (int j = threadIdx.y; j < wnd.wh; j += kTileY)
      for (int i = threadIdx.x; i < wnd.ww; i += kTileX) {
        const Texel t = load_texel<kRough>(a, wnd.ox + i, wnd.oy + j);
        g[j * wnd.ww + i] = t.g;
        s[j * wnd.ww + i] = t.s;
        m[j * wnd.ww + i] = t.m;
      }
    wnd.g = g;
    wnd.s = s;
    wnd.m = m;
    __syncthreads();
  }
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const Texel ct = fetch<kRough>(a, wnd, x, y);
  const float hl = __ldg(a.hl + i);
  const V3 n{ct.g.x, ct.g.y, ct.g.z};
  const float mat_c = fmaxf(ct.m.y, a.min_material);
  float out[4];
  if (a.is_first && !(hl >= a.history_threshold)) {
    variance_estimation<kRough>(a, wnd, x, y, n, mat_c, hl, out);
#pragma unroll
    for (int c = 0; c < 4; ++c) a.out[4 * i + c] = out[c];
    return;
  }

  const float fw = (float)a.f.w, fh = (float)a.f.h;
  const float u = nrd::pixel_u(x, a.f.w), v = nrd::pixel_u(y, a.f.h);
  const float z = ct.g.w;
  const V3 xc = relax::world_pos(a.f, u, v, z);
  const float thr = a.depth_threshold * (a.f.ortho == 0.0f ? z : 1.0f);
  const float c[4] = {ct.s.x, ct.s.y, ct.s.z, ct.s.w};

  // the diffuse lobe fraction, relaxed by IN_DIFF_CONFIDENCE
  const float dlf0 =
      a.is_first ? a.lobe_fraction : 0.99f + (a.lobe_fraction - 0.99f) * nrd::saturate(hl / 5.0f);
  float dlf = dlf0, lum_relax = 1.0f;
  if (a.diff_conf != nullptr) {
    const float conf = __ldg(a.diff_conf + i);
    dlf = dlf0 + (1.0f - dlf0) * relaxation(a, conf, a.conf_normal);
    lum_relax = 1.0f - relaxation(a, conf, a.conf_lum);
  }
  const float nwp = relax::normal_weight_param2(dlf);

  // the specular relaxations and, after iteration 0, the specular weights' parameters
  const bool spec_taps = a.spec && !a.is_first;
  float nwp_simpl = 0.0f, ra = 0.0f, rb = 0.0f, angle0 = 0.0f, f0 = 0.0f;
  V3 cv{0.0f, 0.0f, 0.0f};
  if (a.spec) {
    const float reproj = a.reproj != nullptr ? __ldg(a.reproj + i) : 1.0f;
    lum_relax = 1.0f;
    if ((a.step <= 4 || a.is_first) && a.reproj != nullptr)
      lum_relax = 1.0f + (reproj - 1.0f) * a.lesr;
    float spec_lobe = a.laf, dlf_simpl = dlf0;
    if (a.spec_conf != nullptr) {
      const float conf = __ldg(a.spec_conf + i);
      const float rr = relaxation(a, conf, a.conf_normal);
      dlf_simpl = dlf0 + (1.0f - dlf0) * rr;
      spec_lobe = a.laf + (1.0f - a.laf) * rr;
      lum_relax = lum_relax * (1.0f - relaxation(a, conf, a.conf_lum));
    }
    if (spec_taps) {
      nwp_simpl = relax::normal_weight_param2(dlf_simpl);
      const float rough = ct.m.z;
      ra = 1.0f / (0.01f + 0.99f * nrd::saturate(rough * a.rf));
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

  float var;
  if (a.is_first) {
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const float k = kPrefilter[abs(dx)][abs(dy)];
        const float4 s = fetch<kRough>(a, wnd, x + dx, y + dy).s;
        pre[0] = pre[0] + s.x * k;
        pre[1] = pre[1] + s.y * k;
        pre[2] = pre[2] + s.z * k;
        pre[3] = pre[3] + s.w * k;
      }
    const float m1 = relax::luminance(pre[0], pre[1], pre[2]);
    var = fmaxf(pre[3] - m1 * m1, 0.0f);
  } else {
    var = c[3];
  }

  const float phi_inv = 1.0f / fmaxf(a.phi * sqrtf(var), 1e-4f);
  const float center_l = ct.m.x;
  const float rinv_x = 1.0f / fw, rinv_y = 1.0f / fh;
  float wsum = a.w0;
  float acc[4] = {c[0] * a.w0, c[1] * a.w0, c[2] * a.w0, c[3] * (a.is_first ? a.w0 : a.w0_sq)};
  for (int yy = -1; yy <= 1; ++yy)
    for (int xx = -1; xx <= 1; ++xx) {
      if (xx == 0 && yy == 0) continue;
      const float kern = (xx == 0 || yy == 0) ? a.k01 : a.k11;
      const float us = u + ((float)(xx * a.step) + offx) * rinv_x;
      const float vs = v + ((float)(yy * a.step) + offy) * rinv_y;
      const float inside = nrd::in_screen_nearest(us, vs);
      const int tx = nrd::to_index(floorf(us * fw)), ty = nrd::to_index(floorf(vs * fh));
      const Texel t = fetch<kRough>(a, wnd, tx, ty);
      const float zs = t.g.w;
      const V3 ns{t.g.x, t.g.y, t.g.z};
      const float ms = t.m.y;
      const V3 xs = relax::world_pos(a.f, us, vs, zs);
      float gw = (relax::plane_dist(xs, xc, n) < thr ? 1.0f : 0.0f) * kern;
      gw = gw * inside * (zs < a.denoising_range ? 1.0f : 0.0f);
      const float angle = nrd::acos_approx(nrd::dot3(n, ns));
      float w_;
      if (spec_taps) {
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
      w_ = w_ * (fmaxf(ms, a.min_material) == mat_c ? 1.0f : 0.0f);
      const float s[4] = {t.s.x, t.s.y, t.s.z, t.s.w};
      const float sl = t.m.x;
      const float lw = fminf(fabsf(center_l - sl) * phi_inv, a.max_rel) * lum_relax;
      w_ = w_ * expf(-lw);
      wsum = wsum + w_;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[ch] = acc[ch] + s[ch] * w_;
      acc[3] = acc[3] + s[3] * (a.is_first ? w_ : w_ * w_);
    }
  if (a.is_first) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) out[ch] = acc[ch] / wsum;
    const float m1 = relax::luminance(out[0], out[1], out[2]);
    out[3] = fmaxf(out[3] - m1 * m1, 0.0f);
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[ch] = acc[ch] / wsum;
    out[3] = acc[3] / (wsum * wsum);
  }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) a.out[4 * i + ch] = out[ch];
}

}  // namespace

// ptrs: signal, view_z, nr, history_length, out, then diff_conf, spec_conf, reproj (each may
//       be null)
// consts: frame geometry (relax::load_frame), denoising_range, depth_threshold,
//         lobe_fraction, nwp_sve, phi, max_rel, min_material, history_threshold, step,
//         is_first (0 or 1), frame index low 16 bits, high 16 bits, w0, w0^2, k01, k11,
//         confidence multiplier, normal and luminance relaxations, specular (0 or 1), the
//         settings' lobe fraction, roughness fraction, normal edge-stopping relaxation, lobe
//         slack, luminance and roughness edge-stopping relaxations, roughness edge stopping
//         (0 or 1), roughness mode (0 LINEAR, 1 SQRT_LINEAR, 2 SQ_LINEAR)
extern "C" int nrd_relax_atrous(void* const* p, const float* c, int w, int h, void* stream) {
  AtrousArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.hl = (const float*)p[3];
  a.out = (float*)p[4];
  a.diff_conf = (const float*)p[5];
  a.spec_conf = (const float*)p[6];
  a.reproj = (const float*)p[7];
  a.f = relax::load_frame(c, w, h);
  const float* q = c + relax::kFrameConsts;
  a.denoising_range = q[0];
  a.depth_threshold = q[1];
  a.lobe_fraction = q[2];
  a.nwp_sve = q[3];
  a.phi = q[4];
  a.max_rel = q[5];
  a.min_material = q[6];
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
  // iteration 0 reads the 5x5 estimation's neighbours and its taps'
  a.halo = a.step > 2 ? a.step : 2;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const size_t smem =
      a.is_first ? (size_t)(kTileX + 2 * a.halo) * (kTileY + 2 * a.halo) * 3 * sizeof(float4) : 0;
  if (a.is_first && rough == 0)
    relax_atrous_kernel<true, 0><<<grid, block, smem, (cudaStream_t)stream>>>(a);
  else if (a.is_first && rough == 1)
    relax_atrous_kernel<true, 1><<<grid, block, smem, (cudaStream_t)stream>>>(a);
  else if (a.is_first && rough == 2)
    relax_atrous_kernel<true, 2><<<grid, block, smem, (cudaStream_t)stream>>>(a);
  else if (rough == 0)
    relax_atrous_kernel<false, 0><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (rough == 1)
    relax_atrous_kernel<false, 1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (rough == 2)
    relax_atrous_kernel<false, 2><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
