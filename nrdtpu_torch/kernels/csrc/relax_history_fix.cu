// K19: RELAX history fix: where the history is short (history length <= frame num, frame num
// != 1) the 24 taps of the 5x5 at the pixel's own stride floor(base / (1 + hl) + 0.5), clamp
// addressing with the in-screen test, weighted by plane distance, the normal weight (diffuse:
// pow(max(0.01, n . ns), power); specular: the specular normal weight at the angle0 / f0 of
// history length 5 and the tap's view vector relaxed by roughness_edge_stopping_relaxation)
// and material, counted where the weight is above 1e-4; elsewhere the signal passes through
// (and the taps are skipped). With the SH variants (kSh) each signal's SH plane accumulates
// with the signal's tap weight where it is above 1e-4, over the same weight sum, and passes
// through where the fix does not apply (kernels.py:1095-1098, :1111-1114, :1124-1130; the TPU
// kernel's d_sh / s_sh, relax_pallas.py:1290, :1297-1298). Replaces
// nrdtpu/kernels/relax_pallas.py:1499
// relax_history_fix_pallas; computes nrdtpu/passes/relax/kernels.py:1021-1131 per pixel for
// one signal or for both. The plain version is
// nrdtpu_torch/kernels/relax_history_fix.py:relax_history_fix_ref.
//
// Design for the H100: two stream-ordered launches of one entry.
//   0. one thread a texel: what a tap derives from its texel alone, the same for every pixel
//      that taps it, into a (h, w, 2) float4 record plane (scratch of the wrapper's): the
//      world position at the texel's centre with the material x 3, and the unpacked normal
//      with the scaled viewZ. Under --fmad=false it is the tap's own expression, bit for bit.
//      Skipped where frame num is 1 (no pixel runs the taps).
//   1-3. one thread a pixel: the pass-through or the taps, of the diffuse signal (phase 1),
//      the specular one (2) or both (3). A tap reads its texel's two records and each
//      signal as float4 through the read-only path, its index clamped once and its in-screen
//      test taken from the integer position (the stride is a whole number). The pixel's own
//      geometry comes from its records too; the per-pixel constants (1 / angle0 of the
//      specular smoothstep, roughness relaxation x the centre's position) are hoisted out of
//      the taps, and the diffuse weight at the default power 8 is three squarings. The
//      record does not depend on the signal: with both signals a tap reads it once, takes its
//      plane distance and in-screen test once, and weighs each signal with its own normal
//      weight and min material into its own accumulator. With SH a tap reads each signal's SH
//      texel as one float4 more, into an accumulator of its own.
// The specular weight's centre roughness follows the roughness encoding, the template
// parameter kRough (common.cuh:decode_roughness); the diffuse taps read no roughness. At the
// RGBA normal encodings every phase reads the decoded plane, the template parameter kDec
// (common.cuh:unpack_nr): the records' material lane holds 0 (the 32 B record kept) and the
// taps test no material (the TPU kernel's mat_occ=False).
// kMinCtas: the CTAs an SM that ptxas is asked to fit (chosen by A/B timing, PERF.md).
#include "relax_common.cuh"

namespace {

using nrd::V3;

constexpr int kMinCtas = 4;
constexpr float kMaxStride = 1048576.0f;  // beyond it every off-centre tap is off screen

struct RelaxHfArgs {
  const float* signal[2];  // (h, w, 4) each: the phase's signals, the diffuse one first
  const float* view_z;     // (h, w) raw
  const float* nr;         // (h, w, 4)
  const float* hl;         // (h, w) history length
  float* out[2];           // (h, w, 4) each, one a signal
  const float* sh[2];      // (h, w, 4) each: the signals' SH planes (kSh only)
  float* sh_out[2];        // (h, w, 4) each (kSh only)
  float4* rec;             // (h, w, 2) the taps' records: (world position, material x 3),
                           // (unpacked normal, viewZ)
  relax::Frame f;
  float depth_threshold, base_stride, frame_num, normal_power;
  float min_material[2];   // each signal's
  float laf, slack, resr;  // specular: lobe fraction, lobe slack, roughness relaxation
};

// The signals of a phase (1 diffuse, 2 specular, 3 both) and whether its signal k is specular.
template <int kPhase>
constexpr int kSignals = kPhase == 3 ? 2 : 1;
template <int kPhase>
__device__ __forceinline__ constexpr bool is_specular(int k) {
  return kPhase == 2 || (kPhase == 3 && k == 1);
}

__device__ __forceinline__ V3 xyz(float4 v) { return V3{v.x, v.y, v.z}; }

// phase 0: one texel's records (kDec: the material lane 0, the record's layout kept)
template <bool kDec>
__device__ __forceinline__ void write_records(const RelaxHfArgs& a, int x, int y) {
  const size_t i = (size_t)y * a.f.w + x;
  const float4 nr = __ldg(reinterpret_cast<const float4*>(a.nr) + i);
  const float z = relax::view_z(a.f, __ldg(a.view_z + i));
  const nrd::NormalRoughness u = nrd::unpack_nr<kDec>(nr);
  const V3 n = u.n;
  const V3 p = relax::world_pos(a.f, ((float)x + 0.5f) / (float)a.f.w,
                                ((float)y + 0.5f) / (float)a.f.h, z);
  a.rec[2 * i] = make_float4(p.x, p.y, p.z, u.mat);
  a.rec[2 * i + 1] = make_float4(n.x, n.y, n.z, z);
}

// max(0.01, n . ns)^power, three squarings at power 8
__device__ __forceinline__ float diffuse_weight(float c, float power, bool pow8) {
  const float p = fmaxf(c, 0.01f);
  if (pow8) {
    const float p2 = p * p, p4 = p2 * p2;
    return p4 * p4;
  }
  return powf(p, power);
}

// phases 1-3: the history fix of one pixel, for each signal of the phase (kDec: no material
// test)
template <int kPhase, int kRough, bool kSh, bool kDec>
__device__ __forceinline__ void history_fix_pixel(const RelaxHfArgs& a, int x, int y) {
  constexpr int kN = kSignals<kPhase>;
  constexpr bool kSpec = kPhase != 1;  // some signal takes the specular weight
  const size_t i = (size_t)y * a.f.w + x;
  float acc[kN][4];
  float4 acc_sh[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float4 sc = __ldg(reinterpret_cast<const float4*>(a.signal[k]) + i);
    acc[k][0] = sc.x;
    acc[k][1] = sc.y;
    acc[k][2] = sc.z;
    acc[k][3] = sc.w;
    if constexpr (kSh) acc_sh[k] = __ldg(reinterpret_cast<const float4*>(a.sh[k]) + i);
  }
  const float hl = a.hl[i];
  if (hl <= a.frame_num && a.frame_num != 1.0f) {
    const float4* rec = a.rec;
    const float4 r0 = rec[2 * i], r1 = rec[2 * i + 1];
    const V3 xc = xyz(r0), n = xyz(r1);
    const float z = r1.w;
    float mat_c[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) mat_c[k] = fmaxf(r0.w, a.min_material[k]);
    const float thr = a.depth_threshold * (a.f.ortho == 0.0f ? z : 1.0f);
    const float stride = floorf(a.base_stride / (1.0f + hl) + 0.5f);
    const int step = (int)fminf(fmaxf(stride, -kMaxStride), kMaxStride);
    const bool pow8 = a.normal_power == 8.0f;
    float angle0 = 0.0f, f0 = 0.0f, inv_angle0 = 0.0f;
    V3 cv{0.0f, 0.0f, 0.0f}, rx{0.0f, 0.0f, 0.0f};
    if constexpr (kSpec) {
      relax::normal_weight_params_atrous(
          nrd::decode_roughness<kRough>(__ldg(a.nr + 4 * i + nrd::kRoughLane<kDec>)), 5.0f,
          1.0f, 0.0f, a.laf, a.slack, &angle0, &f0);
      inv_angle0 = 1.0f / angle0;
      cv = relax::neg_normalize(xc);
      rx = V3{a.resr * xc.x, a.resr * xc.y, a.resr * xc.z};
    }
    float wsum[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) wsum[k] = 1.0f;
    for (int j = -2; j <= 2; ++j) {
      const int py = y + j * step;
      const bool inside_y = py >= 0 && py < a.f.h;
      const size_t row = (size_t)nrd::clampi(py, 0, a.f.h - 1) * a.f.w;
#pragma unroll
      for (int kx = -2; kx <= 2; ++kx) {
        if (j == 0 && kx == 0) continue;
        const int px = x + kx * step;
        const float inside = (inside_y && px >= 0 && px < a.f.w) ? 1.0f : 0.0f;
        const size_t t = row + nrd::clampi(px, 0, a.f.w - 1);
        float4 s[kN], sh[kN];
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          s[k] = __ldg(reinterpret_cast<const float4*>(a.signal[k]) + t);
          if constexpr (kSh) sh[k] = __ldg(reinterpret_cast<const float4*>(a.sh[k]) + t);
        }
        const float4 q0 = __ldg(rec + 2 * t), q1 = __ldg(rec + 2 * t + 1);
        const V3 xs = xyz(q0), ns = xyz(q1);
        const float gw = relax::plane_dist(xs, xc, n) < thr ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          float dw;
          if (!is_specular<kPhase>(k)) {
            dw = gw * diffuse_weight(nrd::dot3(n, ns), a.normal_power, pow8);
          } else {
            const V3 sv = relax::neg_normalize(V3{xs.x + rx.x, xs.y + rx.y, xs.z + rx.z});
            const float cosa = fminf(nrd::dot3(n, ns), nrd::dot3(cv, sv));
            const float tt = nrd::saturate(nrd::acos_approx(cosa) * inv_angle0);
            dw = gw * nrd::saturate(1.0f - tt * tt * (3.0f - 2.0f * tt) * f0);
          }
          dw = dw * inside;
          if constexpr (!kDec)
            dw = dw * (fmaxf(q0.w, a.min_material[k]) == mat_c[k] ? 1.0f : 0.0f);
          const bool live = dw > 1e-4f;
          acc[k][0] = live ? acc[k][0] + s[k].x * dw : acc[k][0];
          acc[k][1] = live ? acc[k][1] + s[k].y * dw : acc[k][1];
          acc[k][2] = live ? acc[k][2] + s[k].z * dw : acc[k][2];
          acc[k][3] = live ? acc[k][3] + s[k].w * dw : acc[k][3];
          wsum[k] = live ? wsum[k] + dw : wsum[k];
          if constexpr (kSh)
            acc_sh[k] = live ? nrd::add_weighted(acc_sh[k], sh[k], dw) : acc_sh[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] = acc[k][c] / wsum[k];
      if constexpr (kSh) acc_sh[k] = nrd::divide(acc_sh[k], wsum[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    reinterpret_cast<float4*>(a.out[k])[i] = make_float4(acc[k][0], acc[k][1], acc[k][2],
                                                         acc[k][3]);
    if constexpr (kSh) reinterpret_cast<float4*>(a.sh_out[k])[i] = acc_sh[k];
  }
}

// phase 0: the records; 1, 2, 3: the history fix, diffuse, specular or both (roughness mode
// kRough), with the SH planes (kSh); kDec: the RGBA formats' decoded normal plane
// (common.cuh:unpack_nr), no material test (the TPU kernel's mat_occ=False)
template <int kPhase, int kRough = 0, bool kSh = false, bool kDec = false>
__global__ void __launch_bounds__(256, kPhase == 0 ? 1 : kMinCtas)
    relax_history_fix_kernel(RelaxHfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  if constexpr (kPhase == 0)
    write_records<kDec>(a, x, y);
  else
    history_fix_pixel<kPhase, kRough, kSh, kDec>(a, x, y);
}

template <int kPhase, bool kSh, bool kDec>
void launch_fix(const RelaxHfArgs& a, int rough, dim3 grid, dim3 block, cudaStream_t stream) {
  if (rough == 0)
    relax_history_fix_kernel<kPhase, 0, kSh, kDec><<<grid, block, 0, stream>>>(a);
  else if (rough == 1)
    relax_history_fix_kernel<kPhase, 1, kSh, kDec><<<grid, block, 0, stream>>>(a);
  else
    relax_history_fix_kernel<kPhase, 2, kSh, kDec><<<grid, block, 0, stream>>>(a);
}

template <bool kSh, bool kDec>
void launch_phase(const RelaxHfArgs& a, int signals, bool spec, int rough, dim3 grid,
                  dim3 block, cudaStream_t stream) {
  if (signals == 2)
    launch_fix<3, kSh, kDec>(a, rough, grid, block, stream);
  else if (spec)
    launch_fix<2, kSh, kDec>(a, rough, grid, block, stream);
  else
    relax_history_fix_kernel<1, 0, kSh, kDec><<<grid, block, 0, stream>>>(a);
}

}  // namespace

// ptrs: signal, view_z, nr, history_length, out, records ((h, w, 8) float scratch, 16-byte
//       aligned; may be null where frame_num is 1), then with both signals the specular
//       signal and its out (the first pair being the diffuse one), then the SH plane and its
//       out of the first signal and of the second (null without SH, or without a second)
// consts: frame geometry (relax::load_frame), depth_threshold, base_stride, frame_num,
//         normal_power (already max(power, 0.01)), min_material, specular (0 or 1), lobe
//         fraction, lobe slack, roughness edge-stopping relaxation, roughness mode (0 LINEAR,
//         1 SQRT_LINEAR, 2 SQ_LINEAR), signals (1 or 2), the specular signal's min material,
//         the plane decoded (kDec: 0 or 1)
extern "C" int nrd_relax_history_fix(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  RelaxHfArgs a;
  a.signal[0] = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.hl = (const float*)p[3];
  a.out[0] = (float*)p[4];
  a.rec = (float4*)p[5];
  a.f = relax::load_frame(c, w, h);
  const float* q = c + relax::kFrameConsts;
  a.depth_threshold = q[0];
  a.base_stride = q[1];
  a.frame_num = q[2];
  a.normal_power = q[3];
  a.min_material[0] = q[4];
  const bool spec = q[5] != 0.0f;
  a.laf = q[6];
  a.slack = q[7];
  a.resr = q[8];
  const int rough = (int)q[9];
  const int signals = (int)q[10];
  a.min_material[1] = q[11];
  const bool dec = q[12] != 0.0f;
  a.signal[1] = (const float*)p[6];
  a.out[1] = (float*)p[7];
  for (int k = 0; k < 2; ++k) {
    a.sh[k] = (const float*)p[8 + 2 * k];
    a.sh_out[k] = (float*)p[9 + 2 * k];
  }
  const bool sh = a.sh[0] != nullptr;
  if (rough < 0 || rough > 2 || signals < 1 || signals > 2) return (int)cudaErrorInvalidValue;
  // both signals: the diffuse one first, the specular one's weight
  if (signals == 2 && (!spec || a.signal[1] == nullptr || a.out[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool taps = a.frame_num != 1.0f;
  if (taps && a.rec == nullptr) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < signals; ++k)  // with SH, an SH plane and its out for every signal
    if ((a.sh[k] != nullptr) != sh || (a.sh_out[k] != nullptr) != sh)
      return (int)cudaErrorInvalidValue;
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const cudaStream_t s = (cudaStream_t)stream;
  if (taps) {
    if (dec)
      relax_history_fix_kernel<0, 0, false, true><<<grid, block, 0, s>>>(a);
    else
      relax_history_fix_kernel<0><<<grid, block, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dec && sh)
    launch_phase<true, true>(a, signals, spec, rough, grid, block, s);
  else if (dec)
    launch_phase<false, true>(a, signals, spec, rough, grid, block, s);
  else if (sh)
    launch_phase<true, false>(a, signals, spec, rough, grid, block, s);
  else
    launch_phase<false, false>(a, signals, spec, rough, grid, block, s);
  return (int)cudaGetLastError();
}
