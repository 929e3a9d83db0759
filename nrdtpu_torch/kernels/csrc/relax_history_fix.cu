// K19: RELAX history fix: where the history is short (history length <= frame num, frame num
// != 1) the 24 taps of the 5x5 at the pixel's own stride floor(base / (1 + hl) + 0.5), clamp
// addressing with the in-screen test, weighted by plane distance, the normal weight (diffuse:
// pow(max(0.01, n . ns), power); specular: the specular normal weight at the angle0 / f0 of
// history length 5 and the tap's view vector relaxed by roughness_edge_stopping_relaxation)
// and material, counted where the weight is above 1e-4; elsewhere the signal passes through
// (and the taps are skipped). Replaces nrdtpu/kernels/relax_pallas.py:1499
// relax_history_fix_pallas; computes nrdtpu/passes/relax/kernels.py:1021-1131 per pixel for
// one signal. The plain version is
// nrdtpu_torch/kernels/relax_history_fix.py:relax_history_fix_ref.
//
// Design for the H100: two stream-ordered launches of one entry.
//   0. one thread a texel: what a tap derives from its texel alone, the same for every pixel
//      that taps it, into a (h, w, 2) float4 record plane (scratch of the wrapper's): the
//      world position at the texel's centre with the material x 3, and the unpacked normal
//      with the scaled viewZ. Under --fmad=false it is the tap's own expression, bit for bit.
//      Skipped where frame num is 1 (no pixel runs the taps).
//   1. one thread a pixel: the pass-through or the taps. A tap reads its texel's two records
//      and signal as three float4 through the read-only path, its index clamped once and its
//      in-screen test taken from the integer position (the stride is a whole number). The
//      pixel's own geometry comes from its records too; the per-pixel constants (1 / angle0
//      of the specular smoothstep, roughness relaxation x the centre's position) are hoisted
//      out of the taps, and the diffuse weight at the default power 8 is three squarings.
// The specular weight's centre roughness follows the roughness encoding, the template
// parameter kRough (common.cuh:decode_roughness); the diffuse taps read no roughness.
// kMinCtas: the CTAs an SM that ptxas is asked to fit (chosen by A/B timing, PERF.md).
#include "relax_common.cuh"

namespace {

using nrd::V3;

constexpr int kMinCtas = 4;
constexpr float kMaxStride = 1048576.0f;  // beyond it every off-centre tap is off screen

struct RelaxHfArgs {
  const float* signal;  // (h, w, 4)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* hl;      // (h, w) history length
  float* out;           // (h, w, 4)
  float4* rec;          // (h, w, 2) the taps' records: (world position, material x 3),
                        // (unpacked normal, viewZ)
  relax::Frame f;
  float depth_threshold, base_stride, frame_num, normal_power, min_material;
  float laf, slack, resr;  // specular: lobe fraction, lobe slack, roughness relaxation
};

__device__ __forceinline__ V3 xyz(float4 v) { return V3{v.x, v.y, v.z}; }

// phase 0: one texel's records
__device__ __forceinline__ void write_records(const RelaxHfArgs& a, int x, int y) {
  const size_t i = (size_t)y * a.f.w + x;
  const float4 nr = __ldg(reinterpret_cast<const float4*>(a.nr) + i);
  const float z = relax::view_z(a.f, __ldg(a.view_z + i));
  const V3 n = nrd::unpack_normal(nr.x, nr.y);
  const V3 p = relax::world_pos(a.f, ((float)x + 0.5f) / (float)a.f.w,
                                ((float)y + 0.5f) / (float)a.f.h, z);
  a.rec[2 * i] = make_float4(p.x, p.y, p.z, nr.w * 3.0f);
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

// phase 1: the history fix of one pixel
template <bool kSpec, int kRough>
__device__ __forceinline__ void history_fix_pixel(const RelaxHfArgs& a, int x, int y) {
  const size_t i = (size_t)y * a.f.w + x;
  const float4* sig = reinterpret_cast<const float4*>(a.signal);
  const float4 sc = __ldg(sig + i);
  float acc[4] = {sc.x, sc.y, sc.z, sc.w};
  const float hl = a.hl[i];
  if (hl <= a.frame_num && a.frame_num != 1.0f) {
    const float4* rec = a.rec;
    const float4 r0 = rec[2 * i], r1 = rec[2 * i + 1];
    const V3 xc = xyz(r0), n = xyz(r1);
    const float z = r1.w;
    const float mat_c = fmaxf(r0.w, a.min_material);
    const float thr = a.depth_threshold * (a.f.ortho == 0.0f ? z : 1.0f);
    const float stride = floorf(a.base_stride / (1.0f + hl) + 0.5f);
    const int step = (int)fminf(fmaxf(stride, -kMaxStride), kMaxStride);
    const bool pow8 = a.normal_power == 8.0f;
    float angle0 = 0.0f, f0 = 0.0f, inv_angle0 = 0.0f;
    V3 cv{0.0f, 0.0f, 0.0f}, rx{0.0f, 0.0f, 0.0f};
    if constexpr (kSpec) {
      relax::normal_weight_params_atrous(nrd::decode_roughness<kRough>(__ldg(a.nr + 4 * i + 2)),
                                         5.0f, 1.0f, 0.0f, a.laf, a.slack, &angle0, &f0);
      inv_angle0 = 1.0f / angle0;
      cv = relax::neg_normalize(xc);
      rx = V3{a.resr * xc.x, a.resr * xc.y, a.resr * xc.z};
    }
    float wsum = 1.0f;
    for (int j = -2; j <= 2; ++j) {
      const int py = y + j * step;
      const bool inside_y = py >= 0 && py < a.f.h;
      const size_t row = (size_t)nrd::clampi(py, 0, a.f.h - 1) * a.f.w;
#pragma unroll
      for (int k = -2; k <= 2; ++k) {
        if (j == 0 && k == 0) continue;
        const int px = x + k * step;
        const float inside = (inside_y && px >= 0 && px < a.f.w) ? 1.0f : 0.0f;
        const size_t t = row + nrd::clampi(px, 0, a.f.w - 1);
        const float4 s = __ldg(sig + t);
        const float4 q0 = __ldg(rec + 2 * t), q1 = __ldg(rec + 2 * t + 1);
        const V3 xs = xyz(q0), ns = xyz(q1);
        const float gw = relax::plane_dist(xs, xc, n) < thr ? 1.0f : 0.0f;
        float dw;
        if constexpr (!kSpec) {
          dw = gw * diffuse_weight(nrd::dot3(n, ns), a.normal_power, pow8);
        } else {
          const V3 sv = relax::neg_normalize(V3{xs.x + rx.x, xs.y + rx.y, xs.z + rx.z});
          const float cosa = fminf(nrd::dot3(n, ns), nrd::dot3(cv, sv));
          const float tt = nrd::saturate(nrd::acos_approx(cosa) * inv_angle0);
          dw = gw * nrd::saturate(1.0f - tt * tt * (3.0f - 2.0f * tt) * f0);
        }
        dw = dw * inside;
        dw = dw * (fmaxf(q0.w, a.min_material) == mat_c ? 1.0f : 0.0f);
        const bool live = dw > 1e-4f;
        acc[0] = live ? acc[0] + s.x * dw : acc[0];
        acc[1] = live ? acc[1] + s.y * dw : acc[1];
        acc[2] = live ? acc[2] + s.z * dw : acc[2];
        acc[3] = live ? acc[3] + s.w * dw : acc[3];
        wsum = live ? wsum + dw : wsum;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] / wsum;
  }
  reinterpret_cast<float4*>(a.out)[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// phase 0: the records; 1, 2: the history fix, diffuse or specular (roughness mode kRough)
template <int kPhase, int kRough = 0>
__global__ void __launch_bounds__(256, kPhase == 0 ? 1 : kMinCtas)
    relax_history_fix_kernel(RelaxHfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  if constexpr (kPhase == 0)
    write_records(a, x, y);
  else
    history_fix_pixel<kPhase == 2, kRough>(a, x, y);
}

}  // namespace

// ptrs: signal, view_z, nr, history_length, out, records ((h, w, 8) float scratch, 16-byte
//       aligned; may be null where frame_num is 1)
// consts: frame geometry (relax::load_frame), depth_threshold, base_stride, frame_num,
//         normal_power (already max(power, 0.01)), min_material, specular (0 or 1), lobe
//         fraction, lobe slack, roughness edge-stopping relaxation, roughness mode (0 LINEAR,
//         1 SQRT_LINEAR, 2 SQ_LINEAR)
extern "C" int nrd_relax_history_fix(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  RelaxHfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.hl = (const float*)p[3];
  a.out = (float*)p[4];
  a.rec = (float4*)p[5];
  a.f = relax::load_frame(c, w, h);
  const float* q = c + relax::kFrameConsts;
  a.depth_threshold = q[0];
  a.base_stride = q[1];
  a.frame_num = q[2];
  a.normal_power = q[3];
  a.min_material = q[4];
  const bool spec = q[5] != 0.0f;
  a.laf = q[6];
  a.slack = q[7];
  a.resr = q[8];
  const int rough = (int)q[9];
  if (rough < 0 || rough > 2) return (int)cudaErrorInvalidValue;
  const bool taps = a.frame_num != 1.0f;
  if (taps && a.rec == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (taps) {
    relax_history_fix_kernel<0><<<grid, block, 0, (cudaStream_t)stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (spec && rough == 0)
    relax_history_fix_kernel<2, 0><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (spec && rough == 1)
    relax_history_fix_kernel<2, 1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (spec)
    relax_history_fix_kernel<2, 2><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    relax_history_fix_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
