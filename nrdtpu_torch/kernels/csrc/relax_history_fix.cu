// K19: RELAX history fix: where the history is short (history length <= frame num, frame num
// != 1) the 24 taps of the 5x5 at the pixel's own stride floor(base / (1 + hl) + 0.5), clamp
// addressing with the in-screen test, weighted by plane distance, the normal weight (diffuse:
// pow(max(0.01, n . ns), power); specular: the specular normal weight at the angle0 / f0 of
// history length 5 and the tap's view vector relaxed by roughness_edge_stopping_relaxation)
// and material, counted where the weight is above 1e-4; elsewhere the signal passes through
// (and the taps are skipped). Replaces nrdtpu/kernels/relax_pallas.py:1499
// relax_history_fix_pallas; computes nrdtpu/passes/relax/kernels.py:1021-1131 per pixel for
// one signal. The plain version is
// nrdtpu_torch/kernels/relax_history_fix.py:relax_history_fix_ref. One thread per pixel.
#include "relax_common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

struct RelaxHfArgs {
  const float* signal;  // (h, w, 4)
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  const float* hl;      // (h, w) history length
  float* out;           // (h, w, 4)
  relax::Frame f;
  float depth_threshold, base_stride, frame_num, normal_power, min_material;
  bool spec;
  float laf, slack, resr;  // specular: lobe fraction, lobe slack, roughness relaxation
};

__global__ void __launch_bounds__(256) relax_history_fix_kernel(RelaxHfArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const Image<float, 4> sig{a.signal, a.f.w, a.f.h};
  float acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = sig.at(x, y, k);
  const float hl = a.hl[i];
  if (hl <= a.frame_num && a.frame_num != 1.0f) {
    const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
    const Image<float, 1> vz{a.view_z, a.f.w, a.f.h};
    const float fw = (float)a.f.w, fh = (float)a.f.h;
    const float z = relax::view_z(a.f, vz.at(x, y, 0));
    const V3 n = nrd::unpack_normal(nr.at(x, y, 0), nr.at(x, y, 1));
    const float mat_c = fmaxf(nr.at(x, y, 3) * 3.0f, a.min_material);
    const V3 xc = relax::world_pos(a.f, nrd::pixel_u(x, a.f.w), nrd::pixel_u(y, a.f.h), z);
    const float thr = a.depth_threshold * (a.f.ortho == 0.0f ? z : 1.0f);
    const float stride = floorf(a.base_stride / (1.0f + hl) + 0.5f);
    float angle0 = 0.0f, f0 = 0.0f;
    V3 cv{0.0f, 0.0f, 0.0f};
    if (a.spec) {
      relax::normal_weight_params_atrous(nr.at(x, y, 2), 5.0f, 1.0f, 0.0f, a.laf, a.slack,
                                         &angle0, &f0);
      cv = relax::neg_normalize(xc);
    }
    float wsum = 1.0f;
    for (int j = -2; j <= 2; ++j)
      for (int k = -2; k <= 2; ++k) {
        if (j == 0 && k == 0) continue;
        const float posx = (float)x + (float)k * stride, posy = (float)y + (float)j * stride;
        const float inside =
            (posx >= 0.0f && posx < fw && posy >= 0.0f && posy < fh) ? 1.0f : 0.0f;
        const int tx = (int)fminf(fmaxf(posx, 0.0f), fw - 1.0f);
        const int ty = (int)fminf(fmaxf(posy, 0.0f), fh - 1.0f);
        const V3 ns = nrd::unpack_normal(nr.at(tx, ty, 0), nr.at(tx, ty, 1));
        const float ms = nr.at(tx, ty, 3) * 3.0f;
        const float zs = relax::view_z(a.f, vz.at(tx, ty, 0));
        const V3 xs = relax::world_pos(a.f, ((float)tx + 0.5f) / fw, ((float)ty + 0.5f) / fh, zs);
        const float gw = relax::plane_dist(xs, xc, n) < thr ? 1.0f : 0.0f;
        float dw;
        if (!a.spec) {
          dw = gw * powf(fmaxf(nrd::dot3(n, ns), 0.01f), a.normal_power);
        } else {
          const V3 sv = relax::neg_normalize(
              V3{xs.x + a.resr * xc.x, xs.y + a.resr * xc.y, xs.z + a.resr * xc.z});
          dw = gw * relax::specular_normal_weight_atrous(angle0, f0, n, ns, cv, sv);
        }
        dw = dw * inside;
        dw = dw * (fmaxf(ms, a.min_material) == mat_c ? 1.0f : 0.0f);
        if (dw > 1e-4f) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = acc[c] + sig.at(tx, ty, c) * dw;
          wsum = wsum + dw;
        }
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] / wsum;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) a.out[4 * i + c] = acc[c];
}

}  // namespace

// ptrs: signal, view_z, nr, history_length, out
// consts: frame geometry (relax::load_frame), depth_threshold, base_stride, frame_num,
//         normal_power (already max(power, 0.01)), min_material, specular (0 or 1), lobe
//         fraction, lobe slack, roughness edge-stopping relaxation
extern "C" int nrd_relax_history_fix(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  RelaxHfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.hl = (const float*)p[3];
  a.out = (float*)p[4];
  a.f = relax::load_frame(c, w, h);
  const float* q = c + relax::kFrameConsts;
  a.depth_threshold = q[0];
  a.base_stride = q[1];
  a.frame_num = q[2];
  a.normal_power = q[3];
  a.min_material = q[4];
  a.spec = q[5] != 0.0f;
  a.laf = q[6];
  a.slack = q[7];
  a.resr = q[8];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  relax_history_fix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
