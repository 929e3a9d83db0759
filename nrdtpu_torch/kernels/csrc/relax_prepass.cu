// K15: RELAX PrePass, diffuse: 8 rotated Poisson taps at the pixel's own radius
// (diffusePrepassBlurRadius x hit-distance factor, at least 1 where hitT == 0), snapped to
// texel centres, weighted by in-screen, denoising range, material, normal angle, plane
// distance, hit distance and the tap's Gaussian; then the radius-disabled select and the
// FP16_MAX clip. Replaces nrdtpu/kernels/relax_pallas.py:751 relax_prepass_taps_pallas;
// computes nrdtpu/passes/relax/kernels.py:160-306 (diffuse branch) per pixel. The plain
// version is nrdtpu_torch/kernels/relax_prepass.py:relax_prepass_ref. One thread per pixel.
#include "relax_common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

struct PrepassArgs {
  const float* signal;  // (h, w, 4) radiance, raw hitT
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  float* out;           // (h, w, 4)
  relax::Frame f;
  float denoising_range, frustum_size_scale, blur_radius, nwp, ha, min_hd_weight,
      depth_threshold, min_material;
  float off[16], gauss[8];
};

__global__ void __launch_bounds__(256) relax_prepass_kernel(PrepassArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const Image<float, 4> sig{a.signal, a.f.w, a.f.h};
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const Image<float, 1> vz{a.view_z, a.f.w, a.f.h};

  float c[4], out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = sig.at(x, y, k);
  if (a.blur_radius <= 0.0f) {  // the pass is off: the signal passes through
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = c[k];
  } else {
    const float fw = (float)a.f.w, fh = (float)a.f.h;
    const float u = nrd::pixel_u(x, a.f.w), v = nrd::pixel_u(y, a.f.h);
    const float z = relax::view_z(a.f, vz.at(x, y, 0));
    const V3 n = nrd::unpack_normal(nr.at(x, y, 0), nr.at(x, y, 1));
    const float mat_c = fmaxf(nr.at(x, y, 3) * 3.0f, a.min_material);
    const V3 xc = relax::world_pos(a.f, u, v, z);
    const float frustum_size = a.frustum_size_scale * (z + (1.0f - z) * fabsf(a.f.ortho));
    const float hit = c[3];
    const float hd = hit == 0.0f ? 1.0f : hit;
    float radius = a.blur_radius * nrd::saturate(hd / frustum_size);
    if (hit == 0.0f) radius = fmaxf(radius, 1.0f);
    const float hb = -(hit * a.ha);
    const float dts = a.f.ortho == 0.0f ? z : 1.0f;

    float acc[4] = {c[0], c[1], c[2], c[3]};
    float wsum = 1.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float us = (floorf(u * fw + a.off[2 * k] * radius) + 0.5f) / fw;
      const float vs = (floorf(v * fh + a.off[2 * k + 1] * radius) + 0.5f) / fh;
      const int tx = nrd::to_index(floorf(us * fw)), ty = nrd::to_index(floorf(vs * fh));
      const V3 ns = nrd::unpack_normal(nr.at(tx, ty, 0), nr.at(tx, ty, 1));
      const float ms = nr.at(tx, ty, 3) * 3.0f;
      const float zs = relax::view_z(a.f, vz.at(tx, ty, 0));
      const V3 xs = relax::world_pos(a.f, us, vs, zs);
      float w_ = nrd::in_screen_nearest(us, vs);
      w_ = w_ * (zs < a.denoising_range ? 1.0f : 0.0f);
      w_ = w_ * (mat_c == fmaxf(ms, a.min_material) ? 1.0f : 0.0f);
      w_ = w_ * nrd::compute_weight(nrd::acos_approx(nrd::dot3(n, ns)), a.nwp, 0.0f);
      w_ = w_ * (relax::plane_dist(xs, xc, n) / dts <= a.depth_threshold ? 1.0f : 0.0f);
      float s[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) s[ch] = w_ == 0.0f ? 0.0f : sig.at(tx, ty, ch);
      w_ = w_ * (a.min_hd_weight +
                 (1.0f - a.min_hd_weight) * nrd::compute_exponential_weight(s[3], a.ha, hb));
      w_ = w_ * a.gauss[k];
      wsum = wsum + w_;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[ch] = acc[ch] + s[ch] * w_;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = acc[k] / wsum;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) a.out[4 * i + k] = fminf(fmaxf(out[k], 0.0f), 65504.0f);
}

}  // namespace

// ptrs: signal, view_z, nr, out
// consts: frame geometry (relax::load_frame), denoising_range, frustum_size_scale,
//         blur_radius, nwp, ha, min_hd_weight, depth_threshold, min_material,
//         offsets[16] (x, y per tap), gaussian weights[8]
extern "C" int nrd_relax_prepass(void* const* p, const float* c, int w, int h, void* stream) {
  PrepassArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.out = (float*)p[3];
  a.f = relax::load_frame(c, w, h);
  const float* q = c + relax::kFrameConsts;
  a.denoising_range = q[0];
  a.frustum_size_scale = q[1];
  a.blur_radius = q[2];
  a.nwp = q[3];
  a.ha = q[4];
  a.min_hd_weight = q[5];
  a.depth_threshold = q[6];
  a.min_material = q[7];
  for (int k = 0; k < 16; ++k) a.off[k] = q[8 + k];
  for (int k = 0; k < 8; ++k) a.gauss[k] = q[24 + k];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  relax_prepass_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
