// K15: RELAX PrePass: 8 rotated Poisson taps at the pixel's own radius (at least 1 where
// hitT == 0), snapped to texel centres, weighted by in-screen, denoising range, material,
// normal angle, plane distance, hit distance and the tap's Gaussian; then the radius-disabled
// select and the FP16_MAX clip. Diffuse: the radius is diffusePrepassBlurRadius x the
// hit-distance factor. Specular: the hit distance clamped to the denoising range, the radius
// from the dominant direction, the hit-distance factor and the spec magic curve capped by the
// lobe radius, the normal weight at half the lobe fraction with the pixel's roughness, the
// roughness weight, the tap weight lerp(saturate(t), 1, linearstep(0.5, 1, roughness)), and
// the min hitT of the kept taps in .w. Replaces nrdtpu/kernels/relax_pallas.py:751
// relax_prepass_taps_pallas (without its 32-px radius cap); computes
// nrdtpu/passes/relax/kernels.py:160-306 per pixel. The plain version is
// nrdtpu_torch/kernels/relax_prepass.py:relax_prepass_ref. One thread per pixel. The roughness
// encoding is the template parameter kRough (common.cuh:decode_roughness), applied to the
// centre's roughness and to each tap's, as the TPU kernel's rough_sq.
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
  bool spec;
  float unproject, normal_lobe_fraction, rf, lobe_tan_scale;  // specular only
};

template <int kRough>
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
    if (a.spec) out[3] = fmaxf(fminf(c[3], a.denoising_range), 0.0f);
  } else {
    const float fw = (float)a.f.w, fh = (float)a.f.h;
    const float u = nrd::pixel_u(x, a.f.w), v = nrd::pixel_u(y, a.f.h);
    const float z = relax::view_z(a.f, vz.at(x, y, 0));
    const V3 n = nrd::unpack_normal(nr.at(x, y, 0), nr.at(x, y, 1));
    const float mat_c = fmaxf(nr.at(x, y, 3) * 3.0f, a.min_material);
    const V3 xc = relax::world_pos(a.f, u, v, z);
    const float frustum_size = a.frustum_size_scale * (z + (1.0f - z) * fabsf(a.f.ortho));
    float hit, radius, nwp, ha, hb, min_hd_weight, ra = 0.0f, rb = 0.0f, rough = 0.0f;
    float min_hit = 0.0f;
    if (!a.spec) {
      hit = c[3];
      const float hd = hit == 0.0f ? 1.0f : hit;
      radius = a.blur_radius * nrd::saturate(hd / frustum_size);
      nwp = a.nwp;
      ha = a.ha;
      hb = -(hit * a.ha);
      min_hd_weight = a.min_hd_weight;
    } else {
      hit = fmaxf(fminf(c[3], a.denoising_range), 0.0f);
      c[3] = hit;
      rough = nrd::decode_roughness<kRough>(nr.at(x, y, 2));
      const V3 view = a.f.ortho == 0.0f ? relax::neg_normalize(xc)
                                        : V3{a.f.fwd[0], a.f.fwd[1], a.f.fwd[2]};
      float dfac;
      const V3 d = relax::specular_dominant_direction(n, view, rough, &dfac);
      const float nod = fabsf(nrd::dot3(n, d));
      const float hd = hit == 0.0f ? 1.0f : hit;
      const float smc = relax::spec_magic_curve(rough);
      radius = a.blur_radius * nrd::saturate(hd * nod / frustum_size) * smc;
      const float lobe_radius = hd * nod * (rough * rough * a.lobe_tan_scale);
      const float zz = z + hd * dfac;
      const float min_blur = lobe_radius / (a.unproject * (zz + (1.0f - zz) * fabsf(a.f.ortho)));
      radius = fminf(radius, min_blur);
      const float r = nrd::saturate(rough);
      const float p = a.normal_lobe_fraction;
      nwp = 1.0f / fmaxf(atanf(r * r * p / (1.0f - p + 1e-6f)), relax::kNormalUlp);
      ha = 1.0f / (0.0005f + 0.9995f * fminf(smc, 1.0f / 9.0f));
      hb = -(hit * ha);
      ra = 1.0f / (0.01f + 0.99f * nrd::saturate(rough * a.rf));
      rb = -(rough * ra);
      min_hd_weight = hit == 0.0f ? 1.0f : a.min_hd_weight * smc;
      min_hit = hit == 0.0f ? 1e6f : hit;
    }
    if (hit == 0.0f) radius = fmaxf(radius, 1.0f);
    const float dts = a.f.ortho == 0.0f ? z : 1.0f;
    const float tap_floor = nrd::saturate((rough - 0.5f) / 0.5f);  // linearstep(0.5, 1, r)

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
      if (a.spec)
        w_ = w_ * nrd::compute_weight(nrd::decode_roughness<kRough>(nr.at(tx, ty, 2)), ra, rb);
      w_ = w_ * nrd::compute_weight(nrd::acos_approx(nrd::dot3(n, ns)), nwp, 0.0f);
      w_ = w_ * (relax::plane_dist(xs, xc, n) / dts <= a.depth_threshold ? 1.0f : 0.0f);
      float s[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) s[ch] = w_ == 0.0f ? 0.0f : sig.at(tx, ty, ch);
      if (a.spec) s[3] = fmaxf(fminf(s[3], a.denoising_range), 0.0f);
      w_ = w_ * (min_hd_weight + (1.0f - min_hd_weight) * nrd::compute_exponential_weight(s[3], ha, hb));
      w_ = w_ * a.gauss[k];
      if (!a.spec) {
        wsum = wsum + w_;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) acc[ch] = acc[ch] + s[ch] * w_;
        continue;
      }
      const V3 dx{xs.x - xc.x, xs.y - xc.y, xs.z - xc.z};
      const float t = s[3] / (hit + sqrtf(nrd::dot3(dx, dx)) + 1e-6f);
      const float st = nrd::saturate(t);
      w_ = w_ * (st + (1.0f - st) * tap_floor);
      if (w_ != 0.0f && s[3] != 0.0f) min_hit = fminf(min_hit, s[3]);
      wsum = wsum + w_;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[ch] = acc[ch] + s[ch] * w_;
    }
    if (a.spec) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out[k] = acc[k] / wsum;
      out[3] = min_hit == 1e6f ? 0.0f : min_hit;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = acc[k] / wsum;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) a.out[4 * i + k] = fminf(fmaxf(out[k], 0.0f), 65504.0f);
}

}  // namespace

// ptrs: signal, view_z, nr, out
// consts: frame geometry (relax::load_frame), denoising_range, frustum_size_scale,
//         blur_radius, nwp, ha, min_hd_weight, depth_threshold, min_material,
//         offsets[16] (x, y per tap), gaussian weights[8], specular (0 or 1), unproject,
//         normal lobe fraction, roughness fraction, lobe tan scale sqrt(0.75 / 0.25),
//         roughness mode (0 LINEAR, 1 SQRT_LINEAR, 2 SQ_LINEAR)
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
  a.spec = q[32] != 0.0f;
  a.unproject = q[33];
  a.normal_lobe_fraction = q[34];
  a.rf = q[35];
  a.lobe_tan_scale = q[36];
  const int rough = (int)q[37];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (rough == 0)
    relax_prepass_kernel<0><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (rough == 1)
    relax_prepass_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else if (rough == 2)
    relax_prepass_kernel<2><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
