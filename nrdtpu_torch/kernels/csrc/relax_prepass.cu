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
// nrdtpu_torch/kernels/relax_prepass.py:relax_prepass_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, one instance per mode
// <kSpec, kRough> (the specular signal, the roughness encoding of common.cuh:
// decode_roughness, applied to the centre's roughness and to each tap's, as the TPU kernel's
// rough_sq), at most kMinCtas' register budget. Bound by its 8 gathers a pixel, each of a
// texel up to 30 px x the hit-distance factor away:
//   - the taps in a rolled loop (an unrolled one holds every tap's code; the offsets and
//     Gaussians are read from the parameter block by the tap's index);
//   - each tap's packed normal and signal as one float4 each, issued with its viewZ before
//     the weight chain; the signal is kept only where the weight is non-zero (the plain
//     version's s = 0 where w == 0);
//   - the tap's divisions: the snap to the texel centre by the reciprocal of the rect size
//     (floor(us x w) cannot change: us is within an ulp of the centre), the plane distance by
//     the reciprocal of its per-pixel scale, and the specular t by __fdividef. Each moves a
//     value by an ulp or two, which can flip a threshold only at a tap that sits on it; the
//     A/B on the H100 found them faster with no value more outside the tolerance (PERF.md);
//   - the centre's signal read, and the output written, as one float4.
#include "relax_common.cuh"

namespace {

using nrd::V3;

constexpr int kMinCtas = 5;  // chosen by A/B timing on the H100 (PERF.md)
constexpr int kTaps = 8;

struct PrepassArgs {
  const float* signal;  // (h, w, 4) radiance, raw hitT
  const float* view_z;  // (h, w) raw
  const float* nr;      // (h, w, 4)
  float* out;           // (h, w, 4)
  relax::Frame f;
  float denoising_range, frustum_size_scale, blur_radius, nwp, ha, min_hd_weight,
      depth_threshold, min_material;
  float off[2 * kTaps], gauss[kTaps];
  float unproject, normal_lobe_fraction, rf, lobe_tan_scale;  // specular only
};

__device__ __forceinline__ float4 clip(float4 v) {  // [0, FP16_MAX]
  return make_float4(fminf(fmaxf(v.x, 0.0f), 65504.0f), fminf(fmaxf(v.y, 0.0f), 65504.0f),
                     fminf(fmaxf(v.z, 0.0f), 65504.0f), fminf(fmaxf(v.w, 0.0f), 65504.0f));
}

template <bool kSpec, int kRough>
__global__ void __launch_bounds__(256, kMinCtas) relax_prepass_kernel(PrepassArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const nrd::Image<float, 4> img{a.nr, a.f.w, a.f.h};  // clamped indices of every plane
  const float4* sig = reinterpret_cast<const float4*>(a.signal);
  const float4* nr = reinterpret_cast<const float4*>(a.nr);
  float4* out = reinterpret_cast<float4*>(a.out);

  const float4 c = __ldg(sig + i);
  if (a.blur_radius <= 0.0f) {  // the pass is off: the signal passes through
    float4 o = c;
    if constexpr (kSpec) o.w = fmaxf(fminf(c.w, a.denoising_range), 0.0f);
    out[i] = clip(o);
    return;
  }
  const float fw = (float)a.f.w, fh = (float)a.f.h;
  const float inv_fw = 1.0f / fw, inv_fh = 1.0f / fh;
  const float u = nrd::pixel_u(x, a.f.w), v = nrd::pixel_u(y, a.f.h);
  const float z = relax::view_z(a.f, __ldg(a.view_z + i));
  const float4 nc = __ldg(nr + i);
  const V3 n = nrd::unpack_normal(nc.x, nc.y);
  const float mat_c = fmaxf(nc.w * 3.0f, a.min_material);
  const V3 xc = relax::world_pos(a.f, u, v, z);
  const float frustum_size = a.frustum_size_scale * (z + (1.0f - z) * fabsf(a.f.ortho));
  float hit, radius, nwp, ha, hb, min_hd_weight, ra = 0.0f, rb = 0.0f, rough = 0.0f;
  float min_hit = 0.0f;
  if constexpr (!kSpec) {
    hit = c.w;
    const float hd = hit == 0.0f ? 1.0f : hit;
    radius = a.blur_radius * nrd::saturate(hd / frustum_size);
    nwp = a.nwp;
    ha = a.ha;
    hb = -(hit * a.ha);
    min_hd_weight = a.min_hd_weight;
  } else {
    hit = fmaxf(fminf(c.w, a.denoising_range), 0.0f);
    rough = nrd::decode_roughness<kRough>(nc.z);
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
  const float inv_dts = 1.0f / (a.f.ortho == 0.0f ? z : 1.0f);  // the plane distance's scale
  const float tap_floor = nrd::saturate((rough - 0.5f) / 0.5f);  // linearstep(0.5, 1, r)
  const float uw = u * fw, vh = v * fh;

  float acc[4] = {c.x, c.y, c.z, kSpec ? hit : c.w};
  float wsum = 1.0f;
#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    const float us = (floorf(uw + a.off[2 * k] * radius) + 0.5f) * inv_fw;
    const float vs = (floorf(vh + a.off[2 * k + 1] * radius) + 0.5f) * inv_fh;
    const size_t t = img.index(nrd::to_index(floorf(us * fw)), nrd::to_index(floorf(vs * fh)));
    const float4 s_tap = __ldg(sig + t);  // issued before the weights, used where w_ != 0
    const float4 ns4 = __ldg(nr + t);
    const float zs = relax::view_z(a.f, __ldg(a.view_z + t));
    const V3 ns = nrd::unpack_normal(ns4.x, ns4.y);
    const V3 xs = relax::world_pos(a.f, us, vs, zs);
    float w_ = nrd::in_screen_nearest(us, vs);
    w_ = w_ * (zs < a.denoising_range ? 1.0f : 0.0f);
    w_ = w_ * (mat_c == fmaxf(ns4.w * 3.0f, a.min_material) ? 1.0f : 0.0f);
    if constexpr (kSpec)
      w_ = w_ * nrd::compute_weight(nrd::decode_roughness<kRough>(ns4.z), ra, rb);
    w_ = w_ * nrd::compute_weight(nrd::acos_approx(nrd::dot3(n, ns)), nwp, 0.0f);
    w_ = w_ * (relax::plane_dist(xs, xc, n) * inv_dts <= a.depth_threshold ? 1.0f : 0.0f);
    const float4 s = w_ == 0.0f ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : s_tap;
    const float s3 = kSpec ? fmaxf(fminf(s.w, a.denoising_range), 0.0f) : s.w;
    w_ = w_ * (min_hd_weight + (1.0f - min_hd_weight) * nrd::compute_exponential_weight(s3, ha, hb));
    w_ = w_ * a.gauss[k];
    if constexpr (kSpec) {
      const V3 dx{xs.x - xc.x, xs.y - xc.y, xs.z - xc.z};
      const float tt = __fdividef(s3, hit + sqrtf(nrd::dot3(dx, dx)) + 1e-6f);
      const float st = nrd::saturate(tt);
      w_ = w_ * (st + (1.0f - st) * tap_floor);
      if (w_ != 0.0f && s3 != 0.0f) min_hit = fminf(min_hit, s3);
    }
    wsum = wsum + w_;
    acc[0] = acc[0] + s.x * w_;
    acc[1] = acc[1] + s.y * w_;
    acc[2] = acc[2] + s.z * w_;
    if constexpr (!kSpec) acc[3] = acc[3] + s3 * w_;
  }
  float4 o = make_float4(acc[0] / wsum, acc[1] / wsum, acc[2] / wsum, 0.0f);
  if constexpr (kSpec)
    o.w = min_hit == 1e6f ? 0.0f : min_hit;
  else
    o.w = acc[3] / wsum;
  out[i] = clip(o);
}

template <bool kSpec>
cudaError_t launch(const PrepassArgs& a, int rough, dim3 grid, dim3 block, cudaStream_t stream) {
  switch (rough) {
    case 0: relax_prepass_kernel<kSpec, 0><<<grid, block, 0, stream>>>(a); break;
    case 1: relax_prepass_kernel<kSpec, 1><<<grid, block, 0, stream>>>(a); break;
    case 2: relax_prepass_kernel<kSpec, 2><<<grid, block, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  for (int k = 0; k < 2 * kTaps; ++k) a.off[k] = q[8 + k];
  for (int k = 0; k < kTaps; ++k) a.gauss[k] = q[24 + k];
  const float spec = q[32];
  a.unproject = q[33];
  a.normal_lobe_fraction = q[34];
  a.rf = q[35];
  a.lobe_tan_scale = q[36];
  const int rough = (int)q[37];
  if ((spec != 0.0f && spec != 1.0f) || (float)rough != q[37]) return (int)cudaErrorInvalidValue;
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const cudaError_t err = spec != 0.0f ? launch<true>(a, rough, grid, block, (cudaStream_t)stream)
                                       : launch<false>(a, rough, grid, block, (cudaStream_t)stream);
  return (int)err;
}
