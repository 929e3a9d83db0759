// H2: REBLUR spatial filter of one signal (PrePass, Blur, PostBlur), diffuse or specular, with
// its centre's geometry and parameters. Replaces nrdtpu/kernels/reblur_blur2.py:264
// spatial_filter_taps_pallas2 and v1 nrdtpu/kernels/reblur_pallas.py:1207; computes
// nrdtpu/passes/reblur/kernels.py:763 (diffuse), :1564 (specular), :2075 (the diffuse PrePass)
// with their geometry (:1783) per pixel. The plain version is
// nrdtpu_torch/kernels/spatial_filter.py:spatial_filter_ref.
//
// Design for the H100: one thread a pixel, 16x16 CTAs. The centre reads its raw viewZ, packed
// normal, signal and (Blur, PostBlur) accumulation speed, and computes what the pass glue
// computed into 16-23 planes before: the frame geometry (reblur_filters.cuh:filter_geometry),
// then the stage's parameters (diff_prepass_params, spec_prepass_params, diff_blur_params,
// spec_blur_params). Then sf_filter's tap loop, unchanged. The modes are template parameters:
// the tap count (8, or 6 in performance mode), the signal and the PrePass. The PrePass, which
// runs before the history fix, unpacks its taps' geometry from the packed planes (PackedTaps);
// Blur and PostBlur read the (unpacked normal, scaled viewZ) plane that H3 writes
// (UnpackedTaps: 8-9 % faster than PackedTaps there on frame 4 at 2560x1440, PERF.md).
// kMinCtas: the CTAs an SM that ptxas is asked to fit (4: 50-59 registers, no spill; at 5 the
// specular instances spilled 8-24 B and ran no faster, PERF.md).
// The checkerboard PrePass is a fourth template parameter (kCb, PrePass instances only): the
// pixel's has_data comes from (x, y), the frame index and the mode's parity, host integers, not
// from a mask plane; the centre's hit distance is zeroed where it has none before the
// parameters are computed (the radius, ha / hb and the lobe radius read it), its weight is
// has_data, and where the weight sum is 0 the epilogue writes reblur_filters.cuh's
// cb_neighbor_resolve, as NRD's PrePass shader does (the JAX package does it as glue after the
// TPU kernel, nrdtpu/passes/reblur/kernels.py:1682-1684, :2122-2128). The non-cb instances
// compile as before.
// The SH variants are a template parameter before kCb (kSh, every stage, no checkerboard): the
// signal's SH1 rides sf_filter's taps with each tap's final weight (reblur_filters.cuh); the
// non-SH instances compile as before.
// The occlusion variants are a template parameter after kSh (kOcc, Blur and PostBlur only, no
// SH, no checkerboard: the occlusion path has no PrePass): the signal is the (h, w, 1) hit
// distance, read and written as one float a pixel, and the min hit-distance weight of its
// parameters drops sqrt(nlas) (reblur_filters.cuh:diff_blur_params / spec_blur_params; TPU
// reblur_blur2.py:276 at c = 1). The four-channel instances compile as before.
// The roughness encodings are a template parameter after kCb (kRough, specular instances only:
// 1 SQRT_LINEAR, 2 SQ_LINEAR; build.ROUGHNESS_MODE): the reference reads the centre's roughness
// as packed (unpack_nr3, nrdtpu/passes/reblur/kernels.py:37-42, :1576) and decodes each tap's
// (:1716), so these instances take the packed plane, compute the centre from it as before and
// decode at the taps (reblur_filters.cuh:PackedTapsT / UnpackedTapsT). The diffuse filter reads
// no roughness, and the kRough 0 instances compile as before.
// The RGBA normal encodings are the last template parameter (kDec, at kRough 0 only): nr is the
// plane that the frame decodes once (its normal .xyz, its roughness .w decoded), which the
// reference's centre reads decoded too at these formats (unpack_nr3 falls back to unpack_nr,
// nrdtpu/passes/reblur/kernels.py:37-42); the centre's geometry and the taps read it as it is
// and test no material (reblur_filters.cuh). The R10G10B10A2 instances compile as before.
#include "reblur_filters.cuh"

namespace {

using nrd::Image;

constexpr int kMinCtas = 4;

struct SfArgs {
  const float* signal;     // (h, w, 4), or (h, w, 1) with kOcc
  const float* view_z;     // (h, w) raw
  const float* nr;         // (h, w, 4)
  const float* data1;      // (h, w) accumulation speed: Blur and PostBlur only
  const float4* geometry;  // (h, w) the taps' unpacked normal and scaled viewZ (not PrePass)
  float* out;              // (h, w, 4), or (h, w, 1) with kOcc
  float* hdt;              // (h, w) hitDistForTracking, specular PrePass only
  const float* sh;         // (h, w, 4) the signal's SH1 (kSh)
  float* out_sh;           // (h, w, 4) (kSh)
  float min_material, prepass_radius;
  nrd::CbConsts cb;  // the checkerboard PrePass only
  nrd::SfFrame f;
  nrd::GeometryConsts geo;
  nrd::BlurConsts blur;
  nrd::StageConsts stage;
};

template <int kTaps, bool kSpec, bool kPrepass, bool kSh, bool kOcc, bool kCb, int kRough = 0,
          bool kDec = false>
__global__ void __launch_bounds__(256, kMinCtas) spatial_filter_kernel(SfArgs a) {
  static_assert(!kCb || kPrepass, "the checkerboard mode is the PrePass's");
  static_assert(kRough == 0 || kSpec, "the diffuse filter reads no roughness");
  static_assert(!(kDec && kRough != 0), "the decoded plane's roughness is decoded");
  static_assert(!kOcc || (!kPrepass && !kSh), "the occlusion mode is Blur's and PostBlur's");
  constexpr nrd::SfMode mode = !kSpec ? nrd::SfMode::kDiffuse
                               : kPrepass ? nrd::SfMode::kPrepass : nrd::SfMode::kSpec;
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.f.w || y >= a.f.h) return;
  const size_t i = (size_t)y * a.f.w + x;
  const Image<float, 4> nr{a.nr, a.f.w, a.f.h};
  const Image<float, 4> sig{a.signal, a.f.w, a.f.h};
  const float4 nrc = __ldg(reinterpret_cast<const float4*>(a.nr) + i);
  float hit_dist = kOcc ? __ldg(a.signal + i) : __ldg(a.signal + 4 * i + 3);
  float has_data = 1.0f;
  if constexpr (kCb) {  // the centre's signal zeroed where it has no data, as signal * cb_mask
    has_data = nrd::cb_has_data(x, y, a.f.frame_index, a.cb.parity);
    hit_dist = hit_dist * has_data;
  }
  const float data1 = kPrepass ? 0.0f : __ldg(a.data1 + i);
  const float u = nrd::pixel_u(x, a.f.w), v = nrd::pixel_u(y, a.f.h);
  const nrd::FilterGeometry g =
      nrd::filter_geometry<kSpec, kDec>(a.f, a.geo, u, v, __ldg(a.view_z + i), nrc);

  float prm[kSpec ? nrd::kSfPrepassParams : nrd::kSfDiffParams];
  if constexpr (kPrepass && kSpec)
    nrd::spec_prepass_params(a.blur, a.stage, a.geo, a.f.ortho, a.prepass_radius, hit_dist, g,
                             prm);
  else if constexpr (kPrepass)
    nrd::diff_prepass_params(a.blur, a.stage, a.prepass_radius, hit_dist, g, prm);
  else if constexpr (kSpec)
    nrd::spec_blur_params<kOcc>(a.blur, a.stage, hit_dist, data1, g.hds, g.fsz, g.nov,
                                g.roughness, g.smc, prm);
  else
    nrd::diff_blur_params<kOcc>(a.blur, a.stage, hit_dist, data1, g.hds, g.fsz, g.nov, g.nv.x,
                                g.nv.y, prm);

  nrd::Centre c;
  c.x = x;
  c.y = y;
  c.u = u;
  c.v = v;
  c.material = kDec ? 0.0f : nrc.w * 3.0f;
  c.ga = g.ga;
  c.gb = g.gb;
  c.fsz = g.fsz;
  c.n = g.n;
  c.nv = g.nv;
  float out[4], sh_out[4];
  float* const hdt = kSpec && kPrepass ? a.hdt + i : nullptr;
  if constexpr (kPrepass) {
    const nrd::PackedTapsT<kRough, kDec> taps{nr, Image<float, 1>{a.view_z, a.f.w, a.f.h},
                                              a.f.view_z_scale};
    const float sum =
        nrd::sf_filter<kTaps, mode, kCb, kSh>(a.f, c, prm, 1, a.min_material, sig, taps, out,
                                              hdt, has_data, a.sh, sh_out);
    if constexpr (kCb)
      if (sum == 0.0f)
        nrd::cb_neighbor_resolve(sig, taps, x, y, g.view_z, g.fsz, g.nov, a.cb.denoising_range,
                                 out);
  } else
    nrd::sf_filter<kTaps, mode, false, kSh, kOcc>(a.f, c, prm, 1, a.min_material, sig,
                                                  nrd::UnpackedTapsT<kRough, kDec>{a.geometry, nr},
                                                  out, hdt, 1.0f, a.sh, sh_out);
  if constexpr (kOcc)
    a.out[i] = out[3];
  else
    reinterpret_cast<float4*>(a.out)[i] = make_float4(out[0], out[1], out[2], out[3]);
  if constexpr (kSh)
    reinterpret_cast<float4*>(a.out_sh)[i] =
        make_float4(sh_out[0], sh_out[1], sh_out[2], sh_out[3]);
}

using Kernel = void (*)(SfArgs);

template <int kTaps, bool kSh, bool kDec = false>
Kernel pick_stage(bool spec, bool prepass) {
  if (prepass)
    return spec ? spatial_filter_kernel<kTaps, true, true, kSh, false, false, 0, kDec>
                : spatial_filter_kernel<kTaps, false, true, kSh, false, false, 0, kDec>;
  return spec ? spatial_filter_kernel<kTaps, true, false, kSh, false, false, 0, kDec>
              : spatial_filter_kernel<kTaps, false, false, kSh, false, false, 0, kDec>;
}

// the instances on the RGBA formats' decoded plane (kDec; the roughness decoded, kRough 0)
template <int kTaps>
Kernel pick_dec(bool spec, bool prepass, bool cb, bool sh, bool occ) {
  if (prepass && cb)
    return spec ? spatial_filter_kernel<kTaps, true, true, false, false, true, 0, true>
                : spatial_filter_kernel<kTaps, false, true, false, false, true, 0, true>;
  if (occ)  // Blur and PostBlur
    return spec ? spatial_filter_kernel<kTaps, true, false, false, true, false, 0, true>
                : spatial_filter_kernel<kTaps, false, false, false, true, false, 0, true>;
  return sh ? pick_stage<kTaps, true, true>(spec, prepass)
            : pick_stage<kTaps, false, true>(spec, prepass);
}

// the specular instances that decode the taps' roughness (kRough 1 or 2)
template <int kTaps, int kRough>
Kernel pick_rough(bool prepass, bool cb, bool sh, bool occ) {
  if (prepass && cb) return spatial_filter_kernel<kTaps, true, true, false, false, true, kRough>;
  if (occ) return spatial_filter_kernel<kTaps, true, false, false, true, false, kRough>;
  if (sh)
    return prepass ? spatial_filter_kernel<kTaps, true, true, true, false, false, kRough>
                   : spatial_filter_kernel<kTaps, true, false, true, false, false, kRough>;
  return prepass ? spatial_filter_kernel<kTaps, true, true, false, false, false, kRough>
                 : spatial_filter_kernel<kTaps, true, false, false, false, false, kRough>;
}

template <int kTaps>
Kernel pick(bool spec, bool prepass, bool cb, bool sh, bool occ, int rough, bool dec) {
  if (dec) return pick_dec<kTaps>(spec, prepass, cb, sh, occ);
  if (spec && rough == 1) return pick_rough<kTaps, 1>(prepass, cb, sh, occ);
  if (spec && rough == 2) return pick_rough<kTaps, 2>(prepass, cb, sh, occ);
  if (prepass && cb)
    return spec ? spatial_filter_kernel<kTaps, true, true, false, false, true>
                : spatial_filter_kernel<kTaps, false, true, false, false, true>;
  if (occ)  // Blur and PostBlur
    return spec ? spatial_filter_kernel<kTaps, true, false, false, true, false>
                : spatial_filter_kernel<kTaps, false, false, false, true, false>;
  return sh ? pick_stage<kTaps, true>(spec, prepass) : pick_stage<kTaps, false>(spec, prepass);
}

}  // namespace

// ptrs: signal, view_z, nr, data1 and geometry (null in the PrePass), out, hdt (specular
//       PrePass only), sh and out_sh (SH only)
// consts (spatial_filter.py:launch_consts): frustum[4], rect_w, rect_h, rect_inv_w,
//         rect_inv_h, view_z_scale, ortho_mode, world_to_view[3][3], min_rect_dim_mul_unproject,
//         unproject, plane_dist_sensitivity, hit-distance params[4], lobe angle fraction and
//         1 - it, encoding error, max and min blur radius, the signal's PrePass blur radius, the
//         fade's a and b - a, the stage's rotator[4], fraction scale, radius scale, min
//         hit-distance weight scale and scaled roughness fraction, min material, ntaps (8 or
//         6), stage (0 PrePass, 1 Blur, 2 PostBlur), specular (0 or 1),
//         use_prepass_not_only, frame index low 16 bits, high 16 bits, the checkerboard's
//         has-data parity (-1: off; PrePass only), denoising range, SH (0 or 1; not with the
//         checkerboard), one-channel occlusion signal (0 or 1; Blur and PostBlur only, no SH),
//         the roughness encoding of nr (0 LINEAR, 1 SQRT_LINEAR, 2 SQ_LINEAR; specular only),
//         nr the RGBA formats' decoded plane (0 or 1; at LINEAR only)
extern "C" int nrd_spatial_filter(void* const* p, const float* c, int w, int h, void* stream) {
  SfArgs a;
  a.signal = (const float*)p[0];
  a.view_z = (const float*)p[1];
  a.nr = (const float*)p[2];
  a.data1 = (const float*)p[3];
  a.geometry = (const float4*)p[4];
  a.out = (float*)p[5];
  a.hdt = (float*)p[6];
  a.sh = (const float*)p[7];
  a.out_sh = (float*)p[8];
  a.f.w = w;
  a.f.h = h;
  for (int k = 0; k < 4; ++k) a.f.fr[k] = c[k];
  a.f.rect_w = c[4];
  a.f.rect_h = c[5];
  a.f.inv_rect_w = 1.0f / c[4];
  a.f.inv_rect_h = 1.0f / c[5];
  a.blur.rect_inv_w = c[6];
  a.blur.rect_inv_h = c[7];
  a.f.view_z_scale = c[8];
  a.f.ortho = c[9];
  for (int k = 0; k < 9; ++k) a.geo.wtv[k] = c[10 + k];
  a.geo.min_rect_dim_mul_unproject = c[19];
  a.geo.unproject = c[20];
  a.geo.plane_dist_sensitivity = c[21];
  for (int k = 0; k < 4; ++k) a.f.hdp[k] = c[22 + k];
  a.blur.laf = c[26];
  a.blur.one_minus_laf = c[27];
  a.blur.enc_err = c[28];
  a.blur.max_blur_radius = c[29];
  a.blur.min_blur_radius = c[30];
  a.prepass_radius = c[31];
  a.blur.fade_a = c[32];
  a.blur.fade_ba = c[33];
  for (int k = 0; k < 4; ++k) a.stage.rot[k] = c[34 + k];
  a.stage.fraction_scale = c[38];
  a.stage.radius_scale = c[39];
  a.stage.mhdw_scale = c[40];
  a.stage.rf_scaled = c[41];
  a.min_material = c[42];
  const int ntaps = (int)c[43], stage = (int)c[44];
  const bool spec = c[45] != 0.0f, prepass = stage == 0;
  a.f.use_prepass_not_only = c[46];
  a.f.frame_index = (uint32_t)c[47] | ((uint32_t)c[48] << 16);
  a.cb.parity = (int)c[49];
  a.cb.denoising_range = c[50];
  const bool cb = a.cb.parity >= 0;
  const bool sh = c[51] != 0.0f;
  const bool occ = c[52] != 0.0f;
  const int rough = (int)c[53];
  const bool dec = c[54] != 0.0f;
  if ((ntaps != 8 && ntaps != 6) || stage < 0 || stage > 2 || a.cb.parity > 1 ||
      rough < 0 || rough > 2 || (rough != 0 && !spec) || (rough != 0 && dec) ||
      (occ && (prepass || sh)) ||
      (cb && !prepass) || (sh && (cb || a.sh == nullptr || a.out_sh == nullptr)) ||
      (!prepass && (a.data1 == nullptr || a.geometry == nullptr)) ||
      (spec && prepass && a.hdt == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const Kernel kernel =
      ntaps == 8 ? pick<8>(spec, prepass, cb, sh, occ, rough, dec)
                 : pick<6>(spec, prepass, cb, sh, occ, rough, dec);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
