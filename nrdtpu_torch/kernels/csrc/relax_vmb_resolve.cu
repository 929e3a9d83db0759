// K17: RELAX virtual-motion loader (TemporalAccumulation's loadVirtualMotionBasedPrevData):
// the 2x2 footprint at the virtual-motion uv, each previous texel's world position in the
// previous camera tested by plane distance |(x - camera_delta - x_prev) . n| against the
// per-tap in-screen threshold and by material; any / all of the four; the specular slow and
// responsive histories through the CatRom footprint where the surface-motion footprint was
// bicubic and all four pass, else with the custom bilinear weights; the previous reflection
// hitT and packed normal/roughness, plain bilinear at uv x resolution_scale_prev. With the SH
// variants (kSh) also the bf16 specular SH slow and responsive histories, bilinear with the
// custom weights at the 2x2 only (kernels.py:992-995; the TPU kernel's sh_prev /
// sh_resp_prev, relax_pallas.py:1222, :1246-1249). Replaces
// nrdtpu/kernels/relax_pallas.py:1219 relax_vmb_resolve (without its block-base capture);
// computes nrdtpu/passes/relax/kernels.py:742-796 per pixel. The plain version is
// nrdtpu_torch/kernels/relax_vmb_resolve.py:relax_vmb_resolve_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, one instance per mode <kSh, kDec>
// (kDec: the current plane is the RGBA formats' decoded one, and the taps test no material,
// as the TPU kernel's mat_occ=False), at most kMinCtas' register budget. Bound by its
// gathers: both histories go through one CatRom footprint in one loop over its 5 bilinear
// samples (common.cuh:catrom_apply4: each texel read as one float4, a weight of 0 included,
// `kKeepNaN`, so that a NaN history texel the plain version multiplies by 0 leaves NaN where
// the plain version's does), in place of 5 bilinear samples of 16 scalar reads per history;
// the material maxima return NaN where the material is NaN (common.cuh:max_bound), as
// clamp_min does; the previous packed normal is read as four float4; every (h, w, 4) output is
// written as one float4; an SH history's 2x2 is four 8-byte loads (uint2) widened to float.
#include "relax_common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr int kMinCtas = 4;  // chosen by A/B timing on the H100 (PERF.md)

struct RelaxVmbArgs {
  const float* uv;        // (h, w, 2) virtual-motion uv
  const float* n;         // (h, w, 3)
  const float* xm;        // (h, w, 3) world position - camera delta
  const float* thr_base;  // (h, w)
  const float* nr;        // (h, w, 4) current packed normal/roughness/material
  const float* smb_found; // (h, w) 2 where the surface-motion footprint was bicubic
  const float* prev_vz;   // (h, w) raw
  const float* prev_mat;  // (h, w)
  const float* prev_ht;   // (h, w) reflection hitT
  const float* prev_nr;   // (h, w, 4) RGBA8-quantized 0.5 n + 0.5, roughness
  const float* hist;      // (h, w, 4) specular slow history
  const float* resp;      // (h, w, 4) specular responsive history
  float* sig;             // (3, h, w, 4): spec_vmb, spec_vmb_resp, nr_packed
  float* planes;          // (3, h, w): hit_t, any, all
  const uint2* sh;        // (h, w, 4) bf16 specular SH slow history (kSh only)
  const uint2* sh_resp;   // (h, w, 4) bf16 specular SH responsive history (kSh only)
  float* sh_out;          // (2, h, w, 4): sh_vmb, sh_vmb_resp (kSh only)
  relax::Frame pf;        // the previous camera's frustum vectors
  float rect_prev_w, rect_prev_h, res_scale_x, res_scale_y, min_material;
};

template <bool kSh, bool kDec = false>
__global__ void __launch_bounds__(256, kMinCtas) relax_vmb_resolve_kernel(RelaxVmbArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  const int w = a.pf.w, h = a.pf.h;
  if (x >= w || y >= h) return;
  const size_t i = (size_t)y * w + x;
  const size_t plane = (size_t)w * h;
  const Image<float, 1> prev_vz{a.prev_vz, w, h};
  const Image<float, 1> prev_mat{a.prev_mat, w, h};

  const float u = __ldg(a.uv + 2 * i), v = __ldg(a.uv + 2 * i + 1);
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  const float ox = floorf(posx), oy = floorf(posy);
  const int bx = nrd::to_index(ox), by = nrd::to_index(oy);

  // IsInScreenBilinear per tap
  const float x0ok = (ox >= 0.0f && ox < a.rect_prev_w) ? 1.0f : 0.0f;
  const float x1ok = (ox + 1.0f >= 0.0f && ox + 1.0f < a.rect_prev_w) ? 1.0f : 0.0f;
  const float y0ok = (oy >= 0.0f && oy < a.rect_prev_h) ? 1.0f : 0.0f;
  const float y1ok = (oy + 1.0f >= 0.0f && oy + 1.0f < a.rect_prev_h) ? 1.0f : 0.0f;
  const float in4[4] = {x0ok * y0ok, x1ok * y0ok, x0ok * y1ok, x1ok * y1ok};

  const V3 n{__ldg(a.n + 3 * i), __ldg(a.n + 3 * i + 1), __ldg(a.n + 3 * i + 2)};
  const V3 xm{__ldg(a.xm + 3 * i), __ldg(a.xm + 3 * i + 1), __ldg(a.xm + 3 * i + 2)};
  const float tb = __ldg(a.thr_base + i);
  float mat_c = 0.0f;  // kDec: no material test
  if constexpr (!kDec) mat_c = nrd::max_bound(__ldg(a.nr + 4 * i + 3) * 3.0f, a.min_material);
  float valid[4];
  bool any = false, all = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int tx = bx + (k & 1), ty = by + (k >> 1);
    const float zp = relax::view_z(a.pf, prev_vz.ldg(tx, ty));
    const V3 xp = relax::world_pos(a.pf, ((float)tx + 0.5f) / a.rect_prev_w,
                                   ((float)ty + 0.5f) / a.rect_prev_h, zp);
    const float thr = tb * in4[k] - 1e-6f;
    float ok = relax::plane_dist(xm, xp, n) <= thr ? 1.0f : 0.0f;
    if constexpr (!kDec)
      ok = ok * (mat_c == nrd::max_bound(prev_mat.ldg(tx, ty), a.min_material) ? 1.0f : 0.0f);
    valid[k] = ok;
    any = any || ok > 0.0f;
    all = all && ok > 0.0f;
  }
  float bw[4], cw[4];
  nrd::bilinear_weights(posx - ox, posy - oy, bw);
#pragma unroll
  for (int k = 0; k < 4; ++k) cw[k] = bw[k] * valid[k];
  const bool bicubic = __ldg(a.smb_found + i) == 2.0f && all;

  // both histories at uv x rect_prev through one footprint (as K16)
  const nrd::CatromTaps taps =
      nrd::catrom_taps(u * a.rect_prev_w, v * a.rect_prev_h, bicubic, cw);
  const float4* img[2] = {reinterpret_cast<const float4*>(a.hist),
                          reinterpret_cast<const float4*>(a.resp)};
  float4 out[2];
  nrd::catrom_apply4<2, true>(img, w, h, taps, out);
  float4* sig = reinterpret_cast<float4*>(a.sig);
  sig[i] = out[0];
  sig[plane + i] = out[1];

  // plain bilinear of the packed normal and the reflection hitT
  const float ur = u * a.res_scale_x, vr = v * a.res_scale_y;
  sig[2 * plane + i] = nrd::sample_bilinear4(Image<float, 4>{a.prev_nr, w, h}, ur, vr);
  float ht;
  nrd::sample_bilinear(Image<float, 1>{a.prev_ht, w, h}, ur, vr, &ht);
  a.planes[i] = ht;
  a.planes[plane + i] = any ? 1.0f : 0.0f;
  a.planes[2 * plane + i] = all ? 1.0f : 0.0f;
  if constexpr (kSh) {  // the SH histories: the custom-weight bilinear at the 2x2
    float4* sh_out = reinterpret_cast<float4*>(a.sh_out);
    sh_out[i] = nrd::bilinear_custom4(a.sh, w, h, bx, by, cw);
    sh_out[plane + i] = nrd::bilinear_custom4(a.sh_resp, w, h, bx, by, cw);
  }
}

}  // namespace

// ptrs: uv, n, xm, thr_base, nr, smb_found, prev_vz, prev_mat, prev_ht, prev_nr, hist, resp,
//       sig, planes, then sh, sh_resp (bf16) and sh_out (all three null without SH)
// consts: the previous camera's geometry (relax::load_frame), rect_prev_w, rect_prev_h,
//         res_scale_x, res_scale_y, min_material, the plane decoded (kDec: 0 or 1)
extern "C" int nrd_relax_vmb_resolve(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  RelaxVmbArgs a;
  a.uv = (const float*)p[0];
  a.n = (const float*)p[1];
  a.xm = (const float*)p[2];
  a.thr_base = (const float*)p[3];
  a.nr = (const float*)p[4];
  a.smb_found = (const float*)p[5];
  a.prev_vz = (const float*)p[6];
  a.prev_mat = (const float*)p[7];
  a.prev_ht = (const float*)p[8];
  a.prev_nr = (const float*)p[9];
  a.hist = (const float*)p[10];
  a.resp = (const float*)p[11];
  a.sig = (float*)p[12];
  a.planes = (float*)p[13];
  a.sh = (const uint2*)p[14];
  a.sh_resp = (const uint2*)p[15];
  a.sh_out = (float*)p[16];
  const bool sh = a.sh != nullptr;
  if (sh != (a.sh_resp != nullptr) || sh != (a.sh_out != nullptr))
    return (int)cudaErrorInvalidValue;
  a.pf = relax::load_frame(c, w, h);
  const float* q = c + relax::kFrameConsts;
  a.rect_prev_w = q[0];
  a.rect_prev_h = q[1];
  a.res_scale_x = q[2];
  a.res_scale_y = q[3];
  a.min_material = q[4];
  const bool dec = q[5] != 0.0f;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dec && sh)
    relax_vmb_resolve_kernel<true, true><<<grid, block, 0, s>>>(a);
  else if (dec)
    relax_vmb_resolve_kernel<false, true><<<grid, block, 0, s>>>(a);
  else if (sh)
    relax_vmb_resolve_kernel<true><<<grid, block, 0, s>>>(a);
  else
    relax_vmb_resolve_kernel<false><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
