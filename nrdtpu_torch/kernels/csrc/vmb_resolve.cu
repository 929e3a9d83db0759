// N3: virtual-motion footprint resolve + specular history sampling (REBLUR specular TA).
// Replaces nrdtpu/kernels/reblur_pallas.py:779 reblur_vmb_resolve; computes the gathers of
// nrdtpu/passes/reblur/kernels.py:1163-1174, :1272-1310, :1338-1340 and :1457-1462 per
// pixel. With the SH variants (kSh) also the bf16 specular SH history, bilinear with the
// virtual-motion occlusion weights at the footprint's 2x2, as the fast history, never the
// CatRom (nrdtpu/passes/reblur/kernels.py:1491-1494; the TPU kernel's n_sh,
// nrdtpu/kernels/reblur_pallas.py:800, :829-830). The plain version is
// nrdtpu_torch/kernels/vmb_resolve.py:vmb_resolve_ref.
// One thread per pixel. The body is a device template <kSh> under two kernels: the SH kernel
// takes the SH history and its output as kernel parameters beside VmbArgs, not as fields of it
// (two more fields in VmbArgs moved the non-SH kernel from 63 to 71 registers, 3 CTAs an SM,
// and from 1620 to 1441 SASS instructions: ptxas on the H100, PERF.md), so that the non-SH
// kernel compiles as before. The SH history's 2x2 is four 8-byte loads
// (common.cuh:bilinear_custom4), written as one float4. The occlusion variants' kernel
// (vmb_resolve_occ_kernel, the body's kOcc) samples the (h, w, 1) bf16 hit-distance history
// through the same CatRom, one channel, and writes one float a pixel (the TPU kernel at c = 1,
// nrdtpu/passes/reblur/denoiser.py:317-318); VmbArgs is unchanged.
// The RGBA normal encodings (kDec, the body's last template parameter, one kernel each of the
// three above: vmb_resolve_dec_kernel, vmb_resolve_sh_dec_kernel, vmb_resolve_occ_dec_kernel):
// prev_nr is the previous plane that the frame decodes once, its roughness .w, and the taps
// test no material (the TPU kernel's mat_occ=False, reblur_pallas.py:798). The other kernels
// compile as before.
#include "common.cuh"

namespace {

using nrd::Image;

enum Param { NOX, THR, NX, NY, NZ, VVX, VVY, VVZ, RA, RB, RSIGMA, PSM, MAT, SMB_CATROM };

struct VmbArgs {
  const float* uv;              // (h, w, 2) virtual-motion uv
  const float* params;          // (14, h, w), order of Param
  const float* prev_vz;         // (h, w) raw previous viewZ
  const float* prev_nr;         // (h, w, 4): the roughness .z (kDec: .w)
  const float* prev_mat;        // (h, w)
  const float* accum;           // (h, w) previous specular accumulation speed
  const __nv_bfloat16* hist;    // (h, w, 4), or (h, w, 1) with kOcc
  const __nv_bfloat16* fast;    // (h, w)
  const float* prev_hdt;        // (h, w) previous hitDistForTracking
  float* out_hist;              // (h, w, 4), or (h, w, 1) with kOcc
  float* out_planes;            // (7, h, w): rough_conf, fbits_vmb, footprint_raw,
                                //   accum_raw, allow_catrom, fast, hdt_prev
  int w, h;
  float view_z_scale, ortho, rect_prev_w, rect_prev_h, min_material, res_scale_x, res_scale_y;
};

template <bool kSh, bool kOcc = false, bool kDec = false>
__device__ __forceinline__ void vmb_resolve_body(const VmbArgs& a, const uint2* sh,
                                                 float* out_sh) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const float* P = a.params + i;
  const Image<float, 1> prev_vz{a.prev_vz, a.w, a.h};
  const Image<float, 4> prev_nr{a.prev_nr, a.w, a.h};
  const Image<float, 1> prev_mat{a.prev_mat, a.w, a.h};

  const float u = a.uv[2 * i], v = a.uv[2 * i + 1];
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  const float ox = floorf(posx), oy = floorf(posy);
  float bw[4];
  nrd::bilinear_weights(posx - ox, posy - oy, bw);
  const int bx = nrd::to_index(ox), by = nrd::to_index(oy);
  const float x0ok = (ox >= 0.0f && ox < a.rect_prev_w) ? 1.0f : 0.0f;
  const float x1ok = (ox + 1.0f >= 0.0f && ox + 1.0f < a.rect_prev_w) ? 1.0f : 0.0f;
  const float y0ok = (oy >= 0.0f && oy < a.rect_prev_h) ? 1.0f : 0.0f;
  const float y1ok = (oy + 1.0f >= 0.0f && oy + 1.0f < a.rect_prev_h) ? 1.0f : 0.0f;
  const float in4[4] = {x0ok * y0ok, x1ok * y0ok, x0ok * y1ok, x1ok * y1ok};

  const float nx = P[NX * plane], ny = P[NY * plane], nz = P[NZ * plane];
  const float vvx = P[VVX * plane], vvy = P[VVY * plane], vvz = P[VVZ * plane];
  const float ra = P[RA * plane], rb = P[RB * plane], rsig = P[RSIGMA * plane];
  const float psm = P[PSM * plane], nox_curr = P[NOX * plane], thr = P[THR * plane];
  const float mat_c = fmaxf(P[MAT * plane], a.min_material);

  float rw[4], occ[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int tx = bx + (k & 1), ty = by + (k >> 1);
    const float r_t = prev_nr.at(tx, ty, nrd::kRoughLane<kDec>);
    const float w_ = nrd::compute_weight_with_sigma(r_t * r_t, ra, rb, rsig);
    rw[k] = psm + (1.0f - psm) * w_;
    const float z_t = fabsf(prev_vz.at(tx, ty, 0)) * a.view_z_scale;
    const float zscale = a.ortho == 0.0f ? z_t : a.ortho;
    const float nox_prev = (nx * vvx + ny * vvy) * zscale + nz * vvz * z_t;
    float o = fabsf(nox_prev - nox_curr) <= thr * in4[k] - 1e-6f ? 1.0f : 0.0f;
    o = o * (rw[k] >= 0.5f ? 1.0f : 0.0f);
    if constexpr (!kDec)  // the RGBA formats carry no material
      o = o * (mat_c == fmaxf(prev_mat.at(tx, ty, 0), a.min_material) ? 1.0f : 0.0f);
    occ[k] = o;
  }
  float ow[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ow[k] = bw[k] * occ[k];
  const float rough_conf = rw[0] * bw[0] + rw[1] * bw[1] + rw[2] * bw[2] + rw[3] * bw[3];
  const float fbits = occ[0] * 16.0f + occ[1] * 32.0f + occ[2] * 64.0f + occ[3] * 128.0f;
  const float footprint = occ[0] * bw[0] + occ[1] * bw[1] + occ[2] * bw[2] + occ[3] * bw[3];
  const bool allow_catrom = (occ[0] + occ[1] + occ[2] + occ[3]) > 3.5f && P[SMB_CATROM * plane] > 0.5f;
  float accum;
  nrd::bilinear_custom(Image<float, 1>{a.accum, a.w, a.h}, bx, by, ow, &accum);

  const float spx = nrd::saturate(u) * a.rect_prev_w, spy = nrd::saturate(v) * a.rect_prev_h;
  constexpr int kC = kOcc ? 1 : 4;
  float hist[kC];
  nrd::sample_catrom(Image<__nv_bfloat16, kC>{a.hist, a.w, a.h}, spx, spy, allow_catrom, ow,
                     hist);
  float fast;
  const int fx0 = nrd::to_index(floorf(spx - 0.5f)), fy0 = nrd::to_index(floorf(spy - 0.5f));
  nrd::bilinear_custom(Image<__nv_bfloat16, 1>{a.fast, a.w, a.h}, fx0, fy0, ow, &fast);
  if constexpr (kSh)
    reinterpret_cast<float4*>(out_sh)[i] = nrd::bilinear_custom4(sh, a.w, a.h, fx0, fy0, ow);
  float hdt_prev;
  nrd::sample_bilinear(Image<float, 1>{a.prev_hdt, a.w, a.h}, u * a.res_scale_x, v * a.res_scale_y,
                       &hdt_prev);

#pragma unroll
  for (int c = 0; c < kC; ++c) a.out_hist[kC * i + c] = hist[c];
  float* o = a.out_planes + i;
  o[0] = rough_conf;
  o[plane] = fbits;
  o[2 * plane] = footprint;
  o[3 * plane] = accum;
  o[4 * plane] = allow_catrom ? 1.0f : 0.0f;
  o[5 * plane] = fast;
  o[6 * plane] = hdt_prev;
}

__global__ void __launch_bounds__(256) vmb_resolve_kernel(VmbArgs a) {
  vmb_resolve_body<false>(a, nullptr, nullptr);
}
__global__ void __launch_bounds__(256) vmb_resolve_sh_kernel(VmbArgs a, const uint2* sh,
                                                             float* out_sh) {
  vmb_resolve_body<true>(a, sh, out_sh);
}
__global__ void __launch_bounds__(256) vmb_resolve_occ_kernel(VmbArgs a) {
  vmb_resolve_body<false, true>(a, nullptr, nullptr);
}
__global__ void __launch_bounds__(256) vmb_resolve_dec_kernel(VmbArgs a) {
  vmb_resolve_body<false, false, true>(a, nullptr, nullptr);
}
__global__ void __launch_bounds__(256) vmb_resolve_sh_dec_kernel(VmbArgs a, const uint2* sh,
                                                                 float* out_sh) {
  vmb_resolve_body<true, false, true>(a, sh, out_sh);
}
__global__ void __launch_bounds__(256) vmb_resolve_occ_dec_kernel(VmbArgs a) {
  vmb_resolve_body<false, true, true>(a, nullptr, nullptr);
}

}  // namespace

// ptrs: uv, params, prev_vz, prev_nr, prev_mat, accum, hist, fast, prev_hdt, out_hist,
//       out_planes, sh (bf16), out_sh (both null without SH)
// consts: view_z_scale, ortho_mode, rect_prev_w, rect_prev_h, min_material,
//         resolution_scale_prev x, y, SH (0 or 1), one-channel history (0 or 1; not with SH),
//         prev_nr the RGBA formats' decoded plane (0 or 1)
extern "C" int nrd_vmb_resolve(void* const* p, const float* c, int w, int h, void* stream) {
  VmbArgs a;
  a.uv = (const float*)p[0];
  a.params = (const float*)p[1];
  a.prev_vz = (const float*)p[2];
  a.prev_nr = (const float*)p[3];
  a.prev_mat = (const float*)p[4];
  a.accum = (const float*)p[5];
  a.hist = (const __nv_bfloat16*)p[6];
  a.fast = (const __nv_bfloat16*)p[7];
  a.prev_hdt = (const float*)p[8];
  a.out_hist = (float*)p[9];
  a.out_planes = (float*)p[10];
  a.w = w;
  a.h = h;
  a.view_z_scale = c[0];
  a.ortho = c[1];
  a.rect_prev_w = c[2];
  a.rect_prev_h = c[3];
  a.min_material = c[4];
  a.res_scale_x = c[5];
  a.res_scale_y = c[6];
  const bool sh = c[7] != 0.0f;
  const uint2* sh_in = (const uint2*)p[11];
  float* sh_out = (float*)p[12];
  const bool occ = c[8] != 0.0f;
  if ((sh && (sh_in == nullptr || sh_out == nullptr)) || (sh && occ))
    return (int)cudaErrorInvalidValue;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const cudaStream_t st = (cudaStream_t)stream;
  if (c[9] != 0.0f) {  // the decoded plane
    if (occ)
      vmb_resolve_occ_dec_kernel<<<grid, block, 0, st>>>(a);
    else if (sh)
      vmb_resolve_sh_dec_kernel<<<grid, block, 0, st>>>(a, sh_in, sh_out);
    else
      vmb_resolve_dec_kernel<<<grid, block, 0, st>>>(a);
  } else if (occ)
    vmb_resolve_occ_kernel<<<grid, block, 0, st>>>(a);
  else if (sh)
    vmb_resolve_sh_kernel<<<grid, block, 0, st>>>(a, sh_in, sh_out);
  else
    vmb_resolve_kernel<<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}
