// K16: RELAX surface-motion loader (TemporalAccumulation's loadSurfaceMotionBasedPrevData):
// the current 3x3 normal average, the 4x4 previous viewZ / material occlusion with the
// per-quad in-screen thresholds, the backface test against the previous normal at the
// footprint centre, the custom-bilinear history length (+ 1, at most 255), the footprint
// quality and smb_found, and the CatRom-12 / bilinear-custom samples of 1 to 4 (h, w, 4)
// histories. With the specular signal also the un-normalised 3x3 normal average, the 3x3 min
// of the current specular hitT (0 counts as NRD_INF) and the previous reflection hitT,
// bilinear with the custom weights. With the SH variants also the bf16 SH histories (the slow
// and the responsive one of each signal), bilinear with the custom weights at the footprint's
// 2x2 only, never through the CatRom: JAX's bil_planes (relax_pallas.py:1003, :1028-1035;
// resample.bilinear_custom at kernels.py:607-610, :988-991). Replaces
// nrdtpu/kernels/relax_pallas.py:1000
// relax_smb_resolve; computes nrdtpu/passes/relax/kernels.py:376-394, :426, :485-549,
// :580-583 and :805-814 per pixel. The plain
// version is nrdtpu_torch/kernels/relax_smb_resolve.py:relax_smb_resolve_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, one instance per mode
// <kSpec, kNHist, kNSh, kDec> (the specular planes, the number of histories, the number of SH
// histories: 0, or as many as histories; the RGBA formats' decoded normal plane of
// common.cuh:unpack_nr, whose instances test no material, as the TPU kernel's
// mat_occ=False), so that each holds only its own state, at most
// kMinCtas' register budget (2 CTAs an SM for 3 or 4 histories: RELAX_DIFFUSE_SPECULAR's
// <true, 4, .>, both signals' slow and responsive histories). Bound by its gathers:
//   - the 3x3 neighbourhood reads each current texel 9 times: each CTA first stages its
//     18x18 window (halo 1) in shared memory, each texel's octahedral normal decoded once
//     and, with the specular signal, its hitT as the min counts it (0 -> NRD_INF);
//   - the 12 non-corner taps of the previous viewZ and material (the corners weigh in
//     nothing), their indices clamped once a row and a column;
//   - the previous normal's bilinear as four float4 reads;
//   - the histories through one CatRom footprint (common.cuh:catrom_apply4), all of them in
//     one loop over its 5 bilinear samples: each sample's position, origin and weights
//     computed once, and each of its 4 texels read as one float4, a weight of 0 included
//     (`kKeepNaN`: a NaN history texel that the plain version multiplies by 0 makes its
//     sample NaN here too; most of the 20 reads hit the same 12 texels in L1). The 5
//     samples keep their order: summing the 12 texels directly, with the CatRom weights'
//     products, moved values outside the tolerance where the history's second moment
//     cancels (PERF.md);
//   - every min, max and clamp of the per-pixel part returns NaN where an operand is NaN
//     (common.cuh:min_nan; max_bound and min_bound against a constant), as the plain
//     version's torch.minimum, clamp_min and clamp_max do;
//   - each history written as one float4;
//   - each SH history's 2x2 as four 8-byte loads (uint2), widened to float, written as one
//     float4.
#include "relax_common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr int kMaxHistories = 4;
constexpr int kMinCtas = 4;  // chosen by A/B timing on the H100 (PERF.md)
constexpr int kWin = nrd::kBlock + 2;  // the staged window: the tile and a halo of 1

struct RelaxSmbArgs {
  const float* smb_uv;     // (h, w, 2)
  const float* xv_prev_z;  // (h, w)
  const float* base_thr;   // (h, w)
  const float* nr;         // (h, w, 4) current packed normal/roughness/material
  const float* prev_vz;    // (h, w) raw previous viewZ
  const float* prev_mat;   // (h, w)
  const float* prev_hl;    // (h, w) previous history length
  const float* prev_nr;    // (h, w, 4) RGBA8-quantized 0.5 n + 0.5, roughness
  float* planes;           // (3, h, w): history length, footprint quality, smb_found, and
                           // with spec (+5): n_avg x, y, z, min hitT, reflection hitT
  float* hist_out;         // (nhist, h, w, 4)
  const float* hist[kMaxHistories];  // (h, w, 4) each
  const float* spec_hit;   // (h, w) current specular hitT (PrePass output), spec only
  const float* prev_ht;    // (h, w) previous reflection hitT, spec only
  const uint2* sh[kMaxHistories];  // (h, w, 4) bf16 each: the SH histories
  float* sh_out;           // (nsh, h, w, 4)
  int w, h, nhist, nsh;
  float view_z_scale, rect_prev_w, rect_prev_h, res_w, res_h, min_material;
  float m[9];              // world_prev_to_world rotation, row-major
};

template <bool kSpec, int kNHist, int kNSh, bool kDec = false>
__global__ void __launch_bounds__(256, kNHist <= 2 ? kMinCtas : 2)
    relax_smb_resolve_kernel(RelaxSmbArgs a) {
  // every thread of the CTA stages, then the ones outside the image leave
  __shared__ float4 win[kWin * kWin];  // (unpacked normal, hitT or NRD_INF)
  const int ox0 = blockIdx.x * nrd::kBlock - 1, oy0 = blockIdx.y * nrd::kBlock - 1;
  const Image<float, 4> nr{a.nr, a.w, a.h};
  for (int k = threadIdx.y * nrd::kBlock + threadIdx.x; k < kWin * kWin;
       k += nrd::kBlock * nrd::kBlock) {
    const size_t t = nr.index(ox0 + k % kWin, oy0 + k / kWin);
    const float4 p = __ldg(reinterpret_cast<const float4*>(a.nr) + t);
    const V3 n = nrd::unpack_nr<kDec>(p).n;
    float ht = 0.0f;
    if constexpr (kSpec) {
      ht = __ldg(a.spec_hit + t);
      ht = ht == 0.0f ? 1e6f : ht;
    }
    win[k] = make_float4(n.x, n.y, n.z, ht);
  }
  __syncthreads();
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;

  // current 3x3 normal average, row by row, made unit length
  // and with spec the 3x3 min of the current hitT, 0 counting as NRD_INF
  float min_hit = 0.0f;
  if constexpr (kSpec) min_hit = win[(threadIdx.y + 1) * kWin + threadIdx.x + 1].w;
  V3 na{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float4 t = win[(threadIdx.y + dy) * kWin + threadIdx.x + dx];
      na = V3{na.x + t.x, na.y + t.y, na.z + t.z};
      if constexpr (kSpec) min_hit = nrd::min_nan(min_hit, t.w);
    }
  na = V3{na.x / 9.0f, na.y / 9.0f, na.z / 9.0f};
  if constexpr (kSpec) {
    a.planes[3 * plane + i] = na.x;
    a.planes[4 * plane + i] = na.y;
    a.planes[5 * plane + i] = na.z;
    a.planes[6 * plane + i] = min_hit;
  }
  const float inv = rsqrtf(nrd::max_bound(na.x * na.x + na.y * na.y + na.z * na.z, 1e-15f));
  na = V3{na.x * inv, na.y * inv, na.z * inv};

  const float u = __ldg(a.smb_uv + 2 * i), v = __ldg(a.smb_uv + 2 * i + 1);
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  const float ox = floorf(posx), oy = floorf(posy);
  const float fx = posx - ox, fy = posy - oy;
  const int bx = nrd::to_index(ox), by = nrd::to_index(oy);

  // IsInScreenBilinear per quad and the per-quad thresholds
  const float x0ok = (ox >= 0.0f && ox < a.rect_prev_w) ? 1.0f : 0.0f;
  const float x1ok = (ox + 1.0f >= 0.0f && ox + 1.0f < a.rect_prev_w) ? 1.0f : 0.0f;
  const float y0ok = (oy >= 0.0f && oy < a.rect_prev_h) ? 1.0f : 0.0f;
  const float y1ok = (oy + 1.0f >= 0.0f && oy + 1.0f < a.rect_prev_h) ? 1.0f : 0.0f;
  const float in4[4] = {x0ok * y0ok, x1ok * y0ok, x0ok * y1ok, x1ok * y1ok};
  const float bt = __ldg(a.base_thr + i);
  float qthr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) qthr[q] = bt * in4[q] - 1e-6f;

  // plane-distance and material occlusion of the 12 non-corner taps of the 4x4
  const float xvz = __ldg(a.xv_prev_z + i);
  float mat_c = 0.0f;  // kDec: no material test
  if constexpr (!kDec) mat_c = nrd::max_bound(__ldg(a.nr + 4 * i + 3) * 3.0f, a.min_material);
  int col[4];
  size_t row[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col[k] = nrd::clampi(bx - 1 + k, 0, a.w - 1);
    row[k] = (size_t)nrd::clampi(by - 1 + k, 0, a.h - 1) * a.w;
  }
  float occ[4][4];
  float occ12 = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((j == 0 || j == 3) && (k == 0 || k == 3)) continue;
      const int q = (k >= 2 ? 1 : 0) + (j >= 2 ? 2 : 0);
      const size_t t = row[j] + col[k];
      const float z = fabsf(__ldg(a.prev_vz + t)) * a.view_z_scale;
      const float o = fabsf(z - xvz) <= qthr[q] ? 1.0f : 0.0f;
      if constexpr (kDec) {
        occ[j][k] = o;
      } else {
        const float mt = nrd::max_bound(__ldg(a.prev_mat + t), a.min_material);
        occ[j][k] = o * (mat_c == mt ? 1.0f : 0.0f);
      }
      occ12 = occ12 + occ[j][k];
    }
  bool bicubic = occ12 > 11.5f;
  float bv[4] = {occ[1][1], occ[1][2], occ[2][1], occ[2][2]};

  // backface test: the previous normal, bilinear at the footprint centre, in this frame
  const float4 pn4 = nrd::sample_bilinear4(Image<float, 4>{a.prev_nr, a.w, a.h},
                                           (ox + 1.0f) / a.res_w, (oy + 1.0f) / a.res_h);
  const float px = pn4.x * 2.0f - 1.0f, py = pn4.y * 2.0f - 1.0f, pz = pn4.z * 2.0f - 1.0f;
  const float pinv = rsqrtf(px * px + py * py + pz * pz + 1e-9f);
  const V3 p0{px * pinv, py * pinv, pz * pinv};
  const V3 pn{a.m[0] * p0.x + a.m[1] * p0.y + a.m[2] * p0.z,
              a.m[3] * p0.x + a.m[4] * p0.y + a.m[5] * p0.z,
              a.m[6] * p0.x + a.m[7] * p0.y + a.m[8] * p0.z};
  if (nrd::dot3(na, pn) < 0.0f) {
    bicubic = false;
#pragma unroll
    for (int t = 0; t < 4; ++t) bv[t] = 0.0f;
  }

  float bw[4], cw[4];
  nrd::bilinear_weights(fx, fy, bw);
  bool any_valid = false;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    cw[t] = bw[t] * bv[t];
    any_valid = any_valid || bv[t] > 0.0f;
  }
  const float quality = bicubic ? 1.0f : cw[0] + cw[1] + cw[2] + cw[3];
  float hl;
  nrd::bilinear_custom(Image<float, 1>{a.prev_hl, a.w, a.h}, bx, by, cw, &hl);
  a.planes[i] = nrd::min_bound(hl + 1.0f, 255.0f);
  a.planes[plane + i] = any_valid ? quality : 0.0f;
  a.planes[2 * plane + i] = any_valid ? (bicubic ? 2.0f : 1.0f) : 0.0f;
  if constexpr (kSpec) {
    float ht;
    nrd::bilinear_custom(Image<float, 1>{a.prev_ht, a.w, a.h}, bx, by, cw, &ht);
    a.planes[7 * plane + i] = ht;
  }

  // the histories at uv_smb x rect_prev through one footprint
  const nrd::CatromTaps taps =
      nrd::catrom_taps(u * a.rect_prev_w, v * a.rect_prev_h, bicubic, cw);
  const float4* img[kNHist];
#pragma unroll
  for (int s = 0; s < kNHist; ++s) img[s] = reinterpret_cast<const float4*>(a.hist[s]);
  float4 out[kNHist];
  nrd::catrom_apply4<kNHist, true>(img, a.w, a.h, taps, out);
  float4* hist_out = reinterpret_cast<float4*>(a.hist_out);
#pragma unroll
  for (int s = 0; s < kNHist; ++s) hist_out[s * plane + i] = out[s];

  // the SH histories: the custom-weight bilinear at the footprint's 2x2
  float4* sh_out = reinterpret_cast<float4*>(a.sh_out);
#pragma unroll
  for (int s = 0; s < kNSh; ++s)
    sh_out[s * plane + i] = nrd::bilinear_custom4(a.sh[s], a.w, a.h, bx, by, cw);
}

// the decoded plane's instances (kDec): those that RELAX's variants reach at the RGBA
// formats, two histories a signal (four with both signals, which are specular) and as many SH
// histories or none
template <bool kSpec>
cudaError_t launch_dec(const RelaxSmbArgs& a, dim3 grid, dim3 block, cudaStream_t stream) {
  switch (a.nhist * 8 + a.nsh) {
    case 16: relax_smb_resolve_kernel<kSpec, 2, 0, true><<<grid, block, 0, stream>>>(a); break;
    case 18: relax_smb_resolve_kernel<kSpec, 2, 2, true><<<grid, block, 0, stream>>>(a); break;
    case 32:
      if constexpr (!kSpec) return cudaErrorInvalidValue;
      relax_smb_resolve_kernel<true, 4, 0, true><<<grid, block, 0, stream>>>(a);
      break;
    case 36:
      if constexpr (!kSpec) return cudaErrorInvalidValue;
      relax_smb_resolve_kernel<true, 4, 4, true><<<grid, block, 0, stream>>>(a);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kSpec>
cudaError_t launch(const RelaxSmbArgs& a, bool dec, dim3 grid, dim3 block,
                   cudaStream_t stream) {
  // the SH histories ride the 2- and 4-history instances, as many as histories
  if (a.nsh != 0 && a.nsh != a.nhist) return cudaErrorInvalidValue;
  if (dec) return launch_dec<kSpec>(a, grid, block, stream);
  switch (a.nhist * 8 + a.nsh) {
    case 8: relax_smb_resolve_kernel<kSpec, 1, 0><<<grid, block, 0, stream>>>(a); break;
    case 16: relax_smb_resolve_kernel<kSpec, 2, 0><<<grid, block, 0, stream>>>(a); break;
    case 24: relax_smb_resolve_kernel<kSpec, 3, 0><<<grid, block, 0, stream>>>(a); break;
    case 32: relax_smb_resolve_kernel<kSpec, 4, 0><<<grid, block, 0, stream>>>(a); break;
    case 18: relax_smb_resolve_kernel<kSpec, 2, 2><<<grid, block, 0, stream>>>(a); break;
    case 36: relax_smb_resolve_kernel<kSpec, 4, 4><<<grid, block, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// ptrs: smb_uv, xv_prev_z, base_thr, nr, prev_vz, prev_mat, prev_hl, prev_nr, planes,
//       hist_out, 4 history slots (the first nhist used), spec_hit, prev_ht (null without
//       spec), sh_out, 4 SH history slots (the first nsh used; bf16, null without SH)
// consts: view_z_scale, rect_prev_w, rect_prev_h, res_w, res_h, min_material, m[9], nhist,
//         spec (0 or 1), nsh (0, or nhist: 2 or 4), the plane decoded (kDec: 0 or 1)
extern "C" int nrd_relax_smb_resolve(void* const* p, const float* c, int w, int h,
                                     void* stream) {
  RelaxSmbArgs a;
  a.smb_uv = (const float*)p[0];
  a.xv_prev_z = (const float*)p[1];
  a.base_thr = (const float*)p[2];
  a.nr = (const float*)p[3];
  a.prev_vz = (const float*)p[4];
  a.prev_mat = (const float*)p[5];
  a.prev_hl = (const float*)p[6];
  a.prev_nr = (const float*)p[7];
  a.planes = (float*)p[8];
  a.hist_out = (float*)p[9];
  a.w = w;
  a.h = h;
  a.nhist = (int)c[15];
  if (a.nhist < 1 || a.nhist > kMaxHistories) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < kMaxHistories; ++s) a.hist[s] = (const float*)p[10 + (s < a.nhist ? s : 0)];
  const bool spec = c[16] != 0.0f;
  a.spec_hit = (const float*)p[14];
  a.prev_ht = (const float*)p[15];
  a.nsh = (int)c[17];
  a.sh_out = (float*)p[16];
  if (a.nsh < 0 || a.nsh > kMaxHistories || (a.nsh > 0 && a.sh_out == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < kMaxHistories; ++s) a.sh[s] = (const uint2*)p[17 + (s < a.nsh ? s : 0)];
  if (spec && (a.spec_hit == nullptr || a.prev_ht == nullptr)) return (int)cudaErrorInvalidValue;
  a.view_z_scale = c[0];
  a.rect_prev_w = c[1];
  a.rect_prev_h = c[2];
  a.res_w = c[3];
  a.res_h = c[4];
  a.min_material = c[5];
  for (int k = 0; k < 9; ++k) a.m[k] = c[6 + k];
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const bool dec = c[18] != 0.0f;
  const cudaError_t err = spec ? launch<true>(a, dec, grid, block, (cudaStream_t)stream)
                               : launch<false>(a, dec, grid, block, (cudaStream_t)stream);
  return (int)err;
}
