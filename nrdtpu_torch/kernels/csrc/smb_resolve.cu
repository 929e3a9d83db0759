// H1: surface-motion footprint resolve + history sampling (REBLUR TemporalAccumulation).
// Replaces nrdtpu/kernels/reblur_pallas.py:577 reblur_smb_resolve; computes the gathers of
// nrdtpu/passes/reblur/kernels.py:142-249 and :451-456 per pixel. With two signals
// (REBLUR_DIFFUSE_SPECULAR) one launch resolves the footprint once and samples both signals'
// histories, fast histories and accumulation planes with the same weights. With the SH
// variants (kSh) each signal's bf16 SH history is sampled as its fast history is: the
// occlusion-weighted custom bilinear at the footprint's 2x2, never the CatRom (JAX's
// sample_history_bilinear, nrdtpu/passes/reblur/kernels.py:473-476, :1489-1491; the TPU
// kernel's bil_planes, nrdtpu/kernels/reblur_pallas.py:580, :605). The plain version is
// nrdtpu_torch/kernels/smb_resolve.py:smb_resolve_ref.
//
// Design for the H100: one thread per pixel in 16x16 CTAs, one instance per signal count
// <kNSig, kSh>, at most kMinCtas' register budget. Bound by its gathers:
//   - the current 2x2 normal average reads each current texel 4 times: each CTA first stages
//     its 17x17 window (the tile, the row above and the column to its left) in shared memory,
//     each texel's packed normal read as one float4 and decoded once;
//   - the 12 non-corner taps of the previous viewZ and material (the corners weigh in
//     nothing), their indices clamped once a row and a column, in one pass that keeps only the
//     occlusion sum and the centre 2x2; the previous normals of the centre 2x2 as one float4
//     each;
//   - the histories (bf16) of every signal through one CatRom footprint
//     (common.cuh:catrom_apply4), in one loop over its 5 bilinear samples: each sample's
//     position, origin and weights computed once, and a texel read as one 8-byte load only
//     where its bilinear weight is non-zero. The 5 samples keep their order (summing the 12
//     texels directly moves values outside the tolerance where the history's second moment
//     cancels, PERF.md);
//   - each history written as one float4;
//   - kSh: each SH history's 2x2 as four 8-byte loads (common.cuh:bilinear_custom4, K16's),
//     widened to float, written as one float4. The non-SH instances compile as before.
//   - kOcc, the occlusion variants (one-channel signals): each signal's (h, w, 1) bf16 history
//     through the same CatRom footprint, a texel one 2-byte load (common.cuh:texel4 of an
//     unsigned short) widened to float, written as one float (the TPU kernel's n_hist planes
//     at c = 1, nrdtpu/passes/reblur/denoiser.py:311-320). The four-channel instances compile
//     as before.
//   - kDec, the RGBA normal encodings: the current and previous planes are the ones that the
//     frame decodes once (frontend.py:decode_normal_plane), their normal .xyz read as it is,
//     and the footprint tests no material (the TPU kernel's mat_occ=False,
//     reblur_pallas.py:603). The R10G10B10A2 instances compile as before.
#include "common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr int kMinCtas = 4;            // chosen by A/B timing on the H100 (PERF.md)
constexpr int kWin = nrd::kBlock + 1;  // the staged window: the tile and a halo of 1 up-left

struct SmbArgs {
  const float* smb_uv;      // (h, w, 2)
  const float* xv_prev_z;   // (h, w)
  const float* base_thr;    // (h, w)
  const float* navg_thr;    // (h, w)
  const float* nr;          // (h, w, 4) current packed normal/roughness/material
  const float* prev_vz;     // (h, w) raw previous viewZ
  const float* prev_nr;     // (h, w, 4)
  const float* prev_mat;    // (h, w)
  const float* accum[2];    // (h, w) accumulation speed of each signal being denoised
  const __nv_bfloat16* hist[2];  // (h, w, 4), or (h, w, 1) with kOcc
  const __nv_bfloat16* fast[2];  // (h, w)
  float* out_hist;          // (nsig, h, w, 4), or (nsig, h, w, 1) with kOcc
  float* out_planes;        // (3 + 2 nsig, h, w): fbits, allow_catrom, footprint_raw,
                            // accum, fast [, accum and fast of the second signal]
  float* out_navg;          // (2, h, w, 3): current n_avg, previous smb_navg (rotated)
  const uint2* sh[2];       // (h, w, 4) bf16 SH history of each signal (kSh)
  float* out_sh;            // (nsig, h, w, 4) (kSh)
  int w, h;
  int ph;                   // the previous planes' and histories' height (the whole frame's
                            // when the current planes are a band of its rows; same width)
  float view_z_scale, denoising_range, rect_prev_w, rect_prev_h, min_material;
  float m[9];               // world_prev_to_world rotation, row-major
};

template <int kNSig, bool kSh, bool kOcc = false, bool kDec = false>
__global__ void __launch_bounds__(256, kMinCtas) smb_resolve_kernel(SmbArgs a) {
  static_assert(!(kSh && kOcc), "the occlusion variants have no SH");
  // every thread of the CTA stages, then the ones outside the image leave
  __shared__ float4 win[kWin * kWin];  // (unpacked normal, packed material)
  const int ox0 = blockIdx.x * nrd::kBlock - 1, oy0 = blockIdx.y * nrd::kBlock - 1;
  const Image<float, 4> nr{a.nr, a.w, a.h};
  for (int k = threadIdx.y * nrd::kBlock + threadIdx.x; k < kWin * kWin;
       k += nrd::kBlock * nrd::kBlock) {
    const float4 p = nr.at4(ox0 + k % kWin, oy0 + k / kWin);
    if constexpr (kDec) {
      win[k] = make_float4(p.x, p.y, p.z, 0.0f);
    } else {
      const V3 n = nrd::unpack_normal(p.x, p.y);
      win[k] = make_float4(n.x, n.y, n.z, p.w);
    }
  }
  __syncthreads();
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;

  // current Navg over the 2x2 at offsets {-1, 0}, (dy, dx) row by row
  V3 n_avg{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 n = win[(threadIdx.y + k / 2) * kWin + threadIdx.x + k % 2];
    n_avg = V3{n_avg.x + n.x, n_avg.y + n.y, n_avg.z + n.z};
  }
  n_avg = V3{n_avg.x / 4.0f, n_avg.y / 4.0f, n_avg.z / 4.0f};
  const float mat_c =
      fmaxf(win[(threadIdx.y + 1) * kWin + threadIdx.x + 1].w * 3.0f, a.min_material);

  const float u = __ldg(a.smb_uv + 2 * i), v = __ldg(a.smb_uv + 2 * i + 1);
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  const float ox = floorf(posx), oy = floorf(posy);
  const float fx = posx - ox, fy = posy - oy;
  const int bx = nrd::to_index(ox), by = nrd::to_index(oy);
  int col[4];
  size_t row[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col[k] = nrd::clampi(bx - 1 + k, 0, a.w - 1);
    row[k] = (size_t)nrd::clampi(by - 1 + k, 0, a.ph - 1) * a.w;
  }

  // previous normal average over the centre 2x2 (t = 0..3: (1, 1), (2, 1), (1, 2), (2, 2)),
  // weighted by in-range viewZ
  float zc[4];
  V3 sn{0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const size_t tap = row[1 + t / 2] + col[1 + t % 2];
    zc[t] = fabsf(__ldg(a.prev_vz + tap)) * a.view_z_scale;
    const float w_ = zc[t] < a.denoising_range ? 1.0f : 0.0f;
    const float4 p = __ldg(reinterpret_cast<const float4*>(a.prev_nr) + tap);
    const V3 n = kDec ? V3{p.x, p.y, p.z} : nrd::unpack_normal(p.x, p.y);
    sn = V3{sn.x + n.x * w_, sn.y + n.y * w_, sn.z + n.z * w_};
    wsum = wsum + w_;
  }
  const float d = wsum == 0.0f ? 1.0f : wsum;
  sn = V3{sn.x / d, sn.y / d, sn.z / d};
  sn = V3{a.m[0] * sn.x + a.m[1] * sn.y + a.m[2] * sn.z,
          a.m[3] * sn.x + a.m[4] * sn.y + a.m[5] * sn.z,
          a.m[6] * sn.x + a.m[7] * sn.y + a.m[8] * sn.z};
  const float navg_ok = nrd::dot3(sn, n_avg) > __ldg(a.navg_thr + i) ? 1.0f : 0.0f;

  // IsInScreenBilinear per quad and the per-quad thresholds
  const float x0ok = (ox >= 0.0f && ox < a.rect_prev_w) ? 1.0f : 0.0f;
  const float x1ok = (ox + 1.0f >= 0.0f && ox + 1.0f < a.rect_prev_w) ? 1.0f : 0.0f;
  const float y0ok = (oy >= 0.0f && oy < a.rect_prev_h) ? 1.0f : 0.0f;
  const float y1ok = (oy + 1.0f >= 0.0f && oy + 1.0f < a.rect_prev_h) ? 1.0f : 0.0f;
  const float in4[4] = {x0ok * y0ok, x1ok * y0ok, x0ok * y1ok, x1ok * y1ok};
  const float bt = __ldg(a.base_thr + i);
  float qthr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) qthr[q] = bt * navg_ok * in4[q] - 1e-6f;

  // plane-distance and material occlusion of the 12 non-corner taps of the 4x4, row by row:
  // their sum and the centre 2x2
  const float xvz = __ldg(a.xv_prev_z + i);
  float oc[4];
  float occ12 = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((j == 0 || j == 3) && (k == 0 || k == 3)) continue;
      const bool centre = j >= 1 && j <= 2 && k >= 1 && k <= 2;
      const int c = (j - 1) * 2 + (k - 1);  // the centre tap's index t
      const int q = (k >= 2 ? 1 : 0) + (j >= 2 ? 2 : 0);
      const size_t tap = row[j] + col[k];
      const float z = centre ? zc[c] : fabsf(__ldg(a.prev_vz + tap)) * a.view_z_scale;
      const float o = fabsf(z - xvz) <= qthr[q] ? 1.0f : 0.0f;
      float occ = o;
      if constexpr (!kDec) {  // the RGBA formats carry no material
        const float mt = fmaxf(__ldg(a.prev_mat + tap), a.min_material);
        occ = o * (mat_c == mt ? 1.0f : 0.0f);
      }
      occ12 = occ12 + occ;
      if (centre) oc[c] = occ;
    }

  float bw[4], ow[4];
  nrd::bilinear_weights(fx, fy, bw);
#pragma unroll
  for (int t = 0; t < 4; ++t) ow[t] = bw[t] * oc[t];
  const bool allow_catrom = occ12 > 11.5f;
  const float fbits = oc[0] * 1.0f + oc[1] * 2.0f + oc[2] * 4.0f + oc[3] * 8.0f;
  const float footprint = oc[0] * bw[0] + oc[1] * bw[1] + oc[2] * bw[2] + oc[3] * bw[3];
  a.out_planes[i] = fbits;
  a.out_planes[plane + i] = allow_catrom ? 1.0f : 0.0f;
  a.out_planes[2 * plane + i] = footprint;

  // every signal's history through one CatRom footprint at the saturated reprojected
  // position; the accumulation speed and the fast history bilinear with the custom weights
  const float spx = nrd::saturate(u) * a.rect_prev_w, spy = nrd::saturate(v) * a.rect_prev_h;
  const nrd::CatromTaps taps = nrd::catrom_taps(spx, spy, allow_catrom, ow);
  float4 hist[kNSig];
  float hist1[kNSig];  // kOcc: the one-channel histories
  if constexpr (kOcc) {
    const unsigned short* img[kNSig];
#pragma unroll
    for (int s = 0; s < kNSig; ++s) img[s] = reinterpret_cast<const unsigned short*>(a.hist[s]);
    nrd::catrom_apply4<kNSig>(img, a.w, a.ph, taps, hist1);
  } else {
    const uint2* img[kNSig];
#pragma unroll
    for (int s = 0; s < kNSig; ++s) img[s] = reinterpret_cast<const uint2*>(a.hist[s]);
    nrd::catrom_apply4<kNSig>(img, a.w, a.ph, taps, hist);
  }
  const int fx0 = nrd::to_index(floorf(spx - 0.5f)), fy0 = nrd::to_index(floorf(spy - 0.5f));
  float4* out_hist = reinterpret_cast<float4*>(a.out_hist);
#pragma unroll
  for (int s = 0; s < kNSig; ++s) {
    float das, fast;
    nrd::bilinear_custom(Image<float, 1>{a.accum[s], a.w, a.ph}, bx, by, ow, &das);
    nrd::bilinear_custom(Image<__nv_bfloat16, 1>{a.fast[s], a.w, a.ph}, fx0, fy0, ow, &fast);
    if constexpr (kOcc)
      a.out_hist[s * plane + i] = hist1[s];
    else
      out_hist[s * plane + i] = hist[s];
    a.out_planes[(3 + 2 * s) * plane + i] = das;
    a.out_planes[(4 + 2 * s) * plane + i] = fast;
    if constexpr (kSh)
      reinterpret_cast<float4*>(a.out_sh)[s * plane + i] =
          nrd::bilinear_custom4(a.sh[s], a.w, a.ph, fx0, fy0, ow);
  }
  float* nv = a.out_navg + 3 * i;
  nv[0] = n_avg.x;
  nv[1] = n_avg.y;
  nv[2] = n_avg.z;
  nv += 3 * plane;
  nv[0] = sn.x;
  nv[1] = sn.y;
  nv[2] = sn.z;
}

// the instance of the call's mode; kDec: the RGBA formats' decoded planes
template <bool kDec>
cudaError_t launch(const SmbArgs& a, int nsig, bool sh, bool occ, dim3 grid, dim3 block,
                   cudaStream_t st) {
  if (occ) {
    if (nsig == 1)
      smb_resolve_kernel<1, false, true, kDec><<<grid, block, 0, st>>>(a);
    else
      smb_resolve_kernel<2, false, true, kDec><<<grid, block, 0, st>>>(a);
    return cudaGetLastError();
  }
  switch (nsig * 2 + (sh ? 1 : 0)) {
    case 2: smb_resolve_kernel<1, false, false, kDec><<<grid, block, 0, st>>>(a); break;
    case 4: smb_resolve_kernel<2, false, false, kDec><<<grid, block, 0, st>>>(a); break;
    case 3: smb_resolve_kernel<1, true, false, kDec><<<grid, block, 0, st>>>(a); break;
    default: smb_resolve_kernel<2, true, false, kDec><<<grid, block, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* nrd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ptrs: smb_uv, xv_prev_z, base_thr, navg_thr, nr, prev_vz, prev_nr, prev_mat, accum,
//       hist, fast, out_hist, out_planes, out_navg, accum, hist, fast of a second signal (null
//       with one), out_sh, the SH history of each signal (bf16; null without SH)
// consts: view_z_scale, denoising_range, rect_prev_w, rect_prev_h, min_material, m[9],
//         signal count (1 or 2), SH (0 or 1), one-channel histories (0 or 1; not with SH), nr
//         and prev_nr the RGBA formats' decoded planes (0 or 1), the previous planes' height
extern "C" int nrd_smb_resolve(void* const* p, const float* c, int w, int h, void* stream) {
  SmbArgs a;
  a.smb_uv = (const float*)p[0];
  a.xv_prev_z = (const float*)p[1];
  a.base_thr = (const float*)p[2];
  a.navg_thr = (const float*)p[3];
  a.nr = (const float*)p[4];
  a.prev_vz = (const float*)p[5];
  a.prev_nr = (const float*)p[6];
  a.prev_mat = (const float*)p[7];
  a.out_hist = (float*)p[11];
  a.out_planes = (float*)p[12];
  a.out_navg = (float*)p[13];
  a.w = w;
  a.h = h;
  a.ph = (int)c[18];
  const int nsig = (int)c[14];
  if (nsig != 1 && nsig != 2) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < 2; ++s) {  // the second signal's pointers follow the outputs
    const int k = s == 0 ? 8 : 14;
    a.accum[s] = (const float*)p[s < nsig ? k : 8];
    a.hist[s] = (const __nv_bfloat16*)p[s < nsig ? k + 1 : 9];
    a.fast[s] = (const __nv_bfloat16*)p[s < nsig ? k + 2 : 10];
  }
  a.view_z_scale = c[0];
  a.denoising_range = c[1];
  a.rect_prev_w = c[2];
  a.rect_prev_h = c[3];
  a.min_material = c[4];
  for (int k = 0; k < 9; ++k) a.m[k] = c[5 + k];
  const bool sh = c[15] != 0.0f;
  a.out_sh = (float*)p[17];
  for (int s = 0; s < 2; ++s) a.sh[s] = (const uint2*)p[18 + (s < nsig ? s : 0)];
  const bool occ = c[16] != 0.0f;
  if ((sh && (a.out_sh == nullptr || a.sh[0] == nullptr || a.sh[nsig - 1] == nullptr)) ||
      (sh && occ))
    return (int)cudaErrorInvalidValue;
  const dim3 block(nrd::kBlock, nrd::kBlock);
  const dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(c[17] != 0.0f ? launch<true>(a, nsig, sh, occ, grid, block, st)
                             : launch<false>(a, nsig, sh, occ, grid, block, st));
}
