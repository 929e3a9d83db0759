// H1: surface-motion footprint resolve + history sampling (REBLUR TemporalAccumulation).
// Replaces nrdtpu/kernels/reblur_pallas.py:577 reblur_smb_resolve; computes the gathers of
// nrdtpu/passes/reblur/kernels.py:142-249 and :451-456 per pixel. With two signals
// (REBLUR_DIFFUSE_SPECULAR) one launch resolves the footprint once and samples both signals'
// histories, fast histories and accumulation planes with the same weights. The plain version
// is nrdtpu_torch/kernels/smb_resolve.py:smb_resolve_ref. One thread per pixel.
#include "common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

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
  const __nv_bfloat16* hist[2];  // (h, w, 4)
  const __nv_bfloat16* fast[2];  // (h, w)
  float* out_hist;          // (nsig, h, w, 4)
  float* out_planes;        // (3 + 2 nsig, h, w): fbits, allow_catrom, footprint_raw,
                            // accum, fast [, accum and fast of the second signal]
  float* out_navg;          // (2, h, w, 3): current n_avg, previous smb_navg (rotated)
  int w, h, nsig;
  float view_z_scale, denoising_range, rect_prev_w, rect_prev_h, min_material;
  float m[9];               // world_prev_to_world rotation, row-major
};

// (x, y) of the bilinear 2x2 inside the 4x4 footprint
__constant__ int kCenterX[4] = {1, 2, 1, 2};
__constant__ int kCenterY[4] = {1, 1, 2, 2};

__global__ void __launch_bounds__(256) smb_resolve_kernel(SmbArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const Image<float, 4> nr{a.nr, a.w, a.h};
  const Image<float, 4> prev_nr{a.prev_nr, a.w, a.h};
  const Image<float, 1> prev_vz{a.prev_vz, a.w, a.h};
  const Image<float, 1> prev_mat{a.prev_mat, a.w, a.h};

  // current Navg over the 2x2 at offsets {-1, 0}, (dy, dx) row by row
  V3 n_avg{0.0f, 0.0f, 0.0f};
  const int ody[4] = {-1, -1, 0, 0}, odx[4] = {-1, 0, -1, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    V3 n = nrd::unpack_normal(nr.at(x + odx[k], y + ody[k], 0), nr.at(x + odx[k], y + ody[k], 1));
    n_avg = V3{n_avg.x + n.x, n_avg.y + n.y, n_avg.z + n.z};
  }
  n_avg = V3{n_avg.x / 4.0f, n_avg.y / 4.0f, n_avg.z / 4.0f};

  const float u = a.smb_uv[2 * i], v = a.smb_uv[2 * i + 1];
  const float posx = u * a.rect_prev_w - 0.5f, posy = v * a.rect_prev_h - 0.5f;
  const float ox = floorf(posx), oy = floorf(posy);
  const float fx = posx - ox, fy = posy - oy;
  const int bx = nrd::to_index(ox), by = nrd::to_index(oy);

  float z[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) z[j][k] = fabsf(prev_vz.at(bx - 1 + k, by - 1 + j, 0)) * a.view_z_scale;

  // previous normal average over the centre 2x2, weighted by in-range viewZ
  V3 sn{0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int tx = kCenterX[t], ty = kCenterY[t];
    const float w_ = z[ty][tx] < a.denoising_range ? 1.0f : 0.0f;
    V3 n = nrd::unpack_normal(prev_nr.at(bx + tx - 1, by + ty - 1, 0),
                              prev_nr.at(bx + tx - 1, by + ty - 1, 1));
    sn = V3{sn.x + n.x * w_, sn.y + n.y * w_, sn.z + n.z * w_};
    wsum = wsum + w_;
  }
  const float d = wsum == 0.0f ? 1.0f : wsum;
  sn = V3{sn.x / d, sn.y / d, sn.z / d};
  sn = V3{a.m[0] * sn.x + a.m[1] * sn.y + a.m[2] * sn.z,
          a.m[3] * sn.x + a.m[4] * sn.y + a.m[5] * sn.z,
          a.m[6] * sn.x + a.m[7] * sn.y + a.m[8] * sn.z};
  const float navg_ok = nrd::dot3(sn, n_avg) > a.navg_thr[i] ? 1.0f : 0.0f;

  // IsInScreenBilinear per quad and the per-quad thresholds
  const float x0ok = (ox >= 0.0f && ox < a.rect_prev_w) ? 1.0f : 0.0f;
  const float x1ok = (ox + 1.0f >= 0.0f && ox + 1.0f < a.rect_prev_w) ? 1.0f : 0.0f;
  const float y0ok = (oy >= 0.0f && oy < a.rect_prev_h) ? 1.0f : 0.0f;
  const float y1ok = (oy + 1.0f >= 0.0f && oy + 1.0f < a.rect_prev_h) ? 1.0f : 0.0f;
  const float in4[4] = {x0ok * y0ok, x1ok * y0ok, x0ok * y1ok, x1ok * y1ok};
  const float bt = a.base_thr[i];
  float qthr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) qthr[q] = bt * navg_ok * in4[q] - 1e-6f;

  // plane-distance and material occlusion of the 16 taps
  const float xvz = a.xv_prev_z[i];
  const float mat_c = fmaxf(nr.at(x, y, 3) * 3.0f, a.min_material);
  float occ[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = (k >= 2 ? 1 : 0) + (j >= 2 ? 2 : 0);
      const float o = fabsf(z[j][k] - xvz) <= qthr[q] ? 1.0f : 0.0f;
      const float mt = fmaxf(prev_mat.at(bx - 1 + k, by - 1 + j, 0), a.min_material);
      occ[j][k] = o * (mat_c == mt ? 1.0f : 0.0f);
    }

  float oc[4], bw[4], ow[4];
  nrd::bilinear_weights(fx, fy, bw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    oc[t] = occ[kCenterY[t]][kCenterX[t]];
    ow[t] = bw[t] * oc[t];
  }
  float occ12 = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!((j == 0 || j == 3) && (k == 0 || k == 3))) occ12 = occ12 + occ[j][k];
  const bool allow_catrom = occ12 > 11.5f;
  const float fbits = oc[0] * 1.0f + oc[1] * 2.0f + oc[2] * 4.0f + oc[3] * 8.0f;
  const float footprint = oc[0] * bw[0] + oc[1] * bw[1] + oc[2] * bw[2] + oc[3] * bw[3];

  const size_t plane = (size_t)a.w * a.h;
  a.out_planes[i] = fbits;
  a.out_planes[plane + i] = allow_catrom ? 1.0f : 0.0f;
  a.out_planes[2 * plane + i] = footprint;

  // per signal: accumulation speed and the history samples at the saturated reprojected
  // position, with the CatRom taps and bilinear weights computed once
  const float spx = nrd::saturate(u) * a.rect_prev_w, spy = nrd::saturate(v) * a.rect_prev_h;
  const nrd::CatromTaps taps = nrd::catrom_taps(spx, spy, allow_catrom, ow);
  const int fx0 = nrd::to_index(floorf(spx - 0.5f)), fy0 = nrd::to_index(floorf(spy - 0.5f));
#pragma unroll
  for (int s = 0; s < 2; ++s) {  // unrolled: s is constant, the pointers stay in registers
    if (s >= a.nsig) break;
    float das, fast, hist[4];
    nrd::bilinear_custom(Image<float, 1>{a.accum[s], a.w, a.h}, bx, by, ow, &das);
    nrd::catrom_apply(Image<__nv_bfloat16, 4>{a.hist[s], a.w, a.h}, taps, hist);
    nrd::bilinear_custom(Image<__nv_bfloat16, 1>{a.fast[s], a.w, a.h}, fx0, fy0, ow, &fast);
#pragma unroll
    for (int c = 0; c < 4; ++c) a.out_hist[4 * (s * plane + i) + c] = hist[c];
    a.out_planes[(3 + 2 * s) * plane + i] = das;
    a.out_planes[(4 + 2 * s) * plane + i] = fast;
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

}  // namespace

extern "C" const char* nrd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ptrs: smb_uv, xv_prev_z, base_thr, navg_thr, nr, prev_vz, prev_nr, prev_mat, accum,
//       hist, fast, out_hist, out_planes, out_navg [, accum, hist, fast of a second signal]
// consts: view_z_scale, denoising_range, rect_prev_w, rect_prev_h, min_material, m[9],
//         signal count (1 or 2)
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
  a.nsig = (int)c[14];
  if (a.nsig != 1 && a.nsig != 2) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < 2; ++s) {  // the second signal's pointers follow the outputs
    const int k = s == 0 ? 8 : 14;
    a.accum[s] = (const float*)p[s < a.nsig ? k : 8];
    a.hist[s] = (const __nv_bfloat16*)p[s < a.nsig ? k + 1 : 9];
    a.fast[s] = (const __nv_bfloat16*)p[s < a.nsig ? k + 2 : 10];
  }
  a.view_z_scale = c[0];
  a.denoising_range = c[1];
  a.rect_prev_w = c[2];
  a.rect_prev_h = c[3];
  a.min_material = c[4];
  for (int k = 0; k < 9; ++k) a.m[k] = c[5 + k];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  smb_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
