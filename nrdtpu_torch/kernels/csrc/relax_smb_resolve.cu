// K16: RELAX surface-motion loader (TemporalAccumulation's loadSurfaceMotionBasedPrevData):
// the current 3x3 normal average, the 4x4 previous viewZ / material occlusion with the
// per-quad in-screen thresholds, the backface test against the previous normal at the
// footprint centre, the custom-bilinear history length (+ 1, at most 255), the footprint
// quality and smb_found, and the CatRom-12 / bilinear-custom samples of 1 to 4 (h, w, 4)
// histories. With the specular signal also the un-normalised 3x3 normal average, the 3x3 min
// of the current specular hitT (0 counts as NRD_INF) and the previous reflection hitT,
// bilinear with the custom weights. Replaces nrdtpu/kernels/relax_pallas.py:1000
// relax_smb_resolve; computes nrdtpu/passes/relax/kernels.py:376-394, :426, :485-549,
// :580-583 and :805-814 per pixel. The plain
// version is nrdtpu_torch/kernels/relax_smb_resolve.py:relax_smb_resolve_ref. One thread per
// pixel.
#include "relax_common.cuh"

namespace {

using nrd::Image;
using nrd::V3;

constexpr int kMaxHistories = 4;

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
  int w, h, nhist;
  bool spec;
  float view_z_scale, rect_prev_w, rect_prev_h, res_w, res_h, min_material;
  float m[9];              // world_prev_to_world rotation, row-major
};

__global__ void __launch_bounds__(256) relax_smb_resolve_kernel(RelaxSmbArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 4> nr{a.nr, a.w, a.h};
  const Image<float, 1> prev_vz{a.prev_vz, a.w, a.h};
  const Image<float, 1> prev_mat{a.prev_mat, a.w, a.h};

  // current 3x3 normal average, row by row, made unit length
  // and with spec the 3x3 min of the current hitT, 0 counting as NRD_INF
  const Image<float, 1> hit{a.spec_hit, a.w, a.h};
  float min_hit = 0.0f;
  if (a.spec) {
    min_hit = hit.at(x, y, 0);
    if (min_hit == 0.0f) min_hit = 1e6f;
  }
  V3 na{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const V3 n = nrd::unpack_normal(nr.at(x + dx, y + dy, 0), nr.at(x + dx, y + dy, 1));
      na = V3{na.x + n.x, na.y + n.y, na.z + n.z};
      if (a.spec && (dx != 0 || dy != 0)) {
        const float t = hit.at(x + dx, y + dy, 0);
        min_hit = fminf(min_hit, t == 0.0f ? 1e6f : t);
      }
    }
  na = V3{na.x / 9.0f, na.y / 9.0f, na.z / 9.0f};
  if (a.spec) {
    a.planes[3 * plane + i] = na.x;
    a.planes[4 * plane + i] = na.y;
    a.planes[5 * plane + i] = na.z;
    a.planes[6 * plane + i] = min_hit;
  }
  const float inv = rsqrtf(fmaxf(na.x * na.x + na.y * na.y + na.z * na.z, 1e-15f));
  na = V3{na.x * inv, na.y * inv, na.z * inv};

  const float u = a.smb_uv[2 * i], v = a.smb_uv[2 * i + 1];
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
  const float bt = a.base_thr[i];
  float qthr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) qthr[q] = bt * in4[q] - 1e-6f;

  // plane-distance and material occlusion of the 16 taps
  const float xvz = a.xv_prev_z[i];
  const float mat_c = fmaxf(nr.at(x, y, 3) * 3.0f, a.min_material);
  float occ[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = (k >= 2 ? 1 : 0) + (j >= 2 ? 2 : 0);
      const float z = fabsf(prev_vz.at(bx - 1 + k, by - 1 + j, 0)) * a.view_z_scale;
      const float o = fabsf(z - xvz) <= qthr[q] ? 1.0f : 0.0f;
      const float mt = fmaxf(prev_mat.at(bx - 1 + k, by - 1 + j, 0), a.min_material);
      occ[j][k] = o * (mat_c == mt ? 1.0f : 0.0f);
    }
  float occ12 = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!((j == 0 || j == 3) && (k == 0 || k == 3))) occ12 = occ12 + occ[j][k];
  bool bicubic = occ12 > 11.5f;
  float bv[4] = {occ[1][1], occ[1][2], occ[2][1], occ[2][2]};

  // backface test: the previous normal, bilinear at the footprint centre, in this frame
  float pn4[4];
  nrd::sample_bilinear(Image<float, 4>{a.prev_nr, a.w, a.h}, (ox + 1.0f) / a.res_w,
                       (oy + 1.0f) / a.res_h, pn4);
  const float px = pn4[0] * 2.0f - 1.0f, py = pn4[1] * 2.0f - 1.0f, pz = pn4[2] * 2.0f - 1.0f;
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
  a.planes[i] = fminf(hl + 1.0f, 255.0f);
  a.planes[plane + i] = any_valid ? quality : 0.0f;
  a.planes[2 * plane + i] = any_valid ? (bicubic ? 2.0f : 1.0f) : 0.0f;
  if (a.spec) {
    float ht;
    nrd::bilinear_custom(Image<float, 1>{a.prev_ht, a.w, a.h}, bx, by, cw, &ht);
    a.planes[7 * plane + i] = ht;
  }

  // the histories at uv_smb x rect_prev, with the CatRom taps computed once
  const nrd::CatromTaps taps =
      nrd::catrom_taps(u * a.rect_prev_w, v * a.rect_prev_h, bicubic, cw);
#pragma unroll
  for (int s = 0; s < kMaxHistories; ++s) {  // unrolled: the pointers stay in registers
    if (s >= a.nhist) break;
    float out[4];
    nrd::catrom_apply(Image<float, 4>{a.hist[s], a.w, a.h}, taps, out);
#pragma unroll
    for (int c = 0; c < 4; ++c) a.hist_out[4 * (s * plane + i) + c] = out[c];
  }
}

}  // namespace

// ptrs: smb_uv, xv_prev_z, base_thr, nr, prev_vz, prev_mat, prev_hl, prev_nr, planes,
//       hist_out, 4 history slots (the first nhist used), spec_hit, prev_ht (null without
//       spec)
// consts: view_z_scale, rect_prev_w, rect_prev_h, res_w, res_h, min_material, m[9], nhist,
//         spec (0 or 1)
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
  a.spec = c[16] != 0.0f;
  a.spec_hit = (const float*)p[14];
  a.prev_ht = (const float*)p[15];
  if (a.spec && (a.spec_hit == nullptr || a.prev_ht == nullptr)) return (int)cudaErrorInvalidValue;
  a.view_z_scale = c[0];
  a.rect_prev_w = c[1];
  a.rect_prev_h = c[2];
  a.res_w = c[3];
  a.res_h = c[4];
  a.min_material = c[5];
  for (int k = 0; k < 9; ++k) a.m[k] = c[6 + k];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  relax_smb_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
