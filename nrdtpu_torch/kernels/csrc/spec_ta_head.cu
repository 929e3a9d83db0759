// N1: specular TA head: 3x3 min hitDistForTracking + roughness^2 moments, the curvature
// edge's neighbour normals and the nearest fetches at the high-parallax uv.
// Replaces nrdtpu/kernels/reblur_pallas.py:942 spec_ta_head (= :882 spec_prelude + :847
// shift_planes + :171 nearest_resolve) with the XLA semantics of
// nrdtpu/passes/reblur/kernels.py:1005-1022, :1093-1097 and :1125-1128. The plain version is
// nrdtpu_torch/kernels/spec_ta_head.py:spec_ta_head_ref. One thread per pixel.
// The RGBA normal encodings (kDec): the plane is IN_NORMAL_ROUGHNESS as packed with its .w,
// the roughness, decoded (frontend.py:decode_roughness_plane with decoded); the moments read
// the roughness from .w, and the curvature and high-parallax lanes stay .xy of the plane, as
// the reference reads them at every encoding (nrdtpu/passes/reblur/kernels.py:1094-1097,
// :1126-1128; ROADMAP.md Queue 3). The R10G10B10A2 instance compiles as before.
#include "common.cuh"

namespace {

using nrd::Image;

struct HeadArgs {
  const float* hdt;     // (h, w) hitDistForTracking, 0 = none
  const float* nr;      // (h, w, 4) packed normal / roughness (.z, kDec .w) / material
  const float* view_z;  // (h, w) raw
  const float* uv_high; // (h, w, 2)
  float* out;           // (10, h, w): hdt_min, m1, m2, nr01 x2, nr10 x2, z_high, nr_high x2
  int w, h;
};

__device__ __forceinline__ float hdt_src(const Image<float, 1>& img, int x, int y) {
  const float v = img.at(x, y, 0);
  return v == 0.0f ? 1e6f : v;  // NRD_INF
}

template <bool kDec = false>
__global__ void __launch_bounds__(256) spec_ta_head_kernel(HeadArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 1> hdt{a.hdt, a.w, a.h};
  const Image<float, 4> nr{a.nr, a.w, a.h};

  float hmin = hdt_src(hdt, x, y), m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      hmin = fminf(hmin, hdt_src(hdt, x + dx, y + dy));
      float rsq = nr.at(x + dx, y + dy, nrd::kRoughLane<kDec>);
      rsq = rsq * rsq;
      m1 = m1 + rsq;
      m2 = m2 + rsq * rsq;
    }

  const float u = a.uv_high[2 * i], v = a.uv_high[2 * i + 1];
  const int hx = nrd::to_index(floorf(u * (float)a.w));
  const int hy = nrd::to_index(floorf(v * (float)a.h));

  float* o = a.out + i;
  o[0] = hmin;
  o[plane] = m1 / 9.0f;
  o[2 * plane] = m2 / 9.0f;
  o[3 * plane] = nr.at(x + 1, y, 0);
  o[4 * plane] = nr.at(x + 1, y, 1);
  o[5 * plane] = nr.at(x, y + 1, 0);
  o[6 * plane] = nr.at(x, y + 1, 1);
  o[7 * plane] = Image<float, 1>{a.view_z, a.w, a.h}.at(hx, hy, 0);
  o[8 * plane] = nr.at(hx, hy, 0);
  o[9 * plane] = nr.at(hx, hy, 1);
}

}  // namespace

// ptrs: hdt, nr, view_z, uv_high, out;  consts: the roughness in .w (kDec: 0 or 1)
extern "C" int nrd_spec_ta_head(void* const* p, const float* c, int w, int h, void* stream) {
  HeadArgs a;
  a.hdt = (const float*)p[0];
  a.nr = (const float*)p[1];
  a.view_z = (const float*)p[2];
  a.uv_high = (const float*)p[3];
  a.out = (float*)p[4];
  a.w = w;
  a.h = h;
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  if (c[0] != 0.0f)
    spec_ta_head_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    spec_ta_head_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
