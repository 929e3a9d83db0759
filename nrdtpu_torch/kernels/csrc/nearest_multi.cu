// N2: nearest fetches of a packed (h, w, 4) image at S uv sets in one launch.
// Replaces nrdtpu/kernels/reblur_pallas.py:219 nearest_resolve_multi; computes
// sample_nearest of nrdtpu/passes/reblur/kernels.py:1199-1221 and :1374-1375 per pixel.
// The plain version is nrdtpu_torch/kernels/nearest_multi.py:nearest_multi_ref.
// One thread per pixel, one float4 load per set.
#include "common.cuh"

namespace {

struct NmArgs {
  const float4* img;  // (h, w) texels of 4 floats
  const float* uvs;   // (S, h, w, 2)
  float4* out;        // (S, h, w)
  int w, h, sets;
};

__global__ void __launch_bounds__(256) nearest_multi_kernel(NmArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t plane = (size_t)a.w * a.h;
  const size_t i = (size_t)y * a.w + x;
  for (int s = 0; s < a.sets; ++s) {
    const float* uv = a.uvs + 2 * (s * plane + i);
    const int sx = nrd::clampi(nrd::to_index(floorf(uv[0] * (float)a.w)), 0, a.w - 1);
    const int sy = nrd::clampi(nrd::to_index(floorf(uv[1] * (float)a.h)), 0, a.h - 1);
    a.out[s * plane + i] = a.img[(size_t)sy * a.w + sx];
  }
}

}  // namespace

// ptrs: img, uvs, out;  consts: number of uv sets
extern "C" int nrd_nearest_multi(void* const* p, const float* c, int w, int h, void* stream) {
  NmArgs a;
  a.img = (const float4*)p[0];
  a.uvs = (const float*)p[1];
  a.out = (float4*)p[2];
  a.w = w;
  a.h = h;
  a.sets = (int)c[0];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  nearest_multi_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
