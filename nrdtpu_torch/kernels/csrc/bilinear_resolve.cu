// Bilinear samples of a packed (h, w, 4) image at S uv sets in one launch, each
// sample_bilinear(image, uv x scale) with linear-clamp addressing. Replaces
// nrdtpu/kernels/reblur_pallas.py:1813 bilinear_resolve (without its renormalised off-screen
// taps); computes the look-back normals of nrdtpu/passes/relax/kernels.py:853-877 per pixel.
// The plain version is nrdtpu_torch/kernels/bilinear_resolve.py:bilinear_resolve_ref.
// One thread per pixel.
#include "common.cuh"

namespace {

struct BrArgs {
  const float* img;  // (h, w, 4)
  const float* uvs;  // (S, h, w, 2)
  float* out;        // (S, h, w, 4)
  int w, h, sets;
  float sx, sy;
};

__global__ void __launch_bounds__(256) bilinear_resolve_kernel(BrArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t plane = (size_t)a.w * a.h;
  const size_t i = (size_t)y * a.w + x;
  const nrd::Image<float, 4> img{a.img, a.w, a.h};
  for (int s = 0; s < a.sets; ++s) {
    const float* uv = a.uvs + 2 * (s * plane + i);
    float out[4];
    nrd::sample_bilinear(img, uv[0] * a.sx, uv[1] * a.sy, out);
#pragma unroll
    for (int c = 0; c < 4; ++c) a.out[4 * (s * plane + i) + c] = out[c];
  }
}

}  // namespace

// ptrs: img, uvs, out;  consts: number of uv sets, scale x, scale y
extern "C" int nrd_bilinear_resolve(void* const* p, const float* c, int w, int h,
                                    void* stream) {
  BrArgs a;
  a.img = (const float*)p[0];
  a.uvs = (const float*)p[1];
  a.out = (float*)p[2];
  a.w = w;
  a.h = h;
  a.sets = (int)c[0];
  a.sx = c[1];
  a.sy = c[2];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  bilinear_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
