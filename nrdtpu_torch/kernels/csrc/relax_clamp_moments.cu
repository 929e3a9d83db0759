// K20: RELAX history-clamping moments: over the clamp-to-edge 5x5, each tap weighted by its
// validity (viewZ < denoisingRange), the mean and second moment of the responsive history
// in YCoCg, the mean of the noisy radiance and the second moment of its luminance, divided
// by max(weight sum, 1). Replaces nrdtpu/kernels/relax_pallas.py:479
// relax_clamp_moments_pallas; computes nrdtpu/passes/relax/kernels.py:1173-1192 per pixel.
// The plain version is nrdtpu_torch/kernels/relax_clamp_moments.py:relax_clamp_moments_ref.
// One thread per pixel.
#include "relax_common.cuh"

namespace {

using nrd::Image;

struct ClampMomentsArgs {
  const float* view_z;  // (h, w) raw
  const float* resp;    // (h, w, 4) responsive history (rgb)
  const float* noisy;   // (h, w, 4) PrePass output (rgb)
  float* vec;           // (3, h, w, 3): m1, m2 of the responsive YCoCg, noisy mean
  float* nm2;           // (h, w) second moment of the noisy luminance
  int w, h;
  float view_z_scale, denoising_range;
};

__global__ void __launch_bounds__(256) relax_clamp_moments_kernel(ClampMomentsArgs a) {
  const int x = blockIdx.x * nrd::kBlock + threadIdx.x;
  const int y = blockIdx.y * nrd::kBlock + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = (size_t)y * a.w + x;
  const size_t plane = (size_t)a.w * a.h;
  const Image<float, 1> vz{a.view_z, a.w, a.h};
  const Image<float, 4> resp{a.resp, a.w, a.h};
  const Image<float, 4> noisy{a.noisy, a.w, a.h};

  float m1[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f}, nm1[3] = {0.0f, 0.0f, 0.0f};
  float nm2 = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy)
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      const int tx = x + dx, ty = y + dy;
      const float w_ = fabsf(vz.at(tx, ty, 0)) * a.view_z_scale < a.denoising_range ? 1.0f : 0.0f;
      float ry[3];
      relax::linear_to_ycocg(resp.at(tx, ty, 0), resp.at(tx, ty, 1), resp.at(tx, ty, 2), ry);
      const float nz[3] = {noisy.at(tx, ty, 0), noisy.at(tx, ty, 1), noisy.at(tx, ty, 2)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        m1[c] = m1[c] + ry[c] * w_;
        m2[c] = m2[c] + ry[c] * ry[c] * w_;
        nm1[c] = nm1[c] + nz[c] * w_;
      }
      const float nl = relax::luminance(nz[0], nz[1], nz[2]);
      nm2 = nm2 + nl * nl * w_;
      wsum = wsum + w_;
    }
  wsum = fmaxf(wsum, 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.vec[3 * i + c] = m1[c] / wsum;
    a.vec[3 * (plane + i) + c] = m2[c] / wsum;
    a.vec[3 * (2 * plane + i) + c] = nm1[c] / wsum;
  }
  a.nm2[i] = nm2 / wsum;
}

}  // namespace

// ptrs: view_z, resp, noisy, vec, nm2
// consts: view_z_scale, denoising_range
extern "C" int nrd_relax_clamp_moments(void* const* p, const float* c, int w, int h,
                                       void* stream) {
  ClampMomentsArgs a;
  a.view_z = (const float*)p[0];
  a.resp = (const float*)p[1];
  a.noisy = (const float*)p[2];
  a.vec = (float*)p[3];
  a.nm2 = (float*)p[4];
  a.w = w;
  a.h = h;
  a.view_z_scale = c[0];
  a.denoising_range = c[1];
  dim3 block(nrd::kBlock, nrd::kBlock);
  dim3 grid((w + nrd::kBlock - 1) / nrd::kBlock, (h + nrd::kBlock - 1) / nrd::kBlock);
  relax_clamp_moments_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
