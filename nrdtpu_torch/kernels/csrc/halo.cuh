// K24: the halo-window stencil launcher, a template over the body. Counterpart of
// nrdtpu/kernels/halo.py:30 halo_call (its pallas_call at :130): the image is cut into
// bh x bw blocks, one CTA a block; the CTA stages each input's (bh + 2 halo) x (bw + 2 halo)
// window in dynamic shared memory, clamping every index to the image on load, waits at a
// barrier, and calls the body once per output pixel of the block. Where the windows exceed
// one CTA's shared memory they are staged in strips of whole output rows, each strip with
// its halo rows; the body sees the block's window coordinates either way. The plain version
// is nrdtpu_torch/kernels/halo.py:halo_call_ref.
#pragma once

#include "common.cuh"

namespace nrd {

constexpr int kHaloMaxImages = 4;
constexpr int kHaloThreads = 256;

struct HaloArgs {
  const float* img[kHaloMaxImages];  // (h, w, c) inputs
  int img_c[kHaloMaxImages];
  int nimg;
  float* out[kHaloMaxImages];        // (h, w, c) outputs
  int nout;
  const float* scalars;              // (nscalars,) or null
  int nscalars;
  int w, h, bh, bw, halo;
  int strip;                         // output rows staged at once
  int blocks_x;
};

// one input's staged window: rows [row0, row0 + rows) of the block's window, all its columns
struct HaloWindow {
  const float* s;
  int c, win_w, row0;
  // the block-local window pixel (wy, wx), channel k
  __device__ __forceinline__ float at(int wy, int wx, int k) const {
    return s[((size_t)(wy - row0) * win_w + wx) * c + k];
  }
};

// Body: a functor with
//   __device__ void operator()(const HaloArgs& a, const HaloWindow* win, int ly, int lx,
//                              int y0, int x0) const
// that writes the outputs of the pixel (y0 + ly, x0 + lx); (ly, lx) is the pixel in the
// block, whose window pixel (ly + halo, lx + halo) is the pixel itself.
template <class Body>
__global__ void __launch_bounds__(kHaloThreads) halo_call_kernel(HaloArgs a, Body body) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / a.blocks_x) * a.bh, x0 = (blockIdx.x % a.blocks_x) * a.bw;
  const int win_w = a.bw + 2 * a.halo;
  for (int r0 = 0; r0 < a.bh; r0 += a.strip) {
    const int out_rows = min(a.strip, a.bh - r0), rows = out_rows + 2 * a.halo;
    HaloWindow win[kHaloMaxImages];
    float* s = smem;
    for (int k = 0; k < a.nimg; ++k) {
      const int c = a.img_c[k];
      win[k] = HaloWindow{s, c, win_w, r0};
      const int n = rows * win_w * c;
      for (int e = tid; e < n; e += kHaloThreads) {
        const int wy = e / (win_w * c), rem = e % (win_w * c);
        const int gy = clampi(y0 - a.halo + r0 + wy, 0, a.h - 1);
        const int gx = clampi(x0 - a.halo + rem / c, 0, a.w - 1);
        s[e] = a.img[k][((size_t)gy * a.w + gx) * c + rem % c];
      }
      s += n;
    }
    __syncthreads();
    for (int e = tid; e < out_rows * a.bw; e += kHaloThreads) {
      const int ly = r0 + e / a.bw, lx = e % a.bw;
      if (y0 + ly < a.h && x0 + lx < a.w) body(a, win, ly, lx, y0, x0);
    }
    __syncthreads();  // the next strip overwrites the windows
  }
}

// Launch `body` over the image: sizes the strips to the card's shared memory per CTA, lifts
// the kernel's dynamic shared-memory limit to what it uses, and returns the CUDA error (an
// invalid configuration where one output row's windows do not fit).
template <class Body>
int halo_launch(HaloArgs a, Body body, cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int channels = 0;
  for (int k = 0; k < a.nimg; ++k) channels += a.img_c[k];
  const size_t row_bytes = (size_t)(a.bw + 2 * a.halo) * channels * sizeof(float);
  const long fit_rows = (long)((size_t)smem_max / row_bytes) - 2 * a.halo;
  if (fit_rows < 1) return (int)cudaErrorInvalidConfiguration;
  const int strips = (int)((a.bh + fit_rows - 1) / fit_rows);
  a.strip = (a.bh + strips - 1) / strips;
  const size_t smem = (size_t)(a.strip + 2 * a.halo) * row_bytes;
  err = cudaFuncSetAttribute(halo_call_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  a.blocks_x = (a.w + a.bw - 1) / a.bw;
  const int blocks = a.blocks_x * ((a.h + a.bh - 1) / a.bh);
  halo_call_kernel<Body><<<blocks, kHaloThreads, smem, stream>>>(a, body);
  return (int)cudaGetLastError();
}

}  // namespace nrd
