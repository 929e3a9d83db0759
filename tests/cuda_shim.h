// A CUDA shim for rehearsing the hand kernels of nrdtpu_torch/kernels/csrc on the CPU: the
// sources compile as C++20 with g++ (-ffp-contract=off, as nvcc --fmad=false) when this
// header is force-included and two rewrites are made to the source text
// (tests/test_torch_kernel_rehearsal.py:rewrite):
//   kernel<<<grid, block[, smem[, stream]]>>>(args);  ->  shim::launch(kernel, {grid, ...}, args);
//   extern __shared__ T name[];  ->  T* name = reinterpret_cast<T*>(shim::dynamic_smem);
// A launch runs its blocks one after another; every CUDA thread of a block is a std::thread,
// and __syncthreads() is a std::barrier of the block (a thread that returns early drops out
// of it, as an exited thread does on the card). Static __shared__ arrays become function
// statics, which is sound because one block runs at a time.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__ static
#define __shared__ static

using std::abs;
using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

struct alignas(16) float4 {
  float x, y, z, w;
};

inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

struct alignas(8) float2 {
  float x, y;
};

inline float2 make_float2(float x, float y) { return float2{x, y}; }

struct alignas(8) uint2 {
  uint32_t x, y;
};

inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

inline thread_local dim3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "cuda shim"; }

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __fdividef(float a, float b) { return a / b; }

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

namespace shim {

inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local void* dynamic_smem = nullptr;

struct Config {
  dim3 grid, block;
  size_t smem;
  Config(dim3 g, dim3 b, size_t s = 0, const void* = nullptr) : grid(g), block(b), smem(s) {}
};

template <typename... P, typename... A>
void launch(void (*kernel)(P...), const Config& c, const A&... args) {
  const unsigned n = c.block.x * c.block.y * c.block.z;
  std::unique_ptr<float4[]> smem(new float4[c.smem / sizeof(float4) + 1]);
  for (unsigned bz = 0; bz < c.grid.z; ++bz)
    for (unsigned by = 0; by < c.grid.y; ++by)
      for (unsigned bx = 0; bx < c.grid.x; ++bx) {
        std::barrier<> bar(n);
        std::vector<std::thread> threads;
        threads.reserve(n);
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t % c.block.x, t / c.block.x % c.block.y,
                             t / (c.block.x * c.block.y));
            blockIdx = dim3(bx, by, bz);
            block_barrier = &bar;
            dynamic_smem = smem.get();
            kernel(args...);
            bar.arrive_and_drop();
          });
        for (auto& th : threads) th.join();
      }
}

}  // namespace shim

inline void __syncthreads() { shim::block_barrier->arrive_and_wait(); }
