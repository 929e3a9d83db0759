// K24: the halo-window launcher's bodies (nrdtpu_torch/kernels/halo.py:BODIES). The JAX
// package has no caller of halo_call; `box` exists to hold the launcher against its plain
// version.
#include "halo.cuh"

namespace {

using nrd::HaloArgs;
using nrd::HaloWindow;

// body 0, box: output k = the mean of each channel of image k over the (2 halo + 1)^2
// window, summed row by row (halo.py:box)
struct BoxBody {
  __device__ void operator()(const HaloArgs& a, const HaloWindow* win, int ly, int lx, int y0,
                             int x0) const {
    const int n = 2 * a.halo + 1;
    const size_t o = (size_t)(y0 + ly) * a.w + (x0 + lx);
    for (int k = 0; k < a.nout; ++k) {
      const int c = win[k].c;
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int dy = 0; dy < n; ++dy)
          for (int dx = 0; dx < n; ++dx) acc = acc + win[k].at(ly + dy, lx + dx, ch);
        a.out[k][o * c + ch] = acc / (float)(n * n);
      }
    }
  }
};

}  // namespace

// ptrs: images[4], outputs[4] (null past the count), scalars (or null)
// consts: body index, halo, bh, bw, image count, output count, image channels[4], scalar
//         count
extern "C" int nrd_halo_call(void* const* p, const float* c, int w, int h, void* stream) {
  HaloArgs a;
  const int body = (int)c[0];
  a.halo = (int)c[1];
  a.bh = (int)c[2];
  a.bw = (int)c[3];
  a.nimg = (int)c[4];
  a.nout = (int)c[5];
  if (a.nimg < 1 || a.nimg > nrd::kHaloMaxImages || a.nout < 1 ||
      a.nout > nrd::kHaloMaxImages || a.bh < 1 || a.bw < 1 || a.halo < 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < nrd::kHaloMaxImages; ++k) {
    a.img[k] = (const float*)p[k];
    a.out[k] = (float*)p[nrd::kHaloMaxImages + k];
    a.img_c[k] = (int)c[6 + k];
  }
  a.scalars = (const float*)p[2 * nrd::kHaloMaxImages];
  a.nscalars = (int)c[6 + nrd::kHaloMaxImages];
  a.w = w;
  a.h = h;
  a.strip = a.bh;
  a.blocks_x = 1;
  switch (body) {
    case 0:
      return nrd::halo_launch(a, BoxBody{}, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
