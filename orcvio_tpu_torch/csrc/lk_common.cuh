// Device functions of the LK kernels K2 and K3 (lk_level.cu, one kernel
// body for both): the warp butterfly and corner(), the clamped integer and
// fractional corner of a bilinear patch. ops/_build.py hashes this header
// with every source, so an edit rebuilds.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lk {

constexpr int kMaxP = 31;
constexpr int kAuxW = 16;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Corner {
  int iy, ix;
  float fy, fx;
};

// Integer and fractional part of a (P, P) patch's (0, 0) tap at window
// coordinates (lx, ly), clamped so that all (P+1)^2 taps lie in the window.
__device__ __forceinline__ Corner corner(float lx, float ly, int R, int L, int P) {
  const float my = (float)(R - 1.001 - P);
  const float mx = (float)(L - 1.001 - P);
  ly = fminf(fmaxf(ly, 0.f), my);
  lx = fminf(fmaxf(lx, 0.f), mx);
  const float fly = floorf(ly);
  const float flx = floorf(lx);
  return Corner{(int)fly, (int)flx, ly - fly, lx - flx};
}

}  // namespace lk
