// Device functions shared by the LK kernels K2 (lk_level.cu) and K3
// (lk_iterate.cu): the warp butterfly and corner() (both), block
// reductions and the exact float32 bilinear tap from global memory (K3;
// K2 taps its shared-memory tiles with the same arithmetic).
// Each kernel is its own shared library, so each has its own copy;
// ops/_build.py hashes this header with every source, so an edit rebuilds
// both.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 31;
constexpr int kAuxW = 16;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum each of v[0..K) over the block; every thread receives the sums.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[k][w];
    v[k] = s;
  }
  __syncthreads();  // red is free for the next reduction
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

__device__ __forceinline__ float bilerp(const float* __restrict__ w, int L,
                                        const Corner& c, int i, int j) {
  const float* p = w + (size_t)(c.iy + i) * L + (c.ix + j);
  const float p00 = __ldg(p), p01 = __ldg(p + 1);
  const float p10 = __ldg(p + L), p11 = __ldg(p + L + 1);
  // a row lerp, then a column lerp, as the plain version computes it
  const float r0 = p00 * (1.f - c.fy) + p10 * c.fy;
  const float r1 = p01 * (1.f - c.fy) + p11 * c.fy;
  return r0 * (1.f - c.fx) + r1 * c.fx;
}

}  // namespace lk
