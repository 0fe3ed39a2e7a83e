// Kernel K1: per-feature window gather (an exact copy), for sm_90a.
//
// Replaces orcvio_tpu/ops/dma_gather.py:dma_gather_tiles (_dma_kernel), the
// TPU kernel that issues one asynchronous HBM->VMEM copy per window.
//
//   out[n] = imgs[bidx[n], 8*r0[n] : 8*(r0[n]+nr), 128*c0[n] : 128*(c0[n]+nl)]
//
// Bound: bytes. The copy writes N*rows*lanes*4 bytes, must read the image
// tiles the windows cover once each (neighbouring windows share tiles), and
// does no arithmetic. A tile shared by several windows is read once per
// window here, from L2 after the first. Design: one block per (window,
// 8-row group), so a
// 200-window level gives 1200 blocks and the card has enough in flight to
// cover memory latency; each thread moves 16-byte float4s and neighbouring
// threads take neighbouring addresses (a 128-lane row is 32 float4s). Window
// origins are multiples of 128 floats, so every float4 is aligned. Each
// block loads its own indices (the TPU's scalar prefetch has no
// counterpart) and clamps them in range, so a bad index cannot read out of
// bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kBR = 8;    // rows per origin unit
constexpr int kBL = 128;  // lanes per origin unit
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ imgs,
                     const int* __restrict__ r0, const int* __restrict__ c0,
                     const int* __restrict__ bidx, float* __restrict__ out,
                     int B, int Hp, int Wp, int nr, int nl) {
  const int n = blockIdx.x;
  const int g = blockIdx.y;  // 8-row group of the window
  const int b = min(max(bidx[n], 0), B - 1);
  const int rb = min(max(r0[n], 0), Hp / kBR - nr);
  const int cb = min(max(c0[n], 0), Wp / kBL - nl);
  const int lanes = nl * kBL;
  const int vec_per_row = lanes / 4;
  const size_t row0 = (size_t)b * Hp + (size_t)(rb + g) * kBR;
  const float4* src = reinterpret_cast<const float4*>(
      imgs + row0 * Wp + (size_t)cb * kBL);
  float4* dst = reinterpret_cast<float4*>(
      out + ((size_t)n * nr * kBR + (size_t)g * kBR) * lanes);
  const int src_stride = Wp / 4;
  for (int i = threadIdx.x; i < kBR * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int v = i - r * vec_per_row;
    dst[r * vec_per_row + v] = __ldg(src + (size_t)r * src_stride + v);
  }
}

}  // namespace

extern "C" int window_gather(const float* imgs, const int* r0, const int* c0,
                             const int* bidx, float* out, int N, int B, int Hp,
                             int Wp, int nr, int nl, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  dim3 grid(N, nr);
  window_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      imgs, r0, c0, bidx, out, B, Hp, Wp, nr, nl);
  return (int)cudaGetLastError();
}
