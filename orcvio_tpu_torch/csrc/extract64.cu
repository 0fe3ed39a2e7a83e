// Kernel K5: window extraction at 64-lane-aligned starts, sm_90a.
//
// Replaces scripts/race_extract.py:extract_pallas (_gather_kernel), the
// window-extraction race's Pallas kernel: a dynamic row start and a lane
// start rounded down to a multiple of 64, 128 lanes out.
//
//   y  = clamp(oy[b, n], 0, Hp - rows),  x = clamp(ox[b, n], 0, Wp - rows)
//   x64 = min(floor(x / 64) * 64, Wp - 128)
//   out[b, n] = imgs[b, y : y + rows, x64 : x64 + 128],  off[b, n] = x - x64
//
// so the logical (rows, rows) window at (y, x) is out[b, n][:, off : off +
// rows]. Where the TPU kernel's reads are in range (x < Wp - 64 and y <=
// Hp - rows) the clamps change nothing; elsewhere they keep every read in
// the image, as K1's do (window_gather.cu).
//
// Bound: bytes. It does no arithmetic; it must read the image pixels the
// windows cover, once each (neighbouring windows overlap), and write
// rows * 128 * 4 bytes and one offset per window. Design: one block per
// (window, image) pair, so the race's 200 x 8 windows give 1600 blocks;
// each thread moves 16-byte float4s, neighbouring threads on neighbouring
// addresses (a 128-lane row is 32 float4s). A 64-float start is 256-byte
// aligned, so every float4 is aligned where the row pitch Wp is a multiple
// of 4 (the wrapper checks it). Each block loads its own origins (the TPU's
// scalar prefetch has no counterpart).

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kAlign = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract64_kernel(const float* __restrict__ imgs, const int* __restrict__ oy,
                 const int* __restrict__ ox, float* __restrict__ out,
                 int* __restrict__ off, int N, int Hp, int Wp, int rows) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t i = (size_t)b * N + n;
  const int y = min(max(oy[i], 0), Hp - rows);
  const int x = min(max(ox[i], 0), Wp - rows);
  const int x64 = min((x / kAlign) * kAlign, Wp - kLanes);  // x >= 0: floor
  if (threadIdx.x == 0) off[i] = x - x64;
  constexpr int kVec = kLanes / 4;
  const float4* src = reinterpret_cast<const float4*>(
      imgs + ((size_t)b * Hp + y) * Wp + x64);
  float4* dst = reinterpret_cast<float4*>(out + i * rows * kLanes);
  const int src_stride = Wp / 4;
  for (int k = threadIdx.x; k < rows * kVec; k += kThreads) {
    const int r = k / kVec;
    const int v = k - r * kVec;
    dst[k] = __ldg(src + (size_t)r * src_stride + v);
  }
}

}  // namespace

extern "C" int extract64(const float* imgs, const int* oy, const int* ox,
                         float* out, int* off, int B, int N, int Hp, int Wp,
                         int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N == 0) return 0;
  dim3 grid(N, B);
  extract64_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      imgs, oy, ox, out, off, N, Hp, Wp, rows);
  return (int)cudaGetLastError();
}
