// Kernel K4: the EKF covariance update out = sym(P - K (H P)), for sm_90a.
//
// Replaces orcvio_tpu/ops/cov_update.py:cov_update_pallas (_cov_kernel), the
// TPU kernel that forms, for each 128x128 output tile (i, j),
// A_ij = P_ij - K_i (HP)_j and A_ji^T, and writes 0.5 (A_ij + A_ji^T).
// As there, HP = H P is one matrix product computed outside (torch.matmul);
// the K (HP) products and the symmetrization are this kernel's own work.
//
//   P (D, D), K (D, q), HP (q, D), out (D, D), row-major, float or double.
//
// Bound: operations. The function does 4 D^2 q FLOP (HP and K HP) on
// (2 D^2 + 2 D q) elements in and out: at the bench's D = 172, q = 444,
// 52.5 MFLOP against 0.85 MB, 0.78 us at the FP32 peak against 0.25 us of
// memory. Design: one block of 16x16 threads per 16x16 output tile, tiles of
// K rows and HP columns staged through shared memory in chunks of 32 along
// q, FMAs in the element type (no TF32, no tensor cores). Each thread forms
// A(r, c) and A(c, r) for its output element (r, c). Every A(r, c) is one
// chain of fma(K[r, k], HP[k, c], acc) for k = 0 .. q-1 from 0, whichever
// block computes it, so out(r, c) and out(c, r) add the same two numbers
// and the output is exactly symmetric. Ragged D and q are bounded in the
// loads (zeros past the edge) and the store; nothing is padded in memory.
// Each tile computes both halves, twice the FLOP of a triangular walk: a
// simple kernel first; tensor cores and triangular tiling are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;   // output tile edge
constexpr int kChunk = 32;  // q per shared-memory stage
constexpr int kThreads = kTile * kTile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cov_update_kernel(const T* __restrict__ P, const T* __restrict__ K,
                  const T* __restrict__ HP, T* __restrict__ out, int D, int q) {
  __shared__ T Ki[kTile][kChunk + 1];   // K rows of tile row bi
  __shared__ T Kj[kTile][kChunk + 1];   // K rows of tile column bj
  __shared__ T HPi[kChunk][kTile + 1];  // HP columns of tile row bi
  __shared__ T HPj[kChunk][kTile + 1];  // HP columns of tile column bj
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int r = i0 + ty, c = j0 + tx;
  T s_rc = T(0), s_cr = T(0);
  for (int k0 = 0; k0 < q; k0 += kChunk) {
    for (int e = t; e < kTile * kChunk; e += kThreads) {
      const int row = e / kChunk, k = e - row * kChunk;
      const bool kin = k0 + k < q;
      Ki[row][k] = (kin && i0 + row < D) ? K[(size_t)(i0 + row) * q + k0 + k] : T(0);
      Kj[row][k] = (kin && j0 + row < D) ? K[(size_t)(j0 + row) * q + k0 + k] : T(0);
      const int kk = e / kTile, col = e - kk * kTile;
      const bool hin = k0 + kk < q;
      HPi[kk][col] = (hin && i0 + col < D) ? HP[(size_t)(k0 + kk) * D + i0 + col] : T(0);
      HPj[kk][col] = (hin && j0 + col < D) ? HP[(size_t)(k0 + kk) * D + j0 + col] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      s_rc = fma(Ki[ty][k], HPj[k][tx], s_rc);  // (K HP)(r, c)
      s_cr = fma(Kj[tx][k], HPi[k][ty], s_cr);  // (K HP)(c, r)
    }
    __syncthreads();
  }
  if (r < D && c < D) {
    const T a_rc = P[(size_t)r * D + c] - s_rc;
    const T a_cr = P[(size_t)c * D + r] - s_cr;
    out[(size_t)r * D + c] = (a_rc + a_cr) * T(0.5);
  }
}

template <typename T>
int launch(const T* P, const T* K, const T* HP, T* out, int D, int q,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D == 0) return 0;
  const int nb = (D + kTile - 1) / kTile;
  cov_update_kernel<T><<<dim3(nb, nb), dim3(kTile, kTile), 0,
                         (cudaStream_t)stream>>>(P, K, HP, out, D, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cov_update_f32(const float* P, const float* K, const float* HP,
                              float* out, int D, int q, int device,
                              void* stream) {
  return launch<float>(P, K, HP, out, D, q, device, stream);
}

extern "C" int cov_update_f64(const double* P, const double* K,
                              const double* HP, double* out, int D, int q,
                              int device, void* stream) {
  return launch<double>(P, K, HP, out, D, q, device, stream);
}
