// Kernel K2: one pyramid level of Lucas-Kanade per feature, fused, sm_90a.
//
// Replaces orcvio_tpu/ops/lk_pallas.py:lk_level_fused (_lk_level_kernel).
// Per feature (one block of 256 threads):
//   template: a bilinear (P+2)^2 patch of win0 at aux[0:2] - (r+1), central
//     differences inside it -> t, tgx, tgy on P^2 taps (shared memory),
//     block sums a11, a12, a22, det (det_safe = 1 where det <= 1e-6);
//   iterations over win1 from aux[10:12], clamped to [aux[4:6], aux[6:8]]:
//     each thread resamples its taps and forms err*tgx, err*tgy, a block
//     reduction gives b1, b2, and the step (dx, dy) is clamped; a feature
//     stops once its step norm is <= eps or after `iters` steps;
//   residual: mean |I - T| at the final position.
// Output row: [lx, ly, residual, last step norm, det, steps taken, 0, 0].
//
// The TPU kernel resamples through one-hot bf16 matrix products on a hi/lo
// split of the pixels and stops a block of features together; here each
// tap is an exact float32 bilinear interpolation and each feature stops on
// its own (the TPU kernel's rule at block_n = 1, and cv::TermCriteria's).
//
// Bound: what the function needs, not the windows it is given. Per feature
// it reads a (P+3)^2 block of win0 (the template's (P+2)^2 bilinear taps)
// and, of win1, the union of the (P+1)^2 blocks at the positions it visits:
// at most the 37 x 37 block the clamped search can reach at P = 15, so
// 1.3 KB to 6.8 KB per feature, against some 14 operations per tap per step
// on 225 taps. The windows as stored are 98 KB per feature (K1's output,
// 256 lanes wide for a 36 px search); the kernel reads only the taps, from
// L1/L2. Over the card's data-sheet rates both the bytes and the operations
// come to well under a microsecond for 200 features (chip_smoke.py counts
// them from each run's steps), so the kernel is latency-bound: its time is
// the slowest feature's chain of dependent loads and block reductions.
// Fewer launches (K1 fused into K2) and shorter chains would move it, not
// bandwidth.
// Every thread finishes each reduction with the same sums in the same
// order, so every thread holds the same position and the loop's exit is
// uniform across the block without a broadcast.

#include "lk_common.cuh"

using namespace lk;

namespace {

constexpr int kMaxPt = kMaxP + 2;

__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ win0, const float* __restrict__ win1,
                const float* __restrict__ aux, float* __restrict__ out, int R,
                int L, int P, int iters, float eps) {
  __shared__ float tp[kMaxPt * kMaxPt];
  __shared__ float t_s[kMaxP * kMaxP];
  __shared__ float gx_s[kMaxP * kMaxP];
  __shared__ float gy_s[kMaxP * kMaxP];
  __shared__ float red[3][kWarps];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* w0 = win0 + (size_t)n * R * L;
  const float* w1 = win1 + (size_t)n * R * L;
  const float* a = aux + (size_t)n * kAuxW;
  const int r = (P - 1) / 2;
  const int Pt = P + 2;
  const int PP = P * P;

  // --- template from win0: one (P+2) patch, differences inside it ---
  const Corner c0 = corner(a[0] - (r + 1), a[1] - (r + 1), R, L, Pt);
  for (int k = tid; k < Pt * Pt; k += kThreads) {
    const int i = k / Pt;
    tp[k] = bilerp(w0, L, c0, i, k - i * Pt);
  }
  __syncthreads();
  float h[3] = {0.f, 0.f, 0.f};
  for (int k = tid; k < PP; k += kThreads) {
    const int i = k / P;
    const int j = k - i * P;
    const float* row = tp + (i + 1) * Pt + (j + 1);
    const float gx = 0.5f * (row[1] - row[-1]);
    const float gy = 0.5f * (row[Pt] - row[-Pt]);
    t_s[k] = row[0];
    gx_s[k] = gx;
    gy_s[k] = gy;
    h[0] += gx * gx;
    h[1] += gx * gy;
    h[2] += gy * gy;
  }
  block_sum<3>(h, red);  // its barrier also publishes t_s, gx_s, gy_s
  const float a11 = h[0], a12 = h[1], a22 = h[2];
  const float det = a11 * a22 - a12 * a12;
  const float det_safe = det > 1e-6f ? det : 1.f;

  // --- Gauss-Newton over win1, per-feature stop ---
  const float lo_x = a[4], lo_y = a[5], hi_x = a[6], hi_y = a[7];
  float lx = fminf(fmaxf(a[10], lo_x), hi_x);
  float ly = fminf(fmaxf(a[11], lo_y), hi_y);
  float dn = INFINITY;
  int it = 0;
  for (; it < iters && dn > eps; ++it) {
    const Corner c = corner(lx - r, ly - r, R, L, P);
    float b[2] = {0.f, 0.f};
    for (int k = tid; k < PP; k += kThreads) {
      const int i = k / P;
      const float err = bilerp(w1, L, c, i, k - i * P) - t_s[k];
      b[0] += gx_s[k] * err;
      b[1] += gy_s[k] * err;
    }
    block_sum<2>(b, red);
    const float dx = (a22 * b[0] - a12 * b[1]) / det_safe;
    const float dy = (a11 * b[1] - a12 * b[0]) / det_safe;
    lx = fminf(fmaxf(lx - dx, lo_x), hi_x);
    ly = fminf(fmaxf(ly - dy, lo_y), hi_y);
    dn = sqrtf(dx * dx + dy * dy);
  }

  // --- residual at the final position ---
  const Corner c = corner(lx - r, ly - r, R, L, P);
  float s[1] = {0.f};
  for (int k = tid; k < PP; k += kThreads) {
    const int i = k / P;
    s[0] += fabsf(bilerp(w1, L, c, i, k - i * P) - t_s[k]);
  }
  block_sum<1>(s, red);
  if (tid == 0) {
    float* o = out + (size_t)n * 8;
    o[0] = lx;
    o[1] = ly;
    o[2] = s[0] / (float)PP;
    o[3] = dn;
    o[4] = det;
    o[5] = (float)it;
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

}  // namespace

extern "C" int lk_level(const float* win0, const float* win1, const float* aux,
                        float* out, int N, int R, int L, int P, int iters,
                        float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  lk_level_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      win0, win1, aux, out, R, L, P, iters, eps);
  return (int)cudaGetLastError();
}
