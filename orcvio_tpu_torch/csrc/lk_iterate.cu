// Kernel K3: fixed-count Lucas-Kanade over a given template, sm_90a.
//
// Replaces orcvio_tpu/ops/lk_pallas.py:lk_iterate_fused (_lk_kernel), the
// iterate-only kernel behind klt.py:_lk_iterate_pallas. Per feature (one
// block of 256 threads):
//   the template t, tgx, tgy (P x P each, computed outside) go to shared
//     memory; aux holds a11 a12 a22 det_safe, the bounds lo/hi and p0;
//   exactly `iters` Gauss-Newton steps over win from aux[10:12], clamped to
//     [aux[4:6], aux[6:8]]: each thread resamples its taps and forms
//     err*tgx, err*tgy, a block reduction gives b1, b2, and the step is
//     clamped. There is no eps stop: the TPU kernel has none;
//   residual: mean |I - T| at the final position.
// Output row: [lx, ly, residual, last step norm, 0, 0, 0, 0].
//
// The TPU kernel resamples through one-hot bf16 matrix products on a hi/lo
// split of the pixels; here each tap is an exact float32 bilinear
// interpolation (lk_common.cuh, shared with K2).
//
// Bound: what the function needs. Per feature it reads the template (3 P^2
// floats), aux, and of win the union of the (P+1)^2 blocks at the positions
// it visits (at most 37 x 37 at P = 15 in a 36 px search), and writes 8
// floats; it does some 14 operations per tap per step on P^2 taps. For 200
// features both come to well under a microsecond on the card, so, like K2,
// the kernel is latency-bound: its time is one feature's chain of `iters`
// dependent tap loads and block reductions. Every thread finishes each
// reduction with the same sums in the same order, so every thread holds the
// same position without a broadcast.

#include "lk_common.cuh"

using namespace lk;

namespace {

__global__ void __launch_bounds__(kThreads)
lk_iterate_kernel(const float* __restrict__ win, const float* __restrict__ t,
                  const float* __restrict__ tgx, const float* __restrict__ tgy,
                  const float* __restrict__ aux, float* __restrict__ out,
                  int R, int L, int P, int iters) {
  __shared__ float t_s[kMaxP * kMaxP];
  __shared__ float gx_s[kMaxP * kMaxP];
  __shared__ float gy_s[kMaxP * kMaxP];
  __shared__ float red[2][kWarps];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int PP = P * P;
  const float* w = win + (size_t)n * R * L;
  const float* a = aux + (size_t)n * kAuxW;
  const int r = (P - 1) / 2;

  for (int k = tid; k < PP; k += kThreads) {
    t_s[k] = __ldg(t + (size_t)n * PP + k);
    gx_s[k] = __ldg(tgx + (size_t)n * PP + k);
    gy_s[k] = __ldg(tgy + (size_t)n * PP + k);
  }
  __syncthreads();

  const float a11 = a[0], a12 = a[1], a22 = a[2], det_safe = a[3];
  const float lo_x = a[4], lo_y = a[5], hi_x = a[6], hi_y = a[7];
  float lx = fminf(fmaxf(a[10], lo_x), hi_x);
  float ly = fminf(fmaxf(a[11], lo_y), hi_y);
  float dn = INFINITY;
  for (int it = 0; it < iters; ++it) {
    const Corner c = corner(lx - r, ly - r, R, L, P);
    float b[2] = {0.f, 0.f};
    for (int k = tid; k < PP; k += kThreads) {
      const int i = k / P;
      const float err = bilerp(w, L, c, i, k - i * P) - t_s[k];
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

  const Corner c = corner(lx - r, ly - r, R, L, P);
  float s[1] = {0.f};
  for (int k = tid; k < PP; k += kThreads) {
    const int i = k / P;
    s[0] += fabsf(bilerp(w, L, c, i, k - i * P) - t_s[k]);
  }
  block_sum<1>(s, red);
  if (tid == 0) {
    float* o = out + (size_t)n * 8;
    o[0] = lx;
    o[1] = ly;
    o[2] = s[0] / (float)PP;
    o[3] = dn;
    o[4] = 0.f;
    o[5] = 0.f;
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

}  // namespace

extern "C" int lk_iterate(const float* win, const float* t, const float* tgx,
                          const float* tgy, const float* aux, float* out, int N,
                          int R, int L, int P, int iters, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  lk_iterate_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      win, t, tgx, tgy, aux, out, R, L, P, iters);
  return (int)cudaGetLastError();
}
