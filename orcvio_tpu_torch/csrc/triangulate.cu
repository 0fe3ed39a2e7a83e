// Kernel K6: the triangulation's Levenberg-Marquardt loop, for sm_90a.
//
// Replaces no TPU kernel. The JAX package leaves this loop to XLA
// (orcvio_tpu/filter/triangulation.py:triangulate, plain jnp that XLA fuses
// into a few programs); in eager PyTorch the same code makes some 925
// small launches a call: ten damped Gauss-Newton steps over 3-vectors, each
// with a 3x3 Cramer solve written as some 50 elementwise ops. This kernel
// is that function (ops/triangulate.py:triangulate_plain; feature.hpp
// triangulate_position :583) in one launch, one thread a feature.
//
//   uv (B, F, T, 2), mask (B, F, T) bool, slot (B, F, T) int64, n_obs
//   (B, F) int32, R_c2w (B, S, 3, 3), t_c_w (B, S, 3), p_init (B, F, 3) or
//   null; out p_anchor, p_world, inv_param (B, F, 3), anchor_slot (B, F)
//   int64, valid (B, F) bool. Row b of each input starts at its pointer
//   plus b times its batch stride (elements; 0 for an input the rows
//   share) and is contiguous; the outputs are contiguous.
//
// Per feature: the anchor is observation a = clamp(n_obs - 1, 0); each
// observation's pose relative to it is R_rel = R_k^T R_a, t_rel = R_k^T
// (t_a - t_k); the initial depth is the two-view one (feature.hpp:331), or
// the prior point's depth where the point is finite and more than 0.2 m
// ahead of the anchor; then `iters` Huber-weighted LM steps in (alpha,
// beta, rho) with a per-feature accept or reject and the damping's x10 and
// /10 within [1e-10, 1e12]; then the validity checks (feature.hpp:688-720:
// positive depths, cost_threshold, 5 m from the initial guess, two
// observations). The arithmetic follows the plain version's order: the same
// sums in the same order, the same clamps and guards (1e-18 on the
// determinant, 1e-12 on the depth's denominator and the Huber norm). nvcc
// contracts a product and a sum into one FMA where PyTorch's kernels round
// twice, so the two agree to rounding, not bit for bit.
//
// Precision: float64 for float32 tensors too (widened exactly, each output
// rounded once at the end), as K4 sums in float64, and as the plain
// version's route on the CPU does (ops/triangulate.py:_plain_rows). Where
// the parallax is nil (a static start) the loop's float32 answer is
// rounding noise, and the float32 filter promoted such features until its
// covariance went to NaN. The work is small enough that float64 costs
// nothing that shows.
//
// Bound: operations. The function does about 8 kFLOP a feature of 6
// observations at 10 steps, counting a division or square root as one
// (chip_smoke.py:k6_ops: a valid observation costs 63 once for its
// relative pose, 26 for each cost it enters, 19 in the checks and 85 a step
// for the Jacobian, weights and normal equations; a feature 58 a step for
// the solve and update, 80 once): at the fleet's 1024 x 32 features of 0-6
// observations some 0.13 GFLOP a call, 4 us at the H100's 34 TFLOP/s of
// float64 outside the tensor cores, against some 300 bytes a feature in
// and out (2.9 us at 3.35 TB/s). Divisions and square roots are each a
// sequence of FMAs on the card, so the kernel executes several times that
// count; the work is still well under a millisecond, against the
// milliseconds of launches it replaces.
//
// Design: one thread a feature, every 3-vector and the 3x3 normal matrix
// in registers; no shared memory and no synchronisation. T is a run-time
// value, so a thread does not hold its (T, 12) relative poses: each pass
// over the observations recomputes them from R_c2w and t_c_w, which stay in
// L1 (a row's 20 poses are 1.9 KB, read by the 32 threads that hold its
// features), about 60 FLOP an observation a pass more than the function
// needs. Every thread runs the same fixed count of steps, so a warp does
// not diverge but on the masks.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 64;

// torch.clamp's semantics: a NaN passes through
template <typename S>
__device__ __forceinline__ S clamp(S x, S lo, S hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename S>
__device__ __forceinline__ S clamp_min(S x, S lo) {
  return x < lo ? lo : x;
}

template <typename S>
__device__ __forceinline__ S clamp_max(S x, S hi) {
  return x > hi ? hi : x;
}

// a camera's pose relative to the anchor's
template <typename S>
struct Pose {
  S R[3][3];
  S t[3];
};

// R_rel = R_k^T R_a, t_rel = R_k^T (t_a - t_k), R_k row-major
template <typename T, typename S>
__device__ __forceinline__ void relative(const T* Rk, const T* tk,
                                         const S (&Ra)[3][3],
                                         const S (&ta)[3], Pose<S>& p) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p.R[i][c] =
          Rk[i] * Ra[0][c] + Rk[3 + i] * Ra[1][c] + Rk[6 + i] * Ra[2][c];
  }
  const S d0 = ta[0] - tk[0], d1 = ta[1] - tk[1], d2 = ta[2] - tk[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p.t[i] = Rk[i] * d0 + Rk[3 + i] * d1 + Rk[6 + i] * d2;
}

// h = R_rel (alpha, beta, 1) + rho t_rel
template <typename S>
__device__ __forceinline__ void project(const Pose<S>& p, const S (&x)[3],
                                        S (&h)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = (p.R[i][0] * x[0] + p.R[i][1] * x[1] + p.R[i][2]) + x[2] * p.t[i];
}

// x = A^-1 b by cofactors, the determinant kept away from 0
template <typename S>
__device__ __forceinline__ void solve3(const S (&A)[3][3], const S (&b)[3],
                                       S (&x)[3]) {
  const S c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1];
  const S c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2];
  const S c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0];
  S det = A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02;
  det = fabs(det) > S(1e-18) ? det : S(1e-18);
  const S adj[3][3] = {
      {c00, A[0][2] * A[2][1] - A[0][1] * A[2][2],
       A[0][1] * A[1][2] - A[0][2] * A[1][1]},
      {c01, A[0][0] * A[2][2] - A[0][2] * A[2][0],
       A[0][2] * A[1][0] - A[0][0] * A[1][2]},
      {c02, A[0][1] * A[2][0] - A[0][0] * A[2][1],
       A[0][0] * A[1][1] - A[0][1] * A[1][0]}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = (adj[i][0] * b[0] + adj[i][1] * b[1] + adj[i][2] * b[2]) / det;
}

template <typename T>
struct Args {
  const T* uv;
  const uint8_t* mask;
  const int64_t* slot;
  const int32_t* n_obs;
  const T* R;
  const T* t;
  const T* p_init;  // null: no prior
  T* p_anchor;
  T* p_world;
  int64_t* anchor_slot;
  uint8_t* valid;
  T* inv_param;
  long long s_uv, s_mask, s_slot, s_nobs, s_R, s_t, s_p;  // batch strides
  int B, F, nt, ncam, iters;
  double huber, damping;
};

// T is the tensors' type; the arithmetic is float64's whatever T (S)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    triangulate_kernel(const Args<T> a) {
  using S = double;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)a.B * a.F) return;
  const long long b = g / a.F, f = g % a.F;
  const int nt = a.nt;
  const T* uv = a.uv + b * a.s_uv + f * nt * 2;
  const uint8_t* mask = a.mask + b * a.s_mask + f * nt;
  const int64_t* slot = a.slot + b * a.s_slot + f * nt;
  const int n = a.n_obs[b * a.s_nobs + f];
  const T* R = a.R + b * a.s_R;
  const T* t = a.t + b * a.s_t;
  const int an = max(n - 1, 0);
  S Ra[3][3], ta[3];
  {
    const int64_t c = slot[an];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Ra[i][j] = R[c * 9 + i * 3 + j];
      ta[i] = t[c * 3 + i];
    }
  }
  auto pose = [&](int k, Pose<S>& p) {
    const int64_t c = slot[k];
    relative(R + c * 9, t + c * 3, Ra, ta, p);
  };
  // sum of the squared residuals of the valid observations at x
  auto cost_at = [&](const S (&x)[3]) {
    S c = 0;
    for (int k = 0; k < nt; ++k) {
      if (!mask[k]) continue;
      Pose<S> p;
      pose(k, p);
      S h[3];
      project(p, x, h);
      const S r0 = h[0] / h[2] - uv[2 * k], r1 = h[1] / h[2] - uv[2 * k + 1];
      c += r0 * r0;
      c += r1 * r1;
    }
    return c;
  };

  // two-view initial guess in the anchor frame (feature.hpp:331)
  const S za0 = uv[2 * an], za1 = uv[2 * an + 1], zf0 = uv[0], zf1 = uv[1];
  S depth;
  {
    Pose<S> p;
    pose(0, p);
    S m[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      m[i] = p.R[i][0] * za0 + p.R[i][1] * za1 + p.R[i][2];
    const S A0 = m[0] - zf0 * m[2], A1 = m[1] - zf1 * m[2];
    const S b0 = zf0 * p.t[2] - p.t[0], b1 = zf1 * p.t[2] - p.t[1];
    const S denom = A0 * A0 + A1 * A1;
    depth = denom > S(1e-12) ? (A0 * b0 + A1 * b1) / clamp_min(denom, S(1e-12))
                             : S(1);
    depth = clamp(depth, S(0.1), S(1e3));
  }
  if (a.p_init != nullptr) {
    const T* q = a.p_init + b * a.s_p + f * 3;
    const S d0 = q[0] - ta[0], d1 = q[1] - ta[1], d2 = q[2] - ta[2];
    const S ha2 = Ra[0][2] * d0 + Ra[1][2] * d1 + Ra[2][2] * d2;
    if (isfinite(q[0]) && isfinite(q[1]) && isfinite(q[2]) && ha2 > S(0.2))
      depth = clamp(ha2, S(0.2), S(1e3));
  }
  const S x0[3] = {za0, za1, S(1) / depth};

  // damped Gauss-Newton steps, each accepted where it lowers the cost
  const S huber = S(a.huber), two_huber = S(2.0 * a.huber);
  S x[3] = {x0[0], x0[1], x0[2]};
  S lam = S(a.damping);
  S cost = cost_at(x);
  for (int it = 0; it < a.iters; ++it) {
    S A[3][3] = {}, g3[3] = {};
    for (int k = 0; k < nt; ++k) {
      if (!mask[k]) continue;
      Pose<S> p;
      pose(k, p);
      S h[3];
      project(p, x, h);
      const S r[2] = {h[0] / h[2] - uv[2 * k], h[1] / h[2] - uv[2 * k + 1]};
      const S h3 = h[2], h3sq = h3 * h3;
      const S W[3][3] = {{p.R[0][0], p.R[0][1], p.t[0]},
                         {p.R[1][0], p.R[1][1], p.t[1]},
                         {p.R[2][0], p.R[2][1], p.t[2]}};
      S J[2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          J[i][c] = W[i][c] / h3 - (h[i] * W[2][c]) / h3sq;
      }
      const S e = sqrt(r[0] * r[0] + r[1] * r[1]);
      const S w2 = e <= huber ? S(1) : two_huber / clamp_min(e, S(1e-12));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        S Jw[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) Jw[c] = J[i][c] * w2;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int l = 0; l < 3; ++l) A[c][l] += Jw[c] * J[i][l];
          g3[c] += Jw[c] * r[i];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) A[c][c] += lam;
    S dx[3];
    solve3(A, g3, dx);
    const S x_new[3] = {x[0] - dx[0], x[1] - dx[1], x[2] - dx[2]};
    const S cost_new = cost_at(x_new);
    const bool accept = cost_new < cost;
    if (accept) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = x_new[c];
      cost = cost_new;
    }
    lam = accept ? clamp_min(lam / S(10), S(1e-10))
                 : clamp_max(lam * S(10), S(1e12));
  }

  // validity checks (feature.hpp:688-720)
  const S rho = fabs(x[2]) > S(1e-8) ? x[2] : S(1e-8);
  const S pa[3] = {x[0] / rho, x[1] / rho, S(1) / rho};
  bool pos_depth = x[2] > S(0);
  for (int k = 0; k < nt; ++k) {
    if (!mask[k]) continue;
    Pose<S> p;
    pose(k, p);
    S h[3];
    project(p, x, h);
    pos_depth = pos_depth && h[2] / rho > S(0);
  }
  const S nn = S(2) * S(n) * S(n);
  const bool cost_ok = cost / clamp_min(nn, S(1)) < S(4.7673e-4);
  const S p0[3] = {x0[0] / x0[2], x0[1] / x0[2], S(1) / x0[2]};
  const S e0 = pa[0] - p0[0], e1 = pa[1] - p0[1], e2 = pa[2] - p0[2];
  const bool dist_ok = sqrt(e0 * e0 + e1 * e1 + e2 * e2) < S(5);

  T* pao = a.p_anchor + g * 3;
  T* pwo = a.p_world + g * 3;
  T* xo = a.inv_param + g * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pao[i] = static_cast<T>(pa[i]);
    pwo[i] = static_cast<T>(
        (Ra[i][0] * pa[0] + Ra[i][1] * pa[1] + Ra[i][2] * pa[2]) + ta[i]);
    xo[i] = static_cast<T>(x[i]);
  }
  a.anchor_slot[g] = slot[an];
  a.valid[g] = pos_depth && cost_ok && dist_ok && n >= 2;
}

template <typename S>
int launch(const Args<S>& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)a.B * a.F;
  if (n == 0) return 0;
  if (a.nt < 1 || a.ncam < 1 || a.iters < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  triangulate_kernel<S>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename S>
int entry(const void* uv, const void* mask, const void* slot,
          const void* n_obs, const void* R, const void* t, const void* p_init,
          void* p_anchor, void* p_world, void* anchor_slot, void* valid,
          void* inv_param, long long s_uv, long long s_mask, long long s_slot,
          long long s_nobs, long long s_R, long long s_t, long long s_p,
          int B, int F, int T, int ncam, double huber, int iters,
          double damping, int device, void* stream) {
  Args<S> a;
  a.uv = static_cast<const S*>(uv);
  a.mask = static_cast<const uint8_t*>(mask);
  a.slot = static_cast<const int64_t*>(slot);
  a.n_obs = static_cast<const int32_t*>(n_obs);
  a.R = static_cast<const S*>(R);
  a.t = static_cast<const S*>(t);
  a.p_init = static_cast<const S*>(p_init);
  a.p_anchor = static_cast<S*>(p_anchor);
  a.p_world = static_cast<S*>(p_world);
  a.anchor_slot = static_cast<int64_t*>(anchor_slot);
  a.valid = static_cast<uint8_t*>(valid);
  a.inv_param = static_cast<S*>(inv_param);
  a.s_uv = s_uv;
  a.s_mask = s_mask;
  a.s_slot = s_slot;
  a.s_nobs = s_nobs;
  a.s_R = s_R;
  a.s_t = s_t;
  a.s_p = s_p;
  a.B = B;
  a.F = F;
  a.nt = T;
  a.ncam = ncam;
  a.iters = iters;
  a.huber = huber;
  a.damping = damping;
  return launch<S>(a, device, stream);
}

}  // namespace

// B rows of F features in one launch; the arguments as Args above, the
// batch strides in elements. As in the plain version's indexing, each slot
// lies in [0, ncam) and n_obs is at most T; huber and damping are taken in
// float64, the arithmetic's type.
#define TRIANGULATE_ENTRY(name, S)                                            \
  extern "C" int name(                                                        \
      const void* uv, const void* mask, const void* slot, const void* n_obs,  \
      const void* R, const void* t, const void* p_init, void* p_anchor,       \
      void* p_world, void* anchor_slot, void* valid, void* inv_param,         \
      long long s_uv, long long s_mask, long long s_slot, long long s_nobs,   \
      long long s_R, long long s_t, long long s_p, int B, int F, int T,       \
      int ncam, double huber, int iters, double damping, int device,          \
      void* stream) {                                                         \
    return entry<S>(uv, mask, slot, n_obs, R, t, p_init, p_anchor, p_world,   \
                    anchor_slot, valid, inv_param, s_uv, s_mask, s_slot,      \
                    s_nobs, s_R, s_t, s_p, B, F, T, ncam, huber, iters,       \
                    damping, device, stream);                                 \
  }

TRIANGULATE_ENTRY(triangulate_f32, float)
TRIANGULATE_ENTRY(triangulate_f64, double)
