// Kernels K2 and K3: Lucas-Kanade per feature over one pyramid level, fused,
// sm_90a. One kernel body, lk_kernel<NT, NTP, kGiven>, serves both.
//
// K2 (kGiven = false) replaces orcvio_tpu/ops/lk_pallas.py:lk_level_fused
// (_lk_level_kernel). Per feature:
//   template: a bilinear (P+2)^2 patch of image 0 at aux[0:2] - (r+1),
//     central differences inside it -> t, tgx, tgy on P^2 taps, the sums
//     a11, a12, a22 and det (det_safe = 1 where det <= 1e-6);
//   iterations over image 1 from aux[10:12], clamped to [aux[4:6],
//     aux[6:8]]: each tap is resampled, err*tgx and err*tgy are summed,
//     and the step (dx, dy) is clamped; a feature stops once its step norm
//     is <= eps or after `iters` steps;
//   residual: mean |I - T| at the final position.
// Output row: [lx, ly, residual, last step norm, det, steps taken, 0, 0].
//
// K3 (kGiven = true) replaces lk_iterate_fused (lk_pallas.py:244-287, its
// kernel _lk_kernel at :91), the iterate-only level behind
// frontend/klt.py:_lk_iterate_pallas: the template t, tgx, tgy (N, P, P)
// comes as input, a11 a12 a22 det_safe are aux[0:4] as given (the TPU
// kernel takes them so and recomputes nothing), and there are exactly
// `iters` steps: no eps stop, and a NaN step does not end the loop either,
// since the TPU kernel has no stop.
// Output row: [lx, ly, residual, last step norm, 0, 0, 0, 0].
//
// The TPU kernels resample through one-hot bf16 matrix products on a hi/lo
// split of the pixels, and K2's stops a block of features together; here
// each tap is an exact float32 bilinear interpolation and each K2 feature
// stops on its own (the TPU kernel's rule at block_n = 1, and
// cv::TermCriteria's).
//
// Sources. Each image is read as (base, row stride, per-feature element
// offset) within a logical (R, L) window: the window tensors of the
// JAX-shaped interface (offset n R L, stride L; lk_level, lk_iterate), or
// the padded pyramid level itself (offset 8 r0 Wp + 128 c0 from the window
// origins, stride Wp; lk_level_src, lk_iterate_src), so no window is ever
// written to device memory. corner() clamps into the same (R, L) window
// either way, so the two routes read the same pixels and give the same
// bits.
//
// Bound: what the function needs. Per feature K2 reads a (P+3)^2 block of
// image 0, K3 the template (3 P^2 floats), and both, of image 1, the union
// of the (P+1)^2 blocks at the positions they visit: some 1.3 KB to 6.8 KB
// a feature, against some 14 operations per tap per step on 225 taps; for
// 200 features well under a microsecond either way, bytes first
// (chip_smoke.py counts both from each run's data). So both kernels are
// latency-bound: their time is the slowest feature's chain of dependent
// tap reads and reductions. A block per feature that re-reads each step's
// taps from global memory, at a position that depends on the step before,
// and reduces across the block pays an L1/L2 round trip and two barriers
// a step (some 0.8 us a step on an H100). The design shortens that chain:
//
// - One warp per feature, 4 features per block of 128 threads (50 blocks
//   for 200 features, each on its own SM). Reductions are xor butterflies
//   of __shfl_xor_sync alone: no block barrier anywhere. The butterfly
//   leaves bit-identical sums on every lane, so every lane holds the same
//   position and the eps stop is uniform in the warp.
// - All the taps a feature can reach are staged once into shared memory
//   with cp.async: of image 1, the block from corner(lo - r) to
//   corner(hi - r) + P + 1 (36 x 36 at P = 15 and a 36 px search), and
//   for K2 the template's (P+3)^2 block of image 0. Every position is
//   clamped into [lo, hi] before its corner is taken (fminf/fmaxf, which
//   also take a NaN step to the bound), and corner() is monotone, so that
//   block holds every tap for any aux. The steps and the residual then
//   read shared memory only. The tile is sized statically (kSW); a
//   feature whose bounds need more, or whose window does not lie in its
//   source, gets NaN in columns 0-3 (K2: 0-4): the kernel never reads
//   outside what it staged or what it was given, and the tracker's
//   convergence gate (frontend/klt.py:_converged) reads a NaN row as not
//   converged. The tracker's search span (36 px) needs 37 of the tile's 40
//   pixels. The copies move 16 bytes each where the rows allow (widened to
//   whole multiples of 4 pixels), pixel by pixel otherwise. K2's template
//   block is a copy group of its own, so the template is built while the
//   second block is still in flight; K3 loads its given template while
//   the search block is in flight.
// - The template (t, tgx, tgy) and each tap's tile offset stay in
//   registers: NT taps per lane, NT = 8, 16 or 32 by P, lane l holding taps
//   l, l + 32, ... (K3's loads of them are coalesced). The tap loops have
//   no branches (spare slots are masked), so their loads overlap.

#include <cstdint>
#include <type_traits>

#include "lk_common.cuh"
#include "phases.cuh"

using namespace lk;

namespace {

constexpr int kFeatures = 4;                 // warps (features) per block
constexpr int kBlockThreads = 32 * kFeatures;
constexpr int kTBRows = kMaxP + 3;           // template block rows, 34
constexpr int kTB = 40;                      // its row pitch
constexpr int kSW = 40;                      // search tile edge and pitch

// One image as the kernel reads it: the (R, L) window of feature n starts
// at element off[n] of img (n R L where off is null), rows `stride`
// elements apart, `size` elements in all.
struct Src {
  const float* img;
  const long long* off;
  long long stride, size;
};

// K3's template, given: t, tgx, tgy, each (N, P, P).
struct Given {
  const float* t;
  const float* gx;
  const float* gy;
};

struct LevelTiles {         // K2
  float tb[kTBRows * kTB];  // image 0: the template's (P+3)^2 block
  float sw[kSW * kSW];      // image 1: every block the search can reach
};

struct SearchTile {         // K3: its template is in registers
  float sw[kSW * kSW];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Bilinear tap at p (the (0, 0) pixel of its 2x2 block) in a tile of row
// pitch `pitch`: a row lerp, then a column lerp, as the plain version
// (ops/lk_pallas.py:resample) computes it.
__device__ __forceinline__ float tap(const float* p, int pitch, float fy,
                                     float fx) {
  const float p00 = p[0], p01 = p[1];
  const float p10 = p[pitch], p11 = p[pitch + 1];
  const float r0 = p00 * (1.f - fy) + p10 * fy;
  const float r1 = p01 * (1.f - fy) + p11 * fy;
  return r0 * (1.f - fx) + r1 * fx;
}

// Copy rows x cols pixels at (y0, x0) of a source window into a tile of
// row pitch `pitch`, 16 bytes a copy where `vec` (x0, cols, stride and the
// source 16-byte aligned), else pixel by pixel. The lanes walk the block
// in row-major order without dividing.
__device__ __forceinline__ void stage(float* tile, int pitch, const float* src,
                                      long long stride, int y0, int x0,
                                      int rows, int cols, bool vec, int lane) {
  const int w = vec ? 4 : 1;
  const int V = cols / w;  // copies a row
  const int di = 32 / V, dv = 32 - di * V;
  int i = lane / V, v = lane - (lane / V) * V;
  while (i < rows) {
    float* d = tile + i * pitch + v * w;
    const float* s = src + (long long)(y0 + i) * stride + x0 + v * w;
    if (vec)
      cp_async16(d, s);
    else
      cp_async4(d, s);
    v += dv;
    i += di;
    if (v >= V) {
      v -= V;
      ++i;
    }
  }
}

__device__ __forceinline__ bool window_in(long long off, long long stride,
                                          long long size, int R, int L) {
  return off >= 0 && off + (long long)(R - 1) * stride + L <= size;
}

__device__ __forceinline__ long long window_off(const Src& s, int n, int R,
                                                int L) {
  return s.off ? s.off[n] : (long long)n * R * L;
}

template <int NT, int NTP, bool kGiven>
__global__ void __launch_bounds__(kBlockThreads)
lk_kernel(const Src s0, const Src s1, const Given g,
          const float* __restrict__ aux, float* __restrict__ out, int N,
          int R, int L, int P, int iters, float eps, bool vec_ok) {
  using Tiles = std::conditional_t<kGiven, SearchTile, LevelTiles>;
  __shared__ __align__(16) Tiles tiles[kFeatures];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kFeatures + warp;
  if (n >= N) return;  // the whole warp
  Tiles& ws = tiles[warp];
  PHASE(t0);
  const float* a = aux + (size_t)n * kAuxW;
  float* o = out + (size_t)n * 8;
  const int r = (P - 1) / 2;
  const int Pt = P + 2;
  const int PP = P * P;
  const long long o0 = kGiven ? 0 : window_off(s0, n, R, L);
  const long long o1 = window_off(s1, n, R, L);

  // the block of image 1 every clamped position can reach
  const float lo_x = a[4], lo_y = a[5], hi_x = a[6], hi_y = a[7];
  const Corner cl = corner(fminf(lo_x, hi_x) - r, fminf(lo_y, hi_y) - r, R, L, P);
  const Corner ch = corner(hi_x - r, hi_y - r, R, L, P);
  const int th = ch.iy - cl.iy + P + 1;
  const int tw = ch.ix - cl.ix + P + 1;
  // and K2's template (Pt+1)^2 block of image 0
  const Corner c0 = kGiven ? Corner{0, 0, 0.f, 0.f}
                           : corner(a[0] - (r + 1), a[1] - (r + 1), R, L, Pt);
  // 16-byte copies start each row at a multiple of 4 pixels at or left of
  // the block and end at one at or right of it, inside the window (L is a
  // multiple of 4 then)
  bool vec = vec_ok && ((o0 | o1) & 3) == 0;
  int sx = cl.ix, tx = c0.ix, s_cols = tw, t_cols = Pt + 1;
  if (vec) {
    sx = cl.ix & ~3;
    tx = c0.ix & ~3;
    s_cols = (cl.ix + tw - sx + 3) & ~3;
    t_cols = (c0.ix + Pt + 1 - tx + 3) & ~3;
    if (s_cols > kSW) {  // pixel by pixel, the block as it is
      vec = false;
      sx = cl.ix;
      tx = c0.ix;
      s_cols = tw;
      t_cols = Pt + 1;
    }
  }
  const bool fits = !(isnan(lo_x) || isnan(lo_y) || isnan(hi_x) || isnan(hi_y))
                    && th <= kSW && s_cols <= kSW
                    && window_in(o1, s1.stride, s1.size, R, L)
                    && (kGiven || window_in(o0, s0.stride, s0.size, R, L));
  if (!fits) {  // warp-uniform: every lane read the same aux
    if (lane == 0) {
      const int nan_cols = kGiven ? 4 : 5;  // K2's column 4 is det
      for (int k = 0; k < 8; ++k) o[k] = k < nan_cols ? NAN : 0.f;
    }
    return;
  }

  // The loops below give lane l the taps l, l + 32, ... of a row-major
  // patch, stepping (i, j) without dividing, and compute every slot
  // without branches (a slot past the patch reads a pixel inside it and
  // is masked), so that the scheduler can overlap their loads.
  float t[NT], gx[NT], gy[NT];
  int soff[NT];
  unsigned valid = 0;  // bit m: slot m is a tap of the patch
  float* tb = nullptr;
  PHASE(t1);
  if constexpr (kGiven) {
    // --- stage the search block; load the given template meanwhile ---
    stage(ws.sw, kSW, s1.img + o1, s1.stride, cl.iy, sx, th, s_cols, vec,
          lane);
    asm volatile("cp.async.commit_group;\n" ::);
    const size_t base = (size_t)n * PP;
    const int dj = 32 % P, di = 32 / P;
    int i = lane / P, j = lane - (lane / P) * P;
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      const bool in = i < P;
      const size_t k = base + (in ? i * P + j : 0);
      t[m] = in ? __ldg(g.t + k) : 0.f;
      gx[m] = in ? __ldg(g.gx + k) : 0.f;
      gy[m] = in ? __ldg(g.gy + k) : 0.f;
      soff[m] = (in ? i : 0) * kSW + j;
      valid |= (unsigned)in << m;
      j += dj;
      const bool wrap = j >= P;
      j = wrap ? j - P : j;
      i += di + wrap;
    }
#ifdef KPHASES
    // the next stamp waits for the template's loads
    float touch = 0.f;
#pragma unroll
    for (int m = 0; m < NT; ++m) touch += t[m] + gx[m] + gy[m];
    if (touch == 1.2345e-30f) o[7] = 0.f;
#endif
  } else {
    // --- stage both blocks; the template from the first while the second
    // is still in flight ---
    stage(ws.tb, kTB, s0.img + o0, s0.stride, c0.iy, tx, Pt + 1, t_cols, vec,
          lane);
    asm volatile("cp.async.commit_group;\n" ::);
    stage(ws.sw, kSW, s1.img + o1, s1.stride, cl.iy, sx, th, s_cols, vec,
          lane);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    tb = ws.tb + (c0.ix - tx);  // pixel (c0.iy, c0.ix) at tb[0]

    // the (P+2)^2 template patch tp, its bilinear taps, in place of the
    // block they were read from (taps kept in registers across the swap)
    float tpv[NTP];
    const int dj = 32 % Pt, di = 32 / Pt;
    int i = lane / Pt, j = lane - (lane / Pt) * Pt;
#pragma unroll
    for (int m = 0; m < NTP; ++m) {
      tpv[m] = tap(tb + min(i, Pt - 1) * kTB + j, kTB, c0.fy, c0.fx);
      j += dj;
      const bool wrap = j >= Pt;
      j = wrap ? j - Pt : j;
      i += di + wrap;
    }
    __syncwarp();
    i = lane / Pt;
    j = lane - (lane / Pt) * Pt;
#pragma unroll
    for (int m = 0; m < NTP; ++m) {
      if (i < Pt) tb[i * kTB + j] = tpv[m];
      j += dj;
      const bool wrap = j >= Pt;
      j = wrap ? j - Pt : j;
      i += di + wrap;
    }
    __syncwarp();
  }
  PHASE(t2);
  float a11, a12, a22, det, det_safe;
  if constexpr (kGiven) {
    a11 = a[0];
    a12 = a[1];
    a22 = a[2];
    det_safe = a[3];
    det = 0.f;  // not an output of K3
  } else {
    float h0 = 0.f, h1 = 0.f, h2 = 0.f;
    const int dj = 32 % P, di = 32 / P;
    int i = lane / P, j = lane - (lane / P) * P;
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      const bool in = i < P;
      const int ic = in ? i : 0;
      // central differences inside tp
      const float* p = tb + (ic + 1) * kTB + (j + 1);
      const float gxk = in ? 0.5f * (p[1] - p[-1]) : 0.f;
      const float gyk = in ? 0.5f * (p[kTB] - p[-kTB]) : 0.f;
      t[m] = in ? p[0] : 0.f;
      gx[m] = gxk;
      gy[m] = gyk;
      soff[m] = ic * kSW + j;
      valid |= (unsigned)in << m;
      h0 += gxk * gxk;
      h1 += gxk * gyk;
      h2 += gyk * gyk;
      j += dj;
      const bool wrap = j >= P;
      j = wrap ? j - P : j;
      i += di + wrap;
    }
    a11 = warp_sum(h0);
    a12 = warp_sum(h1);
    a22 = warp_sum(h2);
    det = a11 * a22 - a12 * a12;
    det_safe = det > 1e-6f ? det : 1.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  PHASE(t3);
  // --- Gauss-Newton over image 1, shared memory only: K2 stops per
  // feature, K3 takes exactly `iters` steps ---
  float lx = fminf(fmaxf(a[10], lo_x), hi_x);
  float ly = fminf(fmaxf(a[11], lo_y), hi_y);
  float dn = INFINITY;
  int it = 0;
  for (; it < iters && (kGiven || dn > eps); ++it) {
    const Corner c = corner(lx - r, ly - r, R, L, P);
    const float* base = ws.sw + (c.iy - cl.iy) * kSW + (c.ix - sx);
    float b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int m = 0; m < NT; ++m) {  // a masked slot adds 0 * err
      const float err = tap(base + soff[m], kSW, c.fy, c.fx) - t[m];
      b0 += gx[m] * err;
      b1 += gy[m] * err;
    }
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    const float dx = (a22 * b0 - a12 * b1) / det_safe;
    const float dy = (a11 * b1 - a12 * b0) / det_safe;
    lx = fminf(fmaxf(lx - dx, lo_x), hi_x);
    ly = fminf(fmaxf(ly - dy, lo_y), hi_y);
    dn = sqrtf(dx * dx + dy * dy);
  }

  PHASE(t4);
  // --- residual at the final position ---
  const Corner c = corner(lx - r, ly - r, R, L, P);
  const float* base = ws.sw + (c.iy - cl.iy) * kSW + (c.ix - sx);
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    const float e = fabsf(tap(base + soff[m], kSW, c.fy, c.fx) - t[m]);
    s += (valid >> m) & 1u ? e : 0.f;
  }
  s = warp_sum(s);
  if (lane == 0) {
    o[0] = lx;
    o[1] = ly;
    o[2] = s / (float)PP;
    o[3] = dn;
    o[4] = kGiven ? 0.f : det;
    o[5] = kGiven ? 0.f : (float)it;
    o[6] = 0.f;
    o[7] = 0.f;
  }
#ifdef KPHASES
  if (lane == 0) {
    PHASE(t5);
    long long* st = g_phase[n];
    st[0] = t1 - t0;  // aux and the tile bounds
    st[1] = t2 - t1;  // K2: template block copied, patch built; K3:
                      // search block issued, template loaded
    st[2] = t3 - t2;  // K2: gradients, Hessian; both: search block arrived
    st[3] = t4 - t3;  // Gauss-Newton steps
    st[4] = t5 - t4;  // residual, output
    st[5] = t5 - t0;
    st[6] = it;
  }
#endif
}

template <bool kGiven>
int launch(const Src& s0, const Src& s1, const Given& g, const float* aux,
           float* out, int N, int R, int L, int P, int iters, float eps,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  // the search needs P + 2 rows and columns, K2's template block P + 4
  const int margin = kGiven ? 2 : 4;
  if (P < 1 || P > kMaxP || R < P + margin || L < P + margin)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kFeatures - 1) / kFeatures);
  // rows that start 16-byte aligned in every source read (offsets checked
  // per feature in the kernel)
  auto aligned = [&](const Src& s) {
    return s.stride % 4 == 0 &&
           reinterpret_cast<uintptr_t>(s.img) % 16 == 0;
  };
  const bool vec = L % 4 == 0 && aligned(s1) && (kGiven || aligned(s0));
  const cudaStream_t s = (cudaStream_t)stream;
  if (P * P <= 8 * 32) {  // P <= 15: (P+2)^2 <= 289 tp taps
    lk_kernel<8, 10, kGiven><<<grid, kBlockThreads, 0, s>>>(
        s0, s1, g, aux, out, N, R, L, P, iters, eps, vec);
  } else if (P * P <= 16 * 32) {  // P <= 21: <= 529
    lk_kernel<16, 17, kGiven><<<grid, kBlockThreads, 0, s>>>(
        s0, s1, g, aux, out, N, R, L, P, iters, eps, vec);
  } else {  // P <= 31: <= 1089
    lk_kernel<32, 35, kGiven><<<grid, kBlockThreads, 0, s>>>(
        s0, s1, g, aux, out, N, R, L, P, iters, eps, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2 over the window tensors win0, win1 (N, R, L) of the JAX-shaped
// interface.
extern "C" int lk_level(const float* win0, const float* win1, const float* aux,
                        float* out, int N, int R, int L, int P, int iters,
                        float eps, int device, void* stream) {
  const long long size = (long long)N * R * L;
  return launch<false>(Src{win0, nullptr, L, size},
                       Src{win1, nullptr, L, size}, Given{}, aux, out, N, R,
                       L, P, iters, eps, device, stream);
}

// K2 over (R, L) windows read in place from two images: window n of image
// k starts at element off_k[n] of img_k (size_k elements), rows stride_k
// elements apart.
extern "C" int lk_level_src(const float* img0, const long long* off0,
                            long long stride0, long long size0,
                            const float* img1, const long long* off1,
                            long long stride1, long long size1,
                            const float* aux, float* out, int N, int R, int L,
                            int P, int iters, float eps, int device,
                            void* stream) {
  return launch<false>(Src{img0, off0, stride0, size0},
                       Src{img1, off1, stride1, size1}, Given{}, aux, out, N,
                       R, L, P, iters, eps, device, stream);
}

// K3 over the window tensor win (N, R, L), template t, tgx, tgy (N, P, P).
extern "C" int lk_iterate(const float* win, const float* t, const float* tgx,
                          const float* tgy, const float* aux, float* out,
                          int N, int R, int L, int P, int iters, int device,
                          void* stream) {
  const Src s{win, nullptr, L, (long long)N * R * L};
  return launch<true>(s, s, Given{t, tgx, tgy}, aux, out, N, R, L, P, iters,
                      0.f, device, stream);
}

// K3 over (R, L) windows read in place from img: window n starts at
// element off[n] (size elements), rows stride elements apart.
extern "C" int lk_iterate_src(const float* img, const long long* off,
                              long long stride, long long size,
                              const float* t, const float* tgx,
                              const float* tgy, const float* aux, float* out,
                              int N, int R, int L, int P, int iters,
                              int device, void* stream) {
  const Src s{img, off, stride, size};
  return launch<true>(s, s, Given{t, tgx, tgy}, aux, out, N, R, L, P, iters,
                      0.f, device, stream);
}
