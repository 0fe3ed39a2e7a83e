// Kernel K4: the EKF covariance update out = sym(P - K HP), for sm_90a.
//
// Replaces orcvio_tpu/ops/cov_update.py:cov_update_pallas (_cov_kernel), the
// TPU kernel that forms, for each 128x128 output tile (i, j),
// A_ij = P_ij - K_i (HP)_j and A_ji^T, and writes 0.5 (A_ij + A_ji^T).
// HP = H P is an input: apply_ekf_update forms it for S and K before the
// covariance step, so this kernel does the K HP products and the
// symmetrization.
//
//   P (D, D), K (D, q), HP (q, D), out (D, D), row-major, float or double.
//
// The batched entry (many filters on one card: torch.func.vmap of the
// single-stream step) runs B such updates in one launch: the grid gains
// the batch (blockIdx.y of the cluster kernel, blockIdx.z of the small
// one) and each row's P, K and HP are reached through a batch stride, 0
// for an operand the rows share; out is (B, D, D). nb is one value for
// the batch. Within a row the arithmetic is the single launch's, so a row
// equals its single launch bit for bit.
//
// The nb entry (the Schmidt update, nb = D - 6 nuisance_cap): the entries
// whose row and column are both >= nb keep 0.5 (P(r, c) + P(c, r)), which
// is P itself for a symmetric P; every other entry is as above. A tile
// pair wholly inside [nb, D)^2 skips its q loop; a tile that straddles nb
// masks its products entry by entry. nb = D is the plain update.
//
// Bound: operations. With HP given the function does 2 D^2 q FLOP on
// (2 D^2 + 2 D q) elements in and out: at the bench's D = 172, q = 444,
// 26 MFLOP against 0.85 MB, 0.39 us at the FP32 (or FP64 tensor-core) peak
// against 0.25 us of memory. At that size the kernel is bound by latency
// and by how fast one SM can pull its operands from L2, so the design
// spreads the work over many SMs and keeps dependent chains short:
//
// - Triangular tiling: one 32x32 tile pair (bi <= bj) per cluster. An
//   off-diagonal pair forms A_ij = K_i HP_j and A_ji = K_j HP_i and stores
//   one value, 0.5 ((P_ij - A_ij) + (P_ji - A_ji)^T), at (i, j) and at
//   (j, i): half the products of a square walk, and the output is exactly
//   symmetric because one value is stored twice. A diagonal tile forms
//   A_ii once; its (r, c) and (c, r) add the same two numbers.
// - The products on the tensor cores in FP64 (mma.sync m16n8k4 .f64, DMMA;
//   wgmma has no f64). K and HP are staged in their own type and widened
//   to f64 exactly as the fragments are loaded; the sums run in f64 and
//   the result is rounded once to the element type. No TF32 anywhere: the
//   error is below the plain FP32 version's. The float64 instance is the
//   same code.
// - Split-K over q across a thread-block cluster of up to 4 CTAs, chosen
//   at launch so that each gets at least 2 chunks of 32 (4 at q = 384 and
//   444). Each CTA sums its share of q into a 32x32 f64
//   partial per product and leaves it in its shared memory; then rank r
//   finishes rows [r 32 / cs, (r + 1) 32 / cs) of the tile, adding every
//   rank's partial through distributed shared memory in rank order. One
//   launch, deterministic, no workspace, no atomics. The P entries a rank
//   finishes are read before its q loop, which hides their latency.
// - Staging: K rows and HP columns of both tiles, 32 of q at a time, with
//   cp.async (16 bytes a copy where rows allow), 3 stages in float32 (58
//   KB) and 2 in float64 (78 KB), shared memory opted into above the
//   default 48 KB: the q loop waits on copies from L2, and fewer, larger
//   chunks with more of them in flight wait less. Ragged D and q are
//   zero-filled in the copies and bounded in the store. Nothing is padded
//   in memory.
// - 8 warps per CTA: warp w owns a 16x8 block of both products, one DMMA
//   tile in each; twice the warps of one per 16x16 block, so that each SM
//   has twice the copies, and the epilogue's loads, in flight.
// - q <= 32 (the ZUPT update, q = 9) takes a kernel of its own: there the
//   tiled kernel would be one chunk on 21 CTAs, with its copies, the
//   partials' round trip through shared memory and a 4-element epilogue a
//   thread in series for little work. The small kernel walks every 16x16
//   tile (121 blocks at D = 172), stages the K rows and HP columns of its
//   row and column tiles in f64 once, and each thread forms its (r, c)
//   and (c, r) sums with f64 FMAs and stores its own entry: the thread of
//   (c, r) adds the same two sums, so the output is exactly symmetric,
//   with one rounding at the end and coalesced stores only.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "phases.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;    // output tile edge
constexpr int kChunk = 32;   // q per stage
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 4;
constexpr int kMinChunks = 2;        // chunks a cluster rank gets at least
constexpr int kKPitch = kChunk + 4;  // K rows: 16-byte rows, and the A
constexpr int kHPitch = kTile + 8;   // and B fragments free of conflicts
constexpr int kPad = kTile + 1;
// output elements a thread finishes, at most (a cluster of 1)
constexpr int kMaxPer = kTile * kTile / kThreads;

// which operands may be copied 16 bytes at a time (rows whole multiples of
// 16 bytes, base 16-byte aligned); the others go element by element
constexpr int kVecK = 1, kVecHP = 2;

template <typename T>
struct Stage {
  T k[2][kTile][kKPitch];    // K rows of tile i (0) and tile j (1)
  T hp[2][kChunk][kHPitch];  // HP columns of tile i (0) and tile j (1)
};

// After the q loop the staging ring holds this CTA's f64 partials,
// K_i HP_j (0) and K_j HP_i (1).
using Partial = double[2][kTile][kPad];

// stages in the ring: float32's fit three in 58 KB, float64's two in 78 KB
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 4 ? 3 : 2;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(Stage<T>) * stages<T>() > sizeof(Partial)
             ? sizeof(Stage<T>) * stages<T>()
             : sizeof(Partial);
}

// c (16x8) += a (16x4) b (4x8) in f64 on the tensor cores (sm_90's DMMA
// shape); the fragments' layout is the PTX ISA's for m16n8k4 .f64.
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[2],
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// One element, or 16 bytes, copied; zero-filled where `in` is false (no
// bytes are read then).
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? (int)sizeof(T) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)), "r"(n));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a rows x cols block of a row-major (.., ld) matrix at (r0, c0) into
// a tile of row pitch `pitch`, zero past (nr, nc), 16 bytes at a time where
// `vec` (then ld, c0 and cols are whole 16-byte multiples).
template <typename T, int kRows, int kCols>
__device__ __forceinline__ void copy_block(T* tile, int pitch, const T* m,
                                           int ld, int r0, int c0, int nr,
                                           int nc, bool vec) {
  if (vec) {
    constexpr int W = 16 / sizeof(T);
    constexpr int V = kCols / W;
    for (int e = threadIdx.x; e < kRows * V; e += kThreads) {
      const int row = e / V, c = (e - row * V) * W;
      const bool in = r0 + row < nr && c0 + c < nc;
      cp_async16(tile + row * pitch + c,
                 in ? m + (size_t)(r0 + row) * ld + c0 + c : m, in);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int row = e / kCols, c = e - row * kCols;
      const bool in = r0 + row < nr && c0 + c < nc;
      cp_async(tile + row * pitch + c,
               in ? m + (size_t)(r0 + row) * ld + c0 + c : m, in);
    }
  }
}

// Stage q columns [k0, k0 + kChunk) of the K rows and HP columns of the
// tiles at rows/columns i0 and j0, as one commit group.
template <typename T>
__device__ __forceinline__ void load_stage(Stage<T>& st, const T* K,
                                           const T* HP, int D, int q, int i0,
                                           int j0, int k0, int vec) {
  for (int w = 0; w < 2; ++w) {
    const int g = w ? j0 : i0;
    copy_block<T, kTile, kChunk>(&st.k[w][0][0], kKPitch, K, q, g, k0, D, q,
                                 vec & kVecK);
    copy_block<T, kChunk, kTile>(&st.hp[w][0][0], kHPitch, HP, D, k0, g, q,
                                 D, vec & kVecHP);
  }
  cp_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cov_update_kernel(const T* __restrict__ P, const T* __restrict__ K,
                  const T* __restrict__ HP, T* __restrict__ out, int D, int q,
                  int nb, int nt, int vec, long long sP, long long sK,
                  long long sHP) {
  constexpr int kStages = stages<T>();
  // this block's row of the batch
  P += blockIdx.y * sP;
  K += blockIdx.y * sK;
  HP += blockIdx.y * sHP;
  out += blockIdx.y * (long long)D * D;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem);
  Partial& part = *reinterpret_cast<Partial*>(smem);
  PHASE(t0);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // upper-triangle tile pair (bi <= bj) of this cluster
  int t = blockIdx.x / cs, bi = 0;
  while (t >= nt - bi) {
    t -= nt - bi;
    ++bi;
  }
  const int bj = bi + t;
  const bool diag = bi == bj;
  const int i0 = bi * kTile, j0 = bj * kTile;

  // this rank's share of q, in whole chunks; none in a tile pair wholly
  // inside the kept block (i0 <= j0, so i0 >= nb puts both there)
  const int nch = (q + kChunk - 1) / kChunk;
  const int c_lo = (int)((long long)nch * rank / cs);
  const int mine =
      i0 >= nb ? 0 : (int)((long long)nch * (rank + 1) / cs) - c_lo;

  // warp w owns the 16x8 block (wr, wc) of both products, one DMMA tile
  // each; lane (g, tg) holds rows wr + g and wr + g + 8
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = (warp >> 2) * 16, wc = (warp & 3) * 8;
  double acc[2][4] = {};  // [product][fragment]

  // rank r finishes rows [lo, hi) of the (i, j) tile; its P entries at
  // (r, c) and (c, r) are loaded now, so that their latency (the second
  // read is strided) passes under the q loop
  const int lo = kTile * rank / cs, hi = kTile * (rank + 1) / cs;
  T p_rc[kMaxPer], p_cr[kMaxPer];
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const int R = i0 + lo + e / kTile, C = j0 + e % kTile;
    const bool in = lo + e / kTile < hi && R < D && C < D;
    p_rc[m] = in ? P[(size_t)R * D + C] : T(0);
    p_cr[m] = in ? P[(size_t)C * D + R] : T(0);
  }

  // kStages - 1 chunks in flight ahead of the one being multiplied
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine)
      load_stage(ring[s], K, HP, D, q, i0, j0, (c_lo + s) * kChunk, vec);
    else
      cp_commit();
  }
  for (int c = 0; c < mine; ++c) {
    const int ahead = c + kStages - 1;
    if (ahead < mine)
      load_stage(ring[ahead % kStages], K, HP, D, q, i0, j0,
                 (c_lo + ahead) * kChunk, vec);
    else
      cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const Stage<T>& st = ring[c % kStages];
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      const double ai[2] = {(double)st.k[0][wr + g][kk + tg],
                            (double)st.k[0][wr + g + 8][kk + tg]};
      dmma(acc[0], ai, (double)st.hp[1][kk + tg][wc + g]);
      if (!diag) {
        const double aj[2] = {(double)st.k[1][wr + g][kk + tg],
                              (double)st.k[1][wr + g + 8][kk + tg]};
        dmma(acc[1], aj, (double)st.hp[0][kk + tg][wc + g]);
      }
    }
    __syncthreads();  // the stage is free for the next copy
  }
  cp_wait<0>();
  PHASE(t1);

  // the partials to this CTA's shared memory: fragment e at
  // (wr + g + 8 (e / 2), wc + 2 tg + e % 2)
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[p][wr + g + 8 * (e >> 1)][wc + 2 * tg + (e & 1)] = acc[p][e];
  cluster.sync();
  PHASE(t2);

  // rank r finishes its rows: every rank's partials added in rank order
  // (so a diagonal tile's (r, c) and (c, r), finished by two ranks, add the
  // same numbers), one rounding to T, the value stored at (i, j) and at
  // (j, i). All the remote reads of an entry are issued before its sums.
  const int pj = diag ? 0 : 1;  // the product that holds A_ji
  const Partial* src[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k)
    src[k] = k >= cs ? &part
                     : (k == rank ? &part : cluster.map_shared_rank(&part, k));
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const int rr = lo + e / kTile, cc = e % kTile;
    const int R = i0 + rr, C = j0 + cc;
    if (rr < hi && R < D && C < D) {
      double v_rc[kMaxCluster], v_cr[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        v_rc[k] = k < cs ? (*src[k])[0][rr][cc] : 0.0;
        v_cr[k] = k < cs ? (*src[k])[pj][cc][rr] : 0.0;
      }
      double a_rc = 0.0, a_cr = 0.0;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < cs) {
          a_rc += v_rc[k];
          a_cr += v_cr[k];
        }
      }
      if (R >= nb && C >= nb) a_rc = a_cr = 0.0;  // the kept block
      const T v = (T)(0.5 * (((double)p_rc[m] - a_rc) +
                             ((double)p_cr[m] - a_cr)));
      out[(size_t)R * D + C] = v;
      if (!diag) out[(size_t)C * D + R] = v;
    }
  }
  PHASE(t3);
  cluster.sync();  // every rank keeps its partials until all have read them
#ifdef KPHASES
  if (threadIdx.x == 0 && blockIdx.y == 0) {  // the batch's first row
    PHASE(t4);
    long long* s = g_phase[blockIdx.x];
    s[0] = t1 - t0;  // q loop: copies and DMMA
    s[1] = t2 - t1;  // partials stored, cluster barrier
    s[2] = t3 - t2;  // every rank's partials added, output stored
    s[3] = t4 - t3;  // closing cluster barrier
    s[4] = t4 - t0;
    s[5] = rank;
  }
#endif
}

constexpr int kSmall = 16;  // the small kernel's tile edge
constexpr int kSmallThreads = kSmall * kSmall;

// q <= kChunk: thread (ty, tx) of tile (blockIdx.y, blockIdx.x) forms
// A(r, c) and A(c, r) for r = 16 blockIdx.y + ty, c = 16 blockIdx.x + tx
// and stores out(r, c). The thread of (c, r) forms the same two sums, each
// in the same order, and adds them in the other order, which is exact to
// swap, so both entries get the same value.
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
cov_update_small_kernel(const T* __restrict__ P, const T* __restrict__ K,
                        const T* __restrict__ HP, T* __restrict__ out, int D,
                        int q, int nb, long long sP, long long sK,
                        long long sHP) {
  P += blockIdx.z * sP;  // this block's row of the batch
  K += blockIdx.z * sK;
  HP += blockIdx.z * sHP;
  out += blockIdx.z * (long long)D * D;
  __shared__ double ks[2][kSmall][kChunk + 1];   // K rows of tiles i, j
  __shared__ double hs[2][kChunk][kSmall + 1];   // HP columns of tiles i, j
  const int i0 = blockIdx.y * kSmall, j0 = blockIdx.x * kSmall;
  const int tx = threadIdx.x % kSmall, ty = threadIdx.x / kSmall;
  const int R = i0 + ty, C = j0 + tx;
  const bool in = R < D && C < D;
  const T p_rc = in ? P[(size_t)R * D + C] : T(0);
  const T p_cr = in ? P[(size_t)C * D + R] : T(0);
  // a tile wholly inside the kept block stages and sums nothing
  const int qs = i0 < nb || j0 < nb ? q : 0;
  // 2 x 16 x q of each operand, at most 4 elements a thread
#pragma unroll
  for (int m = 0; m < 2 * kSmall * kChunk / kSmallThreads; ++m) {
    const int e = threadIdx.x + m * kSmallThreads;
    const int w = e / (kSmall * kChunk), f = e % (kSmall * kChunk);
    const int g = w ? j0 : i0;
    const int row = f / kChunk, k = f % kChunk;  // K: row of the tile, k
    if (k < qs)
      ks[w][row][k] = g + row < D ? (double)K[(size_t)(g + row) * q + k] : 0.0;
    const int kh = f / kSmall, col = f % kSmall;  // HP: k, column of the tile
    if (kh < qs)
      hs[w][kh][col] = g + col < D ? (double)HP[(size_t)kh * D + g + col] : 0.0;
  }
  __syncthreads();
  double a_rc = 0.0, a_cr = 0.0;
  for (int k = 0; k < qs; ++k) {
    a_rc = fma(ks[0][ty][k], hs[1][k][tx], a_rc);
    a_cr = fma(ks[1][tx][k], hs[0][k][ty], a_cr);
  }
  if (R >= nb && C >= nb) a_rc = a_cr = 0.0;  // the kept block
  if (in)
    out[(size_t)R * D + C] =
        (T)(0.5 * (((double)p_rc - a_rc) + ((double)p_cr - a_cr)));
}

// every row of the operand starts on a 16-byte boundary
template <typename T>
bool aligned16(const T* p, long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         stride * (long long)sizeof(T) % 16 == 0;
}

template <typename T>
int launch(const T* P, const T* K, const T* HP, T* out, int D, int q, int nb,
           int B, long long sP, long long sK, long long sHP, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D == 0 || B == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (q <= kChunk) {
    const int ns = (D + kSmall - 1) / kSmall;
    cov_update_small_kernel<T>
        <<<dim3(ns, ns, B), kSmallThreads, 0, (cudaStream_t)stream>>>(
            P, K, HP, out, D, q, nb, sP, sK, sHP);
    return (int)cudaGetLastError();
  }
  constexpr size_t bytes = smem_bytes<T>();
  static_assert(bytes <= 227 * 1024, "K4 fits an SM's shared memory");
  static bool opted[64] = {};  // per device: shared memory above 48 KB
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[device]) {
    err = cudaFuncSetAttribute(cov_update_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  constexpr int W = 16 / sizeof(T);
  const int vec = (q % W == 0 && aligned16(K, sK) ? kVecK : 0) |
                  (D % W == 0 && aligned16(HP, sHP) ? kVecHP : 0);
  const int nt = (D + kTile - 1) / kTile;
  const int nch = (q + kChunk - 1) / kChunk;
  int cs = nch / kMinChunks;
  cs = cs < 1 ? 1 : (cs > kMaxCluster ? kMaxCluster : cs);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt * (nt + 1) / 2 * cs, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cov_update_kernel<T>, P, K, HP, out, D, q,
                           nb, nt, vec, sP, sK, sHP);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cov_update_f32(const float* P, const float* K, const float* HP,
                              float* out, int D, int q, int nb, int device,
                              void* stream) {
  return launch<float>(P, K, HP, out, D, q, nb, 1, 0, 0, 0, device, stream);
}

extern "C" int cov_update_f64(const double* P, const double* K,
                              const double* HP, double* out, int D, int q,
                              int nb, int device, void* stream) {
  return launch<double>(P, K, HP, out, D, q, nb, 1, 0, 0, 0, device, stream);
}

// B updates in one launch: row b reads P + b sP, K + b sK, HP + b sHP
// (strides in elements, 0 for an operand the rows share) and writes
// out + b D D.
extern "C" int cov_update_batched_f32(const float* P, const float* K,
                                      const float* HP, float* out, int D,
                                      int q, int nb, int B, long long sP,
                                      long long sK, long long sHP, int device,
                                      void* stream) {
  return launch<float>(P, K, HP, out, D, q, nb, B, sP, sK, sHP, device,
                       stream);
}

extern "C" int cov_update_batched_f64(const double* P, const double* K,
                                      const double* HP, double* out, int D,
                                      int q, int nb, int B, long long sP,
                                      long long sK, long long sHP, int device,
                                      void* stream) {
  return launch<double>(P, K, HP, out, D, q, nb, B, sP, sK, sHP, device,
                        stream);
}
