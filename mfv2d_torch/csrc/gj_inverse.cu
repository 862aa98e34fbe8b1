// Batched inverse of [E, n, n] matrices by Gauss-Jordan elimination with
// partial pivoting, on Hopper.
//
// Replaces the Pallas TPU kernel gj_inverse_pallas / _gj_kernel
// (mfv2d_tpu/ops/pallas_factor.py).  That kernel runs a blocked Jordan sweep
// WITHOUT pivoting in f32, padded to a multiple of 128 with an identity tail,
// four matrices resident in VMEM per grid step; its caller repairs the seed
// with Newton-Schulz and a host fallback.  Here the inverse is the f64 answer
// itself, so the sweep pivots: the element blocks of the hybridized saddle
// systems have zero diagonal entries (the Navier-Stokes block has an all-zero
// pressure-pressure block), which an unpivoted sweep divides by.
//
// Algorithm, for one matrix W (in place):
//   for k = 0 .. n-1:
//     p = argmax_{i >= k} |W[i,k]|  (block-wide reduction; ties take the
//         smaller row; NaN ranks as +inf so that it is caught below)
//     a zero or non-finite pivot: info = k+1, stop
//     swap rows k and p; perm[k] = p
//     row = W[k,:] / W[k,k], with row[k] = 1 / W[k,k]
//     W[k,:] = row;  W[i,:] = W[i,:] - W[i,k] row (i != k, W[i,k] taken as 0)
//   then swap columns k and perm[k] for k = n-1 .. 0 (the row swaps of
//   (P A)^{-1} become column swaps of A^{-1}).
// Any n >= 1 and any E: no padding, no tile rule, no atomics, so the result
// is deterministic.
//
// What bounds it.  2 n^3 flops per matrix and 2 n^2 values of HBM traffic.
// E = 4096, n = 56 (mixed Poisson, p = 4), f64: 1.44 GFLOP and 2 x 103 MB.
// E = 4096, n = 208 (p = 8): 73.7 GFLOP and 2 x 1.42 GB, compute-bound:
// 1.10 ms at the 67 TFLOP/s FP64 tensor-core peak, 2.17 ms at the 34 TFLOP/s
// FP64 vector peak that CUDA-core FMAs reach at most (NVIDIA data sheet,
// H100 SXM).  The unblocked sweep is a chain of n block-wide barriers, each
// step a pivot reduction and a rank-1 update of the whole matrix.
//
// Design.  One thread block per matrix; the route depends on n and on the
// opted-in dynamic shared memory (227 KB on the H100):
//   - Shared route (n <= 169 in f64, 239 in f32): the matrix is loaded once,
//     swept in shared memory by the unblocked body and stored once, so HBM
//     sees one read and one write.  Bound by the n barriers and by the
//     shared-memory traffic of n rank-1 updates of n^2 entries.  Covers the
//     n = 56 and n = 121 element blocks.
//   - Blocked route (n <= 439 in f64, 512 in f32): panels of kPanel = 32
//     columns.  Each thread holds one panel row (two where n > 256) in
//     registers and the block sweeps the n x 32 panel with the same pivoting,
//     two barriers a step: one for the pivot's partial maxima, one for the
//     scaled pivot row.  The panel then holds M = [A_KK^-1 ; -A_OK A_KK^-1]
//     (K: the 32 pivot rows, O: the others), the inverse's columns of that
//     panel.  Every other 32-wide column tile is loaded into shared memory
//     with the panel's row swaps applied as a gather of row indices (nothing
//     is swapped in global memory) and updated by a rank-32 product,
//     C'[i] = (i in K ? 0 : C[i]) + sum_t M[i,t] C[k0+t], from 4x4 register
//     tiles of FP64 FMAs.  The matrix then crosses L2/HBM ceil(n/32) times,
//     plus once to undo the swaps, instead of n times: about 23 GB instead of
//     590 GB at n = 208, E = 4096, which is at least 6.8 ms at 3.35 TB/s, so
//     these passes bound the route, and the n pivot steps, each a chain of
//     shuffles, barriers and a division, come second.  Two blocks of 110 KB
//     share an SM at n <= 256, one above.  Covers the p = 8 blocks (n = 208,
//     289).
//   - Global route (above that): the unblocked body in place on the output
//     in global memory, with only the pivot row and column staged in shared
//     memory; each of the n steps rewrites the whole matrix through L2 or
//     HBM.  Kept so that no n fails; no element block of the repo's models
//     takes it.
// The row swaps of the blocked and global routes are undone as column swaps
// at the end.  DMMA (mma.sync.m8n8k4.f64) with cp.async or TMA staging for
// the blocked route's update, and fewer passes over the matrix, are left to
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; the C entry points below are loaded with ctypes.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;
// Entries of the matrix per thread that decide the block size.
constexpr int kEntriesPerThread = 8;

// Blocked route: panel width (and column-tile width), threads per block, and
// the update's thread layout: 8 threads across a tile's 32 columns and 32
// down its rows, each thread holding a 4 x 4 register tile of outputs.
constexpr int kPanel = 32;
constexpr int kPanelStride = kPanel + 1;  // padded: a warp's 4 rows hit distinct banks
constexpr int kBlockedThreads = 256;
constexpr int kBlockedWarps = kBlockedThreads / kWarp;
constexpr int kTileColThreads = 8;
constexpr int kTileRowThreads = kBlockedThreads / kTileColThreads;
constexpr int kColsPerThread = kPanel / kTileColThreads;
constexpr int kRowsPerThread = 4;
constexpr int kRowChunk = kTileRowThreads * kRowsPerThread;
// Global loads each thread keeps in flight when it fills a tile.
constexpr int kBatch = 16;
// Panel rows a thread holds in registers: the route takes n <= 512.
constexpr int kMaxBlockedRows = 2;

enum Route : int { kSharedRoute = 0, kBlockedRoute = 1, kGlobalRoute = 2 };

// Pivot ranking key: |x|, with NaN ranked as +inf so that a NaN column is
// picked and reported rather than skipped.
__device__ inline double pivot_key(double x) { return x != x ? INFINITY : fabs(x); }
__device__ inline float pivot_key(float x) { return x != x ? INFINITY : fabsf(x); }

__device__ inline double fused_mul_add(double a, double b, double c) { return fma(a, b, c); }
__device__ inline float fused_mul_add(float a, float b, float c) { return fmaf(a, b, c); }

template <typename T>
size_t scratch_bytes(int n) {
  // pivot row and column, the reduction slots, the row permutation
  return (2 * static_cast<size_t>(n) + kMaxWarps) * sizeof(T) +
         (kMaxWarps + static_cast<size_t>(n)) * sizeof(int);
}

template <typename T>
size_t shared_route_bytes(int n) {
  return static_cast<size_t>(n) * n * sizeof(T) + scratch_bytes<T>(n);
}

template <typename T>
size_t blocked_route_bytes(int n) {
  const size_t m = static_cast<size_t>(n);
  // panel, tile, pivot row, old row k and reduction keys; the reduction
  // rows, the pivot rows and the row gather
  return (m * kPanelStride + m * kPanel + 2 * kPanel + kBlockedWarps) * sizeof(T) +
         (kBlockedWarps + 2 * m) * sizeof(int);
}

int block_threads(int n) {
  const long long want = (static_cast<long long>(n) * n + kEntriesPerThread - 1) / kEntriesPerThread;
  long long t = (want + kWarp - 1) / kWarp * kWarp;
  if (t < kWarp) t = kWarp;
  if (t > kMaxThreads) t = kMaxThreads;
  return static_cast<int>(t);
}

// Keep the larger key; on a tie the smaller row.
template <typename T>
__device__ inline void take_max(T& key, int& idx, T other_key, int other_idx) {
  if (other_key > key || (other_key == key && other_idx < idx)) {
    key = other_key;
    idx = other_idx;
  }
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
gj_inverse_kernel(const T* __restrict__ a, T* __restrict__ out, int* __restrict__ info,
                  int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_pivot_row;
  __shared__ int s_bad;

  const long long nn = static_cast<long long>(n) * n;
  const long long e = blockIdx.x;
  const T* src = a + e * nn;
  T* dst = out + e * nn;

  T* w_shared = reinterpret_cast<T*>(smem_raw);
  T* row = w_shared + (kShared ? nn : 0);  // scaled pivot row
  T* col = row + n;                        // pivot column, rows k and p exchanged
  T* red_key = col + n;
  int* red_idx = reinterpret_cast<int*>(red_key + kMaxWarps);
  int* perm = red_idx + kMaxWarps;
  T* w = kShared ? w_shared : dst;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx;
  const int n_threads = blockDim.x * blockDim.y;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_warps = n_threads / kWarp;

  for (long long i = tid; i < nn; i += n_threads) w[i] = src[i];
  __syncthreads();

  int failed_at = 0;
  for (int k = 0; k < n; ++k) {
    // Pivot: the largest |W[i,k]| over rows i >= k.
    T key = T(-1);
    int idx = n;
    for (int i = k + tid; i < n; i += n_threads) {
      take_max(key, idx, pivot_key(w[static_cast<long long>(i) * n + k]), i);
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const T other_key = __shfl_down_sync(0xffffffffu, key, off);
      const int other_idx = __shfl_down_sync(0xffffffffu, idx, off);
      take_max(key, idx, other_key, other_idx);
    }
    if (lane == 0) {
      red_key[warp] = key;
      red_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      key = lane < n_warps ? red_key[lane] : T(-1);
      idx = lane < n_warps ? red_idx[lane] : n;
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const T other_key = __shfl_down_sync(0xffffffffu, key, off);
        const int other_idx = __shfl_down_sync(0xffffffffu, idx, off);
        take_max(key, idx, other_key, other_idx);
      }
      if (lane == 0) {
        s_pivot_row = idx;
        s_bad = !(key > T(0) && key < T(INFINITY));
        perm[k] = idx;
      }
    }
    __syncthreads();
    if (s_bad) {  // uniform across the block
      failed_at = k + 1;
      break;
    }
    const int p = s_pivot_row;
    const T inv_pivot = T(1) / w[static_cast<long long>(p) * n + k];

    // Stage the scaled pivot row (old row p) and column k as it reads after
    // the swap; nothing is written to W yet.
    for (int j = tid; j < n; j += n_threads) {
      const T v = w[static_cast<long long>(p) * n + j];
      row[j] = j == k ? inv_pivot : v * inv_pivot;
      const int from = j == k ? p : (j == p ? k : j);
      col[j] = w[static_cast<long long>(from) * n + k];
    }
    __syncthreads();
    if (p != k) {  // the other half of the swap: old row k moves to row p
      for (int j = tid; j < n; j += n_threads) {
        w[static_cast<long long>(p) * n + j] = w[static_cast<long long>(k) * n + j];
      }
      __syncthreads();
    }
    // Rank-1 update; every entry is read and written by its own thread.
    for (int i = ty; i < n; i += blockDim.y) {
      T* wi = w + static_cast<long long>(i) * n;
      if (i == k) {
        for (int j = tx; j < n; j += blockDim.x) wi[j] = row[j];
      } else {
        const T ci = col[i];
        for (int j = tx; j < n; j += blockDim.x) {
          const T base = j == k ? T(0) : wi[j];
          wi[j] = fused_mul_add(-ci, row[j], base);
        }
      }
    }
    __syncthreads();
  }

  if (failed_at != 0) {
    if (tid == 0) info[e] = failed_at;
    return;
  }
  // Undo the row swaps as column swaps, last first; each thread owns rows.
  for (int i = tid; i < n; i += n_threads) {
    T* wi = w + static_cast<long long>(i) * n;
    for (int k = n - 1; k >= 0; --k) {
      const int pk = perm[k];
      if (pk != k) {
        const T t = wi[k];
        wi[k] = wi[pk];
        wi[pk] = t;
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (long long i = tid; i < nn; i += n_threads) dst[i] = w[i];
  }
  if (tid == 0) info[e] = 0;
}

// Loads columns [j0, j0 + width) of the n x n matrix m into the n x kPanel
// shared array `to` (row stride `stride`); row i is read from row gather[i]
// of m, or from row i where gather is null.  Each thread keeps kBatch
// loads in flight; the loads are explicitly global (ld.global.cg, coherent
// in L2), so the compiler may issue them ahead of the shared stores.
template <typename T>
__device__ void load_columns(const T* m, int n, int j0, int width, const int* gather, T* to,
                             int stride) {
  const int total = n * kPanel;
  for (int first = threadIdx.x; first < total; first += kBlockedThreads * kBatch) {
    T buf[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = first + b * kBlockedThreads;
      const int j = idx % kPanel;
      buf[b] = T(0);
      if (idx < total && j < width) {
        const int i = gather ? gather[idx / kPanel] : idx / kPanel;
        buf[b] = __ldcg(m + static_cast<long long>(i) * n + j0 + j);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = first + b * kBlockedThreads;
      if (idx < total) to[idx / kPanel * stride + idx % kPanel] = buf[b];
    }
  }
}

// v[t] for a runtime t without indexing registers dynamically: a select
// tree on the bits of t, five selects deep.
template <typename T>
__device__ inline T pick(const T (&v)[kPanel], int t) {
  static_assert(kPanel == 32, "the select tree is five levels deep");
  T l16[16], l8[8], l4[4], l2[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) l16[i] = t & 1 ? v[2 * i + 1] : v[2 * i];
#pragma unroll
  for (int i = 0; i < 8; ++i) l8[i] = t & 2 ? l16[2 * i + 1] : l16[2 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) l4[i] = t & 4 ? l8[2 * i + 1] : l8[2 * i];
#pragma unroll
  for (int i = 0; i < 2; ++i) l2[i] = t & 8 ? l4[2 * i + 1] : l4[2 * i];
  return t & 16 ? l2[1] : l2[0];
}

// Blocked route (see the design note), one block of kBlockedThreads threads
// per matrix; thread tid holds panel rows tid + q kBlockedThreads (q <
// kRows) in registers during the panel sweep.  Pass k0 sweeps the panel of
// columns [k0, k0 + kPanel) and applies it to every other column tile; the
// first pass reads the input, the later ones work in place on the output.
// With one panel row per thread two blocks share an SM, so the register
// budget is held to 128.
template <typename T, int kRows>
__global__ void __launch_bounds__(kBlockedThreads, kRows == 1 ? 2 : 1)
gj_inverse_blocked_kernel(const T* a, T* out, int* info, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const long long nn = static_cast<long long>(n) * n;
  const long long e = blockIdx.x;
  T* dst = out + e * nn;

  T* panel = reinterpret_cast<T*>(smem_raw);                // n x kPanelStride
  T* tile = panel + static_cast<size_t>(n) * kPanelStride;  // n x kPanel
  T* prow = tile + static_cast<size_t>(n) * kPanel;         // scaled pivot row
  T* oldk = prow + kPanel;                                  // row k before the swap
  T* red_key = oldk + kPanel;
  int* red_idx = reinterpret_cast<int*>(red_key + kBlockedWarps);
  int* perm = red_idx + kBlockedWarps;  // perm[k]: the pivot row of step k
  int* src = perm + n;                  // src[i]: the row that lands in row i

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int tc = tid % kTileColThreads;  // update: columns tc + 8 c
  const int tr = tid / kTileColThreads;  // update: rows tr + 32 r of a chunk

  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const T* w = k0 == 0 ? a + e * nn : dst;
    const int bk = min(kPanel, n - k0);
    for (int i = tid; i < n; i += kBlockedThreads) src[i] = i;
    load_columns(w, n, k0, bk, static_cast<const int*>(nullptr), panel, kPanelStride);
    __syncthreads();

    // 1. Panel: bk steps of the pivoted sweep on the n x bk panel alone,
    //    each behind two barriers: the pivot's partial maxima, then the
    //    pivot row and the old row k.
    T v[kRows][kPanel];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = tid + q * kBlockedThreads;
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        v[q][j] = i < n && j < bk ? panel[i * kPanelStride + j] : T(0);
      }
    }
    for (int t = 0; t < bk; ++t) {
      const int k = k0 + t;
      T key = T(-1);
      int idx = n;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = tid + q * kBlockedThreads;
        if (i >= k && i < n) take_max(key, idx, pivot_key(pick(v[q], t)), i);
      }
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const T other_key = __shfl_down_sync(0xffffffffu, key, off);
        const int other_idx = __shfl_down_sync(0xffffffffu, idx, off);
        take_max(key, idx, other_key, other_idx);
      }
      if (lane == 0) {
        red_key[warp] = key;
        red_idx[warp] = idx;
      }
      __syncthreads();
      key = red_key[0];
      idx = red_idx[0];
#pragma unroll
      for (int r = 1; r < kBlockedWarps; ++r) take_max(key, idx, red_key[r], red_idx[r]);
      if (!(key > T(0) && key < T(INFINITY))) {  // the same in every thread
        if (tid == 0) info[e] = k + 1;
        return;
      }
      const int p = idx;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = tid + q * kBlockedThreads;
        if (i == p) {
          const T inv_pivot = T(1) / pick(v[q], t);
#pragma unroll
          for (int j = 0; j < kPanel; ++j) prow[j] = j == t ? inv_pivot : v[q][j] * inv_pivot;
        }
        if (i == k) {
#pragma unroll
          for (int j = 0; j < kPanel; ++j) oldk[j] = v[q][j];
        }
      }
      if (tid == 0) {
        perm[k] = p;
        const int s_k = src[k];
        src[k] = src[p];
        src[p] = s_k;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = tid + q * kBlockedThreads;
        if (i == k) {
#pragma unroll
          for (int j = 0; j < kPanel; ++j) v[q][j] = prow[j];
        } else if (i < n) {
          if (i == p) {  // row p takes the old row k
#pragma unroll
            for (int j = 0; j < kPanel; ++j) v[q][j] = oldk[j];
          }
          const T c = pick(v[q], t);
#pragma unroll
          for (int j = 0; j < kPanel; ++j) {
            v[q][j] = fused_mul_add(-c, prow[j], j == t ? T(0) : v[q][j]);
          }
        }
      }
    }
    // The panel now holds M, the inverse's columns [k0, k0 + bk).
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = tid + q * kBlockedThreads;
      if (i < n) {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          if (j < bk) panel[i * kPanelStride + j] = v[q][j];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * kPanel; idx += kBlockedThreads) {
      const int i = idx / kPanel;
      const int t = idx % kPanel;
      if (t < bk) __stcg(dst + static_cast<long long>(i) * n + k0 + t, panel[i * kPanelStride + t]);
    }

    // 2. Update: every other column tile, its rows gathered through src,
    //    C'[i] = (i in K ? 0 : C[i]) + sum_t M[i,t] C[k0+t].
    for (int j0 = 0; j0 < n; j0 += kPanel) {
      if (j0 == k0) continue;
      const int wj = min(kPanel, n - j0);
      load_columns(w, n, j0, wj, src, tile, kPanel);
      __syncthreads();
      for (int r0 = 0; r0 < n; r0 += kRowChunk) {
        int rows[kRowsPerThread];
        T acc[kRowsPerThread][kColsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int i = r0 + tr + r * kTileRowThreads;
          rows[r] = min(i, n - 1);
          const bool keep = i < n && (i < k0 || i >= k0 + bk);
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            acc[r][c] = keep ? tile[rows[r] * kPanel + tc + c * kTileColThreads] : T(0);
          }
        }
        for (int t = 0; t < bk; ++t) {
          T m[kRowsPerThread];
          T pivot_row[kColsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) m[r] = panel[rows[r] * kPanelStride + t];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            pivot_row[c] = tile[(k0 + t) * kPanel + tc + c * kTileColThreads];
          }
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
            for (int c = 0; c < kColsPerThread; ++c) {
              acc[r][c] = fused_mul_add(m[r], pivot_row[c], acc[r][c]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int i = r0 + tr + r * kTileRowThreads;
          if (i >= n) continue;
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const int j = tc + c * kTileColThreads;
            if (j < wj) __stcg(dst + static_cast<long long>(i) * n + j0 + j, acc[r][c]);
          }
        }
      }
      __syncthreads();
    }
  }

  // 3. Undo the row swaps as column swaps, last first: column j of the
  //    result is column src[j] of the swept matrix.  kPanel rows at a time
  //    go through the tile buffer, so loads and stores stay coalesced.
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < n; ++j) src[j] = j;
    for (int k = n - 1; k >= 0; --k) {
      const int pk = perm[k];
      const int s_k = src[k];
      src[k] = src[pk];
      src[pk] = s_k;
    }
  }
  for (int i0 = 0; i0 < n; i0 += kPanel) {
    const int count = min(kPanel, n - i0) * n;
    T* rows_i0 = dst + static_cast<long long>(i0) * n;
    for (int first = tid; first < count; first += kBlockedThreads * kBatch) {
      T buf[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int idx = first + b * kBlockedThreads;
        buf[b] = idx < count ? __ldcg(rows_i0 + idx) : T(0);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int idx = first + b * kBlockedThreads;
        if (idx < count) tile[idx] = buf[b];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < count; idx += kBlockedThreads) {
      const int r = idx / n;
      __stcg(rows_i0 + idx, tile[r * n + src[idx - r * n]]);
    }
    __syncthreads();
  }
  if (tid == 0) info[e] = 0;
}

int smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  return static_cast<int>(err);
}

template <typename T>
Route route_for(int n, int optin) {
  const size_t limit = static_cast<size_t>(optin);
  if (shared_route_bytes<T>(n) <= limit) return kSharedRoute;
  if (n <= kMaxBlockedRows * kBlockedThreads && blocked_route_bytes<T>(n) <= limit) {
    return kBlockedRoute;
  }
  return kGlobalRoute;
}

template <typename T>
int route_query(int n) {
  int optin = 0;
  const int err = smem_optin(&optin);
  if (err != 0) return -err;
  return route_for<T>(n, optin);
}

template <typename T>
int launch_kernel(void (*kernel)(const T*, T*, int*, int), dim3 grid, dim3 block, size_t smem,
                  cudaStream_t stream, const T* a, T* out, int* info, int n) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, stream>>>(a, out, info, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, void* out, int* info, int n_elem, int n, void* stream) {
  if (n_elem <= 0 || n <= 0) return 0;
  int optin = 0;
  const int err = smem_optin(&optin);
  if (err != 0) return err;
  const T* a_t = static_cast<const T*>(a);
  T* out_t = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(n);
  const dim3 unblocked(kWarp, threads / kWarp);
  switch (route_for<T>(n, optin)) {
    case kSharedRoute:
      return launch_kernel(gj_inverse_kernel<T, true>, n_elem, unblocked,
                           shared_route_bytes<T>(n), s, a_t, out_t, info, n);
    case kBlockedRoute:
      return launch_kernel(n <= kBlockedThreads ? gj_inverse_blocked_kernel<T, 1>
                                                : gj_inverse_blocked_kernel<T, kMaxBlockedRows>,
                           n_elem, kBlockedThreads, blocked_route_bytes<T>(n), s, a_t, out_t,
                           info, n);
    default:
      break;
  }
  const size_t scratch = scratch_bytes<T>(n);
  if (scratch > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return launch_kernel(gj_inverse_kernel<T, false>, n_elem, unblocked, scratch, s, a_t, out_t,
                       info, n);
}

}  // namespace

extern "C" int mfv2d_gj_inverse_f64(const void* a, void* out, int* info, int n_elem, int n,
                                    void* stream) {
  return launch<double>(a, out, info, n_elem, n, stream);
}

extern "C" int mfv2d_gj_inverse_f32(const void* a, void* out, int* info, int n_elem, int n,
                                    void* stream) {
  return launch<float>(a, out, info, n_elem, n, stream);
}

// The route an n x n matrix takes on the current device: 0 shared, 1
// blocked, 2 global; minus a CUDA error code.
extern "C" int mfv2d_gj_inverse_route_f64(int n) { return route_query<double>(n); }

extern "C" int mfv2d_gj_inverse_route_f32(int n) { return route_query<float>(n); }
