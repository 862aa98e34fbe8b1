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
// Design.  The route depends on n and on the opted-in dynamic shared memory
// (227 KB on the H100):
//   - Register route (n <= 64): a group of threads per matrix, one matrix
//     row per thread, held in registers; 32 threads (one warp) for
//     n <= 32, 64 (two warps) above, several groups per 128-thread block.
//     Bound at n = 56, E = 4096, f64 by its bytes: 2 x 103 MB, 0.0613 ms at
//     3.35 TB/s.  A step costs two barriers scoped to the group and one
//     broadcast of the pivot row through shared memory; the matrix itself
//     crosses shared memory only on its way in and out:
//       * Pivoting is implicit: no row is ever swapped.  Each thread keeps a
//         `used` flag for its row; step k takes the pivot p_k, the largest
//         |T[i,k]| over the unused rows (NaN as +inf; ties now go to the
//         smaller ORIGINAL row, not the smaller current position), and
//         sweeps in place as above.  At the end inverse[k, p_j] = T[p_k, j]:
//         the thread holding row p_k writes output row k, its column j to
//         column p_j.  A zero column stays zero under the sweep, so a
//         singular matrix reports the same info = k+1.
//       * Column k is always register 0: each row lives in T u[kLen] (kLen
//         = n rounded up to 8, zero past n) and is rotated left one place per
//         step, the new column-k value going to u[kLen-1].  So every
//         register index is static while the step loop stays a short runtime
//         loop (unrolling it would put n copies of the step in the
//         instruction cache).  After n steps column j sits in
//         u[kLen - n + j].  One instantiation per kLen.
//       * The pivot row is scaled lazily.  Its owner broadcasts its raw row
//         and keeps s = 1 / piv for the end (T[p,:] = s u_p); every other
//         row subtracts f = T[i,k] / piv times it and takes -f in its last
//         place, the pivot row only rotates and takes 1 there.  Every
//         thread divides by the pivot itself, so the owner does no
//         multiplications before the broadcast.
//       * The pivot search compares integers: the bits of |x| order as |x|
//         does, with NaN raised to +inf, and the row tag 2 row + sign lets
//         ties go to the smaller row and the winner's value be rebuilt.  The
//         FP64 pipe, which every warp's update keeps busy, then sees no
//         compares.
//       * Two barriers a step, scoped to the group: the pivot reduction is a
//         butterfly of warp shuffles; a 64-thread group exchanges its two
//         warp maxima through shared memory behind a named barrier
//         (bar.sync id, 64), then both warps finish it redundantly.  The
//         pivot's owner writes its row once, in 16-byte stores, into the
//         group's broadcast slot; after the second barrier every other
//         thread reads it back as broadcast 16-byte loads and updates its
//         row with kLen FMAs.  A 32-thread group uses __syncwarp.  Each
//         barrier also orders the slot's reuse.
//       * Shared memory carries only the broadcast row inside the sweep.
//         Each matrix comes in once through a per-group staging buffer
//         (16-byte cp.async, coalesced, where n x sizeof(T) is a multiple of
//         16 bytes; element copies otherwise), with a row stride of an odd
//         number of 16-byte vectors, so that eight threads' row loads hit
//         distinct banks; the permuted result goes out through the same
//         buffer, coalesced.  Groups are persistent, looping over matrices
//         e = g, g + G, ...  One buffer per group (26 KB at n = 56, f64)
//         means a group's next copy cannot overlap its own sweep: the other
//         groups of the SM sweep meanwhile, and two buffers would halve the
//         groups that fit.  __launch_bounds__ asks for 6 groups of 64 per
//         SM (at most 170 registers a thread; the 56 f64 entries of an n = 56
//         row take 112), 4 for f64 rows of 64, which would spill under 170.
//     What bounds it now: the shared-memory pipe.  Every thread reads the
//     whole pivot row at every step, and a 16-byte broadcast load still
//     writes 16 bytes into each of the 32 lanes, 512 bytes through a path of
//     128 bytes a cycle; with the owner's stores that is about 190 cycles
//     of the SM's pipe per warp and step, about 2,200 per step for the 12
//     warps of an SM.
//   - Blocked route (64 < n <= 439 in f64, 512 in f32): panels of kPanel = 32
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
//     share an SM at n <= 256, one above.  Covers the p = 5 Navier-Stokes
//     blocks (n = 121) and the p = 8 blocks (n = 208, 289).
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
#include <stdint.h>

#include <atomic>

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

// Register route: the largest n, and threads per block (2 groups of 64 or
// 4 of 32).
constexpr int kRegisterMaxN = 64;
constexpr int kRegisterThreads = 128;

// Blocks per SM asked of the compiler for rows of kLen entries: 3 (6
// groups of 64, at most 170 registers a thread), but 2 for f64 rows of 64,
// whose 128 registers of entries would spill under that cap.
template <typename T>
constexpr int register_min_blocks(int len) { return sizeof(T) == 8 && len > 56 ? 2 : 3; }

enum Route : int { kRegisterRoute = 0, kBlockedRoute = 1, kGlobalRoute = 2 };

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
size_t blocked_route_bytes(int n) {
  const size_t m = static_cast<size_t>(n);
  // panel, tile, pivot row, old row k and reduction keys; the reduction
  // rows, the pivot rows and the row gather
  return (m * kPanelStride + m * kPanel + 2 * kPanel + kBlockedWarps) * sizeof(T) +
         (kBlockedWarps + 2 * m) * sizeof(int);
}

// Register route: the row stride (entries) of a group's staging buffer, an
// odd number of 16-byte vectors, so that the rows read by eight threads'
// 16-byte loads start in distinct banks.
template <typename T>
__host__ __device__ inline int register_stride(int n) {
  constexpr int kVec = 16 / sizeof(T);
  int vectors = (n + kVec - 1) / kVec;
  if (vectors % 2 == 0) ++vectors;
  return vectors * kVec;
}

// One group's shared memory.  First a part of fixed size, so that its
// fields sit at constant offsets: the pivot row, the two warps' maxima
// (keys, tags) and the pivot rows.  Then the staging buffer.  Both are
// rounded up to 16 bytes.
template <typename T>
__host__ __device__ constexpr size_t register_fixed_bytes() {
  return (kRegisterMaxN * sizeof(T) + 2 * sizeof(long long) + (2 + kRegisterMaxN) * sizeof(int) +
          15) /
         16 * 16;
}

template <typename T>
__host__ __device__ inline size_t register_group_bytes(int n) {
  const size_t buffer = static_cast<size_t>(n) * register_stride<T>(n) * sizeof(T);
  return register_fixed_bytes<T>() + (buffer + 15) / 16 * 16;
}

// Threads of a group: one warp for rows up to 32, two above.
__host__ __device__ constexpr int register_threads(int n) { return n <= kWarp ? kWarp : 2 * kWarp; }

template <typename T>
size_t register_route_bytes(int n) {
  return kRegisterThreads / register_threads(n) * register_group_bytes<T>(n);
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

// Global route (see the design note): one block per matrix, swept in place
// on the output.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gj_inverse_global_kernel(const T* __restrict__ a, T* __restrict__ out, int* __restrict__ info,
                         int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_pivot_row;
  __shared__ int s_bad;

  const long long nn = static_cast<long long>(n) * n;
  const long long e = blockIdx.x;
  const T* src = a + e * nn;
  T* w = out + e * nn;

  T* row = reinterpret_cast<T*>(smem_raw);  // scaled pivot row
  T* col = row + n;                         // pivot column, rows k and p exchanged
  T* red_key = col + n;
  int* red_idx = reinterpret_cast<int*>(red_key + kMaxWarps);
  int* perm = red_idx + kMaxWarps;

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
  if (tid == 0) info[e] = 0;
}

// Register route helpers.  A group of kThreads threads waits for itself
// alone: __syncwarp for one warp, a named barrier (one id per group) for
// two; both order shared memory among the group's threads.
template <int kThreads>
__device__ inline void group_sync(int barrier_id) {
  if constexpr (kThreads == kWarp) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(barrier_id), "n"(kThreads) : "memory");
  }
}

template <int kBytes>
__device__ inline void copy_async(void* to_shared, const void* from_global) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(to_shared));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(from_global)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(to), "l"(from_global),
                 "n"(kBytes)
                 : "memory");
  }
}

__device__ inline void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// Integer pivot keys: the bits of |x|, which order as |x| does, with NaN
// raised to +inf; the compares then stay off the FP64 pipe.  A row's tag
// is 2 row + (sign of x), so that ties still go to the smaller row and
// the winner's value can be rebuilt from its key and tag.
__device__ inline long long pivot_bits(double x) {
  const long long bits = __double_as_longlong(x) & 0x7fffffffffffffffLL;
  return bits > 0x7ff0000000000000LL ? 0x7ff0000000000000LL : bits;
}
__device__ inline long long pivot_bits(float x) {
  const int bits = __float_as_int(x) & 0x7fffffff;
  return bits > 0x7f800000 ? 0x7f800000 : bits;
}
__device__ inline int sign_bit(double x) { return static_cast<unsigned>(__double2hiint(x)) >> 31; }
__device__ inline int sign_bit(float x) { return static_cast<unsigned>(__float_as_int(x)) >> 31; }
__device__ inline void pivot_value(long long key, int tag, double* x) {
  *x = __longlong_as_double(key | (static_cast<long long>(tag & 1) << 63));
}
__device__ inline void pivot_value(long long key, int tag, float* x) {
  *x = __int_as_float(static_cast<int>(key) | ((tag & 1) << 31));
}
template <typename T>
constexpr long long kInfBits = sizeof(T) == 8 ? 0x7ff0000000000000LL : 0x7f800000LL;

__device__ inline void take_max_bits(long long& key, int& tag, long long other_key,
                                     int other_tag) {
  if (other_key > key || (other_key == key && other_tag < tag)) {
    key = other_key;
    tag = other_tag;
  }
}

// 16 bytes between shared memory (16-byte aligned) and registers x[0..].
__device__ inline void load16(const double* p, double* x) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}
__device__ inline void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ inline void store16(double* p, const double* x) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}
__device__ inline void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Register route (see the design note): a group of kThreads threads per
// matrix, thread r holding row r in u[0..kLen), kLen = n rounded up to 8.
// `vec`: n x sizeof(T) and both pointers are 16-byte multiples, so the
// matrix moves in 16-byte pieces.
template <typename T, int kLen>
__global__ void __launch_bounds__(kRegisterThreads, register_min_blocks<T>(kLen))
gj_inverse_register_kernel(const T* __restrict__ a, T* __restrict__ out, int* __restrict__ info,
                           int n_elem, int n, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = register_threads(kLen);
  constexpr int kGroups = kRegisterThreads / kThreads;
  static_assert(kLen % kVec == 0, "rows of whole 16-byte pieces");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int group = threadIdx.x / kThreads;
  const int r = threadIdx.x % kThreads;
  const int barrier_id = 1 + group;  // 0 is __syncthreads'
  const int stride = register_stride<T>(n);
  const int row_vecs = n / kVec;
  const long long nn = static_cast<long long>(n) * n;

  unsigned char* fixed = smem_raw + group * register_group_bytes<T>(n);
  T* bro = reinterpret_cast<T*>(fixed);  // the pivot row, raw
  long long* red_key = reinterpret_cast<long long*>(bro + kRegisterMaxN);  // the warps' maxima
  int* red_tag = reinterpret_cast<int*>(red_key + 2);
  int* perm = red_tag + 2;  // perm[k]: the pivot row of step k
  T* buf = reinterpret_cast<T*>(fixed + register_fixed_bytes<T>());

  for (int e = blockIdx.x * kGroups + group; e < n_elem; e += gridDim.x * kGroups) {
    const T* src = a + static_cast<long long>(e) * nn;
    if (vec) {
      for (int i = r; i < n * row_vecs; i += kThreads) {
        const int row = i / row_vecs;
        const int c = (i - row * row_vecs) * kVec;
        copy_async<16>(buf + row * stride + c, src + row * n + c);
      }
    } else {
      for (int i = r; i < nn; i += kThreads) {
        const int row = i / n;
        copy_async<sizeof(T)>(buf + row * stride + i - row * n, src + i);
      }
    }
    copy_async_wait();
    group_sync<kThreads>(barrier_id);

    T u[kLen];
#pragma unroll
    for (int q = 0; q < kLen; q += kVec) {
      T x[kVec] = {};
      if (r < n && q < n) load16(buf + r * stride + q, x);
#pragma unroll
      for (int t = 0; t < kVec; ++t) u[q + t] = r < n && q + t < n ? x[t] : T(0);
    }

    bool used = r >= n;
    int my_step = 0;
    T scale = T(1);  // the row is scale * u once it has been a pivot
    int failed_at = 0;
    for (int k = 0; k < n; ++k) {
      long long key = used ? -1LL : pivot_bits(u[0]);
      int tag = 2 * r + sign_bit(u[0]);
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const long long other_key = __shfl_xor_sync(0xffffffffu, key, off);
        const int other_tag = __shfl_xor_sync(0xffffffffu, tag, off);
        take_max_bits(key, tag, other_key, other_tag);
      }
      if constexpr (kThreads > kWarp) {
        if (r % kWarp == 0) {
          red_key[r / kWarp] = key;
          red_tag[r / kWarp] = tag;
        }
      }
      // Orders the last step's broadcast reads before this step's write,
      // and (two warps) publishes the warp maxima.
      group_sync<kThreads>(barrier_id);
      if constexpr (kThreads > kWarp) {
        key = red_key[0];
        tag = red_tag[0];
        take_max_bits(key, tag, red_key[1], red_tag[1]);
      }
      if (!(key > 0 && key < kInfBits<T>)) {  // the same in every thread of the group
        failed_at = k + 1;
        break;
      }
      const bool pivot = r == tag >> 1;
      // The pivot's owner broadcasts its raw row; every thread divides by
      // the pivot itself while the barrier waits.
      if (pivot) {
#pragma unroll
        for (int q = 0; q < kLen; q += kVec) store16(bro + q, u + q);
        perm[k] = r;
        used = true;
        my_step = k;
      }
      T piv;
      pivot_value(key, tag, &piv);
      const T inv_pivot = T(1) / piv;
      group_sync<kThreads>(barrier_id);
      // T[i,:] - (T[i,k] / piv) T[p,:], rotated one place left; the pivot
      // row itself only rotates (f = 0) and takes 1 in its last place, its
      // scale 1 / piv kept for the end.
      const T f = pivot ? T(0) : u[0] * inv_pivot;
      if (pivot) scale = inv_pivot;
#pragma unroll
      for (int q = 0; q < kLen; q += kVec) {
        T b[kVec];
        load16(bro + q, b);
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          const int j = q + t - 1;
          if (j >= 0) u[j] = fused_mul_add(-f, b[t], u[j + 1]);
        }
      }
      u[kLen - 1] = pivot ? T(1) : -f;
    }

    if (failed_at != 0) {
      if (r == 0) info[e] = failed_at;
      group_sync<kThreads>(barrier_id);
      continue;
    }
    // inverse[k, perm[j]] = T[perm[k], j] = scale u[j + kLen - n] of the
    // thread whose row was pivot k, gathered into the buffer, then stored
    // coalesced.
    group_sync<kThreads>(barrier_id);
    if (r < n) {
      T* row_out = buf + my_step * stride;
#pragma unroll
      for (int q = 0; q < kLen; ++q) {
        const int j = q - (kLen - n);
        if (j >= 0) row_out[perm[j]] = scale * u[q];
      }
    }
    group_sync<kThreads>(barrier_id);
    T* dst = out + static_cast<long long>(e) * nn;
    if (vec) {
      for (int i = r; i < n * row_vecs; i += kThreads) {
        const int row = i / row_vecs;
        const int c = (i - row * row_vecs) * kVec;
        T x[kVec];
        load16(buf + row * stride + c, x);
        store16(dst + row * n + c, x);
      }
    } else {
      for (int i = r; i < nn; i += kThreads) {
        const int row = i / n;
        dst[i] = buf[row * stride + i - row * n];
      }
    }
    if (r == 0) info[e] = 0;
    group_sync<kThreads>(barrier_id);  // the buffer is read out before the next copy lands
  }
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

// The current device and the dynamic shared memory a block may opt in to.
int smem_optin(int* device, int* bytes) {
  cudaError_t err = cudaGetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, *device);
  }
  return static_cast<int>(err);
}

// Above n = 64 the blocked route: a route that held the whole matrix in
// shared memory was slower at every n timed, 65 to 161 in f64 and 65 to 208
// in f32 (tools/gj_inverse_ablation.py --baseline).
template <typename T>
Route route_for(int n, int optin) {
  const size_t limit = static_cast<size_t>(optin);
  if (n <= kRegisterMaxN && register_route_bytes<T>(n) <= limit) return kRegisterRoute;
  if (n <= kMaxBlockedRows * kBlockedThreads && blocked_route_bytes<T>(n) <= limit) {
    return kBlockedRoute;
  }
  return kGlobalRoute;
}

template <typename T>
int route_query(int n) {
  int device = 0;
  int optin = 0;
  const int err = smem_optin(&device, &optin);
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

// The blocks of the register kernel for n that fit on `device` at once.
// The answer is fixed for each instantiation, n and device, so it is asked
// for once and kept; the kernel's shared-memory limit is raised on that
// first call to what its largest n needs.
template <typename T, int kLen>
int register_resident_blocks(int device, int n, int* blocks) {
  constexpr int kDevices = 16;
  static std::atomic<int> cache[kDevices][kLen + 1];
  const bool cached = device < kDevices;
  if (cached) {
    *blocks = cache[device][n].load(std::memory_order_relaxed);
    if (*blocks > 0) return 0;
  }
  void (*kernel)(const T*, T*, int*, int, int, int) = gj_inverse_register_kernel<T, kLen>;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(register_route_bytes<T>(kLen)));
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRegisterThreads,
                                                        register_route_bytes<T>(n));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (cached) cache[device][n].store(*blocks, std::memory_order_relaxed);
  return 0;
}

// Persistent groups: no more blocks than fit on the card at once.
template <typename T, int kLen>
int launch_register(const T* a, T* out, int* info, int n_elem, int n, int device,
                    cudaStream_t stream) {
  constexpr int kGroups = kRegisterThreads / register_threads(kLen);
  const size_t smem = register_route_bytes<T>(n);
  int resident = 0;
  const int err = register_resident_blocks<T, kLen>(device, n, &resident);
  if (err != 0) return err;
  long long blocks = (static_cast<long long>(n_elem) + kGroups - 1) / kGroups;
  if (blocks > resident) blocks = resident;
  const int vec = (n * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gj_inverse_register_kernel<T, kLen>
      <<<static_cast<unsigned>(blocks), kRegisterThreads, smem, stream>>>(a, out, info, n_elem, n,
                                                                          vec);
  return static_cast<int>(cudaGetLastError());
}

// The register route's instantiation for n: kLen = n rounded up to 8.
template <typename T>
int launch_register_for(const T* a, T* out, int* info, int n_elem, int n, int device,
                        cudaStream_t s) {
  switch ((n + 7) / 8) {
    case 1: return launch_register<T, 8>(a, out, info, n_elem, n, device, s);
    case 2: return launch_register<T, 16>(a, out, info, n_elem, n, device, s);
    case 3: return launch_register<T, 24>(a, out, info, n_elem, n, device, s);
    case 4: return launch_register<T, 32>(a, out, info, n_elem, n, device, s);
    case 5: return launch_register<T, 40>(a, out, info, n_elem, n, device, s);
    case 6: return launch_register<T, 48>(a, out, info, n_elem, n, device, s);
    case 7: return launch_register<T, 56>(a, out, info, n_elem, n, device, s);
    default: return launch_register<T, 64>(a, out, info, n_elem, n, device, s);
  }
}

template <typename T>
int launch(const void* a, void* out, int* info, int n_elem, int n, void* stream) {
  if (n_elem <= 0 || n <= 0) return 0;
  int device = 0;
  int optin = 0;
  const int err = smem_optin(&device, &optin);
  if (err != 0) return err;
  const T* a_t = static_cast<const T*>(a);
  T* out_t = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(n);
  const dim3 unblocked(kWarp, threads / kWarp);
  switch (route_for<T>(n, optin)) {
    case kRegisterRoute:
      return launch_register_for<T>(a_t, out_t, info, n_elem, n, device, s);
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
  return launch_kernel(gj_inverse_global_kernel<T>, n_elem, unblocked, scratch, s, a_t, out_t,
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

// The route an n x n matrix takes on the current device: 0 register, 1
// blocked, 2 global; minus a CUDA error code.
extern "C" int mfv2d_gj_inverse_route_f64(int n) { return route_query<double>(n); }

extern "C" int mfv2d_gj_inverse_route_f32(int n) { return route_query<float>(n); }
