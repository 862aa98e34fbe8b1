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
//   - Blocked route (64 < n <= 218): panels of kPanel = 32
//     columns.  Each thread holds one panel row in registers and the
//     block sweeps the n x 32 panel with the same pivoting,
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
//     share an SM at n = 208; above n = 218 one block fills an SM, and there
//     the streamed route is faster (tools/gj_inverse_ablation.py: 14.5 ms
//     against 17.1 ms at n = 208, E = 4096; 5.8 ms against 5.0 ms at
//     n = 224, E = 1000).  Covers the p = 5 Navier-Stokes blocks (n = 121)
//     and the p = 8 mixed Poisson blocks (n = 208).  The kernel takes
//     n <= 256, one panel row a thread.
//   - Streamed route (n >= 219): the blocked route's panel sweep and tile
//     update, each its own launch, so that nothing of size n x b sits in
//     shared memory on the update side and one matrix spreads over many
//     blocks.  For each panel k0 (b = 32 columns up to n = 512, 16 to
//     n = 1024, 32 above):
//       * panel launch: the n x b panel is read into registers, 64 entries
//         a thread of 256 (two rows of 32, or four of 16), swept with the
//         blocked route's pivoting (each row rotated one place a step, so
//         that column k always sits in the first register: no select
//         tree), and written to the work matrix (below), where it is the
//         inverse's own columns M; the panel's row gather src (the row of
//         the matrix as read that lands in each row) goes to a scratch
//         array, and so does the running row permutation sigma,
//         sigma'[i] = sigma[src[i]], written in place once every block of
//         the matrix has read it.  Up
//         to n = 1024 one block holds a matrix's panel.  Above, a cluster
//         of ceil(n / 512) blocks (at most 8, the portable size) holds it,
//         512 rows of 32 columns a block, and a step takes a block barrier
//         and one cluster barrier where one block takes two block
//         barriers: behind the block barrier each block reduces its warps'
//         maxima; the warp that holds the block's candidate row, and the
//         warp that holds row k, spread them over their lanes with
//         shuffles, each lane storing its entry in every block
//         (distributed shared memory), and lane r of warp 0 stores the
//         block's maximum in block r; behind the cluster barrier every
//         block reduces the blocks' maxima and reads the pivot row from
//         its own shared memory.  Two sets of these slots alternate by
//         step: set s is next written in step t + 2, behind the barrier of
//         step t + 1, which no thread reaches before it has read step t's,
//         so no second cluster barrier orders their reuse.  Past 8 x 512 =
//         4,096 rows each block keeps its share of the rest in natural
//         column order in place in the work matrix, where it stays in L2,
//         and sweeps it with the same arithmetic (this spill and the
//         cluster are template flags, compiled out of the one-block kernel
//         of n <= 1024).  So the panel launch takes every n; the route
//         stops where its other launches' shared memory does (n = 19,370 in
//         f64, where the column swaps' one row and its permutation fill a
//         block), an element block of 3.0 GB;
//       * update launch, one block of 128 threads per matrix and column
//         tile, ceil(n / b) - 1 of them per matrix (13 x 16 = 208 blocks at
//         n = 441, E = 16):
//         C'[i] = (i in K ? 0 : C[src[i]]) + sum_t M[i,t] C[src[k0 + t]].
//         The b x b pivot rows C[src[K]] and the rows C[K] as read are
//         staged first; then row chunks of 32 rows of M and C stream
//         through a three-stage ring of cp.async copies.  A row i outside K
//         reads either its own row or one of the rows K (the panel's swaps
//         only move rows of K out of K), so after the staging a block
//         writes no row that it still has to read, and blocks of one matrix
//         own disjoint column tiles.  The rank-b product runs on the FP64
//         tensor cores (mma.sync.m16n8k4.f64, each warp 16 rows by b / 2
//         columns, the accumulators starting from the kept C rows); f32
//         keeps the same ownership with FP32 FMAs (TF32 products were not
//         tried: their 10-bit mantissa is near the 1e-3 tolerance).
//       then one launch undoes the row swaps as column swaps: column c of
//       the result is column j of the swept matrix where sigma[j] = c.
//     The panels and updates sweep a work matrix whose rows start 16 bytes
//     apart: row stride ld, n rounded up to 16 bytes (n + 1 for odd n in
//     f64; the wrapper's `launch_plan`), the output itself where ld = n,
//     else a buffer of E n ld entries beside it (687 MB at n = 289,
//     E = 1024).  The first panel and its update read the input (row
//     stride n), and the column swaps write the output from the work
//     matrix.  So every staged row of the work matrix moves in 16-byte
//     cp.async pieces (a piece that straddles a strip's last column reads
//     only up to it, so that no padding column is read as data) and the
//     update stores two entries at once, 16 bytes in f64; with the rows
//     n entries apart, odd n (every Navier-Stokes block, (2p + 1)^2, and
//     config 3's n = 289) took 8-byte copies and single stores.
//     2 ceil(n / b) + 1 launches a call (31 at n = 460, 71 at n = 1089) on
//     the caller's stream, after a clear of info; each launch first reads
//     info[e], so a matrix whose panel failed is left alone by the rest of
//     the call.  The matrix crosses HBM twice per panel (C read, C'
//     written; M is re-read from L2 by the matrix's tile blocks, which run
//     side by side), about 51 GB at n = 460, E = 1000, 15 ms at 3.35 TB/s;
//     the n pivot steps, a chain of barriers in one block (or cluster) per
//     matrix, come next.  As measured (tools/gj_inverse_ablation.py, H100
//     SXM at 700 W, f64): at n = 460, E = 1000 31.9 ms a call, 20.9 ms
//     without the products (the passes), 28.1 ms without the pivot steps,
//     0.23 ms for the 31 launches alone; a ring of two stages, chunks of 64
//     rows on 8 warps and 2 warps each owning whole tile rows were each
//     within 5%, panels of 16 columns twice as slow.  At n = 1056 and
//     1089 (E = 16) and 2401 (E = 4) the cluster takes 6.94, 9.37 and
//     27.76 ms (torch.linalg.inv 27.41, 29.40 and 73.84 ms); one block of
//     16 columns with the rows past 1,024 in L2 13.93, 18.64 and 108.22 ms
//     (twice the passes), two blocks of 32 with theirs in L2 10.91, 14.48
//     and 91.31 ms.  Its pivot steps cost 2.27, 2.35 and 5.47 ms of that,
//     2.2 us a step against 1.2 us for one block's at n = 441; with two
//     cluster barriers a step (the warp maxima of every block sent to
//     every block, then the rows p and k) they cost 2.8 us a step, 7.58,
//     10.02 and 28.93 ms a call.  In another call the step took 6.95, 9.24
//     and 26.36 ms, two cluster barriers 7.59, 9.90 and 27.60 ms, and one
//     cluster barrier behind every warp's candidate row sent to every
//     block 7.26, 9.54 and 26.93 ms.  With rows n entries apart
//     odd n took 11.80 against 11.05 ms at n = 289 (E = 1024) and 11.39
//     against 9.37 ms at n = 1089, where the even n + 1 (as many panels)
//     takes 11.20 and 9.39 ms.  One matrix alone is slower than
//     torch.linalg.inv above n = 2560 (chip_smoke.py phase 6: 32.87
//     against 21.03 ms at n = 4096, and each spilled row adds global round
//     trips to the chain, 43.01 ms at n = 4097).
// The row swaps of the blocked and streamed routes are undone as column
// swaps at the end.  Which route and layout an n takes is decided by the
// wrapper (mfv2d_torch/ops/kernels/gj_inverse.py, `launch_plan`), where it is
// checked without a card; launch() below only validates it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; the C entry points below are loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;

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

// Register route: the largest n, and threads per block (2 groups of 64 or
// 4 of 32).
constexpr int kRegisterMaxN = 64;
constexpr int kRegisterThreads = 128;

// Blocks per SM asked of the compiler for rows of kLen entries: 3 (6
// groups of 64, at most 170 registers a thread), but 2 for f64 rows of 64,
// whose 128 registers of entries would spill under that cap.
template <typename T>
constexpr int register_min_blocks(int len) { return sizeof(T) == 8 && len > 56 ? 2 : 3; }

// Streamed route: the most blocks of a panel launch's cluster (the
// portable cluster size), the update's threads, rows per ring stage and
// stages, and the padding of a staged row (kB + 4 entries: the fragment
// loads of a warp then take two shared-memory wavefronts, the least for 32
// lanes of 8 bytes); the column swaps' threads and rows.
constexpr int kMaxCluster = 8;
constexpr int kStreamThreads = 128;
constexpr int kStreamRows = 32;
constexpr int kStreamStages = 3;
constexpr int kStreamPad = 4;
// The update's warps: row pair warp % kRowPairs of a chunk, column group
// warp / kRowPairs of the tile.
constexpr int kRowPairs = kStreamRows / 16;
constexpr int kColGroups = kStreamThreads / kWarp / kRowPairs;
static_assert(kColGroups >= 1 && kColGroups * kRowPairs * kWarp == kStreamThreads,
              "the update's warps cover a chunk's row pairs and the tile's columns");
constexpr int kUnswapThreads = 128;
constexpr int kUnswapRows = 16;

// Route codes, as the wrapper passes them.
enum Route : int { kRegisterRoute = 0, kBlockedRoute = 1, kStreamedRoute = 2 };

// Pivot ranking key: |x|, with NaN ranked as +inf so that a NaN column is
// picked and reported rather than skipped.
__device__ inline double pivot_key(double x) { return x != x ? INFINITY : fabs(x); }
__device__ inline float pivot_key(float x) { return x != x ? INFINITY : fabsf(x); }

__device__ inline double fused_mul_add(double a, double b, double c) { return fma(a, b, c); }
__device__ inline float fused_mul_add(float a, float b, float c) { return fmaf(a, b, c); }

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

// Keep the larger key; on a tie the smaller row.
template <typename T>
__device__ inline void take_max(T& key, int& idx, T other_key, int other_idx) {
  if (other_key > key || (other_key == key && other_idx < idx)) {
    key = other_key;
    idx = other_idx;
  }
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
// per matrix; thread tid holds panel row tid in registers during the panel
// sweep (n <= kBlockedThreads).  Pass k0 sweeps the panel of columns
// [k0, k0 + kPanel) and applies it to every other column tile; the first
// pass reads the input, the later ones work in place on the output.  Two
// blocks share an SM, so the register budget is held to 128.
template <typename T>
__global__ void __launch_bounds__(kBlockedThreads, 2)
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
    T v[kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      v[j] = tid < n && j < bk ? panel[tid * kPanelStride + j] : T(0);
    }
    for (int t = 0; t < bk; ++t) {
      const int k = k0 + t;
      T key = T(-1);
      int idx = n;
      if (tid >= k && tid < n) take_max(key, idx, pivot_key(pick(v, t)), tid);
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
      if (tid == p) {
        const T inv_pivot = T(1) / pick(v, t);
#pragma unroll
        for (int j = 0; j < kPanel; ++j) prow[j] = j == t ? inv_pivot : v[j] * inv_pivot;
      }
      if (tid == k) {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) oldk[j] = v[j];
      }
      if (tid == 0) {
        perm[k] = p;
        const int s_k = src[k];
        src[k] = src[p];
        src[p] = s_k;
      }
      __syncthreads();
      if (tid == k) {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) v[j] = prow[j];
      } else if (tid < n) {
        if (tid == p) {  // row p takes the old row k
#pragma unroll
          for (int j = 0; j < kPanel; ++j) v[j] = oldk[j];
        }
        const T c = pick(v, t);
#pragma unroll
        for (int j = 0; j < kPanel; ++j) v[j] = fused_mul_add(-c, prow[j], j == t ? T(0) : v[j]);
      }
    }
    // The panel now holds M, the inverse's columns [k0, k0 + bk).
    if (tid < n) {
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        if (j < bk) panel[tid * kPanelStride + j] = v[j];
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

// Streamed route, panel launch helpers.  A panel launch's blocks of one
// matrix form a cluster (kCluster) or are one block alone; x goes to
// `local` in block `to` of the cluster (in this block alone), and sync_all
// waits for every thread of the cluster (of the block), ordering shared
// and global memory among them.
template <bool kCluster, typename X>
__device__ inline void store_to(X* local, X x, int to) {
  if constexpr (kCluster) {
    *cg::this_cluster().map_shared_rank(local, to) = x;
  } else {
    *local = x;
  }
}

template <bool kCluster>
__device__ inline void sync_all() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Streamed route (see the design note).  Panel launch: the blocks of one
// matrix (a cluster of `blocks` where kCluster, else one) sweep columns
// [k0, k0 + kB) of w (the input, row stride ldw = n, for the first panel;
// the work matrix after) and write them to the work matrix `out` (row
// stride ld).  Block r holds rows r kHeld + tid + q
// kBlockedThreads in registers; where kSpill, its `spill` rows from
// blocks kHeld + r spill on in natural column order, in place in the
// work matrix's panel columns, where they stay in L2.  gather[e] takes the
// panel's row gather src, and sigma[e] the running row permutation,
// sigma'[i] = sigma[src[i]] (src[i] for the first panel).  The
// instantiation of one block with no spill is the kernel of n <= 1024:
// the cluster's ranks, its distributed stores and the spilled rows are
// compiled out of it.
template <typename T, int kRows, int kB, bool kCluster, bool kSpill>
__global__ void __launch_bounds__(kBlockedThreads, 1)
gj_streamed_panel_kernel(const T* w, int ldw, T* out, int ld, int* info, int* gather, int* sigma,
                         int n, int k0, int blocks, int spill) {
  constexpr int kHeld = kRows * kBlockedThreads;
  // A cluster's step publishes into one of two sets, by the parity of t.
  constexpr int kSets = kCluster ? 2 : 1;
  constexpr int kBlockSlots = kCluster ? kMaxCluster : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Raw and rotated: one block's pivot row, or each block's candidate row.
  __shared__ __align__(16) T cand_row[kSets][kBlockSlots][kB];
  __shared__ T oldk[kSets][kB];  // row k before the swap, rotated
  __shared__ T red_key[kSets][kBlockedWarps];  // the block's warp maxima
  __shared__ int red_idx[kSets][kBlockedWarps];
  __shared__ T blk_key[kSets][kBlockSlots];  // the cluster's block maxima
  __shared__ int blk_idx[kSets][kBlockSlots];
  int* src = reinterpret_cast<int*>(smem_raw);  // src[i]: the row as read that lands in row i

  const int nb = kCluster ? blocks : 1;
  const int rank = kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long e = kCluster ? blockIdx.x / nb : blockIdx.x;
  if (info[e] != 0) return;  // an earlier panel of this matrix failed
  const T* we = w + e * n * ldw;
  T* oe = out + e * n * ld;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int bk = min(kB, n - k0);
  const int row0 = rank * kHeld;  // the first register row
  // The spilled rows: first + m, m < count; row m, column k0 + c at sp[m ld + c].
  const int first = nb * kHeld + rank * spill;
  const int count = kSpill ? max(0, min(spill, n - first)) : 0;
  T* sp = oe + static_cast<long long>(first) * ld + k0;

  for (int i = tid; i < n; i += kBlockedThreads) src[i] = i;
  T v[kRows][kB];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = row0 + tid + q * kBlockedThreads;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      v[q][j] = i < n && j < bk ? we[static_cast<long long>(i) * ldw + k0 + j] : T(0);
    }
  }
  if constexpr (kSpill) {
    if (we != oe) {  // the first panel: the spilled rows' columns to the work matrix
      for (int idx = tid; idx < count * bk; idx += kBlockedThreads) {
        const int m = idx / bk;
        const int c = idx - m * bk;
        sp[static_cast<long long>(m) * ld + c] =
            we[static_cast<long long>(first + m) * ldw + k0 + c];
      }
    }
  }
  // Every block of the cluster has started before any writes to another.
  sync_all<kCluster>();

  // bk pivot steps, as in the blocked route, but with column k0 + t at
  // v[q][0] in step t: each step rotates a row left by one place, the
  // eliminated column's new entry going to the last place, so that no
  // register is indexed by t (no select tree).  The pivot row is broadcast
  // raw and every thread scales by the pivot itself.  First a block
  // barrier: the block's maximum over its warps' maxima.  One block: then
  // a second, behind which the rows p and k are in shared memory.  A
  // cluster: the warp that holds the block's candidate row, and the warp
  // that holds row k, store those rows into every block, and one cluster
  // barrier later every block reduces the blocks' maxima and reads the
  // pivot row from its own shared memory.
  for (int t = 0; t < bk; ++t) {
    const int k = k0 + t;
    const int set = kCluster ? t & 1 : 0;
    T key = T(-1);
    int idx = n;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = row0 + tid + q * kBlockedThreads;
      if (i >= k && i < n) take_max(key, idx, pivot_key(v[q][0]), i);
    }
    if constexpr (kSpill) {
      for (int m = tid; m < count; m += kBlockedThreads) {
        const T x = sp[static_cast<long long>(m) * ld + t];
        if (first + m >= k) take_max(key, idx, pivot_key(x), first + m);
      }
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const T other_key = __shfl_xor_sync(0xffffffffu, key, off);
      const int other_idx = __shfl_xor_sync(0xffffffffu, idx, off);
      take_max(key, idx, other_key, other_idx);
    }
    if (lane == 0) {
      red_key[set][warp] = key;
      red_idx[set][warp] = idx;
    }
    __syncthreads();
    key = red_key[set][0];
    idx = red_idx[set][0];
#pragma unroll
    for (int r = 1; r < kBlockedWarps; ++r) take_max(key, idx, red_key[set][r], red_idx[set][r]);
    int win = 0;  // the block whose candidate is the pivot row
    if constexpr (kCluster) {
      // The block's candidate row idx and row k, rotated as the register
      // rows are, to slot `rank` and to oldk of set `set` in every block,
      // and the block's maximum to slot `rank` of every block.  Set `set`
      // is next written in step t + 2, after the barrier of step t + 1,
      // which every thread reaches only once it has read this step's.
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int row = s == 0 ? idx : k;
        T* to = s == 0 ? cand_row[set][rank] : oldk[set];
        const int rel = row - row0;
        if (row < n && rel >= 0 && rel < kHeld && warp == rel % kBlockedThreads / kWarp) {
          // A register row of this warp: one entry a lane, by shuffles,
          // each lane storing its entry in every block.
          const int q_own = rel / kBlockedThreads;
          T mine = T(0);
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            T x = v[0][j];
#pragma unroll
            for (int q = 1; q < kRows; ++q) x = q == q_own ? v[q][j] : x;
            x = __shfl_sync(0xffffffffu, x, rel % kWarp);
            if (lane == j) mine = x;
          }
          if (lane < kB) {
            for (int b = 0; b < nb; ++b) store_to<kCluster>(to + lane, mine, b);
          }
        } else if (kSpill && row < n && row >= first && row < first + count && warp == 0) {
          // A spilled row of this block, written in the last step, before
          // the block barrier.
          if (lane < kB) {
            const int c = (t + lane) & (kB - 1);
            const T x = c < bk ? sp[static_cast<long long>(row - first) * ld + c] : T(0);
            for (int b = 0; b < nb; ++b) store_to<kCluster>(to + lane, x, b);
          }
        }
      }
      if (warp == 0 && lane < nb) {
        store_to<kCluster>(&blk_key[set][rank], key, lane);
        store_to<kCluster>(&blk_idx[set][rank], idx, lane);
      }
      sync_all<kCluster>();
      key = blk_key[set][0];
      idx = blk_idx[set][0];
      for (int b = 1; b < nb; ++b) {
        const T other_key = blk_key[set][b];
        const int other_idx = blk_idx[set][b];
        if (other_key > key || (other_key == key && other_idx < idx)) {
          key = other_key;
          idx = other_idx;
          win = b;
        }
      }
    }
    if (!(key > T(0) && key < T(INFINITY))) {  // the same in every thread of the cluster
      if (rank == 0 && tid == 0) info[e] = k + 1;
      return;
    }
    const int p = idx;
    if constexpr (!kCluster) {
      // The rows p and k go to the pivot row's slot and to oldk from the
      // thread that holds them or, for a spilled row, the first kB threads.
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = tid + q * kBlockedThreads;
        if (i == p) {
#pragma unroll
          for (int j = 0; j < kB; ++j) cand_row[0][0][j] = v[q][j];
        }
        if (i == k) {
#pragma unroll
          for (int j = 0; j < kB; ++j) oldk[0][j] = v[q][j];
        }
      }
      if constexpr (kSpill) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int row = s == 0 ? p : k;
          if (row >= first && row < first + count && tid < kB) {
            const int c = (t + tid) & (kB - 1);
            const T x = c < bk ? sp[static_cast<long long>(row - first) * ld + c] : T(0);
            (s == 0 ? cand_row[0][0] : oldk[0])[tid] = x;
          }
        }
      }
    }
    if (tid == 0) {
      const int s_k = src[k];
      src[k] = src[p];
      src[p] = s_k;
    }
    if constexpr (!kCluster) __syncthreads();
    const T* prow = cand_row[set][win];
    const T* old_row = oldk[set];
    const T inv_pivot = T(1) / prow[0];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = row0 + tid + q * kBlockedThreads;
      if (i == k) {
#pragma unroll
        for (int j = 0; j + 1 < kB; ++j) v[q][j] = inv_pivot * prow[j + 1];
        v[q][kB - 1] = inv_pivot;
      } else if (i < n) {
        if (i == p) {  // row p takes the old row k
#pragma unroll
          for (int j = 0; j < kB; ++j) v[q][j] = old_row[j];
        }
        const T f = v[q][0] * inv_pivot;
#pragma unroll
        for (int j = 0; j + 1 < kB; ++j) v[q][j] = fused_mul_add(-f, prow[j + 1], v[q][j + 1]);
        v[q][kB - 1] = -f;
      }
    }
    if constexpr (kSpill) {
      // The spilled rows, in natural order: column c is entry (c - t) mod
      // kB of the rotated rows.  Each is read and written by one thread.
      for (int m = tid; m < count; m += kBlockedThreads) {
        const int i = first + m;
        T* r = sp + static_cast<long long>(m) * ld;
        if (i == k) {
          for (int c = 0; c < bk; ++c) {
            r[c] = c == t ? inv_pivot : inv_pivot * prow[(c - t) & (kB - 1)];
          }
        } else {
          const bool moved = i == p;  // row p takes the old row k
          const T f = (moved ? old_row[0] : r[t]) * inv_pivot;
          for (int c = 0; c < bk; ++c) {
            const int j = (c - t) & (kB - 1);
            r[c] = c == t ? -f : fused_mul_add(-f, prow[j], moved ? old_row[j] : r[c]);
          }
        }
      }
    }
  }
  // tid 0's last swap of src, in a cluster (one block: since the last
  // step's second barrier).
  if constexpr (kCluster) __syncthreads();
  // A ragged last panel rotates on, without arithmetic, until each column
  // is back in its place (the padding columns stay zero).
  for (int t = bk; t < kB; ++t) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const T first_entry = v[q][0];
#pragma unroll
      for (int j = 0; j + 1 < kB; ++j) v[q][j] = v[q][j + 1];
      v[q][kB - 1] = first_entry;
    }
  }

  // The panel is M, the inverse's columns [k0, k0 + bk); the spilled rows
  // are already in place.
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = row0 + tid + q * kBlockedThreads;
    if (i < n) {
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        if (j < bk) oe[static_cast<long long>(i) * ld + k0 + j] = v[q][j];
      }
    }
  }
  // src is final.  Each row's slot of src then takes its new permutation
  // entry, which goes out once every block of the matrix has read the old
  // permutation.
  int* ge = gather + e * n;
  int* se = sigma + e * n;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = row0 + tid + q * kBlockedThreads;
    if (i < n) {
      ge[i] = src[i];
      if (k0 > 0) src[i] = se[src[i]];
    }
  }
  if constexpr (kSpill) {
    for (int m = tid; m < count; m += kBlockedThreads) {
      const int i = first + m;
      ge[i] = src[i];
      if (k0 > 0) src[i] = se[src[i]];
    }
  }
  sync_all<kCluster>();
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = row0 + tid + q * kBlockedThreads;
    if (i < n) se[i] = src[i];
  }
  if constexpr (kSpill) {
    for (int m = tid; m < count; m += kBlockedThreads) se[first + m] = src[first + m];
  }
}

// kBytes to shared memory with cp.async: the first src_bytes from global
// memory, zeros after them.
template <int kBytes>
__device__ inline void copy_async_zfill(void* to_shared, const void* from_global, int src_bytes) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(to_shared));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to), "l"(from_global),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(to), "l"(from_global),
                 "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ inline void copy_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int kPending>
__device__ inline void copy_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Stages `count` rows of a kB-wide strip into shared memory (row stride
// kB + kStreamPad): row r takes columns [col0, col0 + cols) of row rows[r]
// (row row0 + r where rows is null) of the matrix m of row stride ld, and
// zeros past `cols` and for r >= valid.  `vec`: 16-byte copies (ld a
// multiple of 16 bytes and m aligned); a copy that straddles `cols` reads
// only the entries before it, so an odd strip never reads a padding
// column.
template <typename T, int kB>
__device__ inline void stage_rows(T* to, const T* m, int ld, int col0, int cols, const int* rows,
                                  int row0, int count, int valid, bool vec) {
  constexpr int kLd = kB + kStreamPad;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPer = kB / kVec;
    for (int idx = threadIdx.x; idx < count * kPer; idx += blockDim.x) {
      const int r = idx / kPer;
      const int c = (idx - r * kPer) * kVec;
      const bool ok = r < valid && c < cols;
      const long long row = ok ? (rows ? rows[r] : row0 + r) : 0;
      const int bytes = ok ? min(cols - c, kVec) * static_cast<int>(sizeof(T)) : 0;
      copy_async_zfill<16>(to + r * kLd + c, m + row * ld + col0 + (ok ? c : 0), bytes);
    }
  } else {
    for (int idx = threadIdx.x; idx < count * kB; idx += blockDim.x) {
      const int r = idx / kB;
      const int c = idx - r * kB;
      const bool ok = r < valid && c < cols;
      const long long row = ok ? (rows ? rows[r] : row0 + r) : 0;
      copy_async_zfill<sizeof(T)>(to + r * kLd + c, m + row * ld + col0 + (ok ? c : 0),
                                  ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// D += A B for 16 x 8 outputs and four terms of the sum.  Lane (g, t),
// g = lane / 4, t = lane % 4, holds A[g][t], A[g + 8][t], B[t][g] and
// D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1] (as in mass_edge.cu).
__device__ inline void mma_pair(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// One warp's part of a row chunk's rank-kB product: rows r and r + 8 of
// the chunk (r = 16 (warp % kRowPairs) + g), columns c0 + 8 j + 2t and the
// next (j < kNcw), acc += M[rows, :] P[:, columns], M from the chunk's rows
// `ms`, P the staged pivot rows `pr`.
template <int kB, int kNcw>
__device__ inline void rank_update(double (&acc)[kNcw][4], const double* ms, const double* pr,
                                   int r, int c0, int g, int t) {
  constexpr int kLd = kB + kStreamPad;
#pragma unroll
  for (int s = 0; s < kB; s += 4) {
    const double a0 = ms[r * kLd + s + t];
    const double a1 = ms[(r + 8) * kLd + s + t];
#pragma unroll
    for (int j = 0; j < kNcw; ++j) mma_pair(acc[j], a0, a1, pr[(s + t) * kLd + c0 + 8 * j + g]);
  }
}

// The same ownership in f32, with FMAs.
template <int kB, int kNcw>
__device__ inline void rank_update(float (&acc)[kNcw][4], const float* ms, const float* pr,
                                   int r, int c0, int g, int t) {
  constexpr int kLd = kB + kStreamPad;
#pragma unroll 8
  for (int s = 0; s < kB; ++s) {
    const float a0 = ms[r * kLd + s];
    const float a1 = ms[(r + 8) * kLd + s];
#pragma unroll
    for (int j = 0; j < kNcw; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(pr + s * kLd + c0 + 8 * j + 2 * t);
      acc[j][0] = fmaf(a0, b.x, acc[j][0]);
      acc[j][1] = fmaf(a0, b.y, acc[j][1]);
      acc[j][2] = fmaf(a1, b.x, acc[j][2]);
      acc[j][3] = fmaf(a1, b.y, acc[j][3]);
    }
  }
}

__device__ inline void store_pair(double* to, double v0, double v1) {
  *reinterpret_cast<double2*>(to) = make_double2(v0, v1);
}
__device__ inline void store_pair(float* to, float v0, float v1) {
  *reinterpret_cast<float2*>(to) = make_float2(v0, v1);
}

template <typename T>
size_t streamed_update_bytes(int kb, int n) {
  const size_t ld = kb + kStreamPad;
  return (2 * kb * ld + kStreamStages * 2 * kStreamRows * ld) * sizeof(T) + n * sizeof(int);
}

// Update launch: one block per matrix and column tile other than the
// panel's, C'[i] = (i in K ? 0 : C[src[i]]) + sum_t M[i,t] C[src[k0 + t]],
// C read from w (row stride ldw; `vec_w`: its rows move in 16-byte
// pieces), M from the panel columns of the work matrix `out` (row stride
// ld; `vec`: likewise), C' written there.  Each warp owns 16
// rows and kB / kColGroups columns of every chunk of kStreamRows rows.
template <typename T, int kB>
__global__ void __launch_bounds__(kStreamThreads)
gj_streamed_update_kernel(const T* w, int ldw, int vec_w, T* out, int ld, int vec,
                          const int* info, const int* gather, int n, int k0) {
  constexpr int kLd = kB + kStreamPad;
  constexpr int kChunk = kStreamRows * kLd;
  constexpr int kNcw = kB / 8 / kColGroups;  // column blocks of 8 a warp
  static_assert(kNcw >= 1, "a warp owns whole column blocks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pr = reinterpret_cast<T*>(smem_raw);  // the pivot rows C[src[K]]
  T* qr = pr + kB * kLd;                    // the rows C[K] as read
  T* ring = qr + kB * kLd;                  // per stage: a chunk's M rows, then its C rows
  int* src = reinterpret_cast<int*>(ring + kStreamStages * 2 * kChunk);

  const int n_tiles = (n + kB - 1) / kB;
  const long long e = blockIdx.x / (n_tiles - 1);
  const int jt = blockIdx.x % (n_tiles - 1);
  if (info[e] != 0) return;  // this matrix's panel failed
  const int j0 = (jt < k0 / kB ? jt : jt + 1) * kB;
  const int wj = min(kB, n - j0);
  const int bk = min(kB, n - k0);
  const T* we = w + e * n * ldw;
  T* oe = out + e * n * ld;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = warp % kRowPairs * 16 + g;
  const int c0 = warp / kRowPairs * kNcw * 8;
  // Two neighbouring entries in one store (16 bytes in f64): an even ld
  // aligns them, and the second of a pair at the ragged edge of an odd n
  // is the padding column.
  const bool pairs = (ld & 1) == 0;

  for (int i = tid; i < n; i += kStreamThreads) src[i] = gather[e * n + i];
  __syncthreads();
  // Every row this block writes is read before its first store: the pivot
  // rows and the rows K here, the others in their own chunk.
  stage_rows<T, kB>(pr, we, ldw, j0, wj, src + k0, 0, kB, bk, vec_w);
  stage_rows<T, kB>(qr, we, ldw, j0, wj, nullptr, k0, kB, bk, vec_w);
  const int n_chunks = (n + kStreamRows - 1) / kStreamRows;
  auto request = [&](int c) {
    if (c < n_chunks) {
      T* stage = ring + (c % kStreamStages) * 2 * kChunk;
      const int i0 = c * kStreamRows;
      stage_rows<T, kB>(stage, oe, ld, k0, bk, nullptr, i0, kStreamRows, n - i0, vec);
      stage_rows<T, kB>(stage + kChunk, we, ldw, j0, wj, nullptr, i0, kStreamRows, n - i0, vec_w);
    }
    copy_async_commit();
  };
  for (int c = 0; c < kStreamStages - 1; ++c) request(c);

  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c has landed, and every warp is done with the stage that the
    // next request overwrites.
    copy_async_wait_pending<kStreamStages - 2>();
    __syncthreads();
    request(c + kStreamStages - 1);
    const T* ms = ring + (c % kStreamStages) * 2 * kChunk;
    const T* cs = ms + kChunk;
    const int i0 = c * kStreamRows;

    T acc[kNcw][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      const int i = i0 + r;
      const T* kept = nullptr;  // C[src[i]], or null for the rows K
      if (i < n && (i < k0 || i >= k0 + bk)) {
        const int s = src[i];
        kept = s == i ? cs + r * kLd : qr + (s - k0) * kLd;
      }
#pragma unroll
      for (int j = 0; j < kNcw; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        acc[j][2 * h] = kept ? kept[col] : T(0);
        acc[j][2 * h + 1] = kept ? kept[col + 1] : T(0);
      }
    }
    rank_update<kB, kNcw>(acc, ms, pr, r_lo, c0, g, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + r_lo + 8 * h;
      if (i >= n) continue;
      T* row = oe + static_cast<long long>(i) * ld + j0;
#pragma unroll
      for (int j = 0; j < kNcw; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        if (pairs) {
          if (col < wj) store_pair(row + col, acc[j][2 * h], acc[j][2 * h + 1]);
        } else {
          if (col < wj) row[col] = acc[j][2 * h];
          if (col + 1 < wj) row[col + 1] = acc[j][2 * h + 1];
        }
      }
    }
  }
  copy_async_wait_pending<0>();
}

// Column swaps: the row permutation, then one row of n entries per warp.
template <typename T>
size_t streamed_unswap_bytes(int n, int warps) {
  return (static_cast<size_t>(n) * sizeof(int) + 15) / 16 * 16 +
         static_cast<size_t>(warps) * n * sizeof(T);
}

// Column swaps of the streamed route: kUnswapRows rows of one matrix a
// block, one row at a time a warp, through shared memory; column c of the
// result `out` (row stride n) is column j of the swept work matrix (row
// stride ld; `out` itself where ld = n) where sigma[j] = c.  The block
// has as many warps as rows of n fit beside the permutation (at most 4).
template <typename T>
__global__ void __launch_bounds__(kUnswapThreads)
gj_streamed_unswap_kernel(const T* work, int ld, T* out, const int* info, const int* sigma,
                          int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = (n + kUnswapRows - 1) / kUnswapRows;
  const long long e = blockIdx.x / chunks;
  const int i0 = (blockIdx.x % chunks) * kUnswapRows;
  if (info[e] != 0) return;  // the matrix is singular
  int* col = reinterpret_cast<int*>(smem_raw);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  T* buf = reinterpret_cast<T*>(smem_raw + (static_cast<size_t>(n) * sizeof(int) + 15) / 16 * 16) +
           static_cast<size_t>(warp) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) col[sigma[e * n + j]] = j;
  __syncthreads();
  const int i1 = min(i0 + kUnswapRows, n);
  for (int i = i0 + warp; i < i1; i += warps) {
    const T* swept = work + (e * n + i) * ld;
    T* row = out + (e * n + i) * n;
    for (int j = lane; j < n; j += kWarp) buf[j] = swept[j];
    __syncwarp();
    for (int c = lane; c < n; c += kWarp) row[c] = buf[col[c]];
    __syncwarp();
  }
}

// Shared memory of a panel launch: the row gather src (dynamic), and the
// step's arrays (static): one block's pivot row, row k, warp maxima and
// block maximum, or a cluster's two sets of a candidate row a block, row
// k, the block's warp maxima and the blocks' maxima.
size_t streamed_panel_bytes(int n) { return (static_cast<size_t>(n) * sizeof(int) + 15) / 16 * 16; }

template <typename T>
size_t streamed_panel_static(int kb, bool cluster) {
  const size_t sets = cluster ? 2 : 1;
  const size_t block_slots = cluster ? kMaxCluster : 1;
  return sets * ((block_slots + 1) * kb * sizeof(T) +
                 (kBlockedWarps + block_slots) * (sizeof(T) + sizeof(int)));
}

// The whole streamed route for one call: ceil(n / kB) panel and update
// launches, then the column swaps, on `stream`.  The panel launch has
// `blocks` blocks per matrix, a cluster where that is above 1, and their
// rows beyond their registers spill to L2.  scratch holds gather
// [n_elem][n], then sigma [n_elem][n].  The panels and updates sweep a
// work matrix of row stride ld >= n: `out` itself where ld = n, else
// `work` ([n_elem][n][ld], its columns past n never read as data), which
// the column swaps then copy to `out`.  `limit`: the dynamic shared
// memory a block may opt in to.
template <typename T, int kRows, int kB>
int launch_streamed(const T* a, T* out, T* work, int* info, int* scratch, int n_elem, int n,
                    int blocks, int ld, size_t limit, cudaStream_t stream) {
  constexpr int kHeld = kRows * kBlockedThreads;
  // A cluster holds 32 columns (two rows of them a thread); no cluster
  // kernel is built for 16.
  constexpr bool kCluster = kB == kPanel;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (blocks < 1 || blocks > kMaxCluster || (blocks > 1 && !kCluster)) return invalid;
  if (ld < n || (ld > n && work == nullptr)) return invalid;
  if (ld == n) work = out;
  const long long held = static_cast<long long>(blocks) * kHeld;
  const int spill = n > held ? static_cast<int>((n - held + blocks - 1) / blocks) : 0;
  const size_t panel_smem = streamed_panel_bytes(n);
  const size_t panel_static = streamed_panel_static<T>(kB, blocks > 1);
  const size_t update_smem = streamed_update_bytes<T>(kB, n);
  int unswap_warps = kUnswapThreads / kWarp;
  while (unswap_warps > 1 && streamed_unswap_bytes<T>(n, unswap_warps) > limit) unswap_warps /= 2;
  const size_t unswap_smem = streamed_unswap_bytes<T>(n, unswap_warps);
  if (panel_smem + panel_static > limit || update_smem > limit || unswap_smem > limit) {
    return invalid;
  }
  void (*panel)(const T*, int, T*, int, int*, int*, int*, int, int, int, int) =
      blocks > 1 ? (spill > 0 ? gj_streamed_panel_kernel<T, kRows, kB, kCluster, true>
                              : gj_streamed_panel_kernel<T, kRows, kB, kCluster, false>)
                 : (spill > 0 ? gj_streamed_panel_kernel<T, kRows, kB, false, true>
                              : gj_streamed_panel_kernel<T, kRows, kB, false, false>);
  cudaError_t err = cudaFuncSetAttribute(panel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(panel_smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gj_streamed_update_kernel<T, kB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(update_smem));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gj_streamed_unswap_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(unswap_smem));
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(info, 0, n_elem * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long en = static_cast<long long>(n_elem) * n;
  int* gather = scratch;
  int* sigma = scratch + en;
  // Rows of 16-byte pieces: the work matrix's wherever ld is a multiple
  // of 16 bytes (the wrapper's plans), the input's where n is.
  constexpr int kVec = 16 / sizeof(T);
  const int vec = ld % kVec == 0 && reinterpret_cast<uintptr_t>(work) % 16 == 0;
  const int vec_a = n % kVec == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int n_tiles = (n + kB - 1) / kB;

  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(n_elem) * blocks));
  config.blockDim = dim3(kBlockedThreads);
  config.dynamicSmemBytes = panel_smem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = blocks > 1 ? 1 : 0;
  for (int k0 = 0; k0 < n; k0 += kB) {
    // The first panel reads the input, the later ones the work matrix.
    const T* w = k0 == 0 ? a : work;
    const int ldw = k0 == 0 ? n : ld;
    const int vec_w = k0 == 0 ? vec_a : vec;
    err = cudaLaunchKernelEx(&config, panel, w, ldw, work, ld, info, gather, sigma, n, k0, blocks,
                             spill);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err == cudaSuccess && n_tiles > 1) {
      const long long update_blocks = static_cast<long long>(n_elem) * (n_tiles - 1);
      gj_streamed_update_kernel<T, kB>
          <<<static_cast<unsigned>(update_blocks), kStreamThreads, update_smem, stream>>>(
              w, ldw, vec_w, work, ld, vec, info, gather, n, k0);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long unswap_blocks =
      static_cast<long long>(n_elem) * ((n + kUnswapRows - 1) / kUnswapRows);
  gj_streamed_unswap_kernel<T><<<static_cast<unsigned>(unswap_blocks), unswap_warps * kWarp,
                                 unswap_smem, stream>>>(work, ld, out, info, sigma, n);
  return static_cast<int>(cudaGetLastError());
}

// The current device and the dynamic shared memory a block may opt in to.
int smem_optin(int* device, int* bytes) {
  cudaError_t err = cudaGetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, *device);
  }
  return static_cast<int>(err);
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

// One call on the route the wrapper chose, after checking that the route
// takes n on this device; cudaErrorInvalidValue where it does not.
template <typename T>
int launch(const void* a, void* out, int* info, int* scratch, void* work, int n_elem, int n,
           int route, int panel, int blocks, int ld, void* stream) {
  if (n_elem <= 0 || n <= 0) return 0;
  int device = 0;
  int optin = 0;
  const int err = smem_optin(&device, &optin);
  if (err != 0) return err;
  const size_t limit = static_cast<size_t>(optin);
  const T* a_t = static_cast<const T*>(a);
  T* out_t = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case kRegisterRoute:
      if (n > kRegisterMaxN || register_route_bytes<T>(n) > limit) return invalid;
      return launch_register_for<T>(a_t, out_t, info, n_elem, n, device, s);
    case kBlockedRoute:
      if (n > kBlockedThreads || blocked_route_bytes<T>(n) > limit) return invalid;
      return launch_kernel(gj_inverse_blocked_kernel<T>, n_elem, kBlockedThreads,
                           blocked_route_bytes<T>(n), s, a_t, out_t, info, n);
    case kStreamedRoute:
      // Panel rows a thread holds: 32 entries in two rows, or 16 in four.
      if (scratch == nullptr) return invalid;
      if (panel == kPanel) {
        return launch_streamed<T, 2, kPanel>(a_t, out_t, static_cast<T*>(work), info, scratch,
                                             n_elem, n, blocks, ld, limit, s);
      }
      if (panel == kPanel / 2) {
        return launch_streamed<T, 4, kPanel / 2>(a_t, out_t, static_cast<T*>(work), info, scratch,
                                                 n_elem, n, blocks, ld, limit, s);
      }
      return invalid;
    default:
      return invalid;
  }
}

}  // namespace

// The inverses of n_elem n x n matrices a into out, on `stream`; info[e] is
// 0 or the first zero or non-finite pivot k+1 of matrix e.  route: 0
// register, 1 blocked, 2 streamed (panel: 32 or 16 columns; blocks: the
// panel launch's blocks per matrix, 1 to 8, whose rows beyond their
// registers spill to L2; scratch: 2 n_elem n ints; ld: the row stride of
// the work matrix, n (in place in out) or more, with work n_elem n ld
// entries).  Returns a CUDA error code.
extern "C" int mfv2d_gj_inverse_f64(const void* a, void* out, int* info, int* scratch, void* work,
                                    int n_elem, int n, int route, int panel, int blocks, int ld,
                                    void* stream) {
  return launch<double>(a, out, info, scratch, work, n_elem, n, route, panel, blocks, ld, stream);
}

extern "C" int mfv2d_gj_inverse_f32(const void* a, void* out, int* info, int* scratch, void* work,
                                    int n_elem, int n, int route, int panel, int blocks, int ld,
                                    void* stream) {
  return launch<float>(a, out, info, scratch, work, n_elem, n, route, panel, blocks, ld, stream);
}
