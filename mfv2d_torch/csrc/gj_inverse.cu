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
// What bounds it.  2 n^3 flops per matrix.  E = 4096, n = 56 (mixed Poisson,
// p = 4), f64: 1.44 GFLOP and 2 x 103 MB of HBM traffic.  E = 4096, n = 208
// (p = 8): 73.7 GFLOP and 2 x 1.42 GB, compute-bound at the FP64 vector rate:
// at least 2.2 ms at 34 TFLOP/s (NVIDIA data sheet, H100 SXM).  Each of the n
// steps is a rank-1 update of the whole matrix behind a pivot reduction, so
// the sweep is a chain of n block-wide barriers.
//
// Design.  One thread block per matrix, threads laid out 32 wide over
// columns (coalesced rows) and up to 32 deep over rows.
//   - Shared route: where n^2 values plus scratch fit the opted-in dynamic
//     shared memory (227 KB: n <= 169 in f64, 239 in f32), the matrix is
//     loaded once, swept in shared memory and stored once, so HBM sees one
//     read and one write.  This covers the n = 56 and n = 121 element
//     blocks.
//   - Global route: beyond that (n = 208, 289 at p = 8) the sweep runs in
//     place on the output in global memory (L2-resident while the blocks in
//     flight fit the 50 MB L2), and only the scaled pivot row and the pivot
//     column are staged in shared memory at each step.  Every step then
//     rewrites the whole matrix through L2 or HBM, which makes this route
//     slower than torch.linalg.inv at n = 208 (times in PERF.md).
// Both routes are the same templated body.  FP64 tensor-core MMA (DMMA),
// blocked panels with TMA streaming, and thread-block clusters for the large
// blocks are left to later work.
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

int smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  return static_cast<int>(err);
}

template <typename T>
int uses_shared(int n) {
  int optin = 0;
  const int err = smem_optin(&optin);
  if (err != 0) return -err;
  return shared_route_bytes<T>(n) <= static_cast<size_t>(optin) ? 1 : 0;
}

template <typename T, bool kShared>
int launch_route(const T* a, T* out, int* info, int n_elem, int n, size_t smem,
                 cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_kernel<T, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block_threads(n);
  const dim3 block(kWarp, threads / kWarp);
  gj_inverse_kernel<T, kShared><<<n_elem, block, smem, stream>>>(a, out, info, n);
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
  const size_t shared = shared_route_bytes<T>(n);
  if (shared <= static_cast<size_t>(optin)) {
    return launch_route<T, true>(a_t, out_t, info, n_elem, n, shared, s);
  }
  const size_t scratch = scratch_bytes<T>(n);
  if (scratch > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return launch_route<T, false>(a_t, out_t, info, n_elem, n, scratch, s);
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

// 1 where an n x n matrix takes the shared-memory route on the current
// device, 0 where it takes the global-memory route, minus a CUDA error code.
extern "C" int mfv2d_gj_inverse_shared_f64(int n) { return uses_shared<double>(n); }

extern "C" int mfv2d_gj_inverse_shared_f32(int n) { return uses_shared<float>(n); }
