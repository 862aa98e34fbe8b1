// 1-form mass matrices M1 for a batch of bilinear quad elements, on Hopper.
//
// Replaces the Pallas TPU kernel mass_edge_pallas / _mass_edge_kernel
// (mfv2d_tpu/ops/pallas_mass.py).  For element e, with the metric factors
// formed at the nq quadrature points
//
//   k_hh = (j10^2 + j11^2) / det * w
//   k_vv = (j00^2 + j01^2) / det * w
//   k_hv = (j00 j10 + j01 j11) / det * w
//
// the output tile is
//
//   M1[e] = [[bh diag(k_hh) bh^T, bh diag(k_hv) bv^T],
//            [bv diag(k_hv) bh^T, bv diag(k_vv) bv^T]]     ([n1, n1], n1 = n_h + n_v)
//
// What bounds it.  At E = 4096, p = 4 (nq = 64, n1 = 40) the kernel writes
// 52 MB of f64 output (16 us at 3.35 TB/s), reads 10.5 MB of Jacobian terms
// and does 0.42 G FP64 FMAs (0.84 GFLOP, 25 us at the 33.5 TFLOP/s FP64
// vector rate).  The basis tables are shared by every element, so the cost
// that decides the design is feeding the FMAs from on-chip memory.
//
// Design.  A persistent grid: each block copies bh and bv once, transposed
// to s-major [nq][ld] tables in shared memory (ld = max(n_h, n_v) rounded
// up to 4, zero padded), then walks over elements e = blockIdx.x,
// blockIdx.x + gridDim.x, ...  For each element it stages the three metric
// rows in shared memory, and every thread computes 4x4 output tiles of one
// quadrant (hh, hv, vh or vv) from the quadrant's row table, column table
// and metric row: per quadrature point two 4-wide vector loads feed 16 FMAs
// in registers.  Every output entry is stored once; no atomics, so the
// result is deterministic.  FP64 tensor-core MMA (DMMA) and TMA staging
// are left to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; the C entry points below are loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;
constexpr int kMaxThreads = 256;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Four consecutive values from 16-byte-aligned shared memory.
__device__ inline void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ inline void load4(const float* p, float (&v)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <typename T>
size_t smem_bytes(int nq, int ld) {
  return (2 * static_cast<size_t>(nq) * ld + 3 * static_cast<size_t>(nq)) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mass_edge_kernel(const T* __restrict__ j00, const T* __restrict__ j01,
                 const T* __restrict__ j10, const T* __restrict__ j11,
                 const T* __restrict__ det, const T* __restrict__ bh,
                 const T* __restrict__ bv, const T* __restrict__ w,
                 T* __restrict__ out, int n_elem, int n_h, int n_v, int nq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = round_up(n_h > n_v ? n_h : n_v, kTile);
  T* tab_h = reinterpret_cast<T*>(smem_raw);  // [nq][ld], tab_h[s][r] = bh[r][s]
  T* tab_v = tab_h + nq * ld;                  // [nq][ld], tab_v[s][r] = bv[r][s]
  T* k_hh = tab_v + nq * ld;
  T* k_vv = k_hh + nq;
  T* k_hv = k_vv + nq;

  for (int i = threadIdx.x; i < nq * ld; i += blockDim.x) {
    const int s = i / ld;
    const int r = i - s * ld;
    tab_h[i] = r < n_h ? bh[r * nq + s] : T(0);
    tab_v[i] = r < n_v ? bv[r * nq + s] : T(0);
  }

  const int n1 = n_h + n_v;
  const int tiles_h = (n_h + kTile - 1) / kTile;
  const int tiles_1 = tiles_h + (n_v + kTile - 1) / kTile;
  const int n_tiles = tiles_1 * tiles_1;

  for (long long e = blockIdx.x; e < n_elem; e += gridDim.x) {
    __syncthreads();  // tables staged; the previous element's metric rows are free
    const long long base = e * nq;
    for (int s = threadIdx.x; s < nq; s += blockDim.x) {
      const T a00 = j00[base + s];
      const T a01 = j01[base + s];
      const T a10 = j10[base + s];
      const T a11 = j11[base + s];
      const T d = det[base + s];
      const T ws = w[s];
      k_hh[s] = (a10 * a10 + a11 * a11) / d * ws;
      k_vv[s] = (a00 * a00 + a01 * a01) / d * ws;
      k_hv[s] = (a00 * a10 + a01 * a11) / d * ws;
    }
    __syncthreads();

    T* o = out + e * static_cast<long long>(n1) * n1;
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const int rb = t / tiles_1;
      const int cb = t - rb * tiles_1;
      const bool row_h = rb < tiles_h;
      const bool col_h = cb < tiles_h;
      const int r0 = (row_h ? rb : rb - tiles_h) * kTile;
      const int c0 = (col_h ? cb : cb - tiles_h) * kTile;
      const T* ta = (row_h ? tab_h : tab_v) + r0;
      const T* tb = (col_h ? tab_h : tab_v) + c0;
      const T* k = row_h ? (col_h ? k_hh : k_hv) : (col_h ? k_hv : k_vv);

      T acc[kTile][kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] = T(0);
      }
      for (int s = 0; s < nq; ++s) {
        T a[kTile];
        T b[kTile];
        load4(ta + s * ld, a);
        load4(tb + s * ld, b);
        const T ks = k[s];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const T ak = a[i] * ks;
#pragma unroll
          for (int j = 0; j < kTile; ++j) acc[i][j] += ak * b[j];
        }
      }

      const int n_rows = row_h ? n_h : n_v;
      const int n_cols = col_h ? n_h : n_v;
      const int row_off = row_h ? 0 : n_h;
      const int col_off = col_h ? 0 : n_h;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (r0 + i >= n_rows) break;
        T* orow = o + static_cast<long long>(row_off + r0 + i) * n1 + col_off + c0;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          if (c0 + j < n_cols) orow[j] = acc[i][j];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* j00, const void* j01, const void* j10, const void* j11,
           const void* det, const void* bh, const void* bv, const void* w,
           void* out, int n_elem, int n_h, int n_v, int nq, void* stream) {
  if (n_elem <= 0) {
    return 0;
  }
  const int ld = round_up(n_h > n_v ? n_h : n_v, kTile);
  const size_t smem = smem_bytes<T>(nq, ld);
  const int tiles_1 = (n_h + kTile - 1) / kTile + (n_v + kTile - 1) / kTile;
  int threads = round_up(tiles_1 * tiles_1, 32);
  threads = threads < kMaxThreads ? threads : kMaxThreads;

  int device = 0;
  int n_sm = 0;
  int smem_optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (smem > static_cast<size_t>(smem_optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(mass_edge_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mass_edge_kernel<T>,
                                                        threads, smem);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long resident = static_cast<long long>(per_sm) * n_sm;
  const int grid = static_cast<int>(n_elem < resident ? n_elem : resident);
  mass_edge_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(j00), static_cast<const T*>(j01),
      static_cast<const T*>(j10), static_cast<const T*>(j11),
      static_cast<const T*>(det), static_cast<const T*>(bh),
      static_cast<const T*>(bv), static_cast<const T*>(w), static_cast<T*>(out),
      n_elem, n_h, n_v, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mfv2d_mass_edge_f64(const void* j00, const void* j01,
                                   const void* j10, const void* j11,
                                   const void* det, const void* bh,
                                   const void* bv, const void* w, void* out,
                                   int n_elem, int n_h, int n_v, int nq,
                                   void* stream) {
  return launch<double>(j00, j01, j10, j11, det, bh, bv, w, out, n_elem, n_h,
                        n_v, nq, stream);
}

extern "C" int mfv2d_mass_edge_f32(const void* j00, const void* j01,
                                   const void* j10, const void* j11,
                                   const void* det, const void* bh,
                                   const void* bv, const void* w, void* out,
                                   int n_elem, int n_h, int n_v, int nq,
                                   void* stream) {
  return launch<float>(j00, j01, j10, j11, det, bh, bv, w, out, n_elem, n_h,
                       n_v, nq, stream);
}
