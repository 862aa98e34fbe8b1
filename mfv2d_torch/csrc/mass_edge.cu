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
// What bounds it.  Each of the E n1^2 outputs is written once and each of
// the 5 E nq Jacobian terms read once; the least arithmetic, using the
// symmetry of M1, is E n1 (n1 + 1) nq / 2 multiply-adds.  At E = 4096, p = 4
// (nq = 64, n1 = 40) that is 63 MB (19 us at 3.35 TB/s) against 0.43 GFLOP
// (6 us at the 67 TFLOP/s of the FP64 tensor cores): bytes.  At p = 8
// (nq = 144, n1 = 144) 0.70 GB (0.21 ms) against 12.3 GFLOP (0.18 ms):
// bytes again, but only if the multiply-adds run on the tensor cores at
// their full rate and are fed from shared memory at about a fragment load
// per MMA.  The basis tables are shared by every element.
//
// Design.
//   * One table.  The wrapper hands over both basis tables as one s-major,
//     zero-padded array tab[nq_pad][ld]: columns [0, n_h) hold bh, columns
//     [n_hp, n_hp + n_v) hold bv, n_hp = n_h rounded up to 8.  Every 8 x 8
//     block of the (padded) output then lies in one quadrant and takes one
//     metric row; a run of quadrature points is one contiguous range.
//   * Warp tiles and the 16-row MMA.  An element is cut into tiles of
//     2 MP x NC blocks of 8 x 8 (32 x 32 or 32 x 24 entries, whichever wastes
//     less at the given orders); one warp owns one tile of one element and
//     keeps its sums in registers over all nq.  In f64 two row blocks and
//     one column block are one mma.sync.m16n8k4 per four quadrature points.
//     On the H100 the m8n8k4 shape runs at the same rate per instruction
//     and so reaches only the vector rate, 33 TFLOP/s; m16n8k4 reaches 66.
//     All fragments are plain 8-byte loads from the table (ld = 4 mod 16
//     keeps them free of bank conflicts), the B fragments (the fewer) are
//     scaled by the metric row as they are loaded, and 2 MP + NC fragment
//     loads feed MP x NC MMAs.  f32 keeps the same ownership with FMAs (TF32
//     cannot hold 1e-5).  The MMAs themselves are what takes the time: with
//     the fragment loads cut out the kernel is no faster, and without the
//     scaling less than a tenth.
//   * Symmetry.  hh and vv are computed on and above the block diagonal and
//     hv once; the mirror images are stored straight from the accumulator
//     fragments (for a fixed column pair the eight row lanes of a fragment
//     are eight consecutive addresses of the transposed block).  Every entry
//     is stored once; no atomics, so the result is deterministic.
//   * A footprint set by the plan, not by the orders.  Up to 176 KB the
//     table stays resident in shared memory; above that it is streamed in
//     chunks of 4 to 32 quadrature points through a three-stage ring of
//     16-byte cp.async copies, one barrier per chunk, the sums staying in
//     registers across chunks.  The stream is periodic, so it runs on
//     across tiles and elements without a refill.
//   * Overlap.  A block takes `group` elements per step and keeps two sets
//     of their metric rows: the next step's Jacobian loads and divisions are
//     started before the current step's MMAs, with one barrier per step.
//   * The launch plan (warp tile, tile list, ld, chunk, stages, group,
//     warps) comes from the wrapper, mfv2d_torch/ops/kernels/mass_edge.py,
//     where it is checked without a card; launch() below only validates it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; the C entry points below are loaded with ctypes.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kBlock = 8;       // the tiling counts in blocks of 8 x 8 outputs
constexpr int kStep = 4;        // quadrature points per MMA
constexpr int kRingStages = 3;  // stages of the ring when the table is streamed
constexpr int kMaxThreads = 512;

// Quadrants in the tile codes (quadrant << 28 | tile row << 14 | tile column).
constexpr int kQuadHV = 1;

struct Plan {
  int mr, nc, ld, nq_pad, chunk, stages, group, warps, n_tiles;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline void copy_async16(void* to_shared, const void* from_global) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(to_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(from_global)
               : "memory");
}

__device__ inline void copy_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ inline void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// D += A B for 16 x 8 outputs and four quadrature points.  Lane (g, t),
// g = lane / 4, t = lane % 4, holds A[g][t], A[g + 8][t], B[t][g] and
// D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ inline void mma_pair(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ inline void store_pair(double* to, double v0, double v1) {
  *reinterpret_cast<double2*>(to) = make_double2(v0, v1);
}

__device__ inline void store_pair(float* to, float v0, float v1) {
  *reinterpret_cast<float2*>(to) = make_float2(v0, v1);
}

// One warp tile over `n_points` quadrature points of a table stage.  `rows`
// and `cols` point at the tile's first row and column block in the stage's
// first table row, `k` at the metric row of the same points.  Bit
// pi * NC + j of mask says whether the tile needs the MMA of row pair pi and
// column block j.  Every fragment is loaded,
// needed or not: one past the end of a quadrant reads the table's next
// columns or, from the ring's last row, at most 23 entries of the metric rows
// behind it, and feeds only output rows and columns that are never stored.
template <int MP, int NC>
__device__ inline void accumulate(double (&acc)[MP][NC][4], const double* rows,
                                  const double* cols, const double* k, int n_points,
                                  int ld, unsigned mask, int g, int t) {
  rows += t * ld + g;
  cols += t * ld + g;
  k += t;
#pragma unroll 1
  for (int s = 0; s < n_points; s += kStep) {
    const double ks = k[s];
    double a[MP][2];
    double b[NC];
#pragma unroll
    for (int i = 0; i < 2 * MP; ++i) {
      a[i / 2][i % 2] = rows[i * kBlock];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      b[j] = cols[j * kBlock] * ks;
    }
#pragma unroll
    for (int pi = 0; pi < MP; ++pi) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (mask >> (pi * NC + j) & 1u) mma_pair(acc[pi][j], a[pi][0], a[pi][1], b[j]);
      }
    }
    rows += kStep * ld;
    cols += kStep * ld;
  }
}

// The same ownership in f32, with FMAs.
template <int MP, int NC>
__device__ inline void accumulate(float (&acc)[MP][NC][4], const float* rows,
                                  const float* cols, const float* k, int n_points,
                                  int ld, unsigned mask, int g, int t) {
  rows += g;
  cols += 2 * t;
  for (int s = 0; s < n_points; ++s) {
    const float ks = k[s];
    float a[MP][2];
    float2 b[NC];
#pragma unroll
    for (int i = 0; i < 2 * MP; ++i) {
      a[i / 2][i % 2] = rows[i * kBlock];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      b[j] = *reinterpret_cast<const float2*>(cols + j * kBlock);
      b[j].x *= ks;
      b[j].y *= ks;
    }
#pragma unroll
    for (int pi = 0; pi < MP; ++pi) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (mask >> (pi * NC + j) & 1u) {
          acc[pi][j][0] += a[pi][0] * b[j].x;
          acc[pi][j][1] += a[pi][0] * b[j].y;
          acc[pi][j][2] += a[pi][1] * b[j].x;
          acc[pi][j][3] += a[pi][1] * b[j].y;
        }
      }
    }
    rows += ld;
    cols += ld;
  }
}

template <typename T, int MP, int NC>
__global__ void __launch_bounds__(kMaxThreads)
mass_edge_kernel(const T* __restrict__ j00, const T* __restrict__ j01,
                 const T* __restrict__ j10, const T* __restrict__ j11,
                 const T* __restrict__ det, const T* __restrict__ tab,
                 const T* __restrict__ w, const int* __restrict__ tiles,
                 T* __restrict__ out, int n_elem, int n_h, int n_v, int nq, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  const bool resident = p.stages == 1;
  const int n_chunks = p.nq_pad / p.chunk;
  const int chunk_elems = p.chunk * p.ld;
  const int k_set = p.group * 3 * p.nq_pad;
  T* ring = reinterpret_cast<T*>(smem_raw);     // [stages][chunk][ld]
  T* k_rows = ring + p.stages * chunk_elems;    // [2][group][hh, vv, hv][nq_pad]
  int* tile_codes = reinterpret_cast<int*>(k_rows + 2 * k_set);

  const int n1 = n_h + n_v;
  const int n_hp = round_up(n_h, kBlock);
  const int nq_steps = round_up(nq, kStep);  // points the MMAs walk over
  const int n_groups = (n_elem + p.group - 1) / p.group;
  const int n_items = p.group * p.n_tiles;
  const int n_batches = (n_items + p.warps - 1) / p.warps;
  // 16-byte stores of a fragment's column pair need even offsets throughout.
  const bool pair_stores = ((n1 | n_h) & 1) == 0;

  // Requests chunk `load_chunk` of the table into ring slot `load_slot` and
  // moves both on; the stream of chunks is periodic.
  int load_chunk = 0;
  int load_slot = 0;
  auto request_chunk = [&]() {
    const char* from = reinterpret_cast<const char*>(tab + static_cast<size_t>(load_chunk) * chunk_elems);
    char* to = reinterpret_cast<char*>(ring + load_slot * chunk_elems);
    const int n_vectors = chunk_elems * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < n_vectors; i += n_threads) copy_async16(to + 16 * i, from + 16 * i);
    copy_async_commit();
    load_chunk = load_chunk + 1 == n_chunks ? 0 : load_chunk + 1;
    load_slot = load_slot + 1 == p.stages ? 0 : load_slot + 1;
  };

  // The three metric rows of every element of group `grp` into set `set`,
  // zero beyond nq and beyond the batch.
  auto metric_rows = [&](int set, int grp) {
    T* k = k_rows + set * k_set;
#pragma unroll 2
    for (int i = tid; i < p.group * p.nq_pad; i += n_threads) {
      const int ge = i / p.nq_pad;
      const int s = i - ge * p.nq_pad;
      const long long e = static_cast<long long>(grp) * p.group + ge;
      T hh = T(0), vv = T(0), hv = T(0);
      if (e < n_elem && s < nq) {
        const long long at = e * nq + s;
        const T a00 = j00[at];
        const T a01 = j01[at];
        const T a10 = j10[at];
        const T a11 = j11[at];
        const T d = det[at];
        const T ws = w[s];
        hh = (a10 * a10 + a11 * a11) / d * ws;
        vv = (a00 * a00 + a01 * a01) / d * ws;
        hv = (a00 * a10 + a01 * a11) / d * ws;
      }
      T* ke = k + ge * 3 * p.nq_pad + s;
      ke[0] = hh;
      ke[p.nq_pad] = vv;
      ke[2 * p.nq_pad] = hv;
    }
  };

  const int n_prefetch = resident ? 1 : kRingStages - 1;
  for (int i = 0; i < n_prefetch; ++i) request_chunk();
  for (int i = tid; i < p.n_tiles; i += n_threads) tile_codes[i] = tiles[i];
  metric_rows(0, blockIdx.x);
  if (resident) copy_async_wait<0>();
  __syncthreads();

  int set = 0;
  int slot = 0;  // the ring slot of the chunk computed on next
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x, set ^= 1) {
    if (grp + gridDim.x < n_groups) metric_rows(set ^ 1, grp + gridDim.x);
    const T* k_group = k_rows + set * k_set;

    for (int batch = 0; batch < n_batches; ++batch) {
      // This warp's item: tile `item % n_tiles` of element `item / n_tiles`.
      const int item = batch * p.warps + warp;
      const int ge = item / p.n_tiles;
      const long long e = static_cast<long long>(grp) * p.group + ge;
      const bool active = item < n_items && e < n_elem;
      const int code = active ? tile_codes[item - ge * p.n_tiles] : 0;
      const int quad = code >> 28;
      const int rb0 = ((code >> 14) & 0x3fff) * 2 * MP;  // first row block, in its quadrant
      const int cb0 = (code & 0x3fff) * NC;              // first column block
      const bool rows_v = (quad & 2) != 0;
      const bool cols_v = ((quad + 1) & 2) != 0;
      const int q_rows = rows_v ? n_v : n_h;
      const int q_cols = cols_v ? n_v : n_h;
      const int nb_rows = (q_rows + kBlock - 1) / kBlock;
      const int nb_cols = (q_cols + kBlock - 1) / kBlock;
      const bool diagonal = rows_v == cols_v;

      // An MMA is needed if its upper row block is: the lower one lies
      // further below the diagonal and further down the quadrant.
      unsigned mask = 0;
      if (active) {
#pragma unroll
        for (int pi = 0; pi < MP; ++pi) {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int rb = rb0 + 2 * pi;
            if (rb < nb_rows && cb0 + j < nb_cols && !(diagonal && cb0 + j < rb)) {
              mask |= 1u << (pi * NC + j);
            }
          }
        }
      }
      const int row_at = (rows_v ? n_hp : 0) + rb0 * kBlock;  // in a table row
      const int col_at = (cols_v ? n_hp : 0) + cb0 * kBlock;
      const int k_kind = rows_v == cols_v ? (rows_v ? 1 : 0) : 2;
      const T* k_item = k_group + (ge * 3 + k_kind) * p.nq_pad;

      T acc[MP][NC][4];
#pragma unroll
      for (int pi = 0; pi < MP; ++pi) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[pi][j][v] = T(0);
        }
      }

      for (int c = 0; c < n_chunks; ++c) {
        if (!resident) {
          // Chunk c has landed, and every warp is done with the slot that
          // the next request overwrites.
          copy_async_wait<kRingStages - 2>();
          __syncthreads();
          request_chunk();
        }
        if (mask) {
          // The last chunk may end before the padding of the table does.
          const int at = c * p.chunk;
          const int n_points = nq_steps - at < p.chunk ? nq_steps - at : p.chunk;
          const T* stage = ring + slot * chunk_elems;
          accumulate<MP, NC>(acc, stage + row_at, stage + col_at, k_item + at, n_points,
                             p.ld, mask, g, t);
        }
        if (!resident) slot = slot + 1 == kRingStages ? 0 : slot + 1;
      }

      if (mask) {
        const int row_off = rows_v ? n_h : 0;
        const int col_off = cols_v ? n_h : 0;
        T* o = out + e * n1 * n1;
#pragma unroll
        for (int i = 0; i < 2 * MP; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            // Row block i of the tile is the upper (i even) or lower half
            // of an MMA; the block is stored unless it lies below the
            // diagonal of hh or vv.
            if (!(mask >> (i / 2 * NC + j) & 1u)) continue;
            if (diagonal && cb0 + j < rb0 + i) continue;
            const T v0 = acc[i / 2][j][2 * (i % 2)];
            const T v1 = acc[i / 2][j][2 * (i % 2) + 1];
            const int r = (rb0 + i) * kBlock + g;      // in the quadrant
            const int c = (cb0 + j) * kBlock + 2 * t;  // and c + 1
            if (r < q_rows) {
              T* to = o + static_cast<long long>(row_off + r) * n1 + col_off + c;
              if (pair_stores) {
                if (c < q_cols) store_pair(to, v0, v1);
              } else {
                if (c < q_cols) to[0] = v0;
                if (c + 1 < q_cols) to[1] = v1;
              }
              const bool mirror = quad == kQuadHV || (diagonal && cb0 + j > rb0 + i);
              if (mirror) {
                T* m = o + static_cast<long long>(col_off + c) * n1 + row_off + r;
                if (c < q_cols) m[0] = v0;
                if (c + 1 < q_cols) m[n1] = v1;
              }
            }
          }
        }
      }
    }
    // The next step's metric rows are written; this step's are free.
    __syncthreads();
  }
  copy_async_wait<0>();
}

template <typename T, int MP, int NC>
int launch_tile(const void* j00, const void* j01, const void* j10, const void* j11,
                const void* det, const void* tab, const void* w, const void* tiles,
                void* out, int n_elem, int n_h, int n_v, int nq, const Plan& p,
                cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(p.stages) * p.chunk * p.ld + 2 * static_cast<size_t>(p.group) * 3 * p.nq_pad) *
          sizeof(T) +
      static_cast<size_t>(round_up(p.n_tiles, 4)) * sizeof(int);
  const int threads = p.warps * 32;

  // The blocks that fit the card at once, asked for again only when the
  // device, the block size or the shared memory differ from the last launch.
  static std::mutex guard;
  static int last_device = -1;
  static int last_threads = 0;
  static size_t last_smem = 0;
  static long long last_blocks = 0;
  long long resident_blocks = 0;
  {
    std::lock_guard<std::mutex> lock(guard);
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (device != last_device || threads != last_threads || smem != last_smem) {
      int n_sm = 0;
      int smem_optin = 0;
      int per_sm = 0;
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                     device);
      }
      if (err == cudaSuccess && smem > static_cast<size_t>(smem_optin)) {
        err = cudaErrorInvalidConfiguration;
      }
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(mass_edge_kernel<T, MP, NC>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mass_edge_kernel<T, MP, NC>, threads, smem);
      }
      if (err == cudaSuccess && per_sm < 1) {
        err = cudaErrorInvalidConfiguration;
      }
      if (err != cudaSuccess) {
        return static_cast<int>(err);
      }
      last_device = device;
      last_threads = threads;
      last_smem = smem;
      last_blocks = static_cast<long long>(per_sm) * n_sm;
    }
    resident_blocks = last_blocks;
  }
  const long long n_groups = (static_cast<long long>(n_elem) + p.group - 1) / p.group;
  const int grid = static_cast<int>(n_groups < resident_blocks ? n_groups : resident_blocks);
  mass_edge_kernel<T, MP, NC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(j00), static_cast<const T*>(j01), static_cast<const T*>(j10),
      static_cast<const T*>(j11), static_cast<const T*>(det), static_cast<const T*>(tab),
      static_cast<const T*>(w), static_cast<const int*>(tiles), static_cast<T*>(out),
      n_elem, n_h, n_v, nq, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* j00, const void* j01, const void* j10, const void* j11,
           const void* det, const void* tab, const void* w, const void* tiles,
           void* out, int n_elem, int n_h, int n_v, int nq, const int* plan,
           void* stream) {
  if (n_elem <= 0) {
    return 0;
  }
  const Plan p = {plan[0], plan[1], plan[2], plan[3], plan[4],
                  plan[5], plan[6], plan[7], plan[8]};
  const int n1_pad = round_up(n_h, kBlock) + round_up(n_v, kBlock);
  const bool ring_ok = p.stages == 1 ? p.chunk == p.nq_pad : p.stages == kRingStages;
  if (n_h < 1 || n_v < 1 || nq < 1 || p.ld < n1_pad || p.ld % 4 != 0 || p.nq_pad < nq ||
      p.chunk < kStep || p.chunk % kStep != 0 || p.nq_pad % p.chunk != 0 || !ring_ok ||
      p.group < 1 || p.warps < 1 || p.warps * 32 > kMaxThreads || p.n_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The warp tile is mr x nc blocks: mr / 2 row pairs of 16.
  if (p.mr == 4 && p.nc == 4) {
    return launch_tile<T, 2, 4>(j00, j01, j10, j11, det, tab, w, tiles, out, n_elem, n_h,
                                n_v, nq, p, s);
  }
  if (p.mr == 4 && p.nc == 3) {
    return launch_tile<T, 2, 3>(j00, j01, j10, j11, det, tab, w, tiles, out, n_elem, n_h,
                                n_v, nq, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int mfv2d_mass_edge_f64(const void* j00, const void* j01, const void* j10,
                                   const void* j11, const void* det, const void* tab,
                                   const void* w, const void* tiles, void* out,
                                   int n_elem, int n_h, int n_v, int nq, const int* plan,
                                   void* stream) {
  return launch<double>(j00, j01, j10, j11, det, tab, w, tiles, out, n_elem, n_h, n_v, nq,
                        plan, stream);
}

extern "C" int mfv2d_mass_edge_f32(const void* j00, const void* j01, const void* j10,
                                   const void* j11, const void* det, const void* tab,
                                   const void* w, const void* tiles, void* out,
                                   int n_elem, int n_h, int n_v, int nq, const int* plan,
                                   void* stream) {
  return launch<float>(j00, j01, j10, j11, det, tab, w, tiles, out, n_elem, n_h, n_v, nq,
                       plan, stream);
}
