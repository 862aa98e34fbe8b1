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
//   * The launch plan (route, warp tile, tile or panel list, ld, chunk,
//     stages, group, warps, panel) comes from the wrapper,
//     mfv2d_torch/ops/kernels/mass_edge.py, where it is checked without a
//     card; launch() below only validates it.
//
// The panel route, for batches too small to fill the card.  The element
// route above gives a block whole elements: at p = 16 (n1 = 544, nq = 400)
// and E = 16 that is 4 blocks of 16 warps for 132 SMs, each walking 171
// warp tiles of an element in 11 rounds and streaming the whole 1.75 MB
// table every round in chunks of 8 points (three stages of 548-entry rows
// must fit 176 KB), one barrier per two MMA k-steps.  The work is
// E n1 (n1 + 1) nq = 1.9 GFLOP, 0.028 ms at the 67 TFLOP/s of the FP64
// tensor cores: operations bound it, and the element route leaves 128
// SMs idle.  So:
//   * A block owns one panel of one element: R x C warp tiles of one
//     quadrant (128 x 128 entries at 4 x 4 tiles of 32 x 32), one warp a
//     tile; hh and vv panels below the diagonal have no block, hv panels
//     are computed once.  The grid is one block per (panel, element) item,
//     the panels with the most MMAs first, so the largest items start
//     first.  The wrapper takes this route, and 4 x 4 or 2 x 2 tiles, where
//     it gives the busiest SM the fewest rounds of warp tiles: at p = 16,
//     E = 16, 336 items in 3 rounds against 43 rounds of whole elements.
//     Every entry is still stored by exactly one block, with no atomics.
//   * A block streams only its slice of the table: the columns of the
//     panel's rows and of its columns (one range for a panel on the
//     diagonal), cut at the end of the quadrant, with 16-byte cp.async
//     copies out of the same padded table.  A ring stage row is two panel
//     widths, not ld: at p = 16 a stage holds 32 points, not 8, so a
//     barrier comes once per eight k-steps.  Offsets into the one table
//     keep one device copy per basis and dtype for both routes, where a
//     layout per panel would hold the same columns once per panel.
//   * The warp tiles, the metric-scaled B fragments, the MMAs, the masks
//     and the mirror stores are the element route's; a block forms only
//     the metric row of its quadrant for its element.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; the C entry points below are loaded with ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <mutex>

namespace {

constexpr int kBlock = 8;       // the tiling counts in blocks of 8 x 8 outputs
constexpr int kStep = 4;        // quadrature points per MMA
constexpr int kRingStages = 3;  // stages of the ring when the table is streamed
constexpr int kMaxThreads = 512;

// Quadrants in the tile and panel codes (quadrant << 28 | row << 14 | column).
constexpr int kQuadHV = 1;
// Routes: whole elements a block, or one panel of one element a block.
constexpr int kRouteElement = 0;
constexpr int kRoutePanel = 1;

struct Plan {
  int mr, nc, ld, nq_pad, chunk, stages, group, warps, n_tiles;
  // The panel route's panel, in warp tiles, and the row length of its ring.
  int route, panel_rows, panel_cols, slice_ld;
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

// Metric factor `kind` (0: k_hh, 1: k_vv, 2: k_hv) at one quadrature point.
template <typename T>
__device__ inline T metric_factor(int kind, T a00, T a01, T a10, T a11, T d, T ws) {
  const T num = kind == 0   ? a10 * a10 + a11 * a11
                : kind == 1 ? a00 * a00 + a01 * a01
                            : a00 * a10 + a01 * a11;
  return num / d * ws;
}

// One quadrant of M1 (0 hh, 1 hv, 2 vv): whether its rows and columns are
// the v part, its size in entries and in blocks of 8, where it starts in
// M1, and which metric row it takes.
struct Quadrant {
  bool rows_v, cols_v, diagonal;
  int q_rows, q_cols, nb_rows, nb_cols, row_off, col_off, k_kind;

  __device__ Quadrant(int quad, int n_h, int n_v)
      : rows_v((quad & 2) != 0), cols_v(((quad + 1) & 2) != 0), diagonal(rows_v == cols_v),
        q_rows(rows_v ? n_v : n_h), q_cols(cols_v ? n_v : n_h),
        nb_rows((q_rows + kBlock - 1) / kBlock), nb_cols((q_cols + kBlock - 1) / kBlock),
        row_off(rows_v ? n_h : 0), col_off(cols_v ? n_h : 0),
        k_kind(diagonal ? (rows_v ? 1 : 0) : 2) {}
};

// The MMAs a warp tile from row block rb0 and column block cb0 needs: bit
// pi * NC + j for row pair pi and column block j.  An MMA is needed if its
// upper row block is: the lower one lies further below the diagonal and
// further down the quadrant.
template <int MP, int NC>
__device__ inline unsigned tile_mask(const Quadrant& q, int rb0, int cb0) {
  unsigned mask = 0;
#pragma unroll
  for (int pi = 0; pi < MP; ++pi) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int rb = rb0 + 2 * pi;
      if (rb < q.nb_rows && cb0 + j < q.nb_cols && !(q.diagonal && cb0 + j < rb)) {
        mask |= 1u << (pi * NC + j);
      }
    }
  }
  return mask;
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

// Stores a warp tile's sums into o, the element's M1, with their mirror
// images: hv whole, hh and vv above the block diagonal.
template <typename T, int MP, int NC>
__device__ inline void store_tile(const T (&acc)[MP][NC][4], T* o, const Quadrant& q,
                                  int quad, int rb0, int cb0, unsigned mask, int n1,
                                  bool pair_stores, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2 * MP; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      // Row block i of the tile is the upper (i even) or lower half
      // of an MMA; the block is stored unless it lies below the
      // diagonal of hh or vv.
      if (!(mask >> (i / 2 * NC + j) & 1u)) continue;
      if (q.diagonal && cb0 + j < rb0 + i) continue;
      const T v0 = acc[i / 2][j][2 * (i % 2)];
      const T v1 = acc[i / 2][j][2 * (i % 2) + 1];
      const int r = (rb0 + i) * kBlock + g;      // in the quadrant
      const int c = (cb0 + j) * kBlock + 2 * t;  // and c + 1
      if (r < q.q_rows) {
        T* to = o + static_cast<long long>(q.row_off + r) * n1 + q.col_off + c;
        if (pair_stores) {
          if (c < q.q_cols) store_pair(to, v0, v1);
        } else {
          if (c < q.q_cols) to[0] = v0;
          if (c + 1 < q.q_cols) to[1] = v1;
        }
        const bool mirror = quad == kQuadHV || (q.diagonal && cb0 + j > rb0 + i);
        if (mirror) {
          T* m = o + static_cast<long long>(q.col_off + c) * n1 + q.row_off + r;
          if (c < q.q_cols) m[0] = v0;
          if (c + 1 < q.q_cols) m[n1] = v1;
        }
      }
    }
  }
}

// The element route: a block takes `group` elements per step.
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
        hh = metric_factor(0, a00, a01, a10, a11, d, ws);
        vv = metric_factor(1, a00, a01, a10, a11, d, ws);
        hv = metric_factor(2, a00, a01, a10, a11, d, ws);
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
      const Quadrant q(quad, n_h, n_v);
      const unsigned mask = active ? tile_mask<MP, NC>(q, rb0, cb0) : 0u;
      const int row_at = (q.rows_v ? n_hp : 0) + rb0 * kBlock;  // in a table row
      const int col_at = (q.cols_v ? n_hp : 0) + cb0 * kBlock;
      const T* k_item = k_group + (ge * 3 + q.k_kind) * p.nq_pad;

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
        store_tile<T, MP, NC>(acc, out + e * n1 * n1, q, quad, rb0, cb0, mask, n1,
                              pair_stores, g, t);
      }
    }
    // The next step's metric rows are written; this step's are free.
    __syncthreads();
  }
  copy_async_wait<0>();
}

// The panel route: block b takes panel b / n_elem of element b % n_elem
// (the list has the panels with the most MMAs first), one warp a warp tile.
template <typename T, int MP, int NC>
__global__ void __launch_bounds__(kMaxThreads)
mass_edge_panel_kernel(const T* __restrict__ j00, const T* __restrict__ j01,
                       const T* __restrict__ j10, const T* __restrict__ j11,
                       const T* __restrict__ det, const T* __restrict__ tab,
                       const T* __restrict__ w, const int* __restrict__ panels,
                       T* __restrict__ out, int n_elem, int n_h, int n_v, int nq, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  const int n_chunks = p.nq_pad / p.chunk;
  const int stage_elems = p.chunk * p.slice_ld;
  T* ring = reinterpret_cast<T*>(smem_raw);   // [kRingStages][chunk][slice_ld]
  T* k = ring + kRingStages * stage_elems;    // [nq_pad]

  const int n1 = n_h + n_v;
  const int n_hp = round_up(n_h, kBlock);
  const int nq_steps = round_up(nq, kStep);
  const bool pair_stores = ((n1 | n_h) & 1) == 0;

  const int panel = blockIdx.x / n_elem;
  const long long e = blockIdx.x - static_cast<long long>(panel) * n_elem;
  const int code = panels[panel];
  const int quad = code >> 28;
  const Quadrant q(quad, n_h, n_v);
  const int span_r = p.panel_rows * 2 * MP;  // the panel, in blocks
  const int span_c = p.panel_cols * NC;
  const int pr0 = ((code >> 14) & 0x3fff) * span_r;  // its first row and column block
  const int pc0 = (code & 0x3fff) * span_c;

  // The slice: the table columns of the panel's rows, then those of its
  // columns, each cut at the end of its quadrant; a panel whose rows and
  // columns are the same blocks streams them once.
  const int row_from = (q.rows_v ? n_hp : 0) + pr0 * kBlock;
  const int col_from = (q.cols_v ? n_hp : 0) + pc0 * kBlock;
  const int row_len = min(span_r, q.nb_rows - pr0) * kBlock;
  const int col_len = min(span_c, q.nb_cols - pc0) * kBlock;
  const bool one_range = row_from == col_from && row_len == col_len;
  const int col_base = one_range ? 0 : span_r * kBlock;  // in a stage row
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // entries a 16-byte copy
  const int row_vecs = row_len / kVec;
  const int point_vecs = row_vecs + (one_range ? 0 : col_len / kVec);

  // Requests the slice of chunk `load_chunk` into ring slot `load_slot`;
  // past the last chunk it commits empty groups, so the waits count alike.
  int load_chunk = 0;
  int load_slot = 0;
  auto request_chunk = [&]() {
    if (load_chunk < n_chunks) {
      const T* from = tab + static_cast<size_t>(load_chunk) * p.chunk * p.ld;
      T* to = ring + load_slot * stage_elems;
      for (int i = tid; i < p.chunk * point_vecs; i += n_threads) {
        const int s = i / point_vecs;
        const int v = i - s * point_vecs;
        const bool row_part = v < row_vecs;
        const int from_col = row_part ? row_from + v * kVec : col_from + (v - row_vecs) * kVec;
        const int to_col = row_part ? v * kVec : col_base + (v - row_vecs) * kVec;
        copy_async16(to + s * p.slice_ld + to_col, from + static_cast<size_t>(s) * p.ld + from_col);
      }
    }
    copy_async_commit();
    ++load_chunk;
    load_slot = load_slot + 1 == kRingStages ? 0 : load_slot + 1;
  };

  for (int i = 0; i < kRingStages - 1; ++i) request_chunk();
  // The metric row of the panel's quadrant for element e, zero beyond nq;
  // the first barrier below publishes it.
  for (int s = tid; s < p.nq_pad; s += n_threads) {
    T v = T(0);
    if (s < nq) {
      const long long at = e * nq + s;
      v = metric_factor(q.k_kind, j00[at], j01[at], j10[at], j11[at], det[at], w[s]);
    }
    k[s] = v;
  }

  const int rb0 = pr0 + (warp / p.panel_cols) * 2 * MP;  // this warp's tile
  const int cb0 = pc0 + (warp % p.panel_cols) * NC;
  const unsigned mask = tile_mask<MP, NC>(q, rb0, cb0);
  const int row_at = (rb0 - pr0) * kBlock;  // in a stage row
  const int col_at = col_base + (cb0 - pc0) * kBlock;

  T acc[MP][NC][4];
#pragma unroll
  for (int pi = 0; pi < MP; ++pi) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[pi][j][v] = T(0);
    }
  }

  int slot = 0;
  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c has landed, and every warp is done with the slot that the
    // next request overwrites.
    copy_async_wait<kRingStages - 2>();
    __syncthreads();
    request_chunk();
    if (mask) {
      const int at = c * p.chunk;
      const int n_points = nq_steps - at < p.chunk ? nq_steps - at : p.chunk;
      const T* stage = ring + slot * stage_elems;
      accumulate<MP, NC>(acc, stage + row_at, stage + col_at, k + at, n_points, p.slice_ld,
                         mask, g, t);
    }
    slot = slot + 1 == kRingStages ? 0 : slot + 1;
  }
  if (mask) {
    store_tile<T, MP, NC>(acc, out + e * n1 * n1, q, quad, rb0, cb0, mask, n1, pair_stores,
                          g, t);
  }
  copy_async_wait<0>();
}

// Opts `Kernel` in to `smem` bytes of dynamic shared memory and, where
// `blocks` is given, gives there how many of its blocks of `threads` fit
// the card at once.  Each kernel keeps its own answer, asked for again
// only when the device, the block size or the shared memory differ from
// its last call.
template <auto Kernel>
cudaError_t fit(int threads, size_t smem, long long* blocks) {
  static std::mutex guard;
  static int last_device = -1;
  static int last_threads = 0;
  static size_t last_smem = 0;
  static long long last_blocks = 0;  // 0: not asked for yet
  std::lock_guard<std::mutex> lock(guard);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return err;
  }
  if (device != last_device || threads != last_threads || smem != last_smem) {
    int smem_optin = 0;
    err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess && smem > static_cast<size_t>(smem_optin)) {
      err = cudaErrorInvalidConfiguration;
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) {
      return err;
    }
    last_device = device;
    last_threads = threads;
    last_smem = smem;
    last_blocks = 0;
  }
  if (blocks != nullptr && last_blocks == 0) {
    int n_sm = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, smem);
    }
    if (err == cudaSuccess && per_sm < 1) {
      err = cudaErrorInvalidConfiguration;
    }
    if (err != cudaSuccess) {
      return err;
    }
    last_blocks = static_cast<long long>(per_sm) * n_sm;
  }
  if (blocks != nullptr) {
    *blocks = last_blocks;
  }
  return cudaSuccess;
}

template <typename T, int MP, int NC>
int launch_tile(const void* j00, const void* j01, const void* j10, const void* j11,
                const void* det, const void* tab, const void* w, const void* tiles,
                void* out, int n_elem, int n_h, int n_v, int nq, const Plan& p,
                cudaStream_t stream) {
  const int threads = p.warps * 32;
  long long grid = 0;
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
  if (p.route == kRoutePanel) {
    // The ring of slices and the metric row; one block an item.
    smem = (static_cast<size_t>(kRingStages) * p.chunk * p.slice_ld + p.nq_pad) * sizeof(T);
    err = fit<mass_edge_panel_kernel<T, MP, NC>>(threads, smem, nullptr);
    grid = static_cast<long long>(p.n_tiles) * n_elem;
    if (err == cudaSuccess && grid > INT_MAX) {
      err = cudaErrorInvalidConfiguration;
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    mass_edge_panel_kernel<T, MP, NC><<<static_cast<int>(grid), threads, smem, stream>>>(
        static_cast<const T*>(j00), static_cast<const T*>(j01), static_cast<const T*>(j10),
        static_cast<const T*>(j11), static_cast<const T*>(det), static_cast<const T*>(tab),
        static_cast<const T*>(w), static_cast<const int*>(tiles), static_cast<T*>(out),
        n_elem, n_h, n_v, nq, p);
    return static_cast<int>(cudaGetLastError());
  }
  // The ring, two sets of metric rows, the tile codes; as many blocks as
  // fit the card at once, at most one a group.
  smem = (static_cast<size_t>(p.stages) * p.chunk * p.ld +
          2 * static_cast<size_t>(p.group) * 3 * p.nq_pad) *
             sizeof(T) +
         static_cast<size_t>(round_up(p.n_tiles, 4)) * sizeof(int);
  long long resident_blocks = 0;
  err = fit<mass_edge_kernel<T, MP, NC>>(threads, smem, &resident_blocks);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long n_groups = (static_cast<long long>(n_elem) + p.group - 1) / p.group;
  grid = n_groups < resident_blocks ? n_groups : resident_blocks;
  mass_edge_kernel<T, MP, NC><<<static_cast<int>(grid), threads, smem, stream>>>(
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
  const Plan p = {plan[0], plan[1], plan[2],  plan[3],  plan[4],  plan[5], plan[6],
                  plan[7], plan[8], plan[9], plan[10], plan[11], plan[12]};
  const int n1_pad = round_up(n_h, kBlock) + round_up(n_v, kBlock);
  const bool ring_ok = p.stages == 1 ? p.chunk == p.nq_pad : p.stages == kRingStages;
  bool ok = n_h >= 1 && n_v >= 1 && nq >= 1 && p.ld >= n1_pad && p.ld % 4 == 0 &&
            p.nq_pad >= nq && p.chunk >= kStep && p.chunk % kStep == 0 &&
            p.nq_pad % p.chunk == 0 && ring_ok && p.group >= 1 && p.warps >= 1 &&
            p.warps * 32 <= kMaxThreads && p.n_tiles >= 1;
  if (p.route == kRoutePanel) {
    // One warp a tile of the panel, and a stage row that holds a row and a
    // column range of the panel side by side.
    ok = ok && p.stages == kRingStages && p.panel_rows >= 1 && p.panel_cols >= 1 &&
         p.warps == p.panel_rows * p.panel_cols && p.slice_ld % 4 == 0 &&
         p.slice_ld >= (p.panel_rows * p.mr + p.panel_cols * p.nc) * kBlock;
  } else {
    ok = ok && p.route == kRouteElement;
  }
  if (!ok) {
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

// What the wrapper's launch plan needs to know of the current device, in
// `out`: its SMs, the shared memory of one SM, the shared memory the
// runtime keeps for each block, and the registers of one SM.
extern "C" int mfv2d_mass_edge_card(int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock, cudaDevAttrMaxRegistersPerMultiprocessor};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = cudaDeviceGetAttribute(out + i, attrs[i], device);
  }
  return static_cast<int>(err);
}
