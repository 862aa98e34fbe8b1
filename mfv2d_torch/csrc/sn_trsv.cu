// The triangular sweeps of a frozen sparse LU factorization, level by level
// over its supernodes, on Hopper, in float64.
//
// Replaces no TPU kernel: the JAX package solves its frozen saddle systems
// with SciPy's SuperLU on the host, as the port did.  It was added because
// those host solves, one thread each, set the pace of the port's Picard
// loops and time marches: a march of 64x64 p=4 makes 134 of them on one
// factorization (L 15.4 M, U 14.6 M non-zeros).  The factorization stays on
// the host; the wrapper (mfv2d_torch/ops/kernels/supernodal.py) lays its
// factors out once, and this kernel runs the sweeps.
//
// One launch a level of a sweep.  A task is rows [row0, row1) of one block
// (a supernode of L, rows [c0, c0 + w)).  Its rows' entries outside the
// block are contiguous: L's rows are CSR (their columns left of the block),
// U's a dense row block of w rows by the nk columns right of the block that
// the block touches, the columns listed once for the block.  The first CTAs
// of a launch take one large task each; every later CTA takes eight small
// ones, a warp each (a block of at most 32 rows and a few hundred products,
// in one task).
//
// Each task first loads what depends on the factors alone: its record, its
// rows' starts, its first products' values and columns, and (a block of one
// task) its triangle, by asynchronous copies (cp.async) into shared memory.
// Only then does it wait for the launches before it (griddepcontrol.wait:
// each launch lets the next one start early, programmatic dependent
// launch) and read x.  A CTA forms its products, each a value times a
// gathered x, into shared memory a chunk at a time, so that the memory
// latency is paid once a chunk and not once a row; then a warp a row sums
// the row's products of the chunk (lanes stride, then a butterfly sum).  A
// warp's task sums each row in one lane, in order.  A block cut into
// several tasks parks its rows' x[c0 + i] - sums in x; the CTA that
// finishes last (an integer counter a block, reset by that CTA) takes them
// and fetches the triangle.
//
// The triangle (packed by columns: L's strict lower one, U's upper one with
// the diagonal) is solved in shared memory in panels of 32 columns: one warp
// solves the panel, lane per row, by shuffles; then every thread of the CTA
// updates the rows past the panel, one row a thread, in column order.  L's
// diagonal is 1; U's is applied as its reciprocal, taken for the panel's 32
// entries at once before its chain of steps, so that a step is a shuffle
// and a multiply-add.  A launch takes the shared memory of its largest task
// (at most 224 rows: 220,680 bytes).  No floating-point atomics: a solve is
// bitwise repeatable.
//
// What bounds it.  Bytes: each non-zero of L (its unit diagonal aside) and
// of U read once, 8 bytes a value, and the right side and the solution once:
// at 64x64 p=4 (L 15.35 M, U 14.48 M non-zeros) 0.2408 GB, 0.072 ms at
// 3.35 TB/s (chip_smoke.py phase 12b).  The dependency chain binds first:
// 209 levels, whose top ones hold one block each, so a solve costs about a
// launch, a few memory latencies and a triangle of up to 200 rows a level,
// 2.6 ms in all on the H100, of which about 1.07 ms are the panels'
// one-warp chains of large blocks.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 32;
// Products a thread loads before the wait; a CTA's first kAhead * threads
// come from these registers, into the first chunk.
constexpr int kAhead = 8;
// Products a CTA holds in shared memory at once (CHUNK in supernodal.py,
// which sizes the shared memory with it).
constexpr int kChunk = 2048;
static_assert(kChunk >= kAhead * kThreads, "the loads before the wait fill one chunk");
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  double* x;                 // the permuted right side, solved in place
  const long long* tasks;    // [T, 12] records (TASK_FIELDS in supernodal.py)
  const double* tri;         // the blocks' packed triangles
  const long long* rowptr;   // L: [n + 1] CSR of the rows left of their block
  const int* col;
  const double* val;
  const int* u_kidx;         // U: each row block's columns
  const double* u_val;       // U: w x nk row-major row blocks
  unsigned* counters;        // [nb], zero between launches
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Start of column j of a w-row triangle packed by columns: L's strict lower
// one (rows j+1 .. w-1 of column j) or U's upper one (rows 0 .. j).
template <bool kUpper>
__device__ __forceinline__ int column(int j, int w) {
  return kUpper ? j * (j + 1) / 2 : j * (w - 1) - j * (j - 1) / 2 - j - 1;
}

// A task of a large block, by the whole CTA.  In `r`: the rows' right
// sides less their products (w); the task's row starts (w + 1 ints); a
// chunk of products; the triangle.
template <bool kUpper>
__device__ __forceinline__ void cta_task(const Args& a, long long task, double* r) {
  __shared__ int last;
  const longlong2* rec = reinterpret_cast<const longlong2*>(a.tasks + 12 * task);
  const longlong2 f0 = rec[0], f1 = rec[1], f2 = rec[2], f3 = rec[3], f4 = rec[4];
  const int blk = static_cast<int>(f0.x), row0 = static_cast<int>(f0.y);
  const int row1 = static_cast<int>(f1.x), c0 = static_cast<int>(f1.y);
  const int w = static_cast<int>(f2.x), ntask = static_cast<int>(f2.y);
  const int nk = static_cast<int>(f3.x);
  const long long e0 = f3.y;
  const int n_e = static_cast<int>(f4.x);
  const long long tri_off = f4.y;
  const int threads = kThreads, warps = kWarps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* starts = reinterpret_cast<int*>(r + w);
  double* buf = r + w + (w + 2) / 2;
  double* t = buf + min(n_e, kChunk);
  const int size = kUpper ? w * (w + 1) / 2 : w * (w - 1) / 2;
  double* x = a.x;

  // A block of one task fetches its triangle now, behind the products.
  if (ntask == 1) {
    for (int e = tid; e < size; e += threads) {
      __pipeline_memcpy_async(t + e, a.tri + tri_off + e, sizeof(double));
    }
    __pipeline_commit();
  }
  for (int i = row0 + tid; i <= row1; i += threads) {
    starts[i - row0] = kUpper ? (i - row0) * nk : static_cast<int>(a.rowptr[c0 + i] - e0);
  }
  const int* cols = kUpper ? a.u_kidx + rec[5].x : nullptr;
  const int ahead = min(n_e, kAhead * threads);
  double value[kAhead];
  int index[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int q = tid + j * threads;
    if (q < ahead) {
      value[j] = kUpper ? a.u_val[e0 + q] : a.val[e0 + q];
      index[j] = kUpper ? cols[q % nk] : a.col[e0 + q];
    }
  }
  // Everything above reads the factors only; x is written by the earlier
  // launches, which are complete past this point.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = row0 + tid; i < row1; i += threads) r[i] = x[c0 + i];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int q = tid + j * threads;
    if (q < ahead) buf[q] = value[j] * x[index[j]];
  }
  for (int q0 = 0; q0 < n_e; q0 += kChunk) {
    const int q1 = min(n_e, q0 + kChunk);
#pragma unroll 8
    for (int q = max(q0, ahead) + tid; q < q1; q += threads) {
      buf[q - q0] = kUpper ? a.u_val[e0 + q] * x[cols[q % nk]] : a.val[e0 + q] * x[a.col[e0 + q]];
    }
    __syncthreads();
    for (int i = row0 + warp; i < row1; i += warps) {
      const int s0 = max(starts[i - row0], q0), s1 = min(starts[i - row0 + 1], q1);
      if (s0 >= s1) continue;
      double sum = 0.0;
      for (int q = s0 + lane; q < s1; q += 32) sum += buf[q - q0];
      sum = warp_sum(sum);
      if (lane == 0) r[i] -= sum;
    }
    __syncthreads();
  }
  if (ntask > 1) {
    for (int i = row0 + tid; i < row1; i += threads) x[c0 + i] = r[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const unsigned done = atomicAdd(a.counters + blk, 1u);
      last = done == static_cast<unsigned>(ntask - 1);
      if (last) a.counters[blk] = 0u;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int e = tid; e < size; e += threads) {
      __pipeline_memcpy_async(t + e, a.tri + tri_off + e, sizeof(double));
    }
    __pipeline_commit();
    for (int i = tid; i < w; i += threads) r[i] = __ldcg(x + c0 + i);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  if (!kUpper) {
    for (int p0 = 0; p0 < w; p0 += kPanel) {
      const int pw = min(kPanel, w - p0);
      if (warp == 0) {
        double v = lane < pw ? r[p0 + lane] : 0.0;
        if (pw == kPanel) {
          // A whole panel: straight-line steps, whose loads can be issued
          // ahead of the shuffles they wait for.
#pragma unroll
          for (int k = 0; k < kPanel - 1; ++k) {
            const double xk = __shfl_sync(kFull, v, k);
            if (lane > k) v = fma(-t[column<false>(p0 + k, w) + p0 + lane], xk, v);
          }
        } else {
#pragma unroll
          for (int k = 0; k < kPanel - 1; ++k) {
            if (k + 1 < pw) {
              const double xk = __shfl_sync(kFull, v, k);
              if (lane > k && lane < pw) v = fma(-t[column<false>(p0 + k, w) + p0 + lane], xk, v);
            }
          }
        }
        if (lane < pw) r[p0 + lane] = v;
      }
      __syncthreads();
      for (int i = p0 + pw + tid; i < w; i += threads) {
        double v = r[i];
        for (int k = 0; k < pw; ++k) v = fma(-t[column<false>(p0 + k, w) + i], r[p0 + k], v);
        r[i] = v;
      }
      __syncthreads();
    }
  } else {
    for (int p1 = w; p1 > 0; p1 -= kPanel) {
      const int p0 = max(0, p1 - kPanel), pw = p1 - p0;
      if (warp == 0) {
        double v = lane < pw ? r[p0 + lane] : 0.0;
        // The diagonal's reciprocals, all at once, off the chain of steps.
        const double inverse = lane < pw ? 1.0 / t[column<true>(p0 + lane, w) + p0 + lane] : 0.0;
        if (pw == kPanel) {
#pragma unroll
          for (int k = kPanel - 1; k >= 0; --k) {
            if (lane == k) v *= inverse;
            const double xk = __shfl_sync(kFull, v, k);
            if (lane < k) v = fma(-t[column<true>(p0 + k, w) + p0 + lane], xk, v);
          }
        } else {
#pragma unroll
          for (int k = kPanel - 1; k >= 0; --k) {
            if (k < pw) {
              if (lane == k) v *= inverse;
              const double xk = __shfl_sync(kFull, v, k);
              if (lane < k) v = fma(-t[column<true>(p0 + k, w) + p0 + lane], xk, v);
            }
          }
        }
        if (lane < pw) r[p0 + lane] = v;
      }
      __syncthreads();
      for (int i = tid; i < p0; i += threads) {
        double v = r[i];
        for (int k = 0; k < pw; ++k) v = fma(-t[column<true>(p0 + k, w) + i], r[p0 + k], v);
        r[i] = v;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < w; i += threads) x[c0 + i] = r[i];
}

// A task of a small block (at most 32 rows, one task, its products at most
// a few hundred), by one warp: lane i holds row i.  In `r`, the warp's own
// part of shared memory: the right sides (w), the row starts (w + 1 ints),
// the products, the triangle.  Lane i sums its row's products in order.
template <bool kUpper>
__device__ __forceinline__ void warp_task(const Args& a, long long task, double* r, int lane) {
  const longlong2* rec = reinterpret_cast<const longlong2*>(a.tasks + 12 * task);
  const longlong2 f1 = rec[1], f2 = rec[2], f3 = rec[3], f4 = rec[4];
  const int c0 = static_cast<int>(f1.y), w = static_cast<int>(f2.x);
  const int nk = static_cast<int>(f3.x);
  const long long e0 = f3.y;
  const int n_e = static_cast<int>(f4.x);
  const long long tri_off = f4.y;
  int* starts = reinterpret_cast<int*>(r + w);
  double* buf = r + w + (w + 2) / 2;
  double* t = buf + n_e;
  const int size = kUpper ? w * (w + 1) / 2 : w * (w - 1) / 2;
  for (int e = lane; e < size; e += 32) {
    __pipeline_memcpy_async(t + e, a.tri + tri_off + e, sizeof(double));
  }
  __pipeline_commit();
  for (int i = lane; i <= w; i += 32) {
    starts[i] = kUpper ? i * nk : static_cast<int>(a.rowptr[c0 + i] - e0);
  }
  const int* cols = kUpper ? a.u_kidx + rec[5].x : nullptr;
  const int ahead = min(n_e, kAhead * 32);
  double value[kAhead];
  int index[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int q = lane + 32 * j;
    if (q < ahead) {
      value[j] = kUpper ? a.u_val[e0 + q] : a.val[e0 + q];
      index[j] = kUpper ? cols[q % nk] : a.col[e0 + q];
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  double* x = a.x;
  double v = lane < w ? x[c0 + lane] : 0.0;
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int q = lane + 32 * j;
    if (q < ahead) buf[q] = value[j] * x[index[j]];
  }
  for (int q = ahead + lane; q < n_e; q += 32) {
    buf[q] = kUpper ? a.u_val[e0 + q] * x[cols[q % nk]] : a.val[e0 + q] * x[a.col[e0 + q]];
  }
  __syncwarp();
  if (lane < w) {
    double sum = 0.0;
    for (int q = starts[lane]; q < starts[lane + 1]; ++q) sum += buf[q];
    v -= sum;
  }
  __pipeline_wait_prior(0);
  __syncwarp();
  if (!kUpper) {
#pragma unroll
    for (int k = 0; k < kPanel - 1; ++k) {
      if (k + 1 < w) {
        const double xk = __shfl_sync(kFull, v, k);
        if (lane > k && lane < w) v = fma(-t[column<false>(k, w) + lane], xk, v);
      }
    }
  } else {
    const double inverse = lane < w ? 1.0 / t[column<true>(lane, w) + lane] : 0.0;
#pragma unroll
    for (int k = kPanel - 1; k >= 0; --k) {
      if (k < w) {
        if (lane == k) v *= inverse;
        const double xk = __shfl_sync(kFull, v, k);
        if (lane < k) v = fma(-t[column<true>(k, w) + lane], xk, v);
      }
    }
  }
  if (lane < w) x[c0 + lane] = v;
}

// One level of a sweep: CTAs [0, n_big) take the large tasks task0 ..
// task0 + n_big - 1, one each; every later CTA takes eight small tasks, one
// a warp, each warp with `stride` doubles of the shared memory.
template <bool kUpper>
__global__ void __launch_bounds__(kThreads)
    sn_trsv_level(Args a, int task0, int n_big, int n_small, int stride) {
  extern __shared__ double smem[];
  // The next launch may start its CTAs, which wait for this one to end
  // before they read x (programmatic dependent launch).
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int b = static_cast<int>(blockIdx.x);
  if (b < n_big) {
    cta_task<kUpper>(a, task0 + b, smem);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int k = (b - n_big) * kWarps + warp;
  if (k < n_small) warp_task<kUpper>(a, task0 + n_big + k, smem + warp * stride, threadIdx.x & 31);
}

// `plan` (host memory) holds 5 values a launch: first task, large tasks,
// small tasks, shared memory bytes, each warp's share of it for a small
// task (doubles).
// Each launch may begin while the one before it runs (programmatic stream
// serialization): its CTAs load what they read of the factors, then wait at
// griddepcontrol.wait for the earlier launches to end.
template <bool kUpper>
int sweep(const Args& a, const long long* plan, int n_launches, cudaStream_t stream) {
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  for (int l = 0; l < n_launches; ++l) {
    const long long* p = plan + 5 * l;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(p[1] + (p[2] + kWarps - 1) / kWarps));
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = static_cast<size_t>(p[3]);
    config.stream = stream;
    config.attrs = &early;
    config.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&config, sn_trsv_level<kUpper>, a, static_cast<int>(p[0]),
                           static_cast<int>(p[1]), static_cast<int>(p[2]), static_cast<int>(p[4]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Every instantiation may take `bytes` of dynamic shared memory.  Called
// before a graph is captured.
extern "C" int mfv2d_sn_trsv_reserve(int bytes) {
  if (bytes <= 48 * 1024) return 0;
  const void* kernels[] = {reinterpret_cast<const void*>(sn_trsv_level<false>),
                           reinterpret_cast<const void*>(sn_trsv_level<true>)};
  for (const void* kernel : kernels) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The products a CTA holds at once, which the caller's shared memory
// sizes must count with.
extern "C" int mfv2d_sn_trsv_chunk() { return kChunk; }

// The launches of one sweep, L's (upper = 0) or U's (upper = 1), on
// `stream`, as `plan` (host memory, 5 values a launch) lays them out.
extern "C" int mfv2d_sn_trsv_f64(void* x, const void* tasks, const long long* plan,
                                 int n_launches, int upper, const void* tri,
                                 const void* rowptr, const void* col, const void* val,
                                 const void* u_kidx, const void* u_val, void* counters,
                                 void* stream) {
  const Args a{static_cast<double*>(x),
               static_cast<const long long*>(tasks),
               static_cast<const double*>(tri),
               static_cast<const long long*>(rowptr),
               static_cast<const int*>(col),
               static_cast<const double*>(val),
               static_cast<const int*>(u_kidx),
               static_cast<const double*>(u_val),
               static_cast<unsigned*>(counters)};
  const auto s = static_cast<cudaStream_t>(stream);
  return upper ? sweep<true>(a, plan, n_launches, s) : sweep<false>(a, plan, n_launches, s);
}
