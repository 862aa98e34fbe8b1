// Peak rate of the FP64 tensor-core MMA shapes on one GPU.
//
// Each warp runs rounds of 8 independent mma.sync instructions of one
// shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16) on register operands, two
// blocks of 4 or 8 warps per SM; the program prints the time, the rate in
// TFLOP/s and the nanoseconds per instruction and SM.  It is what decided
// the shape csrc/mass_edge.cu uses: on an H100 the m8n8k4 shape stays at
// the vector FP64 rate.
//
// Build and run from the repository root:
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/fp64_mma_shapes tools/fp64_mma_shapes.cu && build/fp64_mma_shapes

#include <cstdio>
#include <cuda_runtime.h>

template <int kShape>
__global__ void run_shape(double* out, int rounds) {
  double c[8][4];
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 4; ++j) c[i][j] = threadIdx.x * 1e-9 + i + j;
  }
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = 1.0 + 1e-9 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1.0 - 1e-9 * (threadIdx.x + i);
  for (int round = 0; round < rounds; ++round) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kShape == 0) {
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
            : "+d"(c[i][0]), "+d"(c[i][1])
            : "d"(a[0]), "d"(b[0]));
      } else if (kShape == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
            "{%0,%1,%2,%3};"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
      } else if (kShape == 2) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
              "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
      }
    }
  }
  double sum = 0;
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 4; ++j) sum += c[i][j];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int kShape>
int run(const char* name, double fma_per_mma, int warps, int n_sm) {
  const int rounds = 4000;
  const int blocks = 2 * n_sm;
  double* out = nullptr;
  if (cudaMalloc(&out, sizeof(double) * blocks * warps * 32) != cudaSuccess) return 1;
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  run_shape<kShape><<<blocks, warps * 32>>>(out, 100);
  cudaEventRecord(start);
  run_shape<kShape><<<blocks, warps * 32>>>(out, rounds);
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0;
  cudaEventElapsedTime(&ms, start, stop);
  const cudaError_t err = cudaGetLastError();
  const double mmas = static_cast<double>(blocks) * warps * rounds * 8;
  printf("%s, %2d warps a block: %.3f ms, %.2f TFLOP/s, %.2f ns per MMA and SM%s\n", name,
         warps, ms, 2 * mmas * fma_per_mma / ms / 1e9, ms * 1e6 / (mmas / n_sm),
         err == cudaSuccess ? "" : " (launch failed)");
  cudaFree(out);
  return err == cudaSuccess ? 0 : 1;
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "fp64_mma_shapes: no CUDA device.\n");
    return 1;
  }
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  int failed = 0;
  for (int warps : {4, 8}) {
    failed += run<0>("m8n8k4  ", 256, warps, prop.multiProcessorCount);
    failed += run<1>("m16n8k4 ", 512, warps, prop.multiProcessorCount);
    failed += run<2>("m16n8k8 ", 1024, warps, prop.multiProcessorCount);
    failed += run<3>("m16n8k16", 2048, warps, prop.multiProcessorCount);
  }
  return failed ? 1 : 0;
}
