// Shared-memory update rates of one SM on Hopper: float atomicAdd, int
// atomicAdd, three float atomicAdds to neighbouring words (a histogram's
// g/h/w), and a lane-private plain load-add-store, each at random
// addresses in S words (195 = 65 bins x 3 stats; 3120 = 16 nodes of them),
// at 1 to 8 blocks of 256 threads per SM. Prints lane-updates per clock per
// SM, against the card's listed SM clock. The level-histogram kernel
// (csrc/hist.cu) was designed from these rates: a float atomicAdd in
// shared memory compiles to a compare-and-swap loop.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o smem_rates \
//       h2o3_tpu_torch/bench/smem_update_rates.cu && ./smem_rates
#include <cstdio>
#include <cuda_runtime.h>
template <int MODE>
__global__ void k(float* out, int iters, int S) {
  extern __shared__ float sm[];
  const int n = MODE == 2 ? S * 32 : S;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  unsigned x = 0x9e3779b9u * (threadIdx.x + 1) ^ (blockIdx.x * 7919u);
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x = x * 1664525u + 1013904223u;
      const int a = (x >> 8) % S;
      if (MODE == 0) atomicAdd(&sm[a], 1.0f);
      if (MODE == 1) atomicAdd(reinterpret_cast<int*>(sm) + a, 1);
      if (MODE == 2) sm[a * 32 + lane] += 1.0f;
      if (MODE == 3) { float* p = &sm[(a / 3) * 3];
        atomicAdd(p, 1.f); atomicAdd(p + 1, 1.f); atomicAdd(p + 2, 1.f); }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = sm[1];
}
template <int MODE> void run(const char* name, int S, int threads, int bps) {
  float* out; cudaMalloc(&out, 132 * 64 * 4);
  const int smem = (MODE == 2 ? S * 32 : S) * 4;
  cudaFuncSetAttribute(k<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  const int iters = 4096, blocks = 132 * bps;
  k<MODE><<<blocks, threads, smem>>>(out, 16, S);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  k<MODE><<<blocks, threads, smem>>>(out, iters, S);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  const double ops = (double)blocks * threads * iters * 4 * (MODE == 3 ? 3 : 1);
  printf("%-22s S=%6d threads=%4d blocks/SM=%d: %.3f ms, %.2f lane-ops/clk/SM (%s)\n",
         name, S, threads, bps, ms, ops / 132 / (ms * 1e-3 * clk * 1e3),
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  for (int S : {195, 3120}) for (int bps : {1, 2, 4, 8}) {
    run<0>("float atomicAdd", S, 256, bps);
    run<1>("int atomicAdd", S, 256, bps);
    run<3>("float atomicAdd x3", S, 256, bps);
  }
  for (int bps : {1, 2, 4, 8}) run<2>("plain RMW lane-private", 195, 256, bps);
  run<0>("float atomicAdd", 195, 1024, 2);
  run<1>("int atomicAdd", 195, 1024, 2);
  return 0;
}
