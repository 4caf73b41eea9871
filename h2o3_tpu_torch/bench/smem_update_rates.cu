// Shared-memory update rates of one SM on Hopper: float atomicAdd, int
// atomicAdd, three float atomicAdds to neighbouring words (a histogram's
// g/h/w), and a lane-private plain load-add-store, each at random
// addresses in S words (195 = 65 bins x 3 stats; 3120 = 16 nodes of them),
// at 1 to 8 blocks of 256 threads per SM; then int atomicAdd at the fixed
// kernel's slab (28 features x 257 bins x 3 stats, csrc/hist.cu
// fixed_hist_kernel): three adds per (row, feature) with lanes on features
// (lane l < 28 adds feature l at a random bin of a [3][257][32] slab, so
// that the warp's 32 lanes fall on 32 banks), against the same adds at
// random words of a [28][257][3] slab. Prints lane-updates per clock per SM,
// against the card's listed SM clock. The level-histogram kernels were
// designed from these rates: a float atomicAdd in shared memory compiles to
// a compare-and-swap loop, an int atomicAdd to one ATOMS.ADD.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o smem_rates \
//       h2o3_tpu_torch/bench/smem_update_rates.cu && ./smem_rates
#include <cstdio>
#include <cuda_runtime.h>
enum { kFloat, kInt, kPlainLane, kFloat3, kIntLanes, kIntRandom };
constexpr int kFeatures = 28, kBins = 257;
template <int MODE>
__global__ void k(float* out, int iters, int S) {
  extern __shared__ float sm[];
  const int n = MODE == kPlainLane ? S * 32 : S;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  unsigned x = 0x9e3779b9u * (threadIdx.x + 1) ^ (blockIdx.x * 7919u);
  const int lane = threadIdx.x & 31;
  int* si = reinterpret_cast<int*>(sm);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x = x * 1664525u + 1013904223u;
      const int a = (x >> 8) % S;
      if (MODE == kFloat) atomicAdd(&sm[a], 1.0f);
      if (MODE == kInt) atomicAdd(si + a, 1);
      if (MODE == kPlainLane) sm[a * 32 + lane] += 1.0f;
      if (MODE == kFloat3) { float* p = &sm[(a / 3) * 3];
        atomicAdd(p, 1.f); atomicAdd(p + 1, 1.f); atomicAdd(p + 2, 1.f); }
      if (MODE == kIntLanes && lane < kFeatures) {
        // slab [3][kBins][32]: stat s of feature `lane` at bin b
        int* p = si + ((x >> 8) % kBins) * 32 + lane;
        atomicAdd(p, 1); atomicAdd(p + kBins * 32, 2);
        atomicAdd(p + 2 * kBins * 32, 3); }
      if (MODE == kIntRandom && lane < kFeatures) {
        // slab [kFeatures][kBins][3]: the same adds, feature-major
        int* p = si + (lane * kBins + (x >> 8) % kBins) * 3;
        atomicAdd(p, 1); atomicAdd(p + 1, 2); atomicAdd(p + 2, 3); }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = sm[1];
}
template <int MODE> void run(const char* name, int S, int threads, int bps) {
  float* out; cudaMalloc(&out, 132 * 64 * 4);
  const int smem = (MODE == kPlainLane ? S * 32 : S) * 4;
  cudaFuncSetAttribute(k<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  const int iters = 4096, blocks = 132 * bps;
  k<MODE><<<blocks, threads, smem>>>(out, 16, S);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  k<MODE><<<blocks, threads, smem>>>(out, iters, S);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  const bool slab = MODE == kIntLanes || MODE == kIntRandom;
  const double ops = (double)blocks * threads * iters * 4
                     * (MODE == kFloat3 || slab ? 3 : 1)
                     * (slab ? kFeatures / 32.0 : 1.0);
  printf("%-22s S=%6d threads=%4d blocks/SM=%d: %.3f ms, %.2f lane-ops/clk/SM (%s)\n",
         name, S, threads, bps, ms, ops / 132 / (ms * 1e-3 * clk * 1e3),
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  for (int S : {195, 3120}) for (int bps : {1, 2, 4, 8}) {
    run<kFloat>("float atomicAdd", S, 256, bps);
    run<kInt>("int atomicAdd", S, 256, bps);
    run<kFloat3>("float atomicAdd x3", S, 256, bps);
  }
  for (int bps : {1, 2, 4, 8}) run<kPlainLane>("plain RMW lane-private", 195, 256, bps);
  run<kFloat>("float atomicAdd", 195, 1024, 2);
  run<kInt>("int atomicAdd", 195, 1024, 2);
  // the fixed kernel's slab: 3 x 257 x 32 words (98,688 bytes) for lanes on
  // features, 28 x 257 x 3 (86,352 bytes) feature-major
  for (int bps : {1, 2}) for (int threads : {256, 512}) {
    if (bps * threads > 1024) continue;
    run<kIntLanes>("int x3 lanes on feats", 3 * kBins * 32, threads, bps);
    run<kIntRandom>("int x3 feature-major", kFeatures * kBins * 3, threads, bps);
  }
  return 0;
}
