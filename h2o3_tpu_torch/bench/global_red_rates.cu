// Float reductions into global memory (L2) on Hopper: three scalar f32 adds
// to neighbouring words of a [S, 3] array (a histogram entry's g, h and w, as
// the level-histogram kernels flush them) against one 16-byte v4 add to an
// entry of a [S, 4] array, one scalar add alone, and one 64-bit integer
// add (RED.E.ADD.64, as fixed_hist_kernel flushes its slab), each at random
// entries
// of arrays of about 0.02, 3, 30 and 90 MB (the 90 MB case is beyond the
// card's 50 MB L2, as DRF's level of 4096 nodes is), with the result unused
// so that each add compiles to a fire-and-forget RED. Prints entries per
// second and reductions per second; global_hist_kernel (csrc/hist.cu) adds
// one (row, feature) per entry, so these rates bound it.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o global_red_rates \
//       h2o3_tpu_torch/bench/global_red_rates.cu && ./global_red_rates
#include <cstdio>
#include <cuda_runtime.h>

enum { kScalar3, kVec4, kScalar1, kInt64 };

template <int MODE>
__global__ void k(float* out, long long S, int iters) {
  unsigned x = 0x9e3779b9u * (blockIdx.x * blockDim.x + threadIdx.x + 1);
  for (int it = 0; it < iters; ++it) {
    x = x * 1664525u + 1013904223u;
    const unsigned y = x ^ (x >> 15);
    const long long e = static_cast<long long>(y) % S;
    if (MODE == kScalar3) {
      float* p = out + 3 * e;
      atomicAdd(p, 1.0f);
      atomicAdd(p + 1, 2.0f);
      atomicAdd(p + 2, 3.0f);
    }
    if (MODE == kVec4)
      atomicAdd(reinterpret_cast<float4*>(out) + e,
                make_float4(1.0f, 2.0f, 3.0f, 0.0f));
    if (MODE == kScalar1) atomicAdd(out + e, 1.0f);
    if (MODE == kInt64)   // fire-and-forget: atomicAdd would wait (ATOMG)
      asm volatile("red.global.add.u64 [%0], %1;" ::"l"(
                       reinterpret_cast<unsigned long long*>(out) + e),
                   "l"(1ull) : "memory");
  }
}

template <int MODE> void run(const char* name, double mb) {
  const int per = MODE == kVec4 ? 4 : MODE == kScalar3 ? 3
                  : MODE == kInt64 ? 2 : 1;
  // the same entry count for every mode: the v4 array is `mb` MB
  const long long S = static_cast<long long>(mb * 1e6 / 16);
  float* out;
  cudaMalloc(&out, S * per * sizeof(float));
  cudaMemset(out, 0, S * per * sizeof(float));
  const int blocks = 132 * 8, threads = 256, iters = 1024;
  k<MODE><<<blocks, threads>>>(out, S, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  k<MODE><<<blocks, threads>>>(out, S, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double entries = static_cast<double>(blocks) * threads * iters;
  const double reds = entries * (MODE == kScalar3 ? 3 : 1);
  printf("%-14s %8.3f MB (%lld entries of %d floats): %.3f ms, "
         "%.4g entries/s, %.4g reductions/s (%s)\n",
         name, S * per * 4 / 1e6, S, per, ms, entries / (ms * 1e-3),
         reds / (ms * 1e-3), cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  for (double mb : {0.02, 3.0, 30.0, 90.0}) {
    run<kScalar3>("f32 x3", mb);
    run<kVec4>("v4.f32", mb);
    run<kScalar1>("f32 x1", mb);
    run<kInt64>("u64 x1", mb);
  }
  return 0;
}
