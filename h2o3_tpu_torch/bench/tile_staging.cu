// Tile staging on Hopper: how fast one block of 256 threads per SM stages
// a level-histogram kernel's row tiles (csrc/hist.cu's kernel without
// atomics, since removed; the fixed kernel stages in registers too)
// into shared memory at the main path's shape: 11M rows of node (int32),
// g, h, w (float32) and 28 int8 bin rows, T rows to a tile, each block
// walking every gridDim-th tile. Two ways:
//   regs  each thread loads its share of the next tile into registers while
//         the block works on this one, then stores it to shared memory
//         (what the histogram kernels do);
//   bulk  a ring of S stages, each filled by 1-D bulk asynchronous copies
//         (cp.async.bulk, one per array row of the tile: node, g, h, w and
//         28 bin rows) that complete on the stage's mbarrier; thread 0
//         refills a stage once the block has read it.
// Each thread reads two words of every staged tile, so that each tile is
// waited for; nothing else is done with it. Prints the card's name, then ms
// per pass over the rows (mean of 20 after one), GB/s and the share of the
// 3.35 TB/s memory rate, per variant.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tile_staging \
//       h2o3_tpu_torch/bench/tile_staging.cu && ./tile_staging
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

constexpr long long kRows = 11000000;   // a multiple of 16
constexpr int kF = 28;
constexpr int kThreads = 256;
constexpr int kSmemFloor = 120 * 1024;  // one block per SM, as in hist.cu

// ---------------------------------------------------------------------------
// regs: shared memory holds the tile's stats [T] (g, h, w, node) and bins
// [F][T/4 + 1] words.
template <int T>
__global__ void __launch_bounds__(kThreads, 1)
regs(const uint32_t* __restrict__ bins, const int4* __restrict__ node,
     const float4* __restrict__ g, const float4* __restrict__ h,
     const float4* __restrict__ w, long long tiles, unsigned* out) {
  constexpr int Q = T / 4;                          // quads of rows
  constexpr int QT = (Q + kThreads - 1) / kThreads; // quads per thread
  constexpr int WT = kF * Q / kThreads;             // bin words per thread
  constexpr int stride = Q + 1;
  extern __shared__ float4 smem4[];
  float4* stats = smem4;
  uint32_t* bins_s = reinterpret_cast<uint32_t*>(stats + T);
  const int tid = threadIdx.x;
  const long long R4 = kRows / 4;
  int4 qn[QT];
  float4 qg[QT], qh[QT], qw[QT];
  uint32_t b[WT];
  auto load = [&](long long t) {
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const int q = tid + kThreads * i;
      if (q < Q) {
        qn[i] = __ldg(node + t * Q + q);
        qg[i] = __ldg(g + t * Q + q);
        qh[i] = __ldg(h + t * Q + q);
        qw[i] = __ldg(w + t * Q + q);
      }
    }
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      const int idx = tid + kThreads * i;
      b[i] = __ldg(bins + (idx / Q) * R4 + t * Q + idx % Q);
    }
  };
  unsigned sink = 0;
  if (blockIdx.x < tiles) load(blockIdx.x);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const int q = tid + kThreads * i;
      if (q < Q) {
        float4* st = stats + 4 * q;
        st[0] = make_float4(qg[i].x, qh[i].x, qw[i].x, __int_as_float(qn[i].x));
        st[1] = make_float4(qg[i].y, qh[i].y, qw[i].y, __int_as_float(qn[i].y));
        st[2] = make_float4(qg[i].z, qh[i].z, qw[i].z, __int_as_float(qn[i].z));
        st[3] = make_float4(qg[i].w, qh[i].w, qw[i].w, __int_as_float(qn[i].w));
      }
    }
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      const int idx = tid + kThreads * i;
      bins_s[(idx / Q) * stride + idx % Q] = b[i];
    }
    __syncthreads();
    if (t + gridDim.x < tiles) load(t + gridDim.x);
    sink += bins_s[(tid % kF) * stride + tid % Q]
            ^ __float_as_uint(stats[tid % T].y);
  }
  if (sink == 0x9e3779b9u) out[0] = sink;
}

// ---------------------------------------------------------------------------
// bulk: S stages of [node T | g T | h T | w T | bins F x T bytes], after S
// mbarriers.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(mbar) : "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t mbar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(mbar), "r"(parity) : "memory");
}

template <int T>
__device__ __forceinline__ void fill(unsigned char* stage, uint32_t mbar,
                                     const int8_t* bins, const int* node,
                                     const float* g, const float* h,
                                     const float* w, long long t) {
  constexpr uint32_t kBytes = 16u * T + kF * T;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(mbar), "r"(kBytes) : "memory");
  const long long r0 = t * T;
  const uint32_t s = smem_addr(stage);
  bulk_copy(s, node + r0, 4 * T, mbar);
  bulk_copy(s + 4 * T, g + r0, 4 * T, mbar);
  bulk_copy(s + 8 * T, h + r0, 4 * T, mbar);
  bulk_copy(s + 12 * T, w + r0, 4 * T, mbar);
  for (int f = 0; f < kF; ++f)
    bulk_copy(s + 16 * T + f * T, bins + f * kRows + r0, T, mbar);
}

template <int T, int S>
__global__ void __launch_bounds__(kThreads, 1)
bulk(const int8_t* __restrict__ bins, const int* __restrict__ node,
     const float* __restrict__ g, const float* __restrict__ h,
     const float* __restrict__ w, long long tiles, unsigned* out) {
  constexpr int kStage = 16 * T + kF * T;
  extern __shared__ float4 smem4[];
  uint64_t* mbars = reinterpret_cast<uint64_t*>(smem4);
  unsigned char* stages = reinterpret_cast<unsigned char*>(smem4) + 128;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(mbars + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S; ++s) {
      const long long t = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (t < tiles)
        fill<T>(stages + s * kStage, smem_addr(mbars + s), bins, node, g, h,
                w, t);
    }
  unsigned sink = 0;
  int i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int s = i % S;
    unsigned char* stage = stages + s * kStage;
    wait_parity(smem_addr(mbars + s), (i / S) & 1);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(stage);
    sink += words[(16 * T + (tid % kF) * T) / 4 + tid % (T / 4)]
            ^ words[T + tid % T];
    __syncthreads();   // the whole block has read stage s
    const long long next = t + static_cast<long long>(S) * gridDim.x;
    if (tid == 0 && next < tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fill<T>(stage, smem_addr(mbars + s), bins, node, g, h, w, next);
    }
  }
  if (sink == 0x9e3779b9u) out[0] = sink;
}

// ---------------------------------------------------------------------------
struct Inputs {
  int8_t* bins;
  int* node;
  float *g, *h, *w;
  unsigned* out;
};

template <typename K>
void run_variant(const char* name, K kernel, int T, int smem, const Inputs& in,
          int sms, bool is_regs) {
  const long long tiles = kRows / T;
  smem = smem < kSmemFloor ? kSmemFloor : smem;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  auto launch = [&]() {
    if (is_regs)
      reinterpret_cast<void (*)(const uint32_t*, const int4*, const float4*,
                                const float4*, const float4*, long long,
                                unsigned*)>(kernel)
          <<<sms, kThreads, smem>>>(
              reinterpret_cast<const uint32_t*>(in.bins),
              reinterpret_cast<const int4*>(in.node),
              reinterpret_cast<const float4*>(in.g),
              reinterpret_cast<const float4*>(in.h),
              reinterpret_cast<const float4*>(in.w), tiles, in.out);
    else
      reinterpret_cast<void (*)(const int8_t*, const int*, const float*,
                                const float*, const float*, long long,
                                unsigned*)>(kernel)
          <<<sms, kThreads, smem>>>(in.bins, in.node, in.g, in.h, in.w,
                                    tiles, in.out);
  };
  launch();
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const int reps = 20;
  cudaEventRecord(a);
  for (int r = 0; r < reps; ++r) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= reps;
  const double bytes = static_cast<double>(tiles) * T * (16 + kF);
  printf("%-18s T=%5d smem=%6d B: %.4f ms, %.1f GB/s, %.1f%% of 3.35 TB/s "
         "(%s)\n", name, T, smem, ms, bytes / ms / 1e6,
         100.0 * bytes / ms / 1e6 / 3350.0,
         cudaGetErrorString(cudaGetLastError()));
}

template <int T>
void run_regs(const Inputs& in, int sms) {
  run_variant("regs", regs<T>, T, 16 * T + kF * (T / 4 + 1) * 4, in, sms,
              true);
}

template <int T, int S>
void run_bulk(const Inputs& in, int sms) {
  char name[16];
  snprintf(name, sizeof name, "bulk S=%d", S);
  run_variant(name, bulk<T, S>, T, 128 + S * (16 + kF) * T, in, sms, false);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  Inputs in;
  cudaMalloc(&in.bins, kF * kRows);
  cudaMalloc(&in.node, 4 * kRows);
  cudaMalloc(&in.g, 4 * kRows);
  cudaMalloc(&in.h, 4 * kRows);
  cudaMalloc(&in.w, 4 * kRows);
  cudaMalloc(&in.out, 4);
  cudaMemset(in.bins, 1, kF * kRows);
  cudaMemset(in.node, 0, 4 * kRows);
  cudaMemset(in.g, 0, 4 * kRows);
  cudaMemset(in.h, 0, 4 * kRows);
  cudaMemset(in.w, 0, 4 * kRows);
  const int sms = prop.multiProcessorCount;
  run_regs<256>(in, sms);
  run_regs<512>(in, sms);
  run_regs<1024>(in, sms);
  run_bulk<256, 2>(in, sms);
  run_bulk<256, 3>(in, sms);
  run_bulk<512, 2>(in, sms);
  run_bulk<512, 3>(in, sms);
  run_bulk<1024, 2>(in, sms);
  run_bulk<1024, 3>(in, sms);
  run_bulk<1024, 4>(in, sms);
  run_bulk<2048, 2>(in, sms);
  return 0;
}
