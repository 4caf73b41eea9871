// Level histograms of tree growth, in CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel h2o3_tpu/ops/pallas_hist.py (hist_pallas, body
// _hist_kernel, pallas_call at line 179), which builds the same histograms
// as a one-hot bf16 contraction on the TPU's matrix unit over 1024-row
// tiles. None of that form is carried over: this card has fast atomics in
// shared memory, so the kernel counts rows into a histogram held there.
//
// What it computes, for feature f < F, node n < N and bin b < Bt:
//
//   out[f, n*Bt + b, :] += sum over rows r with node[r] == n and
//                          min(bin[f, r], Bt - 1) == b of (g[r], h[r], w[r])
//
// binned_T is [F, R] int8 or int16, node [R] int32, g/h/w [R] float32 and
// out [F, N*Bt, 3] float32, zeroed by the caller. Rows at node -1 (a frozen
// node, or the sibling that is derived by subtraction) add nothing.
// Out-of-range bins: ids >= Bt are clamped to Bt - 1, as the JAX reference's
// _level_histograms does (h2o3_tpu/models/tree.py:84); the Pallas kernel
// instead drops ids >= its padded stride. The two agree on every bin that
// binning produces, which lies in [0, nbins]. Negative ids, which binning
// never produces, are skipped so that they cannot write outside the slab.
//
// Design (the gpu_hist form). A block takes one feature, one block of Nb
// nodes and a chunk of rows. It zeroes a private float32 slab [Nb, Bt, 3]
// in shared memory, walks its rows with coalesced reads of binned_T[f, r]
// and node[r], skips rows outside its node block before any atomic, adds
// (g, h, w) into the slab with shared-memory atomicAdd, and then flushes
// the slab into `out` with global atomicAdd. Sums are exact float32; the
// TPU's bf16 precision modes, row tiles and node-block ceiling are gone.
// Nb comes from the shared-memory budget (the wrapper's _plan); a slab
// above 48 KB is dynamic shared memory after cudaFuncSetAttribute, so every
// depth up to 16 (2^14 nodes per call) and 257 bins in int16 are covered.
//
// Bound at the main-path shape (R = 11,000,000 rows, F = 28, Bt = 65, int8
// bins): memory. Each launch must read 11M x 28 B of bins plus 4 B of node
// and 12 B of g/h/w per row, about 484 MB: 0.145 ms at 3.35 TB/s. Its
// arithmetic, three float adds per active row and feature (under 1 GFLOP),
// is far below the card's float32 rate.
// What the design does about that bound: bins are read once, by byte loads
// that are coalesced across a warp. node and g/h/w are needed by every
// feature; the grid puts the feature in x, the fastest-varying block index,
// so that the F blocks of one row chunk are scheduled together and can find
// those arrays in L2 (how much they do is not measured).
// What it leaves for later:
//  - at level 0 every row sits in one node, so all atomics of a feature land
//    on 65 x 3 shared addresses and serialise (chip_smoke.py times level 0
//    beside the levels with half the rows active; PERF.md has the numbers);
//    per-warp sub-histograms, or a redesign around TMA, are for later PRs;
//  - bins are loaded one byte per thread; 4- or 16-byte vector loads are for
//    later;
//  - float32 atomics add in a different order from run to run, so sums vary
//    in the last bits between runs. A split whose gain nearly ties another
//    can then come out differently between this kernel and the plain
//    version; a deterministic fixed-point mode is for a later PR.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const BinT* __restrict__ binned_T,
                  const int32_t* __restrict__ node,
                  const float* __restrict__ g,
                  const float* __restrict__ h,
                  const float* __restrict__ w,
                  float* __restrict__ out,
                  long long R, int N, int Bt, int Nb,
                  long long rows_per_block) {
  extern __shared__ float slab[];
  const int f = blockIdx.x;
  const int n0 = blockIdx.z * Nb;
  const int nn = (N - n0 < Nb) ? (N - n0) : Nb;
  const int len = nn * Bt * 3;
  for (int i = threadIdx.x; i < len; i += blockDim.x) slab[i] = 0.0f;
  __syncthreads();

  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = (r0 + rows_per_block < R) ? r0 + rows_per_block : R;
  const BinT* bins = binned_T + (long long)f * R;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    // node -1 and nodes of other blocks both fail this unsigned test
    const unsigned n = (unsigned)(node[r] - n0);
    if (n >= (unsigned)nn) continue;
    int b = (int)bins[r];
    if (b < 0) continue;
    b = (b < Bt) ? b : Bt - 1;
    float* s = slab + ((int)n * Bt + b) * 3;
    atomicAdd(s, g[r]);
    atomicAdd(s + 1, h[r]);
    atomicAdd(s + 2, w[r]);
  }
  __syncthreads();

  float* o = out + ((long long)f * N + n0) * Bt * 3;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const float v = slab[i];
    if (v != 0.0f) atomicAdd(o + i, v);
  }
}

template <typename BinT>
cudaError_t launch(const void* binned_T, const void* node, const void* g,
                   const void* h, const void* w, void* out, long long R,
                   int F, int N, int Bt, int Nb, int n_chunks,
                   long long rows_per_block, int smem_bytes,
                   cudaStream_t stream) {
  auto kernel = level_hist_kernel<BinT>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const int n_node_blocks = (N + Nb - 1) / Nb;
  const dim3 grid(F, n_chunks, n_node_blocks);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const BinT*>(binned_T), static_cast<const int32_t*>(node),
      static_cast<const float*>(g), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<float*>(out), R, N, Bt, Nb,
      rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The Python wrapper (h2o3_tpu_torch/ops/hist.py) has checked every
// argument and planned Nb, n_chunks, rows_per_block and smem_bytes.
extern "C" int h2o3_level_hist(const void* binned_T, int bin_bytes,
                               const void* node, const void* g,
                               const void* h, const void* w, void* out,
                               long long R, int F, int N, int Bt, int Nb,
                               int n_chunks, long long rows_per_block,
                               int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch<int8_t>(binned_T, node, g, h, w, out, R, F, N, Bt, Nb,
                          n_chunks, rows_per_block, smem_bytes, s);
  if (bin_bytes == 2)
    return launch<int16_t>(binned_T, node, g, h, w, out, R, F, N, Bt, Nb,
                           n_chunks, rows_per_block, smem_bytes, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
