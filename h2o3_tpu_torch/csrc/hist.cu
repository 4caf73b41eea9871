// Level histograms of tree growth, in CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel h2o3_tpu/ops/pallas_hist.py (hist_pallas at line
// 150, body _hist_kernel, pallas_call at line 179), which builds the same
// histograms as a one-hot bf16 contraction on the TPU's matrix unit over
// 1024-row tiles. None of that form is carried over: the card counts rows
// into histograms held in shared memory, or, where nodes are many, adds
// them straight into L2.
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
// Sums are float32, added in an order that varies from run to run, so their
// last bits do too.
//
// Bound at the main-path shape (R = 11,000,000 rows, F = 28, Bt = 65, int8
// bins): memory. Each launch must read 11M x 28 B of bins plus 4 B of node
// and 12 B of g/h/w per row, about 484 MB: 0.1445 ms at 3.35 TB/s. Its
// arithmetic, three float adds per active row and feature (under 1 GFLOP),
// is far below the card's float32 rate. What the byte count does not show
// is the shared memory the adds go through: up to 924M float adds a launch.
//
// The first version ran one feature per block and added with shared-memory
// atomicAdd. On this card a float atomicAdd in shared memory is a
// compare-and-swap loop (SASS ATOMS.CAST.SPIN): about 2 adds per clock per
// SM at best, which holds any atomic design above 1.8 ms at level 0. So the
// main path runs a kernel without atomics:
//
// lane_hist_kernel. A block owns a group of up to 32 features and a block of
// Nb nodes; lane l of every warp owns feature l of the group, for all three
// stats. A warp's 32 lanes thus never write the same address, and the slab
// is laid out [stat][node][bin][lane] so that they never share a bank
// either: each add is a plain shared load, add and store. Warps never share
// an address because each owns either a copy of the slab (N = 1: 8 copies,
// each warp taking its own rows) or a class of nodes (n mod owners), or a
// mix (N = 2: 4 copies x 2 owners); the copies are summed before the flush.
// A tile of rows is staged in shared memory by the whole block: node, g, h
// and w read once with 16-byte vector loads of four rows, the group's bins
// four rows to a word (32-bit for int8, 64-bit for int16). Feature row f
// starts at element f*R, which is aligned only when R is a multiple of
// four; otherwise the four bins straddle two aligned words, both of which
// hold bins of this row, and a funnel shift joins them. Nothing is copied or
// padded in device memory. The next tile's loads are in flight, in
// registers, while a tile is counted. Each warp scans its part of the
// tile's nodes 32 at a time, lists the rows it owns (a ballot and a prefix
// count), and counts them four at a time: the four rows' slab entries are
// all loaded before any is stored, a row that hits the bin of an earlier
// row of the four adds onto that row's sum, and a zero row fills the last
// four. The grid is persistent: as many blocks as the
// SMs hold (one each), split over feature groups and node blocks, each
// walking every row_splits-th tile and flushing its slab once, with global
// atomics (native float adds in L2), at the end.
// A lane's slab holds 3 x Nb x Bt floats, so Nb is at most 8 at Bt = 65;
// N = 16 (level 5) takes two node blocks, each reading every row.
//
// atomic_hist_kernel. Where the lane and the global kernel were both
// measured the slower (fewer than 4 nodes of 257 bins: XGBoost's levels
// 0-2), the wrapper's plan takes the first design: one block per feature, a node block from a 96 KB budget,
// one row per thread per tile, and shared-memory atomicAdd.
//
// global_hist_kernel. Both kernels above give each node block every row, so
// at many nodes they read the rows node_blocks times (252 times for the
// atomic kernel at 1024 nodes of 65 bins, 924 at 4096) and lost 13-26x to
// one index_add_. The reference never ran its kernel there either: beyond
// 32 node blocks pallas_hist.py sends a level to the scatter path
// (models/tree.py:_level_histograms, a segment_sum). This kernel is that
// path's counterpart on the card. It reads each row once per pass whatever
// N is: a block stages a tile of 1024 rows' node, g, h and w with 16-byte
// loads, drops the rows at node -1 (and rows of zeros, which add nothing:
// DRF's Poisson bootstrap at rate 0.632 leaves e^-0.632, about half, of its
// rows at weight 0) with a
// ballot and a prefix count before any bin is read, stages the tile's bins
// of the pass's features four rows to a word, and then adds every (listed
// row, feature) into global memory with one 16-byte fire-and-forget float
// reduction (REDG.E.ADD.F32x4) into a [K, F, N*Bt, 4] scratch, whose first
// three floats the wrapper keeps. On this card the v4 reduction carries three
// floats for the cost of one: 8.97e10 of them a second at random addresses
// of a 3 MB array, as many as scalar ones, so 3.1x the entries of three
// scalar adds (bench/global_red_rates.cu). Reductions miss L2 beyond it
// (1.98e10 a second at 90 MB), so the features are walked in passes, every
// block over all its rows per pass, each pass's entries about 8 MiB: at 4096
// nodes of 65 bins (89 MB of output) 14 passes of 2 features took 3.15 ms
// against 8.68 ms in one pass and 4.64 ms at 32 MiB a pass
// (bench/hist_crossover.py). The best budget lies far below the 50 MB L2,
// which the streamed rows share (loads marked evict-first, ld.global.cs,
// were tried and changed nothing). The grid is persistent, one wave of the
// SMs times CUDA's occupancy, over rows and classes. Where all rows add
// into few entries the reductions contend, and below the plan's switch the
// lane or the atomic kernel is faster. What bounds it is the reduction
// rate: one per active (row, feature), 1.72 ms at 5.5M rows x 28 at 8.97e10
// a second, against its 1.93 ms at 1024 nodes.
//
// Classes. Multinomial GBM and DRF grow K class trees per round; the JAX
// reference runs the Pallas kernel under jax.vmap over them, one dispatch
// per level. Here one launch covers all K: the grid's y dimension is the
// class, each block offsets node, g, h (class stride R), w (stride R, or 0
// where all classes share one weight row) and out (stride F*N*Bt*3) by its
// class, and the persistent plan splits the SMs over K times the feature
// groups and node blocks. Each class's slab is its own, so the plan of one
// class is the plan of the batch. Every class re-reads the bins: the bound
// counts them once (at K = 3, 11M x 28 int8: 748 MB, 0.2233 ms), so a
// batch runs at most 1/K of it until a later kernel reads each bin word
// once for all K classes.
//
// The plan (hist.py:_KERNEL_SWITCH) takes each kernel where
// bench/hist_crossover.py measured it the fastest: the lane kernel below 32
// nodes at 65 bins and below 8 at 129, the atomic kernel below 4 at 257, and
// the global kernel from there on.
//
// What is left for later: bins read once for all classes; a deterministic
// fixed-point mode (integer shared atomics are native and about 4x faster);
// a ring of bulk asynchronous copies (cp.async.bulk) for the staging. Such
// a ring stages 512-row tiles faster than the registers' prefetch, but not
// 256-row tiles (bench/tile_staging.cu), and only 256-row stages fit: the
// slab takes 199,680 of the block's 232,448 bytes at every main-path level.
// Bulk copies also land each array linearly at 16-byte aligned addresses,
// which gives up the stats' float4 per row and the odd bin-row stride that
// keep the counting loop, which holds the kernel, at one conflict-free
// shared load per row and feature.
//
// Kinds 0 and 3 of h2o3_level_hist are the lane and the atomic kernel, 4 the
// global kernel. Kinds 1 and 2 launch lane_hist_kernel with the slab
// updates compiled out (it stages, lists and decodes the same rows and adds
// nothing) and with only the tile staging left. chip_smoke.py times them
// beside the real kernel to split its time into staging, listing and
// decoding, and updates; nothing on the path launches them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// Four bins of one feature as one word.
template <typename BinT> struct Word;
template <> struct Word<int8_t> { using T = unsigned int; };
template <> struct Word<int16_t> { using T = unsigned long long; };

// Bins of rows e..e+3 of the flat [F*R] array, e counted from `wbase`, the
// aligned word at or below the array's start. Rows come in fours from a
// multiple of four, so the shift s is the same for a whole feature row.
// Branch-free, and both loads unconditional (the second re-reads the first
// word where one word holds all four bins), so that the loads of many calls
// go out together.
__device__ __forceinline__ unsigned join(unsigned lo, unsigned hi, int s) {
  return __funnelshift_r(lo, hi, 8 * s);
}
__device__ __forceinline__ unsigned long long join(unsigned long long lo,
                                                   unsigned long long hi,
                                                   int s) {
  return s ? (lo >> (16 * s)) | (hi << (64 - 16 * s)) : lo;
}

template <typename BinT>
__device__ __forceinline__ typename Word<BinT>::T load_bins4(
    const typename Word<BinT>::T* __restrict__ wbase, long long e) {
  using W = typename Word<BinT>::T;
  const long long q = e >> 2;
  const int s = static_cast<int>(e & 3);
  const W lo = __ldg(wbase + q);
  const W hi = __ldg(wbase + q + (s != 0));
  return join(lo, hi, s);
}

// Bins of feature row `row0` (an element index of binned_T) at rows
// r..r+3, zero past R: the last rows are read one at a time.
template <typename BinT>
__device__ __forceinline__ typename Word<BinT>::T load_bins(
    const BinT* __restrict__ binned_T,
    const typename Word<BinT>::T* __restrict__ wbase, long long bin_skew,
    long long row0, long long r, long long R) {
  using W = typename Word<BinT>::T;
  constexpr int kBits = 8 * sizeof(BinT);
  if (r + 4 <= R) return load_bins4<BinT>(wbase, bin_skew + row0 + r);
  W v = 0;
  for (int k = 0; k < 4 && r + k < R; ++k)
    v |= (static_cast<W>(binned_T[row0 + r + k]) & ((W(1) << kBits) - 1))
         << (kBits * k);
  return v;
}

// node, g, h and w of rows r..r+3: 16-byte loads where all four arrays are
// aligned for them (kVec) and the four rows exist; node -1 past R.
struct Quad {
  int4 n;
  float4 g, h, w;
};

template <bool kVec>
__device__ __forceinline__ Quad load_quad(const int32_t* __restrict__ node,
                                          const float* __restrict__ g,
                                          const float* __restrict__ h,
                                          const float* __restrict__ w,
                                          long long r, long long R) {
  Quad q;
  if (kVec && r + 4 <= R) {
    q.n = __ldg(reinterpret_cast<const int4*>(node + r));
    q.g = __ldg(reinterpret_cast<const float4*>(g + r));
    q.h = __ldg(reinterpret_cast<const float4*>(h + r));
    q.w = __ldg(reinterpret_cast<const float4*>(w + r));
    return q;
  }
  int n[4];
  float gg[4], hh[4], ww[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = r + k < R;
    n[k] = in ? __ldg(node + r + k) : -1;
    gg[k] = in ? __ldg(g + r + k) : 0.0f;
    hh[k] = in ? __ldg(h + r + k) : 0.0f;
    ww[k] = in ? __ldg(w + r + k) : 0.0f;
  }
  q.n = make_int4(n[0], n[1], n[2], n[3]);
  q.g = make_float4(gg[0], gg[1], gg[2], gg[3]);
  q.h = make_float4(hh[0], hh[1], hh[2], hh[3]);
  q.w = make_float4(ww[0], ww[1], ww[2], ww[3]);
  return q;
}

// ---------------------------------------------------------------------------
// lane_hist_kernel

constexpr int kLaneThreadsMax = 256;   // 8 warps: copies x owners
// Modes of the lane kernel: count rows into the slab; the same with the
// slab updates compiled out (stages, lists and decodes the same rows); only
// stage the tiles. The last two are measurement instances.
enum { kCount, kUpdatesOut, kStagingOnly };
// Tile rows per warp: 64 int8 or 32 int16, so that a tile's bins are the
// same bytes either way (_LANE_ROWS_PER_WARP in hist.py).
template <typename BinT> __host__ __device__ constexpr int rows_per_warp() {
  return 64 / static_cast<int>(sizeof(BinT));
}
// Bin words one thread stages per tile: 32 features x T/4 quads over 32 x
// warps threads. Word j of thread t is quad t % (T/4) of feature
// j * feat_step() + t / (T/4).
template <typename BinT> __host__ __device__ constexpr int words_per_thread() {
  return rows_per_warp<BinT>() / 4;
}
template <typename BinT> __host__ __device__ constexpr int feat_step() {
  return 32 / words_per_thread<BinT>();
}

constexpr int kList = 64;   // a warp's row list: a window and a batch's rest
// Shared memory of the lane kernel in 32-bit words: the slab copies
// [copies][3][Nb][Bt][32]; the staged tile's stats [T + 1][4] (g, h, w and
// the row's node offset; row T is a zero row), node [T], each warp's row
// list [kList], and bins [Fb][T*sizeof(BinT)/4 + 1] (the odd stride puts
// each lane's feature row on its own bank; the last word holds row T's bin,
// 0). hist.py's _lane_smem_bytes mirrors it.
template <typename BinT>
long long lane_smem_words(int Nb, int Bt, int Fb, int copies, int warps) {
  const long long T = static_cast<long long>(rows_per_warp<BinT>()) * warps;
  const long long stride = T * static_cast<long long>(sizeof(BinT)) / 4 + 1;
  return static_cast<long long>(copies) * 3 * Nb * Bt * 32 + 4 * (T + 1) + T
         + kList * warps + Fb * stride;
}

// The next tile's bytes, held in registers while the current tile is
// counted: one quad of rows (threads below T/4) and the group's bin words.
template <typename BinT>
struct Staged {
  Quad q;
  typename Word<BinT>::T b[words_per_thread<BinT>()];
};

template <typename BinT, bool kVec>
__device__ __forceinline__ void load_tile(
    Staged<BinT>& st, const BinT* __restrict__ binned_T,
    const typename Word<BinT>::T* __restrict__ wbase, long long bin_skew,
    const int32_t* __restrict__ node, const float* __restrict__ g,
    const float* __restrict__ h, const float* __restrict__ w, long long R,
    long long r0, int quads, int f0, int fb) {
  const int qd = threadIdx.x % quads;
  const int fl = threadIdx.x / quads;
  const long long r = r0 + 4 * qd;
  if (static_cast<int>(threadIdx.x) < quads)
    st.q = load_quad<kVec>(node, g, h, w, r, R);
  if (r0 + 4 * quads <= R) {
    // a whole tile: every load goes out at once, unconditionally (words of
    // features past the group re-read its last feature and are not stored)
#pragma unroll
    for (int j = 0; j < words_per_thread<BinT>(); ++j) {
      const int f = min(j * feat_step<BinT>() + fl, fb - 1);
      st.b[j] = load_bins4<BinT>(
          wbase, bin_skew + static_cast<long long>(f0 + f) * R + r);
    }
  } else {
#pragma unroll
    for (int j = 0; j < words_per_thread<BinT>(); ++j) {
      const int f = j * feat_step<BinT>() + fl;
      st.b[j] = f < fb ? load_bins<BinT>(binned_T, wbase, bin_skew,
                                         static_cast<long long>(f0 + f) * R,
                                         r, R)
                       : 0;
    }
  }
}

template <typename BinT>
__device__ __forceinline__ void store_tile(const Staged<BinT>& st,
                                           float4* stats_s, int* node_s,
                                           unsigned* bins_s, int quads,
                                           int stride, int fb, int n0,
                                           int Bt) {
  const int qd = threadIdx.x % quads;
  const int fl = threadIdx.x / quads;
  if (static_cast<int>(threadIdx.x) < quads) {
    const Quad& q = st.q;
    const int k = 4 * qd;
    reinterpret_cast<int4*>(node_s)[qd] = q.n;
    // .w: the row's node offset in a slab copy, (node - n0) * Bt * 32
    // (meaningless for rows of other blocks, which are never counted)
    const int m = Bt * 32;
    stats_s[k] = make_float4(q.g.x, q.h.x, q.w.x,
                             __int_as_float((q.n.x - n0) * m));
    stats_s[k + 1] = make_float4(q.g.y, q.h.y, q.w.y,
                                 __int_as_float((q.n.y - n0) * m));
    stats_s[k + 2] = make_float4(q.g.z, q.h.z, q.w.z,
                                 __int_as_float((q.n.z - n0) * m));
    stats_s[k + 3] = make_float4(q.g.w, q.h.w, q.w.w,
                                 __int_as_float((q.n.w - n0) * m));
  }
  constexpr int kU32 = sizeof(BinT);   // 32-bit words per bin word
#pragma unroll
  for (int j = 0; j < words_per_thread<BinT>(); ++j) {
    const int f = j * feat_step<BinT>() + fl;
    if (f < fb) {
      unsigned* dst = bins_s + f * stride + kU32 * qd;
      dst[0] = static_cast<unsigned>(st.b[j]);
      if (kU32 == 2)
        dst[1] = static_cast<unsigned>(
            static_cast<unsigned long long>(st.b[j]) >> 32);
    }
  }
}

// Four listed rows into the lane's slab column. A row with a negative bin
// adds zeros to bin 0. The four rows' entries are all loaded before any is
// stored; a row that hits the bin of an earlier row of the four adds onto
// that row's sum, and the stores, in row order, leave the last sum in place.
// kPad: rows listed as `pad` are the zero row, counted into the node at
// slab offset pad_off (one the warp owns, so that no other warp writes it).
template <typename BinT, bool kUpdate, bool kPad>
__device__ __forceinline__ void count4(float* my, int stat_len,
                                       const float4* stats_s,
                                       const unsigned* frow, int4 k4, int Bt,
                                       int pad, int pad_off, float& sink) {
  const int k[4] = {k4.x, k4.y, k4.z, k4.w};
  float v[4][3];
  int a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 sj = stats_s[k[j]];
    const int b = static_cast<int>(reinterpret_cast<const BinT*>(frow)[k[j]]);
    v[j][0] = b >= 0 ? sj.x : 0.0f;
    v[j][1] = b >= 0 ? sj.y : 0.0f;
    v[j][2] = b >= 0 ? sj.z : 0.0f;
    const int off = kPad && k[j] == pad ? pad_off : __float_as_int(sj.w);
    a[j] = off + min(max(b, 0), Bt - 1) * 32;
  }
  if (!kUpdate) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sink += v[j][0] + v[j][1] * v[j][2] + static_cast<float>(a[j] & 0xff);
    return;
  }
  float o[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int s = 0; s < 3; ++s) o[j][s] = my[s * stat_len + a[j]];
#pragma unroll
  for (int j = 1; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < j; ++e)
      if (a[j] == a[e])
#pragma unroll
        for (int s = 0; s < 3; ++s) o[j][s] = o[e][s] + v[e][s];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int s = 0; s < 3; ++s) my[s * stat_len + a[j]] = o[j][s] + v[j][s];
}

template <typename BinT, bool kVec, int kMode>
__global__ void __launch_bounds__(kLaneThreadsMax, 1)
lane_hist_kernel(const BinT* __restrict__ binned_T, long long bin_skew,
                 const int32_t* __restrict__ node,
                 const float* __restrict__ g, const float* __restrict__ h,
                 const float* __restrict__ w, float* __restrict__ out,
                 long long R, int F, int N, int Bt, int Fb, int Nb,
                 int copies, int owners, int row_splits,
                 long long w_stride) {
  using W = typename Word<BinT>::T;
  extern __shared__ float4 smem4[];
  // class k = blockIdx.y: its own node/g/h rows, w (shared when w_stride
  // is 0) and output; the bins are the same for every class
  {
    const long long k = blockIdx.y;
    node += k * R;
    g += k * R;
    h += k * R;
    w += k * w_stride;
    out += k * F * static_cast<long long>(N) * Bt * 3;
  }
  const int warps = blockDim.x / 32;
  const int T = rows_per_warp<BinT>() * warps;
  const int quads = T / 4;
  const int stride = T * static_cast<int>(sizeof(BinT)) / 4 + 1;

  // block -> (feature group, node block, row split), feature group fastest
  // so that the groups of one tile are scheduled together
  const int groups = (F + Fb - 1) / Fb;
  const int node_blocks = (N + Nb - 1) / Nb;
  int bid = blockIdx.x;
  const int f0 = (bid % groups) * Fb;
  bid /= groups;
  const int fb = min(Fb, F - f0);
  const int n0 = (bid % node_blocks) * Nb;
  const int nn = min(Nb, N - n0);
  const int split = bid / node_blocks;

  const int stat_len = Nb * Bt * 32;   // floats of one stat of one copy
  const int copy_len = 3 * stat_len;
  float* slab = reinterpret_cast<float*>(smem4);
  float4* stats_s = reinterpret_cast<float4*>(slab + copies * copy_len);
  int* node_s = reinterpret_cast<int*>(stats_s + T + 1);
  int* lists = node_s + T;
  unsigned* bins_s = reinterpret_cast<unsigned*>(lists + kList * warps);
  for (int i = threadIdx.x; i < copies * copy_len; i += blockDim.x)
    slab[i] = 0.0f;
  // the zero row T: no stats, and bin 0 in every feature row
  if (threadIdx.x == 0) stats_s[T] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int f = threadIdx.x; f < Fb; f += blockDim.x)
    bins_s[f * stride + stride - 1] = 0u;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = warp / owners;            // slab copy and part of the tile
  const int p = warp % owners;            // class of nodes owned
  float* my = slab + c * copy_len + lane;
  // lanes past the group count feature 0's bins into their own slab
  // column, which is never flushed
  const unsigned* frow = bins_s + (lane < fb ? lane : 0) * stride;
  int* list = lists + kList * warp;
  const int part = T / copies;            // rows of the tile per copy
  float sink = 0.0f;

  const W* wbase = reinterpret_cast<const W*>(binned_T - bin_skew);
  const long long tiles = (R + T - 1) / T;
  Staged<BinT> st;
  if (split < tiles)
    load_tile<BinT, kVec>(st, binned_T, wbase, bin_skew, node, g, h, w, R,
                          static_cast<long long>(split) * T, quads, f0, fb);
  for (long long t = split; t < tiles; t += row_splits) {
    __syncthreads();   // the last tile is counted (and the slab zeroed)
    store_tile<BinT>(st, stats_s, node_s, bins_s, quads, stride, fb, n0,
                     Bt);
    __syncthreads();
    if (t + row_splits < tiles)   // in flight while this tile is counted
      load_tile<BinT, kVec>(st, binned_T, wbase, bin_skew, node, g, h, w, R,
                            (t + row_splits) * T, quads, f0, fb);
    if (kMode == kStagingOnly) continue;
    // the copy's rows, 32 at a time: each warp lists the rows it owns,
    // counts them four at a time, and carries the rest to the next window
    int listed = 0;
    for (int k0 = c * part; k0 < (c + 1) * part; k0 += 32) {
      const unsigned ln = static_cast<unsigned>(node_s[k0 + lane] - n0);
      const bool own = ln < static_cast<unsigned>(nn)
                       && static_cast<int>(ln & (owners - 1)) == p;
      const unsigned mask = __ballot_sync(0xffffffffu, own);
      if (own) list[listed + __popc(mask & ((1u << lane) - 1))] = k0 + lane;
      listed += __popc(mask);
      __syncwarp();
      const int full = listed & ~3;
      for (int i = 0; i < full; i += 4)
        count4<BinT, kMode == kCount, false>(
            my, stat_len, stats_s, frow,
            *reinterpret_cast<const int4*>(list + i), Bt, 0, 0, sink);
      const int rest = listed - full;
      const int r = lane < rest ? list[full + lane] : 0;
      __syncwarp();
      if (lane < rest) list[lane] = r;
      listed = rest;
      __syncwarp();
    }
    if (listed) {   // the last rows, with the zero row after them
      if (lane >= listed && lane < 4) list[lane] = T;
      __syncwarp();
      count4<BinT, kMode == kCount, true>(
          my, stat_len, stats_s, frow, *reinterpret_cast<const int4*>(list),
          Bt, T, p * Bt * 32, sink);
      __syncwarp();
    }
  }
  __syncthreads();

  // sum the copies and flush: slab index (stat, node, bin, lane) ->
  // out[f0 + lane, (n0 + node)*Bt + bin, stat]
  for (int i = threadIdx.x; i < copy_len; i += blockDim.x) {
    float v = slab[i];
    for (int cc = 1; cc < copies; ++cc) v += slab[cc * copy_len + i];
    const int l = i % 32;
    if (v != 0.0f && l < fb) {
      const int nb = i / 32;          // (stat * Nb + node) * Bt + bin
      const int b = nb % Bt;
      const int sn = nb / Bt;
      const int s = sn / Nb, n = sn % Nb;
      atomicAdd(out + ((static_cast<long long>(f0 + l) * N + n0 + n) * Bt
                       + b) * 3 + s, v);
    }
  }
  // keeps the loads-only instance's loads alive; never true for real data
  if (kMode == kUpdatesOut && sink == 1.0e38f) out[0] = sink;
}

// ---------------------------------------------------------------------------
// atomic_hist_kernel: the first kernel, on the persistent grid. A block owns
// one feature and a block of Nb nodes; each thread adds its rows (one row
// of every tile of kThreads rows) with shared-memory atomicAdd.

constexpr int kThreads = 256;   // also the rows of a tile (_ATOMIC_THREADS)

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
atomic_hist_kernel(const BinT* __restrict__ binned_T,
                   const int32_t* __restrict__ node,
                   const float* __restrict__ g, const float* __restrict__ h,
                   const float* __restrict__ w, float* __restrict__ out,
                   long long R, int F, int N, int Bt, int Nb,
                   int row_splits, long long w_stride) {
  extern __shared__ float slab[];
  {   // class k = blockIdx.y, as in lane_hist_kernel
    const long long k = blockIdx.y;
    node += k * R;
    g += k * R;
    h += k * R;
    w += k * w_stride;
    out += k * F * static_cast<long long>(N) * Bt * 3;
  }
  // block -> (feature, node block, row split), feature fastest
  const int node_blocks = (N + Nb - 1) / Nb;
  const int f = blockIdx.x % F;
  const int bid = blockIdx.x / F;
  const int n0 = (bid % node_blocks) * Nb;
  const int nn = min(Nb, N - n0);
  const int split = bid / node_blocks;
  const int len = nn * Bt * 3;
  for (int i = threadIdx.x; i < len; i += kThreads) slab[i] = 0.0f;
  __syncthreads();

  const BinT* bins = binned_T + static_cast<long long>(f) * R;
  const long long step = static_cast<long long>(row_splits) * kThreads;
  for (long long r = static_cast<long long>(split) * kThreads + threadIdx.x;
       r < R; r += step) {
    // node -1 and nodes of other blocks both fail this unsigned test
    const unsigned n = static_cast<unsigned>(node[r] - n0);
    if (n >= static_cast<unsigned>(nn)) continue;
    int b = static_cast<int>(bins[r]);
    if (b < 0) continue;
    b = min(b, Bt - 1);
    float* s = slab + (static_cast<int>(n) * Bt + b) * 3;
    atomicAdd(s, g[r]);
    atomicAdd(s + 1, h[r]);
    atomicAdd(s + 2, w[r]);
  }
  __syncthreads();

  float* o = out + (static_cast<long long>(f) * N + n0) * Bt * 3;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float v = slab[i];
    if (v != 0.0f) atomicAdd(o + i, v);
  }
}

// ---------------------------------------------------------------------------
// global_hist_kernel: each row read once for all features, whatever N is; the
// sums go straight to global memory as fire-and-forget reductions (RED),
// which the card's L2 adds natively. A block stages a tile of rows, lists
// the rows it must add (a ballot and a prefix count), stages the tile's bins
// of a pass's features, and then adds every (listed row, feature) once.

constexpr int kGlobalThreads = 256;
constexpr int kGlobalRows = 4 * kGlobalThreads;   // a quad of rows a thread
constexpr int kGlobalWarps = kGlobalThreads / 32;
constexpr int kRowBits = 10;                       // log2(kGlobalRows)
static_assert(kGlobalRows == 1 << kRowBits, "a list entry packs the row");

// Shared memory: the list [kGlobalRows] of float4 (g, h, w, node << 10 |
// row), each warp's count of listed rows, and the tile's bins, four rows to
// a word [Fb][kGlobalRows / 4]. hist.py's _global_smem_bytes mirrors it.
template <typename BinT>
long long global_smem_bytes(int Fb) {
  return 16LL * kGlobalRows + 4LL * kGlobalWarps
         + static_cast<long long>(Fb) * kGlobalRows * sizeof(BinT);
}

// One 16-byte reduction per (row, feature) into out laid out
// [K, F, N*Bt, 4] (the fourth float stays 0).
template <typename BinT, bool kVec>
__global__ void __launch_bounds__(kGlobalThreads)
global_hist_kernel(const BinT* __restrict__ binned_T, long long bin_skew,
                   const int32_t* __restrict__ node,
                   const float* __restrict__ g, const float* __restrict__ h,
                   const float* __restrict__ w, float* __restrict__ out,
                   long long R, int F, int N, int Bt, int Fb, int row_splits,
                   long long w_stride) {
  using W = typename Word<BinT>::T;
  extern __shared__ float4 smem4[];
  {   // class k = blockIdx.y, as in lane_hist_kernel
    const long long k = blockIdx.y;
    node += k * R;
    g += k * R;
    h += k * R;
    w += k * w_stride;
    out += k * F * static_cast<long long>(N) * Bt * 4;
  }
  float4* list = smem4;
  int* warp_n = reinterpret_cast<int*>(list + kGlobalRows);
  W* bins_w = reinterpret_cast<W*>(warp_n + kGlobalWarps);
  const BinT* bins_s = reinterpret_cast<const BinT*>(bins_w);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const unsigned below = (1u << lane) - 1;
  const W* wbase = reinterpret_cast<const W*>(binned_T - bin_skew);
  const long long tiles = (R + kGlobalRows - 1) / kGlobalRows;

  // features in passes of Fb, every block over all its rows per pass, so
  // that the entries in use at a time stay in L2
  for (int f0 = 0; f0 < F; f0 += Fb) {
    const int fb = min(Fb, F - f0);
    for (long long t = blockIdx.x; t < tiles; t += row_splits) {
      const long long r = t * kGlobalRows + 4 * tid;
      const Quad q = load_quad<kVec>(node, g, h, w, r, R);
      const int n[4] = {q.n.x, q.n.y, q.n.z, q.n.w};
      const float gg[4] = {q.g.x, q.g.y, q.g.z, q.g.w};
      const float hh[4] = {q.h.x, q.h.y, q.h.z, q.h.w};
      const float ww[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
      // a row is listed if it sits at a node of this call and adds
      // something: node -1 (and a row of zeros, which adds nothing) is
      // dropped before any of its bins is read
      bool keep[4];
      int pos[4];
      int listed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = static_cast<unsigned>(n[j]) < static_cast<unsigned>(N)
                  && (gg[j] != 0.0f || hh[j] != 0.0f || ww[j] != 0.0f);
        const unsigned m = __ballot_sync(0xffffffffu, keep[j]);
        pos[j] = listed + __popc(m & below);
        listed += __popc(m);
      }
      __syncthreads();   // the last tile's list and bins are consumed
      if (lane == 0) warp_n[warp] = listed;
      if (keep[0] || keep[1] || keep[2] || keep[3]) {
        for (int f = 0; f < fb; ++f) {
          const long long row0 = static_cast<long long>(f0 + f) * R;
          bins_w[f * (kGlobalRows / 4) + tid] =
              load_bins<BinT>(binned_T, wbase, bin_skew, row0, r, R);
        }
      }
      __syncthreads();
      int base = 0, count = 0;
#pragma unroll
      for (int i = 0; i < kGlobalWarps; ++i) {
        const int c = warp_n[i];
        base += i < warp ? c : 0;
        count += c;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (keep[j])
          list[base + pos[j]] = make_float4(
              gg[j], hh[j], ww[j], __int_as_float((n[j] << kRowBits)
                                                  | (4 * tid + j)));
      __syncthreads();
      if (count == 0) continue;
      // (feature, listed row) items f * count + i, kGlobalThreads apart
      int f = tid / count;
      int i = tid - f * count;
      const int fstep = kGlobalThreads / count;
      const int istep = kGlobalThreads - fstep * count;
      while (f < fb) {
        const float4 e = list[i];
        const int packed = __float_as_int(e.w);
        const int b = static_cast<int>(
            bins_s[f * kGlobalRows + (packed & (kGlobalRows - 1))]);
        if (b >= 0) {
          const long long a =
              (static_cast<long long>(f0 + f) * N + (packed >> kRowBits)) * Bt
              + min(b, Bt - 1);
          atomicAdd(reinterpret_cast<float4*>(out) + a,
                    make_float4(e.x, e.y, e.z, 0.0f));
        }
        i += istep;
        f += fstep;
        if (i >= count) {
          i -= count;
          ++f;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches

struct Args {
  const void* binned_T;
  const void* node;
  const void* g;
  const void* h;
  const void* w;
  void* out;
  long long R;
  int F, N, Bt, Fb, Nb, copies, owners, row_splits, smem_bytes;
  int K;                // classes: the grid's y dimension
  long long w_stride;   // elements between two classes' w (0: shared)
  cudaStream_t stream;
};

// Every launch sets its kernel's dynamic shared memory ceiling, also below
// the 48 KB default: the occupancy query (h2o3_level_hist_blocks_per_sm)
// sets the ceiling to the size it asks about, and a launch above a lower
// ceiling that a later query left is refused.
template <typename K>
cudaError_t prepare(K kernel, int smem_bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// 16-byte loads need every class's node/g/h/w rows aligned: the bases,
// and class strides of a multiple of four elements
bool vec_aligned(const Args& a) {
  return ((reinterpret_cast<uintptr_t>(a.node)
           | reinterpret_cast<uintptr_t>(a.g)
           | reinterpret_cast<uintptr_t>(a.h)
           | reinterpret_cast<uintptr_t>(a.w)) & 15) == 0
         && (a.K == 1 || (a.R % 4 == 0 && a.w_stride % 4 == 0));
}

// the class dimension and its strides, as the kernels take them
bool classes_ok(const Args& a) {
  return a.K >= 1 && a.K <= 65535 && (a.w_stride == 0 || a.w_stride == a.R);
}

template <typename BinT>
long long skew_of(const void* binned_T) {
  return static_cast<long long>(
      (reinterpret_cast<uintptr_t>(binned_T) % sizeof(typename Word<BinT>::T))
      / sizeof(BinT));
}

long long grid_of(const Args& a) {
  return static_cast<long long>((a.F + a.Fb - 1) / a.Fb)
         * ((a.N + a.Nb - 1) / a.Nb) * a.row_splits;
}

template <typename BinT, int kMode>
cudaError_t launch_lanes(const Args& a) {
  const long long blocks = grid_of(a);
  const int warps = a.copies * a.owners;
  if (blocks < 1 || blocks > INT_MAX || !classes_ok(a) || a.Fb > 32
      || warps < 1 || warps * 32 > kLaneThreadsMax
      || 4 * lane_smem_words<BinT>(a.Nb, a.Bt, a.Fb, a.copies, warps)
             != a.smem_bytes)
    return cudaErrorInvalidConfiguration;
  auto kernel = vec_aligned(a) ? lane_hist_kernel<BinT, true, kMode>
                               : lane_hist_kernel<BinT, false, kMode>;
  cudaError_t e = prepare(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(a.K));
  kernel<<<grid, warps * 32, a.smem_bytes, a.stream>>>(
      static_cast<const BinT*>(a.binned_T), skew_of<BinT>(a.binned_T),
      static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), static_cast<const float*>(a.w),
      static_cast<float*>(a.out), a.R, a.F, a.N, a.Bt, a.Fb, a.Nb, a.copies,
      a.owners, a.row_splits, a.w_stride);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch_atomic(const Args& a) {
  const long long blocks = grid_of(a);
  if (blocks < 1 || blocks > INT_MAX || !classes_ok(a) || a.Fb != 1)
    return cudaErrorInvalidConfiguration;
  auto kernel = atomic_hist_kernel<BinT>;
  cudaError_t e = prepare(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(a.K));
  kernel<<<grid, kThreads, a.smem_bytes, a.stream>>>(
      static_cast<const BinT*>(a.binned_T),
      static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), static_cast<const float*>(a.w),
      static_cast<float*>(a.out), a.R, a.F, a.N, a.Bt, a.Nb, a.row_splits,
      a.w_stride);
  return cudaGetLastError();
}

// the largest node id a list entry packs beside the row
constexpr int kGlobalMaxNodes = 1 << (31 - kRowBits);

template <typename BinT>
cudaError_t launch_global(const Args& a) {
  if (a.row_splits < 1 || !classes_ok(a) || a.Fb < 1 || a.Fb > a.F
      || a.N > kGlobalMaxNodes
      || (reinterpret_cast<uintptr_t>(a.out) & 15) != 0
      || global_smem_bytes<BinT>(a.Fb) != a.smem_bytes)
    return cudaErrorInvalidConfiguration;
  auto kernel = vec_aligned(a) ? global_hist_kernel<BinT, true>
                               : global_hist_kernel<BinT, false>;
  cudaError_t e = prepare(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(a.row_splits),
                  static_cast<unsigned>(a.K));
  kernel<<<grid, kGlobalThreads, a.smem_bytes, a.stream>>>(
      static_cast<const BinT*>(a.binned_T), skew_of<BinT>(a.binned_T),
      static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), static_cast<const float*>(a.w),
      static_cast<float*>(a.out), a.R, a.F, a.N, a.Bt, a.Fb, a.row_splits,
      a.w_stride);
  return cudaGetLastError();
}

// kinds 0-2: lane_hist_kernel in mode kCount, kUpdatesOut, kStagingOnly;
// 3: atomic_hist_kernel; 4: global_hist_kernel
int dispatch(int kind, int bin_bytes, const Args& a) {
  if (bin_bytes == 1) {
    if (kind == 0) return launch_lanes<int8_t, kCount>(a);
    if (kind == 1) return launch_lanes<int8_t, kUpdatesOut>(a);
    if (kind == 2) return launch_lanes<int8_t, kStagingOnly>(a);
    if (kind == 3) return launch_atomic<int8_t>(a);
    if (kind == 4) return launch_global<int8_t>(a);
  }
  if (bin_bytes == 2) {
    if (kind == 0) return launch_lanes<int16_t, kCount>(a);
    if (kind == 1) return launch_lanes<int16_t, kUpdatesOut>(a);
    if (kind == 2) return launch_lanes<int16_t, kStagingOnly>(a);
    if (kind == 3) return launch_atomic<int16_t>(a);
    if (kind == 4) return launch_global<int16_t>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename K>
cudaError_t occupancy(K kernel, int threads, int smem_bytes, int* blocks) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem_bytes);
}

}  // namespace

// Launches a histogram kernel on `stream`; returns the cudaError_t of the
// launch. kind 0 is lane_hist_kernel, 1 and 2 its measurement instances
// (updates out, staging only), 3 atomic_hist_kernel, 4 global_hist_kernel.
// The Python wrapper (h2o3_tpu_torch/ops/hist.py) has checked every
// argument and planned Fb (1 for the atomic kernel, the features of a pass
// for the global one), Nb, copies, owners (lanes only), row_splits and
// smem_bytes. K classes: node, g and h are [K, R], w is [K, R] (w_stride =
// R) or one [R] row for all (w_stride = 0), out [K, F, N*Bt, 3] ([K, F,
// N*Bt, 4], 16-byte aligned, for the global kernel).
extern "C" int h2o3_level_hist(int kind, const void* binned_T, int bin_bytes,
                               const void* node, const void* g,
                               const void* h, const void* w, void* out,
                               long long R, int F, int N, int Bt, int Fb,
                               int Nb, int copies, int owners,
                               int row_splits, int smem_bytes, int K,
                               long long w_stride, void* stream) {
  const Args a{binned_T, node, g, h, w, out, R, F, N, Bt, Fb, Nb, copies,
               owners, row_splits, smem_bytes, K, w_stride,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kind, bin_bytes, a);
}

// Blocks of kernel `kind` (0, 3 or 4) one SM holds with `threads` threads and
// `smem_bytes` of dynamic shared memory, into *blocks; returns the
// cudaError_t of the query.
extern "C" int h2o3_level_hist_blocks_per_sm(int kind, int bin_bytes,
                                             int threads, int smem_bytes,
                                             int* blocks) {
  if (kind == 0 && bin_bytes == 1)
    return occupancy(lane_hist_kernel<int8_t, true, kCount>, threads,
                     smem_bytes, blocks);
  if (kind == 0 && bin_bytes == 2)
    return occupancy(lane_hist_kernel<int16_t, true, kCount>, threads,
                     smem_bytes, blocks);
  if (kind == 3 && bin_bytes == 1)
    return occupancy(atomic_hist_kernel<int8_t>, threads, smem_bytes,
                     blocks);
  if (kind == 3 && bin_bytes == 2)
    return occupancy(atomic_hist_kernel<int16_t>, threads, smem_bytes,
                     blocks);
  if (kind == 4 && bin_bytes == 1)
    return occupancy(global_hist_kernel<int8_t, true>, threads, smem_bytes,
                     blocks);
  if (kind == 4 && bin_bytes == 2)
    return occupancy(global_hist_kernel<int16_t, true>, threads, smem_bytes,
                     blocks);
  return cudaErrorInvalidValue;
}

extern "C" const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
