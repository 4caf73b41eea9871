// Level histograms of tree growth, in CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel h2o3_tpu/ops/pallas_hist.py (hist_pallas at line
// 150, body _hist_kernel, pallas_call at line 179), which builds the same
// histograms as a one-hot bf16 contraction on the TPU's matrix unit over
// 1024-row tiles. None of that form is carried over: the card counts rows
// into histograms held in shared memory.
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
// atomic_hist_kernel. Where the lane kernel was measured the slower (many
// node blocks, each reading every row, or blocks of fewer than 8 warps, as
// at 129 and 257 bins; hist.py's _LANE_MAX_NODE_BLOCKS), the wrapper's plan
// takes the first design: one block per feature, a node block from a 96 KB
// budget, one row per thread per tile, and shared-memory atomicAdd.
//
// What is left for later: a class (K) batch dimension; a deterministic
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
// Kinds 1 and 2 of h2o3_level_hist launch lane_hist_kernel with the slab
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
                 int copies, int owners, int row_splits) {
  using W = typename Word<BinT>::T;
  extern __shared__ float4 smem4[];
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
                   int row_splits) {
  extern __shared__ float slab[];
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
  cudaStream_t stream;
};

template <typename K>
cudaError_t prepare(K kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

bool vec_aligned(const Args& a) {
  return ((reinterpret_cast<uintptr_t>(a.node)
           | reinterpret_cast<uintptr_t>(a.g)
           | reinterpret_cast<uintptr_t>(a.h)
           | reinterpret_cast<uintptr_t>(a.w)) & 15) == 0;
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
  if (blocks < 1 || blocks > INT_MAX || a.Fb > 32 || warps < 1
      || warps * 32 > kLaneThreadsMax
      || 4 * lane_smem_words<BinT>(a.Nb, a.Bt, a.Fb, a.copies, warps)
             != a.smem_bytes)
    return cudaErrorInvalidConfiguration;
  auto kernel = vec_aligned(a) ? lane_hist_kernel<BinT, true, kMode>
                               : lane_hist_kernel<BinT, false, kMode>;
  cudaError_t e = prepare(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, a.smem_bytes,
           a.stream>>>(
      static_cast<const BinT*>(a.binned_T), skew_of<BinT>(a.binned_T),
      static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), static_cast<const float*>(a.w),
      static_cast<float*>(a.out), a.R, a.F, a.N, a.Bt, a.Fb, a.Nb, a.copies,
      a.owners, a.row_splits);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch_atomic(const Args& a) {
  const long long blocks = grid_of(a);
  if (blocks < 1 || blocks > INT_MAX || a.Fb != 1)
    return cudaErrorInvalidConfiguration;
  auto kernel = atomic_hist_kernel<BinT>;
  cudaError_t e = prepare(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), kThreads, a.smem_bytes,
           a.stream>>>(
      static_cast<const BinT*>(a.binned_T),
      static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), static_cast<const float*>(a.w),
      static_cast<float*>(a.out), a.R, a.F, a.N, a.Bt, a.Nb, a.row_splits);
  return cudaGetLastError();
}

// kinds 0-2: lane_hist_kernel in mode kCount, kUpdatesOut, kStagingOnly;
// 3: atomic_hist_kernel
int dispatch(int kind, int bin_bytes, const Args& a) {
  if (bin_bytes == 1) {
    if (kind == 0) return launch_lanes<int8_t, kCount>(a);
    if (kind == 1) return launch_lanes<int8_t, kUpdatesOut>(a);
    if (kind == 2) return launch_lanes<int8_t, kStagingOnly>(a);
    if (kind == 3) return launch_atomic<int8_t>(a);
  }
  if (bin_bytes == 2) {
    if (kind == 0) return launch_lanes<int16_t, kCount>(a);
    if (kind == 1) return launch_lanes<int16_t, kUpdatesOut>(a);
    if (kind == 2) return launch_lanes<int16_t, kStagingOnly>(a);
    if (kind == 3) return launch_atomic<int16_t>(a);
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
// (updates out, staging only), 3 atomic_hist_kernel. The Python wrapper
// (h2o3_tpu_torch/ops/hist.py) has checked every argument and planned Fb
// (1 for the atomic kernel), Nb, copies, owners (lanes only), row_splits
// and smem_bytes.
extern "C" int h2o3_level_hist(int kind, const void* binned_T, int bin_bytes,
                               const void* node, const void* g,
                               const void* h, const void* w, void* out,
                               long long R, int F, int N, int Bt, int Fb,
                               int Nb, int copies, int owners,
                               int row_splits, int smem_bytes,
                               void* stream) {
  const Args a{binned_T, node, g, h, w, out, R, F, N, Bt, Fb, Nb, copies,
               owners, row_splits, smem_bytes,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kind, bin_bytes, a);
}

// Blocks of kernel `kind` (0 or 3) one SM holds with `threads` threads and
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
  return cudaErrorInvalidValue;
}

extern "C" const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
