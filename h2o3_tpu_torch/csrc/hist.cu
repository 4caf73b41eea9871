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
// The global kernel's sums are float32, added in an order that varies from
// run to run, so their last bits do too; the fixed kernel's are exact
// integer sums of quantised values, the same bits every run.
//
// Bound at the main-path shape (R = 11,000,000 rows, F = 28, Bt = 65, int8
// bins): memory. Each launch must read 11M x 28 B of bins plus 4 B of node
// and 12 B of g/h/w per row, about 484 MB: 0.1445 ms at 3.35 TB/s. Its
// arithmetic, three float adds per active row and feature (under 1 GFLOP),
// is far below the card's float32 rate. What the byte count does not show
// is the shared memory the adds go through: up to 924M float adds a launch.
//
// On this card a float atomicAdd in shared memory is a compare-and-swap
// loop (SASS ATOMS.CAST.SPIN): about 2 adds per clock per SM at best,
// which holds any float atomic design above 1.8 ms at level 0. An integer
// atomicAdd is native (ATOMS.ADD, 10-14 adds per clock per SM with lanes
// on features, bench/smem_update_rates.cu), and a kernel that adds
// integers was measured faster at every level of few nodes than one
// without atomics (bench/hist_crossover.py). Two kernels:
//
// fixed_hist_kernel. Fixed-point sums in int32 shared atomics, each row read
// once per block for all of the block's features, flushed into an int64
// accumulator; the section above the kernel states its layout, its scale,
// its overflow bound and its error bound. Node, g, h and w of a row are
// read once, the group's bins four rows to a word (32-bit for int8, 64-bit
// for int16). Feature row f starts at element f*R, which is aligned only
// when R is a multiple of four; otherwise the four bins straddle two
// aligned words, both of which hold bins of this row, and a funnel shift
// joins them. Nothing is copied or padded in device memory. The grid is
// persistent: as many blocks as the SMs hold (one each), split over
// feature groups, node blocks and rows.
//
// global_hist_kernel. A kernel with a slab per node block gives each node
// block every row, so at many nodes it reads the rows node_blocks times
// (252 times for the first kernel at 1024 nodes of 65 bins, 924 at 4096),
// which lost 13-26x to one index_add_. The reference never ran its kernel
// there either: beyond
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
// fixed kernel is faster. What bounds it is the reduction
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
// bench/hist_crossover.py measured it the fastest at 11M rows: the fixed
// kernel below 64 nodes at 65 bins, below 32 at 129, below 16 at 257 and
// below 4 at 1025; the global kernel from there on. The fixed kernel's
// precision is part of its plan (hist.py:fixed_needed_qbits): an entry of
// n rows is off by about 2^-qbits x sqrt(n) x max|x|, while the check's
// floor grows as n, so the plan keeps 2 x qbits + log2(n) >= 41 at the
// level's mean n = R / (2 N Bt), flushing more often where entries hold
// fewer rows (qbits up to 22). At 11M rows every planned level keeps 15
// bits; at 1.5M rows and 32 nodes of 65 bins it keeps 17.
//
// What is left for later: bins read once for all classes; fixed-point sums
// for the global kernel; a ring of bulk asynchronous copies
// (cp.async.bulk) for the staging. Such
// a ring stages 512-row tiles faster than the registers' prefetch, but not
// 256-row tiles (bench/tile_staging.cu), and only 256-row stages fit: the
// slab takes 199,680 of the block's 232,448 bytes at every main-path level.
// Bulk copies also land each array linearly at 16-byte aligned addresses,
// which gives up the list's int4 per row and the odd bin-row stride that
// keep the adding loop, which holds the kernel, at one conflict-free shared
// load per row and feature.
//
// Entry points: h2o3_fixed_hist launches the fixed kernel after its scale
// kernel, in one of four modes: counting; one of two measurement
// instances, with the atomic adds and flushes compiled out (it stages,
// quantises and lists the same rows and reads their bins) or with only the
// tile loads and stores left, which chip_smoke.py times beside the real
// kernel to split its time into staging, listing and adding (nothing on
// the training path launches them); or the node totals of a tree's final
// level, reading no bins. h2o3_global_hist launches the global
// kernel; h2o3_level_hist_blocks_per_sm asks CUDA's occupancy of either.

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
// fixed_hist_kernel: fixed-point sums with native integer shared atomics. A
// block of 16 warps owns a group of Fb features and a block of Nb nodes,
// one block per SM. Its first eight warps stage tiles of kFixedRows rows,
// each tile once for all the group's features: one row a thread (node, g,
// h and w, quantised on the way in) and the bins four rows to a word, two
// tiles' loads in flight in registers; they list the rows that add
// something (ballot and prefix count) and store list and bins into one of
// two stages of shared memory. Its other eight warps add the staged rows:
// lanes own features, lane l adding feature l % P
// (P, the feature stride, is Fb rounded up to a power of two) of the
// warp's row l / P, each (row, feature) three int32 atomicAdds (ATOMS.ADD)
// into the slab [3][Nb][Bt][P], four rows' loads issued before their adds.
// At P = 32 the 32 lanes of a warp fall on 32 banks, so its atomics never
// conflict, whatever the bins. Named barriers hand each stage from the
// staging warps to the adding warps ("full") and back ("empty"), so that
// loading a tile overlaps adding the one before. Every flush_tiles tiles,
// and at the end, the adding warps add the slab into an int64 accumulator
// [K, F, N*Bt, 3] with 64-bit fire-and-forget reductions (RED.E.ADD.64),
// each block starting at its own offset so that the blocks' reductions
// fall on different entries, and zero it; the last block of each (class,
// feature group, node block) to finish converts its part of the
// accumulator to the float32 output. The slab at 257 bins is 98,688 bytes
// a node beside 36,992 bytes of stages; the plan picks feature groups and
// nodes per block to read the fewest bytes per row.
//
// The scale: two tiers. One outlier must not coarsen every row's step (five
// rows of g = 1e4 among normal g put the step of a single scale at 0.5 and
// missed the check 45-fold), so the scale of stat s comes from the bulk of
// its values and the few above it are added apart. fixed_scale_kernel counts
// the active values of each stat (rows at a node of the call, all classes)
// by their float exponent, 256 buckets per stat (the biased exponent field:
// bucket b holds 2^(b-127) <= |x| < 2^(b-126), 255 the non-finite), in
// shared memory with a copy of the buckets for each lane so that a warp's
// adds never meet, adds its block's counts into one [3][256] array, and
// zeroes the accumulator. Each histogram block reads the counts. The top
// bucket T is the highest non-empty finite one; the bulk bucket B is the
// highest one whose values, with those of every bucket above it, outnumber
// kOutlierCap (64), or T where all values of the stat do not; B is raised
// to T - (56 - qbits) at the lowest. With E_s = max(B, 1) - 126 (for B = T,
// the exponent of max|x_s|, as in frexp), a value below 2^E_s is q =
// rint(x * 2^(qbits - E_s)), |q| <= 2^qbits, added into the slab. A row
// with a value at or above it, an outlier (fewer than kOutlierCap of them
// in the launch), is listed apart, whole, from the end of its tile's list,
// and the adding warps add its three values, each rounded at its stat's
// scale to a 64-bit integer, straight into the int64 accumulator, one
// 64-bit reduction per (row, feature, stat). Both products are exact. Where
// no stat is skewed, B = T and nothing is an outlier: the single-scale rule
// of before. The staging warps hold two tiles in flight in the kernel's
// 128 registers, so what the rule adds to their loop holds no register:
// the factors 2^(qbits - E_s) are read from shared memory for every tile,
// the bound 2^qbits is a launch parameter in the constant bank, and
// outlier rows take their list slots with a shared atomic (each register
// more spilled the loop into local memory, which L1 holds poorly beside a
// slab of 200 KB: the kernel ran 2x slower).
// The plan takes qbits = floor(log2((2^31 - 1) / L)) (15 to 22), L the rows
// a block adds between two flushes, so that no int32 entry can overflow:
// L x 2^qbits <= 2^31 - 1 whatever the data. It picks L, as large as the
// block's rows allow, so that qbits meets the precision rule below. An
// int64 entry holds at most R x 2^22 < 2^53 from the slabs and at most
// kOutlierCap x 2^(qbits + T - B) <= 2^62 from the outliers, so its sums
// are exact too; the conversion (acc x 2^(E_s - qbits), in double, then
// rounded to float) rounds once where an entry passes 2^53 and else only
// in that last rounding. Every count, bucket and sum is an integer, so the
// plan of the scale is decided on the card with no host sync, and repeats.
//
// Error bound. Each value, bulk or outlier, is off by at most half a step,
// 2^(E_s - qbits - 1), so an entry summing n rows is within n x 2^(E_s -
// qbits - 1) of the exact sum, plus float32 rounding of the result (2^-24
// of it). 2^E_s is the bulk bound: fewer than kOutlierCap active values of
// the stat lie at or above it (unless the clamp raised B), and it is at
// most 2 max|x_s|. At XGBoost's level 0 (11M rows over 132 blocks,
// flushed every L = 65,280 rows, qbits 15) that is n x max|x| / 32768 at
// worst; the rounding errors being independent, a bin of 43k rows of g
// (max|g| about 5.5) is off by about 0.015 (one standard deviation). That
// error grows as 2^-qbits x sqrt(n), an entry's sum and the float32
// check's floor (1e-5 of the largest entry) as n, so at 15 bits the check
// failed from about 670 rows an entry on (bench/hist_crossover.py). The
// plan therefore keeps 2 x qbits + log2(n) >= 41 at the level's mean
// n = R / (2 N Bt) (hist.py:fixed_needed_qbits), a factor of 1.7 below
// those failures, by flushing more often where entries hold fewer rows.
//
// Non-finite stats: a NaN or an infinity among a stat's active values (a
// count in bucket 255) makes that stat NaN in every entry of the output
// (the plain version's NaN or infinity lands in the rows' bins only). Sums
// of integers do not depend on the order of the adds: two launches on the
// same inputs give bit-identical output.
//
// Node totals. The final level of a tree needs only each node's (G, H, W):
// the kTotals instance is the kernel at F = 1 and Bt = 1 that reads no
// bins (every row's bin is 0), [K, N, 3] from node, g, h and w alone, with
// the same scale and sums, so its bits repeat from run to run as the float
// index_add_ it replaces did not.
//
// Across ranks (h2o3_tpu_torch/ops/hist.py:mesh_level_histograms). The
// W ranks of a cloud each hold a block of the rows, and a level's
// histograms must equal, bit for bit, what one launch over all the rows
// gives. Two distributed modes make that so. kScaleOnly runs the scale
// kernel alone and leaves its exponent counts [3][256] in the caller's
// buffer; the ranks sum the counts (an all_reduce), so every rank picks
// the scale one launch over all the rows would pick, with qbits of that
// launch's plan. kAccOut (kTotalsAcc for the node totals) then takes those
// exponents as an input instead of deriving them, and leaves the int64
// accumulator unconverted; the ranks sum the accumulators (a second
// all_reduce), which integer addition makes order-free, and the wrapper
// scales the sums back once, as this kernel's last block does.

// Modes of the fixed kernel: count rows into the slab; the same with the
// slab's atomic adds and flushes compiled out (it stages, quantises and lists
// the same rows and reads their bins); only load and store the tiles; count
// rows into node totals, reading no bins. The second and third are
// measurement instances. kAccOut and kTotalsAcc are kCount and kTotals with
// the scale read from `exps_in` and the accumulator left as the output;
// kScaleOnly is no instance of this kernel, only its scale kernel.
enum { kCount, kUpdatesOut, kStagingOnly, kTotals, kAccOut, kTotalsAcc,
       kScaleOnly };
constexpr int kFixedThreads = 512;
constexpr int kFixedWarps = kFixedThreads / 32;
constexpr int kFixedRows = 256;                 // rows of a tile
constexpr int kFixedRowBits = 8;
constexpr int kFixedQuads = kFixedRows / 4;
constexpr int kFixedStagers = kFixedRows / 32;  // warps that stage the rows
constexpr int kFixedAdders = kFixedWarps - kFixedStagers;   // and add them
constexpr int kFixedStages = 2;                 // tiles staged ahead
// named barriers (0 is __syncthreads): the staging warps among themselves,
// the adding warps among themselves, and per stage "full" (staged, may be
// added) and "empty" (added, may be staged again)
constexpr int kBarStagers = 1, kBarAdders = 2, kBarFull = 3,
              kBarEmpty = kBarFull + kFixedStages;
constexpr int kFixedUnroll = 4;                 // rows a lane adds at once
constexpr int kFixedMaxFeatures = 32;           // most features of a group
constexpr int kFixedWords = kFixedMaxFeatures * kFixedQuads / kFixedRows;
constexpr int kFixedMaxQbits = 22;
constexpr int kScaleThreads = 256;
constexpr int kExpBuckets = 256;      // float exponents, biased: 255 non-finite
constexpr unsigned kOutlierCap = 64;  // most outliers of a stat in a launch
constexpr int kOutlierBits = 62 - 6;  // qbits + T - B at most, 2^6 = the cap
// the scale kernel's shared memory: a copy of the [3][256] counts per lane
constexpr int kScaleSmem = 3 * kExpBuckets * 32 * 4;
static_assert(kFixedRows == 1 << kFixedRowBits, "a list entry packs the row");
static_assert(kFixedStagers >= 1 && kFixedStagers <= kFixedWarps, "stagers");
static_assert(kFixedRows <= kFixedThreads, "a thread stages one row");
static_assert(kFixedWords * kFixedRows == kFixedMaxFeatures * kFixedQuads,
              "the staging threads stage every bin word of a tile");

// the feature stride of the slab: Fb rounded up to a power of two
__host__ __device__ constexpr int fixed_stride(int Fb) {
  return Fb <= 1 ? 1 : Fb <= 2 ? 2 : Fb <= 4 ? 4 : Fb <= 8 ? 8
         : Fb <= 16 ? 16 : 32;
}

// Shared memory of the fixed kernel in bytes: the slab [3][Nb][Bt][P] int32
// (padded to 16 bytes), then for each of kFixedStages staged tiles the list
// of its rows [kFixedRows] int4 (q_g, q_h, q_w, slab offset of the row's
// node << 8 | row) and its bins [Fb][kFixedRows * sizeof(BinT) / 4 + 1]
// words (the odd stride puts consecutive features on consecutive banks).
// hist.py's _fixed_smem_bytes mirrors it.
template <typename BinT>
long long fixed_smem_bytes(int Fb, int Nb, int Bt) {
  const long long stride = kFixedRows * static_cast<long long>(sizeof(BinT))
                           / 4 + 1;
  const long long slab = 3LL * Nb * Bt * fixed_stride(Fb);
  return 4 * ((slab + 3) / 4 * 4)
         + kFixedStages * (16LL * kFixedRows + 4LL * Fb * stride);
}

// max|x| as the bits of a non-negative float: unsigned order is float order,
// and a NaN lies above the infinity
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// Counts of the active values of g, h and w by float exponent, added into
// counts[s * 256 + bucket] (zeroed by the launch), the same array for every
// block and class: each block counts its rows in shared memory, one copy of
// the [3][256] buckets per lane (bucket-major, lane-minor, so that a warp's
// 32 adds fall on 32 banks), then adds the non-empty totals. Every block
// also zeroes its share of `zero` (the accumulator and the done counters).
template <bool kVec>
__global__ void __launch_bounds__(kScaleThreads)
fixed_scale_kernel(const int32_t* __restrict__ node,
                   const float* __restrict__ g, const float* __restrict__ h,
                   const float* __restrict__ w, long long R, int N,
                   long long w_stride,
                   unsigned long long* __restrict__ counts,
                   unsigned long long* __restrict__ zero,
                   long long zero_words) {
  extern __shared__ unsigned hist_s[];   // [3][kExpBuckets][32]
  const long long k = blockIdx.y;
  node += k * R;
  g += k * R;
  h += k * R;
  w += k * w_stride;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < 3 * kExpBuckets * 32; i += kScaleThreads)
    hist_s[i] = 0u;
  __syncthreads();
  unsigned* mine = hist_s + lane;
  const long long step = 4LL * gridDim.x * kScaleThreads;
  for (long long r = 4LL * (blockIdx.x * kScaleThreads + threadIdx.x); r < R;
       r += step) {
    const Quad q = load_quad<kVec>(node, g, h, w, r, R);
    const int n[4] = {q.n.x, q.n.y, q.n.z, q.n.w};
    const float gg[4] = {q.g.x, q.g.y, q.g.z, q.g.w};
    const float hh[4] = {q.h.x, q.h.y, q.h.z, q.h.w};
    const float ww[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (static_cast<unsigned>(n[j]) < static_cast<unsigned>(N)) {
        atomicAdd(mine + 32 * (abs_bits(gg[j]) >> 23), 1u);
        atomicAdd(mine + 32 * (kExpBuckets + (abs_bits(hh[j]) >> 23)), 1u);
        atomicAdd(mine + 32 * (2 * kExpBuckets + (abs_bits(ww[j]) >> 23)),
                  1u);
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * kExpBuckets; i += kScaleThreads) {
    unsigned long long c = 0;
    // lanes in rotation: the threads of a warp read 32 banks at once
    for (int l = 0; l < 32; ++l) c += hist_s[32 * i + ((l + i) & 31)];
    if (c) atomicAdd(counts + i, c);
  }
  const long long blocks = static_cast<long long>(gridDim.x) * gridDim.y;
  for (long long i = (k * gridDim.x + blockIdx.x) * kScaleThreads
                     + threadIdx.x;
       i < zero_words; i += blocks * kScaleThreads)
    zero[i] = 0ull;
}

// A tile being staged, in a staging thread's registers: one row and bin
// words of the group (word t + j * kFixedRows of the tile's [Fb][kFixedQuads]
// words, feature-major).
template <typename BinT>
struct FixedStaged {
  int n;
  float g, h, w;
  typename Word<BinT>::T b[kFixedWords];
};

template <typename BinT, bool kBins>
__device__ __forceinline__ void fixed_load(
    FixedStaged<BinT>& st, const BinT* __restrict__ binned_T,
    const typename Word<BinT>::T* __restrict__ wbase, long long bin_skew,
    const int32_t* __restrict__ node, const float* __restrict__ g,
    const float* __restrict__ h, const float* __restrict__ w, long long R,
    long long r0, int f0, int fb) {
  const int t = threadIdx.x;   // a staging thread, below kFixedRows
  {
    const long long r = r0 + t;
    const bool in = r < R;
    st.n = in ? __ldg(node + r) : -1;
    st.g = in ? __ldg(g + r) : 0.0f;
    st.h = in ? __ldg(h + r) : 0.0f;
    st.w = in ? __ldg(w + r) : 0.0f;
  }
  const bool whole = r0 + kFixedRows <= R;
#pragma unroll
  for (int j = 0; j < kFixedWords; ++j) {
    const int i = t + j * kFixedRows;
    const int f = i / kFixedQuads;
    const long long r = r0 + 4 * (i % kFixedQuads);
    if (kBins && f < fb) {
      const long long row0 = static_cast<long long>(f0 + f) * R;
      if (whole) {
        // as load_bins4, reading the second word only where the feature
        // row starts off a word (s is the same for a warp's one feature)
        const long long e = bin_skew + row0 + r;
        const int s = static_cast<int>(e & 3);
        const typename Word<BinT>::T lo = __ldg(wbase + (e >> 2));
        st.b[j] = s ? join(lo, __ldg(wbase + (e >> 2) + 1), s) : lo;
      } else {
        st.b[j] = load_bins<BinT>(binned_T, wbase, bin_skew, row0, r, R);
      }
    }
  }
}

// named barrier `id` over `count` threads: wait, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// *p += v in global memory, fire and forget (RED.E.ADD.64): atomicAdd on
// 64-bit words compiles to an ATOMG that waits for the old value
__device__ __forceinline__ void red_add(unsigned long long* p, long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// 2^k as a float, for k in [-126, 127]
__device__ __forceinline__ float pow2f(int k) {
  return __int_as_float((127 + k) << 23);
}

// v * 2^e, with 2^e = s1 * s2 split so that each factor is a normal float
// (e lies in [-113, 147]): both products are exact unless the first falls
// below 2^-126 (then the result is below 2^-40 and rounds to 0 either way)
// or the second passes the float range (then v is an outlier)
__device__ __forceinline__ float scaled(float v, float s1, float s2) {
  return (v * s1) * s2;
}

// One listed row's three values into the lane's feature column `my` (slab
// + f) at bin b of the row's node; a negative bin adds nothing.
__device__ __forceinline__ void fixed_add(int* my, int4 e, int b, int Bt,
                                          int P, int stat_len) {
  if (b < 0) return;
  int* s = my + (e.w >> kFixedRowBits) + min(b, Bt - 1) * P;
  atomicAdd(s, e.x);
  atomicAdd(s + stat_len, e.y);
  atomicAdd(s + 2 * stat_len, e.z);
}

// One outlier row's (g, h, w), each rounded at its stat's scale 2^exps[s]
// to a 64-bit integer, added straight into the int64 accumulator entry `e`
// of one feature, one 64-bit reduction a stat; a bad stat adds nothing.
__device__ __forceinline__ void fixed_outlier_add(unsigned long long* e,
                                                  int4 raw, const int* exps,
                                                  const int* bad) {
  const int v[3] = {raw.x, raw.y, raw.z};
#pragma unroll
  for (int s = 0; s < 3; ++s)
    if (!bad[s])
      red_add(e + s, __double2ll_rn(ldexp(
          static_cast<double>(__int_as_float(v[s])), exps[s])));
}

template <typename BinT, int kMode>
__global__ void __launch_bounds__(kFixedThreads, 1)
fixed_hist_kernel(const BinT* __restrict__ binned_T, long long bin_skew,
                  const int32_t* __restrict__ node,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const float* __restrict__ w, float* __restrict__ out,
                  unsigned long long* __restrict__ acc,
                  unsigned* __restrict__ done,
                  const unsigned long long* __restrict__ exp_counts,
                  const int* __restrict__ exps_in,
                  long long R, int F, int N, int Bt, int Fb, int Nb,
                  int row_splits, int flush_tiles, int qbits, float qlimit,
                  long long w_stride) {
  using W = typename Word<BinT>::T;
  constexpr bool kBins = kMode != kTotals && kMode != kTotalsAcc;
  constexpr bool kAdds = kMode == kCount || kMode == kTotals
                         || kMode == kAccOut || kMode == kTotalsAcc;
  // the scale comes in (exps_in: the exponents of g, h, w, then whether
  // each is bad), and the accumulator is the output
  constexpr bool kExpsIn = kMode == kAccOut || kMode == kTotalsAcc;
  extern __shared__ int4 smem_fixed[];
  const int groups = (F + Fb - 1) / Fb;
  const int node_blocks = (N + Nb - 1) / Nb;
  const long long entries = static_cast<long long>(F) * N * Bt * 3;
  {   // class k = blockIdx.y: its own node/g/h rows, w (shared when
      // w_stride is 0) and output; the bins are the same for every class
    const long long k = blockIdx.y;
    node += k * R;
    g += k * R;
    h += k * R;
    w += k * w_stride;
    out += k * entries;
    acc += k * entries;
    done += k * groups * node_blocks;
  }
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  // block -> (feature group, node block, row split), feature group fastest
  int bid = blockIdx.x;
  const int combo = bid % (groups * node_blocks);
  const int f0 = (bid % groups) * Fb;
  bid /= groups;
  const int fb = min(Fb, F - f0);
  const int n0 = (bid % node_blocks) * Nb;
  const int nn = min(Nb, N - n0);
  const int split = bid / node_blocks;

  const int P = fixed_stride(Fb);
  const int node_len = Bt * P;               // slab words of one node, stat
  const int stat_len = Nb * node_len;
  const int stride = kFixedRows * static_cast<int>(sizeof(BinT)) / 4 + 1;
  // the slab, then kFixedStages stages of a tile: its row list and bins
  int* slab = reinterpret_cast<int*>(smem_fixed);
  int4* lists = reinterpret_cast<int4*>(slab + (3 * stat_len + 3) / 4 * 4);
  unsigned* bins_all = reinterpret_cast<unsigned*>(lists + kFixedStages
                                                   * kFixedRows);
  __shared__ int exps[3];       // the scale of each stat: q = x * 2^exps[s]
  __shared__ int bad[3];        // the stat holds a non-finite value
  // 2^exps[s] as two normal floats a stat (0 for a bad stat, which adds
  // nothing): g1, g2, h1, h2, then w1, w2
  __shared__ float4 factors_gh;
  __shared__ float2 factors_w;
  // rows each staging warp lists, by stage: into the slab, and outlier
  // rows (listed from the list's end) added apart
  __shared__ int counts[kFixedStages][kFixedStagers];
  __shared__ int ocounts[kFixedStages];
  __shared__ int last;

  // the scale of each stat from the scale kernel's counts (all classes):
  // warp s < 3 finds stat s's top bucket T and bulk bucket B, each lane
  // holding eight buckets, with a suffix sum of the counts over the lanes
  {
    for (int i = tid; i < 3 * stat_len; i += kFixedThreads) slab[i] = 0;
    if (kExpsIn && tid < 3) {
      const int e = exps_in[tid];
      const bool nonfinite = exps_in[3 + tid] != 0;
      const float f1 = nonfinite ? 0.0f : pow2f(e / 2);
      const float f2 = nonfinite ? 0.0f : pow2f(e - e / 2);
      bad[tid] = nonfinite;
      exps[tid] = e;
      if (tid == 0) factors_gh.x = f1, factors_gh.y = f2;
      if (tid == 1) factors_gh.z = f1, factors_gh.w = f2;
      if (tid == 2) factors_w = make_float2(f1, f2);
    }
    if (!kExpsIn && warp < 3) {
      const unsigned full = 0xffffffffu;
      unsigned long long c[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[j] = exp_counts[warp * kExpBuckets + 8 * lane + j];
      const bool nonfinite = __shfl_sync(full, c[7], 31) != 0;  // bucket 255
      if (lane == 31) c[7] = 0;
      int top = -1;
      unsigned long long mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mine += c[j];
        if (c[j]) top = 8 * lane + j;
      }
      top = __reduce_max_sync(full, top);
      unsigned long long incl = mine;   // this lane's buckets and all above
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const unsigned long long v = __shfl_down_sync(full, incl, d);
        if (lane + d < 32) incl += v;
      }
      unsigned long long above = incl - mine;
      int brk = -1;   // the bucket whose values pass the cap with those above
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (above <= kOutlierCap && above + c[j] > kOutlierCap)
          brk = 8 * lane + j;
        above += c[j];
      }
      brk = __reduce_max_sync(full, brk);
      const int bulk = brk < 0 ? top : max(brk, top - (kOutlierBits - qbits));
      if (lane == 0) {
        const int e = qbits - (top < 0 ? 0 : max(bulk, 1) - 126);
        const float f1 = nonfinite ? 0.0f : pow2f(e / 2);
        const float f2 = nonfinite ? 0.0f : pow2f(e - e / 2);
        bad[warp] = nonfinite;
        exps[warp] = e;
        if (warp == 0) factors_gh.x = f1, factors_gh.y = f2;
        if (warp == 1) factors_gh.z = f1, factors_gh.w = f2;
        if (warp == 2) factors_w = make_float2(f1, f2);
      }
    }
    __syncthreads();
  }
  // the staging warps load the factors from shared memory for every tile
  // (asm volatile: never held in registers across the loop, which the
  // tiles in flight fill to the kernel's 128)
  const unsigned factors_at = static_cast<unsigned>(
      __cvta_generic_to_shared(&factors_gh));
  const unsigned factors_w_at = static_cast<unsigned>(
      __cvta_generic_to_shared(&factors_w));

  const W* wbase = reinterpret_cast<const W*>(binned_T - bin_skew);
  const long long tiles = (R + kFixedRows - 1) / kFixedRows;
  // the tiles this block walks: split, split + row_splits, ...
  const int iters = split < tiles ? static_cast<int>(
      (tiles - 1 - split) / row_splits + 1) : 0;

  if (warp < kFixedStagers) {
    // staging warps: two tiles' loads in flight in registers; each tile is
    // quantised, listed and stored into its stage once the adding warps
    // have released that stage
    FixedStaged<BinT> st[2];
    auto tile_r0 = [&](int k) {
      return (split + static_cast<long long>(k) * row_splits) * kFixedRows;
    };
    auto stage = [&](FixedStaged<BinT>& x, int k) {
      const int sg = k % kFixedStages;
      const unsigned nl = static_cast<unsigned>(x.n - n0);
      const bool at = kMode != kStagingOnly
                      && nl < static_cast<unsigned>(nn);
      // quantised before the stage is free, overlapping the wait for it.
      // A row with an outlier, a stat at or above its bulk bound (a scaled
      // value of at least 2^qbits, `qlimit`: |x| >= 2^E_s), is listed
      // apart, whole, and the adding warps add it straight into the
      // accumulator; a bad stat scales to 0 or NaN and adds nothing
      float4 fgh;
      float2 fw;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(fgh.x), "=f"(fgh.y), "=f"(fgh.z), "=f"(fgh.w)
                   : "r"(factors_at));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                   : "=f"(fw.x), "=f"(fw.y) : "r"(factors_w_at));
      const float pg = scaled(x.g, fgh.x, fgh.y),
                  ph = scaled(x.h, fgh.z, fgh.w), pw = scaled(x.w, fw.x, fw.y);
      const bool out = at && (fabsf(pg) >= qlimit || fabsf(ph) >= qlimit
                              || fabsf(pw) >= qlimit);
      const int a = at && !out ? __float2int_rn(pg) : 0;
      const int b = at && !out ? __float2int_rn(ph) : 0;
      const int c = at && !out ? __float2int_rn(pw) : 0;
      const bool keep = (a | b | c) != 0;
      const unsigned mk = __ballot_sync(0xffffffffu, keep);
      if (k >= kFixedStages) bar_sync(kBarEmpty + sg, kFixedThreads);
      if (lane == 0) counts[sg][warp] = __popc(mk);
      // outlier rows are rare: counted with a shared atomic once every
      // staging warp has passed the barrier below
      if (tid == 0) ocounts[sg] = 0;
      unsigned* bins_w = bins_all + sg * Fb * stride;
      const int words = fb * kFixedQuads;
#pragma unroll
      for (int j = 0; j < kFixedWords; ++j) {
        const int i = tid + j * kFixedStagers * 32;
        if (kBins && i < words) {
          unsigned* dst = bins_w + (i / kFixedQuads) * stride
                          + (i % kFixedQuads) * static_cast<int>(sizeof(BinT));
          dst[0] = static_cast<unsigned>(x.b[j]);
          if (sizeof(BinT) == 2)
            dst[1] = static_cast<unsigned>(
                static_cast<unsigned long long>(x.b[j]) >> 32);
        }
      }
      bar_sync(kBarStagers, kFixedStagers * 32);   // every count is in
      if (kMode == kStagingOnly)   // the row itself, never listed
        lists[sg * kFixedRows + tid] = make_int4(
            __float_as_int(x.g), __float_as_int(x.h), __float_as_int(x.w),
            x.n);
      if (keep) {
        int base = __popc(mk & ((1u << lane) - 1));
        for (int i = 0; i < warp; ++i) base += counts[sg][i];
        lists[sg * kFixedRows + base] = make_int4(
            a, b, c, (at ? static_cast<int>(nl) * node_len : 0)
                         << kFixedRowBits | tid);
      }
      if (out) {   // the row's raw stats and its node, from the list's end
        const int base = atomicAdd(&ocounts[sg], 1);
        lists[sg * kFixedRows + kFixedRows - 1 - base] = make_int4(
            __float_as_int(x.g), __float_as_int(x.h), __float_as_int(x.w),
            static_cast<int>(nl) << kFixedRowBits | tid);
      }
      bar_arrive(kBarFull + sg, kFixedThreads);
    };
    if (iters > 0)
      fixed_load<BinT, kBins>(st[0], binned_T, wbase, bin_skew, node, g, h, w, R,
                       tile_r0(0), f0, fb);
    if (iters > 1)
      fixed_load<BinT, kBins>(st[1], binned_T, wbase, bin_skew, node, g, h, w, R,
                       tile_r0(1), f0, fb);
    for (int k = 0; k < iters; k += 2) {
      stage(st[0], k);
      if (k + 2 < iters)
        fixed_load<BinT, kBins>(st[0], binned_T, wbase, bin_skew, node, g, h, w, R,
                         tile_r0(k + 2), f0, fb);
      if (k + 1 < iters) {
        stage(st[1], k + 1);
        if (k + 3 < iters)
          fixed_load<BinT, kBins>(st[1], binned_T, wbase, bin_skew, node, g, h, w,
                           R, tile_r0(k + 3), f0, fb);
      }
    }
  } else {
    // adding warps: lane -> (feature f, row sub of the warp's
    // rows_per_step); lanes past the group's features stay idle
    const int aw = warp - kFixedStagers;
    const int f = lane & (P - 1);
    const int rows_per_step = 32 / P;
    const int sub = lane / P;
    const int at = tid - kFixedStagers * 32;
    const int wstep = kFixedAdders * rows_per_step;
    int* my = slab + f;
    int sink = 0;   // what the updates-out instance reads instead of adding
    // flush: the slab's nonzero entries into the accumulator, then zeroed;
    // slab word (s, nl, b, f) -> acc[f0 + f, (n0 + nl) * Bt + b, s]. Each
    // block starts at its own offset, a multiple of 32, so that the blocks'
    // reductions of one flush fall on different entries.
    const int len = 3 * stat_len;
    const int off = blockIdx.x % max(1, len / 32) * 32;
    for (int k = 0; k < iters; ++k) {
      const int sg = k % kFixedStages;
      bar_sync(kBarFull + sg, kFixedThreads);
      if (f < fb) {
        int listed = 0;
#pragma unroll
        for (int i = 0; i < kFixedStagers; ++i) listed += counts[sg][i];
        const int4* list = lists + sg * kFixedRows;
        const BinT* fbins = reinterpret_cast<const BinT*>(
            bins_all + (sg * Fb + f) * stride);
        // kFixedUnroll rows of the warp at a time, their loads issued first
        int r = aw * rows_per_step + sub;
        for (; r + (kFixedUnroll - 1) * wstep < listed;
             r += kFixedUnroll * wstep) {
          int4 e[kFixedUnroll];
          int b[kFixedUnroll];
#pragma unroll
          for (int u = 0; u < kFixedUnroll; ++u) e[u] = list[r + u * wstep];
#pragma unroll
          for (int u = 0; u < kFixedUnroll; ++u)
            b[u] = kBins ? static_cast<int>(fbins[e[u].w & (kFixedRows - 1)])
                         : 0;
#pragma unroll
          for (int u = 0; u < kFixedUnroll; ++u) {
            if (kAdds) fixed_add(my, e[u], b[u], Bt, P, stat_len);
            else sink += (e[u].x ^ e[u].y ^ e[u].z ^ e[u].w) + b[u];
          }
        }
        for (; r < listed; r += wstep) {
          const int4 e = list[r];
          const int b = kBins ? static_cast<int>(fbins[e.w & (kFixedRows - 1)])
                              : 0;
          if (kAdds) fixed_add(my, e, b, Bt, P, stat_len);
          else sink += (e.x ^ e.y ^ e.z ^ e.w) + b;
        }
        // outlier rows (rare): each lane adds its feature's three values
        const int outs = ocounts[sg];
        if (kAdds && outs) {
          for (int o = aw * rows_per_step + sub; o < outs; o += wstep) {
            const int4 e = list[kFixedRows - 1 - o];
            const int t = e.w & (kFixedRows - 1);
            const int bo = kBins ? static_cast<int>(fbins[t]) : 0;
            if (bo < 0) continue;
            fixed_outlier_add(
                acc + ((static_cast<long long>(f0 + f) * N + n0
                        + (e.w >> kFixedRowBits)) * Bt + min(bo, Bt - 1)) * 3,
                e, exps, bad);
          }
        }
      }
      // the staging warps wait for this stage only from tile kFixedStages on
      if (k + kFixedStages < iters)
        bar_arrive(kBarEmpty + sg, kFixedThreads);
      if (kAdds && ((k + 1) % flush_tiles == 0 || k + 1 == iters)) {
        bar_sync(kBarAdders, kFixedAdders * 32);   // every add is in
        for (int j = at; j < len; j += kFixedAdders * 32) {
          const int i = j + off < len ? j + off : j + off - len;
          const int v = slab[i];
          if (v == 0) continue;
          slab[i] = 0;
          const int s = i / stat_len;
          const int rem = i - s * stat_len;
          const int fl = rem & (P - 1);
          const int nb = rem / P;                 // nl * Bt + b
          red_add(acc + ((static_cast<long long>(f0 + fl) * N + n0) * Bt
                         + nb) * 3 + s,
                  static_cast<long long>(v));
        }
        bar_sync(kBarAdders, kFixedAdders * 32);   // the slab is zeroed
      }
    }
    // keeps the updates-out instance's reads alive; nothing reads its output
    if (kMode == kUpdatesOut && sink == INT_MIN) out[0] = 1.0f;
  }
  // the distributed modes leave the accumulator as it is: the ranks sum it
  if (kExpsIn) return;

  // the last block of this (class, feature group, node block) converts its
  // part of the accumulator
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(done + combo, 1u)
           == static_cast<unsigned>(row_splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float nan = __int_as_float(0x7fffffff);
  const int per_feature = nn * Bt * 3;
#pragma unroll 4
  for (int i = tid; i < fb * per_feature; i += kFixedThreads) {
    const int fl = i / per_feature;
    const int rem = i - fl * per_feature;
    const long long a = (static_cast<long long>(f0 + fl) * N + n0) * Bt * 3
                        + rem;
    const int s = rem % 3;
    const long long v = static_cast<long long>(__ldcg(acc + a));
    out[a] = bad[s] ? nan
                    : static_cast<float>(ldexp(static_cast<double>(v),
                                               -exps[s]));
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
  {   // class k = blockIdx.y: its own node/g/h rows, w (shared when
      // w_stride is 0) and output; the bins are the same for every class
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
  int F, N, Bt, Fb, Nb, row_splits, smem_bytes;
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

// fixed_hist_kernel's launch in mode kMode: the scale kernel, then the
// histogram kernel, on one stream. `scratch` holds the int64 accumulator
// [K, F, N*Bt, 3], the done counters [K, groups x node blocks] (uint32,
// padded to 8 bytes) and the exponent counts [3][256] (uint64), zeroed here
// before the scale kernel adds into them; hist.py's _fixed_scratch_words
// mirrors it.
template <typename BinT, int kMode>
cudaError_t launch_fixed(const Args& a, void* scratch, int scale_blocks,
                         int flush_tiles, int qbits,
                         const int* exps_in = nullptr) {
  const long long combos = static_cast<long long>((a.F + a.Fb - 1) / a.Fb)
                           * ((a.N + a.Nb - 1) / a.Nb);
  const long long blocks = combos * a.row_splits;
  // no int32 slab entry can overflow: the rows a block adds between two
  // flushes times the largest |q|
  const bool bounded = qbits >= 0 && qbits <= kFixedMaxQbits
                       && flush_tiles >= 1
                       && (static_cast<long long>(flush_tiles) * kFixedRows
                           << qbits) <= INT_MAX;
  if (blocks < 1 || blocks > INT_MAX || !classes_ok(a) || a.Fb < 1
      || a.Fb > kFixedMaxFeatures || a.Fb > a.F || a.Nb < 1 || !bounded
      || scale_blocks < 1
      || a.K * static_cast<long long>(scale_blocks) > INT_MAX
      || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0
      || fixed_smem_bytes<BinT>(a.Fb, a.Nb, a.Bt) != a.smem_bytes)
    return cudaErrorInvalidConfiguration;
  const long long entries = static_cast<long long>(a.F) * a.N * a.Bt * 3;
  auto* acc = static_cast<unsigned long long*>(scratch);
  const long long done_words = (a.K * combos + 1) / 2;
  auto* done = reinterpret_cast<unsigned*>(acc + a.K * entries);
  auto* counts = acc + a.K * entries + done_words;
  constexpr bool kExpsIn = kMode == kAccOut || kMode == kTotalsAcc;
  cudaError_t e = kExpsIn
      // no scale kernel to zero the accumulator and the done counters
      ? cudaMemsetAsync(acc, 0, sizeof(unsigned long long)
                        * (a.K * entries + done_words), a.stream)
      : cudaMemsetAsync(counts, 0, sizeof(unsigned long long)
                        * 3 * kExpBuckets, a.stream);
  if (e != cudaSuccess) return e;
  const bool vec = vec_aligned(a);
  if (!kExpsIn) {
    const dim3 sgrid(static_cast<unsigned>(scale_blocks),
                     static_cast<unsigned>(a.K));
    auto scale = vec ? fixed_scale_kernel<true> : fixed_scale_kernel<false>;
    e = prepare(scale, kScaleSmem);
    if (e != cudaSuccess) return e;
    scale<<<sgrid, kScaleThreads, kScaleSmem, a.stream>>>(
        static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
        static_cast<const float*>(a.h), static_cast<const float*>(a.w), a.R,
        a.N, a.w_stride, counts, acc, a.K * entries + done_words);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  auto kernel = fixed_hist_kernel<BinT, kMode>;
  e = prepare(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(a.K));
  kernel<<<grid, kFixedThreads, a.smem_bytes, a.stream>>>(
      static_cast<const BinT*>(a.binned_T), skew_of<BinT>(a.binned_T),
      static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), static_cast<const float*>(a.w),
      static_cast<float*>(a.out), acc, done, counts, exps_in, a.R, a.F, a.N,
      a.Bt, a.Fb, a.Nb, a.row_splits, flush_tiles, qbits,
      ldexpf(1.0f, qbits), a.w_stride);
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

// kScaleOnly: the scale kernel alone, its exponent counts [3][256] of the
// active values of all classes added into `counts` (zeroed here); it
// zeroes nothing else.
cudaError_t launch_scale_only(const Args& a, unsigned long long* counts,
                              int scale_blocks) {
  if (!classes_ok(a) || scale_blocks < 1
      || a.K * static_cast<long long>(scale_blocks) > INT_MAX
      || (reinterpret_cast<uintptr_t>(counts) & 7) != 0)
    return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(unsigned long long)
                                  * 3 * kExpBuckets, a.stream);
  if (e != cudaSuccess) return e;
  auto scale = vec_aligned(a) ? fixed_scale_kernel<true>
                              : fixed_scale_kernel<false>;
  e = prepare(scale, kScaleSmem);
  if (e != cudaSuccess) return e;
  const dim3 sgrid(static_cast<unsigned>(scale_blocks),
                   static_cast<unsigned>(a.K));
  scale<<<sgrid, kScaleThreads, kScaleSmem, a.stream>>>(
      static_cast<const int32_t*>(a.node), static_cast<const float*>(a.g),
      static_cast<const float*>(a.h), static_cast<const float*>(a.w), a.R,
      a.N, a.w_stride, counts, counts, 0);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t dispatch_fixed(int mode, const Args& a, void* scratch,
                           int scale_blocks, int flush_tiles, int qbits,
                           void* aux) {
  if (mode == kCount)
    return launch_fixed<BinT, kCount>(a, scratch, scale_blocks, flush_tiles,
                                      qbits);
  if (mode == kUpdatesOut)
    return launch_fixed<BinT, kUpdatesOut>(a, scratch, scale_blocks,
                                           flush_tiles, qbits);
  if (mode == kStagingOnly)
    return launch_fixed<BinT, kStagingOnly>(a, scratch, scale_blocks,
                                            flush_tiles, qbits);
  if (mode == kAccOut)
    return launch_fixed<BinT, kAccOut>(a, scratch, scale_blocks, flush_tiles,
                                       qbits, static_cast<const int*>(aux));
  if (mode == kScaleOnly)
    return launch_scale_only(a, static_cast<unsigned long long*>(aux),
                             scale_blocks);
  // node totals read no bins: one instance, at the int8 width
  if constexpr (sizeof(BinT) == 1)
    if (mode == kTotals && a.F == 1 && a.Bt == 1)
      return launch_fixed<BinT, kTotals>(a, scratch, scale_blocks,
                                         flush_tiles, qbits);
  if constexpr (sizeof(BinT) == 1)
    if (mode == kTotalsAcc && a.F == 1 && a.Bt == 1)
      return launch_fixed<BinT, kTotalsAcc>(a, scratch, scale_blocks,
                                            flush_tiles, qbits,
                                            static_cast<const int*>(aux));
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

// Launches fixed_hist_kernel (after its scale kernel) on `stream` in `mode`
// (0 counts; 1 and 2 are its measurement instances, updates out and staging
// only; 3 counts node totals, F = 1 and Bt = 1 with bin_bytes 1 and
// binned_T unread); returns the cudaError_t of the launches. The
// distributed modes: 6 runs the scale kernel alone, its exponent counts
// [3][256] (uint64) into `aux`; 4 (and 5, the node totals') takes the
// exponents of g, h, w and their bad flags from `aux` (int32 [6]), runs no
// scale kernel, and leaves the int64 accumulator at the start of `scratch`
// as its output (`out` unwritten). The Python wrapper
// (h2o3_tpu_torch/ops/hist.py) has checked every argument and planned Fb,
// Nb, row_splits, smem_bytes, the scale kernel's blocks per class, the
// tiles a block walks between two flushes and the bits of the largest |q|.
// K classes: node, g and h are [K, R], w is [K, R] (w_stride = R) or one
// [R] row for all (w_stride = 0), out [K, F, N*Bt, 3]; `scratch` is the
// int64 accumulator, done counters and exponent counts.
extern "C" int h2o3_fixed_hist(int mode, const void* binned_T, int bin_bytes,
                               const void* node, const void* g,
                               const void* h, const void* w, void* out,
                               void* scratch, long long R, int F, int N,
                               int Bt, int Fb, int Nb, int row_splits,
                               int smem_bytes, int K, long long w_stride,
                               int scale_blocks, int flush_tiles, int qbits,
                               void* aux, void* stream) {
  const Args a{binned_T, node, g, h, w, out, R, F, N, Bt, Fb, Nb,
               row_splits, smem_bytes, K, w_stride,
               static_cast<cudaStream_t>(stream)};
  if (bin_bytes == 1)
    return dispatch_fixed<int8_t>(mode, a, scratch, scale_blocks,
                                  flush_tiles, qbits, aux);
  if (bin_bytes == 2)
    return dispatch_fixed<int16_t>(mode, a, scratch, scale_blocks,
                                   flush_tiles, qbits, aux);
  return cudaErrorInvalidValue;
}

// Launches global_hist_kernel on `stream`; returns the cudaError_t of the
// launch. Arguments as h2o3_fixed_hist's, with Fb the features of a pass,
// one block per row split and class, and out [K, F, N*Bt, 4] (16-byte
// aligned, zeroed by the caller), whose first three floats of an entry are
// the sums.
extern "C" int h2o3_global_hist(const void* binned_T, int bin_bytes,
                                const void* node, const void* g,
                                const void* h, const void* w, void* out,
                                long long R, int F, int N, int Bt, int Fb,
                                int row_splits, int smem_bytes, int K,
                                long long w_stride, void* stream) {
  const Args a{binned_T, node, g, h, w, out, R, F, N, Bt, Fb, N,
               row_splits, smem_bytes, K, w_stride,
               static_cast<cudaStream_t>(stream)};
  if (bin_bytes == 1) return launch_global<int8_t>(a);
  if (bin_bytes == 2) return launch_global<int16_t>(a);
  return cudaErrorInvalidValue;
}

// Blocks of kernel `kind` (0 fixed, 1 global) one SM holds with `threads`
// threads and `smem_bytes` of dynamic shared memory, into *blocks; returns
// the cudaError_t of the query.
extern "C" int h2o3_level_hist_blocks_per_sm(int kind, int bin_bytes,
                                             int threads, int smem_bytes,
                                             int* blocks) {
  if (kind == 0 && bin_bytes == 1)
    return occupancy(fixed_hist_kernel<int8_t, kCount>, threads, smem_bytes,
                     blocks);
  if (kind == 0 && bin_bytes == 2)
    return occupancy(fixed_hist_kernel<int16_t, kCount>, threads, smem_bytes,
                     blocks);
  if (kind == 1 && bin_bytes == 1)
    return occupancy(global_hist_kernel<int8_t, true>, threads, smem_bytes,
                     blocks);
  if (kind == 1 && bin_bytes == 2)
    return occupancy(global_hist_kernel<int16_t, true>, threads, smem_bytes,
                     blocks);
  return cudaErrorInvalidValue;
}

extern "C" const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
