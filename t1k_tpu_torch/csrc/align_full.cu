// v1 full-row banded global alignment score.
//
// Replaces the Pallas kernel t1k_tpu/ops/align_pallas.py::_align_kernel
// (through banded_scores_pallas) and the XLA program
// t1k_tpu/ops/align.py::_banded_scores_impl.  Same contract: banded
// affine-gap global alignment (match +2, mismatch -2, gap open -4, gap
// extend -1, band 5 widened by |t_len - p_len|, code 4 = N matches
// anything), row 0 and column 0 boundary quirks of the reference, one
// int32 score per pair.
//
// The TPU kernel keeps [block_b, Lt+1] rows padded to 128 lanes in VMEM
// and resolves the deletion chain with a Kogge-Stone lane scan over the
// whole row.  Only the band columns [max(i-left,1), min(i+right,t_len)]
// and column 0 of a row ever hold anything but NEG_INF, so the kernels
// here compute the band alone, in window coordinates: slot s = w + 1 with
// w = j - i + left, so a cell's diagonal predecessor is the same slot of
// the previous row, its vertical one the slot to the right.  A pair needs
// 13 + |t_len - p_len| slots (pair_slots): the band, the column-0 cell
// one slot left of it and the row-0 cell one slot right of it.  Every
// in-band cell gets exactly the value of the full-row program, so the
// score is bit-exact.
//
// Three paths, one launch each, chosen per pair by its slot count.  A
// counting sort on the card (three small kernels) orders the pairs by
// path class, then by read length, longest first, so a warp's pairs run
// about as many rows; every score goes back to the pair's own index.
// The register paths' grids hold every pair of the launch, their warps
// past their class's pairs exiting at once; the sort's counts come back
// to the host, which launches the ring path, where it has pairs, with a
// ring sized from them.  No plan of the caller's can leave a pair out.
//
//   * thread path (at most 32 slots, |diff| <= 19): one thread per pair,
//     m and e in NS registers each (NS = 16, 20, 24, 28 or 32, the
//     smallest that holds every pair of the warp).  A row is one
//     left-to-right pass over the slots with compile-time indices: the
//     deletion chain is a running max.  The text under the slots sits as
//     bytes in NS/4 words that slide one byte per row, one new byte
//     loaded per row four rows ahead; no shared memory, so the SM fills
//     by registers.
//   * tile path (33-512 slots): one warp per pair, lane l holding the CPL
//     consecutive slots l*CPL .. l*CPL + CPL-1 (CPL = 2, 3, 4, 5, 6, 8,
//     10, 12, 14 or 16, the smallest that holds the pair) in registers.
//     The vertical move is one __shfl_down_sync; the deletion chain a
//     serial max over the lane's slots, one 5-step warp prefix max of the
//     lane totals per row, then a fix-up pass.  The text slides across
//     lanes with one shuffle a row.
//   * ring path (more than 512 slots, |diff| >= 500): one warp per pair
//     over band chunks of 32 columns, two rows of m and e in a
//     shared-memory ring sized from these pairs alone (the first port's
//     kernel, kept: the 8,180 limit holds).
//
// The tile kernel runs on the caller's stream and the thread and ring
// kernels beside it on two more.
//
// What bounds it on an H100: integer instruction throughput.  A pair
// reads t_len + p_len bytes and writes 4.  Counted in the instructions
// this card needs, a band cell is 6 int32 operations: E an add and a
// __viaddmax_s32 (Hopper's DPX add-max, one instruction), H a DPX
// add-max of the diagonal and the substitution, the substitution one, F
// a DPX add-max of the running max, and the running max one.  That is
// 0.117 ms for the 65,536 seeded pairs of chip_smoke.py's v1 phase at
// 132 SMs x 64 int32 lanes x 1.98 GHz.  The register paths hold m + j
// and e + j (see below), so a slot's row is those three add-maxes, the
// max, the add, the substitution byte and the band mask: about 8
// instructions where the first port's shared-memory kernel spent about
// 30 and 5 dependent shuffles per 32-column chunk.  Beyond the band's
// cells the thread path runs the padding up to NS slots and the tile
// path up to 32 x CPL, and the tile path adds about 25 warp instructions
// a row for the shuffles, the scan and the text.

#include <cstdint>
#include <climits>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kMatch = 2;
constexpr int kMismatch = -2;
constexpr int kGO = -4;
constexpr int kGE = -1;
constexpr int kNegInf = -(1 << 24);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdentity = INT_MIN / 2;  // below every reachable value

// Path classes: the thread path's slot counts NS, the tile path's slots
// per lane CPL (a pair takes the smallest that holds its slots), then
// the ring path.
constexpr int kThreadClasses = 5;
constexpr int kTileClasses = 10;
__host__ __device__ constexpr int thread_ns(int c) { return 16 + 4 * c; }
__host__ __device__ constexpr int tile_cpl(int c) {
  return c < 4 ? c + 2 : 2 * c - 2;  // 2, 3, 4, 5, 6, 8, 10, ..., 16
}
static_assert(thread_ns(kThreadClasses - 1) == 32 &&
                  tile_cpl(kTileClasses - 1) == 16,
              "32 thread slots, 512 tile slots");
constexpr int kClasses = kThreadClasses + kTileClasses + 1;
constexpr int kRingClass = kClasses - 1;
// Sort bins: the classes, each by read length, longest first (reads of
// 255 bases or more share the first length).  The scratch holds the bins
// (cursors after the scan), the classes' starts and the end, the most
// slots of a ring-class pair, then the permutation.
constexpr int kLens = 256;
constexpr int kBins = kClasses * kLens;
constexpr int kRingSlots = kBins + kClasses + 1;  // scratch index
constexpr int kPerm = kRingSlots + 1;
constexpr int kScanThreads = 1024;
constexpr int kScanPer = kBins / kScanThreads;  // bins a scan thread holds
constexpr int kSortBlock = 256;
constexpr int kScatterItems = 4;
constexpr int kThreadBlock = 128;
constexpr int kTileWarps = 4;  // warps per tile-kernel block
constexpr int kAhead = 4;      // rows of bases loaded ahead

__device__ __forceinline__ bool degenerate(int tl, int pl) {
  return tl == 0 || pl == 0;
}

// Slots a pair needs (an empty pair runs no rows: the smallest class).
__device__ __forceinline__ int pair_slots(int tl, int pl) {
  return degenerate(tl, pl) ? 13 : 13 + abs(tl - pl);
}

__device__ __forceinline__ int slot_class(int slots) {
#pragma unroll
  for (int c = 0; c < kThreadClasses; ++c)
    if (slots <= thread_ns(c)) return c;
#pragma unroll
  for (int c = 0; c < kTileClasses; ++c)
    if (slots <= 32 * tile_cpl(c)) return kThreadClasses + c;
  return kRingClass;
}

__device__ __forceinline__ int pair_bin(const int32_t* __restrict__ t_lens,
                                        const int32_t* __restrict__ p_lens,
                                        int64_t k) {
  const int tl = t_lens[k], pl = p_lens[k];
  const int rows = degenerate(tl, pl) ? 0 : pl;
  return slot_class(pair_slots(tl, pl)) * kLens + kLens - 1 -
         min(rows, kLens - 1);
}

// Substitution score + 1 of code bytes under four slots: 3 where the
// byte matches the read base (or either is N), -1 (0xff) elsewhere.
__device__ __forceinline__ unsigned sub_word(unsigned codes, unsigned pbx,
                                             bool pb_n) {
  unsigned mk = __vcmpeq4(codes, pbx) | __vcmpeq4(codes, 0x04040404u);
  if (pb_n) mk = kFull;
  return ~mk | 0x03030303u;
}

__device__ __forceinline__ int sub_at(unsigned word, int byte) {
  return (int)(int8_t)(word >> (8 * byte));
}

__device__ __forceinline__ int single_base(const int8_t* tr,
                                           const int8_t* pr) {
  const int t0 = tr[0], p0 = pr[0];
  return (t0 == p0 || t0 == 4 || p0 == 4) ? kMatch : kMismatch;
}

// ------------------------------------------------------------ sorting

__global__ void __launch_bounds__(kSortBlock)
sort_count_kernel(const int32_t* __restrict__ t_lens,
                  const int32_t* __restrict__ p_lens, int64_t n,
                  int* __restrict__ bins) {
  __shared__ int h[kBins];
  __shared__ int ring_slots;
  for (int b = threadIdx.x; b < kBins; b += kSortBlock) h[b] = 0;
  if (threadIdx.x == 0) ring_slots = 0;
  __syncthreads();
  int most = 0;
  for (int64_t k = (int64_t)blockIdx.x * kSortBlock + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * kSortBlock) {
    const int bin = pair_bin(t_lens, p_lens, k);
    atomicAdd(&h[bin], 1);
    if (bin >= kRingClass * kLens)
      most = max(most, pair_slots(t_lens[k], p_lens[k]));
  }
  if (most) atomicMax(&ring_slots, most);
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kSortBlock)
    if (h[b]) atomicAdd(&bins[b], h[b]);
  if (threadIdx.x == 0 && ring_slots) atomicMax(&bins[kRingSlots], ring_slots);
}

// Exclusive scan of the bin counts in place (the bins become cursors),
// kScanPer bins a thread; bins[kBins + c] = the first position of class
// c, bins[kBins + kClasses] = n.
__global__ void __launch_bounds__(kScanThreads) sort_scan_kernel(int* bins) {
  static_assert(kBins == kScanPer * kScanThreads && kLens % kScanPer == 0,
                "whole bins a thread, a class starting on a thread");
  __shared__ int acc[kScanThreads];
  const int t = threadIdx.x;
  int c[kScanPer], sum = 0;
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) {
    c[r] = bins[kScanPer * t + r];
    sum += c[r];
  }
  acc[t] = sum;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int v = t >= d ? acc[t - d] : 0;
    __syncthreads();
    acc[t] += v;
    __syncthreads();
  }
  int before = acc[t] - sum;
  if ((kScanPer * t) % kLens == 0) bins[kBins + kScanPer * t / kLens] = before;
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) {
    bins[kScanPer * t + r] = before;
    before += c[r];
  }
  if (t == kScanThreads - 1) bins[kBins + kClasses] = acc[t];
}

// Each block ranks its pairs per bin in shared memory, then claims one
// range per bin from the global cursors.  The order within a bin is
// arbitrary; scores land at the pairs' own indices all the same.
__global__ void __launch_bounds__(kSortBlock)
sort_scatter_kernel(const int32_t* __restrict__ t_lens,
                    const int32_t* __restrict__ p_lens, int64_t n,
                    int* __restrict__ cursor, int* __restrict__ perm) {
  __shared__ int h[kBins];
  __shared__ int start[kBins];
  for (int b = threadIdx.x; b < kBins; b += kSortBlock) h[b] = 0;
  __syncthreads();
  const int64_t k0 =
      (int64_t)blockIdx.x * kSortBlock * kScatterItems + threadIdx.x;
  int bin[kScatterItems], rank[kScatterItems];
#pragma unroll
  for (int r = 0; r < kScatterItems; ++r) {
    const int64_t k = k0 + (int64_t)r * kSortBlock;
    bin[r] = -1;
    rank[r] = 0;
    if (k < n) {
      bin[r] = pair_bin(t_lens, p_lens, k);
      rank[r] = atomicAdd(&h[bin[r]], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kSortBlock)
    start[b] = h[b] ? atomicAdd(&cursor[b], h[b]) : 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kScatterItems; ++r)
    if (bin[r] >= 0)
      perm[start[bin[r]] + rank[r]] = (int)(k0 + (int64_t)r * kSortBlock);
}

// ---------------------------------------------------- one thread per pair

// Values a slot holds: m + j and e + j of its cell (j its column), so
// along a row U = H' - GE*j is the cell's own h and F = run - 4 with run
// the max of U over the slots left of it; a row is then three add-max
// steps (__viaddmax_s32, one DPX instruction on Hopper) and a max per
// slot.  Only the slots right of the band are reset to NEG_INF each row
// (the next row's last band cell reads one of them), and row 0 holds its
// values only up to the slot right of the band; every other cell off the
// band only ever loses a max to an in-band one (an in-band cell has an
// in-band diagonal predecessor), so its value never reaches the score:
// slot 0 left of the band is kept off the deletion chain, cells past
// t_len feed only cells past t_len, and the cells left of column 0 in
// the first rows stay within a few thousand of NEG_INF.

// Row-0 values of slot s on column j0 = s - 1 - left, up to the slot
// right of the band (band_hi + 1, which the first row's last band cell
// reads); the slots past it start, and stay, off the band.
__device__ __forceinline__ int2 row0(int s, int left, int band_hi, int tl,
                                     int pl) {
  const int j0 = s - 1 - left;
  if (j0 == 0) return make_int2(0, 0);
  if (j0 >= 1 && j0 <= tl && s <= band_hi + 1)
    return make_int2(kGO + j0 * kGO + j0, kGO + (pl + 1) * kGO + j0);
  return make_int2(kNegInf, kNegInf);
}

// Slot bits 0..hi (none for hi < 0).
__device__ __forceinline__ unsigned low_bits(int hi) {
  return hi < 0 ? 0u : (hi >= 31 ? kFull : (2u << hi) - 1u);
}

// The DP of one pair over NS register slots (NS >= pair_slots), rows
// 1..pl; returns m at row pl, column t_len (slot t_len - p_len + left + 1).
template <int NS>
__device__ __forceinline__ int thread_pair(const int8_t* __restrict__ tr,
                                           int tl,
                                           const int8_t* __restrict__ pr,
                                           int pl) {
  static_assert(NS % 4 == 0 && NS <= 32, "whole words, bits of one word");
  constexpr int kNW = NS / 4;
  const int diff = tl - pl;
  const int left = 5 + max(-diff, 0);
  const int right = 5 + max(diff, 0);
  const int band_hi = left + right + 1;  // slot of the band's last cell
  const unsigned keep = low_bits(band_hi);

  int a[NS], b[NS];  // m + j, e + j
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int2 v = row0(s, left, band_hi, tl, pl);
    a[s] = v.x;
    b[s] = v.y;
  }

  // Text codes under the slots, byte s & 3 of word s >> 2 for slot s;
  // row i's slot s lies on column i - left - 1 + s.  Columns off the text
  // hold 0: they are off the band.
  auto code = [&](int j) -> unsigned {
    return (j >= 1 && j <= tl) ? (unsigned)(uint8_t)__ldg(tr + j - 1) : 0u;
  };
  unsigned tw[kNW];
#pragma unroll
  for (int k = 0; k < kNW; ++k) tw[k] = 0u;
#pragma unroll
  for (int s = 0; s < NS; ++s) tw[s >> 2] |= code(s - left) << (8 * (s & 3));
  const int j_top = NS - 2 - left;  // + i: row i's last slot
  unsigned tq[kAhead];  // top columns of rows i + 1 .. i + kAhead
  int pq[kAhead];       // read bases of rows i .. i + kAhead - 1
#pragma unroll
  for (int q = 0; q < kAhead; ++q) {
    tq[q] = code(j_top + 2 + q);
    pq[q] = q < pl ? (int)__ldg(pr + q) : 0;
  }

  // Row i.  With column 0 on the slots (kCol0: i <= left + 1) one slot
  // takes the boundary values; without, slot 0 lies left of the band and
  // is not run.
  auto row = [&](int i, auto col0_rows) {
    constexpr bool kCol0 = decltype(col0_rows)::value;
    const int pb = pq[0];
#pragma unroll
    for (int q = 0; q + 1 < kAhead; ++q) pq[q] = pq[q + 1];
    pq[kAhead - 1] = i + kAhead <= pl ? (int)__ldg(pr + i + kAhead - 1) : 0;
    const unsigned pbx = (unsigned)(uint8_t)pb * 0x01010101u;
    unsigned sw[kNW];
#pragma unroll
    for (int k = 0; k < kNW; ++k) sw[k] = sub_word(tw[k], pbx, pb == 4);

    const int c0 = left + 1 - i;  // slot of column 0
    const int m0_i = kGO + i * kGO;
    int run = kNegInf;  // max of u over the slots left of s
#pragma unroll
    for (int s = kCol0 ? 0 : 1; s < NS; ++s) {
      int ec = s + 1 < NS
                   ? __viaddmax_s32(a[s + 1 < NS ? s + 1 : s], kGO + kGE,
                                    b[s + 1 < NS ? s + 1 : s] + kGE)
                   : kNegInf;
      int h = __viaddmax_s32(a[s], sub_at(sw[s >> 2], s & 3), ec);
      int mc = __viaddmax_s32(run, kGO, h);
      if (kCol0 && s == c0) {
        ec = kGO + i * kGE;
        h = m0_i - kGO;
        mc = m0_i;
      }
      run = max(run, h);
      a[s] = (keep >> s) & 1u ? mc : kNegInf;
      b[s] = ec;
    }

    // slide the text one column for row i + 1
#pragma unroll
    for (int k = 0; k + 1 < kNW; ++k)
      tw[k] = __funnelshift_r(tw[k], tw[k + 1], 8);
    tw[kNW - 1] = __funnelshift_r(tw[kNW - 1], tq[0], 8);
#pragma unroll
    for (int q = 0; q + 1 < kAhead; ++q) tq[q] = tq[q + 1];
    tq[kAhead - 1] = code(j_top + i + 1 + kAhead);
  };
  const int col0_rows = min(pl, left + 1);
  int i = 1;
  for (; i <= col0_rows; ++i) row(i, std::true_type{});
  for (; i <= pl; ++i) row(i, std::false_type{});

  const int fs = diff + left + 1;
  int score = kNegInf;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (s == fs) score = a[s];
  return score - tl;
}

template <int C = 0>
__device__ __forceinline__ int thread_dispatch(int need, const int8_t* tr,
                                               int tl, const int8_t* pr,
                                               int pl) {
  if constexpr (C + 1 < kThreadClasses) {
    if (need > thread_ns(C))
      return thread_dispatch<C + 1>(need, tr, tl, pr, pl);
  }
  return thread_pair<thread_ns(C)>(tr, tl, pr, pl);
}

// The thread classes' pairs: perm[start[0] .. start[kThreadClasses]);
// each warp takes the smallest NS all of its pairs fit.
__global__ void __launch_bounds__(kThreadBlock)
thread_kernel(const int8_t* __restrict__ t_codes,
              const int32_t* __restrict__ t_lens,
              const int8_t* __restrict__ p_codes,
              const int32_t* __restrict__ p_lens, int lt_w, int lp_w,
              const int* __restrict__ order, int32_t* __restrict__ out) {
  const int* start = order + kBins;
  const int* perm = order + kPerm;
  const int64_t k =
      start[0] + (int64_t)blockIdx.x * kThreadBlock + threadIdx.x;
  const int64_t end = start[kThreadClasses];
  const unsigned live = __ballot_sync(kFull, k < end);
  if (k >= end) return;
  const int64_t item = perm[k];
  const int tl = t_lens[item], pl = p_lens[item];
  const int8_t* tr = t_codes + item * (int64_t)lt_w;
  const int8_t* pr = p_codes + item * (int64_t)lp_w;
  const int need = __reduce_max_sync(live, pair_slots(tl, pl));
  int score = 0;
  if (!degenerate(tl, pl)) {
    score = thread_dispatch(need, tr, tl, pr, pl);
    if (tl == 1 && pl == 1) score = single_base(tr, pr);
  }
  out[item] = score;
}

// ------------------------------------------------------ one warp per pair

// The DP of one pair over 32 x CPL slots, lane l holding slots
// l*CPL .. l*CPL + CPL-1, with the thread path's values; every lane
// returns the score.
template <int CPL>
__device__ __forceinline__ int tile_pair(const int8_t* __restrict__ tr,
                                         int tl,
                                         const int8_t* __restrict__ pr,
                                         int pl, int lane) {
  static_assert(CPL >= 2 && CPL <= 32, "slots of one word");
  constexpr int kNW = (CPL + 3) / 4;
  const int diff = tl - pl;
  const int left = 5 + max(-diff, 0);
  const int right = 5 + max(diff, 0);
  const int band_hi = left + right + 1;
  const int s0 = lane * CPL;  // this lane's first slot
  const unsigned keep = low_bits(band_hi - s0);

  int a[CPL], b[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int2 v = row0(s0 + c, left, band_hi, tl, pl);
    a[c] = v.x;
    b[c] = v.y;
  }

  // text codes under this lane's slots (as the thread path); lane 31
  // loads the warp's new top column each row, four rows ahead, the other
  // lanes take theirs from the next lane
  auto code = [&](int j) -> unsigned {
    return (j >= 1 && j <= tl) ? (unsigned)(uint8_t)__ldg(tr + j - 1) : 0u;
  };
  unsigned tw[kNW];
#pragma unroll
  for (int k = 0; k < kNW; ++k) tw[k] = 0u;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    tw[c >> 2] |= code(s0 + c - left) << (8 * (c & 3));
  const bool top = lane == 31;
  const int j_top = 32 * CPL - 2 - left;  // + i: row i's last slot
  unsigned tq[kAhead];
  int pq[kAhead];
#pragma unroll
  for (int q = 0; q < kAhead; ++q) {
    tq[q] = top ? code(j_top + 2 + q) : 0u;
    pq[q] = q < pl ? (int)__ldg(pr + q) : 0;
  }

  auto row = [&](int i, auto col0_rows) {
    constexpr bool kCol0 = decltype(col0_rows)::value;
    const int pb = pq[0];
#pragma unroll
    for (int q = 0; q + 1 < kAhead; ++q) pq[q] = pq[q + 1];
    pq[kAhead - 1] = i + kAhead <= pl ? (int)__ldg(pr + i + kAhead - 1) : 0;
    const unsigned pbx = (unsigned)(uint8_t)pb * 0x01010101u;
    unsigned sw[kNW];
#pragma unroll
    for (int k = 0; k < kNW; ++k) sw[k] = sub_word(tw[k], pbx, pb == 4);

    const int c0 = left + 1 - i - s0;  // this lane's slot of column 0
    const int m0_i = kGO + i * kGO;

    // vertical predecessor of the lane's last slot: the next lane's first
    int x_next = __shfl_down_sync(
        kFull, __viaddmax_s32(a[0], kGO + kGE, b[0] + kGE), 1);
    if (top) x_next = kNegInf;

    // h (= u) into a, the lane's total
    int tot = kNegInf;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      int ec = c + 1 < CPL
                   ? __viaddmax_s32(a[c + 1 < CPL ? c + 1 : c], kGO + kGE,
                                    b[c + 1 < CPL ? c + 1 : c] + kGE)
                   : x_next;
      int h = __viaddmax_s32(a[c], sub_at(sw[c >> 2], c & 3), ec);
      if (kCol0 && c == c0) {
        ec = kGO + i * kGE;
        h = m0_i - kGO;
      }
      if (!kCol0 && c == 0 && lane == 0) h = kNegInf;  // left of the band
      tot = max(tot, h);
      a[c] = h;
      b[c] = ec;
    }

    // exclusive prefix max of u over the lanes (a lane below d gets its
    // own value back, which leaves the max as it is), then along the lane
    int run = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) run = kNegInf;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      run = max(run, __shfl_up_sync(kFull, run, d));
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int h = a[c];
      int mc = __viaddmax_s32(run, kGO, h);
      if (kCol0 && c == c0) mc = m0_i;
      run = max(run, h);
      a[c] = (keep >> c) & 1u ? mc : kNegInf;
    }

    // slide the text one column for row i + 1
    unsigned nb = __shfl_down_sync(kFull, tw[0], 1);
    if (top) nb = tq[0];
#pragma unroll
    for (int k = 0; k + 1 < kNW; ++k)
      tw[k] = __funnelshift_r(tw[k], tw[k + 1], 8);
    tw[kNW - 1] = (tw[kNW - 1] >> 8) | ((nb & 0xffu) << (8 * ((CPL - 1) & 3)));
#pragma unroll
    for (int q = 0; q + 1 < kAhead; ++q) tq[q] = tq[q + 1];
    tq[kAhead - 1] = top ? code(j_top + i + 1 + kAhead) : 0u;
  };
  const int col0_rows = min(pl, left + 1);
  int i = 1;
  for (; i <= col0_rows; ++i) row(i, std::true_type{});
  for (; i <= pl; ++i) row(i, std::false_type{});

  const int fs = diff + left + 1;
  int v = kNegInf;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (s0 + c == fs) v = a[c];
  return __shfl_sync(kFull, v, fs / CPL) - tl;
}

template <int C = 0>
__device__ __forceinline__ int tile_dispatch(int slots, const int8_t* tr,
                                             int tl, const int8_t* pr,
                                             int pl, int lane) {
  if constexpr (C + 1 < kTileClasses) {
    if (slots > 32 * tile_cpl(C))
      return tile_dispatch<C + 1>(slots, tr, tl, pr, pl, lane);
  }
  return tile_pair<tile_cpl(C)>(tr, tl, pr, pl, lane);
}

// The tile classes' pairs, one warp each, CPL from the pair's slots.
__global__ void __launch_bounds__(32 * kTileWarps)
tile_kernel(const int8_t* __restrict__ t_codes,
            const int32_t* __restrict__ t_lens,
            const int8_t* __restrict__ p_codes,
            const int32_t* __restrict__ p_lens, int lt_w, int lp_w,
            const int* __restrict__ order, int32_t* __restrict__ out) {
  const int* start = order + kBins;
  const int* perm = order + kPerm;
  const int lane = threadIdx.x & 31;
  const int64_t k = start[kThreadClasses] +
                    (int64_t)blockIdx.x * kTileWarps + (threadIdx.x >> 5);
  if (k >= start[kRingClass]) return;  // uniform across the warp
  const int64_t item = perm[k];
  const int tl = t_lens[item], pl = p_lens[item];
  const int score =
      tile_dispatch(pair_slots(tl, pl), t_codes + item * (int64_t)lt_w, tl,
                    p_codes + item * (int64_t)lp_w, pl, lane);
  if (lane == 0) out[item] = score;
}

// ------------------------------------------------- one warp, shared ring

// One warp per pair over band chunks of 32 columns, rows i-1 and i of m
// and e in a ring of `ring` cells per warp in shared memory, indexed by
// column & (ring-1); a read outside the previous row's band is NEG_INF,
// row 0 is its closed form; the deletion chain a warp prefix max per
// chunk seeded with the carry of everything left of it.  With `order`,
// the warps take the ring class's pairs; without, pairs 0..n-1.
__global__ void ring_kernel(const int8_t* __restrict__ t_codes,
                            const int32_t* __restrict__ t_lens,
                            const int8_t* __restrict__ p_codes,
                            const int32_t* __restrict__ p_lens, int64_t n,
                            int lt_w, int lp_w, int ring,
                            const int* __restrict__ order,
                            int32_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t item = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (order != nullptr) {
    const int* start = order + kBins;
    item += start[kRingClass];
    if (item >= start[kClasses]) return;  // uniform across the warp
    item = order[kPerm + item];
  } else if (item >= n) {
    return;
  }

  int* mbuf = smem + (size_t)warp * 4 * ring;  // [2][ring]
  int* ebuf = mbuf + 2 * ring;                 // [2][ring]
  const int mask = ring - 1;
  const int8_t* tr = t_codes + item * (int64_t)lt_w;
  const int8_t* pr = p_codes + item * (int64_t)lp_w;
  const int tl = t_lens[item];
  const int pl = p_lens[item];

  // degenerate cases (reference AlignAlgo.hpp:217-236)
  if (degenerate(tl, pl) || (tl == 1 && pl == 1)) {
    if (lane == 0) out[item] = degenerate(tl, pl) ? 0 : single_base(tr, pr);
    return;
  }

  const int diff = tl - pl;
  const int left = 5 + max(-diff, 0);
  const int right = 5 + max(diff, 0);
  int prev_lo = 1, prev_hi = tl;

  for (int i = 1; i <= pl; ++i) {
    const int* m_prev = mbuf + ((i - 1) & 1) * ring;
    const int* e_prev = ebuf + ((i - 1) & 1) * ring;
    int* m_cur = mbuf + (i & 1) * ring;
    int* e_cur = ebuf + (i & 1) * ring;
    const int pb = pr[i - 1];
    const int lo = max(i - left, 1);
    const int hi = min(i + right, tl);
    const int m0 = kGO + i * kGO;
    const int m0_prev = i == 1 ? 0 : kGO + (i - 1) * kGO;
    // prefix max of U over the columns left of the band
    int carry = i - left <= 1 ? m0 - kGO : kNegInf;
    if (lo > 1) carry = max(carry, kNegInf - kGE * (lo - 1));

    for (int c0 = lo; c0 <= hi; c0 += 32) {
      const int j = c0 + lane;
      const bool act = j <= hi;
      int u = kIdentity, h = 0, ec = 0;
      if (act) {
        int mp, ep, md;
        if (i == 1) {  // row 0 in closed form
          mp = kGO + j * kGO;
          ep = kGO + (pl + 1) * kGO;
          md = j == 1 ? 0 : kGO + (j - 1) * kGO;
        } else {
          const bool in_prev = j >= prev_lo && j <= prev_hi;
          mp = in_prev ? m_prev[j & mask] : kNegInf;
          ep = in_prev ? e_prev[j & mask] : kNegInf;
          const int jd = j - 1;
          md = jd == 0 ? m0_prev
                       : (jd >= prev_lo && jd <= prev_hi ? m_prev[jd & mask]
                                                         : kNegInf);
        }
        const int tb = tr[j - 1];
        const int sub = (tb == pb || tb == 4 || pb == 4) ? kMatch : kMismatch;
        ec = max(ep + kGE, mp + (kGO + kGE));
        h = max(md + sub, ec);
        u = h - kGE * j;
      }
      int incl = u;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      excl = lane == 0 ? carry : max(excl, carry);
      if (act) {
        const int mc = max(h, kGO + kGE * j + excl);
        m_cur[j & mask] = mc;
        e_cur[j & mask] = ec;
        if (i == pl && j == tl) out[item] = mc;
      }
      carry = max(carry, __shfl_sync(kFull, incl, 31));
    }
    prev_lo = lo;
    prev_hi = hi;
    __syncwarp();
  }
}

bool ring_ok(int ring) {
  return ring >= 32 && (ring & (ring - 1)) == 0 && ring <= 8192;
}

// `count` warps of the ring kernel: pairs 0..count-1, or with `order` the
// ring class's pairs.
int launch_ring(const int8_t* tc, const int32_t* tl, const int8_t* pc,
                const int32_t* pl, int64_t n, int lt_w, int lp_w, int ring,
                const int* order, int64_t count, int32_t* out,
                cudaStream_t stream) {
  const size_t per_warp = (size_t)16 * ring;
  int warps = (int)((size_t)(227 * 1024) / per_warp);
  warps = warps > 8 ? 8 : (warps < 1 ? 1 : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((count + warps - 1) / warps);
  ring_kernel<<<grid, 32 * warps, smem, stream>>>(tc, tl, pc, pl, n, lt_w,
                                                  lp_w, ring, order, out);
  return 0;
}

// Pinned host memory for the sort's class starts, the end and the ring
// pairs' most slots (kClasses + 2 ints), one buffer per host thread.
int* head_buffer() {
  static thread_local int* head = nullptr;
  if (head == nullptr &&
      cudaHostAlloc(reinterpret_cast<void**>(&head),
                    (kClasses + 2) * sizeof(int),
                    cudaHostAllocPortable) != cudaSuccess)
    head = nullptr;
  return head;
}

// The second and third streams of the current device.
cudaStream_t side_stream(int dev, int which) {
  static cudaStream_t side[64][2] = {};
  if (side[dev][which] == nullptr)
    cudaStreamCreateWithFlags(&side[dev][which], cudaStreamNonBlocking);
  return side[dev][which];
}

}  // namespace

// Ints of scratch before the permutation: t1k_align_full takes int32
// [t1k_align_order_ints() + n].
extern "C" int t1k_align_order_ints() { return kPerm; }

// t_codes int8 [n, lt_w], p_codes int8 [n, lp_w], lens int32 [n], out
// int32 [n].  The counting sort and the tile kernel run on `stream`, the
// thread kernel and the ring kernel on two more streams that `stream`
// waits for.  Both register paths always launch; the ring path only
// where the sort finds it pairs (the host waits for the sort's counts,
// not for the kernels).  paths[0..2] receive the pairs of the thread,
// tile and ring paths.  Returns the first CUDA error, or
// cudaErrorInvalidValue where a ring pair's band passes the 8,192-cell
// ring (|t_len - p_len| > 8,180).
extern "C" int t1k_align_full(const void* t_codes, const void* t_lens,
                              const void* p_codes, const void* p_lens,
                              int64_t n, int lt_w, int lp_w, void* scratch,
                              void* out, int64_t* paths, void* stream) {
  paths[0] = paths[1] = paths[2] = 0;
  if (n <= 0) return 0;
  if (scratch == nullptr || n > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const auto* tc = static_cast<const int8_t*>(t_codes);
  const auto* pc = static_cast<const int8_t*>(p_codes);
  const auto* tl = static_cast<const int32_t*>(t_lens);
  const auto* pl = static_cast<const int32_t*>(p_lens);
  auto* o = static_cast<int32_t*>(out);
  auto* order = static_cast<int*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);

  cudaMemsetAsync(order, 0, kPerm * sizeof(int), s);
  const int64_t tiles = (n + kSortBlock - 1) / kSortBlock;
  sort_count_kernel<<<(unsigned)min(tiles, (int64_t)1056), kSortBlock, 0,
                      s>>>(tl, pl, n, order);
  sort_scan_kernel<<<1, kScanThreads, 0, s>>>(order);
  const int64_t per = (int64_t)kSortBlock * kScatterItems;
  sort_scatter_kernel<<<(unsigned)((n + per - 1) / per), kSortBlock, 0, s>>>(
      tl, pl, n, order, order + kPerm);

  // The register paths start as soon as the pairs are ordered, on grids
  // that hold every pair (their warps past their class's pairs exit at
  // once).  Meanwhile the class starts, the end and the ring pairs' most
  // slots come back to the host, which launches the ring path, if it has
  // pairs, with a ring sized from them.
  int* head = head_buffer();
  if (head == nullptr) return (int)cudaErrorMemoryAllocation;
  cudaEvent_t ordered, copied, done[2];
  cudaEventCreateWithFlags(&ordered, cudaEventDisableTiming);
  cudaEventCreateWithFlags(&copied, cudaEventDisableTiming);
  cudaEventCreateWithFlags(&done[0], cudaEventDisableTiming);
  cudaEventCreateWithFlags(&done[1], cudaEventDisableTiming);
  cudaEventRecord(ordered, s);
  cudaMemcpyAsync(head, order + kBins, (kClasses + 2) * sizeof(int),
                  cudaMemcpyDeviceToHost, s);
  cudaEventRecord(copied, s);
  tile_kernel<<<(unsigned)((n + kTileWarps - 1) / kTileWarps),
                32 * kTileWarps, 0, s>>>(tc, tl, pc, pl, lt_w, lp_w, order,
                                         o);
  cudaStream_t side0 = side_stream(dev, 0);
  cudaStreamWaitEvent(side0, ordered, 0);
  thread_kernel<<<(unsigned)((n + kThreadBlock - 1) / kThreadBlock),
                  kThreadBlock, 0, side0>>>(tc, tl, pc, pl, lt_w, lp_w, order,
                                            o);
  cudaEventRecord(done[0], side0);

  int rc = (int)cudaEventSynchronize(copied);
  if (rc == 0) {
    const int64_t n_thread = head[kThreadClasses] - head[0];
    const int64_t n_tile = head[kRingClass] - head[kThreadClasses];
    const int64_t n_ring = head[kClasses] - head[kRingClass];
    int ring = 32;  // holds a row's band: 11 + |diff| + 1 = slots - 1 cells
    while (ring < head[kClasses + 1] - 1) ring *= 2;
    paths[0] = n_thread;
    paths[1] = n_tile;
    paths[2] = n_ring;
    if (n_thread + n_tile + n_ring != n || (n_ring > 0 && !ring_ok(ring))) {
      rc = (int)cudaErrorInvalidValue;
    } else if (n_ring > 0) {
      cudaStream_t side1 = side_stream(dev, 1);
      cudaStreamWaitEvent(side1, ordered, 0);
      rc = launch_ring(tc, tl, pc, pl, n, lt_w, lp_w, ring, order, n_ring, o,
                       side1);
      cudaEventRecord(done[1], side1);
      cudaStreamWaitEvent(s, done[1], 0);
    }
  }
  cudaStreamWaitEvent(s, done[0], 0);
  cudaEventDestroy(ordered);  // released once the waits are done
  cudaEventDestroy(copied);
  cudaEventDestroy(done[0]);
  cudaEventDestroy(done[1]);
  const int err = (int)cudaGetLastError();
  return rc != 0 ? rc : err;
}

// The ring kernel alone on every pair in their own order (the first
// port's launch): ring a power of two >= 12 + max |t_len - p_len|.
extern "C" int t1k_align_full_ring(const void* t_codes, const void* t_lens,
                                   const void* p_codes, const void* p_lens,
                                   int64_t n, int lt_w, int lp_w, int ring,
                                   void* out, void* stream) {
  if (n <= 0) return 0;
  if (!ring_ok(ring)) return (int)cudaErrorInvalidValue;
  const int rc = launch_ring(
      static_cast<const int8_t*>(t_codes), static_cast<const int32_t*>(t_lens),
      static_cast<const int8_t*>(p_codes), static_cast<const int32_t*>(p_lens),
      n, lt_w, lp_w, ring, nullptr, n, static_cast<int32_t*>(out),
      static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : (int)cudaGetLastError();
}
