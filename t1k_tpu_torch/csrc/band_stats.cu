// Band-packed banded global alignment with traceback statistics.
//
// Replaces the Pallas kernel t1k_tpu/ops/align_pallas_band.py::_band_kernel
// (stats=True through _desc_stats_call and banded_stats_band, stats=False
// through banded_scores_band).  Same contract: banded affine-gap global
// alignment (match +2, mismatch -2, gap open -4, gap extend -1, band 5
// widened by |t_len - p_len|, code 4 = N matches anything), with the
// match / mismatch / indel counts of the reference walk carried forward
// as 9-bit fields of one packed counter (MU / XU / IU).
//
// The DP state of row i lives in window coordinates w = j - i + ML, so
// the diagonal predecessor of a cell is the same w on the previous row,
// the vertical one w + 1 and the horizontal one w - 1.  Two designs, and
// the first design's kernel for the wider windows kept beside them:
//
// Thread kernels (windows of at most 32 cells, every launch of the
// engine's deferred items): one thread per item.  A thread holds only the
// slots w in [ML - left - 1, ML + right + 1] of the window (the band, the
// column-0 cell one slot left of it and the row-0 cell right of it that
// feeds the first row's vertical move) in registers: NS each of m, e and
// the packed counts, NS = 13 + |t_len - p_len| at least.  A row is one
// left-to-right pass over the slots with compile-time indices: the
// horizontal gap chain is a running max and the delete-run copy scan a
// running (last open cell, payload) pair, so no data crosses lanes.  The
// text under the band slides one base per row, so it is kept as one-hot
// bit masks over the slots (one per base, N in all four) shifted by one
// bit a row, with one new byte loaded per row, four rows ahead.
//
// Nearly every deferred item has t_len == p_len (13 slots), and a
// kernel's register count is that of its widest path, so the items are
// split: thread_narrow_kernel takes those of at most 13 slots (with the
// rows past column 0 in a copy of the row without its tests),
// thread_wide_kernel the rest, each warp at 24 slots (every wide item of
// the engine's ML = 15) or 32.  The two run side by side on two streams,
// the wide one dispatched first, so its few long warps start at once.
// A counting sort on the card (three small kernels) orders each range by
// p_len, longest first, so a warp's 32 items run about as many rows
// each; results go back to the items' own columns.
//
// group_kernel (windows of 64, 128 and 256 cells: the dry run, entry()
// and wide banded_stats_band batches; no stage launches one): the same
// slots, up to 256 of them, on a group of G lanes per item, each lane
// holding CPL consecutive slots and running the thread kernels' per-slot
// code on them.  G is the fewest lanes (a power of two) whose slots hold
// the item; CPL (1, 2, 4 or 8) is chosen per launch on the host, the
// fewest with which the batch's groups stay within a bound on lanes
// (ops/align_band.py group_cpl).  What crosses a lane's edge goes by shuffles of width G:
// the vertical move one __shfl_down_sync, the gap chain's running max
// and the delete run's last open cell each a log2 G step prefix max, the
// open cell's payload one shuffle from its lane.  A batch of one shape
// runs in index order; any other first goes through the counting sort
// on (lane class, p_len) bins, widest class and longest first, each warp
// then holding 32 / G items of one class.
//
// band_warp_kernel (the first design for 64-256 cells, kept for A/B
// timing only): one warp per item, lane l holding the W/32 window cells
// w = l*CPL .. l*CPL + CPL-1, every cell of the window computed.
//
// What bounds them on an H100: integer instruction throughput, not bytes
// - an item reads t_len + p_len bytes and writes 8.  The thread kernels
// spend about 40 instructions per slot a row, one warp instruction
// serving 32 items.  The group kernel spends the same per slot and lane,
// plus 16-20 shuffles a row, about half of them dependent; on batches
// too small to fill the card (the dry run's 256-1,024 items) the row's
// dependent shuffles set the time, so at CPL <= 2 a row's count pass
// and the next row's score pass run their scans step by step together.
// The warp kernel spends about 24 dependent shuffles and 200 warp
// instructions a row on all W cells, of which the band uses 12-21 a lane
// row.

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
// Packed counters wrap like the reference's int32 lanes; unsigned keeps
// that wrap defined.  Only cells off the optimal walk ever wrap.
constexpr unsigned kMU = 1u;
constexpr unsigned kXU = 1u << 9;
constexpr unsigned kIU = 1u << 18;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

// Copy-scan element: the payload of the largest key at or left of a cell
// (keys are cell positions or the -1024 sentinel; ties go to the right,
// which makes the operator associative).
__device__ __forceinline__ void take_left(int lk, unsigned lp, int& k,
                                          unsigned& p) {
  if (lk > k) {
    k = lk;
    p = lp;
  }
}

template <int CPL, bool STATS>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_warp_kernel(const int8_t* __restrict__ ref, const int8_t* __restrict__ reads,
            const int64_t* __restrict__ desc, int64_t n, int ml,
            int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t item =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n) return;  // uniform across the warp

  const int64_t t_off = desc[item];
  const int tl = (int)desc[n + item];
  const int64_t p_off = desc[2 * n + item];
  const int pl = (int)desc[3 * n + item];
  const int diff = tl - pl;
  const int left = 5 + max(-diff, 0);
  const int right = 5 + max(diff, 0);
  const int w_final = ml + diff;
  const int w0 = lane * CPL;  // first cell of this lane
  // band test on w alone: j >= i - left and j <= i + right
  const int w_lo = ml - left;
  const int w_hi = ml + right;

  int m[CPL], e[CPL];
  unsigned pm[CPL], pe[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j0 = w0 + c - ml;
    const bool inside = j0 >= 1 && j0 <= tl;
    m[c] = j0 == 0 ? 0 : (inside ? kGO + j0 * kGO : kNegInf);
    e[c] = j0 == 0 ? 0 : (inside ? kGO + (pl + 1) * kGO : kNegInf);
    if (STATS) {
      // row-0 closed forms of the reference walk's boundary quirks
      pm[c] = j0 == 0 ? 0u
                      : (unsigned)(j0 * (int)kIU +
                                   (j0 * kGE >= (pl + 1) * kGO ? 0 : (int)kIU));
      pe[c] = j0 == 0 ? 0u : (unsigned)((j0 + 1) * (int)kIU);
    }
  }

  int score = kNegInf;
  unsigned statv = 0u;

  for (int i = 1; i <= pl; ++i) {
    const int pb = reads[p_off + i - 1];
    const int m0_i = kGO + i * kGO;
    const bool start_le1 = left >= i - 1;

    // vertical predecessors: cell w+1 of the previous row
    int x[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) x[c] = max(e[c] + kGE, m[c] + (kGO + kGE));
    const int x_next = __shfl_down_sync(kFull, x[0], 1);
    int m_next = 0;
    unsigned pm_next = 0u, pe_next = 0u;
    if (STATS) {
      m_next = __shfl_down_sync(kFull, m[0], 1);
      pm_next = __shfl_down_sync(kFull, pm[0], 1);
      pe_next = __shfl_down_sync(kFull, pe[0], 1);
    }

    int sub[CPL], ecur[CPL], h[CPL], u[CPL];
    bool inband[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int w = w0 + c;
      const int j = w - ml + i;
      const bool col0 = j == 0;
      const bool in_text = j >= 1 && j <= tl;
      const int tb = in_text ? (int)ref[t_off + j - 1] : 0;
      sub[c] = (tb == pb || tb == 4 || pb == 4) ? kMatch : kMismatch;
      inband[c] = in_text && w >= w_lo && w <= w_hi;
      int ec = c + 1 < CPL ? x[c + 1 < CPL ? c + 1 : c]
                           : (lane == 31 ? kNegInf : x_next);
      if (col0) ec = kGO + i * kGE;
      int hh = max(m[c] + sub[c], ec);
      if (col0) hh = m0_i;
      if (!(inband[c] || (col0 && start_le1))) hh = kNegInf;
      ecur[c] = ec;
      h[c] = hh;
      u[c] = col0 ? (start_le1 ? m0_i - kGO : kNegInf) : hh - kGE * j;
    }

    // exclusive prefix max of u along w: lane totals, 5-step warp scan,
    // then a running max inside the lane
    int tot = u[0];
#pragma unroll
    for (int c = 1; c < CPL; ++c) tot = max(tot, u[c]);
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, tot, s);
      if (lane >= s) tot = max(tot, v);
    }
    int run = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) run = kNegInf;

    int f[CPL], mc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = w0 + c - ml + i;
      const bool col0 = j == 0;
      f[c] = kGO + kGE * j + run;
      run = max(run, u[c]);
      const bool ibc = inband[c] || col0;
      int v = max(h[c], f[c]);
      if (!ibc) v = kNegInf;
      if (col0) v = m0_i;
      mc[c] = v;
      if (!ibc) ecur[c] = kNegInf;
    }

    if (STATS) {
      // Forward count propagation with the walk's local tie rules: the
      // insert-run pop compares the previous row's m (cell w+1), the
      // delete-run pop this row's m one cell to the left.
      unsigned pe_new[CPL], pm_nof[CPL];
      bool diag_ok[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = w0 + c - ml + i;
        const bool col0 = j == 0;
        const int m_up = c + 1 < CPL ? m[c + 1 < CPL ? c + 1 : c]
                                     : (lane == 31 ? kNegInf : m_next);
        const unsigned pm_up = c + 1 < CPL ? pm[c + 1 < CPL ? c + 1 : c]
                                           : (lane == 31 ? 0u : pm_next);
        const unsigned pe_up = c + 1 < CPL ? pe[c + 1 < CPL ? c + 1 : c]
                                           : (lane == 31 ? 0u : pe_next);
        const bool open_e = m_up + kGO + kGE == ecur[c];
        pe_new[c] = kIU + (open_e ? pm_up : pe_up);
        diag_ok[c] = m[c] + sub[c] == mc[c] && j >= 1 && !col0;
        const unsigned su = sub[c] == kMatch ? kMU : kXU;
        pm_nof[c] = diag_ok[c] ? pm[c] + su : pe_new[c];
      }
      // left neighbours of this row's m and of pm_nof
      const int m_prev_lane = __shfl_up_sync(kFull, mc[CPL - 1], 1);
      const unsigned nof_prev_lane = __shfl_up_sync(kFull, pm_nof[CPL - 1], 1);

      int key[CPL];
      unsigned pay[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int w = w0 + c;
        const int j = w - ml + i;
        const bool col0 = j == 0;
        const int m_left = c > 0 ? mc[c > 0 ? c - 1 : 0]
                                 : (lane == 0 ? kNegInf : m_prev_lane);
        const unsigned nof_left = c > 0 ? pm_nof[c > 0 ? c - 1 : 0]
                                        : (lane == 0 ? 0u : nof_prev_lane);
        const bool o = (m_left + kGO + kGE == f[c] && j >= 1 && !col0) || col0;
        key[c] = o ? w : -1024;
        pay[c] = col0 ? (unsigned)i * kIU : nof_left;
      }
      // inclusive copy scan inside the lane, then over lane aggregates
#pragma unroll
      for (int c = 1; c < CPL; ++c) take_left(key[c - 1], pay[c - 1], key[c], pay[c]);
      int ak = key[CPL - 1];
      unsigned ap = pay[CPL - 1];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int vk = __shfl_up_sync(kFull, ak, s);
        const unsigned vp = __shfl_up_sync(kFull, ap, s);
        if (lane >= s) take_left(vk, vp, ak, ap);
      }
      int lk = __shfl_up_sync(kFull, ak, 1);
      const unsigned lp = __shfl_up_sync(kFull, ap, 1);
      if (lane == 0) lk = INT_MIN;  // identity of the scan
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int w = w0 + c;
        const int j = w - ml + i;
        const bool col0 = j == 0;
        int kw = key[c];
        unsigned pw = pay[c];
        take_left(lk, lp, kw, pw);
        const unsigned pf = pw + (unsigned)(w - kw + 1) * kIU;
        unsigned v = diag_ok[c] ? pm[c] + (sub[c] == kMatch ? kMU : kXU)
                                : (f[c] >= ecur[c] ? pf : pe_new[c]);
        if (col0) v = (unsigned)i * kIU;
        pm[c] = v;
        pe[c] = pe_new[c];
      }
    }

#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      m[c] = mc[c];
      e[c] = ecur[c];
    }
    if (i == pl) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (w0 + c == w_final) {
          score = mc[c];
          if (STATS) statv = pm[c];
        }
      }
    }
  }

  // The lane holding w_final reports (lane 0 when the final cell lies
  // outside the window, which leaves the empty-window values).
  const bool in_win = w_final >= 0 && w_final < 32 * CPL;
  const int owner = in_win ? w_final / CPL : 0;
  if (lane != owner) return;
  int s_out = max(score, kNegInf);
  int p_out = max((int)statv, 0);
  if (tl == 1 && pl == 1) {
    const int t0 = ref[t_off];
    const int p0 = reads[p_off];
    const bool eq = t0 == p0 || t0 == 4 || p0 == 4;
    s_out = eq ? kMatch : kMismatch;
    p_out = eq ? (int)kMU : (int)kXU;
  }
  if (tl == 0 || pl == 0) {
    s_out = 0;
    p_out = 0;
  }
  out[item] = s_out;
  out[n + item] = STATS ? p_out : 0;
}

template <int CPL>
void launch_warp(const int8_t* ref, const int8_t* reads, const int64_t* desc,
                 int64_t n, int ml, int stats, int32_t* out,
                 cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  if (stats)
    band_warp_kernel<CPL, true><<<grid, block, 0, stream>>>(ref, reads, desc,
                                                            n, ml, out);
  else
    band_warp_kernel<CPL, false><<<grid, block, 0, stream>>>(ref, reads, desc,
                                                             n, ml, out);
}

// ------------------------------------------------------- one thread per item

constexpr int kW = 32;  // the thread kernels' window
constexpr int kThreadBlock = 128;
constexpr int kAhead = 4;  // rows of bases loaded ahead
// Slot counts: the narrow kernel's, then the wide kernel's two.
constexpr int kNarrow = 13;
constexpr int kWideLow = 24;
// Order bins: the narrow items by length, then the wide items by length.
// The scratch holds the bins, the split (the first wide position) and the
// permutation.
constexpr int kLens = 256;
constexpr int kBins = 2 * kLens;
constexpr int kSortBlock = 256;
constexpr int kScatterItems = 4;

// Slots an item needs: the cells of a window of kw cells from the
// column-0 cell left of the band to the row-0 cell right of it, clipped
// to the window.
__device__ __forceinline__ int window_slots(int tl, int pl, int ml, int kw) {
  const int diff = tl - pl;
  const int base = max(ml - 5 - max(-diff, 0) - 1, 0);
  return max(min(ml + 5 + max(diff, 0) + 1, kw - 1) - base + 1, 1);
}

__device__ __forceinline__ int item_slots(int tl, int pl, int ml) {
  return window_slots(tl, pl, ml, kW);
}

// Longest p_len first (p_len >= 255 share the first length) within each
// kernel's range, so a warp's items run about as many rows each.
__device__ __forceinline__ int item_bin(const int64_t* desc, int64_t n,
                                        int64_t k, int ml) {
  const int64_t pl = desc[3 * n + k];
  const int len = kLens - 1 - (int)min(pl, (int64_t)(kLens - 1));
  const bool narrow = item_slots((int)desc[n + k], (int)pl, ml) <= kNarrow;
  return narrow ? len : kLens + len;
}

// The thread kernels' bins.
struct ThreadBins {
  static constexpr int kCount = kBins;
  int ml;
  __device__ __forceinline__ int operator()(const int64_t* desc, int64_t n,
                                            int64_t k) const {
    return item_bin(desc, n, k, ml);
  }
};

template <class Bins>
__global__ void __launch_bounds__(kSortBlock)
sort_count_kernel(const int64_t* __restrict__ desc, int64_t n, Bins bin_of,
                  int* __restrict__ bins) {
  __shared__ int h[Bins::kCount];
  for (int b = threadIdx.x; b < Bins::kCount; b += kSortBlock) h[b] = 0;
  __syncthreads();
  for (int64_t k = (int64_t)blockIdx.x * kSortBlock + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * kSortBlock)
    atomicAdd(&h[bin_of(desc, n, k)], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < Bins::kCount; b += kSortBlock)
    if (h[b]) atomicAdd(&bins[b], h[b]);
}

// Exclusive scan of the bin counts in place (the bins become cursors),
// two bins a thread; bins[BINS] = the start of bin kLens (the thread
// kernels' first wide position).
template <int BINS>
__global__ void __launch_bounds__(BINS / 2) sort_scan_kernel(int* bins) {
  constexpr int kThreads = BINS / 2;
  static_assert(BINS <= 2 * kThreads, "two bins a thread");
  __shared__ int acc[kThreads];
  const int t = threadIdx.x;
  const int c0 = 2 * t < BINS ? bins[2 * t] : 0;
  const int c1 = 2 * t + 1 < BINS ? bins[2 * t + 1] : 0;
  acc[t] = c0 + c1;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    const int v = t >= d ? acc[t - d] : 0;
    __syncthreads();
    acc[t] += v;
    __syncthreads();
  }
  const int before = acc[t] - c0 - c1;
  if (2 * t < BINS) bins[2 * t] = before;
  if (2 * t + 1 < BINS) bins[2 * t + 1] = before + c0;
  if (2 * t == kLens) bins[BINS] = before;
}

// Each block ranks its items per bin in shared memory, then claims one
// range per bin from the global cursors.  The order within a bin is
// arbitrary; results land in the items' own columns all the same.
template <class Bins>
__global__ void __launch_bounds__(kSortBlock)
sort_scatter_kernel(const int64_t* __restrict__ desc, int64_t n, Bins bin_of,
                    int* __restrict__ cursor, int* __restrict__ perm) {
  __shared__ int h[Bins::kCount];
  __shared__ int start[Bins::kCount];
  for (int b = threadIdx.x; b < Bins::kCount; b += kSortBlock) h[b] = 0;
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
      bin[r] = bin_of(desc, n, k);
      rank[r] = atomicAdd(&h[bin[r]], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < Bins::kCount; b += kSortBlock)
    start[b] = h[b] ? atomicAdd(&cursor[b], h[b]) : 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kScatterItems; ++r)
    if (bin[r] >= 0)
      perm[start[bin[r]] + rank[r]] = (int)(k0 + (int64_t)r * kSortBlock);
}

// One item over NS register slots: slot s is window cell w = base + s,
// base = max(ML - left - 1, 0), so the slots cover the column-0 cell left
// of the band (w = ML - left - 1, absent when that is -1), the band and
// the row-0 cell right of it; cells w >= kW do not exist.  NS must be at
// least item_slots().  SPLIT runs the rows past the column-0 cell's last
// slot (i > ML - base) through a copy of the row without the column-0
// and j >= 1 tests.  Returns (score, packed counts) before the
// single-base and empty fix-ups.
template <int NS, bool STATS, bool SPLIT>
__device__ __forceinline__ int2 band_item(const int8_t* __restrict__ ref,
                                          const int8_t* __restrict__ reads,
                                          int64_t t_off, int tl,
                                          int64_t p_off, int pl, int ml) {
  static_assert(NS <= 32, "slots are the bits of one word");
  const int diff = tl - pl;
  const int left = 5 + max(-diff, 0);
  const int right = 5 + max(diff, 0);
  const int base = max(ml - left - 1, 0);
  const int n_exist = kW - base;  // slots s < n_exist lie in the window
  const int band_lo = ml - left - base;
  const int band_hi = min(ml + right, kW - 1) - base;

  int m[NS], e[NS];
  unsigned pm[NS], pe[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int j0 = base + s - ml;
    const bool inside = j0 >= 1 && j0 <= tl;
    m[s] = j0 == 0 ? 0 : (inside ? kGO + j0 * kGO : kNegInf);
    e[s] = j0 == 0 ? 0 : (inside ? kGO + (pl + 1) * kGO : kNegInf);
    if (s >= n_exist) {
      m[s] = kNegInf;
      e[s] = kNegInf;
    }
    if (STATS) {
      // row-0 closed forms of the reference walk's boundary quirks
      pm[s] = j0 == 0 ? 0u
                      : (unsigned)(j0 * (int)kIU +
                                   (j0 * kGE >= (pl + 1) * kGO ? 0 : (int)kIU));
      pe[s] = j0 == 0 ? 0u : (unsigned)((j0 + 1) * (int)kIU);
    }
  }

  // Text under the slots as one-hot masks: bit s of eq[b] is set where the
  // base under slot s on this row is b or N.  Row i's slot NS-1 lies on
  // text column j = base - ML + i + NS - 1; columns off the text load
  // nothing (code -1 sets no bit).
  const int j_top = base - ml + NS - 1;  // + i
  auto text_code = [&](int j) -> int {
    return (j >= 1 && j <= tl) ? (int)__ldg(ref + t_off + j - 1) : -1;
  };
  unsigned eq0 = 0u, eq1 = 0u, eq2 = 0u, eq3 = 0u;
  auto push = [&](int c) {
    constexpr unsigned top = 1u << (NS - 1);
    const bool nb = c == 4;
    eq0 = (eq0 >> 1) | ((c == 0 || nb) ? top : 0u);
    eq1 = (eq1 >> 1) | ((c == 1 || nb) ? top : 0u);
    eq2 = (eq2 >> 1) | ((c == 2 || nb) ? top : 0u);
    eq3 = (eq3 >> 1) | ((c == 3 || nb) ? top : 0u);
  };
#pragma unroll
  for (int r = 2 - NS; r <= 0; ++r) push(text_code(j_top + r));
  int tq[kAhead], pq[kAhead];  // codes of rows i .. i + kAhead - 1
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    tq[a] = text_code(j_top + 1 + a);
    pq[a] = a < pl ? (int)__ldg(reads + p_off + a) : 0;
  }

  // Row i.  Without column 0 on the slots (kCol0 false: i > ML - base)
  // every slot has j >= 1.
  auto row = [&](int i, auto col0_rows) {
    constexpr bool kCol0 = decltype(col0_rows)::value;
    push(tq[0]);
    const int pb = pq[0];
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) {
      tq[a] = tq[a + 1];
      pq[a] = pq[a + 1];
    }
    tq[kAhead - 1] = text_code(j_top + i + kAhead);
    pq[kAhead - 1] =
        i + kAhead <= pl ? (int)__ldg(reads + p_off + i + kAhead - 1) : 0;
    const unsigned match = pb == 0   ? eq0
                           : pb == 1 ? eq1
                           : pb == 2 ? eq2
                           : pb == 3 ? eq3
                                     : 0xffffffffu;

    const int js0 = base - ml + i;  // text column of slot 0
    const int c0 = -js0;            // slot of column 0
    const int m0_i = kGO + i * kGO;
    const bool start_le1 = left >= i - 1;
    // in band: inside the band's w range and on the text
    const int lo = max(band_lo, max(1 - js0, 0));
    const int hi = min(band_hi, min(tl - js0, NS - 1));
    const unsigned inb =
        hi >= lo ? (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo) : 0u;

    int run = kNegInf;        // max of u over the slots left of s
    int m_left = kNegInf;     // this row's m one slot left
    unsigned nof_left = 0u;   // its count without the horizontal move
    int last_w = -1024;       // the last open cell at or left of s
    unsigned last_p = 0u;     // and its payload
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int j = js0 + s;
      const bool col0 = kCol0 && s == c0;
      const bool j_pos = !kCol0 || j >= 1;
      const bool inband = (inb >> s) & 1u;
      const bool is_match = (match >> s) & 1u;
      const int sub = is_match ? kMatch : kMismatch;
      const int m_up = s + 1 < NS ? m[s + 1 < NS ? s + 1 : s] : kNegInf;
      const int e_up = s + 1 < NS ? e[s + 1 < NS ? s + 1 : s] : kNegInf;
      int ec = s + 1 < NS ? max(e_up + kGE, m_up + (kGO + kGE)) : kNegInf;
      if (col0) ec = kGO + i * kGE;
      int h = col0 ? m0_i : max(m[s] + sub, ec);
      if (!(inband || (col0 && start_le1))) h = kNegInf;
      const int u = col0 ? (start_le1 ? m0_i - kGO : kNegInf) : h - kGE * j;
      const int f = kGO + kGE * j + run;
      run = max(run, u);
      const bool ibc = inband || col0;
      int mc = ibc ? max(h, f) : kNegInf;
      if (col0) mc = m0_i;
      if (!ibc) ec = kNegInf;
      if (STATS) {
        // the walk's tie rules: the insert-run pop compares the previous
        // row's m one slot right, the delete-run pop this row's m one
        // slot left
        const unsigned pm_up = s + 1 < NS ? pm[s + 1 < NS ? s + 1 : s] : 0u;
        const unsigned pe_up = s + 1 < NS ? pe[s + 1 < NS ? s + 1 : s] : 0u;
        const bool open_e = m_up + (kGO + kGE) == ec;
        const unsigned pe_new = kIU + (open_e ? pm_up : pe_up);
        const bool diag_ok = m[s] + sub == mc && j_pos;
        const unsigned diag_p = pm[s] + (is_match ? kMU : kXU);
        const unsigned nof = diag_ok ? diag_p : pe_new;
        if (col0 || (m_left + (kGO + kGE) == f && j_pos)) {
          last_w = base + s;
          last_p = col0 ? (unsigned)i * kIU : nof_left;
        }
        const unsigned pf = last_p + (unsigned)(base + s - last_w + 1) * kIU;
        unsigned v = diag_ok ? diag_p : (f >= ec ? pf : pe_new);
        if (col0) v = (unsigned)i * kIU;
        pm[s] = v;
        pe[s] = pe_new;
        nof_left = nof;
      }
      m_left = mc;
      m[s] = mc;
      e[s] = ec;
    }
  };
  const int col0_rows = SPLIT ? min(pl, ml - base) : pl;
  int i = 1;
  for (; i <= col0_rows; ++i) row(i, std::true_type{});
  if constexpr (SPLIT)
    for (; i <= pl; ++i) row(i, std::false_type{});

  // the final cell w = ML + diff, outside the window for the empty values
  const int w_final = ml + diff;
  const int fs = w_final - base;
  int s_out = kNegInf;
  unsigned statv = 0u;
  if (w_final >= 0 && w_final < kW) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s == fs) {
        s_out = m[s];
        if (STATS) statv = pm[s];
      }
    }
  }
  return make_int2(max(s_out, kNegInf), max((int)statv, 0));
}

struct Item {
  int64_t t_off, p_off;
  int tl, pl;
};

__device__ __forceinline__ Item load_item(const int64_t* __restrict__ desc,
                                          int64_t n, int64_t item) {
  return Item{desc[item], desc[2 * n + item], (int)desc[n + item],
              (int)desc[3 * n + item]};
}

// Single-base and empty fix-ups, then the item's own column.
template <bool STATS>
__device__ __forceinline__ void store_item(const int8_t* __restrict__ ref,
                                           const int8_t* __restrict__ reads,
                                           const Item& it, int2 r,
                                           int64_t n, int64_t item,
                                           int32_t* __restrict__ out) {
  int s_out = r.x, p_out = r.y;
  if (it.tl == 1 && it.pl == 1) {
    const int t0 = ref[it.t_off];
    const int p0 = reads[it.p_off];
    const bool eq = t0 == p0 || t0 == 4 || p0 == 4;
    s_out = eq ? kMatch : kMismatch;
    p_out = eq ? (int)kMU : (int)kXU;
  }
  if (it.tl == 0 || it.pl == 0) {
    s_out = 0;
    p_out = 0;
  }
  out[item] = s_out;
  out[n + item] = STATS ? p_out : 0;
}

// The narrow items (at most kNarrow slots): perm[0 .. split).
template <bool STATS>
__global__ void __launch_bounds__(kThreadBlock)
thread_narrow_kernel(const int8_t* __restrict__ ref,
                     const int8_t* __restrict__ reads,
                     const int64_t* __restrict__ desc,
                     const int* __restrict__ order, int64_t n, int ml,
                     int32_t* __restrict__ out) {
  const int64_t k = (int64_t)blockIdx.x * kThreadBlock + threadIdx.x;
  if (k >= order[kBins]) return;
  const int64_t item = order[kBins + 1 + k];
  const Item it = load_item(desc, n, item);
  const int2 r = band_item<kNarrow, STATS, true>(ref, reads, it.t_off, it.tl,
                                                 it.p_off, it.pl, ml);
  store_item<STATS>(ref, reads, it, r, n, item, out);
}

// One wide item at the warp's slot count.
template <bool STATS>
__device__ __forceinline__ void wide_item(const int8_t* __restrict__ ref,
                                          const int8_t* __restrict__ reads,
                                          const Item& it, int need, int64_t n,
                                          int64_t item, int ml,
                                          int32_t* __restrict__ out) {
  int2 r;
  if (need <= kWideLow)
    r = band_item<kWideLow, STATS, false>(ref, reads, it.t_off, it.tl,
                                          it.p_off, it.pl, ml);
  else
    r = band_item<32, STATS, false>(ref, reads, it.t_off, it.tl, it.p_off,
                                    it.pl, ml);
  store_item<STATS>(ref, reads, it, r, n, item, out);
}

// The wide items: perm[split .. n); each warp takes the smaller slot
// count (24 or 32) that all of its items fit.
template <bool STATS>
__global__ void __launch_bounds__(kThreadBlock)
thread_wide_kernel(const int8_t* __restrict__ ref,
                   const int8_t* __restrict__ reads,
                   const int64_t* __restrict__ desc,
                   const int* __restrict__ order, int64_t n, int ml,
                   int32_t* __restrict__ out) {
  const int64_t k =
      order[kBins] + (int64_t)blockIdx.x * kThreadBlock + threadIdx.x;
  const unsigned live = __ballot_sync(0xffffffffu, k < n);
  if (k >= n) return;
  const int64_t item = order[kBins + 1 + k];
  const Item it = load_item(desc, n, item);
  const int need = __reduce_max_sync(live, item_slots(it.tl, it.pl, ml));
  wide_item<STATS>(ref, reads, it, need, n, item, ml, out);
}

// order: Bins::kCount cursors, the split, then perm [n] in bin order.
// After the scatter each cursor holds the end of its bin.
template <class Bins>
void item_order(const int64_t* desc, int64_t n, Bins bin_of, int* order,
                cudaStream_t stream) {
  cudaMemsetAsync(order, 0, Bins::kCount * sizeof(int), stream);
  const int64_t tiles = (n + kSortBlock - 1) / kSortBlock;
  sort_count_kernel<<<(unsigned)min(tiles, (int64_t)1056), kSortBlock, 0,
                      stream>>>(desc, n, bin_of, order);
  sort_scan_kernel<Bins::kCount><<<1, Bins::kCount / 2, 0, stream>>>(order);
  const int64_t per = (int64_t)kSortBlock * kScatterItems;
  sort_scatter_kernel<<<(unsigned)((n + per - 1) / per), kSortBlock, 0,
                        stream>>>(desc, n, bin_of, order,
                                  order + Bins::kCount + 1);
}

// The second stream of the current device, for the narrow kernel.
cudaStream_t side_stream(int dev) {
  static cudaStream_t side[64] = {};
  if (side[dev] == nullptr)
    cudaStreamCreateWithFlags(&side[dev], cudaStreamNonBlocking);
  return side[dev];
}

// The wide kernel goes first on the caller's stream and the narrow kernel
// on a second stream beside it: the card dispatches the wide blocks (its
// blocks past the wide items end at once) first, so its few long warps
// start at once instead of after the last narrow block.  The caller's
// stream then waits for the narrow kernel.
int launch_thread(const int8_t* ref, const int8_t* reads,
                  const int64_t* desc, int* order, int64_t n, int ml,
                  int stats, int32_t* out, cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  cudaStream_t side = side_stream(dev);
  item_order(desc, n, ThreadBins{ml}, order, stream);
  cudaEvent_t ordered, narrow_done;
  cudaEventCreateWithFlags(&ordered, cudaEventDisableTiming);
  cudaEventCreateWithFlags(&narrow_done, cudaEventDisableTiming);
  cudaEventRecord(ordered, stream);
  const unsigned grid = (unsigned)((n + kThreadBlock - 1) / kThreadBlock);
  if (stats)
    thread_wide_kernel<true><<<grid, kThreadBlock, 0, stream>>>(
        ref, reads, desc, order, n, ml, out);
  else
    thread_wide_kernel<false><<<grid, kThreadBlock, 0, stream>>>(
        ref, reads, desc, order, n, ml, out);
  cudaStreamWaitEvent(side, ordered, 0);
  if (stats)
    thread_narrow_kernel<true><<<grid, kThreadBlock, 0, side>>>(
        ref, reads, desc, order, n, ml, out);
  else
    thread_narrow_kernel<false><<<grid, kThreadBlock, 0, side>>>(
        ref, reads, desc, order, n, ml, out);
  cudaEventRecord(narrow_done, side);
  cudaStreamWaitEvent(stream, narrow_done, 0);
  cudaEventDestroy(ordered);  // released once the waits are done
  cudaEventDestroy(narrow_done);
  return (int)cudaGetLastError();
}

// --------------------------------------------- a lane group per item (W > 32)

// Lane classes: class q holds the items a group of G = 32 >> q lanes
// takes, widest first; bins are (class, length) pairs.  A group holds at
// least kGroupMinSlots slots (an item's band takes 11 at the least), so
// a launch at CPL slots a lane has G >= kGroupMinSlots / CPL.
constexpr int kGroupClasses = 6;
constexpr int kGroupBins = kGroupClasses * kLens;
constexpr int kGroupBlock = 128;  // four warps a block
constexpr int kGroupMinSlots = 16;

// log2 of the item's G at CPL = 1 << cpl_shift slots a lane: the fewest
// lanes (a power of two, at least kGroupMinSlots / CPL) whose slots hold
// the item's; 32 at the most.
__device__ __forceinline__ int group_lg(int slots, int cpl_shift) {
  const int lanes = max((slots + (1 << cpl_shift) - 1) >> cpl_shift,
                        kGroupMinSlots >> cpl_shift);
  return min(lanes <= 1 ? 0 : 32 - __clz(lanes - 1), kGroupClasses - 1);
}

// Widest class first, then longest p_len first, so the longest warps
// start first and a warp's groups run about as many rows each.
struct GroupBins {
  static constexpr int kCount = kGroupBins;
  int ml, kw, cpl_shift;
  __device__ __forceinline__ int operator()(const int64_t* desc, int64_t n,
                                            int64_t k) const {
    const int64_t pl = desc[3 * n + k];
    const int len = kLens - 1 - (int)min(pl, (int64_t)(kLens - 1));
    const int lg = group_lg(window_slots((int)desc[n + k], (int)pl, ml, kw),
                            cpl_shift);
    return (kGroupClasses - 1 - lg) * kLens + len;
  }
};

__device__ __forceinline__ unsigned one_hot(int code) {
  // bit 8b: the base is b or N; an off-text column (-1) sets none
  return code == 4 ? 0x01010101u : ((unsigned)code < 4u ? 1u << (8 * code) : 0u);
}

// What a row's score pass leaves for its count pass: F, E (masked), M,
// the previous row's M and, on the lane's last slot, the previous row's
// M at the next lane's first slot (kNegInf on the top lane), and the
// slots' match bits.
template <int CPL>
struct ScoreRow {
  int f[CPL], ec[CPL], mc[CPL], m_prev[CPL];
  int m_up;
  unsigned match;
};

// A score pass between its two halves: H and u of the lane's slots and
// the row's band geometry.
template <int CPL>
struct ScoreMid {
  int h[CPL], u[CPL];
  int lo, hi, c0, jl;
};

// A count pass between its two halves: each slot's counts without the
// horizontal move, whether it opens a delete run and the payload it
// carries; the lane's last open cell's payload.
template <int CPL>
struct CountMid {
  unsigned pe_new[CPL], diag_p[CPL], pay[CPL];
  bool diag_ok[CPL], open[CPL];
  unsigned lp;
};

// One item on a group of G lanes, lane g holding the CPL slots s = g*CPL
// .. g*CPL + CPL-1 (slot s is window cell base + s, as band_item's): the
// same per-slot arithmetic as band_item, with what crosses a lane's edge
// shuffled inside the group (width G; every lane of the warp takes part,
// the warp's groups running its longest item's rows, an item's result
// taken at its own last row, so the shuffles need no partial mask).  The
// text under the slots is four one-hot fields of CPL bits (field b at
// bits 8b..), slid one slot a row: a lane's top bit from the next lane's
// bit 0, the top lane's from one byte loaded a row.  A row is two
// passes, each cut at a group scan (log2 G __shfl_up_sync steps, then
// one step for the lanes to the left).  The score pass: the previous
// row's first slot of the next lane (the vertical move) and u; the max
// of u left of the lane; the lane's running max, F and M.  The count
// pass: the counts, this row's last m and count of the previous lane,
// the open cells; the last open cell left of the lane (a max scan of
// the keys) and one shuffle from the lane that holds it for its
// payload; the counts of the row.  Past the column-0 rows, at CPL <= 2,
// row i's count pass and row i + 1's score pass share a loop body and
// their two scans go step by step together, so their shuffles overlap;
// at 4 and 8 they run one after the other (fewer registers, faster
// there: scripts/band_ab.py's readings).
// An inactive lane (a group past the last item) runs an empty item and
// stores nothing.
template <int CPL, int G, bool STATS>
__device__ __forceinline__ void group_item(
    const int8_t* __restrict__ ref, const int8_t* __restrict__ reads,
    const Item& it, bool active, int64_t n, int64_t item, int ml, int kw,
    int g, int32_t* __restrict__ out) {
  static_assert(CPL >= 1 && CPL <= 8, "a field of 8 bits a base");
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "a warp's lanes");
  constexpr unsigned kLow = 0x01010101u;
  constexpr unsigned kKeep = kLow * ((1u << (CPL - 1)) - 1u);
  constexpr int kNS = G * CPL;
  const int tl = it.tl, pl = it.pl;
  const int diff = tl - pl;
  const int left = 5 + max(-diff, 0);
  const int right = 5 + max(diff, 0);
  const int base = max(ml - left - 1, 0);
  const int s0 = g * CPL;  // the lane's first slot
  const int n_exist = kw - base;
  const int band_lo = ml - left - base;
  const int band_hi = min(ml + right, kw - 1) - base;
  const bool top = g == G - 1;
  const bool first = g == 0;

  int m[CPL], e[CPL];
  unsigned pm[CPL], pe[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int s = s0 + c;
    const int j0 = base + s - ml;
    const bool inside = j0 >= 1 && j0 <= tl;
    m[c] = j0 == 0 ? 0 : (inside ? kGO + j0 * kGO : kNegInf);
    e[c] = j0 == 0 ? 0 : (inside ? kGO + (pl + 1) * kGO : kNegInf);
    if (s >= n_exist) {
      m[c] = kNegInf;
      e[c] = kNegInf;
    }
    if (STATS) {
      pm[c] = j0 == 0 ? 0u
                      : (unsigned)(j0 * (int)kIU +
                                   (j0 * kGE >= (pl + 1) * kGO ? 0 : (int)kIU));
      pe[c] = j0 == 0 ? 0u : (unsigned)((j0 + 1) * (int)kIU);
    }
  }

  auto text_code = [&](int j) -> int {
    return (j >= 1 && j <= tl) ? (int)__ldg(ref + it.t_off + j - 1) : -1;
  };
  // before row 1 slot s holds text column base - ML + s
  unsigned tx = 0u;
#pragma unroll
  for (int c = 0; c < CPL; ++c) tx |= one_hot(text_code(base - ml + s0 + c)) << c;
  const int j_top = base - ml + kNS - 1;  // the top slot's column, + i
  int tq[kAhead], pq[kAhead];             // codes of rows i .. i + kAhead - 1
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    tq[a] = top ? text_code(j_top + 1 + a) : -1;
    pq[a] = a < pl ? (int)__ldg(reads + it.p_off + a) : 0;
  }

  // the final cell w = ML + diff (outside the window: the empty values),
  // taken from its lane's slot fc at row pl
  const int w_final = ml + diff;
  const int fc = w_final - base - s0;
  const bool in_win = w_final >= 0 && w_final < kw && w_final >= base &&
                      w_final - base < kNS;
  const bool owner = in_win ? fc >= 0 && fc < CPL : first;
  int s_out = kNegInf;
  unsigned statv = 0u;

  // Group scans: the max of v over the lanes left of this one, `none`
  // on the first lane; the second form runs two scans step by step.
  auto scan_left = [&](int v, int none) {
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int w = __shfl_up_sync(kFull, v, d, G);
      if (g >= d) v = max(v, w);
    }
    const int x = __shfl_up_sync(kFull, v, 1, G);
    return first ? none : x;
  };
  auto scan_left2 = [&](int& v1, int none1, int& v2, int none2) {
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int w1 = __shfl_up_sync(kFull, v1, d, G);
      const int w2 = __shfl_up_sync(kFull, v2, d, G);
      if (g >= d) {
        v1 = max(v1, w1);
        v2 = max(v2, w2);
      }
    }
    const int x1 = __shfl_up_sync(kFull, v1, 1, G);
    const int x2 = __shfl_up_sync(kFull, v2, 1, G);
    v1 = first ? none1 : x1;
    v2 = first ? none2 : x2;
  };

  // row i's score pass, first half: the text slid, E, H and u; returns
  // the lane's largest u
  auto score_in = [&](int i, auto col0_rows, ScoreRow<CPL>& r,
                      ScoreMid<CPL>& q) {
    constexpr bool kCol0 = decltype(col0_rows)::value;
    const unsigned up_tx = __shfl_down_sync(kFull, tx, 1, G);
    tx = ((tx >> 1) & kKeep) | ((top ? one_hot(tq[0]) : up_tx & kLow) << (CPL - 1));
    const int pb = pq[0];
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) {
      tq[a] = tq[a + 1];
      pq[a] = pq[a + 1];
    }
    tq[kAhead - 1] = top ? text_code(j_top + i + kAhead) : -1;
    pq[kAhead - 1] =
        i + kAhead <= pl ? (int)__ldg(reads + it.p_off + i + kAhead - 1) : 0;
    const unsigned match = (unsigned)pb < 4u ? tx >> (8 * pb) : 0xffffffffu;
    r.match = match;

    const int js0 = base - ml + i;  // text column of slot 0
    q.jl = js0 + s0;                // text column of the lane's slot 0
    q.c0 = -q.jl;                   // the lane's slot of column 0
    const int m0_i = kGO + i * kGO;
    const bool start_le1 = left >= i - 1;
    // in band: the lane's slots lo .. hi
    q.lo = max(band_lo, max(1 - js0, 0)) - s0;
    q.hi = min(band_hi, min(tl - js0, kNS - 1)) - s0;

    // the previous row at the next lane's first slot
    const int x_up = __shfl_down_sync(
        kFull, __viaddmax_s32(e[0], kGE, m[0] + (kGO + kGE)), 1, G);
    if (STATS) {
      r.m_up = __shfl_down_sync(kFull, m[0], 1, G);
      if (top) r.m_up = kNegInf;
    }
    int tot = kNegInf;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const bool col0 = kCol0 && c == q.c0;
      const bool inband = c >= q.lo && c <= q.hi;
      const int sub = (match >> c) & 1u ? kMatch : kMismatch;
      int x = c + 1 < CPL ? __viaddmax_s32(e[c + 1 < CPL ? c + 1 : c], kGE,
                                           m[c + 1 < CPL ? c + 1 : c] +
                                               (kGO + kGE))
                          : (top ? kNegInf : x_up);
      if (col0) x = kGO + i * kGE;
      int hh = col0 ? m0_i : __viaddmax_s32(m[c], sub, x);
      if (!(inband || (col0 && start_le1))) hh = kNegInf;
      r.ec[c] = x;
      q.h[c] = hh;
      q.u[c] = col0 ? (start_le1 ? m0_i - kGO : kNegInf)
                    : hh - kGE * (q.jl + c);
      tot = max(tot, q.u[c]);
    }
    return tot;
  };

  // its second half, from the max of u left of the lane: F and M; m and e
  // become row i's
  auto score_out = [&](int i, auto col0_rows, ScoreRow<CPL>& r,
                       const ScoreMid<CPL>& q, int run) {
    constexpr bool kCol0 = decltype(col0_rows)::value;
    const int m0_i = kGO + i * kGO;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const bool col0 = kCol0 && c == q.c0;
      const bool ibc = (c >= q.lo && c <= q.hi) || col0;
      r.f[c] = kGO + kGE * (q.jl + c) + run;
      run = max(run, q.u[c]);
      int v = ibc ? max(q.h[c], r.f[c]) : kNegInf;
      if (col0) v = m0_i;
      r.mc[c] = v;
      if (!ibc) r.ec[c] = kNegInf;
      if (STATS) r.m_prev[c] = m[c];
      m[c] = v;
      e[c] = r.ec[c];
    }
    if (i == pl && owner) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c == fc) s_out = m[c];
    }
  };

  // row i's count pass, first half, from its score pass's ScoreRow: the
  // walk's tie rules as band_item's, the open cells and their payloads;
  // returns the lane's last open cell (-1024 for none)
  auto counts_in = [&](int i, auto col0_rows, const ScoreRow<CPL>& r,
                       CountMid<CPL>& q) {
    constexpr bool kCol0 = decltype(col0_rows)::value;
    const int jl = base - ml + i + s0;
    const int c0 = -jl;
    unsigned pm_up_l = __shfl_down_sync(kFull, pm[0], 1, G);
    unsigned pe_up_l = __shfl_down_sync(kFull, pe[0], 1, G);
    if (top) {
      pm_up_l = 0u;
      pe_up_l = 0u;
    }
    unsigned nof[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = jl + c;
      const int m_up = c + 1 < CPL ? r.m_prev[c + 1 < CPL ? c + 1 : c] : r.m_up;
      const unsigned pm_up = c + 1 < CPL ? pm[c + 1 < CPL ? c + 1 : c] : pm_up_l;
      const unsigned pe_up = c + 1 < CPL ? pe[c + 1 < CPL ? c + 1 : c] : pe_up_l;
      const bool is_match = (r.match >> c) & 1u;
      const bool open_e = m_up + (kGO + kGE) == r.ec[c];
      q.pe_new[c] = kIU + (open_e ? pm_up : pe_up);
      q.diag_ok[c] = r.m_prev[c] + (is_match ? kMatch : kMismatch) == r.mc[c] &&
                     (!kCol0 || j >= 1);
      q.diag_p[c] = pm[c] + (is_match ? kMU : kXU);
      nof[c] = q.diag_ok[c] ? q.diag_p[c] : q.pe_new[c];
    }
    // this row's m and count one slot left of the lane
    int m_l = __shfl_up_sync(kFull, r.mc[CPL - 1], 1, G);
    unsigned nof_l = __shfl_up_sync(kFull, nof[CPL - 1], 1, G);
    if (first) {
      m_l = kNegInf;
      nof_l = 0u;
    }
    int lk = -1024;
    q.lp = 0u;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = jl + c;
      const bool col0 = kCol0 && c == c0;
      const int m_left = c > 0 ? r.mc[c > 0 ? c - 1 : 0] : m_l;
      const unsigned nof_left = c > 0 ? nof[c > 0 ? c - 1 : 0] : nof_l;
      q.open[c] = col0 || (m_left + (kGO + kGE) == r.f[c] && (!kCol0 || j >= 1));
      q.pay[c] = col0 ? (unsigned)i * kIU : nof_left;
      if (q.open[c]) {
        lk = base + s0 + c;  // keys grow with the slot
        q.lp = q.pay[c];
      }
    }
    return lk;
  };

  // its second half, from the last open cell left of the lane: the
  // payload from the lane that holds it, then pm and pe become row i's
  auto counts_out = [&](int i, auto col0_rows, const ScoreRow<CPL>& r,
                        const CountMid<CPL>& q, int last_w) {
    constexpr bool kCol0 = decltype(col0_rows)::value;
    const int c0 = ml - base - i - s0;
    const int from = last_w >= 0 ? (last_w - base) / CPL : 0;
    unsigned last_p = __shfl_sync(kFull, q.lp, from, G);
    if (last_w < 0) last_p = 0u;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const bool col0 = kCol0 && c == c0;
      if (q.open[c]) {
        last_w = base + s0 + c;
        last_p = q.pay[c];
      }
      const unsigned pf = last_p + (unsigned)(base + s0 + c - last_w + 1) * kIU;
      unsigned v = q.diag_ok[c] ? q.diag_p[c]
                                : (r.f[c] >= r.ec[c] ? pf : q.pe_new[c]);
      if (col0) v = (unsigned)i * kIU;
      pm[c] = v;
      pe[c] = q.pe_new[c];
    }
    if (i == pl && owner) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c == fc) statv = pm[c];
    }
  };

  auto row = [&](int i, auto col0_rows, ScoreRow<CPL>& r) {
    ScoreMid<CPL> sq;
    const int tot = score_in(i, col0_rows, r, sq);
    score_out(i, col0_rows, r, sq, scan_left(tot, kNegInf));
    if (STATS) {
      CountMid<CPL> cq;
      const int lk = counts_in(i, col0_rows, r, cq);
      counts_out(i, col0_rows, r, cq, scan_left(lk, -1024));
    }
  };

  // the warp runs its longest item's rows; rows past ML - base hold no
  // column-0 slot in any of its items
  const int rows = __reduce_max_sync(kFull, pl);
  const int col0_rows = __reduce_max_sync(kFull, min(pl, ml - base));
  ScoreRow<CPL> cur;
  int i = 1;
  for (; i <= col0_rows; ++i) row(i, std::true_type{}, cur);
  if constexpr (STATS && CPL <= 2) {
    if (i <= rows) {
      constexpr std::false_type kNo{};
      ScoreMid<CPL> sq;
      score_out(i, kNo, cur, sq, scan_left(score_in(i, kNo, cur, sq),
                                           kNegInf));
      for (; i < rows; ++i) {
        ScoreRow<CPL> nxt;
        CountMid<CPL> cq;
        int tot = score_in(i + 1, kNo, nxt, sq);
        int lk = counts_in(i, kNo, cur, cq);
        scan_left2(tot, kNegInf, lk, -1024);
        score_out(i + 1, kNo, nxt, sq, tot);
        counts_out(i, kNo, cur, cq, lk);
        cur = nxt;
      }
      CountMid<CPL> cq;
      const int lk = counts_in(i, kNo, cur, cq);
      counts_out(i, kNo, cur, cq, scan_left(lk, -1024));
    }
  } else {
    for (; i <= rows; ++i) row(i, std::false_type{}, cur);
  }

  if (!active || !owner) return;
  store_item<STATS>(ref, reads, it,
                    make_int2(max(s_out, kNegInf), max((int)statv, 0)), n,
                    item, out);
}

// In order (the item sort's, order != nullptr): warps take the classes
// in bin order, each class's items 32 / G a warp in its length order.
// Without it: every item at G = 1 << lg_all, 32 / G a warp in index
// order.  Warps past the last item return; a warp's groups past it run
// an empty item.
template <int CPL, bool STATS>
__global__ void __launch_bounds__(kGroupBlock)
group_kernel(const int8_t* __restrict__ ref, const int8_t* __restrict__ reads,
             const int64_t* __restrict__ desc, const int* __restrict__ order,
             int64_t n, int ml, int kw, int lg_all, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lg = lg_all;
  int64_t k0, end = n;  // the warp's first item
  if (order != nullptr) {
    int64_t first_warp = 0;
    int q = 0, start = 0, class_end = 0;
    for (; q < kGroupClasses; ++q) {
      start = class_end;
      class_end = order[q * kLens + kLens - 1];  // the class's last bin's end
      const int64_t warps =
          (((int64_t)(class_end - start) << (kGroupClasses - 1 - q)) + 31) >> 5;
      if (warp < first_warp + warps) break;
      first_warp += warps;
    }
    if (q == kGroupClasses) return;
    lg = kGroupClasses - 1 - q;
    k0 = start + ((warp - first_warp) << q);
    end = class_end;
  } else {
    k0 = warp << (kGroupClasses - 1 - lg);
  }
  if (k0 >= end) return;  // uniform across the warp
  const int64_t k = k0 + (lane >> lg);
  const bool active = k < end;
  const int64_t item =
      !active ? 0 : (order != nullptr ? order[kGroupBins + 1 + k] : k);
  const Item it = active ? load_item(desc, n, item) : Item{0, 0, 0, 0};
  const int g = lane & ((1 << lg) - 1);
#define T1K_GROUP_CASE(LG)                                                 \
  case LG:                                                                 \
    if constexpr ((1 << LG) * CPL >= kGroupMinSlots)                       \
      group_item<CPL, 1 << LG, STATS>(ref, reads, it, active, n, item,     \
                                      ml, kw, g, out);                     \
    break;
  switch (lg) {
    T1K_GROUP_CASE(0)
    T1K_GROUP_CASE(1)
    T1K_GROUP_CASE(2)
    T1K_GROUP_CASE(3)
    T1K_GROUP_CASE(4)
    T1K_GROUP_CASE(5)
  }
#undef T1K_GROUP_CASE
}

template <int CPL>
void launch_group_cpl(const int8_t* ref, const int8_t* reads,
                      const int64_t* desc, const int* order, int64_t n, int ml,
                      int kw, int lg_all, int stats, unsigned grid,
                      int32_t* out, cudaStream_t stream) {
  constexpr int block = kGroupBlock;
  if (stats)
    group_kernel<CPL, true><<<grid, block, 0, stream>>>(
        ref, reads, desc, order, n, ml, kw, lg_all, out);
  else
    group_kernel<CPL, false><<<grid, block, 0, stream>>>(
        ref, reads, desc, order, n, ml, kw, lg_all, out);
}

// The lane-group path at CPL slots a lane: with `sort`, the class and
// length order, then one launch whose grid holds every item in the class
// of max_slots (an upper bound on every item's slots); without, one
// launch of every item at that class.
int launch_group(const int8_t* ref, const int8_t* reads, const int64_t* desc,
                 int* order, int64_t n, int ml, int kw, int stats, int cpl,
                 int max_slots, bool sort, int32_t* out, cudaStream_t stream) {
  int shift = 0;
  while ((1 << shift) < cpl) ++shift;
  if ((1 << shift) != cpl || cpl > 8 || max_slots < 1 ||
      max_slots > 32 * cpl || (sort && order == nullptr))
    return (int)cudaErrorInvalidValue;
  int lg_max = 0;
  while ((1 << lg_max) * cpl < max(max_slots, kGroupMinSlots)) ++lg_max;
  if (sort) item_order(desc, n, GroupBins{ml, kw, shift}, order, stream);
  const int64_t warps =
      ((n << lg_max) + 31) / 32 + (sort ? kGroupClasses : 0);
  const unsigned grid = (unsigned)((warps * 32 + kGroupBlock - 1) / kGroupBlock);
  const int* ord = sort ? order : nullptr;
  switch (cpl) {
    case 1: launch_group_cpl<1>(ref, reads, desc, ord, n, ml, kw, lg_max, stats, grid, out, stream); break;
    case 2: launch_group_cpl<2>(ref, reads, desc, ord, n, ml, kw, lg_max, stats, grid, out, stream); break;
    case 4: launch_group_cpl<4>(ref, reads, desc, ord, n, ml, kw, lg_max, stats, grid, out, stream); break;
    default: launch_group_cpl<8>(ref, reads, desc, ord, n, ml, kw, lg_max, stats, grid, out, stream); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// desc: int64 [4, n] rows (t_off, t_len, p_off, p_len) into the flat code
// arrays ref and reads.  out: int32 [2, n] rows (score, packed counts).
// w is the window width, one of 32, 64, 128, 256.  path: kPathThread the
// thread kernels (w = 32 only), kPathGroup the lane groups at cpl slots a
// lane (1, 2, 4 or 8; max_slots bounds every item's slots and is at most
// 32 * cpl; sort != 0 orders the items by class and length first, else
// all run at max_slots' class in index order), kPathWarp the first
// design's warp kernel.  scratch: int32
// [t1k_band_order_ints(path) + n] for the item order (the thread kernels
// and the sorted group launch).  Returns the launches'
// cudaGetLastError().
constexpr int kPathWarp = 0;
constexpr int kPathThread = 1;
constexpr int kPathGroup = 2;

extern "C" int t1k_band_order_ints(int path) {
  return (path == kPathGroup ? kGroupBins : kBins) + 1;
}

extern "C" int t1k_band_stats(const void* ref, const void* reads,
                              const void* desc, int64_t n, int ml, int w,
                              int stats, int path, int cpl, int max_slots,
                              int sort, void* scratch, void* out,
                              void* stream) {
  const auto* r = static_cast<const int8_t*>(ref);
  const auto* q = static_cast<const int8_t*>(reads);
  const auto* d = static_cast<const int64_t*>(desc);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (w != 32 && w != 64 && w != 128 && w != 256)
    return (int)cudaErrorInvalidValue;
  if (path == kPathThread) {
    if (w != kW || scratch == nullptr) return (int)cudaErrorInvalidValue;
    return launch_thread(r, q, d, static_cast<int*>(scratch), n, ml, stats,
                         o, s);
  }
  if (path == kPathGroup)
    return launch_group(r, q, d, static_cast<int*>(scratch), n, ml, w, stats,
                        cpl, max_slots, sort != 0, o, s);
  if (path != kPathWarp) return (int)cudaErrorInvalidValue;
  switch (w) {
    case 32: launch_warp<1>(r, q, d, n, ml, stats, o, s); break;
    case 64: launch_warp<2>(r, q, d, n, ml, stats, o, s); break;
    case 128: launch_warp<4>(r, q, d, n, ml, stats, o, s); break;
    default: launch_warp<8>(r, q, d, n, ml, stats, o, s); break;
  }
  return (int)cudaGetLastError();
}
