// Phase-A chain state machine on a dense [NR, B] seed tile.
//
// Replaces t1k_tpu/ops/phase_a.py::_chain_rows (the XLA program reached
// through _chain_kernel, the extraction screen, and _cand_tile_kernel).
// Row r holds one (read, strand, seq) bucket: a = read offsets, b = seq
// offsets, the first nb[r] columns valid, in any order.  Per row it
// computes the reference's chain filters (engine.cc BuildOverlaps,
// SeqSet.hpp:1232-1592):
//
//   1. sort the seeds by (diagonal c = a - b, b, a);
//   2. split segments at diagonal gaps > radius; per segment the dominant
//      diagonal is the first maximal run of equal c;
//   3. offsetBest: per (segment, a) keep the seeds nearest the dominant
//      diagonal (all ties);
//   4. sort the kept seeds by (segment, b, a) and run the reference's
//      patience LIS on a per segment: equal tails never replace, the
//      chain is the backtrack from the last top;
//   5. drop chain seeds whose b repeats the previous chosen seed's, and
//      count TotalSpan on both axes with gap breaks > k-1;
//   6. a segment passes the core tests when size >= 3, size*k, lis*k,
//      span_a and span_b all reach hit_len_required, and the budget test
//      when len - span_a <= budget.
//
// Output int32 [2, NR]: row 0 = some segment passes core and budget (the
// screen's HasHitInSet verdict), row 1 = some segment passes core (the
// bucket emits an overlap in the assignment path).
//
// A second entry, bucket_kernel, runs the same state machine (chain_row)
// for K10 (t1k_tpu/ops/phase_a.py::_cand_tile_kernel): one warp per
// bucket of cand_census.cu's arena, reading the bucket's seeds where the
// census wrote them, so no dense tile is built; a persistent grid walks
// the buckets up to the count the census left on the card.
//
// What bounds it on an H100: the bytes are tiny (8 bytes per seed in, 8
// per row out) and the operations few (three sorts of nb keys and linear
// passes), so the time is latency: the dependent steps of the widest row,
// since all rows of a chunk run at once.  Rows are narrow: of a 1024-read
// chunk of the extraction's inputs, 725 rows were empty and the widest
// held 63 seeds of the 512 columns.  The design: one warp per row, four
// rows per block, synchronised with __syncwarp only.  The three
// lexicographic sorts are bitonic sorts of packed int64 keys (a < 2^12,
// b < 2^20, |c| < 2^21, segment < 2^10): unrolled in registers with
// shuffles for rows up to 128 seeds, in the warp's own shared-memory
// slice for wider rows (up to 512).  Segments and runs come from ballots and
// warp max-scans, per-segment tallies from shared-memory atomics.  The
// patience LIS stays sequential over the seeds.  Up to 128 kept seeds it
// runs in registers (lis_regs): a step is a broadcast, a few ballots and
// predicated updates, the backtrack a chain of shuffles, and the
// duplicate-b collapse and spans are computed for all seeds at once from
// bit masks.  Wider rows keep the tops in shared memory (lis_shared).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 512;
constexpr int kWarps = 4;           // rows per block
constexpr int kMinHitRequired = 3;  // SeqSet.hpp minHitRequired
constexpr long long kBig = LLONG_MAX;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_max_scan(int v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = max(v, u);
  }
  return v;
}

// A row of up to 32*E seeds in registers: seed i = e*32 + lane lives in
// lane `lane`, register e.

// Ascending bitonic sort of 32*E keys in registers.
template <int E>
__device__ __forceinline__ void sort_regs(long long (&x)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {  // the pairs (e, e + stride/32) within a lane
        const int es = stride / 32;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & es) continue;
          const bool up = ((e * 32 + lane) & size) == 0;
          const long long lo = min(x[e], x[e | es]);
          const long long hi = max(x[e], x[e | es]);
          x[e] = up ? lo : hi;
          x[e | es] = up ? hi : lo;
        }
        continue;
      }
      // the lower element of a pair keeps the minimum on an ascending
      // run; the pair's direction is that of its size-block
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long long y = __shfl_xor_sync(kFull, x[e], stride);
        x[e] = (lower == (((e * 32 + lane) & size) == 0)) ? min(x[e], y)
                                                          : max(x[e], y);
      }
    }
  }
}

template <int E>
__device__ void sort_in_regs(long long* key, int n, int lane) {
  long long x[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    x[e] = e * 32 + lane < n ? key[e * 32 + lane] : kBig;
  sort_regs<E>(x, lane);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e * 32 + lane < n) key[e * 32 + lane] = x[e];
}

// Ascending bitonic sort of key[0, n), 128 < n <= capacity, in shared
// memory; each lane handles pairs p = lane, lane + 32, ...
__device__ void sort_shared(long long* key, int n, int lane) {
  int N = 256;
  while (N < n) N <<= 1;
  for (int i = n + lane; i < N; i += 32) key[i] = kBig;
  __syncwarp();
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = lane; p < N / 2; p += 32) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const long long x = key[i], y = key[j];
        if ((x > y) == up) {
          key[i] = y;
          key[j] = x;
        }
      }
      __syncwarp();
    }
  }
}

// Ascending sort of key[0, n) by the warp: in registers up to 128 keys,
// in shared memory above.
__device__ void warp_sort(long long* key, int n, int lane) {
  __syncwarp();
  if (n <= 1) return;
  if (n <= 32) sort_in_regs<1>(key, n, lane);
  else if (n <= 64) sort_in_regs<2>(key, n, lane);
  else if (n <= 128) sort_in_regs<4>(key, n, lane);
  else sort_shared(key, n, lane);
  __syncwarp();
}

// x[idx] for a warp-uniform or per-lane register index.
template <int E, typename T>
__device__ __forceinline__ T pick(const T (&x)[E], int idx) {
  T r = x[0];
#pragma unroll
  for (int e = 1; e < E; ++e) r = idx == e ? x[e] : r;
  return r;
}

// Seed j's value of a register row, for a per-lane j (any j < 0 gives
// seed 31's, which callers ignore).
template <int E>
__device__ __forceinline__ int fetch(const int (&x)[E], int j) {
  int y[E];
#pragma unroll
  for (int e = 0; e < E; ++e) y[e] = __shfl_sync(kFull, x[e], j & 31);
  return pick<E>(y, j >> 5);
}

// The highest set bit of a 32*E-bit mask in [lo, hi), or -1.
template <int E>
__device__ __forceinline__ int highest_in(const unsigned (&m)[E], int lo,
                                          int hi) {
  int r = -1;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int l = lo - e * 32, h = hi - e * 32;
    unsigned w = m[e];
    if (h < 32) w = h > 0 ? w & ((1u << h) - 1u) : 0u;
    if (l > 0) w = l < 32 ? w & ~((1u << l) - 1u) : 0u;
    if (w) r = e * 32 + 31 - __clz(w);
  }
  return r;
}

// The core and budget tests of one segment.
__device__ __forceinline__ void segment_tests(long long sz, long long lis,
                                              long long span_a,
                                              long long span_b, int k,
                                              int hlr, int len, int budget,
                                              int& core, int& verdict) {
  core = sz >= kMinHitRequired && sz * k >= hlr && lis * k >= hlr &&
         span_a >= hlr && span_b >= hlr;
  verdict = core && (long long)len - span_a <= budget;
}

// Steps 4-6 for rows of at most 32*E kept seeds, key[0, nk) in (segment,
// b, a) order, held in registers.  The patience LIS keeps its tops in
// registers too (top j where seed j would be): a step is a broadcast of
// the seed's a, E + 1 votes and predicated updates, with no branch on a
// lane.  At a segment's end the warp walks its chain back through the
// link registers with shuffles, marking the chosen mask; after the last
// segment every seed finds its previous chosen and previous kept seed in
// its segment from the masks, and the span terms go to per-segment
// tallies in shared memory (acc, 3 x nseg, zeroed here).
template <int E>
__device__ void lis_regs(const long long* key, int nk, int nseg,
                         const int* seg_sz, int* acc, int k, int hlr,
                         int len, int budget, int lane, int& verdict,
                         int& core_any) {
  int a[E], b[E], sg[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long kk = e * 32 + lane < nk ? key[e * 32 + lane] : kBig;
    a[e] = (int)(kk & 0xFFF);
    b[e] = (int)((kk >> 12) & 0xFFFFF);
    sg[e] = (int)(kk >> 32);
  }
  for (int j = lane; j < 3 * nseg; j += 32) acc[j] = 0;
  unsigned S[E];  // segment starts
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int carry = __shfl_sync(kFull, sg[e > 0 ? e - 1 : 0], 31);
    int prev = __shfl_up_sync(kFull, sg[e], 1);
    prev = lane == 0 ? (e > 0 ? carry : -1) : prev;
    S[e] = __ballot_sync(kFull, e * 32 + lane < nk && sg[e] != prev);
  }

  unsigned END[E];  // the last seed of each segment
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    const int first_next = __shfl_sync(kFull, sg[e + 1 < E ? e + 1 : e], 0);
    int next = __shfl_down_sync(kFull, sg[e], 1);
    next = lane == 31 ? first_next : next;
    END[e] = __ballot_sync(kFull, i < nk && (i + 1 == nk || next != sg[e]));
  }

  int tv[E], ti[E], link[E];  // tops and links, where seed j would be
  unsigned M[E];              // the chosen seeds
#pragma unroll
  for (int e = 0; e < E; ++e) {
    tv[e] = INT_MAX;
    ti[e] = -1;
    link[e] = -1;
    M[e] = 0;
  }
  // In-order issue: each step's broadcast of the next seed's a and its
  // own link shuffle are consumed one step later, so their latency hides
  // behind the ballots.
  int ntop = 0;
  int v = __shfl_sync(kFull, a[0], 0);
  int link_t = -1, link_top = 0;  // the previous step's link, pending
  bool link_set = false;
  for (int t = 0; t < nk; ++t) {
    const int tn = t + 1 < nk ? t + 1 : t;
    const int v_next = __shfl_sync(kFull, pick<E>(a, tn >> 5), tn & 31);
#pragma unroll
    for (int e = 0; e < E; ++e)  // the pending link of step t - 1
      link[e] = link_set && e == (link_t >> 5) && lane == (link_t & 31)
                    ? link_top : link[e];
    int lo = 0;
    unsigned eqm = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      lo += __popc(__ballot_sync(kFull, tv[e] < v));
      eqm |= tv[e] == v ? 1u : 0u;
    }
    const bool eq = __any_sync(kFull, eqm);  // equal tails never replace
    const int li = max(lo - 1, 0);
    link_top = __shfl_sync(kFull, pick<E>(ti, li >> 5), li & 31);
    link_t = t;
    link_set = !eq && lo > 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool put = !eq && e == (lo >> 5) && lane == (lo & 31);
      tv[e] = put ? v : tv[e];
      ti[e] = put ? t : ti[e];
    }
    ntop += !eq && lo == ntop;
    v = v_next;
    if ((pick<E>(END, t >> 5) >> (t & 31)) & 1u) {
      // the segment ends at t: settle the pending link, mark the chain
      // from the last top, reset the tops
#pragma unroll
      for (int e = 0; e < E; ++e)
        link[e] = link_set && e == (t >> 5) && lane == (t & 31) ? link_top
                                                                 : link[e];
      link_set = false;
      const int end = ntop - 1;
      int p = __shfl_sync(kFull, pick<E>(ti, end >> 5), end & 31);
      while (p >= 0) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          M[e] |= e == (p >> 5) ? 1u << (p & 31) : 0u;
        p = __shfl_sync(kFull, pick<E>(link, p >> 5), p & 31);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        tv[e] = INT_MAX;
        ti[e] = -1;
      }
      ntop = 0;
    }
  }
  __syncwarp();  // acc zeroed

  // duplicate-b collapse and TotalSpan, every seed at once
  int start[E];
  bool kept[E];
  unsigned K[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    start[e] = highest_in<E>(S, 0, i + 1);  // this seed's segment start
    const int j = highest_in<E>(M, start[e], i);
    const int bj = fetch<E>(b, j);
    kept[e] = i < nk && ((M[e] >> lane) & 1) && !(j >= 0 && bj == b[e]);
    K[e] = __ballot_sync(kFull, kept[e]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = highest_in<E>(K, start[e], e * 32 + lane);
    const int ka = fetch<E>(a, j), kb = fetch<E>(b, j);
    if (kept[e]) {
      atomicAdd(&acc[sg[e]], j < 0 || a[e] - ka > k - 1 ? k : a[e] - ka);
      atomicAdd(&acc[nseg + sg[e]],
                j < 0 || b[e] - kb > k - 1 ? k : b[e] - kb);
      atomicAdd(&acc[2 * nseg + sg[e]], 1);
    }
  }
  __syncwarp();
  int v_any = 0, c_any = 0;
  for (int s = lane; s < nseg; s += 32) {
    int core, ver;
    segment_tests(seg_sz[s], acc[2 * nseg + s], acc[s], acc[nseg + s], k,
                  hlr, len, budget, core, ver);
    c_any |= core;
    v_any |= ver;
  }
  verdict = __any_sync(kFull, v_any);
  core_any = __any_sync(kFull, c_any);
}

// Steps 4-6 for rows of more than 128 kept seeds, key[0, nk) in
// (segment, b, a) order: the LIS tops in shared memory, each step one
// ballot over them (they ascend strictly, so the count below v is the
// insertion point); at each segment's end lane 0 backtracks its chain
// (into top_v, free by then) and counts it.  The verdicts are lane 0's.
__device__ void lis_shared(const long long* key, int nk, const int* seg_sz,
                           int* link, int* top_v, int* top_i, int k, int hlr,
                           int len, int budget, int lane, int& verdict,
                           int& core_any) {
  int ntop = 0;
  long long cur = nk > 0 ? key[0] : kBig;
  for (int t = 0; t < nk; ++t) {
    const long long nxt = t + 1 < nk ? key[t + 1] : kBig;
    const int seg = (int)(cur >> 32);
    const int v = (int)(cur & 0xFFF);
    int lo = 0;
    bool eq = false;
    for (int base = 0; base < ntop; base += 32) {
      const int tv = base + lane < ntop ? top_v[base + lane] : INT_MAX;
      lo += __popc(__ballot_sync(kFull, tv < v));
      eq |= __ballot_sync(kFull, tv == v) != 0;
    }
    if (lane == 0) {  // equal tails never replace
      link[t] = !eq && lo > 0 ? top_i[lo - 1] : -1;
      if (!eq) {
        top_v[lo] = v;
        top_i[lo] = t;
      }
    }
    if (!eq && lo == ntop) ++ntop;
    __syncwarp();
    if ((int)(nxt >> 32) != seg || t + 1 == nk) {
      if (lane == 0) {
        int plen = 0;
        for (int p = top_i[ntop - 1]; p >= 0; p = link[p]) top_v[plen++] = p;
        bool has_chosen = false, has_kept = false;
        int chosen_b = 0, ka = 0, kb = 0;
        long long span_a = 0, span_b = 0, lis = 0;
        for (int j = plen - 1; j >= 0; --j) {  // the chain in seed order
          const long long kk = key[top_v[j]];
          const int a = (int)(kk & 0xFFF);
          const int b = (int)((kk >> 12) & 0xFFFFF);
          const bool kept = !(has_chosen && chosen_b == b);
          has_chosen = true;
          chosen_b = b;
          if (!kept) continue;
          if (!has_kept) {
            span_a += k;
            span_b += k;
          } else {
            span_a += a - ka > k - 1 ? k : a - ka;
            span_b += b - kb > k - 1 ? k : b - kb;
          }
          has_kept = true;
          ka = a;
          kb = b;
          ++lis;
        }
        int core, ver;
        segment_tests(seg_sz[seg], lis, span_a, span_b, k, hlr, len, budget,
                      core, ver);
        core_any |= core;
        verdict |= ver;
      }
      ntop = 0;
      __syncwarp();
    }
    cur = nxt;
  }
}

// The chain state machine of one bucket, run by one warp: seeds ar[0, n)
// and br[0, n), in any order; the warp's shared-memory slice `key` holds
// 3 x cap int64 (cap >= n, a power of two).  Sets verdict (some segment
// passes the core and budget tests) and core_any (some segment passes
// the core tests) on every lane.
__device__ __forceinline__ void chain_row(const int32_t* __restrict__ ar,
                                          const int32_t* __restrict__ br,
                                          int n, int len, int budget, int k,
                                          int radius, int hlr, int cap,
                                          long long* key, int lane,
                                          int& verdict, int& core_any) {
  // the slice: int64 keys, then four int32 arrays of `cap`
  int* link = reinterpret_cast<int*>(key + cap);  // segment of a seed,
                                                  // then the LIS links
  int* top_v = link + cap;   // dominant run per segment, then LIS tops
  int* top_i = top_v + cap;  // LIS tops' seed indices
  int* seg_sz = top_i + cap;

  // ---- 1. diagonal sort: (c, b, a) ascending
  for (int i = lane; i < n; i += 32) {
    const long long a = ar[i], b = br[i];
    key[i] = ((a - b + (1 << 20)) << 32) | (b << 12) | a;
    top_v[i] = 0;
    seg_sz[i] = 0;
  }
  warp_sort(key, n, lane);

  // ---- 2. segments, runs, each segment's size and dominant run
  int nseg = 0, carry_c = 0, carry_rf = -1;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool valid = i < n;
    const int c = valid ? (int)((key[i] >> 32) - (1 << 20)) : 0;
    int c_prev = __shfl_up_sync(kFull, c, 1);
    if (lane == 0) c_prev = carry_c;
    const bool newseg = valid && (i == 0 || c - c_prev > radius);
    const bool newrun = valid && (newseg || c != c_prev);
    const unsigned segs = __ballot_sync(kFull, newseg);
    const int seg = nseg + __popc(segs & ((2u << lane) - 1u)) - 1;
    // the run's first index; a run's longest prefix is the run itself,
    // so the maximum over its seeds of (length so far, -first) packs the
    // first maximal run of the segment
    const int rf = max(warp_max_scan(newrun ? i : -1, lane), carry_rf);
    if (valid) {
      atomicMax(&top_v[seg], ((i - rf + 1) << 10) | (1023 - rf));
      atomicAdd(&seg_sz[seg], 1);
      link[i] = seg;
    }
    nseg += __popc(segs);
    carry_c = __shfl_sync(kFull, c, 31);
    carry_rf = __shfl_sync(kFull, rf, 31);
  }
  __syncwarp();
  for (int s = lane; s < nseg; s += 32)
    top_v[s] = (int)((key[1023 - (top_v[s] & 1023)] >> 32) - (1 << 20));
  __syncwarp();

  // ---- 3. offsetBest keys (segment, a, d, b); radius 0 keeps every
  // seed and goes straight to the (segment, b, a) keys
  for (int i = lane; i < n; i += 32) {
    const long long kk = key[i];
    const long long c = (kk >> 32) - (1 << 20);
    const long long b = (kk >> 12) & 0xFFFFF, a = kk & 0xFFF;
    const long long seg = link[i];
    key[i] = radius > 0
        ? (seg << 53) | (a << 41) | ((c > top_v[seg] ? c - top_v[seg]
                                                      : top_v[seg] - c)
                                     << 20) | b
        : (seg << 32) | (b << 12) | a;
  }
  if (radius > 0) {
    warp_sort(key, n, lane);
    // per (segment, a) group keep the seeds at the group's least d
    int carry_seg = -1, carry_a = -1, carry_first = -1;
    long long carry_gd = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool valid = i < n;
      const long long kk = valid ? key[i] : 0;
      const int seg = (int)(kk >> 53);
      const int a = (int)((kk >> 41) & 0xFFF);
      const long long d = (kk >> 20) & 0x1FFFFF;
      const long long b = kk & 0xFFFFF;
      int seg_prev = __shfl_up_sync(kFull, seg, 1);
      int a_prev = __shfl_up_sync(kFull, a, 1);
      if (lane == 0) {
        seg_prev = carry_seg;
        a_prev = carry_a;
      }
      const bool gstart = valid && (seg != seg_prev || a != a_prev);
      const int first = max(warp_max_scan(gstart ? i : -1, lane), carry_first);
      const long long d_first = __shfl_sync(kFull, d, max(first - base, 0));
      const long long gd = first >= base ? d_first : carry_gd;
      if (valid)
        key[i] = d == gd ? ((long long)seg << 32) | (b << 12) | a : kBig;
      carry_seg = __shfl_sync(kFull, seg, 31);
      carry_a = __shfl_sync(kFull, a, 31);
      carry_first = __shfl_sync(kFull, first, 31);
      carry_gd = __shfl_sync(kFull, gd, 31);
    }
  }
  // ---- 4. (segment, b, a) order of the kept seeds
  warp_sort(key, n, lane);
  int nk = 0;
  for (int base = 0; base < n; base += 32)
    nk += __popc(__ballot_sync(kFull, base + lane < n &&
                                          key[base + lane] != kBig));

  verdict = 0;
  core_any = 0;
  if (nk <= 32) {
    lis_regs<1>(key, nk, nseg, seg_sz, link, k, hlr, len, budget, lane,
                verdict, core_any);
  } else if (nk <= 64) {
    lis_regs<2>(key, nk, nseg, seg_sz, link, k, hlr, len, budget, lane,
                verdict, core_any);
  } else if (nk <= 128) {
    lis_regs<4>(key, nk, nseg, seg_sz, link, k, hlr, len, budget, lane,
                verdict, core_any);
  } else {
    lis_shared(key, nk, seg_sz, link, top_v, top_i, k, hlr, len, budget,
               lane, verdict, core_any);
  }
}

// The dense entry: row r of a [NR, B] tile, one warp a row.
__global__ void __launch_bounds__(kWarps * 32)
chain_kernel(const int32_t* __restrict__ a_in,
             const int32_t* __restrict__ b_in,
             const int32_t* __restrict__ nb_in,
             const int32_t* __restrict__ lens,
             const int32_t* __restrict__ budgets, int B, int cap, int k,
             int radius, int hlr, int NR, int32_t* __restrict__ out) {
  extern __shared__ long long smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= NR) return;  // whole warps leave together
  int verdict, core_any;
  chain_row(a_in + (int64_t)row * B, b_in + (int64_t)row * B,
            min(max(nb_in[row], 0), B), lens[row], budgets[row], k, radius,
            hlr, cap, smem + (size_t)warp * 3 * cap, lane, verdict,
            core_any);
  if (lane == 0) {
    out[row] = verdict;
    out[NR + row] = core_any;
  }
}

// The bucket-ragged entry (K10's chain, replacing _cand_tile_kernel's
// dense tiles): bucket g < *nb_total holds the seeds a[first[g],
// first[g] + count[g]) of read key[g] / NG.  A persistent grid of warps
// walks the buckets; a bucket of min_seeds to bucket_cap seeds is
// chained with a zero budget straight from the arena and keep[g] is its
// core verdict; a smaller one gets keep 0 unchained, a larger one keep 0
// and one more count in over[read] (its read is undecided).
__global__ void __launch_bounds__(kWarps * 32)
bucket_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              const int32_t* __restrict__ key,
              const int32_t* __restrict__ first,
              const int32_t* __restrict__ count,
              const int32_t* __restrict__ nb_total,
              const int32_t* __restrict__ lens, int NG, int min_seeds,
              int bucket_cap, int cap, int k, int radius, int hlr,
              int32_t* __restrict__ keep, int32_t* __restrict__ over) {
  extern __shared__ long long smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  long long* slice = smem + (size_t)warp * 3 * cap;
  const int nb = *nb_total;
  for (int g = blockIdx.x * kWarps + warp; g < nb;
       g += gridDim.x * kWarps) {
    const int n = count[g];
    const int read = key[g] / NG;
    if (n < min_seeds || n > bucket_cap) {
      if (lane == 0) {
        keep[g] = 0;
        if (n > bucket_cap) atomicAdd(&over[read], 1);
      }
      continue;
    }
    int verdict, core_any;
    chain_row(a + first[g], b + first[g], n, lens[read], 0, k, radius, hlr,
              cap, slice, lane, verdict, core_any);
    if (lane == 0) keep[g] = core_any;
    __syncwarp();  // the slice is the next bucket's
  }
}

}  // namespace

// a, b: int32 [NR, B] seed tiles; nb, lens, budgets: int32 [NR].  out:
// int32 [2, NR].  B <= 512.  Returns the launch's cudaGetLastError().
extern "C" int t1k_phase_a_chain(const void* a, const void* b, const void* nb,
                                 const void* lens, const void* budgets, int NR,
                                 int B, int k, int radius, int hlr, void* out,
                                 void* stream) {
  if (NR <= 0) return 0;
  if (B < 1 || B > kMaxB) return (int)cudaErrorInvalidValue;
  int cap = 32;  // a warp's slice holds the widest row, a power of two
  while (cap < B) cap <<= 1;
  const size_t smem = (size_t)kWarps * 3 * cap * sizeof(long long);  // <= 48 KB
  const unsigned grid = (unsigned)((NR + kWarps - 1) / kWarps);
  chain_kernel<<<grid, kWarps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(nb), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(budgets), B, cap, k, radius, hlr, NR,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// K10's chain over a census: a, b int32 arena; key, first, count int32
// [>= nb_total]; nb_total int32 [1] on the card; lens int32 [R].  keep:
// int32 [>= nb_total], over: int32 [R], zeroed by the caller.
// bucket_cap <= 512.  Returns the launch's cudaGetLastError().
extern "C" int t1k_phase_a_chain_buckets(
    const void* a, const void* b, const void* key, const void* first,
    const void* count, const void* nb_total, const void* lens, int NG,
    int min_seeds, int bucket_cap, int k, int radius, int hlr, void* keep,
    void* over, void* stream) {
  if (bucket_cap < 1 || bucket_cap > kMaxB || NG < 1)
    return (int)cudaErrorInvalidValue;
  int cap = 32;
  while (cap < bucket_cap) cap <<= 1;
  const size_t smem = (size_t)kWarps * 3 * cap * sizeof(long long);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_kernel,
                                                kWarps * 32, smem);
  const unsigned grid = (unsigned)(sms * (per_sm > 0 ? per_sm : 1));
  bucket_kernel<<<grid, kWarps * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(first),
      static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(nb_total),
      static_cast<const int32_t*>(lens), NG, min_seeds, bucket_cap, cap, k,
      radius, hlr, static_cast<int32_t*>(keep), static_cast<int32_t*>(over));
  return (int)cudaGetLastError();
}
