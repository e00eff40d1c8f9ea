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
// bucket emits an overlap in the assignment path).  The tile interface is
// the one DeviceCandidates' tile kernel needs as well.
//
// Design: one block of 128 threads per row.  The three lexicographic
// sorts are bitonic sorts of packed int64 keys in shared memory (a < 2^12,
// b < 2^20, |c| < 2^21, segment < 2^10; B <= 512).  Everything between
// them is a sequential pass over at most B seeds on one thread: segment
// and run bookkeeping, the group minimum, the LIS (binary search over the
// tops), the backtrack and the span counts.  What bounds it on an H100:
// the sorts' barrier steps and the sequential passes' shared-memory
// latency, O(nb log nb) per row; a row reads 8*nb bytes and writes 8.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 512;
constexpr int kThreads = 128;
constexpr int kMinHitRequired = 3;  // SeqSet.hpp minHitRequired
constexpr long long kBig = LLONG_MAX;

__device__ void bitonic_sort(long long* key, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const long long x = key[i], y = key[j];
          if ((x > y) == up) {
            key[i] = y;
            key[j] = x;
          }
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(const int32_t* __restrict__ a_in, const int32_t* __restrict__ b_in,
             const int32_t* __restrict__ nb_in,
             const int32_t* __restrict__ lens,
             const int32_t* __restrict__ budgets, int B, int k, int radius,
             int hlr, int NR, int32_t* __restrict__ out) {
  __shared__ long long key[kMaxB];
  __shared__ int sa[kMaxB], sb[kMaxB], sc[kMaxB], sseg[kMaxB];
  __shared__ int link[kMaxB], top_v[kMaxB], top_i[kMaxB];
  __shared__ unsigned char chosen[kMaxB];
  __shared__ int dom_c[kMaxB], seg_sz[kMaxB];
  __shared__ int s_nkeep;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nb = min(max(nb_in[row], 0), B);
  int n = 1;
  while (n < nb) n <<= 1;

  // ---- 1. diagonal sort: (c, b, a) ascending
  for (int i = tid; i < n; i += blockDim.x) {
    if (i < nb) {
      const long long a = a_in[(int64_t)row * B + i];
      const long long b = b_in[(int64_t)row * B + i];
      key[i] = ((a - b + (1 << 20)) << 32) | (b << 12) | a;
    } else {
      key[i] = kBig;
    }
  }
  bitonic_sort(key, n);

  // ---- 2. segments and dominant diagonals (one thread)
  if (tid == 0) {
    int seg = -1, run_start = 0, best = 0;
    for (int i = 0; i < nb; ++i) {
      const long long kk = key[i];
      const int c = (int)((kk >> 32) - (1 << 20));
      sc[i] = c;
      sb[i] = (int)((kk >> 12) & 0xFFFFF);
      sa[i] = (int)(kk & 0xFFF);
      const bool newseg = i == 0 || c - sc[i - 1] > radius;
      const bool newrun = newseg || c != sc[i - 1];
      if (newrun && i > 0 && i - run_start > best) {  // close the run
        best = i - run_start;
        dom_c[seg] = sc[run_start];
      }
      if (newseg) {
        ++seg;
        seg_sz[seg] = 0;
        best = 0;
      }
      if (newrun) run_start = i;
      sseg[i] = seg;
      ++seg_sz[seg];
    }
    if (nb > 0 && nb - run_start > best) dom_c[seg] = sc[run_start];
    // ---- 3. offsetBest keys: (segment, a, d) with b carried
    for (int i = 0; i < n; ++i) {
      if (i < nb && radius > 0) {
        const long long d = abs(sc[i] - dom_c[sseg[i]]);
        key[i] = ((long long)sseg[i] << 53) | ((long long)sa[i] << 41) |
                 (d << 20) | sb[i];
      } else if (i < nb) {  // radius 0 keeps every seed
        key[i] = ((long long)sseg[i] << 32) | ((long long)sb[i] << 12) | sa[i];
      } else {
        key[i] = kBig;
      }
    }
  }
  if (radius > 0) {
    bitonic_sort(key, n);
    if (tid == 0) {
      int g_seg = -1, g_a = -1;
      long long g_d = 0;
      for (int i = 0; i < nb; ++i) {
        const long long kk = key[i];
        const int seg = (int)(kk >> 53);
        const int a = (int)((kk >> 41) & 0xFFF);
        const long long d = (kk >> 20) & 0x1FFFFF;
        const int b = (int)(kk & 0xFFFFF);
        if (seg != g_seg || a != g_a) {  // group start carries min d
          g_seg = seg;
          g_a = a;
          g_d = d;
        }
        key[i] = d == g_d ? ((long long)seg << 32) | ((long long)b << 12) | a
                          : kBig;
      }
    }
  }
  // ---- 4. (segment, b, a) order of the kept seeds
  bitonic_sort(key, n);

  if (tid == 0) {
    int nk = 0;
    while (nk < nb && key[nk] != kBig) {
      const long long kk = key[nk];
      sseg[nk] = (int)(kk >> 32);
      sb[nk] = (int)((kk >> 12) & 0xFFFFF);
      sa[nk] = (int)(kk & 0xFFF);
      chosen[nk] = 0;
      ++nk;
    }
    s_nkeep = nk;
    const int len = lens[row];
    const int budget = budgets[row];
    int verdict = 0, core_any = 0;
    int s0 = 0;
    while (s0 < nk) {  // one segment [s0, s1)
      const int seg = sseg[s0];
      int s1 = s0;
      while (s1 < nk && sseg[s1] == seg) ++s1;
      // patience LIS over a
      int ntop = 0;
      for (int t = s0; t < s1; ++t) {
        const int v = sa[t];
        int lo = 0, hi = ntop;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (top_v[mid] < v) lo = mid + 1; else hi = mid;
        }
        link[t] = -1;
        if (lo < ntop && top_v[lo] == v) continue;  // equal tails never replace
        if (lo > 0) link[t] = top_i[lo - 1];
        top_v[lo] = v;
        top_i[lo] = t;
        if (lo == ntop) ++ntop;
      }
      for (int p = ntop > 0 ? top_i[ntop - 1] : -1; p >= 0; p = link[p])
        chosen[p] = 1;
      // duplicate-b collapse and TotalSpan with gap breaks > k-1
      bool has_chosen = false, has_kept = false;
      int chosen_b = 0, ka = 0, kb = 0;
      long long span_a = 0, span_b = 0, lis = 0;
      for (int t = s0; t < s1; ++t) {
        if (!chosen[t]) continue;
        const bool kept = !(has_chosen && chosen_b == sb[t]);
        has_chosen = true;
        chosen_b = sb[t];
        if (!kept) continue;
        if (!has_kept) {
          span_a += k;
          span_b += k;
        } else {
          span_a += sa[t] - ka > k - 1 ? k : sa[t] - ka;
          span_b += sb[t] - kb > k - 1 ? k : sb[t] - kb;
        }
        has_kept = true;
        ka = sa[t];
        kb = sb[t];
        ++lis;
      }
      const long long sz = seg_sz[seg];
      const bool core = sz >= kMinHitRequired && sz * k >= hlr &&
                        lis * k >= hlr && span_a >= hlr && span_b >= hlr;
      core_any |= core;
      verdict |= core && (long long)len - span_a <= budget;
      s0 = s1;
    }
    out[row] = verdict;
    out[NR + row] = core_any;
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
  chain_kernel<<<NR, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(nb), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(budgets), B, k, radius, hlr, NR,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
