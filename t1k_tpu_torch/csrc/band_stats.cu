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
// Design: one warp per item, the band window on the lanes.  The DP state
// of row i lives in window coordinates w = j - i + ML; lane l holds the CPL
// consecutive cells w = l*CPL .. l*CPL + CPL-1, so W = 32*CPL.  Each warp
// reads its own descriptor (t_off, t_len, p_off, p_len), its text bases
// straight from the resident reference and its pattern base from the
// resident read tensor, and loops over its own p_len rows.  The vertical
// move is a __shfl_down_sync by one cell, the diagonal needs no shift, the
// horizontal gap chain is a warp prefix max (__shfl_up_sync, 5 steps), and
// the delete-run count is a (key, payload) copy scan with the same shuffle
// pattern.  No window tensors are materialised in device memory.
//
// What bounds it on an H100: integer ALU work and shuffle latency per row
// (about 20 dependent shuffles a row with stats), not bytes - an item reads
// t_len + p_len bytes and writes 8.  Items run independently, so the card
// is filled by item count; a chunk of the engine carries thousands.

#include <cstdint>
#include <climits>
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
band_kernel(const int8_t* __restrict__ ref, const int8_t* __restrict__ reads,
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
void launch(const int8_t* ref, const int8_t* reads, const int64_t* desc,
            int64_t n, int ml, int stats, int32_t* out, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  if (stats)
    band_kernel<CPL, true><<<grid, block, 0, stream>>>(ref, reads, desc, n,
                                                       ml, out);
  else
    band_kernel<CPL, false><<<grid, block, 0, stream>>>(ref, reads, desc, n,
                                                        ml, out);
}

}  // namespace

// desc: int64 [4, n] rows (t_off, t_len, p_off, p_len) into the flat code
// arrays ref and reads.  out: int32 [2, n] rows (score, packed counts).
// w is the window width, one of 32, 64, 128, 256.  Returns the launch's
// cudaGetLastError().
extern "C" int t1k_band_stats(const void* ref, const void* reads,
                              const void* desc, int64_t n, int ml, int w,
                              int stats, void* out, void* stream) {
  const auto* r = static_cast<const int8_t*>(ref);
  const auto* q = static_cast<const int8_t*>(reads);
  const auto* d = static_cast<const int64_t*>(desc);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (w) {
    case 32: launch<1>(r, q, d, n, ml, stats, o, s); break;
    case 64: launch<2>(r, q, d, n, ml, stats, o, s); break;
    case 128: launch<4>(r, q, d, n, ml, stats, o, s); break;
    case 256: launch<8>(r, q, d, n, ml, stats, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
