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
// and column 0 of a row ever hold anything but NEG_INF, so this kernel
// computes the band alone:
//
//   * one warp per pair, looping over its own p_len read rows (rows past
//     p_len are frozen in the TPU kernel, so they are simply not run);
//   * the band of row i in chunks of 32 columns, one column per lane;
//   * rows i-1 and i of m and e in a ring of `ring` cells per warp in
//     shared memory, indexed by column & (ring-1); a read outside the
//     previous row's band is NEG_INF, row 0 is its closed form;
//   * the deletion chain as a warp prefix max (__shfl_up_sync, 5 steps)
//     seeded with the carry of everything left of the chunk: column 0's
//     boundary value, the off-band columns 1..lo-1 in closed form
//     (U[j] = NEG_INF + j), and the earlier chunks of the row.
//
// Every in-band cell gets exactly the value of the full-row program, so
// the score taken at i == p_len, column t_len, is the same.  Supported
// shapes: any Lt and Lp, with |t_len - p_len| <= 8180 (the ring, 16*ring
// bytes of shared memory per warp, stays under 128 KB).
//
// What bounds it on an H100: integer ALU work and shuffle latency per
// band chunk (about 5 dependent shuffles and 30 integer operations per
// lane per row); a pair reads t_len + p_len bytes and writes 4.  Pairs
// are independent, so the card fills by pair count.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMatch = 2;
constexpr int kMismatch = -2;
constexpr int kGO = -4;
constexpr int kGE = -1;
constexpr int kNegInf = -(1 << 24);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdentity = INT_MIN / 2;  // below every reachable value

__global__ void align_full_kernel(const int8_t* __restrict__ t_codes,
                                  const int32_t* __restrict__ t_lens,
                                  const int8_t* __restrict__ p_codes,
                                  const int32_t* __restrict__ p_lens,
                                  int64_t n, int lt_w, int lp_w, int ring,
                                  int32_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t item = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= n) return;  // uniform across the warp

  int* mbuf = smem + (size_t)warp * 4 * ring;  // [2][ring]
  int* ebuf = mbuf + 2 * ring;                 // [2][ring]
  const int mask = ring - 1;
  const int8_t* tr = t_codes + item * (int64_t)lt_w;
  const int8_t* pr = p_codes + item * (int64_t)lp_w;
  const int tl = t_lens[item];
  const int pl = p_lens[item];

  // degenerate cases (reference AlignAlgo.hpp:217-236)
  if (tl == 0 || pl == 0 || (tl == 1 && pl == 1)) {
    if (lane == 0) {
      int s = 0;
      if (tl == 1 && pl == 1) {
        const int t0 = tr[0], p0 = pr[0];
        s = (t0 == p0 || t0 == 4 || p0 == 4) ? kMatch : kMismatch;
      }
      out[item] = s;
    }
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

}  // namespace

// t_codes int8 [n, lt_w], p_codes int8 [n, lp_w], lens int32 [n], out
// int32 [n].  ring: power of two >= 12 + max |t_len - p_len|.  Returns the
// launch's cudaGetLastError().
extern "C" int t1k_align_full(const void* t_codes, const void* t_lens,
                              const void* p_codes, const void* p_lens,
                              int64_t n, int lt_w, int lp_w, int ring,
                              void* out, void* stream) {
  if (n <= 0) return 0;
  if (ring < 32 || (ring & (ring - 1)) != 0 || ring > 8192)
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)16 * ring;
  int warps = (int)((size_t)(227 * 1024) / per_warp);
  warps = warps > 8 ? 8 : (warps < 1 ? 1 : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        align_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((n + warps - 1) / warps);
  align_full_kernel<<<grid, 32 * warps, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(t_codes), static_cast<const int32_t*>(t_lens),
      static_cast<const int8_t*>(p_codes), static_cast<const int32_t*>(p_lens),
      n, lt_w, lp_w, ring, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
