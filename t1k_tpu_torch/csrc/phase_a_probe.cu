// Phase-A probe: window codes, CSR posting lookups and the
// GetHitsFromRead dedup/skip scan for each strand of each read.
//
// Replaces t1k_tpu/ops/phase_a.py::_probe_kernel (an XLA program) with
// _window_codes, _csr_lookup and _probe_scan.  Same contract:
//
//   * the reverse complement is left-aligned like the engine: position p
//     of the rc row holds comp(codes[len-1-p]) for p < len, N after;
//   * window w's code is the 2-bit packing of bases w..w+k-1 with N as
//     bit pattern 3, valid when none of them is an N;
//   * the lookup is direct (starts[code], starts[code+1]) for k <= 12, or
//     open-addressed with h = code*2654435761 & mask, step =
//     ((code>>15)|1)&mask|1 in uint32, for max_probe rounds;
//   * the scan (SeqSet.hpp:1081-1119): window 0 and window len-k are
//     always considered, a window repeating the previous considered code
//     is not, and a window with >= 100 postings is skipped up to k/2
//     times in a row without updating the dedup state.
//
// Output contrib / cstart int32 [R, 2W] (forward windows, then rc) and
// tot int32 [R] (zeroed by the caller; the two strands add atomically).
//
// Design: one thread per (read, strand) row, rolling over the row's L
// positions with the code, the last N position and the scan state in
// registers.  What bounds it on an H100: the latency of the table reads
// (starts or keys, then hstart/hcount), up to max_probe dependent
// random loads per window; 2R threads per chunk keep a few warps per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kHashMul = 2654435761u;

__global__ void probe_kernel(const int8_t* __restrict__ codes,
                             const int32_t* __restrict__ lens, int R, int L,
                             int k, int direct,
                             const int32_t* __restrict__ starts,
                             const uint32_t* __restrict__ keys,
                             const int32_t* __restrict__ hstart,
                             const int32_t* __restrict__ hcount,
                             uint32_t hmask, int max_probe,
                             int32_t* __restrict__ contrib,
                             int32_t* __restrict__ cstart,
                             int32_t* __restrict__ tot) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= 2 * R) return;
  const bool rc = q >= R;
  const int r = rc ? q - R : q;
  const int len = lens[r];
  const int W = L - k + 1;
  const int last_w = len - k;  // engine i == len-1  <=>  w == len-k
  const int skip_limit = k / 2;
  const uint32_t code_mask = (1u << (2 * k)) - 1u;
  const int8_t* row = codes + (int64_t)r * L;
  int32_t* out_c = contrib + (int64_t)r * 2 * W + (rc ? W : 0);
  int32_t* out_s = cstart + (int64_t)r * 2 * W + (rc ? W : 0);

  uint32_t code = 0, prev = 0;
  int last_n = -1, skip = 0, sum = 0;
  for (int pos = 0; pos < L; ++pos) {
    int base;
    if (!rc) {
      base = row[pos];
    } else {
      const int j = len - 1 - pos;
      const int x = j >= 0 ? row[j] : 4;
      base = j >= 0 && x < 4 ? 3 - x : (j >= 0 ? x : 4);
    }
    code = ((code << 2) | (uint32_t)min(base, 3)) & code_mask;
    if (base >= 4) last_n = pos;
    const int w = pos - k + 1;
    if (w < 0) continue;

    int st = 0, cnt = 0;
    if (last_n < w) {  // valid window
      if (direct) {
        st = starts[code];
        cnt = starts[code + 1] - st;
      } else {
        uint32_t h = (code * kHashMul) & hmask;
        const uint32_t step = (((code >> 15) | 1u) & hmask) | 1u;
        for (int t = 0; t < max_probe; ++t) {
          const uint32_t kk = keys[h];
          if (kk == code || kk == kEmpty) break;
          h = (h + step) & hmask;
        }
        if (keys[h] == code) {
          st = hstart[h];
          cnt = hcount[h];
        }
      }
    }

    const bool active = w <= last_w && len >= k;
    const bool considered = active && (w == 0 || code != prev);
    const bool skipped = considered && cnt >= 100 && w != 0 && w != last_w &&
                         skip < skip_limit;
    const bool emit = considered && !skipped && cnt > 0;
    if (active) {
      if (skipped) ++skip;
      else if (considered) skip = 0;
      if (!skipped) prev = code;
    }
    out_c[w] = emit ? cnt : 0;
    out_s[w] = st;
    sum += emit ? cnt : 0;
  }
  atomicAdd(&tot[r], sum);
}

}  // namespace

// codes int8 [R, L] (pad 4), lens int32 [R]; the table as PhaseAIndex
// holds it (keys are uint32 bit patterns).  contrib, cstart int32
// [R, 2*(L-k+1)], tot int32 [R] zeroed.  Returns cudaGetLastError().
extern "C" int t1k_phase_a_probe(const void* codes, const void* lens, int R,
                                 int L, int k, int direct, const void* starts,
                                 const void* keys, const void* hstart,
                                 const void* hcount, int64_t hmask,
                                 int max_probe, void* contrib, void* cstart,
                                 void* tot, void* stream) {
  if (R <= 0) return 0;
  if (k < 1 || k > 15 || L < k) return (int)cudaErrorInvalidValue;
  constexpr int kBlock = 128;
  const unsigned grid = (unsigned)((2 * R + kBlock - 1) / kBlock);
  probe_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), R,
      L, k, direct, static_cast<const int32_t*>(starts),
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(hstart),
      static_cast<const int32_t*>(hcount), (uint32_t)hmask, max_probe,
      static_cast<int32_t*>(contrib), static_cast<int32_t*>(cstart),
      static_cast<int32_t*>(tot));
  return (int)cudaGetLastError();
}
