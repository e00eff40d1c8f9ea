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
// What bounds it on an H100: the table lookups, random 4-byte loads into
// a table of up to tens of MB, up to max_probe+1 of them in a dependent
// chain per window; the bytes (codes in, 16 bytes out per window) are a
// microsecond per 1024-read chunk.  The design keeps many independent
// lookups in flight: one warp per (read, strand) row and eight rows per
// block (256 blocks for a 1024-read chunk, every SM busy).  The warp
// stages its row in shared memory with coalesced loads, then each lane
// takes one window of each 32-window tile, builds its code and N
// validity directly from shared memory (k <= 15) and runs its own probe,
// so 32 lookups of a warp are in flight at once.  Only the dedup/skip
// scan is sequential: every lane replays it over the tile's (code,
// count) pairs, read with shuffles from the registers that hold them,
// and keeps its own window's verdict.  Lanes store contrib/cstart at
// consecutive w (coalesced) and the warp reduces tot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kHashMul = 2654435761u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;  // (read, strand) rows per block

__global__ void __launch_bounds__(kWarps * 32)
probe_kernel(const int8_t* __restrict__ codes,
             const int32_t* __restrict__ lens, int R, int L, int k,
             int direct, const int32_t* __restrict__ starts,
             const uint32_t* __restrict__ keys,
             const int32_t* __restrict__ hstart,
             const int32_t* __restrict__ hcount, uint32_t hmask,
             int max_probe, int32_t* __restrict__ contrib,
             int32_t* __restrict__ cstart, int32_t* __restrict__ tot) {
  extern __shared__ int8_t srow_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;  // row: read q/2, strand q%2
  if (q >= 2 * R) return;                    // whole warps leave together
  const int r = q >> 1;
  const bool rc = q & 1;
  const int len = lens[r];
  const int W = L - k + 1;
  const int last_w = len - k;  // engine i == len-1  <=>  w == len-k
  const int skip_limit = k / 2;
  const int8_t* row = codes + (int64_t)r * L;
  int8_t* s = srow_all + warp * ((L + 15) & ~15);
  int32_t* out_c = contrib + (int64_t)r * 2 * W + (rc ? W : 0);
  int32_t* out_s = cstart + (int64_t)r * 2 * W + (rc ? W : 0);

  // ---- stage this strand's row in shared memory
  for (int p = lane; p < L; p += 32) {
    int base;
    if (!rc) {
      base = row[p];
    } else {
      const int j = len - 1 - p;
      const int x = j >= 0 ? row[j] : 4;
      base = j >= 0 && x < 4 ? 3 - x : (j >= 0 ? x : 4);
    }
    s[p] = (int8_t)base;
  }
  __syncwarp();

  // the dedup/skip state, replicated in every lane
  uint32_t prev = 0;
  int skip = 0, sum = 0;
  for (int tile = 0; tile < W; tile += 32) {
    const int w = tile + lane;
    uint32_t code = 0;
    int st = 0, cnt = 0;
    if (w < W) {
      bool has_n = false;
      for (int t = 0; t < k; ++t) {
        const int b = s[w + t];
        code = (code << 2) | (uint32_t)min(b, 3);
        has_n |= b >= 4;
      }
      if (!has_n) {
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
    }
    // windows past last_w are inactive: they change no state
    const int n_active = min(32, last_w + 1 - tile);
    bool emit_mine = false;
    for (int t = 0; t < n_active; ++t) {
      const uint32_t c_t = __shfl_sync(kFull, code, t);
      const int n_t = __shfl_sync(kFull, cnt, t);
      const int wt = tile + t;
      const bool considered = wt == 0 || c_t != prev;
      const bool skipped = considered && n_t >= 100 && wt != 0 &&
                           wt != last_w && skip < skip_limit;
      if (skipped) ++skip;
      else if (considered) skip = 0;
      if (!skipped) prev = c_t;
      if (t == lane) emit_mine = considered && !skipped && n_t > 0;
    }
    if (w < W) {
      out_c[w] = emit_mine ? cnt : 0;
      out_s[w] = st;
    }
    sum += emit_mine ? cnt : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) atomicAdd(&tot[r], sum);
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
  if (k < 1 || k > 15 || L < k || L >= 4096)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((2 * R + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * ((L + 15) & ~15);  // <= 32 KB
  probe_kernel<<<grid, kWarps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), R,
      L, k, direct, static_cast<const int32_t*>(starts),
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(hstart),
      static_cast<const int32_t*>(hcount), (uint32_t)hmask, max_probe,
      static_cast<int32_t*>(contrib), static_cast<int32_t*>(cstart),
      static_cast<int32_t*>(tot));
  return (int)cudaGetLastError();
}
