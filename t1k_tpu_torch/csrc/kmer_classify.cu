// K-mer classification: per read, the forward and reverse-complement
// windows whose k-mer is in the reference's table.
//
// Replaces t1k_tpu/ops/kmer.py::_classify (hashed table) and
// ::_classify_direct (bitmap), XLA programs, with _strand_counts'
// contract:
//
//   * forward window w counts when w < len - k + 1, none of its bases is
//     >= 4 and its key hits; the reverse strand is the reverse complement
//     of the read, so its windows are the reverse complements of the
//     forward ones and one pass over the read gives both keys;
//   * a key is the 2-bit packing of its bases, first base highest;
//   * direct lookup (k <= 14): bit key & 31 of bitmap word key >> 5;
//   * hashed lookup: h = key*2654435761 & mask, step = ((key>>15)|1) &
//     mask | 1 in uint32, until the key or an empty slot (0xFFFFFFFF), at
//     most max_probe probes; a chain that meets neither counts as a hit,
//     and so does the all-T key at k = 16, which equals the empty marker.
//
// Output fwd, rc int32 [R].
//
// What bounds it on an H100: the lookups, random 4-byte loads into a table
// of up to 32 MB (the k = 14 bitmap; it fits the 50 MB L2), one a window
// and strand direct, up to max_probe dependent ones hashed.  The bytes
// (codes in, 8 bytes a read out) are small beside them.  The design keeps
// many lookups in flight: one warp per read and eight reads per block.
// The warp stages the read in shared memory, 256 windows at a time, with
// coalesced loads; each lane takes one window of every 32, builds its
// forward and reverse-complement keys from shared memory and runs both
// lookups, so 64 lookups of a warp are in flight at once.  The warp
// reduces its lanes' counts with shuffles and one lane writes them: no
// atomics, no zeroed outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kHashMul = 2654435761u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;   // reads per block
constexpr int kTile = 256;  // windows a warp stages at once
constexpr int kMaxK = 16;

__device__ __forceinline__ int table_hit(uint32_t key, bool direct,
                                         const uint32_t* __restrict__ table,
                                         uint32_t mask, int max_probe) {
  if (direct) return (__ldg(table + (key >> 5)) >> (key & 31u)) & 1u;
  uint32_t h = (key * kHashMul) & mask;
  const uint32_t step = (((key >> 15) | 1u) & mask) | 1u;
  for (int t = 0; t < max_probe; ++t) {
    const uint32_t e = __ldg(table + h);
    if (e == key) return 1;
    if (e == kEmpty) return 0;
    h = (h + step) & mask;
  }
  return 1;  // unresolved chain: a conservative hit
}

__global__ void __launch_bounds__(kWarps * 32)
classify_kernel(const int8_t* __restrict__ codes,
                const int32_t* __restrict__ lens, int R, int L, int k,
                int direct, const uint32_t* __restrict__ table,
                uint32_t mask, int max_probe, int32_t* __restrict__ fwd_out,
                int32_t* __restrict__ rc_out) {
  __shared__ int8_t srow_all[kWarps][kTile + kMaxK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps leave together
  const int len = min(lens[r], L);
  const int n_win = len - k + 1;  // windows in the read (<= 0: none)
  const int8_t* row = codes + (int64_t)r * L;
  int8_t* s = srow_all[warp];

  int n_fwd = 0, n_rc = 0;
  for (int base = 0; base < n_win; base += kTile) {
    const int tile = min(kTile, n_win - base);
    __syncwarp();  // the previous tile's reads are done
    for (int p = lane; p < tile + k - 1; p += 32) s[p] = row[base + p];
    __syncwarp();
    for (int w = lane; w < tile; w += 32) {
      uint32_t fk = 0, rk = 0;
      bool has_n = false;
      for (int t = 0; t < k; ++t) {
        const int b = s[w + t];
        const uint32_t c = (uint32_t)min(b, 3);
        has_n |= b >= 4;
        fk = (fk << 2) | c;             // base t at bits 2(k-1-t)
        rk |= (3u - c) << (2 * t);      // its complement at bits 2t
      }
      if (!has_n) {
        n_fwd += table_hit(fk, direct, table, mask, max_probe);
        n_rc += table_hit(rk, direct, table, mask, max_probe);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    n_fwd += __shfl_xor_sync(kFull, n_fwd, off);
    n_rc += __shfl_xor_sync(kFull, n_rc, off);
  }
  if (lane == 0) {
    fwd_out[r] = n_fwd;
    rc_out[r] = n_rc;
  }
}

}  // namespace

// codes int8 [R, L] (bases 0-3, N 4), lens int32 [R]; table the uint32
// words (bitmap when direct, else keys of a power-of-two table, mask =
// its size - 1).  fwd, rc int32 [R].  Returns cudaGetLastError().
extern "C" int t1k_kmer_classify(const void* codes, const void* lens, int R,
                                 int L, int k, int direct, const void* table,
                                 int64_t mask, int max_probe, void* fwd,
                                 void* rc, void* stream) {
  if (R <= 0) return 0;
  if (k < 1 || k > kMaxK || L < k) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((R + kWarps - 1) / kWarps);
  classify_kernel<<<grid, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), R,
      L, k, direct, static_cast<const uint32_t*>(table), (uint32_t)mask,
      max_probe, static_cast<int32_t*>(fwd), static_cast<int32_t*>(rc));
  return (int)cudaGetLastError();
}
