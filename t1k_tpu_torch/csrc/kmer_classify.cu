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
//   * pair lookup (k <= 13): bits 2(fk & 15) and 2(fk & 15) + 1 of pair
//     word fk >> 4 are the forward key's membership and its reverse
//     complement's (ops/kmer.py::pair_words), so one word answers both
//     strands;
//   * centre lookup (k = 14): the same two bits at the entry of the
//     window's canonical key (CentreLookup, ops/kmer.py::centre_words);
//   * bitmap lookup (the first design, k <= 14): bit key & 31 of bitmap
//     word key >> 5, once for each strand's key;
//   * hashed lookup: h = key*2654435761 & mask, step = ((key>>15)|1) &
//     mask | 1 in uint32, until the key or an empty slot (0xFFFFFFFF), at
//     most max_probe probes; a chain that meets neither counts as a hit,
//     and so does the all-T key at k = 16, which equals the empty marker.
//
// Output fwd, rc int32 [R].
//
// What bounds it on an H100: the lookups, random 4-byte loads into a
// table that fits the 50 MB L2, each a request for a 32-byte L2 sector.
// The card serves about 1.3e11 such requests a second from a table of 8
// or 16 MB, however many a thread keeps in flight (scripts/kmer_ab.py's
// gather ceiling), so the count of lookups sets the time.  The bytes
// (codes in, 8 bytes a read out) are small beside them.
//
// The design (classify_kernel): one lookup a window where the table
// allows it (pair and centre layouts), kParts threads a read, each
// walking a contiguous share of its windows.  A block stages its reads'
// bases in shared memory, kTileWin windows a tile, with streaming loads
// (so the codes do not evict the table from L2), rows an odd number of
// words apart so that a warp's rows at one column sit in distinct banks.
// A thread rolls its forward and reverse-complement keys one base a
// window, tracks the last N instead of re-scanning the window, and issues
// the lookups of kBatch windows before it consumes any (a Lookup struct a
// table layout); hashed, each round of the batch's unresolved chains goes
// out together.  The kParts threads of a read add their counts with
// shuffles and one writes them: no atomics, no zeroed outputs.
//
// The first design (classify_v1_kernel, t1k_kmer_classify_v1) stays for
// A/B timing: a warp a read, a window a lane, both keys rebuilt from k
// staged bases, two lookups a window.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kHashMul = 2654435761u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 16;

enum Mode { kPair = 0, kCentre = 1, kHashed = 2 };

// ------------------------------------------------------------ second design

constexpr int kThreads = 128;  // threads a block
constexpr int kParts = 4;      // threads a read: a power of two <= 32
constexpr int kBatch = 8;      // windows whose lookups go out together
constexpr int kTileWin = 96;   // windows of a row a tile stages

constexpr int kRows = kThreads / kParts;  // reads a block
// a row's bases in shared memory: whole words, an odd count of them
constexpr int kStride = 4 * ((((kTileWin + kMaxK - 1) + 3) / 4) | 1);
static_assert(32 % kParts == 0 && kThreads % 32 == 0, "kParts | 32");

// A table layout: load() issues a window's loads (none where the window
// does not count), probe() a further round of them (hashed chains only;
// it returns whether it issued any), count() adds its hits.  The kernel
// calls load() for a batch of windows, then probe() rounds, before it
// calls count() for any.
struct PairLookup {  // k <= 13: one word answers both strands
  uint32_t w;
  __device__ __forceinline__ void load(const uint32_t* __restrict__ t,
                                       uint32_t fk, uint32_t, bool ok,
                                       uint32_t) {
    w = ok ? __ldg(t + (fk >> 4)) : 0u;
  }
  __device__ __forceinline__ bool probe(const uint32_t* __restrict__, uint32_t,
                                        uint32_t, uint32_t) {
    return false;
  }
  __device__ __forceinline__ void count(uint32_t fk, uint32_t, bool,
                                        int& n_fwd, int& n_rc) const {
    const uint32_t v = w >> (2 * (fk & 15u));
    n_fwd += v & 1u;
    n_rc += (v >> 1) & 1u;
  }
};

// k = 14: the centre-canonical layout (ops/kmer.py::centre_words).  The
// middle base pair m (bases 6 and 7) and its reverse complement's pair
// fall in one of 10 classes; the key whose pair is the class's smaller
// one is canonical (both, for the four pairs that are their own reverse
// complement), and entry (class, the 12 other bases) of the canonical key
// x holds [x in S, revcomp(x) in S].  A window whose forward key is not
// canonical reads its reverse complement's entry with the bits swapped:
// one 40 MB table, one word a window.
constexpr unsigned long long kCentreClass = 0x0479158726543210ull;
constexpr uint32_t kCentreFlip = 0xEC80u;  // m whose revcomp is canonical
static_assert(((kCentreClass >> 60) & 15) == 0 && (kCentreFlip >> 15) == 1,
              "pair TT (15) is AA's (0) reverse complement");

struct CentreLookup {
  uint32_t w, i;
  bool flip;
  __device__ __forceinline__ void load(const uint32_t* __restrict__ t,
                                       uint32_t fk, uint32_t rk, bool ok,
                                       uint32_t) {
    const uint32_t m = (fk >> 12) & 15u;
    flip = (kCentreFlip >> m) & 1u;
    const uint32_t x = flip ? rk : fk;
    i = (((uint32_t)(kCentreClass >> (4 * m)) & 15u) << 24) |
        ((x >> 16) << 12) | (x & 0xFFFu);
    w = ok ? __ldg(t + (i >> 4)) : 0u;
  }
  __device__ __forceinline__ bool probe(const uint32_t* __restrict__, uint32_t,
                                        uint32_t, uint32_t) {
    return false;
  }
  __device__ __forceinline__ void count(uint32_t, uint32_t, bool,
                                        int& n_fwd, int& n_rc) const {
    const uint32_t v = w >> (2 * (i & 15u));
    n_fwd += (flip ? v >> 1 : v) & 1u;
    n_rc += (flip ? v : v >> 1) & 1u;
  }
};

// k >= 15: the open-addressing table, both strands' chains.  load()
// issues each chain's first probe; each probe() round then issues the
// next probe of every chain of the batch that has met neither its key nor
// an empty slot, so a batch's chains go out together; the kernel runs at
// most max_probe - 1 rounds.  A chain still unresolved is a hit.
struct HashedLookup {
  uint32_t hf, hr, ef, er;
  __device__ __forceinline__ void load(const uint32_t* __restrict__ t,
                                       uint32_t fk, uint32_t rk, bool ok,
                                       uint32_t mask) {
    hf = (fk * kHashMul) & mask;
    hr = (rk * kHashMul) & mask;
    ef = ok ? __ldg(t + hf) : fk;  // a window that does not count: resolved
    er = ok ? __ldg(t + hr) : rk;
  }
  __device__ __forceinline__ bool probe(const uint32_t* __restrict__ t,
                                        uint32_t fk, uint32_t rk,
                                        uint32_t mask) {
    const bool more_f = ef != fk && ef != kEmpty;
    const bool more_r = er != rk && er != kEmpty;
    if (more_f) hf = (hf + ((((fk >> 15) | 1u) & mask) | 1u)) & mask;
    if (more_r) hr = (hr + ((((rk >> 15) | 1u) & mask) | 1u)) & mask;
    ef = more_f ? __ldg(t + hf) : ef;
    er = more_r ? __ldg(t + hr) : er;
    return more_f || more_r;
  }
  __device__ __forceinline__ void count(uint32_t fk, uint32_t rk, bool ok,
                                        int& n_fwd, int& n_rc) const {
    if (!ok) return;
    n_fwd += ef == fk || ef != kEmpty;  // its key, or an unresolved chain
    n_rc += er == rk || er != kEmpty;
  }
};

// The bases of the block's rows for windows [base, base + tw): tb bytes
// of each row from column `base`, a warp a row; whole words where the
// rows allow.
__device__ __forceinline__ void stage(int8_t* tile,
                                      const int8_t* __restrict__ codes,
                                      int64_t row0, int rows, int L, int base,
                                      int tb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* src = codes + row0 * L + base;
  if (((reinterpret_cast<uintptr_t>(src) | L | tb) & 3) == 0) {
    const int words = tb >> 2;
    for (int i = warp; i < rows; i += kThreads / 32) {
      const int* in = reinterpret_cast<const int*>(src + (int64_t)i * L);
      int* out = reinterpret_cast<int*>(tile + i * kStride);
      for (int j = lane; j < words; j += 32) out[j] = __ldcs(in + j);
    }
  } else {
    for (int i = warp; i < rows; i += kThreads / 32) {
      const signed char* in =
          reinterpret_cast<const signed char*>(src + (int64_t)i * L);
      for (int j = lane; j < tb; j += 32)
        tile[i * kStride + j] = __ldcs(in + j);
    }
  }
}

template <class Lookup>
__global__ void __launch_bounds__(kThreads)
classify_kernel(const int8_t* __restrict__ codes,
                const int32_t* __restrict__ lens, int R, int L, int k,
                const uint32_t* __restrict__ table, uint32_t mask,
                int max_probe, int32_t* __restrict__ fwd_out,
                int32_t* __restrict__ rc_out) {
  __shared__ __align__(16) int8_t tile[kRows * kStride];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - row0);
  const int local = threadIdx.x / kParts, part = threadIdx.x % kParts;
  const int r = row0 + local;
  const int len = r < R ? min(lens[r], L) : 0;
  const int n_win = max(len - k + 1, 0);
  // this thread's windows [w_lo, w_hi): share `part` of kParts
  const int w_lo = (int)((int64_t)n_win * part / kParts);
  const int w_hi = (int)((int64_t)n_win * (part + 1) / kParts);
  const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const int rshift = 2 * (k - 1);
  const int8_t* s_row = tile + local * kStride;

  int n_fwd = 0, n_rc = 0;
  for (int base = 0; base < L - k + 1; base += kTileWin) {
    // also the barrier after the previous tile's reads
    if (!__syncthreads_or(w_hi > base)) break;
    const int tw = min(kTileWin, L - k + 1 - base);  // windows in the tile
    stage(tile, codes, row0, rows, L, base, tw + k - 1);
    __syncthreads();
    const int a = max(w_lo, base), b = min(w_hi, base + tw);
    if (a >= b) continue;
    // s[q] is base a - base + q of the tile; window a + j ends at q = j + k - 1
    const int8_t* s = s_row + (a - base);
    const int q_end = b - a + k - 1;
    uint32_t fk = 0, rk = 0;
    int last_n = -k;  // the last N's q: the window ending at q is clean
                      // iff q - last_n >= k
    auto roll = [&](int q, int code) {
      const uint32_t c = (uint32_t)min(code, 3);
      fk = ((fk << 2) | c) & kmask;               // base at bits 0
      rk = (rk >> 2) | ((c ^ 3u) << rshift);      // complement at the top
      last_n = code >= 4 ? q : last_n;
    };
    for (int q = 0; q < k - 1; ++q) roll(q, s[q]);
    for (int q = k - 1; q < q_end; q += kBatch) {
      uint32_t fkey[kBatch], rkey[kBatch];
      bool ok[kBatch];
      Lookup look[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const bool in = q + i < q_end;
        const int code = s[min(q + i, q_end - 1)];
        roll(q + i, in ? code : 4);
        fkey[i] = fk;
        rkey[i] = rk;
        ok[i] = q + i - last_n >= k;  // false past the end (an N there)
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        look[i].load(table, fkey[i], rkey[i], ok[i], mask);
      for (int t = 1; t < max_probe; ++t) {
        bool more = false;
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          more |= look[i].probe(table, fkey[i], rkey[i], mask);
        if (!more) break;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        look[i].count(fkey[i], rkey[i], ok[i], n_fwd, n_rc);
    }
  }
#pragma unroll
  for (int off = kParts / 2; off > 0; off >>= 1) {
    n_fwd += __shfl_xor_sync(kFull, n_fwd, off);
    n_rc += __shfl_xor_sync(kFull, n_rc, off);
  }
  if (part == 0 && r < R) {
    fwd_out[r] = n_fwd;
    rc_out[r] = n_rc;
  }
}

// ------------------------------------------------------------- first design

constexpr int kWarps = 8;   // reads per block
constexpr int kTile = 256;  // windows a warp stages at once

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
classify_v1_kernel(const int8_t* __restrict__ codes,
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

// codes int8 [R, L] (bases 0-3, N 4), lens int32 [R]; mode a Mode and
// table its uint32 words (pair words, centre-canonical words, or the keys
// of a power-of-two table, mask = its size - 1).  fwd, rc int32 [R].  Returns
// cudaGetLastError().
extern "C" int t1k_kmer_classify(const void* codes, const void* lens, int R,
                                 int L, int k, int mode, const void* table,
                                 int64_t mask, int max_probe, void* fwd,
                                 void* rc, void* stream) {
  if (R <= 0) return 0;
  if (k < 1 || k > kMaxK || L < k || max_probe < 1 ||
      (mode == kPair && k > 13) || (mode == kCentre && k != 14))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((R + kRows - 1) / kRows);
  auto* kernel = mode == kPair     ? classify_kernel<PairLookup>
                 : mode == kCentre ? classify_kernel<CentreLookup>
                                   : classify_kernel<HashedLookup>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), R,
      L, k, static_cast<const uint32_t*>(table), (uint32_t)mask, max_probe,
      static_cast<int32_t*>(fwd), static_cast<int32_t*>(rc));
  return (int)cudaGetLastError();
}

// The first design, for A/B timing: direct 1 for the bitmap, 0 hashed.
extern "C" int t1k_kmer_classify_v1(const void* codes, const void* lens,
                                    int R, int L, int k, int direct,
                                    const void* table, int64_t mask,
                                    int max_probe, void* fwd, void* rc,
                                    void* stream) {
  if (R <= 0) return 0;
  if (k < 1 || k > kMaxK || L < k) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((R + kWarps - 1) / kWarps);
  classify_v1_kernel<<<grid, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), R,
      L, k, direct, static_cast<const uint32_t*>(table), (uint32_t)mask,
      max_probe, static_cast<int32_t*>(fwd), static_cast<int32_t*>(rc));
  return (int)cudaGetLastError();
}
