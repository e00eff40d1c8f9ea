// K10's census: a chunk's hit arena in (read, strand, seq) bucket order.
//
// Replaces t1k_tpu/ops/phase_a.py::_cand_census_kernel (the XLA program
// of DeviceCandidates: the flat posting expansion and one sort of the
// whole arena by bucket key).  Each read's hits fall into only 2 n_seqs
// bins (lkey = seq + (forward ? n_seqs : 0)), so the global sort becomes
// a counting sort per read in shared memory, one block per read.
//
// Inputs: the probe's contrib and cstart [R, 2W] int32 (forward windows,
// then the reverse complement's), the posting table's post_seq and
// post_off.  Outputs: the arena a (read offset) and b (seq offset), int32
// [total], read by read in the order of the prefix of their hit counts
// and inside a read by lkey (the seeds of one bucket in the order the
// atomics give); per bucket g < nb_total, in (read, lkey) order, its key
// read * 2 n_seqs + lkey, its first slot and its count; nb_total.
//
// Global bucket ids need every earlier read's bucket count, so a first
// pass (count_kernel) walks each read's postings into a bitmap of its
// lkeys and writes its hit and bucket counts; the second (write_kernel)
// sums the earlier reads' counts for its bases (R values from L2), builds
// the histogram, scans it, writes the buckets and walks the postings
// again to place each seed.  A key range wider than one block's shared
// memory is taken in slices of `bins` keys, with one walk (two in the
// write pass) over the read's postings per slice.
//
// What bounds it on an H100: bytes, about 16 per hit (a posting read of
// post_seq and post_off, the seed written) and 12 per bucket; the two
// extra walks of post_seq are the first pass's and the histogram's.  The
// walk assigns hit h of the read to thread h mod blockDim, each thread
// keeping its window cursor (the windows' exclusive prefix lives in
// shared memory), four hits in flight per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Exclusive prefix of v over the block's threads, and the block's total.
// scratch holds 32 ints; every thread must call it.
__device__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? scratch[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    scratch[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? scratch[warp - 1] : 0);
  total = scratch[nw - 1];
  __syncthreads();
  return excl;
}

// The read's windows: wpre[w] = hits of windows before w (wpre[W2] =
// the read's hits), cst[w] = the window's first posting.  Returns the
// read's hits.
__device__ int load_windows(const int32_t* __restrict__ crow,
                            const int32_t* __restrict__ srow, int W2,
                            int* wpre, int* cst, int* scratch) {
  const int per = (W2 + blockDim.x - 1) / blockDim.x;
  const int i0 = min(threadIdx.x * per, W2), i1 = min(i0 + per, W2);
  int s = 0;
  for (int i = i0; i < i1; ++i) s += crow[i];
  int total;
  int off = block_scan(s, scratch, total);
  for (int i = i0; i < i1; ++i) {
    wpre[i] = off;
    off += crow[i];
    cst[i] = srow[i];
  }
  if (threadIdx.x == 0) wpre[W2] = total;
  __syncthreads();
  return total;
}

// Calls f(w, p, lkey) for every hit of the read whose lkey lies in [lo,
// lo + n): w its window, p its posting.
template <class F>
__device__ __forceinline__ void walk(const int* wpre, const int* cst,
                                     const int32_t* __restrict__ post_seq,
                                     int W, int n_seqs, int hits, int lo,
                                     int n, F f) {
  int w = 0;
  for (int base = threadIdx.x; base < hits; base += kUnroll * blockDim.x) {
    int p[kUnroll], ww[kUnroll], seq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int h = base + u * blockDim.x;
      if (h < hits) {
        while (wpre[w + 1] <= h) ++w;
        ww[u] = w;
        p[u] = cst[w] + (h - wpre[w]);
      } else {
        p[u] = -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) seq[u] = p[u] >= 0 ? post_seq[p[u]] : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p[u] < 0) continue;
      const int lkey = seq[u] + (ww[u] < W ? n_seqs : 0) - lo;
      if ((unsigned)lkey < (unsigned)n) f(ww[u], p[u], lkey);
    }
  }
}

// Pass 1: each read's hits and distinct lkeys (its buckets).
__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ contrib,
             const int32_t* __restrict__ cstart,
             const int32_t* __restrict__ post_seq, int W2, int n_seqs,
             int bits, int32_t* __restrict__ hits_out,
             int32_t* __restrict__ nbk_out) {
  extern __shared__ int smem[];
  __shared__ int scratch[32];
  int* wpre = smem;
  int* cst = wpre + W2 + 1;
  unsigned* bitmap = reinterpret_cast<unsigned*>(cst + W2);
  const int r = blockIdx.x;
  const int hits = load_windows(contrib + (size_t)r * W2,
                                cstart + (size_t)r * W2, W2, wpre, cst,
                                scratch);
  const int NG = 2 * n_seqs;
  int nbk = 0;
  for (int lo = 0; lo < NG; lo += bits) {
    const int n = min(bits, NG - lo);
    const int words = (n + 31) >> 5;
    for (int i = threadIdx.x; i < words; i += blockDim.x) bitmap[i] = 0u;
    __syncthreads();
    walk(wpre, cst, post_seq, W2 / 2, n_seqs, hits, lo, n,
         [&](int, int, int key) {
           atomicOr(&bitmap[key >> 5], 1u << (key & 31));
         });
    __syncthreads();
    int c = 0;
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      c += __popc(bitmap[i]);
    int total;
    block_scan(c, scratch, total);
    nbk += total;
  }
  if (threadIdx.x == 0) {
    hits_out[r] = hits;
    nbk_out[r] = nbk;
  }
}

// Pass 2: the read's buckets and seeds.
__global__ void __launch_bounds__(kThreads)
write_kernel(const int32_t* __restrict__ contrib,
             const int32_t* __restrict__ cstart,
             const int32_t* __restrict__ post_seq,
             const int32_t* __restrict__ post_off, int R, int W2, int n_seqs,
             int bins, int total, const int32_t* __restrict__ hits_in,
             const int32_t* __restrict__ nbk_in, int32_t* __restrict__ a_out,
             int32_t* __restrict__ b_out, int32_t* __restrict__ key_out,
             int32_t* __restrict__ first_out,
             int32_t* __restrict__ count_out,
             int32_t* __restrict__ nb_total) {
  extern __shared__ int smem[];
  __shared__ int scratch[32];
  int* wpre = smem;
  int* cst = wpre + W2 + 1;
  int* hist = cst + W2;
  const int r = blockIdx.x;
  const int W = W2 / 2, NG = 2 * n_seqs;
  // the read's bases: the earlier reads' hits and buckets
  int hb = 0, bb = 0;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    hb += hits_in[i];
    bb += nbk_in[i];
  }
  block_scan(hb, scratch, hb);
  block_scan(bb, scratch, bb);
  if (r == R - 1 && threadIdx.x == 0) *nb_total = bb + nbk_in[r];
  const int hits = load_windows(contrib + (size_t)r * W2,
                                cstart + (size_t)r * W2, W2, wpre, cst,
                                scratch);
  int carry_h = 0, carry_b = 0;  // the read's hits and buckets so far
  for (int lo = 0; lo < NG; lo += bins) {
    const int n = min(bins, NG - lo);
    for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    walk(wpre, cst, post_seq, W, n_seqs, hits, lo, n,
         [&](int, int, int key) { atomicAdd(&hist[key], 1); });
    __syncthreads();
    // each thread scans a run of bins: the slots before each bin and the
    // buckets before it, then writes its buckets and leaves each bin's
    // first slot (from the read's first) in hist
    const int per = (n + blockDim.x - 1) / blockDim.x;
    const int i0 = min(threadIdx.x * per, n), i1 = min(i0 + per, n);
    int sc = 0, sb = 0;
    for (int i = i0; i < i1; ++i) {
      sc += hist[i];
      sb += hist[i] > 0;
    }
    int tot_c, tot_b;
    int oc = carry_h + block_scan(sc, scratch, tot_c);
    int ob = bb + carry_b + block_scan(sb, scratch, tot_b);
    for (int i = i0; i < i1; ++i) {
      const int c = hist[i];
      if (c > 0 && ob < total) {
        key_out[ob] = r * NG + lo + i;
        first_out[ob] = hb + oc;
        count_out[ob] = c;
        ++ob;
      }
      hist[i] = oc;
      oc += c;
    }
    carry_h += tot_c;
    carry_b += tot_b;
    __syncthreads();
    walk(wpre, cst, post_seq, W, n_seqs, hits, lo, n,
         [&](int w, int p, int key) {
           const int slot = hb + atomicAdd(&hist[key], 1);
           if (slot >= total) return;  // a caller's total below the hits
           a_out[slot] = w < W ? w : w - W;
           b_out[slot] = post_off[p];
         });
    __syncthreads();
  }
}

}  // namespace

// contrib, cstart: int32 [R, W2]; post_seq, post_off: the posting table;
// total: the chunk's hits (the sum of contrib), no slot past it is
// written.  Outputs: a, b int32 [total]; key, first, count int32 [total];
// nb_total int32 [1]; scratch int32 [2 R].  bins_per_pass <= 0 takes as
// many keys a pass as shared memory holds.  Returns the first launch
// error (cudaGetLastError()), or cudaErrorInvalidValue for shapes the
// kernels do not take.
extern "C" int t1k_cand_census(const void* contrib, const void* cstart,
                               const void* post_seq, const void* post_off,
                               int R, int W2, int n_seqs, int total,
                               int bins_per_pass,
                               void* a, void* b, void* key, void* first,
                               void* count, void* nb_total, void* scratch,
                               void* stream) {
  if (R <= 0) return 0;
  if (W2 <= 0 || (W2 & 1) || n_seqs <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int NG = 2 * n_seqs;
  const size_t win = (size_t)(2 * W2 + 1) * sizeof(int);
  const size_t room = (size_t)optin - 32 * sizeof(int);  // static scratch
  if (win + 32 * sizeof(int) > room) return (int)cudaErrorInvalidValue;
  const int cap = (int)((room - win) / sizeof(int));
  int bins = bins_per_pass > 0 ? bins_per_pass : NG;
  bins = bins < NG ? bins : NG;
  bins = bins < cap ? bins : cap;
  int bits = bins_per_pass > 0 ? bins : NG;
  const int cap_bits = cap < (1 << 26) ? cap * 32 : (1 << 30);
  bits = bits < cap_bits ? bits : cap_bits;
  const size_t smem_count = win + (size_t)((bits + 31) / 32) * sizeof(int);
  const size_t smem_write = win + (size_t)bins * sizeof(int);
  cudaFuncSetAttribute(count_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_count);
  cudaFuncSetAttribute(write_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_write);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* hits = static_cast<int32_t*>(scratch);
  int32_t* nbk = hits + R;
  count_kernel<<<R, kThreads, smem_count, s>>>(
      static_cast<const int32_t*>(contrib), static_cast<const int32_t*>(cstart),
      static_cast<const int32_t*>(post_seq), W2, n_seqs, bits, hits, nbk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  write_kernel<<<R, kThreads, smem_write, s>>>(
      static_cast<const int32_t*>(contrib), static_cast<const int32_t*>(cstart),
      static_cast<const int32_t*>(post_seq),
      static_cast<const int32_t*>(post_off), R, W2, n_seqs, bins, total,
      hits, nbk,
      static_cast<int32_t*>(a), static_cast<int32_t*>(b),
      static_cast<int32_t*>(key), static_cast<int32_t*>(first),
      static_cast<int32_t*>(count), static_cast<int32_t*>(nb_total));
  return (int)cudaGetLastError();
}
