// SQUAREM-accelerated EM over the read-group x equivalence-class incidence,
// in the native oracle's exact operation order.
//
// Replaces the jitted XLA programs t1k_tpu/ops/em.py::_em_loop_dense
// (with _squarem_while and _make_mask_reset); in its cohort form,
// _em_loop_dense_batched (the SMART-seq second pass: one block per
// cell, where the reference pads every cell to one [C, R, K] envelope
// and freezes the cells that converge); and in its sharded form the
// per-shard step of t1k_tpu/parallel/mesh.py::em_quantify_sharded_squarem
// and em_quantify_sharded (K13, see below).  Same contract as
// t1k_tpu/native/em.cc (reference Genotyper.hpp:372-437, 1142-1328): two
// EM updates, the SQUAREM extrapolation, one stabilizing update, L1
// convergence below 1e-5 with one forced extra round, and the
// every-10-rounds low-abundance major-allele mask.  Every floating-point
// sum runs in em.cc's order, and the file is built with -fmad=false, so
// the result is bit-identical to the native loop: the genotyper's
// six-decimal abundances (and the allele calls that follow from them)
// are the native route's, which a dense matvec's reordered sums do not
// give at HLA scale.
//
// What bounds it on an H100.  The order contract forces chains of
// dependent f64 adds - per EM update a read group's EC sum, an EC's sum
// over its read groups and the normalizer over the ECs; per round
// alpha's two sums and the L1 change - and the rounds are sequential.
// On the HLA problem those chains take about a tenth of the kernel's time
// (chip_smoke.py's chain bound).  What one block pays for is the rest,
// which the contract leaves free to run ahead of the adds: per EM update
// one random shared-memory gather per incidence in each pass (each warp
// gather costs several bank-conflicting wavefronts) and one correctly
// rounded f64 divide per incidence in the CSC pass.  Those are the
// floors that only a design across SMs would lift.  The cohort form is
// bound by its longest cell's add chain, and the cells' chains spread
// over the SMs' resident warps, one warp a chain.  Its cells are small
// (tens of ECs, hundreds of read groups), and on the card a round of
// such a cell is a chain of latencies far above its adds: the CSC pass's
// correctly rounded divides, a few hundred cycles each, waited on one
// after another down each column (three quarters of a 600 x 48 cell's
// round at 1,024 threads), the list loads, the one-thread folds.
//
// Design: the whole convergence loop is one launch of one block
// (squarem_kernel, 1,024 threads); the cohort form
// (squarem_batched_kernel) runs the same block code once per cell, each
// block on its own cell, with kW threads (32 to 1,024): the host gives
// every cell of a cohort its share of the threads the card holds at once
// (ops/em.py::cohort_width: 256 for 384 cells on 132 SMs, at most 512),
// deals its lists at that width, and launches each (form, width) class
// once, every class on its own stream.  A cell whose vectors and lists
// fit in shared memory (kStagedForm, every cell of a plate) has its lists
// copied there first, and its CSC pass computes every term at once across
// the block before each thread adds its column's terms in order.  Each
// (form, width) is built for the resident blocks that keep its registers
// off the stack (cohort_blocks).
//   * The per-read-group pairs (psum, the group count: one 16-byte
//     gather per CSC term) and the per-EC vectors (x0-x3, count,
//     per_len, the effective lengths) live in dynamic shared memory when
//     they fit (kShared); otherwise the same code runs on device-memory
//     copies.  The index lists stay in device memory (but in the cohort's
//     staged form), laid out by the host so that a warp's 32 threads,
//     each walking its own list, read 128 contiguous bytes a load.
//   * CSR pass: one thread per read group sums its ECs in the group's
//     order; CSC pass: one thread per EC sums its read groups' shares in
//     ascending read-group order (em.cc's scatter order).  The host deals
//     both kinds of list longest first in a snake, so that no thread
//     takes two long ones and a warp's lists are of about one length.
//     Both load the next kUnroll indices, and gather and divide kUnroll
//     terms, ahead of the running add.  An EC the mask zeroed is not
//     folded (its sum is exactly +0), which also keeps zero dividends,
//     slow in the divide, out of the pass.
//   * The EC-length sums (normalizer, alpha's sum_r and sum_v, the L1
//     change): every thread writes its terms to a vector, then one thread
//     folds it left to right with the loads running ahead; sum_r and
//     sum_v fold on two warps at once (on one thread, interleaved, in a
//     one-warp block).  x0 = x1 is a pointer swap.
//   * The mask: one thread per major allele sums its alleles in ascending
//     order (the host's major -> alleles lists), which is em.cc's chain;
//     the gene maximum is exact in any order (an integer atomicMax on the
//     bits of a positive float).
// kProf adds per-phase clock64() counts taken by thread 0 at the barriers.
//
// The sharded form (parallel/mesh.py, multihost.py) cuts the read groups
// into contiguous shards, one per device or rank, and the host drives the
// rounds.  Per EM update each shard runs three kernels with the lists of
// list_fold's layout in device memory: estep_rows_kernel (a thread per
// read group: psum), estep_terms_kernel (a grid-stride loop over the
// column stream's positions, up to a full wave of the SMs: every entry's
// term count * (x / psum), computed once, written at its stream
// position) and estep_fold_kernel (a thread per EC, in blocks of one
// warp: its terms added in list order, adds only).  Only the folds run
// in shard order, each going on from the previous shard's partial
// counts, so every EC's count is em.cc's one chain and any shard count
// gives the native loop's bits (summing independent partials, as the
// reference's psum does, regroups that chain and moves SQUAREM's
// trajectory); every shard's rows and terms need only its own psum and
// go first.  sharded_tail_kernel, one
// block, then runs the round's serial folds with the single-problem
// form's device functions.
// What bounds it: em.cc's order makes each EC's count a chain of
// dependent adds, so an update's E-step is at least the longest row's
// chain plus the longest column's (chip_smoke.py's estep_bound).  The
// first design (estep_fused_kernel, kept for A/B timing) paid a
// dependent index load, a psum gather and a correctly rounded divide per
// term inside that chain, with kUnroll terms in flight, on the few SMs
// that one to ten thousand EC threads fill.  Now the divides spread over
// the card: the term pass is bound by the bytes it streams (per position
// its EC, row and count in, its term out: 24 bytes in f64) on a large
// shard, and by one wave's latency on the HLA problem's.  The fold only
// adds: its terms come from L2, where the term pass left them, through
// a ring in shared memory that cp.async keeps kFoldStages - 1 batches
// ahead of the chain, in blocks of one warp, so that each warp's copies
// have an SM to themselves.  On an H100 its time is the launch and the
// longest column's chain at about twice the 4.1 ns of an add.  The row
// pass keeps its fused form (its terms are x gathers, no divides), and
// the tail its ec_cnt-long folds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaskRound = 10;
constexpr int kUnroll = 4;     // terms ahead of the list folds' adds
constexpr int kFoldUnroll = 8;  // loads ahead of the one-thread folds

// Phases of the profiled instantiation's cycle counts, then the total.
enum Phase { kCsr, kCsc, kNorm, kAlpha, kDiff, kMask, kPhases };

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

// max(*a, v) for v > 0 and *a >= +0: positive floats order as their bits.
__device__ __forceinline__ void atomic_max_pos(float* a, float v) {
  atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_pos(double* a, double v) {
  atomicMax(reinterpret_cast<unsigned long long*>(a),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

// One pass's lists (CSR rows or CSC columns) as the host deals them to
// a block of W threads: slot k*W + t holds the list thread t folds in its
// k-th turn (sched, -1 for none) and its length; the 32 slots of a warp
// share a block of the stream at base[slot / 32], element j of lane l's
// list at base + 32*j + l, so a warp's loads are coalesced; the stream
// holds stream_len elements (the cohort form's staging copies them).
struct Lists {
  int32_t slots, stream_len;
  const int32_t* sched;
  const int32_t* len;
  const int64_t* base;
  const int32_t* stream;
};

template <typename T>
struct Problem {
  int32_t ec_cnt, allele_cnt, gene_cnt, major_cnt, max_iterations;
  int64_t rg_cnt;
  Lists rows;                // read group -> ECs, in the group's order
  Lists cols;                // EC -> read groups, ascending
  const T* rg_counts;        // [rg_cnt]
  const int64_t* ec_off;     // [ec_cnt + 1] CSR: EC -> alleles
  const int32_t* ec_alleles;
  const T* ec_len;           // [ec_cnt] shortest effective length
  const int32_t* allele_gene;
  const int32_t* allele_major;
  const int64_t* maj_off;    // [major_cnt + 1] CSR: major -> alleles (asc)
  const int32_t* maj_alleles;
  const T* init_x;           // [ec_cnt]
  T filter_frac, min_alpha;
};

// Device-memory buffers (grp: [rg_cnt][2]).  The shared instantiation
// uses only `count` (written once, at the end) and the mask's arrays.
template <typename T>
struct Scratch {
  T *x0, *x1, *x2, *x3, *count, *grp, *per_len;
  T *allele_abund, *allele_ec_abund, *major_abund, *gene_max;
};

// The loop's working vectors, in shared or device memory; grp[2 r] is
// read group r's psum, grp[2 r + 1] its count; the staged form's CSC
// terms at their stream positions.
template <typename T>
struct Vecs {
  T *x0, *x1, *x2, *x3, *count, *per_len, *grp, *terms;
  const T* ec_len;
};

__host__ __device__ constexpr size_t align8(size_t n) {
  return (n + 7) & ~(size_t)7;
}

// Dynamic shared memory of the kShared form for one problem.
template <typename T>
__host__ __device__ size_t shared_bytes(int64_t rg_cnt, int64_t ec_cnt) {
  return (2 * (size_t)rg_cnt + 7 * (size_t)ec_cnt) * sizeof(T);
}

// Shared bytes of one pass's lists staged (ops/em.py::staged_bytes):
// base, then sched, len and stream, to a multiple of 8.
__host__ __device__ size_t staged_list_bytes(const Lists& l) {
  return align8(8 * (size_t)(l.slots / 32) +
                4 * (2 * (size_t)l.slots + (size_t)l.stream_len));
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <bool kProf>
__device__ __forceinline__ void mark(long long* cyc, int phase,
                                     long long& last) {
  if (kProf && threadIdx.x == 0) {
    const long long now = clock64();
    cyc[phase] += now - last;
    last = now;
  }
}

// a[0] + a[1] + ... + a[n-1], left to right from 0, by the calling
// thread; the next kFoldUnroll loads are issued before the current adds.
template <typename T>
__device__ __forceinline__ T fold_seq(const T* a, int n) {
  T sum = 0;
  int i = 0;
  if (n >= kFoldUnroll) {
    T cur[kFoldUnroll];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) cur[u] = a[u];
    for (i = kFoldUnroll; i + kFoldUnroll <= n; i += kFoldUnroll) {
      T nxt[kFoldUnroll];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) nxt[u] = a[i + u];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) sum += cur[u];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) sum += cur[u];
  }
  for (; i < n; ++i) sum += a[i];
  return sum;
}

// fold_seq(a, n) into *sum_a and fold_seq(b, n) into *sum_b, the two
// chains interleaved on the calling thread.
template <typename T>
__device__ __forceinline__ void fold_two(const T* a, const T* b, int n,
                                         T* sum_a, T* sum_b) {
  T sa = 0, sb = 0;
  int i = 0;
  for (; i + kUnroll <= n; i += kUnroll) {
    T ta[kUnroll], tb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ta[u] = a[i + u];
      tb[u] = b[i + u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sa += ta[u];
      sb += tb[u];
    }
  }
  for (; i < n; ++i) {
    sa += a[i];
    sb += b[i];
  }
  *sum_a = sa;
  *sum_b = sb;
}

// An index of a list: through the read-only cache from device memory,
// or a plain load where the lists are staged in shared memory.
template <bool kStaged>
__device__ __forceinline__ int32_t index_at(const int32_t* a) {
  if constexpr (kStaged)
    return *a;
  else
    return __ldg(a);
}

// term(l[0]) + term(l[1]) + ... in list order from 0, for the list l a
// thread's slot holds (`base` its lane's first element, `n` its length).
// kU terms at a time, their indices loaded one batch ahead; a batch's
// terms are computed before its adds, and past the list's end a term (of
// index 0, always valid) is computed but not added.
template <typename T, bool kStaged = false, int kU = kUnroll, typename Term>
__device__ __forceinline__ T list_fold(const int32_t* base, int n,
                                       Term term) {
  T sum = 0;
  int32_t cur[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u)
    cur[u] = u < n ? index_at<kStaged>(base + 32 * u) : 0;
  for (int j = 0; j < n; j += kU) {
    int32_t nxt[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = j + kU + u;
      nxt[u] = k < n ? index_at<kStaged>(base + 32 * k) : 0;
    }
    T t[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) t[u] = term(cur[u]);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (j + u < n) sum += t[u];
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
  return sum;
}

// a[0] + a[32] + ... + a[32 (n - 1)] (a lane's list of precomputed
// terms), left to right from 0, the next kU loads issued before the
// current adds.
template <typename T, int kU>
__device__ __forceinline__ T term_fold(const T* a, int n) {
  T sum = 0;
  int j = 0;
  for (; j + kU <= n; j += kU) {
    T t[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) t[u] = a[32 * (j + u)];
#pragma unroll
    for (int u = 0; u < kU; ++u) sum += t[u];
  }
  for (; j < n; ++j) sum += a[32 * j];
  return sum;
}

// out = per_len / (per_len[0] + ... + per_len[n-1]), em.cc's normalizer;
// s_norm: a shared scalar.
template <int kW, typename T>
__device__ __forceinline__ void normalize(const T* per_len, int n, T* out,
                                          T* s_norm) {
  const int tid = threadIdx.x;
  if (tid == 0) *s_norm = fold_seq(per_len, n);
  __syncthreads();
  const T norm = *s_norm;
  for (int e = tid; e < n; e += kW) out[e] = per_len[e] / norm;
  __syncthreads();
}

// x3 = the SQUAREM extrapolation of x0, x1, x2 (em.cc): alpha from the
// sums of r^2 (through x3) and v^2 (through per_len), folded on two warps
// at once (interleaved on one thread in a one-warp block) into s_fold[1]
// and s_fold[2], then clamped at min_alpha.
template <int kW, typename T>
__device__ __forceinline__ void extrapolate(const Vecs<T>& v, int ec,
                                            T min_alpha, T* s_fold) {
  const int tid = threadIdx.x;
  for (int i = tid; i < ec; i += kW) {
    const T r = v.x1[i] - v.x0[i];
    const T w = v.x2[i] - 2 * v.x1[i] + v.x0[i];
    v.x3[i] = r * r;
    v.per_len[i] = w * w;
  }
  __syncthreads();
  if constexpr (kW > 32) {
    if (tid == 0) s_fold[1] = fold_seq(v.x3, ec);
    if (tid == 32) s_fold[2] = fold_seq(v.per_len, ec);
  } else if (tid == 0) {
    fold_two(v.x3, v.per_len, ec, &s_fold[1], &s_fold[2]);
  }
  __syncthreads();
  const T sum_r = s_fold[1], sum_v = s_fold[2];
  T alpha = sum_v == 0 ? (T)-1 : -sqrt_of(sum_r) / sqrt_of(sum_v);
  if (min_alpha < 0 && alpha < min_alpha) alpha = min_alpha;
  for (int i = tid; i < ec; i += kW)
    v.x3[i] = v.x0[i] - 2 * alpha * (v.x1[i] - v.x0[i]) +
              alpha * alpha * (v.x2[i] - 2 * v.x1[i] + v.x0[i]);
  __syncthreads();
}

// |x1 - x0| summed in order (em.cc's L1 change), its terms through x2.
template <int kW, typename T>
__device__ __forceinline__ T l1_change(const Vecs<T>& v, int ec, T* s_fold) {
  const int tid = threadIdx.x;
  for (int i = tid; i < ec; i += kW)
    v.x2[i] = abs_of(v.x1[i] - v.x0[i]);
  __syncthreads();
  if (tid == 0) s_fold[1] = fold_seq(v.x2, ec);
  __syncthreads();
  return s_fold[1];
}

// out = normalized EM update of `in`; leaves the expected read counts in
// v.count (em.cc emUpdate).  kStaged (lists in shared memory): the CSC
// pass first computes every term at its stream position on all kW
// threads at once, so a column's divides no longer wait on each other
// (each takes a few hundred cycles of latency), then each thread adds its
// column's terms in list order; the terms and their order are the fused
// pass's, so are the bits.
template <typename T, bool kProf, int kW, bool kStaged, int kU>
__device__ __forceinline__ void em_update(const Problem<T>& p,
                                          const Vecs<T>& v, const T* in,
                                          T* out, T* s_norm, long long* cyc,
                                          long long& last) {
  const int tid = threadIdx.x, lane = tid & 31;
  const Lists& rows = p.rows;
  for (int k = tid; k < rows.slots; k += kW) {
    const int i = rows.sched[k];
    if (i < 0) continue;
    const T sum = list_fold<T, kStaged, kU>(
        rows.stream + rows.base[k >> 5] + lane, rows.len[k],
        [&](int32_t e) { return in[e]; });
    v.grp[2 * i] = sum == 0 ? (T)1 : sum;
  }
  __syncthreads();
  mark<kProf>(cyc, kCsr, last);
  const Lists& cols = p.cols;
  const auto* grp = reinterpret_cast<const typename Pair<T>::type*>(v.grp);
  if constexpr (kStaged) {
    // position q of the stream is element (q - base[w]) / 32 of the list
    // in slot 32 w + lane (q = lane mod 32), w its warp block
    int w = 0;
    for (int q = tid; q < cols.stream_len; q += kW) {
      while ((w + 1) * 32 < cols.slots && cols.base[w + 1] <= q) ++w;
      const int k = 32 * w + lane;
      const int e = cols.sched[k];
      T term = 0;
      if (e >= 0 && (q - (int)cols.base[w]) / 32 < cols.len[k]) {
        const T xe = in[e];
        if (xe != 0) {
          const auto g = grp[cols.stream[q]];
          term = g.y * (xe / g.x);
        }
      }
      v.terms[q] = term;
    }
    __syncthreads();
  }
  for (int k = tid; k < cols.slots; k += kW) {
    const int e = cols.sched[k];
    if (e < 0) continue;
    // an EC the mask zeroed: every term count * (0 / psum) is +0 or -0
    // (psum > 0), so the sum from +0 is +0 - without the divides, whose
    // zero-dividend case leaves the fast path
    const T xe = in[e];
    T c;
    if constexpr (kStaged)
      c = xe == 0 ? (T)0 : term_fold<T, kU>(
          v.terms + cols.base[k >> 5] + lane, cols.len[k]);
    else
      c = xe == 0 ? (T)0 : list_fold<T, false, kU>(
          cols.stream + cols.base[k >> 5] + lane, cols.len[k],
          [&](int32_t r) {
            const auto g = grp[r];
            return g.y * (xe / g.x);
          });
    v.count[e] = c;
    v.per_len[e] = c / v.ec_len[e];
  }
  __syncthreads();
  mark<kProf>(cyc, kCsc, last);
  normalize<kW>(v.per_len, p.ec_cnt, out, s_norm);
  mark<kProf>(cyc, kNorm, last);
}

// Low-abundance major-allele mask; resets x0 (em.cc maskAndReset).
template <int kW, typename T>
__device__ __forceinline__ void mask_reset(const Problem<T>& p,
                                           const Scratch<T>& s,
                                           const Vecs<T>& v) {
  const int tid = threadIdx.x;
  for (int a = tid; a < p.allele_cnt; a += kW)
    s.allele_abund[a] = s.allele_ec_abund[a] = 0;
  for (int g = tid; g < p.gene_cnt; g += kW) s.gene_max[g] = 0;
  __syncthreads();
  for (int e = tid; e < p.ec_cnt; e += kW) {
    const int64_t size = p.ec_off[e + 1] - p.ec_off[e];
    const T abund = v.count[e] / v.ec_len[e] * (T)1000.0;
    for (int64_t j = p.ec_off[e]; j < p.ec_off[e + 1]; ++j) {
      s.allele_abund[p.ec_alleles[j]] = abund / (T)size;
      s.allele_ec_abund[p.ec_alleles[j]] = abund;
    }
  }
  __syncthreads();
  for (int m = tid; m < p.major_cnt; m += kW) {
    T sum = 0;
    for (int64_t j = p.maj_off[m]; j < p.maj_off[m + 1]; ++j)
      sum += s.allele_abund[p.maj_alleles[j]];
    s.major_abund[m] = sum;
  }
  __syncthreads();
  // em.cc: gene_max starts at 0 and takes a value only if it is larger
  for (int a = tid; a < p.allele_cnt; a += kW) {
    const T w = s.major_abund[p.allele_major[a]];
    if (w > 0) atomic_max_pos(&s.gene_max[p.allele_gene[a]], w);
  }
  __syncthreads();
  for (int a = tid; a < p.allele_cnt; a += kW) {
    if (s.major_abund[p.allele_major[a]] <
        p.filter_frac * (T)0.5 * s.gene_max[p.allele_gene[a]]) {
      s.allele_abund[a] = 0;
      s.allele_ec_abund[a] = 0;
    }
  }
  __syncthreads();
  for (int e = tid; e < p.ec_cnt; e += kW)
    v.x0[e] = s.allele_ec_abund[p.ec_alleles[p.ec_off[e]]];
  __syncthreads();
}

// The whole convergence loop of problem p on the calling block of kW
// threads.  `smem` is the block's dynamic shared memory (the kShared
// form's vectors), s_fold three shared scalars: normalizer / sum_r and
// L1 change, sum_v.  kStaged: p's lists lie in shared memory, behind the
// vectors, and the CSC terms behind them; kU: the list folds' batch.
template <typename T, bool kShared, bool kProf, int kW, bool kStaged = false,
          int kU = kUnroll>
__device__ __forceinline__ void squarem_block(const Problem<T>& p,
                                              const Scratch<T>& s,
                                              int32_t* iterations,
                                              long long* cycles,
                                              unsigned char* smem,
                                              T* s_fold) {
  const int tid = threadIdx.x;
  const int ec = p.ec_cnt;
  Vecs<T> v;
  if constexpr (kShared) {
    T* base = reinterpret_cast<T*>(smem);
    T* len = base + 2 * p.rg_cnt + 6 * (int64_t)ec;
    v.grp = base;
    v.x0 = base + 2 * p.rg_cnt;
    v.x1 = v.x0 + ec;
    v.x2 = v.x1 + ec;
    v.x3 = v.x2 + ec;
    v.count = v.x3 + ec;
    v.per_len = v.count + ec;
    for (int e = tid; e < ec; e += kW) len[e] = p.ec_len[e];
    v.ec_len = len;
    if constexpr (kStaged)
      v.terms = reinterpret_cast<T*>(
          smem + align8(shared_bytes<T>(p.rg_cnt, ec)) +
          staged_list_bytes(p.rows) + staged_list_bytes(p.cols));
  } else {
    v.grp = s.grp;
    v.x0 = s.x0;
    v.x1 = s.x1;
    v.x2 = s.x2;
    v.x3 = s.x3;
    v.count = s.count;
    v.per_len = s.per_len;
    v.ec_len = p.ec_len;
  }
  for (int64_t i = tid; i < p.rg_cnt; i += kW)
    v.grp[2 * i + 1] = p.rg_counts[i];
  for (int e = tid; e < ec; e += kW) v.x0[e] = p.init_x[e];
  __syncthreads();
  long long cyc[kPhases] = {};
  long long last = kProf ? clock64() : 0;
  const long long start = last;

  int ret = 0;
  for (int t = 0; t < p.max_iterations; ++t) {
    ++ret;
    em_update<T, kProf, kW, kStaged, kU>(p, v, v.x0, v.x1, &s_fold[0], cyc,
                                         last);
    em_update<T, kProf, kW, kStaged, kU>(p, v, v.x1, v.x2, &s_fold[0], cyc,
                                         last);
    extrapolate<kW>(v, ec, p.min_alpha, s_fold);  // x3, from r^2 and v^2
    mark<kProf>(cyc, kAlpha, last);
    em_update<T, kProf, kW, kStaged, kU>(p, v, v.x3, v.x1, &s_fold[0], cyc,
                                         last);
    const T diff = l1_change<kW>(v, ec, s_fold);
    T* const old_x0 = v.x0;  // x0 = x1
    v.x0 = v.x1;
    v.x1 = old_x0;
    mark<kProf>(cyc, kDiff, last);
    if (diff < (T)1e-5 && t < p.max_iterations - 2) t = p.max_iterations - 2;
    if (t > 0 && t % kMaskRound == 0) {
      mask_reset<kW>(p, s, v);
      mark<kProf>(cyc, kMask, last);
    }
  }
  if constexpr (kShared)
    for (int e = tid; e < ec; e += kW) s.count[e] = v.count[e];
  if (tid == 0) {
    *iterations = ret;
    if (kProf) {
      for (int k = 0; k < kPhases; ++k) cycles[k] = cyc[k];
      cycles[kPhases] = clock64() - start;
    }
  }
}

template <typename T, bool kShared, bool kProf>
__global__ void __launch_bounds__(kThreads)
squarem_kernel(Problem<T> p, Scratch<T> s, int32_t* iterations,
               long long* cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_fold[3];
  squarem_block<T, kShared, kProf, kThreads>(p, s, iterations, cycles, smem,
                                            s_fold);
}

// The cohort form's cell forms: vectors and lists in device memory; the
// vectors in shared memory (kShared); vectors and lists in shared memory.
enum Form { kDeviceForm, kSharedForm, kStagedForm };

// The cohort form's blocks: kW threads, a power of two from 32 to
// kThreads, the host's choice per cohort (ops/em.py::cohort_width).  Each
// (form, width) is built for cohort_blocks resident blocks an SM, so a
// thread may hold 65,536 / (kW x that) registers: the shared-memory forms
// 64 at every width, 1,024 threads an SM whatever the width, with the
// list folds in batches of kCohortUnroll = 2, which is what fits 64
// without spilling; the device-memory form 128 up to 512 threads (it
// takes 116-122) and 64 at 1,024, where it spills and no rule sends it.
constexpr int cohort_blocks(int form, int w) {
  return form != kDeviceForm ? kThreads / w : w < 512 ? 512 / w : 1;
}
template <int kForm, int kW>
constexpr int kCohortUnroll =
    kForm != kDeviceForm || kW == kThreads ? 2 : kUnroll;

// l's arrays copied by the block's kW threads to shared memory at `at`
// (8-aligned, staged_list_bytes(l) of room); returns the copy.
template <int kW>
__device__ Lists stage_lists(const Lists& l, unsigned char* at) {
  Lists c = l;
  auto* base = reinterpret_cast<int64_t*>(at);
  auto* sched = reinterpret_cast<int32_t*>(base + l.slots / 32);
  int32_t* len = sched + l.slots;
  int32_t* stream = len + l.slots;
  for (int i = threadIdx.x; i < l.slots / 32; i += kW) base[i] = l.base[i];
  for (int i = threadIdx.x; i < l.slots; i += kW) {
    sched[i] = l.sched[i];
    len[i] = l.len[i];
  }
  for (int i = threadIdx.x; i < l.stream_len; i += kW)
    stream[i] = l.stream[i];
  c.base = base;
  c.sched = sched;
  c.len = len;
  c.stream = stream;
  return c;
}

// Block b runs problem b of the cohort (problems[b], scratch[b],
// iterations[b]; the options are the launch's): the replacement of the
// reference's batched program, every cell with the native loop's bits.
// Thread 0 copies the cell's structs into shared memory before the first
// barrier; the staged form then copies both passes' lists behind the
// vectors, so the loop's index loads stay on the SM.  A converged block
// exits, so nothing freezes finished cells.
template <typename T, int kForm, int kW>
__global__ void __launch_bounds__(kW, cohort_blocks(kForm, kW))
squarem_batched_kernel(const Problem<T>* problems, const Scratch<T>* scratch,
                       int32_t* iterations, int max_iterations,
                       T filter_frac, T min_alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_fold[3];
  __shared__ Problem<T> p;
  __shared__ Scratch<T> s;
  if (threadIdx.x == 0) {
    p = problems[blockIdx.x];
    p.max_iterations = max_iterations;
    p.filter_frac = filter_frac;
    p.min_alpha = min_alpha;
    s = scratch[blockIdx.x];
  }
  __syncthreads();
  if constexpr (kForm == kStagedForm) {
    unsigned char* at = smem + align8(shared_bytes<T>(p.rg_cnt, p.ec_cnt));
    const Lists rows = stage_lists<kW>(p.rows, at);
    const Lists cols =
        stage_lists<kW>(p.cols, at + staged_list_bytes(p.rows));
    __syncthreads();
    if (threadIdx.x == 0) {
      p.rows = rows;
      p.cols = cols;
    }
    __syncthreads();
  }
  squarem_block<T, kForm != kDeviceForm, false, kW, kForm == kStagedForm,
                kCohortUnroll<kForm, kW>>(p, s, iterations + blockIdx.x,
                                          nullptr, smem, s_fold);
}

// ---- The sharded form (K13): one EM update over read-group shards.
// Each shard's E-step runs on grids that span the SMs.  The shards hold
// contiguous read groups, and each EC's count is em.cc's one chain over
// them in ascending order: shard s's column fold continues the chain
// from shard s-1's partial (carry), so any shard count gives the native
// loop's bits.  The round's tail (the normalizer, the extrapolation, the
// L1 change, the mask) runs on one block.

constexpr int kEstepThreads = 256;
// Stream positions a thread of the term pass takes at once (a grid
// stride apart), their loads issued before any of their terms.
constexpr int kTermUnroll = 4;
// Terms a batch of the column fold's chain, and the batches of its ring
// in shared memory, filled by cp.async: kFoldStages - 1 batches are in
// flight while the chain adds one.
constexpr int kChainUnroll = 32;
constexpr int kFoldStages = 4;
static_assert(kFoldStages > 1, "the fold's ring needs a stage in flight");
// The fold's block: its warps each read 256 bytes a load, so blocks of
// one warp spread those loads over as many SMs as there are warps.
constexpr int kFoldThreads = 32;

// *dst = *src (sizeof(T) bytes), global to shared, asynchronously: the
// copy lands by the issuing thread's next cp.async.wait_group that
// covers its group.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kN>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kN) : "memory");
}

// start + a[0] + a[32] + ... + a[32 (n - 1)] (a lane's list of
// precomputed terms), left to right, the terms copied ahead into the
// lane's column of a ring of kS stages of kU rows (ring: kS * kU * 32
// elements of shared memory a warp, each lane reading only what it
// copied), so that kS - 1 batches are in flight while the chain adds
// one.
template <typename T, int kU, int kS>
__device__ __forceinline__ T staged_chain(const T* a, int n, T sum,
                                          T* ring) {
  const int lane = threadIdx.x & 31;
  const int batches = (n + kU - 1) / kU;
  auto issue = [&](int b) {   // batch b into stage b % kS (a group each)
    if (b < batches) {
      T* s = ring + (b % kS) * kU * 32 + lane;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (b * kU + u < n) copy_async(s + 32 * u, a + 32 * (b * kU + u));
    }
    async_commit();
  };
#pragma unroll
  for (int b = 0; b < kS - 1; ++b) issue(b);
  for (int b = 0; b < batches; ++b) {
    // the stage batch b + kS - 1 takes is batch b - 1's, whose reads
    // the previous iteration's adds have waited for
    issue(b + kS - 1);
    async_wait<kS - 1>();   // batch b has landed
    const T* s = ring + (b % kS) * kU * 32 + lane;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (b * kU + u < n) sum += s[32 * u];
  }
  return sum;
}

// CSR pass of a shard: thread k folds the ECs of the read group in slot k
// (x in the group's order); psum[i] = that sum, or 1 where it is 0.
template <typename T>
__global__ void __launch_bounds__(kEstepThreads)
estep_rows_kernel(Lists rows, const T* x, T* psum) {
  const int64_t k = (int64_t)blockIdx.x * kEstepThreads + threadIdx.x;
  if (k >= rows.slots) return;
  const int i = rows.sched[k];
  if (i < 0) return;
  const T sum = list_fold<T>(rows.stream + rows.base[k >> 5] +
                                 (threadIdx.x & 31),
                             rows.len[k], [&](int32_t e) { return x[e]; });
  psum[i] = sum == 0 ? (T)1 : sum;
}

// Term pass of a shard's columns, a grid-stride loop over the column
// stream's positions, kTermUnroll a stride apart at once: at each real
// entry (ecs[q], its EC, is -1 past a list's end) of an EC whose x is
// not 0, terms[q] = cts[q] * (x[e] / psum[rows[q]]), the fused pass's
// operations.  Padding positions and the terms of an EC whose x is 0
// are not written: the fold reads neither.
template <typename T>
__global__ void __launch_bounds__(kEstepThreads)
estep_terms_kernel(int64_t n, const int32_t* ecs, const int32_t* rows,
                   const T* cts, const T* x, const T* psum, T* terms) {
  const int64_t stride = (int64_t)gridDim.x * kEstepThreads;
  for (int64_t q0 = (int64_t)blockIdx.x * kEstepThreads + threadIdx.x;
       q0 < n; q0 += kTermUnroll * stride) {
    int32_t e[kTermUnroll], r[kTermUnroll];
    T c[kTermUnroll], xe[kTermUnroll], p[kTermUnroll];
#pragma unroll
    for (int u = 0; u < kTermUnroll; ++u) {
      const int64_t q = q0 + u * stride;
      e[u] = q < n ? __ldg(ecs + q) : -1;
      r[u] = q < n ? __ldg(rows + q) : 0;
      c[u] = q < n ? __ldg(cts + q) : (T)0;
    }
#pragma unroll
    for (int u = 0; u < kTermUnroll; ++u) {
      xe[u] = e[u] >= 0 ? x[e[u]] : (T)0;
      p[u] = e[u] >= 0 ? psum[r[u]] : (T)1;
    }
#pragma unroll
    for (int u = 0; u < kTermUnroll; ++u)
      if (xe[u] != 0) terms[q0 + u * stride] = c[u] * (xe[u] / p[u]);
  }
}

// Column fold of a shard: thread k adds the terms of the EC in slot k in
// list order (read groups ascending, em.cc's scatter order) onto
// count[e]: from 0, or with `carry` from the previous shard's partial
// there.  Adds only: the terms are the term pass's.  An EC whose x is 0
// adds only zeros, so its count stays as it is (as in em_update).
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
estep_fold_kernel(Lists cols, const T* terms, const T* x, T* count,
                  bool carry) {
  __shared__ T ring[kFoldThreads / 32][kFoldStages * kChainUnroll * 32];
  const int64_t k = (int64_t)blockIdx.x * kFoldThreads + threadIdx.x;
  if (k >= cols.slots) return;
  const int e = cols.sched[k];
  if (e < 0) return;
  const T start = carry ? count[e] : (T)0;
  if (x[e] == 0) {
    count[e] = start;
    return;
  }
  count[e] = staged_chain<T, kChainUnroll, kFoldStages>(
      terms + cols.base[k >> 5] + (threadIdx.x & 31), cols.len[k], start,
      ring[threadIdx.x >> 5]);
}

// The first design's column pass, kept for A/B timing only:
// thread k computes and adds the terms of the EC in slot k, kUnroll terms
// computed before their adds, each a dependent index load, a psum gather
// and a divide; past the list's end a term (of element 0) is computed
// but not added.  The same terms in the same order as the term pass and
// the fold, so the same bits.
template <typename T>
__device__ __forceinline__ T entry_fold(const int32_t* rows, const T* cts,
                                        int n, T xe, const T* psum,
                                        T start) {
  T sum = start;
  for (int j = 0; j < n; j += kUnroll) {
    T t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = j + u < n ? j + u : 0;
      t[u] = cts[32 * i] * (xe / psum[__ldg(rows + 32 * i)]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u < n) sum += t[u];
  }
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kEstepThreads)
estep_fused_kernel(Lists cols, const T* cts, const T* x, const T* psum,
                   T* count, bool carry) {
  const int64_t k = (int64_t)blockIdx.x * kEstepThreads + threadIdx.x;
  if (k >= cols.slots) return;
  const int e = cols.sched[k];
  if (e < 0) return;
  const T xe = x[e];
  const T start = carry ? count[e] : (T)0;
  const int64_t at = cols.base[k >> 5] + (threadIdx.x & 31);
  count[e] = xe == 0 ? start
                     : entry_fold(cols.stream + at, cts + at, cols.len[k],
                                  xe, psum, start);
}

// The round's tail on the first shard's device (or on each rank, from the
// same counts): v.count holds the update's counts; state is (t,
// iterations).  Stage 0: x1 = update; 1: x2 = update, then x3 = the
// extrapolation; 2: x1 = update, the L1 change against x0, em.cc's t
// rule, and the mask into x1 (the caller then swaps x0 and x1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sharded_tail_kernel(int stage, int32_t* state, Vecs<T> v, Problem<T> p,
                    Scratch<T> s) {
  __shared__ T s_fold[3];
  __shared__ int s_mask;
  const int tid = threadIdx.x, ec = p.ec_cnt;
  for (int e = tid; e < ec; e += kThreads)
    v.per_len[e] = v.count[e] / v.ec_len[e];
  __syncthreads();
  normalize<kThreads>(v.per_len, ec, stage == 1 ? v.x2 : v.x1, &s_fold[0]);
  if (stage == 1) extrapolate<kThreads>(v, ec, p.min_alpha, s_fold);
  if (stage != 2) return;
  const T diff = l1_change<kThreads>(v, ec, s_fold);
  if (tid == 0) {
    int t = state[0];
    if (diff < (T)1e-5 && t < p.max_iterations - 2) t = p.max_iterations - 2;
    s_mask = t > 0 && t % kMaskRound == 0;
    state[0] = t + 1;
    state[1] += 1;
  }
  __syncthreads();
  if (s_mask) {
    v.x0 = v.x1;  // the next round's x0
    mask_reset<kThreads>(p, s, v);
  }
}

// Raises the kernel's dynamic shared-memory cap to `bytes` (per
// instantiation); returns the CUDA error code.
template <typename Kernel>
int allow_shared(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // not left for a later check
  return (int)err;
}

template <typename T, bool kShared, bool kProf>
int launch_as(const Problem<T>& p, const Scratch<T>& s, int32_t* iterations,
              long long* cycles, cudaStream_t stream) {
  auto kernel = squarem_kernel<T, kShared, kProf>;
  size_t bytes = 0;
  if constexpr (kShared) {
    bytes = shared_bytes<T>(p.rg_cnt, p.ec_cnt);
    if (const int err = allow_shared(kernel, bytes)) return err;
  }
  kernel<<<1, kThreads, bytes, stream>>>(p, s, iterations, cycles);
  return (int)cudaGetLastError();
}

// The device inputs in the order of t1k_em_squarem's `in`, and the
// scratch buffers in the order of its `scratch`.
constexpr int kIns = 17, kScratch = 11;
// A cohort's per-cell host row: ec_cnt, rg_cnt, the rows' and the
// columns' slot counts, the rows' and the columns' stream lengths, then
// the cell's element offset into each of the kIns inputs and the
// kScratch buffers.
constexpr int kCellDims = 6, kCellCols = kCellDims + kIns + kScratch;

// One pass's lists at element offsets off[0..3] of in[0..3].
Lists lists_at(const void* const* in, const int64_t* off, int64_t slots,
               int64_t stream_len = 0) {
  Lists l;
  l.slots = (int32_t)slots;
  l.stream_len = (int32_t)stream_len;
  l.sched = static_cast<const int32_t*>(in[0]) + off[0];
  l.len = static_cast<const int32_t*>(in[1]) + off[1];
  l.base = static_cast<const int64_t*>(in[2]) + off[2];
  l.stream = static_cast<const int32_t*>(in[3]) + off[3];
  return l;
}

// cell: a kCellCols row; common: allele_cnt, gene_cnt, major_cnt,
// max_iterations.
template <typename T>
Problem<T> problem_at(const void* const* in, const int64_t* cell,
                      const int64_t* common, double filter_frac,
                      double min_alpha) {
  const int64_t* off = cell + kCellDims;
  Problem<T> p;
  p.ec_cnt = (int32_t)cell[0];
  p.rg_cnt = cell[1];
  p.allele_cnt = (int32_t)common[0];
  p.gene_cnt = (int32_t)common[1];
  p.major_cnt = (int32_t)common[2];
  p.max_iterations = (int32_t)common[3];
  p.rows = lists_at(in, off, cell[2], cell[4]);
  p.cols = lists_at(in + 4, off + 4, cell[3], cell[5]);
  p.rg_counts = static_cast<const T*>(in[8]) + off[8];
  p.ec_off = static_cast<const int64_t*>(in[9]) + off[9];
  p.ec_alleles = static_cast<const int32_t*>(in[10]) + off[10];
  p.ec_len = static_cast<const T*>(in[11]) + off[11];
  p.allele_gene = static_cast<const int32_t*>(in[12]) + off[12];
  p.allele_major = static_cast<const int32_t*>(in[13]) + off[13];
  p.maj_off = static_cast<const int64_t*>(in[14]) + off[14];
  p.maj_alleles = static_cast<const int32_t*>(in[15]) + off[15];
  p.init_x = static_cast<const T*>(in[16]) + off[16];
  p.filter_frac = (T)filter_frac;
  p.min_alpha = (T)min_alpha;
  return p;
}

template <typename T>
Scratch<T> scratch_at(void* const* scratch, const int64_t* off) {
  Scratch<T> s;
  T** fields[kScratch] = {&s.x0, &s.x1, &s.x2, &s.x3, &s.count, &s.grp,
                          &s.per_len, &s.allele_abund, &s.allele_ec_abund,
                          &s.major_abund, &s.gene_max};
  for (int k = 0; k < kScratch; ++k)
    *fields[k] = static_cast<T*>(scratch[k]) + off[k];
  return s;
}

template <typename T>
int launch(const void* const* in, void* const* scratch, const int64_t* dims,
           double filter_frac, double min_alpha, bool shared,
           void* iterations, void* cycles, void* stream) {
  int64_t cell[kCellCols] = {dims[0], dims[4], dims[6], dims[7], 0, 0};
  const int64_t common[4] = {dims[1], dims[2], dims[3], dims[5]};
  const Problem<T> p =
      problem_at<T>(in, cell, common, filter_frac, min_alpha);
  const Scratch<T> s = scratch_at<T>(scratch, cell + kCellDims + kIns);
  auto* it = static_cast<int32_t*>(iterations);
  auto* cyc = static_cast<long long*>(cycles);
  auto st = static_cast<cudaStream_t>(stream);
  if (shared)
    return cyc ? launch_as<T, true, true>(p, s, it, cyc, st)
               : launch_as<T, true, false>(p, s, it, cyc, st);
  return cyc ? launch_as<T, false, true>(p, s, it, cyc, st)
             : launch_as<T, false, false>(p, s, it, cyc, st);
}

// The cohort's per-cell structs, Problem<T> x n_cells then Scratch<T> x
// n_cells, into host memory at `out` (the options left for the launch).
template <typename T>
void cells_at(int n_cells, const void* const* in, void* const* scratch,
              const int64_t* cells, const int64_t* common, void* out) {
  const int64_t dims[4] = {common[0], common[1], common[2], 0};
  auto* ps = static_cast<Problem<T>*>(out);
  auto* ss = reinterpret_cast<Scratch<T>*>(ps + n_cells);
  for (int b = 0; b < n_cells; ++b) {
    const int64_t* cell = cells + (int64_t)b * kCellCols;
    ps[b] = problem_at<T>(in, cell, dims, 0, 0);
    ss[b] = scratch_at<T>(scratch, cell + kCellDims + kIns);
  }
}

// f(kernel, kW) for the cohort kernel of one Form and `width` threads
// (kW from 32 up); another form or width gives cudaErrorInvalidValue.
template <typename T, int kW = 32, typename F>
int on_width(int form, int width, F&& f) {
  if (width == kW) {
    switch (form) {
      case kDeviceForm:
        return f(squarem_batched_kernel<T, kDeviceForm, kW>, kW);
      case kSharedForm:
        return f(squarem_batched_kernel<T, kSharedForm, kW>, kW);
      case kStagedForm:
        return f(squarem_batched_kernel<T, kStagedForm, kW>, kW);
    }
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (kW < kThreads)
    return on_width<T, 2 * kW>(form, width, f);
  else
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_batched(int n_cells, const void* structs, int form,
                   int64_t bytes, int width, int max_iterations,
                   double filter_frac, double min_alpha, void* iterations,
                   void* stream) {
  const auto* ps = static_cast<const Problem<T>*>(structs);
  const auto* ss = reinterpret_cast<const Scratch<T>*>(ps + n_cells);
  auto* it = static_cast<int32_t*>(iterations);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t dynamic = form == kDeviceForm ? 0 : (size_t)bytes;
  return on_width<T>(form, width, [&](auto kernel, int threads) {
    if (dynamic)
      if (const int err = allow_shared(kernel, dynamic)) return err;
    kernel<<<n_cells, threads, dynamic, st>>>(
        ps, ss, it, max_iterations, (T)filter_frac, (T)min_alpha);
    return (int)cudaGetLastError();
  });
}

// out: the cohort kernel's registers a thread, local (stack and spill)
// bytes a thread, static shared bytes, and resident blocks an SM at
// `bytes` of dynamic shared memory.
template <typename T>
int batched_attrs(int form, int width, int64_t bytes, int32_t* out) {
  const size_t dynamic = form == kDeviceForm ? 0 : (size_t)bytes;
  return on_width<T>(form, width, [&](auto kernel, int threads) {
    if (dynamic)
      if (const int err = allow_shared(kernel, dynamic)) return err;
    cudaFuncAttributes a;
    int blocks = 0;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, threads, dynamic);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    out[0] = a.numRegs;
    out[1] = (int32_t)a.localSizeBytes;
    out[2] = (int32_t)a.sharedSizeBytes;
    out[3] = blocks;
    return 0;
  });
}

template <typename T>
int launch_estep(int pass, const void* const* in, const int64_t* dims,
                 int carry, void* psum, void* terms, void* count,
                 void* stream) {
  const int64_t zero[4] = {0, 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const T*>(in[10]);
  const auto* cts = static_cast<const T*>(in[8]);
  if (pass == 0) {
    estep_rows_kernel<T><<<(int)(dims[0] / kEstepThreads), kEstepThreads, 0,
                           st>>>(lists_at(in, zero, dims[0]), x,
                                 static_cast<T*>(psum));
    return (int)cudaGetLastError();
  }
  const Lists cols = lists_at(in + 4, zero, dims[1], dims[2]);
  const int blocks = (int)(dims[1] / kEstepThreads);
  if (pass == 1) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    // up to a full wave of resident blocks, kTermUnroll positions a
    // thread a turn
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, estep_terms_kernel<T>, kEstepThreads, 0);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    const int64_t need = (dims[2] + kEstepThreads - 1) / kEstepThreads;
    const int64_t wave = (int64_t)per_sm * sms;
    estep_terms_kernel<T><<<(int)(need < wave ? need : wave), kEstepThreads,
                            0, st>>>(
        dims[2], static_cast<const int32_t*>(in[9]), cols.stream, cts, x,
        static_cast<const T*>(psum), static_cast<T*>(terms));
  } else if (pass == 2) {
    estep_fold_kernel<T><<<(int)(dims[1] / kFoldThreads), kFoldThreads, 0,
                           st>>>(
        cols, static_cast<const T*>(terms), x, static_cast<T*>(count),
        carry != 0);
  } else if (pass == 3) {
    estep_fused_kernel<T><<<blocks, kEstepThreads, 0, st>>>(
        cols, cts, x, static_cast<const T*>(psum), static_cast<T*>(count),
        carry != 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tail(int stage, void* const* vecs, const void* const* tables,
                void* const* scratch, const int64_t* dims,
                double filter_frac, double min_alpha, void* state,
                void* stream) {
  Vecs<T> v;
  T** fields[6] = {&v.x0, &v.x1, &v.x2, &v.x3, &v.count, &v.per_len};
  for (int k = 0; k < 6; ++k) *fields[k] = static_cast<T*>(vecs[k]);
  v.grp = v.terms = nullptr;
  v.ec_len = static_cast<const T*>(vecs[6]);
  Problem<T> p = {};
  p.ec_cnt = (int32_t)dims[0];
  p.allele_cnt = (int32_t)dims[1];
  p.gene_cnt = (int32_t)dims[2];
  p.major_cnt = (int32_t)dims[3];
  p.max_iterations = (int32_t)dims[4];
  p.ec_off = static_cast<const int64_t*>(tables[0]);
  p.ec_alleles = static_cast<const int32_t*>(tables[1]);
  p.ec_len = v.ec_len;
  p.allele_gene = static_cast<const int32_t*>(tables[2]);
  p.allele_major = static_cast<const int32_t*>(tables[3]);
  p.maj_off = static_cast<const int64_t*>(tables[4]);
  p.maj_alleles = static_cast<const int32_t*>(tables[5]);
  p.filter_frac = (T)filter_frac;
  p.min_alpha = (T)min_alpha;
  Scratch<T> s = {};
  s.allele_abund = static_cast<T*>(scratch[0]);
  s.allele_ec_abund = static_cast<T*>(scratch[1]);
  s.major_abund = static_cast<T*>(scratch[2]);
  s.gene_max = static_cast<T*>(scratch[3]);
  sharded_tail_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(
                                                  stream)>>>(
      stage, static_cast<int32_t*>(state), v, p, s);
  return (int)cudaGetLastError();
}

// mode 0: one thread, n dependent f64 adds.  mode 1: one block of
// kThreads threads, n terms each of the CSC pass's form,
// g[k] * (v / q[k]) summed kUnroll at a time, from shared memory.
__global__ void __launch_bounds__(kThreads)
clock_probe_kernel(int mode, int64_t n, const double* in, double* out,
                   long long* cycles) {
  __shared__ double q[2048], g[2048];
  const int tid = threadIdx.x;
  if (mode == 0) {
    if (tid != 0) return;
    double x = in[0];
    const double y = in[1];
    const long long t0 = clock64();
#pragma unroll 16
    for (int64_t i = 0; i < n; ++i) x += y;
    const long long t1 = clock64();
    out[0] = x;
    cycles[0] = t1 - t0;
    return;
  }
  for (int i = tid; i < 2048; i += kThreads) {
    q[i] = in[0] + i;
    g[i] = in[1] + (i & 7);
  }
  __syncthreads();
  const double xe = in[2];
  const long long t0 = clock64();
  double sum = 0;
  unsigned r = 37u * tid;
  for (int64_t j = 0; j < n; j += kUnroll) {
    double t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r = r * 1103515245u + 12345u;
      const int k = (r >> 8) & 2047;
      t[u] = g[k] * (xe / q[k]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) sum += t[u];
  }
  __syncthreads();
  const long long t1 = clock64();
  out[tid] = sum;
  if (tid == 0) cycles[0] = t1 - t0;
}

}  // namespace

// in: 17 device pointers: the rows' sched, len, base and stream (CSR,
// read group -> ECs), the columns' four (CSC, EC -> read groups), then
// rg_counts, ec_off, ec_alleles, ec_len, allele_gene, allele_major,
// maj_off, maj_alleles, init_x.  scratch: 11 device buffers (x0, x1, x2,
// x3, count, grp of 2 rg_cnt, per_len, allele_abund, allele_ec_abund,
// major_abund, gene_max); count holds the per-EC read counts afterwards.
// dims: ec_cnt, allele_cnt, gene_cnt, major_cnt, rg_cnt, max_iterations,
// the rows' and the columns' slot counts (multiples of kThreads).
// double_prec selects f64 (else f32) for every floating buffer; shared
// keeps the loop's vectors in (2 rg_cnt + 7 ec_cnt) elements of dynamic
// shared memory.  iterations: one device int32.  cycles: null, or
// kPhases + 1 device int64 for the profiled instantiation's clock64()
// counts (CSR, CSC, normalizer, alpha, L1 change, mask, total).  Returns
// the launch's CUDA error code.
extern "C" int t1k_em_squarem(const void* const* in, void* const* scratch,
                              const int64_t* dims, double filter_frac,
                              double min_alpha, int double_prec, int shared,
                              void* iterations, void* cycles, void* stream) {
  return double_prec
             ? launch<double>(in, scratch, dims, filter_frac, min_alpha,
                              shared != 0, iterations, cycles, stream)
             : launch<float>(in, scratch, dims, filter_frac, min_alpha,
                             shared != 0, iterations, cycles, stream);
}

// The cohort form's per-cell structs, built on the host into `out`
// (n_cells * t1k_em_squarem_cell_bytes(double_prec) bytes), for the
// caller to upload once.  in and scratch: the bases of the cohort's
// concatenations of t1k_em_squarem's 17 inputs (the shared tables
// allele_gene, allele_major, maj_off and maj_alleles once) and 11
// buffers.  cells: host int64, n_cells rows of 34: ec_cnt, rg_cnt, the
// rows' and the columns' slot counts and stream lengths, then the cell's
// element offset into each of the 17 inputs and 11 buffers (a cell's
// list values and ec_off count from its own 0).  common: allele_cnt,
// gene_cnt, major_cnt.
extern "C" void t1k_em_squarem_cells(int n_cells, const void* const* in,
                                     void* const* scratch,
                                     const int64_t* cells,
                                     const int64_t* common, int double_prec,
                                     void* out) {
  if (double_prec)
    cells_at<double>(n_cells, in, scratch, cells, common, out);
  else
    cells_at<float>(n_cells, in, scratch, cells, common, out);
}

// Bytes of one cell's structs in t1k_em_squarem_cells' `out`.
extern "C" int64_t t1k_em_squarem_cell_bytes(int double_prec) {
  return (int64_t)(double_prec
                       ? sizeof(Problem<double>) + sizeof(Scratch<double>)
                       : sizeof(Problem<float>) + sizeof(Scratch<float>));
}

// One launch of the cohort form: n_cells blocks of `width` threads (32,
// 64, ..., 1024; the lists of each cell dealt by the host at that many
// threads), block b on cell b of `structs` (t1k_em_squarem_cells' bytes,
// on the device).  form, one for every cell: 0 vectors and lists in
// device memory, 1 the vectors in shared memory, 2 the lists too; forms
// 1 and 2 take `bytes` of dynamic shared memory (the largest cell's:
// ops/em.py::em_shared_bytes, then staged_bytes).  iterations: n_cells
// device int32.  Returns the launch's CUDA error code
// (cudaErrorInvalidValue for another form or width).
extern "C" int t1k_em_squarem_batched(int n_cells, const void* structs,
                                      int form, int64_t bytes, int width,
                                      int max_iterations,
                                      double filter_frac, double min_alpha,
                                      int double_prec, void* iterations,
                                      void* stream) {
  return double_prec
             ? launch_batched<double>(n_cells, structs, form, bytes, width,
                                      max_iterations, filter_frac,
                                      min_alpha, iterations, stream)
             : launch_batched<float>(n_cells, structs, form, bytes, width,
                                     max_iterations, filter_frac, min_alpha,
                                     iterations, stream);
}

// The cohort kernel of one form and width, as t1k_em_squarem_batched
// would launch it with `bytes` of dynamic shared memory: out (4 int32)
// its registers a thread, local bytes a thread (stack frame, spills
// included), static shared bytes and resident blocks an SM.  Returns the
// CUDA error code.
extern "C" int t1k_em_squarem_batched_attrs(int double_prec, int form,
                                            int width, int64_t bytes,
                                            int32_t* out) {
  return double_prec ? batched_attrs<double>(form, width, bytes, out)
                     : batched_attrs<float>(form, width, bytes, out);
}

// One pass of a shard's E-step (the sharded form).  in: the rows' sched,
// len, base and stream (read group -> ECs), the columns' four (EC -> the
// shard's read-group rows, ascending), the columns' count stream (double
// or float, laid out as their index stream) and EC stream (each
// position's EC, -1 past a list's end), then x.  dims: the rows' and
// the columns' slot counts (multiples of 256, from ops/em.py::warp_lists
// at that many threads) and the columns' stream length.  pass 0: the
// rows, into psum (one element per row); 1: the columns' terms, into
// terms (one element per stream position); 2: the columns' fold of
// those terms onto count (ec_cnt elements: from 0, or with carry from
// what count holds); 3: the first design's fused column pass (terms and
// adds in one thread per EC) onto count, for A/B timing.  Returns the
// CUDA error code.
extern "C" int t1k_em_sharded_estep(int pass, const void* const* in,
                                    const int64_t* dims, int double_prec,
                                    int carry, void* psum, void* terms,
                                    void* count, void* stream) {
  return double_prec ? launch_estep<double>(pass, in, dims, carry, psum,
                                            terms, count, stream)
                     : launch_estep<float>(pass, in, dims, carry, psum,
                                           terms, count, stream);
}

// The sharded form's round tail (sharded_tail_kernel) on one block.
// vecs: x0, x1, x2, x3, count, per_len, ec_len.  tables: ec_off,
// ec_alleles, allele_gene, allele_major, maj_off, maj_alleles (the mask's;
// read at stage 2 only).  scratch: allele_abund, allele_ec_abund,
// major_abund, gene_max.  dims: ec_cnt, allele_cnt, gene_cnt, major_cnt,
// max_iterations.  state: two device int32 (t, iterations).  Returns the
// CUDA error code.
extern "C" int t1k_em_sharded_tail(int stage, void* const* vecs,
                                   const void* const* tables,
                                   void* const* scratch, const int64_t* dims,
                                   double filter_frac, double min_alpha,
                                   int double_prec, void* state,
                                   void* stream) {
  return double_prec
             ? launch_tail<double>(stage, vecs, tables, scratch, dims,
                                   filter_frac, min_alpha, state, stream)
             : launch_tail<float>(stage, vecs, tables, scratch, dims,
                                  filter_frac, min_alpha, state, stream);
}

// Measurement kernel for the EM's bounds (see clock_probe_kernel): in
// holds 3 doubles, out 1024, cycles 1.  Returns the launch's error code.
extern "C" int t1k_em_clock_probe(int mode, int64_t n, const void* in,
                                  void* out, void* cycles, void* stream) {
  clock_probe_kernel<<<1, mode == 0 ? 1 : kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      mode, n, static_cast<const double*>(in), static_cast<double*>(out),
      static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}
