// SQUAREM-accelerated EM over the read-group x equivalence-class incidence,
// in the native oracle's exact operation order.
//
// Replaces the jitted XLA program t1k_tpu/ops/em.py::_em_loop_dense
// (with _squarem_while and _make_mask_reset).  Same contract as
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
// Design: the whole convergence loop is one launch of one block.  Work
// whose order does not matter runs across the block's threads: per read
// group the sum of its ECs' abundances (CSR, in the group's own order),
// per EC the sum of its read groups' shares (CSC, read groups ascending -
// the order in which em.cc's scatter reaches each EC), elementwise
// updates and the mask's per-allele steps.  The order-sensitive
// reductions (the normalizer, the SQUAREM step lengths, the L1 change,
// the major-allele sums) run on thread 0, as em.cc runs them.  No host
// round trip per round.
//
// What bounds it on an H100: latency, not bytes or FLOPs - one SM, and
// per round six serial reductions over the ECs plus dependent f64 loads
// along the incidence lists.  A HLA-scale problem (a few thousand ECs,
// tens of thousands of read groups) fits in L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaskRound = 10;

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

template <typename T>
struct Problem {
  int32_t ec_cnt, allele_cnt, gene_cnt, major_cnt;
  int64_t rg_cnt;
  const int64_t* rg_off;     // [rg_cnt + 1] CSR: read group -> ECs
  const int32_t* rg_ecs;
  const T* rg_counts;        // [rg_cnt]
  const int64_t* col_off;    // [ec_cnt + 1] CSC: EC -> read groups (asc)
  const int32_t* col_rgs;
  const int64_t* ec_off;     // [ec_cnt + 1] CSR: EC -> alleles
  const int32_t* ec_alleles;
  const T* ec_len;           // [ec_cnt] shortest effective length
  const int32_t* allele_gene;
  const int32_t* allele_major;
  T filter_frac, min_alpha;
  int32_t max_iterations;
};

template <typename T>
struct Scratch {
  T *x0, *x1, *x2, *x3, *count, *psum, *per_len;
  T *allele_abund, *allele_ec_abund, *major_abund, *gene_max;
};

// out = normalized EM update of `in`; leaves the expected read counts in
// s.count (em.cc emUpdate).
template <typename T>
__device__ void em_update(const Problem<T>& p, const Scratch<T>& s,
                          const T* in, T* out, T* s_norm) {
  const int tid = threadIdx.x;
  for (int64_t i = tid; i < p.rg_cnt; i += kThreads) {
    T sum = 0;
    for (int64_t j = p.rg_off[i]; j < p.rg_off[i + 1]; ++j)
      sum += in[p.rg_ecs[j]];
    if (sum == 0) sum = 1;
    s.psum[i] = sum;
  }
  __syncthreads();
  for (int e = tid; e < p.ec_cnt; e += kThreads) {
    const T v = in[e];
    T c = 0;
    for (int64_t j = p.col_off[e]; j < p.col_off[e + 1]; ++j) {
      const int32_t r = p.col_rgs[j];
      c += p.rg_counts[r] * (v / s.psum[r]);
    }
    s.count[e] = c;
    s.per_len[e] = c / p.ec_len[e];
  }
  __syncthreads();
  if (tid == 0) {
    T norm = 0;
    for (int e = 0; e < p.ec_cnt; ++e) norm += s.per_len[e];
    *s_norm = norm;
  }
  __syncthreads();
  const T norm = *s_norm;
  for (int e = tid; e < p.ec_cnt; e += kThreads) out[e] = s.per_len[e] / norm;
  __syncthreads();
}

// Low-abundance major-allele mask; resets x0 (em.cc maskAndReset).
template <typename T>
__device__ void mask_reset(const Problem<T>& p, const Scratch<T>& s) {
  const int tid = threadIdx.x;
  for (int a = tid; a < p.allele_cnt; a += kThreads)
    s.allele_abund[a] = s.allele_ec_abund[a] = 0;
  __syncthreads();
  for (int e = tid; e < p.ec_cnt; e += kThreads) {
    const int64_t size = p.ec_off[e + 1] - p.ec_off[e];
    const T abund = s.count[e] / p.ec_len[e] * (T)1000.0;
    for (int64_t j = p.ec_off[e]; j < p.ec_off[e + 1]; ++j) {
      s.allele_abund[p.ec_alleles[j]] = abund / (T)size;
      s.allele_ec_abund[p.ec_alleles[j]] = abund;
    }
  }
  __syncthreads();
  if (tid == 0) {
    for (int m = 0; m < p.major_cnt; ++m) s.major_abund[m] = 0;
    for (int g = 0; g < p.gene_cnt; ++g) s.gene_max[g] = 0;
    for (int a = 0; a < p.allele_cnt; ++a)
      s.major_abund[p.allele_major[a]] += s.allele_abund[a];
    for (int a = 0; a < p.allele_cnt; ++a) {
      const T v = s.major_abund[p.allele_major[a]];
      if (v > s.gene_max[p.allele_gene[a]]) s.gene_max[p.allele_gene[a]] = v;
    }
  }
  __syncthreads();
  for (int a = tid; a < p.allele_cnt; a += kThreads) {
    if (s.major_abund[p.allele_major[a]] <
        p.filter_frac * (T)0.5 * s.gene_max[p.allele_gene[a]]) {
      s.allele_abund[a] = 0;
      s.allele_ec_abund[a] = 0;
    }
  }
  __syncthreads();
  for (int e = tid; e < p.ec_cnt; e += kThreads)
    s.x0[e] = s.allele_ec_abund[p.ec_alleles[p.ec_off[e]]];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
squarem_kernel(Problem<T> p, Scratch<T> s, int32_t* iterations) {
  __shared__ T s_norm, s_alpha, s_diff;
  const int tid = threadIdx.x;
  int ret = 0;
  for (int t = 0; t < p.max_iterations; ++t) {
    ++ret;
    em_update(p, s, s.x0, s.x1, &s_norm);
    em_update(p, s, s.x1, s.x2, &s_norm);
    if (tid == 0) {
      T sum_r = 0, sum_v = 0;
      for (int i = 0; i < p.ec_cnt; ++i) {
        const T r = s.x1[i] - s.x0[i];
        const T v = s.x2[i] - 2 * s.x1[i] + s.x0[i];
        sum_r += r * r;
        sum_v += v * v;
      }
      T alpha = sum_v == 0 ? (T)-1 : -sqrt_of(sum_r) / sqrt_of(sum_v);
      if (p.min_alpha < 0 && alpha < p.min_alpha) alpha = p.min_alpha;
      s_alpha = alpha;
    }
    __syncthreads();
    const T alpha = s_alpha;
    for (int i = tid; i < p.ec_cnt; i += kThreads)
      s.x3[i] = s.x0[i] - 2 * alpha * (s.x1[i] - s.x0[i]) +
                alpha * alpha * (s.x2[i] - 2 * s.x1[i] + s.x0[i]);
    __syncthreads();
    em_update(p, s, s.x3, s.x1, &s_norm);
    if (tid == 0) {
      T diff = 0;
      for (int i = 0; i < p.ec_cnt; ++i) {
        diff += abs_of(s.x1[i] - s.x0[i]);
        s.x0[i] = s.x1[i];
      }
      s_diff = diff;
    }
    __syncthreads();
    if (s_diff < (T)1e-5 && t < p.max_iterations - 2) t = p.max_iterations - 2;
    if (t > 0 && t % kMaskRound == 0) mask_reset(p, s);
    __syncthreads();  // s_diff is rewritten next round
  }
  if (tid == 0) *iterations = ret;
}

template <typename T>
int launch(const void* const* in, void* const* scratch, const int64_t* dims,
           double filter_frac, double min_alpha, void* iterations,
           void* stream) {
  Problem<T> p;
  p.ec_cnt = (int32_t)dims[0];
  p.allele_cnt = (int32_t)dims[1];
  p.gene_cnt = (int32_t)dims[2];
  p.major_cnt = (int32_t)dims[3];
  p.rg_cnt = dims[4];
  p.max_iterations = (int32_t)dims[5];
  p.rg_off = static_cast<const int64_t*>(in[0]);
  p.rg_ecs = static_cast<const int32_t*>(in[1]);
  p.rg_counts = static_cast<const T*>(in[2]);
  p.col_off = static_cast<const int64_t*>(in[3]);
  p.col_rgs = static_cast<const int32_t*>(in[4]);
  p.ec_off = static_cast<const int64_t*>(in[5]);
  p.ec_alleles = static_cast<const int32_t*>(in[6]);
  p.ec_len = static_cast<const T*>(in[7]);
  p.allele_gene = static_cast<const int32_t*>(in[8]);
  p.allele_major = static_cast<const int32_t*>(in[9]);
  p.filter_frac = (T)filter_frac;
  p.min_alpha = (T)min_alpha;
  Scratch<T> s;
  T** fields[] = {&s.x0, &s.x1, &s.x2, &s.x3, &s.count, &s.psum,
                  &s.per_len, &s.allele_abund, &s.allele_ec_abund,
                  &s.major_abund, &s.gene_max};
  for (int k = 0; k < 11; ++k) *fields[k] = static_cast<T*>(scratch[k]);
  squarem_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, s, static_cast<int32_t*>(iterations));
  return (int)cudaGetLastError();
}

}  // namespace

// in: 10 device pointers (rg_off, rg_ecs, rg_counts, col_off, col_rgs,
// ec_off, ec_alleles, ec_len, allele_gene, allele_major).  scratch: 11
// device buffers (x0 holding the initial abundances, x1, x2, x3, count,
// psum, per_len, allele_abund, allele_ec_abund, major_abund, gene_max);
// count holds the per-EC read counts afterwards.  dims: ec_cnt,
// allele_cnt, gene_cnt, major_cnt, rg_cnt, max_iterations.  double_prec
// selects f64 (else f32) for every floating buffer.  iterations: one
// device int32.  Returns the launch's cudaGetLastError().
extern "C" int t1k_em_squarem(const void* const* in, void* const* scratch,
                              const int64_t* dims, double filter_frac,
                              double min_alpha, int double_prec,
                              void* iterations, void* stream) {
  return double_prec
             ? launch<double>(in, scratch, dims, filter_frac, min_alpha,
                              iterations, stream)
             : launch<float>(in, scratch, dims, filter_frac, min_alpha,
                             iterations, stream);
}
