// SQUAREM-accelerated EM quantification over read-group x equivalence-class
// adjacency — exact host implementation.
//
// This mirrors the numerical contract of the reference EM
// (Genotyper.hpp:372-437, 1142-1328): two plain EM updates, a SQUAREM
// extrapolation x3 = x0 - 2a(x1-x0) + a^2(x2-2x1+x0) with
// a = -|x1-x0|/|x2-2x1+x0|, one stabilizing update, convergence when the
// L1 step drops below 1e-5 (plus one forced extra iteration), and a
// low-abundance major-allele mask applied every 10 rounds.  Accumulation
// order matches the reference exactly so results are bit-identical.
//
// The TPU twin of this loop lives in t1k_tpu/ops/em.py (jitted dense
// linear algebra, psum across hosts); this version is the f64 oracle.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of EM iterations executed.
//
// Layout:
//   ec_offsets/ec_alleles     CSR: equivalence class -> allele ids
//   rg_offsets/rg_ecs         CSR: read group -> distinct EC ids (in first-
//                             appearance order)
//   rg_counts                 per read group fragment count (max weight)
//   allele_eff_len            per allele effective length
//   allele_missing            per allele missing exon coverage
//   allele_weight             per allele duplicate-sequence weight
//   allele_gene/allele_major  per allele gene / major-allele id
//   out_ec_read_count         [ec_cnt] final expected read counts
//   init_x                    optional [ec_cnt] warm-start abundances
//                             (normalized); NULL = allele-weight init.
//                             Used by the f64 polish after a device-f32
//                             EM run (core/genotyper.py quantify).
int32_t t1k_em_quantify(
    int32_t ec_cnt, int32_t allele_cnt, int32_t gene_cnt, int32_t major_cnt,
    int64_t rg_cnt, const int64_t* ec_offsets, const int32_t* ec_alleles,
    const int64_t* rg_offsets, const int32_t* rg_ecs, const double* rg_counts,
    const int32_t* allele_eff_len, const int32_t* allele_missing,
    const int32_t* allele_weight, const int32_t* allele_gene,
    const int32_t* allele_major, double filter_frac, double min_squarem_alpha,
    int32_t max_iterations, double* out_ec_read_count,
    const double* init_x) {
  if (ec_cnt == 0) return 0;

  // Per-EC info: min effective length and min missing coverage.
  std::vector<int32_t> ecLen(ec_cnt), ecMissing(ec_cnt);
  for (int i = 0; i < ec_cnt; ++i) {
    int32_t len = allele_eff_len[ec_alleles[ec_offsets[i]]];
    int32_t miss = allele_missing[ec_alleles[ec_offsets[i]]];
    for (int64_t j = ec_offsets[i] + 1; j < ec_offsets[i + 1]; ++j) {
      int32_t l = allele_eff_len[ec_alleles[j]];
      if (l < len) len = l;
      int32_t m = allele_missing[ec_alleles[j]];
      if (m < miss) miss = m;
    }
    ecLen[i] = len;
    ecMissing[i] = miss;
  }

  std::vector<double> x0(ec_cnt), x1(ec_cnt), x2(ec_cnt), x3(ec_cnt);
  std::vector<double> count(ec_cnt);
  std::vector<double> alleleAbund(allele_cnt), alleleEcAbund(allele_cnt);
  std::vector<double> majorAbund(major_cnt), geneMax(gene_cnt);

  if (init_x) {
    for (int i = 0; i < ec_cnt; ++i) x0[i] = init_x[i];
  } else {
    for (int i = 0; i < ec_cnt; ++i) {
      double w = 0;
      for (int64_t j = ec_offsets[i]; j < ec_offsets[i + 1]; ++j)
        w += allele_weight[ec_alleles[j]];
      x0[i] = w;
    }
  }

  auto emUpdate = [&](const double* in, double* out) -> double {
    std::memset(count.data(), 0, sizeof(double) * ec_cnt);
    for (int64_t i = 0; i < rg_cnt; ++i) {
      double psum = 0;
      for (int64_t j = rg_offsets[i]; j < rg_offsets[i + 1]; ++j)
        psum += in[rg_ecs[j]];
      if (psum == 0) psum = 1;
      for (int64_t j = rg_offsets[i]; j < rg_offsets[i + 1]; ++j)
        count[rg_ecs[j]] += rg_counts[i] * (in[rg_ecs[j]] / psum);
    }
    double norm = 0;
    for (int i = 0; i < ec_cnt; ++i) norm += count[i] / ecLen[i];
    double diff = 0;
    for (int i = 0; i < ec_cnt; ++i) {
      double v = count[i] / ecLen[i] / norm;
      diff += std::fabs(v - in[i]);
      out[i] = v;
    }
    return diff;
  };

  // Recompute allele-level abundances (FPK) and apply the low-abundance
  // major-allele mask; reset x0 from the masked EC abundances.
  auto maskAndReset = [&]() {
    for (int i = 0; i < allele_cnt; ++i) alleleAbund[i] = alleleEcAbund[i] = 0;
    for (int i = 0; i < ec_cnt; ++i) {
      int64_t size = ec_offsets[i + 1] - ec_offsets[i];
      double abund = count[i] / ecLen[i] * 1000.0;
      for (int64_t j = ec_offsets[i]; j < ec_offsets[i + 1]; ++j) {
        alleleAbund[ec_alleles[j]] = abund / size;
        alleleEcAbund[ec_alleles[j]] = abund;
      }
    }
    for (int i = 0; i < major_cnt; ++i) majorAbund[i] = 0;
    for (int i = 0; i < gene_cnt; ++i) geneMax[i] = 0;
    for (int i = 0; i < allele_cnt; ++i)
      majorAbund[allele_major[i]] += alleleAbund[i];
    for (int i = 0; i < allele_cnt; ++i) {
      double a = majorAbund[allele_major[i]];
      if (a > geneMax[allele_gene[i]]) geneMax[allele_gene[i]] = a;
    }
    for (int i = 0; i < allele_cnt; ++i) {
      if (majorAbund[allele_major[i]] < filter_frac * 0.5 * geneMax[allele_gene[i]]) {
        alleleAbund[i] = 0;
        alleleEcAbund[i] = 0;
      }
    }
    for (int i = 0; i < ec_cnt; ++i)
      x0[i] = alleleEcAbund[ec_alleles[ec_offsets[i]]];
  };

  int ret = 0;
  for (int t = 0; t < max_iterations; ++t) {
    ++ret;
    emUpdate(x0.data(), x1.data());
    emUpdate(x1.data(), x2.data());

    double sumR = 0, sumV = 0;
    for (int i = 0; i < ec_cnt; ++i) {
      double r = x1[i] - x0[i];
      double v = x2[i] - 2 * x1[i] + x0[i];
      sumR += r * r;
      sumV += v * v;
    }
    double alpha = sumV == 0 ? -1 : -std::sqrt(sumR) / std::sqrt(sumV);
    if (min_squarem_alpha < 0 && alpha < min_squarem_alpha)
      alpha = min_squarem_alpha;
    for (int i = 0; i < ec_cnt; ++i)
      x3[i] = x0[i] - 2 * alpha * (x1[i] - x0[i]) +
              alpha * alpha * (x2[i] - 2 * x1[i] + x0[i]);
    emUpdate(x3.data(), x1.data());

    double diffSum = 0;
    for (int i = 0; i < ec_cnt; ++i) {
      diffSum += std::fabs(x1[i] - x0[i]);
      x0[i] = x1[i];
    }
    if (diffSum < 1e-5 && t < max_iterations - 2) t = max_iterations - 2;
    if (t > 0 && t % 10 == 0) maskAndReset();
  }

  std::memcpy(out_ec_read_count, count.data(), sizeof(double) * ec_cnt);
  return ret;
}

}  // extern "C"
