"""T1K's EM over an equivalence-class problem, in NumPy.

The model (T1K, Genotyper.hpp): the abundance x of each equivalence
class (EC) starts at the summed duplicate weight of its alleles.  An
update splits each read group's count over its ECs in proportion to x,
sums each EC's share, divides by the EC's shortest effective length and
normalises.  SQUAREM extrapolates from two updates: with r = x1 - x0
and v = x2 - 2 x1 + x0, alpha = -|r| / |v| (-1 where v is 0), raised to
the configured floor, x3 = x0 - 2 alpha r + alpha^2 v, and one more
update of x3 is the round's result.  The loop stops once a round moves
x by less than 1e-5 in L1 (after one more round).  Every 10th round,
alleles whose major allele's abundance (the EC's count over its length,
x1000, shared equally by its alleles, summed per major allele) is below
filter_frac / 2 of the largest major allele of the gene are zeroed,
and each EC restarts from its first allele's EC abundance.  The result
is the per-EC expected read count of the last update."""

from __future__ import annotations

import numpy as np


def quantify(problem, dtype=np.float64) -> np.ndarray:
    """problem: (ec_to_alleles, (rg_offsets, rg_ecs), rg_counts,
    allele_eff_len, allele_missing, allele_weight, allele_gene,
    allele_major, gene_cnt, major_cnt, filter_frac, min_squarem_alpha,
    max_iterations).  Returns the per-EC read counts in `dtype`."""
    (ec_to_alleles, (rg_off, rg_ecs), rg_counts, eff_len, _missing,
     weight, gene, major, gene_cnt, major_cnt, filter_frac, min_alpha,
     max_iter) = problem
    dt = np.dtype(dtype)
    ec_cnt = len(ec_to_alleles)
    if ec_cnt == 0:
        return np.zeros(0, dt)
    ec_len = np.array([min(eff_len[a] for a in ec) for ec in ec_to_alleles],
                      dt)
    first = np.array([ec[0] for ec in ec_to_alleles], np.int64)
    size = np.array([len(ec) for ec in ec_to_alleles], np.int64)
    members = np.concatenate([np.asarray(ec, np.int64)
                              for ec in ec_to_alleles])
    member_ec = np.repeat(np.arange(ec_cnt), size)
    rg_off = np.asarray(rg_off, np.int64)
    cols = np.asarray(rg_ecs, np.int64)
    row = np.repeat(np.arange(len(rg_off) - 1), np.diff(rg_off))
    counts = np.asarray(rg_counts, dt)
    allele_cnt = len(weight)
    gene = np.asarray(gene, np.int64)
    major = np.asarray(major, np.int64)

    x0 = np.zeros(ec_cnt, dt)
    np.add.at(x0, member_ec, np.asarray(weight, dt)[members])
    count = np.zeros(ec_cnt, dt)

    def update(x):
        nonlocal count
        psum = np.bincount(row, weights=x[cols],
                           minlength=len(rg_off) - 1).astype(dt)
        psum[psum == 0] = 1
        share = (counts[row] * (x[cols] / psum[row])).astype(dt)
        count = np.bincount(cols, weights=share, minlength=ec_cnt).astype(dt)
        norm = (count / ec_len).sum(dtype=dt)
        return (count / ec_len / norm).astype(dt)

    def mask():
        abund = count / ec_len * dt.type(1000.0)
        allele_ab = np.zeros(allele_cnt, dt)
        allele_ec_ab = np.zeros(allele_cnt, dt)
        allele_ab[members] = (abund / size)[member_ec]
        allele_ec_ab[members] = abund[member_ec]
        major_ab = np.bincount(major, weights=allele_ab,
                               minlength=major_cnt).astype(dt)
        gene_max = np.zeros(gene_cnt, dt)
        np.maximum.at(gene_max, gene, major_ab[major])
        low = major_ab[major] < filter_frac * 0.5 * gene_max[gene]
        allele_ec_ab[low] = 0
        return allele_ec_ab[first]

    t = 0
    while t < max_iter:
        x1 = update(x0)
        x2 = update(x1)
        r, v = x1 - x0, x2 - 2 * x1 + x0
        sv = float((v * v).sum(dtype=dt))
        alpha = -1.0 if sv == 0 else -np.sqrt(float((r * r).sum(dtype=dt))
                                              / sv)
        if min_alpha < 0 and alpha < min_alpha:
            alpha = min_alpha
        a = dt.type(alpha)
        x3 = (x0 - 2 * a * r + a * a * v).astype(dt)
        x1 = update(x3)
        moved = float(np.abs(x1 - x0).sum(dtype=dt))
        x0 = x1
        if moved < 1e-5 and t < max_iter - 2:
            t = max_iter - 2
        if t > 0 and t % 10 == 0:
            x0 = mask()
        t += 1
    return count
