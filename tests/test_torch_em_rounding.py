"""The port's plain SQUAREM EM (t1k_tpu_torch/ops/em.py) against the native
f64 oracle where one rounding of SQUAREM's step length decides the last
bits of the counts."""

import numpy as np

from t1k_tpu.native import em_quantify
from t1k_tpu_torch.ops.em import em_quantify_gpu


def test_f64_matches_native_where_sqrt_rounding_matters():
    """A seeded 300 read group x 60 EC problem: torch's CPU sqrt of a 0-dim
    f64 tensor is not always correctly rounded, and one ulp in SQUAREM's
    alpha at round 7 moved the counts by 1.8e-10.  The plain version takes
    alpha's square roots in IEEE double, as em.cc does."""
    rng = np.random.default_rng(5)
    n_rg, n_ec, n_alleles, n_genes, n_majors = 300, 60, 120, 24, 20
    ec_to_alleles = [[] for _ in range(n_ec)]
    for a in range(n_alleles):
        ec_to_alleles[a % n_ec].append(a)
    offs, ecs = [0], []
    for _ in range(n_rg):
        ecs.extend(rng.choice(n_ec, size=int(rng.integers(1, 12)),
                              replace=False).tolist())
        offs.append(len(ecs))
    args = dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0, 3.0], n_rg),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes, n_majors=n_majors)
    it_native, count_native = em_quantify(**args)
    it, count = em_quantify_gpu(**args, device="cpu")
    assert it == it_native
    np.testing.assert_array_equal(count, count_native)
