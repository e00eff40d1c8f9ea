"""The plain reference on inputs whose answers are known by hand."""

from __future__ import annotations

import numpy as np

from reference import band, em, exact, groups


def _c(s: str) -> np.ndarray:
    return exact.encode(s)


def test_exact_pairs_lie_in_the_alleles_that_hold_both_mates():
    rng = np.random.default_rng(1)
    a = "".join(rng.choice(list("ACGT"), 400))
    b = a[:150] + ("A" if a[150] != "A" else "C") + a[151:]
    panel = exact.Panel([a, b, a[::-1]])
    m1 = _c(a[100:200])[None, :]
    m2 = exact.COMP[_c(a[250:350])[::-1]][None, :]
    assert panel.pair_holders(m1, m2)[0].tolist() == [0]
    m1 = _c(a[200:300])[None, :]
    assert panel.pair_holders(m1, m2)[0].tolist() == [0, 1]
    m1[0, 5] = 4                                   # an N: no exact pair
    assert panel.pair_holders(m1, m2)[0].tolist() == []


def test_kmer_hits_count_either_strand():
    panel = exact.Panel(["ACGTTGCAAGGCTTAGCCAT"])
    table = panel.kmer_table(9)
    fwd = _c("ACGTTGCAAGGC")[None, :]
    rev = exact.COMP[fwd[:, ::-1]]
    assert exact.panel_kmer_hits(table, 9, fwd).tolist() == [4]
    assert exact.panel_kmer_hits(table, 9, rev).tolist() == [4]
    assert exact.kmer_length(1_200_000) == 12
    assert exact.kmer_length(10) == 9


def test_band_items_checked_only_where_ungapped_is_the_optimum():
    t = _c("ACGTACGTAC")
    one = t.copy()
    one[3] = (one[3] + 1) % 4
    three = one.copy()
    three[[5, 7]] = (three[[5, 7]] + 1) % 4
    n = t.copy()
    n[0] = 4
    items = [(t, t, 10), (t, one, 9), (t, three, 7), (t, n, 10),
             (t, t[:9], 9), (t[:0], t[:0], 0)]
    assert band.check(items) == {"checked": 4, "wrong": 0}
    assert band.check([(t, one, 10), (t, n, 9)]) == {"checked": 2,
                                                      "wrong": 2}


def test_classes_and_em_table_from_read_groups():
    # group 0: alleles 0, 1, 2; group 1: alleles 0, 1 (quality 1 on 0)
    goff = np.array([0, 3, 5])
    allele = np.array([0, 1, 2, 0, 1])
    qual = np.array([1.0, 1.0, 1.0, 1.0, 0.5], np.float32)
    weight = np.array([1.0, 2.0, 1.0, 3.0, 3.0], np.float32)
    ecs = groups.equivalence_classes(goff, allele, qual, 3)
    assert sorted(map(sorted, (k for _, k in ecs))) == [[0], [1], [2]]
    ec_of = {a: c for c, (m, _) in enumerate(ecs) for a in m}
    rows, counts = groups.em_table(goff, allele, weight, ec_of)
    assert [len(r) for r in rows] == [3, 2]
    assert counts.tolist() == [2.0, 3.0]


def _problem(rg_ecs, counts):
    off = np.cumsum([0] + [len(r) for r in rg_ecs])
    ec_to_alleles = [[0], [1]]
    return (ec_to_alleles, (off, np.concatenate(rg_ecs)),
            np.asarray(counts, np.float64), np.array([1000, 1000]),
            np.zeros(2, np.int32), np.ones(2, np.int32),
            np.zeros(2, np.int64), np.array([0, 1]), 1, 2, 0.15, -1.0, 1000)


def test_em_splits_shared_reads_by_the_unique_ones():
    # 30 reads only on class 0, 10 only on class 1, 40 on both: the
    # fixed point gives class 0 three quarters of the shared reads
    p = _problem([np.array([0]), np.array([1]), np.array([0, 1])],
                 [30, 10, 40])
    got = em.quantify(p)
    assert np.allclose(got, [60.0, 20.0], rtol=1e-6)
    assert abs(em.quantify(p, np.float32).astype(np.float64)
               - got).max() < 1e-3
