"""The port's cohort EM (t1k_tpu_torch/ops/em.py em_quantify_batched, the
cohort form of csrc/em_squarem.cu) against the native f64 loop per cell
and the JAX package's batched device EM (em_quantify_jax_batched)."""

import numpy as np
import pytest
import torch

from t1k_tpu_torch.native import em_quantify
from t1k_tpu_torch.ops import em as tem
from t1k_tpu_torch.ops.em import em_quantify_batched


def _cohort_problems(n_cells=9, n_alleles=40, n_genes=4, seed0=50):
    """Randomized per-cell EC problems against one shared reference
    (tests/test_device_ops.py's _cohort_problems, copied)."""
    allele_gene = (np.arange(n_alleles) % n_genes).astype(np.int32)
    allele_major = (np.arange(n_alleles) // 2).astype(np.int32)
    n_majors = n_alleles // 2
    rng = np.random.default_rng(seed0)
    allele_eff_len = rng.integers(800, 1600, n_alleles).astype(np.float64)

    problems = []
    for s in range(n_cells):
        r = np.random.default_rng(seed0 + 1 + s)
        K = int(r.integers(3, 12))
        pool = list(range(n_alleles))
        r.shuffle(pool)
        ecs, used = [], 0
        for _ in range(K):
            sz = int(r.integers(1, 4))
            ecs.append(sorted(pool[used:used + sz]))
            used += sz
        G = int(r.integers(5, 40))
        rg_off, rg_ecs = [0], []
        for _ in range(G):
            n = int(r.integers(1, min(4, K) + 1))
            rg_ecs.extend(sorted(r.choice(K, n, replace=False).tolist()))
            rg_off.append(len(rg_ecs))
        counts = r.integers(1, 20, G).astype(np.float64)
        problems.append((ecs, (np.array(rg_off), np.array(rg_ecs)), counts,
                         np.ones(n_alleles)))
    return problems, allele_eff_len, allele_gene, allele_major, n_genes, n_majors


def _wide_cell(rg_cnt, ec_cnt, n_alleles, seed):
    """One cell of up to 8 distinct ECs per read group over `ec_cnt`
    ECs, each one allele of the cohort's `n_alleles` (an allele is in one
    EC at most, as the genotyper's ECs partition the alleles)."""
    r = np.random.default_rng(seed)
    ecs = [[int(a)] for a in r.permutation(n_alleles)[:ec_cnt]]
    rg_off, rg_ecs = [0], []
    for _ in range(rg_cnt):
        rg_ecs.extend(r.choice(ec_cnt, int(r.integers(1, 9)),
                               replace=False).tolist())
        rg_off.append(len(rg_ecs))
    return (ecs, (np.array(rg_off), np.array(rg_ecs)),
            r.choice([1.0, 0.5, 2.0, 3.0], rg_cnt),
            r.integers(1, 4, n_alleles))


def _empty_cell(n_alleles):
    return ([], (np.array([0]), np.array([], np.int64)), np.zeros(0),
            np.ones(n_alleles))


def _native(problem, allele_eff_len, allele_gene, allele_major, n_genes,
            n_majors, min_alpha=0.0):
    ecs, csr, counts, weight = problem
    if not ecs:
        return 0, np.zeros(0)
    return em_quantify(ecs, csr, counts, allele_eff_len,
                       np.zeros(len(allele_eff_len)), weight, allele_gene,
                       allele_major, n_genes, n_majors, 0.15, min_alpha, 1000)


@pytest.mark.parametrize("seed0,min_alpha", [(50, 0.0), (90, 0.0),
                                             (130, -1.5)])
def test_batched_f64_matches_native_per_cell_bit_for_bit(seed0, min_alpha):
    """Every cell's iterations and counts are the native loop's bits; an
    empty cell gives (0, zeros(0))."""
    problems, *ref = _cohort_problems(seed0=seed0)
    problems[4] = _empty_cell(len(ref[0]))
    got = em_quantify_batched(problems, *ref, min_squarem_alpha=min_alpha,
                              device="cpu")
    assert len(got) == len(problems)
    for i, p in enumerate(problems):
        it, count = _native(p, *ref, min_alpha=min_alpha)
        assert got[i][0] == it, f"cell {i}"
        assert got[i][1].dtype == np.float64
        assert got[i][1].tobytes() == count.tobytes(), f"cell {i}"
    assert got[4][0] == 0 and got[4][1].shape == (0,)


def test_batched_matches_jax_batched_under_x64():
    """The JAX package's padded, frozen-cell program in f64: the same
    iterations, counts within rtol 1e-9 (its einsums sum in another
    order; atol 1e-9 as in its own f64 comparison,
    tests/test_device_ops.py::test_cohort_batched_em_chunking, for the
    counts near 0, which differ by about 5e-14)."""
    # imported here: the card's machine runs this file's cuda tests
    # without the JAX package
    import jax

    from t1k_tpu.ops.em import em_quantify_jax_batched

    problems, *ref = _cohort_problems(n_cells=7, seed0=130)
    problems[2] = _empty_cell(len(ref[0]))
    got = em_quantify_batched(problems, *ref, device="cpu")
    with jax.enable_x64():
        want = em_quantify_jax_batched(problems, *ref)
    for (it, count), (it_j, count_j) in zip(got, want):
        assert it == it_j
        assert count.shape == count_j.shape
        np.testing.assert_allclose(count, count_j, rtol=1e-9, atol=1e-9)


def test_batched_results_do_not_depend_on_cell_order():
    problems, *ref = _cohort_problems(n_cells=8, seed0=70)
    got = em_quantify_batched(problems, *ref, device="cpu")
    order = np.random.default_rng(1).permutation(len(problems))
    shuffled = em_quantify_batched([problems[i] for i in order], *ref,
                                   device="cpu")
    for j, i in enumerate(order):
        assert shuffled[j][0] == got[i][0]
        assert shuffled[j][1].tobytes() == got[i][1].tobytes()


def _cell_tables(problems, allele_eff_len, allele_gene, allele_major,
                 n_genes, n_majors):
    return [tem.em_tables(p[0], p[1], p[2], allele_eff_len, p[3],
                          allele_gene, allele_major, n_genes, n_majors)
            for p in problems]


def test_batched_tables_hold_each_cells_own_tables():
    """batched_tables' concatenations, read at each cell's offsets, are
    the cell's own kernel inputs (warp_lists of both passes, the counts,
    EC tables and initial abundances), the reference tables appear once,
    and the scratch offsets give each cell its own buffers.  A cell past
    EM_SHARED_LIMIT takes the device-memory form."""
    problems, *ref = _cohort_problems(n_cells=5, n_alleles=1000, seed0=50)
    problems.append(_wide_cell(12_000, 900, len(ref[0]), 7))
    cells = _cell_tables(problems, *ref)
    host = tem.batched_tables(cells, 8)
    rows = host["rows"]
    assert rows.shape == (6, 32)
    assert host["shared"].tolist() == [True] * 5 + [False]
    assert host["common"].tolist() == [len(ref[0]), ref[3], ref[4]]
    maj_off, maj_alleles = tem.major_lists(ref[2], ref[4])
    for k, want in ((12, ref[1]), (13, ref[2]), (14, maj_off),
                    (15, maj_alleles)):
        assert np.array_equal(host["ins"][k], want)
    for b, t in enumerate(cells):
        ec_cnt, rg_cnt = len(t["ec_len"]), len(t["rg_counts"])
        csr = tem.warp_lists(t["rg_off"], t["rg_ecs"])
        csc = tem.warp_lists(t["col_off"], t["col_rgs"])
        assert rows[b, :4].tolist() == [ec_cnt, rg_cnt, len(csr["sched"]),
                                        len(csc["sched"])]
        own = [lists[k] for lists in (csr, csc)
               for k in ("sched", "len", "base", "stream")]
        own += [t["rg_counts"], t["ec_off"], t["ec_alleles"], t["ec_len"]]
        own += [None] * 4 + [t["init_x"]]
        for k, want in enumerate(own):
            if want is None:
                assert rows[b, 4 + k] == 0
                continue
            off = rows[b, 4 + k]
            assert np.array_equal(host["ins"][k][off:off + len(want)], want)
        vec = 0 if host["shared"][b] else 1
        want_sizes = [vec * ec_cnt] * 4 + [ec_cnt, vec * 2 * rg_cnt,
                                           vec * ec_cnt, len(ref[0]),
                                           len(ref[0]), ref[4], ref[3]]
        nxt = rows[b + 1, 21:] if b + 1 < len(cells) else host["scratch"]
        assert (nxt - rows[b, 21:]).tolist() == want_sizes


def test_batched_tables_refuse_mixed_references():
    problems, *ref = _cohort_problems(n_cells=3, n_alleles=1000, seed0=50)
    cells = _cell_tables(problems, *ref)
    other = dict(cells[1], allele_major=cells[1]["allele_major"][::-1])
    with pytest.raises(ValueError, match="one reference"):
        tem.batched_tables([cells[0], other], 8)


def test_batched_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problems, *ref = _cohort_problems(n_cells=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        em_quantify_batched(problems, *ref, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("min_alpha", [0.0, -1.5])
def test_batched_kernel_on_card_matches_plain_and_single_kernel(min_alpha):
    """The cohort form on the card, on a cohort that mixes the
    shared-memory form (the small cells) and the device-memory form (a
    cell past EM_SHARED_LIMIT), in f64: bit for bit against the plain
    version, the single-problem kernel and the native loop per cell; two
    launches, one per form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    problems, *ref = _cohort_problems(n_cells=12, n_alleles=1000, seed0=90)
    problems[3] = _wide_cell(12_000, 900, len(ref[0]), 7)
    problems[7] = _empty_cell(len(ref[0]))
    before = tem.launch_counts["em_squarem_batched"]
    got = em_quantify_batched(problems, *ref, min_squarem_alpha=min_alpha)
    assert tem.launch_counts["em_squarem_batched"] - before == 2
    plain = em_quantify_batched(problems, *ref, min_squarem_alpha=min_alpha,
                                device="cpu")
    for i, p in enumerate(problems):
        it, count = _native(p, *ref, min_alpha=min_alpha)
        assert got[i][0] == plain[i][0] == it, f"cell {i}"
        assert got[i][1].tobytes() == plain[i][1].tobytes() \
            == count.tobytes(), f"cell {i}"
        if not p[0]:
            continue
        it_k, count_k = tem.em_quantify_gpu(
            p[0], p[1], p[2], ref[0], np.zeros(len(ref[0])), p[3], *ref[1:],
            min_squarem_alpha=min_alpha)
        assert it_k == it and count_k.tobytes() == count.tobytes()
