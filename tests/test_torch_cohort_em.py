"""The port's cohort EM (t1k_tpu_torch/ops/em.py em_quantify_batched, the
cohort form of csrc/em_squarem.cu) against the native f64 loop per cell
and the JAX package's batched device EM (em_quantify_jax_batched)."""

import functools

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
    the cell's own kernel inputs (warp_lists of both passes at the cell's
    width, the counts, EC tables and initial abundances), the reference
    tables appear once, and the scratch offsets give each cell its own
    buffers.  A cell past EM_SHARED_LIMIT takes the device-memory form."""
    problems, *ref = _cohort_problems(n_cells=5, n_alleles=1000, seed0=50)
    problems.append(_wide_cell(12_000, 900, len(ref[0]), 7))
    cells = _cell_tables(problems, *ref)
    host = tem.batched_tables(cells, 8)
    rows = host["rows"]
    assert rows.shape == (6, 34)
    assert host["form"].tolist() == [tem.STAGED_FORM] * 5 + [tem.DEVICE_FORM]
    assert host["common"].tolist() == [len(ref[0]), ref[3], ref[4]]
    maj_off, maj_alleles = tem.major_lists(ref[2], ref[4])
    for k, want in ((12, ref[1]), (13, ref[2]), (14, maj_off),
                    (15, maj_alleles)):
        assert np.array_equal(host["ins"][k], want)
    for b, t in enumerate(cells):
        ec_cnt, rg_cnt = len(t["ec_len"]), len(t["rg_counts"])
        w = int(host["width"][b])
        assert w == tem.cohort_width(len(cells))
        csr = tem.warp_lists(t["rg_off"], t["rg_ecs"], threads=w)
        csc = tem.warp_lists(t["col_off"], t["col_rgs"], threads=w)
        assert rows[b, :6].tolist() == [ec_cnt, rg_cnt, len(csr["sched"]),
                                        len(csc["sched"]),
                                        len(csr["stream"]),
                                        len(csc["stream"])]
        own = [lists[k] for lists in (csr, csc)
               for k in ("sched", "len", "base", "stream")]
        own += [t["rg_counts"], t["ec_off"], t["ec_alleles"], t["ec_len"]]
        own += [None] * 4 + [t["init_x"]]
        for k, want in enumerate(own):
            if want is None:
                assert rows[b, 6 + k] == 0
                continue
            off = rows[b, 6 + k]
            assert np.array_equal(host["ins"][k][off:off + len(want)], want)
        vec = int(host["form"][b] == tem.DEVICE_FORM)
        want_sizes = [vec * ec_cnt] * 4 + [ec_cnt, vec * 2 * rg_cnt,
                                           vec * ec_cnt, len(ref[0]),
                                           len(ref[0]), ref[4], ref[3]]
        nxt = rows[b + 1, 23:] if b + 1 < len(cells) else host["scratch"]
        assert (nxt - rows[b, 23:]).tolist() == want_sizes


@pytest.mark.parametrize("n_cells,sms,width", [
    (1, 132, 512), (96, 132, 512), (264, 132, 512), (265, 132, 256),
    (384, 132, 256), (528, 132, 256), (529, 132, 128), (4_224, 132, 32),
    (100_000, 132, 32), (384, 66, 128)])
def test_cohort_width_is_the_cells_share_of_resident_threads(n_cells, sms,
                                                             width):
    """Each cell's share of 1,024 threads on each SM, rounded down to a
    power of two from 32 to 512."""
    assert tem.cohort_width(n_cells, sms) == width


@pytest.mark.parametrize("width", tem.COHORT_WIDTHS)
def test_warp_lists_deal_every_list_once_at_each_width(width):
    """warp_lists at each cohort width, on a cell's rows and columns,
    decodes back to every list in its order, each dealt exactly once;
    the slots fill whole turns of `width` threads."""
    problems, *ref = _cohort_problems(n_cells=1, n_alleles=1000, seed0=50)
    t = _cell_tables([_wide_cell(3_000, 700, len(ref[0]), 11)], *ref)[0]
    for off, idx in ((t["rg_off"], t["rg_ecs"]),
                     (t["col_off"], t["col_rgs"])):
        lists = tem.warp_lists(off, idx, threads=width)
        sched = lists["sched"]
        assert len(sched) % width == 0
        assert len(sched) // width == -(-(len(off) - 1) // width)
        dealt = sched[sched >= 0]
        assert sorted(dealt.tolist()) == list(range(len(off) - 1))
        for k in np.nonzero(sched >= 0)[0]:
            i = sched[k]
            n = lists["len"][k]
            got = lists["stream"][lists["base"][k // 32] + k % 32
                                  + 32 * np.arange(n)]
            assert np.array_equal(got, idx[off[i]:off[i + 1]])
        assert (lists["len"][sched < 0] == 0).all()


@pytest.mark.parametrize("width", tem.COHORT_WIDTHS)
def test_term_pass_positions_cover_every_list_element_once(width):
    """A mirror of the staged form's CSC term pass (em_squarem.cu
    em_update): thread t takes stream positions t, t + width, ..., walks
    its warp block w forward while base[w + 1] <= q, and reads slot
    32 w + q % 32, element (q - base[w]) / 32.  Over all threads that
    reaches every element of every column list exactly once, at the
    position the chain reads it from."""
    problems, *ref = _cohort_problems(n_cells=1, n_alleles=1000, seed0=50)
    t = _cell_tables([_wide_cell(700, 300, len(ref[0]), 12)], *ref)[0]
    lists = tem.warp_lists(t["col_off"], t["col_rgs"], threads=width)
    base, sched, lens = lists["base"], lists["sched"], lists["len"]
    slots, stream = len(sched), lists["stream"]
    seen = {}
    for tid in range(width):
        w = 0
        for q in range(tid, len(stream), width):
            while (w + 1) * 32 < slots and base[w + 1] <= q:
                w += 1
            k, j = 32 * w + q % 32, (q - base[w]) // 32
            if sched[k] >= 0 and j < lens[k]:
                assert (k, j) not in seen
                seen[k, j] = q
    want = {(k, j): base[k // 32] + k % 32 + 32 * j
            for k in np.nonzero(sched >= 0)[0] for j in range(lens[k])}
    assert seen == want
    for (k, j), q in seen.items():
        e = sched[k]
        assert stream[q] == t["col_rgs"][t["col_off"][e] + j]


def _mixed_cohort(n_alleles=1000):
    """Cells of 3 to 600 ECs against one reference: those whose lists are
    staged in shared memory, one whose vectors fit there but not its
    lists (cell 4), one past EM_SHARED_LIMIT (cell 3)."""
    problems, *ref = _cohort_problems(n_cells=4, n_alleles=n_alleles,
                                      seed0=90)
    for i, (rg, ec) in enumerate(((200, 48), (300, 100), (400, 200),
                                  (500, 400), (400, 600))):
        problems.append(_wide_cell(rg, ec, n_alleles, 20 + i))
    problems.insert(3, _wide_cell(12_000, 900, n_alleles, 7))
    problems.insert(4, _wide_cell(5_000, 900, n_alleles, 8))
    return problems, ref


def _form_of(t, width, stage=True):
    """(form, shared bytes) of one cell at `width`, by the rule
    batched_tables states."""
    ec_cnt, rg_cnt = len(t["ec_len"]), len(t["rg_counts"])
    staged = tem.staged_bytes(
        rg_cnt, ec_cnt, 8, tem.warp_lists(t["rg_off"], t["rg_ecs"], width),
        tem.warp_lists(t["col_off"], t["col_rgs"], width))
    vectors = tem.em_shared_bytes(rg_cnt, ec_cnt, 8)
    if stage and staged <= tem.EM_SHARED_LIMIT:
        return tem.STAGED_FORM, staged
    if vectors <= tem.EM_SHARED_LIMIT:
        return tem.SHARED_FORM, vectors
    return tem.DEVICE_FORM, 0


def test_batched_tables_give_each_cell_its_width_and_class():
    """Every cell gets the rule's width (or the forced one), lists dealt
    at it and the form and shared bytes it fits; cohort_classes puts each
    (form, width) in one class, widest first, and every cell in exactly
    one class, the device-memory cell in a class of its own."""
    problems, ref = _mixed_cohort()
    cells = _cell_tables(problems, *ref)
    for width, stage in [(None, True), (None, False),
                         *((w, True) for w in tem.COHORT_WIDTHS)]:
        host = tem.batched_tables(cells, 8, width, stage)
        want = [width or tem.cohort_width(len(cells))] * len(cells)
        assert host["width"].tolist() == want
        forms = [_form_of(t, w, stage) for t, w in zip(cells, want)]
        assert host["form"].tolist() == [f for f, _ in forms]
        assert host["bytes"].tolist() == [n for _, n in forms]
        classes = tem.cohort_classes(host)
        seen = np.concatenate([idx for _, _, idx in classes])
        assert sorted(seen.tolist()) == list(range(len(cells)))
        assert [w for _, w, _ in classes] == sorted(
            (w for _, w, _ in classes), reverse=True)
        assert len({(f, w) for f, w, _ in classes}) == len(classes)
        for form, w, idx in classes:
            assert (host["width"][idx] == w).all()
            assert (host["form"][idx] == form).all()
            for b in idx:
                t = cells[b]
                for k, (off, lst) in enumerate(((t["rg_off"], t["rg_ecs"]),
                                                (t["col_off"],
                                                 t["col_rgs"]))):
                    lists = tem.warp_lists(off, lst, threads=w)
                    assert host["rows"][b, 2 + k] == len(lists["sched"])
                    assert host["rows"][b, 4 + k] == len(lists["stream"])
                    for j, key in enumerate(("sched", "len", "base",
                                             "stream")):
                        at = host["rows"][b, 6 + 4 * k + j]
                        assert np.array_equal(
                            host["ins"][4 * k + j][at:at + len(lists[key])],
                            lists[key])
        device_form = [c for c in classes if c[0] == tem.DEVICE_FORM]
        assert len(device_form) == 1 and device_form[0][2].tolist() == [3]
    host = tem.batched_tables(cells, 8)
    assert host["form"][4] == tem.SHARED_FORM
    assert (np.delete(host["form"], [3, 4]) == tem.STAGED_FORM).all()
    with pytest.raises(ValueError, match="cohort width"):
        tem.batched_tables(cells, 8, width=48)


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
    version, the single-problem kernel and the native loop per cell; one
    launch per (form, width) class that batched_tables gives the
    cohort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    problems, *ref = _cohort_problems(n_cells=12, n_alleles=1000, seed0=90)
    problems[3] = _wide_cell(12_000, 900, len(ref[0]), 7)
    problems[7] = _empty_cell(len(ref[0]))
    classes = tem.cohort_classes(tem.batched_tables(
        _cell_tables([p for p in problems if p[0]], *ref), 8,
        sms=torch.cuda.get_device_properties(0).multi_processor_count))
    before = tem.launch_counts["em_squarem_batched"]
    got = em_quantify_batched(problems, *ref, min_squarem_alpha=min_alpha)
    assert tem.launch_counts["em_squarem_batched"] - before == len(classes)
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


@functools.lru_cache(maxsize=None)
def _mixed_results(min_alpha):
    """The mixed cohort's cells and per cell the native loop's
    (iterations, counts), each held equal to the plain version's and the
    single-problem kernel's, bit for bit."""
    problems, ref = _mixed_cohort()
    cells = _cell_tables(problems, *ref)
    opts = dict(filter_frac=0.15, min_squarem_alpha=min_alpha,
                max_iterations=1000)
    f64 = torch.float64
    plain = tem.squarem_batched_plain(cells, **opts, device="cpu", dtype=f64)
    want = []
    for i, p in enumerate(problems):
        it, count = _native(p, *ref, min_alpha=min_alpha)
        it_k, count_k = tem.squarem_cuda(**cells[i], **opts, device="cuda",
                                         dtype=f64)
        assert plain[i][0] == it_k == it, f"cell {i}"
        assert plain[i][1].numpy().tobytes() == count.tobytes() \
            == count_k.cpu().numpy().tobytes(), f"cell {i}"
        want.append((it, count.tobytes()))
    return cells, opts, want


@pytest.mark.cuda
@pytest.mark.parametrize("min_alpha", [0.0, -1.5])
@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("width", [None, *tem.COHORT_WIDTHS])
def test_batched_kernel_forced_width_matches_native(width, stage, min_alpha):
    """The mixed cohort (staged, vectors-only and device-memory forms) at
    the rule's width and forced to each width, with and without staged
    lists, f64: every cell the native loop's, the plain version's and the
    single-problem kernel's iterations and bits; one launch per class,
    every kernel at 0 bytes of local memory but the device-memory form at
    1,024 threads, which spills (64 registers) and which the rule, at
    most 512 threads, never launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    cells, opts, want = _mixed_results(min_alpha)
    f64 = torch.float64
    before = tem.launch_counts["em_squarem_batched"]
    batch = tem.squarem_batched_device(cells, "cuda", f64, width=width,
                                       stage=stage)
    tem.squarem_batched_launch(batch, **opts)
    got = [(it, c.cpu().numpy().tobytes()) for it, c in
           tem.squarem_batched_results(batch)]
    assert tem.launch_counts["em_squarem_batched"] - before == len(
        tem.cohort_classes(tem.batched_tables(
            cells, 8, width, stage,
            torch.cuda.get_device_properties(0).multi_processor_count)))
    for g in batch["launches"]:
        attrs = tem.batched_kernel_attrs(f64, g["form"], g["width"],
                                         g["bytes"])
        assert attrs["local_bytes"] == 0 or (
            width == 1024 and g["form"] == tem.DEVICE_FORM), (g, attrs)
        assert attrs["blocks_per_sm"] >= 1
    for i, (it, count) in enumerate(want):
        assert got[i] == (it, count), f"cell {i}"
