"""The port's SQUAREM EM (t1k_tpu_torch/ops/em.py) against the native
f64 oracle and the JAX device EM."""

import numpy as np
import pytest
import torch

from t1k_tpu.native import em_quantify
from t1k_tpu_torch.ops import em as tem
from t1k_tpu_torch.ops.em import em_quantify_gpu, incidence_lists


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _em_problem(rg_cnt, ec_cnt, seed, n_alleles, n_genes, n_majors, max_k):
    """The seeded EM problems of test_device_ops (_em_inputs) and
    test_routing (_em_inputs), by their constants."""
    rng = np.random.default_rng(seed)
    ec_to_alleles = [[] for _ in range(ec_cnt)]
    for a in range(n_alleles):
        ec_to_alleles[a % ec_cnt].append(a)
    offs, ecs = [0], []
    for _ in range(rg_cnt):
        k = rng.integers(1, max_k)
        ecs.extend(rng.choice(ec_cnt, size=k, replace=False).tolist())
        offs.append(len(ecs))
    return dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0], rg_cnt),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes, n_majors=n_majors)


def _small_inputs():
    return _em_problem(200, 15, 3, 40, 3, 12, 6)


def _routing_inputs(rg_cnt=2000, ec_cnt=60, seed=3):
    return _em_problem(rg_cnt, ec_cnt, seed, 120, 4, 24, 8)


def _skewed_inputs(rg_cnt=1150, ec_cnt=160, seed=17, n_alleles=400,
                   n_genes=5, n_majors=60):
    """EC 0 in 95% of the read groups, so its column (about 1,090 read
    groups) is longer than the kernel's 1,024 threads, and rows of up to
    116 ECs (geometric, mean 30): the HLA problem's longest row is 115."""
    rng = np.random.default_rng(seed)
    ec_to_alleles = [[] for _ in range(ec_cnt)]
    for a in range(n_alleles):
        ec_to_alleles[a % ec_cnt].append(a)
    offs, ecs = [0], []
    for _ in range(rg_cnt):
        k = int(min(rng.geometric(1 / 30), 115))
        row = rng.choice(np.arange(1, ec_cnt), size=k, replace=False).tolist()
        if rng.random() < 0.95:
            row.insert(int(rng.integers(0, len(row) + 1)), 0)
        ecs.extend(row)
        offs.append(len(ecs))
    return dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0], rg_cnt),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes, n_majors=n_majors)


PROBLEMS = {"device_ops": _small_inputs, "routing": _routing_inputs,
            "routing_masked": lambda: _routing_inputs(rg_cnt=500, ec_cnt=30,
                                                      seed=11),
            "skewed": _skewed_inputs}
# f32 against f32 in another summation order: on the skewed problem the
# two f32 loops stop at different rounds (25 here, 21 in the JAX loop),
# so it is held to the native loop in f64 only
F32_PROBLEMS = sorted(set(PROBLEMS) - {"skewed"})


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_f64_matches_native_bit_for_bit(problem):
    """f64 in em.cc's summation order: the native loop's iteration count
    and its counts, bit for bit (the issue's rtol 1e-9 is met with 0)."""
    args = PROBLEMS[problem]()
    it_native, count_native = em_quantify(**args)
    it, count = em_quantify_gpu(**args, device="cpu")
    assert it == it_native
    assert count.dtype == np.float64
    np.testing.assert_array_equal(count, count_native)


def test_f64_matches_native_with_squarem_alpha_floor():
    args = _routing_inputs(rg_cnt=800, ec_cnt=40, seed=7)
    it_native, count_native = em_quantify(min_squarem_alpha=-1.5, **args)
    it, count = em_quantify_gpu(min_squarem_alpha=-1.5, device="cpu", **args)
    assert it == it_native
    np.testing.assert_array_equal(count, count_native)


@pytest.mark.parametrize("problem", F32_PROBLEMS)
def test_f32_matches_jax(problem):
    """f32 against em_quantify_jax (f32 here: jax_enable_x64 is off).
    rtol 1e-4: the two f32 loops sum in different orders, and SQUAREM's
    extrapolation amplifies that f32 rounding."""
    from t1k_tpu.ops.em import em_quantify_jax

    args = PROBLEMS[problem]()
    it_jax, count_jax = em_quantify_jax(**args)
    it, count = em_quantify_gpu(**args, device="cpu", dtype=torch.float32)
    assert it == it_jax
    np.testing.assert_allclose(count, count_jax, rtol=1e-4, atol=1e-4)


def test_incidence_lists_and_their_checks():
    rg_off = np.array([0, 2, 3, 4])
    col_off, col_rgs = incidence_lists(rg_off, np.array([1, 2, 0, 1]), 3)
    assert col_off.tolist() == [0, 1, 3, 4]
    assert col_rgs.tolist() == [1, 0, 2, 0]  # per EC, read groups ascending
    with pytest.raises(ValueError, match="duplicate"):
        incidence_lists(rg_off, np.array([1, 1, 0, 1]), 3)
    with pytest.raises(ValueError, match="out of range"):
        incidence_lists(rg_off, np.array([1, 2, 0, 3]), 3)


def test_em_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        em_quantify_gpu(**_small_inputs(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_kernel_on_card_matches_native_and_plain(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    args = PROBLEMS[problem]()
    it_native, count_native = em_quantify(**args)
    it, count = em_quantify_gpu(**args, device="cuda")
    assert it == it_native
    np.testing.assert_array_equal(count, count_native)
    if problem not in F32_PROBLEMS:
        return
    it32, count32 = em_quantify_gpu(**args, device="cuda",
                                    dtype=torch.float32)
    it32_plain, count32_plain = em_quantify_gpu(**args, device="cpu",
                                                dtype=torch.float32)
    # f32: the CPU plain version's sequential sums accumulate in f64
    assert it32 == it32_plain
    np.testing.assert_allclose(count32, count32_plain, rtol=1e-4, atol=1e-4)


# ------------------------------------------------- the kernel's schedule

def _mirror_squarem(t, filter_frac=0.15, min_alpha=0.0, max_iterations=1000,
                    threads=tem.EM_THREADS):
    """numpy mirror of csrc/em_squarem.cu's fold schedule, in f64: the CSR
    and CSC passes turn by turn as the threads read warp_lists' streams,
    each thread folding its list's precomputed terms in list order (a
    read group's ECs in its order, an EC's read groups ascending); the
    EC-length sums folded left to right from their term vectors; the
    mask's major sums one chain per major over major_lists, the gene
    maximum in any order."""
    ec_len, rg_counts = t["ec_len"], t["rg_counts"]
    ec_cnt, rg_cnt = len(ec_len), len(rg_counts)
    rg_off, rg_ecs = t["rg_off"], t["rg_ecs"]
    col_off, col_rgs = t["col_off"], t["col_rgs"]
    ec_off, ec_alleles = t["ec_off"], t["ec_alleles"]
    gene, major = t["allele_gene"], t["allele_major"]
    maj_off, maj_alleles = tem.major_lists(major, t["major_cnt"])
    maj_idx = tem._padded(maj_off, maj_alleles, len(major))   # [M, Lm]
    rgc_z = np.append(rg_counts, 0.0)

    def turns(lists, pad):
        """Per turn of the kernel's threads: the lists they fold and each
        list's indices as read from the warp-interleaved stream, `pad`
        past its end."""
        sched, lens, base = lists["sched"], lists["len"], lists["base"]
        out = []
        for k in range(len(sched) // threads):
            slots = np.arange(k * threads, (k + 1) * threads)
            slots = slots[sched[slots] >= 0]
            j = np.arange(lens[slots].max(initial=0))
            valid = j[None, :] < lens[slots][:, None]
            pos = base[slots // 32][:, None] + 32 * j + (slots % 32)[:, None]
            out.append((sched[slots], np.where(
                valid, lists["stream"][np.where(valid, pos, 0)], pad)))
        return out

    row_turns = turns(tem.warp_lists(rg_off, rg_ecs, threads), ec_cnt)
    col_turns = turns(tem.warp_lists(col_off, col_rgs, threads), rg_cnt)

    def fold_cols(terms):  # each row left to right, rows side by side
        acc = np.zeros(terms.shape[0])
        for j in range(terms.shape[1]):
            acc = acc + terms[:, j]
        return acc

    def fold_seq(v):  # one thread, left to right (numpy's cumsum is)
        return np.cumsum(v)[-1] if len(v) else 0.0

    def em_update(x):
        psum = np.full(rg_cnt, np.nan)
        x_z = np.append(x, 0.0)
        for rows, idx in row_turns:
            psum[rows] = fold_cols(x_z[idx])
        psum[psum == 0] = 1.0
        psum_z = np.append(psum, 1.0)
        count = np.full(ec_cnt, np.nan)
        for cols, r in col_turns:
            count[cols] = fold_cols(rgc_z[r] * (x[cols, None] / psum_z[r]))
        # every list folded once
        assert not (np.isnan(psum).any() or np.isnan(count).any())
        per_len = count / ec_len
        return per_len / fold_seq(per_len), count

    def mask_reset(count):
        abund = count / ec_len * 1000.0
        size = np.diff(ec_off)
        of_allele = np.repeat(np.arange(ec_cnt), size)
        allele_abund = np.zeros(len(major) + 1)
        allele_ec_abund = np.zeros(len(major))
        allele_abund[ec_alleles] = (abund / size)[of_allele]
        allele_ec_abund[ec_alleles] = abund[of_allele]
        major_abund = fold_cols(allele_abund[maj_idx])
        gene_max = np.zeros(t["gene_cnt"])
        np.maximum.at(gene_max, gene, major_abund[major])
        masked = major_abund[major] < filter_frac * 0.5 * gene_max[gene]
        allele_ec_abund[masked] = 0.0
        return allele_ec_abund[ec_alleles[ec_off[:-1]]]

    x0 = t["init_x"].copy()
    iters, step = 0, 0
    while step < max_iterations:
        iters += 1
        x1, _ = em_update(x0)
        x2, _ = em_update(x1)
        sum_r = fold_seq((x1 - x0) * (x1 - x0))
        v = x2 - 2 * x1 + x0
        sum_v = fold_seq(v * v)
        alpha = -1.0 if sum_v == 0 else -np.sqrt(sum_r) / np.sqrt(sum_v)
        if min_alpha < 0 and alpha < min_alpha:
            alpha = min_alpha
        x3 = x0 - 2 * alpha * (x1 - x0) + alpha * alpha * (x2 - 2 * x1 + x0)
        x1, count = em_update(x3)
        diff = fold_seq(np.abs(x1 - x0))
        x0 = x1
        if diff < 1e-5 and step < max_iterations - 2:
            step = max_iterations - 2
        if step > 0 and step % tem.MASK_ROUND == 0:
            x0 = mask_reset(count)
        step += 1
    return iters, count


def _tables(args):
    return tem.em_tables(**{k: v for k, v in args.items()
                            if k != "allele_missing"})


@pytest.mark.parametrize("threads", [tem.EM_THREADS, 64])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_fold_schedule_mirror_matches_native_bit_for_bit(problem, threads):
    """The kernel's schedule (64 threads: several turns per thread)
    gives the native loop's iterations and counts, bit for bit."""
    args = PROBLEMS[problem]()
    it_native, count_native = em_quantify(**args)
    it, count = _mirror_squarem(_tables(args), threads=threads)
    assert it == it_native
    np.testing.assert_array_equal(count, count_native)


def test_list_schedule_deals_each_list_once_longest_first():
    rng = np.random.default_rng(8)
    # 1,070 columns as long as the HLA problem's (median ~194, max 571)
    lens = np.minimum(rng.geometric(1 / 200, 1070), 571)
    lens[0] = 571
    col_off = np.concatenate([[0], np.cumsum(lens)])
    sched = tem.list_schedule(col_off)
    assert len(sched) == 2 * tem.EM_THREADS
    assert sorted(sched[sched >= 0].tolist()) == list(range(1070))
    turns = sched.reshape(2, tem.EM_THREADS)
    # turn 0: the 1,024 longest, longest at thread 0; turn 1 reversed, so
    # its columns land on the threads that took the shortest of turn 0
    assert (np.diff(lens[turns[0]]) <= 0).all()
    assert (turns[1, :tem.EM_THREADS - 46] == -1).all()
    second = turns[1] >= 0
    assert (lens[turns[1, second]][::-1] <= lens[turns[0, second]].min()).all()
    load = np.where(turns >= 0, lens[np.maximum(turns, 0)], 0).sum(0)
    assert load.max() == 571  # no thread folds two long columns
    assert tem.list_schedule(col_off, 64).size == 17 * 64


@pytest.mark.parametrize("threads", [tem.EM_THREADS, 64])
def test_warp_lists_hold_each_list_lane_by_lane(threads):
    args = _skewed_inputs()
    off, idx = args["rg_ecs_csr"]
    lists = tem.warp_lists(off, idx, threads)
    sched, lens, base = lists["sched"], lists["len"], lists["base"]
    assert len(base) == len(sched) // 32
    for slot in np.nonzero(sched >= 0)[0]:
        i = sched[slot]
        got = lists["stream"][base[slot // 32] + slot % 32
                              + 32 * np.arange(lens[slot])]
        np.testing.assert_array_equal(got, idx[off[i]:off[i + 1]])
    assert (lens[sched < 0] == 0).all()
    # each warp's block is as high as its longest list, and lists sorted
    # by length keep the padding small
    height = lens.reshape(-1, 32).max(axis=1)
    assert len(lists["stream"]) == 32 * height.sum()
    assert 32 * height.sum() < 1.1 * len(idx)


def test_major_lists_ascending():
    maj_off, alleles = tem.major_lists(np.array([2, 0, 2, 1, 0]), 4)
    assert maj_off.tolist() == [0, 2, 3, 5, 5]
    assert alleles.tolist() == [1, 4, 3, 0, 2]


def test_shared_memory_bytes_choose_the_form():
    # the HLA problem (5,421 read groups x 1,070 ECs) fits in f64 and f32
    assert tem.em_shared_bytes(5421, 1070, 8) == 146_656
    assert tem.em_shared_bytes(5421, 1070, 8) <= tem.EM_SHARED_LIMIT
    assert tem.em_shared_bytes(5421, 1070, 4) <= tem.EM_SHARED_LIMIT
    # ten times that does not: the device-memory form
    assert tem.em_shared_bytes(54210, 10700, 8) > tem.EM_SHARED_LIMIT
    assert tem.EM_SHARED_LIMIT < 232_448  # an H100 block's opt-in bytes
    big = dict(_tables(_small_inputs()), rg_counts=np.zeros(54210),
               ec_len=np.ones(10700))
    big.pop("init_x")
    with pytest.raises(ValueError, match="does not fit"):
        tem.squarem_device(**{k: big[k] for k in (
            "rg_off", "rg_ecs", "rg_counts", "col_off", "col_rgs", "ec_off",
            "ec_alleles", "ec_len", "allele_gene", "allele_major",
            "gene_cnt", "major_cnt")}, init_x=np.ones(10700), device="cpu",
            dtype=torch.float64, shared=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_kernel_forms_on_card_match_native(problem, shared):
    """Both instantiations, forced: the device-memory form (which a
    problem past EM_SHARED_LIMIT takes) and the shared-memory form, in
    f64, bit for bit against the native loop; the profiled form too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    args = PROBLEMS[problem]()
    it_native, count_native = em_quantify(**args)
    t = _tables(args)
    kw = dict(filter_frac=0.15, min_squarem_alpha=0.0, max_iterations=1000)
    it, count = tem.squarem_cuda(**t, **kw, device="cuda",
                                 dtype=torch.float64, shared=shared)
    assert it == it_native
    np.testing.assert_array_equal(count.cpu().numpy(), count_native)
    em_dev = tem.squarem_device(**t, device="cuda", dtype=torch.float64,
                                shared=shared)
    cycles = torch.zeros(len(tem.EM_PHASES) + 1, dtype=torch.int64,
                         device="cuda")
    tem.squarem_launch(em_dev, **kw, cycles=cycles)
    assert int(em_dev["iterations"].item()) == it_native
    np.testing.assert_array_equal(em_dev["count"].cpu().numpy(), count_native)
    c = cycles.cpu().numpy()
    assert (c[:-1] >= 0).all() and 0 < c[:-1].sum() <= c[-1]


# ------------------------------------------------------------ segment EM (K7)

def _jax_segment_em(args, **opts):
    """em_quantify_jax on its segment loop (_em_loop): DENSE_EM_MAX_ELEMS
    set to 0 forces it, as tests/test_device_ops.py does, in f64 under
    jax_enable_x64; both restored after."""
    import jax

    from t1k_tpu.ops import em as jem

    old = jem.DENSE_EM_MAX_ELEMS
    jax.config.update("jax_enable_x64", True)
    jem.DENSE_EM_MAX_ELEMS = 0
    try:
        return jem.em_quantify_jax(**args, **opts)
    finally:
        jem.DENSE_EM_MAX_ELEMS = old
        jax.config.update("jax_enable_x64", False)


SEGMENT_CASES = {name: (make, {}) for name, make in PROBLEMS.items()}
SEGMENT_CASES["alpha_floor"] = (
    lambda: _routing_inputs(rg_cnt=800, ec_cnt=40, seed=7),
    {"min_squarem_alpha": -1.5})


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_em_matches_jax_em_loop(case):
    """The port's segment EM against the JAX _em_loop, both in f64: the
    same iteration count, and counts within atol 1e-6 reads (rtol 1e-9).
    Both take each sum as a cumsum difference, XLA's CPU cumsum and
    torch's grouping the adds differently; the largest difference seen is
    5.2e-7 reads, on the skewed problem (25 rounds over 33,000 entries),
    about 2e-16 of its prefix sums per round carried by SQUAREM."""
    make, opts = SEGMENT_CASES[case]
    args = make()
    it_jax, count_jax = _jax_segment_em(args, **opts)
    it, count = tem.em_quantify_segment(**args, **opts, device="cpu")
    assert it == it_jax
    assert count.dtype == np.float64 and count.shape == count_jax.shape
    np.testing.assert_allclose(count, count_jax, rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_em_matches_native_at_the_reference_tolerance(case):
    """Against the native loop at the reference's own tolerance for its
    segment path (tests/test_device_ops.py: rtol 2e-3, atol 1e-3)."""
    make, opts = SEGMENT_CASES[case]
    args = make()
    it_native, count_native = em_quantify(**args, **opts)
    it, count = tem.em_quantify_segment(**args, **opts, device="cpu")
    assert it == it_native
    np.testing.assert_allclose(count, count_native, rtol=2e-3, atol=1e-3)


def test_segment_tables_are_the_jax_loops():
    """The host tables em_quantify_jax hands _em_loop: sorted orders,
    their bounds, and an allele in two ECs taking the later one."""
    from t1k_tpu.ops import em as jem

    args = _small_inputs()
    args["ec_to_alleles"][3] = args["ec_to_alleles"][3] + [0]
    t = tem.segment_tables(
        args["ec_to_alleles"], args["rg_ecs_csr"], args["rg_counts"],
        args["allele_eff_len"], args["allele_weight"], args["allele_gene"],
        args["allele_major"], args["n_genes"], args["n_majors"])
    rg_off, rg_ecs = args["rg_ecs_csr"]
    seg_rg = np.repeat(np.arange(len(args["rg_counts"])), np.diff(rg_off))
    perm = np.argsort(rg_ecs, kind="stable")
    assert np.array_equal(t["sec_sorted"], rg_ecs[perm])
    assert np.array_equal(t["srg_ecorder"], seg_rg[perm])
    for mine, theirs in zip(t["ec_bounds"], jem.segment_bounds(
            rg_ecs[perm], len(args["ec_to_alleles"]))):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
    ec_len, ec_size, ec_first, allele_ec, allele_valid, init_x = \
        jem._pack_ec_tables(args["ec_to_alleles"], args["allele_eff_len"],
                            args["allele_weight"])
    for name, want in (("ec_len", ec_len), ("ec_size", ec_size),
                       ("ec_first", ec_first), ("allele_ec", allele_ec),
                       ("allele_valid", allele_valid), ("init_x", init_x)):
        assert np.array_equal(t[name], want), name


def test_segment_em_is_reached_only_by_name():
    """No module of the port but ops/em.py names em_quantify_segment: no
    "auto" route and no --emBackend value reaches it."""
    import os

    import t1k_tpu_torch

    pkg = os.path.dirname(t1k_tpu_torch.__file__)
    named = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if "em_quantify_segment" in fh.read():
                        named.append(os.path.relpath(os.path.join(root, f),
                                                     pkg))
    assert named == [os.path.join("ops", "em.py")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_em_on_card_matches_native(case):
    """The segment EM on the card's tensors: the native loop's rounds and
    counts at the reference's tolerance, as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    make, opts = SEGMENT_CASES[case]
    args = make()
    it_native, count_native = em_quantify(**args, **opts)
    it, count = tem.em_quantify_segment(**args, **opts, device="cuda")
    assert it == it_native
    np.testing.assert_allclose(count, count_native, rtol=2e-3, atol=1e-3)
