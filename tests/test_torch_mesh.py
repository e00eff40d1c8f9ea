"""The port's sharded EM (t1k_tpu_torch/parallel/mesh.py, K13) against the
native f64 loop and the JAX package's t1k_tpu/parallel/mesh.py (on the
8-device virtual CPU mesh); the cohort EM over a device list; and, on a
card (`cuda`), the sharded form of csrc/em_squarem.cu against its plain
version.  Shard lists of the CPU are devices repeated, as [cuda:0] * n is
on one card.  The JAX package is imported by the tests that use it, so
the `cuda` tests collect on a machine without JAX."""

import numpy as np
import pytest
import torch

from t1k_tpu_torch.device import NoCardError
from t1k_tpu_torch.native import em_quantify
from t1k_tpu_torch.ops import em as tem
from t1k_tpu_torch.ops.align_band import banded_stats_band
from t1k_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _em_inputs():
    """tests/test_device_ops.py's _em_inputs, copied."""
    rng = np.random.default_rng(3)
    n_alleles, n_genes, n_majors, ec_cnt, rg_cnt = 40, 3, 12, 15, 200
    ec_to_alleles = [[] for _ in range(ec_cnt)]
    for a in range(n_alleles):
        ec_to_alleles[a % ec_cnt].append(a)
    offs = [0]
    ecs = []
    for _ in range(rg_cnt):
        k = rng.integers(1, 6)
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
        n_genes=n_genes,
        n_majors=n_majors,
    )


# __graft_entry__.py's production-shape composite
B, LT, LP = 1024, 112, 100
EC_CNT, FANOUT = 512, 4
REF_SIM = 0.8


def _example_batch(b, Lt, Lp, seed=7):
    """__graft_entry__.py's _example_batch, copied."""
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 4, (b, Lt)).astype(np.int8)
    pc = tc[:, (Lt - Lp) // 2:(Lt - Lp) // 2 + Lp].copy()
    mut = rng.random((b, Lp)) < 0.02
    pc[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.int8)
    tl = np.full(b, Lt, np.int32)
    pl = np.full(b, Lp, np.int32)
    return tc, tl, pc, pl


def _graft_problem():
    """dryrun_multichip's ragged EM problem (__graft_entry__.py:231-262,
    copied): the seeded pair batch's band-stats match counts (the port's
    plain version; every pair's similarity puts its FragWeight at 1),
    FANOUT pairs per read group, 1-4 distinct ECs per group, two alleles
    per EC over 16 genes."""
    tc, tl, pc, pl = _example_batch(B, LT, LP)
    _, match, _, _ = banded_stats_band(tc, tl, pc, pl, ml=10, device="cpu")
    sim = 2.0 * 2.0 * match.astype(np.float32) / (tl + pl).astype(np.float32)
    segment = max((1 - REF_SIM) / 4.0, 0.01)
    frag_w = np.where(sim < 1 - 3 * segment, 0.01,
                      np.where(sim < 1 - 2 * segment, 0.1,
                               np.where(sim < 1 - segment, 0.5, 1.0)))
    rng = np.random.default_rng(5)
    rg_cnt = B // FANOUT
    rg_w = frag_w.reshape(rg_cnt, FANOUT).max(axis=1)
    counts = (rng.integers(1, 4, rg_cnt) * rg_w).astype(np.float64)
    seg_rg, seg_ec = [], []
    for g in range(rg_cnt):
        k = int(rng.integers(1, 5))
        for e in rng.choice(EC_CNT, size=k, replace=False):
            seg_rg.append(g)
            seg_ec.append(int(e))
    seg_rg = np.array(seg_rg, np.int32)
    n_alleles = EC_CNT * 2
    allele_major = (np.arange(n_alleles) // 2).astype(np.int32)
    rg_off = np.zeros(rg_cnt + 1, np.int64)
    np.add.at(rg_off[1:], seg_rg, 1)
    return dict(
        ec_to_alleles=[[2 * i, 2 * i + 1] for i in range(EC_CNT)],
        rg_ecs_csr=(np.cumsum(rg_off), np.array(seg_ec, np.int32)),
        rg_counts=counts,
        allele_eff_len=rng.integers(900, 1500, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=np.ones(n_alleles, np.int32),
        allele_gene=(allele_major % 16).astype(np.int32),
        allele_major=allele_major, n_genes=16, n_majors=EC_CNT)


PROBLEMS = {"em_inputs": _em_inputs, "graft": _graft_problem}


def _sharded_args(a):
    """A native problem as em_quantify_sharded_squarem's positional
    arguments after the mesh (counts per read group)."""
    rg_off, rg_ecs = a["rg_ecs_csr"]
    rg_cnt = len(a["rg_counts"])
    seg_rg = np.repeat(np.arange(rg_cnt), np.diff(rg_off)).astype(np.int32)
    return (seg_rg, np.asarray(rg_ecs, np.int32),
            np.asarray(a["rg_counts"], np.float64), rg_cnt,
            a["ec_to_alleles"], a["allele_eff_len"], a["allele_weight"],
            a["allele_gene"], a["allele_major"], a["n_genes"], a["n_majors"])


def _jax_mesh():
    from t1k_tpu.parallel import mesh as jmesh

    return jmesh


@pytest.fixture(scope="module")
def reference():
    """Per problem: the problem, the native loop's result and the JAX
    sharded SQUAREM's on the 8-device mesh (em_inputs in float32, as
    tests/test_device_ops.py runs it; the graft problem in float64 under
    x64, as dryrun_multichip's rerun does)."""
    import jax

    jmesh = _jax_mesh()
    out = {}
    for name, make in PROBLEMS.items():
        a = make()
        args = _sharded_args(a)
        if name == "graft":
            jax.config.update("jax_enable_x64", True)
            try:
                want = jmesh.em_quantify_sharded_squarem(
                    jmesh.data_mesh(8), *args)
            finally:
                jax.config.update("jax_enable_x64", False)
        else:
            want = jmesh.em_quantify_sharded_squarem(jmesh.data_mesh(8),
                                                     *args)
        out[name] = (a, em_quantify(**a), want)
    return out


@pytest.mark.parametrize("n", [1, 3, 8])
def test_partition_read_groups_matches_jax(n):
    """Both forms, array by array, on unsorted read groups with repeats."""
    jmesh = _jax_mesh()
    rng = np.random.default_rng(9)
    rg_cnt, ec_cnt, nnz = 50, 17, 400
    seg_rg = rng.integers(0, rg_cnt, nnz).astype(np.int32)
    seg_ec = rng.integers(0, ec_cnt, nnz).astype(np.int32)
    counts = rng.integers(1, 4, nnz).astype(np.float64)
    for kw in ({}, {"ec_cnt": ec_cnt}):
        want = jmesh.partition_read_groups(seg_rg, seg_ec, counts, rg_cnt, n,
                                           **kw)
        got = tmesh.partition_read_groups(seg_rg, seg_ec, counts, rg_cnt, n,
                                          **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_sharded_squarem_matches_native_and_jax(reference, problem, n):
    """n shards of the CPU: the native loop's iterations and bits (one
    chain per EC through the shards), the host loop and, at 1 shard, the
    single dispatch alike; and the JAX form on its 8-device mesh agrees at
    its own test's tolerance."""
    a, (it_n, count_n), (it_j, count_j) = reference[problem]
    args = _sharded_args(a)
    it, count = tmesh.em_quantify_sharded_squarem([CPU] * n, *args,
                                                  single_dispatch=False)
    assert it == it_n == it_j
    assert count.tobytes() == count_n.tobytes()
    if n == 1:
        for sd in (None, True):
            it1, count1 = tmesh.em_quantify_sharded_squarem(
                [CPU], *args, single_dispatch=sd)
            assert it1 == it and count1.tobytes() == count.tobytes()
    np.testing.assert_allclose(count, count_n, rtol=1e-9, atol=1e-9)
    if problem == "graft":   # float64, dryrun_multichip's f64 contract
        np.testing.assert_allclose(count, count_j, rtol=1e-9, atol=1e-9)
    else:                    # float32, test_sharded_squarem_matches_native
        np.testing.assert_allclose(count, count_j, rtol=2e-3, atol=1e-3)


def test_sharded_squarem_is_deterministic_and_f32_close():
    a = _em_inputs()
    args = _sharded_args(a)
    it_n, count_n = em_quantify(**a)
    first = tmesh.em_quantify_sharded_squarem([CPU] * 3, *args)
    again = tmesh.em_quantify_sharded_squarem([CPU] * 3, *args)
    assert first[0] == again[0] and first[1].tobytes() == again[1].tobytes()
    it32, count32 = tmesh.em_quantify_sharded_squarem(
        [CPU] * 3, *args, dtype=torch.float32)
    assert it32 == it_n
    np.testing.assert_allclose(count32, count_n, rtol=2e-3, atol=1e-3)


def test_more_shards_than_read_groups():
    """Shards past the read groups hold none and pass the chain on."""
    a = _em_inputs()
    rg_off, rg_ecs = a["rg_ecs_csr"]
    a["rg_ecs_csr"] = (rg_off[:6], rg_ecs[:rg_off[5]])
    a["rg_counts"] = a["rg_counts"][:5]
    it_n, count_n = em_quantify(**a)
    it, count = tmesh.em_quantify_sharded_squarem([CPU] * 8,
                                                  *_sharded_args(a))
    assert it == it_n and count.tobytes() == count_n.tobytes()


def _plain_em_problem():
    """tests/test_device_ops.py::test_sharded_em_multichip's problem: a
    count per entry, repeated (read group, EC) pairs among them."""
    rng = np.random.default_rng(5)
    ec_cnt, rg_cnt, nnz = 12, 300, 900
    seg_rg = np.sort(rng.integers(0, rg_cnt, nnz)).astype(np.int32)
    seg_ec = rng.integers(0, ec_cnt, nnz).astype(np.int32)
    counts = np.ones(nnz, np.float64)
    ec_len = rng.integers(800, 1200, ec_cnt).astype(np.float64)
    init = np.ones(ec_cnt, np.float64)
    return seg_rg, seg_ec, counts, rg_cnt, ec_len, init


@pytest.mark.parametrize("n", [1, 8])
def test_sharded_plain_em_matches_jax(n):
    seg_rg, seg_ec, counts, rg_cnt, ec_len, init = _plain_em_problem()
    pairs = seg_rg.astype(np.int64) * len(init) + seg_ec
    assert len(np.unique(pairs)) < len(pairs)  # repeats present
    jmesh = _jax_mesh()
    want = jmesh.em_quantify_sharded(jmesh.data_mesh(8), seg_rg, seg_ec,
                                     counts, rg_cnt, ec_len, init,
                                     iterations=20)
    got = tmesh.em_quantify_sharded([CPU] * n, seg_rg, seg_ec, counts,
                                    rg_cnt, ec_len, init, iterations=20)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    got64 = tmesh.em_quantify_sharded([CPU] * n, seg_rg, seg_ec, counts,
                                      rg_cnt, ec_len, init, iterations=20,
                                      dtype=torch.float64)
    np.testing.assert_allclose(got64, want, rtol=1e-4, atol=1e-6)


def test_sharded_em_step_is_one_update():
    seg_rg, seg_ec, counts, rg_cnt, ec_len, init = _plain_em_problem()
    step = tmesh.sharded_em_step([CPU] * 3, seg_rg, seg_ec, counts, rg_cnt,
                                 ec_len, dtype=torch.float64)
    x0 = torch.as_tensor(tmesh.normalized(init, torch.float64))
    x1, count = step(x0)
    want = tmesh.em_quantify_sharded([CPU] * 3, seg_rg, seg_ec, counts,
                                     rg_cnt, ec_len, init, iterations=1,
                                     dtype=torch.float64)
    assert x1.numpy().tobytes() == want.tobytes()
    per_len = count / torch.as_tensor(ec_len)
    np.testing.assert_allclose(x1.numpy(), (per_len / per_len.sum()).numpy(),
                               rtol=1e-12)


def test_shard_tables_lists():
    """Padding dropped; rows in the group's order; columns ascending with
    each entry's own count (repeats kept)."""
    rg_cnt, ec_cnt = 9, 4
    seg_rg = np.array([3, 3, 3, 5, 5, 8, 9, 9])   # 9 = rg_cnt: padding
    seg_ec = np.array([2, 0, 2, 1, 2, 0, 0, 0])
    counts = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.0, 0.0])
    t = tem.shard_tables(seg_rg, seg_ec, counts, rg_cnt, ec_cnt)
    assert t["row_off"].tolist() == [0, 3, 5, 6]
    assert t["row_ecs"].tolist() == [2, 0, 2, 1, 2, 0]
    assert t["col_off"].tolist() == [0, 2, 3, 6, 6]
    assert t["col_rows"].tolist() == [0, 2, 1, 0, 0, 1]
    assert t["col_cts"].tolist() == [2.0, 6.0, 4.0, 1.0, 3.0, 5.0]
    est = tem.estep_device(t, CPU, torch.float64)
    x = torch.tensor([0.5, 0.25, 0.125, 1.0], dtype=torch.float64)
    count = torch.full((4,), 7.0, dtype=torch.float64)
    tem.estep_rows(est, x)
    psum = [0.125 + 0.5 + 0.125, 0.25 + 0.125, 0.5]
    assert est["psum"].tolist() == psum
    terms = [[2 * (0.5 / psum[0]), 6 * (0.5 / psum[2])],
             [4 * (0.25 / psum[1])],
             [1 * (0.125 / psum[0]), 3 * (0.125 / psum[0]),
              5 * (0.125 / psum[1])], []]
    for carry, start in ((False, 0.0), (True, 7.0)):
        tem.estep_terms(est, x)
        tem.estep_fold(est, x, count, carry)
        want = []
        for ts in terms:   # one chain per EC, in list order from `start`
            total = start
            for term in ts:
                total += term
            want.append(total)
        assert count.tolist() == want
        count.fill_(7.0)


def _shard_cases():
    """Per case, shard_tables of every shard: em_inputs and the graft
    problem at 1, 2, 3 and 8 shards with 3 ECs no entry names (empty
    columns), and 5 read groups over 8 shards (shards without entries)."""
    cases = {}
    for problem in sorted(PROBLEMS):
        a = PROBLEMS[problem]()
        seg_rg, seg_ec, counts, rg_cnt, ec_to_alleles = _sharded_args(a)[:5]
        for n in (1, 2, 3, 8):
            out = tmesh.partition_read_groups(seg_rg, seg_ec, counts[seg_rg],
                                              rg_cnt, n)
            cases[f"{problem}_n{n}"] = [
                tem.shard_tables(out[0][s], out[1][s], out[2][s], rg_cnt,
                                 len(ec_to_alleles) + 3) for s in range(n)]
    a = _em_inputs()
    seg_rg, seg_ec, counts, _, ec_to_alleles = _sharded_args(a)[:5]
    few = seg_rg < 5
    out = tmesh.partition_read_groups(seg_rg[few], seg_ec[few],
                                      counts[seg_rg[few]], 5, 8)
    cases["five_groups_n8"] = [
        tem.shard_tables(out[0][s], out[1][s], out[2][s], 5,
                         len(ec_to_alleles)) for s in range(8)]
    return cases


SHARD_CASES = sorted(_shard_cases())


def _term_positions(cols) -> dict:
    """Stream position -> EC of every position the term pass writes, as
    estep_terms_kernel decides it (the position's EC is not -1)."""
    return {q: int(e) for q, e in enumerate(cols["ecs"]) if e >= 0}


def _fold_reads(cols) -> dict:
    """Stream position -> (slot, element) of every term the fold adds
    (estep_fold_kernel's term_chain: element j of slot k at base[k / 32]
    + 32 j + k % 32)."""
    out = {}
    for k, e in enumerate(cols["sched"]):
        if e >= 0:
            for j in range(cols["len"][k]):
                q = int(cols["base"][k // 32]) + 32 * j + k % 32
                assert q not in out
                out[q] = (k, j)
    return out


@pytest.mark.parametrize("case", SHARD_CASES)
def test_column_stream_reaches_every_entry_once_where_the_fold_reads(case):
    """Every real entry of every column is written by the term pass once,
    at the stream position where the fold reads it, holding its own row
    and count in list order; no padding position is written or read."""
    for t in _shard_cases()[case]:
        cols = tem.column_stream(t)
        ec_cnt = t["ec_cnt"]
        assert len(cols["sched"]) % tem.ESTEP_THREADS == 0
        assert len(cols["stream"]) == len(cols["cts"]) == len(cols["ecs"])
        slots = cols["sched"][cols["sched"] >= 0]
        assert sorted(slots.tolist()) == list(range(ec_cnt))
        written, read = _term_positions(cols), _fold_reads(cols)
        assert sorted(written) == sorted(read)
        assert len(written) == len(t["col_rows"])
        for q, (k, j) in read.items():
            e = cols["sched"][k]
            assert written[q] == e
            assert cols["len"][k] == t["col_off"][e + 1] - t["col_off"][e]
            entry = t["col_off"][e] + j
            assert cols["stream"][q] == t["col_rows"][entry]
            assert cols["cts"][q] == t["col_cts"][entry]
    if case == "five_groups_n8":
        assert any(len(t["col_rows"]) == 0 for t in _shard_cases()[case])


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", SHARD_CASES)
def test_split_plain_equals_the_fused_plain_column_pass(case, dtype, carry):
    """estep_terms_plain then estep_fold_plain, bit for bit
    estep_cols_plain (the independent form), x zero on every 7th EC;
    with the unread positions of the term buffer poisoned (NaN), which
    the fold never adds."""
    for s, t in enumerate(_shard_cases()[case]):
        ec_cnt = t["ec_cnt"]
        rng = np.random.default_rng(2 + s)
        x = torch.as_tensor(rng.random(ec_cnt), dtype=dtype)
        x[::7] = 0
        start = torch.as_tensor(rng.random(ec_cnt), dtype=dtype)
        est = tem.estep_device(t, CPU, dtype)
        tem.estep_rows_plain(est, x)
        want = start.clone()
        tem.estep_cols_plain(est, x, want, carry)
        tem.estep_terms_plain(est, x)
        real = list(_term_positions(tem.column_stream(t)))
        terms = est["terms"].clone()
        est["terms"].fill_(float("nan"))
        est["terms"][real] = terms[real]
        got = start.clone()
        tem.estep_fold_plain(est, x, got, carry)
        assert got.numpy().tobytes() == want.numpy().tobytes()
        if carry:   # an EC whose x is 0 keeps its start exactly
            assert got[::7].numpy().tobytes() == start[::7].numpy().tobytes()


def _record(monkeypatch, module, name, calls, what):
    """module.name, wrapped to append what(*its positional arguments) to
    `calls`."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(what(*args))
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)


def test_sharded_update_runs_terms_before_the_folds(monkeypatch):
    """ShardedEM.estep: every shard's row and term pass before the first
    fold, the folds in shard order; the CPU's host loop runs the split,
    not estep_cols_plain, and keeps the native bits."""
    a = _em_inputs()
    args = _sharded_args(a)
    calls = []
    for name in ("estep_rows", "estep_terms", "estep_fold"):
        _record(monkeypatch, tem, name, calls,
                lambda est, *_, _n=name: (_n, est["n_rows"]))

    def refuse(*_):
        raise AssertionError("the host loop ran the fused plain pass")
    monkeypatch.setattr(tem, "estep_cols_plain", refuse)
    it, count = tmesh.em_quantify_sharded_squarem([CPU] * 3, *args)
    it_n, count_n = em_quantify(**a)
    assert it == it_n and count.tobytes() == count_n.tobytes()
    first = calls[:9]
    assert [c[0] for c in first[:6]] == ["estep_rows", "estep_terms"] * 3
    assert [c[0] for c in first[6:]] == ["estep_fold"] * 3
    assert [c[1] for c in first[6:]] == [c[1] for c in first[:6:2]]


def test_multihost_term_pass_runs_before_the_hand_off(monkeypatch):
    """em_quantify_multihost on a one-rank Gloo group: each update's term
    pass before receive_partial, the fold after it; the in-process
    one-shard bits."""
    import socket

    import torch.distributed as dist

    from t1k_tpu_torch.parallel import multihost

    seg_rg, seg_ec, counts, rg_cnt, ec_len, init = _plain_em_problem()
    calls = []
    for module, name in ((tem, "estep_terms"), (tem, "estep_fold"),
                         (multihost, "receive_partial")):
        _record(monkeypatch, module, name, calls, lambda *_, _n=name: _n)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        x = multihost.em_quantify_multihost(
            seg_rg, seg_ec, counts, rg_cnt, ec_len, init, iterations=3,
            device="cpu", dtype=torch.float64)
    finally:
        dist.destroy_process_group()
    assert calls == ["estep_terms", "receive_partial", "estep_fold"] * 3
    want = tmesh.em_quantify_sharded([CPU], seg_rg, seg_ec, counts, rg_cnt,
                                     ec_len, init, iterations=3,
                                     dtype=torch.float64)
    assert x.tobytes() == want.tobytes()


def test_per_read_group_form_refuses_a_repeated_pair():
    a = _em_inputs()
    seg_rg, seg_ec, *rest = _sharded_args(a)
    seg_rg = np.append(seg_rg, seg_rg[0])
    seg_ec = np.append(seg_ec, seg_ec[0])
    with pytest.raises(ValueError, match="duplicate"):
        tmesh.em_quantify_sharded_squarem([CPU] * 2, seg_rg, seg_ec, *rest)


def test_no_quiet_fallback(monkeypatch):
    a = _em_inputs()
    args = _sharded_args(a)
    with pytest.raises(ValueError, match="single_dispatch"):
        tmesh.em_quantify_sharded_squarem([CPU] * 2, *args,
                                          single_dispatch=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError):
        tmesh.data_mesh()
    with pytest.raises(NoCardError):
        tmesh.data_mesh(2)
    assert tmesh.data_mesh(3, "cpu") == [CPU] * 3


def test_shard_batch_and_replicate():
    arr = np.arange(12.0).reshape(3, 4)
    rows = tmesh.shard_batch([CPU] * 3, arr)
    assert [r.tolist() for r in rows] == arr.tolist()
    copies = tmesh.replicate([CPU] * 2, arr)
    assert all(c.tolist() == arr.tolist() for c in copies)


def _cohort(n_cells=10, n_alleles=40, n_genes=4, seed0=70):
    """Per-cell EC problems against one reference
    (tests/test_device_ops.py's _cohort_problems, copied), one cell
    empty."""
    allele_gene = (np.arange(n_alleles) % n_genes).astype(np.int32)
    allele_major = (np.arange(n_alleles) // 2).astype(np.int32)
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
    problems[4] = ([], (np.array([0]), np.array([], np.int64)), np.zeros(0),
                   np.ones(n_alleles))
    return (problems, allele_eff_len, allele_gene, allele_major, n_genes,
            n_alleles // 2)


@pytest.mark.parametrize("n", [3, 20])
def test_cohort_em_over_a_device_list(n):
    """Cells dealt to n devices in blocks of ceil(C/n) (20 > the cells:
    devices left without one), each cell the bits of one device."""
    cohort = _cohort()
    want = tem.em_quantify_batched(*cohort, device="cpu")
    got = tem.em_quantify_batched(*cohort, device="cpu", devices=[CPU] * n)
    assert len(got) == len(want)
    for (it, c), (it_w, c_w) in zip(got, want):
        assert it == it_w and c.tobytes() == c_w.tobytes()


# ---- on a card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_sharded_estep_on_card_matches_plain(problem, dtype):
    """Each shard's local counts from the E-step kernels, bit for bit
    against the plain version on the card's tensors and on the CPU's."""
    dev = _card()
    a = PROBLEMS[problem]()
    seg_rg, seg_ec, counts, rg_cnt, ec_to_alleles = _sharded_args(a)[:5]
    ec_cnt = len(ec_to_alleles)
    out = tmesh.partition_read_groups(seg_rg, seg_ec, counts[seg_rg], rg_cnt,
                                      3)
    x = np.random.default_rng(2).random(ec_cnt)
    x[::7] = 0
    start = np.random.default_rng(4).random(ec_cnt)
    for s in range(3):
        t = tem.shard_tables(out[0][s], out[1][s], out[2][s], rg_cnt, ec_cnt)
        for carry in (False, True):
            got = []
            for d in (dev, CPU):
                est = tem.estep_device(t, d, dtype)
                xd = torch.as_tensor(x, dtype=dtype, device=d)
                count = torch.as_tensor(start, dtype=dtype, device=d)
                tem.estep_rows(est, xd)
                tem.estep_terms(est, xd)
                tem.estep_fold(est, xd, count, carry)
                got.append(count.cpu().numpy().tobytes())
            assert got[0] == got[1]


@pytest.mark.cuda
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_sharded_squarem_on_card(problem):
    """1 shard: the native loop's bits, and the single dispatch (one
    em_squarem.cu launch) equal; 2 and 4 shards of one card: bit for bit
    the CPU's shards."""
    dev = _card()
    a = PROBLEMS[problem]()
    args = _sharded_args(a)
    it_n, count_n = em_quantify(**a)
    launches = dict(tem.launch_counts)
    fused = dict(tem.fused_launches)
    it, count = tmesh.em_quantify_sharded_squarem([dev], *args,
                                                  single_dispatch=False)
    for key in (*tem.ESTEP_KERNELS, "em_sharded_tail"):
        assert tem.launch_counts[key] > launches[key]
    assert tem.fused_launches == fused
    assert it == it_n and count.tobytes() == count_n.tobytes()
    it1, count1 = tmesh.em_quantify_sharded_squarem([dev], *args)
    assert tem.launch_counts["em_squarem"] == launches["em_squarem"] + 1
    assert it1 == it and count1.tobytes() == count.tobytes()
    for n in (2, 4):
        got = tmesh.em_quantify_sharded_squarem([dev] * n, *args)
        want = tmesh.em_quantify_sharded_squarem([CPU] * n, *args)
        assert got[0] == want[0] == it_n
        assert got[1].tobytes() == want[1].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", SHARD_CASES)
def test_split_estep_on_card_matches_plain_and_the_fused_pass(case, dtype):
    """Each shard's row pass, term pass and fold on the card: psum and
    every term the kernel writes bit for bit the plain split's on the
    card's tensors, and the counts bit for bit the plain split's and the
    first design's fused column pass's (forced), from 0 and with carry,
    x zero on every 7th EC."""
    dev = _card()
    for s, t in enumerate(_shard_cases()[case]):
        rng = np.random.default_rng(2 + s)
        x = torch.as_tensor(rng.random(t["ec_cnt"]), dtype=dtype)
        x[::7] = 0
        start = torch.as_tensor(rng.random(t["ec_cnt"]), dtype=dtype,
                                device=dev)
        xd = x.to(dev)
        est = tem.estep_device(t, dev, dtype)
        plain = tem.estep_device(t, dev, dtype, plain=True)
        tem.estep_rows(est, xd)
        tem.estep_rows_plain(plain, xd)
        n_rows = est["n_rows"]
        assert (est["psum"][:n_rows].cpu().numpy().tobytes()
                == plain["psum"].cpu().numpy().tobytes())
        tem.estep_terms(est, xd)
        tem.estep_terms_plain(plain, xd)
        cols = tem.column_stream(t)
        live = [q for q, e in _term_positions(cols).items() if x[e] != 0]
        assert (est["terms"][live].cpu().numpy().tobytes()
                == plain["terms"][live].cpu().numpy().tobytes())
        for carry in (False, True):
            got, want, fused = start.clone(), start.clone(), start.clone()
            tem.estep_fold(est, xd, got, carry)
            tem.estep_fold_plain(plain, xd, want, carry)
            tem.estep_cols_fused_cuda(est, xd, fused, carry)
            assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
            assert got.cpu().numpy().tobytes() == fused.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_more_shards_than_read_groups_on_card():
    """Shards of one card without entries launch no row or term pass and
    pass the chain on: the native bits."""
    dev = _card()
    a = _em_inputs()
    rg_off, rg_ecs = a["rg_ecs_csr"]
    a["rg_ecs_csr"] = (rg_off[:6], rg_ecs[:rg_off[5]])
    a["rg_counts"] = a["rg_counts"][:5]
    it_n, count_n = em_quantify(**a)
    it, count = tmesh.em_quantify_sharded_squarem([dev] * 8,
                                                  *_sharded_args(a))
    assert it == it_n and count.tobytes() == count_n.tobytes()


@pytest.mark.cuda
def test_cohort_em_over_one_card_twice():
    dev = _card()
    cohort = _cohort()
    want = tem.em_quantify_batched(*cohort, device="cpu")
    got = tem.em_quantify_batched(*cohort, devices=[dev] * 2)
    for (it, c), (it_w, c_w) in zip(got, want):
        assert it == it_w and c.tobytes() == c_w.tobytes()
