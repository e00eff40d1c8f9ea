"""The port's v1 full-row aligner (t1k_tpu_torch/ops/align.py) against the
JAX package's XLA program (ops/align.py), its Pallas kernel in interpret
mode (ops/align_pallas.py), the golden score table and the port's band
aligner.

Integer kernels: every comparison is exact.  The plain PyTorch version
runs here on the CPU; the CUDA kernel is compared with it on a card by
the test marked `cuda` (and by chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu.constants import encode_seq
from t1k_tpu_torch.ops import align as v1
from t1k_tpu_torch.ops import align_band as ab

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_batch():
    """The 400 scored cases of golden/align_global.tsv as padded windows."""
    cases = []
    with open(os.path.join(HERE, "golden", "align_global.tsv")) as f:
        for line in f:
            _, _, t, p, score, _ = line.rstrip("\n").split("\t")
            cases.append(("" if t == "-" else t, "" if p == "-" else p,
                          int(score)))
    tc = np.zeros((len(cases), max(len(c[0]) for c in cases) + 1), np.int8)
    pc = np.zeros((len(cases), max(len(c[1]) for c in cases) + 1), np.int8)
    for i, (t, p, _) in enumerate(cases):
        tc[i, :len(t)] = encode_seq(t)
        pc[i, :len(p)] = encode_seq(p)
    tl = np.array([len(c[0]) for c in cases], np.int32)
    pl = np.array([len(c[1]) for c in cases], np.int32)
    return tc, tl, pc, pl, np.array([c[2] for c in cases], np.int32)


def _seeded_pairs(seed, n, lt=96, lp=64, max_diff=40):
    """Reads against mutated panel-like windows of read length +-max_diff
    (clipped to the widths), N bases and padding garbage included."""
    rng = np.random.default_rng(seed)
    pl = rng.integers(0, lp + 1, n).astype(np.int32)
    tl = np.clip(pl + rng.integers(-max_diff, max_diff + 1, n), 0,
                 lt).astype(np.int32)
    tc = rng.integers(0, 5, (n, lt)).astype(np.int8)
    pc = rng.integers(0, 5, (n, lp)).astype(np.int8)
    same = rng.random(n) < 0.7
    m = min(lt, lp)
    pc[same, :m] = tc[same, :m]
    mut = rng.random((n, lp)) < 0.08
    pc[mut] = rng.integers(0, 5, int(mut.sum()))
    pl[:4] = [0, 1, 1, 2]
    tl[:4] = [3, 1, 0, 1]
    return tc, tl, pc, pl


def test_plain_matches_golden_table_and_jax_program():
    from t1k_tpu.ops.align import banded_scores

    tc, tl, pc, pl, want = _golden_batch()
    got = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    assert got.dtype == np.int32
    assert (got == want).all()
    assert (v1.banded_scores_full(tc, tl, pc, pl, device="cpu") == want).all()
    assert (np.asarray(banded_scores(tc, tl, pc, pl)) == got).all()


def test_plain_matches_pallas_interpret():
    from t1k_tpu.ops.align_pallas import banded_scores_pallas

    tc, tl, pc, pl, want = _golden_batch()
    jax_got = np.asarray(banded_scores_pallas(tc[:32], tl[:32], pc[:32],
                                              pl[:32], block_b=32,
                                              interpret=True))
    got = v1.banded_scores(tc[:32], tl[:32], pc[:32], pl[:32], device="cpu")
    assert (got == jax_got).all()
    assert (got == want[:32]).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_matches_jax_program_on_seeded_pairs(seed):
    """Large length differences, empty and single-base pairs, padding."""
    from t1k_tpu.ops.align import banded_scores

    tc, tl, pc, pl = _seeded_pairs(seed, 300)
    got = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    assert (got == np.asarray(banded_scores(tc, tl, pc, pl))).all()


def test_plain_matches_band_aligner_where_the_band_fits():
    """The v1 and band-packed aligners share the scoring contract."""
    tc, tl, pc, pl = _seeded_pairs(11, 400, lt=80, lp=80, max_diff=10)
    got = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    ml, over = ab._window_class(tl, pl)
    assert ab.band_window(ml, over) <= 32
    assert (got == ab.banded_scores_band(tc, tl, pc, pl,
                                         device="cpu")).all()


def test_lengths_outside_the_widths_raise():
    tc, tl, pc, pl = _seeded_pairs(5, 8)
    with pytest.raises(ValueError, match="within the window widths"):
        v1.banded_scores(tc, tl + 200, pc, pl, device="cpu")


# |t_len - p_len| at both sides of each slot edge (slots = 13 + |diff|):
# the thread path's NS (16, 20, 24, 28, then 32 and the tile path), the
# tile path's 32 x CPL (64, 96, ..., 448, then 512 and the ring path),
# and deep in the ring path.
EDGE_DIFFS = (0, 3, 4, 7, 8, 11, 12, 15, 16, 19, 20) + tuple(
    d for c in v1.TILE_CPL for d in (32 * c - 13, 32 * c - 12)) + (2000,)
# the cases: 0, each edge's two sides, 2000
EDGE_CASES = ("0",) + tuple(f"{a}/{b}" for a, b in zip(EDGE_DIFFS[1:-1:2],
                                                        EDGE_DIFFS[2:-1:2])) \
    + ("2000",)
# (t_len, p_len) of empty, single-base and two-base pairs
SHORT_PAIRS = ((0, 0), (0, 1), (0, 2), (0, 40), (1, 0), (2, 0), (40, 0),
               (1, 1), (1, 2), (2, 1), (2, 2), (1, 30), (30, 1), (2, 30),
               (30, 2), (0, 600), (600, 0))


def _pairs(rng, shapes):
    """Related text/read windows of the given (t_len, p_len): the read is
    the text, shifted by up to 3 bases, with a 1-4 base deletion and a
    1-4 base insertion, or random; 8% substitutions and N bases; pad
    values random."""
    shapes = list(shapes)
    lt = max(max(t for t, _ in shapes), 1)
    lp = max(max(p for _, p in shapes), 1)
    n = len(shapes)
    tc = rng.integers(0, 5, (n, lt)).astype(np.int8)
    pc = rng.integers(0, 5, (n, lp)).astype(np.int8)
    for k in range(0, n, 2):
        src = list(tc[k, int(rng.integers(0, 4)):])
        for _ in range(2):
            at, run = int(rng.integers(0, max(len(src), 1))), \
                int(rng.integers(1, 5))
            if _:
                src[at:at] = list(rng.integers(0, 4, run))
            else:
                del src[at:at + run]
        m = min(len(src), lp)
        pc[k, :m] = src[:m]
    mut = rng.random((n, lp)) < 0.08
    pc[mut] = rng.integers(0, 5, int(mut.sum()))
    tl = np.array([t for t, _ in shapes], np.int32)
    pl = np.array([p for _, p in shapes], np.int32)
    return tc, tl, pc, pl


def _edge_batch(case, seed=31):
    """Pairs at the |diff|s of one EDGE_CASES entry (text longer and read
    longer, reads of 1, 24 and 37 bases), or the SHORT_PAIRS."""
    rng = np.random.default_rng(seed)
    if case == "short":
        return _pairs(rng, SHORT_PAIRS)
    shapes = []
    for d in map(int, case.split("/")):
        shapes += [(b + d, b) for b in (1, 24, 37)] + [(b, b + d)
                                                       for b in (1, 24)]
    return _pairs(rng, shapes)


@pytest.mark.parametrize("case", EDGE_CASES + ("short",))
def test_plain_matches_jax_program_at_path_edges(case):
    """The plain version equals the JAX program at each kernel path's
    slot edges, deep in the ring path and on empty and short pairs."""
    from t1k_tpu.ops.align import banded_scores

    tc, tl, pc, pl = _edge_batch(case)
    got = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    assert (got == np.asarray(banded_scores(tc, tl, pc, pl))).all()


def test_slot_rule_at_path_edges():
    """v1_slots mirrors csrc/align_full.cu pair_slots; v1_plan splits a
    batch by it; ring_cells sizes the ring kernel's ring."""
    d = np.array(EDGE_DIFFS)
    assert (v1.v1_slots(30 + d, 30) == 13 + d).all()
    assert (v1.v1_slots(30, 30 + d) == 13 + d).all()
    short = np.array(SHORT_PAIRS)
    want = np.where((short == 0).any(1), 13,
                    13 + np.abs(short[:, 0] - short[:, 1]))
    assert (v1.v1_slots(short[:, 0], short[:, 1]) == want).all()
    for diff in EDGE_DIFFS:
        path = 0 if diff <= 19 else (1 if diff <= 499 else 2)
        plan = v1.v1_plan([50 + diff, 50], [50, 50 + diff])
        assert plan[path] == 2, diff
    # the thread path's slot counts and the tile path's slots per lane
    # hold exactly the pairs up to their edge
    edges = [13 + x for x in EDGE_DIFFS[1:-2:2]]
    assert edges == list(v1.THREAD_NS) + [32 * c for c in v1.TILE_CPL]
    plan = v1.v1_plan([30 + d for d in EDGE_DIFFS] + [0, 600],
                      [30] * len(EDGE_DIFFS) + [600, 0])
    assert plan == v1.V1Plan(12, 20, 2)
    assert v1.ring_cells(500) == 512 and v1.ring_cells(2000) == 2048
    with pytest.raises(ValueError, match="ring"):
        v1.ring_cells(8181)


def _kernel_mirror(t, tl, p, pl, lanes, per):
    """Scalar mirror of csrc/align_full.cu's thread path (lanes = 1, per =
    NS) and tile path (lanes = 32, per = CPL) for one pair: the same
    slots and values (m + j and e + j; row 0 up to the slot right of the
    band, m right of the band reset to NEG_INF each row, slot 0 left of
    the band dropped from the deletion chain, every other off-band cell
    only ever losing a max to an in-band one), text slide, column-0 slot,
    vertical move across lanes, lane totals, exclusive scan over the
    lanes and fix-up pass."""
    neg, go, ge = v1.NEG_INF, v1.GO, v1.GE
    if tl == 0 or pl == 0:
        return 0
    if tl == 1 and pl == 1:
        eq = t[0] == p[0] or t[0] == 4 or p[0] == 4
        return v1.SCORE_MATCH if eq else v1.SCORE_MISMATCH
    ns = lanes * per
    diff = tl - pl
    left, right = 5 + max(-diff, 0), 5 + max(diff, 0)
    band_hi = left + right + 1
    assert ns >= v1.v1_slots(tl, pl)

    def code(j):
        return int(t[j - 1]) if 1 <= j <= tl else 0

    a, b = [neg] * ns, [neg] * ns  # m + j, e + j
    for s in range(ns):
        j0 = s - 1 - left
        if j0 == 0:
            a[s] = b[s] = 0
        elif 1 <= j0 <= tl and s <= band_hi + 1:
            a[s], b[s] = go + j0 * go + j0, go + (pl + 1) * go + j0
    codes = [code(s - left) for s in range(ns)]
    j_top = ns - 2 - left
    for i in range(1, pl + 1):
        pb = int(p[i - 1])
        k_col0 = i <= left + 1
        js0 = i - left - 1
        c0, m0_i = -js0, go + i * go
        x = [max(b[s] - 1, a[s] - 5) for s in range(ns)]
        h, ec, tot = [0] * ns, [0] * ns, []
        for lane in range(lanes):
            s0 = lane * per
            t_lane = neg
            for c in range(per):
                s = s0 + c
                col0 = k_col0 and c == c0 - s0
                sub1 = 3 if (codes[s] == pb or codes[s] == 4
                             or pb == 4) else -1
                ec[s] = x[s + 1] if s + 1 < ns else neg
                h[s] = max(a[s] + sub1, ec[s])
                if col0:
                    ec[s], h[s] = go + i * ge, m0_i - go
                if not k_col0 and s == 0:  # left of the band
                    h[s] = neg
                t_lane = max(t_lane, h[s])
            tot.append(t_lane)
        for lane in range(lanes):
            run = max([neg] + tot[:lane])  # exclusive scan over the lanes
            s0 = lane * per
            hi_l = band_hi - s0  # the lane's last slot in the band
            for c in range(per):
                s = s0 + c
                col0 = k_col0 and c == c0 - s0
                mc = m0_i if col0 else max(h[s], run - 4)
                run = max(run, h[s])
                a[s] = mc if c <= hi_l else neg
                b[s] = ec[s]
        codes = codes[1:] + [code(j_top + i + 1)]
    return a[diff + left + 1] - tl


@pytest.mark.parametrize("case", EDGE_CASES[:-1]
                         + ("short", "golden", "seeded"))
def test_kernel_mirror_matches_plain(case):
    """The thread and tile paths' slot loops, run as scalar Python on each
    pair at the smallest slot count of its path that fits and at the
    widest (a warp holding a wider pair), equal the plain version: the
    path edges, short pairs, 100 golden cases and the first 40 of the
    card test's seeded pairs."""
    if case == "golden":
        tc, tl, pc, pl = (x[:100] for x in _golden_batch()[:4])
    elif case == "seeded":
        tc, tl, pc, pl = (x[:40] for x in _seeded_pairs(
            3, 2000, lt=600, lp=150, max_diff=500))
    else:
        tc, tl, pc, pl = _edge_batch(case)
    want = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    slots = v1.v1_slots(tl, pl)
    for k in range(len(tl)):
        if slots[k] > v1.TILE_SLOTS:
            continue  # the ring path
        if slots[k] <= v1.THREAD_SLOTS:
            configs = [(1, min(c for c in v1.THREAD_NS if c >= slots[k])),
                       (1, v1.THREAD_SLOTS)]
        else:
            configs = [(32, min(c for c in v1.TILE_CPL
                                if 32 * c >= slots[k])),
                       (32, v1.TILE_CPL[-1])]
        for lanes, per in configs:
            got = _kernel_mirror(tc[k], int(tl[k]), pc[k], int(pl[k]),
                                 lanes, per)
            assert got == want[k], (case, k, lanes, per)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    """Every path against the plain version: the golden table, seeded
    batches, one launch mixing pairs of every path and class (the edge
    batches, the short pairs), and the ring kernel alone on them."""
    tc, tl, pc, pl, want = _golden_batch()
    assert (v1.banded_scores_full(tc, tl, pc, pl, device=cuda_device)
            == want).all()
    for seed in (3, 4):
        tc, tl, pc, pl = _seeded_pairs(seed, 2000, lt=600, lp=150,
                                       max_diff=500)
        assert (v1.banded_scores_full(tc, tl, pc, pl, device=cuda_device)
                == v1.banded_scores(tc, tl, pc, pl, device="cpu")).all()
    rng = np.random.default_rng(41)
    shapes = list(SHORT_PAIRS)
    for d in EDGE_DIFFS + (700,):
        for b in (1, 24, 37, 150):
            shapes += [(b + d, b), (b, b + d)]
    shapes = [shapes[k] for k in rng.permutation(len(shapes))]
    tc, tl, pc, pl = _pairs(rng, shapes)
    plan = v1.v1_plan(tl, pl)
    assert min(plan) > 0
    n0 = dict(v1.launch_counts)
    got = v1.banded_scores_full(tc, tl, pc, pl, device=cuda_device)
    for path in v1.PATHS:
        assert v1.launch_counts[path] == n0[path] + 1, path
    plain = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    assert (got == plain).all()
    args = v1._as_tensors(tc, tl, pc, pl, cuda_device)
    n0, alone = dict(v1.launch_counts), v1.ring_alone_launches[
        "align_full_ring_alone"]
    ring = v1.banded_scores_ring_cuda(*args, int(np.abs(tl - pl).max()))
    assert (ring.cpu().numpy() == plain).all()
    assert v1.launch_counts == n0
    assert v1.ring_alone_launches["align_full_ring_alone"] == alone + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES + ("short",))
def test_cuda_paths_follow_slot_rule(cuda_device, case):
    """At each slot edge the card's counting sort puts the pairs on the
    paths that the slot rule's mirror (v1_plan) names, the ring path
    launches only with pairs, and every score matches the plain
    version's."""
    tc, tl, pc, pl = _edge_batch(case)
    plan = v1.v1_plan(tl, pl)
    n0, p0 = dict(v1.launch_counts), dict(v1.path_pairs)
    got = v1.banded_scores_full(tc, tl, pc, pl, device=cuda_device)
    for k, path in enumerate(v1.PATHS):
        assert v1.path_pairs[path] == p0[path] + plan[k], path
        assert v1.launch_counts[path] == n0[path] + (
            1 if path != "align_full_ring" else int(plan[k] > 0)), path
    assert (got == v1.banded_scores(tc, tl, pc, pl, device="cpu")).all()


@pytest.mark.cuda
def test_cuda_band_past_the_ring_raises(cuda_device):
    """|t_len - p_len| past 8,180 does not fit the ring: the numpy entry
    raises before the launch, the tensor entry on the card's count."""
    tc, tl, pc, pl = _pairs(np.random.default_rng(5), [(8211, 30), (40, 30)])
    with pytest.raises(ValueError, match="ring"):
        v1.banded_scores_full(tc, tl, pc, pl, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        v1.banded_scores_cuda(*v1._as_tensors(tc, tl, pc, pl, cuda_device))
