"""The port's band aligner (t1k_tpu_torch/ops/align_band.py) against the
JAX package's Pallas kernel in interpret mode and the native walk (the
engine's deferred route through it: test_torch_band_engine.py).

Integer kernels: every comparison is exact.  The plain PyTorch version
runs here on the CPU; the CUDA kernel is compared with it on a card by
the tests marked `cuda` (and by chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu.constants import encode_seq
from t1k_tpu.native import align_global
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
    """The 400 scored cases of golden/align_global.tsv as padded windows
    (the batch of test_device_ops)."""
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


def _stats_cases(seed=19, n=256):
    """The seeded boundary-quirk shapes of test_device_ops's stats test."""
    rng = np.random.default_rng(seed)
    t_list, p_list = [], []
    for it in range(n):
        lenp = int(rng.integers(1, 90))
        if it % 3 == 0:
            lent = max(1, lenp + int(rng.integers(-5, 6)))
            t = rng.integers(0, 5, lent)
        elif it % 3 == 1:
            lent = int(rng.integers(1, 25))
            lenp = max(1, lent + int(rng.integers(-8, 9)))
            t = rng.integers(0, 5, lent)
        else:  # mutated copy
            lent = max(1, lenp + int(rng.integers(-3, 4)))
            p0 = rng.integers(0, 4, max(lent, lenp))
            t = p0[:lent].copy()
            for _ in range(int(rng.integers(0, 6))):
                t[int(rng.integers(0, lent))] = int(rng.integers(0, 5))
            p_list.append(p0[:lenp])
            t_list.append(t)
            continue
        p_list.append(rng.integers(0, 5, lenp))
        t_list.append(t)
    B = len(t_list)
    tc = np.zeros((B, max(len(t) for t in t_list)), np.int8)
    pc = np.zeros((B, max(len(p) for p in p_list)), np.int8)
    tl = np.array([len(t) for t in t_list], np.int32)
    pl = np.array([len(p) for p in p_list], np.int32)
    for i, (t, p) in enumerate(zip(t_list, p_list)):
        tc[i, :len(t)] = t
        pc[i, :len(p)] = p
    ml = 5 + max(0, int((pl - tl).max()))
    tl = np.minimum(tl, pl + (32 - 1 - 5 - ml))  # keep the band in W=32
    return tc, tl, pc, pl


def _walk_counts(t, p):
    score, ops = align_global(t, p)
    return score, (int((ops == 0).sum()), int((ops == 1).sum()),
                   int(((ops == 2) | (ops == 3)).sum()))


def test_plain_scores_match_pallas_and_golden_table():
    from t1k_tpu.ops.align_pallas_band import banded_scores_band

    tc, tl, pc, pl, want = _golden_batch()
    got = ab.banded_scores_band(tc, tl, pc, pl, device="cpu")
    assert got.dtype == np.int32
    assert (got == want).all()
    jax_got = np.asarray(banded_scores_band(tc[:64], tl[:64], pc[:64],
                                            pl[:64], G=1, interpret=True))
    assert (ab.banded_scores_band(tc[:64], tl[:64], pc[:64], pl[:64],
                                  device="cpu") == jax_got).all()


def test_plain_stats_match_pallas_and_native_walk():
    from t1k_tpu.ops.align_pallas_band import banded_stats_band

    tc, tl, pc, pl = _stats_cases()
    got = ab.banded_stats_band(tc, tl, pc, pl, device="cpu")
    jax_got = banded_stats_band(tc, tl, pc, pl, interpret=True)
    for g, j in zip(got, jax_got):
        assert (g == np.asarray(j)).all()
    for i in range(len(tl)):
        score, counts = _walk_counts(tc[i, :tl[i]], pc[i, :pl[i]])
        assert int(got[0][i]) == score, i
        assert (int(got[1][i]), int(got[2][i]), int(got[3][i])) == counts, i


@pytest.mark.parametrize("diff", [0, 25])
def test_window_adapts_to_length_difference(diff):
    """The band_window cases of test_device_ops: narrow (W=16) and wide
    (diff 25 -> W=40) batches match the native walk, and the kernel's
    wider window (32 * cells-per-lane) gives the same results."""
    assert ab.band_window(5, 0) == 16
    assert ab.band_window(5, 12) == 24
    assert ab.band_window(15, 10) == 32
    assert ab.band_window(5, 25) == 40
    assert [ab.kernel_window(w) for w in (16, 32, 40, 96, 256)] == \
        [32, 32, 64, 128, 256]
    rng = np.random.default_rng(23)
    B, lenp = 32, 60
    lent = lenp + diff
    tc = rng.integers(0, 4, (B, lent)).astype(np.int8)
    pc = tc[:, :lenp].copy()
    mut = rng.random((B, lenp)) < 0.05
    pc[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.int8)
    tl = np.full(B, lent, np.int32)
    pl = np.full(B, lenp, np.int32)
    got = ab.banded_scores_band(tc, tl, pc, pl, device="cpu")
    want = np.array([align_global(tc[i], pc[i])[0] for i in range(B)])
    assert (got == want).all()
    w = ab.band_window(5, diff)
    narrow = ab.banded_stats_band(tc, tl, pc, pl, w=w, device="cpu")
    wide = ab.banded_stats_band(tc, tl, pc, pl, w=ab.kernel_window(w),
                                device="cpu")
    for a, b in zip(narrow, wide):
        assert (a == b).all()


def test_511_op_walk_boundary():
    """254 + 254 + 2 = 510 ops is the largest legal walk (exact counts);
    255 + 255 would overflow the 9-bit fields and is refused."""
    rng = np.random.default_rng(3)
    L = 254
    t = rng.integers(0, 4, size=(4, L)).astype(np.int8)
    p = t.copy()
    for i in range(4):
        for q in range(i + 1, L, 17):
            p[i, q] = (p[i, q] + 1) % 4
    full = np.full(4, L, np.int32)
    scores, match, mis, ind = ab.banded_stats_band(t, full, p, full,
                                                   device="cpu")
    for i in range(4):
        score, counts = _walk_counts(t[i], p[i])
        assert scores[i] == score
        assert (match[i], mis[i], ind[i]) == counts
        assert int(match[i] + mis[i] + ind[i]) <= 510
    big = np.zeros((1, 255), np.int8)
    with pytest.raises(ValueError, match="511"):
        ab.banded_stats_band(big, np.array([255], np.int32), big,
                             np.array([255], np.int32), device="cpu")


def _desc_items(rng, n_reads=24, read_len=100, n_items=300):
    """A reference, a read batch and deferred items into both, some
    through the reverse-complement half (rc=True)."""
    ref = rng.integers(0, 5, 20_000).astype(np.int8)
    reads = rng.integers(0, 5, n_reads * read_len).astype(np.int8)
    starts = np.arange(n_reads, dtype=np.int64) * read_len
    lens = np.full(n_reads, read_len, np.int32)
    t_len = rng.integers(0, 60, n_items)
    p_len = np.clip(t_len + rng.integers(-10, 11, n_items), 0, 60)
    t_off = rng.integers(0, ref.size - 64, n_items)
    read = rng.integers(0, n_reads, n_items)
    within = rng.integers(0, read_len - 60, n_items)
    rc = rng.random(n_items) < 0.5
    return ref, reads, starts, lens, (t_off, t_len, read, within, p_len, rc)


def _service_stats(svc, ref, reads, starts, lens, items):
    t_off, t_len, read, within, p_len, rc = items
    svc.set_ref(ref)
    svc.set_layout(starts, lens)
    base = svc.begin_batch(reads)
    p_off = np.where(rc, base, 0) + starts[read] + within
    return svc.stats(t_off.astype(np.int64), t_len.astype(np.int32),
                     p_off.astype(np.int64), p_len.astype(np.int32))


def test_desc_service_matches_pallas_service():
    from t1k_tpu.ops.align_pallas_band import DeferredDescService as JaxSvc

    rng = np.random.default_rng(41)
    ref, reads, starts, lens, items = _desc_items(rng)
    svc = ab.DeferredDescService(device="cpu")
    got = _service_stats(svc, ref, reads, starts, lens, items)
    want = _service_stats(JaxSvc(interpret=True), ref, reads, starts, lens,
                          items)
    assert got.dtype == np.int32
    assert (got == want).all()
    assert items[5].any() and (~items[5]).any()
    assert svc.items_scored == len(items[0])
    assert got.max() > 10  # real alignments, not only empty items


def test_desc_service_rejects_out_of_range_items():
    rng = np.random.default_rng(5)
    ref, reads, starts, lens, _ = _desc_items(rng)
    svc = ab.DeferredDescService(device="cpu")
    svc.set_ref(ref)
    svc.set_layout(starts, lens)
    svc.begin_batch(reads)
    one = np.ones(1, np.int32)
    with pytest.raises(ValueError, match="reference"):
        svc.stats(np.array([ref.size], np.int64), one, np.zeros(1, np.int64),
                  one)
    with pytest.raises(ValueError, match="above 10"):
        svc.stats(np.zeros(1, np.int64), 12 * one, np.zeros(1, np.int64), one)


# (t_len - p_len, p_len) shapes at the engine's caps (|diff| <= 10,
# lengths <= 254): the column-0 cell at the window's left edge (diff -10),
# single-base and empty texts, one to eight rows of a warp's width
EDGE_SHAPES = [(d, p) for d in (-10, -1, 0, 1, 10) for p in (1, 16, 33, 244)
               if p + d >= 0]
MIRROR_SHAPES = [(d, p) for d in range(-10, 11)
                 for p in (1, 2, 15, 16, 17, 31, 32, 33, 60, 96, 254)
                 if 0 <= p + d <= 254]


def _shape_items(rng, shapes, copies=3):
    """`copies` deferred items of each (diff, p_len) shape: text windows of
    a random reference with 3% N, patterns that are mutated copies, every
    other one stored reverse-complemented and addressed through the rc
    half.  Returns the _service_stats inputs, one read per item."""
    ref = rng.integers(0, 4, 40_000).astype(np.int8)
    ref[rng.random(ref.size) < 0.03] = 4
    t_len, p_len = (np.array([x for x in v for _ in range(copies)], np.int64)
                    for v in zip(*[(p + d, p) for d, p in shapes]))
    n = len(p_len)
    t_off = rng.integers(0, ref.size - 300, n)
    rc = np.arange(n) % 2 == 1
    pats = []
    for i in range(n):
        pat = ref[t_off[i]:t_off[i] + p_len[i]].copy()
        mut = rng.random(p_len[i]) < 0.08
        pat[mut] = rng.integers(0, 5, int(mut.sum()))
        pats.append(np.where(pat < 4, 3 - pat, pat)[::-1] if rc[i] else pat)
    lens = p_len.astype(np.int32)
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    reads = np.concatenate(pats).astype(np.int8)
    return ref, reads, starts, lens, (t_off, t_len, np.arange(n),
                                      np.zeros(n, np.int64), p_len, rc)


@pytest.mark.parametrize("diff,p_len", EDGE_SHAPES)
def test_desc_service_edge_shapes(diff, p_len):
    """Items at the band's edges through the descriptor service: the port
    on the CPU equals the Pallas service in interpret mode and the native
    walk's match counts."""
    from t1k_tpu.ops.align_pallas_band import DeferredDescService as JaxSvc

    rng = np.random.default_rng(1000 + 300 * (diff + 10) + p_len)
    ref, reads, starts, lens, items = _shape_items(rng, [(diff, p_len)], 6)
    got = _service_stats(ab.DeferredDescService("cpu"), ref, reads, starts,
                         lens, items)
    want = _service_stats(JaxSvc(interpret=True), ref, reads, starts, lens,
                          items)
    assert (got == want).all()
    t_off, t_len, _, _, p_len_, rc = items
    for i in range(len(t_len)):
        pat = reads[starts[i]:starts[i] + lens[i]]
        if rc[i]:
            pat = np.where(pat < 4, 3 - pat, pat)[::-1]
        t = ref[t_off[i]:t_off[i] + t_len[i]]
        if t_len[i] == 0:
            assert got[i] == 0
        else:
            assert got[i] == _walk_counts(t, pat)[1][0], i


# csrc/band_stats.cu's slot counts: the narrow kernel's, then the wide
# kernel's two.
THREAD_SLOTS = (13, 24, 32)


def _thread_slots(t_len, p_len, ml, kw=32):
    """Register slots one item needs in a window of kw cells (band_stats.cu
    window_slots): the window cells from the column-0 cell left of the
    band to the row-0 cell right of it."""
    diff = t_len - p_len
    base = max(ml - 5 - max(-diff, 0) - 1, 0)
    return max(min(ml + 5 + max(diff, 0) + 1, kw - 1) - base + 1, 1)


def _lane_scan(vals, op):
    """Inclusive scan over a group's lanes in log2 G steps, as the kernel's
    __shfl_up_sync steps of width G: lane g takes lane g - d's value for
    d = 1, 2, 4, ..."""
    vals = list(vals)
    d = 1
    while d < len(vals):
        vals = [op(v, vals[g - d]) if g >= d else v
                for g, v in enumerate(vals)]
        d *= 2
    return vals


def _thread_item(ref, reads, item, ml, ns, stats=True, kw=32, lanes=1):
    """Scalar mirror of csrc/band_stats.cu's band_item (lanes = 1) and
    group_item (a group of `lanes` lanes, each holding ns / lanes slots)
    for one item (t_off, t_len, p_off, p_len), slot for slot in a window
    of kw cells: the same register slots, running max, copy scan and
    boundary cases, the narrow kernel's and the group kernel's rows
    without column 0, and in a group the lane totals of u and the lanes'
    last open cells carried lane to lane by log2 G step scans, the
    payload taken from the lane holding the key.  Returns (score, packed
    counts)."""
    neg, go, ge, m32 = ab.NEG_INF, ab.GO, ab.GE, 0xFFFFFFFF
    cpl = ns // lanes
    t_off, tl, p_off, pl = (int(x) for x in item)
    diff = tl - pl
    left, right = 5 + max(-diff, 0), 5 + max(diff, 0)
    base = max(ml - left - 1, 0)
    band_lo, band_hi = ml - left - base, min(ml + right, kw - 1) - base
    m, e, pm, pe = ([0] * ns for _ in range(4))
    for s in range(ns):
        j0 = base + s - ml
        inside = 1 <= j0 <= tl
        m[s] = 0 if j0 == 0 else (go + j0 * go if inside else neg)
        e[s] = 0 if j0 == 0 else (go + (pl + 1) * go if inside else neg)
        if s >= kw - base:  # outside the window
            m[s] = e[s] = neg
        pm[s] = 0 if j0 == 0 else (j0 * ab.IU + (
            0 if j0 * ge >= (pl + 1) * go else ab.IU)) & m32
        pe[s] = 0 if j0 == 0 else ((j0 + 1) * ab.IU) & m32
    split = lanes > 1 or ns == 13
    col0_rows = min(pl, ml - base) if split else pl
    for i in range(1, pl + 1):
        k_col0 = i <= col0_rows
        js0 = base - ml + i  # text column of slot 0
        pb = int(reads[p_off + i - 1])
        match = [pb == 4 or (1 <= js0 + s <= tl
                             and int(ref[t_off + js0 + s - 1]) in (pb, 4))
                 for s in range(ns)]
        c0, m0_i, start_le1 = -js0, go + i * go, left >= i - 1
        lo = max(band_lo, 1 - js0, 0)
        hi = min(band_hi, tl - js0, ns - 1)
        col0 = [k_col0 and s == c0 for s in range(ns)]
        j_pos = [not k_col0 or js0 + s >= 1 for s in range(ns)]
        inband = [lo <= s <= hi for s in range(ns)]
        # the slots' own terms: vertical move, h and u
        ec, h, u = [0] * ns, [0] * ns, [0] * ns
        for s in range(ns):
            up = s + 1 < ns
            ec[s] = max(e[s + 1] + ge, m[s + 1] + go + ge) if up else neg
            if col0[s]:
                ec[s] = go + i * ge
            sub = ab.SCORE_MATCH if match[s] else ab.SCORE_MISMATCH
            h[s] = m0_i if col0[s] else max(m[s] + sub, ec[s])
            if not (inband[s] or (col0[s] and start_le1)):
                h[s] = neg
            u[s] = ((m0_i - go if start_le1 else neg) if col0[s]
                    else h[s] - ge * (js0 + s))
        # the max of u left of each lane: its lanes' totals, scanned
        tot = _lane_scan([max([neg] + u[g * cpl:(g + 1) * cpl])
                          for g in range(lanes)], max)
        f, mc = [0] * ns, [0] * ns
        pe_new, diag_p, nof, diag_ok = [0] * ns, [0] * ns, [0] * ns, [0] * ns
        for g in range(lanes):
            run = tot[g - 1] if g else neg
            for s in range(g * cpl, (g + 1) * cpl):
                f[s] = go + ge * (js0 + s) + run
                run = max(run, u[s])
                ibc = inband[s] or col0[s]
                mc[s] = m0_i if col0[s] else (max(h[s], f[s]) if ibc
                                              else neg)
                ec[s] = ec[s] if ibc else neg
                if stats:
                    up = s + 1 < ns
                    m_up = m[s + 1] if up else neg
                    open_e = m_up + go + ge == ec[s]
                    pe_new[s] = (ab.IU + ((pm[s + 1] if open_e else pe[s + 1])
                                          if up else 0)) & m32
                    sub = ab.SCORE_MATCH if match[s] else ab.SCORE_MISMATCH
                    diag_ok[s] = m[s] + sub == mc[s] and j_pos[s]
                    diag_p[s] = (pm[s] + (ab.MU if match[s] else ab.XU)) & m32
                    nof[s] = diag_p[s] if diag_ok[s] else pe_new[s]
        if stats:
            # the open cells and their payloads, each lane's last one
            opened, pay = [False] * ns, [0] * ns
            agg = []
            for g in range(lanes):
                lk, lp = -1024, 0
                for s in range(g * cpl, (g + 1) * cpl):
                    m_left = mc[s - 1] if s else neg
                    opened[s] = col0[s] or (m_left + go + ge == f[s]
                                            and j_pos[s])
                    pay[s] = i * ab.IU if col0[s] else (nof[s - 1] if s else 0)
                    if opened[s]:
                        lk, lp = base + s, pay[s]
                agg.append((lk, lp))
            keys = _lane_scan([k for k, _ in agg], max)
            for g in range(lanes):
                last_w = keys[g - 1] if g else -1024
                last_p = agg[(last_w - base) // cpl][1] if last_w >= 0 else 0
                for s in range(g * cpl, (g + 1) * cpl):
                    if opened[s]:
                        last_w, last_p = base + s, pay[s]
                    pf = (last_p + (base + s - last_w + 1) * ab.IU) & m32
                    v = diag_p[s] if diag_ok[s] else (
                        pf if f[s] >= ec[s] else pe_new[s])
                    pm[s], pe[s] = (i * ab.IU if col0[s] else v), pe_new[s]
        m, e = mc, ec
    fs = ml + diff - base
    score, statv = neg, 0
    if 0 <= ml + diff < kw and fs < ns:
        score, statv = m[fs], pm[fs]
    packed = max(statv - (1 << 32) if statv >= 1 << 31 else statv, 0)
    if tl == 1 and pl == 1:
        eq = int(ref[t_off]) in (int(reads[p_off]), 4) or reads[p_off] == 4
        score, packed = (2, ab.MU) if eq else (-2, ab.XU)
    if tl == 0 or pl == 0:
        score = packed = 0
    return score, packed if stats else 0


def _desc_batch(rng, shapes, ml, kw, copies=1):
    """(ref, reads, desc, ML, kW) tensors of _shape_items's items, the
    patterns addressed through a doubled read tensor (rc half)."""
    ref, reads, starts, lens, items = _shape_items(rng, shapes, copies)
    t_off, t_len, _, _, p_len, rc = items
    base = reads.size + ab.SEQ_PAD
    rc_half = np.concatenate([reads, np.zeros(ab.SEQ_PAD, np.int8)])
    # the rc half holds the reverse complement of each read in place
    for i in range(len(lens)):
        r = reads[starts[i]:starts[i] + lens[i]]
        rc_half[starts[i]:starts[i] + lens[i]] = np.where(
            r < 4, 3 - r, r)[::-1]
    flat = np.concatenate([reads, np.zeros(ab.SEQ_PAD, np.int8), rc_half])
    desc = np.stack([t_off, t_len, np.where(rc, base, 0) + starts, p_len])
    return (torch.from_numpy(np.concatenate(
        [ref, np.zeros(ab.SEQ_PAD, np.int8)])), torch.from_numpy(flat),
        torch.from_numpy(desc.astype(np.int64)), ml, kw)


def _mirror_batches():
    """(name, ref, reads, desc, ML, W) batches for the mirror:
    every MIRROR_SHAPES item at the descriptor route's (15, 32), and the
    byte-window batches of the stats cases and the golden table at their
    own (ML, W)."""
    out = [("edges", *_desc_batch(np.random.default_rng(77), MIRROR_SHAPES,
                                  ab.DESC_ML, ab.DESC_W))]
    for name, (tc, tl, pc, pl) in (("stats_cases", _stats_cases()),
                                   ("golden", _golden_batch()[:4])):
        ml, over = ab._window_class(tl, pl)
        out.append((name, *ab._pack_windows(tc, tl, pc, pl, "cpu"), ml,
                    ab.band_window(ml, over)))
    return out


def _wide_shapes(ml, kw, diffs, p_lens=(1, 2, 16, 33, 95, 160, 254)):
    """(t_len - p_len, p_len) shapes a window of kw cells at ML takes:
    each diff against each p_len where 0 <= t_len and t_len + p_len + 2 <
    512, and t_len = 0 against p_len 1, 2 and ML - 5 where ML covers it."""
    shapes = [(d, p) for d in diffs for p in p_lens
              if 0 <= p + d and 2 * p + d + 2 < 512]
    shapes += [(-p, p) for p in sorted({1, 2, ml - 5}) if 1 <= p <= ml - 5]
    assert all(-d <= ml - 5 and d <= kw - ml - 6 for d, _ in shapes)
    return shapes


# The lane-group kernel's batches (W > 32): name -> (ML, kernel window,
# diffs).  ML = 117 at W = 256 takes diff -112 to +112 (up to 125 slots);
# ML = 5 there diff up to +244 (256 slots, only CPL = 8 holds them).
WIDE_MIRROR = {
    "W64": (30, 64, (-25, -24, -13, -1, 0, 1, 7, 14, 27, 28)),
    "W128": (60, 128, (-55, -54, -30, -1, 0, 1, 20, 45, 61, 62)),
    "W256": (117, 256, (-112, -111, -70, -17, 0, 1, 33, 80, 111, 112)),
    "W256_ML5": (5, 256, (0, 20, 125, 200, 243, 244)),
}


def _wide_batch(name):
    ml, kw, diffs = WIDE_MIRROR[name]
    return (name, *_desc_batch(np.random.default_rng(sum(map(ord, name))),
                               _wide_shapes(ml, kw, diffs), ml, kw))


def _pallas_band_stats(ref, reads, desc, ml, w):
    """The JAX package's _band_stats_call (interpret mode, one block of
    128 lanes) on the items of `desc`, packed as _band_grid packs them,
    with its single-base and empty fix-ups.  Returns int32 [2, n]."""
    import jax.numpy as jnp
    from t1k_tpu.ops.align_pallas_band import (LANES, _band_stats_call,
                                               _round_up)

    r, q, d = ref.numpy(), reads.numpy(), desc.numpy()
    n = d.shape[1]
    assert n <= LANES
    t_off, tl, p_off, pl = d
    Lt, Lp = int(tl.max()), int(pl.max())
    lead = ml + 1
    Lt_pad = _round_up(max(Lt + lead, Lp + w + 1) + 1, 8)
    Lp_pad = _round_up(max(Lp, 8), 8)
    tb = np.zeros((LANES, Lt_pad), np.int32)
    pb = np.zeros((LANES, Lp_pad), np.int32)
    for k in range(n):
        tb[k, lead:lead + tl[k]] = r[t_off[k]:t_off[k] + tl[k]]
        pb[k, :pl[k]] = q[p_off[k]:p_off[k] + pl[k]]
    lens = [np.zeros((1, 1, LANES), np.int32) for _ in range(2)]
    lens[0][0, 0, :n], lens[1][0, 0, :n] = tl, pl
    score, packed = (np.asarray(x)[0, :n] for x in _band_stats_call(
        jnp.asarray(lens[0]), jnp.asarray(lens[1]), jnp.asarray(tb.T[None]),
        jnp.asarray(pb.T[None]), G=1, ML=ml, Lp=Lp, interpret=True, W=w))
    t0 = r[t_off].astype(np.int32)
    p0 = q[p_off].astype(np.int32)
    eq = (t0 == p0) | (t0 == 4) | (p0 == 4)
    single = (tl == 1) & (pl == 1)
    score = np.where(single, np.where(eq, ab.SCORE_MATCH, ab.SCORE_MISMATCH),
                     score)
    packed = np.where(single, np.where(eq, ab.MU, ab.XU), packed)
    empty = (tl == 0) | (pl == 0)
    return np.stack([np.where(empty, 0, score), np.where(empty, 0, packed)])


# (stats, window, CPL) of the mirror: the thread kernels at W = 32 (CPL
# None, under their first ids), the lane-group kernel at each CPL the
# dispatch can take for each batch (32 * CPL at least its widest item),
# W = 32 included (the group kernel forced there)
MIRROR_CASES = [(True, "W32", None), (False, "W32", None)] + [
    (True, "W32", c) for c in (1, 2, 4, 8)] + [
    (True, "W64", c) for c in (2, 4, 8)] + [
    (True, "W128", c) for c in (4, 8)] + [
    (True, "W256", c) for c in (4, 8)] + [
    (True, "W256_ML5", 8), (False, "W64", 2), (False, "W256", 4)]


@pytest.mark.parametrize(
    "stats,window,cpl", MIRROR_CASES,
    ids=[str(st) if c is None else f"{st}-{w}-cpl{c}"
         for st, w, c in MIRROR_CASES])
def test_thread_kernel_mirror_matches_plain(stats, window, cpl):
    """The kernels' slot loop, run as scalar Python on each item, equals
    the plain version.  Thread kernels (CPL None): the edge shapes (every
    diff in [-10, 10] against p_len 1-254, t_len 0 included), the stats
    cases and the golden table, with the smallest slot count each item
    fits (a warp of such items) and with 32 slots (a warp holding a wider
    item).  Lane-group kernel: each item on its group of G lanes of CPL
    slots (the G the dispatch takes for it), at W = 32 on those batches
    and at W = 64, 128 and 256 on items with diff from -112 to +244, p_len
    1-254 and t_len 0, there also equal to the JAX package's
    _band_stats_call in interpret mode."""
    batches = (_mirror_batches() if window == "W32"
               else [_wide_batch(window)])
    for name, ref, reads, desc, ml, w in batches:
        kw = ab.kernel_window(w)
        want = ab.band_stats_plain(ref, reads, desc, ml, w, stats).numpy()
        if window != "W32":
            pallas = _pallas_band_stats(ref, reads, desc, ml, w)
            assert (pallas[0] == want[0]).all(), name
            if stats:
                assert (pallas[1] == want[1]).all(), name
        r, q, d = ref.numpy(), reads.numpy(), desc.numpy()
        need = [_thread_slots(int(d[1, k]), int(d[3, k]), ml, kw)
                for k in range(d.shape[1])]
        if cpl is None:
            layouts = [[(min(c for c in THREAD_SLOTS if c >= x), 1)
                        for x in need], [(32, 1)] * len(need)]
        else:
            assert max(need) <= 32 * cpl
            lanes = [int(g) for g in ab.group_lanes(need, cpl)]
            layouts = [[(cpl * g, g) for g in lanes]]
            assert len({g for _, g in layouts[0]}) >= 2, name
        for layout in layouts:
            got = [_thread_item(r, q, d[:, k], ml, ns, stats, kw, g)
                   for k, (ns, g) in enumerate(layout)]
            assert (np.array(got).T == want).all(), (name, layout[0])


@pytest.mark.cuda
def test_cuda_thread_and_warp_kernels_match_plain(cuda_device):
    """On a card: the thread kernel (every window of at most 32 cells)
    and the warp kernel forced at the same window equal the plain version
    on the mirror's batches and the stats cases at W = None, 64, 128 and
    256 (the wider windows take the warp kernel)."""
    for name, ref, reads, desc, ml, w in _mirror_batches():
        args = [x.to(cuda_device) for x in (ref, reads, desc)]
        for stats in (True, False):
            want = ab.band_stats_plain(ref, reads, desc, ml, w, stats)
            n0 = dict(ab.launch_counts)
            got = ab.band_stats(*args, ml, w, stats).cpu()
            warp = ab._band_stats_warp_cuda(*args, ml, w, stats).cpu()
            assert ab.launch_counts["band_stats"] == n0["band_stats"] + 1
            assert ab.launch_counts["band_stats_warp"] == \
                n0["band_stats_warp"] + 1
            assert torch.equal(got, want), (name, stats)
            assert torch.equal(warp, want), (name, stats)
    tc, tl, pc, pl = _stats_cases()
    for w in (None, 64, 128, 256):
        got = ab.banded_stats_band(tc, tl, pc, pl, w=w, device=cuda_device)
        ref = ab.banded_stats_band(tc, tl, pc, pl, w=w, device="cpu")
        for g, r in zip(got, ref):
            assert (g == r).all()


def _wide_windows(rng, w, n=4096):
    """(t_len, p_len) of chip_smoke.py's wide batches: t_len 40-199, p_len
    shorter by 0 to (w - 32) / 2, at least 1."""
    t_len = rng.integers(40, 200, n)
    return t_len, np.clip(t_len - rng.integers(0, (w - 32) // 2 + 1, n), 1,
                          None)


# Batches whose fastest CPL scripts/band_ab.py measured on an H100 (80GB
# HBM3, 700 W), sorted where group_launch sorts: name -> (ML, W, CPL)
GROUP_CPL_CASES = {
    "dryrun_256": (10, 40, 1), "dryrun_512": (10, 40, 1),
    "dryrun_1024": (10, 40, 1), "dryshape_16384": (10, 40, 8),
    "wide_W64": (5, 64, 2), "wide_W128": (5, 128, 2),
    "wide_W256": (5, 256, 4), "wide256_1024": (5, 256, 4),
    "wide256_16384": (5, 256, 8)}


@pytest.mark.parametrize("name", sorted(GROUP_CPL_CASES))
def test_group_launch_takes_the_fastest_measured_cpl(name):
    """group_launch picks, for each batch the rule was fixed on, the CPL
    that was fastest there (route and every CPL in turns on the card),
    every CPL it returns holds the largest item in 32 lanes, and a batch
    of one shape runs unsorted."""
    from t1k_tpu_torch.parallel import dryrun

    ml, w, want = GROUP_CPL_CASES[name]
    kind, n = name.rsplit("_", 1)
    rng = np.random.default_rng(2024)
    if kind.startswith("dry"):
        _, tl, _, pl = dryrun.example_batch(int(n) if kind == "dryshape"
                                            else dryrun.B, dryrun.LT,
                                            dryrun.LP)
        tl, pl = tl[:int(n)], pl[:int(n)]
    else:
        tl, pl = _wide_windows(rng, w if kind == "wide" else 256,
                               4096 if kind == "wide" else int(n))
    kw = ab.kernel_window(w)
    cpl, max_slots, sort = ab.group_launch(tl, pl, ml, kw)
    assert max_slots == ab.window_slots(tl, pl, ml, kw).max()
    assert cpl == want and 32 * cpl >= max_slots
    assert sort == (kind != "dryrun" and kind != "dryshape")


@pytest.mark.cuda
def test_cuda_group_kernel_matches_plain(cuda_device):
    """On a card: the lane-group kernel, the route of every window above
    32 cells, equals the plain version on the mirror's wide batches (W =
    64, 128 and 256, diff -112 to +244) through band_stats, with and
    without the items' lengths, and at every CPL whose 32-lane groups hold
    the batch, sorted and not; forced at W = 32
    on the mirror's batches at every CPL; and
    through banded_stats_band on the dry run's shard slices (1,024, 512
    and 256 pairs of 112 / 100 at ML = 10).  The first design's warp
    kernel equals the plain version on the wide batches.  band_stats
    counts its wide launches as band_stats_group and none as the thread
    kernels' or the warp kernel's."""
    from t1k_tpu_torch.parallel import dryrun

    batches = [_wide_batch(name) for name in WIDE_MIRROR] + _mirror_batches()
    for name, ref, reads, desc, ml, w in batches:
        args = [x.to(cuda_device) for x in (ref, reads, desc)]
        kw = ab.kernel_window(w)
        need = int(ab.window_slots(desc[1].numpy(), desc[3].numpy(), ml,
                                   kw).max())
        for stats in (True, False):
            want = ab.band_stats_plain(ref, reads, desc, ml, w, stats)
            if kw > 32:
                for lengths in (None, (desc[1].numpy(), desc[3].numpy())):
                    n0 = dict(ab.launch_counts)
                    got = ab.band_stats(*args, ml, w, stats, lengths).cpu()
                    assert ab.launch_counts == dict(
                        n0, band_stats_group=n0["band_stats_group"] + 1)
                    assert torch.equal(got, want), (name, stats)
                warp = ab._band_stats_warp_cuda(*args, ml, w, stats).cpu()
                assert torch.equal(warp, want), (name, stats)
            for cpl in ab.GROUP_CPL:
                if 32 * cpl < need:
                    continue
                for sort in (False, True):
                    got = ab._band_stats_group_cuda(
                        *args, ml, w, stats, max_slots=need, cpl=cpl,
                        sort=sort).cpu()
                    assert torch.equal(got, want), (name, stats, cpl, sort)
    tc, tl, pc, pl = dryrun.example_batch(dryrun.B, dryrun.LT, dryrun.LP)
    for n in (1024, 512, 256):
        n0 = ab.launch_counts["band_stats_group"]
        got = ab.banded_stats_band(tc[:n], tl[:n], pc[:n], pl[:n],
                                   ml=dryrun.ML, w=dryrun.W,
                                   device=cuda_device)
        assert ab.launch_counts["band_stats_group"] == n0 + 1
        want = ab.banded_stats_band(tc[:n], tl[:n], pc[:n], pl[:n],
                                    ml=dryrun.ML, w=dryrun.W, device="cpu")
        for g, r in zip(got, want):
            assert (g == r).all(), n


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    """On a card: the kernel equals the plain version on the same CUDA
    tensors, at W = 32 (descriptor service) and the wider windows."""
    tc, tl, pc, pl, want = _golden_batch()
    assert (ab.banded_scores_band(tc, tl, pc, pl, device=cuda_device)
            == want).all()
    tc, tl, pc, pl = _stats_cases()
    for w in (None, 64, 128, 256):
        got = ab.banded_stats_band(tc, tl, pc, pl, w=w, device=cuda_device)
        ref = ab.banded_stats_band(tc, tl, pc, pl, w=w, device="cpu")
        for g, r in zip(got, ref):
            assert (g == r).all()
    rng = np.random.default_rng(41)
    ref, reads, starts, lens, items = _desc_items(rng)
    launches = ab.launch_counts["band_stats"]
    got = _service_stats(ab.DeferredDescService(cuda_device), ref, reads,
                         starts, lens, items)
    assert ab.launch_counts["band_stats"] == launches + 1
    want = _service_stats(ab.DeferredDescService("cpu"), ref, reads, starts,
                          lens, items)
    assert (got == want).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    return torch.device("cuda")
