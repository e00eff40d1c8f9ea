"""The port's band aligner (t1k_tpu_torch/ops/align_band.py) against the
JAX package's Pallas kernel in interpret mode and the native walk.

Integer kernels: every comparison is exact.  The plain PyTorch version
runs here on the CPU; the CUDA kernel is compared with it on a card by
the tests marked `cuda` (and by chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu.constants import encode_seq
from t1k_tpu.io.reads import read_seq_file
from t1k_tpu.io.refset import RefSet
from t1k_tpu.native import NativeEngine, align_global
from t1k_tpu_torch.native import NativeEngine as PortEngine
from t1k_tpu_torch.ops import align_band as ab

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "data")


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


def _multigene_batch():
    refset = RefSet.from_fasta(os.path.join(DATA_DIR, "multigene_rna.fa"))
    seqs = [r.seq for name in ("multigene_1.fq", "multigene_2.fq")
            for r in read_seq_file(os.path.join(DATA_DIR, name))]
    codes = [encode_seq(s) for s in seqs]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flat = np.concatenate(codes).astype(np.int8)
    return refset.packed(), flat, starts, lens, np.ones(len(codes), np.int32)


@pytest.mark.parametrize("transport", ["descriptors", "window_bytes"])
def test_engine_deferred_with_port_scorer_matches_inline(transport):
    """The port's engine copy, deferring to the port's scorer, is
    byte-identical to the reference package's inline engine on the
    multigene reads."""
    from t1k_tpu.constants import GENOTYPER_KMER_LENGTH

    packed, flat, starts, lens, weights = _multigene_batch()
    eng1 = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)
    eng2 = PortEngine(packed, GENOTYPER_KMER_LENGTH)  # the port's copy
    if transport == "descriptors":
        svc = ab.DeferredDescService(device="cpu")
        rec2, off2 = eng2.assign_batch_deferred(flat, starts, lens, weights,
                                                desc_service=svc)
        assert svc.items_scored > 10_000
    else:
        rec2, off2 = eng2.assign_batch_deferred(
            flat, starts, lens, weights, ab.make_deferred_stats_fn("cpu"))
    assert rec1.shape[0] > 0
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)
    assert np.array_equal(eng1.pos_weight(), eng2.pos_weight())


def test_chunked_desc_deferral_matches_unchunked():
    from t1k_tpu.constants import GENOTYPER_KMER_LENGTH

    packed, flat, starts, lens, weights = _multigene_batch()
    n = len(lens) // 2
    uid1 = np.arange(n, dtype=np.int64)
    uid2 = np.arange(n, 2 * n, dtype=np.int64)
    has_n = np.zeros(n, np.uint8)
    outs = []
    for chunk in (0, 317):
        eng = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
        eng.assign_batch_deferred(
            flat, starts, lens, weights, store_results=False,
            chunk_size=chunk, desc_service=ab.DeferredDescService("cpu"))
        outs.append((*eng.fragment_batch(uid1, uid2, has_n, True, 2000,
                                         None), eng.pos_weight()))
    assert outs[0][0].shape[0] > 0
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


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


def _thread_slots(t_len, p_len, ml):
    """Register slots one item needs (band_stats.cu item_slots): the
    window cells from the column-0 cell left of the band to the row-0 cell
    right of it."""
    diff = t_len - p_len
    base = max(ml - 5 - max(-diff, 0) - 1, 0)
    return max(min(ml + 5 + max(diff, 0) + 1, 31) - base + 1, 1)


def _thread_item(ref, reads, item, ml, ns, stats=True):
    """Scalar mirror of csrc/band_stats.cu's band_item for one item
    (t_off, t_len, p_off, p_len), slot for slot: the same register slots,
    running max, copy scan and boundary cases, and the narrow kernel's
    rows without column 0 (13 slots).  Returns (score, packed counts)."""
    neg, go, ge, m32, kw = ab.NEG_INF, ab.GO, ab.GE, 0xFFFFFFFF, 32
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
    col0_rows = min(pl, ml - base) if ns == 13 else pl
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
        run = m_left = neg
        nof_left = last_p = 0
        last_w = -1024
        for s in range(ns):
            j, col0, inband = js0 + s, k_col0 and s == c0, lo <= s <= hi
            j_pos = not k_col0 or j >= 1
            sub = ab.SCORE_MATCH if match[s] else ab.SCORE_MISMATCH
            up = s + 1 < ns
            m_up = m[s + 1] if up else neg
            ec = max(e[s + 1] + ge, m_up + go + ge) if up else neg
            if col0:
                ec = go + i * ge
            h = m0_i if col0 else max(m[s] + sub, ec)
            if not (inband or (col0 and start_le1)):
                h = neg
            u = (m0_i - go if start_le1 else neg) if col0 else h - ge * j
            f = go + ge * j + run
            run = max(run, u)
            ibc = inband or col0
            mc = m0_i if col0 else (max(h, f) if ibc else neg)
            ec = ec if ibc else neg
            if stats:
                open_e = m_up + go + ge == ec
                pe_new = (ab.IU + ((pm[s + 1] if open_e else pe[s + 1])
                                   if up else 0)) & m32
                diag_ok = m[s] + sub == mc and j_pos
                diag_p = (pm[s] + (ab.MU if match[s] else ab.XU)) & m32
                nof = diag_p if diag_ok else pe_new
                if col0 or (m_left + go + ge == f and j_pos):
                    last_w, last_p = base + s, (i * ab.IU if col0
                                                else nof_left)
                pf = (last_p + (base + s - last_w + 1) * ab.IU) & m32
                v = diag_p if diag_ok else (pf if f >= ec else pe_new)
                pm[s], pe[s] = (i * ab.IU if col0 else v), pe_new
                nof_left = nof
            m_left = m[s] = mc
            e[s] = ec
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


def _mirror_batches():
    """(name, ref, reads, desc, ML, W) batches for the mirror:
    every MIRROR_SHAPES item at the descriptor route's (15, 32), and the
    byte-window batches of the stats cases and the golden table at their
    own (ML, W)."""
    rng = np.random.default_rng(77)
    ref, reads, starts, lens, items = _shape_items(rng, MIRROR_SHAPES, 1)
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
    out = [("edges", torch.from_numpy(np.concatenate(
        [ref, np.zeros(ab.SEQ_PAD, np.int8)])), torch.from_numpy(flat),
        torch.from_numpy(desc.astype(np.int64)), ab.DESC_ML, ab.DESC_W)]
    for name, (tc, tl, pc, pl) in (("stats_cases", _stats_cases()),
                                   ("golden", _golden_batch()[:4])):
        ml, over = ab._window_class(tl, pl)
        out.append((name, *ab._pack_windows(tc, tl, pc, pl, "cpu"), ml,
                    ab.band_window(ml, over)))
    return out


@pytest.mark.parametrize("stats", [True, False])
def test_thread_kernel_mirror_matches_plain(stats):
    """The thread kernel's slot loop, run as scalar Python on each item,
    equals the plain version on the edge shapes (every diff in [-10, 10]
    against p_len 1-254, t_len 0 included), the stats cases and the golden
    table, with the smallest slot count each item fits (a warp of such
    items) and with 32 slots (a warp holding a wider item)."""
    for name, ref, reads, desc, ml, w in _mirror_batches():
        want = ab.band_stats_plain(ref, reads, desc, ml, w, stats).numpy()
        r, q, d = ref.numpy(), reads.numpy(), desc.numpy()
        for widest in (False, True):
            got = []
            for k in range(d.shape[1]):
                need = _thread_slots(int(d[1, k]), int(d[3, k]), ml)
                ns = 32 if widest else min(c for c in THREAD_SLOTS
                                           if c >= need)
                got.append(_thread_item(r, q, d[:, k], ml, ns, stats))
            assert (np.array(got).T == want).all(), (name, widest)


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
