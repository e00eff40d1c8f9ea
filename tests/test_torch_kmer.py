"""The port's k-mer prefilter (t1k_tpu_torch/ops/kmer.py, K11) against the
JAX package's (t1k_tpu/ops/kmer.py) on committed data: the tables word
for word, the per-read (fwd, rc) counts element for element on the direct
(k = 11, 14) and hashed (k = 15, 16) paths, edge reads, a scalar mirror
of the CUDA kernel's single-pass keys and probe loop, and no read the
native screen accepts dropped.  The JAX package is imported inside the
tests that use it, so the `cuda` test also collects where jax is absent."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu_torch.constants import encode_seq
from t1k_tpu_torch.io.reads import read_seq_file
from t1k_tpu_torch.io.refset import RefSet
from t1k_tpu_torch.native import NativeEngine
from t1k_tpu_torch.ops import kmer

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU = torch.device("cpu")
PANELS = ("multigene_rna.fa", "kirex_rna.fa")
KS = (11, 14, 15, 16)


def _packed(panel, jax_package=False):
    if jax_package:
        from t1k_tpu.io.refset import RefSet as JaxRefSet
        refset = JaxRefSet(digit_units=-1)
    else:
        refset = RefSet(digit_units=-1)
    for rec in read_seq_file(os.path.join(DATA, panel)):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    return refset.packed()


_TABLES = {}


def _tables(panel, k):
    """(port table on the CPU, JAX DeviceKmerTable), built once."""
    if (panel, k) not in _TABLES:
        from t1k_tpu.ops.kmer import DeviceKmerTable as JaxTable

        _TABLES[panel, k] = (
            kmer.DeviceKmerTable.build(_packed(panel), k, device="cpu"),
            JaxTable.build(_packed(panel, jax_package=True), k))
    return _TABLES[panel, k]


def _words(table):
    """A port table as the JAX build's uint32 array."""
    return table.table.cpu().numpy().view(np.uint32)


def _extract_reads():
    recs = list(read_seq_file(os.path.join(DATA, "extract_1.fq")))
    lens = np.array([len(r.seq) for r in recs], np.int32)
    codes = np.full((len(recs), int(lens.max())), 4, np.int8)
    for i, r in enumerate(recs):
        codes[i, :lens[i]] = encode_seq(r.seq)
    return codes, lens


def _edge_reads(panel, k, L=48, seed=5):
    """Reads cut from a panel allele (so their windows hit), at the edges:
    lengths 0, k - 1, k, k + 1 and L; an N at the first, a middle and the
    last base; the reverse complement of a slice (its rc windows hit);
    all-T and all-A reads (at k = 16 the all-T key equals the
    hashed table's empty marker); random bases past each read's end."""
    rng = np.random.default_rng(seed)
    packed = _packed(panel)
    start, ln = int(packed.seq_starts[0]), int(packed.seq_lens[0])
    allele = packed.seq_codes[start:start + ln]
    rows = []
    for n in (0, k - 1, k, k + 1, L):
        off = int(rng.integers(0, ln - L))
        rows.append((allele[off:off + n].copy(), n))
    for pos in (0, L // 2, L - 1):
        r = allele[100:100 + L].copy()
        r[pos] = 4
        rows.append((r, L))
    rc = allele[200:200 + L][::-1].copy()
    rows.append((np.where(rc < 4, 3 - rc, rc).astype(np.int8), L))
    rows.append((np.full(L, 3, np.int8), L))
    rows.append((np.full(L, 0, np.int8), L))
    rows.append((np.full(k, 3, np.int8), k))
    codes = rng.integers(0, 5, (len(rows), L)).astype(np.int8)
    lens = np.zeros(len(rows), np.int32)
    for i, (r, n) in enumerate(rows):
        codes[i, :n] = r
        lens[i] = n
    return codes, lens


def _jax_counts(jtable, codes, lens):
    from t1k_tpu.ops.kmer import classify_reads

    fwd, rc = classify_reads(jtable, codes, lens)
    return np.asarray(fwd), np.asarray(rc)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("panel", PANELS)
def test_tables_equal_the_jax_build(panel, k):
    mine, theirs = _tables(panel, k)
    want = np.asarray(theirs.table)
    assert mine.direct == theirs.direct == (k <= kmer.DIRECT_MAX_K)
    assert mine.size == theirs.size == len(want)
    assert mine.table.dtype == torch.int32 and mine.table.device == CPU
    assert want.dtype == np.uint32 and np.array_equal(_words(mine), want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("panel", PANELS)
def test_counts_equal_jax_classify_reads(panel, k):
    """The extraction reads and the edge reads, element for element."""
    mine, theirs = _tables(panel, k)
    for codes, lens in (_extract_reads(), _edge_reads(panel, k)):
        fwd, rc = kmer.classify_reads(mine, codes, lens)
        want_fwd, want_rc = _jax_counts(theirs, codes, lens)
        assert fwd.dtype == rc.dtype == np.int32
        assert np.array_equal(fwd, want_fwd)
        assert np.array_equal(rc, want_rc)
    if panel == "multigene_rna.fa":  # the extraction reads come from it
        fwd, rc = kmer.classify_reads(mine, *_extract_reads())
        assert 0.3 < (fwd > 0).mean() < 1


@pytest.mark.parametrize("k", KS)
def test_edge_reads(k):
    """Reads shorter than k give zeros, the reverse-complemented slice hits
    on every rc window; at k = 16 the all-T reads hit on every forward
    window (their key is the hashed table's empty marker)."""
    mine, _ = _tables("multigene_rna.fa", k)
    codes, lens = _edge_reads("multigene_rna.fa", k)
    fwd, rc = kmer.classify_reads(mine, codes, lens)
    short = lens < k
    assert short.sum() == 2 and not fwd[short].any() and not rc[short].any()
    assert rc[8] == codes.shape[1] - k + 1  # the reverse-complement slice
    if k == 16:
        poly_t = (codes == 3).all(axis=1) & (lens == codes.shape[1])
        n_win = codes.shape[1] - k + 1
        assert (fwd[poly_t] == n_win).all()
        # its reverse complement is all-A, a key the panel may lack
        assert (fwd[(codes[:, :k] == 3).all(axis=1) & (lens == k)] == 1).all()


def test_batch_narrower_than_k_gives_zeros():
    mine, theirs = _tables("multigene_rna.fa", 15)
    codes = np.zeros((3, 10), np.int8)
    lens = np.array([10, 5, 0], np.int32)
    for got, want in zip(kmer.classify_reads(mine, codes, lens),
                         _jax_counts(theirs, codes, lens)):
        assert np.array_equal(got, want) and not got.any()
    assert not kmer.prefilter_flags(mine, codes, lens, 27).any()


def _mirror_hit(words, key, direct, mask):
    """csrc/kmer_classify.cu's table_hit, one key in Python."""
    if direct:
        return (int(words[key >> 5]) >> (key & 31)) & 1
    h = (key * 2654435761) & 0xFFFFFFFF & mask
    step = ((key >> 15) | 1) & mask | 1
    for _ in range(kmer.MAX_PROBE):
        e = int(words[h])
        if e == key:
            return 1
        if e == kmer.EMPTY_KEY:
            return 0
        h = (h + step) & mask
    return 1


def _kernel_mirror(table, codes, lens):
    """The kernel's arithmetic: per read, each forward window's key and
    its reverse complement's, both built from the forward bases (base t
    at bits 2(k-1-t) and its complement at bits 2t), windows f < min(len,
    L) - k + 1 without an N, each key through table_hit."""
    k = table.k
    words = _words(table)
    win = np.lib.stride_tricks.sliding_window_view(
        codes.astype(np.int64), k, axis=1)
    c = np.minimum(win, 3)
    fk = (c << (2 * np.arange(k - 1, -1, -1))).sum(axis=2)
    rk = ((3 - c) << (2 * np.arange(k))).sum(axis=2)
    n_win = np.minimum(lens, codes.shape[1]) - k + 1
    ok = (win < 4).all(axis=2) & (np.arange(win.shape[1])[None, :]
                                  < n_win[:, None])
    out = np.zeros((2, len(lens)), np.int32)
    for r, f in zip(*np.nonzero(ok)):
        for s, key in enumerate((fk[r, f], rk[r, f])):
            out[s, r] += _mirror_hit(words, int(key), table.direct,
                                     table.size - 1)
    return out


@pytest.mark.parametrize("k", KS)
def test_kernel_mirror_equals_jax(k):
    """The single-pass keys and the early-exit probe loop give the JAX
    counts (kirex panel: the extraction reads mostly miss it)."""
    mine, theirs = _tables("kirex_rna.fa", k)
    for codes, lens in (_extract_reads(), _edge_reads("kirex_rna.fa", k)):
        got = _kernel_mirror(mine, codes, lens)
        want = _jax_counts(theirs, codes, lens)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("panel", PANELS)
def test_prefilter_keeps_every_read_the_screen_accepts(panel):
    k, hit_len = 11, 27
    packed = _packed(panel)
    engine = NativeEngine(packed, k, hit_len_required=hit_len)
    mine, _ = _tables(panel, k)
    codes, lens = _extract_reads()
    flat = np.concatenate([codes[i, :lens[i]] for i in range(len(lens))])
    starts = np.zeros(len(lens), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    accepted = engine.screen_batch(flat, starts, lens).astype(bool)
    flags = kmer.prefilter_flags(mine, codes, lens, hit_len)
    assert flags.dtype == bool
    assert not (accepted & ~flags).any()
    if panel == "multigene_rna.fa":
        assert accepted.sum() > 100


def test_build_refuses_k_past_16_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="k <= 16"):
        kmer.DeviceKmerTable.build(_packed("kirex_rna.fa"), 17, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kmer.DeviceKmerTable.build(_packed("kirex_rna.fa"), 11)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", (11, 13, 14, 15, 16))
def test_kernel_on_card_equals_plain(cuda_device, k):
    """The kernel against its plain version on the card's tensors, exact,
    on the extraction and edge reads; a launch is counted."""
    table = kmer.DeviceKmerTable.build(_packed("multigene_rna.fa"), k,
                                       device=cuda_device)
    for codes, lens in (_extract_reads(), _edge_reads("multigene_rna.fa",
                                                      k)):
        c = torch.from_numpy(codes).to(cuda_device)
        n = torch.from_numpy(lens).to(cuda_device)
        before = kmer.launch_counts["kmer_classify"]
        got = kmer.classify(table, c, n)
        want = kmer.classify_plain(table, c, n)
        torch.cuda.synchronize()
        assert kmer.launch_counts["kmer_classify"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
