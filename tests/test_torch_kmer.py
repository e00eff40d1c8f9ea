"""The port's k-mer prefilter (t1k_tpu_torch/ops/kmer.py, K11) against the
JAX package's (t1k_tpu/ops/kmer.py) on committed data: the tables word
for word, the pair table's bits against the JAX build's key set, the
per-read (fwd, rc) counts element for element on the pair (k = 11-13),
bitmap (k = 14) and hashed (k = 15, 16) paths, edge reads, a scalar
mirror of the CUDA kernel's thread loop (rolled keys, last-N tracking,
batched lookups, tiles and shares of a read), the count of table words
a launch reads, and no read the native
screen accepts dropped.  The JAX package is imported inside the tests
that use it, so the `cuda` test also collects where jax is absent."""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from t1k_tpu_torch.constants import encode_seq
from t1k_tpu_torch.io.reads import read_seq_file
from t1k_tpu_torch.io.refset import RefSet
from t1k_tpu_torch.native import NativeEngine
from t1k_tpu_torch.ops import kmer

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "t1k_tpu_torch", "csrc", "kmer_classify.cu")
CPU = torch.device("cpu")
PANELS = ("multigene_rna.fa", "kirex_rna.fa")
KS = (11, 12, 13, 14, 15, 16)
PAIR_KS = (11, 12, 13)      # the pair table; 14 the centre-canonical one


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _words_of(t):
    """A port table's int32 words as the JAX build's uint32 array."""
    return t.cpu().numpy().view(np.uint32)


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
    assert want.dtype == np.uint32 and np.array_equal(_words_of(mine.table), want)


def _revcomp(key, k):
    """A key's reverse complement through its base string."""
    bases = "".join("ACGT"[(key >> 2 * (k - 1 - t)) & 3] for t in range(k))
    rc = bases[::-1].translate(str.maketrans("ACGT", "TGCA"))
    return sum("ACGT".index(b) << 2 * (k - 1 - t) for t, b in enumerate(rc))


def _jax_member(jtable, key):
    """Membership of a key in the JAX build's key set (its bitmap)."""
    return (int(np.asarray(jtable.table)[key >> 5]) >> (key & 31)) & 1


def _centre_entry(key, k):
    """(canonical key's entry, swapped) at k = 14, from the layout's
    definition: the middle pair m and its reverse complement's pair make a
    class; the key with the smaller pair is canonical (for a pair that is
    its own reverse complement, the key itself)."""
    m = (key >> 12) & 15
    partner = 4 * (3 - (m & 3)) + (3 - (m >> 2))
    classes = sorted({min(p, 4 * (3 - (p & 3)) + (3 - (p >> 2)))
                      for p in range(16)})
    x = _revcomp(key, k) if m > partner else key
    flanks = ((x >> 16) << 12) | (x & 0xFFF)
    return classes.index(min(m, partner)) << 24 | flanks, m > partner


def _key_strategy(k, members):
    """Members of the key set, their reverse complements, random keys and
    (at even k) palindromes: a random half followed by its reverse
    complement."""
    half = k // 2
    palindromes = st.integers(0, 4 ** half - 1).map(
        lambda h: (h << 2 * half) | _revcomp(h, half))
    keys = [st.sampled_from(members),
            st.sampled_from(members).map(lambda x: _revcomp(x, k)),
            st.integers(0, 4 ** k - 1)]
    return st.one_of(*keys, *([palindromes] if k % 2 == 0 else []))


def _pair_bits(table, key):
    """(key in S, revcomp(key) in S) as the pair table holds them."""
    words = _words_of(table.pair)
    if table.k <= kmer.PAIR_MAX_K:
        v = (int(words[key >> 4]) >> 2 * (key & 15)) & 3
        return v & 1, v >> 1
    i, swapped = _centre_entry(key, table.k)
    v = (int(words[i >> 4]) >> 2 * (i & 15)) & 3
    return (v >> 1, v & 1) if swapped else (v & 1, v >> 1)


@pytest.mark.parametrize("k", (*PAIR_KS, kmer.CENTRE_K))
def test_pair_bits_are_memberships_of_key_and_revcomp(k):
    """Each pair entry's bits against the JAX build's key set (multigene
    panel): the key's membership and its reverse complement's, over
    hypothesis' keys; palindromes at even k have both bits equal."""
    mine, theirs = _tables("multigene_rna.fa", k)
    assert mine.mode == (kmer.MODE_PAIR if k <= kmer.PAIR_MAX_K
                         else kmer.MODE_CENTRE)
    assert mine.pair.dtype == torch.int32
    assert len(mine.pair) == (4 ** k if k <= kmer.PAIR_MAX_K
                              else 10 * 4 ** (k - 2)) // 16
    members = kmer.key_array(_packed("multigene_rna.fa"), k)[::97].tolist()

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(_key_strategy(k, members))
    def check(key):
        rc = _revcomp(key, k)
        fwd, rev = _pair_bits(mine, key)
        assert fwd == _jax_member(theirs, key)
        assert rev == _jax_member(theirs, rc)
        if rc == key:
            assert fwd == rev

    check()


@pytest.mark.parametrize("k", (*PAIR_KS, kmer.CENTRE_K))
def test_pair_table_holds_exactly_the_key_set_both_ways(k):
    """Every key at once.  Pair table: its even bits unpacked equal the
    JAX bitmap, its odd bits are set exactly at the reverse complements of
    the keys.  Centre table: each key's bit at its canonical entry (the
    upper bit where that is its reverse complement's) is set, and it holds
    as many bits as keys plus the keys whose middle pair is its own
    reverse complement (both orientations canonical)."""
    mine, theirs = _tables("multigene_rna.fa", k)
    bits = np.unpackbits(_words_of(mine.pair).view(np.uint8),
                         bitorder="little")
    jax_bits = np.unpackbits(np.asarray(theirs.table).view(np.uint8),
                             bitorder="little")
    members = np.flatnonzero(jax_bits)
    rcs = kmer.revcomp_keys(members, k)
    assert np.array_equal(rcs[::53], [_revcomp(int(x), k)
                                      for x in members[::53]])
    if k <= kmer.PAIR_MAX_K:
        assert np.array_equal(bits[0::2], jax_bits)
        assert bits[1::2].sum() == len(members)
        assert bits[2 * rcs + 1].all()
        return
    entries = [_centre_entry(int(x), k) for x in members[::7]]
    assert bits[np.array([2 * i + swapped for i, swapped in entries])].all()
    cls, flip = kmer.centre_classes()
    partner = np.array([4 * (3 - (m & 3)) + (3 - (m >> 2))
                        for m in range(16)])
    m = (members >> 12) & 15
    assert bits.sum() == len(members) + (partner[m] == m).sum()
    assert int(cls.max()) == 9 and int(flip.sum()) == 6


def test_table_modes_by_k():
    for k in KS:
        mine, _ = _tables("kirex_rna.fa", k)
        want = (kmer.MODE_PAIR if k <= kmer.PAIR_MAX_K else
                kmer.MODE_CENTRE if k == kmer.CENTRE_K else
                kmer.MODE_HASHED)
        assert mine.mode == want
        assert (mine.pair is None) == (k > kmer.DIRECT_MAX_K)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("panel", PANELS)
def test_counts_equal_jax_classify_reads(panel, k):
    """The extraction reads and the edge reads, element for element (the
    plain version's pair lookup at k <= 14)."""
    mine, theirs = _tables(panel, k)
    assert (mine.pair is not None) == (k <= kmer.DIRECT_MAX_K)
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


def _probes(words, key):
    """Table words a hashed probe chain for `key` reads, scalar: until the
    key, an empty slot or MAX_PROBE."""
    mask = len(words) - 1
    h = (key * 2654435761) & 0xFFFFFFFF & mask
    step = ((key >> 15) | 1) & mask | 1
    for n in range(1, kmer.MAX_PROBE + 1):
        if words[h] in (key, 0xFFFFFFFF):
            return n
        h = (h + step) & mask
    return kmer.MAX_PROBE


@pytest.mark.parametrize("k", KS)
def test_lookups_count_the_table_words_read(k):
    """`lookups` (the smoke's count of table words a launch reads) against
    a scalar walk of each window in its read without an N: one word a
    window, the first design two (k <= 14); hashed, each strand's probe
    chain on the JAX build's words, in both designs."""
    mine, theirs = _tables("multigene_rna.fa", k)
    words = [int(w) for w in np.asarray(theirs.table)]
    for codes, lens in (_extract_reads(),
                        _edge_reads("multigene_rna.fa", k)):
        want = 0
        for row, n in zip(codes, lens):
            for w in range(max(int(n) - k + 1, 0)):
                win = row[w:w + k]
                if (win >= 4).any():
                    continue
                if k <= kmer.DIRECT_MAX_K:
                    want += 1
                    continue
                fk = int(sum(int(b) << 2 * (k - 1 - t)
                             for t, b in enumerate(win)))
                want += (_probes(words, fk)
                         + _probes(words, _revcomp(fk, k)))
        got = kmer.lookups(mine, torch.from_numpy(codes),
                           torch.from_numpy(lens))
        assert got == ((want, 2 * want) if k <= kmer.DIRECT_MAX_K
                       else (want, want))


def _kernel_constants():
    """csrc/kmer_classify.cu's thread mapping: kParts, kBatch, kTileWin."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kParts", "kBatch", "kTileWin"))


def _lookup_batch(table, words, batch):
    """One batch's lookups as the kernel's Lookup structs make them:
    `batch` holds (fk, rk, ok) of each window; every load is issued (in
    rounds, for the hashed chains) before any count; returns the batch's
    (fwd, rc) hits."""
    k, mode, mask = table.k, table.mode, table.size - 1
    if mode == kmer.MODE_PAIR:
        loaded = [int(words[fk >> 4]) if ok else 0 for fk, _, ok in batch]
        return [((w >> 2 * (fk & 15)) & 1, (w >> 2 * (fk & 15) + 1) & 1)
                for (fk, _, _), w in zip(batch, loaded)]
    if mode == kmer.MODE_CENTRE:
        entries = [_centre_entry(fk, k) for fk, _, _ in batch]
        loaded = [int(words[i >> 4]) if ok else 0
                  for (i, _), (_, _, ok) in zip(entries, batch)]
        out = []
        for (i, swapped), w in zip(entries, loaded):
            v = (w >> 2 * (i & 15)) & 3
            out.append((v >> 1, v & 1) if swapped else (v & 1, v >> 1))
        return out
    h = [[(key * 2654435761) & 0xFFFFFFFF & mask for key in (fk, rk)]
         for fk, rk, _ in batch]
    e = [[int(words[h[i][s]]) if ok else key
          for s, key in enumerate((fk, rk))]
         for i, (fk, rk, ok) in enumerate(batch)]
    for _ in range(1, kmer.MAX_PROBE):  # a round of the unresolved chains
        more = False
        for i, (fk, rk, _) in enumerate(batch):
            for s, key in enumerate((fk, rk)):
                if e[i][s] != key and e[i][s] != kmer.EMPTY_KEY:
                    h[i][s] = (h[i][s] + (((key >> 15) | 1) & mask | 1)) \
                        & mask
                    e[i][s] = int(words[h[i][s]])
                    more = True
        if not more:
            break
    return [tuple(int(ok and (e[i][s] == key or e[i][s] != kmer.EMPTY_KEY))
                  for s, key in enumerate((fk, rk)))
            for i, (fk, rk, ok) in enumerate(batch)]


def _kernel_mirror(table, codes, lens, parts, batch, tile_win):
    """csrc/kmer_classify.cu's classify_kernel, one thread at a time: each
    read's windows in `parts` shares, the row in tiles of `tile_win`
    windows; in a tile the share's keys rolled a base a window from k - 1
    bases before it, the last N's position tracked, `batch` windows'
    lookups issued before any is consumed (past the share's end an N,
    no lookup): a pair word a window at k <= 13, a centre-canonical word
    at 14, both strands' probe chains hashed."""
    k = table.k
    words = _words_of(table.table if table.pair is None else table.pair)
    kmask = (1 << 2 * k) - 1
    R, L = codes.shape
    W = L - k + 1
    out = np.zeros((2, R), np.int32)
    for r in range(R):
        n_win = max(min(int(lens[r]), L) - k + 1, 0)
        for part in range(parts):
            w_lo, w_hi = n_win * part // parts, n_win * (part + 1) // parts
            for base in range(0, W, tile_win):
                if w_hi <= base:
                    break
                tw = min(tile_win, W - base)
                a, b = max(w_lo, base), min(w_hi, base + tw)
                if a >= b:
                    continue
                s = codes[r, a:base + tw + k - 1].astype(np.int64)
                q_end = b - a + k - 1
                fk = rk = 0
                last_n = -k
                pending = []
                for q in range(q_end + (-(q_end - k + 1)) % batch):
                    code = int(s[min(q, q_end - 1)]) if q < q_end else 4
                    c = min(code, 3)
                    fk = ((fk << 2) | c) & kmask
                    rk = (rk >> 2) | ((c ^ 3) << 2 * (k - 1))
                    last_n = q if code >= 4 else last_n
                    if q < k - 1:
                        continue
                    pending.append((fk, rk, q - last_n >= k))
                    if len(pending) == batch:
                        for f, c in _lookup_batch(table, words, pending):
                            out[0, r] += f
                            out[1, r] += c
                        pending = []
    return out


@pytest.mark.parametrize("k", KS)
def test_kernel_mirror_equals_jax(k):
    """The kernel's thread loop at its committed constants gives the JAX
    counts (kirex panel: the extraction reads mostly miss it)."""
    mine, theirs = _tables("kirex_rna.fa", k)
    for codes, lens in (_extract_reads(), _edge_reads("kirex_rna.fa", k)):
        got = _kernel_mirror(mine, codes, lens, *_kernel_constants())
        want = _jax_counts(theirs, codes, lens)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("k", KS)
def test_kernel_mirror_tiles_and_shares_equal_jax(k):
    """Short tiles, four shares a read and an odd batch put share and tile
    edges inside windows and N runs (multigene panel, where reads hit)."""
    mine, theirs = _tables("multigene_rna.fa", k)
    codes, lens = _edge_reads("multigene_rna.fa", k, L=70)
    extract = _extract_reads()
    codes = np.concatenate([codes, extract[0][:24, :70]])
    lens = np.concatenate([lens, np.minimum(extract[1][:24], 70)])
    want = _jax_counts(theirs, codes, lens)
    assert want[0].sum() > 0 and want[1].sum() > 0
    for parts, batch, tile_win in ((4, 3, 5), (2, 8, 17), (32, 1, 96)):
        got = _kernel_mirror(mine, codes, lens, parts, batch, tile_win)
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
@pytest.mark.parametrize("k", (11, 12, 13, 14, 15, 16))
def test_kernel_on_card_equals_plain(cuda_device, k):
    """The kernel and its first design against the plain version on the
    card's tensors, exact, on the extraction and edge reads (at L = 151
    too: rows of an odd length, staged a byte at a time, and two tiles);
    `classify` launches the kernel once and never the first design."""
    table = kmer.DeviceKmerTable.build(_packed("multigene_rna.fa"), k,
                                       device=cuda_device)
    for codes, lens in (_extract_reads(),
                        _edge_reads("multigene_rna.fa", k),
                        _edge_reads("multigene_rna.fa", k, L=151)):
        c = torch.from_numpy(codes).to(cuda_device)
        n = torch.from_numpy(lens).to(cuda_device)
        before = dict(kmer.launch_counts)
        got = kmer.classify(table, c, n)
        assert kmer.launch_counts["kmer_classify"] == \
            before["kmer_classify"] + 1
        assert kmer.launch_counts["kmer_classify_v1"] == \
            before["kmer_classify_v1"]
        v1 = kmer.classify_v1_cuda(table, c, n)
        assert kmer.launch_counts["kmer_classify_v1"] == \
            before["kmer_classify_v1"] + 1
        want = kmer.classify_plain(table, c, n)
        torch.cuda.synchronize()
        for out in (got, v1):
            assert torch.equal(out[0], want[0])
            assert torch.equal(out[1], want[1])
