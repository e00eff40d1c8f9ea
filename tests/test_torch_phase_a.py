"""The port's phase-A screen (t1k_tpu_torch/ops/phase_a.py) against the
JAX package's (t1k_tpu/ops/phase_a.py) and the native engine's
HasHitInSet.

Integer programs: every comparison is exact.  The plain PyTorch versions
run here on the CPU; the CUDA kernels are compared with them on a card by
the tests marked `cuda` (and by chip_smoke.py).  The seeded panels and
reads follow tests/test_phase_a.py, with the same caps, so the JAX side
compiles the same variants.  The JAX package is imported inside the
tests that use it, so the `cuda` tests also collect where jax is
absent."""

import numpy as np
import pytest
import torch

from t1k_tpu.constants import encode_seq
from t1k_tpu.io.refset import RefSet
from t1k_tpu.native import NativeEngine
from t1k_tpu_torch.ops import phase_a as tpa

BASES = "ACGT"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def mutate(rng, s, rate=0.05, n_rate=0.2):
    out = list(s)
    for i in range(len(out)):
        r = rng.random()
        if r < rate:
            out[i] = BASES[rng.integers(0, 4)]
        elif r < rate * (1 + n_rate):
            out[i] = "N"
    return "".join(out)


def revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(s))


def make_reads(rng, seqs, n):
    reads = []
    for _ in range(n):
        kind = rng.integers(0, 6)
        s = seqs[rng.integers(0, len(seqs))]
        if kind == 0:
            reads.append(rand_seq(rng, int(rng.integers(30, 150))))
        elif kind == 1:
            st = rng.integers(0, max(1, len(s) - 100))
            reads.append(mutate(rng, s[st:st + 100], rng.random() * 0.2))
        elif kind == 2:
            st = rng.integers(0, max(1, len(s) - 100))
            reads.append(revcomp(mutate(rng, s[st:st + 100],
                                        rng.random() * 0.1)))
        elif kind == 3 and len(s) > 250:
            reads.append(mutate(rng, s[:60] + s[-60:], 0.02))
        elif kind == 4:
            reads.append("A" * int(rng.integers(5, 40)))  # code-0 quirk
        else:
            st = rng.integers(0, max(1, len(s) - 60))
            reads.append(mutate(rng, s[st:st + 60], 0.05))
    return reads


def _packed(seqs):
    rs = RefSet(digit_units=-1, delimiter="")
    for i, s in enumerate(seqs):
        rs.add_allele(f"G{i % 3}*{i:03d}", s, None)
    return rs.packed()


def _pad(reads):
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = encode_seq(r)
        codes[i, :len(c)] = c
        lens[i] = len(c)
    return codes, lens


def _native(packed, k, hit_len, sim, reads, lens):
    eng = NativeEngine(packed, k, ref_seq_similarity=sim,
                       hit_len_required=hit_len)
    cat = np.concatenate([encode_seq(r) for r in reads])
    starts = np.zeros(len(reads), np.int64)
    starts[1:] = np.cumsum(lens[:-1].astype(np.int64))
    return eng.screen_batch(cat, starts, lens).astype(bool)


def check_parity(seqs, reads, k, hit_len, sim, caps=None):
    """Plain port screen == JAX screen (verdict and decided, exactly) and
    == the native engine on every decided read.  Returns `decided`."""
    from t1k_tpu.ops import phase_a as jpa

    packed = _packed(seqs)
    caps = caps or dict(bucket_cap=128)
    jscreen = jpa.DeviceScreen.build(packed, k, hit_len, sim, **caps)
    tscreen = tpa.DeviceScreen.build(packed, k, hit_len, sim, device="cpu",
                                     **caps)
    codes, lens = _pad(reads)
    jv, jd = jscreen.screen(codes, lens)
    tv, td = tscreen.screen(codes, lens)
    assert (td == jd).all()
    assert (tv == jv).all()
    flags = _native(packed, k, hit_len, sim, reads, lens)
    mism = np.nonzero(td & (tv != flags))[0]
    assert len(mism) == 0, f"diverges from the engine on {reads[mism[0]]!r}"
    assert tscreen.screened == len(reads)
    assert tscreen.decided == int(td.sum())
    return td


def _random_panel(rng):
    base = rand_seq(rng, int(rng.integers(300, 700)))
    seqs = []
    for _ in range(int(rng.integers(3, 25))):
        if rng.random() < 0.7:
            seqs.append(mutate(rng, base, 0.03).replace("N", "A"))
        else:
            seqs.append(rand_seq(rng, int(rng.integers(200, 600))))
    return seqs


@pytest.mark.parametrize("k", [9, 13])
def test_index_carries_over_from_jax(k):
    """Direct (k=9) and hashed (k=13) tables: the port's build equals the
    JAX build field for field, and the carry-over reproduces it."""
    from t1k_tpu.ops import phase_a as jpa

    rng = np.random.default_rng(91)
    base = rand_seq(rng, 600)
    seqs = [mutate(rng, base, 0.02).replace("N", "G") for _ in range(15)]
    seqs += ["A" * 40, "ACGT" * 30]
    packed = _packed(seqs)
    jidx = jpa.PhaseAIndex.build(packed, k)
    carried = tpa.PhaseAIndex.from_jax_arrays(
        **{f: np.asarray(getattr(jidx, f)) if hasattr(getattr(jidx, f),
                                                      "shape")
           else getattr(jidx, f) for f in jpa.PhaseAIndex.__dataclass_fields__},
        device="cpu")
    built = tpa.PhaseAIndex.build(packed, k, device="cpu")
    assert built.direct == (k <= 12)
    for name, want in carried.to_numpy().items():
        got = built.to_numpy()[name]
        assert np.array_equal(np.asarray(got), np.asarray(want)), name
        assert np.array_equal(np.asarray(want),
                              np.asarray(getattr(jidx, name))), name


@pytest.mark.parametrize("k", [9, 13])
def test_probe_matches_jax_probe_kernel(k):
    from t1k_tpu.ops import phase_a as jpa

    rng = np.random.default_rng(7)
    seqs = _random_panel(rng)
    reads = make_reads(rng, seqs, 80)
    codes, lens = _pad(reads)
    packed = _packed(seqs)
    jidx = jpa.PhaseAIndex.build(packed, k)
    tidx = tpa.PhaseAIndex.build(packed, k, device="cpu")
    want = jpa._probe_kernel(codes, lens, jidx.starts, jidx.keys, jidx.hstart,
                             jidx.hcount, k=k, direct=jidx.direct,
                             hsize=jidx.hsize, max_probe=jidx.max_probe)
    got = tpa.probe(torch.from_numpy(codes), torch.from_numpy(lens), tidx)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_chain_rows_match_jax_chain_rows():
    """Seed tiles of a probed chunk through both chain state machines."""
    from t1k_tpu.ops import phase_a as jpa

    rng = np.random.default_rng(17)
    seqs = _random_panel(rng)
    reads = make_reads(rng, seqs, 120)
    codes, lens = _pad(reads)
    k, hlr = 9, 23
    tidx = tpa.PhaseAIndex.build(_packed(seqs), k, device="cpu")
    contrib, cstart, tot = tpa.probe(torch.from_numpy(codes),
                                     torch.from_numpy(lens), tidx)
    a, b, nb, _, _ = tpa.expand_buckets(contrib, cstart, int(tot.sum()),
                                        tidx, hlr, 128)
    assert int(nb.max()) > 20
    budgets = torch.from_numpy(
        np.trunc(lens * 0.2).astype(np.int32) * k)
    for radius in (10, 0):
        want = jpa._chain_rows(a.numpy(), b.numpy(), nb.numpy(), lens,
                               budgets.numpy(), k=k, radius=radius,
                               hit_len_required=hlr)
        got = tpa.chain_rows_plain(a, b, nb, torch.from_numpy(lens),
                                   budgets, k=k, radius=radius,
                                   hit_len_required=hlr)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        flags = tpa.chain_rows(a, b, nb, torch.from_numpy(lens), budgets,
                               k=k, radius=radius, hit_len_required=hlr)
        assert np.array_equal(flags[0].numpy(),
                              (np.asarray(want[0]) & np.asarray(want[1]))
                              .any(axis=1))
        assert np.array_equal(flags[1].numpy(),
                              np.asarray(want[0]).any(axis=1))


def test_chain_matches_jax_chain_kernel():
    """The plain K9 (posting expansion, best bucket, compaction, chain)
    against `_chain_kernel` on one probed chunk, bucket overflow
    included."""
    from t1k_tpu.ops import phase_a as jpa

    rng = np.random.default_rng(23)
    seqs = _random_panel(rng)
    reads = make_reads(rng, seqs, 100)
    codes, lens = _pad(reads)
    k, hlr, radius = 9, 23, 10
    packed = _packed(seqs)
    jidx = jpa.PhaseAIndex.build(packed, k)
    tidx = tpa.PhaseAIndex.build(packed, k, device="cpu")
    contrib, cstart, tot = tpa.probe(torch.from_numpy(codes),
                                     torch.from_numpy(lens), tidx)
    total = int(tot.sum())
    budgets = np.trunc(lens * 0.2).astype(np.int32) * k
    for bucket_cap in (128, 8):
        jv, jd = jpa._chain_kernel(
            contrib.numpy(), cstart.numpy(), lens, budgets, jidx.post_seq,
            jidx.post_off, k=k, n_seqs=jidx.n_seqs, radius=radius,
            hit_len_required=hlr, cap=1 << 16, bucket_cap=bucket_cap)
        tv, td = tpa.chain_plain(contrib, cstart, total,
                                 torch.from_numpy(lens),
                                 torch.from_numpy(budgets), tidx,
                                 radius=radius, hit_len_required=hlr,
                                 bucket_cap=bucket_cap)
        assert np.array_equal(td.numpy(), np.asarray(jd))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert not td.all()  # bucket_cap 8 leaves reads undecided


@pytest.mark.parametrize("trial", range(4))
def test_screen_parity_random_panels(trial):
    rng = np.random.default_rng(500 + trial)
    seqs = _random_panel(rng)
    reads = make_reads(rng, seqs, 60)
    dec = check_parity(seqs, reads, k=9, hit_len=23,
                       sim=[0.8, 0.9, 0.97][trial % 3])
    assert dec.sum() > 50  # the caps decide the bulk


def test_screen_parity_skip_heuristic():
    """>=100-posting k-mers exercise the probe skip path."""
    rng = np.random.default_rng(77)
    base = rand_seq(rng, 500)
    seqs = [mutate(rng, base, 0.01).replace("N", "C") for _ in range(120)]
    reads = make_reads(rng, seqs, 50)
    check_parity(seqs, reads, k=9, hit_len=23, sim=0.8,
                 caps=dict(bucket_cap=256))


def test_screen_parity_repeats_and_hashed():
    """Tandem repeats (duplicate-b chains) and the k=13 hashed table."""
    rng = np.random.default_rng(91)
    motif = rand_seq(rng, 25)
    seqs = [rand_seq(rng, 40) + motif * int(rng.integers(3, 7))
            + rand_seq(rng, 60) + motif + rand_seq(rng, 40)
            for _ in range(10)]
    check_parity(seqs, make_reads(rng, seqs, 50), k=9, hit_len=23, sim=0.8)
    base = rand_seq(rng, 600)
    seqs13 = [mutate(rng, base, 0.02).replace("N", "G") for _ in range(15)]
    assert not tpa.PhaseAIndex.build(_packed(seqs13), 13,
                                     device="cpu").direct
    check_parity(seqs13, make_reads(rng, seqs13, 40), k=13, hit_len=23,
                 sim=0.9)


def test_screen_edge_cases():
    rng = np.random.default_rng(13)
    seqs = [rand_seq(rng, 300)]
    # reads shorter than k, exactly k, all-N, the code-0 window
    reads = ["ACGT", seqs[0][:9], "N" * 50, "A" * 9, seqs[0][10:19]]
    check_parity(seqs, reads, k=9, hit_len=9, sim=0.8)
    screen = tpa.DeviceScreen.build(_packed(seqs), 9, 9, 0.8, device="cpu")
    v, d = screen.screen(*_pad(["ACG", "TTAG"]))  # no window fits: L < k
    assert not v.any() and d.all()


def test_overflow_reads_are_flagged_undecided():
    rng = np.random.default_rng(5)
    base = rand_seq(rng, 400)
    seqs = [mutate(rng, base, 0.005).replace("N", "T") for _ in range(110)]
    reads = [mutate(rng, base[:100], 0.01) for _ in range(8)]
    caps = dict(hit_cap=256, bucket_cap=32)
    dec = check_parity(seqs, reads, k=9, hit_len=23, sim=0.8, caps=caps)
    assert not dec.any()  # tiny caps: every read overflows, none lies


def test_reads_of_4096_or_more_go_to_the_host():
    rng = np.random.default_rng(21)
    seqs = [rand_seq(rng, 800) for _ in range(3)]
    reads = [seqs[0][:100], rand_seq(rng, 4100), seqs[1][200:330],
             seqs[2] * 6]
    packed = _packed(seqs)
    screen = tpa.DeviceScreen.build(packed, 9, 23, 0.8, device="cpu",
                                    bucket_cap=128)
    codes, lens = _pad(reads)
    v, d = screen.screen(codes, lens)
    assert d.tolist() == [True, False, True, False]
    flags = _native(packed, 9, 23, 0.8, reads, lens)
    assert (v[d] == flags[d]).all() and v[d].all()


# ------------------------------------------------------------ on a card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [9, 13])
def test_cuda_kernels_match_plain(cuda_device, k):
    rng = np.random.default_rng(31 + k)
    seqs = _random_panel(rng)
    reads = make_reads(rng, seqs, 3000)
    codes, lens = _pad(reads)
    packed = _packed(seqs)
    cidx = tpa.PhaseAIndex.build(packed, k, cuda_device)
    pidx = tpa.PhaseAIndex.build(packed, k, device="cpu")
    got = tpa.probe(torch.from_numpy(codes).to(cuda_device),
                    torch.from_numpy(lens).to(cuda_device), cidx)
    want = tpa.probe(torch.from_numpy(codes), torch.from_numpy(lens), pidx)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    a, b, nb, _, _ = tpa.expand_buckets(*want[:2], int(want[2].sum()), pidx,
                                        23, 512)
    budgets = torch.from_numpy(np.trunc(lens * 0.2).astype(np.int32) * k)
    lens_t = torch.from_numpy(lens)
    for radius in (10, 0):
        kw = dict(k=k, radius=radius, hit_len_required=23)
        flags = tpa.chain_rows(*(x.to(cuda_device) for x in
                                 (a, b, nb, lens_t, budgets)), **kw)
        assert torch.equal(flags.cpu(), tpa.chain_rows(a, b, nb, lens_t,
                                                       budgets, **kw))
    caps = dict(bucket_cap=256)
    gv, gd = tpa.DeviceScreen(cidx, 23, 0.8, **caps).screen(codes, lens)
    cv, cd = tpa.DeviceScreen(pidx, 23, 0.8, **caps).screen(codes, lens)
    assert (gd == cd).all() and (gv == cv).all() and gd.sum() > 1000


def _edge_tiles(rng, B=512):
    """Seed tiles at the warp kernel's edges: rows of nb = 0, 1, 31, 32,
    33, 63, 64, 65, 128 and 512 seeds, random, clustered on a few
    diagonals, or tandem-repeat chains, plus rows whose seeds all share
    one diagonal."""
    rows = []
    for nb in (0, 1, 31, 32, 33, 63, 64, 65, 128, 512):
        for kind in range(4):
            a = np.sort(rng.choice(4000, nb, replace=False))
            if kind == 0:
                b = rng.integers(0, 1 << 20, nb)
            elif kind == 1:
                diag = rng.integers(-3000, 3000, 3)[rng.integers(0, 3, nb)]
                b = a + 5000 + diag + rng.integers(-4, 5, nb)
            elif kind == 2:
                b = a + 700 + 25 * rng.integers(0, 3, nb)
            else:
                b = a + 1234
            rows.append((a, np.maximum(b, 0)))
    NR = len(rows)
    at = np.zeros((NR, B), np.int32)
    bt = np.zeros((NR, B), np.int32)
    nb = np.zeros(NR, np.int32)
    for r, (a, b) in enumerate(rows):
        perm = rng.permutation(len(a))  # tiles arrive in any order
        at[r, :len(a)], bt[r, :len(a)], nb[r] = a[perm], b[perm], len(a)
    lens = rng.integers(100, 4096, NR).astype(np.int32)
    budgets = rng.integers(0, 600, NR).astype(np.int32)
    return [torch.from_numpy(x) for x in (at, bt, nb, lens, budgets)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [9, 13])
def test_cuda_chain_matches_plain_at_edge_widths(cuda_device, k):
    tiles = _edge_tiles(np.random.default_rng(k))
    for radius in (10, 0):
        for hlr in (23, 60):
            kw = dict(k=k, radius=radius, hit_len_required=hlr)
            want = tpa.chain_rows(*tiles, **kw)
            got = tpa.chain_rows(*(x.to(cuda_device) for x in tiles), **kw)
            assert torch.equal(got.cpu(), want), kw
            assert want[1].any() and not want[1].all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 13])
def test_cuda_probe_matches_plain_at_edge_lengths(cuda_device, k):
    rng = np.random.default_rng(40 + k)
    base = rand_seq(rng, 4600)
    seqs = [mutate(rng, base, 0.01).replace("N", "A") for _ in range(6)]
    packed = _packed(seqs)
    cidx = tpa.PhaseAIndex.build(packed, k, cuda_device)
    pidx = tpa.PhaseAIndex.build(packed, k, device="cpu")
    assert cidx.direct == (k <= 12)
    for L in (13, 44, 45, 76, 100, 150, tpa.MAX_READ_LEN - 1):
        reads = []
        for i in range(24):
            st = int(rng.integers(0, len(base) - L + 1))
            r = mutate(rng, seqs[i % 6][st:st + L], 0.02)
            reads.append(revcomp(r) if i % 3 == 0 else
                         r[:int(rng.integers(k, L + 1))] if i % 3 == 1 else r)
        codes, lens = _pad(reads)
        got = tpa.probe(torch.from_numpy(codes).to(cuda_device),
                        torch.from_numpy(lens).to(cuda_device), cidx)
        want = tpa.probe(torch.from_numpy(codes), torch.from_numpy(lens),
                         pidx)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), L
        assert int(want[2].sum()) > 0
