"""The port's candidate pruning for the genotyper (DeviceCandidates, K10,
in t1k_tpu_torch/ops/phase_a.py; the engine's set_candidates and
overlap_buckets bindings; --deviceCandidates) against the JAX package's
DeviceCandidates, the native engine's overlap-bucket oracle and the JAX
package's native genotyper.

Integer programs: every comparison is exact.  The chain's plain version
runs here on the CPU; the `cuda` tests hold the card's route against it.
The seeded panels and reads follow tests/test_phase_a.py, with the same
caps, so the JAX side compiles the same variants.  The JAX package is
imported inside the tests that use it, so the `cuda` tests also collect
where jax is absent."""

import json
import os

import numpy as np
import pytest
import torch

from t1k_tpu_torch.constants import encode_seq
from t1k_tpu_torch.io.refset import RefSet
from t1k_tpu_torch.native import NativeEngine
from t1k_tpu_torch.ops import phase_a as tpa

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "data")
MULTIGENE = (os.path.join(DATA_DIR, "multigene_rna.fa"),
             os.path.join(DATA_DIR, "multigene_1.fq"),
             os.path.join(DATA_DIR, "multigene_2.fq"))
GENOTYPE_OUTPUTS = ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                    "_aligned_2.fa", "_assign.tsv")
BASES = "ACGT"



@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread each, so that the suite's test processes running side by side
    do not wait on each other's thread pools."""
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


def random_panel(rng):
    """tests/test_phase_a.py's random panel: a base and its 3%-mutated
    copies, with unrelated sequences among them."""
    base = rand_seq(rng, int(rng.integers(300, 700)))
    seqs = []
    for _ in range(int(rng.integers(3, 25))):
        if rng.random() < 0.7:
            seqs.append(mutate(rng, base, 0.03).replace("N", "A"))
        else:
            seqs.append(rand_seq(rng, int(rng.integers(200, 600))))
    return seqs


def near_identical_panel(rng):
    """The genotyper's regime: 40 alleles 1% apart."""
    base = rand_seq(rng, 900)
    return [mutate(rng, base, 0.01).replace("N", "G") for _ in range(40)]


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


def oracle_check(packed, k, hit_len, reads, out) -> int:
    """Every decided read's keep set equals the engine's overlap buckets;
    returns the decided reads."""
    reads_k, seqs_k, strands_k, undecided = out
    codes, lens = _pad(reads)
    eng = NativeEngine(packed, k, hit_len_required=hit_len)
    starts = np.zeros(len(reads), np.int64)
    starts[1:] = np.cumsum(lens[:-1].astype(np.int64))
    off, oseqs, ostrands = eng.overlap_buckets(
        np.concatenate([encode_seq(r) for r in reads]), starts, lens)
    for i in np.nonzero(~undecided)[0]:
        m = reads_k == i
        got = set(zip(seqs_k[m].tolist(), strands_k[m].tolist()))
        want = set(zip(oseqs[off[i]:off[i + 1]].tolist(),
                       ostrands[off[i]:off[i + 1]].tolist()))
        assert got == want, f"read {i} ({reads[i]!r})"
    return int((~undecided).sum())


def check_generate(seqs, reads, k, hit_len, caps):
    """The plain port's generate == the JAX package's, array for array and
    element for element, and == the engine's oracle on every decided
    read.  Returns the decided reads."""
    from t1k_tpu.ops import phase_a as jpa

    packed = _packed(seqs)
    codes, lens = _pad(reads)
    want = jpa.DeviceCandidates.build(packed, k, hit_len, **caps).generate(
        codes, lens)
    dc = tpa.DeviceCandidates.build(packed, k, hit_len, device="cpu", **caps)
    got = dc.generate(codes, lens)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert dc.screened == len(reads)
    assert dc.decided == int((~got[3]).sum()) and dc.kept == len(got[0])
    assert sum(c["kept"] for c in dc.chunks) == len(got[0])
    return oracle_check(packed, k, hit_len, reads, got)


@pytest.mark.parametrize("trial", range(3))
def test_generate_matches_jax_on_random_panels(trial):
    rng = np.random.default_rng(900 + trial)
    seqs = random_panel(rng)
    reads = make_reads(rng, seqs, 40)
    assert check_generate(seqs, reads, 9, 23, dict(bucket_cap=128)) > 25


def test_generate_matches_jax_on_a_near_identical_panel():
    """Nearly every bucket survives; the keep set must still be exact."""
    rng = np.random.default_rng(41)
    seqs = near_identical_panel(rng)
    reads = make_reads(rng, seqs, 40)
    assert check_generate(seqs, reads, 11, 31, dict(bucket_cap=256)) > 20


def test_generate_does_not_depend_on_chunks_or_tiles():
    """Chunks of 7 reads keep the same buckets, in the same order, as one
    chunk (the chain takes every bucket of a chunk at once: there are no
    tiles), and each chunk's figures add up."""
    rng = np.random.default_rng(41)
    seqs = near_identical_panel(rng)
    reads = make_reads(rng, seqs, 40)
    packed = _packed(seqs)
    codes, lens = _pad(reads)
    whole = tpa.DeviceCandidates.build(packed, 11, 31, device="cpu",
                                       bucket_cap=256)
    one = whole.generate(codes, lens)
    dc = tpa.DeviceCandidates.build(packed, 11, 31, device="cpu",
                                    bucket_cap=256, row_chunk=7)
    many = dc.generate(codes, lens)
    for a, b in zip(one, many):
        assert np.array_equal(a, b)
    assert len(dc.chunks) == 6 and len(whole.chunks) == 1
    assert sum(c["buckets"] for c in dc.chunks) \
        == whole.chunks[0]["buckets"] > len(one[0])
    assert sum(c["kept"] for c in dc.chunks) == len(one[0])
    assert len(one[0]) > 100 and not one[3].any()


def test_census_and_tile_match_the_jax_programs():
    """cand_census and cand_tile against `_cand_census_kernel` and
    `_cand_tile_kernel` on one probed chunk: bucket ids, ranks and the
    bucket count equal; each bucket's keys and seeds equal as a set; keep,
    read, lkey, nb and over per bucket equal, bucket overflow included."""
    from t1k_tpu.ops import phase_a as jpa

    rng = np.random.default_rng(23)
    seqs = random_panel(rng)
    reads = make_reads(rng, seqs, 100)
    codes, lens = _pad(reads)
    k, hlr, radius = 9, 23, 10
    packed = _packed(seqs)
    jidx = jpa.PhaseAIndex.build(packed, k)
    tidx = tpa.PhaseAIndex.build(packed, k, device="cpu")
    contrib, cstart, tot = tpa.probe(torch.from_numpy(codes),
                                     torch.from_numpy(lens), tidx)
    total = int(tot.sum())
    cen = tpa.cand_census(contrib, cstart, total, tidx)
    gk_s, a_s, b_s, bid, within, nb_total = (
        np.asarray(x) for x in jpa._cand_census_kernel(
            contrib.numpy(), cstart.numpy(), jidx.post_seq, jidx.post_off,
            n_seqs=jidx.n_seqs, cap=1 << 16))
    nb = int(cen.nb_total)
    assert nb == int(nb_total) > 100
    assert np.array_equal(cen.gk.numpy(), gk_s[:total])
    assert np.array_equal(cen.bid.numpy(), bid[:total])
    assert np.array_equal(cen.within.numpy(), within[:total])
    # the order inside a bucket is free: compare each bucket's seeds sorted
    order = np.lexsort((cen.b.numpy(), cen.a.numpy(), cen.gk.numpy()))
    jorder = np.lexsort((b_s[:total], a_s[:total], gk_s[:total]))
    assert np.array_equal(cen.a.numpy()[order], a_s[:total][jorder])
    assert np.array_equal(cen.b.numpy()[order], b_s[:total][jorder])
    for bucket_cap in (128, 8):
        want = jpa._cand_tile_kernel(
            gk_s, a_s, b_s, bid, within, lens, np.int32(0), TR=nb + 3,
            B=bucket_cap, k=k, n_seqs=jidx.n_seqs, radius=radius,
            hit_len_required=hlr)
        keep = tpa.cand_tile(cen, torch.from_numpy(lens), torch.arange(nb),
                             k=k, n_seqs=tidx.n_seqs, radius=radius,
                             hit_len_required=hlr, bucket_cap=bucket_cap)
        # read, lkey, nb and over per bucket follow from the census, as
        # DeviceCandidates.chunk takes them
        cnt = cen.count[:nb]
        gk = cen.gk[cen.first[:nb]]
        got = (keep, gk // (2 * tidx.n_seqs), gk % (2 * tidx.n_seqs),
               torch.clamp(cnt, max=bucket_cap), cnt > bucket_cap)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)[:nb])
        assert not np.asarray(want[0])[nb:].any()
    assert got[4].any() and got[0].any()   # bucket_cap 8 overflows some


def _panel(kind, seed):
    """(seqs, reads, k, hit_len) of a seeded random panel (k = 9) or of
    the near-identical panel (the genotyper's k = 11, hitLen 31)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        seqs = random_panel(rng)
        return seqs, make_reads(rng, seqs, 60), 9, 23
    seqs = near_identical_panel(rng)
    return seqs, make_reads(rng, seqs, 60), 11, 31


def _probed(seqs, reads, k, device="cpu"):
    """The panel's index and one probed chunk of the reads on `device`:
    (packed, index, contrib, cstart, total, lens)."""
    packed = _packed(seqs)
    codes, lens = _pad(reads)
    idx = tpa.PhaseAIndex.build(packed, k, device=device)
    lens_d = torch.from_numpy(lens).to(device)
    contrib, cstart, tot = tpa.probe(torch.from_numpy(codes).to(device),
                                     lens_d, idx)
    return packed, idx, contrib, cstart, int(tot.sum()), lens_d


def _census_arrays(cen):
    """A BucketCensus on the host: nb, then key, first and count of its
    buckets, then each bucket's seeds sorted (bucket, a, b), for a
    comparison in which the order inside a bucket is free."""
    nb = int(cen.nb_total)
    key, first, count = (getattr(cen, n)[:nb].cpu().numpy()
                         for n in ("key", "first", "count"))
    assert np.array_equal(first, np.cumsum(count) - count)
    assert count.sum() == len(cen.a) and (count > 0).all()
    bucket = np.repeat(np.arange(nb), count)
    a, b = cen.a.cpu().numpy(), cen.b.cpu().numpy()
    order = np.lexsort((b, a, bucket))
    return nb, key, first, count, a[order], b[order]


@pytest.mark.parametrize("kind,seed", [("random", 900), ("random", 901),
                                       ("random", 902),
                                       ("near_identical", 41)])
def test_bucket_census_matches_cand_census_and_jax(kind, seed):
    """The plain bucket_census (keys, first slots, counts, nb_total)
    equals the projection of cand_census and of the JAX package's
    `_cand_census_kernel`, exactly; each bucket's seeds equal the JAX
    program's as a multiset."""
    from t1k_tpu.ops import phase_a as jpa

    seqs, reads, k, _ = _panel(kind, seed)
    packed, idx, contrib, cstart, total, _ = _probed(seqs, reads, k)
    got = tpa.bucket_census(contrib, cstart, total, idx)
    assert all(getattr(got, n).dtype == torch.int32 for n in (
        "a", "b", "key", "first", "count", "nb_total"))
    nb, key, first, count, a, b = _census_arrays(got)
    cen = tpa.cand_census(contrib, cstart, total, idx)
    assert nb == int(cen.nb_total) > 50
    assert np.array_equal(first, cen.first[:nb].numpy())
    assert np.array_equal(count, cen.count[:nb].numpy())
    assert np.array_equal(key, cen.gk[cen.first[:nb]].numpy())
    jidx = jpa.PhaseAIndex.build(packed, k)
    gk_s, a_s, b_s, bid, within, jnb = (
        np.asarray(x) for x in jpa._cand_census_kernel(
            contrib.numpy(), cstart.numpy(), jidx.post_seq, jidx.post_off,
            n_seqs=jidx.n_seqs, cap=1 << max(16, total.bit_length())))
    jfirst = np.nonzero(within[:total] == 0)[0]
    assert int(jnb) == nb == len(jfirst)
    assert np.array_equal(first, jfirst)
    assert np.array_equal(key, gk_s[jfirst])
    assert np.array_equal(count, np.bincount(bid[:total], minlength=nb))
    order = np.lexsort((b_s[:total], a_s[:total], bid[:total]))
    assert np.array_equal(a, a_s[:total][order])
    assert np.array_equal(b, b_s[:total][order])


@pytest.mark.parametrize("bucket_cap", [128, 8])
def test_chain_buckets_matches_cand_tile(bucket_cap):
    """The plain chain_buckets over every bucket gives the keep set of
    cand_tile over the chained buckets and the over-count per read that
    DeviceCandidates took from cand_census (buckets past bucket_cap)."""
    rng = np.random.default_rng(23)
    seqs = random_panel(rng)
    reads = make_reads(rng, seqs, 100)
    k, hlr = 9, 23
    _, idx, contrib, cstart, total, lens = _probed(seqs, reads, k)
    kw = dict(k=k, n_seqs=idx.n_seqs, radius=10, hit_len_required=hlr,
              bucket_cap=bucket_cap)
    keep, over = tpa.chain_buckets(
        tpa.bucket_census(contrib, cstart, total, idx), lens, **kw)
    cen = tpa.cand_census(contrib, cstart, total, idx)
    rows = torch.nonzero((cen.count >= tpa.min_chain_seeds(k, hlr))
                         & (cen.count <= bucket_cap))[:, 0]
    want = torch.zeros(total, dtype=torch.int32)
    want[rows] = tpa.cand_tile(cen, lens, rows, **kw).int()
    want_over = torch.zeros(len(reads), dtype=torch.int32).scatter_add_(
        0, cen.gk[cen.first] // (2 * idx.n_seqs),
        (cen.count > bucket_cap).int())
    assert keep.dtype == over.dtype == torch.int32
    assert torch.equal(keep, want) and torch.equal(over, want_over)
    assert keep.any() and (over.any() if bucket_cap == 8 else
                           not over.any())


def test_chain_verdicts_do_not_depend_on_seed_order():
    """A seeded permutation of the seeds inside every bucket (the freedom
    the census kernel's atomics take) leaves every keep verdict and every
    over-count unchanged."""
    import dataclasses

    seqs, reads, k, hlr = _panel("near_identical", 7)
    _, idx, contrib, cstart, total, lens = _probed(seqs, reads, k)
    cen = tpa.bucket_census(contrib, cstart, total, idx)
    nb, *_ = _census_arrays(cen)
    bucket = np.repeat(np.arange(nb), cen.count[:nb].numpy())
    perm = torch.from_numpy(np.lexsort(
        (np.random.default_rng(5).random(total), bucket)))
    assert (perm != torch.arange(total)).sum() > total // 2
    shuffled = dataclasses.replace(cen, a=cen.a[perm], b=cen.b[perm])
    for bucket_cap in (128, 32):
        kw = dict(k=k, n_seqs=idx.n_seqs, radius=10, hit_len_required=hlr,
                  bucket_cap=bucket_cap)
        keep, over = tpa.chain_buckets(cen, lens, **kw)
        keep_s, over_s = tpa.chain_buckets(shuffled, lens, **kw)
        assert torch.equal(keep, keep_s) and torch.equal(over, over_s)
        assert keep.sum() > 100


def test_tiny_caps_leave_every_read_undecided():
    """A hit cap below every chunk's total, or a bucket cap below every
    kept bucket: every read undecided and no bucket left, as in JAX."""
    from t1k_tpu.ops import phase_a as jpa

    rng = np.random.default_rng(5)
    base = rand_seq(rng, 400)
    seqs = [mutate(rng, base, 0.005).replace("N", "T") for _ in range(110)]
    reads = [mutate(rng, base[:100], 0.01) for _ in range(8)]
    packed = _packed(seqs)
    codes, lens = _pad(reads)
    for caps in (dict(hit_cap=256, bucket_cap=32),
                 dict(bucket_cap=2, row_chunk=4)):
        want = jpa.DeviceCandidates.build(packed, 9, 23, **caps).generate(
            codes, lens)
        got = tpa.DeviceCandidates.build(packed, 9, 23, device="cpu",
                                         **caps).generate(codes, lens)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[3].all() and len(got[0]) == 0


@pytest.mark.parametrize("L", [4096, 8])
def test_reads_outside_the_length_envelope_are_undecided(L):
    """A batch padded to 4,096 bases or more, or narrower than k: every
    read undecided, as the JAX generate leaves them."""
    from t1k_tpu.ops import phase_a as jpa

    rng = np.random.default_rng(3)
    seqs = random_panel(rng)
    reads = make_reads(rng, seqs, 6)
    codes = np.full((len(reads), L), 4, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = encode_seq(r)[:L]
        codes[i, :len(c)] = c
        lens[i] = len(c)
    packed = _packed(seqs)
    want = jpa.DeviceCandidates.build(packed, 9, 23).generate(codes, lens)
    dc = tpa.DeviceCandidates.build(packed, 9, 23, device="cpu")
    got = dc.generate(codes, lens)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3].all() and dc.decided == 0 and dc.screened == len(reads)


def _captured_words(monkeypatch, lib, engine, *args):
    """The (has, bits, words) an engine's set_candidates hands its C
    library."""
    seen = {}

    def fake(handle, n_reads, has, bits, words):
        seen.update(has=np.array(has), bits=np.array(bits), words=words)

    monkeypatch.setattr(lib, "t1k_set_candidates", fake)
    engine.set_candidates(*args)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("shuffle", [False, True])
def test_set_candidates_words_equal_the_jax_binding(monkeypatch, shuffle):
    """The vectorised bit words equal np.bitwise_or.at's, for generate's
    sorted output and for shuffled input with repeated buckets; bits
    past 64 buckets a read included."""
    from t1k_tpu import native as jnative
    from t1k_tpu.io.refset import RefSet as HostRefSet

    from t1k_tpu_torch import native as tnative

    rng = np.random.default_rng(11)
    seqs = [rand_seq(rng, 200) for _ in range(70)]
    host = HostRefSet(digit_units=-1, delimiter="")
    for i, s in enumerate(seqs):
        host.add_allele(f"G{i % 3}*{i:03d}", s, None)
    n_reads = 50
    reads = np.sort(rng.integers(0, n_reads, 3000))
    cseqs = rng.integers(0, 70, 3000).astype(np.int32)
    strands = np.where(rng.random(3000) < 0.5, 1, -1).astype(np.int8)
    undecided = rng.random(n_reads) < 0.2
    if shuffle:
        p = rng.permutation(3000)
        reads, cseqs, strands = reads[p], cseqs[p], strands[p]
    else:
        # generate's order: (read, strand -1 then +1, seq), no repeats
        key = reads * 1000 + (strands == 1) * 100 + cseqs
        _, first = np.unique(key, return_index=True)
        reads, cseqs, strands = reads[first], cseqs[first], strands[first]
    args = (n_reads, reads, cseqs, strands, undecided)
    want = _captured_words(monkeypatch, jnative._lib,
                           jnative.NativeEngine(host.packed(), 11), *args)
    got = _captured_words(monkeypatch, tnative._lib,
                          NativeEngine(_packed(seqs), 11), *args)
    assert got["words"] == want["words"] == 3
    assert np.array_equal(got["has"], want["has"])
    assert got["bits"].dtype == np.uint64
    assert np.array_equal(got["bits"], want["bits"])
    assert (want["bits"] >> np.uint64(63)).any()


def _genotype_port(prefix, *flags):
    from t1k_tpu_torch.cli.genotype import main

    ref, fq1, fq2 = MULTIGENE
    assert main(["-f", ref, "-1", fq1, "-2", fq2, "-o", prefix,
                 "--outputReadAssignment", *flags]) == 0


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_genotype_cli_with_device_candidates_on_the_cpu(tmp_path):
    """cli.genotype --deviceCandidates --device cpu on the multigene data:
    every output, _assign.tsv included, byte-identical to the JAX
    package's native route and to an unpruned port run (the host engine);
    the device decided reads and kept buckets (the stage's metrics)."""
    from t1k_tpu.cli.genotype import main as host_main

    ref, fq1, fq2 = MULTIGENE
    native = str(tmp_path / "native")
    assert host_main(["-f", ref, "-1", fq1, "-2", fq2, "-o", native,
                      "--outputReadAssignment", "--backend", "native",
                      "--emBackend", "native"]) == 0
    pruned = str(tmp_path / "pruned")
    plain = str(tmp_path / "plain")
    _genotype_port(pruned, "--device", "cpu", "--deviceCandidates")
    _genotype_port(plain, "--backend", "native", "--emBackend", "native")
    for suffix in GENOTYPE_OUTPUTS:
        assert _read(pruned + suffix) == _read(native + suffix), suffix
        assert _read(pruned + suffix) == _read(plain + suffix), suffix
    with open(pruned + "_metrics.json") as f:
        ra = json.load(f)["read_assignment"]
    assert 0 < ra["device_decided_reads"] <= ra["unique_read_count"]
    assert ra["candidate_count"] > 0 and ra["candidate_seconds"] > 0
    with open(plain + "_metrics.json") as f:
        assert "candidate_count" not in json.load(f)["read_assignment"]


def test_deferred_chunks_prune_each_read_with_its_own_buckets(tmp_path):
    """The gpu backend's deferred DP in chunks of 100 unique reads: each
    chunk's begin pass finds its reads' buckets at the chunk's base, so
    the pruned outputs equal the host engine's unpruned ones (the JAX
    package's binding sets the base only before each finish, so its
    second and later chunks read another chunk's buckets)."""
    from t1k_tpu_torch.core.pipeline import GenotypeOptions, run_genotyper

    ref, fq1, fq2 = MULTIGENE
    out = {}
    for name, prune, backend in (("pruned", True, "gpu"),
                                 ("plain", False, "native")):
        out[name] = str(tmp_path / name)
        run_genotyper(ref, [fq1], [fq2], out[name], GenotypeOptions(
            backend=backend, em_backend="native", device="cpu",
            defer_chunk=100, output_read_assignment=True,
            device_candidates=prune))
    for suffix in GENOTYPE_OUTPUTS:
        assert _read(out["pruned"] + suffix) == _read(out["plain"] + suffix)
    with open(out["pruned"] + "_metrics.json") as f:
        ra = json.load(f)["read_assignment"]
    assert ra["unique_read_count"] > 1000 and ra["device_decided_reads"] > 0


def test_run_cli_with_device_candidates_on_the_cpu(tmp_path):
    """cli.run --deviceCandidates --device cpu (the host engine for the
    rest of the chain): the same chain outputs as without the flag."""
    from t1k_tpu_torch.cli.run import main

    ref, fq1, fq2 = MULTIGENE
    outs = {}
    for name, flags in (("pruned", ["--deviceCandidates"]), ("plain", [])):
        assert main(["-f", ref, "-1", fq1, "-2", fq2, "--od",
                     str(tmp_path / name), "-o", "s", "--device", "cpu",
                     "--backend", "native", "--emBackend", "native",
                     *flags]) == 0
        outs[name] = str(tmp_path / name / "s")
    for suffix in ("_candidate_1.fq", "_candidate_2.fq", "_genotype.tsv",
                   "_allele.tsv", "_aligned_1.fa", "_aligned_2.fa",
                   "_allele.vcf"):
        assert _read(outs["pruned"] + suffix) == _read(
            outs["plain"] + suffix), suffix
    with open(outs["pruned"] + "_metrics.json") as f:
        assert json.load(f)["read_assignment"]["candidate_count"] > 0


@pytest.mark.parametrize("cli", ["genotype", "run"])
def test_device_candidates_without_a_card_exit_2(tmp_path, monkeypatch,
                                                 capsys, cli):
    """Without a card the flag fails like every card route, even with the
    host engine for the rest: exit 2, naming --device cpu, no output."""
    import importlib

    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"t1k_tpu_torch.cli.{cli}").main
    ref, fq1, fq2 = MULTIGENE
    out = str(tmp_path / "o")
    where = ["-o", out] if cli == "genotype" else ["--od", out, "-o", "s"]
    with pytest.raises(SystemExit) as exc:
        main(["-f", ref, "-1", fq1, "-2", fq2, *where, "--backend",
              "native", "--emBackend", "native", "--deviceCandidates"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "--device cpu" in err
    assert not [p for p in os.listdir(tmp_path)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [dict(bucket_cap=128),
                                  dict(bucket_cap=256, row_chunk=7),
                                  dict(hit_cap=256, bucket_cap=32)])
def test_cuda_generate_matches_plain(cuda_device, caps):
    """The card's route (probe, census and bucket chain kernels) equals
    the plain version on the CPU, array for array, and the engine's
    oracle on every decided read; the census and chain kernels launched,
    and the host waited once a chunk and twice at the end."""
    rng = np.random.default_rng(77)
    seqs = near_identical_panel(rng) + random_panel(rng)
    reads = make_reads(rng, seqs, 400)
    packed = _packed(seqs)
    codes, lens = _pad(reads)
    census0 = tpa.launch_counts["cand_census"]
    chain0 = tpa.launch_counts["cand_chain"]
    dc = tpa.DeviceCandidates.build(packed, 11, 31, device=cuda_device,
                                    **caps)
    got = dc.generate(codes, lens)
    want = tpa.DeviceCandidates.build(packed, 11, 31, device="cpu",
                                      **caps).generate(codes, lens)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    oracle_check(packed, 11, 31, reads, got)
    assert dc.waits == len(dc.chunks) + 2
    if not got[3].all():
        assert tpa.launch_counts["cand_census"] > census0
        assert tpa.launch_counts["cand_chain"] > chain0


@pytest.mark.cuda
def test_cuda_census_and_tile_match_plain(cuda_device):
    """cand_census on the card equals it on the CPU (keys, ids, ranks,
    counts; seeds per bucket as a set) and cand_tile's chain kernel
    equals the plain chain per bucket."""
    rng = np.random.default_rng(23)
    seqs = near_identical_panel(rng)
    reads = make_reads(rng, seqs, 300)
    codes, lens = _pad(reads)
    packed = _packed(seqs)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        idx = tpa.PhaseAIndex.build(packed, 11, device=dev)
        lens_d = torch.from_numpy(lens).to(dev)
        contrib, cstart, tot = tpa.probe(torch.from_numpy(codes).to(dev),
                                         lens_d, idx)
        cen = tpa.cand_census(contrib, cstart, int(tot.sum()), idx)
        rows = torch.arange(int(cen.nb_total), device=dev)
        tile = tpa.cand_tile(cen, lens_d, rows, k=11, n_seqs=idx.n_seqs,
                             radius=10, hit_len_required=31, bucket_cap=128)
        order = np.lexsort((cen.b.cpu().numpy(), cen.a.cpu().numpy(),
                            cen.gk.cpu().numpy()))
        out[dev.type] = ([x.cpu().numpy() for x in (
            cen.gk, cen.bid, cen.within, cen.first, cen.count)]
            + [cen.a.cpu().numpy()[order], cen.b.cpu().numpy()[order]]
            + [tile.cpu().numpy()])
    for g, w in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(g, w)
    assert out["cpu"][-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bins_per_pass", [None, 37])
def test_cuda_bucket_census_matches_plain(cuda_device, bins_per_pass):
    """csrc/cand_census.cu against the plain census on the CPU: nb_total,
    every bucket's key, first slot and count exactly, each bucket's seeds
    as a multiset; at the default keys per pass and at 37 (four slices of
    the panel's 128 keys, one not a multiple of 32)."""
    rng = np.random.default_rng(23)
    seqs = near_identical_panel(rng) + random_panel(rng)
    reads = make_reads(rng, seqs, 300)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        _, idx, contrib, cstart, total, _ = _probed(seqs, reads, 11, dev)
        launches = tpa.launch_counts["cand_census"]
        cen = tpa.bucket_census(contrib, cstart, total, idx,
                                bins_per_pass=bins_per_pass)
        assert tpa.launch_counts["cand_census"] == launches + (
            dev.type == "cuda")
        out[dev.type] = _census_arrays(cen)
    assert 2 * idx.n_seqs == 128 and out["cpu"][0] > 1000
    for g, w in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_cap", [128, 8])
def test_cuda_chain_buckets_matches_plain(cuda_device, bucket_cap):
    """The bucket-ragged entry of csrc/phase_a_chain.cu on the card's
    census against the plain chain on the same census on the CPU: keep
    per bucket and the over-counts per read, exactly."""
    import dataclasses

    rng = np.random.default_rng(31)
    seqs = near_identical_panel(rng) + random_panel(rng)
    reads = make_reads(rng, seqs, 300)
    _, idx, contrib, cstart, total, lens = _probed(seqs, reads, 11,
                                                   cuda_device)
    cen = tpa.bucket_census(contrib, cstart, total, idx)
    kw = dict(k=11, n_seqs=idx.n_seqs, radius=10, hit_len_required=31,
              bucket_cap=bucket_cap)
    launches = tpa.launch_counts["cand_chain"]
    keep, over = tpa.chain_buckets(cen, lens, **kw)
    assert tpa.launch_counts["cand_chain"] == launches + 1
    host = dataclasses.replace(cen, **{f.name: getattr(cen, f.name).cpu()
                                       for f in dataclasses.fields(cen)})
    want_keep, want_over = tpa.chain_buckets(host, lens.cpu(), **kw)
    assert torch.equal(keep.cpu(), want_keep)
    assert torch.equal(over.cpu(), want_over)
    assert want_keep.any() and (want_over.any() if bucket_cap == 8 else
                                not want_over.any())
