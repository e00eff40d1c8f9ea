"""The run-t1k chain on genomic (dna-mode) references under the WGS and
WES presets: the JAX package's native route (t1k_tpu.cli.run --backend
native --emBackend native), the port's native route and the port's gpu
routes on the CPU (--backend gpu --emBackend gpu --device cpu: the
kernels' plain versions) write the same bytes.

The references are the committed dna-mode fastas (exon coordinates in
each header, introns between them; synth_pad_dna.fa holds exon-only
partial records).  Reads are simulated from a donor copy of one allele
with three exonic substitutions, a second allele of the same gene and an
allele of the other gene, so they cross exon-intron junctions and the
analyzer calls variants; random pairs ride along for the screen.  Three
configurations: --preset kir-wgs -t 4 on paired input, --preset hla-wgs
on the mate-1 reads alone (-u), --preset kir-wes on an interleaved file
(-i).  Checks that they do not pass vacuously: kir-wgs writes other
bytes than -s 0.9 without --relaxIntronAlign, and the engine's relaxed
match counts leave its match counts under --relaxIntronAlign.  The
reference's exon mask and inferred k, and the extraction screen at
k = 14 (hashed table), hit length 23 and similarity 0.97 (the hla-wgs
extractor), against the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

from t1k_tpu.cli.run import main as host_main
from t1k_tpu.io.reads import SeqRecord, read_seq_file, write_fastq
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs
from t1k_tpu_torch.cli.run import main

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
REFS = ("synth_dna.fa", "synth_pad_dna.fa")
NATIVE = ["--backend", "native", "--emBackend", "native"]
ROUTES = {"port_native": NATIVE,
          "port_cpu": ["--backend", "gpu", "--emBackend", "gpu", "--device",
                       "cpu"]}
N_PAIRS, N_RANDOM = 300, 60
# configuration -> (run-t1k flags, input kind)
CONFIGS = {"kir-wgs": (["--preset", "kir-wgs", "-t", "4"], "paired"),
           "hla-wgs": (["--preset", "hla-wgs"], "single"),
           "kir-wes": (["--preset", "kir-wes"], "interleaved")}
PAIRED_OUTPUTS = ("_candidate_1.fq", "_candidate_2.fq", "_genotype.tsv",
                  "_allele.tsv", "_aligned_1.fa", "_aligned_2.fa",
                  "_allele.vcf")
SINGLE_OUTPUTS = ("_candidate.fq", "_genotype.tsv", "_allele.tsv",
                  "_aligned.fa", "_allele.vcf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _exons(comment):
    """[(start, end)] of a dna-mode header ("n s1 e1 s2 e2 ...")."""
    nums = [int(x) for x in comment.split()]
    return list(zip(nums[1::2], nums[2::2]))


def _simulate(ref, work):
    """Paired, single-end and interleaved inputs of one reference: a donor
    copy of the first allele with a substitution in the middle of each of
    its first three exons (or fewer), its gene's third allele and the
    other gene's second, then N_RANDOM random pairs (seeds 11 and 3)."""
    recs = list(read_seq_file(os.path.join(GOLDEN, ref)))
    first = recs[0]
    seq = list(first.seq)
    for start, end in _exons(first.comment)[:3]:
        p = (start + end) // 2
        seq[p] = "ACGT"[("ACGT".index(seq[p]) + 1) % 4]
    gene = first.id.split("*")[0]
    same = [r for r in recs if r.id.split("*")[0] == gene]
    other = [r for r in recs if r.id.split("*")[0] != gene]
    donors = [SeqRecord(first.id + "snp", "".join(seq), first.comment),
              same[2], other[1]]
    r1, r2 = simulate_pairs(donors, [1.0, 0.6, 1.0],
                            SimConfig(n_pairs=N_PAIRS, seed=11,
                                      error_rate=0.004))
    rng = np.random.default_rng(3)
    for i in range(N_RANDOM):
        a, b = ("".join("ACGT"[j] for j in rng.integers(0, 4, 100))
                for _ in range(2))
        r1.append(SeqRecord(f"rnd{i}", a, "I" * 100))
        r2.append(SeqRecord(f"rnd{i}", b, "I" * 100))
    fq1, fq2, il = (str(work / n) for n in ("r_1.fq", "r_2.fq", "r_il.fq"))
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)
    write_fastq(il, [r for pair in zip(r1, r2) for r in pair])
    return {"paired": ["-1", fq1, "-2", fq2], "single": ["-u", fq1],
            "interleaved": ["-i", il]}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """ref -> its three inputs' run-t1k flags."""
    return {ref: _simulate(ref, tmp_path_factory.mktemp(ref.split(".")[0]))
            for ref in REFS}


def _args(inputs, ref, flags, kind, outdir):
    return ["-f", os.path.join(GOLDEN, ref), *inputs[ref][kind],
            *flags, "--od", str(outdir), "-o", "w"]


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_routes_write_the_same_bytes(inputs, tmp_path, ref, config):
    flags, kind = CONFIGS[config]
    assert host_main([*_args(inputs, ref, flags, kind, tmp_path / "jax"),
                      *NATIVE]) == 0
    for route, route_flags in ROUTES.items():
        assert main([*_args(inputs, ref, flags, kind, tmp_path / route),
                     *route_flags]) == 0
    outputs = SINGLE_OUTPUTS if kind == "single" else PAIRED_OUTPUTS
    names = {d: sorted(n for n in os.listdir(tmp_path / d)
                       if not n.endswith(".json"))
             for d in ("jax", *ROUTES)}
    assert names["port_native"] == names["jax"] == names["port_cpu"]
    assert {"w" + s for s in outputs} <= set(names["jax"])
    for name in names["jax"]:
        want = _read(tmp_path / "jax" / name)
        for route in ROUTES:
            assert _read(tmp_path / route / name) == want, (route, name)
    assert _read(tmp_path / "jax" / "w_allele.vcf"), "no variant called"
    # the plain band kernel scored the deferred windows of both stages
    geno = json.loads(_read(tmp_path / "port_cpu" / "w_metrics.json"))
    ana = json.loads(_read(tmp_path / "port_cpu" /
                           "w_analyzer_metrics.json"))
    assert geno["read_assignment"]["deferred_item_count"] > 0
    assert ana["analyzer_read_assignment"]["deferred_item_count"] > 0


@pytest.mark.parametrize("ref", REFS)
def test_exon_mask_and_inferred_k_match_jax(ref):
    """The genotyper's reference (RefSet.from_fasta): the exon mask read
    from the dna-mode headers and the packed layout equal the JAX
    package's, as does the inferred k."""
    from t1k_tpu.io.refset import RefSet as HostRefSet
    from t1k_tpu_torch.io.refset import RefSet

    path = os.path.join(GOLDEN, ref)
    got, want = RefSet.from_fasta(path), HostRefSet.from_fasta(path)
    a, b = got.packed(), want.packed()
    for field in ("seq_codes", "seq_starts", "seq_lens", "exon_mask"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert 0 < a.exon_mask.sum() < len(a.exon_mask)
    assert got.infer_kmer_length() == want.infer_kmer_length()


@pytest.mark.parametrize("ref", REFS)
def test_relaxed_intron_alignment_changes_the_outputs(inputs, tmp_path, ref):
    """kir-wgs is -s 0.9 with --relaxIntronAlign in the genotyper and the
    analyzer: without the relax flag the same input gives other bytes."""
    outs = {}
    for name, flags in (("relax", ["--preset", "kir-wgs"]),
                        ("strict", ["-s", "0.9"])):
        assert main([*_args(inputs, ref, flags, "paired", tmp_path / name),
                     *NATIVE]) == 0
        outs[name] = {s: _read(tmp_path / name / ("w" + s))
                      for s in PAIRED_OUTPUTS}
    assert outs["relax"] != outs["strict"]


@pytest.mark.parametrize("ref", REFS)
def test_relaxed_match_counts_leave_the_match_counts(inputs, ref):
    """The engine's assignment records (ASSIGN_FIELDS): under
    --relaxIntronAlign some read's relaxed_match_cnt differs from its
    match_cnt, and without it none does but those the engine zeroes
    (more than 10 below the read's best match); the port's host engine, its
    deferred route through the plain band kernel and the JAX package's
    engine give the same records."""
    from t1k_tpu.core.pipeline import assign_unique_reads as host_assign
    from t1k_tpu.io.refset import RefSet as HostRefSet
    from t1k_tpu.native import ASSIGN_FIELDS
    from t1k_tpu.native import NativeEngine as HostEngine
    from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH
    from t1k_tpu_torch.core.pipeline import assign_unique_reads
    from t1k_tpu_torch.io.refset import RefSet
    from t1k_tpu_torch.native import NativeEngine
    from t1k_tpu_torch.ops.align_band import DeferredDescService

    fq1, fq2 = inputs[ref]["paired"][1::2]
    seqs = [r.seq for f in (fq1, fq2) for r in read_seq_file(f)]
    path = os.path.join(GOLDEN, ref)
    match = ASSIGN_FIELDS.index("match_cnt")
    relaxed = ASSIGN_FIELDS.index("relaxed_match_cnt")
    for relax in (True, False):
        packed = RefSet.from_fasta(path, -1, "").packed()
        engine = NativeEngine(packed, GENOTYPER_KMER_LENGTH, 0.9,
                              relax_intron_align=relax, threads=4)
        _, _, rec, off = assign_unique_reads(engine, seqs)
        _, _, drec, doff = assign_unique_reads(
            NativeEngine(packed, GENOTYPER_KMER_LENGTH, 0.9,
                         relax_intron_align=relax),
            seqs, backend="gpu", desc_service=DeferredDescService("cpu"))
        host = HostEngine(HostRefSet.from_fasta(path, -1, "").packed(),
                          GENOTYPER_KMER_LENGTH, 0.9,
                          relax_intron_align=relax)
        _, _, hrec, hoff = host_assign(host, seqs)
        assert len(rec) > N_PAIRS
        for got, got_off in ((drec, doff), (hrec, hoff)):
            assert np.array_equal(got_off, off)
            assert np.array_equal(got, rec)
        moved = int(((rec[:, relaxed] != rec[:, match])
                     & (rec[:, relaxed] != 0)).sum())
        assert (moved > 0) == relax, moved


@pytest.mark.parametrize("ref", REFS)
def test_screen_at_k14_matches_jax(inputs, ref):
    """DeviceScreen's plain version at the extractor's k for a reference of
    16.8-67 Mbp (14: the hashed table), the single-end hit length (23) and
    the hla-wgs extractor's similarity (0.97), on the extractor's
    reference (every record, no dedupe): verdict and decided equal to the
    JAX package's screen, every decided verdict equal to the engine's."""
    from t1k_tpu.constants import encode_seq
    from t1k_tpu.io.refset import RefSet as HostRefSet
    from t1k_tpu.ops import phase_a as jpa
    from t1k_tpu_torch.native import NativeEngine
    from t1k_tpu_torch.ops import phase_a as tpa

    k, hit_len, sim = 14, 23, 0.97
    refset = HostRefSet(digit_units=-1, delimiter="")
    for rec in read_seq_file(os.path.join(GOLDEN, ref)):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    packed = refset.packed()
    reads = [r.seq for r in read_seq_file(inputs[ref]["single"][1])]
    lens = np.array([len(r) for r in reads], np.int32)
    codes = np.full((len(reads), int(lens.max())), 4, np.int8)
    for i, r in enumerate(reads):
        codes[i, :lens[i]] = encode_seq(r)
    tscreen = tpa.DeviceScreen.build(packed, k, hit_len, sim, device="cpu")
    assert not tscreen.index.direct
    tv, td = tscreen.screen(codes, lens)
    jv, jd = jpa.DeviceScreen.build(packed, k, hit_len, sim).screen(codes,
                                                                    lens)
    assert np.array_equal(td, jd) and np.array_equal(tv, jv)
    assert td.sum() > len(reads) // 2 and tv[td].any() and not tv[td].all()
    starts = np.zeros(len(reads), np.int64)
    starts[1:] = np.cumsum(lens[:-1].astype(np.int64))
    flags = NativeEngine(packed, k, ref_seq_similarity=sim,
                         hit_len_required=hit_len).screen_batch(
        np.concatenate([encode_seq(r) for r in reads]), starts,
        lens).astype(bool)
    assert np.array_equal(tv[td], flags[td])
