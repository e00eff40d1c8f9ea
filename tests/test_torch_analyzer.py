"""The port's post-analysis stage (t1k_tpu_torch.core.analyzer and its
CLI) against the JAX package's analyzer on the same genotyper outputs:
reads simulated from the multigene panel with three seeded substitutions
in one allele, so the VCF has records, and a barcode FASTA written here.
The gpu route runs on the CPU through the band kernel's plain version
(device="cpu").  Also: the port's packed array coalesce against the JAX
package's object coalesce, and the variant caller's numpy oracle against
its native pass."""

import json
import os

import numpy as np
import pytest
import torch

from t1k_tpu.core import analyzer as host_analyzer
from t1k_tpu.core import pipeline as host_pipeline
from t1k_tpu.io.reads import SeqRecord, read_seq_file, write_fastq
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs
from t1k_tpu_torch.core.analyzer import AnalyzerOptions, run_analyzer

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "data", "multigene_rna.fa")
SNP_POSITIONS = (300, 700, 1100)   # 0-based, in the copy of GENA*83
BARCODES = ("ACGTAC", "CCTTGA", "GATTCA")


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
    with open(path) as f:
        return f.read()


def _snp_reads(prefix, n_pairs=600):
    """Pairs from GENB*104 and from a copy of GENA*83 with substitutions
    at SNP_POSITIONS, fixed seed."""
    recs = {r.id: r for r in read_seq_file(REF)}
    seq = list(recs["GENA*83"].seq)
    for p in SNP_POSITIONS:
        seq[p] = "ACGT"[("ACGT".index(seq[p]) + 1) % 4]
    donor = SeqRecord("GENA*83snp", "".join(seq), None)
    r1, r2 = simulate_pairs([recs["GENB*104"], donor], [1.0, 1.0],
                            SimConfig(n_pairs=n_pairs, seed=5))
    write_fastq(prefix + "_1.fq", r1)
    write_fastq(prefix + "_2.fq", r2)


@pytest.fixture(scope="module")
def genotyped(tmp_path_factory):
    """The JAX native genotyper's outputs on the seeded-SNP reads, and a
    barcode FASTA with one record per aligned fragment (some missing)."""
    work = tmp_path_factory.mktemp("analyzer")
    reads = str(work / "snp")
    _snp_reads(reads)
    prefix = str(work / "g")
    host_pipeline.run_genotyper(
        REF, [reads + "_1.fq"], [reads + "_2.fq"], prefix,
        host_pipeline.GenotypeOptions(backend="native", em_backend="native"))
    ids = [r.id for r in read_seq_file(prefix + "_aligned_1.fa")]
    rng = np.random.default_rng(11)
    bc = str(work / "bc.fa")
    with open(bc, "w") as f:
        for name in ids:
            pick = int(rng.integers(0, len(BARCODES) + 1))
            seq = BARCODES[pick] if pick < len(BARCODES) else "missing_barcode"
            f.write(f">{name}\n{seq}\n")
    return prefix, bc


def _inputs(prefix):
    return (prefix + "_allele.tsv", [prefix + "_aligned_1.fa"],
            [prefix + "_aligned_2.fa"])


@pytest.fixture(scope="module")
def host_analyzed(genotyped, tmp_path_factory):
    prefix, bc = genotyped
    out = str(tmp_path_factory.mktemp("host") / "a")
    host_analyzer.run_analyzer(
        REF, *_inputs(prefix), out,
        host_analyzer.AnalyzerOptions(backend="native", barcode_file=bc))
    vcf = _read(out + "_allele.vcf")
    assert len(vcf.splitlines()) >= len(SNP_POSITIONS)
    assert _read(out + "_barcode_expr.tsv")
    return out


def _check_outputs(got, want):
    for suffix in ("_allele.vcf", "_barcode_expr.tsv"):
        assert _read(got + suffix) == _read(want + suffix), suffix


@pytest.mark.parametrize("backend,em_backend,device", [
    ("native", "native", "cuda"), ("gpu", "gpu", "cpu")])
def test_port_analyzer_matches_jax_native(genotyped, host_analyzed, tmp_path,
                                          backend, em_backend, device):
    prefix, bc = genotyped
    out = str(tmp_path / "a")
    res = run_analyzer(REF, *_inputs(prefix), out, AnalyzerOptions(
        backend=backend, em_backend=em_backend, device=device,
        barcode_file=bc))
    assert res["variants"] >= len(SNP_POSITIONS)
    _check_outputs(out, host_analyzed)
    stage = json.loads(_read(out + "_analyzer_metrics.json"))[
        "analyzer_read_assignment"]
    # the gpu route sends the deferred DP to the band kernel's plain version
    assert (stage["deferred_item_count"] > 0) == (backend == "gpu")
    assert stage["band_kernel_launches"] == 0


def test_variant_numpy_oracle_matches_native_pass(genotyped, host_analyzed,
                                                  tmp_path, monkeypatch):
    prefix, bc = genotyped
    monkeypatch.setenv("T1K_VARIANT_BACKEND", "python")
    out = str(tmp_path / "py")
    run_analyzer(REF, *_inputs(prefix), out, AnalyzerOptions(
        backend="native", em_backend="native", barcode_file=bc))
    _check_outputs(out, host_analyzed)


def test_packed_coalesce_matches_the_reference_object_coalesce(genotyped):
    """The port's analyzer packs its fragments' ReadAssignments for the
    array coalesce; the JAX package's analyzer coalesces the objects.  On
    the same reads both build the same read-group CSR, byte for byte."""
    from t1k_tpu.core import fragment as host_fragment
    from t1k_tpu.core.genotyper import Genotyper as HostGenotyper
    from t1k_tpu.io.refset import RefSet as HostRefSet
    from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH
    from t1k_tpu_torch.core.analyzer import pack_assignments
    from t1k_tpu_torch.core.fragment import (RefContext, fragment_assign,
                                             set_read_assignments)
    from t1k_tpu_torch.core.genotyper import Genotyper
    from t1k_tpu_torch.core.pipeline import (assign_unique_reads,
                                             overlap_lists_from_records)
    from t1k_tpu_torch.io.reads import read_seq_files
    from t1k_tpu_torch.io.refset import RefSet
    from t1k_tpu_torch.native import NativeEngine

    prefix, _ = genotyped
    seqs1 = [r.seq for r in read_seq_files([prefix + "_aligned_1.fa"])]
    seqs2 = [r.seq for r in read_seq_files([prefix + "_aligned_2.fa"])]
    n = len(seqs1)
    refset = RefSet.from_fasta(REF)
    engine = NativeEngine(refset.packed(), GENOTYPER_KMER_LENGTH)
    _, group_of, rec, off = assign_unique_reads(engine, seqs1 + seqs2)
    overlaps = overlap_lists_from_records(rec, off)
    has_n = [("N" in a) or ("N" in b) for a, b in zip(seqs1, seqs2)]

    ctx = RefContext(refset)
    port = Genotyper(refset, device="cpu")
    cnt_port = port.coalesce_arrays(*pack_assignments([
        set_read_assignments(ctx, fragment_assign(
            ctx, overlaps[group_of[i]], overlaps[group_of[n + i]],
            has_n[i], True), None, 2000) for i in range(n)]))

    host_refset = HostRefSet.from_fasta(REF)
    host_ctx = host_fragment.RefContext(host_refset)
    host_overlaps = [[host_fragment.OverlapRec.from_row(r) for r in
                      rec[off[i]:off[i + 1]]] for i in range(len(off) - 1)]
    host = HostGenotyper(host_refset)
    cnt_host = host.coalesce([
        host_fragment.set_read_assignments(
            host_ctx, host_fragment.fragment_assign(
                host_ctx, host_overlaps[group_of[i]],
                host_overlaps[group_of[n + i]], has_n[i], True), None, 2000)
        for i in range(n)])
    host._build_group_arrays_from_objects()

    assert cnt_port == cnt_host > n // 2
    assert port.read_group_count == host.read_group_count > 1
    for name in ("_grp_off", "_flat_allele", "_flat_start", "_flat_end",
                 "_flat_weight", "_flat_qual", "_flat_adjust"):
        a, b = getattr(port, name), getattr(host, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_zero_weights_leave_coverage_untouched(genotyped):
    """The analyzer's assignment (zero weights) adds no base coverage;
    weighted assignment does."""
    from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH
    from t1k_tpu_torch.core.pipeline import assign_unique_reads
    from t1k_tpu_torch.io.reads import read_seq_files
    from t1k_tpu_torch.io.refset import RefSet
    from t1k_tpu_torch.native import NativeEngine

    prefix, _ = genotyped
    seqs = [r.seq for r in read_seq_files([prefix + "_aligned_1.fa"])]
    packed = RefSet.from_fasta(REF).packed()
    for zero in (True, False):
        engine = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
        _, _, rec, _ = assign_unique_reads(engine, seqs, zero_weights=zero)
        assert len(rec) > 0
        assert (engine.pos_weight().sum() == 0) == zero


def test_analyze_cli_negative_var_max_group(genotyped, tmp_path):
    """`--varMaxGroup -1` (no group-size limit) parses as the reference's
    getopt reads it, and calls what the JAX package's CLI calls."""
    from t1k_tpu.cli.analyze import main as host_main
    from t1k_tpu_torch.cli.analyze import main

    prefix, _ = genotyped
    allele, (a1,), (a2,) = _inputs(prefix)
    args = ["-f", REF, "-a", allele, "-1", a1, "-2", a2,
            "--varMaxGroup", "-1"]
    host_main([*args, "-o", str(tmp_path / "h"), "--backend", "native"])
    assert main([*args, "-o", str(tmp_path / "p"), "--backend", "native",
                 "--emBackend", "native"]) == 0
    assert _read(str(tmp_path / "p_allele.vcf")) == _read(
        str(tmp_path / "h_allele.vcf")) != ""


def test_analyze_cli_auto_without_a_card_exits(genotyped, tmp_path,
                                                monkeypatch, capsys):
    from t1k_tpu_torch.cli.analyze import main

    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix, _ = genotyped
    allele, (a1,), (a2,) = _inputs(prefix)
    out = str(tmp_path / "x")
    with pytest.raises(SystemExit) as exc:
        main(["-f", REF, "-a", allele, "-1", a1, "-2", a2, "-o", out])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--backend native" in err and "--device cpu" in err
    assert not os.path.exists(out + "_allele.vcf")
    assert AnalyzerOptions().device == "cuda"
    assert AnalyzerOptions().backend == "auto"


@pytest.mark.cuda
def test_port_analyzer_on_card(genotyped, host_analyzed, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    prefix, bc = genotyped
    out = str(tmp_path / "card")
    run_analyzer(REF, *_inputs(prefix), out, AnalyzerOptions(
        backend="gpu", em_backend="gpu", device="cuda", barcode_file=bc))
    _check_outputs(out, host_analyzed)
    stage = json.loads(_read(out + "_analyzer_metrics.json"))[
        "analyzer_read_assignment"]
    assert stage["band_kernel_launches"] > 0
