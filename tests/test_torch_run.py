"""The port's pipeline driver (t1k_tpu_torch.cli.run) against the JAX
package's (t1k_tpu.cli.run --backend native --emBackend native): the whole
chain extract -> genotype -> analyze on reads simulated from the
multigene panel with three seeded substitutions in one allele (so the VCF
has records) and a barcode file, the same reads as a BAM (-b, with CB/UB
tags), single-end input, two processes, and the multigene driver cases
of tests/test_runt1k.py.  The gpu routes run
on the CPU through the kernels' plain versions (--device cpu)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from t1k_tpu.cli import fold_negative_values as host_fold
from t1k_tpu.cli.run import main as host_main
from t1k_tpu.constants import revcomp_str
from t1k_tpu.io.bam import BamRecord, BamWriter
from t1k_tpu.io.reads import SeqRecord, read_seq_file, write_fastq
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs
from t1k_tpu_torch.cli import fold_negative_values
from t1k_tpu_torch.cli.run import build_parser, main

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA_DIR = os.path.join(HERE, "data")
REF = os.path.join(DATA_DIR, "multigene_rna.fa")
MULTIGENE = (os.path.join(DATA_DIR, "multigene_1.fq"),
             os.path.join(DATA_DIR, "multigene_2.fq"))
SNP_POSITIONS = (300, 700, 1100)   # 0-based, in the copy of GENA*83
NATIVE = ["--backend", "native", "--emBackend", "native"]
PAIRED_OUTPUTS = ("_candidate_1.fq", "_candidate_2.fq", "_genotype.tsv",
                  "_allele.tsv", "_aligned_1.fa", "_aligned_2.fa",
                  "_allele.vcf")
BARCODE_OUTPUTS = ("_candidate_bc.fa", "_aligned_bc.fa", "_barcode_expr.tsv")
SINGLE_OUTPUTS = ("_candidate.fq", "_genotype.tsv", "_allele.tsv",
                  "_aligned.fa", "_allele.vcf")
# gene g's alleles on chr6 at [100,000 + 20,000 g, + 2,000] in the BAM test
GENE_START, GENE_STEP, GENE_SPAN = 100_000, 20_000, 2_000


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


@pytest.fixture(scope="module")
def snp_reads(tmp_path_factory):
    """800 pairs from GENB*104 and from a copy of GENA*83 with
    substitutions at SNP_POSITIONS (seed 5), and a barcode FASTQ with one
    of three barcodes per pair."""
    work = tmp_path_factory.mktemp("snp")
    recs = {r.id: r for r in read_seq_file(REF)}
    seq = list(recs["GENA*83"].seq)
    for p in SNP_POSITIONS:
        seq[p] = "ACGT"[("ACGT".index(seq[p]) + 1) % 4]
    donor = SeqRecord("GENA*83snp", "".join(seq), None)
    r1, r2 = simulate_pairs([recs["GENB*104"], donor], [1.0, 1.0],
                            SimConfig(n_pairs=800, seed=5))
    fq1, fq2, bc = (str(work / n) for n in ("snp_1.fq", "snp_2.fq",
                                            "snp_bc.fq"))
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)
    rng = np.random.default_rng(4)
    codes = ("ACGTACGTAAGGCCTT", "TTGACCATGGCAACGT", "GATTACAGATTACAGG")
    write_fastq(bc, [SeqRecord(r.id, codes[int(rng.integers(0, 3))],
                               "I" * 16) for r in r1])
    return fq1, fq2, bc


def _chain_args(snp_reads, outdir):
    fq1, fq2, bc = snp_reads
    return ["-f", REF, "-1", fq1, "-2", fq2, "--barcode", bc,
            "--od", outdir, "-o", "c"]


@pytest.fixture(scope="module")
def host_chain(snp_reads, tmp_path_factory):
    """The JAX package's chain, native routes; its VCF has records."""
    out = str(tmp_path_factory.mktemp("host"))
    assert host_main([*_chain_args(snp_reads, out), *NATIVE]) == 0
    vcf = _read(os.path.join(out, "c_allele.vcf")).decode()
    assert len(vcf.splitlines()) >= len(SNP_POSITIONS)
    return out


def _same_outputs(got_dir, want_dir, suffixes, prefix="c"):
    for suffix in suffixes:
        got = _read(os.path.join(got_dir, prefix + suffix))
        assert got == _read(os.path.join(want_dir, prefix + suffix)), suffix
        if suffix != "_allele.vcf":
            assert got, suffix


@pytest.mark.parametrize("flags", [["--device", "cpu"], NATIVE],
                         ids=["device_cpu", "native"])
def test_chain_matches_jax_native_on_every_output(snp_reads, host_chain,
                                                  tmp_path, flags):
    out = str(tmp_path)
    assert main([*_chain_args(snp_reads, out), *flags]) == 0
    _same_outputs(out, host_chain, PAIRED_OUTPUTS + BARCODE_OUTPUTS)
    metrics = json.loads(_read(os.path.join(out, "c_analyzer_metrics.json")))
    deferred = metrics["analyzer_read_assignment"]["deferred_item_count"]
    assert (deferred > 0) == (flags[0] == "--device")


def test_single_end_chain_matches_jax_native(snp_reads, tmp_path):
    fq1 = snp_reads[0]
    host, port = str(tmp_path / "host"), str(tmp_path / "port")
    args = ["-f", REF, "-u", fq1, "-o", "s"]
    assert host_main([*args, "--od", host, *NATIVE]) == 0
    assert main([*args, "--od", port, "--device", "cpu"]) == 0
    _same_outputs(port, host, SINGLE_OUTPUTS, prefix="s")
    assert _read(os.path.join(host, "s_allele.vcf"))


def test_two_processes_match_one(snp_reads, host_chain, tmp_path):
    """T1K_NUM_PROCESSES=2: process 1 assigns its shard on the gpu route
    it was given (no pin to the host engine), process 0 extracts, merges
    through the single-process tail and analyzes; the outputs equal the
    single-process chain's."""
    fq1, fq2, _ = snp_reads
    out = str(tmp_path)
    cmd = [sys.executable, "-m", "t1k_tpu_torch.cli.run", "-f", REF,
           "-1", fq1, "-2", fq2, "--od", out, "-o", "c", "--backend", "gpu",
           "--emBackend", "gpu", "--device", "cpu"]
    procs = []
    for pid in (1, 0):
        # two processes at torch's default thread count oversubscribe the
        # cores: the plain band kernel then runs some 20x slower
        env = dict(os.environ, PYTHONPATH=REPO, T1K_NUM_PROCESSES="2",
                   T1K_PROCESS_ID=str(pid), OMP_NUM_THREADS="2")
        for var in ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND"):
            env.pop(var, None)
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    logs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    worker = [line for line in logs[0][1].splitlines()
              if "stage read_assignment finished" in line]
    assert len(worker) == 1
    counters = dict(kv.split("=") for kv in worker[0].split() if "=" in kv)
    assert int(counters["deferred_item_count"]) > 0, worker
    _same_outputs(out, host_chain, PAIRED_OUTPUTS)
    # the merge runs the single-process tail, metrics included
    metrics = json.loads(_read(os.path.join(out, "c_metrics.json")))
    assert {"read_assignment", "em_quantification",
            "allele_selection"} <= set(metrics)


def test_worker_resolves_its_own_backend(host_chain, tmp_path, monkeypatch,
                                         capfd):
    """A worker process keeps the presence verdict unpinned and runs the
    route --backend / --device resolve to, as one process does."""
    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("T1K_NUM_PROCESSES", "2")
    monkeypatch.setenv("T1K_PROCESS_ID", "1")
    out = str(tmp_path)
    for suffix in ("_candidate_1.fq", "_candidate_2.fq"):
        shutil.copy(os.path.join(host_chain, "c" + suffix), out)
    assert main(["-f", REF, "-1", *MULTIGENE[:1], "--od", out, "-o", "c",
                 "--stage", "1", "--device", "cpu"]) == 0
    assert "T1K_GPU_PRESENT" not in os.environ
    assert os.path.exists(os.path.join(out, "c_dshard_1.npz"))
    assert not os.path.exists(os.path.join(out, "c_genotype.tsv"))
    line = [x for x in capfd.readouterr().err.splitlines()
            if "stage read_assignment finished" in x][0]
    assert "deferred_item_count=0 " not in line + " "


def test_negative_and_range_values_parse():
    argv = ["-f", "r.fa", "-1", "a.fq", "--read1Range", "0", "-1",
            "--read2Range", "5", "-1", "--barcodeRange", "0", "15", "-",
            "--post-varMaxGroup", "-1", "--squaremMinAlpha", "-0.5",
            "--alleleDigitUnits", "-1", "-2", "b.fq"]
    assert fold_negative_values(argv) == host_fold(argv)
    args = build_parser().parse_args(fold_negative_values(argv))
    assert args.read1Range == [0, -1] and args.read2Range == [5, -1]
    assert args.barcodeRange == ["0", "15", "-"]
    assert args.varMaxGroup == -1 and args.squaremMinAlpha == -0.5
    assert args.alleleDigitUnits == -1
    assert args.first == ["a.fq"] and args.second == ["b.fq"]


def test_interleaved_prefix_inference(tmp_path):
    """Interleaved-only input infers the bare `T1K` prefix: run-t1k's
    inference looks only at -b and -1/-u (run-t1k:316-331)."""
    r1 = list(read_seq_file(MULTIGENE[0]))
    r2 = list(read_seq_file(MULTIGENE[1]))
    inter = str(tmp_path / "sample.inter.fq")
    write_fastq(inter, [x for pair in zip(r1, r2) for x in pair])
    outdir = str(tmp_path / "out")
    assert main(["-f", REF, "-i", inter, "--od", outdir,
                 "--skipPostAnalysis", "--device", "cpu"]) == 0
    names = set(os.listdir(outdir))
    assert "T1K_genotype.tsv" in names, names
    assert not any(n.startswith("T1K_sample") for n in names), names


def test_no_extraction_requires_direct_reads(tmp_path):
    rc = main(["-f", REF, "-i", MULTIGENE[0], "--od", str(tmp_path),
               "--noExtraction", "--device", "cpu"])
    assert rc == 1
    assert os.listdir(str(tmp_path)) == []


def test_config_and_metrics_provenance(tmp_path):
    """The resolved config (<prefix>_config.json, PipelineConfig round
    trip) and per-stage metrics (<prefix>_metrics.json)."""
    from t1k_tpu_torch.config import PipelineConfig

    outdir = str(tmp_path / "prov")
    assert main(["-f", REF, "-1", *MULTIGENE[:1], "-2", MULTIGENE[1],
                 "--od", outdir, "-o", "p", "--preset", "hla",
                 "--skipPostAnalysis", "--device", "cpu"]) == 0
    path = os.path.join(outdir, "p_config.json")
    cfg = PipelineConfig.load(path)
    assert cfg.preset == "hla"
    assert cfg.similarity == 0.97  # hla preset resolved into the config
    assert cfg.skip_post_analysis
    assert (cfg.backend, cfg.device) == ("auto", "cpu")
    cfg.save(str(tmp_path / "again.json"))
    assert _read(str(tmp_path / "again.json")) == _read(path)
    metrics = json.loads(_read(os.path.join(outdir, "p_metrics.json")))
    for stage_name in ("read_assignment", "fragment_assignment",
                       "em_quantification", "allele_selection"):
        assert stage_name in metrics, metrics.keys()
        assert metrics[stage_name]["seconds"] >= 0
    assert metrics["read_assignment"]["read_count"] > 0


def test_auto_without_a_card_exits_before_any_output(tmp_path, monkeypatch,
                                                     capsys):
    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    outdir = str(tmp_path / "x")
    with pytest.raises(SystemExit) as exc:
        main(["-f", REF, "-1", MULTIGENE[0], "-2", MULTIGENE[1],
              "--od", outdir])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--backend native" in err and "--device cpu" in err
    assert not os.path.exists(outdir)


@pytest.mark.parametrize("flags", [["-b", "x.bam"], ["--deviceCandidates"]])
def test_unported_inputs_are_refused(tmp_path, capsys, monkeypatch, flags):
    """-b without -c exits 1 with the reference's diagnostic
    (run-t1k:284-287) and writes no output.  --deviceCandidates, once
    refused, is accepted and reaches the genotyper's GenotypeOptions."""
    if flags[0] == "--deviceCandidates":
        from t1k_tpu_torch.core import pipeline

        seen = []
        monkeypatch.setattr(pipeline, "run_genotyper",
                            lambda *args: seen.append(args[-1]))
        assert main(["-f", REF, "-1", MULTIGENE[0], "-2", MULTIGENE[1],
                     "--od", str(tmp_path / "o"), "--device", "cpu",
                     "--noExtraction", "--skipPostAnalysis", *flags]) == 0
        assert len(seen) == 1 and seen[0].device_candidates
        assert seen[0].device == "cpu"
        return
    assert main(["-f", REF, "-1", MULTIGENE[0], "--od", str(tmp_path / "o"),
                 "--device", "cpu", *flags]) == 1
    err = capsys.readouterr().err
    assert host_main(["-f", REF, "-1", MULTIGENE[0], "--od",
                      str(tmp_path / "h"), *flags]) == 1
    assert capsys.readouterr().err == err
    assert err == ("Need to use -c to specify gene coordinate file for "
                   "BAM input.\n")
    assert not os.path.exists(str(tmp_path / "o"))
    assert not os.path.exists(str(tmp_path / "h"))


def test_multi_process_refusal_is_the_reference_text(tmp_path, capsys,
                                                     monkeypatch):
    """Barcodes under T1K_NUM_PROCESSES=2 exit 1 with the reference's
    message, byte for byte."""
    monkeypatch.setenv("T1K_NUM_PROCESSES", "2")
    monkeypatch.setenv("T1K_PROCESS_ID", "0")
    argv = ["-f", REF, "-1", MULTIGENE[0], "-2", MULTIGENE[1],
            "--barcode", MULTIGENE[0]]
    assert host_main([*argv, "--od", str(tmp_path / "h")]) == 1
    want = capsys.readouterr().err
    assert main([*argv, "--od", str(tmp_path / "o"), "--device",
                 "cpu"]) == 1
    assert capsys.readouterr().err == want == (
        "Distributed mode covers the standard paired/single flow; barcode, "
        "whitelist and per-read-assignment outputs run single-process (or "
        "per-cell, tools/smartseq.py).\n")


@pytest.fixture(scope="module")
def snp_bam(snp_reads, tmp_path_factory):
    """The snp_reads pairs as a coordinate-sorted BAM with CB/UB tags
    (the pair's barcode, a UMI per pair; every fifth pair untagged): 500
    pairs aligned inside their gene's interval on chr6, 100 on an
    alternative contig, 200 unaligned templates, and 200 random pairs on
    chr1; and its coordinate fasta.  Returns (bam, coord)."""
    work = tmp_path_factory.mktemp("snpbam")
    fq1, fq2, bc = snp_reads
    r1, r2 = list(read_seq_file(fq1)), list(read_seq_file(fq2))
    codes = [r.seq for r in read_seq_file(bc)]
    genes = sorted({r.id.split("*")[0] for r in read_seq_file(REF)})
    coord = str(work / "coord.fa")
    with open(coord, "w") as f:
        for r in read_seq_file(REF):
            g = GENE_START + GENE_STEP * genes.index(r.id.split("*")[0])
            f.write(f">{r.id} chr6 {g} {g + GENE_SPAN} +\n{r.seq}\n")
    rng = np.random.default_rng(8)
    aligned, unaligned = [], []

    def pair(i, name, s1, q1, s2, q2, tid, p1, tags):
        if tid < 0:
            unaligned.extend([
                BamRecord(name, 0x4D, -1, -1, 0, [], -1, -1, 0, s1, q1,
                          tags),
                BamRecord(name, 0x8D, -1, -1, 0, [], -1, -1, 0, s2, q2,
                          tags)])
            return
        p2 = p1 + 150
        aligned.extend([
            BamRecord(name, 0x63, tid, p1, 60, [(len(s1), 0)], tid, p2,
                      250, s1, q1, tags),
            BamRecord(name, 0x93, tid, p2, 60, [(len(s2), 0)], tid, p1,
                      -250, revcomp_str(s2), q2[::-1], tags)])

    for i, (a, b) in enumerate(zip(r1, r2)):
        tags = {} if i % 5 == 4 else {"CB": codes[i], "UB": "U%09d" % i}
        if i < 500:
            # sim_<i>_<allele>_<start>: inside the allele's gene interval
            gene = a.id.split("_")[2].split(".")[0]
            tid = 1
            pos = (GENE_START + GENE_STEP * genes.index(gene)
                   + int(a.id.split("_")[-1]))
        else:
            tid, pos = (2, 1000 + 10 * i) if i < 600 else (-1, -1)
        pair(i, a.id, a.seq, a.qual, b.seq, b.qual, tid, pos, tags)
    for i in range(200):
        s1, s2 = ("".join(rng.choice(list("ACGT"), 100)) for _ in range(2))
        pair(i, f"bg{i}", s1, "I" * 100, s2, "I" * 100, 0, 5000 + 300 * i,
             {"CB": codes[i]})
    bam = str(work / "snp.bam")
    w = BamWriter(bam, ["chr1", "chr6", "chr6_GL000251v2_alt"],
                  [1_000_000, 1_000_000, 100_000],
                  "@HD\tVN:1.6\tSO:coordinate\n")
    for r in sorted(aligned, key=lambda r: (r.tid, r.pos)) + unaligned:
        w.write(r)
    w.close()
    return bam, coord


def test_bam_chain_matches_jax_native_on_every_output(snp_bam, tmp_path,
                                                      monkeypatch, capfd):
    """run -b: BAM extraction (the coordinate fasta as screen reference,
    CB barcodes, UB UMIs) -> genotype -> analyze, the port's gpu routes
    on the CPU against the JAX package's native routes (its BAM screen
    pinned to the host engine by T1K_BACKEND=native).  The port's screen
    takes --backend and --device: every screened read reaches its device
    screen."""
    bam, coord = snp_bam
    host, port = str(tmp_path / "host"), str(tmp_path / "port")
    args = ["-f", REF, "-b", bam, "-c", coord, "--barcode", "CB", "--UMI",
            "UB", "-o", "b"]
    monkeypatch.setenv("T1K_BACKEND", "native")
    assert host_main([*args, "--od", host, *NATIVE]) == 0
    monkeypatch.delenv("T1K_BACKEND")
    capfd.readouterr()
    assert main([*args, "--od", port, "--backend", "gpu", "--device",
                 "cpu"]) == 0
    line = [x for x in capfd.readouterr().err.splitlines()
            if "stage extraction_screen finished" in x][0]
    screen = dict(kv.split("=") for kv in line.split() if "=" in kv)
    # chunks of 1,024 reads on this panel of near-identical alleles pass
    # the screen's hit cap and go back to the engine: decided may be 0
    assert int(screen["device_screened_reads"]) == 1600, line
    _same_outputs(port, host, PAIRED_OUTPUTS + BARCODE_OUTPUTS
                  + ("_candidate_umi.fa",), prefix="b")
    assert len(_read(os.path.join(port, "b_allele.vcf")).splitlines()) >= 1
    cand = _read(os.path.join(port, "b_candidate_1.fq")).splitlines()
    assert 790 <= len(cand) // 4 <= 800
    metrics = json.loads(_read(os.path.join(port, "b_analyzer_metrics.json")))
    assert metrics["analyzer_read_assignment"]["deferred_item_count"] > 0


def test_bam_prefix_is_inferred_from_the_bam(snp_bam, tmp_path):
    """Without -o the prefix comes from -b (run-t1k:316-331)."""
    bam, coord = snp_bam
    out = str(tmp_path / "out")
    assert main(["-f", REF, "-b", bam, "-c", coord, "--od", out,
                 "--skipPostAnalysis", "--backend", "native", "--emBackend",
                 "native"]) == 0
    assert os.path.exists(os.path.join(out, "T1K_snp_genotype.tsv"))
