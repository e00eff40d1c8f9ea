"""Case generators of the port's differential fuzz layer.

Each generator writes one random case's inputs (a panel, reads, a BAM,
list files) into a case directory and returns a `Case`: the runs of the
port's entry points that the case makes, in order, and the rules its
outputs are compared by.  The generators are copies of the case builders
of tests/fuzz_genotyper.py (`make_panel` and its run), fuzz_driver.py,
fuzz_analyzer.py, fuzz_extractor.py, fuzz_bam.py and fuzz_smartseq.py,
written against the port's modules (t1k_tpu_torch.io.reads,
tools.simulate, io.bam): they draw the same random numbers in the same
order, so a seed writes the same panel, reads, BAM, list files and
argument lists as the matching fuzzer (tests/test_torch_fuzz_stages.py
holds them to that).  Where a fuzzer draws after a comparison (the
genotyper's -a rerun, the driver's --stage restart), the copy draws as
that fuzzer does when every comparison before it passed.

A run's arguments hold OUT where the route's output directory goes; the
route's own flags (--backend, --emBackend, --device) are added by
`route_argv`.  `run_case` runs a case's runs in this process through
each module's `main`, and `verdict` compares two routes' output
directories by the fuzzers' rules: every file byte for byte, except
`_assign.tsv` as sorted lines (its order follows the engine's threads)
and the port's provenance files (EXTRA_SUFFIXES), which are left out.

  python3 scripts/fuzz_torch.py driver,genotyper 0 20   # the card runner
"""

from __future__ import annotations

import importlib
import os
import random
import shutil
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from t1k_tpu_torch.constants import revcomp_str  # noqa: E402
from t1k_tpu_torch.io.bam import BamRecord, BamWriter  # noqa: E402
from t1k_tpu_torch.io.reads import (SeqRecord, read_seq_file,  # noqa: E402
                                    write_fastq)
from t1k_tpu_torch.tools.simulate import SimConfig, simulate_pairs  # noqa: E402

FUZZERS = ("driver", "genotyper", "analyzer", "extractor", "bam", "smartseq")
# where a run's arguments name the route's output directory
OUT = "{out}"
# the port's provenance and observability files, left out of comparisons
EXTRA_SUFFIXES = ("_config.json", "_metrics.json", "_em_state.npz")
BASES = "ACGT"
# the modules that take --emBackend (the extractors have no EM)
EM_MODULES = ("cli.run", "cli.genotype", "cli.analyze", "tools.smartseq")


@dataclass
class Run:
    """One call of `t1k_tpu_torch.<module>.main(argv)`, in `cwd` when it
    is set (OUT may stand in both).  `port_only` flags follow `argv` on
    the routes under test and not on the native route, the oracle (as the
    fuzzers pass them to their own runs and not to the reference's)."""
    module: str
    argv: List[str]
    cwd: Optional[str] = None
    port_only: List[str] = field(default_factory=list)


@dataclass
class Case:
    fuzzer: str
    seed: int
    dir: str                  # the inputs
    runs: List[Run]
    flags: str                # what a failure line names
    mkdirs: List[str] = field(default_factory=list)   # made before the runs


def render(arg: str, out: str) -> str:
    return arg.replace(OUT, out)


def route_argv(run: Run, route: str, out: str, device: str) -> List[str]:
    """The run's arguments for a route: "native" (the host engine),
    "gpu" (the kernels on `device`; a plate's second pass as --cohortEm,
    one batched EM) or "auto" (the defaults, which a user runs: the card,
    behind the size gates)."""
    flags = []
    if route != "auto":
        flags = ["--backend", route] + (
            ["--emBackend", route] if run.module in EM_MODULES else [])
    argv = [render(a, out) for a in run.argv]
    if route != "native":
        argv += run.port_only
        flags += ["--device", device]
    if route == "gpu" and run.module == "tools.smartseq":
        flags.append("--cohortEm")   # the plate's second pass in one EM
    return argv + flags


# ------------------------------------------------- tests/fuzz_genotyper.py

def _rand_seq(rng, n):
    return "".join(rng.choice(BASES) for _ in range(n))


def _mutate(rng, seq, sub_rate, indel_rate=0.0):
    out = []
    for c in seq:
        r = rng.random()
        if r < sub_rate and c in BASES:
            out.append(BASES[(BASES.index(c) + rng.randint(1, 3)) % 4])
        elif r < sub_rate + indel_rate:
            if rng.random() < 0.5:
                continue  # deletion
            out.append(c)
            out.append(rng.choice(BASES))  # insertion
        else:
            out.append(c)
    return "".join(out)


def make_panel(rng, path, dna, big=False):
    """Genes diverge by 1-5%, alleles within a gene by 0.1-1%.  DNA mode
    builds exon blocks with intron padding and single-N separators and
    real exon coords; RNA mode uses a 50bp UTR + one or more exons.
    `big` draws as T1K_FUZZ_BIG does: 3-6 genes of 6-30 alleles."""
    n_genes = rng.randint(3, 6) if big else rng.randint(1, 3)
    gene_div = rng.uniform(0.01, 0.05)
    records = []
    base = _rand_seq(rng, rng.randint(500, 1200))
    for g in range(n_genes):
        gname = f"FZG{chr(65 + g)}"
        gene_seq = _mutate(rng, base, gene_div)
        n_alleles = rng.randint(6, 30) if big else rng.randint(2, 12)
        if dna:
            n_ex = rng.randint(2, 4)
            cut = sorted(rng.sample(range(60, len(gene_seq) - 60), n_ex - 1))
            bounds = [0] + cut + [len(gene_seq)]
            exons = [gene_seq[bounds[i]:bounds[i + 1]] for i in range(n_ex)]
        for a in range(n_alleles):
            allele_seq = _mutate(rng, gene_seq, rng.uniform(0.001, 0.01),
                                 indel_rate=0.0 if dna else 0.002)
            if dna:
                al_ex = [_mutate(rng, e, rng.uniform(0.001, 0.01))
                         for e in exons]
                parts = [_rand_seq(rng, 50)]
                coords = []
                pos = 50
                for i, e in enumerate(al_ex):
                    coords.append((pos, pos + len(e) - 1))
                    parts.append(e)
                    pos += len(e)
                    if i + 1 < len(al_ex):
                        pad_l = _rand_seq(rng, rng.randint(40, 120))
                        pad_r = _rand_seq(rng, rng.randint(40, 120))
                        parts.append(pad_l + "N" + pad_r)
                        pos += len(pad_l) + 1 + len(pad_r)
                parts.append(_rand_seq(rng, 50))
                seq = "".join(parts)
                comment = f"{len(coords)} " + " ".join(
                    f"{s} {e}" for s, e in coords)
            else:
                seq = _rand_seq(rng, 50) + allele_seq + _rand_seq(rng, 50)
                comment = f"1 50 {50 + len(allele_seq) - 1}"
            records.append((f"{gname}*{a + 1:03d}", seq, comment))
    with open(path, "w") as f:
        for name, seq, comment in records:
            f.write(f">{name} {comment}\n{seq}\n")
    return records


def _donor(rng, records):
    """1-2 alleles of every gene and their abundances."""
    genes = sorted({r[0].split("*")[0] for r in records})
    by_gene = {g: [r for r in records if r[0].startswith(g + "*")]
               for g in genes}
    chosen, abund = [], []
    for g in genes:
        for r in rng.sample(by_gene[g],
                            min(len(by_gene[g]), rng.randint(1, 2))):
            chosen.append(SeqRecord(r[0], r[1], None, r[2]))
            abund.append(rng.uniform(0.4, 1.0))
    return chosen, abund


def genotyper_case(seed: int, case: str, big: bool = False) -> Case:
    rng = random.Random(seed)
    os.makedirs(case, exist_ok=True)
    dna = rng.random() < 0.4
    panel = f"{case}/panel_{seed}.fa"
    records = make_panel(rng, panel, dna, big)
    chosen, abund = _donor(rng, records)
    n_pairs = rng.randint(300, 900) if big else rng.randint(40, 300)
    cfg = SimConfig(n_pairs=n_pairs, seed=seed,
                    read_len=rng.choice([75, 100]),
                    error_rate=rng.choice([0.0, 0.005, 0.02]))
    r1, r2 = simulate_pairs(chosen, abund, cfg)
    paired = rng.random() < 0.75
    p1, p2 = f"{case}/r1_{seed}.fq", f"{case}/r2_{seed}.fq"
    write_fastq(p1, r1)
    if paired:
        write_fastq(p2, r2)

    args = []
    if dna:
        if rng.random() < 0.7:
            args += ["--relaxIntronAlign"]
        args += ["-s", rng.choice(["0.8", "0.9"])]
    else:
        args += ["-s", rng.choice(["0.8", "0.97"])]
    if rng.random() < 0.3:
        args += ["--frac", rng.choice(["0.05", "0.3"])]
    if rng.random() < 0.3:
        args += ["--cov", rng.choice(["0.5", "2.0"])]
    if rng.random() < 0.3:
        args += ["--crossGeneRate", rng.choice(["0.0", "0.1"])]
    if rng.random() < 0.2:
        args += ["-n", rng.choice(["20", "5"])]
    inp = ["-1", p1, "-2", p2] if paired else ["-u", p1]
    extra = ["--deviceCandidates"] if rng.random() < 0.4 else []
    minep = f"{OUT}/mine_{seed}"
    runs = [Run("cli.genotype", ["-f", panel, "-o", minep,
                                 "--outputReadAssignment"] + args + inp,
                port_only=extra)]
    # -a bypasses the EM with an abundance file (Genotyper.hpp:1016-1051)
    if rng.random() < 0.25:
        ab = f"{case}/abund_{seed}.tsv"
        arng = random.Random(seed ^ 0xAB)
        with open(ab, "w") as f:
            f.write("target_id\tlength\teff_length\test_counts\ttpm\n")
            for name, _, _ in records:
                if arng.random() < 0.8:
                    f.write(f"{name}\t1000\t900\t"
                            f"{arng.uniform(0, 80):.4f}\t0\n")
        runs.append(Run("cli.genotype", ["-f", panel, "-o", minep,
                                         "--outputReadAssignment", "-a", ab]
                        + args + inp, port_only=extra))
    return Case("genotyper", seed, case, runs,
                f"dna={dna} paired={paired} args={args + extra} "
                f"a={len(runs) > 1}")


# ---------------------------------------------------- tests/fuzz_driver.py

def _driver_bam(seed, rng, case, panel, records, r1, r2, args):
    """The -b chain: coordinate-sorted BAM -> bam-extractor -> genotyper
    -> analyzer (run-t1k:350)."""
    gene_start = rng.randint(5000, 20000)
    gene_end = gene_start + rng.randint(800, 2500)
    coord = f"{case}/coord.fa"
    with open(coord, "w") as f:
        for name, seq, _ in records:
            f.write(f">{name} chr22 {gene_start} {gene_end} +\n{seq}\n")

    paired = rng.random() < 0.7
    bam = f"{case}/in.bam"
    w = BamWriter(bam, ["chr22"], [10_000_000],
                  "@HD\tVN:1.6\tSO:coordinate\n")
    M = 0
    aligned = []
    unmapped = []
    for a, b in zip(r1, r2):
        kind = rng.random()
        if kind < 0.5:
            # candidate: unaligned template (mates adjacent)
            f1 = 0x1 | 0x4 | 0x8 | 0x40
            f2 = 0x1 | 0x4 | 0x8 | 0x80
            if not paired:
                unmapped.append(BamRecord(a.id, 0x4, -1, -1, 0, [], -1, -1,
                                          0, a.seq, a.qual, {}))
            else:
                unmapped.append(BamRecord(a.id, f1, -1, -1, 0, [], -1, -1,
                                          0, a.seq, a.qual, {}))
                unmapped.append(BamRecord(a.id, f2, -1, -1, 0, [], -1, -1,
                                          0, b.seq, b.qual, {}))
        else:
            # aligned read in or out of the gene interval
            inside = rng.random() < 0.5
            p1 = (rng.randint(gene_start - 30, gene_end - 10) if inside
                  else rng.randint(100000, 9_000_000))
            flag = 0x0 if not paired else (0x1 | 0x2 | 0x20 | 0x40)
            aligned.append(BamRecord(
                a.id, flag, 0, p1, 60, [(len(a.seq), M)], 0,
                p1 + 200, 200 + len(b.seq), a.seq, a.qual, {}))
            if paired:
                aligned.append(BamRecord(
                    a.id, 0x1 | 0x2 | 0x10 | 0x80, 0, p1 + 200, 60,
                    [(len(b.seq), M)], 0, p1,
                    -(200 + len(b.seq)), revcomp_str(b.seq),
                    (b.qual or "")[::-1], {}))
    aligned.sort(key=lambda r: r.pos)
    for r in aligned:
        w.write(r)
    for r in unmapped:
        w.write(r)
    w.close()

    if rng.random() < 0.5:
        args = args + ["-s", rng.choice(["0.8", "0.9"])]
    if rng.random() < 0.3:
        args = args + ["--skipPostAnalysis"]
    return Case("driver", seed, case,
                [Run("cli.run", ["-f", panel, "-c", coord, "-b", bam, "-o",
                                 "fz", "--od", f"{OUT}/mine"] + args)],
                f"bam paired={paired} args={args}", [f"{OUT}/mine"])


def driver_case(seed: int, case: str, big: bool = False,
                hla: Optional[tuple] = None) -> Case:
    """`hla` = (panel fasta, read pairs or None) takes that panel (the
    smoke's HLA-scale one) instead of a drawn one, with that many pairs
    (None: 2,000-12,000, drawn apart from the case's own numbers)."""
    rng = random.Random(seed)
    os.makedirs(case, exist_ok=True)
    dna = rng.random() < 0.4
    if hla:
        panel, dna = hla[0], False
        records = [(r.id, r.seq, r.comment) for r in read_seq_file(panel)]
    else:
        panel = f"{case}/panel.fa"
        records = make_panel(rng, panel, dna, big)
    chosen, abund = _donor(rng, records)
    n_pairs = rng.randint(60, 250)
    if hla:
        n_pairs = hla[1] or random.Random(seed ^ 0x41A).randint(2000, 12000)
    cfg = SimConfig(n_pairs=n_pairs, seed=seed,
                    read_len=rng.choice([75, 100]),
                    error_rate=rng.choice([0.0, 0.005, 0.02]))
    r1, r2 = simulate_pairs(chosen, abund, cfg)

    io_mode = rng.choices(["paired", "single", "interleaved", "bam"],
                          weights=[0.45, 0.22, 0.18, 0.15])[0]
    if io_mode == "bam":
        return _driver_bam(seed, rng, case, panel, records, r1, r2, args=[])
    # input files named with dots to exercise prefix inference
    p1 = f"{case}/reads.x_1.fq"
    p2 = f"{case}/reads.x_2.fq"
    pi = f"{case}/reads.inter.fq"
    if io_mode == "interleaved":
        inter = [x for pair in zip(r1, r2) for x in pair]
        write_fastq(pi, inter)
        io_args = ["-i", pi]
    elif io_mode == "paired":
        write_fastq(p1, r1)
        write_fastq(p2, r2)
        io_args = ["-1", p1, "-2", p2]
    else:
        write_fastq(p1, r1)
        io_args = ["-u", p1]

    # barcode chain: extractor correction -> genotyper _candidate_bc.fa
    # -> analyzer _aligned_bc.fa -> _barcode_expr.tsv (run-t1k:195-234)
    if io_mode != "interleaved" and rng.random() < 0.3:
        bc_len = rng.choice([8, 12])
        bcs = [SeqRecord(a.id, "".join(rng.choice("ACGT")
                                       for _ in range(bc_len)),
                         "I" * bc_len, None) for a in r1]
        bf = f"{case}/bc.fq"
        write_fastq(bf, bcs)
        io_args += ["--barcode", bf]
        if rng.random() < 0.5:
            io_args += ["--barcodeRange", "1", str(bc_len - 2),
                        rng.choice(["+", "-"])]
        if rng.random() < 0.5:
            wl = sorted({b.seq for b in bcs})[::2]
            with open(f"{case}/wl.txt", "w") as f:
                f.write("\n".join(wl) + "\n")
            io_args += ["--barcodeWhitelist", f"{case}/wl.txt"]

    args = []
    if dna:
        preset = rng.choice(["", "kir-wgs", "kir-wes"])
    else:
        preset = rng.choice(["", "hla", "hla-wgs"])
    if preset:
        args += ["--preset", preset]
    elif rng.random() < 0.5:
        args += ["-s", rng.choice(["0.8", "0.9"] if dna else ["0.8", "0.97"])]
        if dna and rng.random() < 0.5:
            args += ["--relaxIntronAlign"]
    if rng.random() < 0.25:
        args += ["--frac", rng.choice(["0.05", "0.3"])]
    if rng.random() < 0.25:
        args += ["--cov", rng.choice(["0.5", "2.0"])]
    if rng.random() < 0.2:
        args += ["--crossGeneRate", rng.choice(["0.0", "0.1"])]
    if rng.random() < 0.2:
        args += ["-n", rng.choice(["20", "500"])]
    if rng.random() < 0.3:
        args += ["--outputReadAssignment"]
    skip_post = rng.random() < 0.25
    if skip_post:
        args += ["--skipPostAnalysis"]
    elif rng.random() < 0.3:
        args += ["--post-varMaxGroup", rng.choice(["-1", "2", "8"])]
    no_extract = io_mode != "interleaved" and rng.random() < 0.25
    if no_extract:
        args += ["--noExtraction"]

    use_prefix = rng.random() < 0.7
    prefix_args = ["-o", "fz"] if use_prefix else []
    minedir = f"{OUT}/mine"
    runs = [Run("cli.run", ["-f", panel] + io_args + prefix_args
                + ["--od", minedir] + args)]
    # stage restart: a later stage again in place, from the stage files
    stage = None
    if not no_extract and rng.random() < 0.35:
        stage = rng.choice([1, 2] if not skip_post else [1])
        runs.append(Run("cli.run", ["-f", panel] + io_args + prefix_args
                        + ["--od", minedir, "--stage", str(stage)] + args))
    barcodes = [a for a in io_args if a.startswith("--barcode")]
    return Case("driver", seed, case, runs,
                f"mode={io_mode} preset={preset!r} args={args} "
                f"stage={stage} pairs={n_pairs} barcode={barcodes}",
                [minedir])


# -------------------------------------------------- tests/fuzz_analyzer.py

def _inject_snps(rng, seq, comment, n_snps):
    """Substitute n_snps positions, biased into exon regions so the
    variant caller has exonic candidates to emit."""
    toks = comment.split()
    n_ex = int(toks[0])
    exons = [(int(toks[1 + 2 * i]), int(toks[2 + 2 * i]))
             for i in range(n_ex)]
    s = list(seq)
    for _ in range(n_snps):
        if rng.random() < 0.8:
            es, ee = rng.choice(exons)
            pos = rng.randint(es, ee)
        else:
            pos = rng.randrange(len(s))
        if s[pos] in BASES:
            s[pos] = BASES[(BASES.index(s[pos]) + rng.randint(1, 3)) % 4]
    return "".join(s)


def analyzer_case(seed: int, case: str, big: bool = False) -> Case:
    rng = random.Random(10_000_000 + seed)
    os.makedirs(case, exist_ok=True)
    dna = rng.random() < 0.35
    panel = f"{case}/panel_{seed}.fa"
    records = make_panel(rng, panel, dna, big)

    genes = sorted({r[0].split("*")[0] for r in records})
    by_gene = {g: [r for r in records if r[0].startswith(g + "*")]
               for g in genes}
    chosen, abund = [], []
    for g in genes:
        for r in rng.sample(by_gene[g],
                            min(len(by_gene[g]), rng.randint(1, 2))):
            seq = r[1]
            if rng.random() < 0.7:  # novel-variant carrier
                n_snps = rng.randint(4, 10) if big else rng.randint(1, 3)
                seq = _inject_snps(rng, seq, r[2], n_snps)
            chosen.append(SeqRecord(r[0], seq, None, r[2]))
            abund.append(rng.uniform(0.4, 1.0))
    n_pairs = rng.randint(500, 1200) if big else rng.randint(150, 500)
    cfg = SimConfig(n_pairs=n_pairs, seed=seed,
                    read_len=rng.choice([75, 100]),
                    error_rate=rng.choice([0.0, 0.005]))
    r1, r2 = simulate_pairs(chosen, abund, cfg)
    paired = rng.random() < 0.75
    p1, p2 = f"{case}/r1_{seed}.fq", f"{case}/r2_{seed}.fq"
    write_fastq(p1, r1)
    if paired:
        write_fastq(p2, r2)

    gargs = []
    aargs = []
    if dna and rng.random() < 0.7:
        gargs += ["--relaxIntronAlign"]
        aargs += ["--relaxIntronAlign"]
    if rng.random() < 0.2:
        aargs += ["--varMaxGroup", rng.choice(["2", "-1"])]
    inp = ["-1", p1, "-2", p2] if paired else ["-u", p1]
    minep = f"{OUT}/mine_{seed}"
    mal = (["-1", f"{minep}_aligned_1.fa", "-2", f"{minep}_aligned_2.fa"]
           if paired else ["-u", f"{minep}_aligned.fa"])
    return Case("analyzer", seed, case, [
        Run("cli.genotype", ["-f", panel, "-o", minep] + gargs + inp),
        Run("cli.analyze", ["-f", panel, "-a", f"{minep}_allele.tsv", "-o",
                            minep + "_an"] + aargs + mal)],
        f"dna={dna} paired={paired} gargs={gargs} aargs={aargs}")


# ------------------------------------------------- tests/fuzz_extractor.py

def _make_reads(rng, records, n, read_len, lead1=0, lead2=0, bc_len=0):
    """On-target pairs diluted with random background; optional leading
    junk (exercises read ranges) and per-read barcodes."""
    genes = sorted({r[0].split("*")[0] for r in records})
    by_gene = {g: [r for r in records if r[0].startswith(g + "*")]
               for g in genes}
    chosen, abund = [], []
    for g in genes:
        r = rng.choice(by_gene[g])
        chosen.append(SeqRecord(r[0], r[1], None, r[2]))
        abund.append(1.0)
    cfg = SimConfig(n_pairs=n, seed=rng.randint(0, 10**6),
                    read_len=read_len,
                    error_rate=rng.choice([0.0, 0.01]))
    r1, r2 = simulate_pairs(chosen, abund, cfg)
    out1, out2, bcs = [], [], []
    for a, b in zip(r1, r2):
        if rng.random() < 0.5:  # replace with off-target background
            a = SeqRecord(a.id, _rand_seq(rng, read_len), a.qual, None)
            b = SeqRecord(b.id, _rand_seq(rng, read_len), b.qual, None)
        if lead1:
            a = SeqRecord(a.id, _rand_seq(rng, lead1) + a.seq,
                          ("I" * lead1 + a.qual) if a.qual else None, None)
        if lead2:
            b = SeqRecord(b.id, _rand_seq(rng, lead2) + b.seq,
                          ("I" * lead2 + b.qual) if b.qual else None, None)
        out1.append(a)
        out2.append(b)
        if bc_len:
            bcs.append(SeqRecord(a.id, _rand_seq(rng, bc_len),
                                 "I" * bc_len, None))
    return out1, out2, bcs


def extractor_case(seed: int, case: str, big: bool = False) -> Case:
    rng = random.Random(seed)
    os.makedirs(case, exist_ok=True)
    panel = f"{case}/panel.fa"
    records = make_panel(rng, panel, rng.random() < 0.3, big)

    io_mode = rng.choices(["paired", "single", "interleaved"],
                          weights=[0.55, 0.3, 0.15])[0]
    multi = io_mode in ("paired", "single") and rng.random() < 0.3
    read_len = rng.choice([75, 100])
    lead1 = rng.choice([0, 0, 8]) if io_mode != "interleaved" else 0
    lead2 = rng.choice([0, 0, 6]) if io_mode == "paired" else 0
    use_bc = rng.random() < 0.4 and io_mode != "interleaved"
    bc_len = rng.choice([8, 12]) if use_bc else 0

    n = rng.randint(80, 250)
    r1, r2, bcs = _make_reads(rng, records, n, read_len, lead1, lead2,
                              bc_len)
    extra = []
    io_args = []
    bc_files = []
    if io_mode == "interleaved":
        inter = [x for pair in zip(r1, r2) for x in pair]
        write_fastq(f"{case}/ri.fq", inter)
        io_args = ["-i", f"{case}/ri.fq"]
    else:
        splits = [(0, n)] if not multi else [(0, n // 2), (n // 2, n)]
        f1s, f2s, bfs = [], [], []
        for si, (lo, hi) in enumerate(splits):
            f1 = f"{case}/r{si}_1.fq"
            write_fastq(f1, r1[lo:hi])
            f1s.append(f1)
            if io_mode == "paired":
                f2 = f"{case}/r{si}_2.fq"
                write_fastq(f2, r2[lo:hi])
                f2s.append(f2)
            if use_bc:
                bf = f"{case}/bc{si}.fq"
                write_fastq(bf, bcs[lo:hi])
                bfs.append(bf)
        if io_mode == "paired":
            for f in f1s:
                io_args += ["-1", f]
            for f in f2s:
                io_args += ["-2", f]
        else:
            for f in f1s:
                io_args += ["-u", f]
        bc_files = bfs

    if rng.random() < 0.5:
        extra += ["-s", rng.choice(["0.8", "0.9", "0.97"])]
    if lead1:
        extra += ["--read1Start", str(lead1)]
        if rng.random() < 0.5:
            extra += ["--read1End", str(lead1 + read_len - 1)]
    if lead2:
        extra += ["--read2Start", str(lead2)]
    for bf in bc_files:
        extra += ["--barcode", bf]
    if bc_files:
        if rng.random() < 0.5:
            extra += ["--barcodeStart", "1",
                      "--barcodeEnd", str(bc_len - 2)]
        if rng.random() < 0.3:
            extra += ["--barcodeRevComp"]
        if rng.random() < 0.4:
            # whitelist: half the observed barcodes
            wl = sorted({b.seq for b in bcs})[::2]
            with open(f"{case}/wl.txt", "w") as f:
                f.write("\n".join(wl) + "\n")
            extra += ["--barcodeWhitelist", f"{case}/wl.txt"]
    return Case("extractor", seed, case,
                [Run("cli.extract", ["-f", panel, "-o", f"{OUT}/mine"]
                     + io_args + extra)],
                f"mode={io_mode} multi={multi} lead=({lead1},{lead2}) "
                f"extra={extra}")


# ------------------------------------------------------- tests/fuzz_bam.py

def cyp_alleles(path: str) -> None:
    """A stand-in for the reference's cyp2d6_rna_seq.fa (which
    tests/fuzz_bam.py reads from T1K_CYP2D6_IDX): CYP2D6*1, 1,497 seeded
    bases, and CYP2D6*4, the same with 12 substitutions."""
    rng = random.Random(2604)
    one = _rand_seq(rng, 1497)
    s = list(one)
    for p in rng.sample(range(len(s)), 12):
        s[p] = BASES[(BASES.index(s[p]) + 1) % 4]
    with open(path, "w") as f:
        f.write(f">CYP2D6*1 1 0 1496\n{one}\n>CYP2D6*4 1 0 1496\n"
                f"{''.join(s)}\n")


def bam_case(seed: int, case: str, big: bool = False,
             alleles: Optional[str] = None) -> Case:
    """`alleles`: a fasta holding CYP2D6*1 and CYP2D6*4 (cyp_alleles
    writes one into the case directory when it is None)."""
    os.makedirs(case, exist_ok=True)
    if alleles is None:
        alleles = f"{case}/cyp2d6_rna_seq.fa"
        cyp_alleles(alleles)
    by_name = {r.id: r for r in read_seq_file(alleles)}
    rng = random.Random(seed)
    bases = "ACGT"
    paired = rng.random() < 0.7
    rl = rng.choice([75, 100, 150])
    n_sim = rng.randint(30, 120)
    r1, r2 = simulate_pairs([by_name["CYP2D6*1"], by_name["CYP2D6*4"]],
                            [1.0, 0.8],
                            SimConfig(n_pairs=n_sim, seed=seed, read_len=rl))
    gene_start = rng.randint(5000, 20000)
    gene_end = gene_start + rng.randint(800, 2500)
    coord = f"{case}/coord_{seed}.fa"
    with open(coord, "w") as f:
        for a in ("CYP2D6*1", "CYP2D6*4"):
            f.write(f">{a} chr22 {gene_start} {gene_end} +\n"
                    f"{by_name[a].seq}\n")

    refs = ["chr22", "chr22_alt", "HLA-DRB1*15.01"]
    reflens = [10_000_000, 200000, 20000]
    M = 0

    def rand_seq(n):
        return "".join(rng.choice(bases) for _ in range(n))

    def mk_pair(name, s1, q1, s2, q2, tid, p1, p2, extra_flag=0, tags=None):
        t = tags or {}
        a = BamRecord(name, 0x63 | extra_flag, tid, p1, 60, [(len(s1), M)],
                      tid, p2, p2 - p1 + len(s2), s1, q1, dict(t))
        b = BamRecord(name, 0x93 | extra_flag, tid, p2, 60, [(len(s2), M)],
                      tid, p1, -(p2 - p1 + len(s2)), revcomp_str(s2),
                      (q2 or "")[::-1] or None, dict(t))
        return a, b

    aligned = {0: [], 1: [], 2: []}
    unmapped = []
    si = 0

    def next_sim():
        nonlocal si
        r = (r1[si % n_sim], r2[si % n_sim])
        si += 1
        return r

    n_events = rng.randint(20, 90)
    for i in range(n_events):
        kind = rng.random()
        name = f"f{seed}_{i}"
        if rng.random() < 0.3:
            name += rng.choice(["/1", "/2"]) if not paired else ""
        tags = {}
        if rng.random() < 0.25:
            tags = {"CB": "".join(rng.choice(bases) for _ in range(8))}
        if rng.random() < 0.2:
            tags["UB"] = "".join(rng.choice(bases) for _ in range(10))
        if kind < 0.35:
            # aligned near/inside the gene window (boundary stress)
            a, b = next_sim()
            p1 = rng.choice([
                gene_start - rl, gene_start - rl + 1, gene_start - 1,
                gene_start, gene_end - 1, gene_end, gene_end + 1,
                rng.randint(gene_start, gene_end),
            ])
            p1 = max(1, p1)
            p2 = p1 + rng.randint(rl, rl + 300)
            if paired:
                aligned[0].extend(mk_pair(name, a.seq, a.qual, b.seq, b.qual,
                                          0, p1, p2, tags=tags))
            else:
                aligned[0].append(BamRecord(name, 0x0, 0, p1, 60,
                                            [(rl, M)], -1, -1, 0, a.seq,
                                            a.qual, dict(tags)))
        elif kind < 0.5:
            # background far away
            p1 = rng.randint(100000, 9_000_000)
            s1, s2 = rand_seq(rl), rand_seq(rl)
            if paired:
                aligned[0].extend(mk_pair(name, s1, "I" * rl, s2, "I" * rl,
                                          0, p1, p1 + rl + 50, tags=tags))
            else:
                aligned[0].append(BamRecord(name, 0x0, 0, p1, 60, [(rl, M)],
                                            -1, -1, 0, s1, "I" * rl,
                                            dict(tags)))
        elif kind < 0.62:
            # alt contig
            a, b = next_sim()
            tid = rng.choice([1, 2])
            p1 = rng.randint(100, reflens[tid] - 2000)
            if paired:
                aligned[tid].extend(mk_pair(name, a.seq, a.qual, b.seq,
                                            b.qual, tid, p1, p1 + rl + 50,
                                            tags=tags))
            else:
                aligned[tid].append(BamRecord(name, 0x0, tid, p1, 60,
                                              [(rl, M)], -1, -1, 0, a.seq,
                                              a.qual, dict(tags)))
        elif kind < 0.78:
            # unaligned template (on-target or background)
            if rng.random() < 0.6:
                a, b = next_sim()
                s1, q1, s2, q2 = a.seq, a.qual, b.seq, b.qual
            else:
                s1, q1, s2, q2 = rand_seq(rl), "I" * rl, rand_seq(rl), "I" * rl
            if rng.random() < 0.1:
                s1 = "N" * rl  # low complexity
            if paired:
                unmapped.append(BamRecord(name, 0x4D, -1, -1, 0, [], -1, -1,
                                          0, s1, q1, dict(tags)))
                unmapped.append(BamRecord(name, 0x8D, -1, -1, 0, [], -1, -1,
                                          0, s2, q2, dict(tags)))
            else:
                unmapped.append(BamRecord(name, 0x4, -1, -1, 0, [], -1, -1,
                                          0, s1, q1, dict(tags)))
        elif kind < 0.88:
            # secondary / supplementary (ignored in pass 2 and in the
            # general info)
            a, b = next_sim()
            fl = rng.choice([0x100, 0x800])
            p1 = rng.randint(gene_start, gene_end)
            if paired:
                x, y = mk_pair(name, a.seq, a.qual, b.seq, b.qual, 0, p1,
                               p1 + rl + 50, extra_flag=fl, tags=tags)
                aligned[0].extend([x, y])
            else:
                aligned[0].append(BamRecord(name, fl, 0, p1, 60, [(rl, M)],
                                            -1, -1, 0, a.seq, a.qual,
                                            dict(tags)))
        else:
            # missing quals / N-heavy read, aligned in-region
            a, _ = next_sim()
            seq = a.seq
            if rng.random() < 0.5:
                seq = "".join(c if rng.random() > 0.15 else "N" for c in seq)
            p1 = rng.randint(gene_start, gene_end)
            aligned[0].append(BamRecord(name, 0x0 if not paired else 0x41,
                                        0, p1, 60, [(len(seq), M)], -1, -1,
                                        0, seq, None, dict(tags)))

    for tid in aligned:
        aligned[tid].sort(key=lambda r: r.pos)
    bam = f"{case}/case_{seed}.bam"
    w = BamWriter(bam, refs, reflens, "@HD\tVN:1.6\tSO:coordinate\n")
    for tid in (0, 1, 2):
        for r in aligned[tid]:
            w.write(r)
    for r in unmapped:
        w.write(r)
    w.close()

    frng = random.Random(seed ^ 0xBC)
    use_bc = frng.random() < 0.4
    use_umi = frng.random() < 0.3
    argv = ["-b", bam, "-f", coord, "-o", f"{OUT}/mine_{seed}"]
    if use_bc:
        argv += ["--barcode", "CB"]
    if use_umi:
        argv += ["--UMI", "UB"]
    return Case("bam", seed, case, [Run("cli.bamextract", argv)],
                f"paired={paired} rl={rl} events={n_events} "
                f"bc={use_bc} umi={use_umi}")


# -------------------------------------------------- tests/fuzz_smartseq.py

def smartseq_case(seed: int, case: str, big: bool = False) -> Case:
    rng = random.Random(seed)
    os.makedirs(case, exist_ok=True)
    panel = f"{case}/panel.fa"
    records = make_panel(rng, panel, False, big)
    genes = sorted({r[0].split("*")[0] for r in records})
    by_gene = {g: [r for r in records if r[0].startswith(g + "*")]
               for g in genes}

    paired = rng.random() < 0.7
    n_cells = rng.randint(2, 4)
    reads_dir = f"{case}/reads"
    os.makedirs(reads_dir, exist_ok=True)
    l1, l2 = [], []
    for c in range(n_cells):
        chosen, abund = [], []
        for g in genes:
            for r in rng.sample(by_gene[g],
                                min(len(by_gene[g]), rng.randint(1, 2))):
                chosen.append(SeqRecord(r[0], r[1], None, r[2]))
                abund.append(rng.uniform(0.4, 1.0))
        cfg = SimConfig(n_pairs=rng.randint(60, 150), seed=seed * 100 + c,
                        read_len=rng.choice([75, 100]),
                        error_rate=rng.choice([0.0, 0.01]))
        r1, r2 = simulate_pairs(chosen, abund, cfg)
        f1 = f"{reads_dir}/cell{c}.x_1.fq"
        f2 = f"{reads_dir}/cell{c}.x_2.fq"
        write_fastq(f1, r1)
        l1.append(f1)
        if paired:
            write_fastq(f2, r2)
            l2.append(f2)
    list1, list2 = f"{case}/list1.txt", f"{case}/list2.txt"
    with open(list1, "w") as f:
        f.write("\n".join(l1) + "\n")
    if paired:
        with open(list2, "w") as f:
            f.write("\n".join(l2) + "\n")

    args = []
    if rng.random() < 0.4:
        args += ["--preset", "hla"]
    minedir = f"{OUT}/mine"
    return Case("smartseq", seed, case,
                [Run("tools.smartseq", ["-f", panel, "-1", list1]
                     + (["-2", list2] if paired else []) + args,
                     cwd=minedir)],
                f"cells={n_cells} paired={paired} args={args}", [minedir])


GENERATORS = {"driver": driver_case, "genotyper": genotyper_case,
              "analyzer": analyzer_case, "extractor": extractor_case,
              "bam": bam_case, "smartseq": smartseq_case}


def make_case(fuzzer: str, seed: int, case: str, big: bool = False,
              **kw) -> Case:
    return GENERATORS[fuzzer](seed, case, big, **kw)


# ------------------------------------------------------------ runs, checks

def port_main(module: str):
    """`t1k_tpu_torch.<module>.main`."""
    return importlib.import_module(f"t1k_tpu_torch.{module}").main


def run_case(case: Case, out: str, argv_of, main_of=port_main) -> list:
    """Runs `case`'s runs in this process, each through `main_of(module)`
    with its arguments for the route (`argv_of(run)`, OUT standing for
    `out`).  After each run but the last, `out` is copied
    to `out.run<i>`.  Stops at the first run that fails.  Returns a
    record per run made: {"rc", "s", "error"}."""
    os.makedirs(out, exist_ok=True)
    for d in case.mkdirs:
        os.makedirs(render(d, out), exist_ok=True)
    records = []
    for i, run in enumerate(case.runs):
        here = os.getcwd()
        t0 = time.perf_counter()
        error = ""
        try:
            if run.cwd:
                os.chdir(render(run.cwd, out))
            rc = main_of(run.module)(argv_of(run))
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except Exception:
            rc, error = 1, traceback.format_exc()[-2000:]
        finally:
            os.chdir(here)
        records.append({"rc": int(rc or 0), "s": time.perf_counter() - t0,
                        "error": error})
        if rc:
            break
        if i + 1 < len(case.runs):
            shutil.copytree(out, f"{out}.run{i}")
    return records


def _files(d: str) -> dict:
    """relative path -> path of every comparable file under d."""
    found = {}
    for root, _, names in os.walk(d):
        for name in names:
            if name.endswith(EXTRA_SUFFIXES):
                continue
            p = os.path.join(root, name)
            found[os.path.relpath(p, d)] = p
    return found


def _same(pa: str, pb: str, name: str) -> bool:
    with open(pa, "rb") as f:
        a = f.read()
    with open(pb, "rb") as f:
        b = f.read()
    if name.endswith("_assign.tsv"):
        return sorted(a.splitlines()) == sorted(b.splitlines())
    return a == b


def compare_dirs(a: str, b: str) -> Optional[str]:
    """None when the two directories hold the same outputs, else the
    first difference."""
    fa, fb = _files(a), _files(b)
    if set(fa) != set(fb):
        return (f"file sets differ: only {os.path.basename(a)} "
                f"{sorted(set(fa) - set(fb))[:4]}, only "
                f"{os.path.basename(b)} {sorted(set(fb) - set(fa))[:4]}")
    for name in sorted(fa):
        if not _same(fa[name], fb[name], name):
            return f"DIFF {name}"
    return None


def verdict(case: Case, a_out: str, a_runs: list, b_out: str,
            b_runs: list) -> tuple:
    """("ok" | "both_failed" | "fail", the first difference or None) of
    two routes' runs of `case`: each run that both made with rc 0 holds
    the same outputs, and a failing run fails on both routes."""
    for i in range(min(len(a_runs), len(b_runs))):
        ra, rb = a_runs[i]["rc"], b_runs[i]["rc"]
        if ra or rb:
            if ra and rb and len(a_runs) == len(b_runs) == i + 1:
                return "both_failed", None
            return "fail", f"run {i} rc {ra} against {rb}"
        last = i + 1 == len(case.runs)
        diff = compare_dirs(a_out if last else f"{a_out}.run{i}",
                            b_out if last else f"{b_out}.run{i}")
        if diff:
            return "fail", f"run {i}: {diff}"
    if len(a_runs) != len(b_runs):
        return "fail", f"{len(a_runs)} runs against {len(b_runs)}"
    return "ok", None
