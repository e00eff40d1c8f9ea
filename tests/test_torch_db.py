"""The port's database build (t1k_tpu_torch.db) against the JAX package's
(t1k_tpu.db), byte for byte, on the committed inputs, on seeded
IPD-shaped and fuzz-shaped .dat files and over the option surface; and
against the committed goldens where the JAX package's tests hold them.

Host code in both packages: no test here needs a card."""

import io
import os
import random
import shutil
import stat
import subprocess
import sys
import urllib.request
import zipfile

import pytest

from t1k_tpu.db import add_gene_coord as host_coord
from t1k_tpu.db import build as host_build
from t1k_tpu.db import gtf_to_dat as host_gtf
from t1k_tpu.db import parse_dat as host_parse
from t1k_tpu.db import vcf_to_dat as host_vcf
from t1k_tpu_torch.db import add_gene_coord, build, gtf_to_dat, parse_dat
from t1k_tpu_torch.db import vcf_to_dat

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA_DIR = os.path.join(HERE, "data")
GOLDEN_DIR = os.path.join(HERE, "golden")
BASES = "ACGT"


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


# ---------------------------------------------------------------- writers
# seeded .dat writers: copies of the record writer and generators of the
# JAX package's database fuzz and IPD-scale tests


def _rand_seq(rng, n):
    return "".join(rng.choice(BASES) for _ in range(n))


def _mutate(rng, seq, rate):
    out = []
    for c in seq:
        if rng.random() < rate:
            out.append(BASES[(BASES.index(c) + rng.randint(1, 3)) % 4])
        else:
            out.append(c)
    return "".join(out)


def _emit_record(f, allele, seq, features):
    f.write(f"ID   {allele}\n")
    f.write(f'FT   allele="{allele}"\n')
    for line in features:
        f.write(f"FT   {line}\n")
    f.write(f"SQ  Sequence {len(seq)} BP\n")
    for i in range(0, len(seq), 60):
        chunk = seq[i:i + 60]
        f.write(f"{chunk} {min(i + 60, len(seq))}\n")
    f.write("//\n")


def make_ipd_dat(rng, path, n_genes=4, alleles_per_gene=30):
    """hla.dat-shaped: 6-8 exons/gene, ~1-3kb alleles, 18% exon-only
    (rna-style) partial records, 12% block-dropped partials, 5% exact
    duplicates."""
    with open(path, "w") as f:
        for g in range(n_genes):
            gene = f"IP{chr(65 + g // 4)}{g % 4 + 1}"
            n_ex = rng.randint(6, 8)
            utr5, utr3 = rng.choice([30, 50, 80]), rng.choice([30, 50, 80])
            ex_lens = [rng.randint(90, 360) for _ in range(n_ex)]
            in_lens = [rng.randint(80, 250) for _ in range(n_ex - 1)]
            exons_t = [_rand_seq(rng, n) for n in ex_lens]
            introns_t = [_rand_seq(rng, n) for n in in_lens]
            dup_from = None
            for a in range(alleles_per_gene):
                allele = f"{gene}*{a + 1:03d}"
                ex = [_mutate(rng, e, rng.uniform(0.0, 0.01)) for e in exons_t]
                if dup_from is not None and rng.random() < 0.05:
                    ex = dup_from
                elif rng.random() < 0.1:
                    dup_from = ex
                r = rng.random()
                parts, feats, pos = [], [], 1
                if r < 0.18:
                    lo = rng.randint(0, 1)
                    hi = n_ex - rng.randint(0, 1)
                    for i in range(lo, hi):
                        parts.append(ex[i])
                        feats.append(
                            f"exon          {pos}..{pos + len(ex[i]) - 1}")
                        pos += len(ex[i])
                    feats.append("/partial")
                else:
                    lo, hi = 0, n_ex
                    partial = r < 0.30
                    if partial:
                        if rng.random() < 0.7:
                            lo = rng.randint(1, n_ex - 1)
                        if hi - lo > 1 and rng.random() < 0.5:
                            hi = rng.randint(lo + 1, n_ex)
                        if (lo, hi) == (0, n_ex):
                            partial = False
                    pad5 = utr5 if lo == 0 else 0
                    if pad5:
                        parts.append(_rand_seq(rng, pad5))
                        pos += pad5
                    for i in range(lo, hi):
                        parts.append(ex[i])
                        feats.append(
                            f"exon          {pos}..{pos + len(ex[i]) - 1}")
                        pos += len(ex[i])
                        if i + 1 < hi:
                            intr = introns_t[i]
                            parts.append(intr)
                            feats.append(
                                f"intron        {pos}..{pos + len(intr) - 1}")
                            pos += len(intr)
                    if hi == n_ex:
                        parts.append(_rand_seq(rng, utr3))
                    if partial:
                        feats.append("/partial")
                _emit_record(f, allele, "".join(parts), feats)


def make_fuzz_dat(rng, path):
    """1-3 genes of 1-4 exons, 2-7 alleles each: mutated exons, exonized
    alleles (an exon annexes intron bases, either side), duplicates,
    partials missing leading or trailing blocks, /pseudo markers."""
    n_genes = rng.randint(1, 3)
    with open(path, "w") as f:
        for g in range(n_genes):
            gene = f"FZ{chr(65 + g)}"
            n_ex = rng.randint(1, 4)
            utr5 = rng.choice([0, 5, 20, 50, 80])
            utr3 = rng.choice([0, 5, 20, 50, 80])
            ex_lens = [rng.randint(40, 180) for _ in range(n_ex)]
            in_lens = [rng.randint(25, 140) for _ in range(n_ex - 1)]
            exons_t = [_rand_seq(rng, n) for n in ex_lens]
            introns_t = [_rand_seq(rng, n) for n in in_lens]
            n_alleles = rng.randint(2, 7)
            dup_from = None
            for a in range(n_alleles):
                allele = f"{gene}*{a + 1:03d}"
                ex = [_mutate(rng, e, rng.uniform(0.0, 0.02))
                      for e in exons_t]
                ex_introns = list(introns_t)
                if n_ex >= 2 and a >= 1 and rng.random() < 0.25:
                    j = rng.randint(1, n_ex - 1)
                    delta = rng.randint(3, min(12, len(ex_introns[j - 1]) - 5))
                    if rng.random() < 0.5:
                        ex[j] = ex_introns[j - 1][-delta:] + ex[j]
                        ex_introns[j - 1] = ex_introns[j - 1][:-delta]
                    else:
                        ex[j - 1] = ex[j - 1] + ex_introns[j - 1][:delta]
                        ex_introns[j - 1] = ex_introns[j - 1][delta:]
                if dup_from is not None and rng.random() < 0.3:
                    ex = dup_from
                elif rng.random() < 0.3:
                    dup_from = ex
                lo, hi = 0, n_ex
                partial = rng.random() < 0.3 and n_ex >= 2
                if partial:
                    if rng.random() < 0.7:
                        lo = rng.randint(1, n_ex - 1)
                    if hi - lo > 1 and rng.random() < 0.5:
                        hi = rng.randint(lo + 1, n_ex)
                    if (lo, hi) == (0, n_ex):
                        partial = False
                parts, feats, pos = [], [], 1
                pad5 = utr5 if lo == 0 else rng.choice([0, 3, 10])
                if pad5:
                    parts.append(_rand_seq(rng, pad5))
                    pos += pad5
                for i in range(lo, hi):
                    parts.append(ex[i])
                    feats.append(f"exon          {pos}..{pos + len(ex[i]) - 1}")
                    if hi - lo >= 2 and i > lo and rng.random() < 0.08:
                        feats.append("/pseudo")
                    pos += len(ex[i])
                    if i + 1 < hi:
                        intr = ex_introns[i]
                        parts.append(intr)
                        feats.append(
                            f"intron        {pos}..{pos + len(intr) - 1}")
                        pos += len(intr)
                pad3 = utr3 if hi == n_ex else rng.choice([0, 3, 10])
                if pad3:
                    parts.append(_rand_seq(rng, pad3))
                if partial:
                    feats.append("/partial")
                _emit_record(f, allele, "".join(parts), feats)


def make_intron_partial_dat(rng, path):
    """Records whose intron is flagged partial and left out of the
    sequence (what --partialIntronHasNoSeq reads), one with a /pseudo
    exon after it: exon coordinates run on as if the intron were there."""
    exons = [_rand_seq(rng, n) for n in (120, 90, 150)]
    introns = [_rand_seq(rng, n) for n in (80, 110)]
    utr5, utr3 = _rand_seq(rng, 40), _rand_seq(rng, 60)
    with open(path, "w") as f:
        for a in range(6):
            ex = [_mutate(rng, e, 0.01) for e in exons]
            parts, feats, pos = [utr5], [], 1 + len(utr5)
            for i in range(3):
                parts.append(ex[i])
                feats.append(f"exon          {pos}..{pos + len(ex[i]) - 1}")
                if a == 5 and i == 1:
                    feats.append("/pseudo")
                    feats.append("/partial")
                pos += len(ex[i])
                if i < 2:
                    feats.append(
                        f"intron        {pos}..{pos + len(introns[i]) - 1}")
                    if a >= 3 and i == a % 2:
                        feats.append("/partial")   # no sequence follows
                    else:
                        parts.append(introns[i])
                    pos += len(introns[i])
            parts.append(utr3)
            _emit_record(f, f"GP*{a + 1:03d}", "".join(parts), feats)


@pytest.fixture(scope="module")
def dats(tmp_path_factory):
    root = tmp_path_factory.mktemp("dats")
    out = {"synth": os.path.join(DATA_DIR, "synth.dat"),
           "synth_pad": os.path.join(DATA_DIR, "synth_pad.dat"),
           "synth_exonized": os.path.join(DATA_DIR, "synth_exonized.dat")}
    out["ipd"] = str(root / "ipd.dat")
    make_ipd_dat(random.Random(42), out["ipd"])
    out["intron_partial"] = str(root / "intron_partial.dat")
    make_intron_partial_dat(random.Random(5), out["intron_partial"])
    for seed in FUZZ_SEEDS:
        out[f"fuzz{seed}"] = str(root / f"fuzz{seed}.dat")
        make_fuzz_dat(random.Random(seed), out[f"fuzz{seed}"])
    return out


FUZZ_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)


def _both(dat, **kw):
    """(port, JAX) build_allele_fasta outputs and returned counts."""
    got, want = io.StringIO(), io.StringIO()
    n = parse_dat.build_allele_fasta(dat, got, parse_dat.BuildOptions(**kw))
    m = host_parse.build_allele_fasta(dat, want,
                                      host_parse.BuildOptions(**kw))
    return got.getvalue(), want.getvalue(), n, m


def _same_build(dat, **kw):
    got, want, n, m = _both(dat, **kw)
    assert n == m
    assert got == want
    return got, n


# ------------------------------------------------------------- parse_dat


@pytest.mark.parametrize("seed", [17, 0, 1, 42, 2**31 - 1, 2**40 + 3])
def test_perl_rand_stream_matches(seed):
    a, b = parse_dat.PerlRand(seed), host_parse.PerlRand(seed)
    got = [(a.rand(), a.randint(4), a.randint(1000)) for _ in range(500)]
    want = [(b.rand(), b.randint(4), b.randint(1000)) for _ in range(500)]
    assert got == want
    if seed == 17:   # the UTR padding stream (ParseDatFile.pl srand(17))
        c = parse_dat.PerlRand(17)
        assert [c.randint(4) for _ in range(12)] == \
            [3, 2, 2, 3, 1, 1, 0, 3, 3, 1, 3, 0]


@pytest.mark.parametrize("dist", [
    {3: 2, 5: 2, 40: 1}, {"ACG": 1, "TTA": 1, "A": 1}, {7: 1}, {},
    {10: 4, 9: 4, 100: 4, 11: 3}])
def test_find_mode_matches(dist):
    assert parse_dat.find_mode(dist) == host_parse.find_mode(dist)


@pytest.mark.parametrize("no_seq", [False, True])
@pytest.mark.parametrize("name", ["synth", "synth_pad", "synth_exonized",
                                  "ipd", "intron_partial", "fuzz3"])
def test_parse_dat_records_matches(dats, name, no_seq):
    with open(dats[name]) as f:
        got = [(r.allele, r.seq, r.exons, r.is_partial, h)
               for r, h in parse_dat.parse_dat_records(f, no_seq)]
    with open(dats[name]) as f:
        want = [(r.allele, r.seq, r.exons, r.is_partial, h)
                for r, h in host_parse.parse_dat_records(f, no_seq)]
    assert got == want and got


@pytest.mark.parametrize("mode", ["rna", "dna", "genome"])
def test_synth_dat_matches_jax_and_golden(dats, mode):
    got, _ = _same_build(dats["synth"], mode=mode)
    assert got == _read(os.path.join(GOLDEN_DIR, f"synth_{mode}.fa"))


@pytest.mark.parametrize("mode", ["rna", "dna"])
def test_oversized_utr_padding_matches_jax_and_golden(dats, mode):
    got, _ = _same_build(dats["synth_pad"], mode=mode)
    assert got == _read(os.path.join(GOLDEN_DIR, f"synth_pad_{mode}.fa"))


def test_left_exonization_trim_matches_jax_and_golden(dats):
    got, _ = _same_build(dats["synth_exonized"], mode="dna",
                         intron_padding=30)
    assert got == _read(os.path.join(GOLDEN_DIR, "synth_exonized_dna.fa"))


OPTIONS = {
    "default": {},
    "gene_prefix": dict(gene_prefix="IPA2"),
    "gene_prefix_fz": dict(gene_prefix="FZB"),
    "ignore_partial": dict(ignore_partial=True),
    "partial_in_rna_mode": dict(partial_in_rna_mode=40),
    "partial_intron_has_no_seq": dict(partial_intron_has_no_seq=True),
    "intron_padding": dict(intron_padding=30),
    "dedup": dict(dedup=True),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("mode", ["rna", "dna", "genome"])
@pytest.mark.parametrize("name", ["ipd", "synth", "intron_partial"])
def test_option_surface_matches(dats, name, mode, option):
    got, n = _same_build(dats[name], mode=mode, **OPTIONS[option])
    if not OPTIONS[option].get("gene_prefix"):
        assert n > 0 and got.startswith(">")


@pytest.mark.parametrize("mode", ["rna", "dna", "genome"])
@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_dat_matches(dats, seed, mode):
    rng = random.Random(seed * 31 + len(mode))
    kw = {}
    if rng.random() < 0.5:
        kw["intron_padding"] = rng.choice([10, 30, 60])
    if rng.random() < 0.3:
        kw["dedup"] = True
    if rng.random() < 0.3:
        kw["partial_in_rna_mode"] = rng.choice([5, 50, 300])
    _same_build(dats[f"fuzz{seed}"], mode=mode, **kw)


def test_ipd_shaped_build_rescues_partials(dats):
    """The seeded IPD-shaped file reaches the dna mode's intron rescue:
    more alleles come out than the records that are whole."""
    got, n = _same_build(dats["ipd"], mode="dna")
    whole, _ = _same_build(dats["ipd"], mode="dna", ignore_partial=True)
    assert n > whole.count(">") > 0


# ------------------------------------------------------- vcf / gtf chains


def test_combine_vcfs_matches_jax_and_golden(tmp_path, monkeypatch):
    """Allele names come from the file names given (CombineVcf.pl), so
    the VCFs are passed as MYG_2.vcf and MYG_3.vcf, the golden's."""
    for n in (2, 3):
        shutil.copy(os.path.join(DATA_DIR, f"vcfdb_MYG_{n}.vcf"),
                    tmp_path / f"MYG_{n}.vcf")
    monkeypatch.chdir(tmp_path)
    files = ["MYG_2.vcf", "MYG_3.vcf"]
    got, want = io.StringIO(), io.StringIO()
    vcf_to_dat.combine_vcfs("MYG*1", files, got)
    host_vcf.combine_vcfs("MYG*1", files, want)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue() == _read(
        os.path.join(GOLDEN_DIR, "vcfdb_combined.tsv"))
    # a name of several underscores and a directory: the reference's
    # re-applied renaming, line by line
    os.makedirs("a_b")
    shutil.copy("MYG_2.vcf", "a_b/X_y_z.vcf")
    got, want = io.StringIO(), io.StringIO()
    vcf_to_dat.combine_vcfs("X*0", ["a_b/X_y_z.vcf"], got)
    host_vcf.combine_vcfs("X*0", ["a_b/X_y_z.vcf"], want)
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("eof_flush", [False, True])
def test_vcf_to_dat_matches_jax_and_golden(eof_flush):
    args = (os.path.join(DATA_DIR, "vcfdb_genome.fa"),
            os.path.join(DATA_DIR, "vcfdb_anno.gtf"),
            os.path.join(GOLDEN_DIR, "vcfdb_combined.tsv"))
    got, want = io.StringIO(), io.StringIO()
    n = vcf_to_dat.vcf_to_dat(*args, got, eof_flush=eof_flush)
    m = host_vcf.vcf_to_dat(*args, want, eof_flush=eof_flush)
    assert n == m == 3
    # exact bytes, record order included (stricter than the JAX test's
    # sorted comparison with the reference)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue() == _read(os.path.join(GOLDEN_DIR, "vcfdb.dat"))


@pytest.mark.parametrize("padding", [500, 100])
def test_vcf_to_dat_padding_and_helpers_match(padding):
    genome = os.path.join(DATA_DIR, "vcfdb_genome.fa")
    assert vcf_to_dat._read_genome(genome) == host_vcf._read_genome(genome)
    assert vcf_to_dat._revcomp("ACGTNacgtAAC") == \
        host_vcf._revcomp("ACGTNacgtAAC")
    args = (genome, os.path.join(DATA_DIR, "vcfdb_anno.gtf"),
            os.path.join(GOLDEN_DIR, "vcfdb_combined.tsv"))
    got, want = io.StringIO(), io.StringIO()
    vcf_to_dat.vcf_to_dat(*args, got, padding=padding)
    host_vcf.vcf_to_dat(*args, want, padding=padding)
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("eof_flush", [False, True])
def test_gtf_to_dat_matches_jax_and_golden(eof_flush):
    args = (os.path.join(DATA_DIR, "gtfdat_strand.fa"),
            os.path.join(DATA_DIR, "gtfdat_strand.gtf"))
    got, want = io.StringIO(), io.StringIO()
    n = gtf_to_dat.gtf_to_dat(*args, got, allele_id="007", source="fuzzsrc",
                              eof_flush=eof_flush)
    m = host_gtf.gtf_to_dat(*args, want, allele_id="007", source="fuzzsrc",
                            eof_flush=eof_flush)
    assert n == m
    assert got.getvalue() == want.getvalue()
    if not eof_flush:
        assert got.getvalue() == _read(
            os.path.join(GOLDEN_DIR, "gtfdat_strand.dat"))


LIFTOFF = """#!/bin/sh
# liftoff -g <annotation> <target fasta> <reference fasta>: prints a fixed
# GTF on the target's first sequence, with lines of another source
chrom=$(head -n 1 "$3" | cut -c2- | cut -d' ' -f1)
printf '##gff-version 3\\n'
printf '%s\\tLiftoff\\texon\\t301\\t420\\t.\\t+\\t.\\tgene_name "gq"; transcript_name "GQ-1";\\n' "$chrom"
printf '%s\\tLiftoff\\texon\\t601\\t777\\t.\\t+\\t.\\tgene_name "gq"; transcript_name "GQ-1";\\n' "$chrom"
printf '%s\\tother\\texon\\t10\\t20\\t.\\t+\\t.\\tgene_name "NO"; transcript_name "NO-1";\\n' "$chrom"
printf '%s\\tLiftoff\\texon\\t1701\\t1900\\t.\\t-\\t.\\tgene_name "GR"; transcript_name "GR-1";\\n' "$chrom"
printf '%s\\tLiftoff\\texon\\t1201\\t1400\\t.\\t-\\t.\\tgene_name "GR"; transcript_name "GR-1";\\n' "$chrom"
printf '%s\\tLiftoff\\texon\\t2101\\t2200\\t.\\t+\\t.\\tgene_name "GS"; transcript_name "GS-1";\\n' "$chrom"
"""


def test_process_multiple_genomes_matches_with_a_stub_liftoff(
        tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "liftoff"
    stub.write_text(LIFTOFF)
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    rng = random.Random(9)
    genome = tmp_path / "genomes.fa"
    with open(genome, "w") as f:
        for name in ("asmA", "asmB", "asmC"):
            f.write(f">{name} assembly\n")
            seq = _rand_seq(rng, 2600)
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
    anno = tmp_path / "ref.gtf"
    anno.write_text("# the reference annotation liftoff maps\n")
    outs = {}
    for pkg, mod in (("port", gtf_to_dat), ("jax", host_gtf)):
        (tmp_path / pkg).mkdir()
        out = io.StringIO()
        mod.process_multiple_genomes(str(genome), str(anno), out,
                                     tmp_prefix=str(tmp_path / pkg / "tmp"))
        # the temporary files are gone
        assert os.listdir(tmp_path / pkg) == []
        outs[pkg] = out.getvalue()
    assert outs["port"] == outs["jax"]
    assert outs["port"].count("ID   ") == 6   # GQ and GR in 3 assemblies
    assert "DE   source asmC GR*003" in outs["port"]


# -------------------------------------------------- coordinates and build


def _gtf_on_chr6(path, genes, chrom="6"):
    with open(path, "w") as f:
        f.write("#annotation\n")
        for i, gene in enumerate(genes):
            start = 29_000_000 + 100_000 * i
            strand = "+-"[i % 2]
            f.write(f"{chrom}\ttest\tgene\t{start}\t{start + 4000}\t.\t"
                    f"{strand}\t.\tgene_id \"g{i}\"; gene_name \"{gene}\";\n")
            f.write(f"{chrom}\ttest\texon\t{start}\t{start + 300}\t.\t"
                    f"{strand}\t.\tgene_name \"{gene}\"; "
                    f"transcript_name \"{gene}-1\";\n")
        f.write('chr1\ttest\tgene\t5\t50\t.\t+\t.\tgene_name "HFE";\n')


@pytest.mark.parametrize("mapping", ["HFE:HLA-HFE", "HFE:HLA-HFE,GA:GB",
                                     "GB:GA"])
def test_add_gene_coord_matches(dats, tmp_path, mapping):
    rna = tmp_path / "rna.fa"
    with open(rna, "w") as f:
        parse_dat.build_allele_fasta(dats["synth"], f)
        # a gene without '*' (keyed by its whole header in pass 1) and
        # one absent from the GTF
        f.write(">HLA-HFE extra comment\nACGT\n>ZZ*01 1 0 3\nACGT\n")
    _gtf_on_chr6(tmp_path / "chr6.gtf", ["GA", "GB", "HLA-HFE"])
    for gtf in (os.path.join(DATA_DIR, "vcfdb_anno.gtf"),
                str(tmp_path / "chr6.gtf")):
        got, want = io.StringIO(), io.StringIO()
        add_gene_coord.add_gene_coord(str(rna), gtf, out=got,
                                      gene_name_mapping=mapping)
        host_coord.add_gene_coord(str(rna), gtf, out=want,
                                  gene_name_mapping=mapping)
        assert got.getvalue() == want.getvalue()
    assert "chr6 29000000 29004000 +" in got.getvalue()


def _build_both(tmp_path, monkeypatch, **kw):
    """build_database in a working directory of each package's own; its
    returned paths and every file it wrote, by name."""
    outs = {}
    for pkg, mod in (("port", build), ("jax", host_build)):
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        paths = mod.build_database(**kw)
        files = {}
        for root, _, names in os.walk("."):
            for n in names:
                files[os.path.join(root, n)] = _read(os.path.join(root, n),
                                                     "rb")
        outs[pkg] = (paths, files)
    assert outs["port"] == outs["jax"]
    return outs["port"]


BUILD_CASES = {
    "prefix": dict(outdir="out", prefix="syn"),
    "target": dict(outdir="out", gene="ga"),
    "outdir_prefix": dict(outdir="dbx/sub"),
    "default_outdir": dict(),
    "ignore_partial": dict(outdir="o", prefix="p", ignore_partial=True),
    "partial_intron_has_no_seq": dict(outdir="o", prefix="p",
                                      partial_intron_has_no_seq=True),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_database_matches(dats, tmp_path, monkeypatch, case):
    gtf = str(tmp_path / "chr6.gtf")
    _gtf_on_chr6(gtf, ["GA", "GB"])
    paths, files = _build_both(tmp_path, monkeypatch, dat=dats["synth"],
                               annotation=gtf, **BUILD_CASES[case])
    assert sorted(paths) == ["dna", "dna_coord", "rna", "rna_coord"]
    assert len(files) == 4 and all(files.values())
    if case == "prefix":
        assert files["./out/syn_rna_seq.fa"].decode() == _read(
            os.path.join(GOLDEN_DIR, "synth_rna.fa"))
        assert files["./out/syn_dna_seq.fa"].decode() == _read(
            os.path.join(GOLDEN_DIR, "synth_dna.fa"))
    if case == "outdir_prefix":   # outdir.split("/")[0]
        assert paths["rna"] == "dbx/sub/dbx_rna_seq.fa"
    if case == "default_outdir":
        assert paths["rna"] == "./T1K_ref_rna_seq.fa"


def test_build_database_reheaders_an_ipd_sequence_fasta(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "hla_nuc.fasta"
    src.write_text(">HLA:HLA00001 A*01:01:01:01 1098 bp\nACGTACGT\nGGCC\n"
                   ">HLA:HLA00002 A*01:01:01:02N 1098 bp\nTTTT\n")
    gtf = str(tmp_path / "chr6.gtf")
    _gtf_on_chr6(gtf, ["A"])
    paths, files = _build_both(tmp_path, monkeypatch, fasta=str(src),
                               outdir="hla", annotation=gtf)
    assert sorted(paths) == ["rna", "rna_coord"]
    assert files["./hla/hla_rna_seq.fa"] == \
        b">A*01:01:01:01\nACGTACGT\nGGCC\n>A*01:01:01:02N\nTTTT\n"


def test_build_database_without_input_raises():
    for mod in (build, host_build):
        with pytest.raises(ValueError, match="need a .dat file"):
            mod.build_database()


@pytest.mark.parametrize("name", ["IPD-IMGT/HLA", "ipd-kir", "URL"])
def test_download_dat_matches(dats, tmp_path, monkeypatch, name):
    """urlretrieve patched to copy local files: the HLA release is a zip
    built here, the KIR release and a URL plain .dat files."""
    zpath = tmp_path / "hla.dat.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(dats["synth"], "hla.dat")
    sources = {build.IPD_HLA_URL: str(zpath), build.IPD_KIR_URL: dats["ipd"],
               "file:///local/x.dat": dats["synth_pad"]}
    assert host_build.IPD_HLA_URL == build.IPD_HLA_URL
    assert host_build.IPD_KIR_URL == build.IPD_KIR_URL
    fetched = []

    def fake(url, path):
        fetched.append(url)
        shutil.copy(sources[url], path)
        return path, None
    monkeypatch.setattr(urllib.request, "urlretrieve", fake)
    arg = "file:///local/x.dat" if name == "URL" else name
    got = {}
    for pkg, mod in (("port", build), ("jax", host_build)):
        out = tmp_path / pkg
        out.mkdir()
        path = mod.download_dat(arg, str(out))
        got[pkg] = (os.path.relpath(path, out), _read(path, "rb"))
    assert got["port"] == got["jax"]
    assert len(fetched) == 2 and fetched[0] == fetched[1]
    want = {"IPD-IMGT/HLA": dats["synth"], "ipd-kir": dats["ipd"],
            "URL": dats["synth_pad"]}[name]
    assert got["port"][1] == _read(want, "rb")


# ------------------------------------------------------------------ CLIs


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_build_cli_matches(dats, tmp_path):
    gtf = str(tmp_path / "chr6.gtf")
    _gtf_on_chr6(gtf, ["GA", "GB"])
    outs = {}
    for pkg in ("t1k_tpu_torch", "t1k_tpu"):
        work = tmp_path / pkg
        work.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.db.build", "-d", dats["synth"],
             "-o", "db/x", "--target", "GA", "-g", gtf],
            cwd=work, env=_env(), capture_output=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        files = {n: _read(work / "db" / "x" / n, "rb")
                 for n in sorted(os.listdir(work / "db" / "x"))}
        outs[pkg] = (proc.stdout, proc.stderr, files)
    assert outs["t1k_tpu_torch"] == outs["t1k_tpu"]
    assert sorted(outs["t1k_tpu"][2]) == [
        "ga_dna_coord.fa", "ga_dna_seq.fa", "ga_rna_coord.fa",
        "ga_rna_seq.fa"]
    assert b"rna_coord: db/x/ga_rna_coord.fa" in outs["t1k_tpu"][1]


def test_parse_dat_cli_matches(dats):
    outs = {}
    for pkg in ("t1k_tpu_torch", "t1k_tpu"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.db.parse_dat", dats["ipd"],
             "--mode", "dna", "--intronPadding", "60", "--dedup",
             "--partialInRnaMode", "20"],
            cwd=REPO, env=_env(), capture_output=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[pkg] = (proc.stdout, proc.stderr)
    assert outs["t1k_tpu_torch"] == outs["t1k_tpu"]
    got, _ = _same_build(dats["ipd"], mode="dna", intron_padding=60,
                         dedup=True, partial_in_rna_mode=20)
    assert outs["t1k_tpu"][0].decode() == got


def _main_stdout(capsys, main, argv):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["combine", "todat", "gtf", "gtf_source",
                                 "genomes", "coord"])
def test_other_clis_match(dats, tmp_path, monkeypatch, capsys, cmd):
    """The CLIs of vcf_to_dat, gtf_to_dat and add_gene_coord, called in
    this process: their standard output, byte for byte."""
    monkeypatch.chdir(tmp_path)
    if cmd == "combine":
        for n in (2, 3):
            shutil.copy(os.path.join(DATA_DIR, f"vcfdb_MYG_{n}.vcf"),
                        f"MYG_{n}.vcf")
        with open("list.txt", "w") as f:
            f.write("MYG_2.vcf\n\nMYG_3.vcf\n")
        argv = ["combine", "MYG*1", "list.txt"]
        port, host = vcf_to_dat.main, host_vcf.main
    elif cmd == "todat":
        argv = ["todat", os.path.join(DATA_DIR, "vcfdb_genome.fa"),
                os.path.join(DATA_DIR, "vcfdb_anno.gtf"),
                os.path.join(GOLDEN_DIR, "vcfdb_combined.tsv")]
        port, host = vcf_to_dat.main, host_vcf.main
    elif cmd in ("gtf", "gtf_source"):
        argv = ["gtf", os.path.join(DATA_DIR, "gtfdat_strand.fa"),
                os.path.join(DATA_DIR, "gtfdat_strand.gtf")]
        argv += ["042", "hg"] if cmd == "gtf_source" else []
        port, host = gtf_to_dat.main, host_gtf.main
    elif cmd == "genomes":
        (tmp_path / "liftoff").write_text(LIFTOFF)
        (tmp_path / "liftoff").chmod(0o755)
        monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                           f"{os.environ['PATH']}")
        with open("g.fa", "w") as f:
            rng = random.Random(4)
            for name in ("h1", "h2"):
                f.write(f">{name}\n{_rand_seq(rng, 2500)}\n")
        argv = ["genomes", "-g", "g.fa", "-a", "ref.gtf", "--tmp", "t"]
        port, host = gtf_to_dat.main, host_gtf.main
    else:
        with open("rna.fa", "w") as f:
            parse_dat.build_allele_fasta(dats["synth"], f)
        _gtf_on_chr6("chr6.gtf", ["GA", "GB"])
        argv = ["rna.fa", "chr6.gtf", "--gtf-gene-name-mapping", "GB:GA"]
        port, host = add_gene_coord.main, host_coord.main
        # add_gene_coord's `out` defaults to the sys.stdout of its import:
        # point both defaults at this test's captured stream
        for fn in (add_gene_coord.add_gene_coord,
                   host_coord.add_gene_coord):
            monkeypatch.setattr(fn, "__defaults__",
                                (sys.stdout,) + fn.__defaults__[1:])
    got = _main_stdout(capsys, port, argv)
    want = _main_stdout(capsys, host, argv)
    assert got == want and got
