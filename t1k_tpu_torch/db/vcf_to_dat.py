"""Custom-gene database construction from VCF allele definitions
(reference vcf_database/CombineVcf.pl + CombinedVcfToDat.pl).

combine_vcfs: one VCF per allele (file name encodes the allele, first
'_' becomes '*') -> a combined table, plus a default allele row.

vcf_to_dat: combined table + genome FASTA + GTF -> EMBL-ENA-style .dat
records (500bp UTR padding around the gene, variants applied with the
reference's running-offset semantics, minus-strand genes reverse-
complemented).  Records are emitted in first-appearance order (the
reference iterates a Perl hash, whose order is unspecified).
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Optional, TextIO


def combine_vcfs(default_allele: str, vcf_files: List[str], out: TextIO) -> None:
    chrom = "."
    for fname in vcf_files:
        # CombineVcf.pl:26-28 re-applies s/.vcf// and s/_/*/ to the
        # ALREADY-transformed name on every data line, so a filename
        # with several underscores yields a progressively different
        # allele name per variant row — mirrored
        name = fname
        with open(fname) as fp:
            for line in fp:
                if line.startswith("#"):
                    continue
                cols = line.split()
                chrom = cols[0]
                name = re.sub(r"_", "*", re.sub(r".vcf", "", name, count=1),
                              count=1)
                name = os.path.basename(name)
                out.write("\t".join([name] + cols[0:7]) + "\n")
    out.write("\t".join([default_allele, chrom, "0", ".", ".", ".", ".", "."]) + "\n")


def _read_genome(path: str):
    genome: Dict[str, str] = {}
    has_chr_prefix = False
    chrom, parts = "", []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if chrom:
                    genome[chrom] = "".join(parts)
                chrom = line[1:].split()[0]
                if chrom.startswith("c"):
                    has_chr_prefix = True
                parts = []
            else:
                parts.append(line.strip())
    if chrom:
        genome[chrom] = "".join(parts)
    return genome, has_chr_prefix


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def vcf_to_dat(genome_fa: str, gtf: str, combined_vcf: str, out: TextIO,
               padding: int = 500, eof_flush: bool = False) -> int:
    # NOTE: like the reference, the final transcript of the GTF is only
    # recorded when a later transcript follows; eof_flush=True fixes this.
    genome, has_chr_prefix = _read_genome(genome_fa)

    # alleles and their variant lines
    vcf: Dict[str, List[List[str]]] = {}
    interested: Dict[str, str] = {}
    with open(combined_vcf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.split()
            gene = cols[0].split("*")[0]
            interested.setdefault(gene, ".")
            vcf.setdefault(cols[0], []).append(cols[1:])

    # exon ranges of the first transcript per gene
    exons: Dict[str, List] = {}
    strand_of: Dict[str, str] = {}
    prev_tname = "-1"
    gname = "-1"
    strand = "."
    rng: List = []

    def flush():
        if interested.get(gname, None) == "." and rng:
            interested[gname] = strand
            r = list(rng)
            if len(r) > 3 and r[1] > r[4]:
                i, j = 0, len(r) - 3
                while i < j:
                    r[i + 1], r[j + 1] = r[j + 1], r[i + 1]
                    r[i + 2], r[j + 2] = r[j + 2], r[i + 2]
                    i += 3
                    j -= 3
            exons[gname] = r

    with open(gtf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip().split("\t")
            if len(cols) < 9 or cols[2] != "exon":
                continue
            m = re.search(r'transcript_name "(.*?)"', cols[8])
            if not m:
                raise ValueError(f"No transcript_name: {line}")
            tname = m.group(1)
            if tname != prev_tname:
                flush()
                prev_tname = tname
                m2 = re.search(r'gene_name "(.*?)"', cols[8])
                if not m2:
                    raise ValueError(f"No gene_name: {line}")
                gname = m2.group(1).upper()
                strand = cols[6]
                rng = []
            chrom = cols[0]
            if has_chr_prefix and not chrom.startswith("c"):
                chrom = "chr" + chrom
            elif not has_chr_prefix and chrom.startswith("c"):
                chrom = chrom[3:]
            rng.extend([chrom, int(cols[3]) - 1, int(cols[4]) - 1])
    if eof_flush:
        flush()

    n = 0
    for allele, allele_vcf in vcf.items():
        gname = allele.split("*")[0]
        allele_exon = list(exons[gname])
        chrom = allele_exon[0]
        start = max(allele_exon[1] - padding, 0)
        end = min(allele_exon[-1] + padding, len(genome[chrom]) - 1)
        seq = genome[chrom][start:end + 1]
        offset = start
        first_offset = start

        for v in allele_vcf:
            pos = int(v[1]) - 1 - offset
            if pos >= len(seq):
                continue
            ref, alt = v[3], v[4]
            if ref != "." and alt != ".":
                seq = seq[:pos] + alt + seq[pos + len(ref):]
                offset += len(ref) - len(alt)
            elif ref == "." and alt != ".":
                seq = seq[:pos] + alt + seq[pos:]
                offset -= len(alt)
            elif ref != "." and alt == ".":
                seq = seq[:pos] + seq[pos + len(ref):]
                offset += len(ref)

        for i in range(0, len(allele_exon), 3):
            allele_exon[i + 1] -= first_offset
            allele_exon[i + 2] -= first_offset

        for v in allele_vcf:
            pos = int(v[1]) - 1
            ref, alt = v[3], v[4]
            if ref != "." and alt != ".":
                shift = len(ref) - len(alt)
            elif ref == "." and alt != ".":
                shift = len(alt)
            elif ref != "." and alt == ".":
                shift = -len(ref)
            else:
                continue
            for i in range(0, len(allele_exon), 3):
                if allele_exon[i + 1] >= pos:
                    allele_exon[i + 1] += shift
                if allele_exon[i + 2] >= pos:
                    allele_exon[i + 2] += shift

        seq = seq.upper()
        ln = len(seq)
        if interested[gname] == "-":
            seq = _revcomp(seq)
            i, j = 0, len(allele_exon) - 3
            while i < j:
                allele_exon[i + 1], allele_exon[j + 1] = allele_exon[j + 1], allele_exon[i + 1]
                allele_exon[i + 2], allele_exon[j + 2] = allele_exon[j + 2], allele_exon[i + 2]
                i += 3
                j -= 3
            for i in range(0, len(allele_exon), 3):
                allele_exon[i + 1], allele_exon[i + 2] = (
                    ln - 1 - allele_exon[i + 2], ln - 1 - allele_exon[i + 1])

        out.write(f"ID   {allele}\n")
        out.write(f'FT   allele="{allele}"\n')
        if allele_exon[1] > 0:
            out.write(f"FT   UTR            1..{allele_exon[1]}\n")
        for i in range(0, len(allele_exon), 3):
            out.write(f"FT   exon          {allele_exon[i + 1] + 1}.."
                      f"{allele_exon[i + 2] + 1}\n")
            if i + 3 < len(allele_exon):
                out.write(f"FT   intron        {allele_exon[i + 2] + 2}.."
                          f"{allele_exon[i + 4]}\n")
        if allele_exon[-1] < ln - 1:
            out.write(f"FT   UTR            {allele_exon[-1] + 2}..{ln}\n")
        out.write(f"SQ  Sequence {ln} BP\n")
        out.write(f"{seq} {ln}\n")
        out.write("//\n")
        n += 1
    return n


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="VCF allele set -> .dat database")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c1 = sub.add_parser("combine", help="combine per-allele vcf files")
    c1.add_argument("default_allele")
    c1.add_argument("vcf_list", help="file listing vcf paths")
    c2 = sub.add_parser("todat", help="combined vcf -> .dat")
    c2.add_argument("genome_fa")
    c2.add_argument("gtf")
    c2.add_argument("combined_vcf")
    args = ap.parse_args(argv)
    if args.cmd == "combine":
        with open(args.vcf_list) as f:
            files = [line.strip() for line in f if line.strip()]
        combine_vcfs(args.default_allele, files, sys.stdout)
    else:
        vcf_to_dat(args.genome_fa, args.gtf, args.combined_vcf, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
