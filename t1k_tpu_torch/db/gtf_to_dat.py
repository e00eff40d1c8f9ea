"""HPRC-style database generators (reference hprc_database/).

gtf_to_dat: genome FASTA + annotation GTF -> one .dat record per gene,
using the longest transcript's exon chain, 500bp padding, minus-strand
genes reverse-complemented (GtfToDat.pl).

process_multiple_genomes: run a liftoff-annotated GtfToDat pass per
assembly so each genome contributes one allele per gene
(ProcessMultipleGenomesToDat.pl; requires `liftoff` on PATH).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, TextIO

from .vcf_to_dat import _read_genome, _revcomp


def gtf_to_dat(genome_fa: str, gtf: str, out: TextIO, allele_id: str = "001",
               source: str = "", padding: int = 500,
               eof_flush: bool = False) -> int:
    # NOTE: the reference only records a transcript when a later one is
    # seen, so the file's final transcript is dropped; pass eof_flush=True
    # for the fixed behavior.
    genome, _ = _read_genome(genome_fa)

    exons: Dict[str, List] = {}
    strand_of: Dict[str, str] = {}
    prev_tname = "-1"
    gname = "-1"
    strand = "."
    rng: List = []

    def flush():
        if gname == "-1" or not rng:
            return
        r = list(rng)
        if len(r) > 3 and r[1] > r[4]:
            i, j = 0, len(r) - 3
            while i < j:
                r[i + 1], r[j + 1] = r[j + 1], r[i + 1]
                r[i + 2], r[j + 2] = r[j + 2], r[i + 2]
                i += 3
                j -= 3
        # the reference intends "longest transcript wins" but its length
        # helper reads a stale variable, so the first transcript always
        # wins; the gene STRAND however is overwritten on every flush
        # (GtfToDat.pl:90 sets it unconditionally), so a gene whose
        # transcripts disagree gets first-transcript exons with
        # last-transcript strand — reproduced faithfully
        if gname not in exons:
            exons[gname] = r
        strand_of[gname] = strand

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
            rng.extend([cols[0], int(cols[3]) - 1, int(cols[4]) - 1])
    if eof_flush:
        flush()

    n = 0
    for gname, allele_exon in exons.items():
        allele_exon = list(allele_exon)
        chrom = allele_exon[0]
        start = max(allele_exon[1] - padding, 0)
        end = min(allele_exon[-1] + padding, len(genome[chrom]) - 1)
        seq = genome[chrom][start:end + 1].upper()
        for i in range(0, len(allele_exon), 3):
            allele_exon[i + 1] -= start
            allele_exon[i + 2] -= start
        ln = len(seq)
        if strand_of[gname] == "-":
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

        allele = f"{gname}*{allele_id}"
        out.write(f"ID   {allele}\n")
        if source:
            out.write(f"DE   source {source} {allele}\n")
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


def process_multiple_genomes(genome_fa: str, ref_annotation: str,
                             out: TextIO, tmp_prefix: str = "tmp") -> None:
    """One allele per assembly via liftoff re-annotation
    (ProcessMultipleGenomesToDat.pl)."""
    genome, _ = _read_genome(genome_fa)
    names = list(genome.keys())
    ref_name = names[0]
    ref_tmp = f"{tmp_prefix}_ref.fa"
    genome_tmp = f"{tmp_prefix}_genome.fa"
    anno_tmp = f"{tmp_prefix}_genome.gtf"
    with open(ref_tmp, "w") as f:
        f.write(f">{ref_name}\n{genome[ref_name]}\n")
    try:
        for i, name in enumerate(names):
            with open(genome_tmp, "w") as f:
                f.write(f">{name}\n{genome[name]}\n")
            lifted = subprocess.run(
                ["liftoff", "-g", ref_annotation, genome_tmp, ref_tmp],
                check=True, capture_output=True, text=True).stdout
            with open(anno_tmp, "w") as f:
                for line in lifted.splitlines():
                    cols = line.split("\t")
                    if len(cols) > 1 and cols[1] == "Liftoff":
                        f.write(line + "\n")
            gtf_to_dat(genome_tmp, anno_tmp, out, f"{i + 1:03d}", name)
    finally:
        for p in (ref_tmp, genome_tmp, anno_tmp, genome_tmp + ".mmi",
                  ref_tmp + ".fai", genome_tmp + ".fai"):
            if os.path.exists(p):
                os.unlink(p)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="genome+GTF -> .dat records")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c1 = sub.add_parser("gtf")
    c1.add_argument("genome_fa")
    c1.add_argument("gtf")
    c1.add_argument("allele_id", nargs="?", default="001")
    c1.add_argument("source", nargs="?", default="")
    c2 = sub.add_parser("genomes")
    c2.add_argument("-g", dest="genome", required=True)
    c2.add_argument("-a", dest="annotation", required=True)
    c2.add_argument("--tmp", default="tmp")
    args = ap.parse_args(argv)
    if args.cmd == "gtf":
        gtf_to_dat(args.genome_fa, args.gtf, sys.stdout, args.allele_id,
                   args.source)
    else:
        process_multiple_genomes(args.genome, args.annotation, sys.stdout,
                                 args.tmp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
