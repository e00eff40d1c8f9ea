"""Attach genomic gene coordinates from a GTF to the allele FASTA
headers, producing the coordinate file used by the BAM extractor
(reference AddGeneCoord.pl: header becomes ``>allele chrom start end
strand``; genes absent from the GTF keep chr19 -1 -1 +)."""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Optional


def add_gene_coord(ref_fa: str, gtf: str, out=sys.stdout,
                   gene_name_mapping: str = "HFE:HLA-HFE") -> None:
    mapping = {}
    for pair in gene_name_mapping.split(","):
        if ":" in pair:
            a, b = pair.split(":", 1)
            mapping[a] = b

    gene_coord: Dict[str, str] = {}
    with open(ref_fa) as f:
        for line in f:
            if line.startswith(">"):
                # pass-1 key splits the whole chomped header on '*'
                # (AddGeneCoord.pl:44 does NOT take the first token), so
                # a header without '*' keys the full line incl. comment
                gene = line.rstrip("\n")[1:].split("*")[0]
                gene_coord[gene] = "chr19 -1 -1 +"

    with open(gtf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip().split("\t")
            if len(cols) < 9 or cols[2] != "gene":
                continue
            m = re.search(r'gene_name "(.*?)"', cols[8])
            if not m:
                raise ValueError(f"No gene_name: {line}")
            gname = mapping.get(m.group(1), m.group(1))
            chrom = cols[0] if cols[0].startswith("c") else "chr" + cols[0]
            if gname in gene_coord and gene_coord[gname].split(" ")[1] == "-1":
                gene_coord[gname] = " ".join([chrom, cols[3], cols[4], cols[6]])

    with open(ref_fa) as f:
        seq = ""
        for line in f:
            line = line.rstrip("\n")
            if not line.startswith(">"):
                seq += line
                continue
            if seq:
                out.write(seq + "\n")
            header = line.split()[0]
            gene = header[1:].split("*")[0]
            # a first-token gene missing from pass 1 (header with a
            # comment but no '*') prints an empty coordinate like the
            # reference's undef interpolation (AddGeneCoord.pl:99-100)
            out.write(f"{header} {gene_coord.get(gene, '')}\n")
            seq = ""
        if seq:
            out.write(seq + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="allele fasta + GTF -> coord fasta")
    ap.add_argument("ref_fa")
    ap.add_argument("gtf")
    ap.add_argument("--gtf-gene-name-mapping", default="HFE:HLA-HFE")
    args = ap.parse_args(argv)
    add_gene_coord(args.ref_fa, args.gtf,
                   gene_name_mapping=args.gtf_gene_name_mapping)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
