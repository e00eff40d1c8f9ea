"""Merge genotyping results from many samples/cells into an
allele x sample abundance matrix (reference t1k-merge.py).

Alleles are voted across samples by summed quality (only the first
member of an equal-allele group votes); alleles above the total-quality
threshold form the matrix columns, and each sample row reports the
abundance of its matching alleles plus an inconsistency column listing
calls that match no selected allele.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Optional


def merge_genotypes(files: List[str], num_allele_per_gene: int = 2,
                    qual: float = 0, total_qual: float = 30,
                    out=sys.stdout) -> Dict[str, float]:
    gene_alleles: Dict[str, Dict[str, float]] = {}
    for f in files:
        with open(f) as fp:
            for line in fp:
                cols = line.rstrip().split("\t")
                gene = cols[0]
                gene_alleles.setdefault(gene, {})
                for k, i in enumerate([2, 5]):
                    if k < int(cols[1]) and float(cols[i + 2]) > qual:
                        first = cols[i].split(",")[0]
                        gene_alleles[gene][first] = (
                            gene_alleles[gene].get(first, 0) + float(cols[i + 2]))

    final_alleles: Dict[str, float] = {}
    for gene, alleles in gene_alleles.items():
        ranked = sorted(alleles.keys(), key=lambda a: alleles[a], reverse=True)
        for allele in ranked[:num_allele_per_gene]:
            if alleles[allele] >= total_qual:
                final_alleles[allele] = alleles[allele]

    header = ["sample"] + sorted(final_alleles.keys()) + ["inconsistency"]
    out.write("\t".join(header) + "\n")
    for f in files:
        # int 0 until touched: the reference prints untouched cells as
        # "0", accumulated ones as floats (t1k-merge.py:62)
        sample_alleles = {a: 0 for a in final_alleles}
        inconsistent: List[str] = []
        with open(f) as fp:
            for line in fp:
                cols = line.rstrip().split("\t")
                for k, i in enumerate([2, 5]):
                    if k < int(cols[1]) and float(cols[i + 2]) > qual:
                        equal = cols[i].split(",")
                        conflict = True
                        for allele in equal:
                            if allele in final_alleles:
                                sample_alleles[allele] += float(cols[i + 1])
                                conflict = False
                                break
                        if conflict:
                            inconsistent.append("_".join(equal + cols[i + 1:i + 3]))
        sample = ".".join(f.split("/")[-1].split(".")[0:-1])
        if re.search("_genotype$", sample):
            sample = sample[:-9]
        row = [sample] + [str(sample_alleles[a]) for a in sorted(sample_alleles)]
        row += [",".join(inconsistent)]
        out.write("\t".join(row) + "\n")
    return final_alleles


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Combine the genotyping results from multiple files.")
    ap.add_argument("-l", dest="filelist", required=True)
    ap.add_argument("-n", dest="numAllelePerGene", type=int, default=2)
    ap.add_argument("-q", dest="qual", type=float, default=0)
    ap.add_argument("--tq", dest="totalQual", type=float, default=30)
    args = ap.parse_args(argv)
    with open(args.filelist) as f:
        files = [line.strip() for line in f if line.strip()]
    merge_genotypes(files, args.numAllelePerGene, args.qual, args.totalQual)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
