"""Post-hoc allele copy-number inference (reference t1k-copynumber.py).

Fits a one-copy Normal on sqrt-abundances of heterozygous genes (or a
user-given always-present gene list), then assigns each allele the
copy count 1..8 maximizing the scaled Normal log-likelihood.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Optional


def log_normal_likelihood(x: float, mu: float, var: float) -> float:
    sigma = math.sqrt(var)
    return -0.5 * ((x - mu) / sigma) ** 2 - math.log(sigma)


def infer_copy_number(gfile: str, nomissing: str = "", upper_quantile: float = 0.3,
                      lower_quantile: float = 0.0, adjust_var: float = 1.0,
                      qual: float = 0, out=sys.stdout) -> None:
    gene_rank: Dict[str, int] = {}
    gene_to_alleles: Dict[str, List[str]] = {}
    allele_info: Dict[str, dict] = {}
    # ordered like the reference's {g: 1 for g in split(",")} dict: the
    # iteration below accumulates floats in the user's comma order
    nomissing_genes = (dict.fromkeys(nomissing.split(","))
                       if nomissing else {})

    with open(gfile) as fp:
        for gi, line in enumerate(fp):
            cols = line.rstrip().split()
            gene_rank[cols[0]] = gi
            gene_to_alleles[cols[0]] = []
            for i in range(int(cols[1])):
                k = 2 if i == 0 else 5
                allele = cols[k]
                if int(cols[k + 2]) <= qual:
                    continue
                allele_info[allele] = {"abund": float(cols[k + 1])}
                gene_to_alleles[cols[0]].append(allele)

    abundances: List[float] = []
    used = 0
    for g in nomissing_genes:
        alleles = gene_to_alleles.get(g, [])
        if len(alleles) > 1:
            abundances.extend(math.sqrt(allele_info[a]["abund"]) for a in alleles)
        elif len(alleles) == 1:
            abundances.append(math.sqrt(allele_info[alleles[0]]["abund"]) / 2)
        used += len(alleles)

    start = int((len(allele_info) - used) * lower_quantile)
    end = int((len(allele_info) - used) * upper_quantile)
    # dict like the reference's heterAlleles: a homozygous gene reported
    # with the same allele name in both slots contributes ONE pool entry
    heter = dict.fromkeys(
        a for g, alleles in gene_to_alleles.items()
        if g not in nomissing_genes and len(alleles) > 1 for a in alleles)
    abundances.extend(sorted(math.sqrt(allele_info[a]["abund"]) for a in heter)[start:end])

    n = len(abundances)
    mean = sum(abundances) / n
    var = sum(a * a for a in abundances) / n - mean * mean
    var *= adjust_var

    for allele, info in allele_info.items():
        x = math.sqrt(info["abund"])
        lls = sorted(
            ((c + 1, log_normal_likelihood(x, mean * (c + 1), var * (c + 1)))
             for c in range(8)),
            key=lambda t: t[1], reverse=True)
        info["copy"] = lls[0][0]
        info["ratio"] = lls[0][1] - lls[1][1]

    for gene in sorted(gene_rank, key=lambda g: gene_rank[g]):
        line = f"{gene}\t{len(gene_to_alleles[gene])}"
        for i in range(2):
            if i < len(gene_to_alleles[gene]):
                a = gene_to_alleles[gene][i]
                line += "\t%s\t%d\t%.2f" % (a, allele_info[a]["copy"],
                                            allele_info[a]["ratio"])
            else:
                line += "\t.\t-1\t0"
        out.write(line + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Infer the allele copy number.")
    ap.add_argument("-g", dest="gfile", required=True)
    ap.add_argument("--nomissing", dest="nomissing", default="")
    ap.add_argument("--upper-quantile", dest="uq", type=float, default=0.3)
    ap.add_argument("--lower-quantile", dest="lq", type=float, default=0.0)
    ap.add_argument("--adjust-var", dest="av", type=float, default=1.0)
    ap.add_argument("-q", dest="qual", type=float, default=0)
    args = ap.parse_args(argv)
    infer_copy_number(args.gfile, args.nomissing, args.uq, args.lq, args.av,
                      args.qual)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
