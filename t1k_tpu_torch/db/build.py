"""Reference database construction driver (reference t1k-build.pl).

From an EMBL-ENA .dat file (or an IPD sequence FASTA) produce:
  <out>/<prefix>_dna_seq.fa   (genomic mode: introns + padding)
  <out>/<prefix>_rna_seq.fa   (transcript mode: UTR + exons)
  <out>/<prefix>_{rna,dna}_coord.fa  (optional, from a GTF annotation)

The IPD download URLs are kept for parity; in offline environments pass
a local .dat via -d.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .add_gene_coord import add_gene_coord
from .parse_dat import BuildOptions, build_allele_fasta

IPD_HLA_URL = "https://ftp.ebi.ac.uk/pub/databases/ipd/imgt/hla/hla.dat.zip"
IPD_KIR_URL = "https://ftp.ebi.ac.uk/pub/databases/ipd/kir/kir.dat"


def download_dat(name: str, outdir: str) -> str:
    """Fetch an IPD .dat release (requires network egress)."""
    import urllib.request
    import zipfile

    if name.upper() == "IPD-IMGT/HLA":
        path = os.path.join(outdir, "hla.dat.zip")
        urllib.request.urlretrieve(IPD_HLA_URL, path)
        with zipfile.ZipFile(path) as z:
            member = z.namelist()[0]
            out = os.path.join(outdir, "hla.dat")
            with z.open(member) as src, open(out, "wb") as dst:
                dst.write(src.read())
        return out
    if name.upper() == "IPD-KIR":
        out = os.path.join(outdir, "kir.dat")
        urllib.request.urlretrieve(IPD_KIR_URL, out)
        return out
    out = os.path.join(outdir, "t1k_ref.dat")
    urllib.request.urlretrieve(name, out)
    return out


def build_database(
    dat: Optional[str] = None,
    fasta: Optional[str] = None,
    download: Optional[str] = None,
    outdir: str = "./",
    prefix: str = "",
    gene: str = "",
    annotation: Optional[str] = None,
    ignore_partial: bool = False,
    partial_intron_has_no_seq: bool = False,
) -> dict:
    if not dat and not fasta and not download:
        raise ValueError("need a .dat file, a sequence fasta, or a download name")
    os.makedirs(outdir, exist_ok=True)
    if not dat and download:
        dat = download_dat(download, outdir)
    gene = gene.lower()  # t1k-build.pl:83 lowercases --target
    if not prefix:
        prefix = gene or (outdir.split("/")[0] if outdir != "./" else "T1K_ref")

    rna = os.path.join(outdir, f"{prefix}_rna_seq.fa")
    dna = os.path.join(outdir, f"{prefix}_dna_seq.fa")
    outputs = {"rna": rna}
    if dat:
        common = dict(gene_prefix=gene.upper(), ignore_partial=ignore_partial,
                      partial_intron_has_no_seq=partial_intron_has_no_seq)
        with open(dna, "w") as f:
            build_allele_fasta(dat, f, BuildOptions(mode="dna", **common))
        with open(rna, "w") as f:
            build_allele_fasta(dat, f, BuildOptions(mode="rna", **common))
        outputs["dna"] = dna
    else:
        # reheader an IPD sequence fasta: second token is the allele name
        with open(fasta) as src, open(rna, "w") as dst:
            for line in src:
                if line.startswith(">"):
                    cols = line[1:].split()
                    dst.write(f">{cols[1]}\n")
                else:
                    dst.write(line)

    if annotation:
        rc = os.path.join(outdir, f"{prefix}_rna_coord.fa")
        with open(rc, "w") as f:
            add_gene_coord(rna, annotation, out=f)
        outputs["rna_coord"] = rc
        if dat:
            dc = os.path.join(outdir, f"{prefix}_dna_coord.fa")
            with open(dc, "w") as f:
                add_gene_coord(dna, annotation, out=f)
            outputs["dna_coord"] = dc
    return outputs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="build the allele reference database")
    ap.add_argument("-d", dest="dat", default=None, help=".dat file")
    ap.add_argument("-f", dest="fasta", default=None, help="IPD sequence fasta")
    ap.add_argument("--download", default=None,
                    help="IPD-IMGT/HLA, IPD-KIR, or a URL")
    ap.add_argument("-o", dest="outdir", default="./")
    ap.add_argument("--prefix", default="")
    # flag names mirror t1k-build.pl: -g is the GTF annotation,
    # --target the gene keyword filter (-a kept as a -g alias)
    ap.add_argument("--target", dest="gene", default="")
    ap.add_argument("-g", "-a", dest="annotation", default=None,
                    help="GTF annotation file")
    ap.add_argument("--ignorePartial", action="store_true")
    ap.add_argument("--partialIntronHasNoSeq", action="store_true")
    args = ap.parse_args(argv)
    outputs = build_database(
        args.dat, args.fasta, args.download, args.outdir, args.prefix,
        args.gene, args.annotation, args.ignorePartial,
        args.partialIntronHasNoSeq)
    for k, v in outputs.items():
        print(f"{k}: {v}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
