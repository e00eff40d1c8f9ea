"""Single-gene variant-panel reference builder (cDNA-name driven).

Generalization of the reference's CFTR2 pipeline
(reference CFTR/1_Create_Reference_Files/*.py, CFTR/all_README.sh): a
gene's transcript model plus a list of variants named in cDNA (HGVS-like)
notation becomes a mimic-Ensembl ``.dat`` whose records feed the standard
database builder (db/parse_dat.py) and then the genotyper with
``--alleleDelimiter : --alleleDigitUnits 1``.

Pipeline mirrored (behavior, generalized away from CFTR specifics):

* exon/intron coordinate mapping with cumulative gene-local positions
  (reference cftr_exon_intron_coordinate_mapper.py),
* cDNA position -> gene-local DNA position, including ``+n``/``-n``
  intronic offsets and the transcript 5'-UTR shift (reference
  VariantMappingAndMutantEnsemblFormatUtils.py:37-81 — the CFTR-specific
  ``+69/+70`` constants become ``utr5_len``-derived),
* variant application (SNV / del / ins / dup / delins and compound
  ``c.[a;b]`` alleles) with per-region length adjustment (ibid.:252-684),
* protein-family grouping into ``GENE*%04d:%04d`` allele ids
  (ibid.:783-823),
* combined-allele expansion: every variant with frequency >= threshold
  pairs with every other variant
  (reference Variant_Integration_Ensembl_Formatting.py:91-155),
* tab-style mimic-Ensembl ``.dat`` export (ibid. export_to_dat:826-880).
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

CODON_TABLE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}


def translate(cdna: str) -> str:
    """Translate from the first ATG, stopping at a stop codon."""
    s = cdna.upper()
    start = s.find("ATG")
    if start < 0:
        return ""
    out = []
    for i in range(start, len(s) - 2, 3):
        aa = CODON_TABLE.get(s[i:i + 3], "X")
        out.append(aa)
        if aa == "*":
            break
    return "".join(out)


@dataclass
class Region:
    label: str       # "UTR", "exon<N>", "intron<N>"
    start: int       # gene-local, 0-based inclusive
    end: int


@dataclass
class TranscriptModel:
    """Gene-local transcript model.

    ``genome`` is the gene-local genomic sequence (5' flank + gene body +
    3' flank); ``exons`` are 0-based inclusive spans into it; ``utr5_len``
    is the length of the transcript 5' UTR (the cDNA position c.1 maps to
    transcript position utr5_len, mirroring the reference's +69 shift for
    CFTR)."""

    genome: str
    exons: List[Tuple[int, int]]
    utr5_len: int
    gene: str = "GENE"

    regions: List[Region] = field(default_factory=list)

    def __post_init__(self):
        self.genome = self.genome.upper()
        regs: List[Region] = []
        if self.exons[0][0] > 0:
            regs.append(Region("UTR", 0, self.exons[0][0] - 1))
        for i, (s, e) in enumerate(self.exons):
            regs.append(Region(f"exon{i + 1}", s, e))
            if i + 1 < len(self.exons):
                regs.append(Region(f"intron{i + 1}", e + 1,
                                   self.exons[i + 1][0] - 1))
        if self.exons[-1][1] < len(self.genome) - 1:
            regs.append(Region("UTR", self.exons[-1][1] + 1,
                               len(self.genome) - 1))
        self.regions = regs

        # transcript (RNA) position of each exon base, in order
        self._dna_of_rna: List[int] = []
        for s, e in self.exons:
            self._dna_of_rna.extend(range(s, e + 1))

    @classmethod
    def from_coords_csv(cls, path: str, genome: str, utr5_len: int,
                        gene: str = "GENE") -> "TranscriptModel":
        """Exon rows from a coordinate CSV with columns including
        ``type`` (exon rows used), ``pos1``, ``pos2`` in gene-local
        1-based coordinates (reference coordinate-mapper CSV layout)."""
        exons = []
        with open(path) as f:
            for row in csv.DictReader(f):
                if row["type"].strip().lower() == "exon":
                    exons.append((int(row["pos1"]) - 1, int(row["pos2"]) - 1))
        exons.sort()
        return cls(genome=genome, exons=exons, utr5_len=utr5_len, gene=gene)

    # ---------------------------------------------------------- coordinates
    def cdna_to_dna(self, token: str) -> int:
        """cDNA position token -> gene-local DNA position (0-based).

        Handles plain positions (``123``), 5'-UTR negatives (``-5``) and
        intronic offsets (``123+45`` / ``124-3``), mirroring the
        reference's adjusted-number logic
        (VariantMappingAndMutantEnsemblFormatUtils.py:37-81)."""
        token = token.strip()
        m = re.match(r"^(-?\d+)([+-]\d+)$", token)
        if m:
            base = int(m.group(1))
            off = int(m.group(2))
        else:
            base = int(token)
            off = 0
        # c.1 is the first coding base: transcript index utr5_len.
        # Negative cDNA positions (5' UTR) have no position 0, hence the
        # extra +1 (the reference's +69 vs +70 pair).
        rna = base + self.utr5_len - 1 if base > 0 else base + self.utr5_len
        if rna < 0 or rna >= len(self._dna_of_rna):
            raise ValueError(f"cDNA position {token} outside transcript")
        return self._dna_of_rna[rna] + off

    def region_index_of(self, pos: int) -> int:
        for i, r in enumerate(self.regions):
            if r.start <= pos <= r.end:
                return i
        raise ValueError(f"position {pos} outside gene")


# -------------------------------------------------------------- variants
@dataclass
class Edit:
    """A single sequence edit in gene-local DNA coordinates."""
    kind: str        # "sub" | "del" | "ins" | "dup" | "delins"
    start: int       # 0-based inclusive
    end: int         # 0-based inclusive (== start for point edits / ins anchor)
    alt: str = ""    # inserted/substituted bases
    ref: str = ""    # declared reference bases (validated when present)


_CDNA_SPECIAL = {
    # reference clean_cdna_name SPECIAL_CASES analog: non-standard names
    # normalized before parsing; extend as panels require
}

_POS = r"(-?\d+(?:[+-]\d+)?)"


def parse_cdna_variant(name: str, model: TranscriptModel) -> List[Edit]:
    """Parse one cDNA variant name (possibly compound ``c.[a;b]``) into
    gene-local edits."""
    name = name.strip()
    for pat, repl in _CDNA_SPECIAL.items():
        name = name.replace(pat, repl)
    if name.startswith("c.[") and name.endswith("]"):
        parts = name[3:-1].split(";")
        edits: List[Edit] = []
        for p in parts:
            edits.extend(parse_cdna_variant("c." + p.strip(), model))
        return edits
    if name.startswith("c."):
        name = name[2:]

    m = re.match(rf"^{_POS}([ACGT])>([ACGT])$", name)
    if m:
        pos = model.cdna_to_dna(m.group(1))
        return [Edit("sub", pos, pos, alt=m.group(3), ref=m.group(2))]

    m = re.match(rf"^{_POS}(?:_{_POS})?delins([ACGT]+)$", name)
    if m:
        s = model.cdna_to_dna(m.group(1))
        e = model.cdna_to_dna(m.group(2)) if m.group(2) else s
        return [Edit("delins", s, e, alt=m.group(3))]

    m = re.match(rf"^{_POS}(?:_{_POS})?del([ACGT]*)$", name)
    if m:
        s = model.cdna_to_dna(m.group(1))
        e = model.cdna_to_dna(m.group(2)) if m.group(2) else s
        return [Edit("del", s, e, ref=m.group(3))]

    m = re.match(rf"^{_POS}_{_POS}ins([ACGT]+)$", name)
    if m:
        s = model.cdna_to_dna(m.group(1))
        return [Edit("ins", s, s, alt=m.group(3))]

    m = re.match(rf"^{_POS}(?:_{_POS})?dup([ACGT]*)$", name)
    if m:
        s = model.cdna_to_dna(m.group(1))
        e = model.cdna_to_dna(m.group(2)) if m.group(2) else s
        return [Edit("dup", s, e)]

    raise ValueError(f"unsupported cDNA variant name: c.{name}")


def apply_edits(model: TranscriptModel, edits: Sequence[Edit]
                ) -> Tuple[str, List[Tuple[str, int]]]:
    """Apply edits to the gene-local genome; returns the mutant sequence
    and the adjusted (region_label, length) list.  Each indel adjusts the
    length of its containing region (reference final_bp_counts)."""
    lengths = [(r.label, r.end - r.start + 1) for r in model.regions]
    deltas = [0] * len(lengths)
    seq = model.genome

    for ed in sorted(edits, key=lambda e: e.start, reverse=True):
        ri = model.region_index_of(ed.start)
        if ed.kind == "sub":
            if ed.ref and seq[ed.start] != ed.ref:
                raise ValueError(
                    f"reference mismatch at {ed.start}: "
                    f"{seq[ed.start]} != {ed.ref}")
            seq = seq[:ed.start] + ed.alt + seq[ed.start + 1:]
        elif ed.kind == "del":
            if ed.ref and seq[ed.start:ed.end + 1] != ed.ref:
                raise ValueError(f"reference mismatch for del at {ed.start}")
            seq = seq[:ed.start] + seq[ed.end + 1:]
            deltas[ri] -= ed.end - ed.start + 1
        elif ed.kind == "ins":
            # inserted after the anchor base (HGVS a_b ins semantics)
            seq = seq[:ed.start + 1] + ed.alt + seq[ed.start + 1:]
            deltas[ri] += len(ed.alt)
        elif ed.kind == "dup":
            dup = seq[ed.start:ed.end + 1]
            seq = seq[:ed.end + 1] + dup + seq[ed.end + 1:]
            deltas[ri] += len(dup)
        elif ed.kind == "delins":
            removed = ed.end - ed.start + 1
            seq = seq[:ed.start] + ed.alt + seq[ed.end + 1:]
            deltas[ri] += len(ed.alt) - removed
        else:
            raise ValueError(ed.kind)

    return seq, [(lab, ln + d) for (lab, ln), d in zip(lengths, deltas)]


def _layout(lengths: Sequence[Tuple[str, int]]
            ) -> List[Tuple[str, int, int]]:
    """(label, length) -> (label, pos0, pos1) continuous layout
    (reference create_mutant_Ensembl_format)."""
    out = []
    p = 0
    for lab, ln in lengths:
        out.append((lab, p, p + ln - 1))
        p += ln
    return out


@dataclass
class AlleleRecord:
    name: str           # legacy / cDNA display name
    seq: str
    layout: List[Tuple[str, int, int]]
    cdna: str
    protein: str
    allele_id: str = ""


def build_allele(model: TranscriptModel, cdna_name: str,
                 display_name: Optional[str] = None) -> AlleleRecord:
    edits = parse_cdna_variant(cdna_name, model) if cdna_name else []
    seq, lengths = apply_edits(model, edits)
    layout = _layout(lengths)
    cdna = "".join(seq[p0:p1 + 1] for lab, p0, p1 in layout
                   if lab.startswith("exon"))
    return AlleleRecord(name=display_name or cdna_name or "REF", seq=seq,
                        layout=layout, cdna=cdna,
                        protein=translate(cdna[model.utr5_len:]))


def expand_combined(variants: List[dict], freq_threshold: float
                    ) -> List[dict]:
    """Original variants plus every (top x other) combined pair
    (reference Variant_Integration_Ensembl_Formatting.py:91-155)."""
    out = [dict(v) for v in variants]
    top = [v for v in variants
           if float(v.get("freq", 0) or 0) >= freq_threshold]
    for vi in top:
        for vj in variants:
            if vj["cdna"] == vi["cdna"]:
                continue
            ci = vi["cdna"].removeprefix("c.").strip("[]")
            cj = vj["cdna"].removeprefix("c.").strip("[]")
            out.append({
                "cdna": f"c.[{ci};{cj}]",
                "name": f"{vi.get('name', vi['cdna'])};"
                        f"{vj.get('name', vj['cdna'])}",
                "freq": 0.0,
            })
    return out


def build_database(model: TranscriptModel, variants: List[dict],
                   freq_threshold: float = 0.01,
                   include_reference: bool = True) -> List[AlleleRecord]:
    """Variant dicts ({'cdna', 'name', 'freq'}) -> allele records with
    GENE*family:allele ids (family = distinct protein sequence)."""
    expanded = expand_combined(variants, freq_threshold)
    records: List[AlleleRecord] = []
    if include_reference:
        records.append(build_allele(model, "", display_name="reference"))
    for v in expanded:
        try:
            records.append(build_allele(model, v["cdna"],
                                        v.get("name") or v["cdna"]))
        except ValueError as exc:
            print(f"variant_gene_db: skipping {v['cdna']}: {exc}",
                  file=sys.stderr)

    family_of: Dict[str, int] = {}
    counts: Dict[int, int] = {}
    for rec in records:
        fam = family_of.setdefault(rec.protein, len(family_of) + 1)
        counts[fam] = counts.get(fam, 0) + 1
        rec.allele_id = f"{model.gene}*{fam:04d}:{counts[fam]:04d}"
    return records


def export_dat(records: Sequence[AlleleRecord], path: str) -> None:
    """Tab-style mimic-Ensembl export (reference export_to_dat)."""
    with open(path, "w") as f:
        for rec in records:
            f.write(f"ID\t{rec.allele_id}\n")
            f.write(f"DE\t{rec.allele_id}\n")
            f.write(f'FT\t/allele="{rec.allele_id}"\n')
            total = 0
            for lab, p0, p1 in rec.layout:
                total = max(total, p1 + 1)
                m = re.match(r"^(exon|intron)(\d+)$", lab)
                if m:
                    f.write(f"FT\t{m.group(1):<15}{p0 + 1}..{p1 + 1}\n")
                    f.write(f'FT\t{" " * 15}/number="{m.group(2)}"\n')
            f.write(f"SQ\tSequence {total} BP;\n")
            seq = rec.seq.lower()
            written = 0
            for i in range(0, len(seq), 60):
                chunk = seq[i:i + 60]
                written += len(chunk)
                groups = " ".join(chunk[j:j + 10]
                                  for j in range(0, len(chunk), 10))
                f.write(f"        {groups:<65}{str(written).rjust(8)}\n")
            f.write("//\n")


def read_variant_table(path: str) -> List[dict]:
    """TSV/CSV with columns: cdna, name (optional), freq (optional).
    The cdna column may carry ``|``-separated alternatives, each of which
    becomes its own variant (reference 'or' explode)."""
    delim = "\t" if path.endswith((".tsv", ".txt")) else ","
    out = []
    with open(path) as f:
        for row in csv.DictReader(f, delimiter=delim):
            for alt in row["cdna"].split("|"):
                out.append({
                    "cdna": alt.strip(),
                    "name": (row.get("name") or "").strip() or alt.strip(),
                    "freq": float(row.get("freq") or 0),
                })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Build a single-gene variant-panel .dat "
                    "(generalized CFTR2 pipeline)")
    ap.add_argument("--genome", required=True,
                    help="gene-local genomic FASTA (one record)")
    ap.add_argument("--coords", required=True,
                    help="exon coordinate CSV (type,pos1,pos2; 1-based)")
    ap.add_argument("--variants", required=True,
                    help="variant table (cdna[,name][,freq])")
    ap.add_argument("--gene", default="GENE")
    ap.add_argument("--utr5-len", type=int, required=True)
    ap.add_argument("--allele-threshold", type=float, default=0.01)
    ap.add_argument("-o", "--output", required=True, help=".dat output")
    args = ap.parse_args(argv)

    from ..io.reads import read_seq_file

    genome = next(iter(read_seq_file(args.genome))).seq
    model = TranscriptModel.from_coords_csv(args.coords, genome,
                                            args.utr5_len, args.gene)
    variants = read_variant_table(args.variants)
    records = build_database(model, variants, args.allele_threshold)
    export_dat(records, args.output)
    print(f"wrote {len(records)} alleles to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
