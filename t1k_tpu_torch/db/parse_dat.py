"""EMBL-ENA .dat -> allele FASTA database builder.

Behavior contract: reference ParseDatFile.pl.  Modes:
  rna    — 50bp UTR pad + concatenated exons,
  dna    — exons with `intronPadding`bp intron flanks, introns separated
           by a single 'N'; short introns merge their exons,
  genome — the full record.

Also reproduced: partial-allele rescue (rna: length check; dna: fill
missing introns with the per-gene modal intron sequence), deterministic
random UTR padding (seeded with the same PRNG stream the reference
uses — Perl srand(17)/rand == drand48), exonization trimming against
modal exon/intron lengths, gene-modal final-length trimming, and the
output header `>allele exonCnt e1s e1e ...` with 0-based inclusive
coordinates.  String-style tie-breaking in mode selection matches the
reference's FindMode (ties pick the string-greatest key).
"""

from __future__ import annotations

import argparse
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple


class PerlRand:
    """Perl's rand()/srand() on Linux == drand48."""

    def __init__(self, seed: int):
        self.x = ((seed << 16) | 0x330E) % (1 << 48)

    def rand(self) -> float:
        self.x = (0x5DEECE66D * self.x + 0xB) % (1 << 48)
        return self.x / (1 << 48)

    def randint(self, n: int) -> int:
        return int(self.rand() * n)


def find_mode(dist: Dict) -> object:
    """Most frequent key; ties pick the string-greatest key
    (ParseDatFile.pl FindMode)."""
    ret, mx = -1, -1
    for k, cnt in dist.items():
        if cnt > mx:
            mx = cnt
            ret = k
        elif cnt == mx and str(k) >= str(ret):
            ret = k
    return ret


@dataclass
class DatRecord:
    allele: str
    seq: str
    exons: List[int]            # flattened true 0-based inclusive coords
    is_partial: bool


def parse_dat_records(fp: TextIO, partial_intron_has_no_seq: bool = False):
    """Stream (allele, sequence, exon coords, partial flag) records."""
    exons: List[int] = []
    seq_parts: List[str] = []
    allele = "-1"
    is_partial = False
    has_intron = 0
    partial_intron_len = 0
    local_intron_len = 0
    description_state = 0
    pseudo_exon_len = 0
    in_sq = False

    for line in fp:
        if in_sq:
            if line.startswith("//"):
                in_sq = False
                seq = "".join(seq_parts)
                yield DatRecord(allele, seq, list(exons), is_partial), has_intron
                continue
            cols = line.split()
            seq_parts.extend(cols[:-1])
            continue
        if line.startswith("ID"):
            exons = []
            has_intron = 0
            partial_intron_len = 0
            is_partial = False
            seq_parts = []
            allele = "-1"
            pseudo_exon_len = 0
        elif line.startswith("FT"):
            m = re.search(r'allele="(.*?)"', line)
            if m:
                allele = m.group(1)
            elif re.search(r"\sexon\s", line):
                cols = line.split()
                m = re.search(r"(\d+)\.\.(\d+)", cols[2])
                start, end = int(m.group(1)), int(m.group(2))
                exons.extend([start - 1 - partial_intron_len,
                              end - 1 - partial_intron_len])
                description_state = 0
                pseudo_exon_len = 0
            elif line.rstrip().endswith("pseudo"):
                end = exons.pop()
                start = exons.pop()
                pseudo_exon_len = end - start + 1
            elif re.search(r"\sintron\s", line):
                if partial_intron_has_no_seq:
                    cols = line.split()
                    m = re.search(r"(\d+)\.\.(\d+)", cols[2])
                    local_intron_len = int(m.group(2)) - int(m.group(1)) + 1
                has_intron += 1
                description_state = 1
            elif line.rstrip().endswith("partial"):
                if description_state == 0 or not partial_intron_has_no_seq:
                    is_partial = True
                else:
                    partial_intron_len += local_intron_len
                    has_intron -= 1
                if pseudo_exon_len > 0 and partial_intron_has_no_seq:
                    partial_intron_len += pseudo_exon_len
        elif line.startswith("SQ"):
            in_sq = True


@dataclass
class BuildOptions:
    mode: str = "rna"                  # rna | dna | genome
    gene_prefix: str = ""
    ignore_partial: bool = False
    partial_in_rna_mode: int = 0       # includePartialDiffLen
    partial_intron_has_no_seq: bool = False
    intron_padding: int = 200
    dedup: bool = False


def build_allele_fasta(dat_path: str, out: TextIO,
                       opts: Optional[BuildOptions] = None) -> int:
    opts = opts or BuildOptions()
    mode = opts.mode
    utr_length = 0 if mode == "genome" else 50
    fix_gene_length = mode in ("rna", "dna")
    include_partial_diff = (-1 if mode == "genome"
                            else opts.partial_in_rna_mode)
    pad = opts.intron_padding

    partial_alleles: Dict[str, bool] = {}
    allele_order: List[str] = []
    allele_seq: Dict[str, str] = {}
    gene5: Dict[str, str] = {}
    gene5_best: Dict[str, str] = {}
    gene3: Dict[str, str] = {}
    gene3_best: Dict[str, str] = {}
    allele_padding: Dict[str, List[int]] = {}
    allele_eff_len: Dict[str, int] = {}
    allele_exon_regions: Dict[str, List[int]] = {}
    allele_true_exons: Dict[str, List[int]] = {}
    gene_last_exon_dist: Dict[str, Dict[int, int]] = {}

    with open(dat_path) as fp:
        for rec, has_intron in parse_dat_records(fp, opts.partial_intron_has_no_seq):
            allele, seq, exons = rec.allele, rec.seq, rec.exons
            if rec.is_partial:
                partial_alleles[allele] = True
            if mode == "genome" and has_intron == 0 and len(exons) > 2:
                continue
            if allele == "-1" or not exons:
                continue

            output_seq = ""
            start = exons[0] - utr_length
            end = exons[0] - 1
            gene = allele.split("*")[0]
            allele_padding[allele] = [0, 0]
            exon_actual: List[int] = []

            if start < 0:
                allele_padding[allele][0] = -start
                if gene not in gene5_best or end > len(gene5_best[gene]):
                    gene5_best[gene] = seq[0:end].upper()
                start = 0
            elif gene not in gene5:
                gene5[gene] = seq[start:end + 1].upper()
            output_seq += seq[start:end + 1]

            exon_offset = utr_length
            if mode == "rna":
                for i in range(0, len(exons), 2):
                    output_seq += seq[exons[i]:exons[i + 1] + 1]
                    exon_actual.append(exon_offset)
                    exon_actual.append(exon_offset + exons[i + 1] - exons[i])
                    exon_offset += exons[i + 1] - exons[i] + 1
            elif mode == "dna":
                for i in range(2, len(exons), 2):
                    if exons[i] <= exons[i - 1] + 1:
                        partial_alleles[allele] = True
                i = 0
                while i < len(exons):
                    start = exons[i]
                    end = exons[i + 1]
                    if i > 0:
                        start = max(exons[i] - pad, 0)
                        exon_offset += 1 + pad  # +1 for the 'N' separator
                        output_seq += "N"
                    exon_actual.append(exon_offset)
                    exon_actual.append(exon_offset + exons[i + 1] - exons[i])
                    k = i
                    while i + 2 < len(exons):
                        end = exons[i + 1] + pad
                        if end >= len(seq):
                            end = len(seq) - 1
                        if end >= exons[i + 2] - pad:
                            i += 2
                            end = exons[i + 1]
                            exon_actual.append(exon_offset + exons[i] - exons[k])
                            exon_actual.append(exon_offset + exons[i + 1] - exons[k])
                        else:
                            break
                    output_seq += seq[start:end + 1]
                    exon_offset += exons[i + 1] - exons[k] + 1
                    exon_offset += pad
                    i += 2
                allele_true_exons[allele] = list(exons)
            elif mode == "genome":
                for i in range(2, len(exons), 2):
                    if exons[i] <= exons[i - 1] + 1:
                        partial_alleles[allele] = True
                output_seq = seq
                exon_actual = list(exons)
            else:
                raise ValueError(f"unknown mode {mode}")

            last_exon_len = exons[-1] - exons[-2] + 1
            gene_last_exon_dist.setdefault(gene, {})
            gene_last_exon_dist[gene][last_exon_len] = (
                gene_last_exon_dist[gene].get(last_exon_len, 0) + 1)

            # 3' UTR
            start = exons[-1] + 1
            if start > len(seq):
                partial_alleles[allele] = True
            else:
                end = start + utr_length - 1
                if end >= len(seq):
                    allele_padding[allele][1] = end - len(seq) + 1
                    if gene not in gene3_best or len(seq) - start > len(gene3_best[gene]):
                        gene3_best[gene] = seq[start:].upper()
                    end = len(seq) - 1
                elif gene not in gene3:
                    gene3[gene] = seq[start:end + 1].upper()
                output_seq += seq[start:end + 1]

            output_seq = output_seq.upper()
            if allele not in partial_alleles:
                allele_order.append(allele)
            allele_seq[allele] = output_seq
            allele_exon_regions[allele] = exon_actual
            eff = 2 * utr_length
            for i in range(0, len(exons), 2):
                eff += exons[i + 1] - exons[i] + 1
            allele_eff_len[allele] = eff

    # ---- statistics for dna mode
    gene_len_dist: Dict[str, Dict[int, int]] = {}
    gene_len_mode: Dict[str, int] = {}
    gene_exon_cnt_dist: Dict[str, Dict[int, int]] = {}
    gene_exon_cnt_mode: Dict[str, int] = {}
    gene_exon_len_mode: Dict[str, Dict[int, int]] = {}
    gene_true_intron_mode: Dict[str, Dict[int, int]] = {}
    if mode == "dna":
        for allele in allele_order:
            gene = allele.split("*")[0]
            gene_len_dist.setdefault(gene, {})
            le = allele_eff_len[allele]
            gene_len_dist[gene][le] = gene_len_dist[gene].get(le, 0) + 1
            cnt = len(allele_exon_regions[allele]) // 2
            gene_exon_cnt_dist.setdefault(gene, {})
            gene_exon_cnt_dist[gene][cnt] = gene_exon_cnt_dist[gene].get(cnt, 0) + 1
        for gene, d in gene_len_dist.items():
            gene_len_mode[gene] = find_mode(d)
        for gene, d in gene_exon_cnt_dist.items():
            gene_exon_cnt_mode[gene] = find_mode(d)

        gene_exon_len_dist: Dict[str, Dict[int, Dict[int, int]]] = {}
        gene_true_intron_dist: Dict[str, Dict[int, Dict[int, int]]] = {}
        for allele in allele_order:
            gene = allele.split("*")[0]
            # the reference double-counts the length distribution here;
            # harmless for the mode, mirrored for exactness
            le = allele_eff_len[allele]
            gene_len_dist[gene][le] = gene_len_dist[gene].get(le, 0) + 1
            exons = allele_exon_regions[allele]
            true_exons = allele_true_exons[allele]
            cnt = len(exons) // 2
            if cnt != gene_exon_cnt_mode[gene]:
                continue
            for i in range(cnt):
                ln = exons[2 * i + 1] - exons[2 * i] + 1
                gene_exon_len_dist.setdefault(gene, {}).setdefault(i, {})
                gene_exon_len_dist[gene][i][ln] = gene_exon_len_dist[gene][i].get(ln, 0) + 1
                if i < cnt - 1:
                    il = true_exons[2 * i + 2] - true_exons[2 * i + 1] - 1
                    gene_true_intron_dist.setdefault(gene, {}).setdefault(i, {})
                    gene_true_intron_dist[gene][i][il] = (
                        gene_true_intron_dist[gene][i].get(il, 0) + 1)
        for gene, d in gene_exon_len_dist.items():
            gene_exon_len_mode[gene] = {i: find_mode(v) for i, v in d.items()}
        for gene, d in gene_true_intron_dist.items():
            gene_true_intron_mode[gene] = {i: find_mode(v) for i, v in d.items()}

    # ---- partial-allele rescue
    if include_partial_diff >= 0 and not opts.ignore_partial:
        if not gene_len_mode:
            for allele in allele_order:
                gene = allele.split("*")[0]
                gene_len_dist.setdefault(gene, {})
                le = allele_eff_len[allele]
                gene_len_dist[gene][le] = gene_len_dist[gene].get(le, 0) + 1
            for gene, d in gene_len_dist.items():
                gene_len_mode[gene] = find_mode(d)

        rescued: List[str] = []
        if mode == "rna":
            for allele in partial_alleles:
                gene = allele.split("*")[0]
                if gene not in gene_len_mode:
                    continue
                if allele_eff_len[allele] >= gene_len_mode[gene] - include_partial_diff:
                    rescued.append(allele)
        elif mode == "dna":
            gene_intron_dist: Dict[str, Dict[int, Dict[str, int]]] = {}
            for allele in allele_order:
                gene = allele.split("*")[0]
                exons = allele_exon_regions[allele]
                cnt = len(exons) // 2
                if cnt != gene_exon_cnt_mode[gene]:
                    continue
                for i in range(2, 2 * cnt, 2):
                    s = allele_seq[allele][exons[i - 1] + 1:exons[i]]
                    gene_intron_dist.setdefault(gene, {}).setdefault(i // 2 - 1, {})
                    gene_intron_dist[gene][i // 2 - 1][s] = (
                        gene_intron_dist[gene][i // 2 - 1].get(s, 0) + 1)
            gene_intron_mode: Dict[str, Dict[int, str]] = {
                g: {i: find_mode(v) for i, v in d.items()}
                for g, d in gene_intron_dist.items()
            }
            for allele in partial_alleles:
                gene = allele.split("*")[0]
                if gene not in gene_len_mode:
                    continue
                if allele_eff_len[allele] < gene_len_mode[gene] - include_partial_diff:
                    continue
                exons = list(allele_exon_regions[allele])
                cnt = len(exons) // 2
                if cnt != gene_exon_cnt_mode.get(gene):
                    continue
                exon_offset = 0
                out_seq = allele_seq[allele]
                extra5 = allele_padding[allele][0]
                exons = [e - extra5 for e in exons]
                for i in range(2, 2 * cnt, 2):
                    if exons[i] + exon_offset == exons[i - 1] + 1:
                        intron = gene_intron_mode[gene][i // 2 - 1]
                        pos = exons[i - 1] + 1
                        out_seq = out_seq[:pos] + intron + out_seq[pos:]
                        exon_offset += len(intron)
                    exons[i] += exon_offset
                    exons[i + 1] += exon_offset
                exons = [e + extra5 for e in exons]
                allele_exon_regions[allele] = exons
                allele_seq[allele] = out_seq
                rescued.append(allele)
        allele_order.extend(rescued)

    # ---- UTR padding (deterministic Perl-rand stream)
    rng = PerlRand(17)
    num_to_nuc = "ACGT"
    for allele in allele_order:
        gene = allele.split("*")[0]
        if gene not in gene5:
            rand_seq = "".join(num_to_nuc[rng.randint(4)] for _ in range(utr_length))
            best = gene5_best.get(gene, "")
            if best:
                # Perl substr($rand, -$len, $len, $best) with an oversized
                # replacement swallows the whole string: the padding
                # becomes exactly $best (which can exceed utr_length)
                if len(best) >= len(rand_seq):
                    rand_seq = best
                else:
                    rand_seq = rand_seq[:len(rand_seq) - len(best)] + best
            gene5[gene] = rand_seq
        if gene not in gene3:
            rand_seq = "".join(num_to_nuc[rng.randint(4)] for _ in range(utr_length))
            best = gene3_best.get(gene, "")
            if best:
                rand_seq = best + rand_seq[len(best):]
            gene3[gene] = rand_seq

    for allele in allele_order:
        out_seq = allele_seq[allele]
        gene = allele.split("*")[0]
        p5, p3 = allele_padding[allele]
        if p5 > 0:
            out_seq = gene5[gene][:p5] + out_seq
        if p3 > 0:
            out_seq = out_seq + gene3[gene][len(gene3[gene]) - p3:]
        allele_seq[allele] = out_seq

    # ---- exonization trimming (dna mode)
    if mode == "dna":
        for allele in allele_order:
            gene = allele.split("*")[0]
            exons = list(allele_exon_regions[allele])
            cnt = len(exons) // 2
            if cnt != gene_exon_cnt_mode.get(gene):
                continue
            if allele not in allele_true_exons:
                continue
            updated = False
            for i in range(cnt - 1):
                exon_len = exons[2 * i + 1] - exons[2 * i] + 1
                mode_len = gene_exon_len_mode[gene][i]
                if exon_len <= mode_len:
                    continue
                trim = exon_len - mode_len
                trim_side = 0
                true_exons = allele_true_exons[allele]
                s = allele_seq[allele]
                if (true_exons[2 * i + 2] - true_exons[2 * i + 1] - 1 + trim
                        == gene_true_intron_mode[gene][i]
                        and exons[2 * i + 1] + 1 + pad < len(s)
                        and s[exons[2 * i + 1] + 1 + pad] == "N"):
                    trim_side = 1
                    pos_n = exons[2 * i + 1] + 1 + pad
                    new_seq = s[:pos_n - trim] + s[pos_n:]
                elif (i > 0
                        and true_exons[2 * i] - true_exons[2 * i - 1] - 1 + trim
                        == gene_true_intron_mode[gene][i - 1]
                        and exons[2 * i] - 1 - pad >= 0
                        and s[exons[2 * i - 1] - 1 - pad] == "N"):
                    trim_side = -1
                    # NOTE the reference CHECKS the 'N' at
                    # exons[2i-1]-1-pad (previous exon's end) but TRIMS
                    # at posN = exons[2i]-1-pad (this exon's start) —
                    # ParseDatFile.pl:667 vs :671; mirror the mismatch
                    pos_n = exons[2 * i] - 1 - pad
                    new_seq = s[:pos_n + 1] + s[pos_n + trim + 1:]
                else:
                    continue
                allele_seq[allele] = new_seq
                if trim > pad:
                    if trim_side == 1:
                        exons[2 * i + 1] -= trim - pad
                    else:
                        exons[2 * i] += trim + pad
                if trim_side == -1:
                    exons[2 * i] -= trim
                    exons[2 * i + 1] -= trim
                for j in range(i + 1, cnt):
                    exons[2 * j] -= trim
                    exons[2 * j + 1] -= trim
                updated = True
            if updated:
                allele_exon_regions[allele] = exons

    # ---- gene-modal length trimming
    gene_seq_len_dist: Dict[str, Dict[int, int]] = {}
    for allele in allele_order:
        gene = allele.split("*")[0]
        gene_seq_len_dist.setdefault(gene, {})
        ln = len(allele_seq[allele])
        gene_seq_len_dist[gene][ln] = gene_seq_len_dist[gene].get(ln, 0) + 1
    gene_seq_len = {g: find_mode(d) for g, d in gene_seq_len_dist.items()}
    gene_last_exon = {g: find_mode(d) for g, d in gene_last_exon_dist.items()}

    if fix_gene_length:
        for allele in allele_order:
            out_seq = allele_seq[allele]
            gene = allele.split("*")[0]
            regions = allele_exon_regions[allele]
            last_exon_len = regions[-1] - regions[-2] + 1
            trim = last_exon_len - gene_last_exon[gene]
            if len(out_seq) > gene_seq_len[gene] and trim > 0:
                out_seq = out_seq[:len(out_seq) - trim]
            allele_seq[allele] = out_seq

    # ---- output
    used_seq: Dict[str, bool] = {}
    n = 0
    for allele in allele_order:
        out_seq = allele_seq[allele]
        if out_seq == "":
            continue
        if opts.dedup and out_seq in used_seq:
            continue
        if opts.gene_prefix and not allele.upper().startswith(opts.gene_prefix):
            continue
        used_seq[out_seq] = True
        regions = allele_exon_regions[allele]
        out.write(f">{allele} {len(regions) // 2} " + " ".join(map(str, regions))
                  + f"\n{out_seq}\n")
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="EMBL-ENA .dat -> allele fasta")
    ap.add_argument("dat")
    ap.add_argument("--mode", default="rna", choices=["rna", "dna", "genome"])
    ap.add_argument("--gene", default="")
    ap.add_argument("--ignorePartial", action="store_true")
    ap.add_argument("--partialInRnaMode", type=int, default=0)
    ap.add_argument("--partialIntronHasNoSeq", action="store_true")
    ap.add_argument("--intronPadding", type=int, default=200)
    ap.add_argument("--dedup", action="store_true")
    args = ap.parse_args(argv)
    opts = BuildOptions(
        mode=args.mode, gene_prefix=args.gene.upper(),
        ignore_partial=args.ignorePartial,
        partial_in_rna_mode=args.partialInRnaMode,
        partial_intron_has_no_seq=args.partialIntronHasNoSeq,
        intron_padding=args.intronPadding, dedup=args.dedup)
    build_allele_fasta(args.dat, sys.stdout, opts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
