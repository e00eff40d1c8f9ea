"""The comparison that decides `correct`.

Every completed sample's output files are read before they are
deleted: the first completion of each pool sample keeps its bytes and
the program's captured state (capture.py), every later completion of
the same pool sample its digests, which have to equal the first's.
Once the window has closed, each kept pool sample is judged by the
plain reference (port_bench/reference), which takes only the panel and
the reads that the harness made:

  screen   every pair that lies exactly in a panel allele is extracted;
           every extracted pair is an input pair, record for record,
           and carries panel k-mers at MIN_KMER_HITS positions or more;
  assign   every extracted exact pair is among the aligned pairs, and
           every aligned pair is an extracted pair, record for record;
  groups   the equivalence classes and the EM's read-group table equal
           the ones worked out again from the read groups;
  band     the checkable band items' match counts (reference/band.py);
  em       each EM's per-class read counts against T1K's EM in float64,
           as the widest gap over the classes in reads, over the
           problem's reads.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np

from reference import band, em, exact, groups

MIN_KMER_HITS = 3
# the EM's widest gap may reach this share of the problem's reads: sound
# runs of kir-rna.candidates read at most 3.8e-11 on 23 seeds, the float32
# control at least 2.8e-9 on 7 (PERF.md, section 2)
EM_GAP_LIMIT = 1e-9


def read_outputs(prefix: str, suffixes) -> Dict[str, Optional[bytes]]:
    """Each output file's bytes; a missing file reads as None."""
    out = {}
    for s in suffixes:
        try:
            with open(prefix + s, "rb") as f:
                out[s] = f.read()
        except FileNotFoundError:
            out[s] = None
    return out


def digest(outputs) -> Dict[str, Optional[str]]:
    return {s: None if b is None else hashlib.sha256(b).hexdigest()
            for s, b in outputs.items()}


class Outputs:
    """What the window's samples wrote, by pool index."""

    def __init__(self, suffixes):
        self.suffixes = tuple(suffixes)
        self.first: Dict[int, Dict[str, Optional[bytes]]] = {}
        self.first_digest: Dict[int, dict] = {}
        self.repeats_differ = 0

    def take(self, index: int, prefix: str) -> None:
        outs = read_outputs(prefix, self.suffixes)
        d = digest(outs)
        if index not in self.first:
            self.first[index] = outs
            self.first_digest[index] = d
        elif d != self.first_digest[index]:
            self.repeats_differ += 1


def fastq(data: Optional[bytes]):
    """(ids, sequences, qualities) of a FASTQ file's records."""
    if not data:
        return [], [], []
    lines = data.decode("ascii").split("\n")
    return lines[0::4][:len(lines) // 4], lines[1::4], lines[3::4]


def codes(seqs: List[str], length: int) -> np.ndarray:
    out = np.full((len(seqs), length), 4, np.int8)
    for i, s in enumerate(seqs):
        c = exact.encode(s)[:length]
        out[i, :len(c)] = c
    return out


class Sample:
    """A pool sample's input pairs and the facts of the plain reference
    about them."""

    def __init__(self, prefix: str, panel: exact.Panel, table, k: int):
        with open(prefix + "_1.fq", "rb") as f:
            self.ids, self.seq1, self.qual1 = fastq(f.read())
        with open(prefix + "_2.fq", "rb") as f:
            _, self.seq2, self.qual2 = fastq(f.read())
        L = max(len(s) for s in self.seq1 + self.seq2)
        m1, m2 = codes(self.seq1, L), codes(self.seq2, L)
        self.holders = panel.pair_holders(m1, m2)
        self.hits = np.maximum(exact.panel_kmer_hits(table, k, m1),
                               exact.panel_kmer_hits(table, k, m2))


def screen(sample: Sample, outs) -> dict:
    ids1, seq1, qual1 = fastq(outs.get("_candidate_1.fq"))
    ids2, seq2, qual2 = fastq(outs.get("_candidate_2.fq"))
    where = {name: i for i, name in enumerate(sample.ids)}
    kept, wrong, last = set(), 0, -1
    for j, name in enumerate(ids1):
        i = where.get(name, -1)
        same = (i > last and j < len(ids2) and ids2[j] == name
                and seq1[j] == sample.seq1[i] and qual1[j] == sample.qual1[i]
                and seq2[j] == sample.seq2[i] and qual2[j] == sample.qual2[i])
        if not same:
            wrong += 1
            continue
        last = i
        kept.add(i)
    wrong += abs(len(ids1) - len(ids2))
    exact_pairs = [i for i, h in enumerate(sample.holders) if len(h)]
    return {
        "screen_records_wrong": wrong,
        "screen_exact_missed": sum(i not in kept for i in exact_pairs),
        "screen_unfounded": int(sum(sample.hits[i] < MIN_KMER_HITS
                                    for i in kept)),
        "exact_pairs": len(exact_pairs), "kept": kept,
    }


def fasta_records(data: Optional[bytes]):
    """(ids, sequences) of a FASTA file written two lines a record."""
    if not data:
        return [], []
    lines = data.decode("ascii").split("\n")
    return [x[1:] for x in lines[0::2][:len(lines) // 2]], lines[1::2]


def assignment(sample: Sample, kept, outs) -> dict:
    """The genotyper's aligned pairs (_aligned_1.fa, _aligned_2.fa):
    every exact pair among them, each of them an extracted pair, record
    for record."""
    ids1, seq1 = fasta_records(outs.get("_aligned_1.fa"))
    ids2, seq2 = fasta_records(outs.get("_aligned_2.fa"))
    where = {name[1:]: i for i, name in enumerate(sample.ids)}
    aligned, wrong = set(), abs(len(ids1) - len(ids2))
    for j, name in enumerate(ids1):
        i = where.get(name, -1)
        if (i in kept and j < len(ids2) and ids2[j] == name
                and seq1[j] == sample.seq1[i] and seq2[j] == sample.seq2[i]):
            aligned.add(i)
        else:
            wrong += 1
    unaligned = sum(i not in aligned for i in kept if len(sample.holders[i]))
    return {"aligned_records_wrong": wrong,
            "assign_exact_unaligned": unaligned}


def classes(geno) -> dict:
    """The genotyper's ECs and, through its EM problem, the read-group
    table against the plain rework."""
    mine = groups.equivalence_classes(geno["goff"], geno["allele"],
                                      geno["qual"], len(geno["names"]))
    want = {frozenset(kept) for _, kept in mine}
    have = {frozenset(ec) for ec in geno["ecs"]}
    return {"wrong": len(want ^ have), "mine": mine}


def em_table(geno, mine, problem) -> int:
    """Groups whose EC list or count differs from the plain rework."""
    ec_of = {}
    for c, (members, _) in enumerate(mine):
        for a in members:
            ec_of[a] = c
    kept = [frozenset(k) for _, k in mine]
    want_ecs, want_counts = groups.em_table(geno["goff"], geno["allele"],
                                            geno["weight"], ec_of)
    ec_to_alleles, (rg_off, rg_ecs), rg_counts = problem[:3]
    if len(rg_off) - 1 != len(want_ecs):
        return max(len(rg_off) - 1, len(want_ecs))
    wrong = 0
    for g, ecs in enumerate(want_ecs):
        got = [frozenset(ec_to_alleles[c])
               for c in rg_ecs[rg_off[g]:rg_off[g + 1]].tolist()]
        wrong += int(got != [kept[c] for c in ecs]
                     or float(rg_counts[g]) != want_counts[g])
    return wrong


def em_gap(problem, counts: np.ndarray) -> float:
    """The widest gap between `counts` and T1K's EM in float64, over the
    problem's reads."""
    want = em.quantify(problem, np.float64)
    if len(want) != len(counts):
        return float("inf")
    if not len(want):
        return 0.0
    total = max(float(np.sum(problem[2])), 1.0)
    return float(np.max(np.abs(np.asarray(counts, np.float64) - want))
                 / total)


def judge(records: dict, outputs: Outputs, samples: Dict[int, Sample],
          names: List[str], em_answer=None) -> dict:
    """The numbers of every kept pool sample, summed (or their widest).
    em_answer(problem) replaces the program's EM answers: the control."""
    total = {"screen_records_wrong": 0, "screen_exact_missed": 0,
             "screen_unfounded": 0, "aligned_records_wrong": 0,
             "assign_exact_unaligned": 0,
             "classes_wrong": 0, "em_table_wrong": 0, "band_wrong": 0,
             "em_gap": 0.0, "exact_pairs": 0,
             "band_checked": 0, "em_problems": 0, "samples_checked": 0,
             "record_missing": 0}
    for index, outs in sorted(outputs.first.items()):
        rec = records.get(index)
        if rec is None or not rec["genotypers"]:
            total["record_missing"] += 1
            continue
        total["samples_checked"] += 1
        s = screen(samples[index], outs)
        for key in ("screen_records_wrong", "screen_exact_missed",
                    "screen_unfounded", "exact_pairs"):
            total[key] += s[key]
        geno = rec["genotypers"][0]
        if geno["names"] != names:
            total["record_missing"] += 1
        a = assignment(samples[index], s["kept"], outs)
        for key in ("aligned_records_wrong", "assign_exact_unaligned"):
            total[key] += a[key]
        if len(rec["em"]) != len(rec["genotypers"]):
            total["record_missing"] += 1
        for g, e in zip(rec["genotypers"], rec["em"]):
            c = classes(g)
            total["classes_wrong"] += c["wrong"]
            total["em_table_wrong"] += em_table(g, c["mine"], e["problem"])
            answer = (e["counts"] if em_answer is None
                      else em_answer(e["problem"]))
            total["em_gap"] = max(total["em_gap"],
                                  em_gap(e["problem"], answer))
            total["em_problems"] += 1
        b = band.check(rec["band"])
        total["band_wrong"] += b["wrong"]
        total["band_checked"] += b["checked"]
    return total


def panel_facts(recs):
    """The panel's exact index, its k-mer bitmap and the extraction's k."""
    panel = exact.Panel([r[2] for r in recs])
    k = exact.kmer_length(panel.total_bases)
    return panel, panel.kmer_table(k), k
