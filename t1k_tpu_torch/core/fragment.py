"""Fragment (mate-pair) assignment from per-read-end alignments.

Pairs the two read ends of a fragment on each allele, keeps the best
candidate per allele, applies the tie-relaxation and dangling/truncated-
reference filters, and emits weighted per-fragment allele assignments.

Behavior contract: reference SeqSet.hpp:2310-2655 (pairing, dedupe, tie
rules, dangling filters, truncated-mate rescue) and Genotyper.hpp:205-230,
778-832 (similarity-bucket weights, separator-span drop, adjust factor).
Weights are stored as float32 exactly like the reference's `float` fields;
accumulation order is preserved so downstream sums are bit-identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class OverlapRec:
    """One read-end alignment to one allele (engine output row)."""
    seq_idx: int
    read_start: int
    read_end: int
    seq_start: int
    seq_end: int
    strand: int
    match_cnt: int
    relaxed_match_cnt: int
    similarity: float
    left_clip: int
    right_clip: int

    @classmethod
    def from_row(cls, row) -> "OverlapRec":
        return cls(
            int(row[0]), int(row[1]), int(row[2]), int(row[3]), int(row[4]),
            int(row[5]), int(row[6]), int(row[7]), float(row[8]), int(row[9]),
            int(row[10]),
        )


def overlap_rank_key(o: OverlapRec):
    """Sort key equivalent to the reference overlap ranking (SeqSet.hpp:103)."""
    return (
        -o.match_cnt, -o.similarity, -(o.read_end - o.read_start), o.seq_idx,
        o.strand, o.read_start, o.read_end, o.seq_start, o.seq_end,
    )


@dataclass
class FragmentRec:
    seq_idx: int
    seq_start: int
    seq_end: int
    match_cnt: int
    relaxed_match_cnt: int
    similarity: float
    has_mate_pair: bool
    o1_from_r2: bool
    overlap1: OverlapRec
    overlap2: Optional[OverlapRec]
    has_n: bool
    qual: float = 0.0


class RefContext:
    """Reference geometry needed by the fragment stage."""

    def __init__(self, refset, hit_len_required: int = 31,
                 relax_intron_align: bool = False,
                 ref_seq_similarity: float = 0.8):
        self.seq_lens = [a.length for a in refset.alleles]
        # sentinel-augmented like the reference (SeqSet.hpp:924-928):
        # -1 and len() count as separators for the boundary checks
        self.separators = [
            np.asarray([-1] + list(a.separators) + [a.length],
                       dtype=np.int64)
            for a in refset.alleles]
        self.hit_len_required = hit_len_required
        self.relax_intron_align = relax_intron_align
        self.ref_seq_similarity = ref_seq_similarity

    def separator_in_range(self, s: int, e: int, seq_idx: int) -> bool:
        seps = self.separators[seq_idx]
        i = int(np.searchsorted(seps, s, side="left"))
        return i < len(seps) and seps[i] <= e


def _overlap_intersect(a: OverlapRec, b: OverlapRec) -> bool:
    return a.seq_idx == b.seq_idx and (
        (a.seq_start <= b.seq_start <= a.seq_end)
        or (b.seq_start <= a.seq_start <= b.seq_end)
    )


def _truncated_mate_overlap(ctx: RefContext, o: OverlapRec,
                            comp1: OverlapRec, comp2: OverlapRec) -> bool:
    """Would o's mate fall off the end of (or across a separator in) the
    reference, given the span observed for the representative pair?
    (reference SeqSet.hpp:502-523)"""
    if o.seq_idx == -1 or comp1 is None or comp2 is None:
        return False
    if o.strand == 1:
        shift = comp2.seq_end - comp1.seq_end
        if ctx.seq_lens[o.seq_idx] - 1 < o.seq_end + shift:
            return True
        if ctx.separator_in_range(o.seq_end, o.seq_end + shift + 1, o.seq_idx):
            return True
    elif o.strand == -1:
        shift = comp1.seq_start - comp2.seq_start
        if o.seq_start - shift < 0:
            return True
        if ctx.separator_in_range(o.seq_start - shift - 1, o.seq_start, o.seq_idx):
            return True
    return False


def _frag_better(a: FragmentRec, b: FragmentRec) -> bool:
    """a ranks strictly higher than b (reference _fragmentOverlap::operator<)."""
    if a.match_cnt != b.match_cnt:
        return a.match_cnt > b.match_cnt
    if a.similarity != b.similarity:
        return a.similarity > b.similarity
    return overlap_rank_key(a.overlap1) < overlap_rank_key(b.overlap1)


def fragment_assign(
    ctx: RefContext,
    ov1: Optional[List[OverlapRec]],
    ov2: Optional[List[OverlapRec]],
    has_n: bool,
    paired: bool,
) -> List[FragmentRec]:
    """Combine the two read ends' alignments into fragment assignments."""
    overlaps1 = ov1 if ov1 is not None else []
    fragments: List[tuple] = []

    if not paired:
        fragments = [(i, -1) for i in range(len(overlaps1))]
        overlaps2 = []
    else:
        overlaps2 = ov2 if ov2 is not None else []
        if len(overlaps1) == 0 or len(overlaps2) == 0:
            fragments = [(i, -1) for i in range(len(overlaps1))]
            fragments += [(-1, j) for j in range(len(overlaps2))]
        else:
            seq_to_j: dict = {}
            for j, o in enumerate(overlaps2):
                seq_to_j.setdefault(o.seq_idx, []).append(j)
            for i, o in enumerate(overlaps1):
                for j in seq_to_j.get(o.seq_idx, ()):
                    o2 = overlaps2[j]
                    if o.strand == o2.strand:
                        continue
                    if (o.strand == 1 and o.seq_start < o2.seq_start) or (
                        o.strand == -1 and o.seq_start > o2.seq_start
                    ):
                        fragments.append((i, j))

    assign: List[FragmentRec] = []
    seq_idx_to_assign: dict = {}
    for fi, fj in fragments:
        if fi >= 0:
            o = overlaps1[fi]
            rec = FragmentRec(
                seq_idx=o.seq_idx, seq_start=o.seq_start, seq_end=o.seq_end,
                match_cnt=o.match_cnt, relaxed_match_cnt=o.relaxed_match_cnt,
                similarity=o.similarity, has_mate_pair=False, o1_from_r2=False,
                overlap1=o, overlap2=None, has_n=has_n,
            )
            if fj >= 0:
                o2 = overlaps2[fj]
                rec.match_cnt += o2.match_cnt
                rec.relaxed_match_cnt += o2.relaxed_match_cnt
                if o.strand == 1:
                    rec.seq_end = o2.seq_end
                else:
                    rec.seq_start = o2.seq_start
                rec.similarity = rec.match_cnt / (
                    o.read_end - o.read_start + 1 + o2.read_end - o2.read_start + 1
                    + o.seq_end - o.seq_start + 1 + o2.seq_end - o2.seq_start + 1
                    + 2 * o.left_clip + 2 * o.right_clip
                    + 2 * o2.left_clip + 2 * o2.right_clip
                )
                rec.has_mate_pair = True
                rec.overlap2 = o2
        elif fj >= 0:  # dangling: only mate 2 aligned
            o = overlaps2[fj]
            rec = FragmentRec(
                seq_idx=o.seq_idx, seq_start=o.seq_start, seq_end=o.seq_end,
                match_cnt=o.match_cnt, relaxed_match_cnt=o.relaxed_match_cnt,
                similarity=o.similarity, has_mate_pair=False, o1_from_r2=True,
                overlap1=o, overlap2=None, has_n=has_n,
            )
        else:
            continue

        prev = seq_idx_to_assign.get(rec.seq_idx)
        if prev is not None:
            if _frag_better(rec, assign[prev]):
                assign[prev] = rec
        else:
            assign.append(rec)
            seq_idx_to_assign[rec.seq_idx] = len(assign) - 1

    if not assign:
        return []

    # Best fragment: strictly more matches, or equal matches + higher
    # similarity (first wins ties) — SeqSet.hpp:2474-2487.
    best = assign[0]
    for rec in assign[1:]:
        if rec.match_cnt > best.match_cnt or (
            rec.match_cnt == best.match_cnt and rec.similarity > best.similarity
        ):
            best = rec

    kept: List[FragmentRec] = []
    for rec in assign:
        match_relax = 2
        if (
            ctx.relax_intron_align and rec.has_mate_pair
            and _overlap_intersect(rec.overlap1, rec.overlap2)
            and rec.overlap1.match_cnt < rec.overlap1.relaxed_match_cnt
            and rec.overlap2.match_cnt < rec.overlap2.relaxed_match_cnt
        ):
            match_relax = 4

        if rec.match_cnt == best.match_cnt and rec.similarity == best.similarity:
            rec.qual = 1.0
            kept.append(rec)
        elif (
            ctx.relax_intron_align
            and rec.match_cnt >= best.match_cnt - match_relax
            and rec.relaxed_match_cnt == best.relaxed_match_cnt
        ):
            rec.qual = 1.0
            kept.append(rec)
    assign_out = kept

    # Dangling-read filter (SeqSet.hpp:2554-2578).
    if assign_out and paired and not assign_out[0].has_mate_pair:
        ok = True
        for rec in assign_out:
            o1 = rec.overlap1
            if (
                rec.similarity < 1
                or ctx.separator_in_range(rec.seq_start, rec.seq_end, rec.seq_idx)
                or (rec.seq_end - rec.seq_start + 1 + o1.read_end - o1.read_start + 1
                    < 3 * ctx.hit_len_required)
            ):
                ok = False
                break
            span_range = 100
            if (o1.strand == 1 and rec.seq_end + span_range < ctx.seq_lens[rec.seq_idx]) or (
                o1.strand == -1 and rec.seq_start - span_range >= 0
            ):
                ok = False
                break
        if not ok:
            return []

    # Truncated-reference rescue filter (SeqSet.hpp:2581-2653).
    if assign_out and paired and assign_out[0].has_mate_pair:
        rep = assign_out[0]
        for rec in assign_out:
            if rec.qual == 1.0:
                rep = rec
                break
        filt = False
        for o in overlaps1:
            if filt:
                break
            if o.match_cnt > rep.overlap1.match_cnt or (
                o.match_cnt == rep.overlap1.match_cnt
                and o.similarity > rep.overlap1.similarity
                and o.seq_idx not in seq_idx_to_assign
            ):
                if _truncated_mate_overlap(ctx, o, rep.overlap1, rep.overlap2):
                    filt = True
                elif o.similarity > rep.overlap2.similarity + 0.1:
                    filt = True
        for o in overlaps2:
            if filt:
                break
            if o.match_cnt > rep.overlap2.match_cnt or (
                o.match_cnt == rep.overlap2.match_cnt
                and o.similarity > rep.overlap2.similarity
                and o.seq_idx not in seq_idx_to_assign
            ):
                if _truncated_mate_overlap(ctx, o, rep.overlap2, rep.overlap1):
                    filt = True
                elif o.similarity > rep.overlap1.similarity + 0.1:
                    filt = True
        if filt:
            return []

    return assign_out


def read_assignment_weight(similarity: float, ref_seq_similarity: float,
                           has_n: bool) -> np.float32:
    """Similarity-bucket fragment weight (Genotyper.hpp:205-230)."""
    segment = (1 - ref_seq_similarity) / 4.0
    if segment < 0.01:
        segment = 0.01
    ret = 1.0
    if similarity < 1 - 3 * segment:
        ret = 0.01
    elif similarity < 1 - 2 * segment:
        ret = 0.1
    elif similarity < 1 - segment:
        ret = 0.5
    if has_n:
        ret /= 10.0
    return np.float32(ret)


@dataclass
class ReadAssignment:
    """Per-fragment allele assignment (reference _readAssignment)."""
    allele_idx: int
    start: int
    end: int
    weight: np.float32
    qual: np.float32
    adjust_weight: np.float32


def set_read_assignments(
    ctx: RefContext,
    fragments: Sequence[FragmentRec],
    whitelist=None,
    max_assign_cnt: int = 2000,
) -> List[ReadAssignment]:
    """Convert fragment records into weighted allele assignments
    (Genotyper.hpp:778-832)."""
    n = len(fragments)
    if n == 0 or (max_assign_cnt > 0 and n > max_assign_cnt):
        return []
    for rec in fragments:
        if ctx.separator_in_range(rec.seq_start, rec.seq_end, rec.seq_idx):
            return []
    max_similarity = 0.0
    for rec in fragments:
        if rec.similarity > max_similarity:
            max_similarity = rec.similarity
    adjust = 0.25 if max_similarity < 1 else 1.0
    out = []
    for rec in fragments:
        if whitelist is not None and not whitelist[rec.seq_idx]:
            continue
        w = read_assignment_weight(rec.similarity, ctx.ref_seq_similarity, rec.has_n)
        out.append(ReadAssignment(
            allele_idx=rec.seq_idx, start=rec.seq_start, end=rec.seq_end,
            weight=w, qual=np.float32(rec.qual),
            adjust_weight=np.float32(adjust * float(w)),
        ))
    return out
