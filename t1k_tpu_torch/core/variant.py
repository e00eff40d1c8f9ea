"""Novel-SNP calling over the selected alleles.

Behavior contract: reference VariantCaller.hpp.  Pipeline:
  1. two passes over all fragments accumulate per-base nucleotide counts —
     first an alignment-quality pass (best matchCnt/similarity per base),
     then a weighted pass gated on assignment quality,
  2. candidate positions: alt count >= 5 and >= 0.5x the reference base
     count (VariantCaller.hpp:307-345),
  3. a fixed-point expansion propagates candidates across co-aligned
     alleles and accumulates variant<->variant co-occurrence weights,
  4. connected groups (edge weight >= 0.15x coverage) are solved by
     exhaustive 4^n nucleotide assignment maximizing fragment coverage
     (groups larger than varMaxGroup or spanning one allele twice or
     without exon positions are skipped),
  5. exonic variants are emitted as a VCF-like table; ties get quality 0.

Several reference quirks are intentionally preserved and marked inline
(e.g. the candidate-overlap pre-check that always falls through, and the
positional stall before an overlap's readStart inflating co-occurrence
weights).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import EDIT_DELETE, EDIT_INSERT, EDIT_MATCH, EDIT_MISMATCH


@dataclass
class Variant:
    seq_idx: int
    ref_start: int
    ref_end: int
    ref: str
    var: str
    all_support: float
    var_support: float
    var_uniq_support: float
    var_group_id: int
    output_group_id: int
    qual: int


class BaseVariants:
    """Per-sequence per-base nucleotide evidence.

    With `views`, the six state arrays are numpy views into the
    VariantCaller's flat arenas so the native counting pass
    (native/variant.cc) and the Python consumers share one memory."""

    def __init__(self, length: int, exon_mask: np.ndarray, views=None):
        if views is None:
            self.count = np.zeros((length, 4), dtype=np.float64)
            self.uniq = np.zeros((length, 4), dtype=np.float64)
            self.unweighted = np.zeros((length, 4), dtype=np.float64)
            self.best_match = np.zeros((length, 4), dtype=np.int64)  # alignInfo.a
            self.best_sim = np.zeros((length, 4), dtype=np.float64)  # alignInfo.b
            # rowwise max of best_match, kept in sync: good_assignment
            # is hot and "within 4 of every best" == "within 4 of max"
            self.best_match_max = np.zeros(length, dtype=np.int64)
        else:
            (self.count, self.uniq, self.unweighted, self.best_match,
             self.best_sim, self.best_match_max) = views
        self.exon = exon_mask
        self.candidate_id = np.full(length, -1, dtype=np.int64)
        self.final_variant_ids: Dict[int, List[int]] = {}

    def good_assignment(self, pos: int, match_cnt: int) -> bool:
        # good iff matchCnt is within 4 of every best alignment seen here
        return match_cnt >= self.best_match_max[pos] - 4


_POS_MASTER = np.arange(4096, dtype=np.int32)


def _pos_master(n: int) -> np.ndarray:
    """Shared int32 arange of at least n+1 elements (grown geometrically);
    slices of it serve as position arrays for indel-free edit walks."""
    global _POS_MASTER
    if len(_POS_MASTER) <= n:
        size = len(_POS_MASTER)
        while size <= n:
            size *= 2
        _POS_MASTER = np.arange(size, dtype=np.int32)
    return _POS_MASTER


def _edit_walk_positions(align: np.ndarray, seq_start: int, read_start: int):
    """Vectorized walk: per op, the (refPos, readPos) BEFORE applying it."""
    not_ins = align != EDIT_INSERT
    not_del = align != EDIT_DELETE
    # exclusive prefix sum = inclusive - self
    ref_pos = seq_start + np.cumsum(not_ins) - not_ins
    read_pos = read_start + np.cumsum(not_del) - not_del
    return ref_pos, read_pos


class VariantCaller:
    def __init__(self, refset, packed, max_var_group: int = 8):
        self.refset = refset
        self.packed = packed
        self.max_var_group = max_var_group
        # flat per-base state arenas over all selected alleles; each
        # BaseVariants holds views (native/variant.cc writes the arenas)
        lens = np.array([a.length for a in refset.alleles], dtype=np.int64)
        total = int(lens.sum())
        self.seq_base = np.zeros(len(lens), dtype=np.int64)
        np.cumsum(lens[:-1], out=self.seq_base[1:])
        self._count = np.zeros((total, 4), dtype=np.float64)
        self._uniq = np.zeros((total, 4), dtype=np.float64)
        self._unweighted = np.zeros((total, 4), dtype=np.float64)
        self._best_match = np.zeros((total, 4), dtype=np.int64)
        self._best_sim = np.zeros((total, 4), dtype=np.float64)
        self._best_match_max = np.zeros(total, dtype=np.int64)
        self.base: List[BaseVariants] = [
            BaseVariants(
                a.length, a.exon_mask,
                views=tuple(arr[b:b + a.length] for arr in
                            (self._count, self._uniq, self._unweighted,
                             self._best_match, self._best_sim,
                             self._best_match_max)))
            for a, b in zip(refset.alleles, self.seq_base)
        ]
        self.seq_abundance = np.zeros(len(refset), dtype=np.float64)
        self.seq_copy = np.zeros(len(refset), dtype=np.int64)
        self.candidate_variants: List[Tuple[int, int]] = []  # (seqIdx, refPos)
        self.candidate_group_id: List[int] = []
        self.candidate_root: List[bool] = []
        self.final_variants: List[Variant] = []

    def set_seq_abundance(self, genotyper) -> None:
        self.seq_abundance = genotyper.abundance.copy()
        gene_cnt: Dict[int, int] = {}
        for a in self.refset.alleles:
            gene_cnt[a.gene_idx] = gene_cnt.get(a.gene_idx, 0) + 1
        for i, a in enumerate(self.refset.alleles):
            self.seq_copy[i] = gene_cnt[a.gene_idx]

    # ------------------------------------------------------- count updates
    def _update_from_overlap(self, r_codes: np.ndarray, weight: float,
                             filter_low_qual: bool, o) -> None:
        """o carries .seq_idx/.seq_start/.read_start/.match_cnt/.similarity
        and .align (int8 edit walk).

        Reference quirk preserved (VariantCaller.hpp:139-167): the
        `continue` on a filtered/N substitution skips the refPos/readPos
        increments at the loop tail, STALLING the walk — every later
        position of that overlap shifts.  The vectorized path is used
        only when no stall can occur; otherwise the sequential walk
        reproduces the stalls exactly."""
        if o.seq_idx == -1 or o.align is None:
            return
        bv = self.base[o.seq_idx]
        align = o.align
        walk = getattr(o, "walk_cache", None)
        if walk is None:
            ref_pos, read_pos = _edit_walk_positions(
                align, o.seq_start, o.read_start)
            subs = np.flatnonzero(
                (align == EDIT_MATCH) | (align == EDIT_MISMATCH))
            # the same overlap is walked once per update pass
            # (alignment-info, then weighted) -- cache the coordinates,
            # plus the substitution-gathered (ref, read) positions used
            # by the batched pass
            o.walk_cache = walk = (ref_pos, read_pos, subs,
                                   ref_pos[subs].astype(np.int32),
                                   read_pos[subs].astype(np.int32))
        ref_pos, read_pos, subs = walk[0], walk[1], walk[2]

        # stall detection on the unstalled coordinates: a stall at the
        # first trigger invalidates everything after it
        stall = False
        if len(subs):
            nucs = r_codes[read_pos[subs]]
            if (nucs >= 4).any():
                stall = True
            elif filter_low_qual:
                rps = ref_pos[subs]
                lo = bv.best_match[rps] - 4
                if (o.match_cnt < lo).any():
                    stall = True

        if not stall:
            if len(subs):
                # vectorized: ref positions strictly increase along the
                # walk, so (rp, nuc) index pairs are unique
                rps = ref_pos[subs]
                nucs = r_codes[read_pos[subs]]
                if weight == 1:
                    bv.uniq[rps, nucs] += weight
                bv.count[rps, nucs] += 1
                bv.unweighted[rps, nucs] += 1
                bm = bv.best_match[rps, nucs]
                bs = bv.best_sim[rps, nucs]
                gt = o.match_cnt > bm
                eq = (o.match_cnt == bm) & (o.similarity > bs)
                if gt.any():
                    bv.best_match[rps[gt], nucs[gt]] = o.match_cnt
                    bv.best_sim[rps[gt], nucs[gt]] = o.similarity
                    np.maximum.at(bv.best_match_max, rps[gt], o.match_cnt)
                if eq.any():
                    bv.best_sim[rps[eq], nucs[eq]] = o.similarity
            return

        self._walk_sequential(o, r_codes, weight, filter_low_qual)

    def _walk_sequential(self, o, r_codes: np.ndarray, weight: float,
                         filter_low_qual: bool) -> None:
        """Exact sequential walk for stalled overlaps — the reference's
        skip-without-advance quirk (VariantCaller.hpp:139-167)."""
        bv = self.base[o.seq_idx]
        rp = o.seq_start
        rdp = o.read_start
        for op in o.align.tolist():
            if op == EDIT_MATCH or op == EDIT_MISMATCH:
                if filter_low_qual and not bv.good_assignment(rp, o.match_cnt):
                    continue  # stall: no position advance
                nuc = r_codes[rdp]
                if nuc >= 4:
                    continue  # stall
                if weight == 1:
                    bv.uniq[rp, nuc] += weight
                bv.count[rp, nuc] += 1
                bv.unweighted[rp, nuc] += 1
                if o.match_cnt > bv.best_match[rp, nuc]:
                    bv.best_match[rp, nuc] = o.match_cnt
                    bv.best_sim[rp, nuc] = o.similarity
                    if o.match_cnt > bv.best_match_max[rp]:
                        bv.best_match_max[rp] = o.match_cnt
                elif (o.match_cnt == bv.best_match[rp, nuc]
                      and o.similarity > bv.best_sim[rp, nuc]):
                    bv.best_sim[rp, nuc] = o.similarity
            if op != EDIT_INSERT:
                rp += 1
            if op != EDIT_DELETE:
                rdp += 1

    def update_fragment(self, r1_codes, r2_codes, update_type: int,
                        frags: List) -> None:
        """update_type 1 = alignment-info pass, 0 = weighted pass
        (VariantCaller.hpp:273-305)."""
        if not frags:
            return
        total = 0.0
        for f in frags:
            total += self.seq_abundance[f.seq_idx]
        for f in frags:
            weight = self.seq_abundance[f.seq_idx] / total if total else 0.0
            filter_low_qual = True
            if update_type == 1:
                filter_low_qual = False
                weight = 0.0
            if f.has_mate_pair:
                self._update_from_overlap(
                    f.o1_rc if f.overlap1.strand == -1 else r1_codes,
                    weight, filter_low_qual, f.overlap1)
                self._update_from_overlap(
                    f.o2_rc if f.overlap2.strand == -1 else r2_codes,
                    weight, filter_low_qual, f.overlap2)
            else:
                rc = r2_codes if f.o1_from_r2 else r1_codes
                self._update_from_overlap(
                    f.o1_rc if f.overlap1.strand == -1 else rc,
                    weight, filter_low_qual, f.overlap1)

    def _enumerate_items(self, all_frags: List[List],
                         update_type: int) -> List[Tuple]:
        """(overlap, strand-resolved read codes, weight) in fragment
        order, mirroring update_fragment."""
        items: List[Tuple] = []
        for frags in all_frags:
            if not frags:
                continue
            r1_codes, r2_codes = frags[0].r1_codes, frags[0].r2_codes
            total = 0.0
            for f in frags:
                total += self.seq_abundance[f.seq_idx]
            for f in frags:
                weight = self.seq_abundance[f.seq_idx] / total if total else 0.0
                if update_type == 1:
                    weight = 0.0
                if f.has_mate_pair:
                    items.append((f.overlap1, f.o1_rc if f.overlap1.strand == -1
                                  else r1_codes, weight))
                    items.append((f.overlap2, f.o2_rc if f.overlap2.strand == -1
                                  else r2_codes, weight))
                else:
                    rc = r2_codes if f.o1_from_r2 else r1_codes
                    items.append((f.overlap1, f.o1_rc if f.overlap1.strand == -1
                                  else rc, weight))
        return [it for it in items
                if it[0].seq_idx != -1 and it[0].align is not None]

    def _update_all(self, all_frags: List[List], update_type: int) -> None:
        """One full update pass over every fragment.

        Production path: the exact sequential reference walk in native
        code (native/variant.cc), one call per pass over flat item
        arrays — stall quirk and fragment order preserved verbatim.
        T1K_VARIANT_BACKEND=python selects the vectorized NumPy
        implementation (the original oracle) instead."""
        import os

        items = self._enumerate_items(all_frags, update_type)
        if not items:
            return
        if os.environ.get("T1K_VARIANT_BACKEND", "native") == "python":
            self._update_all_python(items, update_type)
            return

        from ..native import variant_update

        n = len(items)
        align_len = np.fromiter((len(o.align) for (o, _, _) in items),
                                np.int32, n)
        align_off = np.zeros(n, dtype=np.int64)
        np.cumsum(align_len[:-1], dtype=np.int64, out=align_off[1:])
        align_cat = (np.concatenate([o.align for (o, _, _) in items])
                     if n else np.zeros(0, np.int8))
        align_cat = np.ascontiguousarray(align_cat, dtype=np.int8)
        seq_idx = np.fromiter((o.seq_idx for (o, _, _) in items), np.int32, n)
        seq_start = np.fromiter((o.seq_start for (o, _, _) in items),
                                np.int32, n)
        read_start = np.fromiter((o.read_start for (o, _, _) in items),
                                 np.int32, n)
        match_cnt = np.fromiter((o.match_cnt for (o, _, _) in items),
                                np.int32, n)
        similarity = np.fromiter((o.similarity for (o, _, _) in items),
                                 np.float64, n)
        uniq_add = np.fromiter((1 if w == 1 else 0 for (_, _, w) in items),
                               np.uint8, n)
        # the same read's codes back many items: concatenate each
        # distinct array once, point items at shared offsets
        uniq_pos: Dict[int, int] = {}
        uniq_rcs: List[np.ndarray] = []
        for _, rc, _ in items:
            if id(rc) not in uniq_pos:
                uniq_pos[id(rc)] = len(uniq_rcs)
                uniq_rcs.append(rc)
        u_lens = np.fromiter((len(rc) for rc in uniq_rcs), np.int64,
                             len(uniq_rcs))
        u_base = np.zeros(len(uniq_rcs), dtype=np.int64)
        np.cumsum(u_lens[:-1], out=u_base[1:])
        reads_cat = np.ascontiguousarray(np.concatenate(uniq_rcs),
                                         dtype=np.int8)
        read_off = np.fromiter((u_base[uniq_pos[id(rc)]]
                                for (_, rc, _) in items), np.int64, n)
        variant_update(
            align_cat, align_off, align_len, seq_idx, seq_start, read_start,
            match_cnt, similarity, uniq_add, reads_cat, read_off,
            update_type != 1, self.seq_base, self._count.reshape(-1),
            self._uniq.reshape(-1), self._unweighted.reshape(-1),
            self._best_match.reshape(-1), self._best_sim.reshape(-1),
            self._best_match_max)

    def _update_all_python(self, items: List[Tuple],
                           update_type: int) -> None:
        """One full update pass, batched NumPy (the behavioural oracle).

        Byte-identical to calling update_fragment per fragment, because
        every reordered operation commutes:
          * all count/uniq/unweighted updates are integer-valued f64
            adds (exact at any accumulation order), and nothing reads
            them during a pass;
          * pass 1 (update_type=1) never reads best_* during the pass
            (filter off), and its best updates are an order-independent
            lexicographic (match, sim) max — deferred to a per-sequence
            sorted reduction at the end of the pass;
          * in pass 0 every no-stall overlap's best update is a no-op:
            pass 1 already applied the identical (pos, nuc, match, sim)
            tuples (a pass-0 no-stall overlap is no-stall in pass 1,
            whose stall condition — an N substitution — is a subset of
            pass 0's), so only the commutative count adds remain;
          * stall detection reads live best state per overlap in
            original order, and stalled overlaps run the exact
            sequential walk inline — those are the only in-pass readers
            and writers of best_*, so their interleaving is preserved.
        """
        filter_low_qual = update_type != 1

        # build missing walk caches with ONE global cumsum instead of
        # two per overlap
        need, seen = [], set()
        for o, _, _ in items:
            if o.walk_cache is None and len(o.align) and id(o) not in seen:
                seen.add(id(o))
                need.append(o)
        if need:
            # Most walks carry no indels, so every coordinate array is an
            # arithmetic progression: serve them as VIEWS of one shared
            # arange (zero allocation — large fresh buffers are
            # page-fault-bound on small hosts).  Indel walks (rare) get
            # exact per-overlap prefix sums.
            mx = 0
            for o in need:
                ln = len(o.align)
                mx = max(mx, o.seq_start + ln, o.read_start + ln)
            master = _pos_master(mx)
            for o in need:
                a = o.align
                ln = len(a)
                if int(a.max()) < EDIT_INSERT:  # substitutions only
                    s0, p0 = o.seq_start, o.read_start
                    rp = master[s0:s0 + ln]
                    pp = master[p0:p0 + ln]
                    o.walk_cache = (rp, pp, master[:ln], rp, pp)
                else:
                    ref_pos, read_pos = _edit_walk_positions(
                        a, o.seq_start, o.read_start)
                    subs = np.flatnonzero(a <= EDIT_MISMATCH)
                    o.walk_cache = (
                        ref_pos, read_pos, subs,
                        ref_pos[subs].astype(np.int32),
                        read_pos[subs].astype(np.int32))

        # global per-substitution arrays over every live item: one
        # concatenate + one gather each instead of 3-4 numpy calls per
        # overlap
        live = [it for it in items
                if it[0].walk_cache is not None and len(it[0].walk_cache[2])]
        if not live:
            return
        n_live = len(live)
        cnts = np.fromiter((len(o.walk_cache[3]) for (o, _, _) in live),
                           np.int64, n_live)
        bounds = np.zeros(n_live + 1, dtype=np.int64)
        np.cumsum(cnts, out=bounds[1:])
        g_rps = np.concatenate([o.walk_cache[3] for (o, _, _) in live])
        # the same read's codes back many live items (one per allele
        # assignment x mate end): concatenate each distinct array once
        # and point the items at shared offsets (id() keys are unique
        # here — every rc is kept alive by `live` itself)
        rc_list = [rc for (_, rc, _) in live]
        uniq_pos: Dict[int, int] = {}
        uniq_rcs: List[np.ndarray] = []
        for rc in rc_list:
            if id(rc) not in uniq_pos:
                uniq_pos[id(rc)] = len(uniq_rcs)
                uniq_rcs.append(rc)
        u_lens = np.fromiter((len(rc) for rc in uniq_rcs), np.int64,
                             len(uniq_rcs))
        u_base = np.zeros(len(uniq_rcs), dtype=np.int64)
        np.cumsum(u_lens[:-1], out=u_base[1:])
        arena = np.concatenate(uniq_rcs)
        rbase = np.fromiter((u_base[uniq_pos[id(rc)]] for rc in rc_list),
                            np.int64, n_live)
        g_nuc = arena[np.concatenate([o.walk_cache[4] for (o, _, _) in live])
                      + np.repeat(rbase, cnts)]
        g_idx = g_rps * 4 + g_nuc
        # segmented stall flags (all segments nonempty by construction)
        bad_seg = np.logical_or.reduceat(g_nuc >= 4, bounds[:-1])
        thr = None
        if filter_low_qual:
            seq_lens = np.fromiter((bv.best_match_max.shape[0]
                                    for bv in self.base), np.int64,
                                   len(self.base))
            seq_off = np.zeros(len(self.base), dtype=np.int64)
            np.cumsum(seq_lens[:-1], out=seq_off[1:])
            g_bmm = np.concatenate([bv.best_match_max for bv in self.base])
            item_off = np.fromiter((seq_off[o.seq_idx] for (o, _, _) in live),
                                   np.int64, n_live)
            thr = np.maximum.reduceat(g_bmm[g_rps + np.repeat(item_off, cnts)],
                                      bounds[:-1])

        buf_idx: Dict[int, List[np.ndarray]] = {}
        buf_uniq: Dict[int, List[np.ndarray]] = {}
        buf_best: Dict[int, List[Tuple[np.ndarray, int, float]]] = {}
        dirty = False  # an inline walk may have raised best_match_max
        for i, (o, rc, w) in enumerate(live):
            if bad_seg[i]:
                self._walk_sequential(o, rc, w, filter_low_qual)
                dirty = True
                continue
            if filter_low_qual:
                t = (int(self.base[o.seq_idx]
                         .best_match_max[o.walk_cache[3]].max())
                     if dirty else thr[i])
                if o.match_cnt < t - 4:
                    self._walk_sequential(o, rc, w, filter_low_qual)
                    dirty = True
                    continue
            idx = g_idx[bounds[i]:bounds[i + 1]]
            buf_idx.setdefault(o.seq_idx, []).append(idx)
            if w == 1:
                buf_uniq.setdefault(o.seq_idx, []).append(idx)
            if update_type == 1:
                buf_best.setdefault(o.seq_idx, []).append(
                    (idx, o.match_cnt, o.similarity))

        for si, lst in buf_idx.items():
            bv = self.base[si]
            cnt = np.bincount(np.concatenate(lst),
                              minlength=bv.count.size).astype(np.float64)
            cnt = cnt.reshape(-1, 4)
            bv.count += cnt
            bv.unweighted += cnt
        for si, lst in buf_uniq.items():
            bv = self.base[si]
            cnt = np.bincount(np.concatenate(lst),
                              minlength=bv.uniq.size).astype(np.float64)
            bv.uniq += cnt.reshape(-1, 4)
        for si, lst in buf_best.items():
            bv = self.base[si]
            # per-position lexicographic (match, sim) max: (match, sim)
            # is constant per overlap, so writing overlaps in ascending
            # order leaves the max as the last write per position — no
            # big sort over individual substitutions needed
            n4 = bv.best_match.size
            wm = np.full(n4, -1, dtype=np.int64)
            ws = np.zeros(n4, dtype=np.float64)
            lst.sort(key=lambda x: (x[1], x[2]))
            for idx, m, s in lst:
                wm[idx] = m
                ws[idx] = s
            u_i = np.flatnonzero(wm >= 0)
            u_m, u_s = wm[u_i], ws[u_i]
            bm = bv.best_match.ravel()
            bs = bv.best_sim.ravel()
            gt = u_m > bm[u_i]
            eq = (u_m == bm[u_i]) & (u_s > bs[u_i])
            if gt.any():
                bm[u_i[gt]] = u_m[gt]
                bs[u_i[gt]] = u_s[gt]
                np.maximum.at(bv.best_match_max, u_i[gt] >> 2, u_m[gt])
            if eq.any():
                bs[u_i[eq]] = u_s[eq]

    # -------------------------------------------------- candidate discovery
    def find_candidates(self) -> None:
        """alt count >= 5 and >= 0.5x ref-base count
        (VariantCaller.hpp:307-345)."""
        self.candidate_variants = []
        self.candidate_group_id = []
        self.candidate_root = []
        for i, a in enumerate(self.refset.alleles):
            bv = self.base[i]
            codes = np.asarray(a.codes[:a.length])
            cnt = bv.count[:a.length]
            valid = codes < 4
            ref_idx = np.where(valid, codes, 0).astype(np.int64)
            rows = np.arange(len(codes))
            ref_count = cnt[rows, ref_idx]
            hit = (cnt >= 5) & (cnt >= ref_count[:, None] * 0.5)
            hit[rows, ref_idx] = False  # k != ref_nuc
            for j in np.flatnonzero(valid & hit.any(axis=1)):
                bv.candidate_id[j] = len(self.candidate_variants)
                self.candidate_variants.append((i, int(j)))
                self.candidate_group_id.append(-1)
                self.candidate_root.append(True)

    def _expand_fragment(self, frags: List, adj_weight: List[Dict[int, float]]):
        """One fragment's contribution to candidate expansion + var-var
        weights (VariantCaller.hpp:347-571, with the always-true
        candidate-region precheck quirk preserved by omission)."""
        if not frags:
            return
        n = len(frags)
        for k in (0, 1):
            if k == 1 and not frags[0].has_mate_pair:
                break
            ovs = [f.overlap1 if k == 0 else f.overlap2 for f in frags]
            if any(o.align is None for o in ovs):
                continue
            read_len = frags[0].read_len2 if (
                k == 1 or (k == 0 and frags[0].o1_from_r2)) else frags[0].read_len1
            ref_pos = [o.seq_start for o in ovs]
            if any(o.read_start != ovs[0].read_start for o in ovs[1:]):
                continue
            # The position walk only mutates state when some current ref
            # position carries a candidate (first_cid != -1), and the
            # walk's ref positions stay within [seq_start, seq_end + 1].
            # Skip the whole walk when no overlap's window contains any
            # candidate -- provably output-neutral, and candidates are
            # sparse.  (The reference's own precheck is defeated by an
            # always-true quirk, VariantCaller.hpp:371-377; correcting it
            # changes no output, only work.)
            if not any(
                (self.base[o.seq_idx].candidate_id[
                    o.seq_start:o.seq_end + 2] != -1).any()
                for o in ovs
            ):
                continue
            read_pos = [o.read_start for o in ovs]
            align_idx = [0] * n
            seq_lens = [self.refset.alleles[o.seq_idx].length for o in ovs]

            for j in range(read_len):
                valid = []
                for i in range(n):
                    if ref_pos[i] < seq_lens[i]:
                        valid.append(self.base[ovs[i].seq_idx].good_assignment(
                            ref_pos[i], ovs[i].match_cnt))
                    else:
                        valid.append(False)
                first_cid = -1
                for i in range(n):
                    if not valid[i]:
                        continue
                    if (ref_pos[i] < seq_lens[i]
                            and self.base[ovs[i].seq_idx].candidate_id[ref_pos[i]] != -1):
                        first_cid = int(self.base[ovs[i].seq_idx].candidate_id[ref_pos[i]])
                        break
                if first_cid != -1:
                    for i in range(n):
                        if not valid[i]:
                            continue
                        o = ovs[i]
                        bv = self.base[o.seq_idx]
                        ai = align_idx[i]
                        if (bv.candidate_id[ref_pos[i]] == -1
                                and ai < len(o.align)
                                and o.align[ai] in (EDIT_MATCH, EDIT_MISMATCH)):
                            cid = len(self.candidate_variants)
                            self.candidate_variants.append((o.seq_idx, ref_pos[i]))
                            self.candidate_group_id.append(-1)
                            self.candidate_root.append(False)
                            bv.candidate_id[ref_pos[i]] = cid
                            adj_weight.append({})
                        cid = int(bv.candidate_id[ref_pos[i]])
                        if cid != -1:
                            self.candidate_group_id[cid] = -1
                    for i in range(n):
                        if not valid[i]:
                            continue
                        cid_i = int(self.base[ovs[i].seq_idx].candidate_id[ref_pos[i]])
                        if cid_i == -1:
                            continue
                        for l in range(n):
                            if i == l or not valid[l]:
                                continue
                            cid_l = int(self.base[ovs[l].seq_idx].candidate_id[ref_pos[l]])
                            if cid_l == -1:
                                continue
                            adj_weight[cid_i][cid_l] = adj_weight[cid_i].get(cid_l, 0) + 1

                for i in range(n):
                    o = ovs[i]
                    align = o.align
                    while align_idx[i] < len(align) and read_pos[i] <= j:
                        op = align[align_idx[i]]
                        if op != EDIT_INSERT:
                            ref_pos[i] += 1
                        if op != EDIT_DELETE:
                            read_pos[i] += 1
                        align_idx[i] += 1

    def _build_groups(self, adj_weight: List[Dict[int, float]]) -> int:
        """DFS over the var-var graph keeping edges with weight >= 0.15x
        either endpoint's coverage (VariantCaller.hpp:573-593)."""
        n = len(self.candidate_variants)
        group_cnt = 0

        def dfs(frm: int, tag: int):
            stack = [frm]
            while stack:
                cur = stack.pop()
                if self.candidate_group_id[cur] != -1:
                    continue
                self.candidate_group_id[cur] = tag
                si, pi = self.candidate_variants[cur]
                cov_from = self.base[si].unweighted[pi].sum()
                # reversed: the reference prepends edges and walks the chain
                for to, w in reversed(list(adj_weight[cur].items())):
                    st, pt = self.candidate_variants[to]
                    cov_to = self.base[st].unweighted[pt].sum()
                    if w >= cov_from * 0.15 or w >= cov_to * 0.15:
                        if self.candidate_group_id[to] == -1:
                            stack.append(to)

        for i in range(n):
            if self.candidate_root[i] and self.candidate_group_id[i] == -1:
                dfs(i, group_cnt)
                group_cnt += 1
        return group_cnt

    def _build_frag_var_graph(self, all_frags: List[List]):
        """Fragment <-> variant bipartite adjacency with supported
        nucleotide (VariantCaller.hpp:595-687)."""
        n_var = len(self.candidate_variants)
        var_to_frag: List[List[Tuple[int, int]]] = [[] for _ in range(n_var)]
        var_frag_seen: List[set] = [set() for _ in range(n_var)]
        for frag_idx, frags in enumerate(all_frags):
            if not frags:
                continue
            for k in (0, 1):
                if k == 1 and not frags[0].has_mate_pair:
                    break
                for f in frags:
                    o = f.overlap1 if k == 0 else f.overlap2
                    if o.align is None:
                        continue
                    if k == 0:
                        r = f.o1_rc if o.strand == -1 else (
                            f.r2_codes if f.o1_from_r2 else f.r1_codes)
                    else:
                        r = f.o2_rc if o.strand == -1 else f.r2_codes
                    bv = self.base[o.seq_idx]
                    if o.walk_cache is not None:
                        ref_pos, read_pos = o.walk_cache[0], o.walk_cache[1]
                    else:
                        ref_pos, read_pos = _edit_walk_positions(
                            o.align, o.seq_start, o.read_start)
                    cids = bv.candidate_id[ref_pos]
                    for idx in np.flatnonzero(cids != -1):
                        cid = int(cids[idx])
                        # a trailing deletion can point one past the read end;
                        # the reference reads the terminator there — model it
                        # as a sentinel nucleotide that matches nothing
                        rp = read_pos[idx]
                        nuc = int(r[rp]) if rp < len(r) else -2
                        key = (frag_idx, nuc)
                        if key not in var_frag_seen[cid]:
                            var_frag_seen[cid].add(key)
                            var_to_frag[cid].append(key)
        return var_to_frag

    # ----------------------------------------------------------- solving
    def _enumerate(self, vars_: List[int], frag_ids: List[int],
                   var_to_frag) -> Tuple[float, int, List[int], Optional[List[int]]]:
        """Exhaustive 4^n assignment; returns (bestCover, usedVarCnt,
        best_choices, equal_best_choices)."""
        n = len(vars_)
        best_cover = -1.0
        best_used = n + 1
        best_choice: List[int] = []
        equal_best: Optional[List[int]] = None
        frag_id_set = list(frag_ids)
        choices = [0] * n

        codes_of = [self.refset.alleles[self.candidate_variants[v][0]].codes
                    for v in vars_]
        ref_nucs = [int(codes_of[i][self.candidate_variants[vars_[i]][1]])
                    for i in range(n)]

        def evaluate():
            nonlocal best_cover, best_used, best_choice, equal_best
            covered_map: Dict[int, int] = {}
            for i in range(n):
                v = vars_[i]
                si, pi = self.candidate_variants[v]
                if n <= 1 and self.seq_copy[si] <= 1 and choices[i] != ref_nucs[i]:
                    continue
                for (fidx, nuc) in var_to_frag[v]:
                    if nuc == choices[i]:
                        covered_map[fidx] = 1
            if n <= 1:
                for i in range(n):
                    v = vars_[i]
                    si, pi = self.candidate_variants[v]
                    if self.seq_copy[si] != 1 or choices[i] == ref_nucs[i]:
                        continue
                    ref_contrib = alt_contrib = 0
                    for (fidx, nuc) in var_to_frag[v]:
                        if nuc == choices[i]:
                            alt_contrib += 1
                        elif nuc == ref_nucs[i]:
                            ref_contrib += 1
                    include_alt = (
                        ((alt_contrib >= 2
                          and self.base[si].uniq[pi, choices[i]] > 0)
                         or alt_contrib >= 10)
                        and alt_contrib > 0.15 * ref_contrib)
                    for (fidx, nuc) in var_to_frag[v]:
                        if nuc == ref_nucs[i] or (nuc == choices[i] and include_alt):
                            if covered_map.get(fidx, 0) == 0:
                                covered_map[fidx] = 2
            covered = 0.0
            for fidx in frag_id_set:
                if covered_map.get(fidx, 0):
                    covered += 1
            used = sum(1 for i in range(n) if ref_nucs[i] != choices[i])
            if covered > best_cover or (covered == best_cover and used < best_used):
                best_cover = covered
                best_used = used
                best_choice = list(choices)
                equal_best = None
            elif covered == best_cover and used == best_used:
                equal_best = list(choices)

        def recurse(depth: int):
            if depth == n:
                evaluate()
                return
            for c in range(4):
                choices[depth] = c
                recurse(depth + 1)

        recurse(0)
        return best_cover, best_used, best_choice, equal_best

    def _solve_group(self, vars_: List[int], var_to_frag) -> None:
        n = len(vars_)
        if n > self.max_var_group and self.max_var_group >= 0:
            return
        seq_used: Dict[int, int] = {}
        in_exon = False
        for v in vars_:
            si, pi = self.candidate_variants[v]
            if self.base[si].exon[pi]:
                in_exon = True
            seq_used[si] = seq_used.get(si, 0) + 1
            if seq_used[si] > 1:
                return
        if not in_exon:
            return

        frag_ids: List[int] = []
        frag_seen = set()
        for v in vars_:
            for (fidx, _) in var_to_frag[v]:
                if fidx not in frag_seen:
                    frag_seen.add(fidx)
                    frag_ids.append(fidx)

        _, _, best, equal_best = self._enumerate(vars_, frag_ids, var_to_frag)
        uniq = equal_best is None

        def emit(choice: List[int], output_group: int):
            for i, v in enumerate(vars_):
                si, pi = self.candidate_variants[v]
                if not self.base[si].exon[pi]:
                    continue
                ref_nuc = int(self.refset.alleles[si].codes[pi])
                var_nuc = choice[i]
                if ref_nuc == var_nuc:
                    continue
                bv = self.base[si]
                self.final_variants.append(Variant(
                    seq_idx=si, ref_start=pi, ref_end=pi,
                    ref="ACGTN"[ref_nuc], var="ACGTN"[var_nuc],
                    all_support=float(bv.count[pi].sum()),
                    var_support=float(bv.count[pi, var_nuc]),
                    var_uniq_support=float(bv.uniq[pi, var_nuc]),
                    var_group_id=self.candidate_group_id[v],
                    output_group_id=output_group,
                    qual=0 if not uniq else 60,
                ))

        emit(best, 0)
        if not uniq:
            emit(equal_best, 1)

    # ------------------------------------------------------------- driver
    def compute(self, all_frags: List[List]) -> None:
        """Full novel-variant pipeline (VariantCaller.hpp:978-1145).
        all_frags: per fragment, the assignment list; each record carries
        overlap(s) with precomputed edit walks and encoded read views."""
        if self.max_var_group == 0:
            return
        self._update_all(all_frags, 1)
        self._update_all(all_frags, 0)

        self.find_candidates()
        adj_weight: List[Dict[int, float]] = [{} for _ in self.candidate_variants]

        # with no candidates anywhere, expansion can only no-op: it
        # propagates existing candidates across co-aligned alleles
        while self.candidate_variants:
            prev = len(self.candidate_variants)
            for d in adj_weight:
                d.clear()
            for frags in all_frags:
                self._expand_fragment(frags, adj_weight)
            if prev == len(self.candidate_variants):
                break

        group_cnt = self._build_groups(adj_weight)
        var_to_frag = self._build_frag_var_graph(all_frags)

        groups: List[List[int]] = [[] for _ in range(group_cnt)]
        for i, gid in enumerate(self.candidate_group_id):
            if gid != -1:
                groups[gid].append(i)
        for g in groups:
            self._solve_group(g, var_to_frag)

        for vid, v in enumerate(self.final_variants):
            self.base[v.seq_idx].final_variant_ids.setdefault(
                v.ref_start, []).append(vid)

    def write_vcf(self, path: str) -> None:
        with open(path, "w") as f:
            for v in self.final_variants:
                status = "PASS" if v.qual > 0 else "FAIL"
                exon_pos = self._exonic_position(v.seq_idx, v.ref_start)
                f.write(
                    f"{self.refset.alleles[v.seq_idx].name} {exon_pos + 1} . "
                    f"{v.ref} {v.var} . {status} {v.var_support:.6f} "
                    f"{v.all_support:.6f} {v.var_uniq_support:.6f} "
                    f"{v.ref_start} {v.output_group_id}\n")

    def _exonic_position(self, seq_idx: int, pos: int) -> int:
        a = self.refset.alleles[seq_idx]
        if pos >= len(a.exon_mask) or not a.exon_mask[pos]:
            return -1
        psum = 0
        for (s, e) in a.exons:
            if s <= pos <= e:
                return psum + pos - s
            psum += e - s + 1
        return psum

    # --------------------------------------------- barcode adjustment
    def adjust_fragment_assignment(self, frags: List) -> List:
        """Re-rank a fragment's assignments by agreement with called
        variants (VariantCaller.hpp:1229-1311)."""
        if not frags:
            return frags
        scores = []
        for f in frags:
            score = 0.0
            for k in (0, 1):
                if k == 1 and not f.has_mate_pair:
                    continue
                o = f.overlap1 if k == 0 else f.overlap2
                if o.align is None:
                    continue
                if k == 0:
                    r = f.o1_rc if o.strand == -1 else (
                        f.r2_codes if f.o1_from_r2 else f.r1_codes)
                else:
                    r = f.o2_rc if o.strand == -1 else f.r2_codes
                bv = self.base[o.seq_idx]
                if o.walk_cache is not None:
                    ref_pos, read_pos = o.walk_cache[0], o.walk_cache[1]
                else:
                    ref_pos, read_pos = _edit_walk_positions(
                        o.align, o.seq_start, o.read_start)
                mism = o.align == EDIT_MISMATCH
                for idx in np.flatnonzero(mism):
                    vids = bv.final_variant_ids.get(int(ref_pos[idx]), [])
                    nuc = "ACGTN"[int(r[read_pos[idx]])]
                    for vid in vids:
                        if self.final_variants[vid].var == nuc:
                            score += 1
                            break
            scores.append(score)
        mx = max(scores)
        return [f for f, s in zip(frags, scores) if s == mx]


class BarcodeSummary:
    """Per-barcode x allele fragment counts, variant-adjusted
    (reference BarcodeSummary.hpp)."""

    def __init__(self, refset):
        self.refset = refset
        self.counts: Dict[int, np.ndarray] = {}   # fractional
        self.uniq: Dict[int, np.ndarray] = {}

    def add_fragment(self, barcode: int, variant_caller: Optional[VariantCaller],
                     frags: List) -> None:
        n_alleles = len(self.refset)
        if barcode not in self.counts:
            self.counts[barcode] = np.zeros(n_alleles, dtype=np.float64)
            self.uniq[barcode] = np.zeros(n_alleles, dtype=np.int64)
        adjusted = frags
        if variant_caller is not None:
            adjusted = variant_caller.adjust_fragment_assignment(frags)
        n = len(adjusted)
        for f in adjusted:
            self.counts[barcode][f.seq_idx] += 1.0 / n
            if n == 1:
                self.uniq[barcode][f.seq_idx] += 1

    def write(self, path: str, barcode_names: List[str]) -> None:
        names = [a.name for a in self.refset.alleles]
        with open(path, "w") as f:
            f.write("#barcode")
            for n in names:
                f.write(f"\t{n}")
            for n in names:
                f.write(f"\t{n}_uniq")
            f.write("\n")
            for bc in sorted(self.counts.keys()):
                f.write(barcode_names[bc])
                for v in self.counts[bc]:
                    f.write(f"\t{v:.6f}")
                for v in self.uniq[bc]:
                    f.write(f"\t{int(v)}")
                f.write("\n")
