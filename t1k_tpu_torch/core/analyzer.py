"""Post-analysis stage on PyTorch / CUDA (the reference `analyzer`):
re-align the aligned reads against only the selected alleles,
re-quantify, store full edit walks, call novel SNPs, and emit the VCF plus
the barcode expression matrix.

Counterpart of ``t1k_tpu/core/analyzer.py``.  Routing as in
``core/pipeline.py``: backend "native" keeps every DP on the host engine,
"gpu" scores the engine's deferred items with the band kernel on
``opts.device`` (a CUDA card, or the CPU through the kernel's plain
version), "auto" is "gpu" and raises without a card when the device is a
CUDA one.  The EM runs by ``opts.em_backend`` on the same device.  Every
route writes byte-identical outputs.

Behavior contract: reference Analyzer.cpp:218-731.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..constants import GENOTYPER_KMER_LENGTH, encode_seq, revcomp_codes
from ..device import BACKENDS, resolve_backend, resolve_device
from ..io.refset import RefSet
from ..native import NativeEngine, align_global_batch
from ..ops import align_band
from ..ops.align_band import DeferredDescService
from ..utils.observability import metrics, span, stage, traced_range
from .fragment import RefContext, fragment_assign, set_read_assignments
from .genotyper import Genotyper, GenotyperConfig, pack_assignments
from .pipeline import (assign_unique_reads, engine_stage_counters,
                       load_reads, log, overlap_lists_from_records)
from .variant import BarcodeSummary, VariantCaller


@dataclass
class AnalyzerOptions:
    ref_seq_similarity: float = 0.8
    relax_intron_align: bool = False
    max_assign_cnt: int = 2000
    digit_units: int = -1
    delimiter: str = ""
    barcode_file: Optional[str] = None
    var_max_group: int = 8
    threads: int = 1
    # "auto", "native" or "gpu" (module docstring); byte-identical outputs
    backend: str = "auto"
    em_backend: str = "auto"
    # torch device of the gpu routes: a CUDA device, or "cpu" for the
    # kernels' plain versions
    device: str = "cuda"


class _AnalyzerOverlap:
    """Overlap view carrying the edit walk for the variant caller."""
    __slots__ = ("seq_idx", "read_start", "read_end", "seq_start", "seq_end",
                 "strand", "match_cnt", "similarity", "align", "walk_cache")

    def __init__(self, rec):
        self.seq_idx = rec.seq_idx
        self.read_start = rec.read_start
        self.read_end = rec.read_end
        self.seq_start = rec.seq_start
        self.seq_end = rec.seq_end
        self.strand = rec.strand
        self.match_cnt = rec.match_cnt
        self.similarity = rec.similarity
        self.align = None
        self.walk_cache = None


class _AnalyzerFragment:
    __slots__ = ("seq_idx", "has_mate_pair", "o1_from_r2", "overlap1",
                 "overlap2", "r1_codes", "r2_codes", "o1_rc", "o2_rc",
                 "read_len1", "read_len2")

    def __init__(self, frag, r1_codes, r2_codes):
        self.seq_idx = frag.seq_idx
        self.has_mate_pair = frag.has_mate_pair
        self.o1_from_r2 = frag.o1_from_r2
        self.overlap1 = _AnalyzerOverlap(frag.overlap1)
        self.overlap2 = _AnalyzerOverlap(frag.overlap2) if frag.overlap2 else None
        self.r1_codes = r1_codes
        self.r2_codes = r2_codes
        self.o1_rc = None
        self.o2_rc = None
        self.read_len1 = len(r1_codes) if r1_codes is not None else 0
        self.read_len2 = len(r2_codes) if r2_codes is not None else 0


def _add_alignment_info_batch(frags_lists, refset) -> None:
    """Full-span edit walks for every overlap (SeqSet.hpp:2657-2680),
    all DP calls batched into one native call."""
    t_parts, p_parts, targets = [], [], []

    def enqueue(o: _AnalyzerOverlap, codes: np.ndarray):
        r = revcomp_codes(codes) if o.strand == -1 else codes
        t_parts.append(
            refset.alleles[o.seq_idx].codes[o.seq_start:o.seq_end + 1])
        p_parts.append(r[o.read_start:o.read_end + 1])
        targets.append(o)
        return r if o.strand == -1 else None

    for frags in frags_lists:
        for frag in frags:
            if frag.has_mate_pair:
                frag.o1_rc = enqueue(frag.overlap1, frag.r1_codes)
                frag.o2_rc = enqueue(frag.overlap2, frag.r2_codes)
            else:
                codes = frag.r2_codes if frag.o1_from_r2 else frag.r1_codes
                frag.o1_rc = enqueue(frag.overlap1, codes)
    for o, edits in zip(targets, align_global_batch(t_parts, p_parts)):
        o.align = edits


@traced_range("analyze")
def run_analyzer(
    ref_fasta: str,
    allele_file: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts: Optional[AnalyzerOptions] = None,
) -> dict:
    opts = opts or AnalyzerOptions()
    backend = resolve_backend(opts.backend, opts.device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown alignment backend {backend!r}")
    device = opts.device
    if backend == "gpu" or opts.em_backend == "gpu":
        device = resolve_device(opts.device)
    if opts.em_backend == "auto":  # without a card: fail before any work
        Genotyper._resolve_em_backend(0, 0, opts.device)
    desc_service = DeferredDescService(device) if backend == "gpu" else None
    has_mate = reads2 is not None

    selected = set()
    with open(allele_file) as f:
        for line in f:
            toks = line.split()
            if toks:
                selected.add(toks[0])

    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter,
                               selected_names=selected)
    packed = refset.packed()
    engine = NativeEngine(
        packed, GENOTYPER_KMER_LENGTH,
        ref_seq_similarity=opts.ref_seq_similarity,
        relax_intron_align=opts.relax_intron_align,
        threads=opts.threads,
    )

    _, seqs1, _, seqs2, barcodes = load_reads(reads1, reads2,
                                              opts.barcode_file)
    # each fragment's barcode as its index in order of first appearance
    bc_map = {}
    barcode_idx = [bc_map.setdefault(bc, len(bc_map)) for bc in barcodes or ()]
    bc_names = list(bc_map)

    read_cnt = len(seqs1)
    max_read_length = max([len(s) for s in seqs1 + seqs2], default=0)
    gcfg = GenotyperConfig(read_length=max_read_length,
                           em_backend=opts.em_backend)
    genotyper = Genotyper(refset, gcfg, device=device)

    log(f"Found {read_cnt} read fragments. Start read assignment.")
    all_seqs = seqs1 + seqs2
    launches0 = align_band.launch_counts["band_stats"]
    with stage("analyzer_read_assignment", read_count=read_cnt) as st:
        uniq, group_of, rec, off = assign_unique_reads(
            engine, all_seqs, backend, desc_service, zero_weights=True)
        with span("finish"):
            overlap_lists = overlap_lists_from_records(rec, off)
        st["unique_read_count"] = len(uniq)
        st["deferred_item_count"] = (desc_service.items_scored
                                     if desc_service is not None else 0)
        st["band_kernel_launches"] = (align_band.launch_counts["band_stats"]
                                      - launches0)
        st.update(engine_stage_counters(engine, backend))
    log("Finish read end assignments.")

    ctx = RefContext(refset, hit_len_required=31,
                     relax_intron_align=opts.relax_intron_align,
                     ref_seq_similarity=opts.ref_seq_similarity)

    r1_codes = [encode_seq(s) for s in seqs1]
    r2_codes = [encode_seq(s) for s in seqs2] if has_mate else [None] * read_cnt

    fragment_assignments: List[List[_AnalyzerFragment]] = []
    per_read_assignments = []
    aligned_flags = [False] * read_cnt
    for i in range(read_cnt):
        ov1 = overlap_lists[group_of[i]]
        ov2 = overlap_lists[group_of[read_cnt + i]] if has_mate else None
        has_n = ("N" in seqs1[i]) or (has_mate and "N" in seqs2[i])
        frags = fragment_assign(ctx, ov1, ov2, has_n, has_mate)
        per_read_assignments.append(
            set_read_assignments(ctx, frags, None, opts.max_assign_cnt))
        if frags:
            aligned_flags[i] = True
        fragment_assignments.append(
            [_AnalyzerFragment(f, r1_codes[i],
                               r2_codes[i] if has_mate else None)
             for f in frags])

    aligned_cnt = genotyper.coalesce_arrays(
        *pack_assignments(per_read_assignments))
    genotyper.finalize(engine.pos_weight(), packed)
    log(f"Finish read fragment assignments. {aligned_cnt} read fragments can "
        f"be assigned.")
    em_iters = genotyper.quantify()
    log(f"Finish allele quantification in {em_iters} EM iterations.")

    with stage("alignment_info", fragment_count=aligned_cnt):
        _add_alignment_info_batch(
            (fragment_assignments[i] for i in range(read_cnt)
             if aligned_flags[i]), refset)

    vc = VariantCaller(refset, packed, opts.var_max_group)
    vc.set_seq_abundance(genotyper)
    with stage("variant_calling") as st:
        vc.compute(fragment_assignments)
        st["variant_count"] = len(vc.final_variants)
    vc.write_vcf(f"{output_prefix}_allele.vcf")

    if barcodes is not None:
        summary = BarcodeSummary(refset)
        for i in range(read_cnt):
            if not aligned_flags[i]:
                continue
            summary.add_fragment(barcode_idx[i], vc, fragment_assignments[i])
        summary.write(f"{output_prefix}_barcode_expr.tsv", bc_names)

    log("Post analysis finishes.")
    metrics().save(f"{output_prefix}_analyzer_metrics.json")
    return {"em_iterations": em_iters, "variants": len(vc.final_variants)}
