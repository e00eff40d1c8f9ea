"""Genotyper stage on PyTorch / CUDA (the reference `genotyper`,
Genotyper.cpp:194-738).

Counterpart of ``t1k_tpu/core/pipeline.py``'s genotyper stage: read
ingest -> unique-read dedupe -> seed / chain / deferred banded DP (the
native engine with the band kernel scoring the deferred items) ->
fragment pairing and EC construction -> SQUAREM EM -> allele selection ->
outputs (genotype.tsv, allele.tsv, aligned fastas).

Backends: "native" keeps every DP on the host engine, "gpu" scores the
deferred items on ``opts.device`` (a CUDA card, or the CPU through the
kernel's plain version), "auto" is "gpu": it runs on ``opts.device`` and
raises when that is a CUDA device and no card is present.  Every route
writes byte-identical outputs.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..constants import (DEFAULT_MAX_ASSIGN_CNT, DEFAULT_REF_SEQ_SIMILARITY,
                         GENOTYPER_KMER_LENGTH, encode_seq)
from ..device import BACKENDS, NoCardError, resolve_backend, resolve_device
from ..io.reads import read_seq_files
from ..io.refset import RefSet
from ..native import NativeEngine
from ..ops import align_band
from ..ops.align_band import DeferredDescService
from ..ops.phase_a import DeviceCandidates
from ..utils.observability import (metrics, span, stage, start_metrics,
                                   tracing)
from .fragment import OverlapRec
from .genotyper import Genotyper, GenotyperConfig


def log(msg: str) -> None:
    ts = time.strftime("%a %b %d %H:%M:%S %Y")
    print(f"[{ts}] {msg}", file=sys.stderr)


@dataclass
class GenotypeOptions:
    ref_seq_similarity: float = DEFAULT_REF_SEQ_SIMILARITY
    relax_intron_align: bool = False
    max_assign_cnt: int = DEFAULT_MAX_ASSIGN_CNT
    filter_frac: float = 0.15
    filter_cov: float = 1.0
    cross_gene_rate: float = 0.04
    min_squarem_alpha: float = 0.0
    digit_units: int = -1
    delimiter: str = ""
    allele_whitelist: Optional[str] = None
    abundance_file: Optional[str] = None
    em_state_file: Optional[str] = None  # resume EM from a prior snapshot
    barcode_file: Optional[str] = None
    output_read_assignment: bool = False
    threads: int = 1
    # "auto", "native" or "gpu" (module docstring); byte-identical outputs
    backend: str = "auto"
    # gpu backend: reads per deferred-DP cycle (the JAX package's 2048,
    # which keeps each chunk's host arenas cache-friendly)
    defer_chunk: int = 2048
    em_backend: str = "auto"
    # torch device of the gpu routes: a CUDA device, or "cpu" for the
    # kernels' plain versions
    device: str = "cuda"
    # The device prunes each read's (strand, seq) buckets to those whose
    # chains emit an overlap (ops/phase_a.py DeviceCandidates) and the host
    # engine collects hits only for them; byte-identical.  Off by default,
    # as in the JAX package.  Runs on `device` whatever the backend.
    device_candidates: bool = False


# The candidate route's chunking on the genotyper (a routing choice; every
# cap gives the same outputs): reads per chunk such that a chunk's hit
# arena stays under the 2^24-slot cap on an HLA-scale panel (PERF.md §5).
CANDIDATE_CAPS = dict(row_chunk=512)


@dataclass
class GenotypeResult:
    genotyper: Genotyper
    refset: RefSet
    aligned_flags: List[bool]
    read_ids1: List[str]
    read_ids2: List[str]
    read_seqs1: List[str]
    read_seqs2: List[str]
    barcodes: Optional[List[str]]
    em_iterations: int
    aligned_fragment_cnt: int


@dataclass
class PreparedGenotype:
    """Pipeline state after fragment assignment, before EM."""
    genotyper: Genotyper
    refset: RefSet
    opts: GenotypeOptions
    aligned_flags: List[bool]
    read_ids1: List[str]
    read_ids2: List[str]
    read_seqs1: List[str]
    read_seqs2: List[str]
    barcodes: Optional[List[str]]
    aligned_fragment_cnt: int
    assign_rows: Optional[List[str]]
    has_mate: bool


def assign_unique_reads(
    engine, seqs: List[str], backend: str = "native",
    desc_service: Optional[DeferredDescService] = None,
    store_results: bool = True, defer_chunk: int = 0,
    zero_weights: bool = False, device_candidates=None,
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Group identical read sequences and run the engine once per unique
    sequence with the group size as its weight (Genotyper.cpp:450-479).
    The analyzer passes zero weights so base coverage is left untouched
    (Analyzer.cpp:142).

    With backend "gpu" the gap-fill and overhang alignments go to
    `desc_service` through the engine's deferred descriptor mode.  With
    `device_candidates` (a DeviceCandidates) the engine collects hits
    only for the buckets it keeps, on either backend.

    Inside a tracing stage the grouping, encoding and candidate set-up
    are the span `prepare`, and the gpu backend's passes the spans of
    assign_batch_deferred."""
    with span("prepare"):
        order = sorted(range(len(seqs)), key=lambda i: seqs[i])
        uniq: List[str] = []
        weights: List[int] = []
        group_of = np.zeros(len(seqs), dtype=np.int64)
        i = 0
        while i < len(order):
            j = i + 1
            while j < len(order) and seqs[order[j]] == seqs[order[i]]:
                j += 1
            for k in range(i, j):
                group_of[order[k]] = len(uniq)
            uniq.append(seqs[order[i]])
            weights.append(0 if zero_weights else j - i)
            i = j

        if uniq:
            codes = np.concatenate([encode_seq(s) for s in uniq])
        else:
            codes = np.zeros(0, dtype=np.int8)
        lens = np.array([len(s) for s in uniq], dtype=np.int32)
        starts = np.zeros(len(lens), dtype=np.int64)
        if len(lens):
            starts[1:] = np.cumsum(lens[:-1])
        w = np.array(weights, dtype=np.int32)
        prune = device_candidates is not None and len(uniq) > 0
        if prune:
            padded = np.full((len(uniq), int(lens.max())), 4, dtype=np.int8)
            padded[np.arange(padded.shape[1])[None, :] < lens[:, None]] = codes
            engine.set_candidates(len(uniq), *device_candidates.generate(
                padded, lens))
    if backend == "gpu":
        if desc_service is None:
            raise ValueError("the gpu backend needs a desc_service")
        rec, off = engine.assign_batch_deferred(
            codes, starts, lens, w, desc_service=desc_service,
            store_results=store_results,
            chunk_size=defer_chunk if not store_results else 0)
    elif backend == "native":
        rec, off = engine.assign_batch(codes, starts, lens, w,
                                       store_results=store_results)
    else:
        raise ValueError(f"unknown alignment backend {backend!r}")
    if prune:
        engine.set_candidates(0, None, None, None, None)  # clear
    return uniq, group_of, rec, off


def engine_stage_counters(engine, backend: str) -> dict:
    """What a read-assignment stage records of the engine's pass: the
    gpu backend's begin passes, and while the stage traces the engine's
    counters and phase times (NativeEngine.trace_counters)."""
    out = {"chunk_count": engine.last_chunk_count} if backend == "gpu" else {}
    if tracing():
        out.update(engine.trace_counters())
    return out


def overlap_lists_from_records(rec: np.ndarray,
                               off: np.ndarray) -> List[List[OverlapRec]]:
    """Per unique read, its engine records [N,11] as OverlapRec lists."""
    return [[OverlapRec.from_row(rec[k]) for k in range(off[i], off[i + 1])]
            for i in range(len(off) - 1)]


def load_reads(reads1: List[str], reads2: Optional[List[str]],
               barcode_file=None):
    """(ids1, seqs1, ids2, seqs2, barcodes) of the input fragments, in
    file order.  With a barcode file (one name or a list) a fragment whose
    barcode reads "missing_barcode" is skipped; barcodes is None
    without one."""
    has_mate = reads2 is not None
    ids1, seqs1, ids2, seqs2 = [], [], [], []
    barcodes: Optional[List[str]] = [] if barcode_file else None
    bc_files = (barcode_file if isinstance(barcode_file, (list, tuple))
                else [barcode_file])
    bc_iter = iter(read_seq_files(bc_files)) if barcode_file else None
    it2 = read_seq_files(reads2) if has_mate else None
    for rec1 in read_seq_files(reads1):
        rec2 = next(it2) if has_mate else None
        if bc_iter is not None:
            bc = next(bc_iter)
            if bc.seq == "missing_barcode":
                continue
            barcodes.append(bc.seq)
        ids1.append(rec1.id)
        seqs1.append(rec1.seq)
        if has_mate:
            ids2.append(rec2.id)
            seqs2.append(rec2.seq)
    return ids1, seqs1, ids2, seqs2, barcodes


def new_genotyper(refset: RefSet, opts: GenotypeOptions, device,
                  max_read_length: int) -> Genotyper:
    """The stage's Genotyper with the options' filters, EM route and
    allele whitelist."""
    gcfg = GenotyperConfig(
        filter_frac=opts.filter_frac, filter_cov=opts.filter_cov,
        cross_gene_rate=opts.cross_gene_rate,
        max_assign_cnt=opts.max_assign_cnt,
        min_squarem_alpha=opts.min_squarem_alpha,
        read_length=max_read_length, em_backend=opts.em_backend,
    )
    genotyper = Genotyper(refset, gcfg, device=device)
    if opts.allele_whitelist:
        with open(opts.allele_whitelist) as f:
            genotyper.set_allele_whitelist(f.read().split())
    return genotyper


def resolve_routes(opts: GenotypeOptions,
                   desc_service: Optional[DeferredDescService] = None):
    """(backend, device, desc_service) of the stage's options: "auto"
    resolved, the card asked for where a gpu route runs (raising before
    any work without one, as the EM's "auto" does), and the band-kernel
    service the gpu backend scores on, `desc_service` if given."""
    if opts.device_candidates:  # on opts.device whatever the backend
        resolve_device(opts.device, NoCardError)
    backend = resolve_backend(opts.backend, opts.device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown alignment backend {backend!r}")
    device = opts.device
    if backend == "gpu" or opts.em_backend == "gpu":
        device = resolve_device(opts.device)
    if opts.em_backend == "auto":  # without a card: fail before any work
        Genotyper._resolve_em_backend(0, 0, opts.device)
    if backend == "gpu" and desc_service is None:
        desc_service = DeferredDescService(device)
    return backend, device, desc_service


def run_genotyper(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts: Optional[GenotypeOptions] = None,
    refset: Optional[RefSet] = None,
) -> GenotypeResult:
    prep = prepare_genotyper(ref_fasta, reads1, reads2, opts, refset)
    return finish_genotyper(prep, output_prefix)


def prepare_genotyper(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    opts: Optional[GenotypeOptions] = None,
    refset: Optional[RefSet] = None,
    desc_service: Optional[DeferredDescService] = None,
) -> PreparedGenotype:
    """Load reference and reads, run read and fragment assignment and EC
    construction; stop at the EM boundary (Genotyper.cpp:194-637).
    `desc_service` replaces the band-kernel service the gpu backend
    would build on `opts.device`."""
    opts = opts or GenotypeOptions()
    backend, device, desc_service = resolve_routes(opts, desc_service)
    if refset is None:
        refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    packed = refset.packed()
    engine = NativeEngine(
        packed, GENOTYPER_KMER_LENGTH,
        ref_seq_similarity=opts.ref_seq_similarity,
        relax_intron_align=opts.relax_intron_align,
        threads=opts.threads,
    )
    has_mate = reads2 is not None

    ids1, seqs1, ids2, seqs2, barcodes = load_reads(reads1, reads2,
                                                    opts.barcode_file)
    read_cnt = len(seqs1)
    max_read_length = max((len(s) for s in seqs1 + seqs2), default=0)
    genotyper = new_genotyper(refset, opts, device, max_read_length)
    whitelist = genotyper.whitelist if opts.allele_whitelist else None

    start_metrics()
    log(f"Found {read_cnt} read fragments. Start read assignment.")
    all_seqs = seqs1 + seqs2
    dev_cand = None
    if opts.device_candidates:
        dev_cand = DeviceCandidates.build(
            packed, GENOTYPER_KMER_LENGTH, engine.hit_len_required,
            device=resolve_device(opts.device), **CANDIDATE_CAPS)
    launches0 = align_band.launch_counts["band_stats"]
    items0 = desc_service.items_scored if desc_service is not None else 0
    with stage("read_assignment") as ctx:
        uniq, group_of, _, _ = assign_unique_reads(
            engine, all_seqs, backend, desc_service, store_results=False,
            defer_chunk=opts.defer_chunk, device_candidates=dev_cand)
        ctx["read_count"] = len(all_seqs)
        ctx["unique_read_count"] = len(uniq)
        ctx["alignment_count"] = engine.last_assign_count
        ctx["deferred_item_count"] = (
            desc_service.items_scored - items0
            if backend == "gpu" else 0)
        ctx["band_kernel_launches"] = (align_band.launch_counts["band_stats"]
                                       - launches0)
        ctx.update(engine_stage_counters(engine, backend))
        if dev_cand is not None:
            ctx["candidate_count"] = dev_cand.kept
            ctx["device_decided_reads"] = dev_cand.decided
            ctx["candidate_seconds"] = round(dev_cand.seconds, 6)
    log("Finish read end assignments.")

    has_n = np.array(
        [("N" in s1) or (has_mate and "N" in s2)
         for s1, s2 in zip(seqs1, seqs2 if has_mate else [""] * read_cnt)],
        dtype=np.uint8)
    uid1 = group_of[:read_cnt]
    uid2 = (group_of[read_cnt:] if has_mate
            else np.full(read_cnt, -1, dtype=np.int64))

    with stage("fragment_assignment") as sctx:
        frag_rec = frag_counts = None
        if opts.output_read_assignment:
            # the per-fragment records cross into Python for the dump
            frag_rec, frag_counts, aligned_flags_arr = engine.fragment_batch(
                uid1, uid2, has_n, has_mate, opts.max_assign_cnt, whitelist)
            aligned_fragment_cnt = genotyper.coalesce_arrays(
                frag_rec, frag_counts)
        else:
            coalesced, assigned_cnt, frag_counts, aligned_flags_arr = (
                engine.fragment_batch_coalesced(
                    uid1, uid2, has_n, has_mate, opts.max_assign_cnt,
                    whitelist))
            aligned_fragment_cnt = genotyper.adopt_coalesced(
                coalesced, assigned_cnt)
        aligned_flags = aligned_flags_arr.tolist()
        genotyper.finalize(engine.pos_weight(), packed)
        sctx["fragment_count"] = read_cnt
        sctx["aligned_fragment_count"] = aligned_fragment_cnt
        sctx["read_group_count"] = genotyper.read_group_count
        sctx["equivalence_class_count"] = len(genotyper.ec_to_alleles)

    assign_rows = None
    if opts.output_read_assignment:
        assign_rows = []
        off = np.zeros(read_cnt + 1, dtype=np.int64)
        off[1:] = np.cumsum(frag_counts)
        for i in range(read_cnt):
            for k in range(off[i], off[i + 1]):
                r = frag_rec[k]
                assign_rows.append(
                    f"{ids1[i]}\t{refset.alleles[int(r[0])].name}"
                    f"\t{int(r[1])}\t{int(r[2])}")
    log(f"Finish read fragment assignments. {aligned_fragment_cnt} read "
        f"fragments can be assigned.")
    return PreparedGenotype(
        genotyper=genotyper, refset=refset, opts=opts,
        aligned_flags=aligned_flags, read_ids1=ids1, read_ids2=ids2,
        read_seqs1=seqs1, read_seqs2=seqs2, barcodes=barcodes,
        aligned_fragment_cnt=aligned_fragment_cnt, assign_rows=assign_rows,
        has_mate=has_mate)


def finish_genotyper(
    prep: PreparedGenotype,
    output_prefix: str,
    em_result: Optional[Tuple[int, np.ndarray]] = None,
    side_files: bool = True,
) -> GenotypeResult:
    """EM (or a supplied abundance file, EM snapshot or EM result), allele
    selection, and output writing (Genotyper.cpp:640-738).  `em_result`
    is (iterations, per-EC read counts) from an external quantification:
    the SMART-seq cohort's batched EM.  Without `side_files` the EM snapshot
    (<prefix>_em_state.npz) and <prefix>_metrics.json are not written:
    the in-process sharded genotyper writes the reference's files only."""
    opts = prep.opts
    genotyper = prep.genotyper
    ids1, ids2 = prep.read_ids1, prep.read_ids2
    seqs1, seqs2 = prep.read_seqs1, prep.read_seqs2
    aligned_flags = prep.aligned_flags
    read_cnt = len(seqs1)

    if opts.abundance_file:
        genotyper.init_abundance_from_file(opts.abundance_file)
        em_iters = 0
    elif opts.em_state_file:
        genotyper.load_em_state(opts.em_state_file)
        em_iters = 0
        log("Resumed EM sufficient statistics from "
            f"{opts.em_state_file}; skipping quantification.")
    elif em_result is not None:
        em_iters = genotyper.set_em_result(*em_result)
        log(f"Adopted externally quantified abundances "
            f"({em_iters} EM iterations).")
    else:
        with stage("em_quantification") as ctx:
            em_iters = genotyper.quantify()
            ctx["em_iteration_count"] = em_iters
            if side_files:
                genotyper.save_em_state(f"{output_prefix}_em_state.npz",
                                        genotyper._last_ec_read_count)
        log(f"Finish allele quantification in {em_iters} EM iterations.")
    with stage("allele_selection"):
        genotyper.remove_low_likelihood()
        genotyper.select_alleles()

    # ------------------------------------------------------------ outputs
    genotyper.write_genotype_tsv(f"{output_prefix}_genotype.tsv")
    with open(f"{output_prefix}_allele.tsv", "w") as f:
        for name, qual in genotyper.representative_alleles():
            f.write(f"{name} {qual}\n")

    suffix1 = "_aligned_1.fa" if prep.has_mate else "_aligned.fa"
    with open(f"{output_prefix}{suffix1}", "w") as f:
        for i in range(read_cnt):
            if aligned_flags[i]:
                f.write(f">{ids1[i]}\n{seqs1[i]}\n")
    if prep.has_mate:
        with open(f"{output_prefix}_aligned_2.fa", "w") as f:
            for i in range(read_cnt):
                if aligned_flags[i]:
                    f.write(f">{ids2[i]}\n{seqs2[i]}\n")
    if prep.barcodes is not None:
        with open(f"{output_prefix}_aligned_bc.fa", "w") as f:
            for i in range(read_cnt):
                if aligned_flags[i]:
                    f.write(f">{ids1[i]}\n{prep.barcodes[i]}\n")
    if prep.assign_rows is not None:
        with open(f"{output_prefix}_assign.tsv", "w") as f:
            for row in prep.assign_rows:
                f.write(row + "\n")

    if side_files:
        metrics().save(f"{output_prefix}_metrics.json")
    log("Genotyping finishes.")
    return GenotypeResult(
        genotyper=genotyper, refset=prep.refset, aligned_flags=aligned_flags,
        read_ids1=ids1, read_ids2=ids2, read_seqs1=seqs1, read_seqs2=seqs2,
        barcodes=prep.barcodes, em_iterations=em_iters,
        aligned_fragment_cnt=prep.aligned_fragment_cnt,
    )
