"""Host-sharded genotyping: the multi-host execution model.

Each shard of the input fragments (a contiguous range) runs read
assignment -> fragment assignment against its own engine (and, on the
gpu route, a band-kernel service on the card), and hands on only the
per-fragment assignment records (allele, span, float32 weights) plus its
integer coverage tensor.  The merge concatenates the records in shard
order, sums the coverage tensors and runs the global stages (coalesce ->
ECs -> EM -> selection -> outputs) in ``_merge_and_finish``.

This composition is *byte-identical* to the single-process pipeline:

* fragment records concatenated in shard order reproduce the global
  fragment order, so float32 coalescing accumulates identically;
* the per-base coverage scatter is integer and additive, so per-shard
  tensors sum to the global tensor regardless of how duplicate reads
  split across shards;
* read assignment itself is per-read and weight-independent.

Two flavours run it.  ``run_genotyper_distributed`` runs the shards one
after another in one process, each with its own engine and all on one
``DeferredDescService`` (the panel uploaded once).  The multi-process
mode of ``cli/run.py`` runs one shard a process (``worker_shard_to_file``,
each with its own service) and exchanges shard files by atomic rename,
matching run-t1k's files-between-stages contract; process 0 merges them
(``merge_shards_and_finish``).  Counterpart of
``t1k_tpu/parallel/distributed.py``.

Reference behavior contract: Genotyper.cpp:337-718 (single-node flow
this distributes).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..constants import GENOTYPER_KMER_LENGTH
from ..core.pipeline import (GenotypeOptions, PreparedGenotype,
                             assign_unique_reads, engine_stage_counters,
                             finish_genotyper, load_reads, log,
                             new_genotyper, resolve_routes)
from ..device import BACKENDS, resolve_backend, resolve_device
from ..io.refset import RefSet
from ..native import NativeEngine
from ..ops import align_band
from ..ops.align_band import DeferredDescService
from ..utils.observability import metrics, stage, start_metrics


def shard_bounds(n: int, workers: int) -> List[tuple]:
    """Contiguous fragment shards, reference thread-split convention
    (Genotyper.cpp:132-135)."""
    base = n // workers
    out = []
    for w in range(workers):
        lo = base * w
        hi = n if w == workers - 1 else base * (w + 1)
        out.append((lo, hi))
    return out


def _worker_stage(packed, opts, s1: List[str], s2: List[str],
                  has_mate: bool,
                  service: Optional[DeferredDescService] = None):
    """The per-shard stage: read assignment + fragment assignment on one
    contiguous fragment shard, on the backend resolved from `opts`; the
    gpu backend scores on `service`, or on a service of its own.
    Returns (frag_rec, frag_counts, flags, pos_weight), the only data
    that crosses shards."""
    backend = resolve_backend(opts.backend, opts.device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown alignment backend {backend!r}")
    if backend == "gpu" and service is None:
        service = DeferredDescService(resolve_device(opts.device))
    engine = NativeEngine(
        packed, GENOTYPER_KMER_LENGTH,
        ref_seq_similarity=opts.ref_seq_similarity,
        relax_intron_align=opts.relax_intron_align,
        threads=opts.threads,
    )
    all_seqs = s1 + s2
    launches0 = align_band.launch_counts["band_stats"]
    items0 = service.items_scored if service is not None else 0
    with stage("read_assignment") as ctx:
        _, group_of, _, _ = assign_unique_reads(
            engine, all_seqs, backend, service, store_results=False,
            defer_chunk=opts.defer_chunk)
        ctx["read_count"] = len(all_seqs)
        ctx["deferred_item_count"] = (service.items_scored - items0
                                      if service is not None else 0)
        ctx["band_kernel_launches"] = (align_band.launch_counts["band_stats"]
                                       - launches0)
        ctx.update(engine_stage_counters(engine, backend))
    n = len(s1)
    has_n = np.array(
        [("N" in a) or (has_mate and "N" in b)
         for a, b in zip(s1, s2 if has_mate else [""] * n)],
        dtype=np.uint8)
    uid1 = group_of[:n]
    uid2 = (group_of[n:] if has_mate
            else np.full(n, -1, dtype=np.int64))
    rec, counts, flags = engine.fragment_batch(
        uid1, uid2, has_n, has_mate, opts.max_assign_cnt, None)
    pw = engine.pos_weight()
    del engine
    return rec, counts, flags, pw


def _merge_and_finish(refset: RefSet, opts, device, reads, shards,
                      has_mate: bool, output_prefix: str,
                      side_files: bool = True):
    """The merge stage: the shards' (frag_rec, frag_counts, flags,
    pos_weight), in shard order, concatenated back into the global
    fragment order, coalesced into read groups and ECs, then the
    single-process tail (core/pipeline.py::finish_genotyper: EM,
    selection, outputs).  `reads` is load_reads' (ids1, seqs1, ids2,
    seqs2).  Returns the Genotyper."""
    ids1, seqs1, ids2, seqs2 = reads
    frag_rec_parts, frag_count_parts, flag_parts = [], [], []
    pos_weight = None
    for rec, counts, flags, pw in shards:
        frag_rec_parts.append(rec)
        frag_count_parts.append(counts)
        flag_parts.append(flags)
        pos_weight = pw if pos_weight is None else pos_weight + pw
    frag_rec = (np.concatenate(frag_rec_parts)
                if frag_rec_parts else np.zeros((0, 6)))
    frag_counts = np.concatenate(frag_count_parts)

    max_read_length = max((len(s) for s in seqs1 + seqs2), default=0)
    genotyper = new_genotyper(refset, opts, device, max_read_length)
    aligned_fragment_cnt = genotyper.coalesce_arrays(frag_rec, frag_counts)
    genotyper.finalize(pos_weight, refset.packed())
    log(f"Finish read fragment assignments. {aligned_fragment_cnt} read "
        f"fragments can be assigned.")
    prep = PreparedGenotype(
        genotyper=genotyper, refset=refset, opts=opts,
        aligned_flags=np.concatenate(flag_parts).tolist(),
        read_ids1=ids1, read_ids2=ids2, read_seqs1=seqs1, read_seqs2=seqs2,
        barcodes=None, aligned_fragment_cnt=aligned_fragment_cnt,
        assign_rows=None, has_mate=has_mate)
    return finish_genotyper(prep, output_prefix,
                            side_files=side_files).genotyper


def run_genotyper_distributed(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts: Optional[GenotypeOptions] = None,
    n_workers: int = 2,
):
    """Sharded equivalent of core.pipeline.run_genotyper (the standard
    paired/single genotyping flow; barcode and whitelist paths go
    through the single-process genotyper), its `n_workers` shards run one
    after another in this process.  Each shard builds its own engine
    (freed before the next); on the gpu route every shard scores on one
    DeferredDescService, the panel uploaded once and the shard's reads
    per shard.  Writes <prefix>_genotype.tsv, _allele.tsv and the
    aligned fastas, the JAX package's files; each shard's read
    assignment is recorded in this process's metrics as shard_<i>.
    Returns the Genotyper."""
    opts = opts or GenotypeOptions()
    _, device, service = resolve_routes(opts)
    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    packed = refset.packed()

    has_mate = reads2 is not None
    ids1, seqs1, ids2, seqs2, _ = load_reads(reads1, reads2)
    read_cnt = len(seqs1)
    log(f"Distributed genotyping over {n_workers} workers, "
        f"{read_cnt} fragments.")
    start_metrics()
    shards = []
    for w, (lo, hi) in enumerate(shard_bounds(read_cnt, n_workers)):
        with stage(f"shard_{w}") as ctx:
            shards.append(_worker_stage(
                packed, opts, seqs1[lo:hi], seqs2[lo:hi] if has_mate else [],
                has_mate, service))
            ra = metrics().stages["read_assignment"]
            ctx["fragment_count"] = hi - lo
            ctx["read_assignment_seconds"] = ra["seconds"]
            ctx["deferred_item_count"] = ra["deferred_item_count"]
            ctx["band_kernel_launches"] = ra["band_kernel_launches"]
    return _merge_and_finish(refset, opts, device,
                             (ids1, seqs1, ids2, seqs2), shards, has_mate,
                             output_prefix, side_files=False)


def wait_for_files(paths: List[str], timeout_s: float = 600.0,
                   poll_s: float = 0.2) -> None:
    deadline = time.monotonic() + timeout_s
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"distributed barrier timed out waiting for: {missing[:4]}")
        time.sleep(poll_s)


def worker_shard_to_file(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    opts,
    pid: int,
    nproc: int,
    out_path: str,
) -> None:
    """One process's stage: slice shard `pid` of `nproc` from the input
    fragments, assign, and publish the shard file atomically."""
    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    packed = refset.packed()
    has_mate = reads2 is not None
    _, seqs1, _, seqs2, _ = load_reads(reads1, reads2)
    lo, hi = shard_bounds(len(seqs1), nproc)[pid]
    log(f"Distributed worker {pid}/{nproc}: fragments [{lo}, {hi}).")
    rec, counts, flags, pw = _worker_stage(
        packed, opts, seqs1[lo:hi], seqs2[lo:hi] if has_mate else [],
        has_mate)
    tmp = f"{out_path}.tmp.{pid}"
    np.savez(tmp, rec=rec, counts=counts, flags=flags, pos_weight=pw)
    os.replace(tmp + ".npz", out_path)
    log(f"Distributed worker {pid}/{nproc}: shard published.")


def merge_shards_and_finish(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts,
    shard_paths: List[str],
):
    """Process 0's merge: the published shards, read in process order,
    through _merge_and_finish."""
    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    ids1, seqs1, ids2, seqs2, _ = load_reads(reads1, reads2)
    shards = []
    for p in shard_paths:
        with np.load(p) as z:
            shards.append((z["rec"], z["counts"], z["flags"],
                           z["pos_weight"]))
    device = (resolve_device(opts.device) if opts.em_backend == "gpu"
              else opts.device)
    return _merge_and_finish(refset, opts, device,
                             (ids1, seqs1, ids2, seqs2), shards,
                             reads2 is not None, output_prefix)
