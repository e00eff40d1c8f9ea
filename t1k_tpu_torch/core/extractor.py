"""Candidate-read extraction on PyTorch / CUDA (the reference
`fastq-extractor` stage, FastqExtractor.cpp).

Screens raw reads with the k-mer index: a read pair is kept when either
mate has a chained hit with enough matching bases.  Behavior contract:
reference FastqExtractor.cpp (k=9 raised to log4(refLen)+1, hit-length
thresholds 27/23 raised to meanReadLen/5, low-complexity filter,
read/barcode range slicing, whitelist barcode correction).  Counterpart
of ``t1k_tpu/core/extractor.py``, with the device screen built from this
package's ``ops.phase_a.DeviceScreen`` on a torch device.

Backends: "native" screens every read on the host engine; "gpu" screens
on ``opts.device`` from the first batch (a CUDA card, or the CPU through
the kernels' plain versions); "auto" runs on ``opts.device`` as "gpu"
does once T1K_SCREEN_DEVICE_MIN_READS (default 2,000,000) reads have
streamed through, the host engine before, and raises at once when
``opts.device`` is a CUDA device and no card is present.  Every route
writes byte-identical outputs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..constants import (
    EXTRACTOR_HIT_LEN_PAIRED,
    EXTRACTOR_HIT_LEN_SINGLE,
    EXTRACTOR_KMER_LENGTH,
    encode_seq,
)
from ..device import resolve_backend, resolve_device
from ..io.reads import SeqRecord, read_seq_file, read_seq_files
from ..io.refset import RefSet
from ..native import NativeEngine
from ..ops.phase_a import DeviceScreen
from ..utils.observability import stage, traced_range
from .barcode import BarcodeCorrector, format_barcode


@dataclass
class ExtractorOptions:
    ref_seq_similarity: float = 0.8
    threads: int = 1
    barcode_file: Optional[str] = None
    barcode_start: int = 0
    barcode_end: int = -1
    barcode_revcomp: bool = False
    barcode_whitelist: Optional[str] = None
    read1_start: int = 0
    read1_end: int = -1
    read2_start: int = 0
    read2_end: int = -1
    backend: str = "auto"  # "auto", "native" or "gpu" (module docstring)
    device: str = "cuda"   # torch device of the gpu route


# Reads streamed before "auto" engages the device: the JAX package's
# default, re-measured on the H100 and kept (PERF.md).
DEVICE_MIN_READS = 2_000_000


def low_complexity_flags(codes: np.ndarray, seg: np.ndarray,
                         lens: np.ndarray) -> np.ndarray:
    """Vectorized FastqExtractor.cpp:89-111 over concatenated reads:
    dominated by one base, too many Ns, or at least two bases nearly
    absent.  `codes` are the concatenated base codes, `seg` the read
    index per base, `lens` the per-read lengths."""
    n = len(lens)
    cnt = np.bincount(seg * 5 + codes, minlength=n * 5).reshape(n, 5)
    return ((cnt[:, :4] >= (lens // 2)[:, None]).any(axis=1)
            | (cnt[:, 4] >= lens // 10)
            | ((cnt[:, :4] <= 2).sum(axis=1) >= 2))


def is_low_complexity(seq: str) -> bool:
    """Single-read wrapper over low_complexity_flags."""
    codes = encode_seq(seq)
    return bool(low_complexity_flags(
        codes, np.zeros(len(codes), np.int64),
        np.array([len(seq)], np.int64))[0])


def lazy_device_screen(backend: str, build, device="cuda"):
    """Size-gated lazy device-screen factory.  Returns get(n_new) ->
    DeviceScreen-or-None.  Backend "gpu" builds the screen at the first
    call.  Backend "auto" resolves at once (a CUDA `device` without a
    card raises NoCardError) and engages the device once
    T1K_SCREEN_DEVICE_MIN_READS (default DEVICE_MIN_READS) reads have
    streamed through, since its set-up only pays off on large inputs;
    the switch is safe mid-run because both routes are byte-identical.
    `build` runs at most once."""
    if backend == "auto":
        backend = resolve_backend("auto", device)
        dev_min = int(os.environ.get("T1K_SCREEN_DEVICE_MIN_READS",
                                     str(DEVICE_MIN_READS)))
    else:
        dev_min = 0
    state = {"screen": None, "checked": False, "reads": 0}

    def get(n_new: int):
        if (not state["checked"] and backend == "gpu"
                and state["reads"] >= dev_min):
            state["checked"] = True
            state["screen"] = build()
        state["reads"] += n_new
        return state["screen"]

    return get


def screen_flags(codes_cat: np.ndarray, lens: np.ndarray,
                 starts: np.ndarray, device_screen, engine):
    """Batched candidate screen: the vectorized low-complexity rule over
    the whole batch, the device screen for the reads it can decide, and
    the exact native re-screen for the rest (so output stays
    byte-identical).

    codes_cat: concatenated base codes; lens/starts: per-read layout.
    Returns (hits bool[n] - False for low-complexity reads, lc bool[n]).
    """
    n = len(lens)
    hits = np.zeros(n, bool)
    if n == 0:
        return hits, np.zeros(0, bool)
    seg = np.repeat(np.arange(n), lens)
    lc = low_complexity_flags(codes_cat, seg, lens)
    todo = np.flatnonzero(~lc)
    if len(todo) and device_screen is not None:
        max_len = int(lens[todo].max())
        padded = np.full((len(todo), max_len), 4, dtype=np.int8)
        plens = lens[todo].astype(np.int32)
        for j, i in enumerate(todo):
            padded[j, :lens[i]] = codes_cat[starts[i]:starts[i] + lens[i]]
        verdict, dec = device_screen.screen(padded, plens)
        hits[todo[dec]] = verdict[dec]
        todo = todo[~dec]
    if len(todo):
        codes = np.concatenate(
            [codes_cat[starts[i]:starts[i] + lens[i]] for i in todo])
        l2 = lens[todo].astype(np.int32)
        s2 = np.zeros(len(l2), dtype=np.int64)
        s2[1:] = np.cumsum(l2[:-1])
        hits[todo] = engine.screen_batch(codes, s2, l2).astype(bool)
    return hits, lc


def _slice(seq: Optional[str], start: int, end: int) -> Optional[str]:
    if seq is None or (start == 0 and end == -1):
        return seq
    e = len(seq) - 1 if end == -1 else end
    return seq[start:e + 1]


@traced_range("extract")
def run_extractor(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts: Optional[ExtractorOptions] = None,
    interleaved: bool = False,
) -> dict:
    """Returns counts: {"total": n, "candidates": m}."""
    opts = opts or ExtractorOptions()
    if opts.backend not in ("auto", "native", "gpu"):
        raise ValueError(f"unknown screen backend {opts.backend!r}")
    has_mate = reads2 is not None or interleaved

    # Device screen: the exact extraction screen (k-mer hits, diagonal
    # clustering, LIS chaining, the mismatch-budget test) on the torch
    # device; reads past its caps fall back to the native engine, so the
    # output is byte-identical by construction.  Set up first so that
    # "auto" without a card fails before any work; `_build` reads the
    # table parameters fixed below when the gate first opens.
    def _build():
        return DeviceScreen.build(packed, kmer_length, hit_len,
                                  opts.ref_seq_similarity,
                                  device=resolve_device(opts.device))

    get_screen = lazy_device_screen(opts.backend, _build, opts.device)

    # The extractor indexes every allele record without dedupe
    # (reference InputRefFa, SeqSet.hpp:872-904).
    refset = RefSet(digit_units=-1, delimiter="")
    for rec in read_seq_file(ref_fasta):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    packed = refset.packed()

    # Streaming ingest in bounded chunks (FastqExtractor.cpp:483-567).
    BATCH = int(os.environ.get("T1K_EXTRACT_BATCH", "65536"))

    if interleaved:
        it1 = read_seq_files(reads1, interleaved_id=1)
        it2 = read_seq_files(reads1, interleaved_id=2)
    else:
        it1 = read_seq_files(reads1)
        it2 = read_seq_files(reads2) if reads2 else None

    first1: List[SeqRecord] = []
    for rec in it1:
        first1.append(rec)
        if len(first1) >= BATCH:
            break

    # hit-length threshold from a 1000-read sample (FastqExtractor.cpp:390-407)
    hit_len = EXTRACTOR_HIT_LEN_PAIRED if has_mate else EXTRACTOR_HIT_LEN_SINGLE
    sample = first1[:1000]
    if not sample:
        raise ValueError("read file is empty")
    total_len = sum(len(r.seq) for r in sample)
    if total_len // (len(sample) * 5) > hit_len:
        hit_len = total_len // (len(sample) * 5)

    kmer_length = EXTRACTOR_KMER_LENGTH
    inferred = refset.infer_kmer_length()
    if inferred > kmer_length:
        kmer_length = inferred
        if kmer_length > hit_len:
            hit_len = kmer_length

    engine = NativeEngine(
        packed, kmer_length,
        ref_seq_similarity=opts.ref_seq_similarity,
        hit_len_required=hit_len,
        threads=opts.threads,
    )

    corrector = None
    bc_iter = None
    has_bc = bool(opts.barcode_file)
    if has_bc:
        bc_files = (opts.barcode_file
                    if isinstance(opts.barcode_file, (list, tuple))
                    else [opts.barcode_file])
        if opts.barcode_whitelist:
            corrector = BarcodeCorrector()
            corrector.set_whitelist(opts.barcode_whitelist)
            corrector.collect_background(
                (r.seq for r in read_seq_files(bc_files)),
                opts.barcode_start, opts.barcode_end, opts.barcode_revcomp)
        bc_iter = read_seq_files(bc_files)

    used = []  # the device screen, once it has engaged

    def screen(recs: List[SeqRecord]) -> np.ndarray:
        n = len(recs)
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        device_screen = get_screen(n)
        if device_screen is not None and not used:
            used.append(device_screen)
        codes_cat = encode_seq("".join(r.seq for r in recs))
        lens_all = np.array([len(r.seq) for r in recs], dtype=np.int64)
        starts_all = np.zeros(n, dtype=np.int64)
        np.cumsum(lens_all[:-1], out=starts_all[1:])
        hits, _ = screen_flags(codes_cat, lens_all, starts_all,
                               device_screen, engine)
        return hits.astype(np.uint8)

    if has_mate:
        f1 = open(f"{output_prefix}_1.fq", "w")
        f2 = open(f"{output_prefix}_2.fq", "w")
    else:
        f1 = open(f"{output_prefix}.fq", "w")
        f2 = None
    fbc = open(f"{output_prefix}_bc.fa", "w") if has_bc else None

    def write_rec(f, name: str, rec: SeqRecord, start: int, end: int):
        seq = _slice(rec.seq, start, end)
        qual = _slice(rec.qual, start, end)
        if qual is None:
            f.write(f">{name}\n{seq}\n")
        else:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")

    n_total = 0
    n_out = 0
    try:
        with stage("extraction_screen") as st:
            chunk1 = first1
            while chunk1:
                chunk2 = None
                if it2 is not None:
                    chunk2 = []
                    for rec2 in it2:
                        chunk2.append(rec2)
                        if len(chunk2) >= len(chunk1):
                            break
                bc_chunk = None
                if bc_iter is not None:
                    bc_chunk = []
                    for recb in bc_iter:
                        bc_chunk.append(recb)
                        if len(bc_chunk) >= len(chunk1):
                            break

                good = screen(chunk1)
                if chunk2 is not None:
                    # mate 2 only where mate 1 failed (either-mate rule)
                    failed = [i for i in range(len(chunk2)) if not good[i]]
                    if failed:
                        sub_flags = screen([chunk2[i] for i in failed])
                        for j, i in enumerate(failed):
                            if sub_flags[j]:
                                good[i] = 1

                for i, keep in enumerate(good):
                    if not keep:
                        continue
                    n_out += 1
                    write_rec(f1, chunk1[i].id, chunk1[i],
                              opts.read1_start, opts.read1_end)
                    if f2 is not None:
                        write_rec(f2, chunk1[i].id, chunk2[i],
                                  opts.read2_start, opts.read2_end)
                    if fbc is not None:
                        raw = bc_chunk[i].seq
                        if raw:
                            bc = format_barcode(raw, opts.barcode_start,
                                                opts.barcode_end,
                                                opts.barcode_revcomp)
                            if corrector is not None:
                                bc = corrector.correct(bc, bc_chunk[i].qual)
                            # only an uncorrectable barcode becomes
                            # missing_barcode; a raw barcode sliced to
                            # empty is an empty line (FastqExtractor.cpp:
                            # 157-199)
                            fbc.write(f">{chunk1[i].id}\n"
                                      f"{bc if bc is not None else 'missing_barcode'}\n")
                        else:
                            fbc.write(f">{chunk1[i].id}\nmissing_barcode\n")

                n_total += len(chunk1)
                chunk1 = []
                for rec in it1:
                    chunk1.append(rec)
                    if len(chunk1) >= BATCH:
                        break
            st["read_count"] = n_total
            st["candidate_count"] = n_out
            if used:
                st["device_screened_reads"] = used[0].screened
                st["device_decided_reads"] = used[0].decided
    finally:
        f1.close()
        if f2 is not None:
            f2.close()
        if fbc is not None:
            fbc.close()
    return {"total": n_total, "candidates": n_out}
