"""ctypes bindings for the port's native host engine (libt1k_native.so).

The engine implements the seed/chain/banded-DP/extend read-assignment hot
path, the extraction screen, the exact-f64 EM loop and the BAM scanner
(``BamScan``); the sources here (``engine.cc``, ``em.cc``,
``bamscan.cc``, ``variant.cc``) are the port's own copy of the reference
package's engine.  The library is built at
first import into ``build/t1k_tpu_torch/native/`` at the repository root
(gitignored) when it is missing, older than a source or built on another
machine, with the flags the reference's Makefile uses:
``-ffp-contract=off`` keeps every f64 operation rounded as written, and
libdeflate is linked only when its header is present.  Concurrent
importers build it once: the build holds a file lock, writes a private
name and renames it into place.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from ..utils.observability import no_rate, span, tracing

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, f)
            for f in ("engine.cc", "em.cc", "bamscan.cc", "variant.cc")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "t1k_tpu_torch", "native")
_SO = os.path.join(BUILD_DIR, "libt1k_native.so")
_KEY = _SO + ".machine"
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-funroll-loops",
            "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-Wno-unused-parameter"]

_c_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_c_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_c_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_c_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_c_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_c_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _machine_key() -> str:
    """What a library built with -march=native against this machine's
    libraries depends on: the host and its CPU's model and flags."""
    cpu = ""
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            cpu = "".join(line for line in f
                          if line.startswith(("model name", "flags")))
    return hashlib.sha256(
        "\0".join([*platform.uname(), cpu]).encode()).hexdigest()


def _fresh() -> bool:
    """A library newer than every source and built on this machine (a
    tree copied from another machine rebuilds)."""
    if not os.path.exists(_SO) or any(
            os.path.getmtime(_SO) < os.path.getmtime(s) for s in _SOURCES):
        return False
    try:
        with open(_KEY) as f:
            return f.read() == _machine_key()
    except OSError:
        return False


def _has_libdeflate(cxx: str) -> bool:
    """The Makefile's probe: does the preprocessor find <libdeflate.h>
    with the compile's own flags (so the probe and bamscan.cc's
    __has_include agree)?"""
    proc = subprocess.run([cxx, *CXXFLAGS, "-E", "-x", "c++", "-"],
                          input="#include <libdeflate.h>\n",
                          capture_output=True, text=True)
    return proc.returncode == 0


def _build_if_needed() -> None:
    if _fresh():
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():  # built by another process while this one waited
            return
        cxx = os.environ.get("CXX", "g++")
        libs = ["-lz"] + (["-ldeflate"] if _has_libdeflate(cxx) else [])
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp,
                               *_SOURCES, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"native engine build failed:\n{proc.stdout}"
                               f"\n{proc.stderr}")
        # a fresh inode: processes that loaded the old library keep it
        os.replace(tmp, _SO)
        with open(_KEY, "w") as f:
            f.write(_machine_key())


_build_if_needed()
_lib = ct.CDLL(_SO)

_lib.t1k_engine_create.restype = ct.c_void_p
_lib.t1k_engine_create.argtypes = [
    _c_i8p, _c_i64p, _c_i32p, _c_u8p,
    ct.c_int32, ct.c_int64, ct.c_int32, ct.c_double, ct.c_int32, ct.c_int32,
]
_lib.t1k_engine_destroy.argtypes = [ct.c_void_p]
_lib.t1k_engine_set_threads.argtypes = [ct.c_void_p, ct.c_int32]
_lib.t1k_engine_set_hit_len.argtypes = [ct.c_void_p, ct.c_int32]
_lib.t1k_engine_set_trace.argtypes = [ct.c_void_p, ct.c_int32]
_lib.t1k_engine_trace_name.restype = ct.c_char_p
_lib.t1k_engine_trace_name.argtypes = [ct.c_int32]
_lib.t1k_engine_trace_fetch.restype = ct.c_int32
_lib.t1k_engine_trace_fetch.argtypes = [ct.c_void_p, _c_i64p, ct.c_int32]
_lib.t1k_assign_batch.restype = ct.c_int64
_lib.t1k_assign_batch.argtypes = [
    ct.c_void_p, _c_i8p, _c_i64p, _c_i32p, _c_i32p, ct.c_int64,
]
_lib.t1k_get_results.restype = ct.POINTER(ct.c_double)
_lib.t1k_get_results.argtypes = [ct.c_void_p]
_lib.t1k_get_result_offsets.restype = ct.POINTER(ct.c_int64)
_lib.t1k_get_result_offsets.argtypes = [ct.c_void_p]
_lib.t1k_get_pos_weight.restype = ct.POINTER(ct.c_int32)
_lib.t1k_get_pos_weight.argtypes = [ct.c_void_p]
_lib.t1k_fragment_batch.restype = ct.c_int64
_lib.t1k_fragment_batch.argtypes = [
    ct.c_void_p, _c_i64p, _c_i64p, _c_u8p, ct.c_int64, ct.c_int32,
    ct.c_int32, ct.c_void_p,
]
_lib.t1k_screen_batch.argtypes = [
    ct.c_void_p, _c_i8p, _c_i64p, _c_i32p, ct.c_int64, _c_u8p,
]
_lib.t1k_overlap_buckets.restype = ct.c_int64
_lib.t1k_overlap_buckets.argtypes = [
    ct.c_void_p, _c_i8p, _c_i64p, _c_i32p, ct.c_int64, ct.c_int64,
    _c_i32p, _c_i8p, _c_i64p,
]
_c_u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_lib.t1k_set_candidates.restype = None
_lib.t1k_set_candidates.argtypes = [
    ct.c_void_p, ct.c_int64, _c_u8p, _c_u64p, ct.c_int32,
]
_lib.t1k_coalesce_batch.restype = ct.c_int64
_lib.t1k_coalesce_batch.argtypes = [ct.c_void_p]
_lib.t1k_coalesce_dims.argtypes = [
    ct.c_void_p, ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
]
_lib.t1k_coalesce_fetch.argtypes = [
    ct.c_void_p, _c_i64p, _c_i64p, _c_i64p, _c_i64p, _c_f32p, _c_f32p,
    _c_f32p,
]
_lib.t1k_align_global.restype = ct.c_int32
_lib.t1k_align_global.argtypes = [
    _c_i8p, ct.c_int32, _c_i8p, ct.c_int32, ct.c_int32, _c_i8p,
]
_lib.t1k_align_stats.restype = None
_lib.t1k_align_stats.argtypes = [
    _c_i8p, ct.c_int32, _c_i8p, ct.c_int32, ct.c_int32, _c_i32p,
]
_lib.t1k_align_stats_batch.restype = None
_lib.t1k_align_stats_batch.argtypes = [
    _c_i8p, _c_i32p, _c_i8p, _c_i32p, ct.c_int64, ct.c_int64, ct.c_int64,
    ct.c_int32, _c_i32p,
]
_lib.t1k_align_global_batch.restype = None
_lib.t1k_align_global_batch.argtypes = [
    _c_i8p, _c_i64p, _c_i32p, _c_i8p, _c_i64p, _c_i32p, _c_i64p,
    ct.c_int64, ct.c_int32, _c_i8p, _c_i32p,
]
_lib.t1k_variant_update.restype = None
_lib.t1k_variant_update.argtypes = [
    ct.c_int64, _c_i8p, _c_i64p, _c_i32p, _c_i32p, _c_i32p, _c_i32p,
    _c_i32p, _c_f64p, _c_u8p, _c_i8p, _c_i64p, ct.c_int32, _c_i64p,
    _c_f64p, _c_f64p, _c_f64p, _c_i64p, _c_f64p, _c_i64p,
]
_lib.t1k_engine_set_store_results.argtypes = [ct.c_void_p, ct.c_int32]
_lib.t1k_defer_reserve.argtypes = [ct.c_void_p, ct.c_int64]
_lib.t1k_defer_set_base.argtypes = [ct.c_void_p, ct.c_int64]
_lib.t1k_defer_end_chunked.argtypes = [ct.c_void_p]
_lib.t1k_defer2_begin.restype = ct.c_int64
_lib.t1k_defer2_begin.argtypes = [
    ct.c_void_p, ct.c_int32, _c_i8p, _c_i64p, _c_i32p, _c_i32p, ct.c_int64,
    ct.c_int64,
]
_lib.t1k_defer2_fetch_desc.argtypes = [
    ct.c_void_p, ct.c_int32, _c_i64p, _c_i32p, _c_i64p, _c_i32p,
]
_lib.t1k_defer2_dims.argtypes = [
    ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
    ct.POINTER(ct.c_int32),
]
_lib.t1k_defer2_fetch.argtypes = [
    ct.c_void_p, ct.c_int32, _c_i8p, _c_i32p, _c_i8p, _c_i32p, ct.c_int32,
    ct.c_int32,
]
_lib.t1k_defer2_finish.restype = ct.c_int64
_lib.t1k_defer2_finish.argtypes = [ct.c_void_p, ct.c_int32, _c_i32p]
_lib.t1k_em_quantify.restype = ct.c_int32
_lib.t1k_em_quantify.argtypes = [
    ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int64,
    _c_i64p, _c_i32p, _c_i64p, _c_i32p, _c_f64p,
    _c_i32p, _c_i32p, _c_i32p, _c_i32p, _c_i32p,
    ct.c_double, ct.c_double, ct.c_int32, _c_f64p, ct.c_void_p,
]


def align_global(t: np.ndarray, p: np.ndarray,
                 band: int = 5) -> Tuple[int, np.ndarray]:
    """Banded affine global alignment; returns (score, edit ops int8)."""
    t = np.ascontiguousarray(t, dtype=np.int8)
    p = np.ascontiguousarray(p, dtype=np.int8)
    # Capacity: the walk can exceed lent+lenp by up to two ops (the
    # boundary quirks each emit one op without advancing), plus the
    # terminator.
    out = np.empty(len(t) + len(p) + 4, dtype=np.int8)
    score = _lib.t1k_align_global(t, len(t), p, len(p), band, out)
    n = int(np.argmax(out == -1))
    return score, out[:n]


def align_stats_batch(tc: np.ndarray, tl: np.ndarray, pc: np.ndarray,
                      pl: np.ndarray, band: int = 5) -> np.ndarray:
    """Match counts for padded [n, tcap]/[n, pcap] row batches: the host
    oracle of the band kernel's counts, with the deferred-DP stats_fn
    signature (engine.cc t1k_align_stats_batch)."""
    tc = np.ascontiguousarray(tc, dtype=np.int8)
    pc = np.ascontiguousarray(pc, dtype=np.int8)
    n = len(tl)
    out = np.zeros(n, dtype=np.int32)
    _lib.t1k_align_stats_batch(
        tc, np.ascontiguousarray(tl, np.int32), pc,
        np.ascontiguousarray(pl, np.int32),
        tc.shape[1] if tc.ndim == 2 else len(tc),
        pc.shape[1] if pc.ndim == 2 else len(pc), n, band, out)
    return out


def align_stats(t: np.ndarray, p: np.ndarray,
                band: int = 5) -> Tuple[int, int, int]:
    """Count-only banded alignment; returns (match, mismatch, indel).

    The walk of `align_global` without the edit string: the engine's
    gap-fill and overhang scoring (and its <=31bp stack-state path)."""
    t = np.ascontiguousarray(t, dtype=np.int8)
    p = np.ascontiguousarray(p, dtype=np.int8)
    out = np.zeros(3, dtype=np.int32)
    _lib.t1k_align_stats(t, len(t), p, len(p), band, out)
    return int(out[0]), int(out[1]), int(out[2])


def align_global_batch(ts, ps, band: int = 5):
    """Banded global alignment of many (text, pattern) pairs in one
    native call; returns a list of edit-walk int8 arrays (views into one
    shared buffer)."""
    n = len(ts)
    if n == 0:
        return []
    tlen = np.array([len(t) for t in ts], dtype=np.int32)
    plen = np.array([len(p) for p in ps], dtype=np.int32)
    toff = np.zeros(n, dtype=np.int64)
    np.cumsum(tlen[:-1], dtype=np.int64, out=toff[1:])
    poff = np.zeros(n, dtype=np.int64)
    np.cumsum(plen[:-1], dtype=np.int64, out=poff[1:])
    tcat = np.ascontiguousarray(np.concatenate(ts), dtype=np.int8)
    pcat = np.ascontiguousarray(np.concatenate(ps), dtype=np.int8)
    # the walk's capacity, as in align_global
    cap = tlen.astype(np.int64) + plen + 3
    aoff = np.zeros(n, dtype=np.int64)
    np.cumsum(cap[:-1], out=aoff[1:])
    acat = np.empty(int(cap.sum()), dtype=np.int8)
    alens = np.zeros(n, dtype=np.int32)
    _lib.t1k_align_global_batch(tcat, toff, tlen, pcat, poff, plen,
                                aoff, n, band, acat, alens)
    return [acat[aoff[i]:aoff[i] + alens[i]] for i in range(n)]


def variant_update(align_cat, align_off, align_len, seq_idx, seq_start,
                   read_start, match_cnt, similarity, uniq_add, reads_cat,
                   read_off, filter_low_qual, seq_base, count, uniq,
                   unweighted, best_match, best_sim, best_match_max):
    """Exact per-base evidence accumulation over one update pass of the
    analyzer's variant caller (native/variant.cc); all state arrays are
    updated in place."""
    _lib.t1k_variant_update(
        len(align_len), align_cat, align_off, align_len, seq_idx,
        seq_start, read_start, match_cnt, similarity, uniq_add,
        reads_cat, read_off, int(filter_low_qual), seq_base, count, uniq,
        unweighted, best_match, best_sim, best_match_max)


# ------------------------------------------------------- native BAM scan
_lib.t1k_bam_open2.restype = ct.c_void_p
_lib.t1k_bam_open2.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_char_p,
                               ct.c_int32]
_lib.t1k_bam_close.argtypes = [ct.c_void_p]
_lib.t1k_bam_n_refs.restype = ct.c_int32
_lib.t1k_bam_n_refs.argtypes = [ct.c_void_p]
_lib.t1k_bam_ref_name.restype = ct.c_char_p
_lib.t1k_bam_ref_name.argtypes = [ct.c_void_p, ct.c_int32]
_lib.t1k_bam_ref_len.restype = ct.c_int32
_lib.t1k_bam_ref_len.argtypes = [ct.c_void_p, ct.c_int32]
_lib.t1k_bam_header_text.restype = ct.c_char_p
_lib.t1k_bam_header_text.argtypes = [ct.c_void_p]
_lib.t1k_bam_scan2.restype = ct.c_int64
_lib.t1k_bam_scan2.argtypes = [ct.c_void_p, ct.c_int64, ct.c_int32]
_lib.t1k_bam_fetch.restype = None
_lib.t1k_bam_fetch.argtypes = [ct.c_void_p, _c_i64p, ct.c_int64]
_lib.t1k_bam_fields.restype = ct.POINTER(ct.c_int32)
_lib.t1k_bam_fields.argtypes = [ct.c_void_p]
_lib.t1k_bam_name_hashes.restype = ct.POINTER(ct.c_uint64)
_lib.t1k_bam_name_hashes.argtypes = [ct.c_void_p]
_lib.t1k_bam_offsets.restype = ct.POINTER(ct.c_int64)
_lib.t1k_bam_offsets.argtypes = [ct.c_void_p, ct.c_int32]
_lib.t1k_bam_blob.restype = ct.c_void_p
_lib.t1k_bam_blob.argtypes = [ct.c_void_p, ct.c_int32,
                              ct.POINTER(ct.c_int64)]


class BamScan:
    """Streaming native BAM scanner; yields batches of flat arrays."""

    def __init__(self, path: str, bc_tag: str = "", umi_tag: str = "",
                 trim_len: int = -1):
        self._handle = _lib.t1k_bam_open2(
            path.encode(), bc_tag.encode(), umi_tag.encode(), trim_len)
        if not self._handle:
            raise IOError(f"cannot open BAM: {path}")
        n = _lib.t1k_bam_n_refs(self._handle)
        self.ref_names = [
            _lib.t1k_bam_ref_name(self._handle, i).decode() for i in range(n)]
        self.ref_lens = [
            _lib.t1k_bam_ref_len(self._handle, i) for i in range(n)]
        self.header_text = _lib.t1k_bam_header_text(self._handle).decode(
            "ascii", "replace")

    def close(self):
        if self._handle:
            _lib.t1k_bam_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def _text_views(self, n: int):
        offs = {}
        blobs = {}
        for i, key in enumerate(("name", "seq", "qual", "bc", "umi")):
            offs[key] = np.ctypeslib.as_array(
                _lib.t1k_bam_offsets(self._handle, i), shape=(n + 1,)).copy()
            ln = ct.c_int64()
            ptr = _lib.t1k_bam_blob(self._handle, i, ct.byref(ln))
            blobs[key] = (ct.string_at(ptr, ln.value)
                          if ln.value else b"")
        return offs, blobs

    def _fields(self, n: int) -> np.ndarray:
        return np.ctypeslib.as_array(
            _lib.t1k_bam_fields(self._handle), shape=(n, 9)).copy()

    def scan(self, max_records: int = 262144):
        """Eager scan: returns (fields [n,9] i32, name_hash [n] u64,
        offsets dict, blobs dict) or None at EOF."""
        n = int(_lib.t1k_bam_scan2(self._handle, max_records, 0))
        if n == 0:
            return None
        fields = self._fields(n)
        hashes = np.ctypeslib.as_array(
            _lib.t1k_bam_name_hashes(self._handle), shape=(n,)).copy()
        offs, blobs = self._text_views(n)
        return fields, hashes, offs, blobs

    def scan_lazy(self, max_records: int = 262144):
        """Lazy scan: returns (fields [n,9] i32: flag, tid, pos, mapq,
        mtid, mpos, tlen, l_seq, ref_span; name_hash [n] u64) or None;
        call fetch(idxs) for the text blobs of selected rows."""
        n = int(_lib.t1k_bam_scan2(self._handle, max_records, 1))
        if n == 0:
            return None
        fields = self._fields(n)
        hashes = np.ctypeslib.as_array(
            _lib.t1k_bam_name_hashes(self._handle), shape=(n,)).copy()
        return fields, hashes

    def scan_headers(self, max_records: int = 262144):
        """Headers-only scan (fields [n,9] i32, ref_span not populated
        beyond the cigar walk) or None; for sampling passes."""
        n = int(_lib.t1k_bam_scan2(self._handle, max_records, 2))
        if n == 0:
            return None
        return self._fields(n)

    def fetch(self, idxs: np.ndarray):
        """Decode text blobs for `idxs` (rows of the last scan_lazy
        batch); returns (offs dict, blobs dict) indexed 0..len(idxs)."""
        idxs = np.ascontiguousarray(idxs, np.int64)
        _lib.t1k_bam_fetch(self._handle, idxs, len(idxs))
        return self._text_views(len(idxs))


def _trace_fields() -> Tuple[str, ...]:
    """The engine's counter block, named by the engine (TraceField)."""
    names = []
    while (name := _lib.t1k_engine_trace_name(len(names))) is not None:
        names.append(name.decode())
    odd = [n for n in names if not n.endswith(("_count", "_ns"))]
    if odd:
        raise RuntimeError(f"trace fields of no known kind: {odd}")
    return tuple(names)


# the block's fields in its order: counts (TRACE_COUNTS) as they are,
# phase thread-nanoseconds as <phase>_seconds (TRACE_PHASES)
_TRACE_FIELDS = _trace_fields()
TRACE_COUNTS = tuple(n for n in _TRACE_FIELDS if n.endswith("_count"))
TRACE_PHASES = tuple(n[:-3] + "_seconds" for n in _TRACE_FIELDS
                     if n.endswith("_ns"))
no_rate(*TRACE_COUNTS, "chunk_count")


class NativeEngine:
    """Read-assignment engine bound to one packed reference."""

    def __init__(
        self,
        packed,                      # io.refset.PackedRef
        kmer_length: int,
        ref_seq_similarity: float = 0.8,
        hit_len_required: int = 31,
        relax_intron_align: bool = False,
        threads: int = 1,
    ):
        self._packed = packed
        total = int(packed.seq_codes.shape[0])
        self._handle = _lib.t1k_engine_create(
            np.ascontiguousarray(packed.seq_codes, dtype=np.int8),
            np.ascontiguousarray(packed.seq_starts, dtype=np.int64),
            np.ascontiguousarray(packed.seq_lens, dtype=np.int32),
            np.ascontiguousarray(packed.exon_mask, dtype=np.uint8),
            packed.n, total, kmer_length,
            ref_seq_similarity, hit_len_required, int(relax_intron_align),
        )
        self.kmer_length = kmer_length
        self.hit_len_required = hit_len_required
        if threads > 1:
            _lib.t1k_engine_set_threads(self._handle, threads)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            _lib.t1k_engine_destroy(handle)
            self._handle = None

    def set_hit_len_required(self, h: int) -> None:
        self.hit_len_required = h
        _lib.t1k_engine_set_hit_len(self._handle, h)

    def set_threads(self, n: int) -> None:
        _lib.t1k_engine_set_threads(self._handle, n)

    def _trace_pass(self) -> None:
        """The next pass counts and times its phases only while the
        enclosing stage traces (utils/observability.py)."""
        _lib.t1k_engine_set_trace(self._handle, int(tracing()))

    def trace_counters(self) -> dict:
        """The last assignment pass's counters (TRACE_COUNTS) and phase
        thread-seconds (TRACE_PHASES); zeros where the pass did not
        trace."""
        out = np.zeros(len(_TRACE_FIELDS), np.int64)
        _lib.t1k_engine_trace_fetch(self._handle, out, len(out))
        counts = {}
        for name, v in zip(_TRACE_FIELDS, out):
            if name.endswith("_ns"):
                counts[name[:-3] + "_seconds"] = float(v) / 1e9
            else:
                counts[name] = int(v)
        return counts

    def assign_batch(
        self,
        read_codes: np.ndarray,
        read_starts: np.ndarray,
        read_lens: np.ndarray,
        weights: np.ndarray,
        store_results: bool = True,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Assign unique reads; returns (records [N,11] f64, offsets [R+1]).

        With store_results=False the per-read record staging is skipped
        (the assignments stay inside the engine for fragment_batch and
        pos_weight) and (None, None) is returned."""
        n = len(read_lens)
        _lib.t1k_engine_set_store_results(self._handle, int(store_results))
        self._trace_pass()
        total = _lib.t1k_assign_batch(
            self._handle,
            np.ascontiguousarray(read_codes, dtype=np.int8),
            np.ascontiguousarray(read_starts, dtype=np.int64),
            np.ascontiguousarray(read_lens, dtype=np.int32),
            np.ascontiguousarray(weights, dtype=np.int32),
            n,
        )
        self.last_assign_count = int(total)
        if not store_results:
            return None, None
        return self._results(total, n)

    def _results(self, total: int, n: int):
        rec = np.ctypeslib.as_array(
            _lib.t1k_get_results(self._handle), shape=(int(total), 11)
        ).copy() if total else np.zeros((0, 11))
        off = np.ctypeslib.as_array(
            _lib.t1k_get_result_offsets(self._handle), shape=(n + 1,)
        ).copy()
        return rec, off

    def assign_batch_deferred(
        self,
        read_codes: np.ndarray,
        read_starts: np.ndarray,
        read_lens: np.ndarray,
        weights: np.ndarray,
        stats_fn=None,
        store_results: bool = True,
        chunk_size: int = 0,
        desc_service=None,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """assign_batch with the gap-fill / extension DP batched out to
        an external scorer.  Output is byte-identical to assign_batch.

        One device round trip per chunk: the begin pass emits gap-fill
        and speculative extension items together, the finish pass replays
        the exact state machine on the returned counts.  Chunks are
        pipelined over the engine's two state slots: while the device
        scores chunk i, the host runs chunk i+1's seed/chain.

        Two scoring transports:
        * `stats_fn(t_codes [N,Lt] i8, t_lens, p_codes [N,Lp] i8, p_lens)
          -> match [N] i32`: window bytes cross to the scorer;
        * `desc_service`: descriptor mode.  The reference and the batch's
          reads live on the device; only (t_off, t_len, p_off, p_len)
          cross per item.  The service provides `set_ref`, `set_layout`,
          `begin_batch(read_codes)` (returns the rc-half base) and
          `stats(...)` or `stats_async(...) -> callable`.

        chunk_size > 0 processes reads in bounded chunks while
        accumulating assignments engine-side; requires
        store_results=False.

        Inside a tracing stage the spans `prepare` (the service's
        reference, layout and read upload), `begin`, `dispatch` (the
        descriptor fetch and the scorer's launch), `wait` (the host
        blocked on the counts) and `finish` (the finish passes and the
        result copy) bracket the work, and the engine counts and times
        its passes (trace_counters).  `last_chunk_count` is the number of
        begin passes.
        """
        with span("prepare"):
            read_codes = np.ascontiguousarray(read_codes, dtype=np.int8)
            read_starts = np.ascontiguousarray(read_starts, dtype=np.int64)
            read_lens = np.ascontiguousarray(read_lens, dtype=np.int32)
            weights = np.ascontiguousarray(weights, dtype=np.int32)
            n = len(read_lens)
            total_len = int(read_codes.shape[0])
            if desc_service is not None:
                desc_service.set_ref(np.ascontiguousarray(
                    self._packed.seq_codes, dtype=np.int8))
                desc_service.set_layout(read_starts, read_lens)
                # the service pads the device tensor; its padded length
                # is the rc-half base the engine must emit in descriptors
                total_len = int(desc_service.begin_batch(read_codes))

        def dispatch(slot):
            """Fetch the slot's items and launch scoring; returns a
            materializer for the match counts (device work proceeds
            asynchronously until it is called)."""
            ni = ct.c_int64()
            mt = ct.c_int32()
            mp = ct.c_int32()
            _lib.t1k_defer2_dims(self._handle, slot, ct.byref(ni),
                                 ct.byref(mt), ct.byref(mp))
            ni = int(ni.value)
            if ni == 0:
                zero = np.zeros(0, np.int32)
                return lambda: zero
            if desc_service is not None:
                t_off = np.zeros(ni, np.int64)
                t_len = np.zeros(ni, np.int32)
                p_off = np.zeros(ni, np.int64)
                p_len = np.zeros(ni, np.int32)
                _lib.t1k_defer2_fetch_desc(self._handle, slot, t_off, t_len,
                                           p_off, p_len)
                if hasattr(desc_service, "stats_async"):
                    fut = desc_service.stats_async(t_off, t_len, p_off, p_len)
                else:
                    res = desc_service.stats(t_off, t_len, p_off, p_len)
                    fut = lambda: res  # noqa: E731
                return lambda: np.ascontiguousarray(fut(), dtype=np.int32)
            tcap, pcap = max(int(mt.value), 1), max(int(mp.value), 1)
            tc = np.zeros((ni, tcap), np.int8)
            pc = np.zeros((ni, pcap), np.int8)
            tl = np.zeros(ni, np.int32)
            pl = np.zeros(ni, np.int32)
            _lib.t1k_defer2_fetch(self._handle, slot, tc, tl, pc, pl, tcap,
                                  pcap)
            return lambda: np.ascontiguousarray(stats_fn(tc, tl, pc, pl),
                                                dtype=np.int32)

        _lib.t1k_engine_set_store_results(self._handle, int(store_results))
        chunk = chunk_size if (chunk_size and chunk_size < n) else max(n, 1)
        if chunk < n and store_results:
            raise ValueError("chunked deferral keeps results engine-side: "
                             "pass store_results=False")
        self._trace_pass()
        _lib.t1k_defer_reserve(self._handle, n)
        bounds = ([(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
                  if n else [(0, 0)])
        pending = []  # (slot, lo, materializer)
        total = 0
        slot = 0

        def finish(s0, lo0, fut0):
            with span("wait"):
                match = fut0()
            with span("finish"):
                _lib.t1k_defer_set_base(self._handle, lo0)
                return int(_lib.t1k_defer2_finish(self._handle, s0, match))

        for lo, hi in bounds:
            # the begin pass finds a read's candidate buckets (set_candidates)
            # at base + i; the finish of the chunk before resets the base
            with span("begin"):
                _lib.t1k_defer_set_base(self._handle, lo)
                _lib.t1k_defer2_begin(self._handle, slot, read_codes,
                                      read_starts[lo:hi], read_lens[lo:hi],
                                      weights[lo:hi], hi - lo, total_len)
            with span("dispatch"):
                pending.append((slot, lo, dispatch(slot)))
            slot ^= 1
            if len(pending) == 2:
                total += finish(*pending.pop(0))
        for pend in pending:
            total += finish(*pend)
        with span("finish"):
            _lib.t1k_defer_end_chunked(self._handle)
            self.last_assign_count = int(total)
            self.last_chunk_count = len(bounds)
            if not store_results:
                return None, None
            return self._results(total, n)

    def _fragments(self, uid1, uid2, has_n, paired, max_assign_cnt,
                   whitelist) -> int:
        wl = None
        if whitelist is not None:
            wl = np.ascontiguousarray(whitelist, dtype=np.uint8)
        return _lib.t1k_fragment_batch(
            self._handle,
            np.ascontiguousarray(uid1, dtype=np.int64),
            np.ascontiguousarray(uid2, dtype=np.int64),
            np.ascontiguousarray(has_n, dtype=np.uint8),
            len(uid1), int(paired), max_assign_cnt,
            wl.ctypes.data if wl is not None else None,
        )

    def _fragment_flags(self, n: int):
        packed = np.ctypeslib.as_array(
            _lib.t1k_get_result_offsets(self._handle), shape=(n + 1,)
        )[1:].copy()
        return packed >> 1, (packed & 1).astype(bool)

    def fragment_batch(self, uid1: np.ndarray, uid2: np.ndarray,
                       has_n: np.ndarray, paired: bool,
                       max_assign_cnt: int = 2000, whitelist=None):
        """Fragment assignment over the last assign pass's results.

        Returns (records [N,6] f64: allele/start/end/weight/adjust/qual,
        counts [F] per-fragment record counts, flags [F] fragment-assigned
        booleans)."""
        total = self._fragments(uid1, uid2, has_n, paired, max_assign_cnt,
                                whitelist)
        rec = np.ctypeslib.as_array(
            _lib.t1k_get_results(self._handle), shape=(int(total), 6)
        ).copy() if total else np.zeros((0, 6))
        counts, flags = self._fragment_flags(len(uid1))
        return rec, counts, flags

    def fragment_batch_coalesced(self, uid1: np.ndarray, uid2: np.ndarray,
                                 has_n: np.ndarray, paired: bool,
                                 max_assign_cnt: int = 2000, whitelist=None):
        """fragment_batch plus engine-side read-group coalescing: the
        per-record staging never crosses into Python.  Returns (coalesced
        dict of flat group-CSR arrays, assigned_fragment_cnt, counts [F],
        flags [F])."""
        self._fragments(uid1, uid2, has_n, paired, max_assign_cnt, whitelist)
        assigned = int(_lib.t1k_coalesce_batch(self._handle))
        counts, flags = self._fragment_flags(len(uid1))
        g = ct.c_int64()
        r = ct.c_int64()
        _lib.t1k_coalesce_dims(self._handle, ct.byref(g), ct.byref(r))
        groups, rows = int(g.value), int(r.value)
        out = {
            "goff": np.zeros(groups + 1, np.int64),
            "allele": np.zeros(rows, np.int64),
            "start": np.zeros(rows, np.int64),
            "end": np.zeros(rows, np.int64),
            "weight": np.zeros(rows, np.float32),
            "qual": np.zeros(rows, np.float32),
            "adjust": np.zeros(rows, np.float32),
        }
        _lib.t1k_coalesce_fetch(
            self._handle, out["goff"], out["allele"], out["start"],
            out["end"], out["weight"], out["qual"], out["adjust"])
        return out, assigned, counts, flags

    def pos_weight(self) -> np.ndarray:
        """Per-base coverage counts, shape [total_len, 4] (a copy)."""
        total = int(self._packed.seq_codes.shape[0])
        if total == 0:  # empty reference (e.g. empty allele whitelist)
            return np.zeros((0, 4), dtype=np.int32)
        return np.ctypeslib.as_array(
            _lib.t1k_get_pos_weight(self._handle), shape=(total, 4)
        ).copy()

    def set_candidates(self, n_reads: int, cand_reads, cand_seqs,
                       cand_strands, undecided) -> None:
        """Install device-generated candidate buckets
        (ops/phase_a.py DeviceCandidates.generate's output) for the next
        assign/defer cycle: hit collection keeps only the listed (strand,
        seq) buckets of a read; reads flagged `undecided` run unpruned.
        n_reads = 0 clears.

        Each read's bucket bits are uint64 words, bit (strand == +1 ?
        n_seqs : 0) + seq.  The words are built as sums of the distinct
        powers of two in each word, which equal their OR: the global bit
        indices are sorted and deduplicated (generate's order already is),
        then summed per word with one reduceat."""
        if n_reads == 0:
            _lib.t1k_set_candidates(self._handle, 0, np.zeros(0, np.uint8),
                                    np.zeros(0, np.uint64), 0)
            return
        n_seqs = int(self._packed.n)
        words = max(1, (2 * n_seqs + 63) // 64)
        bits = np.zeros(n_reads * words, np.uint64)
        has = (~np.asarray(undecided, bool)).astype(np.uint8)
        flat = (np.asarray(cand_reads, np.int64) * (64 * words)
                + np.where(np.asarray(cand_strands) == 1, n_seqs, 0)
                + np.asarray(cand_seqs, np.int64))
        if len(flat) and not (flat[1:] > flat[:-1]).all():
            flat = np.unique(flat)
        if len(flat):
            word = flat >> 6
            start = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
            power = np.left_shift(np.uint64(1), (flat & 63).astype(np.uint64))
            bits[word[start]] = np.add.reduceat(power, start)
        _lib.t1k_set_candidates(self._handle, n_reads,
                                np.ascontiguousarray(has), bits, words)

    def overlap_buckets(self, read_codes: np.ndarray,
                        read_starts: np.ndarray, read_lens: np.ndarray):
        """Per read, the distinct (seq, strand) buckets whose chains emit
        at least one overlap in the assignment path's pre-DP stage: the
        parity oracle of DeviceCandidates.  Returns CSR (offsets [n+1]
        int64, seqs int32, strands int8)."""
        n = len(read_lens)
        codes = np.ascontiguousarray(read_codes, dtype=np.int8)
        starts = np.ascontiguousarray(read_starts, dtype=np.int64)
        lens = np.ascontiguousarray(read_lens, dtype=np.int32)
        off = np.zeros(n + 1, dtype=np.int64)
        cap = max(1024, 64 * n)
        while True:
            seqs = np.zeros(cap, dtype=np.int32)
            strands = np.zeros(cap, dtype=np.int8)
            total = _lib.t1k_overlap_buckets(
                self._handle, codes, starts, lens, n, cap, seqs, strands,
                off)
            if total <= cap:
                return off, seqs[:total], strands[:total]
            cap = int(total)

    def screen_batch(self, read_codes: np.ndarray, read_starts: np.ndarray,
                     read_lens: np.ndarray) -> np.ndarray:
        """The extraction screen (HasHitInSet) per read, uint8 [n]."""
        n = len(read_lens)
        flags = np.zeros(n, dtype=np.uint8)
        _lib.t1k_screen_batch(
            self._handle,
            np.ascontiguousarray(read_codes, dtype=np.int8),
            np.ascontiguousarray(read_starts, dtype=np.int64),
            np.ascontiguousarray(read_lens, dtype=np.int32),
            n, flags,
        )
        return flags


def em_quantify(
    ec_to_alleles: List[List[int]],
    rg_ecs_csr: Tuple[np.ndarray, np.ndarray],  # (offsets int64, ecs int32)
    rg_counts: np.ndarray,
    allele_eff_len: np.ndarray,
    allele_missing: np.ndarray,
    allele_weight: np.ndarray,
    allele_gene: np.ndarray,
    allele_major: np.ndarray,
    n_genes: int,
    n_majors: int,
    filter_frac: float = 0.15,
    min_squarem_alpha: float = 0.0,
    max_iterations: int = 1000,
) -> Tuple[int, np.ndarray]:
    """Run the exact f64 SQUAREM EM from the allele-weight start the
    reference uses (Genotyper.hpp:1214-1232); returns (iterations,
    ec_read_count f64)."""
    ec_cnt = len(ec_to_alleles)
    ec_off = np.zeros(ec_cnt + 1, dtype=np.int64)
    for i, lst in enumerate(ec_to_alleles):
        ec_off[i + 1] = ec_off[i] + len(lst)
    ec_all = np.array(
        [a for lst in ec_to_alleles for a in lst], dtype=np.int32
    ) if ec_cnt else np.zeros(0, np.int32)
    rg_off, rg_ecs = rg_ecs_csr
    out = np.zeros(ec_cnt, dtype=np.float64)
    iters = _lib.t1k_em_quantify(
        ec_cnt, len(allele_eff_len), n_genes, n_majors, len(rg_counts),
        np.ascontiguousarray(ec_off), np.ascontiguousarray(ec_all),
        np.ascontiguousarray(rg_off, dtype=np.int64),
        np.ascontiguousarray(rg_ecs, dtype=np.int32),
        np.ascontiguousarray(rg_counts, dtype=np.float64),
        np.ascontiguousarray(allele_eff_len, dtype=np.int32),
        np.ascontiguousarray(allele_missing, dtype=np.int32),
        np.ascontiguousarray(allele_weight, dtype=np.int32),
        np.ascontiguousarray(allele_gene, dtype=np.int32),
        np.ascontiguousarray(allele_major, dtype=np.int32),
        filter_frac, min_squarem_alpha, max_iterations, out, None,
    )
    return iters, out
