"""Device k-mer classification against the allele database (K11).

Counterpart of ``t1k_tpu/ops/kmer.py`` (``DeviceKmerTable``, the XLA
programs ``_classify`` and ``_classify_direct``, ``classify_reads`` and
``prefilter_flags``), with the same results element for element:

  * the table holds the distinct valid k-mers of every reference sequence
    as 2-bit-packed keys: for k <= DIRECT_MAX_K a uint32 membership
    bitmap of max(4^k / 32, 1) words (exact counts), above it an
    open-addressing table of uint32 keys, 0xFFFFFFFF empty, sized to the
    power of two >= 4x the keys and filled in the JAX build's order (the
    iteration order of the same Python set), so every key lands in the
    same slot;
  * a hashed lookup probes h = key * 2654435761 & mask, step ((key >> 15)
    | 1) & mask | 1, at most MAX_PROBE times, and counts a chain that
    meets neither its key nor an empty slot as a hit: the counts are an
    upper bound, never a false negative (the all-T key at k = 16 equals
    the empty marker and is always a hit);
  * per read, the forward windows w < len - k + 1 with no base >= 4 that
    hit, and the same count for the reverse complement strand, whose
    windows are the reverse complements of the forward ones.

A read that the exact screen accepts has at least ceil(hitLenRequired /
k) index-matching windows (SeqSet.hpp:1959), so ``prefilter_flags``
never drops one.  The reference has no production caller of this
module; nothing in the port's stages calls it either.

``classify`` runs ``csrc/kmer_classify.cu`` on CUDA tensors and
``classify_plain``, the same arithmetic as tensor code, on CPU tensors;
it never falls back.  The table's uint32 words are held as int32 bit
patterns (torch's uint32 has few operations); the plain version computes
in int64 and masks with 0xFFFFFFFF.
"""

from __future__ import annotations

import array
import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

EMPTY_KEY = 0xFFFFFFFF      # hashed-table empty slot
DIRECT_MAX_K = 14           # 4^14 bits = a 32 MB bitmap
MAX_PROBE = 6               # the reference's probe cap
_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF

# Kernel launches, counted by the CUDA wrapper where it launches.
launch_counts = {"kmer_classify": 0}


def table_words(packed, k: int) -> Tuple[np.ndarray, bool]:
    """The JAX package's DeviceKmerTable.build on host numpy (ops/kmer.py
    :51-94 there): (uint32 words, direct).  The hashed table is filled in
    the iteration order of the same Python set, built by the same
    updates, so every key lands in the slot the JAX build gives it."""
    keys = set()
    pows = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    for s in range(packed.n):
        start = int(packed.seq_starts[s])
        ln = int(packed.seq_lens[s])
        codes = packed.seq_codes[start:start + ln].astype(np.int64)
        if ln < k:
            continue
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        valid = (win < 4).all(axis=1)
        vals = (np.where(win < 4, win, 3) * pows).sum(axis=1)
        keys.update(int(v) for v in vals[valid])
    if k <= DIRECT_MAX_K:
        bitmap = np.zeros(max(4 ** k // 32, 1), np.uint32)
        if keys:
            ka = np.fromiter(keys, np.int64, len(keys))
            np.bitwise_or.at(bitmap, ka >> 5,
                             np.uint32(1) << (ka & 31).astype(np.uint32))
        return bitmap, True
    size = 1
    while size < 4 * max(len(keys), 1):
        size *= 2
    # an array of C uint32 indexes faster than numpy one key at a time
    table = array.array("I", [EMPTY_KEY]) * size
    mask = size - 1
    for key in keys:
        h = (key * _HASH_MUL) & mask
        step = ((key >> 15) | 1) & mask | 1
        while table[h] != EMPTY_KEY:
            h = (h + step) & mask
        table[h] = key
    return np.frombuffer(table, np.uint32).copy(), False


@dataclass
class DeviceKmerTable:
    k: int
    table: torch.Tensor     # int32 bit patterns of the uint32 words:
    #                         direct: bitmap [max(4^k/32, 1)];
    #                         hashed: keys [size], 0xFFFFFFFF empty
    size: int               # words; a power of two when hashed
    direct: bool = False    # direct-addressed bitmap vs open addressing

    @classmethod
    def build(cls, packed, k: int, device="cuda") -> "DeviceKmerTable":
        """The distinct valid k-mers of every sequence of `packed` (an
        io.refset.PackedRef), on `device`."""
        if not 1 <= k <= 16:
            raise ValueError("k-mer keys are uint32: 1 <= k <= 16")
        dev = resolve_device(device)
        words, direct = table_words(packed, k)
        return cls(k=k, table=torch.from_numpy(words.view(np.int32)).to(dev),
                   size=len(words), direct=direct)


# ------------------------------------------------------------ plain version

def _rolling(codes: torch.Tensor, k: int):
    """codes int64 [R, L] -> (window keys int64 [R, L-k+1], valid)."""
    R, L = codes.shape
    W = L - k + 1
    acc = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
    invalid = torch.zeros((R, W), dtype=torch.bool, device=codes.device)
    for t in range(k):
        sl = codes[:, t:t + W]
        acc = (acc << 2) | torch.where(sl < 4, sl, 3)
        invalid |= sl >= 4
    return acc, ~invalid


def window_keys(codes: torch.Tensor, lens: torch.Tensor, k: int):
    """`_strand_counts`' windows: (fwd keys, fwd mask, rc keys, rc mask),
    int64 keys [R, W] and the windows that count before the lookup (in
    the read, no base >= 4).  The reverse strand is the reverse
    complement of the padded row, N kept as N, so its windows in the read
    sit at the end of the row."""
    R, L = codes.shape
    W = L - k + 1
    c = codes.long()
    lens = lens.long()[:, None]
    fwd, fwd_valid = _rolling(c, k)
    rc, rc_valid = _rolling(torch.where(c < 4, 3 - c, c).flip(1), k)
    win = torch.arange(W, device=codes.device)[None, :]
    return (fwd, fwd_valid & (win < lens - k + 1),
            rc, rc_valid & (win >= L - lens))


def hash_slots(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """Each int64 key's first probe slot, keys * 2654435761 & mask in
    uint32, with int64 products that do not overflow: the key's two 16-bit
    halves multiplied apart."""
    lo = (keys & 0xFFFF) * _HASH_MUL
    hi = (((keys >> 16) * _HASH_MUL) & 0xFFFF) << 16
    return ((lo + hi) & _U32) & mask


def _lookup(table: DeviceKmerTable, keys: torch.Tensor) -> torch.Tensor:
    """Hit mask of int64 keys: the bitmap's bit, or the hashed table's
    probe chain with an unresolved chain counted as a hit."""
    words = table.table.long() & _U32
    if table.direct:
        return ((words[keys >> 5] >> (keys & 31)) & 1) == 1
    mask = table.size - 1
    h = hash_slots(keys, mask)
    step = ((keys >> 15) | 1) & mask | 1
    found = torch.zeros_like(keys, dtype=torch.bool)
    empty = torch.zeros_like(keys, dtype=torch.bool)
    for _ in range(MAX_PROBE):
        entry = words[h]
        found = found | (entry == keys)
        empty = empty | (entry == EMPTY_KEY)
        h = torch.where(found | empty, h, (h + step) & mask)
    return found | ~(found | empty)


def classify_plain(table: DeviceKmerTable, codes: torch.Tensor,
                   lens: torch.Tensor):
    """Plain PyTorch version of the kernel (`classify`'s contract)."""
    fwd, fwd_ok, rc, rc_ok = window_keys(codes, lens, table.k)
    return ((_lookup(table, fwd) & fwd_ok).sum(dim=1, dtype=torch.int32),
            (_lookup(table, rc) & rc_ok).sum(dim=1, dtype=torch.int32))


# ----------------------------------------------------------------- kernel

@functools.lru_cache(maxsize=None)
def _kmer_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("kmer_classify")
    lib.t1k_kmer_classify.restype = ctypes.c_int
    lib.t1k_kmer_classify.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _check(name: str, x: torch.Tensor, dtype, dev) -> None:
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{dev}")


def classify_cuda(table: DeviceKmerTable, codes: torch.Tensor,
                  lens: torch.Tensor):
    """Launch csrc/kmer_classify.cu on the current stream (no
    synchronisation); same result as classify_plain."""
    dev = codes.device
    _check("codes", codes, torch.int8, dev)
    _check("lens", lens, torch.int32, dev)
    _check("table", table.table, torch.int32, dev)
    R, L = codes.shape
    if lens.shape != (R,) or L < table.k:
        raise ValueError(f"codes [R, L] with L >= k = {table.k} and lens "
                         "[R]")
    fwd = torch.empty(R, dtype=torch.int32, device=dev)
    rc = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return fwd, rc
    lib = _kmer_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.t1k_kmer_classify(
            codes.data_ptr(), lens.data_ptr(), R, L, table.k,
            int(table.direct), table.table.data_ptr(), table.size - 1,
            MAX_PROBE, fwd.data_ptr(), rc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kmer_classify kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["kmer_classify"] += 1
    return fwd, rc


def classify(table: DeviceKmerTable, codes: torch.Tensor,
             lens: torch.Tensor):
    """Per-read matching-window counts (fwd, rc), int32 [R], of codes int8
    [R, L] (bases 0-3, N 4) and lens int32 [R] on the table's device.  A
    batch narrower than k has no window: zeros."""
    R, L = codes.shape
    if L < table.k:
        zeros = torch.zeros(R, dtype=torch.int32, device=codes.device)
        return zeros, zeros.clone()
    if codes.device.type == "cuda":
        return classify_cuda(table, codes, lens)
    if codes.device.type == "cpu":
        return classify_plain(table, codes, lens)
    raise ValueError(f"no k-mer kernel for device {codes.device}")


def classify_reads(table: DeviceKmerTable, codes, lens):
    """`classify_reads` of the JAX package: per-read matching-window counts
    (fwd, rc) as int32 numpy arrays for a padded batch (numpy or tensors),
    computed on the table's device."""
    dev = table.table.device
    codes = torch.as_tensor(np.asarray(codes, np.int8)).to(dev).contiguous()
    lens = torch.as_tensor(np.asarray(lens, np.int32)).to(dev).contiguous()
    fwd, rc = classify(table, codes, lens)
    return fwd.cpu().numpy(), rc.cpu().numpy()


def prefilter_flags(table: DeviceKmerTable, codes, lens,
                    hit_len_required: int) -> np.ndarray:
    """Conservative candidate prefilter: keep a read iff fwd + rc >=
    max(1, ceil(hit_len_required / k)).  The exact screen accepts when
    lisSize * k >= hitLenRequired (SeqSet.hpp:1959-1978), and the LIS is
    no longer than the read's distinct index-matching windows, so no read
    it accepts is dropped; no constant floor above that is safe (its
    minHitRequired = 3 counts postings, not windows)."""
    fwd, rc = classify_reads(table, codes, lens)
    need = max(1, -(-hit_len_required // table.k))
    return (fwd + rc) >= need
