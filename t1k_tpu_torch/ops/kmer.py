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

For k <= DIRECT_MAX_K the table also holds ``pair``, two bits an entry
that answer both strands of a window with one lookup: a key's membership
and its reverse complement's (revcomp(fk) in S iff fk in revcomp(S)).
For k <= PAIR_MAX_K the entry is the forward key fk itself (4^k / 16
words; at even k a palindromic key, fk = rk, has both bits equal).  At k
= 14, where that table (64 MB) would pass the card's L2, the layout is
centre-canonical (``centre_words``, 40 MB): the middle base pair picks
one of each key's two orientations, and the entry of that canonical key
holds its bits.  The kernel and the plain version look windows up there;
``table`` stays the JAX build's words.

A read that the exact screen accepts has at least ceil(hitLenRequired /
k) index-matching windows (SeqSet.hpp:1959), so ``prefilter_flags``
never drops one.  The reference has no production caller of this
module; nothing in the port's stages calls it either.

``classify`` runs ``csrc/kmer_classify.cu`` on CUDA tensors and
``classify_plain``, the same arithmetic as tensor code, on CPU tensors;
it never falls back.  ``classify_v1_cuda`` launches the kernel's first
design (a warp a read, two lookups a window), reached only by name for
A/B timing.  The table's uint32 words are held as int32 bit
patterns (torch's uint32 has few operations); the plain version computes
in int64 and masks with 0xFFFFFFFF.
"""

from __future__ import annotations

import array
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

EMPTY_KEY = 0xFFFFFFFF      # hashed-table empty slot
DIRECT_MAX_K = 14           # 4^14 bits = a 32 MB bitmap
PAIR_MAX_K = 13             # 4^13 x 2 bits = a 16 MB pair table
CENTRE_K = 14               # 10 x 4^12 x 2 bits = a 40 MB centre table
MAX_PROBE = 6               # the reference's probe cap
_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF

# Kernel launches, counted by the CUDA wrapper where it launches.
launch_counts = {"kmer_classify": 0, "kmer_classify_v1": 0}
# the kernel's table layouts (csrc/kmer_classify.cu's Mode)
MODE_PAIR, MODE_CENTRE, MODE_HASHED = 0, 1, 2


def _valid_keys(packed, k: int):
    """Each sequence's valid window keys (int64, first base highest)."""
    pows = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    for s in range(packed.n):
        start = int(packed.seq_starts[s])
        ln = int(packed.seq_lens[s])
        codes = packed.seq_codes[start:start + ln].astype(np.int64)
        if ln < k:
            continue
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        valid = (win < 4).all(axis=1)
        yield (np.where(win < 4, win, 3) * pows).sum(axis=1)[valid]


def kmer_keys(packed, k: int) -> set:
    """The distinct valid k-mers of every sequence of `packed` as 2-bit
    keys in a Python set built by the JAX build's updates (its iteration
    order fixes the hashed table's slots)."""
    keys = set()
    for vals in _valid_keys(packed, k):
        keys.update(int(v) for v in vals)
    return keys


def key_array(packed, k: int) -> np.ndarray:
    """The same keys as a sorted int64 array (the direct layouts)."""
    return np.unique(np.concatenate([np.zeros(0, np.int64),
                                     *_valid_keys(packed, k)]))


def table_words(packed, k: int, keys=None) -> Tuple[np.ndarray, bool]:
    """The JAX package's DeviceKmerTable.build on host numpy (ops/kmer.py
    :51-94 there): (uint32 words, direct).  The hashed table is filled in
    the iteration order of the same Python set, built by the same
    updates, so every key lands in the slot the JAX build gives it.
    `keys`: key_array's (direct) or kmer_keys' (hashed), if built."""
    if k <= DIRECT_MAX_K:
        ka = key_array(packed, k) if keys is None else keys
        return _bit_words(max(4 ** k // 32, 1), ka), True
    if keys is None:
        keys = kmer_keys(packed, k)
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


def revcomp_keys(keys, k: int):
    """Reverse complements of int64 keys (a numpy array or a tensor), as
    the kernel rolls them: base t's complement at bits 2t."""
    out, x = keys * 0, keys
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x = x >> 2
    return out


def _bit_words(n: int, *index_bits) -> np.ndarray:
    """uint32 [n] with bit i & 31 of word i >> 5 set for each distinct bit
    index i of the int64 arrays (each set once, so a word's bits add
    without carries, exact in float64 weights)."""
    words = np.zeros(n, np.float64)
    for i in index_bits:
        words += np.bincount(i >> 5, (np.int64(1) << (i & 31))
                             .astype(np.float64), n)
    return words.astype(np.uint32)


def pair_words(keys: np.ndarray, k: int) -> np.ndarray:
    """The pair table (uint32 [max(4^k / 16, 1)]) of distinct keys: for
    each key s, bit 2(s & 15) of word s >> 4, and bit 2(rc & 15) + 1 of
    word rc >> 4 for its reverse complement rc."""
    return _bit_words(max(4 ** k // 16, 1), 2 * keys,
                      2 * revcomp_keys(keys, k) + 1)


def centre_classes() -> Tuple[np.ndarray, np.ndarray]:
    """(class, flip) of each middle pair m = 4 * first + second of a
    CENTRE_K key: its reverse complement's pair is 4 * (3 - second) + (3 -
    first); a class is the orbit of the two (10 of them: six pairs of
    pairs and four pairs that are their own reverse complement), numbered
    in order of its smaller pair; the larger pair of a two-pair class is
    flipped: its reverse complement is the canonical key."""
    partner = [4 * (3 - (m & 3)) + (3 - (m >> 2)) for m in range(16)]
    reps = sorted({min(m, partner[m]) for m in range(16)})
    return (np.array([reps.index(min(m, p)) for m, p in enumerate(partner)],
                     np.int64),
            np.array([int(m > p) for m, p in enumerate(partner)], np.int64))


def centre_index(keys, cls):
    """Each canonical CENTRE_K key's entry: its class << 24 | its 12 other
    bases (the six above the middle pair, then the six below)."""
    return ((cls[(keys >> 12) & 15] << 24) | ((keys >> 16) << 12)
            | (keys & 0xFFF))


def centre_words(keys: np.ndarray) -> np.ndarray:
    """The centre-canonical table (uint32 [10 x 4^12 / 16]) of distinct
    CENTRE_K keys: entry i = centre_index(x) of a canonical key x holds
    bit 2(i & 15) of word i >> 4 when x is a key and the bit above it
    when revcomp(x) is."""
    cls, flip = centre_classes()
    rc = revcomp_keys(keys, CENTRE_K)
    fwd = keys[flip[(keys >> 12) & 15] == 0]
    rev = rc[flip[(rc >> 12) & 15] == 0]
    return _bit_words(10 * 4 ** (CENTRE_K - 2) // 16,
                      2 * centre_index(fwd, cls),
                      2 * centre_index(rev, cls) + 1)


@dataclass
class DeviceKmerTable:
    k: int
    table: torch.Tensor     # int32 bit patterns of the uint32 words:
    #                         direct: bitmap [max(4^k/32, 1)];
    #                         hashed: keys [size], 0xFFFFFFFF empty
    size: int               # words; a power of two when hashed
    direct: bool = False    # direct-addressed bitmap vs open addressing
    pair: Optional[torch.Tensor] = None  # k <= DIRECT_MAX_K: int32 bit
    #                         patterns of pair_words (k <= PAIR_MAX_K) or
    #                         centre_words (k = CENTRE_K)

    @classmethod
    def build(cls, packed, k: int, device="cuda") -> "DeviceKmerTable":
        """The distinct valid k-mers of every sequence of `packed` (an
        io.refset.PackedRef), on `device`."""
        if not 1 <= k <= 16:
            raise ValueError("k-mer keys are uint32: 1 <= k <= 16")
        dev = resolve_device(device)
        keys = key_array(packed, k) if k <= DIRECT_MAX_K else None
        words, direct = table_words(packed, k, keys)
        put = lambda w: torch.from_numpy(w.view(np.int32)).to(dev)
        pair = (pair_words(keys, k) if k <= PAIR_MAX_K else
                centre_words(keys) if k == CENTRE_K else None)
        return cls(k=k, table=put(words), size=len(words), direct=direct,
                   pair=None if pair is None else put(pair))

    @property
    def mode(self) -> int:
        """The kernel's table layout: pair, centre-canonical or hashed."""
        if self.pair is None:
            return MODE_HASHED
        return MODE_PAIR if self.k <= PAIR_MAX_K else MODE_CENTRE


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


def _lookup(table: DeviceKmerTable, keys: torch.Tensor):
    """(hit mask, table words read) of int64 keys: the bitmap's bit, one
    word a key, or the hashed table's probe chain, a word a probe until
    the key, an empty slot or MAX_PROBE, with an unresolved chain counted
    as a hit."""
    words = table.table.long() & _U32
    if table.direct:
        return ((words[keys >> 5] >> (keys & 31)) & 1) == 1, keys.numel()
    mask = table.size - 1
    h = hash_slots(keys, mask)
    step = ((keys >> 15) | 1) & mask | 1
    found = torch.zeros_like(keys, dtype=torch.bool)
    empty = torch.zeros_like(keys, dtype=torch.bool)
    loads = 0
    for _ in range(MAX_PROBE):
        loads = loads + (~(found | empty)).sum()
        entry = words[h]
        found = found | (entry == keys)
        empty = empty | (entry == EMPTY_KEY)
        h = torch.where(found | empty, h, (h + step) & mask)
    return found | ~(found | empty), loads


def pair_lookup(table: DeviceKmerTable, fk: torch.Tensor) -> torch.Tensor:
    """Two bits of each int64 forward key from the pair table: bit 0 its
    membership, bit 1 its reverse complement's (at CENTRE_K through its
    canonical key's entry, the bits swapped where that is the reverse
    complement)."""
    words = table.pair.long() & _U32
    if table.mode == MODE_PAIR:
        return (words[fk >> 4] >> (2 * (fk & 15))) & 3
    cls, flip = (torch.from_numpy(a).to(fk.device) for a in centre_classes())
    f = flip[(fk >> 12) & 15] == 1
    i = centre_index(torch.where(f, revcomp_keys(fk, CENTRE_K), fk), cls)
    v = (words[i >> 4] >> (2 * (i & 15))) & 3
    return torch.where(f, (v >> 1) | ((v & 1) << 1), v)


def classify_plain(table: DeviceKmerTable, codes: torch.Tensor,
                   lens: torch.Tensor):
    """Plain PyTorch version of the kernel (`classify`'s contract): at k
    <= DIRECT_MAX_K one pair entry a forward window answers both
    strands."""
    if table.pair is not None:
        R, L = codes.shape
        fwd, ok = _rolling(codes.long(), table.k)
        win = torch.arange(L - table.k + 1, device=codes.device)[None, :]
        ok &= win < lens.long()[:, None] - table.k + 1
        bits = pair_lookup(table, fwd) * ok
        return ((bits & 1).sum(dim=1, dtype=torch.int32),
                (bits >> 1).sum(dim=1, dtype=torch.int32))
    fwd, fwd_ok, rc, rc_ok = window_keys(codes, lens, table.k)
    return ((_lookup(table, fwd)[0] & fwd_ok).sum(dim=1, dtype=torch.int32),
            (_lookup(table, rc)[0] & rc_ok).sum(dim=1, dtype=torch.int32))


def lookups(table: DeviceKmerTable, codes: torch.Tensor,
            lens: torch.Tensor) -> Tuple[int, int]:
    """Table words one launch of the kernel reads, counted from this
    batch's keys: (this design, the first design).  A window in its read
    without an N reads one pair or centre-canonical word (the first design
    two bitmap words); hashed, each strand's probe chain reads a word a
    probe in both designs."""
    fwd, fwd_ok, rc, rc_ok = window_keys(codes, lens, table.k)
    if table.pair is not None:
        n = int(fwd_ok.sum())
        return n, 2 * n
    n = int(_lookup(table, torch.cat([fwd[fwd_ok], rc[rc_ok]]))[1])
    return n, n


# ----------------------------------------------------------------- kernel

def bind_kmer_lib(lib: ctypes.CDLL, names=("t1k_kmer_classify",
                                            "t1k_kmer_classify_v1")):
    """Set the argument types of a build's classify entries (they share
    one signature); returns `lib`."""
    for name in names:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _kmer_lib() -> ctypes.CDLL:
    from ._build import load

    return bind_kmer_lib(load("kmer_classify"))


def _check(name: str, x: torch.Tensor, dtype, dev) -> None:
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{dev}")


def _launch(entry: str, table: DeviceKmerTable, words: torch.Tensor,
            mode: int, codes: torch.Tensor, lens: torch.Tensor):
    """One launch of csrc/kmer_classify.cu's `entry` on the current stream
    (no synchronisation), counted under `entry`'s name."""
    dev = codes.device
    _check("codes", codes, torch.int8, dev)
    _check("lens", lens, torch.int32, dev)
    _check("table", words, torch.int32, dev)
    R, L = codes.shape
    if lens.shape != (R,) or L < table.k:
        raise ValueError(f"codes [R, L] with L >= k = {table.k} and lens "
                         "[R]")
    fwd = torch.empty(R, dtype=torch.int32, device=dev)
    rc = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return fwd, rc
    fn = getattr(_kmer_lib(), f"t1k_{entry}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(codes.data_ptr(), lens.data_ptr(), R, L, table.k, mode,
                 words.data_ptr(), table.size - 1, MAX_PROBE,
                 fwd.data_ptr(), rc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    launch_counts[entry] += 1
    return fwd, rc


def classify_cuda(table: DeviceKmerTable, codes: torch.Tensor,
                  lens: torch.Tensor):
    """Launch csrc/kmer_classify.cu on the current stream (no
    synchronisation); same result as classify_plain."""
    words = table.pair if table.pair is not None else table.table
    return _launch("kmer_classify", table, words, table.mode, codes, lens)


def classify_v1_cuda(table: DeviceKmerTable, codes: torch.Tensor,
                     lens: torch.Tensor):
    """The kernel's first design (two lookups a window in `table`), for
    A/B timing only; same result as classify_plain."""
    return _launch("kmer_classify_v1", table, table.table, int(table.direct),
                   codes, lens)


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
