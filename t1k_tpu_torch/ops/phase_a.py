"""Phase A of the extraction screen on torch tensors: k-mer hit
generation, diagonal clustering and LIS chaining.

Counterpart of ``t1k_tpu/ops/phase_a.py`` (``PhaseAIndex``, the XLA
programs ``_probe_kernel`` and ``_chain_kernel``, ``DeviceScreen``), with
the same bit-exactness contract against the native engine's HasHitInSet
(reference SeqSet.hpp:1071-1990):

  * the posting table reproduces KmerIndex::BuildIndexFromRead's
    insertion quirks, a stable per-code order, and the hashed table's
    "last wins" parallel insertion; n_seqs and the posting array are
    padded to the same power-of-two tiers, so bucket order and every
    tie-break are the JAX package's;
  * probing forms the read's reverse complement left-aligned, rolling
    2-bit codes with N as bit pattern 3 and a separate validity window,
    and GetHitsFromRead's dedup/skip scan;
  * the best (strand, seq) bucket per read is the first strictly-largest
    group (strand -1 first, then seq ascending);
  * chaining sorts by (diagonal, seqOff, readOff), splits at diagonal
    gaps > radius, keeps per read offset the seeds nearest the first
    maximal equal-diagonal run, runs the reference's patience LIS, and
    counts TotalSpan with gap breaks > k-1 on both axes.

Four functions carry kernels, each with its plain PyTorch version beside
it: ``probe`` (``csrc/phase_a_probe.cu``) and ``chain_rows``
(``csrc/phase_a_chain.cu``) for the screen; ``bucket_census``
(``csrc/cand_census.cu``) and ``chain_buckets`` (the bucket-ragged entry
of ``csrc/phase_a_chain.cu``) for the genotyper's candidate pruning (the
JAX package's DeviceCandidates, K10).  CPU tensors take the plain
version; CUDA tensors launch the kernel and never fall back.  The
screen's posting expansion and bucket choice (``expand_buckets``) is
integer tensor code on either device.  All arithmetic is exact integer
arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass, fields
from typing import Tuple

import numpy as np
import torch

from ..utils.observability import traced_range

I32MAX = int(np.iinfo(np.int32).max)
EMPTY_KEY = 0xFFFFFFFF      # hashed-table empty slot
_DIRECT_MAX_K = 12          # 4^12+1 int32 CSR offsets = 64 MB
_MIN_HIT_REQUIRED = 3       # SeqSet.hpp minHitRequired
_HASH_MUL = 2654435761
MAX_READ_LEN = 1 << 12      # longer reads are screened on the host
CHAIN_MAX_B = 512           # bucket width the chain kernel holds in shared memory

# Kernel launches, counted by the CUDA wrappers where they launch.
launch_counts = {"phase_a_probe": 0, "phase_a_chain": 0, "cand_census": 0,
                 "cand_chain": 0}


# --------------------------------------------------------------- table build

def build_arrays(packed, k: int) -> dict:
    """The JAX package's PhaseAIndex.build on host numpy, field for field
    (ops/phase_a.py:100-213 there): a dict of PhaseAIndex's fields with
    numpy arrays (keys as uint32)."""
    # 0xFFFFFFFF is the hashed-table empty sentinel, so the all-T k=16
    # code cannot be represented: the effective ceiling is 15.
    if k > 15:
        raise ValueError("phase-A codes are uint32 with an empty sentinel "
                         "(k <= 15)")
    max_len = int(packed.seq_lens.max()) if packed.n else 0
    if max_len >= 1 << 20:
        raise ValueError("diagonal packing assumes seq len < 1M")
    all_codes, all_seq, all_off = [], [], []
    pows = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    for s in range(packed.n):
        start = int(packed.seq_starts[s])
        ln = int(packed.seq_lens[s])
        if ln < k:
            continue
        codes = packed.seq_codes[start:start + ln].astype(np.int64)
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        valid = (win < 4).all(axis=1)
        vals = (np.minimum(win, 3) * pows).sum(axis=1)
        # KmerIndex.hpp:107-130 insertion rule incl. boundary quirks
        keep = valid.copy()
        keep[0] &= vals[0] != 0          # first window: skip code 0
        if len(vals) > 2:                # offset 1 always inserts;
            keep[2:] &= vals[2:] != vals[1:-1]  # others dedup vs prev
        idx = np.nonzero(keep)[0]
        all_codes.append(vals[idx].astype(np.uint32))
        all_seq.append(np.full(len(idx), s, np.int32))
        all_off.append(idx.astype(np.int32))
    if all_codes:
        codes = np.concatenate(all_codes)
        seqs = np.concatenate(all_seq)
        offs = np.concatenate(all_off)
    else:
        codes = np.zeros(0, np.uint32)
        seqs = np.zeros(0, np.int32)
        offs = np.zeros(0, np.int32)
    order = np.argsort(codes, kind="stable")  # per-code insertion order
    codes, seqs, offs = codes[order], seqs[order], offs[order]
    if len(seqs) == 0:  # keep gathers in-bounds for an empty panel
        seqs = np.zeros(1, np.int32)
        offs = np.zeros(1, np.int32)
    # The power-of-two tiers of the JAX build: padding groups own no
    # postings and keep group order, padded postings are never addressed.
    n_pad = 32
    while n_pad < packed.n:
        n_pad *= 2
    p_pad = 1 << max(int(len(seqs) - 1).bit_length(), 5)
    seqs = np.concatenate([seqs, np.zeros(p_pad - len(seqs), np.int32)])
    offs = np.concatenate([offs, np.zeros(p_pad - len(offs), np.int32)])

    empty = np.zeros(0, np.int32)
    base = dict(k=k, n_seqs=n_pad, max_seq_len=max_len, post_seq=seqs,
                post_off=offs)
    if k <= _DIRECT_MAX_K:
        starts = np.zeros(4 ** k + 1, np.int64)
        np.add.at(starts, codes.astype(np.int64) + 1, 1)
        starts = np.cumsum(starts).astype(np.int32)
        return dict(base, direct=True, starts=starts,
                    keys=np.zeros(0, np.uint32), hstart=empty, hcount=empty,
                    hsize=1, max_probe=1)
    uniq, first, counts = np.unique(codes, return_index=True,
                                    return_counts=True)
    n = max(len(uniq), 1)
    size = 1
    while size < 4 * n:
        size *= 2
    mask = size - 1
    keys = np.full(size, EMPTY_KEY, np.uint32)
    hstart = np.zeros(size, np.int32)
    hcount = np.zeros(size, np.int32)
    # Parallel insertion in rounds of claim-and-advance; where several keys
    # claim one slot the last write wins.  max_probe = worst displacement.
    key64 = uniq.astype(np.int64)
    h = (key64 * _HASH_MUL) & mask
    step = ((key64 >> 15) | 1) & mask | 1
    unres = np.arange(len(uniq))
    max_probe = 0
    while len(unres):
        max_probe += 1
        hh = h[unres]
        free = keys[hh] == EMPTY_KEY
        cand = unres[free]
        keys[h[cand]] = cand.astype(np.uint32)  # stash idx; last wins
        won = cand[keys[h[cand]] == cand]
        keys[h[won]] = uniq[won]
        hstart[h[won]] = first[won]
        hcount[h[won]] = counts[won]
        lost = np.setdiff1d(unres, won, assume_unique=True)
        h[lost] = (h[lost] + step[lost]) & mask
        unres = lost
    mp_pad = 1
    while mp_pad < max_probe:
        mp_pad *= 2
    return dict(base, direct=False, starts=np.zeros(1, np.int32), keys=keys,
                hstart=hstart, hcount=hcount, hsize=size, max_probe=mp_pad)


@dataclass
class PhaseAIndex:
    """CSR k-mer posting table as torch tensors on one device.

    k <= 12 direct-addresses `starts` by the 2-bit code; larger k uses an
    open-addressed table of the distinct codes whose `max_probe` bounds
    every present key's displacement (absent keys resolve at any probe
    count).  `keys` holds the uint32 codes' bit patterns in int32."""

    k: int
    n_seqs: int
    max_seq_len: int
    post_seq: torch.Tensor    # int32 [P]
    post_off: torch.Tensor    # int32 [P]
    direct: bool
    starts: torch.Tensor      # direct: int32 [4^k+1]
    keys: torch.Tensor        # hashed: int32 [S] (uint32 bits; -1 = empty)
    hstart: torch.Tensor      # hashed: int32 [S]
    hcount: torch.Tensor      # hashed: int32 [S]
    hsize: int
    max_probe: int

    @property
    def device(self) -> torch.device:
        return self.post_seq.device

    @classmethod
    def build(cls, packed, k: int, device="cuda") -> "PhaseAIndex":
        return cls.from_jax_arrays(**build_arrays(packed, k), device=device)

    @classmethod
    def from_jax_arrays(cls, k, n_seqs, max_seq_len, post_seq, post_off,
                        direct, starts, keys, hstart, hcount, hsize,
                        max_probe, device="cuda") -> "PhaseAIndex":
        """The index from the arrays of a JAX-package PhaseAIndex (or of
        `build_arrays`), as numpy: the carry-over of a built table."""
        dev = torch.device(device)

        def i32(x):
            return torch.from_numpy(
                np.ascontiguousarray(np.asarray(x).astype(np.int32))).to(dev)

        keys = np.ascontiguousarray(np.asarray(keys, np.uint32))
        return cls(k=int(k), n_seqs=int(n_seqs), max_seq_len=int(max_seq_len),
                   post_seq=i32(post_seq), post_off=i32(post_off),
                   direct=bool(direct), starts=i32(starts),
                   keys=torch.from_numpy(keys.view(np.int32).copy()).to(dev),
                   hstart=i32(hstart), hcount=i32(hcount), hsize=int(hsize),
                   max_probe=int(max_probe))

    def to_numpy(self) -> dict:
        """The fields as `build_arrays` gives them (keys as uint32)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
                if f.name == "keys":
                    v = v.view(np.uint32)
            out[f.name] = v
        return out


# ------------------------------------------------------------ window probing

def probe(codes: torch.Tensor, lens: torch.Tensor, index: PhaseAIndex):
    """Windows, CSR lookups and the probe dedup/skip scan of `_probe_kernel`.

    codes int8 [R, L] (pad 4), lens int32 [R], on the index's device.
    Returns (contrib, cstart) int32 [R, 2W] with the forward windows then
    the reverse-complement windows, and tot int32 [R]."""
    if codes.device.type == "cuda":
        return probe_cuda(codes, lens, index)
    if codes.device.type == "cpu":
        return probe_plain(codes, lens, index)
    raise ValueError(f"no probe kernel for device {codes.device}")


def _csr_lookup_plain(wc, valid, index: PhaseAIndex):
    """Per-window CSR slice (start, count); the uint32 hash is computed in
    int64 and masked, which equals the uint32 arithmetic bit for bit."""
    if index.direct:
        starts = index.starts.long()
        st = starts[wc]
        cnt = starts[wc + 1] - st
    else:
        keys = index.keys.long() & 0xFFFFFFFF
        mask = index.hsize - 1
        h = (wc * _HASH_MUL) & 0xFFFFFFFF & mask
        step = ((wc >> 15) | 1) & mask | 1
        done = torch.zeros_like(wc, dtype=torch.bool)
        for _ in range(index.max_probe):
            kh = keys[h]
            done = done | (kh == wc) | (kh == EMPTY_KEY)
            h = torch.where(done, h, (h + step) & mask)
        found = keys[h] == wc
        st = torch.where(found, index.hstart.long()[h], 0)
        cnt = torch.where(found, index.hcount.long()[h], 0)
    return torch.where(valid, st, 0), torch.where(valid, cnt, 0)


def _probe_scan_plain(wc, sizes, lens, k: int):
    """GetHitsFromRead's per-strand loop (SeqSet.hpp:1081-1119): dedup
    against the previous rolling code, skip >=100-posting windows up to
    k/2 times in a row WITHOUT updating the dedup state, always probe the
    first and the last window.  Returns the emit mask [rows, W]."""
    rows, W = wc.shape
    skip_limit = k // 2
    last_w = lens - k          # engine i == len-1  <=>  w == len-k
    prev = torch.zeros(rows, dtype=wc.dtype, device=wc.device)
    skip = torch.zeros(rows, dtype=torch.int32, device=wc.device)
    emit = torch.zeros((rows, W), dtype=torch.bool, device=wc.device)
    for w in range(W):
        code, size = wc[:, w], sizes[:, w]
        active = (w <= last_w) & (lens >= k)
        considered = active & ((code != prev) | (w == 0))
        skipped = considered & (size >= 100) & (last_w != w) \
            & (skip < skip_limit)
        if w == 0:
            skipped = torch.zeros_like(skipped)
        emit[:, w] = considered & ~skipped & (size > 0)
        skip = torch.where(~active, skip,
                           torch.where(skipped, skip + 1,
                                       torch.where(considered, 0, skip)))
        prev = torch.where(active & ~skipped, code, prev)
    return emit


def probe_plain(codes: torch.Tensor, lens: torch.Tensor,
                index: PhaseAIndex):
    """Plain PyTorch version of the probe kernel (`probe`'s contract)."""
    R, L = codes.shape
    k = index.k
    W = L - k + 1
    dev = codes.device
    c = codes.long()
    lens64 = lens.long()
    # the reverse complement, left-aligned like the engine
    j = lens64[:, None] - 1 - torch.arange(L, device=dev)[None, :]
    rc_base = c.gather(1, j.clamp(min=0))
    rc = torch.where(j >= 0, torch.where(rc_base < 4, 3 - rc_base, rc_base),
                     4)
    stacked = torch.cat([c, rc], dim=0)                       # [2R, L]
    wc = torch.zeros((2 * R, W), dtype=torch.int64, device=dev)
    invalid = torch.zeros((2 * R, W), dtype=torch.bool, device=dev)
    for t in range(k):
        sl = stacked[:, t:t + W]
        wc = (wc << 2) | sl.clamp(max=3)
        invalid |= sl >= 4
    cstart, csize = _csr_lookup_plain(wc, ~invalid, index)
    emit = _probe_scan_plain(wc, csize, lens64.repeat(2), k)

    def halves(x):  # [2R, W] -> [R, 2W]
        return torch.cat([x[:R], x[R:]], dim=1).to(torch.int32)

    contrib = halves(torch.where(emit, csize, 0))
    return contrib, halves(cstart), contrib.sum(dim=1, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _probe_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("phase_a_probe")
    lib.t1k_phase_a_probe.restype = ctypes.c_int
    lib.t1k_phase_a_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _check(name: str, x: torch.Tensor, dtype, dev) -> None:
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{dev}")


def probe_cuda(codes: torch.Tensor, lens: torch.Tensor, index: PhaseAIndex):
    """Launch csrc/phase_a_probe.cu on the current stream (no
    synchronisation); same result as probe_plain."""
    dev = codes.device
    _check("codes", codes, torch.int8, dev)
    _check("lens", lens, torch.int32, dev)
    for name in ("post_seq", "starts", "keys", "hstart", "hcount"):
        _check(name, getattr(index, name), torch.int32, dev)
    R, L = codes.shape
    k = index.k
    if lens.shape != (R,) or L < k or L >= MAX_READ_LEN:
        raise ValueError(f"codes [R, L] with {k} <= L < {MAX_READ_LEN} and "
                         "lens [R]")
    W = L - k + 1
    contrib = torch.empty((R, 2 * W), dtype=torch.int32, device=dev)
    cstart = torch.empty((R, 2 * W), dtype=torch.int32, device=dev)
    tot = torch.zeros(R, dtype=torch.int32, device=dev)
    if R == 0:
        return contrib, cstart, tot
    lib = _probe_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_phase_a_probe(
            codes.data_ptr(), lens.data_ptr(), R, L, k, int(index.direct),
            index.starts.data_ptr(), index.keys.data_ptr(),
            index.hstart.data_ptr(), index.hcount.data_ptr(),
            index.hsize - 1, index.max_probe, contrib.data_ptr(),
            cstart.data_ptr(), tot.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"phase_a_probe kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts["phase_a_probe"] += 1
    return contrib, cstart, tot


# ------------------------------------------------------- bucket expansion

def expand_buckets(contrib: torch.Tensor, cstart: torch.Tensor, total: int,
                   index: PhaseAIndex, hit_len_required: int,
                   bucket_cap: int):
    """The first half of `_chain_kernel`: expand the emitting windows'
    posting slices into a flat hit arena of exactly `total` slots, choose
    each read's best (strand, seq) bucket, and compact that bucket onto a
    dense [R, bucket_cap] seed tile.

    Returns (a, b, nb, pass0, decided): read offsets and seq offsets int32
    [R, B], seeds per row int32 [R], and the bucket-size verdicts bool
    [R].  Needs no host synchronisation: `total` is the chunk's hit total
    the caller already holds."""
    dev = contrib.device
    R, W2 = contrib.shape
    W = W2 // 2
    B = bucket_cap
    k = index.k
    n_seqs = index.n_seqs
    NG = 2 * n_seqs
    flatc = contrib.reshape(-1).long()
    startf = torch.cumsum(flatc, 0) - flatc
    wid = torch.repeat_interleave(torch.arange(R * W2, device=dev), flatc,
                                  output_size=total)
    slot = torch.arange(total, device=dev)
    pidx = cstart.reshape(-1).long()[wid] + (slot - startf[wid])
    r = wid // W2
    woff = wid % W2
    is_fwd = woff < W
    roff = torch.where(is_fwd, woff, woff - W)
    lkey = index.post_seq.long()[pidx] + torch.where(is_fwd, n_seqs, 0)

    # best bucket per read: the largest group, ties to the smallest key
    # (strand -1 first, then seq ascending), from the sorted group keys
    gk = torch.sort(r * NG + lkey).values
    newg = torch.ones(total, dtype=torch.bool, device=dev)
    newg[1:] = gk[1:] != gk[:-1]
    gid = torch.cumsum(newg.long(), 0) - 1
    gsize = torch.zeros(total, dtype=torch.int64, device=dev).scatter_add_(
        0, gid, torch.ones_like(gid))
    score = gsize[gid] * NG + (NG - 1 - gk % NG)
    best = torch.full((R,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, gk // NG, score, reduce="amax")
    found = best >= 0
    best_len = torch.where(found, best // NG, 0)
    best_key = torch.where(found, NG - 1 - best % NG, NG)
    pass0 = (best_len * k >= hit_len_required) & (best_len > 0)
    decided = best_len <= B

    # compact the winning bucket onto the [R, B] chaining axis, in arena
    # order (the chain sorts it anyway)
    inb = lkey == best_key[r]
    per_row = torch.zeros(R, dtype=torch.int64, device=dev).scatter_add_(
        0, r, inb.long())
    base = torch.cumsum(per_row, 0) - per_row
    tpos = torch.cumsum(inb.long(), 0) - 1 - base[r]
    tgt = torch.where(inb & (tpos < B), r * B + tpos, R * B)
    a = torch.zeros(R * B + 1, dtype=torch.int32, device=dev)
    a.scatter_(0, tgt, roff.to(torch.int32))
    b = torch.zeros(R * B + 1, dtype=torch.int32, device=dev)
    b.scatter_(0, tgt, index.post_off[pidx])
    nb = torch.clamp(best_len, max=B).to(torch.int32)
    return (a[:R * B].view(R, B), b[:R * B].view(R, B), nb, pass0, decided)


# ------------------------------------------------------------ chaining

def chain_rows(a, b, nb, lens, budgets, *, k: int, radius: int,
               hit_len_required: int) -> torch.Tensor:
    """The per-bucket chain state machine on a dense [NR, B] seed tile
    (row r: one (read, strand, seq) bucket, a = read offsets, b = seq
    offsets, the first nb[r] columns valid, any order).

    Returns int32 [2, NR]: row 0 is 1 where some segment passes the core
    tests and the mismatch budget (the screen's HasHitInSet), row 1 where
    some segment passes the core tests (a bucket that emits an overlap in
    the assignment path)."""
    if a.device.type == "cuda":
        return chain_rows_cuda(a, b, nb, lens, budgets, k=k, radius=radius,
                               hit_len_required=hit_len_required)
    if a.device.type == "cpu":
        core, budget = chain_rows_plain(a, b, nb, lens, budgets, k=k,
                                        radius=radius,
                                        hit_len_required=hit_len_required)
        return torch.stack([(core & budget).any(dim=1),
                            core.any(dim=1)]).to(torch.int32)
    raise ValueError(f"no chain kernel for device {a.device}")


def _seg_last(segstart, has, val):
    """For each position, the most recent (has, val) at a STRICTLY earlier
    position within its segment (segments start where `segstart`)."""
    NR, B = has.shape
    pos = torch.arange(B, device=has.device).expand(NR, B)
    prev_pos = torch.where(has, pos, -1)
    prev_pos = torch.cat([torch.full_like(prev_pos[:, :1], -1),
                          prev_pos[:, :-1]], dim=1)
    latest = torch.cummax(prev_pos, dim=1).values
    seg_first = torch.cummax(torch.where(segstart, pos, 0), dim=1).values
    ok = latest >= seg_first
    return ok, val.gather(1, latest.clamp(min=0))


def _seg_sum(values, seg, nseg):
    out = torch.zeros((values.shape[0], nseg), dtype=torch.int64,
                      device=values.device)
    return out.scatter_add_(1, seg, values.long())


def chain_rows_plain(a, b, nb, lens, budgets, *, k: int, radius: int,
                     hit_len_required: int):
    """Plain PyTorch version of `_chain_rows`: per-segment (seg_core,
    seg_budget) bool [NR, B+1].  The lexicographic sorts use packed int64
    keys (a < 2^12, b < 2^20, |a - b| < 2^21, segment < 2^10)."""
    dev = a.device
    NR, B_out = a.shape
    # columns past the widest row hold no seed: drop them, and pad the
    # per-segment masks back to B_out + 1 slots at the end
    B = max(1, min(B_out, int(nb.max())) if NR else 1)
    a, b = a[:, :B], b[:, :B]
    NSEG = B + 1
    BIG = torch.iinfo(torch.int64).max
    pos = torch.arange(B, device=dev)[None, :]
    a = a.long()
    b = b.long()
    mv = pos < nb.long()[:, None]

    # ---- diagonal sort of the bucket: (c, b, a) ascending
    key = torch.where(mv, ((a - b + (1 << 20)) << 32) | (b << 12) | a, BIG)
    key = torch.sort(key, dim=1).values
    m = key != BIG
    c = torch.where(m, (key >> 32) - (1 << 20), 0)
    b = torch.where(m, (key >> 12) & 0xFFFFF, 0)
    a = torch.where(m, key & 0xFFF, 0)

    # ---- segments: diagonal gap > radius starts a new one
    prev_c = torch.cat([c[:, :1], c[:, :-1]], dim=1)
    newseg = m & ((pos == 0) | (c - prev_c > radius))
    seg = torch.where(m, torch.cumsum(newseg.long(), dim=1) - 1, B)

    # ---- dominant diagonal per segment: first maximal equal-c run
    newrun = m & (newseg | (c != prev_c))
    run_first = torch.cummax(torch.where(newrun, pos, 0), dim=1).values
    run_id = torch.where(m, torch.cumsum(newrun.long(), dim=1) - 1, B)
    rlen = _seg_sum(m, run_id, NSEG).gather(1, run_id)
    dom_pack = torch.where(m, rlen * (B + 1) + (B - run_first), 0)
    seg_dom = torch.zeros((NR, NSEG), dtype=torch.int64, device=dev) \
        .scatter_reduce_(1, seg, dom_pack, reduce="amax")
    is_dom = m & (dom_pack == seg_dom.gather(1, seg))
    dom_c = torch.full((NR, NSEG), -(1 << 40), dtype=torch.int64,
                       device=dev).scatter_reduce_(
        1, seg, torch.where(is_dom, c, -(1 << 40)), reduce="amax")
    seg_sz = _seg_sum(m, seg, NSEG)

    # ---- offsetBest: keep seeds nearest the dominant diagonal per read
    # offset (SeqSet.hpp:1412-1448)
    if radius > 0:
        d = (c - dom_c.gather(1, seg)).abs()
        key = torch.where(m, (seg << 53) | (a << 41) | (d << 20) | b, BIG)
        key = torch.sort(key, dim=1).values
        m3 = key != BIG
        seg = torch.where(m3, key >> 53, B)
        a = torch.where(m3, (key >> 41) & 0xFFF, 0)
        d = torch.where(m3, (key >> 20) & 0x1FFFFF, 0)
        b = torch.where(m3, key & 0xFFFFF, 0)
        grp = m3 & ((pos == 0) | (seg != torch.cat([seg[:, :1], seg[:, :-1]],
                                                    dim=1))
                    | (a != torch.cat([a[:, :1] - 1, a[:, :-1]], dim=1)))
        first = torch.cummax(torch.where(grp, pos, 0), dim=1).values
        keep = m3 & (d == d.gather(1, first))
    else:
        keep = m
    # ---- order the kept seeds by (segment, b, a) for the LIS
    key = torch.where(keep, (seg << 32) | (b << 12) | a, BIG)
    key = torch.sort(key, dim=1).values
    ml = key != BIG
    seg = torch.where(ml, key >> 32, B)
    b = torch.where(ml, (key >> 12) & 0xFFFFF, 0)
    a = torch.where(ml, key & 0xFFF, 0)
    segstart = ml & ((pos == 0) | (seg != torch.cat(
        [torch.full_like(seg[:, :1], -1), seg[:, :-1]], dim=1)))

    # ---- exact reference LIS (SeqSet.hpp:352-436): the patience state;
    # equal tails never replace; the chain ends at the last top
    rows = torch.arange(NR, device=dev)
    top_v = torch.full((NR, B), I32MAX, dtype=torch.int64, device=dev)
    top_i = torch.full((NR, B), -1, dtype=torch.int64, device=dev)
    links = torch.full((NR, B), -1, dtype=torch.int64, device=dev)
    chain_end = torch.full((NR, B), -1, dtype=torch.int64, device=dev)
    for t in range(B):
        v, active, reset = a[:, t], ml[:, t], segstart[:, t]
        top_v = torch.where(reset[:, None], I32MAX, top_v)
        top_i = torch.where(reset[:, None], -1, top_i)
        c_lt = (top_v < v[:, None]).sum(dim=1)
        iseq = ((top_v == v[:, None]) & active[:, None]).any(dim=1)
        do = active & ~iseq
        prev_top = top_i.gather(1, (c_lt - 1).clamp(min=0)[:, None])[:, 0]
        links[:, t] = torch.where(do & (c_lt > 0), prev_top, -1)
        put = do & (c_lt < B)
        cl = c_lt.clamp(max=B - 1)
        top_v[rows[put], cl[put]] = v[put]
        top_i[rows[put], cl[put]] = t
        ret = (top_v < I32MAX).sum(dim=1)
        last = top_i.gather(1, (ret - 1).clamp(min=0)[:, None])[:, 0]
        chain_end[:, t] = torch.where(ret > 0, last, -1)

    # ---- backtrack every segment's chain
    nxt_seg = torch.cat([seg[:, 1:], torch.full_like(seg[:, :1], -1)], dim=1)
    seg_last = ml & ((pos == B - 1) | (nxt_seg != seg))
    ptr = torch.where(seg_last, chain_end, -1)
    chosen = torch.zeros((NR, B), dtype=torch.bool, device=dev)
    rr = rows[:, None].expand(NR, B)
    while bool((ptr >= 0).any()):
        live = ptr >= 0
        chosen[rr[live], ptr[live]] = True
        ptr = torch.where(live, links.gather(1, ptr.clamp(min=0)), -1)
    chosen &= ml

    # ---- collapse duplicate b along each chain (keep the first)
    ph, pb = _seg_last(segstart, chosen, b)
    kept = chosen & ~(ph & (pb == b))

    # ---- spans with gap breaks > k-1 (TotalSpan, both axes)
    kh, ka = _seg_last(segstart, kept, a)
    _, kb = _seg_last(segstart, kept, b)
    ca = torch.where(kept, torch.where(~kh | (a - ka > k - 1), k, a - ka), 0)
    cb = torch.where(kept, torch.where(~kh | (b - kb > k - 1), k, b - kb), 0)
    span_a = _seg_sum(ca, seg, NSEG)
    span_b = _seg_sum(cb, seg, NSEG)
    lis_sz = _seg_sum(kept, seg, NSEG)

    hlr = hit_len_required
    seg_core = ((seg_sz >= _MIN_HIT_REQUIRED) & (seg_sz * k >= hlr)
                & (lis_sz * k >= hlr) & (span_a >= hlr) & (span_b >= hlr))
    seg_budget = lens.long()[:, None] - span_a <= budgets.long()[:, None]
    # the dropped slots are empty segments: span 0, never core
    pad = (NR, B_out - B)
    return (torch.cat([seg_core, torch.zeros(pad, dtype=torch.bool,
                                             device=dev)], dim=1),
            torch.cat([seg_budget, (lens.long() <= budgets.long())[:, None]
                       .expand(pad)], dim=1))


@functools.lru_cache(maxsize=None)
def _chain_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("phase_a_chain")
    lib.t1k_phase_a_chain.restype = ctypes.c_int
    lib.t1k_phase_a_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.t1k_phase_a_chain_buckets.restype = ctypes.c_int
    lib.t1k_phase_a_chain_buckets.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    return lib


def chain_rows_cuda(a, b, nb, lens, budgets, *, k: int, radius: int,
                    hit_len_required: int) -> torch.Tensor:
    """Launch csrc/phase_a_chain.cu on the current stream (no
    synchronisation); same result as `chain_rows` on the CPU."""
    dev = a.device
    for name, x in (("a", a), ("b", b), ("nb", nb), ("lens", lens),
                    ("budgets", budgets)):
        _check(name, x, torch.int32, dev)
    NR, B = a.shape
    if b.shape != (NR, B) or nb.shape != (NR,) or lens.shape != (NR,) \
            or budgets.shape != (NR,):
        raise ValueError("a, b [NR, B]; nb, lens, budgets [NR]")
    if B > CHAIN_MAX_B:
        raise ValueError(f"bucket width {B} exceeds the chain kernel's "
                         f"{CHAIN_MAX_B}")
    out = torch.empty((2, NR), dtype=torch.int32, device=dev)
    if NR == 0:
        return out
    lib = _chain_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_phase_a_chain(
            a.data_ptr(), b.data_ptr(), nb.data_ptr(), lens.data_ptr(),
            budgets.data_ptr(), NR, B, k, radius, hit_len_required,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"phase_a_chain kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts["phase_a_chain"] += 1
    return out


def chain_plain(contrib, cstart, total: int, lens, budgets,
                index: PhaseAIndex, *, radius: int, hit_len_required: int,
                bucket_cap: int):
    """Plain PyTorch version of `_chain_kernel`: (verdict, decided) bool
    [R] for one probed chunk whose hit total is `total`."""
    a, b, nb, pass0, decided = expand_buckets(
        contrib, cstart, total, index, hit_len_required, bucket_cap)
    core, budget = chain_rows_plain(a, b, nb, lens, budgets, k=index.k,
                                    radius=radius,
                                    hit_len_required=hit_len_required)
    return pass0 & (core & budget).any(dim=1), decided


# ------------------------------------------------------------ the screen

class DeviceScreen:
    """Batched exact extraction screen on a torch device (HasHitInSet
    twin, the JAX package's DeviceScreen).

    screen(codes [n, L] int8, lens) -> (verdict, decided): `decided` False
    marks reads whose hit volume overflows the caps; the caller re-screens
    those on the native engine.  With the JAX screen's caps and row_chunk,
    `decided` is the JAX screen's."""

    MAX_INFLIGHT = 4
    _MAX_TIER = 1 << 24     # the JAX screen's largest arena tier

    def __init__(self, index: PhaseAIndex, hit_len_required: int,
                 ref_sim: float, radius: int = 10,
                 hit_cap: int = 1 << 20, bucket_cap: int = 512,
                 row_chunk: int = 1024):
        if bucket_cap > CHAIN_MAX_B:
            raise ValueError(f"bucket_cap above {CHAIN_MAX_B}")
        self.index = index
        self.hit_len_required = hit_len_required
        self.ref_sim = ref_sim
        self.radius = radius
        self.bucket_cap = bucket_cap
        self.row_chunk = row_chunk
        # a chunk whose hit total exceeds the largest arena is undecided
        self.hit_cap = min(hit_cap, self._MAX_TIER)
        self.device = index.device
        # reads handed to screen() and the share of them decided here
        self.screened = 0
        self.decided = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    @classmethod
    @traced_range("screen_build")
    def build(cls, packed, k: int, hit_len_required: int, ref_sim: float,
              radius: int = 10, device="cuda", **caps) -> "DeviceScreen":
        return cls(PhaseAIndex.build(packed, k, device), hit_len_required,
                   ref_sim, radius, **caps)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def screen(self, codes: np.ndarray,
               lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        verdict, decided = self._route(codes, lens)
        self.screened += len(decided)
        self.decided += int(decided.sum())
        return verdict, decided

    def _route(self, codes: np.ndarray, lens: np.ndarray):
        n, L = codes.shape
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, bool)
        k = self.index.k
        if L < k:
            # no window fits: the engine rejects every such read
            return np.zeros(n, bool), np.ones(n, bool)
        if L >= MAX_READ_LEN:
            # reads at/above the length envelope go to the host per read;
            # the rest is re-padded to its own width
            keep = lens < MAX_READ_LEN
            out_v = np.zeros(n, bool)
            out_d = np.zeros(n, bool)
            if keep.any():
                sub_l = lens[keep]
                sub_c = codes[keep][:, :int(sub_l.max())]
                out_v[keep], out_d[keep] = self._route(sub_c, sub_l)
            return out_v, out_d
        if self._stream is None:
            return self._screen(codes, lens)
        # the index was uploaded on the device's current stream
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            return self._screen(codes, lens)

    def _screen(self, codes: np.ndarray, lens: np.ndarray):
        idx = self.index
        n = codes.shape[0]
        lens = np.asarray(lens, np.int32)
        # int(len * (1 - s)) truncates in C++ double arithmetic; keep the
        # budget in host f64 (SeqSet.hpp:1973-1978)
        budgets = (np.trunc(lens.astype(np.float64) * (1.0 - self.ref_sim))
                   .astype(np.int32) * idx.k)
        codes_d = self._upload(codes.astype(np.int8, copy=False))
        lens_d = self._upload(lens)
        budgets_d = self._upload(budgets)
        out_v = torch.zeros(n, dtype=torch.bool, device=self.device)
        out_d = torch.zeros(n, dtype=torch.bool, device=self.device)
        cuda = self.device.type == "cuda"
        # Bounded probe/chain pipeline: the probes of the next chunks stay
        # queued on the stream while the oldest chunk's hit total (the one
        # host sync per chunk) comes back and its chain is queued.
        inflight = []

        def drain_one():
            lo, hi, contrib, cstart, total, done = inflight.pop(0)
            if done is not None:
                done.synchronize()
            total = int(total)
            if total > self.hit_cap:
                return
            a, b, nb, pass0, decided = expand_buckets(
                contrib, cstart, total, idx, self.hit_len_required,
                self.bucket_cap)
            flags = chain_rows(a, b, nb, lens_d[lo:hi], budgets_d[lo:hi],
                               k=idx.k, radius=self.radius,
                               hit_len_required=self.hit_len_required)
            out_v[lo:hi] = pass0 & (flags[0] != 0)
            out_d[lo:hi] = decided

        for lo in range(0, n, self.row_chunk):
            hi = min(lo + self.row_chunk, n)
            contrib, cstart, tot = probe(codes_d[lo:hi], lens_d[lo:hi], idx)
            if cuda:
                total = torch.empty((), dtype=torch.int64, pin_memory=True)
                total.copy_(tot.sum(dtype=torch.int64), non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                total, done = tot.sum(dtype=torch.int64), None
            inflight.append((lo, hi, contrib, cstart, total, done))
            if len(inflight) >= self.MAX_INFLIGHT:
                drain_one()
        while inflight:
            drain_one()
        return out_v.cpu().numpy(), out_d.cpu().numpy()


# ----------------------------------------------------- candidate generation
#
# The genotyper's pre-DP pruning (the JAX package's DeviceCandidates, its
# XLA programs `_cand_census_kernel` and `_cand_tile_kernel`, K10): every
# (read, strand, seq) bucket of a chunk is a chain row of the same state
# machine as the screen's, and the buckets whose chains emit at least one
# overlap in the assignment path (engine.cc BuildOverlaps) survive.  The
# host engine then collects hits only for those buckets.

@dataclass
class Census:
    """A chunk's hit arena sorted by bucket (`cand_census`).  Per slot, in
    bucket order: the key gk = read * 2 n_seqs + lkey, the read and seq
    offsets, the dense bucket id and the slot's rank inside its bucket.
    Per bucket b < nb_total: its first slot and its slot count (count is
    0 from nb_total on)."""

    gk: torch.Tensor        # int64 [total], ascending
    a: torch.Tensor         # int32 [total]
    b: torch.Tensor         # int32 [total]
    bid: torch.Tensor       # int64 [total]
    within: torch.Tensor    # int64 [total]
    first: torch.Tensor     # int64 [total]
    count: torch.Tensor     # int64 [total]
    nb_total: torch.Tensor  # int64 scalar, on the device


def cand_census(contrib: torch.Tensor, cstart: torch.Tensor, total: int,
                index: PhaseAIndex) -> Census:
    """`_cand_census_kernel`: expand the emitting windows' posting slices
    into a flat arena of exactly `total` slots (as `expand_buckets`; the
    JAX program pads it to an arena tier), then one sort by bucket key.

    The sort need not be stable: `_chain_rows` orders each bucket's seeds
    by its own diagonal sort, so the order inside a bucket never reaches
    a verdict, and a bucket of more than bucket_cap seeds leaves its read
    undecided whichever seeds come first.  bid, within and nb_total do not
    depend on it.  Needs no host synchronisation."""
    dev = contrib.device
    R, W2 = contrib.shape
    W = W2 // 2
    NG = 2 * index.n_seqs
    flatc = contrib.reshape(-1).long()
    startf = torch.cumsum(flatc, 0) - flatc
    wid = torch.repeat_interleave(torch.arange(R * W2, device=dev), flatc,
                                  output_size=total)
    slot = torch.arange(total, device=dev)
    pidx = cstart.reshape(-1).long()[wid] + (slot - startf[wid])
    woff = wid % W2
    is_fwd = woff < W
    roff = torch.where(is_fwd, woff, woff - W)
    lkey = index.post_seq.long()[pidx] + torch.where(is_fwd, index.n_seqs, 0)
    gk, order = torch.sort((wid // W2) * NG + lkey)
    newb = torch.ones(total, dtype=torch.bool, device=dev)
    newb[1:] = gk[1:] != gk[:-1]
    bid = torch.cumsum(newb, 0) - 1
    start = torch.cummax(torch.where(newb, slot, 0), 0).values
    count = torch.zeros(total, dtype=torch.int64, device=dev).scatter_add_(
        0, bid, torch.ones_like(bid))
    first = torch.zeros(total, dtype=torch.int64, device=dev).scatter_(
        0, bid, start)
    nb_total = (bid[-1] + 1 if total
                else torch.zeros((), dtype=torch.int64, device=dev))
    return Census(gk=gk, a=roff[order].to(torch.int32),
                  b=index.post_off[pidx[order]], bid=bid,
                  within=slot - start, first=first, count=count,
                  nb_total=nb_total)


def min_chain_seeds(k: int, hit_len_required: int) -> int:
    """The fewest seeds a bucket needs for a segment to pass the core
    tests (size >= 3 and size * k >= hitLen): a smaller bucket never
    emits an overlap, so it need not be chained."""
    return max(_MIN_HIT_REQUIRED, -(-hit_len_required // k))


def _gather_seeds(a, b, first, cnt, bucket_cap: int):
    """Each bucket's seeds a[first, first + cnt) and b[...] (cnt <=
    bucket_cap) on a dense [len(first), bucket_cap] tile, and the seeds
    per row."""
    col = torch.arange(bucket_cap, device=first.device)
    valid = col[None, :] < cnt[:, None]
    src = torch.where(valid, first[:, None] + col[None, :], 0)
    return (torch.where(valid, a[src], 0), torch.where(valid, b[src], 0),
            valid.sum(dim=1, dtype=torch.int32))


def cand_tile(census: Census, lens: torch.Tensor, rows: torch.Tensor, *,
              k: int, n_seqs: int, radius: int, hit_len_required: int,
              bucket_cap: int):
    """`_cand_tile_kernel` for the buckets `rows` (int64, each below
    nb_total): gather each bucket's seeds into a dense [len(rows),
    bucket_cap] tile and run `chain_rows` with zero budgets (the chain
    kernel on a card, its plain version on the CPU).

    Returns `keep` per bucket: the buckets whose chain emits at least one
    overlap.  A bucket with fewer than `min_chain_seeds` seeds or more
    than bucket_cap (its read is undecided) gets an empty chain row and
    keep False, as its full chain would give.  With `cand_census`, K10's
    plain reference, held against the JAX programs; `DeviceCandidates`
    runs `bucket_census` and `chain_buckets`."""
    cnt = census.count[rows]
    chained = (cnt >= min_chain_seeds(k, hit_len_required)) \
        & (cnt <= bucket_cap)
    first = census.first[rows]
    read = census.gk[first] // (2 * n_seqs)
    a, b, nb = _gather_seeds(census.a, census.b, first,
                             torch.where(chained, cnt, 0), bucket_cap)
    lens_row = lens[read].contiguous()
    flags = chain_rows(a, b, nb, lens_row, torch.zeros_like(lens_row), k=k,
                       radius=radius, hit_len_required=hit_len_required)
    return (flags[1] != 0) & chained


@dataclass
class BucketCensus:
    """A chunk's hit arena in bucket order (`bucket_census`): per slot the
    read and seq offsets; per bucket g < nb_total, in (read, strand -1
    then +1, seq) order, its key read * 2 n_seqs + lkey (lkey = seq, plus
    n_seqs on the forward strand), its first slot and its seed count.
    The per-bucket arrays have `total` entries and hold no bucket from
    nb_total on; the seeds of one bucket lie in any order."""

    a: torch.Tensor         # int32 [total], read offsets
    b: torch.Tensor         # int32 [total], seq offsets
    key: torch.Tensor       # int32 [total]
    first: torch.Tensor     # int32 [total]
    count: torch.Tensor     # int32 [total]
    nb_total: torch.Tensor  # int32 scalar, on the device


def bucket_census(contrib: torch.Tensor, cstart: torch.Tensor, total: int,
                  index: PhaseAIndex, bins_per_pass=None) -> BucketCensus:
    """K10's census of one probed chunk of `total` hits: on a card
    `csrc/cand_census.cu` (a counting sort per read), on the CPU the
    plain version (`cand_census`, projected).  `bins_per_pass` caps the
    kernel's keys per walk over a read's postings (None: as many as a
    block's shared memory holds; a smaller value exercises the slices);
    the plain version ignores it.  Needs no host synchronisation."""
    if contrib.shape[0] * 2 * index.n_seqs > 1 << 31:
        raise ValueError("bucket keys read * 2 n_seqs + lkey pass int32")
    if contrib.device.type == "cuda":
        return bucket_census_cuda(contrib, cstart, total, index,
                                  bins_per_pass)
    if contrib.device.type == "cpu":
        return bucket_census_plain(contrib, cstart, total, index)
    raise ValueError(f"no census kernel for device {contrib.device}")


def bucket_census_plain(contrib: torch.Tensor, cstart: torch.Tensor,
                        total: int, index: PhaseAIndex) -> BucketCensus:
    """Plain PyTorch version of the census kernel: `cand_census`'s sorted
    arena and its buckets' keys, first slots and counts."""
    cen = cand_census(contrib, cstart, total, index)
    live = torch.arange(total, device=contrib.device) < cen.nb_total
    return BucketCensus(a=cen.a, b=cen.b,
                        key=torch.where(live, cen.gk[cen.first], 0).int(),
                        first=cen.first.int(), count=cen.count.int(),
                        nb_total=cen.nb_total.int())


@functools.lru_cache(maxsize=None)
def _census_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("cand_census")
    lib.t1k_cand_census.restype = ctypes.c_int
    lib.t1k_cand_census.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8)
    return lib


def bucket_census_cuda(contrib: torch.Tensor, cstart: torch.Tensor,
                       total: int, index: PhaseAIndex,
                       bins_per_pass=None) -> BucketCensus:
    """Launch csrc/cand_census.cu on the current stream (no
    synchronisation); the same buckets as bucket_census_plain, the seeds
    of each bucket in another order."""
    dev = contrib.device
    _check("contrib", contrib, torch.int32, dev)
    _check("cstart", cstart, torch.int32, dev)
    _check("post_seq", index.post_seq, torch.int32, dev)
    _check("post_off", index.post_off, torch.int32, dev)
    R, W2 = contrib.shape
    total = int(total)
    if cstart.shape != (R, W2) or W2 % 2 or total > I32MAX:
        raise ValueError("contrib, cstart [R, 2W] and total < 2^31")
    a, b, key, first, count = (torch.empty(total, dtype=torch.int32,
                                           device=dev) for _ in range(5))
    nb_total = torch.zeros((), dtype=torch.int32, device=dev)
    if R == 0 or total == 0:
        return BucketCensus(a, b, key, first, count, nb_total)
    scratch = torch.empty(2 * R, dtype=torch.int32, device=dev)
    lib = _census_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_cand_census(
            contrib.data_ptr(), cstart.data_ptr(), index.post_seq.data_ptr(),
            index.post_off.data_ptr(), R, W2, index.n_seqs, total,
            int(bins_per_pass or 0), a.data_ptr(), b.data_ptr(),
            key.data_ptr(), first.data_ptr(), count.data_ptr(),
            nb_total.data_ptr(), scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"cand_census kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts["cand_census"] += 1
    return BucketCensus(a, b, key, first, count, nb_total)


def chain_buckets(census: BucketCensus, lens: torch.Tensor, *, k: int,
                  n_seqs: int, radius: int, hit_len_required: int,
                  bucket_cap: int):
    """K10's chain over a census (`_cand_tile_kernel` without its tiles):
    on a card the bucket-ragged entry of `csrc/phase_a_chain.cu`, on the
    CPU the plain version.  Every bucket of `min_chain_seeds` to
    bucket_cap seeds is chained with a zero budget; the others are not.

    Returns (keep, over): int32 [len(census.key)], 1 for a bucket below
    nb_total whose chain emits at least one overlap and 0 elsewhere; int32
    [len(lens)], per read its buckets past bucket_cap (a read with any is
    undecided).  Needs no host synchronisation on a card."""
    if bucket_cap > CHAIN_MAX_B:
        raise ValueError(f"bucket_cap above {CHAIN_MAX_B}")
    kw = dict(k=k, n_seqs=n_seqs, radius=radius,
              hit_len_required=hit_len_required, bucket_cap=bucket_cap)
    if lens.device.type == "cuda":
        return chain_buckets_cuda(census, lens, **kw)
    if lens.device.type == "cpu":
        return chain_buckets_plain(census, lens, **kw)
    raise ValueError(f"no chain kernel for device {lens.device}")


def chain_buckets_plain(census: BucketCensus, lens: torch.Tensor, *, k: int,
                        n_seqs: int, radius: int, hit_len_required: int,
                        bucket_cap: int):
    """Plain PyTorch version of the bucket-ragged chain: `cand_tile`'s
    gather of the chained buckets and the chain's plain version."""
    dev = lens.device
    nb = int(census.nb_total)
    cnt = census.count[:nb].long()
    read = census.key[:nb].long() // (2 * n_seqs)
    keep = torch.zeros(len(census.key), dtype=torch.int32, device=dev)
    over = torch.zeros(len(lens), dtype=torch.int32, device=dev)
    over.scatter_add_(0, read, (cnt > bucket_cap).int())
    rows = torch.nonzero((cnt >= min_chain_seeds(k, hit_len_required))
                         & (cnt <= bucket_cap))[:, 0]
    if len(rows):
        a, b, nbr = _gather_seeds(census.a, census.b,
                                  census.first[rows].long(), cnt[rows],
                                  bucket_cap)
        lens_row = lens[read[rows]]
        core, _ = chain_rows_plain(a, b, nbr, lens_row,
                                   torch.zeros_like(lens_row), k=k,
                                   radius=radius,
                                   hit_len_required=hit_len_required)
        keep[rows] = core.any(dim=1).int()
    return keep, over


def chain_buckets_cuda(census: BucketCensus, lens: torch.Tensor, *, k: int,
                       n_seqs: int, radius: int, hit_len_required: int,
                       bucket_cap: int):
    """Launch the bucket-ragged entry of csrc/phase_a_chain.cu on the
    current stream (no synchronisation); the same result as
    chain_buckets_plain."""
    dev = lens.device
    for name in ("a", "b", "key", "first", "count", "nb_total"):
        _check(name, getattr(census, name), torch.int32, dev)
    _check("lens", lens, torch.int32, dev)
    keep = torch.zeros(len(census.key), dtype=torch.int32, device=dev)
    over = torch.zeros(len(lens), dtype=torch.int32, device=dev)
    if len(census.key) == 0:
        return keep, over
    lib = _chain_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_phase_a_chain_buckets(
            census.a.data_ptr(), census.b.data_ptr(), census.key.data_ptr(),
            census.first.data_ptr(), census.count.data_ptr(),
            census.nb_total.data_ptr(), lens.data_ptr(), 2 * n_seqs,
            min_chain_seeds(k, hit_len_required), bucket_cap, k, radius,
            hit_len_required, keep.data_ptr(), over.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"phase_a_chain bucket kernel launch failed: CUDA "
                           f"error {rc}")
    launch_counts["cand_chain"] += 1
    return keep, over


def kept_keys(key: torch.Tensor, keep: torch.Tensor, size: int):
    """The keys of the buckets with keep != 0, in bucket order, then -1:
    int32 [size] (size bounds the kept count), without a host wait."""
    pos = torch.cumsum(keep, 0) - 1
    out = torch.full((size + 1,), -1, dtype=torch.int32, device=key.device)
    out.scatter_(0, torch.where(keep != 0, pos, size), key)
    return out[:size]


class DeviceCandidates:
    """Per-read candidate (strand, seq) buckets on a torch device (the JAX
    package's DeviceCandidates).

    generate(codes [n, L], lens) -> (reads int64, seqs int32, strands
    int8, undecided bool [n]): the surviving buckets (exactly those whose
    chains emit at least one overlap in the host assignment path), in
    (read, strand -1 then +1, seq) order, and the reads the device could
    not decide (a chunk past the hit cap, a bucket past bucket_cap, or L
    outside [k, 4096)), whose buckets are dropped: the caller runs those
    reads unpruned.  With the JAX package's caps the arrays equal its
    generate's element for element.

    Each chunk of row_chunk reads is probed (`probe`), censused
    (`bucket_census`) and chained bucket by bucket (`chain_buckets`) on a
    side stream; its kept keys, bucket count and over-counts stay on the
    device.  The host waits once a chunk, for its hit total (the arena's
    size; the probes of the next chunks stay queued meanwhile), and twice
    at the end: for the count of kept buckets and for one copy of every
    chunk's results."""

    MAX_INFLIGHT = 4
    _MAX_TIER = 1 << 24     # the JAX program's largest arena tier

    def __init__(self, index: PhaseAIndex, hit_len_required: int,
                 radius: int = 10, hit_cap: int = 1 << 24,
                 bucket_cap: int = 128, row_chunk: int = 1024):
        if bucket_cap > CHAIN_MAX_B:
            raise ValueError(f"bucket_cap above {CHAIN_MAX_B}")
        self.index = index
        self.hit_len_required = hit_len_required
        self.radius = radius
        self.bucket_cap = bucket_cap
        self.row_chunk = row_chunk
        # a chunk whose hit total exceeds the largest arena is undecided
        self.hit_cap = min(hit_cap, self._MAX_TIER)
        self.device = index.device
        # reads handed to generate(), the share of them decided here, the
        # buckets kept, generate()'s host-clock seconds and its host waits
        # on the card
        self.screened = 0
        self.decided = 0
        self.kept = 0
        self.seconds = 0.0
        self.waits = 0
        # one dict a chunk: lo, hi, hits, buckets, decided, kept
        self.chunks = []
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    @classmethod
    def build(cls, packed, k: int, hit_len_required: int, device="cuda",
              **caps) -> "DeviceCandidates":
        return cls(PhaseAIndex.build(packed, k, device), hit_len_required,
                   **caps)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def generate(self, codes: np.ndarray, lens: np.ndarray):
        t0 = time.perf_counter()
        n, L = codes.shape
        if n == 0 or L < self.index.k or L >= MAX_READ_LEN:
            out = (np.zeros(0, np.int64), np.zeros(0, np.int32),
                   np.zeros(0, np.int8), np.ones(n, bool))
        elif self._stream is None:
            out = self._generate(codes, lens)
        else:
            # the index was uploaded on the device's current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                out = self._generate(codes, lens)
        self.screened += n
        self.decided += int((~out[3]).sum())
        self.kept += len(out[0])
        self.seconds += time.perf_counter() - t0
        return out

    def chunk(self, contrib: torch.Tensor, cstart: torch.Tensor, total: int,
              lens: torch.Tensor):
        """K10 on one probed chunk whose `total` hits fit hit_cap: the
        census, then the chain of its buckets.  Returns, on the device and
        without a host wait, the kept buckets' keys (read * 2 n_seqs +
        lkey, the read counted from the chunk's first) in bucket order
        then -1 (int32), the chunk's bucket count, and per read its
        buckets past bucket_cap (int32; a read with any is undecided)."""
        idx = self.index
        census = bucket_census(contrib, cstart, total, idx)
        keep, over = chain_buckets(
            census, lens, k=idx.k, n_seqs=idx.n_seqs, radius=self.radius,
            hit_len_required=self.hit_len_required,
            bucket_cap=self.bucket_cap)
        size = total // min_chain_seeds(idx.k, self.hit_len_required)
        return kept_keys(census.key, keep, size), census.nb_total, over

    def _generate(self, codes: np.ndarray, lens: np.ndarray):
        idx = self.index
        n = codes.shape[0]
        NG = 2 * idx.n_seqs
        lens = np.asarray(lens, np.int32)
        codes_d = self._upload(codes.astype(np.int8, copy=False))
        lens_d = self._upload(lens)
        undecided = np.zeros(n, bool)
        over_d = torch.zeros(n, dtype=torch.int64, device=self.device)
        kept = []           # per chunk: lo * NG + key of its kept buckets
        buckets = []        # per chunk: its bucket count
        chunks = []
        cuda = self.device.type == "cuda"
        inflight = []

        def drain_one():
            lo, hi, contrib, cstart, total, done = inflight.pop(0)
            if done is not None:
                done.synchronize()
                self.waits += 1
            total = int(total)
            chunks.append(dict(lo=lo, hi=hi, hits=total, buckets=0))
            if total > self.hit_cap:
                undecided[lo:hi] = True
                buckets.append(torch.zeros((), dtype=torch.int64,
                                           device=self.device))
                return
            keys, nb, over = self.chunk(contrib, cstart, total,
                                        lens_d[lo:hi])
            over_d[lo:hi] += over
            kept.append(torch.where(keys >= 0, keys.long() + lo * NG, -1))
            buckets.append(nb.long())

        for lo in range(0, n, self.row_chunk):
            hi = min(lo + self.row_chunk, n)
            contrib, cstart, tot = probe(codes_d[lo:hi], lens_d[lo:hi], idx)
            if cuda:
                total = torch.empty((), dtype=torch.int64, pin_memory=True)
                total.copy_(tot.sum(dtype=torch.int64), non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                total, done = tot.sum(dtype=torch.int64), None
            inflight.append((lo, hi, contrib, cstart, total, done))
            if len(inflight) >= self.MAX_INFLIGHT:
                drain_one()
        while inflight:
            drain_one()

        # at the end, on the device: drop the padding and the buckets of
        # undecided reads (the host recomputes them), split the keys; the
        # host waits twice, for the kept count and for one copy
        over = over_d > 0
        keys = torch.cat(kept) if kept else over_d[:0]
        keys = keys[(keys >= 0) & ~over[(keys // NG).clamp(min=0)]]
        reads = keys // NG
        lkey = keys % NG
        is_fwd = lkey >= idx.n_seqs
        m = len(chunks)
        host = torch.cat([
            over.long(), torch.stack(buckets),
            torch.bincount(reads // self.row_chunk, minlength=m), reads,
            torch.where(is_fwd, lkey - idx.n_seqs, lkey),
            is_fwd.long()]).cpu().numpy()
        self.waits += 2 * cuda
        undecided |= host[:n] != 0
        nbs, per_chunk = host[n:n + m], host[n + m:n + 2 * m]
        reads, seqs, is_fwd = host[n + 2 * m:].reshape(3, len(reads))
        seqs = seqs.astype(np.int32)
        strands = np.where(is_fwd != 0, 1, -1).astype(np.int8)
        for c, info in enumerate(chunks):
            info["buckets"] = int(nbs[c])
            info["decided"] = int((~undecided[info["lo"]:info["hi"]]).sum())
            info["kept"] = int(per_chunk[c])
        self.chunks.extend(chunks)
        return reads, seqs, strands, undecided
