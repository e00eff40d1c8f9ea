"""Band-packed banded aligner with traceback statistics, on torch tensors.

Counterpart of ``t1k_tpu/ops/align_pallas_band.py``.  Same scoring
contract: banded affine-gap global alignment (match +2, mismatch -2, gap
open -4, gap extend -1, band 5 widened by |t_len - p_len|, code 4 = N
matches anything), plus the match / mismatch / indel counts of the
reference walk's traceback, carried forward as 9-bit fields of one packed
int32 (MU / XU / IU).  DP state lives in window coordinates
w = j - i + ML, so a row is a [W] vector per item.

Every entry point works on descriptors: an int64 [4, n] tensor of rows
(t_off, t_len, p_off, p_len) into two flat int8 code tensors, the text
(reference) and the pattern (reads).  The byte-window entry points
(``banded_scores_band``, ``banded_stats_band``, ``make_deferred_stats_fn``)
pack their windows into such flat buffers.

``band_stats`` dispatches on the tensors' device: CPU tensors run
``band_stats_plain``, the vectorized PyTorch version of the kernels; CUDA
tensors launch a hand-written kernel of ``csrc/band_stats.cu`` and never
fall back: one thread per item for windows of at most 32 cells (every
launch of the engine's deferred items), a group of lanes per item for
the wider windows, each lane holding CPL of the item's band slots
(``group_cpl`` picks CPL for the launch, the item's slot count its group
of G lanes).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np
import torch

SCORE_MATCH = 2
SCORE_MISMATCH = -2
GO = -4
GE = -1
NEG_INF = -(1 << 24)

# Packed traceback counters: match in bits 0-8, mismatch in 9-17, indel in
# 18-26.  A field can reach t_len + p_len + 2 ops, so 511 is the limit.
MU = 1
XU = 1 << 9
IU = 1 << 18

# The engine's deferred items have |t_len - p_len| <= 10 and lengths
# <= 254 (engine.cc kDeferMaxDiff / kDeferMaxLen), so one (ML, W) class
# covers them all, and W = 32 takes the thread kernel.
DESC_ML, DESC_W = 15, 32
DEFER_MAX_DIFF = 10
# Trailing zero bytes after each resident code tensor.
SEQ_PAD = 256

# Kernel launches, counted by the CUDA wrapper where it launches:
# "band_stats" the thread kernels, "band_stats_group" the lane-group
# kernel, "band_stats_warp" the first design's warp kernel (A/B only).
launch_counts = {"band_stats": 0, "band_stats_group": 0,
                 "band_stats_warp": 0}

# csrc/band_stats.cu's paths (t1k_band_stats's `path`)
_PATH_WARP, _PATH_THREAD, _PATH_GROUP = 0, 1, 2
# Slots a lane of the group kernel can hold (its instantiations); a
# group has at most 32 lanes and holds at least GROUP_MIN_SLOTS slots.
GROUP_CPL = (1, 2, 4, 8)
GROUP_MIN_SLOTS = 16


def band_window(ml: int, max_tp_diff: int, cap: int = 256) -> int:
    """Smallest window width (multiple of 8) covering the full band: the
    in-band region reaches w = ML + 5 + (t_len - p_len) mid-row."""
    need = ml + 5 + max(max_tp_diff, 0) + 1
    w = -(-max(need, 8) // 8) * 8
    if w > cap:
        raise ValueError("band exceeds the maximum window")
    return w


def kernel_window(w: int) -> int:
    """The CUDA kernels' window: 32 cells (the thread kernel), or 32 cells
    per lane-row times 2, 4 or 8 (the warp kernel).  A wider window with
    the same ML gives the same results: the cells it adds lie outside
    every band."""
    kw = 32
    while kw < w:
        kw *= 2
    if kw > 256:
        raise ValueError(f"window {w} exceeds the kernel's 256 cells")
    return kw


def window_slots(t_lens, p_lens, ml: int, kw: int) -> np.ndarray:
    """Register slots each item needs in a window of kw cells
    (band_stats.cu window_slots): the window cells from the column-0 cell
    left of the band to the row-0 cell right of it."""
    diff = np.asarray(t_lens, np.int64) - np.asarray(p_lens, np.int64)
    base = np.maximum(ml - 5 - np.maximum(-diff, 0) - 1, 0)
    return np.maximum(np.minimum(ml + 5 + np.maximum(diff, 0) + 1, kw - 1)
                      - base + 1, 1)


def group_lanes(slots, cpl: int) -> np.ndarray:
    """The lane-group kernel's G for items of `slots` slots at `cpl` slots
    a lane (band_stats.cu group_lg): the fewest lanes, a power of two,
    whose slots hold the item's and at least GROUP_MIN_SLOTS."""
    need = np.maximum(-(-np.asarray(slots, np.int64) // cpl),
                      GROUP_MIN_SLOTS // cpl)
    return np.minimum(1 << np.ceil(np.log2(np.maximum(need, 1))).astype(
        np.int64), 32)


# The most lanes a lane-group launch may take in all (group_cpl): between
# the smoke's 4,096 pairs at W = 128 at 2 slots a lane (100,032 lanes,
# faster than at 4) and its 4,096 pairs at W = 64 at 1 (111,696 lanes,
# slower than at 2), scripts/band_ab.py's per-CPL times.
GROUP_MAX_LANES = 104 * 1024


def group_cpl(slot_counts) -> int:
    """Slots a lane for a lane-group launch whose items number
    slot_counts[s] of s slots each (np.bincount of their slot counts):
    the fewest (the most lanes an item) whose 32-lane groups hold the
    largest item and at which the items' groups (group_lanes) take at
    most GROUP_MAX_LANES lanes in all, else the most.  Per-CPL times
    fixed it: the dry run's 256-1,024 pairs of 25 slots take 1, the
    smoke's 4,096 pairs at W = 64 and 128 take 2 and at W = 256 4."""
    counts = np.asarray(slot_counts, np.int64)
    slots = np.flatnonzero(counts)
    for cpl in GROUP_CPL:
        if 32 * cpl >= slots[-1] and int(
                (counts[slots] * group_lanes(slots, cpl)).sum()) <= \
                GROUP_MAX_LANES:
            return cpl
    return GROUP_CPL[-1]


def group_launch(t_lens, p_lens, ml: int, kw: int):
    """(cpl, max_slots, sort) of a lane-group launch of items of these
    lengths: group_cpl's slots a lane, the largest window_slots, and
    whether the items first go through the class and length sort (three
    small kernels), which pays wherever the items differ in p_len or in G
    at that CPL; a batch of one shape runs in index order."""
    t_lens = np.asarray(t_lens, np.int64)
    p_lens = np.asarray(p_lens, np.int64)
    if len(t_lens) == 0:
        return 1, 1, False
    slots = window_slots(t_lens, p_lens, ml, kw)
    max_slots = int(slots.max())
    cpl = group_cpl(np.bincount(slots))
    uniform = (p_lens.min() == p_lens.max() and group_lanes(
        slots.min(), cpl) == group_lanes(max_slots, cpl))
    return cpl, max_slots, not uniform


def band_stats(ref: torch.Tensor, reads: torch.Tensor, desc: torch.Tensor,
               ml: int, w: int, stats: bool = True,
               lengths=None) -> torch.Tensor:
    """Scores (row 0) and packed traceback counts (row 1) as an int32
    [2, n] tensor on the inputs' device, single-base and empty items
    fixed up.  CPU tensors take the plain version, CUDA tensors the
    kernel.  `lengths`, where given, are the items' (t_lens, p_lens) on
    the host, from which the lane-group kernel takes its launch's shape
    (group_launch); without them it holds the whole window and sorts."""
    if ref.device.type == "cuda":
        return band_stats_cuda(ref, reads, desc, ml, w, stats, lengths)
    if ref.device.type == "cpu":
        return band_stats_plain(ref, reads, desc, ml, w, stats)
    raise ValueError(f"no band kernel for device {ref.device}")


def _shift_up(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x'[w] = x[w+1], `fill` in the last cell."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x'[w] = x[w-1], `fill` in the first cell."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def band_stats_plain(ref: torch.Tensor, reads: torch.Tensor,
                     desc: torch.Tensor, ml: int, w: int,
                     stats: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the band kernel over [n, W] int32 state.

    Items are sorted by p_len, longest first, so the items still active at
    row i are a prefix: rows past an item's p_len never touch its state,
    which freezes it as the Pallas kernel's `active` mask does."""
    dev = ref.device
    n = int(desc.shape[1])
    out = torch.zeros((2, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    i32 = torch.int32
    order = torch.argsort(desc[3], descending=True, stable=True)
    t_off, p_off = desc[0][order], desc[2][order]
    tl = desc[1][order].to(i32)[:, None]
    pl = desc[3][order].to(i32)[:, None]
    pl_host = pl[:, 0].cpu().numpy()

    wl = torch.arange(w, dtype=i32, device=dev)[None, :]
    diff = tl - pl
    left = 5 + torch.clamp(-diff, min=0)
    right = 5 + torch.clamp(diff, min=0)
    w_final = (ml + diff)[:, 0]
    wband = (wl >= ml - left) & (wl <= ml + right)

    # row 0 in window coordinates (j = w - ML)
    j0 = (wl - ml).expand(n, w)
    inside = (j0 >= 1) & (j0 <= tl)
    m = torch.where(j0 == 0, 0, torch.where(inside, GO + j0 * GO, NEG_INF))
    e = torch.where(j0 == 0, 0,
                    torch.where(inside, GO + (pl + 1) * GO, NEG_INF))
    # boundary quirks of the reference walk: along the top row a delete
    # run costs j indels, plus one spurious insert when the insert matrix
    # dominates; an insert run reaching the top row costs one extra op
    pm = torch.where(j0 == 0, 0,
                     j0 * IU + torch.where(j0 * GE >= (pl + 1) * GO, 0, IU))
    pe = torch.where(j0 == 0, 0, (j0 + 1) * IU)
    m, e, pm, pe = (x.to(i32).contiguous() for x in (m, e, pm, pe))
    score = torch.full((n,), NEG_INF, dtype=i32, device=dev)
    statv = torch.zeros(n, dtype=i32, device=dev)
    w_idx = w_final.clamp(0, w - 1).long()[:, None]
    in_win = (w_final >= 0) & (w_final < w)

    neg_pl = -pl_host
    for i in range(1, int(pl_host[0]) + 1):
        k = int(np.searchsorted(neg_pl, -i, side="right"))  # p_len >= i
        k_next = int(np.searchsorted(neg_pl, -i - 1, side="right"))
        m_prev, e_prev = m[:k], e[:k]
        j = wl - ml + i
        col0 = j == 0
        in_text = (j >= 1) & (j <= tl[:k])
        t_idx = (t_off[:k, None] + (j - 1)).clamp(0, ref.numel() - 1)
        tb = torch.where(in_text, ref[t_idx].to(i32), 0)
        pb = reads[p_off[:k] + (i - 1)].to(i32)[:, None]
        sub = torch.where((tb == pb) | (tb == 4) | (pb == 4),
                          SCORE_MATCH, SCORE_MISMATCH).to(i32)
        in_band = wband[:k] & in_text
        m0_i = GO + i * GO
        start_le1 = left[:k] >= i - 1

        e_cur = _shift_up(torch.maximum(e_prev + GE, m_prev + (GO + GE)),
                          NEG_INF)
        e_cur = torch.where(col0, GO + i * GE, e_cur)
        h = torch.maximum(m_prev + sub, e_cur)
        h = torch.where(col0, m0_i, h)
        h = torch.where(in_band | (col0 & start_le1), h, NEG_INF)
        u = h - GE * j
        u = torch.where(col0, torch.where(start_le1, m0_i - GO, NEG_INF), u)
        f = GO + GE * j + _shift_down(torch.cummax(u, dim=1).values, NEG_INF)
        ibc = in_band | col0
        m_cur = torch.where(ibc, torch.maximum(h, f), NEG_INF)
        m_cur = torch.where(col0, m0_i, m_cur).to(i32)
        e_cur = torch.where(ibc, e_cur, NEG_INF).to(i32)

        if stats:
            pm_prev, pe_prev = pm[:k], pe[:k]
            su = torch.where(sub == SCORE_MATCH, MU, XU)
            open_e = _shift_up(m_prev, NEG_INF) + (GO + GE) == e_cur
            pe_cur = IU + torch.where(open_e, _shift_up(pm_prev, 0),
                                      _shift_up(pe_prev, 0))
            diag_ok = (m_prev + sub == m_cur) & (j >= 1) & ~col0
            pm_nof = torch.where(diag_ok, pm_prev + su, pe_cur)
            o = ((_shift_down(m_cur, NEG_INF) + (GO + GE) == f) & (j >= 1)
                 & ~col0) | col0
            # copy scan: the payload of the nearest open at or left of w
            # (keys are cell positions, so the running max is that cell)
            key = torch.where(o, wl, -1024)
            payload = torch.where(col0, i * IU, _shift_down(pm_nof, 0))
            kwin = torch.cummax(key, dim=1).values
            src = torch.where(kwin >= 0, kwin, wl).long()
            pf_cur = payload.gather(1, src) + (wl - kwin + 1) * IU
            pm_cur = torch.where(diag_ok, pm_prev + su,
                                 torch.where(f >= e_cur, pf_cur, pe_cur))
            pm_cur = torch.where(col0, i * IU, pm_cur).to(i32)
            pm[:k] = pm_cur
            pe[:k] = pe_cur.to(i32)
        m[:k] = m_cur
        e[:k] = e_cur

        # items whose last row this was report their final cell
        if k_next < k:
            fin = slice(k_next, k)
            ok = in_win[fin]
            s = m_cur[fin].gather(1, w_idx[fin])[:, 0]
            score[fin] = torch.where(ok, torch.clamp(s, min=NEG_INF), NEG_INF)
            if stats:
                p = pm[fin].gather(1, w_idx[fin])[:, 0]
                statv[fin] = torch.where(ok, torch.clamp(p, min=0), 0)

    # single-base and empty items
    tl1, pl1 = tl[:, 0], pl[:, 0]
    t0 = ref[t_off.clamp(0, ref.numel() - 1)].to(i32)
    p0 = reads[p_off.clamp(0, reads.numel() - 1)].to(i32)
    single = (tl1 == 1) & (pl1 == 1)
    eq = (t0 == p0) | (t0 == 4) | (p0 == 4)
    score = torch.where(single, torch.where(eq, SCORE_MATCH, SCORE_MISMATCH),
                        score)
    statv = torch.where(single, torch.where(eq, MU, XU), statv)
    empty = (tl1 == 0) | (pl1 == 0)
    out[0, order] = torch.where(empty, 0, score).to(i32)
    if stats:
        out[1, order] = torch.where(empty, 0, statv).to(i32)
    return out


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("band_stats")
    lib.t1k_band_order_ints.restype = ctypes.c_int
    lib.t1k_band_order_ints.argtypes = [ctypes.c_int]
    lib.t1k_band_stats.restype = ctypes.c_int
    lib.t1k_band_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def band_stats_cuda(ref: torch.Tensor, reads: torch.Tensor,
                    desc: torch.Tensor, ml: int, w: int,
                    stats: bool = True, lengths=None) -> torch.Tensor:
    """Launch csrc/band_stats.cu on the current stream of the inputs'
    device (no synchronisation); same result as band_stats_plain.  A
    window of at most 32 cells takes the thread kernels, a wider one the
    lane-group kernel, shaped by group_launch where `lengths` are given."""
    kw = kernel_window(w)
    if kw == 32:
        return _launch(ref, reads, desc, ml, w, stats, _PATH_THREAD)
    cpl, max_slots, sort = ((None, kw, True) if lengths is None
                            else group_launch(*lengths, ml, kw))
    return _band_stats_group_cuda(ref, reads, desc, ml, w, stats,
                                  max_slots=max_slots, cpl=cpl, sort=sort)


def _band_stats_group_cuda(ref: torch.Tensor, reads: torch.Tensor,
                           desc: torch.Tensor, ml: int, w: int,
                           stats: bool = True, max_slots: int = None,
                           cpl: int = None,
                           sort: bool = True) -> torch.Tensor:
    """The lane-group kernel at any window, W = 32 included, its items of
    at most `max_slots` slots (the window's where None) sorted by class
    and length or not; `cpl` forces its slots a lane (A/B timing and the
    card's tests), else group_cpl chooses them as if every item had
    max_slots slots."""
    kw = kernel_window(w)
    max_slots = kw if max_slots is None else int(max_slots)
    if not 1 <= max_slots <= kw:
        raise ValueError(f"max_slots {max_slots} outside 1..{kw}")
    if cpl is None:
        counts = np.zeros(max_slots + 1, np.int64)
        counts[max_slots] = max(int(desc.shape[1]), 1)
        cpl = group_cpl(counts)
    if cpl not in GROUP_CPL or 32 * cpl < max_slots:
        raise ValueError(f"{cpl} slots a lane cannot hold {max_slots} "
                         "slots in 32 lanes")
    return _launch(ref, reads, desc, ml, w, stats, _PATH_GROUP, cpl,
                   max_slots, int(bool(sort)))


def _band_stats_warp_cuda(ref: torch.Tensor, reads: torch.Tensor,
                          desc: torch.Tensor, ml: int, w: int,
                          stats: bool = True) -> torch.Tensor:
    """The first design's warp kernel at any window, W = 32 included: for
    timing it beside the kernels the route takes and for the card's tests
    only."""
    return _launch(ref, reads, desc, ml, w, stats, _PATH_WARP)


_COUNTED = {_PATH_WARP: "band_stats_warp", _PATH_THREAD: "band_stats",
            _PATH_GROUP: "band_stats_group"}


def _launch(ref, reads, desc, ml, w, stats, path: int, cpl: int = 0,
            max_slots: int = 0, sort: int = 0):
    """One launch of the thread kernels (counted as one "band_stats"), of
    the lane-group kernel or of the warp kernel."""
    dev = ref.device
    for name, x, dt in (("ref", ref, torch.int8), ("reads", reads, torch.int8),
                        ("desc", desc, torch.int64)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}")
    if desc.dim() != 2 or desc.shape[0] != 4:
        raise ValueError("desc must be [4, n]")
    if ml < 0:
        raise ValueError("ML must be >= 0")
    kw = kernel_window(w)
    n = int(desc.shape[1])
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _kernel_lib()
    # the item order: bin cursors, the split, perm [n]
    ordered = path == _PATH_THREAD or (path == _PATH_GROUP and sort)
    scratch = (torch.empty(lib.t1k_band_order_ints(path) + n,
                           dtype=torch.int32, device=dev) if ordered else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_band_stats(ref.data_ptr(), reads.data_ptr(),
                                desc.data_ptr(), n, ml, kw, int(stats), path,
                                cpl, max_slots, sort,
                                None if scratch is None
                                else scratch.data_ptr(),
                                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"band_stats kernel launch failed: CUDA error {rc}")
    launch_counts[_COUNTED[path]] += 1
    return out


def _pack_windows(t_codes, t_lens, p_codes, p_lens, device):
    """Flat code buffers plus descriptors for [n, L] byte windows."""
    t_codes = np.ascontiguousarray(t_codes, dtype=np.int8)
    p_codes = np.ascontiguousarray(p_codes, dtype=np.int8)
    t_lens = np.asarray(t_lens, np.int64)
    p_lens = np.asarray(p_lens, np.int64)
    n, lt = t_codes.shape
    lp = p_codes.shape[1]
    if len(t_lens) != n or len(p_lens) != n or p_codes.shape[0] != n:
        raise ValueError("window and length arrays disagree on n")
    if (t_lens < 0).any() or (t_lens > lt).any() or (p_lens < 0).any() \
            or (p_lens > lp).any():
        raise ValueError("lengths must lie within the window widths")
    desc = np.stack([np.arange(n, dtype=np.int64) * lt, t_lens,
                     np.arange(n, dtype=np.int64) * lp, p_lens])
    pad = np.zeros(SEQ_PAD, np.int8)
    dev = torch.device(device)
    return (torch.from_numpy(np.concatenate([t_codes.reshape(-1), pad])).to(dev),
            torch.from_numpy(np.concatenate([p_codes.reshape(-1), pad])).to(dev),
            torch.from_numpy(desc).to(dev))


def _window_class(t_lens, p_lens):
    """(ML, W) covering a batch: ML fits the longest pattern excess, W
    the longest text excess."""
    t_lens = np.asarray(t_lens, np.int64)
    p_lens = np.asarray(p_lens, np.int64)
    ml = 5 + max(0, int((p_lens - t_lens).max(initial=0)))
    return ml, int((t_lens - p_lens).max(initial=0))


def banded_scores_band(t_codes, t_lens, p_codes, p_lens,
                       device="cuda") -> np.ndarray:
    """Band-packed scores for [n, Lt] / [n, Lp] byte windows (int32 [n]);
    the window width adapts to the batch's length differences."""
    ml, over = _window_class(t_lens, p_lens)
    ref, reads, desc = _pack_windows(t_codes, t_lens, p_codes, p_lens, device)
    out = band_stats(ref, reads, desc, ml, band_window(ml, over), stats=False,
                     lengths=(t_lens, p_lens))
    return out[0].cpu().numpy()


def banded_stats_band(t_codes, t_lens, p_codes, p_lens, ml: int = None,
                      w: int = None, device="cuda"):
    """Scores plus match / mismatch / indel counts along the reference
    walk's traceback, by forward count propagation.  Returns four int32
    [n] arrays.  `ml` and `w` may widen the window beyond what the batch
    needs; narrower raises."""
    need_ml, over = _window_class(t_lens, p_lens)
    ml = need_ml if ml is None else ml
    if ml < need_ml:
        raise ValueError(f"ML {ml} < {need_ml} needed by the batch")
    need_w = band_window(ml, over)
    w = need_w if w is None else w
    if w < need_w:
        raise ValueError(f"window {w} < {need_w} needed by the batch")
    max_ops = int((np.asarray(t_lens, np.int64)
                   + np.asarray(p_lens, np.int64)).max(initial=0)) + 2
    if max_ops >= 512:
        raise ValueError("packed count fields overflow beyond 511 ops")
    ref, reads, desc = _pack_windows(t_codes, t_lens, p_codes, p_lens, device)
    out = band_stats(ref, reads, desc, ml, w,
                     lengths=(t_lens, p_lens)).cpu().numpy()
    packed = out[1]
    return out[0], packed & 511, (packed >> 9) & 511, (packed >> 18) & 511


def make_deferred_desc_service(device="cuda") -> "DeferredDescService":
    """The descriptor-mode scorer of NativeEngine.assign_batch_deferred
    on `device` (a CUDA card, or the CPU through the plain version)."""
    return DeferredDescService(device)


def make_deferred_stats_fn(device="cuda"):
    """stats_fn(t_codes, t_lens, p_codes, p_lens) -> match int32 for
    NativeEngine.assign_batch_deferred (window-bytes transport)."""

    def stats_fn(t_codes, t_lens, p_codes, p_lens):
        if len(t_lens) == 0:
            return np.zeros(0, np.int32)
        _, match, _, _ = banded_stats_band(t_codes, t_lens, p_codes, p_lens,
                                           device=device)
        return match.astype(np.int32)

    return stats_fn


class DeferredDescService:
    """Descriptor-mode scorer for NativeEngine.assign_batch_deferred.

    Holds the packed reference (per engine lifetime) and the current
    batch's doubled [fwd | rc] read tensor resident on `device`; each
    deferred item arrives as (t_off, t_len, p_off, p_len).  On a CUDA
    device `stats_async` launches one kernel per engine chunk and copies
    the match counts back without blocking, so the engine's two-slot
    pipelining overlaps host and card."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._ref = None
        self._ref_key = None
        self._ref_len = 0
        self._reads = None
        self._rev_idx = None
        self.items_scored = 0

    def set_ref(self, codes: np.ndarray) -> None:
        # content digest: a buffer address can alias a freed temporary
        key = (hashlib.blake2b(codes.tobytes(), digest_size=16).digest(),
               codes.shape[0])
        if self._ref_key == key:
            return
        buf = np.zeros(codes.shape[0] + SEQ_PAD, np.int8)
        buf[:codes.shape[0]] = codes
        self._ref = torch.from_numpy(buf).to(self.device)
        self._ref_key = key
        self._ref_len = int(codes.shape[0])

    def set_layout(self, read_starts: np.ndarray,
                   read_lens: np.ndarray) -> None:
        """Per-position reversal indices of the batch: position start + j
        of a read maps to start + len - 1 - j."""
        starts = np.asarray(read_starts, np.int64)
        lens = np.asarray(read_lens, np.int64)
        total = int(starts[-1] + lens[-1]) if len(lens) else 0
        rep_start = np.repeat(starts, lens)
        rep_len = np.repeat(lens, lens)
        self._rev_idx = 2 * rep_start + rep_len - 1 - np.arange(
            total, dtype=np.int64)

    def begin_batch(self, read_codes: np.ndarray) -> int:
        """Upload the batch's flat read codes and build [fwd | pad | rc |
        pad] on the device.  Returns the rc-half base the engine adds to
        reverse-complement pattern offsets."""
        total = int(read_codes.shape[0])
        if self._rev_idx is None or len(self._rev_idx) != total:
            raise ValueError("set_layout must describe this batch's reads")
        base = total + SEQ_PAD
        fwd = np.zeros(base, np.int8)
        fwd[:total] = read_codes
        fwd = torch.from_numpy(fwd).to(self.device)
        src = fwd[torch.from_numpy(self._rev_idx).to(self.device)]
        rc = torch.where(src < 4, 3 - src, src)
        self._reads = torch.cat(
            [fwd, rc, torch.zeros(SEQ_PAD, dtype=torch.int8,
                                  device=self.device)])
        return base

    def _check_items(self, desc: np.ndarray) -> None:
        t_off, t_len, p_off, p_len = desc
        if (t_len < 0).any() or (p_len < 0).any():
            raise ValueError("negative item length")
        if (np.abs(t_len - p_len) > DEFER_MAX_DIFF).any():
            raise ValueError(f"item |t_len - p_len| above {DEFER_MAX_DIFF}")
        if (t_len + p_len + 2 >= 512).any():
            raise ValueError("packed count fields overflow beyond 511 ops")
        if (t_off < 0).any() or (t_off + t_len > self._ref_len).any():
            raise ValueError("text window outside the reference")
        if (p_off < 0).any() or (p_off + p_len > self._reads.numel()).any():
            raise ValueError("pattern window outside the read tensor")

    def stats_async(self, t_off, t_len, p_off, p_len):
        """Start scoring the items and return a materializer for their
        match counts (int32 [n])."""
        n = len(t_len)
        if n == 0:
            zero = np.zeros(0, np.int32)
            return lambda: zero
        desc = np.stack([np.asarray(x, np.int64)
                         for x in (t_off, t_len, p_off, p_len)])
        self._check_items(desc)
        self.items_scored += n
        if self.device.type != "cuda":
            out = band_stats(self._ref, self._reads, torch.from_numpy(desc),
                             DESC_ML, DESC_W)
            match = (out[1].numpy() & 511).astype(np.int32)
            return lambda: match
        # Copies, kernel and read-back are ordered on one stream; PyTorch's
        # caching allocators hold the pinned input and the device buffers
        # until the stream has passed their last use.
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            dev_desc = torch.from_numpy(desc).pin_memory().to(
                self.device, non_blocking=True)
            out = band_stats(self._ref, self._reads, dev_desc, DESC_ML,
                             DESC_W)
            host_out = torch.empty(n, dtype=torch.int32, pin_memory=True)
            host_out.copy_(out[1], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)

        def collect() -> np.ndarray:
            done.synchronize()
            return host_out.numpy() & 511

        return collect

    def stats(self, t_off, t_len, p_off, p_len) -> np.ndarray:
        return self.stats_async(t_off, t_len, p_off, p_len)()
