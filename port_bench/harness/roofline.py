"""Peaks of one H100 SXM and the least time of the two kernels whose
rooflines the benchmark reports.  The arithmetic is the chip smoke
test's (`bound`, `dp_bound`, `probe_bound`), frozen here.

Peaks: NVIDIA's data sheet, SXM part: HBM3 at 3.35 TB/s; int32 issue
as 132 SMs x 64 INT32 lanes x 1,980 MHz, the card's boost clock (the
run prints nvidia-smi's clocks.sm and power.limit beside it)."""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SM_COUNT, INT32_LANES, SM_MHZ = 132, 64, 1980.0
INT32_PER_S = SM_COUNT * INT32_LANES * SM_MHZ * 1e6

# int32 operations per band cell with the traceback counts
# (band_stats.cu's STATS block): 12 for the DP terms kept apart, 16 for
# the counts away from column 0 (the smoke test's DP_STATS_OPS_PER_CELL)
DP_STATS_OPS_PER_CELL = 12 + 16
# bytes per deferred item besides its text and pattern: the int64
# descriptor (32) and the result words (8)
DESC_ITEM_BYTES = 40
# int32 operations per probe window and strand: rolling code, hash,
# compare and the scan's tests
PROBE_OPS_PER_WINDOW = 15


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float = INT32_PER_S):
    """The least time: the larger of bytes over the memory rate and
    operations over their peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def band_work(t_len, p_len):
    """(bytes, int32 operations) of a batch of deferred items: each
    item's text and pattern read once plus DESC_ITEM_BYTES, and
    DP_STATS_OPS_PER_CELL per band cell, the band 11 + |t_len - p_len|
    wide."""
    tl = np.asarray(t_len, np.int64)
    pl = np.asarray(p_len, np.int64)
    cells = int((pl * (11 + np.abs(tl - pl))).sum())
    return (int((tl + pl).sum()) + DESC_ITEM_BYTES * len(tl),
            DP_STATS_OPS_PER_CELL * cells)


def probe_work(codes: np.ndarray, lens: np.ndarray, k: int, direct: bool):
    """(bytes, int32 operations) of one probe launch on codes [R, L].
    Bytes: codes and lens in, contrib and cstart (int32 [R, 2W]) and tot
    out, and one table entry for each distinct valid window code of the
    chunk (starts[c] and starts[c+1] direct; key, hstart and hcount
    hashed)."""
    R, L = codes.shape
    W = L - k + 1
    c = codes.astype(np.int64)
    j = lens.astype(np.int64)[:, None] - 1 - np.arange(L)[None, :]
    rcb = np.take_along_axis(c, np.clip(j, 0, None), 1)
    rc = np.where(j >= 0, np.where(rcb < 4, 3 - rcb, rcb), 4)
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([c, rc]), k, axis=1)
    code = (np.minimum(win, 3) * 4 ** np.arange(k - 1, -1, -1)).sum(axis=2)
    distinct = np.unique(code[(win < 4).all(axis=2)]).size
    n_bytes = (codes.nbytes + 8 * R + 16 * R * W
               + distinct * (8 if direct else 12))
    return n_bytes, PROBE_OPS_PER_WINDOW * 2 * R * W
