"""The v1 full-row banded aligner on torch tensors.

Counterpart of ``t1k_tpu/ops/align.py`` (``banded_scores``, the XLA
program) and ``t1k_tpu/ops/align_pallas.py`` (``banded_scores_pallas``,
the Pallas kernel).  Same scoring contract as the band-packed aligner in
``align_band.py`` and the native engine: banded affine-gap global
alignment, match +2, mismatch -2, gap open -4, gap extend -1, band 5
widened by |t_len - p_len|, code 4 = N matches anything, the reference's
boundary quirks kept.

``banded_scores`` is the plain PyTorch version: [B, Lt+1] rows, a loop
over read positions, and ``torch.cummax`` for the deletion chain, the
JAX formulation line for line.  ``banded_scores_full`` dispatches on the
device: CPU takes the plain version, a CUDA device launches the
hand-written kernels of ``csrc/align_full.cu`` and never falls back.
Each pair takes one of three paths by its register slots, decided on the
card (``v1_slots`` mirrors the rule):
one thread per pair (at most THREAD_SLOTS), one warp per pair with the
band in registers (at most TILE_SLOTS), or one warp per pair with the
band in a shared-memory ring.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .align_band import GE, GO, NEG_INF, SCORE_MATCH, SCORE_MISMATCH

# Kernel launches per path, counted by `banded_scores_cuda` where it
# launches them: one thread per pair, one warp per pair with the band in
# registers (both on every launch), one warp per pair with the band in a
# shared-memory ring (where the card's sort finds it pairs); and the pairs
# the sort put on each path.
PATHS = ("align_full_thread", "align_full_tile", "align_full_ring")
launch_counts = {path: 0 for path in PATHS}
path_pairs = {path: 0 for path in PATHS}
# Launches of the ring kernel alone on every pair (`banded_scores_ring_cuda`,
# the first port's launch, for A/B timing), kept apart from the paths'.
ring_alone_launches = {"align_full_ring_alone": 0}

# Register slots of the thread path (one thread per pair, NS slots each)
# and the tile path (32 lanes x CPL slots), a mirror of
# csrc/align_full.cu's thread_ns and tile_cpl, which decide on the card;
# a pair takes the smallest that holds its `v1_slots`.  Pairs past
# TILE_SLOTS take the ring path, two rows of m and e in a ring of `ring`
# cells per warp in shared memory (the band of a pair spans
# 11 + |t_len - p_len| columns).
THREAD_NS = (16, 20, 24, 28, 32)
TILE_CPL = (2, 3, 4, 5, 6, 8, 10, 12, 14, 16)
THREAD_SLOTS = THREAD_NS[-1]
TILE_SLOTS = 32 * TILE_CPL[-1]
MAX_RING = 8192


def _as_tensors(t_codes, t_lens, p_codes, p_lens, device):
    dev = torch.device(device)
    tc = torch.as_tensor(np.ascontiguousarray(t_codes, np.int8)).to(dev)
    pc = torch.as_tensor(np.ascontiguousarray(p_codes, np.int8)).to(dev)
    tl = torch.as_tensor(np.asarray(t_lens, np.int32)).to(dev)
    pl = torch.as_tensor(np.asarray(p_lens, np.int32)).to(dev)
    n = tc.shape[0]
    if tc.dim() != 2 or pc.dim() != 2 or pc.shape[0] != n \
            or tl.shape != (n,) or pl.shape != (n,):
        raise ValueError("t_codes [B, Lt], p_codes [B, Lp], lens [B]")
    tl_np, pl_np = np.asarray(t_lens), np.asarray(p_lens)
    if (tl_np < 0).any() or (tl_np > tc.shape[1]).any() or (pl_np < 0).any() \
            or (pl_np > pc.shape[1]).any():
        raise ValueError("lengths must lie within the window widths")
    return tc, tl, pc, pl


def banded_scores(t_codes, t_lens, p_codes, p_lens,
                  device="cuda") -> np.ndarray:
    """Plain PyTorch version of the v1 aligner: t_codes [B, Lt], p_codes
    [B, Lp] (pad values arbitrary), lens [B].  Returns int32 scores [B]."""
    tc, tl, pc, pl = _as_tensors(t_codes, t_lens, p_codes, p_lens, device)
    return banded_scores_plain(tc, tl, pc, pl).cpu().numpy()


def banded_scores_plain(tc: torch.Tensor, tl: torch.Tensor,
                        pc: torch.Tensor, pl: torch.Tensor) -> torch.Tensor:
    """`_banded_scores_impl` and `_row_step` of the JAX package on torch
    tensors of any device; int32 [B]."""
    dev = tc.device
    i32 = torch.int32
    B, Lt = tc.shape
    Lp = pc.shape[1]
    t = tc.to(i32)
    p = pc.to(i32)
    tl = tl.to(i32)
    pl = pl.to(i32)
    diff = tl - pl
    left = (5 + torch.clamp(-diff, min=0))[:, None]
    right = (5 + torch.clamp(diff, min=0))[:, None]
    cols = torch.arange(Lt + 1, dtype=i32, device=dev)[None, :]
    col0 = cols == 0
    tl_idx = tl.long()[:, None]

    m = ((GO + cols * GO) * (cols > 0)).to(i32).expand(B, Lt + 1).clone()
    # reference boundary quirk: e[0][j] = GO + (lenp+1)*GO for j >= 1
    e = torch.where(cols > 0, GO + (pl[:, None] + 1) * GO, 0).to(i32)
    neg = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    score = m.gather(1, tl_idx)[:, 0]

    for i in range(1, Lp + 1):
        pb = p[:, i - 1:i]
        sub = torch.where((t == pb) | (t == 4) | (pb == 4),
                          SCORE_MATCH, SCORE_MISMATCH).to(i32)
        e_cur = torch.maximum(e + GE, m + (GO + GE))
        e_cur = torch.where(col0, GO + i * GE, e_cur)
        diag = torch.cat([neg, m[:, :-1] + sub], dim=1)
        h = torch.maximum(diag, e_cur)
        m0 = GO + i * GO
        h = torch.where(col0, m0, h)
        start = torch.clamp(i - left, min=1)
        end = torch.minimum(i + right, tl[:, None])
        in_band = (cols >= start) & (cols <= end)
        h = torch.where(in_band | (col0 & (start <= 1)), h, NEG_INF)
        # F by an exclusive cumulative max of U = H' - GE*j; column 0
        # carries the f-boundary chain f[i][0] = GO + i*GO (folded via -GO)
        u = h - GE * cols
        u = torch.where(col0, torch.where(start <= 1, max(m0, m0 - GO),
                                          NEG_INF), u)
        cmax = torch.cummax(u, dim=1).values
        f = GO + GE * cols + torch.cat([neg, cmax[:, :-1]], dim=1)
        f = torch.where(col0, m0, f)
        ibc = in_band | col0
        m_cur = torch.where(ibc, torch.maximum(h, f), NEG_INF)
        m_cur = torch.where(col0, m0, m_cur)
        e_cur = torch.where(ibc, e_cur, NEG_INF)
        active = (i <= pl)[:, None]
        m = torch.where(active, m_cur, m).to(i32)
        e = torch.where(active, e_cur, e).to(i32)
        score = torch.where(i == pl, m.gather(1, tl_idx)[:, 0], score)

    # degenerate cases (reference AlignAlgo.hpp:217-236)
    if Lt and Lp:
        t0, p0 = t[:, 0], p[:, 0]
        single = (tl == 1) & (pl == 1)
        eq = (t0 == p0) | (t0 == 4) | (p0 == 4)
        score = torch.where(single, torch.where(eq, SCORE_MATCH,
                                                SCORE_MISMATCH), score)
    return torch.where((tl == 0) | (pl == 0), 0, score).to(i32)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("align_full")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.t1k_align_order_ints.restype = i32
    lib.t1k_align_order_ints.argtypes = []
    lib.t1k_align_full.restype = i32
    lib.t1k_align_full.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr,
                                   ptr, ptr, ptr]
    lib.t1k_align_full_ring.restype = i32
    lib.t1k_align_full_ring.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                        i32, ptr, ptr]
    return lib


def v1_slots(t_lens, p_lens) -> np.ndarray:
    """Register slots each pair needs (mirrors csrc/align_full.cu
    pair_slots, for splitting and checking batches by path): the
    band's 11 + |t_len - p_len| cells, the column-0 cell left of it and
    the row-0 cell right of it; an empty pair runs no rows and takes the
    smallest class."""
    tl = np.asarray(t_lens, np.int64)
    pl = np.asarray(p_lens, np.int64)
    return np.where((tl == 0) | (pl == 0), 13, 13 + np.abs(tl - pl))


class V1Plan(NamedTuple):
    """Pairs per path of one launch, as the launch's counting sort finds
    them on the card."""
    n_thread: int
    n_tile: int
    n_ring: int


def v1_plan(t_lens, p_lens) -> V1Plan:
    """Pairs per path by `v1_slots` (thread <= THREAD_SLOTS, tile <=
    TILE_SLOTS, ring above)."""
    slots = v1_slots(t_lens, p_lens)
    n_thread = int((slots <= THREAD_SLOTS).sum())
    n_ring = int((slots > TILE_SLOTS).sum())
    return V1Plan(n_thread, int(slots.size) - n_thread - n_ring, n_ring)


def ring_cells(max_diff: int) -> int:
    """Ring size (a power of two) holding one DP row's band."""
    ring = 32
    while ring < 11 + max_diff + 1:
        ring *= 2
    if ring > MAX_RING:
        raise ValueError(f"|t_len - p_len| = {max_diff} exceeds the "
                         f"kernel's {MAX_RING}-cell ring")
    return ring


def _check_inputs(tc, tl, pc, pl) -> None:
    dev = tc.device
    for name, x, dt in (("t_codes", tc, torch.int8), ("p_codes", pc, torch.int8),
                        ("t_lens", tl, torch.int32),
                        ("p_lens", pl, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}")


def banded_scores_cuda(tc: torch.Tensor, tl: torch.Tensor, pc: torch.Tensor,
                       pl: torch.Tensor) -> torch.Tensor:
    """Launch csrc/align_full.cu on the current stream of the inputs'
    device: the counting sort, both register paths, and the ring path
    where the sort finds it pairs (the host waits for the sort's counts,
    not for the kernels); same result as banded_scores_plain."""
    _check_inputs(tc, tl, pc, pl)
    dev = tc.device
    n = int(tc.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _kernel_lib()
    scratch = torch.empty(lib.t1k_align_order_ints() + n, dtype=torch.int32,
                          device=dev)
    paths = (ctypes.c_int64 * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_align_full(tc.data_ptr(), tl.data_ptr(), pc.data_ptr(),
                                pl.data_ptr(), n, int(tc.shape[1]),
                                int(pc.shape[1]), scratch.data_ptr(),
                                out.data_ptr(), paths, stream)
    if rc != 0:
        raise RuntimeError(f"align_full kernel launch failed: CUDA error {rc}")
    launch_counts["align_full_thread"] += 1
    launch_counts["align_full_tile"] += 1
    launch_counts["align_full_ring"] += int(paths[2] > 0)
    for path, count in zip(PATHS, paths):
        path_pairs[path] += count
    return out


def banded_scores_ring_cuda(tc: torch.Tensor, tl: torch.Tensor,
                            pc: torch.Tensor, pl: torch.Tensor,
                            max_diff: int) -> torch.Tensor:
    """The ring kernel alone on every pair, in their own order (the first
    port's launch, kept for A/B timing and the card tests; counted in
    `ring_alone_launches`); `max_diff` bounds |t_len - p_len| over the
    batch."""
    _check_inputs(tc, tl, pc, pl)
    dev = tc.device
    n = int(tc.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    ring = ring_cells(max_diff)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_lib().t1k_align_full_ring(
            tc.data_ptr(), tl.data_ptr(), pc.data_ptr(), pl.data_ptr(), n,
            int(tc.shape[1]), int(pc.shape[1]), ring, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"align_full kernel launch failed: CUDA error {rc}")
    ring_alone_launches["align_full_ring_alone"] += 1
    return out


def banded_scores_full(t_codes, t_lens, p_codes, p_lens,
                       device="cuda") -> np.ndarray:
    """Counterpart of `banded_scores_pallas`: int32 scores [B] of byte
    windows t_codes [B, Lt], p_codes [B, Lp].  On a CUDA device the
    align_full kernels run; on the CPU the plain version."""
    tc, tl, pc, pl = _as_tensors(t_codes, t_lens, p_codes, p_lens, device)
    if tc.device.type == "cuda":
        if tc.shape[0]:  # the ring holds the band: |diff| <= 8,180
            ring_cells(int(np.abs(np.asarray(t_lens, np.int64)
                                  - np.asarray(p_lens, np.int64)).max()))
        return banded_scores_cuda(tc, tl, pc, pl).cpu().numpy()
    if tc.device.type == "cpu":
        return banded_scores_plain(tc, tl, pc, pl).numpy()
    raise ValueError(f"no v1 aligner for device {tc.device}")
