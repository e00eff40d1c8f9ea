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
hand-written kernel ``csrc/align_full.cu`` and never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .align_band import GE, GO, NEG_INF, SCORE_MATCH, SCORE_MISMATCH

# Kernel launches, counted by the CUDA wrapper where it launches.
launch_counts = {"align_full": 0}

# The kernel keeps two rows of the band, m and e, in a ring of `ring`
# cells per warp in shared memory; the band of a pair spans
# 11 + |t_len - p_len| columns.
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
    lib.t1k_align_full.restype = ctypes.c_int
    lib.t1k_align_full.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def ring_cells(max_diff: int) -> int:
    """Ring size (a power of two) holding one DP row's band."""
    ring = 32
    while ring < 11 + max_diff + 1:
        ring *= 2
    if ring > MAX_RING:
        raise ValueError(f"|t_len - p_len| = {max_diff} exceeds the "
                         f"kernel's {MAX_RING}-cell ring")
    return ring


def banded_scores_cuda(tc: torch.Tensor, tl: torch.Tensor, pc: torch.Tensor,
                       pl: torch.Tensor, max_diff: int) -> torch.Tensor:
    """Launch csrc/align_full.cu on the current stream of the inputs'
    device (no synchronisation); same result as banded_scores_plain.
    `max_diff` bounds |t_len - p_len| over the batch."""
    dev = tc.device
    for name, x, dt in (("t_codes", tc, torch.int8), ("p_codes", pc, torch.int8),
                        ("t_lens", tl, torch.int32),
                        ("p_lens", pl, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}")
    n = int(tc.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    ring = ring_cells(max_diff)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_align_full(tc.data_ptr(), tl.data_ptr(), pc.data_ptr(),
                                pl.data_ptr(), n, int(tc.shape[1]),
                                int(pc.shape[1]), ring, out.data_ptr(),
                                stream)
    if rc != 0:
        raise RuntimeError(f"align_full kernel launch failed: CUDA error {rc}")
    launch_counts["align_full"] += 1
    return out


def banded_scores_full(t_codes, t_lens, p_codes, p_lens,
                       device="cuda") -> np.ndarray:
    """Counterpart of `banded_scores_pallas`: int32 scores [B] of byte
    windows t_codes [B, Lt], p_codes [B, Lp].  On a CUDA device the
    align_full kernel runs; on the CPU the plain version."""
    tc, tl, pc, pl = _as_tensors(t_codes, t_lens, p_codes, p_lens, device)
    if tc.device.type == "cuda":
        max_diff = int(np.abs(np.asarray(t_lens, np.int64)
                              - np.asarray(p_lens, np.int64)).max(initial=0))
        return banded_scores_cuda(tc, tl, pc, pl, max_diff).cpu().numpy()
    if tc.device.type == "cpu":
        return banded_scores_plain(tc, tl, pc, pl).numpy()
    raise ValueError(f"no v1 aligner for device {tc.device}")
