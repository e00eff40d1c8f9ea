"""SQUAREM-accelerated EM on a torch device, in the native oracle's order.

Counterpart of the device EM of ``t1k_tpu/ops/em.py`` (``_em_loop_dense``
with ``_squarem_while`` and ``_make_mask_reset``), with the contract of
``t1k_tpu/native/em.cc`` (reference Genotyper.hpp:372-437, 1142-1328):
two EM updates, the SQUAREM extrapolation, one stabilizing update, L1
convergence below 1e-5 with one forced extra round, and the
every-10-rounds low-abundance major-allele mask.

Every floating-point sum runs in em.cc's order, so the f64 result is
bit-identical to the native loop.  That is what keeps the genotyper's
printed abundances byte-identical: on the H100, a dense-matvec E-step
(the JAX route's formulation, summed by cuBLAS) moved the sixth decimal
of HLA-scale abundances.  The incidence is kept as lists: per read group
its ECs (CSR, in the group's own order) and per EC its read groups (CSC,
ascending, the order in which em.cc's scatter reaches the EC).

CUDA tensors run the kernel ``csrc/em_squarem.cu`` (the whole loop in one
launch of one block, its vectors in shared memory when
``em_shared_bytes`` fits ``EM_SHARED_LIMIT``, else in device memory);
CPU tensors run ``squarem_plain``, the same order in PyTorch ops
(bit-exact in f64 on the CPU, whose cumsum is a sequential sum).  A
cohort of cells (``em_quantify_batched``, the counterpart of
``em_quantify_jax_batched``) runs the kernel's cohort form, one block per
cell of the cohort's share of the card's threads (``cohort_width``), its
lists staged in shared memory where they fit, one launch per (form,
width) class the cohort holds (``cohort_classes``), or
``squarem_batched_plain`` on the CPU; every cell gets the native loop's
bits; with a device list (``devices``) the cells are dealt to the
devices in contiguous blocks.
The host deals the kernel's read-group and EC lists to its threads
(``list_schedule``) in a warp-interleaved layout (``warp_lists``) and
lists each major allele's alleles (``major_lists``).

The sharded form (K13, driven by ``parallel/mesh.py`` and
``parallel/multihost.py``): ``shard_tables`` builds one read-group
shard's lists with a count per entry, ``estep_device`` puts them on a
device, ``estep_rows``, ``estep_terms`` and ``estep_fold`` run its
E-step passes (every entry's term at its column stream position, then
each EC's terms added in list order, going on from the previous shard's
partial counts), and ``tail_device`` / ``tail`` hold and run the round's
tail; each wrapper runs its plain version on CPU tensors.

The segment EM (K7, ``em_quantify_segment``) is the JAX package's
``_em_loop`` as tensor code: each E-step sum a cumsum difference over a
sorted incidence list.  It regroups em.cc's sums, so it is reached only
by name, never from ``auto`` or ``--emBackend``.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device

MASK_ROUND = 10
# The reference's dense-incidence budget (t1k_tpu/ops/em.py
# DENSE_EM_MAX_BYTES: int8 cells): past it the genotyper's "auto" EM
# takes the native loop.
DENSE_EM_MAX_CELLS = 4 << 30
# The kernel's block (em_squarem.cu kThreads) and the dynamic shared
# memory its shared-memory form may ask for: an H100 block's 232,448
# opt-in bytes, less room for the kernel's static shared scalars.
EM_THREADS = 1024
EM_SHARED_LIMIT = 232_448 - 1_024
# The cohort form's block widths (squarem_batched_kernel's kW) and its
# cell forms (em_squarem.cu Form): vectors and lists in device memory,
# the vectors in shared memory, the lists there too (staged)
COHORT_WIDTHS = (32, 64, 128, 256, 512, 1024)
DEVICE_FORM, SHARED_FORM, STAGED_FORM = 0, 1, 2
# Threads an SM holds of the shared-memory forms (64 registers a thread)
# and the widest block cohort_width gives; an H100's SMs
COHORT_SM_THREADS, COHORT_MAX_WIDTH, H100_SMS = 1024, 512, 132
# The profiled kernel's clock counts: these phases, then the total.
EM_PHASES = ("csr", "csc", "norm", "alpha", "diff", "mask")

# The sharded form's E-step block (em_squarem.cu kEstepThreads): its
# lists are dealt in one turn of this many threads, rounded up.
ESTEP_THREADS = 256

# Kernel launches, counted by the CUDA wrappers where they launch: the
# single-problem and cohort forms, and the sharded form's row pass, term
# pass, column fold and round tail.
launch_counts = {"em_squarem": 0, "em_squarem_batched": 0,
                 "em_sharded_rows": 0, "em_sharded_terms": 0,
                 "em_sharded_fold": 0, "em_sharded_tail": 0}
# The sharded E-step's kernels on the main path (parallel/mesh.py,
# multihost.py), one update's launches per shard.
ESTEP_KERNELS = ("em_sharded_rows", "em_sharded_terms", "em_sharded_fold")
# Launches of the first design's fused column pass alone
# (`estep_cols_fused_cuda`, for A/B timing), kept apart from the path's.
fused_launches = {"em_sharded_fused": 0}
# The cohort form's per-cell row (t1k_em_squarem_cells): ec_cnt, rg_cnt,
# the rows' and the columns' slot counts and stream lengths, then the
# cell's offsets into the kernel's 17 inputs and 11 scratch buffers.
_CELL_DIMS, _INS, _SCRATCH = 6, 17, 11


def em_shared_bytes(rg_cnt: int, ec_cnt: int, itemsize: int) -> int:
    """Dynamic shared memory of the kernel's shared-memory form: per read
    group its psum and count, per EC x0-x3, count, per_len and the
    shortest effective length."""
    return (2 * rg_cnt + 7 * ec_cnt) * itemsize


def staged_bytes(rg_cnt: int, ec_cnt: int, itemsize: int, rows: dict,
                 cols: dict) -> int:
    """Dynamic shared memory of the cohort form's staged form: the
    vectors (em_shared_bytes, to a multiple of 8), then per pass its
    warp_lists' base, sched, len and stream, each pass to a multiple of
    8 (em_squarem.cu staged_list_bytes), then a CSC term per position of
    the columns' stream."""
    def align8(n):
        return -(-n // 8) * 8
    return align8(em_shared_bytes(rg_cnt, ec_cnt, itemsize)) + sum(
        align8(8 * len(l["base"]) + 4 * (2 * len(l["sched"])
                                         + len(l["stream"])))
        for l in (rows, cols)) + itemsize * len(cols["stream"])


def cohort_width(n_cells: int, sms: int = H100_SMS) -> int:
    """The cohort form's block for each cell of a cohort of `n_cells`:
    the cell's share of the threads the card holds at once
    (COHORT_SM_THREADS on each of `sms` SMs), rounded down to a power of
    two from 32 to COHORT_MAX_WIDTH.  A cell's round is a chain of
    latencies that more threads shorten (the CSC terms' divides, the CSR
    turns), so a cohort that fits the card in one wave gives each cell
    all it can: on an H100, 384 cells of 600 x 48 ran fastest at 256-512
    threads and slowest at 32-64 (PERF.md), 96 small cells at 512."""
    share = COHORT_SM_THREADS * sms // max(n_cells, 1)
    return min(COHORT_MAX_WIDTH, max(32, 1 << max(share.bit_length() - 1, 0)))


def list_schedule(off, threads: int = EM_THREADS) -> np.ndarray:
    """CSR lists (read groups' ECs or ECs' read groups) dealt to the
    kernel's threads: slot k * threads + t holds the list thread t folds
    in its k-th turn, or -1.  Lists are dealt longest first in a snake
    (turn k left to right when k is even, right to left when odd), so the
    threads that took the longest lists in one turn take the shortest of
    the next, and a warp's 32 lists are of about one length."""
    lens = np.diff(np.asarray(off, np.int64))
    order = np.argsort(-lens, kind="stable").astype(np.int32)
    turns = -(-len(order) // threads)
    sched = np.full(turns * threads, -1, np.int32)
    sched[:len(order)] = order
    sched = sched.reshape(turns, threads)
    sched[1::2] = sched[1::2, ::-1]
    return sched.ravel()


def warp_lists(off, idx, threads: int = EM_THREADS) -> dict:
    """CSR lists as the kernel's threads walk them: `sched` (slot k *
    threads + t: the list thread t folds in its k-th turn, or -1, from
    list_schedule) and `len` per slot; the 32 slots of a warp share a
    block of `stream` starting at `base[slot // 32]`, element j of lane
    l's list at base + 32 * j + l (block height: the warp's longest
    list), so a warp's loads are coalesced."""
    off = np.asarray(off, np.int64)
    sched = list_schedule(off, threads)
    lens = np.where(sched >= 0, np.diff(off)[np.maximum(sched, 0)], 0)
    height = lens.reshape(-1, 32).max(axis=1)
    base = np.zeros(len(height), np.int64)
    np.cumsum(32 * height[:-1], out=base[1:])
    stream = np.zeros(max(int(32 * height.sum()), 1), np.int32)
    slots = np.nonzero(lens)[0]
    n = lens[slots]
    rep = np.repeat(slots, n)
    j = np.arange(len(rep)) - np.repeat(np.cumsum(n) - n, n)
    stream[base[rep // 32] + 32 * j + rep % 32] = np.asarray(idx)[
        np.repeat(off[sched[slots]], n) + j]
    return dict(sched=sched, len=lens.astype(np.int32), base=base,
                stream=stream)


def major_lists(allele_major, major_cnt: int):
    """Per major allele its alleles, ascending (CSR): the order em.cc's
    major sums reach them."""
    allele_major = np.asarray(allele_major, np.int64)
    maj_off = np.zeros(major_cnt + 1, np.int64)
    np.cumsum(np.bincount(allele_major, minlength=major_cnt),
              out=maj_off[1:])
    return maj_off, np.argsort(allele_major, kind="stable").astype(np.int32)


def em_tables(ec_to_alleles, rg_ecs_csr, rg_counts, allele_eff_len,
              allele_weight, allele_gene, allele_major, n_genes: int,
              n_majors: int) -> dict:
    """Host tables of one EM problem, as squarem_cuda and squarem_plain
    take them: the incidence both ways, then ec_tables' EC tables."""
    ec = ec_tables(ec_to_alleles, allele_eff_len, allele_weight, allele_gene,
                   allele_major, n_genes, n_majors)
    rg_off = np.asarray(rg_ecs_csr[0], np.int64)
    rg_ecs = np.asarray(rg_ecs_csr[1], np.int32)
    col_off, col_rgs = incidence_lists(rg_off, rg_ecs, len(ec_to_alleles))
    if len(rg_off) != len(rg_counts) + 1:
        raise ValueError("read-group offsets and counts disagree")
    return dict(rg_off=rg_off, rg_ecs=rg_ecs,
                rg_counts=np.asarray(rg_counts, np.float64),
                col_off=col_off, col_rgs=col_rgs, **ec)


def ec_tables(ec_to_alleles, allele_eff_len, allele_weight, allele_gene,
              allele_major, n_genes: int, n_majors: int) -> dict:
    """The EC -> alleles CSR, each EC's shortest effective length, the
    allele-weight initial abundance and the mask's allele tables."""
    ec_cnt = len(ec_to_alleles)
    ec_off = np.zeros(ec_cnt + 1, dtype=np.int64)
    ec_off[1:] = np.cumsum([len(a) for a in ec_to_alleles])
    if (np.diff(ec_off) == 0).any():
        raise ValueError("empty equivalence class")
    ec_alleles = np.fromiter(itertools.chain.from_iterable(ec_to_alleles),
                             dtype=np.int32, count=int(ec_off[-1]))
    allele_gene = np.asarray(allele_gene, np.int64)
    allele_major = np.asarray(allele_major, np.int64)
    allele_cnt = len(allele_gene)
    if not (len(allele_eff_len) == len(allele_weight) == len(allele_major)
            == allele_cnt):
        raise ValueError("per-allele arrays differ in length")
    for name, v, n in (("EC allele", ec_alleles, allele_cnt),
                       ("gene", allele_gene, n_genes),
                       ("major allele", allele_major, n_majors)):
        if len(v) and (v.min() < 0 or v.max() >= n):
            raise ValueError(f"{name} index out of range")
    return dict(
        ec_off=ec_off, ec_alleles=ec_alleles,
        ec_len=np.minimum.reduceat(
            np.asarray(allele_eff_len, np.int64)[ec_alleles],
            ec_off[:-1]).astype(np.float64),
        allele_gene=allele_gene, allele_major=allele_major,
        # integer sums, exact in f64 as em.cc's running double sum is
        init_x=np.add.reduceat(np.asarray(allele_weight, np.int64)[ec_alleles],
                               ec_off[:-1]).astype(np.float64),
        gene_cnt=n_genes, major_cnt=n_majors)


def incidence_lists(rg_off, rg_ecs, ec_cnt: int):
    """Per-EC read groups, ascending (CSC), from the per-read-group EC
    lists (CSR).  Each (read group, EC) pair must appear once: a repeat
    would count the group twice for that EC."""
    rg_off = np.asarray(rg_off, np.int64)
    rg_ecs = np.asarray(rg_ecs, np.int64)
    rg_cnt = len(rg_off) - 1
    if len(rg_ecs) and (rg_ecs.min() < 0 or rg_ecs.max() >= ec_cnt):
        raise ValueError("EC index out of range in the read-group lists")
    seg_rg = np.repeat(np.arange(rg_cnt, dtype=np.int64), np.diff(rg_off))
    # stable: read groups stay ascending within an EC (16-bit keys take
    # numpy's radix sort)
    keys = rg_ecs.astype(np.uint16) if ec_cnt <= 1 << 16 else rg_ecs
    perm = np.argsort(keys, kind="stable")
    col_off = np.zeros(ec_cnt + 1, dtype=np.int64)
    np.cumsum(np.bincount(rg_ecs, minlength=ec_cnt), out=col_off[1:])
    col_rgs, col_ecs = seg_rg[perm], rg_ecs[perm]
    # a repeated pair is one read group twice in a row within one EC
    if ((col_rgs[1:] == col_rgs[:-1]) & (col_ecs[1:] == col_ecs[:-1])).any():
        raise ValueError("duplicate (read group, EC) pair in the incidence")
    return col_off, col_rgs.astype(np.int32)


def _padded(off: np.ndarray, idx: np.ndarray, pad: int) -> np.ndarray:
    """CSR -> [rows, longest row] index matrix, short rows filled with
    `pad` (an index whose contribution is an exact zero)."""
    lens = np.diff(off)
    out = np.full((len(lens), int(lens.max(initial=0))), pad, np.int64)
    rows = np.repeat(np.arange(len(lens)), lens)
    out[rows, np.arange(len(idx)) - np.repeat(off[:-1], lens)] = idx
    return out


def _seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum.  On the CPU, torch's cumsum is sequential, and
    exact in f64; it accumulates f32 in f64, so f32 sums round once."""
    if v.numel() == 0:
        return torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.cumsum(v, 0)[-1]


def plain_mask(ec_len, ec_off, ec_alleles, allele_gene, allele_major,
               gene_cnt: int, major_cnt: int, filter_frac: float, device,
               dtype):
    """em.cc's maskAndReset in PyTorch ops: count -> the next x0 (the
    major-allele sums a left-to-right chain of tensor adds)."""
    ec_cnt, allele_cnt = len(ec_len), len(allele_gene)

    def put(x, dt):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    i64 = torch.int64
    maj_off, order = major_lists(allele_major, major_cnt)
    maj_alleles = put(_padded(maj_off, order, allele_cnt), i64)  # [M, Lm]
    ec_len_t, ec_size_t = put(ec_len, dtype), put(np.diff(ec_off), dtype)
    ec_first = put(ec_alleles[ec_off[:-1]], i64)
    ec_of_allele = put(np.repeat(np.arange(ec_cnt), np.diff(ec_off)), i64)
    ec_alleles_t = put(ec_alleles, i64)
    gene_t, major_t = put(allele_gene, i64), put(allele_major, i64)

    def mask_reset(count):
        ec_abund = count / ec_len_t * 1000.0
        allele_abund = torch.zeros(allele_cnt + 1, dtype=dtype, device=device)
        allele_ec_abund = torch.zeros(allele_cnt, dtype=dtype, device=device)
        allele_abund[ec_alleles_t] = (ec_abund / ec_size_t)[ec_of_allele]
        allele_ec_abund[ec_alleles_t] = ec_abund[ec_of_allele]
        g = allele_abund[maj_alleles]
        major_abund = torch.zeros(major_cnt, dtype=dtype, device=device)
        for k in range(g.shape[1]):
            major_abund = major_abund + g[:, k]
        per_allele = major_abund[major_t]
        gene_max = torch.zeros(gene_cnt, dtype=dtype, device=device)
        gene_max = gene_max.scatter_reduce(0, gene_t, per_allele, "amax")
        masked = per_allele < filter_frac * 0.5 * gene_max[gene_t]
        return torch.where(masked, 0.0, allele_ec_abund)[ec_first]

    return mask_reset


def plain_extrapolate(x0, x1, x2, min_squarem_alpha: float):
    """em.cc's SQUAREM extrapolation x3 of x0, x1, x2 in PyTorch ops."""
    dtype = x0.dtype
    r = x1 - x0
    v = x2 - 2 * x1 + x0
    # alpha's square roots on the host: torch's CPU sqrt of a 0-dim
    # tensor is not always correctly rounded; em.cc's std::sqrt and the
    # kernel's sqrt are
    ft = np.float64 if dtype == torch.float64 else np.float32
    sum_r = ft(_seq_sum(r * r).item())
    sum_v = ft(_seq_sum(v * v).item())
    a = ft(-1.0) if sum_v == 0 else -np.sqrt(sum_r) / np.sqrt(sum_v)
    if min_squarem_alpha < 0 and float(a) < min_squarem_alpha:
        a = ft(min_squarem_alpha)
    alpha = torch.tensor(a, dtype=dtype, device=x0.device)
    return x0 - 2 * alpha * (x1 - x0) + alpha * alpha * (x2 - 2 * x1 + x0)


def squarem_plain(rg_off, rg_ecs, rg_counts, col_off, col_rgs, ec_off,
                  ec_alleles, ec_len, allele_gene, allele_major, init_x,
                  gene_cnt: int, major_cnt: int, filter_frac: float,
                  min_squarem_alpha: float, max_iterations: int,
                  device, dtype) -> Tuple[int, torch.Tensor]:
    """Plain PyTorch version of csrc/em_squarem.cu: em.cc's loop with each
    order-sensitive sum written as a left-to-right chain of tensor adds."""
    ec_cnt = len(ec_len)

    def put(x, dt):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    # the sharded form's plain passes, one shard of every read group
    est = plain_estep_tables(dict(
        row_off=rg_off, row_ecs=rg_ecs, col_off=col_off, col_rows=col_rgs,
        col_cts=np.asarray(rg_counts, np.float64)[col_rgs], ec_cnt=ec_cnt),
        device, dtype)
    ec_len_t = put(ec_len, dtype)
    mask_reset = plain_mask(ec_len, ec_off, ec_alleles, allele_gene,
                            allele_major, gene_cnt, major_cnt, filter_frac,
                            device, dtype)

    def em_update(x):
        count = torch.empty(ec_cnt, dtype=dtype, device=device)
        estep_rows_plain(est, x)
        estep_cols_plain(est, x, count, carry=False)
        per_len = count / ec_len_t
        return per_len / _seq_sum(per_len), count

    x0 = put(init_x, dtype)
    count = torch.zeros(ec_cnt, dtype=dtype, device=device)
    iters = 0
    t = 0
    while t < max_iterations:
        iters += 1
        x1, _ = em_update(x0)
        x2, _ = em_update(x1)
        x3 = plain_extrapolate(x0, x1, x2, min_squarem_alpha)
        x1b, count = em_update(x3)
        diff = float(_seq_sum(torch.abs(x1b - x0)))  # the round's host sync
        x0 = x1b
        if diff < 1e-5 and t < max_iterations - 2:
            t = max_iterations - 2
        if t > 0 and t % MASK_ROUND == 0:
            x0 = mask_reset(count)
        t += 1
    return iters, count


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load

    return bind_kernel_lib(load("em_squarem"))


def bind_kernel_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/em_squarem.cu) with its C interface's
    argument and result types set."""
    lib.t1k_em_squarem.restype = ctypes.c_int
    lib.t1k_em_squarem.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.t1k_em_squarem_cells.restype = None
    lib.t1k_em_squarem_cells.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.t1k_em_squarem_cell_bytes.restype = ctypes.c_int64
    lib.t1k_em_squarem_cell_bytes.argtypes = [ctypes.c_int]
    lib.t1k_em_squarem_batched.restype = ctypes.c_int
    lib.t1k_em_squarem_batched.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.t1k_em_squarem_batched_attrs.restype = ctypes.c_int
    lib.t1k_em_squarem_batched_attrs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p]
    lib.t1k_em_sharded_estep.restype = ctypes.c_int
    lib.t1k_em_sharded_estep.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.t1k_em_sharded_tail.restype = ctypes.c_int
    lib.t1k_em_sharded_tail.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.t1k_em_clock_probe.restype = ctypes.c_int
    lib.t1k_em_clock_probe.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def squarem_device(rg_off, rg_ecs, rg_counts, col_off, col_rgs, ec_off,
                   ec_alleles, ec_len, allele_gene, allele_major, init_x,
                   gene_cnt: int, major_cnt: int, device, dtype,
                   shared=None) -> dict:
    """One EM problem on a CUDA device for csrc/em_squarem.cu: the kernel's
    inputs (the warp_lists of both passes, the major -> alleles lists),
    its scratch and outputs, and the instantiation it takes.  `shared`
    None picks the shared-memory form when em_shared_bytes fits
    EM_SHARED_LIMIT; True or False forces one (True raises if it does
    not fit)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported EM dtype {dtype}")
    ec_cnt, rg_cnt = len(ec_len), len(rg_counts)
    allele_cnt = len(allele_gene)
    itemsize = torch.finfo(dtype).bits // 8
    fits = em_shared_bytes(rg_cnt, ec_cnt, itemsize) <= EM_SHARED_LIMIT
    if shared is None:
        shared = fits
    elif shared and not fits:
        raise ValueError("EM problem does not fit in shared memory")

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=device, dtype=dt).contiguous()

    def buf(n):
        return torch.empty(max(n, 1), dtype=dtype, device=device)

    i32, i64 = torch.int32, torch.int64
    maj_off, maj_alleles = major_lists(allele_major, major_cnt)
    rows = warp_lists(rg_off, rg_ecs, EM_THREADS)
    cols = warp_lists(col_off, col_rgs, EM_THREADS)
    ins = [put(lists[k], dt) for lists in (rows, cols) for k, dt in (
        ("sched", i32), ("len", i32), ("base", i64), ("stream", i32))]
    ins += [put(rg_counts, dtype), put(ec_off, i64), put(ec_alleles, i32),
            put(ec_len, dtype), put(allele_gene, i32),
            put(allele_major, i32), put(maj_off, i64),
            put(maj_alleles, i32), put(init_x, dtype)]
    # the shared form keeps x0-x3, the (psum, count) pairs and per_len
    # on the chip
    vec = 0 if shared else 1
    scratch = [buf(vec * ec_cnt) for _ in range(4)] + [
        buf(ec_cnt), buf(vec * 2 * rg_cnt), buf(vec * ec_cnt),
        buf(allele_cnt), buf(allele_cnt), buf(major_cnt), buf(gene_cnt)]
    dims = (ctypes.c_int64 * 8)(ec_cnt, allele_cnt, gene_cnt, major_cnt,
                                rg_cnt, 0, len(rows["sched"]),
                                len(cols["sched"]))
    return dict(ins=ins, scratch=scratch, dims=dims, shared=bool(shared),
                dtype=dtype, device=torch.device(device),
                iterations=torch.zeros(1, dtype=i32, device=device),
                count=scratch[4][:ec_cnt])


def squarem_launch(em_dev: dict, filter_frac: float,
                   min_squarem_alpha: float, max_iterations: int,
                   cycles=None) -> None:
    """Launch csrc/em_squarem.cu once on a problem from squarem_device, on
    the current stream, without waiting: em_dev["iterations"] and
    em_dev["count"] hold the result once the stream has run it.
    `cycles`, an int64 CUDA tensor of EM_PHASES + 1, selects the profiled
    instantiation and receives its per-phase clock counts."""
    lib = _kernel_lib()
    ins, scratch = em_dev["ins"], em_dev["scratch"]
    em_dev["dims"][5] = max_iterations
    dev = em_dev["device"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t1k_em_squarem(
            (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins]),
            (ctypes.c_void_p * len(scratch))(*[t.data_ptr()
                                               for t in scratch]),
            em_dev["dims"], float(filter_frac), float(min_squarem_alpha),
            int(em_dev["dtype"] == torch.float64), int(em_dev["shared"]),
            em_dev["iterations"].data_ptr(),
            None if cycles is None else cycles.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"em_squarem kernel launch failed: CUDA error {rc}")
    launch_counts["em_squarem"] += 1


def squarem_cuda(rg_off, rg_ecs, rg_counts, col_off, col_rgs, ec_off,
                 ec_alleles, ec_len, allele_gene, allele_major, init_x,
                 gene_cnt: int, major_cnt: int, filter_frac: float,
                 min_squarem_alpha: float, max_iterations: int, device,
                 dtype, shared=None) -> Tuple[int, torch.Tensor]:
    """Upload one problem and launch csrc/em_squarem.cu once for the whole
    loop; same result as squarem_plain on the CPU, bit for bit.  `shared`
    as squarem_device takes it."""
    em_dev = squarem_device(rg_off, rg_ecs, rg_counts, col_off, col_rgs,
                            ec_off, ec_alleles, ec_len, allele_gene,
                            allele_major, init_x, gene_cnt, major_cnt,
                            device, dtype, shared)
    squarem_launch(em_dev, filter_frac, min_squarem_alpha, max_iterations)
    return int(em_dev["iterations"].item()), em_dev["count"]


def squarem_batched_plain(cells: List[dict], filter_frac: float,
                          min_squarem_alpha: float, max_iterations: int,
                          device, dtype) -> List[Tuple[int, torch.Tensor]]:
    """Plain PyTorch version of the kernel's cohort form: squarem_plain on
    each cell's em_tables in turn."""
    return [squarem_plain(**t, filter_frac=filter_frac,
                          min_squarem_alpha=min_squarem_alpha,
                          max_iterations=max_iterations, device=device,
                          dtype=dtype) for t in cells]


def batched_tables(cells: List[dict], itemsize: int, width=None,
                   stage: bool = True, sms: int = H100_SMS) -> dict:
    """Host half of the kernel's cohort form, for a cohort of EM problems
    (each cell's em_tables; one reference).  Each of the kernel's 17
    inputs concatenated over the cells (`ins`; the reference tables
    allele_gene, allele_major and the major -> alleles lists once),
    `rows`: per cell its ec_cnt, rg_cnt, the rows' and the columns' slot
    counts and stream lengths and its offsets into the 17 inputs and the
    11 scratch buffers (t1k_em_squarem_cells' layout), `scratch`: each
    buffer's length, `width`: per cell its block, cohort_width of the
    cohort on `sms` SMs or the forced `width` (one of COHORT_WIDTHS), at
    which both its passes' lists are dealt, and per cell its `form` and
    the shared `bytes` that
    form takes: STAGED_FORM where staged_bytes fits EM_SHARED_LIMIT
    (unless `stage` is False), else SHARED_FORM where em_shared_bytes
    does, else DEVICE_FORM (0 bytes)."""
    if width is not None and width not in COHORT_WIDTHS:
        raise ValueError(f"cohort width {width} is not one of "
                         f"{COHORT_WIDTHS}")
    ref = cells[0]
    for t in cells[1:]:
        if not (np.array_equal(t["allele_gene"], ref["allele_gene"])
                and np.array_equal(t["allele_major"], ref["allele_major"])
                and (t["gene_cnt"], t["major_cnt"])
                == (ref["gene_cnt"], ref["major_cnt"])):
            raise ValueError("the cells of a cohort share one reference")
    allele_cnt = len(ref["allele_gene"])
    gene_cnt, major_cnt = ref["gene_cnt"], ref["major_cnt"]
    maj_off, maj_alleles = major_lists(ref["allele_major"], major_cnt)
    common = {12: ref["allele_gene"], 13: ref["allele_major"], 14: maj_off,
              15: maj_alleles}
    parts = [[] for _ in range(_INS)]
    filled = np.zeros(_INS, np.int64)
    sizes = np.zeros((len(cells), _SCRATCH), np.int64)
    rows = np.zeros((len(cells), _CELL_DIMS + _INS + _SCRATCH), np.int64)
    forms = np.zeros(len(cells), np.int64)
    nbytes = np.zeros(len(cells), np.int64)
    widths = np.full(len(cells), width or cohort_width(len(cells), sms),
                     np.int64)
    for b, t in enumerate(cells):
        ec_cnt, rg_cnt = len(t["ec_len"]), len(t["rg_counts"])
        csr = warp_lists(t["rg_off"], t["rg_ecs"], int(widths[b]))
        csc = warp_lists(t["col_off"], t["col_rgs"], int(widths[b]))
        for form, n in ((STAGED_FORM, staged_bytes(rg_cnt, ec_cnt, itemsize,
                                                   csr, csc) if stage
                         else EM_SHARED_LIMIT + 1),
                        (SHARED_FORM, em_shared_bytes(rg_cnt, ec_cnt,
                                                      itemsize)),
                        (DEVICE_FORM, 0)):
            if n <= EM_SHARED_LIMIT:
                forms[b], nbytes[b] = form, n
                break
        own = [lists[k] for lists in (csr, csc)
               for k in ("sched", "len", "base", "stream")]
        own += [t["rg_counts"], t["ec_off"], t["ec_alleles"], t["ec_len"],
                None, None, None, None, t["init_x"]]
        rows[b, :_CELL_DIMS] = (ec_cnt, rg_cnt, len(csr["sched"]),
                                len(csc["sched"]), len(csr["stream"]),
                                len(csc["stream"]))
        for k, a in enumerate(own):
            if a is not None:
                rows[b, _CELL_DIMS + k] = filled[k]
                filled[k] += len(a)
                parts[k].append(a)
        # the shared forms keep x0-x3, the (psum, count) pairs and per_len
        # on the chip
        vec = int(forms[b] == DEVICE_FORM)
        sizes[b] = [vec * ec_cnt] * 4 + [ec_cnt, vec * 2 * rg_cnt,
                                         vec * ec_cnt, allele_cnt,
                                         allele_cnt, major_cnt, gene_cnt]
    np.cumsum(sizes[:-1], axis=0, out=rows[1:, _CELL_DIMS + _INS:])
    return dict(
        ins=[common[k] if k in common else np.concatenate(parts[k])
             for k in range(_INS)],
        rows=rows, scratch=sizes.sum(axis=0), form=forms, bytes=nbytes,
        width=widths,
        common=np.array([allele_cnt, gene_cnt, major_cnt], np.int64))


def cohort_classes(host: dict) -> List[Tuple[int, int, np.ndarray]]:
    """The launches of a cohort from batched_tables: per (form, width)
    class its form, width and cells (ascending), widest first and, at
    one width, the device-memory form first."""
    keys = sorted({(int(w), int(f)) for w, f in zip(host["width"],
                                                    host["form"])},
                  key=lambda k: (-k[0], k[1]))
    return [(f, w, np.nonzero((host["width"] == w) & (host["form"] == f))[0])
            for w, f in keys]


def squarem_batched_device(cells: List[dict], device, dtype, width=None,
                           stage: bool = True) -> dict:
    """A cohort of EM problems on a CUDA device for the cohort form of
    csrc/em_squarem.cu: batched_tables' concatenations uploaded once per
    kind of array, the scratch allocated once per kind, and per launch
    (one per cohort_classes class) the per-cell structs
    t1k_em_squarem_cells builds from the cells' offsets, uploaded at once,
    and a stream of its own.  `width` forces one block width on every
    cell and `stage` False keeps every cell's lists in device memory
    (tests and measurements)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported EM dtype {dtype}")
    itemsize = torch.finfo(dtype).bits // 8
    host = batched_tables(
        cells, itemsize, width, stage,
        torch.cuda.get_device_properties(device).multi_processor_count)
    i32, i64 = torch.int32, torch.int64
    in_types = [i32, i32, i64, i32] * 2 + [dtype, i64, i32, dtype, i32, i32,
                                           i64, i32, dtype]

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=device, dtype=dt).contiguous()

    ins = [put(a, dt) for a, dt in zip(host["ins"], in_types)]
    scratch = [torch.empty(max(int(n), 1), dtype=dtype, device=device)
               for n in host["scratch"]]
    lib = _kernel_lib()
    double = int(dtype == torch.float64)
    cell_bytes = lib.t1k_em_squarem_cell_bytes(double)
    in_ptrs = (ctypes.c_void_p * _INS)(*[t.data_ptr() for t in ins])
    scratch_ptrs = (ctypes.c_void_p * _SCRATCH)(
        *[t.data_ptr() for t in scratch])
    launches = []
    for form, w, idx in cohort_classes(host):
        rows = np.ascontiguousarray(host["rows"][idx])
        structs = np.empty(len(idx) * cell_bytes, np.uint8)
        lib.t1k_em_squarem_cells(
            len(idx), in_ptrs, scratch_ptrs, rows.ctypes.data,
            host["common"].ctypes.data, double, structs.ctypes.data)
        launches.append(dict(
            cells=idx, form=form, width=w, bytes=int(host["bytes"][idx].max()),
            structs=torch.from_numpy(structs).to(device),
            iterations=torch.zeros(len(idx), dtype=i32, device=device),
            stream=torch.cuda.Stream(device)))
    # the structs point into ins and scratch, which stay referenced here
    return dict(ins=ins, scratch=scratch, launches=launches, dtype=dtype,
                device=torch.device(device), ec_cnt=host["rows"][:, 0],
                count_off=host["rows"][:, _CELL_DIMS + _INS + 4])


def squarem_batched_launch(batch_dev: dict, filter_frac: float,
                           min_squarem_alpha: float,
                           max_iterations: int) -> None:
    """Launch the cohort form of csrc/em_squarem.cu on a cohort from
    squarem_batched_device, one launch per class it holds, widest first,
    each on its class's stream forked from the current stream by an event
    and joined back to it by another; without waiting:
    squarem_batched_results reads the result on the current stream."""
    lib = _kernel_lib()
    dev = batch_dev["device"]
    double = int(batch_dev["dtype"] == torch.float64)
    with torch.cuda.device(dev):
        current = torch.cuda.current_stream(dev)
        fork = torch.cuda.Event()
        fork.record(current)
        for g in batch_dev["launches"]:
            g["stream"].wait_event(fork)
            rc = lib.t1k_em_squarem_batched(
                len(g["cells"]), g["structs"].data_ptr(), g["form"],
                g["bytes"], g["width"], int(max_iterations),
                float(filter_frac), float(min_squarem_alpha), double,
                g["iterations"].data_ptr(), g["stream"].cuda_stream)
            if rc != 0:
                raise RuntimeError("em_squarem batched kernel launch "
                                   f"failed (width {g['width']}): CUDA "
                                   f"error {rc}")
            launch_counts["em_squarem_batched"] += 1
            current.wait_event(g["stream"].record_event())


def batched_kernel_attrs(dtype, form: int, width: int,
                         shared_bytes: int) -> dict:
    """The cohort kernel of one form and width on the current CUDA
    device, as a launch with `shared_bytes` of dynamic shared memory
    would run it: registers a thread, local bytes a thread (its stack
    frame, spills included), static shared bytes and resident blocks an
    SM."""
    out = (ctypes.c_int32 * 4)()
    rc = _kernel_lib().t1k_em_squarem_batched_attrs(
        int(dtype == torch.float64), int(form), int(width),
        int(shared_bytes), out)
    if rc != 0:
        raise RuntimeError(f"em_squarem batched kernel attributes (width "
                           f"{width}): CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "static_shared",
                     "blocks_per_sm"), out))


def squarem_batched_results(batch_dev: dict) -> List[Tuple[int, torch.Tensor]]:
    """Per cell of a launched cohort, in its order: (iterations, per-EC
    counts as a view of the count buffer)."""
    n = len(batch_dev["ec_cnt"])
    iters = np.zeros(n, np.int64)
    for g in batch_dev["launches"]:
        iters[g["cells"]] = g["iterations"].cpu().numpy()
    count = batch_dev["scratch"][4]
    return [(int(iters[b]), count[int(o):int(o) + int(e)])
            for b, (o, e) in enumerate(zip(batch_dev["count_off"],
                                           batch_dev["ec_cnt"]))]


def squarem_batched_cuda(cells: List[dict], filter_frac: float,
                         min_squarem_alpha: float, max_iterations: int,
                         device, dtype) -> List[Tuple[int, torch.Tensor]]:
    """Upload a cohort and launch the cohort form of csrc/em_squarem.cu;
    the same results as squarem_batched_plain on the CPU, bit for bit."""
    batch_dev = squarem_batched_device(cells, device, dtype)
    squarem_batched_launch(batch_dev, filter_frac, min_squarem_alpha,
                           max_iterations)
    return squarem_batched_results(batch_dev)


def shard_tables(seg_rg, seg_ec, counts, rg_cnt: int, ec_cnt: int,
                 unique: bool = False) -> dict:
    """One read-group shard's E-step lists (the sharded form), from its
    entries in read-group order as parallel/mesh.py's
    partition_read_groups cuts them; padding entries (read group rg_cnt,
    count 0, whose term is an exact +0) are dropped.  `rows`: per read
    group of the shard with entries, its ECs in the group's order (CSR
    `row_off`, `row_ecs`); `cols`: per EC its entries, read groups
    ascending (em.cc's scatter order), each entry with its own count (CSC
    `col_off`, `col_rows` as the shard's row numbers, `col_cts`).  With
    `unique`, a repeated (read group, EC) pair raises, as in
    incidence_lists."""
    seg_rg = np.asarray(seg_rg, np.int64)
    real = seg_rg < rg_cnt
    rg = seg_rg[real]
    ec = np.asarray(seg_ec, np.int64)[real]
    ct = np.asarray(counts, np.float64)[real]
    if len(ec) and (ec.min() < 0 or ec.max() >= ec_cnt):
        raise ValueError("EC index out of range in the incidence")
    if (np.diff(rg) < 0).any():
        raise ValueError("a shard's entries must be in read-group order")
    row = np.cumsum(np.diff(rg, prepend=rg[:1]) != 0)   # 0, 0, 1, ...
    row_off = np.zeros(int(row[-1]) + 2 if len(row) else 1, np.int64)
    np.cumsum(np.bincount(row, minlength=len(row_off) - 1), out=row_off[1:])
    # stable, so rows stay ascending within an EC (16-bit keys take
    # numpy's radix sort)
    perm = np.argsort(ec.astype(np.uint16) if ec_cnt <= 1 << 16 else ec,
                      kind="stable")
    col_off = np.zeros(ec_cnt + 1, np.int64)
    np.cumsum(np.bincount(ec, minlength=ec_cnt), out=col_off[1:])
    col_rows, col_ecs = row[perm], ec[perm]
    if unique and ((col_rows[1:] == col_rows[:-1])
                   & (col_ecs[1:] == col_ecs[:-1])).any():
        raise ValueError("duplicate (read group, EC) pair in the incidence")
    return dict(row_off=row_off, row_ecs=ec.astype(np.int32),
                col_off=col_off, col_rows=col_rows.astype(np.int32),
                col_cts=ct[perm], ec_cnt=ec_cnt)


def column_stream(tables: dict) -> dict:
    """A shard's columns as the sharded form's column kernels walk them:
    shard_tables' CSC lists in warp_lists' layout, dealt in one turn over
    a grid of ESTEP_THREADS-thread blocks, each stream position holding
    its entry's row (`stream`), count (`cts`) and EC (`ecs`); unread
    positions (past a list's end) hold row 0, count 0 and EC -1."""
    ec_cnt, nnz = tables["ec_cnt"], len(tables["col_rows"])
    turn = ESTEP_THREADS
    # entry numbers from 1, so an unread position's 0 is no entry
    cols = warp_lists(tables["col_off"],
                      np.arange(1, nnz + 1, dtype=np.int32),
                      max(turn, -(-ec_cnt // turn) * turn))
    at = cols["stream"]
    col_ecs = np.repeat(np.arange(ec_cnt, dtype=np.int32),
                        np.diff(tables["col_off"]))
    cols["stream"] = np.append(np.int32(0), tables["col_rows"])[at].astype(
        np.int32)
    cols["cts"] = np.append(0.0, tables["col_cts"])[at]
    cols["ecs"] = np.append(np.int32(-1), col_ecs)[at]
    return cols


def estep_device(tables: dict, device, dtype, plain: bool = False) -> dict:
    """A shard's shard_tables on `device` for its E-step: the columns'
    column_stream (`cols`), its entry count (`nnz`), a psum per row and a
    term per stream position (`terms`); on a CUDA device the row kernel's
    warp_lists too, dealt like the columns; on the CPU (or with `plain`,
    on any device) the plain row pass's padded index matrix and
    estep_cols_plain's (plain_estep_tables)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported EM dtype {dtype}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:   # as the tensors name it
        dev = torch.device("cuda", torch.cuda.current_device())
    ec_cnt, n_rows = tables["ec_cnt"], len(tables["row_off"]) - 1

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=dev, dtype=dt).contiguous()

    i32, i64 = torch.int32, torch.int64
    cols = column_stream(tables)
    est = dict(device=dev, dtype=dtype, ec_cnt=ec_cnt, n_rows=n_rows,
               nnz=len(tables["col_rows"]),
               cols={k: put(cols[k], dt) for k, dt in (
                   ("sched", i32), ("len", i32), ("base", i64),
                   ("stream", i32), ("cts", dtype), ("ecs", i32))},
               terms=torch.empty(len(cols["stream"]), dtype=dtype,
                                 device=dev))
    if plain or dev.type == "cpu":
        est.update(plain_estep_tables(tables, dev, dtype))
        return est
    turn = ESTEP_THREADS
    rows = warp_lists(tables["row_off"], tables["row_ecs"],
                      max(turn, -(-n_rows // turn) * turn))
    c = est["cols"]
    est["ins"] = [put(rows[k], dt) for k, dt in (
        ("sched", i32), ("len", i32), ("base", i64), ("stream", i32))] + [
        c["sched"], c["len"], c["base"], c["stream"], c["cts"], c["ecs"]]
    est["dims"] = (ctypes.c_int64 * 3)(len(rows["sched"]), len(c["sched"]),
                                       len(cols["stream"]))
    est["psum"] = torch.empty(max(n_rows, 1), dtype=dtype, device=dev)
    return est


def plain_estep_tables(tables: dict, device, dtype) -> dict:
    """shard_tables' lists as the plain passes take them, on `device`:
    [rows, longest row] EC indices padded with ec_cnt (x's appended 0),
    and [ECs, longest column] row indices padded with n_rows (psum's
    appended 1) beside their counts padded with 0."""
    ec_cnt, n_rows = tables["ec_cnt"], len(tables["row_off"]) - 1
    nnz = len(tables["col_rows"])
    at = _padded(tables["col_off"], np.arange(nnz), nnz)        # [E, L]

    def put(x, dt):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    i64 = torch.int64
    return dict(device=torch.device(device), dtype=dtype, ec_cnt=ec_cnt,
                n_rows=n_rows,
                row_ecs=put(_padded(tables["row_off"], tables["row_ecs"],
                                    ec_cnt), i64),              # [R, K]
                col_rows=put(np.append(tables["col_rows"], n_rows)[at], i64),
                col_cts=put(np.append(tables["col_cts"], 0.0)[at], dtype))


def estep_rows_plain(est: dict, x: torch.Tensor) -> None:
    """Plain PyTorch version of the sharded E-step's row pass: per read
    group psum = its x summed in the group's order (0 -> 1), into
    est["psum"]."""
    dtype, dev = est["dtype"], est["device"]
    g = torch.cat([x, torch.zeros(1, dtype=dtype, device=dev)])[est["row_ecs"]]
    psum = torch.zeros(est["n_rows"], dtype=dtype, device=dev)
    for k in range(g.shape[1]):
        psum = psum + g[:, k]
    est["psum"] = torch.where(psum == 0, 1.0, psum)


def estep_cols_plain(est: dict, x: torch.Tensor, count: torch.Tensor,
                     carry: bool) -> None:
    """Plain PyTorch version of the sharded E-step's column pass: per EC
    the running sum over its entries of count * (x / psum), onto `count`
    (from 0, or with `carry` from what it holds), the form of
    squarem_plain's em_update with a count per entry."""
    dtype, dev = est["dtype"], est["device"]
    psum_z = torch.cat([est["psum"], torch.ones(1, dtype=dtype, device=dev)])
    total = count.clone() if carry else torch.zeros_like(count)
    for k in range(est["col_rows"].shape[1]):
        total = total + est["col_cts"][:, k] * (
            x / psum_z[est["col_rows"][:, k]])
    count.copy_(total)


def estep_terms_plain(est: dict, x: torch.Tensor) -> None:
    """Plain PyTorch version of the sharded E-step's term pass, from the
    same layout: at each stream position of a real entry (its EC e >= 0)
    whose x[e] is not 0, count * (x[e] / psum[row]) into est["terms"];
    0 elsewhere (the fold reads none of those)."""
    c = est["cols"]
    e = c["ecs"].long()
    xe = torch.where(e >= 0, x[e.clamp_min(0)], 0.0)
    psum = torch.cat([est["psum"][:est["n_rows"]], torch.ones(
        1, dtype=est["dtype"], device=est["device"])])[
        torch.where(e >= 0, c["stream"].long(), est["n_rows"])]
    est["terms"].copy_(torch.where(xe != 0, c["cts"] * (xe / psum), 0.0))


def estep_fold_plain(est: dict, x: torch.Tensor, count: torch.Tensor,
                     carry: bool) -> None:
    """Plain PyTorch version of the sharded E-step's column fold: per EC
    (the slot that holds it) its terms added in list order onto `count`
    (from 0, or with `carry` from what it holds); an EC whose x is 0
    keeps that start."""
    c = est["cols"]
    slot = torch.nonzero(c["sched"] >= 0).flatten()
    e = c["sched"][slot].long()
    n = c["len"][slot].long()
    at = c["base"][slot // 32] + slot % 32
    live = x[e] != 0
    total = count[e] if carry else torch.zeros_like(count[e])
    for j in range(int(n.max()) if len(n) else 0):
        add = live & (j < n)
        term = est["terms"][torch.where(add, at + 32 * j, 0)]
        total = torch.where(add, total + term, total)
    count[e] = total


def _estep_launch(est: dict, pass_: int, x: torch.Tensor, count,
                  carry: bool) -> None:
    if not (x.is_contiguous() and x.dtype == est["dtype"]
            and x.device == est["device"] and x.numel() == est["ec_cnt"]):
        raise ValueError("x must be a contiguous ec_cnt vector of the "
                         "shard's type on its device")
    if count is not None and not (
            count.is_contiguous() and count.dtype == est["dtype"]
            and count.device == est["device"]
            and count.numel() == est["ec_cnt"]):
        raise ValueError("count must be a contiguous ec_cnt vector of the "
                         "shard's type on its device")
    ins = [*est["ins"], x]
    with torch.cuda.device(est["device"]):
        rc = _kernel_lib().t1k_em_sharded_estep(
            pass_, (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins]),
            est["dims"], int(est["dtype"] == torch.float64), int(carry),
            est["psum"].data_ptr(), est["terms"].data_ptr(),
            None if count is None else count.data_ptr(),
            torch.cuda.current_stream(est["device"]).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sharded E-step launch failed: CUDA error {rc}")


def estep_rows(est: dict, x: torch.Tensor) -> None:
    """A shard's row pass of x (on its device): its kernel on a CUDA
    device, on the current stream without waiting; estep_rows_plain on
    the CPU."""
    if x.device.type == "cpu":
        estep_rows_plain(est, x)
        return
    if est["n_rows"]:   # a shard without entries has no read group
        _estep_launch(est, 0, x, None, False)
        launch_counts["em_sharded_rows"] += 1


def estep_terms(est: dict, x: torch.Tensor) -> None:
    """A shard's term pass of x, after its row pass: every entry's term
    at its column stream position, across the card (its kernel on a CUDA
    device, on the current stream without waiting; estep_terms_plain on
    the CPU).  Needs only this shard's psum, so every shard's may run
    before the first fold."""
    if not est["nnz"]:   # a shard without entries has no term to compute
        return
    if x.device.type == "cpu":
        estep_terms_plain(est, x)
        return
    _estep_launch(est, 1, x, None, False)
    launch_counts["em_sharded_terms"] += 1


def estep_fold(est: dict, x: torch.Tensor, count: torch.Tensor,
               carry: bool) -> None:
    """A shard's column fold onto `count` (ec_cnt elements on its device;
    with `carry` the chain goes on from the partial count holds), after
    its term pass: adds only, its kernel on a CUDA device, on the current
    stream without waiting; estep_fold_plain on the CPU."""
    if x.device.type == "cpu":
        estep_fold_plain(est, x, count, carry)
        return
    _estep_launch(est, 2, x, count, carry)
    launch_counts["em_sharded_fold"] += 1


def estep_cols_fused_cuda(est: dict, x: torch.Tensor, count: torch.Tensor,
                          carry: bool) -> None:
    """The first design's column pass (one thread per EC computes and
    adds its terms) on a CUDA shard, for A/B timing against estep_terms
    and estep_fold: the same bits; counted in `fused_launches`, on no
    path."""
    if x.device.type != "cuda":
        raise ValueError("the fused column pass runs on a CUDA device")
    _estep_launch(est, 3, x, count, carry)
    fused_launches["em_sharded_fused"] += 1


def tail_device(ec_len, init_x, device, dtype, filter_frac: float = 0.15,
                min_squarem_alpha: float = 0.0, max_iterations: int = 1000,
                mask=None) -> dict:
    """The sharded form's round state on `device`: x0-x3 (x0 = init_x; the
    roles of x0 and x1 swap after each round), count, per_len, ec_len, the
    state (t, iterations), and with `mask` (ec_off, ec_alleles,
    allele_gene, allele_major, gene_cnt, major_cnt, as ec_tables gives
    them) the low-abundance mask's tables; without it the tail runs no
    stage 2."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported EM dtype {dtype}")
    dev = torch.device(device)
    ec_cnt = len(ec_len)

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=dev, dtype=dt).contiguous()

    td = dict(device=dev, dtype=dtype, ec_cnt=ec_cnt,
              filter_frac=float(filter_frac),
              min_alpha=float(min_squarem_alpha),
              max_iterations=int(max_iterations),
              x=[put(init_x, dtype)] + [
                  torch.zeros(ec_cnt, dtype=dtype, device=dev)
                  for _ in range(3)],
              count=torch.zeros(ec_cnt, dtype=dtype, device=dev),
              per_len=torch.zeros(ec_cnt, dtype=dtype, device=dev),
              ec_len=put(ec_len, dtype),
              state=torch.zeros(2, dtype=torch.int32, device=dev))
    if mask is None:
        return td
    i32, i64 = torch.int32, torch.int64
    if dev.type == "cpu":
        td["mask"] = plain_mask(ec_len, **mask, filter_frac=filter_frac,
                                device=dev, dtype=dtype)
        return td
    maj_off, maj_alleles = major_lists(mask["allele_major"],
                                       mask["major_cnt"])
    allele_cnt = len(mask["allele_gene"])
    td["tables"] = [put(mask["ec_off"], i64), put(mask["ec_alleles"], i32),
                    put(mask["allele_gene"], i32),
                    put(mask["allele_major"], i32), put(maj_off, i64),
                    put(maj_alleles, i32)]
    td["scratch"] = [torch.empty(max(n, 1), dtype=dtype, device=dev)
                     for n in (allele_cnt, allele_cnt, mask["major_cnt"],
                               mask["gene_cnt"])]
    td["mask_dims"] = (allele_cnt, mask["gene_cnt"], mask["major_cnt"])
    return td


def tail_plain(td: dict, stage: int) -> None:
    """Plain PyTorch version of the sharded form's round tail: from
    td["count"], the normalized update into x1 (stage 0, 2) or x2 (stage
    1), then at stage 1 the extrapolation into x3, at stage 2 the L1
    change against x0, em.cc's t rule (state) and the mask into x1."""
    x = td["x"]
    per_len = td["count"] / td["ec_len"]
    x[2 if stage == 1 else 1].copy_(per_len / _seq_sum(per_len))
    if stage == 1:
        x[3].copy_(plain_extrapolate(x[0], x[1], x[2], td["min_alpha"]))
    if stage != 2:
        return
    diff = float(_seq_sum(torch.abs(x[1] - x[0])))
    t, last = int(td["state"][0]), td["max_iterations"]
    if diff < 1e-5 and t < last - 2:
        t = last - 2
    if t > 0 and t % MASK_ROUND == 0:
        x[1].copy_(td["mask"](td["count"]))
    td["state"][0] = t + 1
    td["state"][1] += 1


def tail(td: dict, stage: int) -> None:
    """The sharded form's round tail on td's device from td["count"] (the
    update's counts there): its kernel, one block, on the current stream
    without waiting, or tail_plain on the CPU."""
    if stage == 2 and "tables" not in td and "mask" not in td:
        raise ValueError("stage 2 needs the mask's tables (tail_device mask)")
    if td["device"].type == "cpu":
        tail_plain(td, stage)
        return
    vecs = [*td["x"], td["count"], td["per_len"], td["ec_len"]]
    # without the mask (no stage 2) the kernel reads neither: null
    tables = [t.data_ptr() for t in td.get("tables", [])] or [None] * 6
    scratch = [t.data_ptr() for t in td.get("scratch", [])] or [None] * 4
    dims = (ctypes.c_int64 * 5)(td["ec_cnt"],
                                *td.get("mask_dims", (0, 0, 0)),
                                td["max_iterations"])
    with torch.cuda.device(td["device"]):
        rc = _kernel_lib().t1k_em_sharded_tail(
            stage, (ctypes.c_void_p * 7)(*[t.data_ptr() for t in vecs]),
            (ctypes.c_void_p * 6)(*tables), (ctypes.c_void_p * 4)(*scratch),
            dims, td["filter_frac"], td["min_alpha"],
            int(td["dtype"] == torch.float64), td["state"].data_ptr(),
            torch.cuda.current_stream(td["device"]).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sharded tail launch failed: CUDA error {rc}")
    launch_counts["em_sharded_tail"] += 1


def em_quantify_gpu(
    ec_to_alleles: List[List[int]],
    rg_ecs_csr: Tuple[np.ndarray, np.ndarray],
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
    device="cuda",
    dtype=torch.float64,
) -> Tuple[int, np.ndarray]:
    """Drop-in for native.em_quantify / ops.em.em_quantify_jax on a torch
    device; returns (iterations, per-EC read counts as f64 numpy).
    `allele_missing` is accepted for signature parity and unused, as in
    both reference routes."""
    if len(ec_to_alleles) == 0:
        return 0, np.zeros(0)
    dev = resolve_device(device)
    tables = em_tables(ec_to_alleles, rg_ecs_csr, rg_counts, allele_eff_len,
                       allele_weight, allele_gene, allele_major, n_genes,
                       n_majors)
    run = squarem_cuda if dev.type == "cuda" else squarem_plain
    iters, count = run(**tables, filter_frac=filter_frac,
                       min_squarem_alpha=min_squarem_alpha,
                       max_iterations=max_iterations, device=dev,
                       dtype=dtype)
    return iters, count.cpu().numpy().astype(np.float64)


def segment_bounds(seg_sorted: np.ndarray, n: int):
    """(starts, ends) of each segment id in a SORTED segment array: the
    host half of sorted_segment_sum (t1k_tpu/ops/em.py:84-89, copied)."""
    b = np.searchsorted(seg_sorted, np.arange(n + 1)).astype(np.int32)
    return b[:-1], b[1:]


def sorted_segment_sum(vals: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor) -> torch.Tensor:
    """Segment sums of `vals` whose segment ids are sorted, as prefix-sum
    differences: a cumsum and two gathers, no scatter."""
    c = torch.cat([torch.zeros(1, dtype=vals.dtype, device=vals.device),
                   torch.cumsum(vals, 0)])
    return c[ends] - c[starts]


def segment_tables(ec_to_alleles, rg_ecs_csr, rg_counts, allele_eff_len,
                   allele_weight, allele_gene, allele_major, n_genes: int,
                   n_majors: int) -> dict:
    """Host tables of the segment EM, as em_quantify_jax builds them for
    _em_loop: the incidence in read-group order (its EC per entry) and in
    stable EC order (EC, read group and count per entry), each order's
    segment bounds, and _pack_ec_tables' EC and allele tables (an allele
    in several ECs takes the last one's)."""
    ec = ec_tables(ec_to_alleles, allele_eff_len, allele_weight, allele_gene,
                   allele_major, n_genes, n_majors)
    ec_cnt = len(ec_to_alleles)
    rg_off, rg_ecs = rg_ecs_csr
    rg_cnt = len(rg_counts)
    seg_rg = np.repeat(np.arange(rg_cnt), np.diff(rg_off)).astype(np.int64)
    seg_ec = np.asarray(rg_ecs, np.int64)
    ec_perm = np.argsort(seg_ec, kind="stable")
    sec_sorted = seg_ec[ec_perm]
    sizes = np.diff(ec["ec_off"])
    allele_ec = np.zeros(len(ec["allele_gene"]), np.int64)
    allele_ec[ec["ec_alleles"]] = np.repeat(np.arange(ec_cnt), sizes)
    allele_valid = np.zeros(len(allele_ec), bool)
    allele_valid[ec["ec_alleles"]] = True
    return dict(
        seg_ec=seg_ec, sec_sorted=sec_sorted, srg_ecorder=seg_rg[ec_perm],
        cts_ecorder=np.asarray(rg_counts, np.float64)[seg_rg][ec_perm],
        rg_bounds=segment_bounds(seg_rg, rg_cnt),
        ec_bounds=segment_bounds(sec_sorted, ec_cnt),
        ec_len=ec["ec_len"], ec_size=sizes.astype(np.float64),
        ec_first=ec["ec_alleles"][ec["ec_off"][:-1]].astype(np.int64),
        allele_ec=allele_ec, allele_valid=allele_valid,
        allele_gene=ec["allele_gene"], allele_major=ec["allele_major"],
        init_x=ec["init_x"], gene_cnt=n_genes, major_cnt=n_majors)


def segment_mask(t: dict, filter_frac: float):
    """_make_mask_reset of the JAX package: count -> the next x0, the
    major sums a scatter-add and each gene's maximum over its valid
    alleles (every-MASK_ROUND abundance mask, Genotyper.hpp:1292-1313)."""
    ec_len, ec_size = t["ec_len"], t["ec_size"]
    allele_ec, allele_valid = t["allele_ec"], t["allele_valid"]
    allele_gene, allele_major = t["allele_gene"], t["allele_major"]

    def mask_reset(count):
        ec_abund = count / ec_len * 1000.0
        allele_abund = torch.where(
            allele_valid, ec_abund[allele_ec] / ec_size[allele_ec], 0.0)
        major_abund = torch.zeros(t["major_cnt"], dtype=count.dtype,
                                  device=count.device)
        major_abund.index_add_(0, allele_major, allele_abund)
        per_allele_major = major_abund[allele_major]
        gene_max = torch.full((t["gene_cnt"],), -torch.inf,
                              dtype=count.dtype, device=count.device)
        gene_max = gene_max.scatter_reduce(
            0, allele_gene, torch.where(allele_valid, per_allele_major, 0.0),
            "amax")
        masked = per_allele_major < filter_frac * 0.5 * gene_max[allele_gene]
        return torch.where(masked[t["ec_first"]], 0.0, ec_abund)

    return mask_reset


def em_quantify_segment(
    ec_to_alleles: List[List[int]],
    rg_ecs_csr: Tuple[np.ndarray, np.ndarray],
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
    device="cuda",
    dtype=torch.float64,
) -> Tuple[int, np.ndarray]:
    """The segment EM (K7): the JAX package's _em_loop with _squarem_while
    (t1k_tpu/ops/em.py:107-200), the route em_quantify_jax takes past its
    dense budget, as tensor code on `device`; em_quantify_gpu's signature
    and return value.

    Each E-step sum is a cumsum difference over the incidence sorted by
    read group (psum) and by EC (counts), which regroups em.cc's sums: the
    counts are the native loop's to rounding, not bit for bit, so no
    "auto" route and no --emBackend value reaches this function, and K5
    (em_quantify_gpu) runs every size in em.cc's order.  The host reads
    each round's L1 change, as the reference's while_loop condition."""
    if len(ec_to_alleles) == 0:
        return 0, np.zeros(0)
    host = segment_tables(ec_to_alleles, rg_ecs_csr, rg_counts,
                          allele_eff_len, allele_weight, allele_gene,
                          allele_major, n_genes, n_majors)
    iters, count = segment_loop(segment_device(host, device, dtype),
                                filter_frac, min_squarem_alpha,
                                max_iterations)
    return iters, count.cpu().numpy().astype(np.float64)


def segment_device(host: dict, device, dtype) -> dict:
    """segment_tables' tables on `device`: floats in `dtype`, indices as
    int64."""
    dev = resolve_device(device)

    def put(x):
        x = torch.as_tensor(np.asarray(x)).to(dev)
        if x.is_floating_point():
            return x.to(dtype)
        return x if x.dtype == torch.bool else x.long()

    return {k: (tuple(put(b) for b in v) if isinstance(v, tuple)
                else v if isinstance(v, int) else put(v))
            for k, v in host.items()}


def segment_loop(t: dict, filter_frac: float = 0.15,
                 min_squarem_alpha: float = 0.0,
                 max_iterations: int = 1000) -> Tuple[int, torch.Tensor]:
    """The segment EM's SQUAREM loop on segment_device's tables: (rounds,
    per-EC counts on the tables' device)."""
    seg_ec, sec_sorted, srg = t["seg_ec"], t["sec_sorted"], t["srg_ecorder"]
    cts, ec_len = t["cts_ecorder"], t["ec_len"]

    def em_update(x):
        psum = sorted_segment_sum(x[seg_ec], *t["rg_bounds"])
        psum = torch.where(psum == 0, 1.0, psum)
        contrib = cts * x[sec_sorted] / psum[srg]
        count = sorted_segment_sum(contrib, *t["ec_bounds"])
        per_len = count / ec_len
        return per_len / per_len.sum(), count

    mask_reset = segment_mask(t, filter_frac)
    x0 = t["init_x"]
    count = torch.zeros_like(x0)
    step = iters = 0
    while step < max_iterations:
        iters += 1
        x1, _ = em_update(x0)
        x2, _ = em_update(x1)
        r = x1 - x0
        v = x2 - 2 * x1 + x0
        sum_r, sum_v = (r * r).sum(), (v * v).sum()
        alpha = torch.where(sum_v == 0, -1.0,
                            -torch.sqrt(sum_r) / torch.sqrt(sum_v))
        if min_squarem_alpha < 0:
            alpha = torch.where(alpha < min_squarem_alpha,
                                min_squarem_alpha, alpha)
        x3 = x0 - 2 * alpha * r + alpha * alpha * v
        x1b, count = em_update(x3)
        diff = float(torch.abs(x1b - x0).sum())  # the round's host sync
        x0 = x1b
        if diff < 1e-5 and step < max_iterations - 2:
            step = max_iterations - 2
        if step > 0 and step % MASK_ROUND == 0:
            x0 = mask_reset(count)
        step += 1
    return iters, count


def em_quantify_batched(
    problems: List[Tuple[List[List[int]], Tuple[np.ndarray, np.ndarray],
                         np.ndarray, np.ndarray]],
    allele_eff_len: np.ndarray,
    allele_gene: np.ndarray,
    allele_major: np.ndarray,
    n_genes: int,
    n_majors: int,
    filter_frac: float = 0.15,
    min_squarem_alpha: float = 0.0,
    max_iterations: int = 1000,
    device="cuda",
    dtype=torch.float64,
    devices=None,
) -> List[Tuple[int, np.ndarray]]:
    """Quantify many cells' EC problems against one reference: the
    counterpart of ops/em.py::em_quantify_jax_batched, with its `problems`
    (per cell: ec_to_alleles, rg_ecs_csr, rg_counts, allele_weight),
    return value and order.  Returns per cell (iterations, per-EC read
    counts as f64 numpy), each cell's the native loop's bits in f64; an
    empty cell gives (0, zeros(0)) and no block.  Nothing is padded, so
    nothing is chunked.  `devices` (a mesh, parallel/mesh.py) deals the
    non-empty cells to its devices in contiguous blocks of ceil(C / n), as
    the reference shards the cell axis: one cohort launch per device, each
    on a stream of its own; without it every cell runs on `device`."""
    results = [(0, np.zeros(0)) for _ in problems]
    cells, where = [], []
    for ci, (ec_to_alleles, rg_ecs_csr, rg_counts, allele_weight) in \
            enumerate(problems):
        if len(ec_to_alleles) == 0:
            continue
        cells.append(em_tables(ec_to_alleles, rg_ecs_csr, rg_counts,
                               allele_eff_len, allele_weight, allele_gene,
                               allele_major, n_genes, n_majors))
        where.append(ci)
    devs = [resolve_device(d) for d in (devices or [device])]
    if not cells:
        return results
    opts = dict(filter_frac=filter_frac, min_squarem_alpha=min_squarem_alpha,
                max_iterations=max_iterations)
    size = -(-len(cells) // len(devs))
    runs = []   # (first cell, stream or None, launched cohort or results)
    for k, dev in enumerate(devs):
        block = cells[k * size:(k + 1) * size]
        if not block:
            continue
        if dev.type == "cpu":
            runs.append((k * size, None, squarem_batched_plain(
                block, **opts, device=dev, dtype=dtype)))
            continue
        stream = (torch.cuda.Stream(dev) if devices is not None
                  else torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            batch_dev = squarem_batched_device(block, dev, dtype)
            squarem_batched_launch(batch_dev, **opts)
        runs.append((k * size, stream, batch_dev))
    for lo, stream, run in runs:
        if stream is not None:
            with torch.cuda.stream(stream):
                run = [(it, count.cpu()) for it, count in
                       squarem_batched_results(run)]
        for i, (it, count) in enumerate(run):
            results[where[lo + i]] = (it, count.numpy().astype(np.float64))
    return results
