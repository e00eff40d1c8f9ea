"""Read-group sharding of the EM over torch devices (K13).

Counterpart of ``t1k_tpu/parallel/mesh.py``.  A mesh is a list of torch
devices, one per shard (``data_mesh``); a device may appear more than
once, so ``[cuda:0] * n`` runs n shards on one card, as the reference's
tests run a virtual CPU mesh.  The incidence is cut into whole read
groups per shard (``partition_read_groups``, copied); the EC tables and
x are replicated.  Each EM update runs every shard's row pass (its read
groups' normalizers) and term pass (each entry's share), then the
shards' column folds in shard order, and the round's tail (normalizer,
extrapolation, L1 change, mask) on the first shard's device; x then
goes back to every shard.  The passes are the sharded form of
``csrc/em_squarem.cu``, or its plain version on the CPU.

The order contract.  em.cc sums each EC's count over the read groups in
ascending order, one chain.  The reference sums per-shard partials (a
psum), which regroups that chain; on the HLA problem two shards then
move counts by 1e-4, and on a 2M-incidence problem they converge a
round later to other counts (PERF.md, the sharded EM's findings).
Here shard s's column fold goes on from shard s-1's partial instead,
so every shard count gives the native loop's bits; the row and term
passes stay independent.  The loop is driven from the host with one
sync a round, for t.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import NoCardError, resolve_device
from ..ops import em
from ..ops.em import segment_bounds


# em.ec_tables' entries that the round tail's mask reads
MASK_TABLES = ("ec_off", "ec_alleles", "allele_gene", "allele_major",
               "gene_cnt", "major_cnt")


def _device(dev) -> torch.device:
    """`dev` as a torch device with its card's index."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(n_devices: Optional[int] = None,
              device="cuda") -> List[torch.device]:
    """The first `n_devices` cards (all of them by default), as
    jax.devices()[:n] gives them; with device "cpu", `n_devices` shards
    on the CPU.  Without a card a CUDA mesh raises NoCardError; asking for
    more cards than there are raises ValueError."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise NoCardError("data_mesh takes the CUDA cards and this machine "
                          "has none: pass a device list, e.g. "
                          "[torch.device('cpu')] * n")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"{n} devices asked for; this machine has {count}")
    return [torch.device("cuda", i) for i in range(n)]


def shard_batch(mesh, arr) -> List[torch.Tensor]:
    """Row s of a shard-major array (or entry s of a list) on shard s's
    device."""
    return [torch.as_tensor(arr[s]).to(_device(d))
            for s, d in enumerate(mesh)]


def replicate(mesh, arr) -> List[torch.Tensor]:
    """The whole array on each shard's device (one tensor per device,
    shared by the shards already there)."""
    t = torch.as_tensor(arr)
    return [t.to(_device(d)) for d in mesh]


def partition_read_groups(seg_rg: np.ndarray, seg_ec: np.ndarray,
                          counts: np.ndarray, rg_cnt: int, n_shards: int,
                          ec_cnt: Optional[int] = None):
    """Split incidence arrays into n_shards with whole read groups per
    shard, padded to equal length (padding points at a dummy group whose
    abundance contribution is zero).  When ec_cnt is given, also emits
    the per-shard EC sort permutation and the per-shard segment bounds
    needed by the scatter-free device step (ops/em.py)."""
    order = np.argsort(seg_rg, kind="stable")
    seg_rg, seg_ec, counts = seg_rg[order], seg_ec[order], counts[order]
    bounds = np.searchsorted(
        seg_rg, np.linspace(0, rg_cnt, n_shards + 1)[1:-1])
    pieces = np.split(np.arange(len(seg_rg)), bounds)
    max_len = max((len(p) for p in pieces), default=0)
    max_len = max(max_len, 1)
    out_rg = np.full((n_shards, max_len), rg_cnt, dtype=seg_rg.dtype)
    out_ec = np.zeros((n_shards, max_len), dtype=seg_ec.dtype)
    out_ct = np.zeros((n_shards, max_len), dtype=counts.dtype)
    for s, p in enumerate(pieces):
        out_rg[s, :len(p)] = seg_rg[p]
        out_ec[s, :len(p)] = seg_ec[p]
        out_ct[s, :len(p)] = counts[p]
    if ec_cnt is None:
        return out_rg, out_ec, out_ct
    out_secs = np.zeros((n_shards, max_len), np.int32)
    out_srgo = np.zeros((n_shards, max_len), np.int32)
    out_ctso = np.zeros((n_shards, max_len), counts.dtype)
    out_rgs = np.zeros((n_shards, rg_cnt + 1), np.int32)
    out_rge = np.zeros((n_shards, rg_cnt + 1), np.int32)
    out_ecs = np.zeros((n_shards, ec_cnt), np.int32)
    out_ece = np.zeros((n_shards, ec_cnt), np.int32)
    for s in range(n_shards):
        # padding entries carry count 0, so wherever the sorts place
        # them their prefix-sum contribution is zero
        perm = np.argsort(out_ec[s], kind="stable").astype(np.int32)
        out_secs[s] = out_ec[s][perm]
        out_srgo[s] = out_rg[s][perm]
        out_ctso[s] = out_ct[s][perm]
        out_rgs[s], out_rge[s] = segment_bounds(out_rg[s], rg_cnt + 1)
        out_ecs[s], out_ece[s] = segment_bounds(out_secs[s], ec_cnt)
    return (out_rg, out_ec, out_ct, out_secs, out_srgo, out_ctso,
            out_rgs, out_rge, out_ecs, out_ece)


def _incidence(seg_rg, seg_ec, rg_cnt: int, ec_cnt: int):
    seg_rg = np.asarray(seg_rg, np.int64)
    seg_ec = np.asarray(seg_ec, np.int64)
    if len(seg_rg) != len(seg_ec):
        raise ValueError("seg_rg and seg_ec differ in length")
    if len(seg_rg) and (seg_rg.min() < 0 or seg_rg.max() >= rg_cnt):
        raise ValueError("read group index out of range")
    if len(seg_ec) and (seg_ec.min() < 0 or seg_ec.max() >= ec_cnt):
        raise ValueError("EC index out of range")
    return seg_rg, seg_ec


class ShardedEM:
    """One problem on a mesh: its shards on their devices (the E-step
    lists of em.shard_tables from partition_read_groups' cut of entries
    with a count each) and the round's tail state on mesh[0] (`td`, from
    em.tail_device with `tail`'s options).  `counts[s]` is where shard s
    continues the per-EC chain: td["count"] for a shard on mesh[0], else
    a vector on its device."""

    def __init__(self, mesh, seg_rg, seg_ec, entry_counts, rg_cnt: int,
                 ec_cnt: int, dtype, ec_len, init_x, unique: bool = False,
                 **tail):
        self.mesh = [_device(d) for d in mesh]
        if not self.mesh:
            raise ValueError("empty mesh")
        out_rg, out_ec, out_ct = partition_read_groups(
            seg_rg, seg_ec, np.asarray(entry_counts, np.float64), rg_cnt,
            len(self.mesh))
        # a shard holds whole read groups, so it sees all of a pair's
        # repeats (em.shard_tables refuses them with `unique`)
        self.shards = [em.estep_device(
            em.shard_tables(out_rg[s], out_ec[s], out_ct[s], rg_cnt, ec_cnt,
                            unique), d, dtype)
            for s, d in enumerate(self.mesh)]
        self.td = em.tail_device(ec_len, init_x, self.mesh[0], dtype, **tail)
        self.init_x = self.td["x"][0].clone()
        self.counts = [self.td["count"] if d == self.mesh[0] else
                       torch.zeros(ec_cnt, dtype=dtype, device=d)
                       for d in self.mesh]

    def estep(self, src: int) -> None:
        """The E-step of the tail's x[src] into td["count"]: every shard's
        row pass and term pass (each needs only its own psum), then the
        column folds in shard order, each going on from the previous
        shard's partial (em.cc's chain)."""
        xs = replicate(self.mesh, self.td["x"][src])
        for est, x in zip(self.shards, xs):
            em.estep_rows(est, x)
            em.estep_terms(est, x)
        for s, (est, x) in enumerate(zip(self.shards, xs)):
            if s and self.counts[s] is not self.counts[s - 1]:
                self.counts[s].copy_(self.counts[s - 1])
            em.estep_fold(est, x, self.counts[s], carry=s > 0)
        if self.counts[-1] is not self.td["count"]:
            self.td["count"].copy_(self.counts[-1])

    def update(self, src: int, stage: int) -> None:
        """One EM update of the tail's x[src]: the E-step, then the tail's
        `stage`."""
        self.estep(src)
        em.tail(self.td, stage)

    def swap(self) -> None:
        """x0 takes the round's update (x1); x1 becomes scratch."""
        x = self.td["x"]
        x[0], x[1] = x[1], x[0]

    def squarem(self):
        """The SQUAREM loop (em.cc's rounds) from init_x; (iterations,
        count)."""
        td = self.td
        td["x"][0].copy_(self.init_x)
        td["state"].zero_()
        while int(td["state"][0]) < td["max_iterations"]:  # the round's sync
            self.update(0, 0)
            self.update(1, 1)
            self.update(3, 2)
            self.swap()
        return int(td["state"][1]), td["count"]


def sharded_em_step(mesh, seg_rg, seg_ec, counts, rg_cnt: int, ec_len,
                    dtype=torch.float32, axis: str = "dp"):
    """Build one data-parallel plain EM update over the mesh (per-entry
    counts): returns step(x) -> (x1, count), both on mesh[0].  Read groups
    are sharded whole, so each shard's normalizers see all of a group's
    entries, and each EC's count is one chain through the shards in
    order.  `axis` is accepted for signature parity and unused."""
    ec_cnt = len(ec_len)
    seg_rg, seg_ec = _incidence(seg_rg, seg_ec, rg_cnt, ec_cnt)
    sh = ShardedEM(mesh, seg_rg, seg_ec, counts, rg_cnt, ec_cnt, dtype,
                   ec_len, np.zeros(ec_cnt))

    def step(x):
        sh.td["x"][0].copy_(x)
        sh.update(0, 0)
        return sh.td["x"][1].clone(), sh.td["count"].clone()

    return step


def em_quantify_sharded_squarem(
    mesh,
    seg_rg: np.ndarray,
    seg_ec: np.ndarray,
    counts: np.ndarray,
    rg_cnt: int,
    ec_to_alleles,
    allele_eff_len: np.ndarray,
    allele_weight: np.ndarray,
    allele_gene: np.ndarray,
    allele_major: np.ndarray,
    gene_cnt: int,
    major_cnt: int,
    filter_frac: float = 0.15,
    min_squarem_alpha: float = 0.0,
    max_iterations: int = 1000,
    axis: str = "dp",
    dtype=None,
    single_dispatch: Optional[bool] = None,
):
    """The sharded SQUAREM quantification: em.cc's loop (3 EM updates and
    the extrapolation per round, L1 convergence at 1e-5 with one forced
    extra round, the every-10-rounds mask on the stabilizing update's
    counts) with the incidence sharded over the mesh on whole read groups.
    Counts per read group (shape (rg_cnt,), the native convention; a
    repeated (read group, EC) pair is refused) or per entry (each entry
    its own term).  dtype defaults to float64.

    single_dispatch: at one shard with counts per read group, None or
    True runs em_squarem.cu's whole loop in one launch (squarem_cuda; its
    plain version on the CPU), which equals the host loop bit for bit;
    False runs the host loop.  True raises at more than one shard or with
    per-entry counts.  `axis` is accepted for signature parity and
    unused.  Returns (iterations, ec_read_count[f64])."""
    dtype = torch.float64 if dtype is None else dtype
    n = len(mesh)
    ec_cnt = len(ec_to_alleles)
    seg_rg, seg_ec = _incidence(seg_rg, seg_ec, rg_cnt, ec_cnt)
    counts = np.asarray(counts, np.float64)
    counts_per_rg = counts.shape == (rg_cnt,)
    if not counts_per_rg and counts.shape != seg_rg.shape:
        raise ValueError("counts are per read group or per entry")
    if single_dispatch is None:
        single_dispatch = n == 1 and counts_per_rg
    if single_dispatch:
        if n != 1:
            raise ValueError(f"single_dispatch runs one launch on one "
                             f"shard; this mesh has {n}")
        if not counts_per_rg:
            raise ValueError("single_dispatch takes counts per read group")
        dev = _device(mesh[0])
        rg_off = np.zeros(rg_cnt + 1, np.int64)
        np.cumsum(np.bincount(seg_rg, minlength=rg_cnt), out=rg_off[1:])
        tables = em.em_tables(
            ec_to_alleles, (rg_off, seg_ec[np.argsort(seg_rg, kind="stable")]),
            counts, allele_eff_len, allele_weight, allele_gene, allele_major,
            gene_cnt, major_cnt)
        run = em.squarem_cuda if dev.type == "cuda" else em.squarem_plain
        it, count = run(**tables, filter_frac=filter_frac,
                        min_squarem_alpha=min_squarem_alpha,
                        max_iterations=max_iterations, device=dev,
                        dtype=dtype)
        return it, count.cpu().numpy().astype(np.float64)
    ec = em.ec_tables(ec_to_alleles, allele_eff_len, allele_weight,
                      allele_gene, allele_major, gene_cnt, major_cnt)
    sh = ShardedEM(mesh, seg_rg, seg_ec, counts[seg_rg] if counts_per_rg
                   else counts, rg_cnt, ec_cnt, dtype, ec["ec_len"],
                   ec["init_x"], filter_frac=filter_frac,
                   min_squarem_alpha=min_squarem_alpha,
                   max_iterations=max_iterations, unique=counts_per_rg,
                   mask={k: ec[k] for k in MASK_TABLES})
    it, count = sh.squarem()
    return it, count.cpu().numpy().astype(np.float64)


def em_quantify_sharded(
    mesh,
    seg_rg: np.ndarray,
    seg_ec: np.ndarray,
    counts: np.ndarray,
    rg_cnt: int,
    ec_len: np.ndarray,
    init_x: np.ndarray,
    iterations: int = 50,
    axis: str = "dp",
    dtype=torch.float32,
):
    """Sharded plain-EM quantification (no SQUAREM), per-entry counts:
    `iterations` updates of init_x / its sum (in dtype, float32 by
    default as the JAX form's).  `axis` is accepted for signature parity
    and unused.  Returns x as numpy."""
    seg_rg, seg_ec = _incidence(seg_rg, seg_ec, rg_cnt, len(init_x))
    sh = ShardedEM(mesh, seg_rg, seg_ec, counts, rg_cnt, len(init_x), dtype,
                   ec_len, normalized(init_x, dtype))
    for _ in range(iterations):
        sh.update(0, 0)
        sh.swap()
    return sh.td["x"][0].cpu().numpy()


def normalized(init_x, dtype) -> np.ndarray:
    """init_x / its sum, left to right, in dtype."""
    x = np.asarray(init_x, torch.empty(0, dtype=dtype).numpy().dtype)
    return x / np.cumsum(x)[-1]
