"""Multi-process execution of the sharded EM over torch.distributed (K13).

Counterpart of ``t1k_tpu/parallel/multihost.py``: one process (rank) per
shard, joined by ``initialize_from_env``; every rank calls
``em_quantify_multihost`` with the FULL incidence problem and builds the
E-step lists of its own read-group shard (``parallel/mesh.py``'s cut).
Each EM update is every rank's row pass and term pass, then the column
folds in rank order, each rank going on from the partial counts the rank
before it sends (em.cc's one chain per EC, as parallel/mesh.py runs it
in one process; only the fold waits for the hand-off), a broadcast of
the last rank's counts, and the update's tail on every rank from those
same counts.  The result is replicated and has
the one-shard bits at any rank count.

Backends: NCCL on the cards (one card per rank) and Gloo on the CPU.
Gloo also serves ranks that share one card: their counts pass through
host copies.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..ops import em
from .mesh import _incidence, normalized, partition_read_groups


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card (LOCAL_RANK, else the rank)
    modulo the card count."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_from_env(device="cuda", backend=None) -> int:
    """Join the process group that T1K_COORDINATOR (host:port),
    T1K_NUM_PROCESSES and T1K_PROCESS_ID describe over tcp://, or else
    the env:// one torchrun sets up.  The backend is NCCL for a CUDA
    `device` and Gloo for the CPU unless `backend` names one; NCCL with
    more ranks on this host than cards raises.  Returns the rank."""
    coord = os.environ.get("T1K_COORDINATOR")
    if coord:
        world = int(os.environ["T1K_NUM_PROCESSES"])
        kw = dict(init_method=f"tcp://{coord}", world_size=world,
                  rank=int(os.environ["T1K_PROCESS_ID"]))
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        kw = dict(init_method="env://")
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local > cards:
            raise RuntimeError(f"NCCL needs a card per rank: {local} ranks "
                               f"on this host, {cards} cards")
    dist.init_process_group(backend, **kw)
    if cuda:
        torch.cuda.set_device(rank_device(device))
    return dist.get_rank()


def global_data_mesh(axis: str = "dp") -> List[int]:
    """The group's ranks in rank order, one shard each, so contiguous
    read-group shards land on contiguous ranks.  `axis` is accepted for
    signature parity and unused."""
    return list(range(dist.get_world_size()))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend moves for `t`: a host copy of a card's
    tensor for Gloo (its TCP transport moves host memory); `t` itself
    otherwise."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.cpu()
    return t


def receive_partial(count: torch.Tensor, mesh, pos: int) -> None:
    """Before the column fold of the rank at place `pos` of `mesh`: the
    previous rank's partial counts into `count` (the first rank starts
    from 0 and receives none)."""
    if pos:
        buf = _wire(count)
        dist.recv(buf, src=mesh[pos - 1])
        if buf is not count:
            count.copy_(buf)


def pass_on(count: torch.Tensor, mesh, pos: int) -> None:
    """After that column fold: `count` to the next rank, then the last
    rank's counts, the update's, broadcast to every rank."""
    if pos < len(mesh) - 1:
        dist.send(_wire(count), dst=mesh[pos + 1])
    buf = _wire(count)
    dist.broadcast(buf, src=mesh[-1])
    if buf is not count:
        count.copy_(buf)


def em_quantify_multihost(
    seg_rg: np.ndarray,
    seg_ec: np.ndarray,
    counts: np.ndarray,
    rg_cnt: int,
    ec_len: np.ndarray,
    init_x: np.ndarray,
    iterations: int = 50,
    axis: str = "dp",
    mesh=None,
    dtype=torch.float32,
    device="cuda",
):
    """Collective multi-process plain-EM quantification (per-entry counts;
    the multi-process analog of mesh.em_quantify_sharded, and its bits).
    Every rank of `mesh` (global_data_mesh() by default, the whole group)
    calls it with identical arguments; returns the replicated abundance
    vector as numpy.  `axis` is accepted for signature parity and
    unused."""
    if mesh is None:
        mesh = global_data_mesh(axis)
    ec_cnt = len(init_x)
    dev = rank_device(device)
    seg_rg, seg_ec = _incidence(seg_rg, seg_ec, rg_cnt, ec_cnt)
    out_rg, out_ec, out_ct = partition_read_groups(
        seg_rg, seg_ec, np.asarray(counts, np.float64), rg_cnt, len(mesh))
    pos = mesh.index(dist.get_rank())
    est = em.estep_device(
        em.shard_tables(out_rg[pos], out_ec[pos], out_ct[pos], rg_cnt,
                        ec_cnt), dev, dtype)
    td = em.tail_device(ec_len, normalized(init_x, dtype), dev, dtype)
    x = td["x"]
    for _ in range(iterations):
        em.estep_rows(est, x[0])
        em.estep_terms(est, x[0])
        receive_partial(td["count"], mesh, pos)
        em.estep_fold(est, x[0], td["count"], carry=pos > 0)
        pass_on(td["count"], mesh, pos)
        em.tail(td, 0)
        x[0], x[1] = x[1], x[0]
    return x[0].cpu().numpy()
