"""Multi-device dry run of the port: the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``.

  python -m t1k_tpu_torch.parallel.dryrun [--devices N] [--device cpu]

One step of the production multi-device layout on a device list (the
port's mesh, ``parallel/mesh.py``; a device may repeat, so ``[cuda:0] *
n`` runs n shards on one card):

1. the band kernel (``csrc/band_stats.cu`` through
   ``ops/align_band.banded_stats_band``; its warp kernel, at the batch's
   40-cell window) scores each shard's slice of a seeded batch of 100 bp
   reads against 112 b windows, and the engine's FragWeight buckets
   (engine.cc; reference Genotyper.hpp:205-230) turn the match counts into
   fragment weights;
2. ``em_quantify_sharded_squarem`` quantifies a seeded ragged read-group x
   EC incidence whose read-group counts carry those weights, in float32
   and then in float64;
3. both are held against the native f64 loop (``native.em_quantify``):
   float32 at the reference's tolerance (rtol 2e-3, atol 1e-2); float64
   to the same iteration count and the same counts, bit for bit, which
   the sharded E-step's chained column passes give at any shard count.

The batch and the incidence are the reference's, seed for seed, and a
shard holds whole 128-pair slabs as there.

``entry(device)`` is the single-device composite of
``__graft_entry__.entry()``: the band kernel on the 1,024-pair batch,
FragWeight, the dense int8 [2,048, 512] incidence scatter-added on the
device, and one SQUAREM round of the dense EM in float32 (two updates,
the extrapolation, a third update); it returns the composite's (match,
x2).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..native import em_quantify
from ..ops.align_band import band_window, banded_stats_band
from .mesh import _device, data_mesh, em_quantify_sharded_squarem

# the reference's production-shape step: 100 bp reads against 112 b
# reference windows, 512 ECs, four pairs per read group
B, LT, LP = 1024, 112, 100
EC_CNT, FANOUT = 512, 4
RG_CNT = 2048           # the composite's read groups
REF_SIM = 0.8           # default -s
LANES = 128             # the JAX band kernel's pairs per slab
ML = 5 + 5              # covers |t_len - p_len| <= 5 extra
W = band_window(ML, max(LT - LP, 0) + 5)
MAX_EM_ROUNDS = 1000


def example_batch(b: int, Lt: int, Lp: int, seed: int = 7):
    """`_example_batch` of __graft_entry__.py, copied: (t_codes, t_lens,
    p_codes, p_lens), each read a 2%-mutated middle slice of its window."""
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 4, (b, Lt)).astype(np.int8)
    pc = tc[:, (Lt - Lp) // 2:(Lt - Lp) // 2 + Lp].copy()
    mut = rng.random((b, Lp)) < 0.02
    pc[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.int8)
    tl = np.full(b, Lt, np.int32)
    pl = np.full(b, Lp, np.int32)
    return tc, tl, pc, pl


def example_em(rg_cnt: int, ec_cnt: int, seed: int = 11):
    """`_example_em` of __graft_entry__.py, copied: (seg_rg, seg_ec, counts,
    ec_len, x0), FANOUT ECs drawn with replacement per read group."""
    rng = np.random.default_rng(seed)
    seg_rg = np.repeat(np.arange(rg_cnt), FANOUT).astype(np.int32)
    seg_ec = rng.integers(0, ec_cnt, rg_cnt * FANOUT).astype(np.int32)
    counts = rng.integers(1, 4, rg_cnt).astype(np.float32)
    ec_len = rng.integers(900, 1500, ec_cnt).astype(np.float32)
    x0 = (np.ones(ec_cnt) / ec_cnt).astype(np.float32)
    return seg_rg, seg_ec, counts, ec_len, x0


def shard_pairs(n_shards: int) -> int:
    """Pairs per shard: an equal share of B rounded up to whole slabs."""
    return max(LANES, (B // n_shards + LANES - 1) // LANES * LANES)


def frag_weights(match: torch.Tensor, tl: torch.Tensor,
                 pl: torch.Tensor) -> torch.Tensor:
    """The engine's FragWeight rule in float32, as the reference's step
    computes it: similarity 4 match / (t_len + p_len) into buckets 1, 0.5,
    0.1 and 0.01 of width max((1 - refSim) / 4, 0.01)."""
    sim = 2.0 * 2.0 * match.float() / (tl + pl).float()
    segment = max((1 - REF_SIM) / 4.0, 0.01)
    one = torch.ones_like(sim)
    return torch.where(
        sim < 1 - 3 * segment, 0.01 * one,
        torch.where(sim < 1 - 2 * segment, 0.1 * one,
                    torch.where(sim < 1 - segment, 0.5 * one, one)))


def align_step(mesh, tc, tl, pc, pl) -> np.ndarray:
    """Phase 1: each shard scores its slice of the batch with the band
    kernel on its device and weighs it; returns the weights (f32) of the
    whole batch in shard order."""
    per = len(tl) // len(mesh)
    out = []
    for s, dev in enumerate(mesh):
        sl = slice(s * per, (s + 1) * per)
        _, match, _, _ = banded_stats_band(tc[sl], tl[sl], pc[sl], pl[sl],
                                           ml=ML, w=W, device=dev)
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        out.append(frag_weights(put(match), put(tl[sl]), put(pl[sl])).cpu())
    return torch.cat(out).numpy()


def em_problem(frag_w: np.ndarray) -> dict:
    """Phase 2's incidence, the reference's recipe seed for seed: FANOUT
    pairs per read group fold into its count (multiplicity x the largest
    weight), each group touches 1-4 distinct ECs; two alleles per EC
    over 16 genes."""
    rng = np.random.default_rng(5)
    rg_cnt = len(frag_w) // FANOUT
    rg_w = np.asarray(frag_w, np.float64).reshape(rg_cnt, FANOUT).max(axis=1)
    counts = (rng.integers(1, 4, rg_cnt) * rg_w).astype(np.float64)
    seg_rg, seg_ec = [], []
    for g in range(rg_cnt):
        k = int(rng.integers(1, 5))
        for e in rng.choice(EC_CNT, size=k, replace=False):
            seg_rg.append(g)
            seg_ec.append(int(e))
    n_alleles = EC_CNT * 2
    allele_major = (np.arange(n_alleles) // 2).astype(np.int32)
    return dict(
        seg_rg=np.array(seg_rg, np.int32), seg_ec=np.array(seg_ec, np.int32),
        counts=counts, rg_cnt=rg_cnt,
        ec_to_alleles=[[2 * i, 2 * i + 1] for i in range(EC_CNT)],
        allele_eff_len=rng.integers(900, 1500, n_alleles).astype(np.int32),
        allele_weight=np.ones(n_alleles, np.int32),
        allele_gene=(allele_major % 16).astype(np.int32),
        allele_major=allele_major, gene_cnt=16, major_cnt=EC_CNT)


def native_em(p: dict):
    """The native f64 loop on the problem: (iterations, counts)."""
    rg_off = np.zeros(p["rg_cnt"] + 1, np.int64)
    np.add.at(rg_off[1:], p["seg_rg"], 1)
    rg_off = np.cumsum(rg_off)
    n_alleles = len(p["allele_eff_len"])
    return em_quantify(
        p["ec_to_alleles"], (rg_off, p["seg_ec"]), p["counts"],
        p["allele_eff_len"], np.zeros(n_alleles, np.int32),
        p["allele_weight"], p["allele_gene"], p["allele_major"],
        p["gene_cnt"], p["major_cnt"])


def sharded_em(mesh, p: dict, dtype):
    return em_quantify_sharded_squarem(
        mesh, p["seg_rg"], p["seg_ec"], p["counts"], p["rg_cnt"],
        p["ec_to_alleles"], p["allele_eff_len"], p["allele_weight"],
        p["allele_gene"], p["allele_major"], p["gene_cnt"], p["major_cnt"],
        max_iterations=MAX_EM_ROUNDS, dtype=dtype)


def dryrun_multichip(n_devices: int, device="cuda",
                     devices: Optional[Sequence] = None) -> dict:
    """Run the multi-device step on `devices` (a device list, which may
    repeat a device), or on the first `n_devices` cards (`device` "cpu":
    n_devices CPU shards).  Raises if a check fails; prints the
    reference's summary line and returns the step's figures (iterations
    and each phase's host-clock seconds)."""
    mesh = list(devices) if devices is not None else data_mesh(n_devices,
                                                                device)
    if len(mesh) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(mesh)}")
    mesh = [_device(d) for d in mesh]

    def synced():
        for d in set(mesh):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return time.perf_counter()

    b = shard_pairs(n_devices) * n_devices
    tc, tl, pc, pl = example_batch(b, LT, LP)
    t0 = synced()
    frag_w = align_step(mesh, tc, tl, pc, pl)
    t1 = synced()
    if frag_w.shape != (b,) or not (frag_w > 0).all():
        raise AssertionError("phase 1 gave weights outside (0, 1]")

    p = em_problem(frag_w)
    it_32, count_32 = sharded_em(mesh, p, torch.float32)
    t2 = synced()
    it_64, count_64 = sharded_em(mesh, p, torch.float64)
    t3 = synced()
    it_native, count_native = native_em(p)
    # float32 lands at the native fixed point to float tolerance; the
    # round it crosses the 1e-5 gate on may differ from float64's
    if it_32 >= MAX_EM_ROUNDS:
        raise AssertionError(f"float32 sharded SQUAREM hit the "
                             f"{MAX_EM_ROUNDS}-round cap")
    np.testing.assert_allclose(count_32, count_native, rtol=2e-3, atol=1e-2)
    if it_64 != it_native:
        raise AssertionError(f"float64 sharded SQUAREM ran {it_64} rounds, "
                             f"the native loop {it_native}")
    if not np.array_equal(count_64, count_native):
        raise AssertionError("float64 sharded SQUAREM counts differ from "
                             "the native loop's")
    print(f"dryrun_multichip({n_devices}): band-stats + FragWeight + "
          f"sharded SQUAREM (f32 {it_32} iters, counts at native fixed "
          f"point; f64 rerun = native {it_native} iters, bit for bit) OK "
          f"(B={b}, RG={p['rg_cnt']}, EC={EC_CNT})", flush=True)
    return dict(pairs=b, read_groups=p["rg_cnt"], it_f32=it_32,
                it_native=it_native, align_s=t1 - t0, em_f32_s=t2 - t1,
                em_f64_s=t3 - t2)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products in full float32 (TF32 off) on the card, as the
    reference's f32 dot; the setting is restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def entry(device="cuda"):
    """The single-device composite of __graft_entry__.entry() on its
    seeded inputs: band-stats alignment -> FragWeight -> one SQUAREM round
    of the dense int8 EM in float32.  Returns (match int32 [B], x2 float32
    [EC_CNT]) as numpy arrays."""
    dev = _device(device)
    tc, tl, pc, pl = example_batch(B, LT, LP)
    srg, sec, cts, elen, x = (
        torch.from_numpy(a).to(dev) for a in example_em(RG_CNT, EC_CNT))
    _, match, _, _ = banded_stats_band(tc, tl, pc, pl, ml=ML, w=W,
                                       device=dev)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    w = frag_weights(put(match), put(tl), put(pl))
    # The reference's step, kept as it is: B // RG_CNT is 0, so the test
    # fails, rg_w is all ones and the band weights never reach the EM.
    rg_w = (w.reshape(RG_CNT, -1).mean(dim=1)
            if w.shape[0] == RG_CNT * (B // RG_CNT)
            else torch.ones(RG_CNT, dtype=torch.float32, device=dev))
    cts_w = cts * rg_w
    # the incidence scatter-added on the device; a cell may hold 2 (ECs
    # are drawn with replacement).  Accumulated in int32, which every
    # device's index_put_ takes, then stored int8 as the reference's.
    A = torch.zeros((RG_CNT, EC_CNT), dtype=torch.int32, device=dev)
    A.index_put_((srg.long(), sec.long()),
                 torch.ones(len(srg), dtype=torch.int32, device=dev),
                 accumulate=True)
    A = A.to(torch.int8)
    Af = A.float()  # _mv / _vm: int8 A, float32 products

    def em_update(xk):
        psum = Af @ xk
        psum = torch.where(psum == 0, 1.0, psum)
        count = xk * ((cts_w / psum) @ Af)
        per_len = count / elen
        return per_len / per_len.sum()

    with _full_f32_matmul():
        x1 = em_update(x)
        x2 = em_update(x1)
        # SQUAREM extrapolation (Genotyper.hpp:424-437), as the step
        r = x1 - x
        v = x2 - x1 - r
        alpha = -torch.sqrt(torch.sum(r * r)
                            / torch.clamp(torch.sum(v * v), min=1e-30))
        xs = x - 2 * alpha * r + alpha * alpha * v
        xs = torch.clamp(xs, min=0)
        xs = xs / xs.sum()
        out = em_update(xs)
    return match.astype(np.int32), out.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="shards: the first N cards, or N CPU shards")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the cards) or cpu (the plain versions)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
