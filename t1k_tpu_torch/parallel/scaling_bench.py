"""Scaling measurement of the sharded step over a device list: the
counterpart of ``t1k_tpu/parallel/scaling_bench.py``.

  python -m t1k_tpu_torch.parallel.scaling_bench [--device cpu]

Two workloads at 1, 2, 4 and 8 devices:
  * the sharded plain EM (``parallel/mesh.py::em_quantify_sharded``) at
    fixed total load (strong scaling): the reference's seeded 200,000
    read group x 4,096 EC problem, 1.6M entries, 2 warm updates and 20
    timed ones;
  * the whole dry-run step (``parallel/dryrun.py::dryrun_multichip``:
    band kernel, FragWeight, sharded SQUAREM and its checks) at constant
    load per device (weak scaling): its first run, then three timed ones.

By default the devices are the cards, and a count past the cards present
ends each loop, as the reference's does past its devices; ``--device
cpu`` runs each count as CPU shards (one process, so the times measure
the sharding's overhead, not a speed-up).  Prints one JSON line in the
reference's schema: {"metric": "sharded_em_scaling", "results": ...,
"full_step_weak_scaling": ...}.  Times are host-clock seconds of calls
that return numpy, so each ends with the devices' work.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from .dryrun import dryrun_multichip
from .mesh import data_mesh, em_quantify_sharded

SIZES = (1, 2, 4, 8)


def scaling_problem(rg_cnt: int = 200_000, ec_cnt: int = 4096,
                    seed: int = 11) -> dict:
    """The reference's seeded problem: 8 entries per read group on
    average, count 1 each, EC lengths in [800, 20000)."""
    rng = np.random.default_rng(seed)
    nnz = rg_cnt * 8
    return dict(
        seg_rg=np.sort(rng.integers(0, rg_cnt, nnz)).astype(np.int32),
        seg_ec=rng.integers(0, ec_cnt, nnz).astype(np.int32),
        counts=np.ones(nnz, np.float64), rg_cnt=rg_cnt,
        ec_len=rng.integers(800, 20000, ec_cnt).astype(np.float64),
        init=np.ones(ec_cnt, np.float64))


def meshes(device="cuda", sizes: Sequence[int] = SIZES) -> Dict[int, List]:
    """Each size's device list: the first n cards, up to the cards present
    (the loop stops at the first size past them; the first size raises
    without a card), or n CPU shards."""
    out = {}
    for n in sizes:
        if out and torch.device(device).type == "cuda" \
                and n > torch.cuda.device_count():
            break
        out[n] = data_mesh(n, device)
    return out


def run_em(mesh, p: dict, iterations: int) -> np.ndarray:
    return em_quantify_sharded(mesh, p["seg_rg"], p["seg_ec"], p["counts"],
                               p["rg_cnt"], p["ec_len"], p["init"],
                               iterations=iterations)


def bench_em(mesh_of: Dict[int, List], p: dict, warm: int = 2,
             iterations: int = 20) -> dict:
    """Strong scaling of the sharded plain EM: ms per update at each size,
    speed-up and efficiency against the first."""
    results = {}
    base = None
    for n, mesh in mesh_of.items():
        run_em(mesh, p, warm)
        t0 = time.perf_counter()
        run_em(mesh, p, iterations)
        dt = (time.perf_counter() - t0) / iterations
        base = dt if base is None else base
        results[n] = {"ms_per_iteration": round(dt * 1e3, 3),
                      "speedup": round(base / dt, 3),
                      "efficiency": round(base / dt / n, 3)}
        print(f"devices={n}: {dt * 1e3:.2f} ms/iter  speedup={base / dt:.2f}"
              f"  eff={base / dt / n:.2f}", file=sys.stderr)
    return results


def bench_full_step(mesh_of: Dict[int, List], reps: int = 3) -> dict:
    """Weak scaling of the dry-run step (its load per device constant):
    seconds per step, the first run's extra seconds, efficiency against
    the first size."""
    results = {}
    base = None
    for n, mesh in mesh_of.items():
        t0 = time.perf_counter()
        dryrun_multichip(n, devices=mesh)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            dryrun_multichip(n, devices=mesh)
        dt = (time.perf_counter() - t0) / reps
        base = dt if base is None else base
        results[n] = {"s_per_step": round(dt, 3),
                      "compile_s": round(t_first - dt, 3),
                      "weak_efficiency": round(base / dt, 3)}
        print(f"full step devices={n}: {dt:.3f} s/step  "
              f"weak-eff={base / dt:.2f}", file=sys.stderr)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the cards) or cpu (CPU shards)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    mesh_of = meshes(args.device)
    results = bench_em(mesh_of, scaling_problem())
    step_results = bench_full_step(mesh_of)
    print(json.dumps({"metric": "sharded_em_scaling", "results": results,
                      "full_step_weak_scaling": step_results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
