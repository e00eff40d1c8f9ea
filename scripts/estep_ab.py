#!/usr/bin/env python3
"""Time the sharded E-step's column kernels (csrc/em_squarem.cu's sharded
form) in several builds, in turns, on one CUDA card.

  python3 scripts/estep_ab.py [--variants committed,kChainUnroll=16]
                              [--reps N]

Each build is this checkout's source with some of the column fold's
constants rewritten before nvcc: a variant is "committed" (none) or
NAME=VALUE pairs joined by "+", as in kChainUnroll=16+kFoldStages=8
(kChainUnroll: terms a batch; kFoldStages: batches in the shared-memory
ring; kFoldThreads: the fold's block), built with this checkout's nvcc
flags; each build's register report is printed.
The problems: a seeded problem of the HLA problem's shape (5,421 read
groups x 1,070 ECs, rows geometric with mean 40, at most 115 ECs), the
same with its ECs drawn skewed (`skewed_problem`) and chip_smoke.py's
large problem (~2M incidences), each as one shard and as three.  On
every shard each build's term pass and fold are held bit for bit to the
plain split on the card's tensors and to the first design's fused
column pass, from 0 and with carry, x zero on every 7th EC.  Then, at
one shard, with CUDA events, `--reps` launches each: the fused column
pass and each build's term pass + fold in turns (in order, then
reversed), and each build's term pass and fold alone.  Prints the card
line and one JSON line: per problem its sizes and per build the
milliseconds of both turns.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build(variants, out_dir: str) -> dict:
    """{variant: ctypes library}, one nvcc each, all at once."""
    from t1k_tpu_torch.ops import _build, em

    with open(os.path.join(_build.CSRC_DIR, "em_squarem.cu")) as f:
        source = f.read()
    procs = {}
    for k, name in enumerate(variants):
        text = source
        for pair in name.split("+") if name != "committed" else ():
            key, value = pair.split("=")
            text, n = re.subn(rf"constexpr int {key} = \d+;",
                              f"constexpr int {key} = {int(value)};", text)
            if n != 1:
                raise RuntimeError(f"{key} not found in em_squarem.cu")
        src = os.path.join(out_dir, f"em_{k}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, *_build.FP_FLAGS,
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", os.path.join(out_dir, f"libem_{k}.so"),
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for k, (u, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {u} build:\n{log}")
        kernel = None
        for line in log.splitlines():   # the sharded kernels' reports
            if "Compiling entry function" in line:
                m = re.search(r"(estep_(?:terms|fold)_kernel)"
                              r"(?:<|I)(double|float|d|f)", line)
                kernel = m and f"{m.group(1)}<{m.group(2)[0]}>"
            elif kernel and ("registers" in line or "spill" in line):
                print(f"  ptxas {u} {kernel}:", line.split(":", 1)[-1]
                      .strip(), flush=True)
        libs[u] = em.bind_kernel_lib(
            ctypes.CDLL(os.path.join(out_dir, f"libem_{k}.so")))
    return libs


@contextlib.contextmanager
def kernel_of(lib):
    """ops.em's wrappers on a build's library."""
    from t1k_tpu_torch.ops import em

    saved = em._kernel_lib
    em._kernel_lib = lambda: lib
    try:
        yield
    finally:
        em._kernel_lib = saved


def skewed_problem() -> dict:
    """The HLA shape with each read group's ECs drawn by weight 1 / (rank
    + 200), so that the longest column holds a few hundred entries, as
    the main phase's HLA problem's does."""
    rng = np.random.default_rng(7)
    n_rg, n_ec = 5421, 1070
    p = cs.em_problem(n_rg, n_ec, rng, lambda r: min(r.geometric(1 / 40),
                                                     115))
    w = 1.0 / (np.arange(n_ec) + 200.0)
    offs = p["rg_ecs_csr"][0]
    ecs = [rng.choice(n_ec, size=int(k), replace=False, p=w / w.sum())
           for k in np.diff(offs)]
    p["rg_ecs_csr"] = (offs, np.concatenate(ecs).astype(np.int32))
    return p


def shards(problem: dict, n: int) -> list:
    """shard_tables of each of n read-group shards of a problem."""
    from t1k_tpu_torch.ops import em
    from t1k_tpu_torch.parallel import mesh as pm

    args, _ = cs.sharded_args(problem)
    seg_rg, seg_ec, counts, rg_cnt, ec_to_alleles = args[:5]
    out = pm.partition_read_groups(seg_rg, seg_ec, counts[seg_rg], rg_cnt, n)
    return [em.shard_tables(out[0][s], out[1][s], out[2][s], rg_cnt,
                            len(ec_to_alleles)) for s in range(n)]


def check(libs: dict, tables: dict, dev, seed: int) -> None:
    """Every build's split against the plain split and the fused pass,
    bit for bit, from 0 and with carry."""
    import torch

    from t1k_tpu_torch.ops import em

    f64 = torch.float64
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.random(tables["ec_cnt"]), dtype=f64, device=dev)
    x[::7] = 0
    start = torch.as_tensor(rng.random(tables["ec_cnt"]), dtype=f64,
                            device=dev)
    plain = em.estep_device(tables, dev, f64, plain=True)
    em.estep_rows_plain(plain, x)
    em.estep_terms_plain(plain, x)
    for carry in (False, True):
        want = start.clone()
        em.estep_fold_plain(plain, x, want, carry)
        for u, lib in libs.items():
            with kernel_of(lib):
                est = em.estep_device(tables, dev, f64)
                em.estep_rows(est, x)
                em.estep_terms(est, x)
                got, fused = start.clone(), start.clone()
                em.estep_fold(est, x, got, carry)
                em.estep_cols_fused_cuda(est, x, fused, carry)
            for what, other in (("plain split", want), ("fused pass", fused)):
                if got.cpu().numpy().tobytes() != \
                        other.cpu().numpy().tobytes():
                    raise AssertionError(f"{u}: differs from the {what} "
                                         f"(carry {carry})")


def main() -> int:
    import torch

    from t1k_tpu_torch.ops import em

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="committed,kChainUnroll=16")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("estep_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev, f64 = torch.device("cuda", 0), torch.float64
    variants = args.variants.split(",")
    problems = {
        "hla_shape": cs.em_problem(5421, 1070, np.random.default_rng(5),
                                   lambda rng: min(rng.geometric(1 / 40),
                                                   115)),
        "skewed": skewed_problem(),
        "large": cs.em_large(*cs.EM_LARGE)}
    print(cs.card_line(), flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="estep_ab_") as tmp:
        libs = build(variants, tmp)
        first = libs[variants[0]]
        for pname, problem in problems.items():
            for n in (1, 3):
                for s, tables in enumerate(shards(problem, n)):
                    check(libs, tables, dev, 10 * n + s)
            tables = shards(problem, 1)[0]
            x = torch.as_tensor(em.ec_tables(*cs.sharded_args(problem)[0][
                4:])["init_x"], dtype=f64, device=dev)
            count = torch.empty_like(x)
            with kernel_of(first):
                est = em.estep_device(tables, dev, f64)
                em.estep_rows(est, x)

            def pieces(lib):
                def terms():
                    with kernel_of(lib):
                        em.estep_terms(est, x)

                def fold():
                    with kernel_of(lib):
                        em.estep_fold(est, x, count, False)
                return terms, fold

            runs = {"fused": lambda: em.estep_cols_fused_cuda(
                est, x, count, False)}
            for u, lib in libs.items():
                terms, fold = pieces(lib)
                runs[u] = lambda t=terms, f=fold: (t(), f())
            ms = {name: [] for name in runs}
            with kernel_of(first):
                for turn in (list(runs), list(runs)[::-1]):
                    for name in turn:
                        ms[name].append(cs.time_ms(runs[name], args.reps,
                                                   dev))
            for u, lib in libs.items():
                terms, fold = pieces(lib)
                ms[f"{u}_terms"] = [cs.time_ms(terms, args.reps, dev)]
                ms[f"{u}_fold"] = [cs.time_ms(fold, args.reps, dev)]
            lens = np.diff(tables["col_off"])
            out[pname] = {"ec_cnt": tables["ec_cnt"],
                          "nnz": len(tables["col_rows"]),
                          "longest_column": int(lens.max()),
                          "positions": len(est["terms"]), "ms": ms}
            print(f"{pname}: " + " ".join(
                f"{k}={'/'.join(f'{t:.4f}' for t in v)}"
                for k, v in ms.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
