#!/usr/bin/env python3
"""Time the SQUAREM EM kernel (csrc/em_squarem.cu) in several builds, in
turns, on one CUDA card.

  python3 scripts/em_ab.py [--parent DIR] [--variants 1024x8,512x8]
                           [--reps N]

Each variant is this checkout's kernel with its block size and unroll
(kThreads x kUnroll) rewritten before nvcc; the first is the committed
setting.  --parent names a directory holding an earlier kernel
(t1k_tpu_torch/csrc/em_squarem.cu), an earlier commit unpacked with `git
archive`, say: one with this checkout's C interface (it exports
t1k_em_squarem_cells) runs through this checkout's wrapper at 1,024
threads, an older one-block kernel through the interface it had before
the warp-interleaved lists (10 inputs, 11 scratch buffers, 6 dims).  All
are built with this
checkout's nvcc flags.  The problems are chip_smoke.py's microcell, a
seeded problem of the HLA problem's shape (5,421 read groups x 1,070 ECs,
rows geometric with mean 40, at most 115 ECs) and its large problem
(~2M incidences, the device-memory form).  On each problem every build is
first held to the native loop bit for bit (iterations and counts); then
they are timed with CUDA events in turns (in order, then reversed),
`--reps` launches each, tables already on the card, and this checkout's
variants are run once more in their profiled instantiation.  Prints the
card line and one JSON line: per problem, per build, the milliseconds
per launch of both turns and the per-phase clock counts.
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


def nvcc(src: str, out: str) -> subprocess.Popen:
    from t1k_tpu_torch.ops import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.FP_FLAGS, "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, src])


def build(variants, parent, out_dir: str) -> dict:
    """{build name: ctypes library}, one nvcc each, all at once."""
    from t1k_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "em_squarem.cu")) as f:
        source = f.read()
    procs = {}
    for threads, unroll in variants:
        name = f"{threads}x{unroll}"
        text = re.sub(r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {threads};", source)
        text = re.sub(r"constexpr int kUnroll = \d+;",
                      f"constexpr int kUnroll = {unroll};", text)
        src = os.path.join(out_dir, f"em_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = nvcc(src, os.path.join(out_dir, f"libem_{name}.so"))
    if parent:
        procs["parent"] = nvcc(
            os.path.join(parent, "t1k_tpu_torch", "csrc", "em_squarem.cu"),
            os.path.join(out_dir, "libem_parent.so"))
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} build")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"libem_{name}.so"))
    return libs


@contextlib.contextmanager
def kernel_of(lib, threads: int):
    """ops.em's wrapper on a variant's library and block size."""
    from t1k_tpu_torch.ops import em

    saved = em.EM_THREADS, em._kernel_lib
    em.EM_THREADS, em._kernel_lib = threads, (lambda: lib)
    try:
        yield
    finally:
        em.EM_THREADS, em._kernel_lib = saved


def this_runner(lib, threads: int, tables: dict, opts: dict, dev):
    """(launch, result, profile) for a variant of this checkout's kernel."""
    import torch

    from t1k_tpu_torch.ops import em

    lib.t1k_em_squarem.restype = ctypes.c_int
    lib.t1k_em_squarem.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    with kernel_of(lib, threads):
        em_dev = em.squarem_device(**tables, device=dev,
                                   dtype=torch.float64)

    def launch(cycles=None):
        with kernel_of(lib, threads):
            em.squarem_launch(em_dev, **opts, cycles=cycles)

    def result():
        return (int(em_dev["iterations"].item()),
                em_dev["count"].cpu().numpy())

    def profile():
        cycles = torch.zeros(len(em.EM_PHASES) + 1, dtype=torch.int64,
                             device=dev)
        launch(cycles)
        return dict(zip(em.EM_PHASES + ("total",),
                        cycles.cpu().numpy().tolist()))
    return launch, result, profile


def parent_runner(lib, tables: dict, opts: dict, dev):
    """(launch, result, None) for the earlier kernel's interface: x0 (its
    first scratch buffer) holds the initial abundances and is overwritten,
    so each launch copies them in first."""
    import torch

    f64, i32, i64 = torch.float64, torch.int32, torch.int64
    fn = lib.t1k_em_squarem
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev, dt)

    ec_cnt, rg_cnt = len(tables["ec_len"]), len(tables["rg_counts"])
    allele_cnt = len(tables["allele_gene"])
    ins = [put(tables["rg_off"], i64), put(tables["rg_ecs"], i32),
           put(tables["rg_counts"], f64), put(tables["col_off"], i64),
           put(tables["col_rgs"], i32), put(tables["ec_off"], i64),
           put(tables["ec_alleles"], i32), put(tables["ec_len"], f64),
           put(tables["allele_gene"], i32), put(tables["allele_major"], i32)]
    init = put(tables["init_x"], f64)
    sizes = [ec_cnt] * 5 + [rg_cnt, ec_cnt, allele_cnt, allele_cnt,
                            tables["major_cnt"], tables["gene_cnt"]]
    scratch = [torch.empty(max(n, 1), dtype=f64, device=dev) for n in sizes]
    iters = torch.zeros(1, dtype=i32, device=dev)
    dims = (ctypes.c_int64 * 6)(ec_cnt, allele_cnt, tables["gene_cnt"],
                                tables["major_cnt"], rg_cnt,
                                opts["max_iterations"])
    in_ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in ins])
    sc_ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in scratch])

    def launch():
        scratch[0][:ec_cnt].copy_(init)
        rc = fn(in_ptrs, sc_ptrs, dims, opts["filter_frac"],
                opts["min_squarem_alpha"], 1, iters.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent kernel launch failed: CUDA error {rc}")

    def result():
        return int(iters.item()), scratch[4][:ec_cnt].cpu().numpy()
    return launch, result, None


def main() -> int:
    import torch

    from t1k_tpu_torch.native import em_quantify
    from t1k_tpu_torch.ops import em

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="1024x4,1024x8,512x4")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("em_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    variants = [tuple(int(v) for v in s.split("x"))
                for s in args.variants.split(",")]
    problems = {
        "micro": cs.em_microcell(cs.EM_RG, cs.EM_EC),
        "hla_shape": cs.em_problem(5421, 1070, np.random.default_rng(5),
                                   lambda rng: min(rng.geometric(1 / 40),
                                                   115)),
        "large": cs.em_large(*cs.EM_LARGE)}
    print(cs.card_line(), flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="em_ab_") as tmp:
        libs = build(variants, args.parent, tmp)
        for pname, problem in problems.items():
            opts = {k: problem[k] for k in ("filter_frac",
                                             "min_squarem_alpha",
                                             "max_iterations")}
            tables = em.em_tables(**{k: v for k, v in problem.items()
                                     if k not in ("allele_missing", *opts)})
            want = em_quantify(**problem)
            runners = {}
            for name, lib in libs.items():
                if name == "parent" and not hasattr(
                        lib, "t1k_em_squarem_cells"):
                    runners[name] = parent_runner(lib, tables, opts, dev)
                elif name == "parent":
                    runners[name] = this_runner(lib, 1024, tables, opts, dev)
                else:
                    runners[name] = this_runner(
                        lib, int(name.split("x")[0]), tables, opts, dev)
            for name, (launch, result, _) in runners.items():
                launch()
                it, count = result()
                if it != want[0] or not np.array_equal(count, want[1]):
                    raise AssertionError(f"{pname}: {name} differs from "
                                         "the native loop")
            ms = {name: [] for name in runners}
            order = list(runners)
            for turn in (order, order[::-1]):
                for name in turn:
                    ms[name].append(cs.time_ms(runners[name][0], args.reps,
                                               dev))
            out[pname] = {
                "shape": f"{len(tables['rg_counts'])}x{len(tables['ec_len'])}",
                "nnz": len(tables["rg_ecs"]), "iterations": want[0],
                "builds": {name: {"ms": ms[name],
                                  "cycles": prof() if prof else None}
                           for name, (_, _, prof) in runners.items()}}
            print(f"{pname}: " + " ".join(
                f"{n}={'/'.join(f'{t:.4f}' for t in v)}"
                for n, v in ms.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
