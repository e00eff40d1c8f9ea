#!/usr/bin/env python3
"""Time the EM kernel's cohort form (csrc/em_squarem.cu,
squarem_batched_kernel) at every block width, in this checkout's build
and in a register-budget variant, on one CUDA card; and the
single-problem kernel's per-phase cycles on one cell of each set.

  python3 scripts/cohort_ab.py [--variants r64,r128]

Sets: chip_smoke.py's cohort set (384 cells of benchmarks/cohort_em.py's
600 read groups x 48 ECs) and "small", 96 seeded cells of 47 x 21 (the
shape of the largest problem of chip_smoke.py's plate).  Variant r64 is
the committed source (the shared-memory forms built for 64 registers a
thread, list folds of 2); r128 builds them as the device-memory form is,
for 128 registers up to 512 threads with folds of 4.  Each variant's
library runs through this checkout's wrapper, and chip_smoke.cohort_case
times it on each set: the rule's width, 1,024 threads and the lists left
in device memory in turns, then every width of ops/em.py COHORT_WIDTHS in
turns, each held to the native loop bit for bit, with each launch's
registers, local bytes and resident blocks an SM.  Then the
single-problem kernel's profiled instantiation (1,024 threads, lists in
device memory) on the first cell of each set: its clock64() cycles per
phase, per round.  Prints the card line, each case's phase line and one
JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# r128: the committed source with the shared-memory forms' budget and
# folds set as the device-memory form's
R128 = (("  return form != kDeviceForm ? kThreads / w : w < 512 ? 512 / w : 1;",
         "  return w < 512 ? 512 / w : 1;"),
        ("    kForm != kDeviceForm || kW == kThreads ? 2 : kUnroll;",
         "    kW == kThreads ? 2 : kUnroll;"))


def small_set(n_cells: int) -> tuple:
    """n_cells seeded cells of 47 read groups x 21 ECs against the cohort
    set's reference, as em_quantify_batched's arguments and options."""
    (_, *ref), kw = cs.cohort_plate(1)
    problems = [cs.cohort_problem(5000 + i, cs.COHORT_ALLELES, 21, 47)
                for i in range(n_cells)]
    return (problems, *ref), kw


def build(variants, out_dir: str) -> dict:
    """{variant: ctypes library}, one nvcc each, all at once."""
    from t1k_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "em_squarem.cu")) as f:
        source = f.read()
    procs = {}
    for name in variants:
        text = source
        if name == "r128":
            for old, new in R128:
                if old not in text:
                    raise RuntimeError(f"r128: {old.strip()!r} not in the "
                                       "source")
                text = text.replace(old, new)
        elif name != "r64":
            raise ValueError(f"unknown variant {name}")
        src = os.path.join(out_dir, f"em_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, *_build.FP_FLAGS,
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
             os.path.join(out_dir, f"libem_{name}.so"), src])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} build")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"libem_{name}.so"))
    return libs


def use(lib) -> None:
    """ops.em's wrapper on `lib` from here on (its argtypes set)."""
    from t1k_tpu_torch.ops import _build, em

    em._kernel_lib.cache_clear()
    load = _build.load
    _build.load = lambda name: lib
    try:
        em._kernel_lib()
    finally:
        _build.load = load


def phase_cycles(dev, cohort: tuple) -> dict:
    """The single-problem kernel's profiled instantiation on the first
    cell of `cohort`: iterations, ms a launch and cycles per phase per
    round."""
    import torch

    from t1k_tpu_torch.ops import em

    (problems, eff_len, gene, major, n_genes, n_majors), kw = cohort
    p = problems[0]
    tables = em.em_tables(p[0], p[1], p[2], eff_len, p[3], gene, major,
                          n_genes, n_majors)
    em_dev = em.squarem_device(**tables, device=dev, dtype=torch.float64)
    opts = dict(kw, max_iterations=1000)
    ms = cs.time_ms(lambda: em.squarem_launch(em_dev, **opts), 20, dev)
    cycles = torch.zeros(len(em.EM_PHASES) + 1, dtype=torch.int64,
                         device=dev)
    em.squarem_launch(em_dev, **opts, cycles=cycles)
    it = int(em_dev["iterations"].item())
    return dict(shape=f"{len(tables['rg_counts'])}x{len(tables['ec_len'])}",
                iterations=it, ms=ms, cycles_per_round={
                    k: round(v / it, 1) for k, v in zip(
                        em.EM_PHASES + ("total",),
                        cycles.cpu().numpy().tolist())})


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="r64,r128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cohort_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _, add_ms = cs.em_clock_probe(dev, 0, 1 << 22)
    add_ns = add_ms * 1e6 / (1 << 22)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sets = {"cohort": cs.cohort_plate(cs.COHORT_CELLS),
            "small": small_set(96)}
    out = {}
    with tempfile.TemporaryDirectory(prefix="cohort_ab_") as tmp:
        libs = build(args.variants.split(","), tmp)
        for name, lib in libs.items():
            use(lib)
            for set_name, cohort in sets.items():
                with cs.phase(f"{name} {set_name}") as info:
                    ms, _, bnd, _, extras = cs.cohort_case(
                        dev, set_name, cohort, add_ns, sms, info)
                out[f"{name}_{set_name}"] = dict(ms=ms, bound_ms=bnd[0],
                                                 **extras)
        use(libs[args.variants.split(",")[0]])
        for set_name, cohort in sets.items():
            out[f"k5_{set_name}"] = phase_cycles(dev, cohort)
            print(f"k5 {set_name}: {json.dumps(out[f'k5_{set_name}'])}",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
