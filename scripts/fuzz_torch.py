#!/usr/bin/env python3
"""The port's differential fuzz runner on the card.

  python3 scripts/fuzz_torch.py <fuzzer>[:n][,<fuzzer>[:n]...] <start_seed>
                                <n_cases> [--big] [--device cuda]
                                [--work DIR]

Fuzzers: driver, genotyper, analyzer, extractor, bam, smartseq
(scripts/fuzz_cases.py, copies of tests/fuzz_<fuzzer>.py's case
builders), and hla: driver cases on chip_smoke.py's HLA-scale panel (24
genes x 240 alleles) with 2,000-12,000 read pairs each, drawn per case
(the smoke's fuzz phase fixes 2,000).  Each fuzzer runs seeds start_seed ..
start_seed + n - 1 (n_cases, or its own `:n`); --big draws panels and
pair counts as T1K_FUZZ_BIG does.

Every case is generated here, then all of them run in two child
processes side by side, each case through its module's `main` in the
child: the card child on the routes under test (--backend gpu
--emBackend gpu --device cuda; a quarter of the cases, seed % 4 == 3,
on the defaults, --backend auto, which users run; a plate on the gpu
route runs the --cohortEm pass) and the native child on the oracle
(--backend native --emBackend native, under T1K_BACKEND=native).  No
route falls back: a kernel that fails to build or launch fails its
case.  Each run's exit code is kept.  Then every output of every case
is compared between the two children (fuzz_cases.verdict: byte for
byte, `_assign.tsv` as sorted lines, provenance files left out, a
failing run failing on both).  Prints a line per failing case (fuzzer,
seed, mode, flags, the first difference), a line with each fuzzer's
seconds, the children's start-up, the native child's CUDA context and
launches and the seeds that failed on both routes, and as the last line {fuzzer: {"ok", "fail", "both_failed",
"launches"}}, `launches` summing the card child's kernel launches over
the fuzzer's cases.  Exits 1 on any failing case, 2 without a card
(unless --device cpu: the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import fuzz_cases as fc  # noqa: E402

FUZZERS = fc.FUZZERS + ("hla",)
# the counters each child reads, summed over a case
KERNEL_COUNTS = ("align", "align_band", "em", "kmer", "phase_a")


def card_mode(seed: int) -> str:
    """The card child's route for a seed: a quarter on the defaults."""
    return "auto" if seed % 4 == 3 else "gpu"


def parse_spec(spec: str, n_cases: int) -> list:
    """[(fuzzer, n)] of `driver:16,genotyper` (n_cases where no `:n`)."""
    out = []
    for part in spec.split(","):
        name, _, n = part.partition(":")
        if name not in FUZZERS:
            raise SystemExit(f"unknown fuzzer {name!r}: {' '.join(FUZZERS)}")
        out.append((name, int(n) if n else n_cases))
    return out


def make_cases(plan, start: int, work: str, big: bool, hla_panel,
               hla_pairs) -> list:
    cases = []
    for name, n in plan:
        for seed in range(start, start + n):
            d = os.path.join(work, name, f"case_{seed}")
            if name == "hla":
                case = fc.make_case("driver", seed, d, big,
                                    hla=(hla_panel, hla_pairs))
                case.fuzzer = "hla"
            else:
                case = fc.make_case(name, seed, d, big)
            cases.append(case)
    return cases


def _counts() -> dict:
    import importlib
    mods = [importlib.import_module(f"t1k_tpu_torch.ops.{m}")
            for m in KERNEL_COUNTS]
    return {k: v for m in mods for k, v in m.launch_counts.items()}


def child(route: str, plan_path: str, results_path: str,
          started: str) -> int:
    """Runs every case of the plan on `route` ("card" or "native") in
    this process; writes each case's runs and launches as JSON, and its
    start-up: from `started` (the parent's wall clock at its start) to
    its imports' end."""
    import torch

    import t1k_tpu_torch.cli.run  # noqa: F401
    startup = time.time() - float(started)
    with open(plan_path) as f:
        plan = json.load(f)
    results = []
    for c in plan["cases"]:
        case = fc.Case(c["fuzzer"], c["seed"], c["dir"],
                       [fc.Run(**r) for r in c["runs"]], c["flags"],
                       c["mkdirs"])
        out = os.path.join(case.dir, route)
        mode = card_mode(case.seed) if route == "card" else "native"
        before = _counts()
        t = time.perf_counter()
        runs = fc.run_case(case, out, lambda run: fc.route_argv(
            run, mode, out, plan["device"]))
        after = _counts()
        results.append({"runs": runs, "s": time.perf_counter() - t,
                        "launches": {k: v - before[k]
                                     for k, v in after.items()
                                     if v != before[k]}})
    with open(results_path, "w") as f:
        json.dump({"results": results, "startup_s": startup,
                   "cuda_context": torch.cuda.is_initialized()}, f)
    return 0


def run_fuzz(plan, start: int, work: str, device: str = "cuda",
             big: bool = False, hla_panel=None, hla_pairs=None) -> dict:
    """Generates the cases of `plan` ([(fuzzer, n)]) under `work`, runs
    them in a card child and a native child side by side, compares them.
    Returns {"summary": {fuzzer: {ok, fail, both_failed, launches}},
    "failures": [lines], "seconds": {fuzzer: card-child seconds},
    "cases_s", "children_s", "native_cuda_context", "native_launches",
    "card_startup_s", "native_startup_s", "case_launches": [(fuzzer,
    seed, mode, argv of the card's first run, launches)], "both_failed":
    {fuzzer: [seeds]}}."""
    t0 = time.perf_counter()
    cases = make_cases(plan, start, work, big, hla_panel, hla_pairs)
    cases_s = time.perf_counter() - t0
    plan_path = os.path.join(work, "plan.json")
    with open(plan_path, "w") as f:
        json.dump({"device": device, "cases": [
            {"fuzzer": c.fuzzer, "seed": c.seed, "dir": c.dir,
             "flags": c.flags, "mkdirs": c.mkdirs,
             "runs": [vars(r) for r in c.runs]} for c in cases]}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}
    t1 = time.perf_counter()
    for route in ("card", "native"):
        cenv = dict(env, T1K_BACKEND="native") if route == "native" else env
        with open(os.path.join(work, f"{route}.log"), "w") as logf:
            procs[route] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", route,
                 plan_path, os.path.join(work, f"{route}.json"),
                 repr(time.time())],
                cwd=ROOT, env=cenv, stdout=logf, stderr=subprocess.STDOUT)
    for route, proc in procs.items():
        if proc.wait() != 0:
            with open(os.path.join(work, f"{route}.log")) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"the {route} child exited {proc.returncode}:"
                               f"\n{tail}")
    children_s = time.perf_counter() - t1
    res = {}
    for route in procs:
        with open(os.path.join(work, f"{route}.json")) as f:
            res[route] = json.load(f)
    summary, failures, seconds, case_launches = {}, [], {}, []
    both_failed = {}
    native_launches = {}
    for c, card, native in zip(cases, res["card"]["results"],
                               res["native"]["results"]):
        mode = card_mode(c.seed)
        s = summary.setdefault(c.fuzzer, {"ok": 0, "fail": 0,
                                          "both_failed": 0, "launches": {}})
        what, diff = fc.verdict(c, os.path.join(c.dir, "card"), card["runs"],
                                os.path.join(c.dir, "native"),
                                native["runs"])
        s[what] += 1
        if what == "both_failed":
            both_failed.setdefault(c.fuzzer, []).append(c.seed)
        if what == "fail":
            errors = [r["error"].strip().splitlines()[-1]
                      for r in card["runs"] + native["runs"] if r["error"]]
            failures.append(f"FAIL {c.fuzzer} seed {c.seed} mode {mode}: "
                            f"{diff} ({c.flags}) {' | '.join(errors)}")
        for k, v in card["launches"].items():
            s["launches"][k] = s["launches"].get(k, 0) + v
        for k, v in native["launches"].items():
            native_launches[k] = native_launches.get(k, 0) + v
        seconds[c.fuzzer] = seconds.get(c.fuzzer, 0.0) + card["s"]
        case_launches.append((c.fuzzer, c.seed, mode,
                              fc.route_argv(c.runs[0], mode, "", device),
                              card["launches"]))
    for line in failures:
        print(line, flush=True)
    return {"summary": summary, "failures": failures, "seconds": seconds,
            "cases_s": cases_s, "children_s": children_s,
            "native_cuda_context": res["native"]["cuda_context"],
            "native_launches": native_launches,
            "card_startup_s": res["card"]["startup_s"],
            "native_startup_s": res["native"]["startup_s"],
            "case_launches": case_launches, "both_failed": both_failed}


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(*argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fuzzers")
    ap.add_argument("start", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=None,
                    help="keep the cases here (default: a temporary "
                         "directory, removed at the end)")
    args = ap.parse_args(argv)
    plan = parse_spec(args.fuzzers, args.n)
    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("fuzz_torch: CUDA is not available", file=sys.stderr)
            return 2
        import chip_smoke as cs
        from t1k_tpu_torch.ops import _build

        print(cs.card_line(), flush=True)
        t0 = time.perf_counter()
        _build.build_all(cs.SOURCES)
        print(f"build {time.perf_counter() - t0:.2f}s", flush=True)
    work = args.work or tempfile.mkdtemp(prefix="t1k_fuzz_")
    os.makedirs(work, exist_ok=True)
    try:
        hla_panel = None
        if any(name == "hla" for name, _ in plan):
            import chip_smoke as cs
            hla_panel = os.path.join(work, "hla_panel.fa")
            cs.build_panel(hla_panel)
        t0 = time.perf_counter()
        got = run_fuzz(plan, args.start, work, args.device, args.big,
                       hla_panel)
        print(json.dumps({
            "seconds": {k: round(v, 3) for k, v in got["seconds"].items()},
            "cases_s": round(got["cases_s"], 3),
            "children_s": round(got["children_s"], 3),
            "card_startup_s": round(got["card_startup_s"], 3),
            "native_startup_s": round(got["native_startup_s"], 3),
            "native_cuda_context": got["native_cuda_context"],
            "native_launches": got["native_launches"],
            "both_failed_seeds": got["both_failed"],
            "wall_s": round(time.perf_counter() - t0, 3)}), flush=True)
        print(json.dumps(got["summary"]), flush=True)
    finally:
        if not args.work:
            shutil.rmtree(work, ignore_errors=True)
    bad = (got["failures"] or got["native_cuda_context"]
           or any(got["native_launches"].values()))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
