"""One run of one benchmark cell of t1k_tpu_torch, the PyTorch/CUDA port.

  python3 port_bench/run.py --workload kir-rna.candidates --seed 7 \\
      --seconds 51 --trace 0

Set-up makes the cell's panel and a pool of samples from the seed
(under $TMPDIR), then runs one sample through the run-t1k chain
(t1k_tpu_torch.cli.run.main), which builds every kernel and warms the
route.  The window then runs the pool's samples back to back in this
process, one in flight, until --seconds have passed; a sample still in
flight at the close is not counted.  Once the window has closed the
outputs and the state captured from the program are judged by the
plain reference (harness/check.py, port_bench/reference), and
one JSON line goes to standard output: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics from a
torch.profiler trace of the window and the harness's spans.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
for _p in (ROOT, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

from harness import check, traffic  # noqa: E402
from harness.layers import TracedRun, load_reader  # noqa: E402

PROGRAM = "t1k_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "t1k_tpu")
RSS_PERIOD_S = 0.05
BREAKDOWN_ENTRIES = 10


class Refused(Exception):
    """The run cannot go on: no result line, a non-zero exit."""


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(name: str, bench_path: str) -> dict:
    """The cell's entry, configuration and workload files, and the
    metrics BENCHMARK.json gives it."""
    if not os.path.exists(bench_path):
        raise Refused(f"{bench_path} is missing")
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(REPO, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "workloads", f"{name}.json")) as f:
        workload = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": config, "workload": workload,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def card_readings() -> dict:
    """nvidia-smi's name, SM clock and power limit, read beside the run."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, clock, power = (x.strip() for x in line.split(","))
    return {"name": name, "clocks_sm": clock, "power_limit": power}


class RssSampler:
    """The process's resident set, read from /proc/self/statm every
    RSS_PERIOD_S until stopped; `peak` in bytes."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _read(self) -> None:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * self._page
        self.peak = max(self.peak, rss)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._read()
            self._stop.wait(RSS_PERIOD_S)

    def __enter__(self):
        self._read()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._read()


class Cell:
    """The cell's inputs on disk and the chain that runs them."""

    def __init__(self, spec: dict, seed: int, work: str, device: str):
        self.config, self.workload = spec["config"], spec["workload"]
        self.work = work
        self.route = [*self.config["route_flags"], "--device", device]
        self.panel = traffic.build_panel(self.config["panel"], seed, ROOT,
                                         work)
        self.recs = traffic.read_fasta(self.panel)
        self.pool = []
        for i in range(self.workload["pool"]):
            prefix = os.path.join(work, f"sample{i}")
            pairs = traffic.make_sample(self.recs, self.workload["sample"],
                                        seed, i, prefix)
            self.pool.append((prefix, pairs))
        self.outputs = check.Outputs(self.config["outputs"])
        self.capture = None

    def argv(self, index: int, outdir: str) -> list:
        prefix = self.pool[index][0]
        return ["-f", self.panel, "-1", prefix + "_1.fq",
                "-2", prefix + "_2.fq", "--od", outdir, "-o", "s",
                *self.config["flags"], *self.route]

    def run(self, index: int) -> bool:
        """One sample through the program's chain; its outputs are read
        and deleted.  True when the chain exited with 0."""
        from t1k_tpu_torch.cli.run import main as program
        outdir = os.path.join(self.work, "out")
        if self.capture is not None:
            self.capture.open(index)
        try:
            ok = program(self.argv(index, outdir)) == 0
        except (Exception, SystemExit) as err:  # a failed sample is counted
            print(f"sample {index} failed: {err!r}", file=sys.stderr)
            ok = False
        if self.capture is not None:
            self.capture.close(index, ok)
        if ok and self.capture is not None:
            self.outputs.take(index, os.path.join(outdir, "s"))
        shutil.rmtree(outdir, ignore_errors=True)
        return ok


def window(cell: Cell, seconds: float, probes=None) -> dict:
    """The timed window: pool samples back to back until `seconds` have
    passed.  Returns the completions inside it and the loop's end."""
    done, failed, attempted = [], 0, 0
    with RssSampler() as rss:
        t0 = time.perf_counter()
        close = t0 + seconds
        k = 0
        while time.perf_counter() < close:
            index = (k + 1) % len(cell.pool)   # the warm-up ran sample 0
            k += 1
            attempted += 1
            rec = (probes.sample(index) if probes is not None
                   else {"index": index})
            a = time.perf_counter()
            ok = cell.run(index)
            b = time.perf_counter()
            rec.update(seconds=b - a, pairs=cell.pool[index][1], t0=a, t1=b,
                       ok=ok)
            if not ok:
                failed += 1
            elif b <= close:
                done.append(rec)
        t_end = time.perf_counter()
    return {"t0": t0, "t_end": t_end, "done": done, "failed": failed,
            "attempted": attempted, "rss_peak": rss.peak}


def end_to_end(names, setup_s: float, win: dict) -> dict:
    if not win["done"]:
        raise Refused("no sample completed inside the window")
    last = max(r["t1"] for r in win["done"])
    values = {
        "pairs_per_s": (sum(r["pairs"] for r in win["done"])
                        / (last - win["t0"]), "pairs/s"),
        "peak_rss_gib": (win["rss_peak"] / 2 ** 30, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    out = {}
    for m in names:
        if m["name"] not in values:
            raise Refused(f"the harness does not measure {m['name']!r}")
        v, unit = values[m["name"]]
        out[m["name"]] = {"value": v, "unit": unit}
    return out


def traced_window(cell: Cell, seconds: float, work: str):
    """The window under torch.profiler with the harness's probes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness.probes import Probes
    from harness.trace import ANCHOR, Trace

    probes = Probes()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
        anchor = time.perf_counter()
        with record_function(ANCHOR):
            pass
        win = window(cell, seconds, probes)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
    finally:
        probes.remove()
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    trace = Trace.from_file(path, anchor, win["t0"], win["t_end"])
    os.unlink(path)
    done_ids = {id(r) for r in win["done"]}
    run = TracedRun([r for r in probes.samples if id(r) in done_ids],
                    probes.samples, trace, probes.probe_work())
    return win, run


def per_layer(metrics, run: TracedRun) -> dict:
    out = {}
    for m in metrics:
        v = load_reader(ROOT, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(run: TracedRun) -> dict:
    from harness.trace import label_gaps
    ops = sorted(run.trace.by_name().items(), key=lambda kv: -kv[1])
    intervals = []
    for r in run.window:
        intervals.append(("sample", r["t0"], r["t1"]))
        intervals += [(n, a, b) for n, a, b in r["spans"]]
        intervals += [(n, a, b) for n, a, b, _ in r["stages"]]
    gaps = sorted(label_gaps(run.trace.gaps(), intervals).items(),
                  key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:BREAKDOWN_ENTRIES]],
            "idle_gaps": [[n, s] for n, s in gaps[:BREAKDOWN_ENTRIES]]}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def correctness(cell: Cell, win: dict, em_answer=None) -> dict:
    """The checks, each {value, limit}: every one must hold.  em_answer
    (the control's) replaces the program's EM answers."""
    t0 = time.perf_counter()
    panel, table, k = check.panel_facts(cell.recs)
    samples = {i: check.Sample(cell.pool[i][0], panel, table, k)
               for i in cell.outputs.first}
    got = check.judge(cell.capture.records, cell.outputs, samples,
                      [r[0] for r in cell.recs], em_answer)
    print(f"reference: pool samples {sorted(samples)} in "
          f"{time.perf_counter() - t0:.3f} s; exact pairs "
          f"{got['exact_pairs']}, band "
          f"items checked {got['band_checked']}, EM problems "
          f"{got['em_problems']}", file=sys.stderr)
    exact0 = ("screen_records_wrong", "screen_exact_missed",
              "screen_unfounded", "aligned_records_wrong",
              "assign_exact_unaligned", "classes_wrong",
              "em_table_wrong", "band_wrong", "record_missing")
    checks = {name: {"value": got[name], "limit": 0} for name in exact0}
    checks["em_gap"] = {"value": got["em_gap"], "limit": check.EM_GAP_LIMIT}
    if em_answer is not None:
        own = check.judge(cell.capture.records, cell.outputs, samples,
                          [r[0] for r in cell.recs])
        print(f"the program's own em_gap {own['em_gap']!r}", file=sys.stderr)
    checks["repeats_differ"] = {"value": cell.outputs.repeats_differ,
                                "limit": 0}
    checks["samples_failed"] = {"value": win["failed"], "limit": 0}
    for name, least in (("samples_checked", 1), ("exact_pairs", 1),
                        ("band_checked", 1), ("em_problems", 2)):
        checks[name] = {"value": got[name], "limit": least,
                        "at_least": True}
    return checks


def holds(checks: dict) -> bool:
    return all(c["value"] >= c["limit"] if c.get("at_least")
               else c["value"] <= c["limit"] for c in checks.values())


def main(argv=None, *, device: str = "cuda", require_card: bool = True,
         bench_path: str = None, em_answer=None) -> int:
    """The keyword arguments serve the harness's tests and the control:
    the device, whether a card is required, the BENCHMARK.json read, and
    answers put in the place of the program's EM answers."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        spec = load_cell(args.workload, bench_path
                         or os.path.join(REPO, "BENCHMARK.json"))
        if importlib.util.find_spec(PROGRAM) is None:
            raise Refused(f"the program ({PROGRAM}) is not in this checkout")
        import torch
        chips = spec["cell"]["chips"]
        if require_card and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
            raise Refused(f"the cell needs {chips} CUDA card(s); "
                          f"{torch.cuda.device_count()} visible")
        return _run(args, spec, device, em_answer)
    except Refused as why:
        print(f"port_bench: {why}", file=sys.stderr)
        return 2


def _run(args, spec: dict, device: str, em_answer) -> int:
    import torch

    from harness.capture import Capture
    cuda = device.startswith("cuda")
    work = tempfile.mkdtemp(prefix="port_bench-")
    try:
        cell = Cell(spec, args.seed, work, device)
        if not cell.run(0):
            raise Refused("the warm-up sample failed")
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_PROCESS
        print(f"set-up {setup_s:.3f} s", file=sys.stderr)

        run = None
        cell.capture = Capture()
        try:
            if args.trace:
                win, run = traced_window(cell, args.seconds, work)
            else:
                win = window(cell, args.seconds)
        finally:
            cell.capture.remove()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        result = {"correct": False, "attempted": win["attempted"],
                  "failed": win["failed"]}
        if args.trace:
            result["metrics"] = per_layer(spec["per_layer"], run)
        else:
            result["metrics"] = end_to_end(spec["end_to_end"], setup_s, win)
        result["device"] = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": spec["cell"]["chips"],
            "memory_peak_bytes": int(memory_peak)}
        if run is not None:
            result["device"]["busy_s"] = run.trace.busy_s()
            result["device"]["window_s"] = run.trace.window_s
            result["breakdown"] = breakdown(run)
            run = None
        result["card"] = card_readings() if cuda else {}
        result["samples"] = {
            "completed": len(win["done"]),
            "seconds": [r["seconds"] for r in win["done"]]}

        # the program's state goes before the reference runs
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = correctness(cell, win, em_answer)
        result["correct"] = holds(checks)

        bad = forbidden_modules()
        if bad:
            raise Refused("modules loaded that the port must not load: "
                          + ", ".join(bad))
        result["checks"] = checks
        for name, c in checks.items():
            rel = ">=" if c.get("at_least") else "<="
            print(f"check {name} {c['value']} {rel} {c['limit']}",
                  file=sys.stderr)
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
