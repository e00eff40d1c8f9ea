"""Label the card's idle time in a traced benchmark run by the port's own
`t1k.*` ranges, and check read assignment's spans against its stage
records.

    python3 scripts/trace_split.py --workload kir-rna.candidates \\
        --seed 3300002601 --seconds 51 --trace 1

runs `port_bench/run.py` of the checkout in the working directory with
these arguments, as it is, and adds three keys to the `breakdown` of
its result line:

  idle_gaps_ranges  idle seconds by label, as `breakdown.idle_gaps`
                    labels them, with every `t1k.*` range of the window's
                    trace as one more interval, named without the prefix
                    (the stage `read_assignment`, its span
                    `read_assignment.finish`, the boundary `extract`);
                    each part of a gap goes to the innermost interval
                    that covers it (harness/trace.py label_gaps)
  t1k_ranges        the number of those ranges
  ra_check          a sample's read-assignment stages (genotyper and
                    analyzer): their seconds, each span's seconds, the
                    spans' share of the stages (`coverage`); in every
                    record, whether gap-fill plus speculative items equal
                    deferred_item_count and the speculative items read
                    are at most those emitted; and each stage's engine
                    counters and phase seconds a sample

The ranges are mapped to the harness's clock by its anchor annotation,
as harness/trace.py maps the device's work.  A checkout whose program
opens no `t1k.*` range (one before the port traced) gets an empty split.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

PREFIX = "t1k."
PARTS = ("prepare", "begin", "dispatch", "wait", "finish")
SPAN_SECONDS = tuple(f"{p}_seconds" for p in PARTS)
STAGES = ("read_assignment", "analyzer_read_assignment")


def t1k_ranges(events: list, anchor_s: float) -> list:
    """The program's ranges [(name without the prefix, start_s, end_s)]
    of a Chrome trace, on the clock on which the anchor opened at
    `anchor_s`."""
    from harness.trace import ANCHOR

    marks = [e["ts"] for e in events
             if e.get("ph") == "X" and e.get("name") == ANCHOR]
    if not marks:
        return []
    shift = anchor_s - marks[0] / 1e6
    return [(e["name"][len(PREFIX):], e["ts"] / 1e6 + shift,
             (e["ts"] + e.get("dur", 0)) / 1e6 + shift)
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)]


def idle_by_range(run, ranges: list) -> list:
    """[[label, idle seconds]], largest first: the harness's intervals
    (samples, its spans, the stage records) and the program's ranges."""
    from harness.trace import label_gaps

    intervals = list(ranges)
    for r in run.window:
        intervals.append(("sample", r["t0"], r["t1"]))
        intervals += [(n, a, b) for n, a, b in r["spans"]]
        intervals += [(n, a, b) for n, a, b, _ in r["stages"]]
    gaps = label_gaps(run.trace.gaps(), intervals)
    return [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])]


def ra_check(run) -> dict:
    """The read-assignment stages of the window's samples, per sample."""
    out = {"stage_s": 0.0, "span_s": {p: 0.0 for p in PARTS},
           "records": 0, "items_equal": True, "used_le_spec": True,
           "engine": {}}
    for r in run.window:
        for name, a, b, c in r["stages"]:
            if name not in STAGES:
                continue
            out["records"] += 1
            out["stage_s"] += b - a
            for p in PARTS:
                out["span_s"][p] += c.get(f"{p}_seconds", 0.0)
            if "gap_item_count" not in c:
                continue
            out["items_equal"] &= (c["gap_item_count"] + c["spec_item_count"]
                                   == c["deferred_item_count"])
            out["used_le_spec"] &= (c["spec_item_used_count"]
                                    <= c["spec_item_count"])
            for k, v in c.items():
                if (k.endswith(("_seconds", "_count"))
                        and not k.endswith("_span_count")
                        and k not in SPAN_SECONDS):
                    key = f"{name}.{k}"
                    out["engine"][key] = out["engine"].get(key, 0) + v
    n = max(len(run.window), 1)
    out["stage_s"] /= n
    out["span_s"] = {p: v / n for p, v in out["span_s"].items()}
    out["engine"] = {k: v / n for k, v in out["engine"].items()}
    spans = sum(out["span_s"].values())
    out["coverage"] = spans / out["stage_s"] if out["stage_s"] else None
    return out


def main(argv, harness: str = None, **bench_kwargs) -> int:
    """Runs `harness`/run.py (default: port_bench/ of the working
    directory) with `argv`; `bench_kwargs` go to its main (the device, a
    BENCHMARK.json, as the harness's tests give them)."""
    harness = harness or os.path.join(os.getcwd(), "port_bench")
    spec = importlib.util.spec_from_file_location(
        "port_bench_run", os.path.join(harness, "run.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)   # puts port_bench/ on sys.path
    from harness.trace import Trace

    ranges = []
    from_chrome = Trace.from_chrome
    from_file_before = Trace.__dict__["from_file"]

    def from_file(cls, path, anchor_s, t0, t1):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ranges[:] = t1k_ranges(events, anchor_s)
        return from_chrome(events, anchor_s, t0, t1)

    Trace.from_file = classmethod(from_file)
    breakdown = bench.breakdown

    def split_breakdown(run):
        out = breakdown(run)
        out["idle_gaps_ranges"] = idle_by_range(run, ranges)
        out["t1k_ranges"] = len(ranges)
        out["ra_check"] = ra_check(run)
        return out

    bench.breakdown = split_breakdown
    try:
        return bench.main(argv, **bench_kwargs)
    finally:
        Trace.from_file = from_file_before


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
