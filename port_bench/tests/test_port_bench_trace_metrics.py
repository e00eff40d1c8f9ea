"""The readers of the program's read-assignment spans and counters
(ra_*_s, hits_per_read, spec_used_pct) on synthetic records: their
values, their silence on a program that records none of them, the
eleven older readers unchanged by the new counters and by `t1k.`
ranges in the trace, and the tiny cell's traced run reporting them;
scripts/trace_split.py's labelling of idle gaps by the `t1k.` ranges."""

from __future__ import annotations

import copy
import json

import pytest

from harness.layers import TracedRun, load_reader
from harness.trace import ANCHOR, Trace

from conftest import HARNESS, TINY, load_run

NEW = ("ra_prepare_s", "ra_begin_s", "ra_dispatch_s", "ra_wait_s",
       "ra_finish_s", "hits_per_read", "spec_used_pct", "ra_fullspan_s",
       "ra_chain_s")
OLD = ("refset_load_s", "extract_s", "screen_build_s", "screen_decided_pct",
       "read_assignment_s", "deferred_items", "em_s", "analyze_s",
       "band_roofline_pct", "probe_roofline_pct", "device_idle_pct")
PARTS = ("prepare", "begin", "dispatch", "wait", "finish")


def _events(annotations=False):
    base = 5_000_000
    ev = [{"ph": "X", "cat": "user_annotation", "name": ANCHOR, "ts": base,
           "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "void thread_narrow_kernel<1>",
           "ts": base + 100, "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "probe_kernel",
           "ts": base + 500, "dur": 100}]
    if annotations:
        ev += [{"ph": "X", "cat": "user_annotation",
                "name": "t1k.read_assignment", "ts": base + 50, "dur": 800},
               {"ph": "X", "cat": "user_annotation",
                "name": "t1k.read_assignment.begin", "ts": base + 60,
                "dur": 300},
               {"ph": "X", "cat": "user_annotation", "name": "t1k.extract",
                "ts": base + 400, "dur": 50}]
    return ev


def _stage(name, t0, t1, **counters):
    return (name, t0, t1, counters)


def _traced_counters(scale):
    """What a traced stage record adds: span seconds and uses, and the
    engine's counters."""
    c = {f"{p}_seconds": scale * (i + 1) * 0.1 for i, p in enumerate(PARTS)}
    c.update({f"{p}_span_count": 1 for p in PARTS})
    c.update(engine_read_count=1000 * scale, hit_count=50_000 * scale,
             overlap_count=4000 * scale, gap_item_count=600 * scale,
             spec_item_count=400 * scale, spec_item_used_count=100 * scale,
             hit_seconds=0.2 * scale, replay_seconds=0.1 * scale,
             chain_seconds=0.3 * scale, fullspan_seconds=0.4 * scale)
    return c


def _samples(traced=True):
    def extra(scale):
        return _traced_counters(scale) if traced else {}
    return [
        {"index": 1, "spans": [("refset_load", 0.0, 1.0),
                               ("extract", 1.0, 3.0)],
         "stages": [_stage("extraction_screen", 1.5, 3.0,
                           device_screened_reads=900,
                           device_decided_reads=855),
                    _stage("read_assignment", 3.0, 5.0,
                           deferred_item_count=1000, **extra(1)),
                    _stage("analyzer_read_assignment", 7.0, 7.5,
                           deferred_item_count=200, **extra(2)),
                    _stage("em_quantification", 5.0, 5.25)],
         "band_bytes": 4000, "band_ops": 2_000_000, "band_items": 100},
        {"index": 2, "spans": [("refset_load", 0.0, 0.5),
                               ("extract", 0.5, 1.5),
                               ("analyze", 6.0, 8.0)],
         "stages": [_stage("extraction_screen", 0.6, 1.5,
                           device_screened_reads=100,
                           device_decided_reads=45),
                    _stage("read_assignment", 2.0, 3.0,
                           deferred_item_count=600, **extra(3)),
                    _stage("em_quantification", 3.0, 3.75)],
         "band_bytes": 1000, "band_ops": 1_000_000, "band_items": 50},
    ]


def _run(traced=True, annotations=False):
    trace = Trace.from_chrome(_events(annotations), 10.0, 10.0, 10.001)
    s = _samples(traced)
    return TracedRun(s, copy.deepcopy(s), trace, probe_work=(670, 0))


def _read(name, run):
    return load_reader(HARNESS, name)(run)


@pytest.mark.parametrize("i,part", list(enumerate(PARTS)))
def test_span_readers_sum_both_stages_per_sample(i, part):
    # scales 1 + 2 (sample 1, genotyper and analyzer) and 3 (sample 2)
    want = (1 + 2 + 3) * (i + 1) * 0.1 / 2
    assert _read(f"ra_{part}_s", _run()) == pytest.approx(want)


@pytest.mark.parametrize("name,per_scale", [("ra_chain_s", 0.3),
                                            ("ra_fullspan_s", 0.4)])
def test_engine_phase_readers_sum_both_stages_per_sample(name, per_scale):
    assert _read(name, _run()) == pytest.approx((1 + 2 + 3) * per_scale / 2)


def test_counter_readers():
    run = _run()
    assert _read("hits_per_read", run) == pytest.approx(50.0)
    assert _read("spec_used_pct", run) == pytest.approx(25.0)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_silent_without_the_program_counters(name):
    """A program that records no spans (the parent of this change, or an
    untraced run) leaves the metric out instead of failing."""
    assert _read(name, _run(traced=False)) is None


def test_counter_readers_silent_on_zero_denominators():
    run = _run()
    for r in run.samples:
        for _, _, _, c in r["stages"]:
            if "spec_item_count" in c:
                c["spec_item_count"] = 0
                c["engine_read_count"] = 0
    assert _read("spec_used_pct", run) is None
    assert _read("hits_per_read", run) is None


@pytest.mark.parametrize("name", OLD)
def test_old_readers_unchanged_by_counters_and_ranges(name):
    plain = _read(name, _run(traced=False))
    assert _read(name, _run(traced=True)) == plain
    assert _read(name, _run(traced=True, annotations=True)) == plain


def test_annotations_are_no_device_work():
    plain, annotated = _run(annotations=False), _run(annotations=True)
    assert annotated.trace.ops == plain.trace.ops
    assert annotated.trace.gaps() == plain.trace.gaps()


def test_tiny_cell_traced_run_reports_the_new_metrics(tiny_copy, capsys):
    root, bench_path = tiny_copy
    run = load_run(root)
    rc = run.main(["--workload", TINY, "--seed", "2147483711", "--seconds",
                   "6", "--trace", "1"], device="cpu", require_card=False,
                  bench_path=bench_path)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    result = json.loads(out.out.splitlines()[-1])
    assert result["correct"] is True
    got = result["metrics"]
    for name in NEW:
        assert name in got, name
    assert 0 <= got["spec_used_pct"]["value"] <= 100
    assert got["hits_per_read"]["value"] > 0
    spans = sum(got[f"ra_{p}_s"]["value"] for p in PARTS)
    # the spans cover the genotyper's and the analyzer's stages; the
    # genotyper's alone is read_assignment_s
    assert spans >= 0.9 * got["read_assignment_s"]["value"]


# ------------------------------------------------ scripts/trace_split.py
def _split_module():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(HARNESS), "scripts",
                        "trace_split.py")
    spec = importlib.util.spec_from_file_location("trace_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_split_maps_ranges_by_the_anchor():
    split = _split_module()
    got = split.t1k_ranges(_events(annotations=True), 10.0)
    assert [n for n, _, _ in got] == ["read_assignment",
                                      "read_assignment.begin", "extract"]
    _, a, b = got[1]
    assert (a, b) == (pytest.approx(10.00006), pytest.approx(10.00036))
    assert split.t1k_ranges(_events(annotations=False), 10.0) == []


def test_split_labels_gaps_by_the_innermost_range():
    """Gaps inside `read_assignment.begin` go to it, gaps inside the
    stage but outside its spans to the bare stage."""
    split = _split_module()
    run = _run(annotations=True)
    run.window = [{"t0": 10.0, "t1": 10.001, "spans": [], "stages": []}]
    ranges = split.t1k_ranges(_events(annotations=True), 10.0)
    got = dict(split.idle_by_range(run, ranges))
    # device idle: [0, 100), [300, 500), [600, 1000) us after the anchor
    assert got["read_assignment.begin"] == pytest.approx(100e-6)
    assert got["extract"] == pytest.approx(50e-6)
    assert got["read_assignment"] == pytest.approx(10e-6 + 40e-6 + 50e-6
                                                   + 250e-6)
    assert got["sample"] == pytest.approx(50e-6 + 150e-6)
    assert sum(got.values()) == pytest.approx(sum(
        b - a for a, b in run.trace.gaps()))


def test_split_checks_the_spans_against_the_stages():
    split = _split_module()
    got = split.ra_check(_run())
    assert got["records"] == 3
    # the synthetic analyzer record: 1,200 + 800 items against 200
    assert got["items_equal"] is False
    assert got["used_le_spec"] is True
    assert got["stage_s"] == pytest.approx((2.0 + 0.5 + 1.0) / 2)
    assert got["span_s"]["finish"] == pytest.approx((1 + 2 + 3) * 0.5 / 2)
    assert got["engine"]["read_assignment.fullspan_seconds"] == pytest.approx(
        (1 + 3) * 0.4 / 2)


def test_split_on_the_tiny_cell(tiny_copy, capsys):
    """The script end to end: the harness's traced run as it is, with the
    idle gaps labelled by the program's ranges and the spans checked."""
    root, bench_path = tiny_copy
    from_file = Trace.__dict__["from_file"]
    rc = _split_module().main(
        ["--workload", TINY, "--seed", "2147483713", "--seconds", "6",
         "--trace", "1"], harness=root, device="cpu", require_card=False,
        bench_path=bench_path)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    result = json.loads(out.out.splitlines()[-1])
    assert result["correct"] is True
    split = result["breakdown"]
    labels = dict(split["idle_gaps_ranges"])
    assert split["t1k_ranges"] > 0
    assert "read_assignment.begin" in labels
    assert "read_assignment.finish" in labels
    check = split["ra_check"]
    assert check["records"] > 0 and check["items_equal"]
    assert check["used_le_spec"] and check["coverage"] >= 0.9
    assert Trace.__dict__["from_file"] is from_file   # the harness restored
