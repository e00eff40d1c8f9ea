"""run.py finds a configuration, a cell and a per-layer metric that are
added as new files, without any file of the harness being edited, and
drives a whole run of the new cell on the CPU."""

from __future__ import annotations

import json
import os

from conftest import HARNESS, TINY, load_run

EXTRA_METRIC = "samples_seen"


def _snapshot(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d or os.sep + "build" in d:
            continue
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_new_files_are_found(tiny_copy, tmp_path):
    root, bench_path = tiny_copy
    before = _snapshot(root)
    metric = os.path.join(root, "metrics", f"{EXTRA_METRIC}.py")
    with open(metric, "w") as f:
        f.write("def read(run):\n    return float(len(run.samples))\n")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": EXTRA_METRIC, "unit": "samples", "better": "higher",
        "source": "host_clock", "layer": "driver", "moves": "pairs_per_s",
        "workloads": [TINY]})
    path = str(tmp_path / "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    try:
        run = load_run(root)
        cell = run.load_cell(TINY, path)
        assert cell["config"]["name"] == "tiny"
        assert cell["workload"]["pool"] == 2
        names = [m["name"] for m in cell["per_layer"]]
        assert EXTRA_METRIC in names and "extract_s" in names
        # the cells of BENCHMARK.json itself do not get the new metric
        assert EXTRA_METRIC not in [
            m["name"] for m in run.load_cell("kir-rna.candidates",
                                             path)["per_layer"]]
        assert run.load_reader(root, EXTRA_METRIC)(
            type("R", (), {"samples": [1, 2, 3]})()) == 3.0
        after = _snapshot(root)
        del after[os.path.relpath(metric, root)]
        assert after == before
    finally:
        os.unlink(metric)


def test_tiny_cell_runs_end_to_end(tiny_copy, capsys):
    root, bench_path = tiny_copy
    run = load_run(root)
    rc = run.main(["--workload", TINY, "--seed", str(2 ** 31 + 5),
                   "--seconds", "6", "--trace", "0"], device="cpu",
                  require_card=False, bench_path=bench_path)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    result = json.loads(out.out.splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"pairs_per_s", "peak_rss_gib",
                                      "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert out.err.rstrip().splitlines()[-1].startswith("check ")


def test_traced_run_reports_per_layer_metrics(tiny_copy, capsys):
    root, bench_path = tiny_copy
    run = load_run(root)
    rc = run.main(["--workload", TINY, "--seed", "17", "--seconds", "6",
                   "--trace", "1"], device="cpu", require_card=False,
                  bench_path=bench_path)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    result = json.loads(out.out.splitlines()[-1])
    assert result["correct"] is True
    got = result["metrics"]
    for name in ("refset_load_s", "extract_s", "screen_build_s",
                 "screen_decided_pct", "read_assignment_s",
                 "deferred_items", "em_s", "analyze_s"):
        assert got[name]["value"] > 0, name
    # the CPU runs no kernel: no roofline is read, and none reads 0
    assert "band_roofline_pct" not in got
    assert "probe_roofline_pct" not in got
    assert result["device"]["window_s"] > 0
    assert len(result["breakdown"]["idle_gaps"]) > 0


def test_refuses_without_card_or_program(tmp_path, capsys):
    run = load_run(HARNESS)
    # a cell that is not in BENCHMARK.json
    assert run.main(["--workload", "none.such", "--seed", "1",
                     "--seconds", "1"]) == 2
    # no BENCHMARK.json
    only = tmp_path / "only"
    only.mkdir()
    assert run.main(["--workload", "kir-rna.candidates", "--seed", "1",
                     "--seconds", "1"],
                    bench_path=str(only / "BENCHMARK.json")) == 2
    # the CPU: no card
    assert run.main(["--workload", "kir-rna.candidates", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
