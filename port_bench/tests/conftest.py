"""Fixtures of the harness's CPU tests: the harness's folder on the
path, the `cuda` marker, and a copy of the harness with a tiny cell that
runs on the CPU through the kernels' plain versions."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

# the kernels' plain versions on a shared CPU: one intra-op thread keeps
# a tiny sample under a second where eight contend for minutes
torch.set_num_threads(1)

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)
for _p in (HARNESS, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = "tiny.candidates"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips elsewhere)")


def tiny_files(root: str) -> dict:
    """A configuration of 10 genes x 8 alleles and a cell of 300-pair
    samples, written as new files into the harness copy at `root`."""
    with open(os.path.join(root, "configs", "kir-rna.json")) as f:
        config = json.load(f)
    config["name"] = "tiny"
    config["panel"]["alleles_per_gene"] = 8
    with open(os.path.join(root, "configs", "tiny.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "workloads",
                           "kir-rna.candidates.json")) as f:
        workload = json.load(f)
    workload.update(config="tiny", pool=2)
    workload["sample"]["on_panel"]["pairs"] = 150
    workload["sample"]["near_miss"]["pairs"] = 50
    workload["sample"]["random"]["pairs"] = 100
    with open(os.path.join(root, "workloads", f"{TINY}.json"), "w") as f:
        json.dump(workload, f)
    return {"config": {"name": "tiny", "source": "tests",
                       "file": "port_bench/configs/tiny.json",
                       "reduced": [], "why": "a CPU test's cell"},
            "cell": {"name": TINY, "config": "tiny", "traffic": "candidates",
                     "chips": 1, "why": "a CPU test's cell"}}


@pytest.fixture(scope="session")
def tiny_copy(tmp_path_factory):
    """(harness copy's folder, its BENCHMARK.json) with the tiny cell
    added, every per-layer metric given to it too."""
    base = tmp_path_factory.mktemp("bench")
    root = str(base / "port_bench")
    shutil.copytree(HARNESS, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    extra = tiny_files(root)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(extra["config"])
    bench["workloads"].append(extra["cell"])
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(TINY)
    path = str(base / "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root, path


def load_run(root: str):
    """The copy's run.py as a module of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"port_bench_run_{abs(hash(root))}", os.path.join(root, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
