"""Importing the harness loads no jax, jaxlib, flax or t1k_tpu (compared
whole on the top-level name: t1k_tpu_torch is the program), the plain
reference loads nothing of the program either, and a checkout that
holds only BENCHMARK.json and the harness's folder exits with an error
and prints no result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from conftest import HARNESS, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "t1k_tpu"}
PROBE = """
import sys
sys.path[:0] = [{harness!r}, {repo!r}]
{imports}
{extra}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {forbidden!r}))
print("t1k_tpu_torch" in tops)
"""


HARNESS_IMPORTS = """import run
from harness import capture, check, control, layers, probes, roofline
from harness import trace, traffic
from reference import band, em, exact, groups"""


def _probe(extra: str = "", imports: str = HARNESS_IMPORTS) -> list:
    code = PROBE.format(harness=HARNESS, repo=REPO, extra=extra,
                        imports=imports, forbidden=FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=HARNESS, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_harness_and_reference_load_no_jax():
    assert _probe() == ["[]", "False"]


def test_reference_loads_nothing_of_the_program():
    lines = _probe(imports="from reference import band, em, exact, groups\n"
                   "import reference.exact as x\n"
                   "x.Panel(['ACGT' * 20]).pair_holders(\n"
                   "    x.encode('ACGT' * 8)[None, :],\n"
                   "    x.encode('ACGT' * 8)[None, :])")
    assert lines == ["[]", "False"]


def test_program_loads_no_jax():
    lines = _probe("import t1k_tpu_torch.cli.run\n"
                   "import t1k_tpu_torch.core.analyzer")
    assert lines == ["[]", "True"]


def test_harness_alone_exits_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HARNESS, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "kir-rna.candidates", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "t1k_tpu_torch" in out.stderr
