"""The port stands on its own: importing any module of t1k_tpu_torch (or
chip_smoke.py) loads nothing of the JAX package and no jax, and the
port's copies of the native engine's oracles equal the originals."""

import ast
import glob
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

import t1k_tpu_torch
from t1k_tpu.constants import encode_seq
from t1k_tpu.native import align_global as host_align_global
from t1k_tpu.native import align_global_batch as host_align_global_batch
from t1k_tpu.native import em_quantify as host_em_quantify
from t1k_tpu_torch.native import align_global, align_global_batch, em_quantify

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.dirname(t1k_tpu_torch.__file__)

_CHECK_MODULES = (
    "import sys\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(\n"
    "    'jax.') or m == 't1k_tpu' or m.startswith('t1k_tpu.'))\n"
    "assert not bad, bad\n")


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def _port_modules():
    names = ["t1k_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], "t1k_tpu_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_the_jax_package():
    names = _port_modules()
    assert {"t1k_tpu_torch.native", "t1k_tpu_torch.core.pipeline",
            "t1k_tpu_torch.cli.extract", "t1k_tpu_torch.io.refset",
            "t1k_tpu_torch.utils.observability", "t1k_tpu_torch.config",
            "t1k_tpu_torch.core.fragment", "t1k_tpu_torch.core.variant",
            "t1k_tpu_torch.core.analyzer", "t1k_tpu_torch.cli.analyze",
            "t1k_tpu_torch.cli.run", "t1k_tpu_torch.io.bam",
            "t1k_tpu_torch.cli.bamextract",
            "t1k_tpu_torch.parallel.distributed",
            "t1k_tpu_torch.tools.smartseq", "t1k_tpu_torch.tools.merge",
            "t1k_tpu_torch.tools.copynumber",
            "t1k_tpu_torch.tools.group_samples",
            "t1k_tpu_torch.tools.extract_sam_hits",
            "t1k_tpu_torch.tools.simulate",
            "t1k_tpu_torch.parallel.mesh",
            "t1k_tpu_torch.parallel.multihost",
            "t1k_tpu_torch.ops.kmer", "t1k_tpu_torch.db",
            "t1k_tpu_torch.db.parse_dat", "t1k_tpu_torch.db.add_gene_coord",
            "t1k_tpu_torch.db.build", "t1k_tpu_torch.db.vcf_to_dat",
            "t1k_tpu_torch.db.gtf_to_dat",
            "t1k_tpu_torch.db.variant_gene_db"} <= set(names)
    code = "".join(f"import {n}\n" for n in names) + _CHECK_MODULES
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_chip_smoke_imports_without_the_jax_package():
    """chip_smoke.py's module-level imports load neither; no import
    statement anywhere in it or in the package names either, and none
    imports importlib or calls __import__."""
    proc = _run("import chip_smoke\n" + _CHECK_MODULES)
    assert proc.returncode == 0, proc.stderr[-3000:]
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            # a module name built at run time would hide from this check
            assert not (isinstance(node, ast.Name)
                        and node.id == "__import__"), path
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("t1k_tpu", "jax", "importlib"), \
                    f"{path}: imports {m}"


def test_card_scripts_name_no_module_of_the_jax_package():
    """No string in chip_smoke.py or scripts/*.py names a module of
    t1k_tpu as a dotted name: not as a `-m` argument, not in `-c` code,
    not in a docstring.  So no baseline on the card runs the JAX package.
    Slash paths (t1k_tpu/ops/em.py:213) name the source a kernel
    replaces and stay allowed."""
    dotted = re.compile(r"\bt1k_tpu\.[A-Za-z_]")
    files = [os.path.join(REPO, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(REPO, "scripts", "*.py")))
    assert len(files) > 1
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and dotted.search(node.value)):
                found.append(f"{os.path.relpath(path, REPO)}:{node.lineno}: "
                             f"{dotted.search(node.value).group()}")
    assert not found, found


def test_align_global_copy_matches_the_original_on_the_golden_cases():
    cases = 0
    with open(os.path.join(HERE, "golden", "align_global.tsv")) as f:
        for line in f:
            _, _, t, p, score, _ = line.rstrip("\n").split("\t")
            tc = encode_seq("" if t == "-" else t)
            pc = encode_seq("" if p == "-" else p)
            got = align_global(tc, pc)
            want = host_align_global(tc, pc)
            assert got[0] == want[0] == int(score)
            assert np.array_equal(got[1], want[1])
            cases += 1
    assert cases == 400


def test_align_global_batch_copy_matches_the_original():
    rng = np.random.default_rng(2)
    ts, ps = [], []
    for _ in range(300):
        t = rng.integers(0, 5, int(rng.integers(0, 160))).astype(np.int8)
        p = t[int(rng.integers(0, 4)):].copy()
        mut = rng.random(len(p)) < 0.08
        p[mut] = rng.integers(0, 5, int(mut.sum()))
        ts.append(t)
        ps.append(p)
    got = align_global_batch(ts, ps)
    want = host_align_global_batch(ts, ps)
    assert len(got) == len(want) == 300
    for g, w, t, p in zip(got, want, ts, ps):
        assert g.tobytes() == w.tobytes()
        assert g.tobytes() == align_global(t, p)[1].tobytes()


@pytest.mark.parametrize("seed", [3, 8])
def test_em_quantify_copy_is_bit_identical_to_the_original(seed):
    rng = np.random.default_rng(seed)
    n_ec, n_rg, n_genes = 120, 700, 6
    n_alleles = 2 * n_ec
    ec_to_alleles = [[] for _ in range(n_ec)]
    for a in range(n_alleles):
        ec_to_alleles[a % n_ec].append(a)
    offs, ecs = [0], []
    for _ in range(n_rg):
        ecs.extend(rng.choice(n_ec, size=int(rng.integers(1, 9)),
                              replace=False).tolist())
        offs.append(len(ecs))
    args = (ec_to_alleles, (np.array(offs, np.int64), np.array(ecs, np.int32)),
            rng.choice([1.0, 0.5, 2.0, 3.0], n_rg),
            rng.integers(900, 1400, n_alleles).astype(np.int32),
            rng.integers(0, 3, n_alleles).astype(np.int32),
            rng.integers(1, 4, n_alleles).astype(np.int32),
            (np.arange(n_alleles) % n_genes).astype(np.int32),
            (np.arange(n_alleles) % (n_ec // 3)).astype(np.int32),
            n_genes, n_ec // 3, 0.15, [0.0, -1.5][seed % 2], 1000)
    it, count = em_quantify(*args)
    want_it, want = host_em_quantify(*args)
    assert it == want_it > 3
    assert count.tobytes() == want.tobytes()
