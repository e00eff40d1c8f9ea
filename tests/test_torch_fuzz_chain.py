"""The port's differential fuzz layer on the chains, on the CPU.

Fixed seeds of scripts/fuzz_cases.py's driver, BAM and SMART-seq cases
(copies of tests/fuzz_driver.py's, fuzz_bam.py's and fuzz_smartseq.py's)
run through three routes: the JAX package's native route
(t1k_tpu.<module>.main, T1K_BACKEND=native), the port's native route
(--backend native --emBackend native) and the port's gpu route on the
CPU (--backend gpu --emBackend gpu --device cpu: the kernels' plain
versions; the plate's second pass as --cohortEm).  Every output of every
run is byte-identical across the three (`_assign.tsv` as sorted lines,
provenance files left out).  The driver seeds hold a -b chain, paired,
single-end and interleaved input, the presets, --frac, --cov,
--crossGeneRate, barcodes with --barcodeRange and --barcodeWhitelist,
--noExtraction, --post-varMaxGroup and --stage restarts (1 and 2); the
BAM seeds random flag mixes with CB and UB tags; the plate seed pins the
--cohortEm pass's post analysis (its per-cell VCF, which that pass once
left out).

Also three seeds each of tests/fuzz_tools.py and tests/fuzz_vcfdb.py
(loaded by file path), with the JAX package's tools and db modules in
the reference scripts' place and the port's as their own: the port's
merge, group_samples, copynumber, vcf_to_dat and gtf_to_dat write the
JAX package's bytes."""

import functools
import importlib
import importlib.util
import io
import os
import sys
import types

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

spec = importlib.util.spec_from_file_location(
    "torch_fuzz_routes", os.path.join(HERE, "torch_fuzz_routes.py"))
routes = importlib.util.module_from_spec(spec)
spec.loader.exec_module(routes)
fc, triangle = routes.fc, routes.triangle


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1, 4, 5, 6, 13, 52])
def test_driver_case_matches_jax_native(seed, tmp_path, monkeypatch):
    triangle(fc.make_case("driver", seed, str(tmp_path)), monkeypatch)


@pytest.mark.parametrize("seed", [0, 2, 4, 5])
def test_bam_case_matches_jax_native(seed, tmp_path, monkeypatch):
    triangle(fc.make_case("bam", seed, str(tmp_path)), monkeypatch)


def test_smartseq_cohort_case_matches_jax_native(tmp_path, monkeypatch):
    case = fc.make_case("smartseq", 0, str(tmp_path))
    triangle(case, monkeypatch)
    vcfs = [os.path.join(root, n)
            for root, _, names in os.walk(os.path.join(case.dir, "cpu"))
            for n in names if n.endswith("_reduced_allele.vcf")]
    assert len(vcfs) == 4


# ---------------------------------------- tests/fuzz_tools.py, fuzz_vcfdb.py

# the reference script each fuzzer runs -> the JAX package's module and
# the function its main writes the standard output through
TOOLS = {"t1k-merge.py": ("tools.merge", "merge_genotypes"),
         "scripts/GroupSample.py": ("tools.group_samples", "group_samples"),
         "t1k-copynumber.py": ("tools.copynumber", "infer_copy_number")}
VCFDB = {"vcf_database/CombineVcf.pl": ("db.vcf_to_dat", "combine"),
         "vcf_database/CombinedVcfToDat.pl": ("db.vcf_to_dat", "todat"),
         "hprc_database/GtfToDat.pl": ("db.gtf_to_dat", "gtf")}


def _tool(package, module, argv):
    """`<package>.<module>.main(argv)` in this process, the output stream
    its main binds at definition time redirected to a buffer."""
    mod = importlib.import_module(f"{package}.{module}")
    fn = dict(TOOLS.values())[module]
    orig = getattr(mod, fn)
    buf = io.StringIO()
    setattr(mod, fn, functools.partial(orig, out=buf))
    try:
        got = routes.stdout_of(mod.main, argv)
    finally:
        setattr(mod, fn, orig)
    got.stdout = buf.getvalue()
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tools_case_writes_the_jax_packages_bytes(seed, tmp_path,
                                                  monkeypatch):
    mod = routes.load("fuzz_tools", os.path.join(HERE, "fuzz_tools.py"))
    runs = routes.Pairs()
    monkeypatch.setattr(mod, "OUT", str(tmp_path))
    monkeypatch.setattr(mod, "_ref", lambda script, args: runs.ref(_tool(
        "t1k_tpu", TOOLS[script][0], args)))
    monkeypatch.setattr(mod, "_mine", lambda module, args: runs.mine(_tool(
        "t1k_tpu_torch", module.split(".", 1)[1], args)))
    assert mod.run_case(seed) == "ok"
    runs.check(2)


def _vcfdb_run(runs, cmd, **_):
    """fuzz_vcfdb's subprocess.run: a reference script runs the JAX
    package's module, `python -m` the port's."""
    if cmd[0] == "perl":
        script = next(s for s in VCFDB if cmd[1].endswith(s))
        module, sub = VCFDB[script]
        return runs.ref(routes.stdout_of(routes.jax_main(module),
                                         [sub] + cmd[2:]))
    assert cmd[:2] == [sys.executable, "-m"]
    return runs.mine(routes.stdout_of(
        fc.port_main(cmd[2].split(".", 1)[1]), cmd[3:]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vcfdb_case_writes_the_jax_packages_bytes(seed, tmp_path,
                                                  monkeypatch):
    """The combined table and the GTF's .dat.  (The fuzzer's case
    directory, case_<seed>, holds an underscore, which the combine step
    turns into an allele's '*' as CombineVcf.pl does, so the combined
    table's .dat fails on both packages alike.)"""
    mod = routes.load("fuzz_vcfdb", os.path.join(HERE, "fuzz_vcfdb.py"))
    runs = routes.Pairs()
    monkeypatch.setattr(mod, "OUT", str(tmp_path))
    monkeypatch.setattr(mod, "subprocess", types.SimpleNamespace(
        run=functools.partial(_vcfdb_run, runs)))
    assert mod.run_case(seed) == "ok"
    runs.check(2)
