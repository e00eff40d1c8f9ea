"""The port's differential fuzz layer on the stage CLIs, on the CPU.

Fixed seeds of scripts/fuzz_cases.py's genotyper, analyzer and extractor
cases (copies of tests/fuzz_genotyper.py's, fuzz_analyzer.py's and
fuzz_extractor.py's) run through three routes: the JAX package's native
route (t1k_tpu.<module>.main, T1K_BACKEND=native), the port's native
route (--backend native --emBackend native) and the port's gpu route on
the CPU (--backend gpu --emBackend gpu --device cpu: the kernels' plain
versions, with the cases' --deviceCandidates).  Every output of every
run is byte-identical across the three (`_assign.tsv` as sorted lines,
provenance files left out).  The genotyper seeds hold --deviceCandidates
(1, 2), the -a EM bypass (2, 8), --crossGeneRate, --frac and --cov; the
analyzer seeds novel SNPs in rna and dna panels, --relaxIntronAlign and
--varMaxGroup -1; the extractor seeds read ranges, barcode slices, a
whitelist and split input files.

Also: for 20 seeds of each of the six fuzzers, scripts/fuzz_cases.py
writes the bytes (panels, reads, BAMs, list and abundance files) and the
argument lists of tests/fuzz_<fuzzer>.py, loaded by file path with its
reference binary and its own runs replaced by recorders; and three seeds
of tests/fuzz_db.py, in which the port's db.parse_dat writes the JAX
package's bytes in every mode."""

import hashlib
import importlib
import importlib.util
import io
import os
import shutil
import sys
import types

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))



spec = importlib.util.spec_from_file_location(
    "torch_fuzz_routes", os.path.join(HERE, "torch_fuzz_routes.py"))
routes = importlib.util.module_from_spec(spec)
spec.loader.exec_module(routes)
fc, triangle, _load = routes.fc, routes.triangle, routes.load


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1, 2, 3, 8, 10, 14])
def test_genotyper_case_matches_jax_native(seed, tmp_path, monkeypatch):
    triangle(fc.make_case("genotyper", seed, str(tmp_path)), monkeypatch)


@pytest.mark.parametrize("seed", [1, 3, 5, 9])
def test_analyzer_case_matches_jax_native(seed, tmp_path, monkeypatch):
    triangle(fc.make_case("analyzer", seed, str(tmp_path)), monkeypatch)


@pytest.mark.parametrize("seed", [0, 2, 4, 6])
def test_extractor_case_matches_jax_native(seed, tmp_path, monkeypatch):
    triangle(fc.make_case("extractor", seed, str(tmp_path)), monkeypatch)


# ------------------------------------------------- the generators' bytes

def _digests(d):
    """relative path -> sha256 of every file under d."""
    out = {}
    for root, _, names in os.walk(d):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


class Recorder:
    """Stands in for a JAX fuzzer's reference binary and its own runs:
    records each run of the package ((module, argv, cwd)) and, at every
    call, the digests of the files then under `root`; every run exits 0
    and writes nothing, so the fuzzer's comparisons pass on empty
    outputs and it draws on as after a passing comparison."""

    def __init__(self, root):
        self.root, self.runs, self.files = root, [], {}

    def _snap(self):
        self.files.update(_digests(self.root))

    def subprocess_run(self, cmd, cwd=None, **_):
        self._snap()
        if cmd[:2] == [sys.executable, "-m"]:
            self.runs.append((cmd[2].replace("t1k_tpu.", "", 1),
                              list(cmd[3:]), cwd))
        return types.SimpleNamespace(returncode=0, stdout=b"", stderr=b"")

    def main(self, module):
        def run(argv):
            self._snap()
            self.runs.append((module, list(argv), None))
            return 0
        return run

    def extract_from_bam(self, bam, coord, ref, prefix, bc_field="",
                         umi_field="", **_):
        assert coord == ref
        argv = ["-b", bam, "-f", coord, "-o", prefix]
        argv += ["--barcode", bc_field] if bc_field else []
        argv += ["--UMI", umi_field] if umi_field else []
        self._snap()
        self.runs.append(("cli.bamextract", argv, None))


def _empty_when_missing(path, mode="r", *args, **kw):
    """open(), but a missing file read gives an empty one (the outputs
    the recorders did not write)."""
    if "r" in mode and not os.path.exists(path):
        return io.BytesIO() if "b" in mode else io.StringIO()
    return open(path, mode, *args, **kw)


def _load_fuzzer(fuzzer, monkeypatch, tmp_path):
    """tests/fuzz_<fuzzer>.py by file path, its driver's make_panel from
    the genotyper fuzzer loaded the same way, fuzz_bam's CYP2D6 alleles
    from a stand-in (fuzz_cases.cyp_alleles) and its import-time output
    directory under tmp_path."""
    geno = _load("fuzz_genotyper", os.path.join(HERE, "fuzz_genotyper.py"))
    monkeypatch.setitem(sys.modules, "tests.fuzz_genotyper", geno)
    if fuzzer == "genotyper":
        return geno
    if fuzzer == "bam":
        idx = tmp_path / "cyp2d6_idx"
        idx.mkdir()
        fc.cyp_alleles(str(idx / "cyp2d6_rna_seq.fa"))
        monkeypatch.setenv("T1K_CYP2D6_IDX", str(idx))
        makedirs = os.makedirs
        with monkeypatch.context() as m:
            m.setattr(os, "makedirs", lambda p, exist_ok=False: makedirs(
                str(tmp_path / "import") if p == "/tmp/bamfuzz" else p,
                exist_ok=exist_ok))
            return _load("fuzz_bam", os.path.join(HERE, "fuzz_bam.py"))
    return _load(f"fuzz_{fuzzer}", os.path.join(HERE, f"fuzz_{fuzzer}.py"))


@pytest.mark.parametrize("fuzzer", list(fc.FUZZERS))
def test_generators_write_the_jax_fuzzers_cases(fuzzer, tmp_path,
                                                monkeypatch):
    monkeypatch.delenv("T1K_FUZZ_EXTRA_ARGS", raising=False)
    monkeypatch.delenv("T1K_FUZZ_BIG", raising=False)
    mod = _load_fuzzer(fuzzer, monkeypatch, tmp_path)
    flat = fuzzer in ("genotyper", "analyzer", "bam")
    for seed in range(20):
        big = seed >= 17
        if big:
            monkeypatch.setenv("T1K_FUZZ_BIG", "1")
        out = tmp_path / fuzzer / f"s{seed}"
        out.mkdir(parents=True)
        case_dir = str(out) if flat else str(out / f"case_{seed}")
        rec = Recorder(case_dir)
        monkeypatch.setattr(mod, "OUT", str(out))
        monkeypatch.setattr(mod, "subprocess", types.SimpleNamespace(
            run=rec.subprocess_run))
        monkeypatch.setattr(mod, "open", _empty_when_missing, raising=False)
        if fuzzer == "bam":
            monkeypatch.setattr(mod, "extract_from_bam", rec.extract_from_bam)
        for name in ("genotype", "run", "analyze"):
            monkeypatch.setattr(importlib.import_module(
                f"t1k_tpu.cli.{name}"), "main", rec.main(f"cli.{name}"))
        mod.run_case(seed)
        assert rec.runs and rec.files, (fuzzer, seed)
        shutil.rmtree(case_dir, ignore_errors=True)
        kw = {"alleles": str(tmp_path / "cyp2d6_idx" / "cyp2d6_rna_seq.fa")
              } if fuzzer == "bam" else {}
        case = fc.make_case(fuzzer, seed, case_dir, big, **kw)
        assert _digests(case_dir) == rec.files, (fuzzer, seed)
        assert [(r.module, [fc.render(a, case_dir) for a in r.argv]
                 + r.port_only, r.cwd and fc.render(r.cwd, case_dir))
                for r in case.runs] == rec.runs, (fuzzer, seed)


# ------------------------------------------------------ tests/fuzz_db.py


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_db_case_writes_the_jax_packages_bytes(seed, tmp_path, monkeypatch):
    """tests/fuzz_db.py's case with the JAX package's db.parse_dat in the
    reference's place and the port's as its own: both write the same
    fasta in every mode and flag set the case draws, byte for byte."""
    from t1k_tpu.db import parse_dat as host
    from t1k_tpu_torch.db import parse_dat as port

    mod = _load("fuzz_db", os.path.join(HERE, "fuzz_db.py"))
    runs = routes.Pairs()
    monkeypatch.setattr(mod, "OUT", str(tmp_path))
    monkeypatch.setattr(mod, "_run_ref", lambda dat, args: runs.ref(
        routes.stdout_of(host.main, [dat] + args)))
    monkeypatch.setattr(mod, "_run_mine", lambda dat, args: runs.mine(
        routes.stdout_of(port.main, [dat] + args)))
    assert mod.run_case(seed) == "ok"
    runs.check(3)
