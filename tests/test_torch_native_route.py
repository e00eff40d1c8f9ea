"""The port's native route (the host engine of t1k_tpu_torch/native/)
against the JAX package's native route, byte for byte, on the paths whose
card baseline in chip_smoke.py is the port's native route and that no
other CPU test holds so: the extraction CLI (--backend native) on the
cases of tests/test_torch_extract.py, and the SMART-seq plate under
T1K_BACKEND=native on both sides.  The card holds the port's gpu route
against its native route; these tests hold that native route against the
JAX package, so the JAX package never has to run on the card.  The run
chain, the BAM chain, bamextract, simulate and the genotyper have their
native-route cases in test_torch_run.py, test_torch_bam.py,
test_torch_tools.py and test_torch_pipeline.py.

Also pins the port's copy of the native sources: em.cc and variant.cc
equal t1k_tpu/native/'s, bamscan.cc differs by the libdeflate null check
alone, and engine.cc by the trace counters alone (data/engine_trace.diff,
in place of t1k_tpu's environment-gated profile)."""

import difflib
import os

import numpy as np
import pytest

from t1k_tpu.cli.extract import main as host_extract
from t1k_tpu.io.reads import read_seq_file, write_fastq
from t1k_tpu.tools import smartseq as host_smartseq
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs
from t1k_tpu_torch.cli.extract import main as port_extract
from t1k_tpu_torch.tools import smartseq as port_smartseq
from t1k_tpu_torch.utils.observability import metrics
from test_torch_extract import CASES, PANEL

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ROUTING_ENV = ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_cli_native_route_matches_jax_native(tmp_path, case,
                                                      monkeypatch):
    for var in ROUTING_ENV:
        monkeypatch.delenv(var, raising=False)
    args = ["-f", PANEL, *CASES[case]]
    host, port = str(tmp_path / "host"), str(tmp_path / "port")
    assert host_extract([*args, "-o", host, "--backend", "native"]) == 0
    assert port_extract([*args, "-o", port, "--backend", "native"]) == 0
    # the host engine screened every read: no device screen was built
    assert "device_screened_reads" not in metrics().stages[
        "extraction_screen"]
    suffixes = ["_1.fq", "_2.fq"] + (["_bc.fa"] if case == "barcode" else [])
    for suffix in suffixes:
        assert _read(port + suffix) == _read(host + suffix), suffix
    assert _read(port + "_1.fq")


# the plate: one donor's alleles of the multigene panel, two cells
REF = os.path.join(HERE, "data", "multigene_rna.fa")
DONOR = {"GENA": ("GENA*83", "GENA*1.016"), "GENB": ("GENB*104", "GENB*25"),
         "GENC": ("GENC*10", "GENC*56")}
CELLS = 2
PLATE_OUTPUTS = ("_genotype_list.out", "_merged_genotype.tsv",
                 "_reduced_ref.fa", "_reduced_genotype_list.out",
                 "_final_genotype.tsv")
PASS_OUTPUTS = ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                "_aligned_2.fa", "_allele.vcf")
# the first pass's per cell (SS_cell<i>/cell<i><suffix>), then the second's
CELL_OUTPUTS = (("_candidate_1.fq", "_candidate_2.fq") + PASS_OUTPUTS
                + tuple("_reduced" + s for s in PASS_OUTPUTS))


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """Two cells of one donor (each expresses two of the three genes, both
    alleles at a ratio drawn from [0.1, 0.9], 300 pairs), through both
    packages' smartseq CLIs with T1K_BACKEND=native, as chip_smoke.py's
    baseline runs the port's.  Returns {package: work directory}."""
    work = tmp_path_factory.mktemp("plate")
    recs = {r.id: r for r in read_seq_file(REF)}
    rng = np.random.default_rng(5)
    lists = ([], [])
    for c in range(CELLS):
        alleles, abund = [], []
        for g in sorted(rng.choice(sorted(DONOR), 2, replace=False)):
            f = rng.uniform(0.1, 0.9)
            alleles += DONOR[g]
            abund += [f, 1 - f]
        mates = simulate_pairs([recs[a] for a in alleles], abund,
                               SimConfig(n_pairs=300, seed=60 + c))
        for lst, mate, recs_m in zip(lists, (1, 2), mates):
            path = str(work / f"cell{c}.R{mate}.fq")
            write_fastq(path, recs_m)
            lst.append(path)
    args = ["-f", REF, "-o", "SS"]
    for mate, lst in zip((1, 2), lists):
        (work / f"list{mate}.txt").write_text("\n".join(lst) + "\n")
        args += [f"-{mate}", str(work / f"list{mate}.txt")]
    out = {}
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        for var in ROUTING_ENV:
            mp.delenv(var, raising=False)
        mp.setenv("T1K_BACKEND", "native")
        for name, main in (("host", host_smartseq.main),
                           ("port", port_smartseq.main)):
            out[name] = str(work / name)
            os.makedirs(out[name])
            os.chdir(out[name])
            try:
                assert main(args) == 0
            finally:
                os.chdir(cwd)
    return out


@pytest.mark.parametrize("suffix", PLATE_OUTPUTS)
def test_plate_native_route_matches_jax_native(plates, suffix):
    got = _read(os.path.join(plates["port"], "SS" + suffix))
    assert got == _read(os.path.join(plates["host"], "SS" + suffix))
    assert got


@pytest.mark.parametrize("suffix", CELL_OUTPUTS)
def test_plate_cells_native_route_match_jax_native(plates, suffix):
    for c in range(CELLS):
        rel = os.path.join(f"SS_cell{c}", f"cell{c}{suffix}")
        assert _read(os.path.join(plates["port"], rel)) == _read(
            os.path.join(plates["host"], rel)), rel


# bamscan.cc's one difference: the port checks libdeflate's decompressor
# for null (a failed allocation stops the scan at its batch)
BAMSCAN_HOST = """\
  static Dec DecAlloc() { return libdeflate_alloc_decompressor(); }
  static void DecFree(Dec d) { libdeflate_free_decompressor(d); }
  void InflateOne(Dec dec, const Task& t) {
"""
BAMSCAN_PORT = """\
  static Dec DecAlloc() {
    Dec d = libdeflate_alloc_decompressor();
    if (!d)
      std::fprintf(stderr, "t1k bamscan: libdeflate_alloc_decompressor() "
                           "failed; the BAM scan stops at this batch\\n");
    return d;
  }
  static void DecFree(Dec d) {
    if (d) libdeflate_free_decompressor(d);
  }
  void InflateOne(Dec dec, const Task& t) {
    // a failed decompressor allocation is a scan error, never a call
    // through a null decompressor
    if (!dec) {
      fail.store(true, std::memory_order_relaxed);
      return;
    }
"""
NATIVE_SOURCES = ("bamscan.cc", "em.cc", "engine.cc", "variant.cc")
# the port's engine.cc against t1k_tpu's: the trace block
# (t1k_engine_set_trace, t1k_engine_trace_fetch) in place of the profile
# that T1K_ENGINE_PROFILE switched on.  After a change to the port's
# engine.cc, write the diff again with engine_trace_diff() below.
ENGINE_DIFF = os.path.join(HERE, "data", "engine_trace.diff")


def engine_trace_diff(host: str, port: str) -> str:
    return "".join(difflib.unified_diff(
        host.splitlines(True), port.splitlines(True),
        "t1k_tpu/native/engine.cc", "t1k_tpu_torch/native/engine.cc"))


@pytest.mark.parametrize("name", NATIVE_SOURCES)
def test_native_source_is_the_jax_packages(name):
    """The port's native route is the JAX package's native route: the same
    C++ sources byte for byte, bamscan.cc with the null-check hunk and
    engine.cc with the trace counters' diff."""
    dirs = [os.path.join(REPO, pkg, "native")
            for pkg in ("t1k_tpu", "t1k_tpu_torch")]
    for d in dirs:
        assert tuple(sorted(n for n in os.listdir(d)
                            if n.endswith(".cc"))) == NATIVE_SOURCES, d
    host, port = (_read(os.path.join(d, name)).decode() for d in dirs)
    if name == "bamscan.cc":
        assert host.count(BAMSCAN_HOST) == 1
        host = host.replace(BAMSCAN_HOST, BAMSCAN_PORT)
    if name == "engine.cc":
        assert engine_trace_diff(host, port) == _read(ENGINE_DIFF).decode()
        return
    assert port == host
