"""The port's spans and counters inside read assignment
(t1k_tpu_torch/utils/observability.py, the engine's trace block in
native/engine.cc): off, nothing is recorded and the engine counts
nothing; under a torch.profiler the stage and its five spans are ranges
of the Chrome trace, the spans cover the stage, the engine's counts add
up to the band service's items, a second pass counts what the first
did, and every output file is the same with tracing on and off.  The
run chain goes through the kernels' plain versions on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from t1k_tpu_torch.cli.run import main as run_main
from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH, encode_seq
from t1k_tpu_torch.io.refset import RefSet
from t1k_tpu_torch.native import TRACE_COUNTS, TRACE_PHASES, NativeEngine
from t1k_tpu_torch.ops.align_band import DeferredDescService
from t1k_tpu_torch.ops.phase_a import DeviceScreen
from t1k_tpu_torch.utils import observability as obs

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
REF = os.path.join(DATA, "multigene_rna.fa")
READS = (os.path.join(DATA, "multigene_1.fq"),
         os.path.join(DATA, "multigene_2.fq"))
STAGES = ("read_assignment", "analyzer_read_assignment")
PARTS = ("prepare", "begin", "dispatch", "wait", "finish")
# files of the chain that are not its outputs
SIDE_FILES = ("_metrics.json", "_analyzer_metrics.json", "_config.json")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(outdir, traced):
    """The run-t1k chain on the card route's plain versions; with
    `traced`, under a CPU torch.profiler.  Returns (the output files'
    bytes, the two metrics files, the Chrome trace's events)."""
    shutil.rmtree(outdir, ignore_errors=True)
    argv = ["-f", REF, "-1", READS[0], "-2", READS[1], "--od", outdir,
            "-o", "c", "--backend", "gpu", "--emBackend", "gpu",
            "--device", "cpu", "--outputReadAssignment"]
    events = []
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert run_main(argv) == 0
        path = os.path.join(outdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(path)
    else:
        assert run_main(argv) == 0
    files = {}
    for name in sorted(os.listdir(outdir)):
        with open(os.path.join(outdir, name), "rb") as f:
            files[name] = f.read()
    stages = {}
    for name in ("c_metrics.json", "c_analyzer_metrics.json"):
        stages.update(json.loads(files[name]))
    return files, stages, events


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    return {traced: _chain(str(root / ("on" if traced else "off")), traced)
            for traced in (False, True)}


def _ranges(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("name") == name]


# ------------------------------------------------------------------ off
def test_span_off_is_the_shared_null_context():
    assert not obs.tracing()
    outside = obs.span("prepare")
    with obs.stage("trace_probe_off") as ctx:
        assert not obs.tracing()
        inside = obs.span("prepare")
        with inside:
            pass
    assert outside is inside
    assert obs.metrics().stages["trace_probe_off"] == {
        "seconds": obs.metrics().stages["trace_probe_off"]["seconds"]}
    assert ctx == {}


def test_span_on_adds_to_the_innermost_stage():
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.stage("trace_probe_outer") as outer:
            with obs.stage("trace_probe_on") as ctx:
                assert obs.tracing()
                for _ in range(3):
                    with obs.span("part"):
                        pass
    assert ctx["part_span_count"] == 3
    assert ctx["part_seconds"] >= 0.0
    assert "part_seconds" not in outer
    rec = obs.metrics().stages["trace_probe_on"]
    assert rec["part_span_count"] == 3


@pytest.mark.parametrize("stage", STAGES)
def test_untraced_chain_records_no_spans(chains, stage):
    _, stages, _ = chains[False]
    rec = stages[stage]
    for part in PARTS:
        assert f"{part}_seconds" not in rec
        assert f"{part}_span_count" not in rec
    for key in TRACE_COUNTS + TRACE_PHASES:
        assert key not in rec
    assert rec["chunk_count"] >= 1


# ------------------------------------------------------------------- on
@pytest.mark.parametrize("stage", STAGES)
def test_spans_nest_in_the_stage_range(chains, stage):
    _, _, events = chains[True]
    outer = _ranges(events, f"t1k.{stage}")
    assert len(outer) == 1
    lo, hi = outer[0]
    for part in PARTS:
        inner = _ranges(events, f"t1k.{stage}.{part}")
        assert inner, part
        assert all(lo <= a and b <= hi for a, b in inner), part


def test_boundaries_are_ranges(chains):
    _, _, events = chains[True]
    names = {e.get("name") for e in events}
    for name in ("t1k.refset_load", "t1k.extract", "t1k.analyze",
                 "t1k.extraction_screen", "t1k.em_quantification"):
        assert name in names, name
    # the analyzer's stages nest in its range
    (lo, hi), = _ranges(events, "t1k.analyze")
    (a, b), = _ranges(events, "t1k.analyzer_read_assignment")
    assert lo <= a and b <= hi


def test_screen_build_is_a_range():
    refset = RefSet.from_fasta(REF)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        DeviceScreen.build(refset.packed(), 11, 31, 0.8, device="cpu")
    names = {e.key for e in prof.key_averages()}
    assert "t1k.screen_build" in names
    assert "t1k.refset_load" not in names


@pytest.mark.parametrize("stage", STAGES)
def test_spans_cover_the_stage(chains, stage):
    _, stages, _ = chains[True]
    rec = stages[stage]
    covered = sum(rec[f"{part}_seconds"] for part in PARTS)
    assert covered >= 0.9 * rec["seconds"], (covered, rec["seconds"])
    assert covered <= rec["seconds"] + 1e-3


@pytest.mark.parametrize("stage", STAGES)
def test_items_by_kind_add_up_to_the_service_items(chains, stage):
    _, stages, _ = chains[True]
    rec = stages[stage]
    assert rec["deferred_item_count"] > 0
    assert (rec["gap_item_count"] + rec["spec_item_count"]
            == rec["deferred_item_count"])


@pytest.mark.parametrize("stage", STAGES)
def test_speculative_items_used_within_bounds(chains, stage):
    _, stages, _ = chains[True]
    rec = stages[stage]
    assert rec["spec_item_count"] > 0
    assert 0 < rec["spec_item_used_count"] <= rec["spec_item_count"]


@pytest.mark.parametrize("stage", STAGES)
def test_engine_counts_the_stage_reads(chains, stage):
    _, stages, _ = chains[True]
    rec = stages[stage]
    assert rec["engine_read_count"] == rec["unique_read_count"]
    assert rec["hit_count"] > rec["overlap_count"] > 0
    for key in ("hit_seconds", "chain_seconds", "replay_seconds"):
        assert rec[key] > 0, key
    assert rec["extend_seconds"] == 0   # the inline path's alone


def test_outputs_identical_traced_and_untraced(chains):
    off, _, _ = chains[False]
    on, _, _ = chains[True]
    assert set(off) == set(on)
    outputs = [n for n in off if not n.endswith(SIDE_FILES)]
    assert "c_assign.tsv" in outputs and "c_allele.vcf" in outputs
    for name in outputs:
        assert off[name] == on[name], name


def test_chain_metrics_keep_the_extraction_record(chains):
    """The genotyper no longer discards the stage records made before it:
    the chain's <prefix>_metrics.json holds extraction and read
    assignment."""
    files, _, _ = chains[False]
    geno = json.loads(files["c_metrics.json"])
    assert {"extraction_screen", "read_assignment",
            "em_quantification"} <= set(geno)


@pytest.mark.parametrize("stage", STAGES)
def test_trace_counts_get_no_rate(chains, stage):
    """A span's uses and the engine's counters are no throughput of the
    stage: their records carry no `<name>_per_s`; the stage's own counts
    keep theirs."""
    _, stages, _ = chains[True]
    rec = stages[stage]
    assert "read_per_s" in rec
    for key in TRACE_COUNTS + ("chunk_count",) + tuple(
            f"{p}_span_count" for p in PARTS):
        assert key in rec, key
        assert key[:-len("_count")] + "_per_s" not in rec, key


@pytest.mark.parametrize("chained", [False, True])
def test_library_run_starts_its_own_records(tmp_path, chained):
    """run_genotyper called in a process that recorded other stages
    writes only its own, unless it runs inside a metrics_run (the
    run-t1k chain), whose stages it adds to."""
    from t1k_tpu_torch.core.pipeline import GenotypeOptions, run_genotyper

    opts = GenotypeOptions(backend="native", em_backend="native",
                           device="cpu")
    prefix = str(tmp_path / "g")
    if chained:
        with obs.metrics_run():
            with obs.stage("earlier_stage"):
                pass
            run_genotyper(REF, [READS[0]], [READS[1]], prefix, opts)
    else:
        with obs.stage("earlier_stage"):
            pass
        run_genotyper(REF, [READS[0]], [READS[1]], prefix, opts)
    with open(prefix + "_metrics.json") as f:
        names = set(json.load(f))
    assert "read_assignment" in names
    assert ("earlier_stage" in names) == chained


def test_trace_fields_are_named_by_the_engine():
    """The binding takes the counter block's names from engine.cc; the
    fields the benchmark's readers divide and sum are among them."""
    from t1k_tpu_torch.native import _TRACE_FIELDS, _lib

    assert _lib.t1k_engine_trace_name(len(_TRACE_FIELDS)) is None
    assert _lib.t1k_engine_trace_name(-1) is None
    assert {"engine_read_count", "hit_count", "gap_item_count",
            "spec_item_count", "spec_item_used_count"} <= set(TRACE_COUNTS)
    assert {"chain_seconds", "fullspan_seconds"} <= set(TRACE_PHASES)
    assert len(TRACE_COUNTS) + len(TRACE_PHASES) == len(_TRACE_FIELDS)


# ------------------------------------------------------ engine counters
def _unique_reads(n=400):
    seqs = []
    for path in READS:
        with open(path) as f:
            seqs += [line.strip() for i, line in enumerate(f) if i % 4 == 1]
    uniq = sorted(set(seqs))[:n]
    codes = np.concatenate([encode_seq(s) for s in uniq])
    lens = np.array([len(s) for s in uniq], np.int32)
    starts = np.zeros(len(lens), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    return codes, starts, lens, np.ones(len(lens), np.int32)


@pytest.fixture(scope="module")
def packed():
    return RefSet.from_fasta(REF).packed()


def _pass(engine, route, reads, chunk=0):
    """One assignment pass inside a stage traced by a CPU profiler;
    returns the engine's counts (its phase times left out)."""
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.stage("trace_probe_pass"):
            if route == "gpu":
                engine.assign_batch_deferred(
                    *reads, desc_service=DeferredDescService("cpu"),
                    store_results=not chunk, chunk_size=chunk)
            else:
                engine.assign_batch(*reads)
    got = engine.trace_counters()
    return {k: got[k] for k in TRACE_COUNTS}


ROUTES = [("gpu", 0), ("gpu", 128), ("native", 0)]


@pytest.mark.parametrize("route,chunk", ROUTES)
def test_second_pass_counts_the_same(packed, route, chunk):
    """The counters restart with each pass: one engine, the same input
    twice, equal counts."""
    engine = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
    reads = _unique_reads()
    first = _pass(engine, route, reads, chunk)
    assert first["engine_read_count"] == len(reads[2])
    assert first["hit_count"] > 0
    assert _pass(engine, route, reads, chunk) == first


@pytest.mark.parametrize("route,chunk", ROUTES)
def test_worker_counts_sum_to_one_thread(packed, route, chunk):
    reads = _unique_reads()
    one = _pass(NativeEngine(packed, GENOTYPER_KMER_LENGTH), route, reads,
                chunk)
    three = _pass(NativeEngine(packed, GENOTYPER_KMER_LENGTH, threads=3),
                  route, reads, chunk)
    assert three == one


def test_chunking_keeps_the_counts(packed):
    """Chunks change the item dedupe scope only within a read: the same
    reads give the same counts unchunked and in chunks of 128."""
    reads = _unique_reads()
    engine = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
    assert _pass(engine, "gpu", reads, 128) == _pass(engine, "gpu", reads)


def test_native_route_has_no_deferred_items(packed):
    engine = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
    _pass(engine, "native", _unique_reads())
    got = engine.trace_counters()
    assert got["gap_item_count"] == got["spec_item_count"] == 0
    assert got["spec_item_used_count"] == 0
    assert got["extend_seconds"] > 0 and got["replay_seconds"] == 0


@pytest.mark.parametrize("route", ["gpu", "native"])
def test_untraced_pass_counts_nothing(packed, route):
    engine = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
    reads = _unique_reads(100)
    _pass(engine, route, reads)
    with obs.stage("trace_probe_untraced"):
        if route == "gpu":
            engine.assign_batch_deferred(
                *reads, desc_service=DeferredDescService("cpu"))
        else:
            engine.assign_batch(*reads)
    assert all(v == 0 for v in engine.trace_counters().values())


def test_traced_pass_assigns_as_untraced(packed):
    """The assignment records of one pass are the same traced and not."""
    reads = _unique_reads()
    engine = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
    plain = engine.assign_batch_deferred(
        *reads, desc_service=DeferredDescService("cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.stage("trace_probe_records"):
            traced = engine.assign_batch_deferred(
                *reads, desc_service=DeferredDescService("cpu"))
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
