"""The port's genotyper stage (t1k_tpu_torch.core.pipeline and its CLI)
against the committed goldens and the JAX package's native route, plus
its device-routing contract: entry points run on the card, and "auto"
without a card raises instead of falling back.  The gpu routes run here
on the CPU through the kernels' plain versions (device="cpu")."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from t1k_tpu.core import pipeline as host_pipeline
from t1k_tpu_torch import device as tdev
from t1k_tpu_torch.core.pipeline import GenotypeOptions, run_genotyper

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA_DIR = os.path.join(HERE, "data")
GOLDEN_DIR = os.path.join(HERE, "golden")
MULTIGENE = (os.path.join(DATA_DIR, "multigene_rna.fa"),
             os.path.join(DATA_DIR, "multigene_1.fq"),
             os.path.join(DATA_DIR, "multigene_2.fq"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def _gpu_opts(**kw):
    return GenotypeOptions(backend="gpu", em_backend="gpu", device="cpu",
                           output_read_assignment=True, **kw)


def _check_multigene_goldens(prefix):
    for suffix in ("_genotype.tsv", "_allele.tsv"):
        assert _read(prefix + suffix) == _read(
            os.path.join(GOLDEN_DIR, "multigene" + suffix)), suffix
    digests = dict(line.split() for line in
                   _read(os.path.join(GOLDEN_DIR, "multigene_digests.txt"))
                   .splitlines())
    rows = "".join(sorted(_read(prefix + "_assign.tsv").splitlines(True)))
    assert hashlib.sha256(rows.encode()).hexdigest() == digests["_assign.tsv"]
    assert hashlib.sha256(_read(prefix + "_aligned_1.fa", "rb")).hexdigest() \
        == digests["_aligned.fa"]


def test_multigene_golden_through_port_matches_native(tmp_path):
    ref, fq1, fq2 = MULTIGENE
    port = str(tmp_path / "port")
    run_genotyper(ref, [fq1], [fq2], port, _gpu_opts())
    _check_multigene_goldens(port)
    native = str(tmp_path / "native")
    host_pipeline.run_genotyper(
        ref, [fq1], [fq2], native,
        host_pipeline.GenotypeOptions(backend="native", em_backend="native",
                                      output_read_assignment=True))
    for suffix in ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                   "_aligned_2.fa", "_assign.tsv"):
        assert _read(port + suffix) == _read(native + suffix), suffix
    stage = json.loads(_read(port + "_metrics.json"))["read_assignment"]
    assert stage["deferred_item_count"] > 0  # the band scorer did the DP
    assert stage["band_kernel_launches"] == 0  # plain version on the CPU


def test_truncated_mate_golden_through_port(tmp_path):
    prefix = str(tmp_path / "tm")
    run_genotyper(os.path.join(DATA_DIR, "truncmate_panel.fa"),
                  [os.path.join(DATA_DIR, "truncmate_1.fq")],
                  [os.path.join(DATA_DIR, "truncmate_2.fq")], prefix,
                  _gpu_opts())
    assert _read(prefix + "_assign.tsv") == ""  # both fragments filtered
    assert _read(prefix + "_genotype.tsv") == _read(
        os.path.join(GOLDEN_DIR, "truncmate_genotype.tsv"))


def test_cli_main(tmp_path):
    from t1k_tpu_torch.cli.genotype import main

    ref, fq1, fq2 = MULTIGENE
    prefix = str(tmp_path / "cli")
    assert main(["-f", ref, "-1", fq1, "-2", fq2, "-o", prefix,
                 "--backend", "gpu", "--emBackend", "gpu", "--device", "cpu",
                 "--outputReadAssignment"]) == 0
    _check_multigene_goldens(prefix)


def test_cpu_slice_imports_no_jax(tmp_path):
    ref, fq1, fq2 = MULTIGENE
    code = (
        "import sys\n"
        "from t1k_tpu_torch.cli.genotype import main\n"
        f"main(['-f', {ref!r}, '-1', {fq1!r}, '-2', {fq2!r}, '-o', "
        f"{str(tmp_path / 'sub')!r}, '--backend', 'gpu', '--emBackend', "
        "'gpu', '--device', 'cpu'])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 't1k_tpu' or m.startswith('t1k_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _read(str(tmp_path / "sub_genotype.tsv")) == _read(
        os.path.join(GOLDEN_DIR, "multigene_genotype.tsv"))


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    """--device cuda (the default) and --backend gpu never run elsewhere
    when CUDA is absent."""
    from t1k_tpu_torch.cli.genotype import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, fq1, fq2 = MULTIGENE
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-f", ref, "-1", fq1, "-2", fq2, "-o", str(tmp_path / "x"),
              "--backend", "gpu", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_genotyper(ref, [fq1], [fq2], str(tmp_path / "y"),
                      GenotypeOptions(backend="gpu"))
    with pytest.raises(ValueError, match="unknown alignment backend"):
        run_genotyper(ref, [fq1], [fq2], str(tmp_path / "z"),
                      GenotypeOptions(backend="tpu", device="cpu"))


def _clear_routing_env(monkeypatch):
    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND"):
        monkeypatch.delenv(var, raising=False)


def test_gpu_present_env_contract(monkeypatch):
    _clear_routing_env(monkeypatch)
    monkeypatch.setenv("T1K_GPU_PRESENT", "1")
    assert tdev.gpu_present() is True
    monkeypatch.setenv("T1K_GPU_PRESENT", "0")
    assert tdev.gpu_present() is False
    # user override beats the cache
    monkeypatch.setenv("T1K_BACKEND", "native")
    monkeypatch.setenv("T1K_GPU_PRESENT", "1")
    assert tdev.gpu_present() is False
    monkeypatch.setenv("T1K_BACKEND", "gpu")
    monkeypatch.setenv("T1K_GPU_PRESENT", "0")
    assert tdev.gpu_present() is True
    # without a verdict: asks torch once and caches the answer
    monkeypatch.delenv("T1K_BACKEND")
    monkeypatch.delenv("T1K_GPU_PRESENT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdev.gpu_present() is False
    assert os.environ["T1K_GPU_PRESENT"] == "0"


def test_resolve_backend_caches_without_touching_user_env(monkeypatch):
    """"auto" is the card: with one it resolves to "gpu" and caches the
    presence verdict, never writing the user's T1K_BACKEND."""
    _clear_routing_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdev.resolve_backend("auto") == "gpu"
    assert os.environ["T1K_GPU_PRESENT"] == "1"
    assert os.environ.get("T1K_BACKEND", "") == ""
    assert tdev.resolve_backend("native") == "native"
    monkeypatch.setenv("T1K_BACKEND", "native")
    assert tdev.resolve_backend("auto") == "native"


def test_pinned_absence_resolves_native_without_probe(monkeypatch):
    """A cached absence verdict decides without probing: "auto" on the
    card raises the no-card error, "auto" on the CPU is the plain
    versions' route, and only T1K_BACKEND=native resolves native."""
    _clear_routing_env(monkeypatch)
    monkeypatch.setenv("T1K_GPU_PRESENT", "0")

    def boom():
        raise AssertionError("presence must not be probed with a verdict")

    monkeypatch.setattr(torch.cuda, "is_available", boom)
    with pytest.raises(tdev.NoCardError, match="--backend native"):
        tdev.resolve_backend("auto")
    with pytest.raises(tdev.NoCardError, match="--device cpu"):
        tdev.resolve_backend("auto", "cuda:0")
    assert tdev.resolve_backend("auto", "cpu") == "gpu"
    assert tdev.gpu_present() is False
    monkeypatch.setenv("T1K_BACKEND", "native")
    assert tdev.resolve_backend("auto") == "native"


def test_em_auto_routes_on_presence_and_size(monkeypatch):
    from t1k_tpu_torch.core.genotyper import Genotyper

    _clear_routing_env(monkeypatch)
    monkeypatch.setenv("T1K_GPU_PRESENT", "1")
    # small problems stay on the native loop even with a card
    assert Genotyper._resolve_em_backend(1000, 100) == "native"
    # >= 5e7 cells with a card present: device EM
    assert Genotyper._resolve_em_backend(100_000, 1000) == "gpu"
    # past the reference's 4 << 30 dense cells: the native loop again
    assert Genotyper._resolve_em_backend(70_000, 70_000) == "native"
    monkeypatch.setenv("T1K_GPU_PRESENT", "0")
    with pytest.raises(tdev.NoCardError):  # no card: an error, not native
        Genotyper._resolve_em_backend(100_000, 1000)
    assert Genotyper._resolve_em_backend(100_000, 1000, "cpu") == "gpu"
    assert Genotyper._resolve_em_backend(1000, 100, "cpu") == "native"
    monkeypatch.setenv("T1K_EM_BACKEND", "gpu")
    assert Genotyper._resolve_em_backend(10, 10) == "gpu"


@pytest.mark.parametrize("flags", [["--backend", "auto"],
                                   ["--backend", "native"]])
def test_auto_without_a_card_exits_with_the_named_routes(
        tmp_path, monkeypatch, capsys, flags):
    """Without a card, "auto" (for the alignment or the EM backend) stops
    before any work with a usage error naming both explicit routes."""
    from t1k_tpu_torch.cli.genotype import main

    _clear_routing_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, fq1, fq2 = MULTIGENE
    prefix = str(tmp_path / "x")
    with pytest.raises(SystemExit) as exc:
        main(["-f", ref, "-1", fq1, "-2", fq2, "-o", prefix, *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--backend native" in err and "--device cpu" in err
    assert not os.path.exists(prefix + "_genotype.tsv")


@pytest.mark.parametrize("flags", [["--device", "cpu"],
                                   ["--backend", "native", "--emBackend",
                                    "native"]])
def test_explicit_routes_run_without_a_card(tmp_path, monkeypatch, flags):
    """--device cpu (auto on the kernels' plain versions) and the host
    engine both run without a card and write the goldens."""
    from t1k_tpu_torch.cli.genotype import main

    _clear_routing_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, fq1, fq2 = MULTIGENE
    prefix = str(tmp_path / "x")
    assert main(["-f", ref, "-1", fq1, "-2", fq2, "-o", prefix,
                 "--outputReadAssignment", *flags]) == 0
    _check_multigene_goldens(prefix)


def test_entry_points_default_to_the_card():
    import inspect

    from t1k_tpu_torch.core.extractor import ExtractorOptions
    from t1k_tpu_torch.core.genotyper import Genotyper
    from t1k_tpu_torch.ops import align, align_band, em, phase_a

    for fn in (Genotyper.__init__, phase_a.PhaseAIndex.build,
               phase_a.PhaseAIndex.from_jax_arrays, phase_a.DeviceScreen.build,
               align_band.DeferredDescService.__init__,
               align_band.make_deferred_desc_service,
               align_band.make_deferred_stats_fn,
               align_band.banded_scores_band, align_band.banded_stats_band,
               align.banded_scores, align.banded_scores_full,
               em.em_quantify_gpu):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
    assert GenotypeOptions().device == ExtractorOptions().device == "cuda"
    assert GenotypeOptions().backend == ExtractorOptions().backend == "auto"


@pytest.mark.cuda
def test_multigene_golden_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    ref, fq1, fq2 = MULTIGENE
    prefix = str(tmp_path / "card")
    opts = _gpu_opts()
    opts.device = "cuda"
    run_genotyper(ref, [fq1], [fq2], prefix, opts)
    _check_multigene_goldens(prefix)
    stage = json.loads(_read(prefix + "_metrics.json"))["read_assignment"]
    assert stage["band_kernel_launches"] > 0


# ------------------------------------------- host helpers of the JAX package
# Names t1k_tpu exports beside its pipeline (test_torch_api_parity.py),
# each against its t1k_tpu counterpart: exact, bytes or integers.

def _golden_pairs():
    """The 400 cases of golden/align_global.tsv as (t, p) code arrays."""
    from t1k_tpu_torch.constants import encode_seq

    pairs = []
    with open(os.path.join(GOLDEN_DIR, "align_global.tsv")) as f:
        for line in f:
            _, _, t, p, _, _ = line.rstrip("\n").split("\t")
            pairs.append(tuple(encode_seq("" if s == "-" else s)
                               for s in (t, p)))
    return pairs


def _seeded_pairs(seed=23, n=300):
    """Reads against windows that differ from them by substitutions,
    N bases and indels of up to 8 bases, p_len 1-150."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        p = rng.integers(0, 4, int(rng.integers(1, 151))).astype(np.int8)
        t = p.copy()
        sub = rng.random(len(t)) < 0.05
        t[sub] = rng.integers(0, 5, int(sub.sum()))
        cut = int(rng.integers(0, len(t) + 1))
        indel = int(rng.integers(-8, 9))
        if indel > 0:
            t = np.concatenate([t[:cut], rng.integers(0, 4, indel)
                                .astype(np.int8), t[cut:]])
        elif indel < 0:
            t = np.concatenate([t[:cut], t[cut - indel:]])
        pairs.append((t.astype(np.int8), p))
    return pairs


def _padded(pairs):
    import numpy as np

    tl = np.array([len(t) for t, _ in pairs], np.int32)
    pl = np.array([len(p) for _, p in pairs], np.int32)
    tc = np.zeros((len(pairs), int(tl.max()) + 1), np.int8)
    pc = np.zeros((len(pairs), int(pl.max()) + 1), np.int8)
    for i, (t, p) in enumerate(pairs):
        tc[i, :len(t)] = t
        pc[i, :len(p)] = p
    return tc, tl, pc, pl


@pytest.mark.parametrize("cases", ["golden", "seeded"])
def test_align_stats_match_jax_and_band_kernel(cases):
    """native.align_stats and align_stats_batch against t1k_tpu.native's;
    the batch's match counts equal the band kernel's plain version's on
    the same items."""
    import numpy as np

    from t1k_tpu import native as host_native
    from t1k_tpu_torch import native as port_native
    from t1k_tpu_torch.ops.align_band import banded_stats_band

    pairs = _golden_pairs() if cases == "golden" else _seeded_pairs()
    assert len(pairs) == (400 if cases == "golden" else 300)
    for t, p in pairs:
        assert port_native.align_stats(t, p) == host_native.align_stats(t, p)
    tc, tl, pc, pl = _padded(pairs)
    match = port_native.align_stats_batch(tc, tl, pc, pl)
    assert match.dtype == np.int32
    assert np.array_equal(match, host_native.align_stats_batch(tc, tl, pc,
                                                               pl))
    assert np.array_equal(match, [port_native.align_stats(t, p)[0]
                                  for t, p in pairs])
    _, band_match, _, _ = banded_stats_band(tc, tl, pc, pl, device="cpu")
    assert np.array_equal(band_match, match)


@pytest.mark.parametrize("threads,hit_len", [(1, 31), (4, 31), (3, 21),
                                             (2, 45)])
def test_engine_setters_leave_assignments_as_the_jax_engine(threads,
                                                            hit_len):
    """NativeEngine.set_threads and set_hit_len_required against the JAX
    engine's: the same assignment records after each; more threads
    change no record, and a hit length other than 31 changes some."""
    import numpy as np

    from t1k_tpu.io.refset import RefSet as HostRefSet
    from t1k_tpu.native import NativeEngine as HostEngine
    from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH, encode_seq
    from t1k_tpu_torch.io.reads import read_seq_files
    from t1k_tpu_torch.io.refset import RefSet
    from t1k_tpu_torch.native import NativeEngine

    ref, fq1, fq2 = MULTIGENE
    seqs = sorted({r.seq for r in read_seq_files([fq1, fq2])})
    codes = np.concatenate([encode_seq(s) for s in seqs])
    lens = np.array([len(s) for s in seqs], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    weights = np.ones(len(seqs), np.int32)
    runs = []
    for engine in (NativeEngine(RefSet.from_fasta(ref).packed(),
                                GENOTYPER_KMER_LENGTH),
                   HostEngine(HostRefSet.from_fasta(ref).packed(),
                              GENOTYPER_KMER_LENGTH)):
        base = engine.assign_batch(codes, starts, lens, weights)
        engine.set_threads(threads)
        engine.set_hit_len_required(hit_len)
        assert engine.hit_len_required == hit_len
        runs.append((base, engine.assign_batch(codes, starts, lens,
                                               weights)))
    (port_base, port), (host_base, host) = runs
    for a, b in zip(port + port_base, host + host_base):
        assert a.tobytes() == b.tobytes()
    changed = port[0].shape != port_base[0].shape or \
        port[0].tobytes() != port_base[0].tobytes()
    assert changed == (hit_len != 31)


def test_is_low_complexity_matches_jax():
    import numpy as np

    from t1k_tpu.core.extractor import is_low_complexity as host_rule
    from t1k_tpu_torch.core.extractor import is_low_complexity

    rng = np.random.default_rng(29)
    reads = ["", "A", "N", "ACGT", "A" * 100, "N" * 10 + "ACGT" * 22,
             "AC" * 50, "ACG" * 33, "ACGT" * 25]
    for _ in range(400):
        n = int(rng.integers(1, 160))
        probs = rng.dirichlet(np.full(5, 0.4))
        reads.append("".join(rng.choice(list("ACGTN"), n, p=probs)))
    got = [is_low_complexity(s) for s in reads]
    assert got == [host_rule(s) for s in reads]
    assert 0 < sum(got) < len(got)


def test_write_fasta_matches_jax(tmp_path):
    from t1k_tpu.io.reads import write_fasta as host_write
    from t1k_tpu_torch.io.reads import read_seq_files, write_fasta

    records = list(read_seq_files([MULTIGENE[1]]))
    write_fasta(str(tmp_path / "port.fa"), records)
    host_write(str(tmp_path / "host.fa"), records)
    assert _read(tmp_path / "port.fa", "rb") == _read(tmp_path / "host.fa",
                                                      "rb")
    assert [r.seq for r in read_seq_files([str(tmp_path / "port.fa")])] \
        == [r.seq for r in records]


PRESETS = ["", "hla", "hla-wgs", "kir-wgs", "kir-wes"]


@pytest.mark.parametrize("preset", PRESETS + ["wgs"])
def test_apply_preset_matches_jax_and_run_cli(preset):
    """PipelineConfig.apply_preset against t1k_tpu's (the reference),
    field for field; cli/run.py's resolve_preset gives what it sets at
    every -s and --relaxIntronAlign."""
    import dataclasses

    from t1k_tpu.config import PipelineConfig as HostConfig
    from t1k_tpu_torch.cli.run import resolve_preset
    from t1k_tpu_torch.config import PipelineConfig

    if preset not in PRESETS:
        for cls in (PipelineConfig, HostConfig):
            with pytest.raises(ValueError, match="unknown preset"):
                cls().apply_preset(preset)
        return
    for sim in (0.8, 0.85):
        for relax in (False, True):
            kw = dict(similarity=sim, extractor_similarity=sim,
                      relax_intron_align=relax)
            port = PipelineConfig(**kw)
            assert port.apply_preset(preset) is port
            host = dataclasses.asdict(HostConfig(**kw).apply_preset(preset))
            got = dataclasses.asdict(port)
            assert {k: got[k] for k in host} == host
            assert resolve_preset(preset, sim, relax) == (
                port.similarity, port.extractor_similarity,
                port.relax_intron_align)
    assert resolve_preset(preset, None) == resolve_preset(preset, 0.8)


@pytest.mark.parametrize("preset", PRESETS[1:] + ["wgs"])
def test_resolve_preset_matches_jax(preset):
    """cli/run.py's resolve_preset against t1k_tpu's on each preset and on
    a name outside them (the defaults, as run-t1k), at every -s and
    --relaxIntronAlign; apply_preset still raises on that name (above)."""
    from t1k_tpu.cli.run import resolve_preset as host_resolve
    from t1k_tpu_torch.cli.run import resolve_preset

    for sim in (None, 0.85):
        for relax in (False, True):
            assert resolve_preset(preset, sim, relax) == host_resolve(
                preset, sim, relax)


def test_make_deferred_desc_service_scores_as_the_host_engine():
    """ops.align_band.make_deferred_desc_service: a descriptor service on
    the device asked for, whose scores through the engine's deferred
    mode give the host engine's records."""
    import numpy as np

    from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH, encode_seq
    from t1k_tpu_torch.io.reads import read_seq_files
    from t1k_tpu_torch.io.refset import RefSet
    from t1k_tpu_torch.native import NativeEngine
    from t1k_tpu_torch.ops import align_band

    service = align_band.make_deferred_desc_service(device="cpu")
    assert isinstance(service, align_band.DeferredDescService)
    assert service.device == torch.device("cpu")
    ref, fq1, fq2 = MULTIGENE
    seqs = sorted({r.seq for r in read_seq_files([fq1, fq2])})
    codes = np.concatenate([encode_seq(s) for s in seqs])
    lens = np.array([len(s) for s in seqs], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    weights = np.ones(len(seqs), np.int32)
    engine = NativeEngine(RefSet.from_fasta(ref).packed(),
                          GENOTYPER_KMER_LENGTH)
    want = engine.assign_batch(codes, starts, lens, weights)
    got = engine.assign_batch_deferred(codes, starts, lens, weights,
                                       desc_service=service)
    assert service.items_scored > 0
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_genotyper_coalesce_matches_jax_object_coalesce():
    """Genotyper.coalesce (the assignments packed for coalesce_arrays)
    against t1k_tpu's object coalesce on the multigene fragments: the
    assigned count and the group CSR byte for byte."""
    from t1k_tpu.core import fragment as host_fragment
    from t1k_tpu.core.genotyper import Genotyper as HostGenotyper
    from t1k_tpu.io.refset import RefSet as HostRefSet
    from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH
    from t1k_tpu_torch.core.fragment import (RefContext, fragment_assign,
                                             set_read_assignments)
    from t1k_tpu_torch.core.genotyper import Genotyper
    from t1k_tpu_torch.core.pipeline import (assign_unique_reads,
                                             overlap_lists_from_records)
    from t1k_tpu_torch.io.reads import read_seq_files
    from t1k_tpu_torch.io.refset import RefSet
    from t1k_tpu_torch.native import NativeEngine

    ref, fq1, fq2 = MULTIGENE
    seqs1 = [r.seq for r in read_seq_files([fq1])]
    seqs2 = [r.seq for r in read_seq_files([fq2])]
    n = len(seqs1)
    refset = RefSet.from_fasta(ref)
    engine = NativeEngine(refset.packed(), GENOTYPER_KMER_LENGTH)
    _, group_of, rec, off = assign_unique_reads(engine, seqs1 + seqs2)
    overlaps = overlap_lists_from_records(rec, off)
    has_n = [("N" in a) or ("N" in b) for a, b in zip(seqs1, seqs2)]
    ctx = RefContext(refset)
    port = Genotyper(refset, device="cpu")
    assert port.coalesce([]) == 0 and port.read_group_count == 0
    cnt_port = port.coalesce([
        set_read_assignments(ctx, fragment_assign(
            ctx, overlaps[group_of[i]], overlaps[group_of[n + i]], has_n[i],
            True), None, 2000) for i in range(n)])

    host_refset = HostRefSet.from_fasta(ref)
    host_ctx = host_fragment.RefContext(host_refset)
    host_overlaps = [[host_fragment.OverlapRec.from_row(r) for r in
                      rec[off[i]:off[i + 1]]] for i in range(len(off) - 1)]
    host = HostGenotyper(host_refset)
    cnt_host = host.coalesce([
        host_fragment.set_read_assignments(
            host_ctx, host_fragment.fragment_assign(
                host_ctx, host_overlaps[group_of[i]],
                host_overlaps[group_of[n + i]], has_n[i], True), None, 2000)
        for i in range(n)])
    host._build_group_arrays_from_objects()
    assert cnt_port == cnt_host > n // 2
    assert port.read_group_count == host.read_group_count > 1
    for name in ("_grp_off", "_flat_allele", "_flat_start", "_flat_end",
                 "_flat_weight", "_flat_qual", "_flat_adjust"):
        a, b = getattr(port, name), getattr(host, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
