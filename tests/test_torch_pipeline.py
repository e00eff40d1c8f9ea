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
