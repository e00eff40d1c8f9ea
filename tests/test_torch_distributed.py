"""The port's in-process host-sharded genotyper
(t1k_tpu_torch.parallel.distributed.run_genotyper_distributed) against
the JAX package's (t1k_tpu.parallel.distributed) and against the port's
single-process genotyper (cli.genotype) on the same input: the same set
of files, each byte for byte, paired and single-end, at 2 and 3 workers
and with more workers than fragments, on the gpu route through the band
kernel's plain version on the CPU and on the host engine.  Then the
shared band-kernel service (one for every shard, one panel upload, one
read batch a shard) and the card routing of the entry point."""

import os

import pytest

from t1k_tpu.core.pipeline import GenotypeOptions as HostOptions
from t1k_tpu.parallel.distributed import \
    run_genotyper_distributed as host_distributed
from t1k_tpu_torch import device as tdev
from t1k_tpu_torch.cli.genotype import main as genotype_main
from t1k_tpu_torch.core import pipeline
from t1k_tpu_torch.core.pipeline import GenotypeOptions
from t1k_tpu_torch.ops import align_band
from t1k_tpu_torch.parallel import distributed
from t1k_tpu_torch.parallel.distributed import run_genotyper_distributed
from t1k_tpu_torch.utils.observability import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
REF = os.path.join(DATA, "multigene_rna.fa")
FQ = (os.path.join(DATA, "multigene_1.fq"), os.path.join(DATA, "multigene_2.fq"))
# "many": the first FEW_FRAGMENTS pairs over more shards than fragments
# (all but the last shard empty)
FEW_FRAGMENTS, MANY_WORKERS = 40, 48
ROUTES = {"gpu": dict(backend="gpu", em_backend="gpu", device="cpu"),
          "native": dict(backend="native", em_backend="native")}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _listing(out):
    return sorted(os.listdir(out))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(mate-1 files, mate-2 files or None) per input: the committed
    multigene pairs, their mate 1 alone, and the first FEW_FRAGMENTS
    pairs."""
    few = tmp_path_factory.mktemp("few")
    paths = []
    for src in FQ:
        with open(src) as f:
            lines = f.readlines()[:4 * FEW_FRAGMENTS]
        paths.append(str(few / os.path.basename(src)))
        with open(paths[-1], "w") as f:
            f.writelines(lines)
    return {"paired": ([FQ[0]], [FQ[1]]), "single": ([FQ[0]], None),
            "few_paired": ([paths[0]], [paths[1]]),
            "few_single": ([paths[0]], None)}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Run-once outputs by key: ("jax", input, workers), the JAX
    package's in-process sharded genotyper on its host engine, and
    ("single", input), the port's cli.genotype on the host engine."""
    root = tmp_path_factory.mktemp("references")
    done = {}

    def get(key, reads):
        if key not in done:
            out = root / "_".join(map(str, key))
            out.mkdir()
            prefix = str(out / "x")
            if key[0] == "jax":
                host_distributed(REF, *reads, prefix,
                                 HostOptions(backend="native",
                                             em_backend="native"),
                                 n_workers=key[2])
            else:
                r1, r2 = reads
                args = ["-f", REF, "-1", *r1, "-2", *r2] if r2 else \
                    ["-f", REF, "-u", *r1]
                assert genotype_main([*args, "-o", prefix, "--backend",
                                      "native", "--emBackend",
                                      "native"]) == 0
            done[key] = str(out)
        return done[key]

    return get


CASES = [("paired", 2), ("paired", 3), ("single", 2), ("single", 3),
         ("few_paired", MANY_WORKERS), ("few_single", MANY_WORKERS)]


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name,workers", CASES,
                         ids=[f"{n}-{w}" for n, w in CASES])
def test_sharded_genotyper_matches_jax_and_single_process(
        inputs, references, tmp_path, name, workers, route):
    reads = inputs[name]
    out = tmp_path / "port"
    out.mkdir()
    run_genotyper_distributed(REF, *reads, str(out / "x"),
                              GenotypeOptions(**ROUTES[route]),
                              n_workers=workers)
    shards = [metrics().stages[f"shard_{w}"] for w in range(workers)]
    jax_out = references(("jax", name, workers), reads)
    single_out = references(("single", name), reads)
    files = _listing(out)
    paired = reads[1] is not None
    assert files == _listing(jax_out) == [
        "x" + s for s in sorted(["_allele.tsv", "_genotype.tsv"] + (
            ["_aligned_1.fa", "_aligned_2.fa"] if paired
            else ["_aligned.fa"]))]
    for f in files:
        port = _read(out / f)
        assert port == _read(os.path.join(jax_out, f)), f
        assert port == _read(os.path.join(single_out, f)), f
    # the single-process run writes its EM snapshot and metrics beside them
    assert set(_listing(single_out)) - set(files) == {
        "x_em_state.npz", "x_metrics.json"}
    assert [s["fragment_count"] for s in shards] == [
        hi - lo for lo, hi in distributed.shard_bounds(
            sum(s["fragment_count"] for s in shards), workers)]
    items = sum(s["deferred_item_count"] for s in shards)
    assert (items > 0) == (route == "gpu")


def test_shards_share_one_band_kernel_service(inputs, tmp_path,
                                              monkeypatch):
    """On the gpu route every shard scores on the one service the entry
    point builds: the panel uploaded once, one read batch a shard, and
    the shards' items summing to the service's."""
    services = []
    uploads = []

    class Recording(align_band.DeferredDescService):
        def __init__(self, device="cuda"):
            super().__init__(device)
            services.append(self)

        def set_ref(self, codes):
            key = self._ref_key
            super().set_ref(codes)
            uploads.append(("ref", key != self._ref_key))

        def begin_batch(self, read_codes):
            uploads.append(("reads", len(read_codes)))
            return super().begin_batch(read_codes)

    monkeypatch.setattr(pipeline, "DeferredDescService", Recording)
    monkeypatch.setattr(distributed, "DeferredDescService", Recording)
    launches0 = align_band.launch_counts["band_stats"]
    run_genotyper_distributed(REF, *inputs["paired"], str(tmp_path / "x"),
                              GenotypeOptions(**ROUTES["gpu"]), n_workers=3)
    assert len(services) == 1
    assert [u for u in uploads if u[0] == "ref"] == [
        ("ref", True), ("ref", False), ("ref", False)]
    assert len([u for u in uploads if u[0] == "reads"]) == 3
    shards = [metrics().stages[f"shard_{w}"] for w in range(3)]
    assert all(s["deferred_item_count"] > 0 for s in shards)
    assert sum(s["deferred_item_count"] for s in shards) == \
        services[0].items_scored
    # on the CPU the wrapper runs the plain version: no kernel launched
    assert align_band.launch_counts["band_stats"] == launches0
    assert sum(s["band_kernel_launches"] for s in shards) == 0


@pytest.mark.parametrize("opts", [dict(), dict(backend="gpu"),
                                  dict(backend="native", em_backend="gpu")],
                         ids=["auto", "gpu", "em_gpu"])
def test_card_routes_without_a_card_raise_before_any_output(
        inputs, tmp_path, monkeypatch, opts):
    """The entry point runs on the card by default: without one, "auto"
    raises NoCardError and an explicit gpu route on "cuda" raises,
    before any file is written."""
    monkeypatch.setattr(tdev.torch.cuda, "is_available", lambda: False)
    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    assert GenotypeOptions().device == "cuda"
    error = tdev.NoCardError if not opts else RuntimeError
    with pytest.raises(error, match="--device cpu"):
        run_genotyper_distributed(REF, *inputs["paired"],
                                  str(tmp_path / "x"),
                                  GenotypeOptions(**opts))
    assert not os.listdir(tmp_path)
