"""The port's in-process host-sharded genotyper
(t1k_tpu_torch.parallel.distributed.run_genotyper_distributed) against
the JAX package's (t1k_tpu.parallel.distributed) and against the port's
single-process genotyper (cli.genotype) on the same input: the same set
of files, each byte for byte, paired and single-end, at 2 and 3 workers
and with more workers than fragments, on the gpu route through the band
kernel's plain version on the CPU and on the host engine (the shared
band-kernel service and the card routing of the entry point:
test_torch_distributed_service.py)."""

import os

import pytest
import torch

from t1k_tpu.core.pipeline import GenotypeOptions as HostOptions
from t1k_tpu.parallel.distributed import \
    run_genotyper_distributed as host_distributed
from t1k_tpu_torch.cli.genotype import main as genotype_main
from t1k_tpu_torch.core.pipeline import GenotypeOptions
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain band kernel runs as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
