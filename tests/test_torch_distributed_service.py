"""The port's in-process host-sharded genotyper
(t1k_tpu_torch.parallel.distributed.run_genotyper_distributed) around
its shards: on the gpu route every shard scores on the one band-kernel
service the entry point builds (one panel upload, one read batch a
shard), through the kernel's plain version on the CPU; and the entry
point's card routing (its outputs against the JAX package's and one
process: test_torch_distributed.py)."""

import os

import pytest
import torch

from t1k_tpu_torch import device as tdev
from t1k_tpu_torch.core import pipeline
from t1k_tpu_torch.core.pipeline import GenotypeOptions
from t1k_tpu_torch.ops import align_band
from t1k_tpu_torch.parallel import distributed
from t1k_tpu_torch.parallel.distributed import run_genotyper_distributed
from t1k_tpu_torch.utils.observability import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
REF = os.path.join(DATA, "multigene_rna.fa")
PAIRED = ([os.path.join(DATA, "multigene_1.fq")],
          [os.path.join(DATA, "multigene_2.fq")])
GPU = dict(backend="gpu", em_backend="gpu", device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain band kernel runs as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shards_share_one_band_kernel_service(tmp_path, monkeypatch):
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
    run_genotyper_distributed(REF, *PAIRED, str(tmp_path / "x"),
                              GenotypeOptions(**GPU), n_workers=3)
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
        tmp_path, monkeypatch, opts):
    """The entry point runs on the card by default: without one, "auto"
    raises NoCardError and an explicit gpu route on "cuda" raises,
    before any file is written."""
    monkeypatch.setattr(tdev.torch.cuda, "is_available", lambda: False)
    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT", "T1K_EM_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    assert GenotypeOptions().device == "cuda"
    error = tdev.NoCardError if not opts else RuntimeError
    with pytest.raises(error, match="--device cpu"):
        run_genotyper_distributed(REF, *PAIRED,
                                  str(tmp_path / "x"),
                                  GenotypeOptions(**opts))
    assert not os.listdir(tmp_path)
