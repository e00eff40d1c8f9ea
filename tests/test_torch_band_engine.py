"""The port's engine copy (t1k_tpu_torch/native) deferring its gap-fill
and overhang DP to the port's band scorer (t1k_tpu_torch/ops/
align_band.py) on the CPU, through descriptors and through window bytes,
in one pass and in chunks, against the JAX package's inline engine on the
multigene reads: records, fragments and base weights exact."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu.constants import encode_seq
from t1k_tpu.io.reads import read_seq_file
from t1k_tpu.io.refset import RefSet
from t1k_tpu.native import NativeEngine
from t1k_tpu_torch.native import NativeEngine as PortEngine
from t1k_tpu_torch.ops import align_band as ab

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "data")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain band kernel runs as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _multigene_batch():
    refset = RefSet.from_fasta(os.path.join(DATA_DIR, "multigene_rna.fa"))
    seqs = [r.seq for name in ("multigene_1.fq", "multigene_2.fq")
            for r in read_seq_file(os.path.join(DATA_DIR, name))]
    codes = [encode_seq(s) for s in seqs]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flat = np.concatenate(codes).astype(np.int8)
    return refset.packed(), flat, starts, lens, np.ones(len(codes), np.int32)


@pytest.mark.parametrize("transport", ["descriptors", "window_bytes"])
def test_engine_deferred_with_port_scorer_matches_inline(transport):
    """The port's engine copy, deferring to the port's scorer, is
    byte-identical to the reference package's inline engine on the
    multigene reads."""
    from t1k_tpu.constants import GENOTYPER_KMER_LENGTH

    packed, flat, starts, lens, weights = _multigene_batch()
    eng1 = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)
    eng2 = PortEngine(packed, GENOTYPER_KMER_LENGTH)  # the port's copy
    if transport == "descriptors":
        svc = ab.DeferredDescService(device="cpu")
        rec2, off2 = eng2.assign_batch_deferred(flat, starts, lens, weights,
                                                desc_service=svc)
        assert svc.items_scored > 10_000
    else:
        rec2, off2 = eng2.assign_batch_deferred(
            flat, starts, lens, weights, ab.make_deferred_stats_fn("cpu"))
    assert rec1.shape[0] > 0
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)
    assert np.array_equal(eng1.pos_weight(), eng2.pos_weight())


def test_chunked_desc_deferral_matches_unchunked():
    from t1k_tpu.constants import GENOTYPER_KMER_LENGTH

    packed, flat, starts, lens, weights = _multigene_batch()
    n = len(lens) // 2
    uid1 = np.arange(n, dtype=np.int64)
    uid2 = np.arange(n, 2 * n, dtype=np.int64)
    has_n = np.zeros(n, np.uint8)
    outs = []
    for chunk in (0, 317):
        eng = NativeEngine(packed, GENOTYPER_KMER_LENGTH)
        eng.assign_batch_deferred(
            flat, starts, lens, weights, store_results=False,
            chunk_size=chunk, desc_service=ab.DeferredDescService("cpu"))
        outs.append((*eng.fragment_batch(uid1, uid2, has_n, True, 2000,
                                         None), eng.pos_weight()))
    assert outs[0][0].shape[0] > 0
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
