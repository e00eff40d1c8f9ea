"""The port's v1 full-row aligner (t1k_tpu_torch/ops/align.py) against the
JAX package's XLA program (ops/align.py), its Pallas kernel in interpret
mode (ops/align_pallas.py), the golden score table and the port's band
aligner.

Integer kernels: every comparison is exact.  The plain PyTorch version
runs here on the CPU; the CUDA kernel is compared with it on a card by
the test marked `cuda` (and by chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu.constants import encode_seq
from t1k_tpu_torch.ops import align as v1
from t1k_tpu_torch.ops import align_band as ab

HERE = os.path.dirname(os.path.abspath(__file__))


def _golden_batch():
    """The 400 scored cases of golden/align_global.tsv as padded windows."""
    cases = []
    with open(os.path.join(HERE, "golden", "align_global.tsv")) as f:
        for line in f:
            _, _, t, p, score, _ = line.rstrip("\n").split("\t")
            cases.append(("" if t == "-" else t, "" if p == "-" else p,
                          int(score)))
    tc = np.zeros((len(cases), max(len(c[0]) for c in cases) + 1), np.int8)
    pc = np.zeros((len(cases), max(len(c[1]) for c in cases) + 1), np.int8)
    for i, (t, p, _) in enumerate(cases):
        tc[i, :len(t)] = encode_seq(t)
        pc[i, :len(p)] = encode_seq(p)
    tl = np.array([len(c[0]) for c in cases], np.int32)
    pl = np.array([len(c[1]) for c in cases], np.int32)
    return tc, tl, pc, pl, np.array([c[2] for c in cases], np.int32)


def _seeded_pairs(seed, n, lt=96, lp=64, max_diff=40):
    """Reads against mutated panel-like windows of read length +-max_diff
    (clipped to the widths), N bases and padding garbage included."""
    rng = np.random.default_rng(seed)
    pl = rng.integers(0, lp + 1, n).astype(np.int32)
    tl = np.clip(pl + rng.integers(-max_diff, max_diff + 1, n), 0,
                 lt).astype(np.int32)
    tc = rng.integers(0, 5, (n, lt)).astype(np.int8)
    pc = rng.integers(0, 5, (n, lp)).astype(np.int8)
    same = rng.random(n) < 0.7
    m = min(lt, lp)
    pc[same, :m] = tc[same, :m]
    mut = rng.random((n, lp)) < 0.08
    pc[mut] = rng.integers(0, 5, int(mut.sum()))
    pl[:4] = [0, 1, 1, 2]
    tl[:4] = [3, 1, 0, 1]
    return tc, tl, pc, pl


def test_plain_matches_golden_table_and_jax_program():
    from t1k_tpu.ops.align import banded_scores

    tc, tl, pc, pl, want = _golden_batch()
    got = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    assert got.dtype == np.int32
    assert (got == want).all()
    assert (v1.banded_scores_full(tc, tl, pc, pl, device="cpu") == want).all()
    assert (np.asarray(banded_scores(tc, tl, pc, pl)) == got).all()


def test_plain_matches_pallas_interpret():
    from t1k_tpu.ops.align_pallas import banded_scores_pallas

    tc, tl, pc, pl, want = _golden_batch()
    jax_got = np.asarray(banded_scores_pallas(tc[:32], tl[:32], pc[:32],
                                              pl[:32], block_b=32,
                                              interpret=True))
    got = v1.banded_scores(tc[:32], tl[:32], pc[:32], pl[:32], device="cpu")
    assert (got == jax_got).all()
    assert (got == want[:32]).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_matches_jax_program_on_seeded_pairs(seed):
    """Large length differences, empty and single-base pairs, padding."""
    from t1k_tpu.ops.align import banded_scores

    tc, tl, pc, pl = _seeded_pairs(seed, 300)
    got = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    assert (got == np.asarray(banded_scores(tc, tl, pc, pl))).all()


def test_plain_matches_band_aligner_where_the_band_fits():
    """The v1 and band-packed aligners share the scoring contract."""
    tc, tl, pc, pl = _seeded_pairs(11, 400, lt=80, lp=80, max_diff=10)
    got = v1.banded_scores(tc, tl, pc, pl, device="cpu")
    ml, over = ab._window_class(tl, pl)
    assert ab.band_window(ml, over) <= 32
    assert (got == ab.banded_scores_band(tc, tl, pc, pl,
                                         device="cpu")).all()


def test_lengths_outside_the_widths_raise():
    tc, tl, pc, pl = _seeded_pairs(5, 8)
    with pytest.raises(ValueError, match="within the window widths"):
        v1.banded_scores(tc, tl + 200, pc, pl, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    tc, tl, pc, pl, want = _golden_batch()
    assert (v1.banded_scores_full(tc, tl, pc, pl, device=cuda_device)
            == want).all()
    for seed in (3, 4):
        tc, tl, pc, pl = _seeded_pairs(seed, 2000, lt=600, lp=150,
                                       max_diff=500)
        assert (v1.banded_scores_full(tc, tl, pc, pl, device=cuda_device)
                == v1.banded_scores(tc, tl, pc, pl, device="cpu")).all()
