"""The port's SQUAREM EM (t1k_tpu_torch/ops/em.py) against the native
f64 oracle and the JAX device EM."""

import numpy as np
import pytest
import torch

from t1k_tpu.native import em_quantify
from t1k_tpu_torch.ops.em import em_quantify_gpu, incidence_lists


def _em_problem(rg_cnt, ec_cnt, seed, n_alleles, n_genes, n_majors, max_k):
    """The seeded EM problems of test_device_ops (_em_inputs) and
    test_routing (_em_inputs), by their constants."""
    rng = np.random.default_rng(seed)
    ec_to_alleles = [[] for _ in range(ec_cnt)]
    for a in range(n_alleles):
        ec_to_alleles[a % ec_cnt].append(a)
    offs, ecs = [0], []
    for _ in range(rg_cnt):
        k = rng.integers(1, max_k)
        ecs.extend(rng.choice(ec_cnt, size=k, replace=False).tolist())
        offs.append(len(ecs))
    return dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0], rg_cnt),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes, n_majors=n_majors)


def _small_inputs():
    return _em_problem(200, 15, 3, 40, 3, 12, 6)


def _routing_inputs(rg_cnt=2000, ec_cnt=60, seed=3):
    return _em_problem(rg_cnt, ec_cnt, seed, 120, 4, 24, 8)


PROBLEMS = {"device_ops": _small_inputs, "routing": _routing_inputs,
            "routing_masked": lambda: _routing_inputs(rg_cnt=500, ec_cnt=30,
                                                      seed=11)}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_f64_matches_native_bit_for_bit(problem):
    """f64 in em.cc's summation order: the native loop's iteration count
    and its counts, bit for bit (the issue's rtol 1e-9 is met with 0)."""
    args = PROBLEMS[problem]()
    it_native, count_native = em_quantify(**args)
    it, count = em_quantify_gpu(**args, device="cpu")
    assert it == it_native
    assert count.dtype == np.float64
    np.testing.assert_array_equal(count, count_native)


def test_f64_matches_native_with_squarem_alpha_floor():
    args = _routing_inputs(rg_cnt=800, ec_cnt=40, seed=7)
    it_native, count_native = em_quantify(min_squarem_alpha=-1.5, **args)
    it, count = em_quantify_gpu(min_squarem_alpha=-1.5, device="cpu", **args)
    assert it == it_native
    np.testing.assert_array_equal(count, count_native)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_f32_matches_jax(problem):
    """f32 against em_quantify_jax (f32 here: jax_enable_x64 is off).
    rtol 1e-4: the two f32 loops sum in different orders, and SQUAREM's
    extrapolation amplifies that f32 rounding."""
    from t1k_tpu.ops.em import em_quantify_jax

    args = PROBLEMS[problem]()
    it_jax, count_jax = em_quantify_jax(**args)
    it, count = em_quantify_gpu(**args, device="cpu", dtype=torch.float32)
    assert it == it_jax
    np.testing.assert_allclose(count, count_jax, rtol=1e-4, atol=1e-4)


def test_incidence_lists_and_their_checks():
    rg_off = np.array([0, 2, 3, 4])
    col_off, col_rgs = incidence_lists(rg_off, np.array([1, 2, 0, 1]), 3)
    assert col_off.tolist() == [0, 1, 3, 4]
    assert col_rgs.tolist() == [1, 0, 2, 0]  # per EC, read groups ascending
    with pytest.raises(ValueError, match="duplicate"):
        incidence_lists(rg_off, np.array([1, 1, 0, 1]), 3)
    with pytest.raises(ValueError, match="out of range"):
        incidence_lists(rg_off, np.array([1, 2, 0, 3]), 3)


def test_em_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        em_quantify_gpu(**_small_inputs(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_kernel_on_card_matches_native_and_plain(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    args = PROBLEMS[problem]()
    it_native, count_native = em_quantify(**args)
    it, count = em_quantify_gpu(**args, device="cuda")
    assert it == it_native
    np.testing.assert_array_equal(count, count_native)
    it32, count32 = em_quantify_gpu(**args, device="cuda",
                                    dtype=torch.float32)
    it32_plain, count32_plain = em_quantify_gpu(**args, device="cpu",
                                                dtype=torch.float32)
    # f32: the CPU plain version's sequential sums accumulate in f64
    assert it32 == it32_plain
    np.testing.assert_allclose(count32, count32_plain, rtol=1e-4, atol=1e-4)
