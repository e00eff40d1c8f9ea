"""The port's multi-device dry run (t1k_tpu_torch/parallel/dryrun.py) and
scaling bench (parallel/scaling_bench.py) on CPU shards: the dry run's
checks pass at one and two shards, its first phase equals the JAX
composite's (__graft_entry__.dryrun_multichip's align_step, the Pallas
band kernel in interpret mode), and the bench's sharded EM gives the same
bits at one and two shards.  The JAX package is imported inside the tests
that use it, so the `cuda` tests also collect where jax is absent."""

import json

import numpy as np
import pytest
import torch

from t1k_tpu_torch.device import NoCardError
from t1k_tpu_torch.parallel import dryrun, scaling_bench

CPU = torch.device("cpu")



@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread each, so that the suite's test processes running side by side
    do not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_passes_on_cpu_shards(n, capsys):
    out = dryrun.dryrun_multichip(n, devices=[CPU] * n)
    assert out["pairs"] == 1024 and out["read_groups"] == 256
    assert out["it_native"] > 0 and out["it_f32"] < dryrun.MAX_EM_ROUNDS
    line = capsys.readouterr().out
    assert line.startswith(f"dryrun_multichip({n}): ") and "OK" in line


def _jax_weights(tc, tl, pc, pl):
    """align_step of __graft_entry__.dryrun_multichip on one shard: the
    Pallas stats kernel in interpret mode and its FragWeight buckets."""
    import jax.numpy as jnp

    from t1k_tpu.ops.align_pallas_band import LANES, _band_grid

    G = 8
    b = len(tl)
    nblocks = -(-b // (G * LANES))
    Lt_pad = ((max(dryrun.LT + dryrun.ML + 1, dryrun.LP + dryrun.W + 1) + 1)
              + 7) // 8 * 8
    Lp_pad = (max(dryrun.LP, 8) + 7) // 8 * 8
    tl_j, pl_j = jnp.asarray(tl), jnp.asarray(pl)
    _, packed = _band_grid(jnp.asarray(tc), tl_j, jnp.asarray(pc), pl_j, G,
                           dryrun.ML, dryrun.LP, dryrun.LT, Lt_pad, Lp_pad,
                           nblocks, stats=True, interpret=True, W=dryrun.W)
    match = (packed & 511).astype(jnp.float32)
    sim = 2.0 * 2.0 * match / (tl_j + pl_j).astype(jnp.float32)
    segment = max((1 - dryrun.REF_SIM) / 4.0, 0.01)
    w = jnp.where(sim < 1 - 3 * segment, 0.01,
                  jnp.where(sim < 1 - 2 * segment, 0.1,
                            jnp.where(sim < 1 - segment, 0.5, 1.0)))
    return np.asarray(w)


@pytest.mark.parametrize("mutated", [False, True])
def test_phase_one_weights_equal_the_jax_composite(mutated):
    """The reference's batch (every pair in the top bucket), and the same
    batch with up to 80% of each read re-drawn (every bucket), at two
    shards: the port's weights equal the JAX step's, float for float."""
    b = dryrun.shard_pairs(2) * 2
    tc, tl, pc, pl = dryrun.example_batch(b, dryrun.LT, dryrun.LP)
    if mutated:
        rng = np.random.default_rng(9)
        redraw = rng.random(pc.shape) < rng.random((b, 1)) * 0.8
        pc[redraw] = rng.integers(0, 4, int(redraw.sum())).astype(np.int8)
    got = dryrun.align_step([CPU] * 2, tc, tl, pc, pl)
    want = _jax_weights(tc, tl, pc, pl)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert len(np.unique(got)) == (4 if mutated else 1)


def test_entry_equals_the_jax_composite():
    """entry("cpu") against __graft_entry__.entry()'s forward, jitted on the
    CPU (the Pallas band kernel in interpret mode): match equal; x2 within
    atol 1e-8 and rtol 1e-4 in float32.  x2 sums to 1 (entries up to
    0.011, 12 of 512 exactly 0 in both); the two float32 products sum
    their 2,048 and 512 terms in different orders, and the extrapolation's
    cancellation carries that to 5.6e-9 at most, 3.2e-5 of the smallest
    nonzero entries (1.5e-5)."""
    import jax

    import __graft_entry__ as graft

    fn, args = graft.entry()
    want_match, want_x2 = (np.asarray(a) for a in jax.jit(fn)(*args))
    match, x2 = dryrun.entry(device="cpu")
    assert match.dtype == want_match.dtype == np.int32
    assert np.array_equal(match, want_match)
    assert x2.dtype == want_x2.dtype == np.float32
    assert np.array_equal(x2 == 0, want_x2 == 0)
    np.testing.assert_allclose(x2, want_x2, rtol=1e-4, atol=1e-8)
    assert abs(float(x2.sum()) - 1) < 1e-5


def test_entry_inputs_are_the_references():
    """example_em equals _example_em seed for seed, and the composite's
    incidence holds the cells that two draws of one EC give."""
    import __graft_entry__ as graft

    for mine, theirs in zip(dryrun.example_em(dryrun.RG_CNT, dryrun.EC_CNT),
                            graft._example_em(graft.RG_CNT, graft.EC_CNT)):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
    assert (dryrun.B, dryrun.RG_CNT, dryrun.EC_CNT, dryrun.FANOUT) == (
        graft.B, graft.RG_CNT, graft.EC_CNT, graft.FANOUT)
    srg, sec = dryrun.example_em(dryrun.RG_CNT, dryrun.EC_CNT)[:2]
    assert len(set(zip(srg.tolist(), sec.tolist()))) < len(srg)


def _small_problem(make=scaling_bench.scaling_problem):
    return make(rg_cnt=3000, ec_cnt=256, seed=11)


def test_scaling_em_is_equal_at_one_and_two_shards():
    p = _small_problem()
    x1 = scaling_bench.run_em([CPU], p, 5)
    x2 = scaling_bench.run_em([CPU] * 2, p, 5)
    assert x1.dtype == np.float32 and np.array_equal(x1, x2)
    assert abs(float(x1.sum()) - 1) < 1e-5
    results = scaling_bench.bench_em({1: [CPU], 2: [CPU] * 2}, p, warm=1,
                                     iterations=2)
    assert list(results) == [1, 2] and results[1]["speedup"] == 1


def test_scaling_bench_prints_the_reference_schema(monkeypatch, capsys):
    """main --device cpu: one JSON line with both loops' results."""
    monkeypatch.setattr(scaling_bench, "scaling_problem", _small_problem)
    monkeypatch.setattr(scaling_bench, "meshes",
                        lambda device: {n: scaling_bench.data_mesh(n, device)
                                        for n in (1, 2)})
    assert scaling_bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["metric"] == "sharded_em_scaling"
    assert list(out["results"]) == list(out["full_step_weak_scaling"]) \
        == ["1", "2"]
    assert out["full_step_weak_scaling"]["1"]["weak_efficiency"] == 1


def test_cpu_meshes_take_every_size_and_cards_raise_without_one(
        monkeypatch):
    assert [len(m) for m in scaling_bench.meshes("cpu").values()] \
        == [1, 2, 4, 8]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError):
        scaling_bench.meshes()
    with pytest.raises(NoCardError):
        dryrun.dryrun_multichip(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real device)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_cuda_dryrun_and_phase_one(cuda_device, n):
    """On [card] x n the dry run passes, and its first phase (the band
    kernel) gives the CPU shards' weights."""
    dryrun.dryrun_multichip(n, devices=[cuda_device] * n)
    b = dryrun.shard_pairs(n) * n
    batch = dryrun.example_batch(b, dryrun.LT, dryrun.LP)
    assert np.array_equal(dryrun.align_step([cuda_device] * n, *batch),
                          dryrun.align_step([CPU] * n, *batch))


@pytest.mark.cuda
def test_cuda_entry_equals_cpu(cuda_device):
    """The composite on the card against its CPU run: match equal, x2 at
    test_entry_equals_the_jax_composite's float32 tolerance."""
    match, x2 = dryrun.entry(cuda_device)
    want_match, want_x2 = dryrun.entry(CPU)
    assert np.array_equal(match, want_match)
    np.testing.assert_allclose(x2, want_x2, rtol=1e-4, atol=1e-8)
