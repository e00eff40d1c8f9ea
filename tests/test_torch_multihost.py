"""Two processes run the port's sharded EM over torch.distributed (Gloo on
the CPU; t1k_tpu_torch/parallel/multihost.py): both hold the same result,
bit for bit the in-process two-shard run's, and the JAX package's
single-process sharded path agrees to float32 roundoff.

Run as a script, this file is the worker: it joins the group that
T1K_COORDINATOR / T1K_NUM_PROCESSES / T1K_PROCESS_ID describe, runs
em_quantify_multihost on the problem of tests/multihost_worker.py (copied)
and saves its result to <outdir>/x_<rank>.npy."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _problem():
    """tests/multihost_worker.py's problem: 400 read groups x 97 ECs, a
    count per entry, repeated (read group, EC) pairs among them."""
    rng = np.random.default_rng(5)
    ec_cnt, rg_cnt = 97, 400
    nnz = rg_cnt * 3
    seg_rg = np.sort(rng.integers(0, rg_cnt, nnz)).astype(np.int32)
    seg_ec = rng.integers(0, ec_cnt, nnz).astype(np.int32)
    counts = rng.integers(1, 4, nnz).astype(np.float64)
    ec_len = rng.integers(800, 2000, ec_cnt).astype(np.float64)
    init = np.ones(ec_cnt, np.float64)
    return seg_rg, seg_ec, counts, rg_cnt, ec_len, init


def _worker(outdir: str) -> int:
    from t1k_tpu_torch.parallel import multihost

    rank = multihost.initialize_from_env(device="cpu")
    assert multihost.global_data_mesh() == list(
        range(int(os.environ["T1K_NUM_PROCESSES"])))
    x = multihost.em_quantify_multihost(*_problem(), iterations=12,
                                        device="cpu")
    np.save(os.path.join(outdir, f"x_{rank}.npy"), x)
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_the_in_process_two_shards(tmp_path):
    from t1k_tpu.parallel.mesh import data_mesh, em_quantify_sharded
    from t1k_tpu_torch.parallel import mesh as tmesh

    nproc, port = 2, _free_port()
    procs = []
    for pid in range(nproc):
        env = dict(os.environ, PYTHONPATH=REPO,
                   T1K_COORDINATOR=f"127.0.0.1:{port}",
                   T1K_NUM_PROCESSES=str(nproc), T1K_PROCESS_ID=str(pid),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:   # a hang fails here, and leaves no process
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-4000:]
    x0 = np.load(tmp_path / "x_0.npy")
    x1 = np.load(tmp_path / "x_1.npy")
    assert x0.dtype == np.float32 and x0.tobytes() == x1.tobytes()
    problem = _problem()
    two = tmesh.em_quantify_sharded([torch.device("cpu")] * 2, *problem,
                                    iterations=12)
    assert two.tobytes() == x0.tobytes()
    ref = em_quantify_sharded(data_mesh(4), *problem, iterations=12)
    np.testing.assert_allclose(x0, ref, rtol=1e-4, atol=1e-6)


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    from t1k_tpu_torch.parallel import multihost

    monkeypatch.setenv("T1K_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("T1K_NUM_PROCESSES", "2")
    monkeypatch.setenv("T1K_PROCESS_ID", "0")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a card per rank"):
        multihost.initialize_from_env()
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
