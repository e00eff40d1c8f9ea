"""The port's SMART-seq pipeline (t1k_tpu_torch.tools.smartseq) against
the JAX package's (t1k_tpu.tools.smartseq) on its native route, on a
plate of four cells of one donor simulated from the multigene panel with
t1k_tpu.tools.simulate: every output byte for byte, in one process and
in a pool of workers (the --cohortEm pass: test_torch_smartseq_cohort.py).
The port's gpu routes run on the CPU through the kernels' plain versions
(device "cpu")."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu.io.reads import read_seq_file, write_fastq
from t1k_tpu.tools import smartseq as host_smartseq
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs
from t1k_tpu_torch.tools import smartseq

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "data", "multigene_rna.fa")
DONOR = {"GENA": ("GENA*83", "GENA*1.016"), "GENB": ("GENB*104", "GENB*25"),
         "GENC": ("GENC*10", "GENC*56")}
CELLS = 4
PLATE_OUTPUTS = ("_genotype_list.out", "_merged_genotype.tsv",
                 "_reduced_ref.fa", "_reduced_genotype_list.out",
                 "_final_genotype.tsv")
PASS_OUTPUTS = ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                "_aligned_2.fa", "_allele.vcf")
# the first pass's per cell (cell<i>/cell<i><suffix>), then the second's
CELL_OUTPUTS = (("_candidate_1.fq", "_candidate_2.fq") + PASS_OUTPUTS
                + tuple("_reduced" + s for s in PASS_OUTPUTS))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    """Four cells of one donor: each expresses two of the three genes
    (drawn per cell), both alleles at a ratio drawn from [0.1, 0.9], 300
    pairs; the list files hold absolute paths."""
    work = tmp_path_factory.mktemp("plate")
    recs = {r.id: r for r in read_seq_file(REF)}
    rng = np.random.default_rng(3)
    lists = ([], [])
    for c in range(CELLS):
        alleles, abund = [], []
        for g in sorted(rng.choice(sorted(DONOR), 2, replace=False)):
            f = rng.uniform(0.1, 0.9)
            alleles += DONOR[g]
            abund += [f, 1 - f]
        mates = simulate_pairs([recs[a] for a in alleles], abund,
                               SimConfig(n_pairs=300, seed=40 + c))
        for lst, mate, recs_m in zip(lists, (1, 2), mates):
            path = str(work / f"cell{c}.R{mate}.fq")
            write_fastq(path, recs_m)
            lst.append(path)
    for mate, lst in zip((1, 2), lists):
        (work / f"list{mate}.txt").write_text("\n".join(lst) + "\n")
    return str(work / "list1.txt"), str(work / "list2.txt")


def _run(run, plate, workdir, **kwargs):
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        run(*plate, REF, "SS", **kwargs)
    finally:
        os.chdir(cwd)
    return str(workdir)


@pytest.fixture(scope="module")
def host_plate(plate, tmp_path_factory):
    return _run(host_smartseq.run_smartseq, plate,
                tmp_path_factory.mktemp("host"), t1k_args={"--backend": "native"})


@pytest.fixture(scope="module")
def port_plate(plate, tmp_path_factory):
    return _run(smartseq.run_smartseq, plate, tmp_path_factory.mktemp("port"),
                device="cpu")


def _plate_file(workdir, suffix):
    return os.path.join(workdir, "SS" + suffix)


def _cell_files(workdir, suffix):
    return [os.path.join(workdir, f"SS_cell{c}", f"cell{c}{suffix}")
            for c in range(CELLS)]


@pytest.mark.parametrize("suffix", PLATE_OUTPUTS)
def test_plate_outputs_match_jax_native(host_plate, port_plate, suffix):
    got = _read(_plate_file(port_plate, suffix))
    assert got == _read(_plate_file(host_plate, suffix))
    assert got


@pytest.mark.parametrize("suffix", CELL_OUTPUTS)
def test_cell_outputs_match_jax_native(host_plate, port_plate, suffix):
    for got, want in zip(_cell_files(port_plate, suffix),
                         _cell_files(host_plate, suffix)):
        assert _read(got) == _read(want), got


def test_plate_has_calls_and_a_monoallelic_cell(port_plate):
    """The final matrix calls alleles of every gene, and the first pass
    leaves at least one call that matches no selected allele."""
    with open(_plate_file(port_plate, "_final_genotype.tsv")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert {h.split("*")[0] for h in rows[0][1:-1]} == set(DONOR)
    assert len(rows) == CELLS + 1
    with open(_plate_file(port_plate, "_merged_genotype.tsv")) as f:
        assert any(line.rstrip("\n").split("\t")[-1] for line in f)


def test_pool_workers_match_one_process(plate, port_plate, tmp_path):
    """Two spawn workers (each cell through cli.run in a worker) give the
    one-process bytes; the workers' kernel launches are gathered per
    kernel (none here: the CPU runs the plain versions)."""
    smartseq.worker_launch_counts.clear()
    pool = _run(smartseq.run_smartseq, plate, tmp_path / "pool", workers=2,
                device="cpu")
    for suffix in PLATE_OUTPUTS:
        assert _read(_plate_file(pool, suffix)) == \
            _read(_plate_file(port_plate, suffix)), suffix
    for got, want in zip(_cell_files(pool, "_reduced_genotype.tsv"),
                         _cell_files(port_plate, "_reduced_genotype.tsv")):
        assert _read(got) == _read(want)
    assert {"phase_a_probe", "phase_a_chain", "band_stats", "em_squarem",
            "em_squarem_batched"} <= set(smartseq.worker_launch_counts)
    assert not any(smartseq.worker_launch_counts.values())


def test_cohort_em_without_a_card_exits_before_any_output(plate, tmp_path,
                                                          monkeypatch):
    """--device cuda (the default) on a machine without a card: the
    command exits 2 naming the CPU routes, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("T1K_GPU_PRESENT", "0")
    monkeypatch.delenv("T1K_BACKEND", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        smartseq.main(["-1", plate[0], "-2", plate[1], "-f", REF, "-o", "SS",
                       "--cohortEm"])
    assert exc.value.code == 2
    assert os.listdir(tmp_path) == []
