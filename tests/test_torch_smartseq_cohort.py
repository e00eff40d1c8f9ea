"""The port's SMART-seq --cohortEm pass (t1k_tpu_torch.tools.smartseq:
one batched EM for every cell's second pass) on a plate of four cells of
one donor simulated from the multigene panel with t1k_tpu.tools.simulate:
byte-identical to the port's per-cell pass, also with its cells dealt
over a device list, and the JAX package's --cohortEm (f32 on the CPU) to
its own test's contract.  The cohort pass runs on the CPU through the
kernels' plain versions (device "cpu"); the per-cell pass it is held
against runs on the host engine, whose bytes test_torch_smartseq.py
holds against the JAX package's and the plain versions' on every
output."""

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
def per_cell_plate(plate, tmp_path_factory):
    """The port's per-cell pass on its host engine."""
    return _run(smartseq.run_smartseq, plate,
                tmp_path_factory.mktemp("per_cell"),
                t1k_args={"--backend": "native", "--emBackend": "native"},
                device="cpu")


@pytest.fixture(scope="module")
def port_cohort(plate, tmp_path_factory):
    return _run(smartseq.run_smartseq, plate,
                tmp_path_factory.mktemp("cohort"), cohort_em=True,
                device="cpu")


def _plate_file(workdir, suffix):
    return os.path.join(workdir, "SS" + suffix)


def _cell_files(workdir, suffix):
    return [os.path.join(workdir, f"SS_cell{c}", f"cell{c}{suffix}")
            for c in range(CELLS)]


def test_cohort_em_is_byte_identical_to_per_cell(per_cell_plate,
                                                 port_cohort):
    """--cohortEm (one batched EM for the second pass) writes the per-cell
    pass's bytes: the matrices, the list files and every second-pass
    output, the post analysis's VCF included."""
    for suffix in PLATE_OUTPUTS:
        assert _read(_plate_file(port_cohort, suffix)) == \
            _read(_plate_file(per_cell_plate, suffix)), suffix
    for suffix in ("_reduced_genotype.tsv", "_reduced_allele.tsv",
                   "_reduced_aligned_1.fa", "_reduced_aligned_2.fa",
                   "_reduced_allele.vcf"):
        for got, want in zip(_cell_files(port_cohort, suffix),
                             _cell_files(per_cell_plate, suffix)):
            assert _read(got) == _read(want), got


def test_cohort_em_over_a_device_list(plate, port_cohort, tmp_path):
    """--cohortEm with its cells dealt over a mesh of three devices (the
    CPU thrice here; every card of a machine with more than one) writes
    the one-device bytes."""
    dealt = _run(smartseq.run_smartseq, plate, tmp_path / "mesh",
                 cohort_em=True, device="cpu",
                 mesh=[torch.device("cpu")] * 3)
    for suffix in PLATE_OUTPUTS:
        assert _read(_plate_file(dealt, suffix)) == \
            _read(_plate_file(port_cohort, suffix)), suffix
    for got, want in zip(_cell_files(dealt, "_reduced_genotype.tsv"),
                         _cell_files(port_cohort, "_reduced_genotype.tsv")):
        assert _read(got) == _read(want)


def test_cohort_em_matches_jax_cohort_contract(plate, port_cohort,
                                               tmp_path):
    """The JAX package's --cohortEm (its batched EM in f32 on the CPU)
    against the port's, to tests/test_tools.py's own contract: the same
    header and inconsistency columns, abundances within max(1e-2, 1e-3
    |a|)."""
    host = _run(host_smartseq.run_smartseq, plate, tmp_path / "hc",
                t1k_args={"--backend": "native"}, cohort_em=True)
    with open(_plate_file(host, "_final_genotype.tsv")) as f:
        a = f.read().splitlines()
    with open(_plate_file(port_cohort, "_final_genotype.tsv")) as f:
        b = f.read().splitlines()
    assert a[0] == b[0]
    assert len(a) == len(b)
    for la, lb in zip(a[1:], b[1:]):
        ca, cb = la.split("\t"), lb.split("\t")
        assert os.path.basename(ca[0]) == os.path.basename(cb[0])
        assert ca[-1] == cb[-1]
        for va, vb in zip(ca[1:-1], cb[1:-1]):
            assert abs(float(va) - float(vb)) <= max(
                1e-2, 1e-3 * abs(float(va)))
