"""The port's cohort tools (t1k_tpu_torch/tools: merge, copynumber,
group_samples, extract_sam_hits, simulate) against the JAX package's
(t1k_tpu/tools), byte for byte, through their command lines
(`python -m <package>.tools.<tool>`) on inputs made here from a seed."""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REF = os.path.join(HERE, "data", "multigene_rna.fa")


def _genotype_rows(rng, genes, alleles_per_gene=6):
    """Genotype TSV rows: per gene 0-2 calls, each an allele (sometimes
    with equal alleles listed after it), an abundance and a quality."""
    rows = []
    for g in genes:
        n = int(rng.integers(0, 3))
        cols = [g, str(n)]
        for k in range(2):
            if k < n:
                names = [f"{g}*{int(rng.integers(1, alleles_per_gene)):02d}"
                         f":{int(rng.integers(1, 4)):02d}"
                         for _ in range(int(rng.integers(1, 3)))]
                cols += [",".join(names), f"{rng.uniform(0, 200):.6f}",
                         str(int(rng.integers(0, 61)))]
            else:
                cols += [".", "0", "-1"]
        rows.append("\t".join(cols) + "\t\n")
    return "".join(rows)


def _samples(tmp_path, genes, n, seed):
    rng = np.random.default_rng(seed)
    files = []
    for s in range(n):
        path = tmp_path / f"s{s}_genotype.tsv"
        path.write_text(_genotype_rows(rng, genes))
        files.append(str(path))
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    return str(tmp_path / "list.txt")


def _merge(tmp_path):
    return ["-l", _samples(tmp_path, ["KIR2DL1", "KIR3DL2", "HLA-A"], 12, 5), "--tq", "40", "-q", "10"]


def _copynumber(tmp_path):
    rng = np.random.default_rng(9)
    rows = []
    for g in range(14):
        gene, n = f"GEN{g}", int(rng.integers(1, 3))
        cols = [gene, str(n)]
        for k in range(2):
            if k < n:
                cols += [f"{gene}*{k + 1}", f"{rng.uniform(5, 400):.6f}",
                         str(int(rng.integers(0, 61)))]
            else:
                cols += [".", "0", "-1"]
        rows.append("\t".join(cols) + "\t\n")
    path = tmp_path / "g_genotype.tsv"
    path.write_text("".join(rows))
    return ["-g", str(path), "--nomissing", "GEN3,GEN1",
            "--upper-quantile", "0.8", "-q", "5"]


def _group_samples(tmp_path):
    return ["-l", _samples(tmp_path, ["HLA-A", "HLA-B", "HLA-C", "HLA-DRB1"],
                           10, 7), "-q", "20", "-d", "1"]


def _extract_sam_hits(tmp_path):
    rng = np.random.default_rng(11)
    sam = ["@HD\tVN:1.6\n", "@SQ\tSN:chr6\tLN:1000\n"]
    fq = []
    for i in range(40):
        name = f"r{i}" + (" extra" if i % 7 == 0 else "")
        qname = name if i % 5 else f"r{i}"
        ref = "*" if i % 3 == 0 else "chr6"
        sam.append(f"{qname}\t0\t{ref}\t1\t60\t4M\t*\t0\t0\tACGT\tIIII\n")
        seq = "".join(rng.choice(list("ACGT"), 8))
        fq.append(f"@{name}\n{seq}\n+\n{'I' * 8}\n" if i % 2
                  else f">{name}\n{seq}\n")
    (tmp_path / "hits.sam").write_text("".join(sam))
    (tmp_path / "cand.fq").write_text("".join(fq))
    return [str(tmp_path / "hits.sam"), str(tmp_path / "cand.fq")]


def _simulate(tmp_path):
    return ["-f", REF, "-o", str(tmp_path / "sim"), "--alleles", "GENA*83",
            "GENB*104", "GENC*1.016", "--abundances", "1", "0.4", "2.5",
            "-n", "150", "--errorRate", "0.02", "--seed", "23"]


# tool -> its arguments for a work directory (inputs written there)
ARGS = {"merge": _merge, "copynumber": _copynumber,
        "group_samples": _group_samples,
        "extract_sam_hits": _extract_sam_hits, "simulate": _simulate}


@pytest.mark.parametrize("tool", sorted(ARGS))
def test_tool_matches_jax_byte_for_byte(tool, tmp_path):
    outs = []
    for pkg in ("t1k_tpu_torch", "t1k_tpu"):
        work = tmp_path / pkg
        work.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.tools.{tool}", *ARGS[tool](work)],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = proc.stdout
        if tool == "simulate":
            out = "".join((work / f"sim_{m}.fq").read_text() for m in (1, 2))
        # the sample lists name each side's own directory
        outs.append(out.replace(str(work), "<work>"))
    assert outs[0] == outs[1]
    assert outs[0].count("\n") >= 3
