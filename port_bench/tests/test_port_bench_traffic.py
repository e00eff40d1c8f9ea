"""The traffic generators repeat byte for byte by seed and differ
across seeds."""

from __future__ import annotations

import hashlib
import os

from harness import traffic

KIR = {"kind": "real_alleles", "source_fasta": "data/kir_rna_ipd.fa",
       "alleles_per_gene": 12, "substitutions": [1, 16]}
SAMPLE = {
    "read_len": 100,
    "on_panel": {"pairs": 120, "genes": 2, "alleles": [1, 2],
                 "abundance": {"kind": "uniform", "low": 0.1, "high": 1.0},
                 "snp_genes": 1, "snp_positions": [300, 700],
                 "frag_mean": 250, "frag_std": 30, "error_rate": 0.005},
    "near_miss": {"pairs": 40, "frag_len": [200, 350],
                  "sub_rate": [0.25, 0.35]},
    "random": {"pairs": 200, "odd_share": 0.05},
}
BIG_SEED = 2 ** 31 + 12_345


def _sha(*paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _panel(tmp_path, panel, seed, tag) -> str:
    work = tmp_path / tag
    work.mkdir()
    return traffic.build_panel(panel, seed, traffic_root(), str(work))


def traffic_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(
        traffic.__file__)))


def _sample(tmp_path, panel_path, seed, index, tag) -> str:
    prefix = str(tmp_path / tag)
    n = traffic.make_sample(traffic.read_fasta(panel_path), SAMPLE, seed,
                            index, prefix)
    assert n == 360
    return _sha(prefix + "_1.fq", prefix + "_2.fq")


def test_panel_repeats_by_seed(tmp_path):
    a = _panel(tmp_path, KIR, BIG_SEED, "a")
    b = _panel(tmp_path, KIR, BIG_SEED, "b")
    c = _panel(tmp_path, KIR, BIG_SEED + 1, "c")
    assert _sha(a) == _sha(b) != _sha(c)
    fixed = dict(KIR, seed=7)
    assert (_sha(_panel(tmp_path, fixed, 1, "d"))
            == _sha(_panel(tmp_path, fixed, 2, "e")))


def test_panel_keeps_the_real_alleles(tmp_path):
    recs = traffic.read_fasta(_panel(tmp_path, KIR, 3, "a"))
    src = traffic.read_fasta(os.path.join(traffic_root(),
                                          KIR["source_fasta"]))
    assert len(recs) == 10 * 12            # genes x alleles_per_gene
    assert len({r[0] for r in recs}) == len({r[2] for r in recs}) == 120
    assert set(src) <= set(recs)
    real = {r[0].split("*")[0]: r[2] for r in src}
    for name, _, seq in recs:
        gene = name.split("*")[0]
        assert gene in real
        near = min(sum(x != y for x, y in zip(seq, s[2]))
                   for s in src if s[0].startswith(gene + "*")
                   and len(s[2]) == len(seq))
        assert near <= 16


def test_samples_repeat_by_seed_and_index(tmp_path):
    panel = _panel(tmp_path, KIR, 11, "p")
    first = _sample(tmp_path, panel, BIG_SEED, 0, "s0")
    assert _sample(tmp_path, panel, BIG_SEED, 0, "s0b") == first
    assert _sample(tmp_path, panel, BIG_SEED, 1, "s1") != first
    assert _sample(tmp_path, panel, BIG_SEED + 1, 0, "t0") != first


def test_sample_reads_are_well_formed(tmp_path):
    panel = _panel(tmp_path, KIR, 3, "p")
    prefix = str(tmp_path / "s")
    traffic.make_sample(traffic.read_fasta(panel), SAMPLE, 3, 0, prefix)
    for mate in ("_1.fq", "_2.fq"):
        with open(prefix + mate) as f:
            lines = f.read().splitlines()
        assert len(lines) == 4 * 360
        assert all(len(s) == 100 and set(s) <= set("ACGTN")
                   for s in lines[1::4])
        assert lines[0::4] == [f"@x{i}" for i in range(360)]
