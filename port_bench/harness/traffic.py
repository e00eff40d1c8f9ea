"""Traffic of the benchmark: the allele panel of a configuration and the
read pairs of a sample, both made from the seed by one general
generator that the configuration and workload files parametrise.

Panels (a configuration's "panel" key):
  real_alleles  the real alleles of a source fasta, each gene filled up
                to `alleles_per_gene` with seeded variants of its own
                real alleles (`substitutions` [lo, hi] each).

A panel's "seed" key fixes it (the deployment's database) whatever the
run's seed.

Samples (a workload's "sample" key): on-panel pairs simulated from a
few alleles of the first genes (optionally with seeded SNPs; with a
"donor_seed", pool sample i has the same alleles in every run), near-miss
pairs cut from panel alleles with heavy substitution, and uniform
random pairs, 1% of them low-complexity or N-rich; shuffled, with
qualities.  The recipes are those of the repository's chip smoke test
and its simulator, rewritten in numpy.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

ACGTN = np.frombuffer(b"ACGTN", np.uint8)
_LUT = np.full(256, 4, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i
# codes of the complements of A, C, G, T, N
COMP = np.array([3, 2, 1, 0, 4], np.int8)

# stream tags of np.random.default_rng([seed, tag])
PANEL_STREAM = 1
SAMPLE_STREAM = 1000
DONOR_STREAM = 2000


def encode(seq: str) -> np.ndarray:
    return _LUT[np.frombuffer(seq.encode("ascii"), np.uint8)]


def read_fasta(path: str) -> List[Tuple[str, str, str]]:
    """(name, comment, sequence) of each record."""
    recs, name, comment, seq = [], None, "", []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    recs.append((name, comment, "".join(seq)))
                head = line[1:].split(" ", 1)
                name, comment = head[0], head[1] if len(head) > 1 else ""
                seq = []
            else:
                seq.append(line)
    if name is not None:
        recs.append((name, comment, "".join(seq)))
    return recs


def write_fasta(path: str, recs) -> None:
    with open(path, "w") as f:
        for name, comment, seq in recs:
            f.write(f">{name} {comment}\n{seq}\n" if comment
                    else f">{name}\n{seq}\n")


# ------------------------------------------------------------------ panels

def real_alleles(src, per_gene: int, subs, rng) -> list:
    """Each gene of the source fasta (the name before '*') keeps its real
    alleles and is filled up to `per_gene` alleles, each a copy of one of
    the gene's real alleles, drawn at random, with a number of
    substitutions drawn uniformly from `subs` [lo, hi] at distinct
    positions.  Names are <gene>*<major><minor>, four alleles to a major
    allele numbered from 100, so none meets a real name; every sequence
    is distinct."""
    by_gene = {}
    for rec in src:
        by_gene.setdefault(rec[0].split("*")[0], []).append(rec)
    out, seen = [], set()
    for gene in sorted(by_gene):
        real = by_gene[gene]
        out += real
        seen.update(r[2] for r in real)
        v = 0
        while len(real) + v < per_gene:
            _, comment, seq = real[int(rng.integers(len(real)))]
            codes = encode(seq)
            n_sub = int(rng.integers(subs[0], subs[1] + 1))
            pos = rng.choice(len(codes), n_sub, replace=False)
            codes = codes.copy()
            codes[pos] = (codes[pos] + rng.integers(1, 4, n_sub)) % 4
            new = ACGTN[codes].tobytes().decode("ascii")
            if new in seen:
                continue
            seen.add(new)
            out.append((f"{gene}*{100 + v // 4:03d}{v % 4 + 1:02d}",
                        comment, new))
            v += 1
    return out


def build_panel(panel: dict, seed: int, root: str, work: str) -> str:
    """Writes the configuration's panel under `work`; returns its path.
    `root` is the harness's folder (source files are named from it)."""
    # a panel "seed" fixes the database whatever the run's seed
    rng = np.random.default_rng([panel.get("seed", seed), PANEL_STREAM])
    path = os.path.join(work, "panel.fa")
    if panel["kind"] == "real_alleles":
        src = read_fasta(os.path.join(root, panel["source_fasta"]))
        write_fasta(path, real_alleles(src, panel["alleles_per_gene"],
                                       panel["substitutions"], rng))
    else:
        raise ValueError(f"unknown panel kind {panel['kind']!r}")
    return path


# ----------------------------------------------------------------- samples

def _concat(seqs: List[np.ndarray]):
    """Concatenated codes and each sequence's offset and length."""
    lens = np.array([len(s) for s in seqs], np.int64)
    off = np.zeros(len(seqs), np.int64)
    off[1:] = np.cumsum(lens[:-1])
    return np.concatenate(seqs), off, lens


def _fragments(cat, off, lens, ai, start, flen, read_len: int):
    """Mate 1 from each fragment's start, mate 2 reverse-complemented
    from its end, [n, read_len] codes."""
    cols = np.arange(read_len)
    m1 = cat[(off[ai] + start)[:, None] + cols]
    end = off[ai] + start + flen
    m2 = COMP[cat[(end - read_len)[:, None] + cols][:, ::-1]]
    return m1, m2


def _abundances(spec: dict, n: int, rng) -> np.ndarray:
    if spec["kind"] == "fixed":
        vals = np.asarray(spec["values"], np.float64)
        return np.resize(vals, n)
    if spec["kind"] == "uniform":
        return rng.random(n) * (spec["high"] - spec["low"]) + spec["low"]
    raise ValueError(f"unknown abundance kind {spec['kind']!r}")


def on_panel_pairs(recs, spec: dict, read_len: int, rng, index: int = 0):
    """Pairs simulated from 'alleles' [lo, hi] alleles of each of the
    first 'genes' genes (sorted by name), drawn by abundance, fragments
    of normal(frag_mean, frag_std) bp, substitution errors at
    'error_rate'; with 'snp_genes', the first allele of that many genes
    carries substitutions at 'snp_positions' (absent from the panel).
    With 'donor_seed', pool sample `index` has the same alleles and
    abundances whatever the run's seed, which then draws only the
    reads."""
    donor = (np.random.default_rng([spec["donor_seed"],
                                    DONOR_STREAM + index])
             if "donor_seed" in spec else rng)
    by_gene = {}
    for name, _, seq in recs:
        by_gene.setdefault(name.split("*")[0], []).append(seq)
    seqs, weights = [], []
    lo, hi = spec["alleles"]
    for g, gene in enumerate(sorted(by_gene)[:spec["genes"]]):
        pool = by_gene[gene]
        n = int(donor.integers(lo, hi + 1))
        pick = donor.choice(len(pool), n, replace=False)
        ab = _abundances(spec["abundance"], n, donor)
        for j, p in enumerate(pick):
            codes = encode(pool[p])
            if j == 0 and g < spec.get("snp_genes", 0):
                codes = codes.copy()
                for q in spec["snp_positions"]:
                    if q < len(codes) and codes[q] < 4:
                        codes[q] = (codes[q] + 1) % 4
            seqs.append(codes)
            weights.append(ab[j])
    cat, off, lens = _concat(seqs)
    n = spec["pairs"]
    p = np.asarray(weights) / np.sum(weights)
    ai = rng.choice(len(seqs), n, p=p)
    flen = np.clip(rng.normal(spec["frag_mean"], spec["frag_std"], n),
                   read_len, np.maximum(read_len, lens[ai])).astype(np.int64)
    flen = np.minimum(flen, lens[ai])
    start = (rng.random(n) * (lens[ai] - flen + 1)).astype(np.int64)
    m1, m2 = _fragments(cat, off, lens, ai, start, flen, read_len)
    for mate in (m1, m2):
        err = rng.random(mate.shape) < spec["error_rate"]
        mate[err] = rng.integers(0, 4, int(err.sum()))
    return m1, m2


def near_miss_pairs(recs, spec: dict, read_len: int, rng):
    """Pairs cut from uniformly drawn panel alleles (fragments of
    'frag_len' bp) with a per-pair substitution rate in 'sub_rate'."""
    seqs = [encode(r[2]) for r in recs]
    cat, off, lens = _concat(seqs)
    n = spec["pairs"]
    ai = rng.integers(0, len(seqs), n)
    lo, hi = spec["frag_len"]
    flen = np.minimum(rng.integers(lo, hi + 1, n), lens[ai])
    start = (rng.random(n) * (lens[ai] - flen + 1)).astype(np.int64)
    m1, m2 = _fragments(cat, off, lens, ai, start, flen, read_len)
    rate = rng.uniform(spec["sub_rate"][0], spec["sub_rate"][1], n)[:, None]
    for mate in (m1, m2):
        sub = rng.random(mate.shape) < rate
        mate[sub] = (mate[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return m1, m2


def random_pairs(spec: dict, read_len: int, rng):
    """Uniform random pairs; an 'odd_share' of them have mate 1
    dominated by one base or N-rich, in turns."""
    n = spec["pairs"]
    r1 = rng.integers(0, 4, (n, read_len)).astype(np.int8)
    r2 = rng.integers(0, 4, (n, read_len)).astype(np.int8)
    odd = np.flatnonzero(rng.random(n) < spec["odd_share"])
    for j, i in enumerate(odd):
        if j % 2:
            r1[i, rng.random(read_len) < 0.6] = 0
        else:
            r1[i, rng.random(read_len) < 0.15] = 4
    return r1, r2


def write_fastq(path: str, seqs: np.ndarray, quals: np.ndarray) -> None:
    """Records x0, x1, ... from [n, L] ASCII arrays."""
    n, L = seqs.shape
    with open(path, "wb") as f:
        f.write(b"".join(b"@x%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(),
                                                   quals[i].tobytes())
                         for i in range(n)))


def make_sample(recs, sample: dict, seed: int, index: int,
                prefix: str) -> int:
    """Writes <prefix>_1.fq and <prefix>_2.fq of pool sample `index`;
    returns its pair count."""
    rng = np.random.default_rng([seed, SAMPLE_STREAM + index])
    L = sample["read_len"]
    parts = [on_panel_pairs(recs, sample["on_panel"], L, rng, index),
             near_miss_pairs(recs, sample["near_miss"], L, rng),
             random_pairs(sample["random"], L, rng)]
    mate1 = np.concatenate([p[0] for p in parts])
    mate2 = np.concatenate([p[1] for p in parts])
    order = rng.permutation(len(mate1))
    quals = rng.integers(35, 74, (len(mate1), L)).astype(np.uint8)
    write_fastq(prefix + "_1.fq", ACGTN[mate1[order]], quals)
    write_fastq(prefix + "_2.fq", ACGTN[mate2[order]], quals[::-1])
    return len(mate1)
