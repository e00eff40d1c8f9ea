"""Deterministic paired-end read simulator for tests and benchmarks.

Draws fragments from chosen alleles of a reference FASTA, applies
substitution errors, and emits mate pairs (R1 forward, R2 reverse
complement) with ground-truth provenance in the read names.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..constants import revcomp_str
from ..io.reads import SeqRecord, read_seq_file, write_fastq


@dataclass
class SimConfig:
    n_pairs: int = 500
    read_len: int = 100
    frag_mean: int = 250
    frag_std: int = 30
    error_rate: float = 0.005
    seed: int = 17


def simulate_pairs(
    alleles: Sequence[SeqRecord],
    abundances: Sequence[float],
    cfg: SimConfig,
) -> tuple[List[SeqRecord], List[SeqRecord]]:
    rng = np.random.default_rng(cfg.seed)
    probs = np.asarray(abundances, dtype=np.float64)
    probs = probs / probs.sum()
    bases = np.array(list("ACGT"))
    r1s, r2s = [], []
    for i in range(cfg.n_pairs):
        ai = rng.choice(len(alleles), p=probs)
        seq = alleles[ai].seq
        flen = int(np.clip(rng.normal(cfg.frag_mean, cfg.frag_std),
                           cfg.read_len, max(cfg.read_len, len(seq))))
        if len(seq) <= flen:
            start = 0
            flen = len(seq)
        else:
            start = int(rng.integers(0, len(seq) - flen + 1))
        frag = seq[start:start + flen]
        r1 = frag[:cfg.read_len]
        r2 = revcomp_str(frag[-cfg.read_len:])

        def mutate(s: str) -> str:
            arr = np.array(list(s))
            errs = rng.random(len(arr)) < cfg.error_rate
            if errs.any():
                repl = bases[rng.integers(0, 4, errs.sum())]
                arr[errs] = repl
            return "".join(arr)

        r1, r2 = mutate(r1), mutate(r2)
        name = f"sim_{i}_{alleles[ai].id.replace('*', '.')}_{start}"
        qual1 = "I" * len(r1)
        qual2 = "I" * len(r2)
        r1s.append(SeqRecord(name, r1, qual1))
        r2s.append(SeqRecord(name, r2, qual2))
    return r1s, r2s


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="simulate paired reads from alleles")
    ap.add_argument("-f", required=True, help="allele reference fasta")
    ap.add_argument("-o", required=True, help="output prefix")
    ap.add_argument("--alleles", nargs="+", required=True,
                    help="allele names to draw from")
    ap.add_argument("--abundances", nargs="+", type=float, default=None)
    ap.add_argument("-n", type=int, default=500)
    ap.add_argument("--readLen", type=int, default=100)
    ap.add_argument("--errorRate", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)

    by_name = {r.id: r for r in read_seq_file(args.f)}
    chosen = [by_name[a] for a in args.alleles]
    ab = args.abundances or [1.0] * len(chosen)
    cfg = SimConfig(n_pairs=args.n, read_len=args.readLen,
                    error_rate=args.errorRate, seed=args.seed)
    r1s, r2s = simulate_pairs(chosen, ab, cfg)
    write_fastq(args.o + "_1.fq", r1s)
    write_fastq(args.o + "_2.fq", r2s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
