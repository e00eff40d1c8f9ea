"""Group samples by shared HLA-A/B/C low-resolution signature —
duplicate-person detection (reference scripts/GroupSample.py)."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def group_samples(files: List[str], qual: int = 29, digits: int = 2,
                  genes=("HLA-A", "HLA-B", "HLA-C"), out=sys.stdout) -> None:
    gene_set = set(genes)
    sample_signature = {}
    bad = set()
    for f in files:
        with open(f) as fp:
            for line in fp:
                cols = line.rstrip().split("\t")
                if cols[0] not in gene_set:
                    continue
                sample_signature.setdefault(f, set())
                if int(cols[1]) >= 1:
                    sample_signature[f].add(
                        ":".join(cols[2].split(",")[0].split(":")[:digits]))
                    if int(cols[4]) <= qual:
                        bad.add(f)
                if int(cols[1]) >= 2:
                    sample_signature[f].add(
                        ":".join(cols[5].split(",")[0].split(":")[:digits]))
                    if int(cols[7]) <= qual:
                        bad.add(f)

    signature_to_samples = {}
    group_id = {}
    for s, sig in sample_signature.items():
        if s in bad:
            group_id[s] = -1
            continue
        signature_to_samples.setdefault(tuple(sorted(sig)), []).append(s)
    for i, samples in enumerate(signature_to_samples.values()):
        for s in samples:
            group_id[s] = i
    for s, gid in group_id.items():
        out.write(f"{s} {gid}\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Group samples into people-level")
    ap.add_argument("-l", dest="filelist", required=True)
    ap.add_argument("-q", dest="qual", type=int, default=29)
    ap.add_argument("-d", dest="digits", type=int, default=2)
    args = ap.parse_args(argv)
    with open(args.filelist) as f:
        files = [line.strip() for line in f if line.strip()]
    group_samples(files, args.qual, args.digits)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
