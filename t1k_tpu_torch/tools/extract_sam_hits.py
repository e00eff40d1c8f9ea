"""Filter candidate reads by ids aligned in an external SAM
(reference ExtractBamHits.pl).

The reference matches the ENTIRE post-'@' header line (its
`my @cols = substr($header, 1)` never splits, ExtractBamHits.pl:34)
against the SAM qname, and reprints the original record lines
verbatim — mirrored here, so reads whose fastq headers carry comments
only match when the SAM qname contains the whole header.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def extract_sam_hits(sam_path: str, fq_path: str, out=sys.stdout) -> int:
    ids = set()
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            cols = line.split()
            if len(cols) > 2 and cols[2] != "*":
                ids.add(cols[0])
    n = 0
    with open(fq_path) as f:
        while True:
            header = f.readline()
            if not header:
                break
            seq = f.readline()
            sep = qual = ""
            if header.startswith("@"):
                sep = f.readline()
                qual = f.readline()
            if header.rstrip("\n")[1:] in ids:
                n += 1
                out.write(header.rstrip("\n") + "\n" + seq + sep + qual)
    return n


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="keep candidate reads aligned in an external SAM")
    ap.add_argument("sam")
    ap.add_argument("fq")
    args = ap.parse_args(argv)
    extract_sam_hits(args.sam, args.fq)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
