"""BAM candidate-read extraction CLI of the PyTorch/CUDA port (reference
bam-extractor, BamExtractor.cpp:468-949): keep unaligned templates,
alt-contig reads and reads overlapping the gene intervals of the
coordinate file.

  python -m t1k_tpu_torch.cli.bamextract -b in.bam -f ref_coord.fa \\
      -o prefix --backend gpu [--device cuda:0]

Same flags as ``t1k_tpu.cli.bamextract``, plus ``--backend`` and
``--device`` as ``cli/extract.py`` has them.  Without a CUDA card,
``--backend auto`` (the default) exits with an error naming ``--backend
native`` and ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..device import NoCardError


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="t1k-bamextract-torch",
        description="Extract candidate reads from BAM")
    ap.add_argument("-b", dest="bam", required=True)
    ap.add_argument("-f", dest="ref", required=True,
                    help="screen reference fasta (with genome coordinates "
                         "in comments, e.g. the _coord.fa)")
    ap.add_argument("-c", dest="coord", default=None,
                    help="coordinate fasta (defaults to -f)")
    ap.add_argument("-o", dest="prefix", default="t1k")
    ap.add_argument("-t", dest="threads", type=int, default=1,
                    help="worker threads (the native reader already "
                         "scales to all cores; accepted for parity with "
                         "BamExtractor.cpp:512-515)")
    ap.add_argument("-u", dest="abnormalUnmapFlag", action="store_true",
                    help="short form of --abnormalUnmapFlag "
                         "(BamExtractor.cpp:508-511)")
    ap.add_argument("--barcode", default="",
                    help="BAM tag carrying the cell barcode (e.g. CB)")
    ap.add_argument("--UMI", dest="umi", default="",
                    help="BAM tag carrying the UMI (e.g. UB)")
    ap.add_argument("--abnormalUnmapFlag", action="store_true")
    ap.add_argument("--mateIdSuffixLen", type=int, default=-1)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="screen backend; gpu = the device phase-A screen "
                         "on --device with the native engine re-screening "
                         "what it cannot decide, native = the host engine, "
                         "auto = gpu once T1K_SCREEN_DEVICE_MIN_READS BAM "
                         "records have streamed (an error without a card "
                         "unless --device cpu); byte-identical output "
                         "either way")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gpu route (cuda, cuda:N, or "
                         "cpu for the kernels' plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from ..io.bam import extract_from_bam

    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        stats = extract_from_bam(
            args.bam, args.coord or args.ref, args.ref, args.prefix,
            abnormal_unmap_flag=args.abnormalUnmapFlag,
            mate_id_len=args.mateIdSuffixLen,
            bc_field=args.barcode, umi_field=args.umi,
            backend=args.backend, device=args.device)
    except NoCardError as err:
        ap.error(str(err))
    print(f"extracted {stats['candidates']} candidates", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
