"""Candidate-read extraction CLI of the PyTorch/CUDA port (reference
fastq-extractor, FastqExtractor.cpp:220-628).

  python -m t1k_tpu_torch.cli.extract -f ref.fa -1 r1.fq -2 r2.fq \\
      -o prefix --backend gpu [--device cuda:0]

Same flags as ``t1k_tpu.cli.extract``, with ``gpu`` in place of ``tpu``
and a ``--device`` for the gpu route.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from t1k_tpu.cli.extract import _merge_negative_ints
from t1k_tpu.cli.extract import build_parser as _host_parser


def build_parser():
    ap = _host_parser()
    ap.prog = "t1k-extract-torch"
    for action in ap._actions:
        if action.dest == "backend":
            action.choices = ["auto", "native", "gpu"]
            action.help = ("screen backend; gpu = the device phase-A screen "
                           "on --device with the native engine re-screening "
                           "what it cannot decide, auto = gpu once "
                           "T1K_SCREEN_DEVICE_MIN_READS reads have streamed "
                           "and a card is present (byte-identical output "
                           "either way)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gpu route (cuda, cuda:N, or "
                         "cpu for the kernels' plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from ..core.extractor import ExtractorOptions, run_extractor

    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(_merge_negative_ints(list(argv)))
    opts = ExtractorOptions(ref_seq_similarity=args.similarity,
                            threads=args.threads, backend=args.backend,
                            device=args.device)
    if args.barcode:
        opts.barcode_file = args.barcode
    if args.barcodeRange:
        opts.barcode_start = int(args.barcodeRange[0])
        opts.barcode_end = int(args.barcodeRange[1])
        opts.barcode_revcomp = args.barcodeRange[2] == "-"
    if args.barcodeWhitelist:
        opts.barcode_whitelist = args.barcodeWhitelist
    if args.read1Range:
        opts.read1_start, opts.read1_end = args.read1Range
    if args.read2Range:
        opts.read2_start, opts.read2_end = args.read2Range
    for attr, val in (("barcode_start", args.barcodeStart),
                      ("barcode_end", args.barcodeEnd),
                      ("read1_start", args.read1Start),
                      ("read1_end", args.read1End),
                      ("read2_start", args.read2Start),
                      ("read2_end", args.read2End)):
        if val is not None:
            setattr(opts, attr, val)
    if args.barcodeRevComp:
        opts.barcode_revcomp = True

    if args.interleaved:
        stats = run_extractor(args.ref, args.interleaved, None, args.prefix,
                              opts, interleaved=True)
    elif args.single:
        stats = run_extractor(args.ref, args.single, None, args.prefix, opts)
    else:
        stats = run_extractor(args.ref, args.first, args.second or None,
                              args.prefix, opts)
    print(f"extracted {stats['candidates']} candidates", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
