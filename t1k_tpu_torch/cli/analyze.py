"""Post-analysis CLI of the PyTorch/CUDA port (reference analyzer,
Analyzer.cpp:300-733): re-align aligned reads against the selected
alleles, re-quantify, call novel SNPs, and emit the single-cell barcode
matrix.

  python -m t1k_tpu_torch.cli.analyze -f ref.fa -a prefix_allele.tsv \\
      -1 prefix_aligned_1.fa -2 prefix_aligned_2.fa -o prefix \\
      --backend gpu [--device cuda:0]

Same flags as ``t1k_tpu.cli.analyze``, with ``gpu`` in place of ``tpu``
and ``--emBackend`` / ``--device`` for the gpu routes.  Without a CUDA
card, ``--backend auto`` (the default) exits with an error naming
``--backend native`` and ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..device import NoCardError
from . import fold_negative_values


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="t1k-analyze-torch",
        description="Novel-SNP / barcode post-analysis")
    ap.add_argument("-f", dest="ref", required=True)
    ap.add_argument("-a", dest="allele_tsv", required=True)
    ap.add_argument("-1", dest="first", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-2", dest="second", nargs="+", action="extend", default=[])
    ap.add_argument("-u", dest="single", nargs="+", action="extend", default=[])
    ap.add_argument("-o", dest="prefix", default="t1k")
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("-s", dest="similarity", type=float, default=0.8)
    ap.add_argument("-n", dest="maxAssign", type=int, default=2000)
    ap.add_argument("--alleleDigitUnits", type=int, default=-1)
    ap.add_argument("--alleleDelimiter", default="")
    ap.add_argument("--barcode", nargs="+", action="extend",
                    default=[])
    ap.add_argument("--relaxIntronAlign", action="store_true")
    ap.add_argument("--varMaxGroup", type=int, default=8)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="alignment backend: gpu = the band kernel on "
                         "--device, native = the host engine, auto = gpu "
                         "(an error without a card unless --device cpu); "
                         "byte-identical either way")
    ap.add_argument("--emBackend", dest="emBackend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="EM implementation: native f64 loop, f64 EM on "
                         "--device, or auto (as in the genotyper); "
                         "bit-identical either way")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gpu routes (cuda, cuda:N, or "
                         "cpu for the kernels' plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from ..core.analyzer import AnalyzerOptions, run_analyzer

    ap = build_parser()
    # "--varMaxGroup -1" (no limit, as the reference's getopt reads it)
    args = ap.parse_args(
        fold_negative_values(sys.argv[1:] if argv is None else argv))
    opts = AnalyzerOptions(
        ref_seq_similarity=args.similarity,
        relax_intron_align=args.relaxIntronAlign,
        max_assign_cnt=args.maxAssign,
        digit_units=args.alleleDigitUnits,
        delimiter=args.alleleDelimiter,
        barcode_file=args.barcode or None,
        var_max_group=args.varMaxGroup,
        threads=args.threads,
        backend=args.backend,
        em_backend=args.emBackend,
        device=args.device,
    )
    reads1 = args.single or args.first
    reads2 = args.second or None
    try:
        run_analyzer(args.ref, args.allele_tsv, reads1, reads2, args.prefix,
                     opts)
    except NoCardError as err:
        ap.error(str(err))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
