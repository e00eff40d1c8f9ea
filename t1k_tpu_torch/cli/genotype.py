"""Genotyping CLI of the PyTorch/CUDA port (reference genotyper,
Genotyper.cpp:194-738).

  python -m t1k_tpu_torch.cli.genotype -f ref.fa -1 c_1.fq -2 c_2.fq \\
      -o prefix --backend gpu --emBackend gpu [--device cuda:0] \\
      [--deviceCandidates]

Same flags as ``t1k_tpu.cli.genotype``, with ``gpu`` in place of
``tpu`` / ``jax`` and a ``--device`` for the gpu routes.  Without a CUDA
card, ``--backend auto`` (the default) exits with an error naming
``--backend native`` and ``--device cpu``; so does ``--deviceCandidates``
(pruning on the card) without a card, naming ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List, Optional

from ..device import NoCardError
from . import fold_negative_values


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="t1k-genotype-torch", description="Genotype candidate reads")
    ap.add_argument("-f", dest="ref", required=True)
    # repeated occurrences extend like the reference binaries' getopt loops
    ap.add_argument("-1", dest="first", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-2", dest="second", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-u", dest="single", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-i", dest="interleaved", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-o", dest="prefix", default="t1k")
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("-s", dest="similarity", type=float, default=0.8)
    ap.add_argument("-n", dest="maxAssign", type=int, default=2000)
    ap.add_argument("-a", dest="abundance", default=None)
    ap.add_argument("--frac", type=float, default=0.15)
    ap.add_argument("--cov", type=float, default=1.0)
    ap.add_argument("--crossGeneRate", type=float, default=0.04)
    ap.add_argument("--squaremMinAlpha", type=float, default=0.0)
    ap.add_argument("--alleleDigitUnits", type=int, default=-1)
    ap.add_argument("--alleleDelimiter", default="")
    ap.add_argument("--alleleWhitelist", default=None)
    ap.add_argument("--barcode", nargs="+", action="extend", default=[])
    ap.add_argument("--relaxIntronAlign", action="store_true")
    ap.add_argument("--outputReadAssignment", action="store_true")
    ap.add_argument("--deviceCandidates", dest="deviceCandidates",
                    action="store_true",
                    help="phase-A-lite: device-pruned candidate buckets for "
                         "the assignment stage, on --device whatever the "
                         "backend (byte-identical)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="alignment backend: gpu = the band kernel on "
                         "--device, native = the host engine, auto = gpu "
                         "(an error without a card unless --device cpu); "
                         "byte-identical either way")
    ap.add_argument("--emBackend", dest="emBackend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="EM implementation: native f64 loop, f64 EM on "
                         "--device, or auto = the device past 5e7 dense "
                         "cells, native below (an error without a card "
                         "unless --device cpu); bit-identical either way")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gpu routes (cuda, cuda:N, or "
                         "cpu for the kernels' plain versions)")
    ap.add_argument("--resumeEmState", dest="resumeEmState", default=None,
                    help="resume from a <prefix>_em_state.npz snapshot: "
                         "skip EM and restore its sufficient statistics")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from ..core.pipeline import GenotypeOptions

    ap = build_parser()
    args = ap.parse_args(
        fold_negative_values(sys.argv[1:] if argv is None else argv))
    opts = GenotypeOptions(
        ref_seq_similarity=args.similarity,
        relax_intron_align=args.relaxIntronAlign,
        max_assign_cnt=args.maxAssign,
        filter_frac=args.frac, filter_cov=args.cov,
        cross_gene_rate=args.crossGeneRate,
        min_squarem_alpha=args.squaremMinAlpha,
        digit_units=args.alleleDigitUnits,
        delimiter=args.alleleDelimiter,
        allele_whitelist=args.alleleWhitelist,
        abundance_file=args.abundance,
        em_state_file=args.resumeEmState,
        barcode_file=args.barcode or None,
        output_read_assignment=args.outputReadAssignment,
        threads=args.threads, backend=args.backend,
        em_backend=args.emBackend, device=args.device,
        device_candidates=args.deviceCandidates,
    )
    try:
        _run(args, opts)
    except NoCardError as err:
        ap.error(str(err))
    return 0


def _run(args, opts) -> None:
    from ..core.pipeline import run_genotyper

    if args.interleaved:
        from ..io.reads import read_seq_files, write_fastq

        # split interleaved input into the pipeline's two-pool form
        with tempfile.TemporaryDirectory() as tmp:
            f1, f2 = f"{tmp}/r_1.fq", f"{tmp}/r_2.fq"
            write_fastq(f1, list(read_seq_files(args.interleaved,
                                                interleaved_id=1)))
            write_fastq(f2, list(read_seq_files(args.interleaved,
                                                interleaved_id=2)))
            run_genotyper(args.ref, [f1], [f2], args.prefix, opts)
    elif args.single:
        run_genotyper(args.ref, args.single, None, args.prefix, opts)
    else:
        run_genotyper(args.ref, args.first, args.second or None, args.prefix,
                      opts)


if __name__ == "__main__":
    raise SystemExit(main())
