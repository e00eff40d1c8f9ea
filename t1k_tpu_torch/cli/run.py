"""Pipeline driver of the PyTorch/CUDA port: the `run-t1k` equivalent.

  python -m t1k_tpu_torch.cli.run -f ref.fa -1 r_1.fq -2 r_2.fq \\
      --od out -o sample [--backend gpu --emBackend gpu --device cuda:0]
  python -m t1k_tpu_torch.cli.run -f ref.fa -b in.bam -c coord.fa \\
      --od out -o sample [--barcode CB --UMI UB] [--backend gpu ...]

Runs candidate extraction -> genotyping -> post analysis with the same
staging, presets and output naming as the reference driver (run-t1k) and
``t1k_tpu.cli.run``:

  stage 0: extraction writes   <prefix>_candidate{_1,_2,}.fq (+ _bc.fa)
  stage 1: genotyping writes   <prefix>_genotype.tsv, _allele.tsv,
                               _aligned{_1,_2,}.fa (+ _aligned_bc.fa)
  stage 2: post analysis       <prefix>_allele.vcf (+ _barcode_expr.tsv)

Presets (run-t1k:289-314): hla -> -s 0.97 for genotyper/analyzer;
hla-wgs additionally -s 0.97 for the extractor; kir-wgs -> -s 0.9
--relaxIntronAlign; kir-wes -> --relaxIntronAlign.

``--backend`` and ``--emBackend`` take ``gpu`` in place of ``tpu`` /
``jax``, and ``--device`` names the torch device of the gpu routes (BAM
input, -b, screens on them too).  Without a CUDA card, ``auto`` (the
default) exits with an error naming ``--backend native`` and ``--device
cpu``.  ``--deviceCandidates`` prunes the genotyper's candidate buckets
on ``--device`` (byte-identical); without a card it exits with an error
naming ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..config import PipelineConfig
from ..core.genotyper import Genotyper
from ..device import NoCardError, resolve_backend, resolve_device
from ..utils.observability import metrics_run
from . import fold_negative_values

# run-t1k's presets (run-t1k:289-314; PipelineConfig.apply_preset)
PRESETS = ("hla", "hla-wgs", "kir-wgs", "kir-wes")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="t1k-torch",
        description="KIR/HLA genotyper on PyTorch/CUDA",
    )
    # repeated occurrences extend like the reference binaries' getopt
    # loops (each -1/-u/--barcode appends another file)
    ap.add_argument("-1", dest="first", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-2", dest="second", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-u", dest="single", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-i", dest="interleaved", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-b", dest="bam", default=None)
    ap.add_argument("-f", dest="ref", required=True)
    ap.add_argument("-c", dest="coord", default=None)
    ap.add_argument("-o", dest="prefix", default="")
    ap.add_argument("--od", dest="outdir", default="")
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("-s", dest="similarity", type=float, default=None)
    ap.add_argument("-n", dest="maxAssign", type=int, default=2000)
    ap.add_argument("--frac", type=float, default=0.15)
    ap.add_argument("--cov", type=float, default=1.0)
    ap.add_argument("--crossGeneRate", type=float, default=0.04)
    ap.add_argument("--squaremMinAlpha", type=float, default=0.0)
    ap.add_argument("--alleleDigitUnits", type=int, default=-1)
    ap.add_argument("--alleleDelimiter", default="")
    ap.add_argument("--alleleWhitelist", default=None)
    ap.add_argument("--barcode", nargs="+", action="extend",
                    default=[])
    ap.add_argument("--barcodeRange", nargs=3, default=None,
                    metavar=("START", "END", "STRAND"))
    ap.add_argument("--barcodeWhitelist", default=None)
    ap.add_argument("--UMI", dest="umi", default="",
                    help="if -b: BAM tag carrying the UMI (run-t1k:230-234)")
    ap.add_argument("--read1Range", nargs=2, type=int, default=None)
    ap.add_argument("--read2Range", nargs=2, type=int, default=None)
    ap.add_argument("--mateIdSuffixLen", type=int, default=0)
    ap.add_argument("--abnormalUnmapFlag", action="store_true")
    ap.add_argument("--relaxIntronAlign", action="store_true")
    ap.add_argument("--preset", default="",
                    choices=["", *PRESETS])
    ap.add_argument("--noExtraction", action="store_true")
    ap.add_argument("--skipPostAnalysis", action="store_true")
    ap.add_argument("--outputReadAssignment", action="store_true")
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--post-varMaxGroup", dest="varMaxGroup", type=int,
                    default=8)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="extraction screen and alignment backend: gpu = "
                         "the kernels on --device, native = the host "
                         "engine, auto = gpu (an error without a card "
                         "unless --device cpu); byte-identical either way")
    ap.add_argument("--emBackend", dest="emBackend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="EM implementation of the genotyper and the "
                         "analyzer: native f64 loop, f64 EM on --device, "
                         "or auto = the device past 5e7 dense cells, "
                         "native below (an error without a card unless "
                         "--device cpu); bit-identical either way")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gpu routes (cuda, cuda:N, or "
                         "cpu for the kernels' plain versions)")
    ap.add_argument("--deviceCandidates", dest="deviceCandidates",
                    action="store_true",
                    help="phase-A-lite: device-pruned candidate buckets for "
                         "the genotyper's assignment stage, on --device "
                         "whatever the backend (byte-identical)")
    return ap


def resolve_preset(preset: str, similarity: Optional[float],
                   relax: bool = False):
    """(genotyper -s, extractor -s, relaxIntronAlign) for a preset
    (run-t1k:289-314): PipelineConfig.apply_preset over -s (default 0.8)
    and --relaxIntronAlign.  Any other name leaves those as they are, as
    run-t1k does (apply_preset itself raises on it)."""
    sim = similarity if similarity is not None else 0.8
    cfg = PipelineConfig(similarity=sim, extractor_similarity=sim,
                         relax_intron_align=relax)
    if preset in PRESETS:
        cfg.apply_preset(preset)
    return cfg.similarity, cfg.extractor_similarity, cfg.relax_intron_align


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    ap = build_parser()
    # negative option values (--post-varMaxGroup -1,
    # --squaremMinAlpha -0.5, --read1Range 0 -1) would be read by
    # argparse as the -1/-2 options; fold them in
    args = ap.parse_args(fold_negative_values(argv))

    geno_sim, extract_sim, relax = resolve_preset(
        args.preset, args.similarity, args.relaxIntronAlign)

    first = args.first or args.single
    paired = bool(args.second) or bool(args.interleaved)
    if not first and not args.interleaved and not args.bam:
        print("Need -1/-2, -u, -i or -b to specify input reads.",
              file=sys.stderr)
        return 1
    if args.bam and not args.coord:
        # run-t1k:284-287 dies with the same diagnostic
        print("Need to use -c to specify gene coordinate file for BAM "
              "input.", file=sys.stderr)
        return 1
    if args.noExtraction and not first:
        # validated BEFORE any output (incl. the config file) is written
        print("--noExtraction requires -1/-2 or -u input.", file=sys.stderr)
        return 1
    try:  # an "auto" route without a card: fail before any output
        resolve_backend(args.backend, args.device)
        if args.deviceCandidates:  # on --device whatever the backend
            resolve_device(args.device, NoCardError)
        if args.emBackend == "auto":
            Genotyper._resolve_em_backend(0, 0, args.device)
    except NoCardError as err:
        ap.error(str(err))

    prefix = args.prefix
    if not prefix:
        # inference only looks at -b and -1/-u; interleaved-only input
        # falls through to the bare "T1K" default (run-t1k:316-331)
        base = args.bam or (first[0] if first else None)
        prefix = ("T1K_" + os.path.basename(base).split(".")[0]
                  if base else "T1K")
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        prefix = os.path.join(args.outdir, prefix)

    # Multi-process execution: N identical processes of this CLI with
    # T1K_NUM_PROCESSES=N and T1K_PROCESS_ID=0..N-1 share the output
    # directory.  Extraction and post analysis run on process 0; the
    # genotyper's assignment stage runs on every process over a
    # contiguous fragment shard, shards are exchanged as files and
    # process 0 merges them in process order, byte-identical to a
    # single-process run at any N (parallel/distributed.py).  Every
    # process resolves its own backend from --backend / T1K_BACKEND: the
    # processes may share one card.
    nproc = int(os.environ.get("T1K_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("T1K_PROCESS_ID", "0"))
    if nproc > 1 and (args.barcode or args.outputReadAssignment
                      or args.alleleWhitelist):
        print("Distributed mode covers the standard paired/single flow; "
              "barcode, whitelist and per-read-assignment outputs run "
              "single-process (or per-cell, tools/smartseq.py).",
              file=sys.stderr)
        return 1

    # serialize the resolved configuration next to the outputs
    cfg = PipelineConfig(
        reference=args.ref, threads=args.threads, backend=args.backend,
        device=args.device,
        extractor_similarity=extract_sim, similarity=geno_sim,
        relax_intron_align=relax, max_assign_cnt=args.maxAssign,
        filter_frac=args.frac, filter_cov=args.cov,
        cross_gene_rate=args.crossGeneRate,
        min_squarem_alpha=args.squaremMinAlpha,
        allele_digit_units=args.alleleDigitUnits,
        allele_delimiter=args.alleleDelimiter,
        allele_whitelist=args.alleleWhitelist,
        barcode_file=args.barcode[0] if args.barcode else None,
        barcode_whitelist=args.barcodeWhitelist,
        var_max_group=args.varMaxGroup,
        skip_post_analysis=args.skipPostAnalysis,
        preset=args.preset, stage=args.stage,
    )
    if pid == 0:  # one writer when running distributed
        cfg.save(f"{prefix}_config.json")
    # one set of stage records for the chain, extraction's included, in
    # <prefix>_metrics.json
    with metrics_run():
        return _run(args, prefix, first, paired, geno_sim, extract_sim,
                    relax, nproc, pid)


def _run(args, prefix: str, first: List[str], paired: bool,
         geno_sim: float, extract_sim: float, relax: bool, nproc: int,
         pid: int) -> int:
    from ..core.extractor import ExtractorOptions, run_extractor
    from ..core.pipeline import GenotypeOptions, log, run_genotyper

    cand1 = f"{prefix}_candidate_1.fq"
    cand2 = f"{prefix}_candidate_2.fq"
    cand = f"{prefix}_candidate.fq"

    # ---------------------------------------------------------- stage 0
    if nproc > 1 and pid > 0 and args.stage <= 0 and not args.noExtraction:
        # workers wait for process 0's extraction (file-boundary barrier)
        from ..parallel.distributed import wait_for_files
        wait_for_files([f"{prefix}_extract.done"])
    elif args.stage <= 0 and not args.noExtraction:
        eopts = ExtractorOptions(
            ref_seq_similarity=extract_sim,
            threads=args.threads,
            barcode_file=args.barcode or None,
            barcode_whitelist=args.barcodeWhitelist,
            backend=args.backend,
            device=args.device,
        )
        if args.barcodeRange:
            eopts.barcode_start = int(args.barcodeRange[0])
            eopts.barcode_end = int(args.barcodeRange[1])
            eopts.barcode_revcomp = args.barcodeRange[2] == "-"
        if args.read1Range:
            eopts.read1_start, eopts.read1_end = args.read1Range
        if args.read2Range:
            eopts.read2_start, eopts.read2_end = args.read2Range
        if args.bam:
            from ..io.bam import extract_from_bam
            # the coordinate fasta doubles as the screening reference
            # (run-t1k:350 passes it as bam-extractor's -f); the screen
            # takes --backend and --device as the FASTQ route does
            extract_from_bam(
                args.bam, args.coord, args.coord, f"{prefix}_candidate",
                abnormal_unmap_flag=args.abnormalUnmapFlag,
                mate_id_len=args.mateIdSuffixLen or -1,
                bc_field=args.barcode[0] if args.barcode else "",
                umi_field=args.umi, backend=args.backend,
                device=args.device)
        else:
            log("Start to extract candidate reads from read files.")
            run_extractor(
                args.ref, first if not args.interleaved else args.interleaved,
                args.second or None, f"{prefix}_candidate", eopts,
                interleaved=bool(args.interleaved),
            )
            log("Finish extracting reads.")
        if nproc > 1 and pid == 0:
            with open(f"{prefix}_extract.done", "w") as f:
                f.write("done\n")

    # determine candidate files
    if not args.noExtraction:
        if os.path.exists(cand1):
            files1, files2 = [cand1], [cand2]
            paired = True
        elif os.path.exists(cand):
            files1, files2 = [cand], None
            paired = False
        elif args.stage <= 1:
            print(f"Could not find files like {prefix}_candidate*.fq",
                  file=sys.stderr)
            return 1
        else:
            files1, files2 = [], None
    else:
        files1 = [first[0]]
        files2 = [args.second[0]] if args.second else None
        paired = files2 is not None

    barcode_geno = f"{prefix}_candidate_bc.fa" if args.barcode else None

    # ---------------------------------------------------------- stage 1
    if args.stage <= 1:
        gopts = GenotypeOptions(
            ref_seq_similarity=geno_sim,
            relax_intron_align=relax,
            max_assign_cnt=args.maxAssign,
            filter_frac=args.frac,
            filter_cov=args.cov,
            cross_gene_rate=args.crossGeneRate,
            min_squarem_alpha=args.squaremMinAlpha,
            digit_units=args.alleleDigitUnits,
            delimiter=args.alleleDelimiter,
            allele_whitelist=args.alleleWhitelist,
            barcode_file=barcode_geno,
            output_read_assignment=args.outputReadAssignment,
            threads=args.threads,
            backend=args.backend,
            em_backend=args.emBackend,
            device=args.device,
            device_candidates=args.deviceCandidates,
        )
        if nproc > 1:
            from ..parallel.distributed import (merge_shards_and_finish,
                                                wait_for_files,
                                                worker_shard_to_file)
            shard = f"{prefix}_dshard_{pid}.npz"
            worker_shard_to_file(args.ref, files1, files2, gopts, pid,
                                 nproc, shard)
            if pid != 0:
                log(f"Distributed worker {pid} finished; process 0 "
                    "merges and writes outputs.")
                return 0
            shards = [f"{prefix}_dshard_{p}.npz" for p in range(nproc)]
            wait_for_files(shards)
            merge_shards_and_finish(args.ref, files1, files2, prefix,
                                    gopts, shards)
        else:
            run_genotyper(args.ref, files1, files2, prefix, gopts)

    if nproc > 1 and pid != 0:
        # post analysis is process-0 work (it reads the merged outputs);
        # reached only when staging skipped the genotype step
        return 0

    # ---------------------------------------------------------- stage 2
    if args.stage <= 2 and not args.skipPostAnalysis:
        from ..core.analyzer import AnalyzerOptions, run_analyzer
        # the reference driver routes an EXPLICIT --relaxIntronAlign only
        # to the genotyper (run-t1k:236-239); the analyzer receives it
        # solely through the kir-wgs/kir-wes presets (run-t1k:302-308)
        relax_analyzer = args.preset in ("kir-wgs", "kir-wes")
        aopts = AnalyzerOptions(
            ref_seq_similarity=geno_sim,
            relax_intron_align=relax_analyzer,
            digit_units=args.alleleDigitUnits,
            delimiter=args.alleleDelimiter,
            barcode_file=f"{prefix}_aligned_bc.fa" if args.barcode else None,
            var_max_group=args.varMaxGroup,
            threads=args.threads,
            backend=args.backend,
            em_backend=args.emBackend,
            device=args.device,
        )
        aligned1 = f"{prefix}_aligned_1.fa" if paired else f"{prefix}_aligned.fa"
        aligned2 = f"{prefix}_aligned_2.fa" if paired else None
        run_analyzer(args.ref, f"{prefix}_allele.tsv", [aligned1],
                     [aligned2] if aligned2 else None, prefix, aopts)

    log("Finish.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
