"""SMART-seq single-cell pipeline of the port (reference t1k-smartseq.pl;
counterpart of t1k_tpu/tools/smartseq.py).

  python -m t1k_tpu_torch.tools.smartseq -1 list_1.txt -2 list_2.txt \\
      -f ref.fa -o plate [--workers 8] [--cohortEm] [--device cuda]

Per-cell genotyping -> cross-cell allele voting -> reduced reference of
the winning alleles -> per-cell re-genotyping against the reduced
reference (--noExtraction).  Cells are independent, so both per-cell
passes dispatch over a spawn pool (`--workers N`), each cell through
t1k_tpu_torch.cli.run with the parent's --backend (its "auto" resolved
once, here), --emBackend and --device.  The cross-cell voting and
reduced-reference construction are global barriers between the two
passes, exactly as in t1k-smartseq.pl.

With --cohortEm the second pass runs in this process: every cell's
alignment and EC construction against one parsed reduced reference and
one band-kernel service, then one EM for the whole plate
(ops/em.py em_quantify_batched: the cohort form of csrc/em_squarem.cu,
one block per cell, on --device), then selection and outputs per cell.
Each cell's EM has the native loop's bits, so the outputs are
byte-identical to the per-cell path.  On a machine with more than one
card the cell axis is dealt over all of them (parallel/mesh.py
data_mesh), as the reference shards it over its device mesh.

Kernel launches made in pool workers are summed per kernel into
`worker_launch_counts`; each wrapper's own count covers its process.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
from typing import Dict, List, Optional

from ..io.reads import read_seq_file
from .merge import merge_genotypes

# launches of the kernels in this process's pool workers, per kernel
worker_launch_counts: Dict[str, int] = {}


def run_cell(args_common: dict, ref: str, file1: str, file2: Optional[str],
             outdir: str, prefix: str, no_extraction: bool = False) -> str:
    from ..cli.run import main as run_main

    os.makedirs(outdir, exist_ok=True)
    argv = ["-f", ref, "-o", prefix, "--od", outdir]
    if no_extraction:
        argv.append("--noExtraction")
    for k, v in args_common.items():
        argv.extend([k, str(v)] if v is not True else [k])
    if file2:
        argv.extend(["-1", file1, "-2", file2])
    else:
        argv.extend(["-u", file1])
    if run_main(argv) != 0:
        raise RuntimeError(f"cell {prefix} failed")
    return os.path.join(outdir, f"{prefix}_genotype.tsv")


def _launches() -> Dict[str, int]:
    from ..ops import align, align_band, em, phase_a

    return {k: v for counts in (align.launch_counts, align_band.launch_counts,
                                em.launch_counts, phase_a.launch_counts)
            for k, v in counts.items()}


def _run_cell_counted(*job):
    """run_cell in a pool worker: (genotype path, the launches of each
    kernel during the cell)."""
    before = _launches()
    path = run_cell(*job)
    return path, {k: v - before[k] for k, v in _launches().items()}


def _share_cores(workers: int) -> None:
    """A pool worker's torch threads: its share of the host's cores (each
    worker's torch would otherwise start a thread per core, and the
    workers' CPU tensor code would spin against each other)."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


def _run_cells(jobs: list, workers: int) -> List[str]:
    """Dispatch independent per-cell pipelines over a spawn pool (cell
    shards; results returned in cell order)."""
    if workers <= 1 or len(jobs) <= 1:
        return [run_cell(*job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    n = min(workers, len(jobs))
    with ctx.Pool(n, initializer=_share_cores, initargs=(n,)) as pool:
        done = pool.starmap(_run_cell_counted, jobs)
    for _, launches in done:
        for k, v in launches.items():
            worker_launch_counts[k] = worker_launch_counts.get(k, 0) + v
    return [path for path, _ in done]


def _run_cells_cohort(jobs: list, device="cuda", mesh=None) -> List[str]:
    """Second-pass cells with one batched EM (the reference's analog is an
    independent genotyper process per cell, t1k-smartseq.pl:160-184).
    Per-cell alignment and EC construction run in this process against a
    shared parsed reference and one DeferredDescService; every cell's EC
    problem then goes to em_quantify_batched on `device`, or dealt over
    the devices of `mesh`; selection and outputs finish per cell.  Each
    cell's options carry the run's --backend, --emBackend and `device`,
    as cli.run's do, and each cell's post analysis runs as cli.run's
    stage 2 runs it, so the pass writes the per-cell pass's files."""
    from ..cli.run import resolve_preset
    from ..core.analyzer import AnalyzerOptions, run_analyzer
    from ..core.pipeline import (GenotypeOptions, finish_genotyper,
                                 prepare_genotyper)
    from ..device import resolve_device
    from ..io.refset import RefSet
    from ..ops.align_band import DeferredDescService
    from ..ops.em import em_quantify_batched
    from ..utils.observability import metrics_run, reset_metrics

    refset = service = None
    preps, prefixes, analyses, cell_sets = [], [], [], []
    for t1k_args, ref, f1, f2, outdir, prefix, _no_extraction in jobs:
        preset = t1k_args.get("--preset", "")
        geno_sim, _, relax = resolve_preset(
            preset, float(t1k_args["-s"]) if "-s" in t1k_args else None,
            "--relaxIntronAlign" in t1k_args)
        if refset is None:
            refset = RefSet.from_fasta(ref)
        opts = GenotypeOptions(
            ref_seq_similarity=geno_sim, relax_intron_align=relax,
            threads=int(t1k_args.get("-t", 1)),
            backend=t1k_args.get("--backend", "auto"),
            em_backend=t1k_args.get("--emBackend", "auto"), device=device)
        if opts.backend == "gpu" and service is None:
            service = DeferredDescService(resolve_device(device))
        os.makedirs(outdir, exist_ok=True)
        with metrics_run() as cell_metrics:
            preps.append(prepare_genotyper(ref, [f1], [f2] if f2 else None,
                                           opts, refset=refset,
                                           desc_service=service))
        cell_sets.append(cell_metrics)
        prefixes.append(os.path.join(outdir, prefix))
        # cli.run gives the analyzer --relaxIntronAlign only through the
        # kir-wgs and kir-wes presets
        analyses.append((ref, f2 is not None, AnalyzerOptions(
            ref_seq_similarity=geno_sim,
            relax_intron_align=preset in ("kir-wgs", "kir-wes"),
            threads=opts.threads, backend=opts.backend,
            em_backend=opts.em_backend, device=device)))

    g0 = preps[0].genotyper
    results = em_quantify_batched(
        [p.genotyper.em_problem() for p in preps],
        g0.allele_eff_len, g0.allele_gene, g0.allele_major,
        g0.gene_cnt, g0.major_cnt,
        filter_frac=g0.cfg.filter_frac,
        min_squarem_alpha=g0.cfg.min_squarem_alpha, device=device,
        devices=mesh)

    out = []
    for prep, res, prefix, (ref, paired, aopts), cell_metrics in zip(
            preps, results, prefixes, analyses, cell_sets):
        # each cell's metrics files hold its own stage records
        reset_metrics(cell_metrics)
        finish_genotyper(prep, prefix, em_result=res)
        aligned = ([f"{prefix}_aligned_1.fa"], [f"{prefix}_aligned_2.fa"])
        run_analyzer(ref, f"{prefix}_allele.tsv",
                     aligned[0] if paired else [f"{prefix}_aligned.fa"],
                     aligned[1] if paired else None, prefix, aopts)
        out.append(f"{prefix}_genotype.tsv")
    return out


def run_smartseq(
    read1_list: str,
    read2_list: Optional[str],
    ref: str,
    output_prefix: str = "T1K",
    t1k_args: Optional[dict] = None,
    workers: int = 1,
    cohort_em: bool = False,
    device="cuda",
    mesh=None,
) -> str:
    """Returns the path of the final merged genotype matrix.  `t1k_args`
    are cli.run options for every cell (-t, --preset, -s, --backend,
    --emBackend); `device` is each cell's --device and the cohort EM's;
    `mesh`, a device list, shards the cohort EM's cells instead."""
    t1k_args = dict(t1k_args or {})
    # Resolve backend "auto" HERE, once, and ship the concrete choice to
    # the cell workers; an "auto" route on a CUDA device without a card
    # raises before any work, as cli.run does
    from ..core.genotyper import Genotyper
    from ..device import resolve_backend
    t1k_args["--backend"] = resolve_backend(
        t1k_args.get("--backend", "auto"), device)
    if t1k_args.get("--emBackend", "auto") == "auto":
        Genotyper._resolve_em_backend(0, 0, device)
    t1k_args["--device"] = str(device)
    with open(read1_list) as f:
        files1 = [line.strip() for line in f if line.strip()]
    files2: List[Optional[str]] = [None] * len(files1)
    if read2_list:
        with open(read2_list) as f:
            files2 = [line.strip() for line in f if line.strip()]

    cells = []
    jobs = []
    for f1, f2 in zip(files1, files2):
        cell = os.path.basename(f1).split(".")[0]
        outdir = f"{output_prefix}_{cell}"
        jobs.append((t1k_args, ref, f1, f2, outdir, cell))
        cells.append(cell)
    genotype_files = _run_cells(jobs, workers)
    with open(f"{output_prefix}_genotype_list.out", "w") as f:
        f.write("".join(p + "\n" for p in genotype_files))

    quality_filter = max(len(cells) * 2, 30)
    merged = f"{output_prefix}_merged_genotype.tsv"
    with open(merged, "w") as out:
        final_alleles = merge_genotypes(genotype_files, total_qual=quality_filter,
                                        out=out)

    # Reduced reference: any allele whose header matches a winning
    # major-allele name (substring match, as the reference driver does).
    reduced_ref = f"{output_prefix}_reduced_ref.fa"
    wanted = set(final_alleles.keys())
    if not wanted:
        raise RuntimeError("No qualified allele found.")
    with open(reduced_ref, "w") as out:
        for rec in read_seq_file(ref):
            header = rec.id + (" " + rec.comment if rec.comment else "")
            if any(w in header for w in wanted):
                out.write(f">{header}\n{rec.seq}\n")

    jobs = []
    for cell, f2 in zip(cells, files2):
        outdir = f"{output_prefix}_{cell}"
        if f2 is not None:
            c1 = os.path.join(outdir, f"{cell}_candidate_1.fq")
            c2 = os.path.join(outdir, f"{cell}_candidate_2.fq")
        else:
            c1 = os.path.join(outdir, f"{cell}_candidate.fq")
            c2 = None
        jobs.append((t1k_args, reduced_ref, c1, c2, outdir,
                     f"{cell}_reduced", True))
    reduced_files = (_run_cells_cohort(jobs, device, mesh) if cohort_em
                     else _run_cells(jobs, workers))
    with open(f"{output_prefix}_reduced_genotype_list.out", "w") as f:
        f.write("".join(p + "\n" for p in reduced_files))

    final = f"{output_prefix}_final_genotype.tsv"
    with open(final, "w") as out:
        merge_genotypes(reduced_files, total_qual=quality_filter, out=out)
    return final


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from ..device import NoCardError

    ap = argparse.ArgumentParser(description="T1K SMART-seq pipeline")
    ap.add_argument("-1", dest="list1", required=True)
    ap.add_argument("-2", dest="list2", default=None)
    ap.add_argument("-f", dest="ref", required=True)
    ap.add_argument("-o", dest="prefix", default="T1K")
    ap.add_argument("-t", dest="threads", type=int, default=1,
                    help="threads per cell pipeline")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells processed concurrently (process pool)")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--cohortEm", action="store_true",
                    help="second pass: every cell's EM in one batched "
                         "EM on --device (one kernel block per cell), its "
                         "cells dealt over every card when there are more")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="each cell's alignment and screen backend, as "
                         "cli.run takes it; auto is resolved once here")
    ap.add_argument("--emBackend", dest="emBackend", default="auto",
                    choices=["auto", "native", "gpu"],
                    help="each cell's EM, as cli.run takes it (the "
                         "--cohortEm pass runs the batched EM on --device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gpu routes (cuda, cuda:N, or "
                         "cpu for the kernels' plain versions)")
    args = ap.parse_args(argv)
    extra = {"--backend": args.backend, "--emBackend": args.emBackend}
    if args.preset:
        extra["--preset"] = args.preset
    if args.threads != 1:
        extra["-t"] = args.threads
    mesh = None
    if (args.cohortEm and torch.device(args.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        from ..parallel.mesh import data_mesh
        mesh = data_mesh()
    try:
        run_smartseq(args.list1, args.list2, args.ref, args.prefix, extra,
                     workers=args.workers, cohort_em=args.cohortEm,
                     device=args.device, mesh=mesh)
    except NoCardError as err:
        ap.error(str(err))
    return 0


if __name__ == "__main__":
    sys.exit(main())
