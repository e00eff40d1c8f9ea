#!/usr/bin/env python3
"""Some of chip_smoke.py's phases alone, on one CUDA card.

  python3 scripts/smoke_phases.py [v1] [main] [distributed] [db]
                                  [candidates] [em_timing] [composite]
                                  [kmer] [wgs] [smartseq]
                                  [cohort_em_timing] [sharded_em] [fuzz]

Builds the kernels (the smoke's `build` phase, with the compiler's
register and spill lines), then runs the named phases in the smoke's
order at its full sizes, each as chip_smoke.run runs it: distributed,
candidates and em_timing take main's panel, reads and outputs (em_timing
its EM problem) and run main first; kmer takes the run phase's reads, which it
writes as that phase does (without running the chains); cohort_em_timing
takes smartseq's problems and runs smartseq first; sharded_em takes both
and runs both (its multi-process ranks in child processes); fuzz runs
the fixed seeds of scripts/fuzz_torch.py (its HLA-scale driver cases on
the panel); without main, the HLA-scale panel is built on its own (v1,
db and wgs need none: db and wgs build their own databases with the
port's build).  Prints each phase's line, the card line, and as JSON the
v1 aligner's per-path launches and times, the distributed and db phases'
band and EM launches, the wgs chains' launches, the smartseq plate's
launches and the fuzz cases' launches.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASES = ("v1", "main", "distributed", "db", "candidates", "em_timing",
          "composite", "kmer", "wgs", "smartseq", "cohort_em_timing",
          "sharded_em", "fuzz")


def main(argv) -> int:
    import json

    import torch

    from t1k_tpu_torch.ops import _build

    wanted = set(argv) or set(PHASES)
    if not wanted <= set(PHASES):
        print(f"phases: {' '.join(PHASES)}", file=sys.stderr)
        return 2
    if wanted & {"distributed", "candidates", "em_timing"}:
        wanted.add("main")
    if "cohort_em_timing" in wanted:
        wanted.add("smartseq")
    if "sharded_em" in wanted:
        wanted |= {"main", "smartseq"}
    if not torch.cuda.is_available():
        print("smoke_phases: CUDA is not available", file=sys.stderr)
        return 2
    dev, sizes = torch.device("cuda"), cs.FULL_SIZES
    print(cs.card_line(), flush=True)
    with cs.phase("build") as info:
        t0 = time.perf_counter()
        _build.build_all(cs.SOURCES)
        info["all_s"] = f"{time.perf_counter() - t0:.2f}"
        for name in ("em_squarem", "align_full", "kmer_classify"):
            with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {name}:", line.strip(), flush=True)
    if "v1" in wanted:
        with cs.phase("v1") as info:
            *_, extras = cs.phase_v1(dev, cs.Checker(), sizes["v1_pairs"],
                                     info)
        print(json.dumps({"v1": extras}), flush=True)
    if not wanted - {"v1"}:
        print(cs.card_line())
        return 0
    with tempfile.TemporaryDirectory(prefix="t1k_phases_") as work:
        em_problems = []
        if "main" in wanted:
            with cs.phase("main") as info:
                cs.phase_main(dev, work, cs.PANEL_GENES, cs.PANEL_COPIES,
                              sizes["sim_pairs"], info, em_problems)
        elif wanted - {"v1", "db", "wgs"}:
            cs.build_panel(os.path.join(work, "panel.fa"))
        if "distributed" in wanted:
            with cs.phase("distributed") as info:
                launches = cs.phase_distributed(dev, work, info,
                                                sizes["mp"])
            print(json.dumps({"distributed_launches": launches}), flush=True)
        if "db" in wanted:
            with cs.phase("db") as info:
                launches = cs.phase_db(dev, work, sizes["db"], info)
            print(json.dumps({"db_launches": launches}), flush=True)
        if "candidates" in wanted:
            with cs.phase("candidates") as info:
                cand = cs.phase_candidates(dev, work, info)
            print(json.dumps({name: dict(
                extras, ms=timed[0], plain_ms=timed[1], bound_ms=timed[2][0],
                bound_by=timed[2][1], launches=launches)
                for name, (timed, launches, extras) in cand.items()}),
                flush=True)
        if "em_timing" in wanted:
            with cs.phase("em_timing") as info:
                cs.phase_em_timing(dev, em_problems[0], sizes, info)
        if "composite" in wanted:
            with cs.phase("composite") as info:
                cs.phase_composite(dev, info)
        if "kmer" in wanted:
            prefix = cs.extract_inputs(
                work, os.path.join(work, "panel.fa"), sizes["run"],
                tag="run", snp_genes=cs.SNP_GENES, barcodes=True)
            with cs.phase("kmer") as info:
                timed, launches, extras = cs.phase_kmer(
                    dev, cs.Checker(), work, prefix, sum(sizes["run"]), info)
            print(json.dumps({"kmer_classify": dict(
                extras, ms=timed[0], plain_ms=timed[1], bound_ms=timed[2][0],
                bound_by=timed[2][1], launches_kmer_phase=launches)}),
                flush=True)
        if "wgs" in wanted:
            with cs.phase("wgs") as info:
                launches = cs.phase_wgs(dev, work, info, sizes["wgs"])
            print(json.dumps({"wgs_launches": launches}), flush=True)
        if "smartseq" in wanted:
            with cs.phase("smartseq") as info:
                launches, plate_em = cs.phase_smartseq(dev, work, info,
                                                       sizes["plate"])
            print(json.dumps({"smartseq_launches": launches}), flush=True)
        if "cohort_em_timing" in wanted:
            with cs.phase("cohort_em_timing") as info:
                cs.phase_cohort_em_timing(dev, plate_em, sizes["cohort"],
                                          info)
        if "sharded_em" in wanted:
            with cs.phase("sharded_em") as info:
                timed, launches, extras = cs.phase_sharded_em(
                    dev, em_problems[0], plate_em, sizes, work, info)
            print(json.dumps({"em_sharded": dict(
                extras, ms=timed[0], plain_ms=timed[1], bound_ms=timed[2][0],
                bound_by=timed[2][1], launches=launches)}), flush=True)
        if "fuzz" in wanted:
            with cs.phase("fuzz") as info:
                launches = cs.phase_fuzz(dev, work, info)
            print(json.dumps({"fuzz_launches": launches}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
