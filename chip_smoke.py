#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (t1k_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Every baseline is the port's own native route (--backend native
--emBackend native or T1K_BACKEND=native: the host engine of
t1k_tpu_torch/native/), each in a child process that reports its
start-up (to its imports' end) and whether it made a CUDA context.
Nothing here runs the JAX package: the CPU tests hold the port's native
route against it (tests/test_torch_native_route.py and the others).

Phases, in order; any failure raises and the exit code is non-zero:
  1. card          nvidia-smi name and power limit, torch and CUDA versions
  2. build         nvcc builds the seven sources of csrc/ for sm_90a, one
                   process per source, all at once, and loads them
  3. kernel        the band kernels vs their plain PyTorch version on the
                   card, exact: the thread kernels (windows of at most 32
                   cells), and the first design's warp kernel and the
                   lane-group kernel at every CPL, sorted and not, forced
                   at the same window, on the 400 golden alignment cases,
                   100,000 seeded deferred items and the edge items (every
                   t_len - p_len in [-10, 10] against p_len 1-254, t_len
                   0, N bases) through the descriptor service (W=32,
                   rc-half descriptors included); the route at W = 64,
                   128, 256 (the lane-group kernel, and no other launch)
                   and the group kernel at every CPL that holds the batch
                   and the warp kernel, on 4,096-pair wide batches and the
                   dry run's 1,024-, 512- and 256-pair shard slices; the
                   golden batch timed, and the wide and dry-run batches
                   through the route in turns with the warp kernel
  4. em            f64 SQUAREM EM kernel on a seeded 5,000 read group x
                   900 EC problem (the microcell): the native f64 loop's
                   iteration count and counts, bit for bit, and equal to
                   the plain version on the CPU
  5. v1            the v1 full-row aligner (align_full.cu: thread, tile
                   and ring paths behind a counting sort) through
                   banded_scores_full: the 400 golden cases, 65,536
                   seeded read/window pairs and 512 seeded pairs with
                   ring-path pairs among them (launch counts per path set
                   to 0 before these two batches, each path must
                   launch), exact against its plain version and, where
                   the band fits, the band kernel; the first port's ring
                   kernel alone on every pair checked too; the launch,
                   that ring kernel, the narrow (thread-path) and wide
                   (tile-path) pairs alone and the plain version timed in
                   turns
  6. screen        the phase-A DeviceScreen on the card against its plain
                   version on the CPU (verdict and decided) and the native
                   engine (every decided read) on seeded panels: random
                   panels, the skip heuristic, tandem repeats, the k=13
                   hashed table, edge cases, overflow; then the probe and
                   chain kernels at their edges, exact against their
                   plain versions: reads of 13, 44, 45, 76, 100, 150 and
                   4095 bases for k = 12 (direct) and k = 13 (hashed), and
                   seed rows of 0, 1, 31, 32, 33, 63, 64, 65, 128 and 512
                   seeds, one kind on a single diagonal
  7. main          the genotyper stage at HLA scale (24 genes x 240
                   alleles, 12,000 read pairs of 100 bp) through
                   t1k_tpu_torch.cli.genotype --backend gpu --emBackend
                   gpu, byte-compared with the port's own native route
                   (--backend native --emBackend native, the host engine,
                   in a child process, which also writes the read
                   assignment the candidates phase holds the pruned
                   genotyper against); both kernels' launch counts over
                   the run must be > 0; the EM problem its genotyper
                   solves is kept
  8. distributed   the host-sharded genotyper on main's panel and reads:
                   t1k_tpu_torch.parallel.distributed's
                   run_genotyper_distributed at 3 shards (an engine a
                   shard, one band-kernel service for all), --backend
                   gpu --emBackend gpu, in this process (launch counts
                   set to 0 before and read after): exactly the four
                   genotyper files, each equal to main's port and native
                   outputs; each shard's fragments, deferred items, band
                   launches and host seconds; the band kernel and the
                   EM kernel must launch.  Then t1k_tpu_torch.cli.run on
                   the first 1,000 of those pairs (cut from 12,000 for
                   the time limit) as one process and as two processes
                   under T1K_NUM_PROCESSES=2 on the one card, each a
                   child process with its launch counts printed: every
                   output equal, both processes launching the band
                   kernel; each route's wall
  9. db            the port's database build into its genotyper: an
                   IPD-shaped .dat (tests/test_db_scale.py's generator,
                   copied: 24 genes x 125 records, ~8.9 MB, exon-only and
                   block-dropped partials, duplicates) and a GTF that puts
                   the 24 genes on chr6, through python -m
                   t1k_tpu_torch.db.build -d -g (rna, dna and both
                   coordinate fastas; each coordinate header checked),
                   then 4,000 pairs simulated from two alleles of every
                   gene of the built rna fasta through
                   t1k_tpu_torch.cli.genotype --backend gpu --emBackend
                   gpu and --backend native --emBackend native (both
                   --outputReadAssignment), each in a child process
                   (launch counts set to 0 before and printed after);
                   every output byte-identical, the band and EM kernels
                   launched by the first and not by the second; build
                   seconds, each route's wall (split at its first and
                   last stage lines) and stages
 10. candidates    DeviceCandidates (K10: probe, census kernel, bucket
                   chain) on the card against its plain version on the
                   CPU, array for array, and every decided read's keep set
                   against the native engine's overlap buckets: seeded
                   panels (random panels, 40 alleles 1% apart at k = 11,
                   the same in chunks of 7 reads, a tiny hit cap and a
                   tiny bucket cap), then main's unique reads with the
                   pipeline's caps (the plain version on the first 16),
                   each chunk's hit total, buckets, decided reads and
                   kept buckets printed, 95% of the reads decided or it
                   fails; generate (one host wait a chunk and two at the
                   end, or it fails) and set_candidates timed;
                   t1k_tpu_torch.cli.genotype
                   --backend gpu --emBackend gpu --outputReadAssignment
                   --deviceCandidates in a child process (cut from four
                   runs in turns, then from a run without and one with
                   the flag, for the time limit; launch counts set to 0
                   before it and printed after it): every output, the
                   _assign.tsv included, equal to main's native route's,
                   probe, census, bucket chain, band and EM
                   kernels launched and the dense chain not, the card
                   deciding reads; its read_assignment seconds beside
                   main's unpruned card route's (in process); on
                   main's chunk with the most hits, the census kernel (at
                   its default keys a pass and at FORCED_BINS) and the
                   bucket chain against their plain versions on the
                   card's tensors (buckets exactly, each bucket's seeds as
                   a multiset; keep and over-counts exactly), the chunk's
                   kept keys against the tile route's, the chunk run
                   with implicit syncs raising; the census, the forced
                   census, the census of the chunk's largest read alone,
                   the chain, the keep set, the chunk and the tile route
                   timed, the plain census and chain once
 11. em_timing     the EM kernel on that HLA problem, the microcell and a
                   seeded problem with ~10x its incidences (the
                   device-memory instantiation): kernel alone (tables on
                   the card), the em_quantify_gpu wrapper and the native
                   loop in turns, each bit-identical to the native loop;
                   the measured f64 add latency and divide-term rate, the
                   add-chain bound, and the profiled instantiation's
                   per-phase cycle shares; the plain version on the HLA
                   problem; the segment EM (K7, em_quantify_segment,
                   tensor code) on the same three problems, its rounds
                   and largest difference from the native loop printed,
                   its loop in turns with K5
 12. composite     parallel/dryrun.py's entry() (the single-device
                   composite of __graft_entry__.entry(): band kernel,
                   FragWeight, one round of the dense int8 EM in float32)
                   on the card against its CPU run: match equal, x2 within
                   rtol 1e-4, atol 1e-8; its band launches the lane-group
                   kernel's alone; timed
 13. timing        thread kernels, warp kernel, the lane-group kernel
                   forced at W = 32 and plain version, in turns, on the
                   largest deferred-item batch one engine chunk of the
                   main path sends, with the chunk's shape (p_len and
                   |t_len - p_len| quantiles, row use of the sorted launch,
                   slot counts of its warps) and how the narrow and wide
                   thread kernels overlapped on their two streams
 14. extract       the FASTQ extraction stage on the same panel (k = 13,
                   hashed table): 25,000 read pairs of 2 x 100 bp
                   (500 simulated on-panel pairs, 2,000 near-miss
                   pairs, 22,500 random pairs, shuffled; cut from 200,000
                   to keep the smoke inside its time limit) through
                   t1k_tpu_torch.cli.extract --backend gpu in this process
                   (its stage time is a warm one), byte-compared with
                   the same CLI's --backend native run in a child
                   process; both phase-A kernels must launch and the
                   device must decide a share of the screened reads
 15. screen_timing probe and chain kernels vs their plain versions, in
                   turns, on one full 1024-row chunk of the extract inputs
 16. run           the run-t1k chain (extract -> genotype -> analyze) on
                   the same panel: 12,500 read pairs built as extract's
                   (1,250 simulated, 3,750 near-miss, 7,500 random),
                   the simulated pairs of two genes drawn from copies of
                   an allele with three seeded substitutions, and a cell
                   barcode per pair: t1k_tpu_torch.cli.run --backend
                   native --emBackend native, then --backend gpu
                   --emBackend gpu, each in a child process
                   of its own (the gpu route's with its kernels' launch
                   counts set to 0 before the run and printed after it;
                   each child's start-up apart); every
                   output byte-compared (candidate reads, genotype,
                   alleles, aligned reads, VCF with at least one record,
                   barcode matrix); both phase-A kernels, the EM kernel
                   and the band kernel in the genotyper's and in the
                   analyzer's read assignment must launch; each route's
                   process wall and stage seconds (between the lines of
                   its log that open and close each stage) are printed
 17. kmer          K11 (ops/kmer.py, csrc/kmer_classify.cu): the table of
                   the panel at k = 11, 12, 13 (pair tables), 14 (the
                   centre-canonical table) and 15, 16 (hashed), build
                   seconds printed, and the kernel and its first design
                   exact against classify_plain on the card's tensors on
                   the run phase's 12,500 mate-1 reads and on edge reads
                   (lengths 0, k - 1, k, k + 1, N at the first, a middle
                   and the last base, a reverse complement, all-T, all-A);
                   a batch narrower than k gives zeros; at the extractor's
                   k the kernel, the first design and the screen's probe
                   kernel on those reads in turns (kmer, v1, probe, probe,
                   v1, kmer), each design's time after 64 MB written (cold),
                   the pair table's bytes, the table words a launch of
                   each design reads (counted from the keys, not a
                   hardware counter), reads/s, and the bound (bytes and
                   gathers)
 18. bam_run       the run-t1k chain on a BAM (-b, with -c the coordinate
                   fasta: every panel allele on its gene's interval of
                   chr6): 16,875 pairs of 2 x 100 bp (BAM_PAIRS:
                   2,500 on-panel pairs in their gene's interval, 250
                   on an alt contig, 8,750 unaligned templates, 1,250
                   pairs within 5 kb of an interval, the rest off target
                   on chr1; cut from 50,000 for the time limit), CB and
                   UB tags on every record, written by a
                   packer that writes BamWriter's bytes (held against it
                   on 1,000 aligned and 1,000 unaligned records):
                   t1k_tpu_torch.cli.run -b --backend native --emBackend
                   native with T1K_BACKEND=native, then --backend gpu
                   --emBackend gpu, as the run phase runs them; every
                   output byte-compared
                   (the UMI file too), VCF records >= 1, the same kernels
                   launched, the device deciding reads; extraction timed
                   from the child's start to the genotyper's first line;
                   then the port's extraction alone in this process, its
                   screen on the host engine, then on the card, each run
                   timed and its outputs equal to the chain's
 19. run_profile   the port's analyzer alone on the run's genotyper
                   outputs under torch.profiler: the same VCF, and the
                   card's busy and idle share of each analyzer stage; its
                   largest batch of deferred items is kept
 20. analyzer_timing  the thread band kernels vs their plain version on
                   that batch, exact and in turns, with its shape and
                   the two streams' overlap
 21. wgs           the run-t1k chain on WGS/WES configurations: a .dat of
                   KIR's shape (make_ipd_dat at 40 genes x 120 records,
                   9 exons of 36-300 bp, introns of 300-3,000 bp, the
                   generator's partials and duplicates; 16 genes came to
                   7.4 Mbp and k = 13, as the build keeps 200 bp of each
                   intron's ends) through python -m
                   t1k_tpu_torch.db.build into its dna fasta (17.7 Mbp,
                   3,694 alleles: the extractor's k = 14, checked); 30,000
                   read pairs of 2 x 100 bp (10,000 simulated by the
                   port's simulator from 1-2 alleles of each of 16 genes
                   at error rate 0.004, so they cross exon-intron
                   junctions, 5,000 near-miss, 15,000 random; cut from
                   50,000 for the time limit); one child
                   of the port's native route (--backend native
                   --emBackend native) and one of its card route
                   (--backend gpu --emBackend gpu), each running
                   t1k_tpu_torch.cli.run three times: --preset kir-wgs
                   -t 8 on -1/-2, --preset hla-wgs -t 8 on -u (mate 1),
                   --preset kir-wes -t 1 on -i (the first 6,000 pairs
                   interleaved), the card's kir-wes run under
                   torch.profiler; every output of each configuration
                   byte-compared between the routes; in each card run the
                   band kernel in the genotyper and the analyzer, both
                   phase-A kernels and the EM kernel must launch, in the
                   native child nothing, and it makes no CUDA context;
                   each run's stage seconds, deferred items and launches,
                   the reference's size and k, and the card's busy share
                   of the profiled run's two read assignments
 22. smartseq      one SMART-seq2 plate of one donor: 4 cells of 4,000
                   pairs of 2 x 100 bp (800 simulated from the donor's
                   two alleles of 6 of 8 panel genes, drawn per cell, at
                   a ratio drawn from [0.1, 0.9]; 800 near-miss and 2,400
                   random pairs): t1k_tpu_torch.tools.smartseq
                   --workers 8 with T1K_BACKEND=native (the host engine,
                   per-cell native EM), then --workers 8 --cohortEm
                   on the card, each in a child process and a work
                   directory of its own (the card route's with its
                   kernels' launch counts, its pool workers' included, set to 0
                   before the run and printed after it); the plate
                   files, each cell's first-pass outputs and each cell's
                   second-pass outputs byte-compared; probe,
                   chain, band and the batched EM must launch; each
                   route's wall, start-up and pass walls, and a spawn
                   pool's start-up
 23. cohort_em_timing  the EM kernel's cohort form alone on (a) the
                   problems the port's second pass solved and (b) 384
                   cells of benchmarks/cohort_em.py's default shape: the
                   batched launches at the cells' widths, the same cells
                   forced to 1,024 threads, one single-problem launch per
                   cell, the per-cell native loop and the plain version,
                   in turns, then every cell forced to each width from 32
                   to 1,024 in turns, every cell bit for bit against the
                   native loop; per launch its kernel's registers, local
                   bytes, resident blocks an SM and waves (local bytes in
                   a launch at the cells' widths fail)
 24. sharded_em    the sharded EM (t1k_tpu_torch/parallel/mesh.py and
                   multihost.py; the sharded form of em_squarem.cu) on
                   one card: em_quantify_sharded_squarem over [card] x n,
                   n = 1, 2, 4, on the main phase's HLA problem and the
                   ~2M-incidence problem (launch counts set to 0 before
                   and read after these six solves), each the native
                   loop's iterations and bits, the one-launch dispatch at
                   n = 1 equal, and on the HLA problem the CPU's plain
                   version equal at n = 2 and 4; the plate's and the 384
                   cohort cells' batched EM with their cells dealt over
                   [card] x 2 and x 4, each cell the native bits;
                   em_quantify_sharded on parallel/scaling_bench.py's
                   problem (200,000 x 4,096, 1.6M entries) at n = 1, 2, 4,
                   equal; em_quantify_multihost's ranks in child
                   processes (two under Gloo sharing the card, one alone
                   under NCCL), equal to the in-process runs; then the
                   solves in turns with the single-problem kernel (alone
                   and through em_quantify_gpu) and the native loop, at
                   one shard the loop in turns with the first design's
                   fused column pass, one update's row passes, column
                   chain and tail alone; at one shard the E-step and the
                   column pass in turns with the fused pass (fused,
                   split, split, fused), the term pass and the fold
                   alone, the kernels bit for bit against the plain split
                   on the card, the independent plain column pass and
                   the fused pass; on the HLA problem torch.sparse;
                   then parallel/dryrun.py's dryrun_multichip (the band
                   kernel and FragWeight on a 1,024-pair batch, the sharded
                   SQUAREM in f32 and f64 against the native loop) and
                   parallel/scaling_bench.py's two loops (the sharded plain
                   EM on its 200,000 x 4,096 problem, the dry run four
                   times) over [card] x 1, 2, 4, their launch counts set
                   to 0 before and read after, their times printed
 25. fuzz          the differential fuzz layer (scripts/fuzz_torch.py,
                   the cases of scripts/fuzz_cases.py, copies of the JAX
                   package's tests/fuzz_*.py generators) on fixed seeds:
                   16 driver, 16 genotyper, 8 analyzer, 8 extractor and 8
                   BAM cases, a SMART-seq plate and 2 driver cases on the
                   HLA-scale panel at 2,000 pairs, every case generated,
                   then all run in one child on the card route (--backend
                   gpu --emBackend gpu --device cuda, a quarter on the
                   defaults, the plate with --cohortEm) and one on the
                   native route (under T1K_BACKEND=native), side by side,
                   each case through its module's main; every output of
                   every run byte-compared (_assign.tsv as sorted lines,
                   provenance files left out), a run failing on one
                   route only fails; the card child's launches of probe,
                   chain, band and EM, K10 in the --deviceCandidates cases
                   and the cohort EM in the plate must be > 0, the native
                   child launches nothing and makes no CUDA context;
                   each fuzzer's ok/both_failed/fail counts and seconds
Then the card line, one JSON line describing the kernels (times; launches
over the run phase's chain, the v1 aligner's over its own phase's seeded
and ring batches (its three paths summed, and per path in
launches_by_path, beside the ring kernel's, the narrow and the wide
pairs' times and bounds), the
batched EM's over the smartseq phase's port run, launches_bam_run over
the bam_run phase's chain, launches_wgs over the wgs phase's three card
runs (the band kernel's genotyper and analyzer launches apart, probe,
chain and EM; null for the others), launches_smartseq over the
plate and launches_fuzz over the fuzz phase's card child (null for the
band kernel's analyzer entry, the v1 aligner and the sharded EM); the
band kernel's thread kernels as two entries, band_stats timed on the
genotyper's chunk with the genotyper's launches and band_stats_analyzer
on the analyzer's batch with the analyzer's; band_stats_group, the
lane-group kernel (W > 32), timed on the dry run's 1,024-pair slice with
the run chain's launches (0), launches_dryrun and launches_composite,
the warp kernel's time on that slice, each kernel-phase batch's times
and CPL, and its time on the genotyper's chunk forced at W = 32; the
first design's warp kernel as band_stats_warp, timed on that chunk; the
bound each could reach on the card and what sets it - for the EM the
longer of its bytes/operations bound and the chain of dependent f64 adds
em.cc's order forces, at the add latency the card measured, and for its
cohort form also the cells' chains over the SMs' resident warps, a warp
a chain; the batched EM timed on set (b), with set (b) forced to 1,024
threads, with its lists left in device memory and forced to each width,
and set (a)'s times and bound; em_sharded, the sharded form's E-step on
the HLA problem at one shard (row pass, term pass, fold), with its
launches over the sharded_em phase's six solves (each kernel's and the
tail's beside them), the fused column pass's times from the same call,
the tail's bound (its ec_cnt-long fold at the add latency), the 2M
problem's under `large`, and its library_ms two torch.sparse CSR
products; cand_census and device_candidates, K10's census kernel
and bucket chain on the genotyper cell's chunk with the most hits (their
launches in the pruned genotyper run, their bounds the work: the
postings read and the seeds and buckets written; the chained seeds in
and the keep set out) with the forced and largest-read census times,
the chunk's, the keep set's and the tile route's, generate's and
set_candidates' seconds, host waits a chunk, the decided share and each
run's read_assignment seconds; launches_db on band_stats and
em_squarem, their launches in the db phase's card route, and
launches_distributed, in the in-process sharded genotyper; launches_dryrun
on band_stats_group, band_stats_warp (0) and
em_sharded over the dry runs; kmer_classify, K11 at the extractor's k
on the run phase's reads, its launches the run chain's (no stage calls
it: 0) beside launches_kmer_phase, replaces_direct, the bitmap program
it also replaces, the first design's v1_ms, v1_launches_kmer_phase and
v1_cold_ms, cold_ms and pair_table_bytes;
no single PyTorch call computes the
others, so their library_ms is null), and
{"ok": true, "device": {...}} as the last line.  Work files go to a
temporary directory that is removed at exit.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(ROOT, "tests", "golden")

PANEL_GENES = 24
PANEL_COPIES = 2          # x 120 source alleles = 240 alleles per gene
SIM_PAIRS = 12000
EM_RG, EM_EC = 5000, 900
EM_LARGE = (54_210, 10_700)   # about 10x the HLA problem's incidences
RANDOM_ITEMS = 100_000
V1_PAIRS = 65_536
# the run phase's depth (cut from 500,000 pairs to keep the smoke well
# inside its time limit as phases are added, then from 250,000, random
# pairs only, when the native baselines became the port's, whose child
# processes each import torch: 967.7-1,113.2 s of phases on H100 80GB
# HBM3 at 700 W, one host 1.35 times slower than another; then to
# 50,000, every share, for the wgs phase: 941.7 s of phases with it at
# 150,000; then to 12,500, every share, for the fuzz phase: 981.26-1,002.52
# s of phases with it at 50,000 and 900.53 s at 25,000, on hosts 1.1-1.2
# times slower than the 834.73 s one)
EXTRACT_PAIRS = (1_250, 3_750, 7_500)     # simulated, near-miss, random
# the extract phase's depth: the run phase extracts EXTRACT_PAIRS (cut
# from 100,000 pairs for the same reason)
EXTRACT_SMOKE_PAIRS = (500, 2_000, 22_500)
SNP_GENES = 2                    # genes whose reads carry seeded SNPs
SNP_POSITIONS = (300, 700, 1100)  # 0-based, in each such allele's copy
READ_LEN = 100

_LUT = np.full(256, 4, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[ord(chr(_b).lower())] = _i


def encode(seq: str) -> np.ndarray:
    return _LUT[np.frombuffer(seq.encode("ascii"), np.uint8)]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    info = {}
    yield info
    extras = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase {name}] ok {time.perf_counter() - t0:.2f}s {extras}",
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def read_fasta(path: str):
    recs, name, comment, seq = [], None, "", []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    recs.append((name, comment, "".join(seq)))
                head = line[1:].split(" ", 1)
                name, comment = head[0], head[1] if len(head) > 1 else ""
                seq = []
            else:
                seq.append(line)
    if name is not None:
        recs.append((name, comment, "".join(seq)))
    return recs


def build_panel(path: str, n_genes: int = PANEL_GENES,
                copies: int = PANEL_COPIES) -> None:
    """HLA-scale panel from the committed 3-gene panel: each gene gets its
    own seeded substitution set (the recipe of benchmarks/hla_scale.py),
    every source allele enters it `copies` times (later copies carry three
    extra seeded substitutions), and names stay unique within a gene."""
    src = read_fasta(os.path.join(DATA, "multigene_rna.fa"))
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for gi in range(n_genes):
            gene = f"GEN{chr(65 + gi // 26)}{chr(65 + gi % 26)}"
            n_mut = 40 * (gi % 6) + 25 * (gi // 6)
            pos = rng.integers(0, 1200, size=n_mut)
            sub = rng.integers(1, 4, size=n_mut)
            for c in range(copies):
                for si, (name, comment, seq) in enumerate(src):
                    s = list(seq)
                    extra = rng.integers(0, len(s), size=3 * (c > 0))
                    for p, d in list(zip(pos, sub)) + [(p, 1) for p in extra]:
                        if p < len(s) and s[p] in "ACGT":
                            s[p] = "ACGT"[("ACGT".index(s[p]) + d) % 4]
                    v = (si // 40) * copies + c + 1
                    allele = name.split("*")[1]
                    f.write(f">{gene}*{v}{allele} {comment}\n{''.join(s)}\n")


def simulate_reads(panel: str, prefix: str, n_pairs: int = SIM_PAIRS,
                   n_genes: int = 8, snp_genes: int = 0) -> None:
    """Two alleles from each of `n_genes` genes, fixed seeds, through the
    port's simulator's command line.  With `snp_genes`, the first chosen
    allele of that many genes is replaced by a copy carrying substitutions
    at SNP_POSITIONS (not in the panel), so the analyzer calls variants."""
    recs = read_fasta(panel)
    names = [r[0] for r in recs]
    rng = np.random.default_rng(13)
    chosen, abund = [], []
    for g in sorted({n.split("*")[0] for n in names})[:n_genes]:
        alleles = sorted(n for n in names if n.startswith(g + "*"))
        for j, p in enumerate(rng.choice(len(alleles), 2, replace=False)):
            chosen.append(alleles[p])
            abund.append(1.0 - 0.3 * j)
    source = panel
    if snp_genes:
        source = prefix + "_donor.fa"
        by_name = {name: (comment, seq) for name, comment, seq in recs}
        with open(source, "w") as f:
            for i, name in enumerate(chosen):
                comment, seq = by_name[name]
                if i % 2 == 0 and i // 2 < snp_genes:
                    s = list(seq)
                    for p in SNP_POSITIONS:
                        s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
                    seq, name = "".join(s), name + "snp"
                    chosen[i] = name
                f.write(f">{name} {comment}\n{seq}\n")
    subprocess.run(
        [sys.executable, "-m", "t1k_tpu_torch.tools.simulate", "-f",
         source, "-o", prefix, "-n", str(n_pairs), "--seed", "3", "--alleles",
         *chosen, "--abundances", *map(str, abund)],
        check=True, cwd=ROOT, env=child_env())


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def golden_windows():
    cases = []
    with open(os.path.join(GOLDEN, "align_global.tsv")) as f:
        for line in f:
            _, _, t, p, score, _ = line.rstrip("\n").split("\t")
            cases.append(("" if t == "-" else t, "" if p == "-" else p,
                          int(score)))
    n = len(cases)
    tc = np.zeros((n, max(len(c[0]) for c in cases) + 1), np.int8)
    pc = np.zeros((n, max(len(c[1]) for c in cases) + 1), np.int8)
    for i, (t, p, _) in enumerate(cases):
        tc[i, :len(t)] = encode(t)
        pc[i, :len(p)] = encode(p)
    tl = np.array([len(c[0]) for c in cases], np.int32)
    pl = np.array([len(c[1]) for c in cases], np.int32)
    return tc, tl, pc, pl, np.array([c[2] for c in cases], np.int32)


def random_items(n: int, rng, max_diff: int = 10):
    """Reference, reads and descriptors of `n` deferred-like items: text
    windows of a random reference, patterns that are mutated copies with
    |t_len - p_len| <= max_diff, half of them addressed through the rc
    half of the doubled read tensor."""
    t_len = rng.integers(1, 255, n)
    p_len = np.clip(t_len + rng.integers(-max_diff, max_diff + 1, n), 1, 254)
    return deferred_items(rng, t_len, p_len)


EDGE_P_LENS = (1, 2, 15, 16, 17, 31, 32, 33, 60, 96, 254)


def edge_items(rng, copies: int = 4):
    """Deferred items at the thread kernel's edges, `copies` of each
    shape: every t_len - p_len in [-10, 10] against each of EDGE_P_LENS
    where 0 <= t_len <= 254 (the engine's caps; t_len 0 included), with
    3% N in the text and patterns mutated 5% towards any code, N
    included."""
    shapes = [(p + d, p) for d in range(-10, 11) for p in EDGE_P_LENS
              if 0 <= p + d <= 254]
    t_len, p_len = (np.repeat(np.array(v, np.int64), copies)
                    for v in zip(*shapes))
    return deferred_items(rng, t_len, p_len, n_rate=0.03)


def deferred_items(rng, t_len, p_len, n_rate: float = 0.002):
    """The items of random_items and edge_items for given lengths."""
    n = len(t_len)
    ref = rng.integers(0, 4, 4_000_000).astype(np.int8)
    ref[rng.random(ref.size) < n_rate] = 4
    t_off = rng.integers(0, ref.size - 300, n)
    rc = rng.random(n) < 0.5
    reads = []
    for i in range(n):
        p = ref[t_off[i]:t_off[i] + p_len[i]].copy()
        mut = rng.random(p_len[i]) < 0.05
        p[mut] = rng.integers(0, 5, int(mut.sum()))
        # an rc item stores the reverse complement, so the rc half of the
        # doubled tensor holds the pattern itself
        reads.append(np.where(p < 4, 3 - p, p)[::-1] if rc[i] else p)
    lens = p_len.astype(np.int32)
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    return ref, np.concatenate(reads).astype(np.int8), starts, lens, \
        t_off, t_len, rc


def time_ms(fn, reps: int, dev) -> float:
    """Mean milliseconds of `fn` over `reps` calls: CUDA events on a card,
    the host clock on the CPU (rehearsals only).  On the card a spin
    kernel (about 25 ms) runs first, so the host has queued the calls
    before the start event is passed and the time is the card's, not the
    host's launch rate, wherever `fn` does not wait on the card."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Peak rates of one H100 SXM (NVIDIA's data sheet) for the bounds: HBM3
# bytes/s, f64 outside the tensor cores, and int32 issue as 132 SMs x 64
# INT32 lanes x the SM clock (read from the card, 1980 MHz on the CPU);
# the resident warps an SM holds.
HBM_BYTES_PER_S = 3.35e12
F64_PER_S = 34e12
WARPS_PER_SM = 64
# int32 operations per DP cell counted for the aligners' bounds, in the
# instructions this card needs.  Scores alone: E an add and a DPX add-max
# (__viaddmax_s32, one instruction on Hopper), H a DPX add-max of the
# diagonal and the substitution, the substitution one, F a DPX add-max of
# the running max of H, and that running max one
DP_OPS_PER_CELL = 6
# With the traceback counts (band_stats.cu, band_item's STATS block) the
# tests compare the terms E, F and H take the max of, so the DP keeps its
# adds apart: two adds and a max for each of E and F, an add and two
# maxes for H, the substitution compare-select = 12.  Then 16 more per
# band cell away from column 0 (the column-0 and j >= 1 tests touch at
# most two cells a row): the insert-run open test (compare) and its count
# (select, add) = 3; the diagonal test (compare) and its count (select
# MU/XU, add) and the count without the horizontal move (select) = 4; the
# delete-run open test (compare) and the copy scan's two selects = 3; the
# run length (subtract, shift, add) = 3; the choice (compare, two
# selects) = 3
DP_STATS_OPS_PER_CELL = 12 + 16


def int32_per_s() -> float:
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], check=True,
            capture_output=True, text=True).stdout.split()[0])
    except (OSError, subprocess.CalledProcessError, IndexError, ValueError):
        mhz = 1980.0
    return 132 * 64 * mhz * 1e6


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dp_bound(t_lens, p_lens, other_bytes: float, stats: bool = True):
    """Bound of a banded aligner over pairs: each pair's text and pattern
    read once plus `other_bytes`, DP_STATS_OPS_PER_CELL (DP_OPS_PER_CELL
    for scores alone) per band cell (the band is 11 + |t_len - p_len|
    wide)."""
    tl = np.asarray(t_lens, np.int64)
    pl = np.asarray(p_lens, np.int64)
    cells = int((pl * (11 + np.abs(tl - pl))).sum())
    ops = DP_STATS_OPS_PER_CELL if stats else DP_OPS_PER_CELL
    return bound(int((tl + pl).sum()) + other_bytes, ops * cells,
                 int32_per_s())


class Checker:
    """Holds kernel outputs against the plain version's, exactly."""

    def __init__(self):
        self.max_err = 0

    def __call__(self, kernel_out, plain_out, what: str) -> None:
        err = int((kernel_out.long() - plain_out.long()).abs().max()) \
            if kernel_out.numel() else 0
        self.max_err = max(self.max_err, err)
        if err != 0:
            raise AssertionError(f"{what}: kernel differs from plain by {err}")


def wide_windows(rng, w: int, n: int = 4096):
    """`n` byte-window pairs for a window of `w` cells at ML = 5: t_len
    40-199, p_len shorter by 0 to (w - 32) / 2 (at least 1), the pattern
    the text with 5% of its codes set to 1."""
    over = (w - 32) // 2
    t_len = rng.integers(40, 200, n)
    p_len = np.clip(t_len - rng.integers(0, over + 1, n), 1, None)
    tcw = rng.integers(0, 5, (n, 200)).astype(np.int8)
    pcw = tcw.copy()
    pcw[rng.random(pcw.shape) < 0.05] = 1
    return tcw, t_len, pcw, p_len


def warp_kernel(dev):
    """The warp kernel forced at any window (the plain version on the
    CPU, for rehearsals)."""
    from t1k_tpu_torch.ops import align_band as ab

    return ab._band_stats_warp_cuda if dev.type == "cuda" \
        else ab.band_stats_plain


def group_kernel(dev, **shape):
    """The lane-group kernel forced at any window, `shape` its
    _band_stats_group_cuda arguments (the plain version on the CPU, for
    rehearsals)."""
    from t1k_tpu_torch.ops import align_band as ab

    if dev.type != "cuda":
        return ab.band_stats_plain
    return lambda *args: ab._band_stats_group_cuda(*args, **shape)


def group_shapes(max_slots: int):
    """Every (CPL, sort) the lane-group kernel can take for a batch of at
    most max_slots slots: each CPL whose 32-lane groups hold it, items
    sorted by class and length or all at the widest class."""
    from t1k_tpu_torch.ops import align_band as ab

    return [dict(max_slots=max_slots, cpl=c, sort=s) for c in ab.GROUP_CPL
            if 32 * c >= max_slots for s in (False, True)]


def check_group_shapes(dev, check_group: Checker, args, want, what: str,
                       max_slots: int) -> None:
    """The lane-group kernel at every shape of group_shapes against the
    plain version's `want`."""
    for shape in group_shapes(max_slots):
        check_group(group_kernel(dev, **shape)(*args), want,
                    f"{what} (group cpl={shape['cpl']} sort={shape['sort']})")


def phase_kernel(dev, check: Checker, check_warp: Checker,
                 check_group: Checker, n_random: int, info: dict) -> tuple:
    """The band kernels against the plain version, exactly: the thread
    kernels (the route at W <= 32), and the first design's warp kernel and
    the lane-group kernel at every CPL (sorted and not) forced at the same
    window, on the golden batch, the seeded random items and the edge
    items; the route at W = 64, 128 and 256 (the lane-group kernel,
    counted as band_stats_group and no other) and the group kernel at
    every CPL that holds the batch, and the warp kernel, on the wide
    batches (4,096 pairs, ML = 5, diff 0 to (W - 32) / 2) and the dry
    run's shard slices (1,024, 512 and 256 pairs of 112 / 100 at ML = 10,
    W = 64).  Times the golden batch (scores and stats, thread kernels)
    beside the plain version, and the wide batches and the dry-run slices
    through the route in turns with the warp kernel (route, warp, warp,
    route).  Returns ({case: (ms, plain ms, bound)} of the golden batch,
    {case: (route ms, warp ms, plain ms, bound, CPL, sort)} of the wide
    and dry-run batches)."""
    import torch

    from t1k_tpu_torch.ops import align_band as ab
    from t1k_tpu_torch.parallel import dryrun

    warp = warp_kernel(dev)
    timed, wide = {}, {}
    tc, tl, pc, pl, want = golden_windows()
    ref, reads, desc = ab._pack_windows(tc, tl, pc, pl, dev)
    ml, over = ab._window_class(tl, pl)
    w = ab.band_window(ml, over)
    for stats in (False, True):
        def run(stats=stats):
            return ab.band_stats(ref, reads, desc, ml, w, stats)

        def plain(stats=stats):
            return ab.band_stats_plain(ref, reads, desc, ml, w, stats)
        k_out = run()
        p_out = plain()
        check(k_out, p_out, f"golden stats={stats}")
        check_warp(warp(ref, reads, desc, ml, w, stats), p_out,
                   f"golden stats={stats} (warp)")
        check_group_shapes(dev, check_group,
                           (ref, reads, desc, ml, w, stats), p_out,
                           f"golden stats={stats}", 32)
        if not (k_out[0].cpu().numpy() == want).all():
            raise AssertionError("golden scores differ from the table")
        timed[f"golden_{'stats' if stats else 'scores'}_W{w}"] = (
            time_ms(run, 20, dev), time_ms(plain, 1, dev),
            dp_bound(tl, pl, 40 * len(tl), stats))
    info["golden"] = len(want)

    rng = np.random.default_rng(2024)
    for name, items in (("random", random_items(n_random, rng)),
                        ("edges", edge_items(rng))):
        rref, rreads, starts, lens, t_off, t_len, rc = items
        svc = ab.DeferredDescService(dev)
        svc.set_ref(rref)
        svc.set_layout(starts, lens)
        base = svc.begin_batch(rreads)
        p_off = np.where(rc, base, 0) + starts
        match = svc.stats(t_off, t_len, p_off, lens)
        d = torch.from_numpy(
            np.stack([t_off, t_len, p_off, lens]).astype(np.int64)).to(dev)
        args = (svc._ref, svc._reads, d, ab.DESC_ML, ab.DESC_W)
        p_out = ab.band_stats_plain(*args)
        check(ab.band_stats(*args), p_out, f"{name} W=32")
        check_warp(warp(*args), p_out, f"{name} W=32 (warp)")
        check_group_shapes(dev, check_group, args, p_out, f"{name} W=32", 32)
        if not (match == (p_out[1].cpu().numpy() & 511)).all():
            raise AssertionError(f"{name}: service match counts differ "
                                 "from plain")
        info[f"{name}_items"] = len(t_len)
        info[f"{name}_rc_items"] = int(rc.sum())

    batches = []
    for w in (64, 128, 256):
        batches.append((f"wide_W{w}", *wide_windows(rng, w), 5, w))
    dtc, dtl, dpc, dpl = dryrun.example_batch(dryrun.B, dryrun.LT, dryrun.LP)
    for n in (1024, 512, 256):
        batches.append((f"dryrun_{n}", dtc[:n], dtl[:n], dpc[:n], dpl[:n],
                        dryrun.ML, dryrun.W))
    for name, tcw, t_len, pcw, p_len, ml, w in batches:
        n = len(t_len)
        ref, reads, desc = ab._pack_windows(tcw, t_len, pcw, p_len, dev)
        kw = ab.kernel_window(w)
        cpl, max_slots, sort = ab.group_launch(t_len, p_len, ml, kw)

        def run(ref=ref, reads=reads, desc=desc, ml=ml, w=w,
                lengths=(t_len, p_len)):
            return ab.band_stats(ref, reads, desc, ml, w, lengths=lengths)

        def warp_fn(ref=ref, reads=reads, desc=desc, ml=ml, w=w):
            return warp(ref, reads, desc, ml, w)

        def plain(ref=ref, reads=reads, desc=desc, ml=ml, w=w):
            return ab.band_stats_plain(ref, reads, desc, ml, w)
        p_out = plain()
        before = dict(ab.launch_counts)
        check_group(run(), p_out, name)
        if dev.type == "cuda" and ab.launch_counts != dict(
                before, band_stats_group=before["band_stats_group"] + 1):
            raise AssertionError(f"{name}: the route launched "
                                 f"{ab.launch_counts} after {before}")
        check_warp(warp_fn(), p_out, f"{name} (warp)")
        check_group_shapes(dev, check_group, (ref, reads, desc, ml, w),
                           p_out, name, max_slots)
        reps = 20 if dev.type == "cuda" else 1
        ms = [time_ms(run, reps, dev), time_ms(warp_fn, reps, dev),
              time_ms(warp_fn, reps, dev), time_ms(run, reps, dev)]
        wide[name] = ((ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2,
                      time_ms(plain, 1, dev), dp_bound(t_len, p_len, 40 * n),
                      cpl, sort)
        info[f"{name}_ms"] = " ".join(f"{t:.4f}" for t in ms[::3])
        info[f"{name}_warp_ms"] = " ".join(f"{t:.4f}" for t in ms[1:3])
        info[f"{name}_route"] = (f"cpl{cpl}_sort{int(wide[name][5])}_"
                                 f"slots{max_slots}")
    for case, (ms, plain_ms, (b_ms, _)) in timed.items():
        info[f"{case}_ms"] = f"{ms:.4f}"
        info[f"{case}_plain_ms"] = f"{plain_ms:.2f}"
        info[f"{case}_bound_ms"] = f"{b_ms:.4f}"
    for case, (_, _, plain_ms, (b_ms, _), _, _) in wide.items():
        info[f"{case}_plain_ms"] = f"{plain_ms:.2f}"
        info[f"{case}_bound_ms"] = f"{b_ms:.4f}"
    return timed, wide


def em_problem(n_rg: int, n_ec: int, rng, row_len) -> dict:
    """A seeded EM problem, as the genotyper passes it to em_quantify_gpu
    (options at their defaults): 2 alleles per EC, 24 genes, a major per
    three ECs, each read group `row_len(rng)` distinct random ECs."""
    n_alleles, n_genes, n_majors = 2 * n_ec, 24, n_ec // 3
    ec_to_alleles = [[] for _ in range(n_ec)]
    for a in range(n_alleles):
        ec_to_alleles[a % n_ec].append(a)
    offs, ecs = [0], []
    for _ in range(n_rg):
        ecs.extend(rng.choice(n_ec, size=int(row_len(rng)),
                              replace=False).tolist())
        offs.append(len(ecs))
    return dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0, 3.0], n_rg),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes, n_majors=n_majors, filter_frac=0.15,
        min_squarem_alpha=0.0, max_iterations=1000)


def em_microcell(n_rg: int, n_ec: int) -> dict:
    """The seeded microcell: 1-11 ECs per read group."""
    return em_problem(n_rg, n_ec, np.random.default_rng(5),
                      lambda rng: rng.integers(1, 12))


def em_large(n_rg: int, n_ec: int) -> dict:
    """The seeded problem past shared memory: rows as long as the HLA
    problem's (geometric, mean 40, at most 115 ECs)."""
    return em_problem(n_rg, n_ec, np.random.default_rng(6),
                      lambda rng: min(rng.geometric(1 / 40), 115))


def phase_em(dev, n_rg: int, n_ec: int, info: dict) -> None:
    """The f64 EM kernel (the plain version on the CPU, for rehearsals)
    on the microcell, against the native loop and the plain version on
    the CPU, bit for bit."""
    from t1k_tpu_torch.native import em_quantify
    from t1k_tpu_torch.ops import em

    problem = em_microcell(n_rg, n_ec)
    it_n, c_n = em_quantify(**problem)
    it_k, c_k = em.em_quantify_gpu(**problem, device=dev)
    it_p, c_p = em.em_quantify_gpu(**problem, device="cpu")
    if not it_k == it_p == it_n:
        raise AssertionError(f"EM iterations: kernel {it_k}, plain {it_p}, "
                             f"native {it_n}")
    if not (np.array_equal(c_k, c_n) and np.array_equal(c_p, c_n)):
        raise AssertionError("EM counts differ from the native loop's")
    info["iterations"] = it_k
    info["bit_identical_to_native"] = True


def em_clock_probe(dev, mode: int, n: int):
    """(clock64 cycles, CUDA-event ms) of one t1k_em_clock_probe launch:
    mode 0, n dependent f64 adds on one thread; mode 1, n terms of the
    CSC pass's form on each of 1,024 threads."""
    import torch

    from t1k_tpu_torch.ops import em

    lib = em._kernel_lib()
    inp = torch.tensor([1.0, 1e-9, 3.0], dtype=torch.float64, device=dev)
    out = torch.empty(1024, dtype=torch.float64, device=dev)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)

    def go():
        rc = lib.t1k_em_clock_probe(
            mode, n, inp.data_ptr(), out.data_ptr(), cyc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"clock probe launch failed: CUDA error {rc}")
    go()
    ms = time_ms(go, 3, dev)
    return int(cyc.item()), ms


def em_chain_adds(tables: dict, iterations: int) -> int:
    """The dependent f64 adds em.cc's order forces: per EM update the
    longest read-group row, the longest EC column and the normalizer's
    ec_cnt; per round three updates plus alpha's two concurrent sums
    (ec_cnt) and the L1 change (ec_cnt)."""
    ec = len(tables["ec_len"])
    update = (int(np.diff(tables["rg_off"]).max(initial=0))
              + int(np.diff(tables["col_off"]).max(initial=0)) + ec)
    return iterations * (3 * update + 2 * ec)


# the reference tables of an EM problem, which a cohort shares
EM_REFERENCE_TABLES = ("allele_gene", "allele_major")


def em_work(tables: dict, iterations: int, reference: bool = True):
    """(bytes, f64 operations) of one EM problem: per round three EM
    updates of about 4 operations per incidence (the group sum, then a
    divide, multiply and add per EC count) and 3 per EC, plus the
    extrapolation's and convergence test's 14 per EC; the tables read
    once (the reference tables only with `reference`) and the counts
    written once."""
    nnz, n_ecs = len(tables["rg_ecs"]), len(tables["ec_len"])
    flops = iterations * (3 * (4 * nnz + 3 * n_ecs) + 14 * n_ecs)
    n_bytes = sum(v.nbytes for k, v in tables.items()
                  if isinstance(v, np.ndarray)
                  and (reference or k not in EM_REFERENCE_TABLES))
    return n_bytes + 8 * n_ecs, flops


def em_work_bound(tables: dict, iterations: int):
    """Bytes and f64 operations bound of one EM problem (em_work)."""
    return bound(*em_work(tables, iterations), F64_PER_S)


def em_case(dev, name: str, problem: dict, reps: int, probe, info: dict):
    """One EM problem: the kernel (tables already on the card), the
    wrapper em_quantify_gpu (host tables, uploads and the read-back
    included) and the native loop, in turns (native, kernel, wrapper,
    twice), each held to the native loop bit for bit; the wrapper's host
    tables (em_tables) and device tables (squarem_device: the kernel's
    lists and the uploads) timed apart; the profiled instantiation's
    phase shares.  Returns (kernel ms, bound) with the
    bound the larger of the add chain (probe: ns per dependent f64 add)
    and the bytes/operations bound."""
    import torch

    from t1k_tpu_torch.native import em_quantify
    from t1k_tpu_torch.ops import em

    cuda = dev.type == "cuda"
    opts = {k: problem[k] for k in ("filter_frac", "min_squarem_alpha",
                                     "max_iterations")}
    tables = em.em_tables(**{k: v for k, v in problem.items()
                             if k not in ("allele_missing", *opts)})
    f64 = torch.float64
    if cuda:
        t0 = time.perf_counter()
        em.em_tables(**{k: v for k, v in problem.items()
                        if k not in ("allele_missing", *opts)})
        t1 = time.perf_counter()
        em_dev = em.squarem_device(**tables, device=dev, dtype=f64)
        torch.cuda.synchronize()
        info[f"{name}_tables_ms"] = f"{(t1 - t0) * 1e3:.3f}"
        info[f"{name}_upload_ms"] = f"{(time.perf_counter() - t1) * 1e3:.3f}"

        def kernel():
            em.squarem_launch(em_dev, **opts)

        def kernel_result():
            return (int(em_dev["iterations"].item()),
                    em_dev["count"].cpu().numpy())
    else:  # CPU rehearsal: the plain version stands in
        em_dev = {"shared": None}
        out = []

        def kernel():
            out[:] = em.squarem_plain(**tables, **opts, device=dev,
                                      dtype=f64)

        def kernel_result():
            return out[0], out[1].numpy()

    def wrapper():
        return em.em_quantify_gpu(**problem, device=dev)

    def native():
        return em_quantify(**problem)

    def host_ms(fn):
        t0 = time.perf_counter()
        got = fn()
        cuda and torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, got

    want = native()
    kernel_ms, wrapper_ms, native_ms = [], [], []
    for _ in range(2):
        ms, got = host_ms(native)
        native_ms.append(ms)
        kernel_ms.append(time_ms(kernel, reps if cuda else 1, dev))
        ms, wrapped = host_ms(wrapper)
        wrapper_ms.append(ms)
        for route, (it, count) in (("kernel", kernel_result()),
                                   ("wrapper", wrapped), ("native", got)):
            if it != want[0] or not np.array_equal(count, want[1]):
                raise AssertionError(f"EM {name}: {route} differs from the "
                                     "native loop")
    it = want[0]
    nnz, n_ec = len(tables["rg_ecs"]), len(tables["ec_len"])
    chain = em_chain_adds(tables, it)
    work = em_work_bound(tables, it)
    pre = f"{name}_"
    info[pre + "shape"] = f"{len(tables['rg_counts'])}x{n_ec}"
    info[pre + "nnz"] = nnz
    info[pre + "iterations"] = it
    info[pre + "max_row"] = int(np.diff(tables["rg_off"]).max())
    info[pre + "max_col"] = int(np.diff(tables["col_off"]).max())
    info[pre + "shared"] = em_dev["shared"]
    info[pre + "kernel_ms"] = " ".join(f"{t:.4f}" for t in kernel_ms)
    info[pre + "wrapper_ms"] = " ".join(f"{t:.3f}" for t in wrapper_ms)
    info[pre + "native_ms"] = " ".join(f"{t:.3f}" for t in native_ms)
    info[pre + "chain_adds"] = chain
    b = work
    if probe is not None:
        add_ns, terms_per_ns = probe
        chain_ms = chain * add_ns / 1e6
        info[pre + "chain_bound_ms"] = f"{chain_ms:.4f}"
        # the divides' floor on one SM: 3 updates x nnz terms a round
        info[pre + "term_floor_ms"] = \
            f"{3 * nnz * it / terms_per_ns / 1e6:.4f}"
        if chain_ms > work[0]:
            b = (chain_ms, "operations")  # the serial f64 add chain
    info[pre + "work_bound_ms"] = f"{work[0]:.6f}"
    info[pre + "bound_share"] = f"{b[0] / np.mean(kernel_ms):.4f}"
    if cuda:
        cycles = torch.zeros(len(em.EM_PHASES) + 1, dtype=torch.int64,
                             device=dev)
        em.squarem_launch(em_dev, **opts, cycles=cycles)
        c = cycles.cpu().numpy()
        info[pre + "cycles"] = int(c[-1])
        info[pre + "phase_share"] = ",".join(
            f"{n}:{v / c[-1]:.4f}" for n, v in zip(em.EM_PHASES, c[:-1]))
        if kernel_result()[0] != it:
            raise AssertionError(f"EM {name}: profiled kernel differs")
    return float(np.mean(kernel_ms)), b, tables, opts


def segment_case(dev, name: str, problem: dict, tables: dict, opts: dict,
                 info: dict) -> None:
    """The segment EM (K7, em_quantify_segment: tensor code) on one
    problem through its entry point: finite counts, its rounds and
    largest difference from the native loop printed.  No tolerance is
    held here: each sum is a cumsum difference, which carries the
    rounding of the whole prefix into small psums, and SQUAREM carries it
    on, so the counts depend on the scan's order.  On the CPU (a
    sequential scan) the microcell comes within 7e-8 of the native loop,
    while the JAX package's own segment loop takes 42 rounds to its 29 and
    ends 4.22 reads off; on the card the port's came 3.28 reads off.  The
    `cuda` tests of tests/test_torch_em.py hold it on their problems.
    Then its loop (tables on the device; host clock, it reads each
    round's change) in turns with K5 (the kernel alone, CUDA events):
    segment, K5, K5, segment."""
    import torch

    from t1k_tpu_torch.native import em_quantify
    from t1k_tpu_torch.ops import em

    cuda = dev.type == "cuda"
    f64 = torch.float64
    it_n, c_n = em_quantify(**problem)
    it_s, c_s = em.em_quantify_segment(**problem, device=dev)
    err = np.abs(c_s - c_n)
    if c_s.shape != c_n.shape or not np.isfinite(c_s).all():
        raise AssertionError(f"segment EM {name}: counts not finite")
    seg = em.segment_device(em.segment_tables(**{
        k: v for k, v in problem.items() if k not in ("allele_missing",
                                                      *opts)}), dev, f64)
    if cuda:
        k5_dev = em.squarem_device(**tables, device=dev, dtype=f64)

        def k5():
            em.squarem_launch(k5_dev, **opts)
    else:  # CPU rehearsal: the plain version stands in
        def k5():
            em.squarem_plain(**tables, **opts, device=dev, dtype=f64)

    def loop_ms():
        t0 = time.perf_counter()
        em.segment_loop(seg, **opts)
        return (time.perf_counter() - t0) * 1e3

    seg_ms = [loop_ms()]
    k5_ms = [time_ms(k5, 3 if cuda else 1, dev) for _ in range(2)]
    seg_ms.append(loop_ms())
    pre = f"{name}_segment_"
    info[pre + "iterations"] = f"{it_s}/{it_n}"
    info[pre + "max_diff"] = f"{err.max():.3e}"
    info[pre + "sums"] = f"{c_s.sum():.6f}/{c_n.sum():.6f}"
    info[pre + "loop_ms"] = " ".join(f"{t:.3f}" for t in seg_ms)
    info[pre + "k5_ms"] = " ".join(f"{t:.4f}" for t in k5_ms)


def phase_composite(dev, info: dict) -> None:
    """parallel/dryrun.py's entry(): the single-device composite of
    __graft_entry__.entry() (band kernel, FragWeight, the dense int8 EM
    round) on the card against its CPU run: match equal, x2 within the
    float32 tolerance its CPU test holds against the JAX composite (rtol
    1e-4, atol 1e-8); the band kernel's launches counted (the lane-group
    kernel's, and none of the first design's); the entry timed on the
    host clock (it returns numpy arrays).  Returns the lane-group
    kernel's launches in the first call."""
    from t1k_tpu_torch.ops import align_band
    from t1k_tpu_torch.parallel import dryrun

    before = dict(align_band.launch_counts)
    match, x2 = dryrun.entry(dev)
    band = {k: v - before[k] for k, v in align_band.launch_counts.items()
            if v != before[k]}
    if dev.type == "cuda" and set(band) != {"band_stats_group"}:
        raise AssertionError(f"entry() launched {band}")
    t0 = time.perf_counter()
    want_match, want_x2 = dryrun.entry("cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(match, want_match):
        raise AssertionError("composite match differs from the CPU run's")
    err = np.abs(x2 - want_x2)
    if not np.all(err <= 1e-8 + 1e-4 * np.abs(want_x2)):
        raise AssertionError(f"composite x2 off the CPU run's by up to "
                             f"{err.max()}")
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        dryrun.entry(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    info.update(match_sum=int(match.sum()), x2_max_diff=f"{err.max():.3e}",
                band_launches=band, entry_ms=" ".join(f"{t:.2f}" for t in ms),
                cpu_entry_s=f"{cpu_s:.2f}")
    return band.get("band_stats_group", 0)


def phase_em_timing(dev, hla: dict, sizes: dict, info: dict):
    """The EM kernel at the main path's shape: the HLA problem the `main`
    phase's genotyper passed to em_quantify_gpu, the microcell and a
    seeded problem with about ten times the HLA incidences (which takes
    the device-memory instantiation).  Prints the f64 add latency and
    the divide-term throughput the bounds use.  Returns (kernel ms, plain
    ms, bound, max |kernel - plain on the CPU|) on the HLA problem."""
    import torch

    from t1k_tpu_torch.ops import em

    cuda = dev.type == "cuda"
    probe = None
    if cuda:
        n_add, n_term = 1 << 22, 1 << 13
        add_cyc, add_ms = em_clock_probe(dev, 0, n_add)
        term_cyc, term_ms = em_clock_probe(dev, 1, n_term)
        probe = (add_ms * 1e6 / n_add, 1024 * n_term / (term_ms * 1e6))
        info["f64_add_cycles"] = f"{add_cyc / n_add:.3f}"
        info["f64_add_ns"] = f"{probe[0]:.4f}"
        info["terms_per_cycle"] = f"{1024 * n_term / term_cyc:.3f}"
        info["terms_per_ns"] = f"{probe[1]:.3f}"
    out = None
    for name, problem, reps in (
            ("hla", hla, 10), ("micro", em_microcell(*sizes["em"]), 10),
            ("large", em_large(*sizes["em_large"]), 3)):
        ms, b, tables, opts = em_case(dev, name, problem, reps, probe, info)
        segment_case(dev, name, problem, tables, opts, info)
        if name == "large" and cuda and em.em_shared_bytes(
                len(tables["rg_counts"]), len(tables["ec_len"]), 8) \
                <= em.EM_SHARED_LIMIT:
            raise AssertionError("the large EM problem fits shared memory")
        if name == "hla":
            def plain(tables=tables, opts=opts):
                return em.squarem_plain(**tables, **opts, device=dev,
                                        dtype=torch.float64)
            plain_ms = [time_ms(plain, 1, dev)]
            _, c_p = em.squarem_plain(**tables, **opts, device="cpu",
                                      dtype=torch.float64)
            plain_ms.append(time_ms(plain, 1, dev))
            it, c_k = em.em_quantify_gpu(**problem, device=dev)
            err = float(np.abs(c_k - c_p.numpy()).max())
            info["hla_plain_ms"] = " ".join(f"{t:.1f}" for t in plain_ms)
            out = (ms, float(np.mean(plain_ms)), b, err)
    return out


def phase_main(dev, work: str, n_genes: int, copies: int, n_pairs: int,
               info: dict, em_problems: list) -> None:
    """The port's CLI on `dev` in this process vs its native route in a
    child process on the HLA-scale panel; each kernel must launch over the
    card route's run.  Appends the EM problem the card route's genotyper
    solved to `em_problems`."""
    import inspect

    from t1k_tpu_torch.cli import genotype as cli
    from t1k_tpu_torch.core import genotyper as tg
    from t1k_tpu_torch.ops import align_band as ab
    from t1k_tpu_torch.ops import em

    panel = os.path.join(work, "panel.fa")
    build_panel(panel, n_genes, copies)
    simulate_reads(panel, os.path.join(work, "r"), n_pairs)
    fq1, fq2 = os.path.join(work, "r_1.fq"), os.path.join(work, "r_2.fq")
    # its read assignment (_assign.tsv) is the candidates phase's
    # reference for the pruned genotyper
    out, _, native_s = timed_chain(
        native_cmd("cli.genotype", "-f", panel, "-1", fq1, "-2", fq2,
                   "-o", os.path.join(work, "native"), "--backend",
                   "native", "--emBackend", "native",
                   "--outputReadAssignment"), (STARTUP,))
    # keep the EM problem the genotyper passes (for em_timing)
    em_call = tg.em_quantify_gpu
    em_args = inspect.signature(em_call)

    def capture(*args, **kwargs):
        bound_args = em_args.bind(*args, **kwargs).arguments
        em_problems.append({k: v for k, v in bound_args.items()
                            if k not in ("device", "dtype")})
        return em_call(*args, **kwargs)
    ab.launch_counts.update(dict.fromkeys(ab.launch_counts, 0))
    em.launch_counts["em_squarem"] = 0
    tg.em_quantify_gpu = capture
    t0 = time.perf_counter()
    try:
        cli.main(["-f", panel, "-1", fq1, "-2", fq2, "-o",
                  os.path.join(work, "port"), "--backend", "gpu",
                  "--emBackend", "gpu", "--device", str(dev)])
    finally:
        tg.em_quantify_gpu = em_call
    t_port = time.perf_counter() - t0
    if len(em_problems) != 1:
        raise AssertionError(f"the genotyper ran {len(em_problems)} EMs")
    launches = {"band_stats": ab.launch_counts["band_stats"],
                "em_squarem": em.launch_counts["em_squarem"]}
    wide_launches = (ab.launch_counts["band_stats_warp"]
                     + ab.launch_counts["band_stats_group"])
    for suffix in ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                   "_aligned_2.fa"):
        with open(os.path.join(work, "native" + suffix), "rb") as f:
            a = f.read()
        with open(os.path.join(work, "port" + suffix), "rb") as f:
            b = f.read()
        if a != b:
            raise AssertionError(f"{suffix} differs from the native route")
    metrics = {}
    for route in ("port", "native"):
        with open(os.path.join(work, f"{route}_metrics.json")) as f:
            metrics[route] = json.load(f)
    ra = metrics["port"]["read_assignment"]
    if ra["band_kernel_launches"] != launches["band_stats"]:
        raise AssertionError("metrics and wrapper disagree on launches")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if wide_launches:
        raise AssertionError("the main path launched a wide-window band "
                             "kernel")
    if ra["deferred_item_count"] <= 0:
        raise AssertionError("the main path deferred no DP item")
    with open(os.path.join(work, "port_genotype.tsv")) as f:
        info["genotype_rows"] = sum(1 for _ in f)
    info["alleles"] = n_genes * copies * 120
    info["pairs"] = n_pairs
    info["port_s"] = f"{t_port:.2f}"
    info["native_s"] = f"{native_s['process']:.2f}"
    info["native_startup_s"] = f"{native_s['startup']:.2f}"
    info["native_cuda_context"] = cuda_context(out)
    info["deferred_item_count"] = ra["deferred_item_count"]
    info["band_kernel_launches"] = launches["band_stats"]
    info["em_kernel_launches"] = launches["em_squarem"]
    info["em_iterations"] = metrics["port"]["em_quantification"][
        "em_iteration_count"]
    for route, m in metrics.items():
        print(f"  {route} stages: " + " ".join(
            f"{k}={v['seconds']}s" for k, v in m.items()), flush=True)


# ---------------------------------------------------- distributed phase
DIST_SHARDS = 3
# the multi-process flavour's read pairs: the first of main's, cut from
# its 12,000 for the time limit (4,000 took two chains of 29.6-37.4 s,
# 2,000 of 22.9-33.0 s, H100 80GB HBM3 at 700 W)
MP_PAIRS = 1_000
MP_OUTPUTS = ("_candidate_1.fq", "_candidate_2.fq", "_genotype.tsv",
              "_allele.tsv", "_aligned_1.fa", "_aligned_2.fa",
              "_allele.vcf")
DIST_OUTPUTS = ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                "_aligned_2.fa")


def same_files(a: str, b: str, suffixes, what: str) -> None:
    for suffix in suffixes:
        with open(a + suffix, "rb") as f, open(b + suffix, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{what}: {suffix} differs")


def phase_distributed(dev, work: str, info: dict,
                      mp_pairs: int = MP_PAIRS) -> dict:
    """The host-sharded genotyper on main's panel and reads.  In this
    process, parallel/distributed.py's run_genotyper_distributed at
    DIST_SHARDS shards (one band-kernel service for all), --backend gpu
    --emBackend gpu: its files exactly the genotyper's four, each equal
    to main's port and native outputs; each shard's fragments, deferred
    items, band launches and host seconds printed; the band kernel and
    the EM kernel must launch in it.  Then the run-t1k chain
    (t1k_tpu_torch.cli.run --backend gpu --emBackend gpu) on the first
    `mp_pairs` of those pairs, once as one process and once as two
    processes (T1K_NUM_PROCESSES=2) sharing the card, each a child
    process with its launch counts printed: every output equal, the band
    kernel launched by both processes of the pair.  Returns the
    in-process run's launch counts."""
    from t1k_tpu_torch.core.pipeline import GenotypeOptions
    from t1k_tpu_torch.ops import align_band as ab
    from t1k_tpu_torch.ops import em
    from t1k_tpu_torch.parallel.distributed import run_genotyper_distributed
    from t1k_tpu_torch.utils.observability import metrics

    panel = os.path.join(work, "panel.fa")
    fq1, fq2 = os.path.join(work, "r_1.fq"), os.path.join(work, "r_2.fq")
    out = os.path.join(work, "dist")
    os.makedirs(out)
    ab.launch_counts.update(dict.fromkeys(ab.launch_counts, 0))
    em.launch_counts["em_squarem"] = 0
    t0 = time.perf_counter()
    run_genotyper_distributed(
        panel, [fq1], [fq2], os.path.join(out, "d"),
        GenotypeOptions(backend="gpu", em_backend="gpu", device=str(dev)),
        n_workers=DIST_SHARDS)
    info["in_process_s"] = f"{time.perf_counter() - t0:.2f}"
    launches = {"band_stats": ab.launch_counts["band_stats"],
                "em_squarem": em.launch_counts["em_squarem"]}
    if sorted(os.listdir(out)) != sorted("d" + s for s in DIST_OUTPUTS):
        raise AssertionError(f"files written: {sorted(os.listdir(out))}")
    for route in ("port", "native"):
        same_files(os.path.join(out, "d"), os.path.join(work, route),
                   DIST_OUTPUTS, f"{DIST_SHARDS} shards against main's "
                   f"{route} route")
    stages = metrics().stages
    shards = [stages[f"shard_{w}"] for w in range(DIST_SHARDS)]
    for w, s in enumerate(shards):
        print(f"  shard {w}: fragments={s['fragment_count']} "
              f"deferred_items={s['deferred_item_count']} "
              f"band_launches={s['band_kernel_launches']} "
              f"host_s={s['seconds']} read_assignment_s="
              f"{s['read_assignment_seconds']}", flush=True)
    if sum(s["band_kernel_launches"] for s in shards) != \
            launches["band_stats"]:
        raise AssertionError("the shards and the wrapper disagree on "
                             "launches")
    if dev.type == "cuda" and (launches["band_stats"] <= 0
                               or launches["em_squarem"] < 1):
        raise AssertionError(f"a kernel of the sharded genotyper never "
                             f"launched: {launches}")
    if ab.launch_counts["band_stats_warp"] or \
            ab.launch_counts["band_stats_group"]:
        raise AssertionError("the sharded genotyper launched a "
                             "wide-window band kernel")
    info["deferred_items"] = sum(s["deferred_item_count"] for s in shards)
    info["band_launches"] = launches["band_stats"]
    info["em_launches"] = launches["em_squarem"]
    info["em_iterations"] = stages["em_quantification"]["em_iteration_count"]

    # the multi-process CLI flavour on the first mp_pairs pairs
    mp1, mp2 = (os.path.join(work, f"mp_{m}.fq") for m in (1, 2))
    for src, dst in ((fq1, mp1), (fq2, mp2)):
        with open(src) as f, open(dst, "w") as g:
            g.writelines(line for _, line in zip(range(4 * mp_pairs), f))
    args = ["-f", panel, "-1", mp1, "-2", mp2, "-o", "mp", "--backend",
            "gpu", "--emBackend", "gpu", "--device", str(dev)]
    env = child_env()
    for var in ("T1K_NUM_PROCESSES", "T1K_PROCESS_ID"):
        env.pop(var, None)
    t0 = time.perf_counter()
    one = subprocess.run(
        [sys.executable, "-c", PORT_RUN, *args, "--od",
         os.path.join(work, "mp_one")],
        cwd=ROOT, env=env, capture_output=True, text=True)
    info["mp_one_process_s"] = f"{time.perf_counter() - t0:.2f}"
    if one.returncode != 0:
        raise RuntimeError(f"one-process chain failed:\n{one.stderr[-4000:]}")
    procs = []
    t0 = time.perf_counter()
    for pid in (1, 0):  # process 1 first: it waits for 0's extraction
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PORT_RUN, *args, "--od",
             os.path.join(work, "mp_two")],
            cwd=ROOT, env=dict(env, T1K_NUM_PROCESSES="2",
                               T1K_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = [p.communicate(timeout=600) for p in procs]
    info["mp_two_processes_s"] = f"{time.perf_counter() - t0:.2f}"
    for pid, p, (_, err) in zip((1, 0), procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"process {pid} of 2 failed:\n{err[-4000:]}")
    same_files(os.path.join(work, "mp_two", "mp"),
               os.path.join(work, "mp_one", "mp"), MP_OUTPUTS,
               "two processes against one")
    one_launches = json.loads(one.stdout.splitlines()[-1])
    two_launches = [json.loads(o.splitlines()[-1]) for o, _ in logs]
    info["mp_pairs"] = mp_pairs
    info["mp_band_launches_one"] = one_launches["band_stats"]
    info["mp_band_launches_two"] = "+".join(
        str(n["band_stats"]) for n in two_launches)
    if dev.type == "cuda" and min(n["band_stats"] for n in two_launches) <= 0:
        raise AssertionError(f"a process of the two launched no band "
                             f"kernel: {two_launches}")
    return launches


# ------------------------------------------------------------- db phase
# An IPD-shaped .dat: tests/test_db_scale.py's generator, copied, at its
# defaults (24 genes x 125 records, 8,949,152 bytes, 2,292 alleles out)
DB_GENES, DB_RECORDS = 24, 125
DB_PAIRS = 4_000
# a genotyper child's wall: from its start to its first stage line, then
# to its last (the log lines of core/pipeline.py)
DB_STAGE_MARKS = (("start", None, "read fragments. Start read assignment."),
                  ("genotyper", "read fragments. Start read assignment.",
                   "Genotyping finishes."))


def _dat_seq(rng, n):
    return "".join(rng.choice(BASES) for _ in range(n))


def _dat_mutate(rng, seq, rate):
    out = []
    for c in seq:
        if rng.random() < rate:
            out.append(BASES[(BASES.index(c) + rng.randint(1, 3)) % 4])
        else:
            out.append(c)
    return "".join(out)


def _dat_record(f, allele, seq, features):
    f.write(f"ID   {allele}\n")
    f.write(f'FT   allele="{allele}"\n')
    for line in features:
        f.write(f"FT   {line}\n")
    f.write(f"SQ  Sequence {len(seq)} BP\n")
    for i in range(0, len(seq), 60):
        chunk = seq[i:i + 60]
        f.write(f"{chunk} {min(i + 60, len(seq))}\n")
    f.write("//\n")


def make_ipd_dat(rng, path, n_genes=DB_GENES, alleles_per_gene=DB_RECORDS,
                 exons=(6, 8), exon_len=(90, 360), intron_len=(80, 250)):
    """hla.dat-shaped: 6-8 exons/gene (`exons`, each `exon_len` bp apart
    from introns of `intron_len` bp), ~1-3kb alleles, 18% exon-only
    (rna-style) partial records, 12% block-dropped partials, 5% exact
    duplicates.  Returns the gene names."""
    genes = []
    with open(path, "w") as f:
        for g in range(n_genes):
            gene = f"IP{chr(65 + g // 4)}{g % 4 + 1}"
            genes.append(gene)
            n_ex = rng.randint(*exons)
            utr5, utr3 = rng.choice([30, 50, 80]), rng.choice([30, 50, 80])
            ex_lens = [rng.randint(*exon_len) for _ in range(n_ex)]
            in_lens = [rng.randint(*intron_len) for _ in range(n_ex - 1)]
            exons_t = [_dat_seq(rng, n) for n in ex_lens]
            introns_t = [_dat_seq(rng, n) for n in in_lens]
            dup_from = None
            for a in range(alleles_per_gene):
                allele = f"{gene}*{a + 1:03d}"
                ex = [_dat_mutate(rng, e, rng.uniform(0.0, 0.01))
                      for e in exons_t]
                if dup_from is not None and rng.random() < 0.05:
                    ex = dup_from
                elif rng.random() < 0.1:
                    dup_from = ex
                r = rng.random()
                parts, feats, pos = [], [], 1
                if r < 0.18:
                    # exon-only partial: the dna mode's intron rescue
                    lo = rng.randint(0, 1)
                    hi = n_ex - rng.randint(0, 1)
                    for i in range(lo, hi):
                        parts.append(ex[i])
                        feats.append(
                            f"exon          {pos}..{pos + len(ex[i]) - 1}")
                        pos += len(ex[i])
                    feats.append("/partial")
                else:
                    lo, hi = 0, n_ex
                    partial = r < 0.30
                    if partial:
                        if rng.random() < 0.7:
                            lo = rng.randint(1, n_ex - 1)
                        if hi - lo > 1 and rng.random() < 0.5:
                            hi = rng.randint(lo + 1, n_ex)
                        if (lo, hi) == (0, n_ex):
                            partial = False
                    pad5 = utr5 if lo == 0 else 0
                    if pad5:
                        parts.append(_dat_seq(rng, pad5))
                        pos += pad5
                    for i in range(lo, hi):
                        parts.append(ex[i])
                        feats.append(
                            f"exon          {pos}..{pos + len(ex[i]) - 1}")
                        pos += len(ex[i])
                        if i + 1 < hi:
                            intr = introns_t[i]
                            parts.append(intr)
                            feats.append(
                                f"intron        {pos}..{pos + len(intr) - 1}")
                            pos += len(intr)
                    if hi == n_ex:
                        parts.append(_dat_seq(rng, utr3))
                    if partial:
                        feats.append("/partial")
                _dat_record(f, allele, "".join(parts), feats)
    return genes


def write_chr6_gtf(path: str, genes) -> dict:
    """Each gene on an interval of its own on chr6, strands alternating;
    returns gene -> its coordinates as add_gene_coord writes them."""
    coords = {}
    with open(path, "w") as f:
        f.write("#!genome-build synthetic\n")
        for i, gene in enumerate(genes):
            start, strand = 29_700_000 + 40_000 * i, "+-"[i % 2]
            end = start + 5_000
            attrs = f'gene_id "G{i:02d}"; gene_name "{gene}";'
            f.write(f"chr6\tsynthetic\tgene\t{start}\t{end}\t.\t{strand}\t.\t"
                    f"{attrs}\n")
            f.write(f"chr6\tsynthetic\texon\t{start}\t{start + 300}\t.\t"
                    f"{strand}\t.\t{attrs} transcript_name \"{gene}-201\";\n")
            coords[gene] = f"chr6 {start} {end} {strand}"
    return coords


def db_genotype(dev, work: str, panel: str, reads: str, route: str) -> tuple:
    """t1k_tpu_torch.cli.genotype in a child process through PORT_GENOTYPE
    (--backend and --emBackend `route`, --outputReadAssignment, prefix
    `route` in `work`): (the
    kernels' launch counts, its metrics, {"process", "start", "genotyper",
    "exit": seconds} by DB_STAGE_MARKS)."""
    stdout, _, secs = timed_chain(
        [sys.executable, "-c", PORT_GENOTYPE, "-f", panel,
         "-1", reads + "_1.fq", "-2", reads + "_2.fq",
         "-o", os.path.join(work, route), "--backend", route,
         "--emBackend", route, "--device", str(dev),
         "--outputReadAssignment"], DB_STAGE_MARKS)
    secs["exit"] = secs["process"] - secs["start"] - secs["genotyper"]
    with open(os.path.join(work, route + "_metrics.json")) as f:
        metrics = json.load(f)
    return json.loads(stdout.strip().splitlines()[-1]), metrics, secs


def phase_db(dev, work: str, n_pairs: int, info: dict) -> dict:
    """The port's database build into the genotyper: an IPD-shaped .dat
    and a chr6 GTF through `python -m t1k_tpu_torch.db.build -d -g` (rna,
    dna and both coordinate fastas), then `n_pairs` simulated from two
    alleles of every gene of the built rna fasta through the port's
    cli.genotype on the card (--backend gpu --emBackend gpu) and on the
    host engine (--backend native --emBackend native), each in a child
    process; every output, the read assignments included, byte-identical.  Returns the card route's
    launches of the band and EM kernels."""
    db_dir = os.path.join(work, "db")
    os.makedirs(db_dir)
    dat, gtf = os.path.join(db_dir, "ipd.dat"), os.path.join(db_dir, "ipd.gtf")
    t0 = time.perf_counter()
    genes = make_ipd_dat(random.Random(42), dat)
    coords = write_chr6_gtf(gtf, genes)
    info["write_s"] = f"{time.perf_counter() - t0:.2f}"
    info["dat_bytes"] = os.path.getsize(dat)
    out = os.path.join(db_dir, "idx")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "t1k_tpu_torch.db.build", "-d", dat,
         "-g", gtf, "-o", out, "--prefix", "ipd"],
        cwd=ROOT, env=child_env(), capture_output=True, text=True)
    info["build_s"] = f"{time.perf_counter() - t0:.3f}"
    if proc.returncode != 0:
        raise RuntimeError(f"the database build failed:\n{proc.stderr[-4000:]}")
    for kind in ("rna", "dna"):
        seq = read_fasta(os.path.join(out, f"ipd_{kind}_seq.fa"))
        coord = read_fasta(os.path.join(out, f"ipd_{kind}_coord.fa"))
        if not seq or [(n, s) for n, _, s in seq] != \
                [(n, s) for n, _, s in coord]:
            raise AssertionError(f"the {kind} coordinate fasta's alleles "
                                 "differ from its sequence fasta's")
        for name, where, _ in coord:
            if where != coords[name.split("*")[0]]:
                raise AssertionError(f"{name}: coordinates {where!r}")
        if {n.split("*")[0] for n, _, _ in seq} != set(genes):
            raise AssertionError(f"a gene has no allele in the {kind} fasta")
        info[f"{kind}_alleles"] = len(seq)

    panel = os.path.join(out, "ipd_rna_seq.fa")
    reads = os.path.join(db_dir, "reads")
    simulate_reads(panel, reads, n_pairs, n_genes=len(genes))
    launches, metrics, walls = {}, {}, {}
    for route in ("gpu", "native"):
        launches[route], metrics[route], walls[route] = db_genotype(
            dev, db_dir, panel, reads, route)
    names = {route: sorted(n[len(route):] for n in os.listdir(db_dir)
                           if n.startswith(route + "_"))
             for route in launches}
    if names["gpu"] != names["native"]:
        raise AssertionError(f"the routes wrote other files: {names}")
    outputs = [s for s in names["gpu"] if s != "_metrics.json"]
    for suffix in outputs:
        with open(os.path.join(db_dir, "gpu" + suffix), "rb") as f:
            a = f.read()
        with open(os.path.join(db_dir, "native" + suffix), "rb") as f:
            b = f.read()
        if a != b:
            raise AssertionError(f"db: {suffix} differs from the native "
                                 "route")
    card = {k: launches["gpu"][k] for k in ("band_stats", "em_squarem")}
    if launches["native"]["band_stats"] or launches["native"]["em_squarem"]:
        raise AssertionError(f"the native route launched kernels: "
                             f"{launches['native']}")
    ra = metrics["gpu"]["read_assignment"]
    if ra["band_kernel_launches"] != card["band_stats"]:
        raise AssertionError("metrics and wrapper disagree on launches")
    if dev.type == "cuda" and min(card.values()) <= 0:
        raise AssertionError(f"a kernel of the db path never launched: "
                             f"{card}")
    with open(os.path.join(db_dir, "gpu_genotype.tsv")) as f:
        info["genotype_rows"] = sum(1 for _ in f)
    info["pairs"] = n_pairs
    info["outputs"] = ",".join(outputs)
    info["deferred_item_count"] = ra["deferred_item_count"]
    info["band_kernel_launches"] = card["band_stats"]
    info["em_kernel_launches"] = card["em_squarem"]
    for route in ("gpu", "native"):
        info[f"{route}_s"] = f"{walls[route]['process']:.3f}"
        print(f"  db {route} process: " + " ".join(
            f"{k}={v:.3f}s" for k, v in walls[route].items())
            + "; stages: " + " ".join(
                f"{k}={v['seconds']}s" for k, v in metrics[route].items()),
            flush=True)
    return card


def candidate_cases():
    """(name, seqs, reads, k, hit_len, caps) of the seeded panels of the
    candidate route: random panels, 40 alleles 1% apart (the genotyper's
    k = 11, hitLen 31), the same in chunks of 7 reads, and tiny caps (the
    hit cap, the bucket cap)."""
    cases = []
    for trial in range(3):
        rng = np.random.default_rng(900 + trial)
        base = rand_seq(rng, int(rng.integers(300, 700)))
        seqs = []
        for _ in range(int(rng.integers(3, 25))):
            if rng.random() < 0.7:
                seqs.append(mutate(rng, base, 0.03).replace("N", "A"))
            else:
                seqs.append(rand_seq(rng, int(rng.integers(200, 600))))
        cases.append((f"random{trial}", seqs, make_reads(rng, seqs, 200), 9,
                      23, dict(bucket_cap=128)))
    rng = np.random.default_rng(41)
    base = rand_seq(rng, 900)
    seqs = [mutate(rng, base, 0.01).replace("N", "G") for _ in range(40)]
    reads = make_reads(rng, seqs, 400)
    cases.append(("near_identical", seqs, reads, 11, 31,
                  dict(bucket_cap=256)))
    cases.append(("chunks", seqs, reads, 11, 31,
                  dict(bucket_cap=256, row_chunk=7)))
    rng = np.random.default_rng(5)
    base = rand_seq(rng, 400)
    seqs = [mutate(rng, base, 0.005).replace("N", "T") for _ in range(110)]
    reads = [mutate(rng, base[:100], 0.01) for _ in range(8)]
    cases.append(("hit_cap", seqs, reads, 9, 23,
                  dict(hit_cap=256, bucket_cap=32)))
    cases.append(("bucket_cap", seqs, reads, 9, 23, dict(bucket_cap=2)))
    return cases


def candidate_keys(out, n_seqs: int) -> np.ndarray:
    """generate's buckets as read * 2 n_seqs + (strand +1: n_seqs) + seq."""
    reads, seqs, strands, _ = out
    return (reads * 2 * n_seqs + np.where(strands == 1, n_seqs, 0)
            + seqs.astype(np.int64))


def check_candidates(dev, packed, k: int, hit_len: int, reads, codes, lens,
                     caps: dict, what: str, plain_rows=None):
    """DeviceCandidates on `dev` against its plain version on the CPU (on
    the first `plain_rows` reads, all by default; array for array) and
    every decided read's keep set against the engine's overlap buckets.
    Returns the card's DeviceCandidates, its output and its chunks'
    figures."""
    from t1k_tpu_torch.native import NativeEngine
    from t1k_tpu_torch.ops import phase_a as pa

    dc = pa.DeviceCandidates.build(packed, k, hit_len, device=dev, **caps)
    out = dc.generate(codes, lens)
    chunks = list(dc.chunks)
    sub = slice(0, plain_rows)
    if plain_rows is not None:
        got = dc.generate(codes[sub], lens[sub])
    else:
        got = out
    want = pa.DeviceCandidates.build(packed, k, hit_len, device="cpu",
                                     **caps).generate(codes[sub], lens[sub])
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"candidates {what}: card differs from "
                                 "plain")
    eng = NativeEngine(packed, k, hit_len_required=hit_len)
    starts = np.zeros(len(lens), np.int64)
    starts[1:] = np.cumsum(lens[:-1].astype(np.int64))
    cat = np.concatenate([encode(r) if isinstance(r, str) else r
                          for r in reads])
    off, oseqs, ostrands = eng.overlap_buckets(cat, starts, lens)
    read_of = np.repeat(np.arange(len(lens)), np.diff(off))
    keep = ~out[3][read_of]
    want_keys = candidate_keys((read_of[keep], oseqs[keep], ostrands[keep],
                                None), packed.n)
    if not np.array_equal(np.sort(candidate_keys(out, packed.n)),
                          np.sort(want_keys)):
        raise AssertionError(f"candidates {what}: keep sets differ from the "
                             "engine's overlap buckets")
    return dc, out, chunks


def genotype_child(dev, work: str, name: str, flags) -> tuple:
    """t1k_tpu_torch.cli.genotype on the main phase's reads in a child
    process (--backend gpu --emBackend gpu --outputReadAssignment):
    (prefix, the kernels' launch counts, its metrics, process seconds)."""
    prefix = os.path.join(work, name)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", PORT_GENOTYPE, "-f",
         os.path.join(work, "panel.fa"), "-1", os.path.join(work, "r_1.fq"),
         "-2", os.path.join(work, "r_2.fq"), "-o", prefix, "--backend",
         "gpu", "--emBackend", "gpu", "--device", str(dev),
         "--outputReadAssignment", *flags],
        cwd=ROOT, env=child_env(), capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")
    with open(prefix + "_metrics.json") as f:
        metrics = json.load(f)
    return (prefix, json.loads(proc.stdout.strip().splitlines()[-1]),
            metrics, secs)


# keys a pass of the census kernel forced on one chunk, so that the
# genotyper cell's 11,520 keys take 12 slices (the default takes them in
# one); its walks of each read's postings go up from 3 to 36
FORCED_BINS = 1000


def census_arrays(cen):
    """A BucketCensus on its device, for a comparison in which the order
    inside a bucket is free: its bucket count, every bucket's key, first
    slot and count, and the arena's (bucket, a, b) keys sorted."""
    import torch

    nb = int(cen.nb_total)
    count = cen.count[:nb].long()
    bucket = torch.repeat_interleave(torch.arange(nb, device=count.device),
                                     count, output_size=len(cen.a))
    seeds = torch.sort((bucket << 32) | (cen.a.long() << 20)
                       | cen.b.long()).values
    return nb, cen.key[:nb], cen.first[:nb], cen.count[:nb], seeds


def tiles_chunk(contrib, cstart, total: int, lens, dc, tile_rows=16384):
    """The tile route of K10 that the two kernels replace, for the time
    beside theirs: the tensor code census (`cand_census`: one sort of the
    arena), the buckets worth chaining in dense tiles of tile_rows
    (`cand_tile`, the dense chain kernel) and their kept keys, brought to
    the host."""
    import torch

    from t1k_tpu_torch.ops import phase_a as pa

    idx = dc.index
    census = pa.cand_census(contrib, cstart, total, idx)
    rows = torch.nonzero(
        (census.count >= pa.min_chain_seeds(idx.k, dc.hit_len_required))
        & (census.count <= dc.bucket_cap))[:, 0]
    keys = [torch.zeros(0, dtype=torch.int64, device=lens.device)]
    for t0 in range(0, len(rows), tile_rows):
        tile = rows[t0:t0 + tile_rows]
        keep = pa.cand_tile(census, lens, tile, k=idx.k, n_seqs=idx.n_seqs,
                            radius=dc.radius,
                            hit_len_required=dc.hit_len_required,
                            bucket_cap=dc.bucket_cap)
        keys.append(torch.where(keep, census.gk[census.first[tile]], -1))
    keys = torch.cat(keys)
    return keys[keys >= 0].cpu()


def k10_bounds(contrib, total: int, nb: int, cnt: np.ndarray,
               n_kept: int) -> tuple:
    """Bounds of one chunk of K10 after its probe: the work, whatever
    implements it, each value at the narrowest width that holds it.
    Census: contrib and cstart in, one posting read per hit (post_seq and
    post_off, 8 bytes), one seed written per hit (a and b, 8 bytes), key,
    first and count per bucket (12 bytes); its few integer operations a
    hit are not counted (bytes set it).  Chain: each bucket's count (4
    bytes), each chained bucket's key, first and read length (12 bytes)
    and seeds (8 bytes each) in, the keep set out (4 bytes a kept key);
    operations as chain_bound's for the chained buckets (`cnt`, their seed
    counts).  Returns the census's, the chain's and the chunk's bounds."""
    census_bytes = 2 * contrib.numel() * 4 + 16 * total + 12 * nb
    n = cnt.astype(np.int64)
    logn = np.ceil(np.log2(np.maximum(n, 2)))
    ops = float((3 * 2 * n * logn + 20 * n).sum())
    chain_bytes = 4 * nb + 12 * len(n) + 8 * float(n.sum()) + 4 * n_kept
    rate = int32_per_s()
    return (bound(census_bytes, 0, rate), bound(chain_bytes, ops, rate),
            bound(census_bytes + chain_bytes, ops, rate))


def phase_candidates(dev, work: str, info: dict) -> dict:
    """The genotyper's device candidate pruning (DeviceCandidates, K10) on
    the card; see the module docstring.  Returns, for the census kernel
    (cand_census) and the bucket chain (device_candidates), each its
    ((ms, plain ms, bound), launches in the pruned genotyper run, the
    kernel record's other fields)."""
    import torch

    from t1k_tpu_torch.constants import GENOTYPER_KMER_LENGTH
    from t1k_tpu_torch.core.pipeline import CANDIDATE_CAPS
    from t1k_tpu_torch.io.refset import RefSet
    from t1k_tpu_torch.native import NativeEngine
    from t1k_tpu_torch.ops import phase_a as pa

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    decided = screened = 0
    for name, seqs, reads, k, hlr, caps in candidate_cases():
        rs = RefSet(digit_units=-1, delimiter="")
        for i, s in enumerate(seqs):
            rs.add_allele(f"G{i % 3}*{i:03d}", s, None)
        codes, lens = pad_reads(reads)
        dc, out, _ = check_candidates(dev, rs.packed(), k, hlr, reads,
                                      codes, lens, caps, name)
        if name.endswith("_cap") and not out[3].all():
            raise AssertionError(f"candidates {name}: reads past the caps "
                                 "were decided")
        decided += dc.decided
        screened += dc.screened
    info["seeded_reads"] = screened
    info["seeded_decided"] = decided

    # the genotyper cell's unique reads, as the stage sends them
    k = GENOTYPER_KMER_LENGTH
    packed = RefSet.from_fasta(os.path.join(work, "panel.fa"), -1,
                               "").packed()
    seqs = sorted({s for side in ("1", "2") for s in read_fastq_seqs(
        os.path.join(work, f"r_{side}.fq"), -1)})
    uniq = [s.decode() for s in seqs]
    codes, lens = pad_reads(uniq)
    hlr = NativeEngine(packed, k).hit_len_required
    t0 = time.perf_counter()
    dc, out, chunks = check_candidates(dev, packed, k, hlr, uniq, codes,
                                       lens, CANDIDATE_CAPS,
                                       "genotyper cell", plain_rows=16)
    info["check_s"] = f"{time.perf_counter() - t0:.1f}"
    for c in chunks:
        print("  chunk {lo}-{hi}: hits={hits} buckets={buckets} "
              "decided={decided} kept={kept}".format(**c), flush=True)
    n = len(uniq)
    n_decided = int((~out[3]).sum())
    hits = np.array([c["hits"] for c in chunks])
    # each read's hits, and the largest chunk total at other chunk sizes
    # (what the pipeline's row_chunk is chosen from)
    tot = np.concatenate([pa.probe(
        torch.from_numpy(codes[lo:lo + 1024]).to(dev),
        torch.from_numpy(lens[lo:lo + 1024]).to(dev), dc.index)[2].cpu()
        .numpy() for lo in range(0, n, 1024)]).astype(np.int64)
    info["hits_per_read"] = (f"mean:{tot.mean():.1f} median:"
                             f"{np.median(tot):.0f} p99:"
                             f"{np.percentile(tot, 99):.0f} max:{tot.max()}")
    for rows in (1024, 512, 256):
        info[f"max_hits_{rows}_rows"] = int(np.add.reduceat(
            tot, np.arange(0, n, rows)).max())
    info["unique_reads"] = n
    info["decided_share"] = f"{n_decided / n:.4f}"
    info["row_chunk"] = dc.row_chunk
    info["chunks"] = len(chunks)
    info["hits_per_chunk"] = f"{hits.min()}-{int(np.median(hits))}-" \
                             f"{hits.max()}"
    info["hit_cap"] = dc.hit_cap
    info["buckets_per_read"] = \
        f"{sum(c['buckets'] for c in chunks) / n:.1f}"
    info["kept_per_read"] = f"{len(out[0]) / max(n_decided, 1):.1f}"
    if n_decided < 0.95 * n:
        raise AssertionError(f"the card decided {n_decided} of {n} reads")
    gen_s = []
    for _ in range(2):
        waits = dc.waits
        sync()
        t0 = time.perf_counter()
        dc.generate(codes, lens)
        gen_s.append(time.perf_counter() - t0)
        waits = dc.waits - waits
    info["generate_s"] = " ".join(f"{t:.3f}" for t in gen_s)
    # host waits of one generate: one a chunk (its hit total), two at the
    # end (the kept count, the copy)
    info["host_waits"] = f"{waits} for {len(chunks)} chunks"
    if cuda and waits != len(chunks) + 2:
        raise AssertionError(f"generate waited {waits} times on "
                             f"{len(chunks)} chunks")
    eng = NativeEngine(packed, k)
    set_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        eng.set_candidates(n, *out)
        set_s.append(time.perf_counter() - t0)
    info["set_candidates_s"] = " ".join(f"{t:.3f}" for t in set_s)

    # end to end: the genotyper with pruning in a child process, every
    # output, _assign.tsv included, equal to main's native route's; the
    # unpruned card route is main's (in process)
    pruned, launches, metrics, secs = genotype_child(
        dev, work, "cand_pruned_a", ["--deviceCandidates"])
    same_files(os.path.join(work, "native"), pruned,
               ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                "_aligned_2.fa", "_assign.tsv"), "the pruned genotyper")
    with open(os.path.join(work, "port_metrics.json")) as f:
        runs = {"main_port": json.load(f), "cand_pruned_a": metrics}
    ra = metrics["read_assignment"]
    # the pruned route runs the census and bucket chain kernels and no
    # dense chain tile (the genotyper runs no screen)
    if cuda and (min(launches[kn] for kn in (
            "phase_a_probe", "cand_census", "cand_chain", "band_stats",
            "em_squarem")) <= 0 or launches["phase_a_chain"] != 0):
        raise AssertionError(f"the pruned route's launches: {launches}")
    if ra["device_decided_reads"] <= 0:
        raise AssertionError("the card decided no read of the genotyper")
    for name, m in runs.items():
        info[f"{name}_read_assignment_s"] = m["read_assignment"]["seconds"]
    info["cand_pruned_a_process_s"] = f"{secs:.2f}"
    info["cand_pruned_a_candidate_s"] = ra["candidate_seconds"]
    info["pruned_decided_reads"] = ra["device_decided_reads"]
    info["pruned_candidates"] = ra["candidate_count"]
    info["pruned_launches"] = " ".join(f"{kn}:{v}"
                                       for kn, v in launches.items())

    # K10 on the chunk with the most hits: each kernel against its plain
    # version on the same inputs (the plain versions on the card's
    # tensors), then each piece alone
    big = max((c for c in chunks if c["hits"] <= dc.hit_cap),
              key=lambda c: c["hits"])
    lo, hi, total = big["lo"], big["hi"], big["hits"]
    idx = dc.index
    codes_d = torch.from_numpy(codes[lo:hi]).to(dev)
    lens_d = torch.from_numpy(lens[lo:hi]).to(dev)
    contrib, cstart, row_hits = pa.probe(codes_d, lens_d, idx)
    kw = dict(k=k, n_seqs=idx.n_seqs, radius=dc.radius,
              hit_len_required=hlr, bucket_cap=dc.bucket_cap)
    size = total // pa.min_chain_seeds(k, hlr)
    census = pa.bucket_census(contrib, cstart, total, idx)
    keep, over = pa.chain_buckets(census, lens_d, **kw)
    t0 = time.perf_counter()
    want = census_arrays(pa.bucket_census_plain(contrib, cstart, total, idx))
    for bins in (None, FORCED_BINS):
        got = census_arrays(pa.bucket_census(contrib, cstart, total, idx,
                                             bins_per_pass=bins))
        if got[0] != want[0] or not all(torch.equal(g, w) for g, w in
                                        zip(got[1:], want[1:])):
            raise AssertionError(f"census kernel (keys a pass {bins}) "
                                 "differs from the plain census")
    plain_keep, plain_over = pa.chain_buckets_plain(census, lens_d, **kw)
    if not (torch.equal(keep, plain_keep) and torch.equal(over, plain_over)):
        raise AssertionError("bucket chain kernel differs from the plain "
                             "chain")
    keys, nb_dev, _ = dc.chunk(contrib, cstart, total, lens_d)
    keys = keys[keys >= 0].cpu()
    if not torch.equal(keys.long(), tiles_chunk(contrib, cstart, total,
                                                lens_d, dc)):
        raise AssertionError("K10 chunk: kept keys differ from the tile "
                             "route's")
    info["k10_check_s"] = f"{time.perf_counter() - t0:.1f}"
    if cuda:  # the chunk waits on nothing: any implicit sync raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            dc.chunk(contrib, cstart, total, lens_d)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the census's tail: the chunk's read with the most hits alone
    r_max = int(row_hits.argmax())
    one = (contrib[r_max:r_max + 1], cstart[r_max:r_max + 1],
           int(row_hits[r_max]))
    reps = 10 if cuda else 1
    ms = dict(census=time_ms(lambda: pa.bucket_census(contrib, cstart,
                                                      total, idx), reps, dev),
              census_forced=time_ms(lambda: pa.bucket_census(
                  contrib, cstart, total, idx, bins_per_pass=FORCED_BINS),
                  3, dev),
              census_largest_read=time_ms(lambda: pa.bucket_census(
                  *one, idx), reps, dev),
              chain=time_ms(lambda: pa.chain_buckets(census, lens_d, **kw),
                            reps, dev),
              keep=time_ms(lambda: pa.kept_keys(census.key, keep, size),
                           reps, dev),
              chunk=time_ms(lambda: dc.chunk(contrib, cstart, total, lens_d),
                            reps, dev),
              tiles_route=time_ms(lambda: tiles_chunk(contrib, cstart, total,
                                                      lens_d, dc), 3, dev))
    plain = dict(census=time_ms(lambda: pa.bucket_census_plain(
                     contrib, cstart, total, idx), 1, dev),
                 chain=time_ms(lambda: pa.chain_buckets_plain(
                     census, lens_d, **kw), 1, dev))
    nb = int(nb_dev)
    cnt = census.count[:nb].cpu().numpy()
    cnt = cnt[(cnt >= pa.min_chain_seeds(k, hlr)) & (cnt <= dc.bucket_cap)]
    b_census, b_chain, b_chunk = k10_bounds(contrib, total, nb, cnt,
                                            len(keys))
    for key, v in ms.items():
        info[f"k10_{key}_ms"] = f"{v:.4f}"
    for key, v in plain.items():
        info[f"k10_{key}_plain_ms"] = f"{v:.1f}"
    info["k10_chunk"] = f"{lo}-{hi}"
    info["k10_chunk_hits"] = total
    info["k10_read_hits"] = (f"median:{int(row_hits.median())} "
                             f"max:{int(row_hits.max())}")
    info["k10_buckets"] = nb
    info["k10_chained"] = len(cnt)
    info["k10_chained_seeds"] = (f"median:{int(np.median(cnt))} p90:"
                                 f"{int(np.percentile(cnt, 90))} "
                                 f"max:{int(cnt.max())}")
    info["k10_kept"] = len(keys)
    info["k10_forced_bins"] = FORCED_BINS
    for name, b in (("census", b_census), ("chain", b_chain),
                    ("chunk", b_chunk)):
        info[f"k10_{name}_bound_ms"] = f"{b[0]:.4f} ({b[1]})"
    common = dict(max_abs_err=0, chunk_hits=total, chunk_buckets=nb,
                  chunk_ms=ms["chunk"], chunk_bound_ms=b_chunk[0],
                  tiles_route_ms=ms["tiles_route"],
                  host_waits_per_chunk=(waits - 2 * cuda) / len(chunks),
                  generate_s=float(np.mean(gen_s)),
                  read_assignment_s={
                      name: m["read_assignment"]["seconds"]
                      for name, m in runs.items()})
    return {"cand_census": (
                (ms["census"], plain["census"], b_census),
                launches["cand_census"],
                dict(common, forced_ms=ms["census_forced"],
                     forced_bins=FORCED_BINS,
                     largest_read_ms=ms["census_largest_read"])),
            "device_candidates": (
                (ms["chain"], plain["chain"], b_chain),
                launches["cand_chain"],
                dict(common, keep_ms=ms["keep"], chained=len(cnt),
                     kept=len(keys), launches_probe=launches["phase_a_probe"],
                     set_candidates_s=float(np.mean(set_s)),
                     decided_share=n_decided / n))}


def thread_slots(t_len: int, p_len: int, ml: int) -> int:
    """Register slots one item needs in the thread kernels (band_stats.cu
    item_slots): the window cells from the column-0 cell left of the band
    to the row-0 cell right of it."""
    diff = t_len - p_len
    base = max(ml - 5 - max(-diff, 0) - 1, 0)
    return max(min(ml + 5 + max(diff, 0) + 1, 31) - base + 1, 1)


def launch_warps(t_len, p_len, ml: int = 15):
    """The thread kernels' warps (band_stats.cu item_bin): the narrow
    items (at most 13 slots), then the wide ones, each run longest p_len
    first.  Returns each warp's rows (its longest p_len) and slot count
    (13 narrow, else 24 or 32 as the warp's widest item needs)."""
    need = np.array([thread_slots(int(t), int(p), ml)
                     for t, p in zip(t_len, p_len)])
    rows, slots = [], []
    for part in (need <= 13, need > 13):
        order = np.argsort(-np.minimum(p_len[part], 255), kind="stable")
        pad = -len(order) % 32
        rows.append(np.concatenate([p_len[part][order], np.zeros(
            pad, np.int64)]).reshape(-1, 32).max(1))
        widest = np.concatenate([need[part][order], np.zeros(
            pad, np.int64)]).reshape(-1, 32).max(1)
        slots.append(np.where(widest <= 13, 13,
                              np.where(widest <= 24, 24, 32)))
    return np.concatenate(rows), np.concatenate(slots)


def recording_service():
    """A DeferredDescService class that keeps, on the class, the largest
    batch of deferred items any of its instances was sent: [ref, reads,
    int64 [4, n] descriptors] with the resident reference and read
    tensors that batch was scored against."""
    from t1k_tpu_torch.ops import align_band as ab

    class Recorder(ab.DeferredDescService):
        largest = None

        def stats_async(self, t_off, t_len, p_off, p_len):
            cls = type(self)
            if cls.largest is None or len(t_len) > cls.largest[2].shape[1]:
                cls.largest = [self._ref, self._reads, np.stack(
                    [np.asarray(x, np.int64) for x in (t_off, t_len, p_off,
                                                       p_len)])]
            return super().stats_async(t_off, t_len, p_off, p_len)

    return Recorder


def thread_timeline(fn, reps: int) -> dict:
    """Means over `reps` calls of a thread-path wrapper, from
    torch.profiler's kernel records: microseconds from the wide kernel's
    start to the narrow kernel's (negative: the narrow one first), the
    two kernels' time together and their span from the first start to
    the last end, each kernel's time, and the calls whose narrow kernel
    started first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    runs = {"thread_wide": [], "thread_narrow": []}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        for key, spans in runs.items():
            if key in ev.name:
                spans.append((ev.time_range.start, ev.time_range.end))
    wide, narrow = (sorted(v) for v in runs.values())
    if len(wide) != len(narrow) or not wide:
        return {"kept": [len(wide), len(narrow)]}
    pairs = list(zip(wide, narrow))
    return dict(
        calls=len(pairs),
        narrow_after_wide_us=float(np.mean([n[0] - w[0] for w, n in pairs])),
        together_us=float(np.mean([max(0, min(w[1], n[1]) - max(w[0], n[0]))
                                   for w, n in pairs])),
        span_us=float(np.mean([max(w[1], n[1]) - min(w[0], n[0])
                               for w, n in pairs])),
        wide_us=float(np.mean([w[1] - w[0] for w, _ in pairs])),
        narrow_us=float(np.mean([n[1] - n[0] for _, n in pairs])),
        narrow_first=int(sum(n[0] < w[0] for w, n in pairs)))


def streams_line(info: dict, thread) -> None:
    """The thread kernels' two streams over 20 calls (thread_timeline):
    the narrow kernel's start after the wide one's, their time together
    and their span, in microseconds; a launch's time beyond the sort and
    the span is the streams' hand-offs."""
    tl = thread_timeline(thread, 20)
    for key in ("narrow_after_wide_us", "together_us", "span_us"):
        info[key] = f"{tl[key]:.1f}" if key in tl else "n/a"


def main_path_chunk(dev, work: str, n_reads: int):
    """The largest batch of deferred items one engine chunk sends when the
    first `n_reads` reads of <work>/r_1.fq meet <work>/panel.fa: the
    reference and read tensors it was scored against, and its int64
    [4, n] descriptors on the host."""
    from t1k_tpu_torch.core import pipeline as tp

    rec = recording_service()(dev)
    seqs = [r.seq for r in tp.read_seq_files([os.path.join(work, "r_1.fq")])]
    refset = tp.RefSet.from_fasta(os.path.join(work, "panel.fa"))
    engine = tp.NativeEngine(refset.packed(), tp.GENOTYPER_KMER_LENGTH)
    tp.assign_unique_reads(engine, seqs[:n_reads], "gpu", rec,
                           store_results=False,
                           defer_chunk=tp.GenotypeOptions().defer_chunk)
    return rec.largest


def phase_timing(dev, check: Checker, check_warp: Checker,
                 check_group: Checker, work: str, n_reads: int, info: dict):
    """Thread kernels, warp kernel, the lane-group kernel (forced at W =
    32 at its rule's CPL, for the record: the route is the thread
    kernels') and plain version, in turns (plain, thread, warp, group,
    thread, warp, group, plain), on the largest batch of deferred items
    one engine chunk of the main path sends; each kernel alone by
    torch.profiler, and how the narrow and wide kernels overlapped
    (streams_line).  Prints the chunk's shape: p_len and |t_len - p_len|
    quantiles, the row use of the sorted launch and the warps' slot
    counts.  Returns ((thread ms, plain ms, bound), (warp ms, plain ms,
    bound), group ms)."""
    import torch

    from t1k_tpu_torch.ops import align_band as ab

    ref, reads, desc = main_path_chunk(dev, work, n_reads)
    d = torch.from_numpy(desc).to(dev)
    args = (ref, reads, d, ab.DESC_ML, ab.DESC_W)
    warp = warp_kernel(dev)
    group = group_kernel(dev, max_slots=32)

    def thread():
        return ab.band_stats(*args)

    def warp_fn():
        return warp(*args)

    def group_fn():
        return group(*args)

    def plain():
        return ab.band_stats_plain(*args)

    want = plain()
    check(thread(), want, "main-path chunk")
    check_warp(warp_fn(), want, "main-path chunk (warp)")
    check_group(group_fn(), want, "main-path chunk (group)")
    cuda = dev.type == "cuda"  # CPU rehearsals: one call each
    plain_ms = [time_ms(plain, 3 if cuda else 1, dev)]
    thread_ms, warp_ms, group_ms = [], [], []
    for _ in range(2):
        thread_ms.append(time_ms(thread, 50 if cuda else 1, dev))
        warp_ms.append(time_ms(warp_fn, 20 if cuda else 1, dev))
        group_ms.append(time_ms(group_fn, 20 if cuda else 1, dev))
    plain_ms.append(time_ms(plain, 3 if cuda else 1, dev))
    if cuda:  # each kernel alone, without the wrapper
        for name in ("thread_narrow", "thread_wide", "sort_",
                     "band_warp_kernel", "group_kernel"):
            fn = (warp_fn if "warp" in name else
                  group_fn if "group" in name else thread)
            info[f"{name.strip('_')}_us"] = call_us(fn, name, 20)
        streams_line(info, thread)
    t_len, p_len = desc[1], desc[3]
    diff = np.abs(t_len - p_len)
    q = (0, 0.5, 0.9, 0.99, 1)
    info["items"] = int(d.shape[1])
    info["p_len_q"] = ",".join(str(int(v)) for v in np.quantile(p_len, q))
    info["absdiff_q"] = ",".join(str(int(v)) for v in np.quantile(diff, q))
    rows, slots = launch_warps(t_len, p_len)
    info["row_use"] = f"{p_len.sum() / (32 * rows.sum()):.4f}"
    info["warp_slots"] = " ".join(
        f"{c}:{int((slots == c).sum())}" for c in (13, 24, 32))
    info["thread_ms"] = " ".join(f"{t:.4f}" for t in thread_ms)
    info["warp_ms"] = " ".join(f"{t:.4f}" for t in warp_ms)
    info["group_ms"] = " ".join(f"{t:.4f}" for t in group_ms)
    info["plain_ms"] = " ".join(f"{t:.2f}" for t in plain_ms)
    # descriptors in (4 x int64), scores and packed counts out (2 x int32)
    b = dp_bound(t_len, p_len, 40 * d.shape[1])
    info["bound_ms"] = f"{b[0]:.4f}"
    info["bound_scores_only_ms"] = \
        f"{dp_bound(t_len, p_len, 40 * d.shape[1], stats=False)[0]:.4f}"
    return ((float(np.mean(thread_ms)), float(np.mean(plain_ms)), b),
            (float(np.mean(warp_ms)), float(np.mean(plain_ms)), b),
            float(np.mean(group_ms)))


# ------------------------------------------------------------- v1 aligner

def seeded_v1_pairs(n: int, rng):
    """Reads of 100-150 bp against panel-like windows of read length +-10
    (one pair in eight against a window of up to 512 bp), cut from one
    random reference with 0.2% N; the reads carry 5% substitutions and a
    shift of up to 3 bases, so the alignments open gaps."""
    lt, lp = 512, 150
    ref = rng.integers(0, 4, 2_000_000).astype(np.int8)
    ref[rng.random(ref.size) < 0.002] = 4
    p_len = rng.integers(100, lp + 1, n).astype(np.int32)
    long = rng.random(n) < 0.125
    t_len = np.where(long, rng.integers(p_len, lt + 1),
                     np.clip(p_len + rng.integers(-10, 11, n), 1, lt))
    t_len = t_len.astype(np.int32)
    t_off = rng.integers(8, ref.size - lt - 8, n)
    tc = ref[t_off[:, None] + np.arange(lt)[None, :]]
    shift = rng.integers(-3, 4, n)
    pc = ref[(t_off + shift)[:, None] + np.arange(lp)[None, :]].copy()
    mut = rng.random(pc.shape) < 0.05
    pc[mut] = rng.integers(0, 5, int(mut.sum()))
    return tc, t_len, pc, p_len


def ring_v1_pairs(n: int, rng):
    """A small mixed batch that puts pairs on every path of the v1 launch:
    reads of 100-150 bp against windows of read length +-10 (thread),
    +20-499 (tile) and +500-2,000 (ring), a quarter, a quarter and a half,
    shuffled, cut from one random reference with 0.2% N."""
    lp = 150
    lt = lp + 2000
    ref = rng.integers(0, 4, 400_000).astype(np.int8)
    ref[rng.random(ref.size) < 0.002] = 4
    p_len = rng.integers(100, lp + 1, n).astype(np.int32)
    kind = rng.permutation(np.arange(n) % 4)
    diff = np.where(kind == 0, rng.integers(-10, 11, n),
                    np.where(kind == 1, rng.integers(20, 500, n),
                             rng.integers(500, 2001, n)))
    t_len = (p_len + diff).astype(np.int32)
    t_off = rng.integers(8, ref.size - lt - 8, n)
    tc = ref[t_off[:, None] + np.arange(lt)[None, :]]
    pc = ref[(t_off + rng.integers(-3, 4, n))[:, None]
             + np.arange(lp)[None, :]].copy()
    mut = rng.random(pc.shape) < 0.05
    pc[mut] = rng.integers(0, 5, int(mut.sum()))
    return tc, t_len, pc, p_len


V1_RING_PAIRS = 512


def v1_bound(tc, tl, pc, pl):
    """The v1 aligner's bound over pairs: the padded windows it is given
    read once, lens in and scores out, DP_OPS_PER_CELL per band cell."""
    return bound(tc.nbytes + pc.nbytes + 12 * len(tl),
                 DP_OPS_PER_CELL * int((pl.astype(np.int64) * (
                     11 + np.abs(tl.astype(np.int64) - pl))).sum()),
                 int32_per_s())


def v1_rows(tl, pl):
    """Band cells and register slot-rows of the thread-path and tile-path
    pairs: each pair's rows times the slots of the smallest class that
    holds its v1_slots (a thread-path warp runs its largest pair's)."""
    from t1k_tpu_torch.ops import align as v1

    slots = v1.v1_slots(tl, pl)
    rows = np.where(np.asarray(tl) == 0, 0, np.asarray(pl, np.int64))
    cells = rows * (slots - 2)
    ns = np.asarray(v1.THREAD_NS)
    tile = 32 * np.asarray(v1.TILE_CPL)
    narrow = slots <= v1.THREAD_SLOTS
    wide = ~narrow & (slots <= v1.TILE_SLOTS)
    return (int(cells[narrow].sum()), int(cells[wide].sum()),
            int((rows * ns[np.searchsorted(ns, np.minimum(
                slots, ns[-1]))])[narrow].sum()),
            int((rows * tile[np.searchsorted(tile, np.minimum(
                slots, tile[-1]))])[wide].sum()))


def phase_v1(dev, check: Checker, n_pairs: int, info: dict):
    """The v1 launch (thread, tile and ring paths) on the goldens, the
    seeded pairs and a small batch with ring pairs, exact against the
    plain version; the first port's ring kernel on every pair, the narrow
    (thread-path) and wide (tile-path) subsets and the plain version
    timed in turns.  Returns (launches per path over the seeded and ring
    batches, (launch ms, plain ms, bound), extras for the kernels
    line)."""
    import torch

    from t1k_tpu_torch.ops import align as v1
    from t1k_tpu_torch.ops import align_band as ab

    cuda = dev.type == "cuda"

    def launch(args):
        if cuda:
            return v1.banded_scores_cuda(*args)
        return v1.banded_scores_plain(*args)  # CPU rehearsal

    def ring_launch(args, max_diff):
        if cuda:
            return v1.banded_scores_ring_cuda(*args, max_diff)
        return v1.banded_scores_plain(*args)

    def batch(tc, tl, pc, pl):
        args = v1._as_tensors(tc, tl, pc, pl, dev)
        return (args, v1.v1_plan(tl, pl), int(np.abs(tl - pl).max()),
                v1.banded_scores_plain(*args))

    tc, tl, pc, pl, want = golden_windows()
    args, plan, max_diff, plain = batch(tc, tl, pc, pl)
    for what, got in (("v1 golden", launch(args)),
                      ("v1 golden ring kernel", ring_launch(args, max_diff))):
        if not (got.cpu().numpy() == want).all():
            raise AssertionError(f"{what} differs from the golden table")
        check(got.cpu(), plain.cpu(), what)

    tc, tl, pc, pl = seeded_v1_pairs(n_pairs, np.random.default_rng(2026))
    args, plan, max_diff, plain = batch(tc, tl, pc, pl)
    rtc, rtl, rpc, rpl = ring_v1_pairs(V1_RING_PAIRS,
                                       np.random.default_rng(2027))
    rargs, rplan, rmax_diff, rplain = batch(rtc, rtl, rpc, rpl)
    if plan.n_ring or min(rplan) == 0:
        raise AssertionError(f"v1 batches miss their paths: {plan} {rplan}")
    v1.launch_counts.update(dict.fromkeys(v1.PATHS, 0))
    v1.path_pairs.update(dict.fromkeys(v1.PATHS, 0))
    scores = v1.banded_scores_full(tc, tl, pc, pl, device=dev)
    ring_scores = v1.banded_scores_full(rtc, rtl, rpc, rpl, device=dev)
    launches, pairs = dict(v1.launch_counts), dict(v1.path_pairs)
    # the card's sort against the slot rule's mirror (v1_plan): the same
    # pairs on each path; both register paths launch with each batch, the
    # ring path with the one that has ring pairs
    want_pairs = {path: plan[k] + rplan[k] for k, path in enumerate(v1.PATHS)}
    want_launches = {"align_full_thread": 2, "align_full_tile": 2,
                     "align_full_ring": 1}
    if cuda and (pairs, launches) != (want_pairs, want_launches):
        raise AssertionError(f"v1 pairs {pairs} and launches {launches} "
                             f"per path, the slot rule's {want_pairs} and "
                             f"{want_launches}")
    check(torch.from_numpy(scores), plain.cpu(), "v1 seeded")
    check(torch.from_numpy(ring_scores), rplain.cpu(), "v1 ring batch")
    check(ring_launch(rargs, rmax_diff).cpu(), rplain.cpu(),
          "v1 ring batch, ring kernel")
    check(ring_launch(args, max_diff).cpu(), plain.cpu(),
          "v1 seeded, ring kernel")
    fit = np.abs(tl - pl) <= ab.DEFER_MAX_DIFF
    band = ab.banded_scores_band(tc[fit], tl[fit], pc[fit], pl[fit],
                                 device=dev)
    if not (band == scores[fit]).all():
        raise AssertionError("v1 and band kernels disagree")

    # the narrow (thread-path) and wide (tile-path) pairs alone
    narrow = v1.v1_slots(tl, pl) <= v1.THREAD_SLOTS
    subsets = {}
    for name, sel in (("narrow", narrow), ("wide", ~narrow)):
        sub = batch(tc[sel], tl[sel], pc[sel], pl[sel])
        check(launch(sub[0]).cpu(), sub[3].cpu(), f"v1 {name}")
        subsets[name] = (sub, v1_bound(tc[sel], tl[sel], pc[sel], pl[sel]))

    fns = {"launch": lambda: launch(args),
           "ring_kernel": lambda: ring_launch(args, max_diff),
           "narrow": lambda: launch(subsets["narrow"][0][0]),
           "wide": lambda: launch(subsets["wide"][0][0])}
    times = {k: [] for k in fns}
    plain_ms = [time_ms(lambda: v1.banded_scores_plain(*args), 1, dev)]
    for _ in range(2):
        for k, fn in fns.items():
            times[k].append(time_ms(fn, 20, dev))
    plain_ms.append(time_ms(lambda: v1.banded_scores_plain(*args), 1, dev))
    b = v1_bound(tc, tl, pc, pl)
    info["golden"] = len(want)
    info["pairs"] = n_pairs
    info["paths"] = "/".join(map(str, plan))
    info["ring_batch_paths"] = "/".join(map(str, rplan))
    info["band_checked"] = int(fit.sum())
    info["cells_thread_tile"], info["slot_rows_thread_tile"] = (
        f"{x}/{y}" for x, y in np.reshape(v1_rows(tl, pl), (2, 2)))
    info["launches"] = " ".join(f"{k}={v}" for k, v in launches.items())
    for k, v in times.items():
        info[f"{k}_ms"] = " ".join(f"{t:.4f}" for t in v)
    info["plain_ms"] = " ".join(f"{t:.2f}" for t in plain_ms)
    info["bound_ms"] = f"{b[0]:.4f}"
    for name, (_, sb) in subsets.items():
        info[f"{name}_bound_ms"] = f"{sb[0]:.4f}"
    mean = {k: float(np.mean(v)) for k, v in times.items()}
    info["bound_share"] = f"{b[0] / mean['launch']:.4f}"
    extras = {"launches_by_path": launches, "pairs_by_path": pairs,
              "ring_kernel_ms": mean["ring_kernel"],
              "narrow_ms": mean["narrow"], "wide_ms": mean["wide"],
              "narrow_bound_ms": subsets["narrow"][1][0],
              "wide_bound_ms": subsets["wide"][1][0]}
    return launches, (mean["launch"], float(np.mean(plain_ms)), b), extras


# --------------------------------------------------------- phase-A screen
# Seeded panels and reads of tests/test_phase_a.py, copied.

BASES = "ACGT"


def rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def mutate(rng, s, rate=0.05, n_rate=0.2):
    out = list(s)
    for i in range(len(out)):
        r = rng.random()
        if r < rate:
            out[i] = BASES[rng.integers(0, 4)]
        elif r < rate * (1 + n_rate):
            out[i] = "N"
    return "".join(out)


def revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(s))


def make_reads(rng, seqs, n):
    reads = []
    for _ in range(n):
        kind = rng.integers(0, 6)
        s = seqs[rng.integers(0, len(seqs))]
        if kind == 0:
            reads.append(rand_seq(rng, int(rng.integers(30, 150))))
        elif kind == 1:
            st = rng.integers(0, max(1, len(s) - 100))
            reads.append(mutate(rng, s[st:st + 100], rng.random() * 0.2))
        elif kind == 2:
            st = rng.integers(0, max(1, len(s) - 100))
            reads.append(revcomp(mutate(rng, s[st:st + 100],
                                        rng.random() * 0.1)))
        elif kind == 3 and len(s) > 250:
            reads.append(mutate(rng, s[:60] + s[-60:], 0.02))
        elif kind == 4:
            reads.append("A" * int(rng.integers(5, 40)))  # code-0 quirk
        else:
            st = rng.integers(0, max(1, len(s) - 60))
            reads.append(mutate(rng, s[st:st + 60], 0.05))
    return reads


def screen_cases():
    """(name, seqs, reads, k, hit_len, sim, caps) of the seeded cases."""
    cases = []
    for trial in range(4):
        rng = np.random.default_rng(500 + trial)
        base = rand_seq(rng, int(rng.integers(300, 700)))
        seqs = []
        for _ in range(int(rng.integers(3, 25))):
            if rng.random() < 0.7:
                seqs.append(mutate(rng, base, 0.03).replace("N", "A"))
            else:
                seqs.append(rand_seq(rng, int(rng.integers(200, 600))))
        cases.append((f"random{trial}", seqs, make_reads(rng, seqs, 60), 9,
                      23, [0.8, 0.9, 0.97][trial % 3], dict(bucket_cap=128)))
    rng = np.random.default_rng(77)
    base = rand_seq(rng, 500)
    seqs = [mutate(rng, base, 0.01).replace("N", "C") for _ in range(120)]
    cases.append(("skip", seqs, make_reads(rng, seqs, 50), 9, 23, 0.8,
                  dict(bucket_cap=256)))
    rng = np.random.default_rng(91)
    motif = rand_seq(rng, 25)
    seqs = [rand_seq(rng, 40) + motif * int(rng.integers(3, 7))
            + rand_seq(rng, 60) + motif + rand_seq(rng, 40)
            for _ in range(10)]
    cases.append(("repeats", seqs, make_reads(rng, seqs, 50), 9, 23, 0.8,
                  dict(bucket_cap=128)))
    base = rand_seq(rng, 600)
    seqs = [mutate(rng, base, 0.02).replace("N", "G") for _ in range(15)]
    cases.append(("hashed13", seqs, make_reads(rng, seqs, 40), 13, 23, 0.9,
                  dict(bucket_cap=128)))
    rng = np.random.default_rng(13)
    seqs = [rand_seq(rng, 300)]
    cases.append(("edges", seqs, ["ACGT", seqs[0][:9], "N" * 50, "A" * 9,
                                  seqs[0][10:19]], 9, 9, 0.8,
                  dict(bucket_cap=128)))
    rng = np.random.default_rng(5)
    base = rand_seq(rng, 400)
    seqs = [mutate(rng, base, 0.005).replace("N", "T") for _ in range(110)]
    cases.append(("overflow", seqs,
                  [mutate(rng, base[:100], 0.01) for _ in range(8)], 9, 23,
                  0.8, dict(hit_cap=256, bucket_cap=32)))
    return cases


def pad_reads(reads):
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.int8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode(r)
    return codes, lens


def phase_screen(dev, info: dict) -> None:
    from t1k_tpu_torch.core import extractor as tx
    from t1k_tpu_torch.ops import phase_a as pa

    decided = screened = 0
    for name, seqs, reads, k, hlr, sim, caps in screen_cases():
        rs = tx.RefSet(digit_units=-1, delimiter="")
        for i, s in enumerate(seqs):
            rs.add_allele(f"G{i % 3}*{i:03d}", s, None)
        packed = rs.packed()
        codes, lens = pad_reads(reads)
        gv, gd = pa.DeviceScreen.build(packed, k, hlr, sim, device=dev,
                                       **caps).screen(codes, lens)
        cv, cd = pa.DeviceScreen.build(packed, k, hlr, sim, device="cpu",
                                       **caps).screen(codes, lens)
        if not (gd == cd).all() or not (gv[gd] == cv[gd]).all():
            raise AssertionError(f"screen {name}: card differs from plain")
        eng = tx.NativeEngine(packed, k, ref_seq_similarity=sim,
                              hit_len_required=hlr)
        starts = np.zeros(len(lens), np.int64)
        starts[1:] = np.cumsum(lens[:-1])
        flags = eng.screen_batch(np.concatenate([encode(r) for r in reads]),
                                 starts, lens).astype(bool)
        if not (gv[gd] == flags[gd]).all():
            raise AssertionError(f"screen {name}: card differs from the "
                                 "native engine")
        if name == "overflow" and gd.any():
            raise AssertionError("overflowing reads were decided")
        decided += int(gd.sum())
        screened += len(reads)
    info["cases"] = len(screen_cases())
    info["reads"] = screened
    info["decided"] = decided


EDGE_LENGTHS = (13, 44, 45, 76, 100, 150, 4095)   # 4095: MAX_READ_LEN - 1
EDGE_WIDTHS = (0, 1, 31, 32, 33, 63, 64, 65, 128, 512)


def edge_tiles(rng, B: int = 512):
    """Seed tiles at the chain kernel's edges: rows of EDGE_WIDTHS seeds,
    random, clustered on a few diagonals, tandem-repeat chains (repeated
    b), and seeds that all share one diagonal, shuffled within the row.
    Returns a, b int32 [NR, B], nb, lens, budgets int32 [NR]."""
    rows = []
    for nb in EDGE_WIDTHS:
        for kind in range(4):
            a = np.sort(rng.choice(4000, nb, replace=False))
            if kind == 0:
                b = rng.integers(0, 1 << 20, nb)
            elif kind == 1:
                diag = rng.integers(-3000, 3000, 3)[rng.integers(0, 3, nb)]
                b = a + 5000 + diag + rng.integers(-4, 5, nb)
            elif kind == 2:
                b = a + 700 + 25 * rng.integers(0, 3, nb)
            else:
                b = a + 1234
            rows.append((a, np.maximum(b, 0)))
    at = np.zeros((len(rows), B), np.int32)
    bt = np.zeros((len(rows), B), np.int32)
    nb = np.zeros(len(rows), np.int32)
    for r, (a, b) in enumerate(rows):
        perm = rng.permutation(len(a))
        at[r, :len(a)], bt[r, :len(a)], nb[r] = a[perm], b[perm], len(a)
    lens = rng.integers(100, 4096, len(rows)).astype(np.int32)
    budgets = rng.integers(0, 600, len(rows)).astype(np.int32)
    return at, bt, nb, lens, budgets


def phase_screen_edges(dev, check_probe: Checker, check_chain: Checker,
                       info: dict) -> None:
    """The warp kernels at their edges, each against its plain version on
    the same device: the probe on reads of EDGE_LENGTHS for k = 12 (direct
    table) and k = 13 (hashed), batch by batch so each length sets the
    padded width (the screen of the same reads is held against the native
    engine too); the chain on edge_tiles at radius 10 and 0."""
    import torch

    from t1k_tpu_torch.core import extractor as tx
    from t1k_tpu_torch.ops import phase_a as pa

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(4242)
    base = rand_seq(rng, 4600)
    seqs = [mutate(rng, base, 0.01).replace("N", "A") for _ in range(6)]
    seqs += [rand_seq(rng, 4600) for _ in range(2)]
    rs = tx.RefSet(digit_units=-1, delimiter="")
    for i, s in enumerate(seqs):
        rs.add_allele(f"G{i % 3}*{i:03d}", s, None)
    packed = rs.packed()
    n_reads = 0
    for k in (12, 13):
        index = pa.PhaseAIndex.build(packed, k, dev)
        if index.direct != (k <= 12):
            raise AssertionError(f"k={k}: wrong table form")
        plain_index = pa.PhaseAIndex.build(packed, k, "cpu")
        card = pa.DeviceScreen(index, 23, 0.8)
        host = pa.DeviceScreen(plain_index, 23, 0.8)
        eng = tx.NativeEngine(packed, k, ref_seq_similarity=0.8,
                              hit_len_required=23)
        for L in EDGE_LENGTHS:
            reads = []
            for i in range(40):
                st = int(rng.integers(0, len(base) - L + 1))
                r = mutate(rng, seqs[i % 8][st:st + L], 0.02)
                reads.append(revcomp(r) if i % 3 == 0 else
                             r[:int(rng.integers(k, L + 1))] if i % 3 == 1
                             else r)
            codes, lens = pad_reads(reads)
            codes_d = torch.from_numpy(codes).to(dev)
            lens_d = torch.from_numpy(lens).to(dev)
            got = (pa.probe_cuda if cuda else pa.probe_plain)(
                codes_d, lens_d, index)
            want = pa.probe_plain(torch.from_numpy(codes),
                                  torch.from_numpy(lens), plain_index)
            for g, w in zip(got, want):
                check_probe(g.cpu(), w, f"probe k={k} L={L}")
            gv, gd = card.screen(codes, lens)
            cv, cd = host.screen(codes, lens)
            starts = np.zeros(len(lens), np.int64)
            starts[1:] = np.cumsum(lens[:-1])
            flags = eng.screen_batch(
                np.concatenate([encode(r) for r in reads]), starts,
                lens).astype(bool)
            if not ((gd == cd).all() and (gv[gd] == cv[gd]).all()
                    and (gv[gd] == flags[gd]).all()):
                raise AssertionError(f"screen k={k} L={L}: card, plain and "
                                     "native engine disagree")
            n_reads += len(reads)
    rows = 0
    for k in (9, 13):
        tiles = edge_tiles(np.random.default_rng(k))
        t_dev = [torch.from_numpy(x).to(dev) for x in tiles]
        t_cpu = [torch.from_numpy(x) for x in tiles]
        for radius in (10, 0):
            for hlr in (23, 60):
                kw = dict(k=k, radius=radius, hit_len_required=hlr)
                core, budget = pa.chain_rows_plain(*t_cpu, **kw)
                want = torch.stack([(core & budget).any(dim=1),
                                    core.any(dim=1)]).to(torch.int32)
                got = (pa.chain_rows_cuda if cuda else pa.chain_rows)(
                    *t_dev, **kw)
                check_chain(got.cpu(), want, f"chain tiles {kw}")
                rows += len(tiles[2])
    info["edge_reads"] = n_reads
    info["edge_rows"] = rows


# ------------------------------------------------------------- extraction

def write_fastq(path: str, names, seqs: np.ndarray, quals: np.ndarray):
    """Records from [n, L] ASCII byte arrays."""
    with open(path, "wb") as f:
        for name, s, q in zip(names, seqs, quals):
            f.write(b"@%s\n%s\n+\n%s\n" % (name, s.tobytes(), q.tobytes()))


def read_fastq_seqs(path: str, n: int):
    seqs = []
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                seqs.append(line.rstrip(b"\n"))
                if len(seqs) == n:
                    break
    return seqs


# base codes of the complements of A, C, G, T, N
_COMP = np.array([3, 2, 1, 0, 4], np.int8)


def off_panel_pairs(rng, panel: str, n_near: int, n_rand: int):
    """(near1, near2, rand1, rand2), [n, READ_LEN] base codes in
    sequencing orientation: near-miss pairs cut from `panel`'s alleles
    (fragments of 200-350 bp) with 25-35% substitutions, and uniform
    random pairs, 1% of them low-complexity or N-rich."""
    alleles = [encode(r[2]) for r in read_fasta(panel)]
    ai = rng.integers(0, len(alleles), n_near)
    flen = rng.integers(200, 351, n_near)
    n1 = np.empty((n_near, READ_LEN), np.int8)
    n2 = np.empty((n_near, READ_LEN), np.int8)
    for i in range(n_near):
        a = alleles[ai[i]]
        st = int(rng.integers(0, len(a) - flen[i] + 1))
        n1[i] = a[st:st + READ_LEN]
        n2[i] = _COMP[a[st + flen[i] - READ_LEN:st + flen[i]][::-1]]
    rate = rng.uniform(0.25, 0.35, n_near)[:, None]
    for mate in (n1, n2):
        sub = rng.random(mate.shape) < rate
        mate[sub] = (mate[sub] + rng.integers(1, 4, int(sub.sum()))) % 4

    r1 = rng.integers(0, 4, (n_rand, READ_LEN)).astype(np.int8)
    r2 = rng.integers(0, 4, (n_rand, READ_LEN)).astype(np.int8)
    odd = np.nonzero(rng.random(n_rand) < 0.01)[0]
    for j, i in enumerate(odd):
        mask = rng.random(READ_LEN) < 0.6
        if j % 2:
            r1[i, mask] = 0                       # one base dominates
        else:
            r1[i, rng.random(READ_LEN) < 0.15] = 4  # N-rich
    return n1, n2, r1, r2


def extract_inputs(work: str, panel: str, counts=EXTRACT_PAIRS,
                   tag: str = "x", snp_genes: int = 0,
                   barcodes: bool = False, simulate=None) -> str:
    """Read pairs of 2 x 100 bp with qualities, fixed seeds (12,500 at
    EXTRACT_PAIRS): simulated on-panel pairs (two alleles from each of 8
    genes, `snp_genes` of them with seeded SNPs; or what `simulate(prefix,
    n)` writes to <prefix>_1.fq / <prefix>_2.fq), near-miss pairs cut from
    panel alleles with 25-35% substitutions, and uniform random pairs (1%
    of them low-complexity or N-rich), shuffled.  Returns the prefix of
    <prefix>_1.fq / <prefix>_2.fq (prefix <work>/<tag>); with `barcodes`,
    also <prefix>_bc.fq, one of 24 cell barcodes of 16 bp per pair."""
    n_sim, n_near, n_rand = counts
    rng = np.random.default_rng(99)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    sim = os.path.join(work, tag + "sim")
    if simulate is None:
        simulate_reads(panel, sim, n_sim, snp_genes=snp_genes)
    else:
        simulate(sim, n_sim)
    m1 = np.stack([encode(s.decode()) for s in
                   read_fastq_seqs(sim + "_1.fq", n_sim)])
    m2 = np.stack([encode(s.decode()) for s in
                   read_fastq_seqs(sim + "_2.fq", n_sim)])
    n1, n2, r1, r2 = off_panel_pairs(rng, panel, n_near, n_rand)

    mate1 = np.concatenate([m1, n1, r1])
    mate2 = np.concatenate([m2, n2, r2])
    order = rng.permutation(len(mate1))
    quals = rng.integers(35, 74, (len(mate1), READ_LEN)).astype(np.uint8)
    names = [b"x%d" % i for i in range(len(mate1))]
    prefix = os.path.join(work, tag)
    write_fastq(prefix + "_1.fq", names, acgt[mate1[order]], quals)
    write_fastq(prefix + "_2.fq", names, acgt[mate2[order]], quals[::-1])
    if barcodes:
        brng = np.random.default_rng(98)
        cells = brng.integers(0, 4, (24, 16)).astype(np.int8)
        write_fastq(prefix + "_bc.fq", names,
                    acgt[cells[brng.integers(0, 24, len(names))]],
                    quals[:, :16])
    return prefix


def stage_line(text: str, name: str) -> dict:
    """The counters of the last `stage <name> finished` line in a log."""
    out = None
    for line in text.splitlines():
        if f"stage {name} finished in " in line:
            head, _, rest = line.partition(f"stage {name} finished in ")
            secs, *pairs = rest.split()
            out = {"seconds": float(secs.rstrip("s"))}
            out.update(p.split("=", 1) for p in pairs if "=" in p)
    if out is None:
        raise AssertionError(f"no {name} stage line")
    return out


def phase_extract(dev, work: str, info: dict, counts=EXTRACT_PAIRS):
    """The port's CLI on `dev` in this process vs its native route in a
    child process; both phase-A kernels must launch over the card route's
    run.  Returns the prefix of the inputs."""
    import io

    from t1k_tpu_torch.cli import extract as cli
    from t1k_tpu_torch.ops import phase_a as pa

    panel = os.path.join(work, "panel.fa")
    t0 = time.perf_counter()
    prefix = extract_inputs(work, panel, counts)
    info["inputs_s"] = f"{time.perf_counter() - t0:.1f}"
    args = ["-f", panel, "-1", prefix + "_1.fq", "-2", prefix + "_2.fq"]
    out, err, secs = timed_chain(
        native_cmd("cli.extract", *args, "-o", os.path.join(work, "xnative"),
                   "--backend", "native"), (STARTUP,))
    native = stage_line(err, "extraction_screen")
    info["native_process_s"] = f"{secs['process']:.2f}"
    info["native_startup_s"] = f"{secs['startup']:.2f}"
    info["native_cuda_context"] = cuda_context(out)

    log = io.StringIO()
    pa.launch_counts.update(phase_a_probe=0, phase_a_chain=0)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        cli.main([*args, "-o", os.path.join(work, "xport"), "--backend",
                  "gpu", "--device", str(dev)])
    info["port_call_s"] = f"{time.perf_counter() - t0:.2f}"
    launches = dict(pa.launch_counts)
    port = stage_line(log.getvalue(), "extraction_screen")
    for suffix in ("_1.fq", "_2.fq"):
        with open(os.path.join(work, "xnative" + suffix), "rb") as f:
            a = f.read()
        with open(os.path.join(work, "xport" + suffix), "rb") as f:
            b = f.read()
        if a != b:
            raise AssertionError(f"extraction {suffix} differs from the "
                                 "native route")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a phase-A kernel never launched: {launches}")
    screened = int(port["device_screened_reads"])
    decided = int(port["device_decided_reads"])
    if decided <= 0:
        raise AssertionError("the device decided no read")
    info["pairs"] = sum(counts)
    info["candidates"] = port["candidate_count"]
    info["reads_screened"] = port["read_count"]
    info["device_screened"] = screened
    info["device_decided"] = decided
    info["device_decided_share"] = f"{decided / screened:.6f}"
    info["port_stage_s"] = port["seconds"]
    info["native_stage_s"] = native["seconds"]
    info.update({f"{k}_launches": v for k, v in launches.items()})
    return prefix


def kernel_device_us(fn, kernel: str, reps: int) -> dict:
    """{kernel name: (mean device microseconds per launch, launches)} of
    the CUDA kernels whose name contains `kernel`, over `reps` calls of
    `fn`, from torch.profiler.  The profiler may drop some events of a
    run, so each mean is over the launches it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0))
        if kernel in ev.key and ev.count and total:
            out[ev.key] = (total / ev.count, ev.count)
    return out


def kernel_us(fn, kernel: str, reps: int):
    """Mean device microseconds per launch of the CUDA kernels whose name
    contains `kernel` (None where the profiler shows no device time)."""
    got = kernel_device_us(fn, kernel, reps).values()
    n = sum(c for _, c in got)
    return sum(us * c for us, c in got) / n if n else None


def call_us(fn, kernel: str, reps: int):
    """Device microseconds per call of `fn` of the CUDA kernels whose name
    contains `kernel`, each launched once a call: the sum of their means
    per launch (None where the profiler shows no device time)."""
    got = kernel_device_us(fn, kernel, reps).values()
    return sum(us for us, _ in got) if got else None


def probe_bound(codes: np.ndarray, lens: np.ndarray, index):
    """Bound of one probe launch.  Bytes: codes and lens in, contrib and
    cstart (int32 [R, 2W]) and tot out, and one table entry for each
    distinct valid window code of the chunk (starts[c] and starts[c+1]
    direct; key, hstart and hcount hashed).  Operations: 15 int32 per
    window and strand (rolling code, hash, compare, the scan's tests)."""
    R, L = codes.shape
    k = index.k
    W = L - k + 1
    c = codes.astype(np.int64)
    j = lens.astype(np.int64)[:, None] - 1 - np.arange(L)[None, :]
    rcb = np.take_along_axis(c, np.clip(j, 0, None), 1)
    rc = np.where(j >= 0, np.where(rcb < 4, 3 - rcb, rcb), 4)
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([c, rc]), k, axis=1)
    code = (np.minimum(win, 3) * 4 ** np.arange(k - 1, -1, -1)).sum(axis=2)
    distinct = np.unique(code[(win < 4).all(axis=2)]).size
    n_bytes = (codes.nbytes + 8 * R + 16 * R * W
               + distinct * (8 if index.direct else 12))
    return bound(n_bytes, 15 * 2 * R * W, int32_per_s())


def chain_bound(nb: np.ndarray):
    """Bound of one chain launch.  Bytes: each row's nb seeds (a and b,
    8 bytes each), nb, lens and budgets in, two int32 flags out.
    Operations: three comparison sorts of each row's seeds (n log2 n
    compare-exchanges of int64 keys, 2 int32 operations each) and 20 per
    seed for the linear passes and the LIS."""
    n = nb.astype(np.int64)
    logn = np.ceil(np.log2(np.maximum(n, 2)))
    ops = float((3 * 2 * n * logn + 20 * n).sum())
    return bound(8 * float(n.sum()) + 20 * len(n), ops, int32_per_s())


def phase_screen_timing(dev, check_probe: Checker,
                        check_chain: Checker, work: str, prefix: str,
                        info: dict):
    """Probe and chain kernels vs their plain versions, in turns (plain,
    kernel, kernel, plain), on the first full 1024-row chunk of the
    extract inputs with the extractor's table and thresholds.  Returns
    ((probe ms, plain ms, bound), (chain ms, plain ms, bound))."""
    import torch

    from t1k_tpu_torch.core import extractor as tx
    from t1k_tpu_torch.ops import phase_a as pa

    rs = tx.RefSet(digit_units=-1, delimiter="")
    for name, comment, seq in read_fasta(os.path.join(work, "panel.fa")):
        rs.add_allele(name, seq, comment)
    k = max(tx.EXTRACTOR_KMER_LENGTH, rs.infer_kmer_length())
    hlr = max(tx.EXTRACTOR_HIT_LEN_PAIRED, READ_LEN // 5, k)
    index = pa.PhaseAIndex.build(rs.packed(), k, dev)
    reads = read_fastq_seqs(prefix + "_1.fq", 1024)
    codes, lens = pad_reads([r.decode() for r in reads])
    codes_d = torch.from_numpy(codes).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    budgets = torch.from_numpy(np.trunc(lens * 0.2).astype(np.int32)
                               * k).to(dev)
    cuda = dev.type == "cuda"
    got = (pa.probe_cuda if cuda else pa.probe_plain)(codes_d, lens_d, index)
    want = pa.probe_plain(codes_d, lens_d, index)
    for g, w in zip(got, want):
        check_probe(g, w, "probe chunk")
    total = int(got[2].sum())
    a, b, nb, _, _ = pa.expand_buckets(got[0], got[1], total, index, hlr,
                                       512)
    kw = dict(k=k, radius=10, hit_len_required=hlr)
    chain_k = pa.chain_rows_cuda if cuda else pa.chain_rows

    def chain_plain():
        core, budget = pa.chain_rows_plain(a, b, nb, lens_d, budgets, **kw)
        return torch.stack([(core & budget).any(dim=1),
                            core.any(dim=1)]).to(torch.int32)

    check_chain(chain_k(a, b, nb, lens_d, budgets, **kw), chain_plain(),
                "chain chunk")
    def out_probe():
        return (pa.probe_cuda if cuda else pa.probe_plain)(codes_d, lens_d,
                                                           index)

    def out_chain():
        return chain_k(a, b, nb, lens_d, budgets, **kw)

    out = []
    for kernel, plain in (
            (out_probe, lambda: pa.probe_plain(codes_d, lens_d, index)),
            (out_chain, chain_plain)):
        plain_ms = [time_ms(plain, 1, dev)]
        kernel_ms = [time_ms(kernel, 20, dev), time_ms(kernel, 20, dev)]
        plain_ms.append(time_ms(plain, 1, dev))
        out.append((kernel_ms, plain_ms))
    if cuda:  # the kernels' own device time, without the wrappers' fills
        info["probe_kernel_us"] = kernel_us(out_probe, "probe_kernel", 20)
        info["chain_kernel_us"] = kernel_us(out_chain, "chain_kernel", 20)
    info["k"] = k
    info["hits"] = total
    info["max_nb"] = int(nb.max())
    for name, (kernel_ms, plain_ms) in zip(("probe", "chain"), out):
        info[f"{name}_ms"] = " ".join(f"{t:.4f}" for t in kernel_ms)
        info[f"{name}_plain_ms"] = " ".join(f"{t:.2f}" for t in plain_ms)
    bounds = (probe_bound(codes, lens, index), chain_bound(nb.cpu().numpy()))
    return tuple((float(np.mean(km)), float(np.mean(pm)), b)
                 for (km, pm), b in zip(out, bounds))


# ------------------------------------------------------------ k-mer prefilter

# K11's table lengths: pair table up to 13, centre-canonical table at 14,
# hashed above
KMER_KS = (11, 12, 13, 14, 15, 16)
# bytes written between launches for K11's cold reading (past the 50 MB L2)
FLUSH_BYTES = 64 << 20
# int32 operations per window and strand counted for K11's bound: the
# rolled key (shift, or, and), its N count (add, compare), the bitmap
# word's address and the bit (two shifts, two ands, a compare) and the
# count (add)
KMER_OPS_PER_WINDOW = 11


def fastq_codes(path: str, n: int):
    """The first `n` reads of a FASTQ as (codes int8 [n, L], lens)."""
    seqs = read_fastq_seqs(path, n)
    if len({len(s) for s in seqs}) != 1:
        return pad_reads([s.decode() for s in seqs])
    codes = _LUT[np.frombuffer(b"".join(seqs), np.uint8)].reshape(
        len(seqs), -1)
    return codes, np.full(len(seqs), codes.shape[1], np.int32)


def kmer_edge_reads(allele: np.ndarray, k: int, rng, L: int = 48):
    """Reads cut from `allele` at K11's edges: lengths 0, k - 1, k, k + 1
    and L; an N at the first, a middle and the last base; a reverse
    complemented slice; all-T (at k = 16 the hashed table's empty marker)
    and all-A reads; random bases past each read's end."""
    rows = [allele[o:o + n] for n, o in zip(
        (0, k - 1, k, k + 1, L), rng.integers(0, len(allele) - L, 5))]
    for pos in (0, L // 2, L - 1):
        r = allele[100:100 + L].copy()
        r[pos] = 4
        rows.append(r)
    rows.append(_COMP[allele[200:200 + L][::-1]])
    rows += [np.full(L, 3, np.int8), np.full(L, 0, np.int8),
             np.full(k, 3, np.int8)]
    codes = rng.integers(0, 5, (len(rows), L)).astype(np.int8)
    lens = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
    return codes, lens


def kmer_bound(table, codes, lens):
    """(bytes, gathers, bound) of one K11 launch.  Bytes: codes and lens
    in, the two counts out, and each table word the batch's windows touch
    read once (direct: the bitmap word of each window's key; hashed: each
    key's first slot).  Operations: KMER_OPS_PER_WINDOW int32 for each
    window and strand looked up (a window in its read, without an N), one
    table gather each."""
    import torch

    from t1k_tpu_torch.ops import kmer

    fwd, fwd_ok, rc, rc_ok = kmer.window_keys(codes, lens, table.k)
    keys = torch.cat([fwd[fwd_ok], rc[rc_ok]])
    slots = (keys >> 5 if table.direct
             else kmer.hash_slots(keys, table.size - 1))
    R, L = codes.shape
    n_bytes = R * L + 12 * R + 4 * int(torch.unique(slots).numel())
    gathers = int(keys.numel())
    return n_bytes, gathers, bound(n_bytes, KMER_OPS_PER_WINDOW * gathers,
                                   int32_per_s())


def cold_ms(fn, reps: int, dev) -> float:
    """Mean milliseconds of one call of `fn` after FLUSH_BYTES have been
    written (CUDA events around the call alone; the host clock on the
    CPU)."""
    import torch

    if dev.type != "cuda":
        return time_ms(fn, reps, dev)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for i in range(reps):
        flush.fill_(i & 1)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_kmer(dev, check: Checker, work: str, prefix: str, n_reads: int,
               info: dict):
    """K11 (ops/kmer.py, csrc/kmer_classify.cu) on the HLA-scale panel:
    the table built at each of KMER_KS (build seconds printed) and the
    kernel and its first design held exactly against classify_plain on
    the card's tensors, on the first `n_reads` mate-1 reads of `prefix`
    and on edge reads of 48 and 151 bases; a batch narrower than k gives
    zeros without a launch.  Then at the extractor's k, on those reads, the kernel, the
    first design and the screen's probe kernel in turns (kmer, v1, probe,
    probe, v1, kmer) between two plain runs, each design's cold time
    (after FLUSH_BYTES written), the pair table's bytes, the table words a
    launch of each design reads (ops/kmer.py::lookups) and the bound.  Returns ((ms, plain ms, bound),
    launches of the kernel in this phase, extras for the kernels line)."""
    import torch

    from t1k_tpu_torch.core import extractor as tx
    from t1k_tpu_torch.ops import kmer
    from t1k_tpu_torch.ops import phase_a as pa

    cuda = dev.type == "cuda"
    classify = kmer.classify_cuda if cuda else kmer.classify_plain
    classify_v1 = kmer.classify_v1_cuda if cuda else kmer.classify_plain
    rs = tx.RefSet(digit_units=-1, delimiter="")
    for name, comment, seq in read_fasta(os.path.join(work, "panel.fa")):
        rs.add_allele(name, seq, comment)
    packed = rs.packed()
    allele = packed.seq_codes[int(packed.seq_starts[0]):][
        :int(packed.seq_lens[0])]
    codes, lens = fastq_codes(prefix + "_1.fq", n_reads)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    codes_d, lens_d = put(codes), put(lens)
    rng = np.random.default_rng(21)
    launches0 = dict(kmer.launch_counts)
    k_screen = max(tx.EXTRACTOR_KMER_LENGTH, rs.infer_kmer_length())
    tables = {}
    for k in KMER_KS:
        t0 = time.perf_counter()
        table = kmer.DeviceKmerTable.build(packed, k, device=dev)
        info[f"k{k}_build_s"] = f"{time.perf_counter() - t0:.3f}"
        info[f"k{k}_words"] = table.size
        edges = kmer_edge_reads(allele, k, rng)
        # odd rows, staged a byte at a time, two tiles of windows a row
        long_edges = kmer_edge_reads(allele, k, rng, L=151)
        for what, c, n in (("reads", codes_d, lens_d),
                           ("edges", put(edges[0]), put(edges[1])),
                           ("long edges", put(long_edges[0]),
                            put(long_edges[1]))):
            got = classify(table, c, n)
            got_v1 = classify_v1(table, c, n)
            want = kmer.classify_plain(table, c, n)
            check(got[0], want[0], f"kmer k={k} {what} fwd")
            check(got[1], want[1], f"kmer k={k} {what} rc")
            check(got_v1[0], want[0], f"kmer v1 k={k} {what} fwd")
            check(got_v1[1], want[1], f"kmer v1 k={k} {what} rc")
            if what == "reads":
                info[f"k{k}_hit_reads"] = int(((got[0] + got[1]) > 0).sum())
        narrow = kmer.classify(table, codes_d[:, :k - 1].contiguous(),
                               lens_d)
        if bool(narrow[0].any() or narrow[1].any()):
            raise AssertionError(f"kmer k={k}: a batch narrower than k "
                                 "counted windows")
        if k == k_screen:
            tables[k] = table
    table = tables.get(k_screen) or kmer.DeviceKmerTable.build(
        packed, k_screen, device=dev)
    index = pa.PhaseAIndex.build(packed, k_screen, dev)
    probe = pa.probe_cuda if cuda else pa.probe_plain

    def run_kmer():
        return classify(table, codes_d, lens_d)

    def run_v1():
        return classify_v1(table, codes_d, lens_d)

    def run_probe():
        return probe(codes_d, lens_d, index)

    def run_plain():
        return kmer.classify_plain(table, codes_d, lens_d)

    reps = 10 if cuda else 1
    plain_ms = [time_ms(run_plain, 1, dev)]
    kmer_ms, v1_ms, probe_ms = [time_ms(run_kmer, reps, dev)], [], []
    v1_ms.append(time_ms(run_v1, reps, dev))
    probe_ms += [time_ms(run_probe, reps, dev), time_ms(run_probe, reps, dev)]
    v1_ms.append(time_ms(run_v1, reps, dev))
    kmer_ms.append(time_ms(run_kmer, reps, dev))
    plain_ms.append(time_ms(run_plain, 1, dev))
    cold = (cold_ms(run_kmer, reps, dev), cold_ms(run_v1, reps, dev))
    if cuda:
        info["kmer_kernel_us"] = kernel_us(run_kmer, "classify_kernel", 10)
        info["v1_kernel_us"] = kernel_us(run_v1, "classify_v1_kernel", 10)
    n_bytes, gathers, b = kmer_bound(table, codes_d, lens_d)
    n_lookups = kmer.lookups(table, codes_d, lens_d)
    pair_bytes = 4 * len(table.pair) if table.pair is not None else 0
    info.update(reads=len(lens), k=k_screen, mode=table.mode,
                pair_table_bytes=pair_bytes,
                kmer_ms=" ".join(f"{t:.4f}" for t in kmer_ms),
                v1_ms=" ".join(f"{t:.4f}" for t in v1_ms),
                probe_ms=" ".join(f"{t:.4f}" for t in probe_ms),
                plain_ms=" ".join(f"{t:.2f}" for t in plain_ms),
                kmer_cold_ms=f"{cold[0]:.4f}", v1_cold_ms=f"{cold[1]:.4f}",
                lookups=n_lookups[0], lookups_v1=n_lookups[1],
                kmer_reads_per_s=f"{len(lens) / np.mean(kmer_ms) * 1e3:.4g}",
                v1_reads_per_s=f"{len(lens) / np.mean(v1_ms) * 1e3:.4g}",
                probe_reads_per_s=f"{len(lens) / np.mean(probe_ms) * 1e3:.4g}",
                bound_bytes=n_bytes, bound_gathers=gathers,
                bound_ms=f"{b[0]:.4f}", bound_by=b[1])
    launches = {name: kmer.launch_counts[name] - launches0[name]
                for name in launches0}
    extras = dict(v1_ms=float(np.mean(v1_ms)), cold_ms=cold[0],
                  v1_cold_ms=cold[1], pair_table_bytes=pair_bytes,
                  v1_launches_kmer_phase=launches["kmer_classify_v1"])
    return ((float(np.mean(kmer_ms)), float(np.mean(plain_ms)), b),
            launches["kmer_classify"], extras)


# ------------------------------------------------------------ run-t1k chain

CHAIN_OUTPUTS = ("_candidate_1.fq", "_candidate_2.fq", "_candidate_bc.fa",
                 "_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                 "_aligned_2.fa", "_aligned_bc.fa", "_allele.vcf",
                 "_barcode_expr.tsv")
# the line PORT_RUN, PORT_SMARTSEQ and PORT_NATIVE write to standard error
# once their imports are done: a child's start-up, from its start to there
READY = "t1k_tpu_torch imported"
STARTUP = ("startup", None, READY)
# each stage of a run-t1k chain between two lines of its log, which both
# routes of cli.run write, after the child's start-up
STAGE_MARKS = (STARTUP,
               ("extraction", "Start to extract candidate reads",
                "Finish extracting reads."),
               ("genotyper", "Finish extracting reads.",
                "Genotyping finishes."),
               ("analyzer", "Genotyping finishes.",
                "Post analysis finishes."))
# a child's arguments may hold several runs of its CLI, one after another
# in the one process, parted by THEN; RUN_MARK i on its standard error
# opens run i
THEN = "--then"
RUN_MARK = "t1k_tpu_torch run"
_RUNS = ("counts = (align_band.launch_counts, em.launch_counts,\n"
         "          kmer.launch_counts, phase_a.launch_counts)\n"
         "runs = [[]]\n"
         "for a in sys.argv[1:]:\n"
         f"    runs.append([]) if a == {THEN!r} else runs[-1].append(a)\n")
# t1k_tpu_torch.cli.run as `python -m` runs it, with the kernels' launch
# counts set to 0 just before each run and printed as a line of their own
# after it (the last line after the last run); `--profileDir DIR` among a
# run's arguments sets T1K_PROFILE_DIR for that run alone
PORT_RUN = ("import json, os, sys\n"
            "from t1k_tpu_torch.cli import run\n"
            "from t1k_tpu_torch.ops import align_band, em, kmer, phase_a\n"
            f"print({READY!r}, file=sys.stderr, flush=True)\n"
            + _RUNS +
            "for i, argv in enumerate(runs):\n"
            "    if '--profileDir' in argv:\n"
            "        j = argv.index('--profileDir')\n"
            "        os.environ['T1K_PROFILE_DIR'] = argv.pop(j + 1)\n"
            "        del argv[j]\n"
            "    for c in counts:\n"
            "        c.update(dict.fromkeys(c, 0))\n"
            f"    print({RUN_MARK!r}, i, file=sys.stderr, flush=True)\n"
            "    rc = run.main(argv)\n"
            "    os.environ.pop('T1K_PROFILE_DIR', None)\n"
            "    print(json.dumps({k: v for c in counts\n"
            "                      for k, v in c.items()}), flush=True)\n"
            "    if rc:\n"
            "        sys.exit(rc)\n")

# t1k_tpu_torch.cli.genotype as `python -m` runs it, with the kernels' launch
# counts set to 0 just before it and printed as the last line after it
PORT_GENOTYPE = PORT_RUN.replace("from t1k_tpu_torch.cli import run",
                                 "from t1k_tpu_torch.cli import genotype") \
    .replace("run.main(", "genotype.main(")

# the native baselines: a module of the port (t1k_tpu_torch.<pkg>.<leaf>,
# filled in by native_cmd) as `python -m` runs it, once per run (THEN),
# READY once imported and, as the last line of its standard output after
# the last run, whether the process made a CUDA context (the host engine
# needs none) and the kernels' launches over all its runs
PORT_NATIVE = ("import json, sys\n"
               "import torch\n"
               "from t1k_tpu_torch.{pkg} import {leaf} as tool\n"
               "from t1k_tpu_torch.ops import align_band, em, kmer, phase_a\n"
               f"print({READY!r}, file=sys.stderr, flush=True)\n"
               + _RUNS +
               "for c in counts:\n"
               "    c.update(dict.fromkeys(c, 0))\n"
               "for i, argv in enumerate(runs):\n"
               f"    print({RUN_MARK!r}, i, file=sys.stderr, flush=True)\n"
               "    rc = tool.main(argv)\n"
               "    if rc:\n"
               "        sys.exit(rc)\n"
               "print(json.dumps({{'cuda_context': "
               "torch.cuda.is_initialized(), 'launches': {{\n"
               "    k: v for c in counts for k, v in c.items()}}}}))\n")


def native_cmd(module: str, *args) -> list:
    """The command of a native baseline: `python -m t1k_tpu_torch.<module>
    args` through PORT_NATIVE."""
    pkg, leaf = module.split(".")
    return [sys.executable, "-c", PORT_NATIVE.format(pkg=pkg, leaf=leaf),
            *args]


def cuda_context(stdout: str) -> bool:
    """Whether a PORT_NATIVE child made a CUDA context (its last line)."""
    return json.loads(stdout.splitlines()[-1])["cuda_context"]


def stamped_child(cmd, env=None, cwd=ROOT) -> tuple:
    """Runs `cmd` in a child process (environment `env`, child_env() by
    default; working directory `cwd`).  Returns its standard output, the
    lines of its standard error, each with its arrival in seconds after
    the child's start (host clock), and the seconds to its exit."""
    stamped = []
    with tempfile.TemporaryFile("w+") as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=cwd, env=env or child_env(),
                                stdout=out, stderr=subprocess.PIPE,
                                text=True)
        for line in proc.stderr:
            stamped.append((time.perf_counter() - t0, line))
        proc.wait()
        process = time.perf_counter() - t0
        out.seek(0)
        stdout = out.read()
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[1:3]} exited {proc.returncode}:\n"
                           + "".join(line for _, line in stamped)[-4000:])
    return stdout, stamped, process


def stage_seconds(stamped, stage_marks) -> dict:
    """{stage: seconds} of `stage_marks` over stamped log lines: each stage
    from the first line that holds its opening mark (the child's start
    where that is None) to the first that holds its closing one."""
    marks = {None: 0.0}
    for now, line in stamped:
        for _, *bounds in stage_marks:
            for mark in bounds:
                if mark is not None and mark in line:
                    marks.setdefault(mark, now)
    return {name: marks[end] - marks[start]
            for name, start, end in stage_marks}


def timed_chain(cmd, stage_marks=STAGE_MARKS, env=None, cwd=ROOT) -> tuple:
    """Runs a run-t1k chain `cmd` in a child process (stamped_child).
    Returns its standard output, its standard error and {stage: seconds,
    "process": seconds}: each stage of `stage_marks` by stage_seconds,
    the process from its start to its exit."""
    stdout, stamped, process = stamped_child(cmd, env, cwd)
    secs = {"process": process, **stage_seconds(stamped, stage_marks)}
    return stdout, "".join(line for _, line in stamped), secs


def timed_runs(cmd, env=None, cwd=ROOT) -> tuple:
    """Runs a child of several run-t1k chains (THEN) through stamped_child.
    Returns its standard output, {"process", "startup": seconds} and, for
    each run, {stage: seconds} by STAGE_MARKS between its RUN_MARK and
    the next."""
    stdout, stamped, process = stamped_child(cmd, env, cwd)
    starts = [i for i, (_, line) in enumerate(stamped)
              if line.startswith(RUN_MARK)]
    runs = [stage_seconds(stamped[a:b], STAGE_MARKS[1:])
            for a, b in zip(starts, starts[1:] + [len(stamped)])]
    return stdout, {"process": process,
                    **stage_seconds(stamped, (STARTUP,))}, runs


def device_busy_ms(trace: str) -> float:
    """Milliseconds in which the card ran something (the union of the
    kernel, copy and set intervals of a torch.profiler Chrome trace)."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_run(dev, work: str, info: dict, counts=EXTRACT_PAIRS) -> dict:
    """t1k_tpu_torch.cli.run (extract -> genotype -> analyze, every route
    on `dev`) against its native route (--backend native --emBackend
    native), each in a child process of its own, on read pairs whose
    simulated share carries seeded SNPs in SNP_GENES genes, with cell
    barcodes.  Every output byte-compared, the VCF non-empty; returns the
    kernels' launch counts over the card route's run, the band kernel's
    split into band_stats (the genotyper's launches) and
    band_stats_analyzer."""
    panel = os.path.join(work, "panel.fa")
    t0 = time.perf_counter()
    prefix = extract_inputs(work, panel, counts, tag="run",
                            snp_genes=SNP_GENES, barcodes=True)
    info["inputs_s"] = f"{time.perf_counter() - t0:.1f}"
    args = ["-f", panel, "-1", prefix + "_1.fq", "-2", prefix + "_2.fq",
            "--barcode", prefix + "_bc.fq", "-o", "run"]
    secs = {}
    native, _, secs["native"] = timed_chain(
        native_cmd("cli.run", *args, "--od", os.path.join(work, "rnative"),
                   "--backend", "native", "--emBackend", "native"))
    info["native_cuda_context"] = cuda_context(native)
    out, _, secs["port"] = timed_chain(
        [sys.executable, "-c", PORT_RUN, *args, "--od",
         os.path.join(work, "rport"), "--backend", "gpu", "--emBackend",
         "gpu", "--device", str(dev)])
    launches = check_chain(dev, os.path.join(work, "rnative", "run"),
                           os.path.join(work, "rport", "run"),
                           CHAIN_OUTPUTS, out, secs, info)
    info["pairs"] = sum(counts)
    return launches


def check_chain(dev, native: str, port: str, outputs, port_stdout: str,
                secs: dict, info: dict) -> dict:
    """Holds the outputs of a port chain (prefix `port`) byte for byte
    against the native route's (prefix `native`), with at least one VCF
    record, and its kernels' launch counts (the last line of
    `port_stdout`, printed by PORT_RUN) against its two metrics files:
    probe, chain, EM and the band kernel in both read assignments must
    launch, the warp band kernel never.  Prints each route's stage
    seconds `secs`; returns the launch counts, the band kernel's split
    into band_stats (the genotyper's) and band_stats_analyzer."""
    label = os.path.basename(port)
    launches = json.loads(port_stdout.splitlines()[-1])
    for suffix in outputs:
        with open(native + suffix, "rb") as f:
            a = f.read()
        with open(port + suffix, "rb") as f:
            b = f.read()
        if a != b:
            raise AssertionError(f"{label} {suffix} differs from the native "
                                 "route")
        info[f"{suffix.lstrip('_')}_bytes"] = len(b)
    with open(port + "_allele.vcf") as f:
        info["vcf_records"] = sum(1 for _ in f)
    if info["vcf_records"] < 1:
        raise AssertionError(f"the {label} chain called no variant")
    with open(port + "_metrics.json") as f:
        geno = json.load(f)["read_assignment"]
    with open(port + "_analyzer_metrics.json") as f:
        ana = json.load(f)
    band = {"genotyper": geno["band_kernel_launches"],
            "analyzer": ana["analyzer_read_assignment"][
                "band_kernel_launches"]}
    if sum(band.values()) != launches["band_stats"]:
        raise AssertionError(f"metrics {band} and wrapper "
                             f"{launches['band_stats']} disagree on launches")
    if launches["band_stats_warp"] or launches["band_stats_group"]:
        raise AssertionError(f"the {label} chain launched a wide-window "
                             "band kernel")
    if dev.type == "cuda" and min(*band.values(), launches["em_squarem"],
                                  launches["phase_a_probe"],
                                  launches["phase_a_chain"]) <= 0:
        raise AssertionError(f"a kernel of the {label} chain never "
                             f"launched: {launches}, band {band}")
    if min(geno["deferred_item_count"], ana["analyzer_read_assignment"][
            "deferred_item_count"]) <= 0:
        raise AssertionError(f"a stage of the {label} chain deferred no DP "
                             "item")
    launches.update(band_stats=band["genotyper"],
                    band_stats_analyzer=band["analyzer"])
    info["deferred_items_analyzer"] = ana["analyzer_read_assignment"][
        "deferred_item_count"]
    info.update({f"{k}_launches": v for k, v in launches.items()})
    print(f"  {label} stage seconds (child processes, host clock): "
          + json.dumps({route: {k: round(v, 3) for k, v in s.items()}
                        for route, s in secs.items()}), flush=True)
    print(f"  {label} port analyzer stages: " + " ".join(
        f"{k}={v['seconds']}s" for k, v in ana.items()), flush=True)
    return launches


# ---------------------------------------------------------- run-t1k -b

# the bam_run phase's BAM, in read pairs of 2 x 100 bp: on-panel pairs
# aligned inside their gene's interval and on the alt contig, unaligned
# templates (on-panel, near-miss, random), pairs within 5 kb of an
# interval on chr6, and off-target pairs on chr1
# 16,875 pairs, cut from 500,000 as the run phase's, then from 250,000
# (off target only) when the native baseline became the port's, whose
# child processes each import torch, then with the run phase's for the
# wgs phase (every share halved, then the off-target pairs cut), then
# from 50,000 for the fuzz phase (the random unaligned templates and the
# off-target pairs halved, then every share)
BAM_PAIRS = dict(region=2_500, alt=250, unaligned_panel=1_000,
                 unaligned_near=4_000, unaligned_random=3_750,
                 near_edge=1_250, off_target=4_250)
BAM_CONTIGS = (("chr1", 200_000_000), ("chr6", 171_000_000),
               ("chr6_GL000251v2_alt", 4_700_000))
# gene g of the panel lies on chr6 at [GENE_START + GENE_STEP g,
# GENE_START + GENE_STEP g + GENE_SPAN]
GENE_START, GENE_STEP, GENE_SPAN = 1_000_000, 200_000, 12_000
# The reference's BAM chain writes no line around its extraction: there
# it runs from the child's start (its start-up included) to the
# genotyper's first line after loading its reads, which both routes write
BAM_STAGE_MARKS = ((STARTUP,
                    ("extraction", None,
                     "read fragments. Start read assignment."),
                    ("genotyper", "read fragments. Start read assignment.",
                     "Genotyping finishes."))
                   + STAGE_MARKS[3:])
BAM_OUTPUTS = CHAIN_OUTPUTS + ("_candidate_umi.fa",)
BAM_HEADER = "@HD\tVN:1.6\tSO:coordinate\n"
# BAM 4-bit codes of A, C, G, T, N ("=ACMGRSVTWYHKDBN")
_NIBBLE = np.array([1, 2, 4, 8, 15], np.uint8)


def _put(rows: np.ndarray, off: int, values, dtype: str) -> None:
    """Little-endian `values` (one per row) into byte columns at `off`."""
    v = np.ascontiguousarray(np.broadcast_to(
        np.asarray(values, dtype), (rows.shape[0],)))
    rows[:, off:off + v.itemsize] = v.view(np.uint8).reshape(len(v), -1)


def pack_records(r: dict, aligned: bool) -> np.ndarray:
    """BAM records, block sizes included, as rows of one uint8 array laid
    out byte for byte as BamWriter.write lays them out: the name p%07d of
    `id`, READ_LEN bases (codes 0-4, as stored) and raw qualities, one M
    CIGAR op where `aligned` (none otherwise), bin 0, then the CB and UB
    tags (codes)."""
    n, L = r["seq"].shape
    n_cig = 1 if aligned else 0
    tags = 2 * 3 + r["cb"].shape[1] + r["ub"].shape[1] + 2
    size = 36 + 9 + 4 * n_cig + L // 2 + L + tags
    rows = np.zeros((n, size), np.uint8)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    _put(rows, 0, size - 4, "<i4")
    for off, key in ((4, "tid"), (8, "pos"), (24, "mtid"), (28, "mpos"),
                     (32, "tlen")):
        _put(rows, off, r[key], "<i4")
    _put(rows, 12, 9, "u1")
    _put(rows, 13, 60 if aligned else 0, "u1")
    _put(rows, 16, n_cig, "<u2")
    _put(rows, 18, r["flag"], "<u2")
    _put(rows, 20, L, "<i4")
    digits = (r["id"][:, None] // 10 ** np.arange(6, -1, -1)) % 10
    rows[:, 36] = ord("p")
    rows[:, 37:44] = digits + ord("0")
    off = 45
    if aligned:
        _put(rows, off, (L << 4) | 0, "<u4")
        off += 4
    nib = _NIBBLE[r["seq"]]
    rows[:, off:off + L // 2] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    off += L // 2
    rows[:, off:off + L] = r["qual"]
    off += L
    for tag, key in ((b"CBZ", "cb"), (b"UBZ", "ub")):
        w = r[key].shape[1]
        rows[:, off:off + 3] = np.frombuffer(tag, np.uint8)
        rows[:, off + 3:off + 3 + w] = acgt[r[key]]
        off += 4 + w
    return rows


def write_bam(path: str, groups) -> None:
    """A BAM with BAM_CONTIGS of the record rows `groups` (pack_records),
    in order, cut into BGZF blocks where BamWriter cuts them (after the
    record that takes its buffer past 32,000 bytes), so that the file is
    the one BamWriter writes; the blocks are compressed on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from t1k_tpu_torch.io.bam import BamWriter, _bgzf_block

    sizes = np.concatenate([np.full(len(g), g.shape[1]) for g in groups])
    data = np.concatenate([g.reshape(-1) for g in groups])
    ends, buf = [], 0
    for i, size in enumerate(sizes.tolist()):
        buf += size
        if buf > 32000:
            ends.append(i + 1)
            buf = 0
    if buf:
        ends.append(len(sizes))
    offs = np.concatenate([[0], np.cumsum(sizes)])
    payloads = [data[offs[a]:offs[b]].tobytes()
                for a, b in zip([0] + ends[:-1], ends)]
    with ThreadPoolExecutor(8) as pool:
        blocks = list(pool.map(_bgzf_block, payloads))
    w = BamWriter(path, *zip(*BAM_CONTIGS), BAM_HEADER)
    for block in blocks:
        w._f.write(block)
    w.close()


def writer_records(r: dict, aligned: bool, n: int):
    """The first `n` rows of `r` as port BamRecords, for BamWriter."""
    from t1k_tpu_torch.io.bam import BamRecord

    acgt = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for i in range(n):
        seq = acgt[r["seq"][i]].tobytes().decode()
        out.append(BamRecord(
            "p%07d" % r["id"][i], int(r["flag"][i]), int(r["tid"][i]),
            int(r["pos"][i]), 60 if aligned else 0,
            [(len(seq), 0)] if aligned else [], int(r["mtid"][i]),
            int(r["mpos"][i]), int(r["tlen"][i]), seq,
            (r["qual"][i] + 33).tobytes().decode(),
            {"CB": acgt[r["cb"][i]].tobytes().decode(),
             "UB": acgt[r["ub"][i]].tobytes().decode()}))
    return out


def read_fastq(path: str):
    """(names, [n, READ_LEN] base codes) of a FASTQ of READ_LEN reads."""
    names, seqs = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            if i % 4 == 0:
                names.append(line[1:].split()[0])
            elif i % 4 == 1:
                seqs.append(encode(line.strip()))
    return names, np.stack(seqs)


def gene_index(name: str) -> int:
    """The panel gene's index g of an allele name GEN<g in base 26>*..."""
    return (ord(name[3]) - 65) * 26 + ord(name[4]) - 65


def bam_inputs(work: str, panel: str, counts: dict, info: dict):
    """The bam_run inputs, fixed seeds: the coordinate fasta (every panel
    allele with its gene's interval on chr6) and a coordinate-sorted BAM
    of `counts` read pairs (BAM_PAIRS), aligned records first and
    unaligned templates (flags 0x4D/0x8D, shuffled) last, CB (one of 24
    barcodes of 16 bp) and UB (10 bp) on every record.  The on-panel
    pairs are simulate_reads' (two genes with seeded SNPs), the rest as
    extract_inputs makes them.  Returns (bam, coord)."""
    rng = np.random.default_rng(97)
    c = counts
    coord = os.path.join(work, "coord.fa")
    with open(coord, "w") as f:
        for name, _, seq in read_fasta(panel):
            lo = GENE_START + GENE_STEP * gene_index(name)
            f.write(f">{name} chr6 {lo} {lo + GENE_SPAN} +\n{seq}\n")
    n_panel = c["region"] + c["alt"] + c["unaligned_panel"]
    sim = os.path.join(work, "bamsim")
    simulate_reads(panel, sim, n_panel, snp_genes=SNP_GENES)
    names, m1 = read_fastq(sim + "_1.fq")
    m2 = read_fastq(sim + "_2.fq")[1]

    def rand(n):
        return rng.integers(0, 4, (n, READ_LEN)).astype(np.int8)

    n_near = c["unaligned_near"]
    n1, n2, r1, r2 = off_panel_pairs(rng, panel, n_near,
                                     c["unaligned_random"])

    # aligned pairs: (mate 1, mate 2 in sequencing orientation, tid, p1)
    k0, k1 = c["region"], c["region"] + c["alt"]
    # simulate_reads' names: sim_<i>_<allele>_<fragment start>
    gene = np.array([gene_index(x.split("_")[2]) for x in names[:k0]])
    start = np.array([int(x.split("_")[-1]) for x in names[:k0]])
    n_edge = c["near_edge"]
    eg = np.arange(n_edge) % PANEL_GENES
    lo = GENE_START + GENE_STEP * eg
    u = rng.integers(0, 4700, n_edge)
    edge_p1 = np.where(np.arange(n_edge) // PANEL_GENES % 2,
                       lo + GENE_SPAN + 1 + u, lo - 5000 + u)
    n_off = c["off_target"]
    al = dict(
        m1=np.concatenate([m1[:k1], rand(n_edge), rand(n_off)]),
        m2=np.concatenate([m2[:k1], rand(n_edge), rand(n_off)]),
        tid=np.concatenate([np.full(k0, 1), np.full(c["alt"], 2),
                            np.full(n_edge, 1), np.zeros(n_off, int)]),
        p1=np.concatenate([GENE_START + GENE_STEP * gene + start,
                           10_000 + 100 * np.arange(c["alt"]), edge_p1,
                           rng.integers(0, 199_000_000, n_off)]))
    order = rng.permutation(n_panel - k1 + n_near + len(r1))
    un = dict(m1=np.concatenate([m1[k1:], n1, r1])[order],
              m2=np.concatenate([m2[k1:], n2, r2])[order])

    cells = rng.integers(0, 4, (24, 16)).astype(np.int8)

    def records(m1, m2, ids, aligned, tid=None, p1=None):
        """Both mates' records of the pairs `ids`, the pair's tags on
        both."""
        n = len(m1)
        cb = cells[rng.integers(0, 24, n)]
        ub = rng.integers(0, 4, (n, 10)).astype(np.int8)
        q = rng.integers(2, 41, (2, n, READ_LEN)).astype(np.uint8)
        if aligned:
            p2 = p1 + 150
            tlen = p2 - p1 + READ_LEN
            mate = [dict(flag=0x63, tid=tid, pos=p1, mtid=tid, mpos=p2,
                         tlen=tlen, seq=m1, qual=q[0]),
                    dict(flag=0x93, tid=tid, pos=p2, mtid=tid, mpos=p1,
                         tlen=-tlen, seq=_COMP[m2[:, ::-1]],
                         qual=q[1][:, ::-1])]
        else:
            mate = [dict(flag=0x4D, seq=m1, qual=q[0]),
                    dict(flag=0x8D, seq=m2, qual=q[1])]
            for m in mate:
                m.update(tid=-1, pos=-1, mtid=-1, mpos=-1, tlen=0)
        out = {}
        for key in ("flag", "tid", "pos", "mtid", "mpos", "tlen", "seq",
                    "qual"):
            both = [np.broadcast_to(m[key], (n,) + np.shape(m[key])[1:])
                    for m in mate]
            out[key] = np.stack(both, 1).reshape((2 * n,) + both[0].shape[1:])
        for key, v in (("id", ids), ("cb", cb), ("ub", ub)):
            out[key] = np.repeat(v, 2, axis=0)
        return out

    n_al = len(al["m1"])
    a = records(al["m1"], al["m2"], np.arange(n_al), True, al["tid"],
                al["p1"])
    order = np.lexsort((a["pos"], a["tid"]))
    a = {k: v[order] for k, v in a.items()}
    un = records(un["m1"], un["m2"], n_al + np.arange(len(un["m1"])),
                 False)
    bam = os.path.join(work, "in.bam")
    t0 = time.perf_counter()
    groups = [pack_records(a, True), pack_records(un, False)]
    write_bam(bam, groups)
    # the packer writes what BamWriter writes: the first 1,000 aligned
    # and the first 1,000 unaligned records
    from t1k_tpu_torch.io.bam import BamWriter

    check = [os.path.join(work, f"check_{w}.bam") for w in ("pack", "writer")]
    write_bam(check[0], [g[:1000] for g in groups])
    w = BamWriter(check[1], *zip(*BAM_CONTIGS), BAM_HEADER)
    for r, aligned in ((a, True), (un, False)):
        for rec in writer_records(r, aligned, min(1000, len(r["flag"]))):
            w.write(rec)
    w.close()
    with open(check[0], "rb") as f, open(check[1], "rb") as g:
        if f.read() != g.read():
            raise AssertionError("the BAM packer and BamWriter differ")
    info["bam_write_s"] = f"{time.perf_counter() - t0:.1f}"
    info["bam_records"] = len(a["flag"]) + len(un["flag"])
    info["bam_mib"] = f"{os.path.getsize(bam) / 2 ** 20:.1f}"
    return bam, coord


def phase_bam_run(dev, work: str, info: dict, counts=BAM_PAIRS) -> dict:
    """t1k_tpu_torch.cli.run -b (BAM scan -> selection -> the device
    screen -> native re-screen -> mate recovery -> genotype -> analyze,
    every route on `dev`) against its native route (--backend native
    --emBackend native, which the BAM screen takes too, and
    T1K_BACKEND=native, which pins any "auto" left to the host engine),
    each in a child process of its own, on the bam_inputs BAM with CB
    barcodes and UB UMIs.  Every output byte-compared, as check_chain
    holds them; the device must decide reads.  Returns the launch counts
    as check_chain does."""
    panel = os.path.join(work, "panel.fa")
    t0 = time.perf_counter()
    bam, coord = bam_inputs(work, panel, counts, info)
    info["inputs_s"] = f"{time.perf_counter() - t0:.1f}"
    args = ["-f", panel, "-b", bam, "-c", coord, "--barcode", "CB",
            "--UMI", "UB", "-o", "bam"]
    secs = {}
    native, _, secs["native"] = timed_chain(
        native_cmd("cli.run", *args, "--od", os.path.join(work, "bnative"),
                   "--backend", "native", "--emBackend", "native"),
        BAM_STAGE_MARKS, dict(child_env(), T1K_BACKEND="native"))
    info["native_cuda_context"] = cuda_context(native)
    out, err, secs["port"] = timed_chain(
        [sys.executable, "-c", PORT_RUN, *args, "--od",
         os.path.join(work, "bport"), "--backend", "gpu", "--emBackend",
         "gpu", "--device", str(dev)], BAM_STAGE_MARKS)
    launches = check_chain(dev, os.path.join(work, "bnative", "bam"),
                           os.path.join(work, "bport", "bam"), BAM_OUTPUTS,
                           out, secs, info)
    screen = stage_line(err, "extraction_screen")
    if int(screen["device_decided_reads"]) <= 0:
        raise AssertionError("the device decided no read of the BAM")
    info["pairs"] = sum(counts.values())
    info["records_streamed"] = screen["read_count"]
    info["candidates"] = screen["candidate_count"]
    info["device_screened"] = screen["device_screened_reads"]
    info["device_decided"] = screen["device_decided_reads"]
    bam_screen_routes(dev, bam, coord, work, info)
    return launches


def bam_screen_routes(dev, bam: str, coord: str, work: str, info: dict):
    """The port's extraction of the bam_run BAM in this process, its
    screen on the host engine (backend "native", where "auto" stays below
    its gate), then on `dev` (backend "gpu", where "auto" goes once the
    gate opens): each run's seconds, host clock, and every output equal
    to the port's chain's candidate files."""
    from t1k_tpu_torch.io.bam import extract_from_bam
    from t1k_tpu_torch.utils.observability import metrics

    def outputs(prefix):
        got = []
        for suffix in ("_1.fq", "_2.fq", "_bc.fa", "_umi.fa"):
            with open(prefix + suffix, "rb") as f:
                got.append(f.read())
        return got

    want = outputs(os.path.join(work, "bport", "bam_candidate"))
    secs = {"native": [], "gpu": []}
    for i, backend in enumerate(("native", "gpu")):
        prefix = os.path.join(work, f"bscreen{i}")
        t0 = time.perf_counter()
        extract_from_bam(bam, coord, coord, prefix, bc_field="CB",
                         umi_field="UB", backend=backend, device=dev)
        secs[backend].append(time.perf_counter() - t0)
        if outputs(prefix) != want:
            raise AssertionError(f"BAM extraction on {backend} differs "
                                 f"from the chain's")
        if backend == "gpu":
            st = metrics().stages["extraction_screen"]
            info["screen_gpu_screened"] = st["device_screened_reads"]
            info["screen_gpu_decided"] = st["device_decided_reads"]
    for backend, t in secs.items():
        info[f"screen_{backend}_s"] = " ".join(f"{x:.3f}" for x in t)


def phase_run_profile(dev, work: str, info: dict):
    """The port's analyzer alone on the run's genotyper outputs, under
    torch.profiler (T1K_PROFILE_DIR): its VCF equals the run's, and the
    card's busy share of each of its stages is reported.  Returns the
    analyzer's largest batch of deferred items, as main_path_chunk."""
    import io

    from t1k_tpu_torch.cli import analyze
    from t1k_tpu_torch.core import analyzer

    port = os.path.join(work, "rport", "run")
    out = os.path.join(work, "aprof")
    trace_dir = os.path.join(work, "trace")
    service = analyzer.DeferredDescService
    analyzer.DeferredDescService = recorder = recording_service()
    os.environ["T1K_PROFILE_DIR"] = trace_dir
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            analyze.main(["-f", os.path.join(work, "panel.fa"),
                          "-a", port + "_allele.tsv",
                          "-1", port + "_aligned_1.fa",
                          "-2", port + "_aligned_2.fa", "-o", out,
                          "--backend", "gpu", "--emBackend", "gpu",
                          "--device", str(dev)])
    finally:
        del os.environ["T1K_PROFILE_DIR"]
        analyzer.DeferredDescService = service
    vcfs = []
    for path in (port, out):
        with open(path + "_allele.vcf", "rb") as f:
            vcfs.append(f.read())
    if vcfs[0] != vcfs[1]:
        raise AssertionError("the profiled analyzer's VCF differs")
    with open(out + "_analyzer_metrics.json") as f:
        stages = json.load(f)
    for name in ("analyzer_read_assignment", "alignment_info",
                 "variant_calling"):
        busy = device_busy_ms(os.path.join(trace_dir, f"{name}.json"))
        wall = stages[name]["seconds"] * 1e3
        info[f"{name}_wall_ms"] = f"{wall:.1f}"
        info[f"{name}_busy_ms"] = f"{busy:.3f}"
        info[f"{name}_idle"] = f"{1 - busy / wall:.6f}" if wall else "n/a"
    return recorder.largest


def phase_analyzer_timing(dev, check: Checker, batch, info: dict):
    """The thread kernels against the plain version, exactly and in turns
    (plain, thread, thread, plain), on the analyzer's largest batch of
    deferred items (its one launch on the run's selected alleles); each
    kernel alone and the two streams' overlap (streams_line).
    Returns (thread ms, plain ms, bound)."""
    import torch

    from t1k_tpu_torch.ops import align_band as ab

    ref, reads, desc = batch
    args = (ref, reads, torch.from_numpy(desc).to(dev), ab.DESC_ML,
            ab.DESC_W)

    def thread():
        return ab.band_stats(*args)

    def plain():
        return ab.band_stats_plain(*args)

    check(thread(), plain(), "analyzer batch")
    cuda = dev.type == "cuda"
    plain_ms = [time_ms(plain, 3 if cuda else 1, dev)]
    thread_ms = [time_ms(thread, 50 if cuda else 1, dev) for _ in range(2)]
    plain_ms.append(time_ms(plain, 3 if cuda else 1, dev))
    if cuda:
        for name in ("thread_narrow", "thread_wide", "sort_"):
            info[f"{name.strip('_')}_us"] = call_us(thread, name, 20)
        streams_line(info, thread)
    t_len, p_len = desc[1], desc[3]
    q = (0, 0.5, 0.9, 0.99, 1)
    info["items"] = int(desc.shape[1])
    info["p_len_q"] = ",".join(str(int(v)) for v in np.quantile(p_len, q))
    info["absdiff_q"] = ",".join(
        str(int(v)) for v in np.quantile(np.abs(t_len - p_len), q))
    info["thread_ms"] = " ".join(f"{t:.4f}" for t in thread_ms)
    info["plain_ms"] = " ".join(f"{t:.2f}" for t in plain_ms)
    b = dp_bound(t_len, p_len, 40 * desc.shape[1])
    info["bound_ms"] = f"{b[0]:.4f}"
    return float(np.mean(thread_ms)), float(np.mean(plain_ms)), b


# ------------------------------------------------------- WGS/WES chains

# the genomic cell: a .dat of KIR's shape (9 exons of 36-300 bp, introns
# of 300-3,000 bp, the generator's partial records and duplicates) built
# into its dna fasta by the port's database build, which keeps 200 bp of
# each intron's ends: 16 genes x 120 records came to 7.4 Mbp (k = 13),
# so the panel has 40 genes (17.7 Mbp, 3,694 alleles: the extractor's
# k = 14, its screen on the hashed table; 48 genes took the phase 155.3 s
# on H100 80GB HBM3 at 700 W, over its 150, and 96 genes of 60 records
# longer, as the reference's gene similarity grows with the genes'
# square).  Reads as benchmarks/kir_scale.py makes them (1-2 alleles of
# each of its first WGS_READ_GENES genes, error rate 0.004), near-miss
# and random pairs
WGS_GENES, WGS_RECORDS, WGS_READ_GENES = 40, 120, 16
WGS_DAT = dict(exons=(9, 9), exon_len=(36, 300), intron_len=(300, 3_000))
# 30,000 (cut from 50,000 for the fuzz phase): at 15,000 the hla-wgs
# run's screen chained no chunk, and its chain kernel must launch
WGS_PAIRS = (10_000, 5_000, 15_000)    # simulated, near-miss, random
# the first pairs, one file: 2,000 of them on-panel (the pairs are
# shuffled), as the first 10,000 of the earlier 50,000 were
WGS_INTERLEAVED = 6_000
WGS_K = 14
# (name, run-t1k flags, input)
WGS_CONFIGS = (("kir-wgs", ("--preset", "kir-wgs", "-t", "8"), "paired"),
               ("hla-wgs", ("--preset", "hla-wgs", "-t", "8"), "single"),
               ("kir-wes", ("--preset", "kir-wes", "-t", "1"),
                "interleaved"))
_WGS_PAIRED = ("_candidate_1.fq", "_candidate_2.fq", "_aligned_1.fa",
               "_aligned_2.fa")
# the configuration whose card route runs under torch.profiler (the
# card's busy share of its read assignments): the smallest, as the
# profiler slows the stages it traces
WGS_PROFILED = "kir-wes"
WGS_OUTPUTS = {"paired": _WGS_PAIRED, "interleaved": _WGS_PAIRED,
               "single": ("_candidate.fq", "_aligned.fa")}
WGS_STAGE_OUTPUTS = ("_genotype.tsv", "_allele.tsv", "_allele.vcf")


def wgs_reference(work: str, n_genes: int, records: int, info: dict) -> str:
    """The genomic cell's .dat through `python -m t1k_tpu_torch.db.build`
    in a child process; returns its dna fasta."""
    db_dir = os.path.join(work, "wgs_db")
    os.makedirs(db_dir)
    dat = os.path.join(db_dir, "kir.dat")
    t0 = time.perf_counter()
    make_ipd_dat(random.Random(22), dat, n_genes, records, **WGS_DAT)
    info["dat_bytes"] = os.path.getsize(dat)
    info["dat_s"] = f"{time.perf_counter() - t0:.2f}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "t1k_tpu_torch.db.build", "-d", dat,
         "-o", db_dir, "--prefix", "kir"],
        cwd=ROOT, env=child_env(), capture_output=True, text=True)
    info["build_s"] = f"{time.perf_counter() - t0:.2f}"
    if proc.returncode != 0:
        raise RuntimeError("the database build failed:\n"
                           + proc.stderr[-4000:])
    return os.path.join(db_dir, "kir_dna_seq.fa")


def wgs_simulate(dna: str, n_genes: int):
    """simulate(prefix, n) for extract_inputs: n pairs of 2 x 100 bp from
    1-2 alleles of each of the first `n_genes` genes of `dna` at weights
    in [0.1, 1), error rate 0.004 (benchmarks/kir_scale.py's recipe,
    seeds 23 and 5), through the port's simulator's command line."""
    by_gene = {}
    for name, _, _ in read_fasta(dna):
        by_gene.setdefault(name.split("*")[0], []).append(name)
    rng = np.random.default_rng(23)
    alleles, weights = [], []
    for gene in sorted(by_gene)[:n_genes]:
        for i in rng.choice(len(by_gene[gene]), int(rng.integers(1, 3)),
                            replace=False):
            alleles.append(by_gene[gene][i])
            weights.append(float(rng.random() * 0.9 + 0.1))

    def simulate(prefix: str, n: int) -> None:
        subprocess.run(
            [sys.executable, "-m", "t1k_tpu_torch.tools.simulate", "-f", dna,
             "-o", prefix, "-n", str(n), "--seed", "5", "--errorRate",
             "0.004", "--alleles", *alleles,
             "--abundances", *map(str, weights)],
            check=True, cwd=ROOT, env=child_env())
    return simulate


def interleave(prefix: str, n: int) -> str:
    """<prefix>_il.fq: the first n pairs of <prefix>_1.fq and _2.fq, mate
    after mate."""
    path = prefix + "_il.fq"
    with open(prefix + "_1.fq") as f1, open(prefix + "_2.fq") as f2, \
            open(path, "w") as out:
        for _ in range(n):
            out.writelines(f1.readline() for _ in range(4))
            out.writelines(f2.readline() for _ in range(4))
    return path


def phase_wgs(dev, work: str, info: dict, sizes: dict) -> dict:
    """The run-t1k chain on the genomic cell under WGS_CONFIGS: one child
    of the port's native route (--backend native --emBackend native,
    through PORT_NATIVE) and one of its card route (--backend gpu
    --emBackend gpu, through PORT_RUN), each running the three
    configurations one after another; every output of each configuration
    byte-identical between the two; on the card route the band kernel
    (genotyper and analyzer), probe, chain and EM launched in each, on the
    native route nothing launched and no CUDA context.  Returns the card
    route's launches summed over the configurations, the band kernel's
    split as band_stats (genotypers) and band_stats_analyzer."""
    from t1k_tpu_torch.io.refset import RefSet

    dna = wgs_reference(work, sizes["genes"], sizes["records"], info)
    refset = RefSet(digit_units=-1, delimiter="")
    for name, comment, seq in read_fasta(dna):
        refset.add_allele(name, seq, comment)
    info["dna_alleles"] = len(refset.alleles)
    info["dna_bases"] = sum(a.length for a in refset.alleles)
    info["k"] = refset.infer_kmer_length()
    if sizes["k"] and info["k"] != sizes["k"]:
        raise AssertionError(f"the genomic reference gives k = {info['k']}")
    t0 = time.perf_counter()
    prefix = extract_inputs(work, dna, sizes["pairs"], tag="wgs",
                            simulate=wgs_simulate(dna, sizes["read_genes"]))
    inputs = {"paired": ["-1", prefix + "_1.fq", "-2", prefix + "_2.fq"],
              "single": ["-u", prefix + "_1.fq"],
              "interleaved": ["-i", interleave(prefix,
                                               sizes["interleaved"])]}
    info["inputs_s"] = f"{time.perf_counter() - t0:.1f}"
    routes = {"native": ["--backend", "native", "--emBackend", "native"],
              "card": ["--backend", "gpu", "--emBackend", "gpu",
                       "--device", str(dev)]}
    out = {route: os.path.join(work, "wgs_" + route) for route in routes}
    trace = os.path.join(work, "wgs_trace")
    args = {route: [] for route in routes}
    for i, (name, flags, kind) in enumerate(WGS_CONFIGS):
        for route, route_flags in routes.items():
            args[route] += [*([THEN] if i else []), "-f", dna,
                            *inputs[kind], *flags, *route_flags,
                            "--od", os.path.join(out[route], name), "-o", "w",
                            *(["--profileDir", trace] if route == "card"
                              and name == WGS_PROFILED else [])]
    stdout, secs, runs = {}, {}, {}
    stdout["native"], secs["native"], runs["native"] = timed_runs(
        native_cmd("cli.run", *args["native"]))
    native_end = json.loads(stdout["native"].splitlines()[-1])
    if native_end["cuda_context"] or any(native_end["launches"].values()):
        raise AssertionError(f"the native route made a CUDA context or "
                             f"launched a kernel: {native_end}")
    stdout["card"], secs["card"], runs["card"] = timed_runs(
        [sys.executable, "-c", PORT_RUN, *args["card"]])
    card_launches = [json.loads(line) for line in
                     stdout["card"].splitlines()[-len(WGS_CONFIGS):]]
    total = {}
    for i, (name, _, kind) in enumerate(WGS_CONFIGS):
        files = {route: sorted(n for n in os.listdir(os.path.join(
            out[route], name)) if not n.endswith(".json"))
            for route in routes}
        want = {"w" + s for s in WGS_OUTPUTS[kind] + WGS_STAGE_OUTPUTS}
        if files["card"] != files["native"] or not want <= set(
                files["card"]):
            raise AssertionError(f"wgs {name}: the routes wrote {files}")
        for fname in files["card"]:
            with open(os.path.join(out["native"], name, fname), "rb") as f:
                a = f.read()
            with open(os.path.join(out["card"], name, fname), "rb") as f:
                b = f.read()
            if a != b:
                raise AssertionError(f"wgs {name}: {fname} differs from the "
                                     "native route")
        with open(os.path.join(out["card"], name, "w_metrics.json")) as f:
            geno = json.load(f)["read_assignment"]
        with open(os.path.join(out["card"], name,
                               "w_analyzer_metrics.json")) as f:
            ana = json.load(f)["analyzer_read_assignment"]
        launches = dict(card_launches[i],
                        band_stats=geno["band_kernel_launches"],
                        band_stats_analyzer=ana["band_kernel_launches"])
        if (launches["band_stats"] + launches["band_stats_analyzer"]
                != card_launches[i]["band_stats"]):
            raise AssertionError(f"wgs {name}: metrics and wrapper disagree "
                                 f"on launches: {launches}")
        path = ("band_stats", "band_stats_analyzer", "phase_a_probe",
                "phase_a_chain", "em_squarem")
        if dev.type == "cuda" and min(launches[k] for k in path) <= 0:
            raise AssertionError(f"wgs {name}: a kernel of the chain never "
                                 f"launched: {launches}")
        if launches["band_stats_warp"] or launches["band_stats_group"]:
            raise AssertionError(f"wgs {name}: a wide-window band kernel "
                                 "launched")
        if min(geno["deferred_item_count"], ana["deferred_item_count"]) <= 0:
            raise AssertionError(f"wgs {name}: a stage deferred no DP item")
        for k in path:
            total[k] = total.get(k, 0) + launches[k]
        info[f"{name}_files"] = len(files["card"])
        print(f"  wgs {name} ({kind}, {' '.join(WGS_CONFIGS[i][1])}): "
              f"deferred items genotyper {geno['deferred_item_count']} "
              f"analyzer {ana['deferred_item_count']}; launches "
              + json.dumps({k: launches[k] for k in path})
              + "; stage seconds (child processes, host clock) "
              + json.dumps({route: {k: round(v, 3) for k, v in
                                    runs[route][i].items()}
                            for route in routes}), flush=True)
    for route in routes:
        info[f"{route}_s"] = f"{secs[route]['process']:.3f}"
        info[f"{route}_startup_s"] = f"{secs[route]['startup']:.3f}"
    # the card's busy share of the profiled run's two read assignments
    for stage, metrics in (("read_assignment", "w_metrics.json"),
                           ("analyzer_read_assignment",
                            "w_analyzer_metrics.json")):
        with open(os.path.join(out["card"], WGS_PROFILED, metrics)) as f:
            wall = json.load(f)[stage]["seconds"] * 1e3
        busy = device_busy_ms(os.path.join(trace, stage + ".json"))
        info[f"{WGS_PROFILED}_{stage}_busy_ms"] = f"{busy:.3f}"
        info[f"{WGS_PROFILED}_{stage}_idle"] = (
            f"{1 - busy / wall:.6f}" if wall else "n/a")
    info["pairs"] = sum(sizes["pairs"])
    return total


# ------------------------------------------------------ SMART-seq plate

# one plate of one donor: cells, and per cell its on-panel pairs (the
# donor's alleles), near-miss and random pairs.  4 cells, so the smoke
# stays inside its time limit on a slow host (H100 80GB HBM3 at 700 W: a
# full plate took 296 s of 1,170 s of phases on one; 48 cells 154.6 s of
# 888.4; 24 cells 103.7 s of 947.4 with the distributed phase's 93.5;
# with the port's native route as the baseline, whose spawn workers each
# import torch, 12 cells 115.9 s of 967.7, 8 cells 93.6 s of 1,010.0 and
# 6 cells 105.3 s of 1,113.2)
PLATE_CELLS = 4
PLATE_PAIRS = (800, 800, 2_400)
PLATE_GENES, PLATE_EXPRESSED = 8, 6   # donor genes; expressed per cell
PLATE_WORKERS = 8
PLATE_OUTPUTS = ("_genotype_list.out", "_merged_genotype.tsv",
                 "_reduced_ref.fa", "_reduced_genotype_list.out",
                 "_final_genotype.tsv")
# each cell's first-pass outputs, then its second pass's
CELL_OUTPUTS = ("_candidate_1.fq", "_candidate_2.fq", "_genotype.tsv",
                "_allele.tsv", "_aligned_1.fa", "_aligned_2.fa",
                "_allele.vcf", "_reduced_genotype.tsv",
                "_reduced_allele.tsv", "_reduced_aligned_1.fa",
                "_reduced_aligned_2.fa", "_reduced_allele.vcf")
# t1k_tpu_torch.tools.smartseq as `python -m` runs it (arguments after
# the first), with the kernels' launch counts set to 0 just before the
# run and printed after it as the last line, its pool workers' added;
# the batched EM's arguments are pickled to the first argument
PORT_SMARTSEQ = (
    "import json, pickle, sys\n"
    "from t1k_tpu_torch.ops import align, align_band, em, phase_a\n"
    "from t1k_tpu_torch.tools import smartseq\n"
    f"print({READY!r}, file=sys.stderr, flush=True)\n"
    "counts = (align.launch_counts, align_band.launch_counts,\n"
    "          em.launch_counts, phase_a.launch_counts)\n"
    "batched = em.em_quantify_batched\n"
    "def keep(*args, **kwargs):\n"
    "    with open(sys.argv[1], 'wb') as f:\n"
    "        pickle.dump((args, kwargs), f)\n"
    "    return batched(*args, **kwargs)\n"
    "em.em_quantify_batched = keep\n"
    "for c in counts:\n"
    "    c.update(dict.fromkeys(c, 0))\n"
    "smartseq.worker_launch_counts.clear()\n"
    "rc = smartseq.main(sys.argv[2:])\n"
    "launches = {k: v for c in counts for k, v in c.items()}\n"
    "for k, v in smartseq.worker_launch_counts.items():\n"
    "    launches[k] += v\n"
    "print(json.dumps(launches))\n"
    "sys.exit(rc)\n")


def plate_inputs(work: str, panel: str, n_cells: int, counts) -> tuple:
    """A SMART-seq plate of one donor (t1k-smartseq's cross-cell vote
    assumes one individual per plate): two alleles of each of PLATE_GENES
    genes of `panel`; each cell expresses PLATE_EXPRESSED of them, drawn
    per cell from a fixed seed, at an allele ratio drawn from [0.1, 0.9],
    in counts[0] simulated pairs (t1k_tpu_torch.tools.simulate), beside
    counts[1] near-miss and counts[2] random pairs (off_panel_pairs),
    shuffled, 2 x READ_LEN bp with qualities.  Returns the two list files
    (absolute paths of cell<NN>.R1.fq / .R2.fq)."""
    from t1k_tpu_torch.io.reads import SeqRecord
    from t1k_tpu_torch.tools.simulate import SimConfig, simulate_pairs

    seqs = {name: seq for name, _, seq in read_fasta(panel)}
    rng = np.random.default_rng(21)
    genes = sorted({n.split("*")[0] for n in seqs})[:PLATE_GENES]
    donor = {}
    for g in genes:
        alleles = sorted(n for n in seqs if n.startswith(g + "*"))
        donor[g] = [alleles[i] for i in rng.choice(len(alleles), 2,
                                                   replace=False)]
    n_sim, n_near, n_rand = counts
    near1, near2, rand1, rand2 = off_panel_pairs(
        np.random.default_rng(22), panel, n_near * n_cells,
        n_rand * n_cells)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    lists = ([], [])
    for c in range(n_cells):
        chosen, abund = [], []
        for g in sorted(rng.choice(genes, PLATE_EXPRESSED, replace=False)):
            f = rng.uniform(0.1, 0.9)
            chosen += donor[g]
            abund += [f, 1 - f]
        sim = simulate_pairs([SeqRecord(a, seqs[a]) for a in chosen], abund,
                             SimConfig(n_pairs=n_sim, seed=1000 + c))
        near, rand = slice(c * n_near, (c + 1) * n_near), \
            slice(c * n_rand, (c + 1) * n_rand)
        mates = [np.concatenate([np.stack([encode(r.seq) for r in s]),
                                 n[near], r[rand]])
                 for s, n, r in zip(sim, (near1, near2), (rand1, rand2))]
        order = rng.permutation(len(mates[0]))
        quals = rng.integers(35, 74, (len(order), READ_LEN)).astype(np.uint8)
        names = [b"c%d_%d" % (c, i) for i in range(len(order))]
        for mate, (lst, m, q) in enumerate(zip(lists, mates,
                                               (quals, quals[::-1])), 1):
            path = os.path.join(work, f"cell{c:02d}.R{mate}.fq")
            write_fastq(path, names, acgt[m[order]], q)
            lst.append(path)
    out = []
    for mate, lst in enumerate(lists, 1):
        path = os.path.join(work, f"plate_list{mate}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lst) + "\n")
        out.append(path)
    return tuple(out)


def smartseq_route(cmd, workdir: str, env: dict) -> tuple:
    """Runs a smartseq command (output prefix "plate") in a child process
    in `workdir`.  Returns its standard output and walls (host clock):
    the process, its start-up, and from the output files' times the first
    pass (start to the genotype list), the vote (to the reduced
    reference) and the second pass (to the reduced genotype list)."""
    os.makedirs(workdir)
    t0 = time.time()
    stdout, _, secs = timed_chain(cmd, (STARTUP,), env, workdir)
    mtime = {s: os.path.getmtime(os.path.join(workdir, "plate" + s))
             for s in PLATE_OUTPUTS}
    secs["pass1"] = mtime["_genotype_list.out"] - t0
    secs["vote"] = mtime["_reduced_ref.fa"] - mtime["_genotype_list.out"]
    secs["pass2"] = (mtime["_reduced_genotype_list.out"]
                     - mtime["_reduced_ref.fa"])
    return stdout, secs


def worker_ready(dev_name: str) -> float:
    """In a spawn worker: seconds to import the port's run chain and open
    the device (what a smartseq pool worker does before its first
    cell)."""
    t0 = time.perf_counter()
    import torch

    import t1k_tpu_torch.cli.run  # noqa: F401
    torch.zeros(1, device=dev_name).sum().item()
    return time.perf_counter() - t0


def worker_startup(dev, workers: int) -> tuple:
    """(seconds from a smartseq-style spawn pool's creation to all its
    workers ready, the slowest worker's own import and device seconds)."""
    import multiprocessing

    from t1k_tpu_torch.tools import smartseq

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=smartseq._share_cores,
                  initargs=(workers,)) as pool:
        ready = pool.map(worker_ready, [str(dev)] * workers)
    return time.perf_counter() - t0, max(ready)


def phase_smartseq(dev, work: str, info: dict, plate: tuple) -> tuple:
    """The SMART-seq plate through the port's smartseq tool on two
    routes, each in a child process with `workers` spawn workers and its
    own work directory: the native route (T1K_BACKEND=native: the host
    engine and the per-cell native EM), then --cohortEm on `dev` (the
    second pass's EM batched).  Every plate file, each cell's first-pass
    outputs and each cell's second-pass outputs byte-compared;
    probe, chain, band and the batched EM must launch.  Returns (launch
    counts over the card route's run, its pickled batched-EM arguments'
    path)."""
    import pickle

    n_cells, counts, workers = plate
    panel = os.path.join(work, "panel.fa")
    t0 = time.perf_counter()
    list1, list2 = plate_inputs(work, panel, n_cells, counts)
    info["inputs_s"] = f"{time.perf_counter() - t0:.1f}"
    args = ["-1", list1, "-2", list2, "-f", panel, "-o", "plate",
            "--workers", str(workers)]
    secs, dirs = {}, {r: os.path.join(work, f"ss{r}")
                      for r in ("native", "port")}
    native, secs["native"] = smartseq_route(
        native_cmd("tools.smartseq", *args), dirs["native"],
        dict(child_env(), T1K_BACKEND="native"))
    info["native_cuda_context"] = cuda_context(native)
    problems = os.path.join(work, "plate_em.pkl")
    out, secs["port"] = smartseq_route(
        [sys.executable, "-c", PORT_SMARTSEQ, problems, *args, "--cohortEm",
         "--device", str(dev)], dirs["port"], child_env())
    launches = json.loads(out.splitlines()[-1])
    paths = ["plate" + s for s in PLATE_OUTPUTS] + [
        os.path.join(f"plate_cell{c:02d}", f"cell{c:02d}{s}")
        for c in range(n_cells) for s in CELL_OUTPUTS]
    for rel in paths:
        got = []
        for d in dirs.values():
            with open(os.path.join(d, rel), "rb") as f:
                got.append(f.read())
        if got[0] != got[1]:
            raise AssertionError(f"smartseq {rel} differs from the native "
                                 "route")
    with open(os.path.join(dirs["port"], "plate_final_genotype.tsv")) as f:
        final = [line.rstrip("\n").split("\t") for line in f]
    with open(os.path.join(dirs["port"], "plate_merged_genotype.tsv")) as f:
        merged = [line.rstrip("\n").split("\t") for line in f]
    if len(final) != n_cells + 1:
        raise AssertionError(f"the final matrix has {len(final)} rows")
    if launches["band_stats_warp"] or launches["band_stats_group"]:
        raise AssertionError("the plate launched a wide-window band kernel")
    kernels = ("phase_a_probe", "phase_a_chain", "band_stats",
               "em_squarem_batched")
    if dev.type == "cuda" and min(launches[k] for k in kernels) <= 0:
        raise AssertionError(f"a kernel of the plate never launched: "
                             f"{launches}")
    with open(problems, "rb") as f:
        (cells, *_), _ = pickle.load(f)
    shapes = [(len(c[2]), len(c[0])) for c in cells]
    largest = max(shapes, key=lambda rc: rc[0] * rc[1])
    info["cells"] = n_cells
    info["pairs_per_cell"] = sum(counts)
    info["files_compared"] = len(paths)
    info["alleles_called"] = len(final[0]) - 2
    info["inconsistent_cells"] = sum(1 for r in merged[1:] if r[-1])
    info["final_inconsistent_cells"] = sum(1 for r in final[1:] if r[-1])
    info["em_problems"] = len(cells)
    info["largest_em_problem"] = f"{largest[0]}x{largest[1]}"
    info["em_nnz_total"] = sum(len(c[1][1]) for c in cells)
    info.update({f"{k}_launches": v for k, v in launches.items()})
    ready = worker_startup(dev, workers)
    info["pool_ready_s"] = f"{ready[0]:.2f}"
    info["worker_ready_s"] = f"{ready[1]:.2f}"
    print("  smartseq walls (child processes, host clock): " + json.dumps(
        {route: {k: round(v, 3) for k, v in s.items()}
         for route, s in secs.items()}), flush=True)
    return launches, problems


# benchmarks/cohort_em.py's default cell: read groups, ECs, alleles, genes
COHORT_CELLS = 384
COHORT_RG, COHORT_EC, COHORT_ALLELES, COHORT_GENES = 600, 48, 160, 16


def cohort_problem(seed: int, n_alleles: int, K: int, G: int):
    """One cell of benchmarks/cohort_em.py (make_problem, copied): K ECs
    of 1-3 alleles, G read groups of 1-4 ECs, counts 1-19."""
    r = np.random.default_rng(seed)
    pool = list(range(n_alleles))
    r.shuffle(pool)
    ecs, used = [], 0
    for _ in range(K):
        sz = int(r.integers(1, 4))
        ecs.append(sorted(pool[used:used + sz]))
        used = (used + sz) % (n_alleles - 4)
    rg_off, rg_ecs = [0], []
    for _ in range(G):
        n = int(r.integers(1, 5))
        rg_ecs.extend(sorted(r.choice(K, n, replace=False).tolist()))
        rg_off.append(len(rg_ecs))
    counts = r.integers(1, 20, G).astype(np.float64)
    return (ecs, (np.array(rg_off), np.array(rg_ecs)), counts,
            np.ones(n_alleles))


def cohort_plate(n_cells: int) -> tuple:
    """benchmarks/cohort_em.py's cohort (its reference tables and cells
    1000, 1001, ...) as em_quantify_batched's positional arguments and
    options."""
    n_alleles, n_genes = COHORT_ALLELES, COHORT_GENES
    rng = np.random.default_rng(1)
    eff_len = rng.integers(800, 1600, n_alleles).astype(np.float64)
    problems = [cohort_problem(1000 + i, n_alleles, COHORT_EC, COHORT_RG)
                for i in range(n_cells)]
    return ((problems, eff_len,
             (np.arange(n_alleles) % n_genes).astype(np.int32),
             (np.arange(n_alleles) // 2).astype(np.int32), n_genes,
             n_alleles // 2),
            dict(filter_frac=0.15, min_squarem_alpha=0.0))


def cohort_case(dev, name: str, cohort: tuple, add_ns: float, sms: int,
                info: dict):
    """One cohort through the batched EM: the batched launches at
    ops/em.py's widths (tables on the card), the same cells forced to
    1,024 threads, one single-problem launch per cell on one stream, the
    per-cell native loop and the plain version (on the CPU), in turns
    (native, batched, 1,024, unstaged, singles, plain, native, unstaged,
    1,024, batched, singles: unstaged is the cells' widths with every
    list left in device memory), then every cell forced to each of
    em.COHORT_WIDTHS in turns (in order, then reversed), each held to
    the native loop bit for bit per cell.  Per launch of the widths' and
    the 1,024-thread form:
    registers, local bytes and resident blocks an SM at its shared bytes
    (the kernel's attributes), and the waves its cells take; a launch of
    the widths' f64 kernels with local bytes fails.  The bound is the
    largest of the longest cell's add chain (em_chain_adds at `add_ns`),
    the cells' chains spread over `sms` SMs x 64 resident warps (a chain
    holds at least one warp, whatever the design), and the cohort's
    bytes/operations (em_work; the reference tables once).  Returns
    (batched ms, plain ms, (bound ms, bound by), max |batched - plain|,
    {1,024-thread ms, unstaged ms, {width: ms}})."""
    import torch

    from t1k_tpu_torch.native import em_quantify
    from t1k_tpu_torch.ops import em

    (problems, eff_len, gene, major, n_genes, n_majors), kw = cohort
    opts = dict(filter_frac=kw["filter_frac"],
                min_squarem_alpha=kw["min_squarem_alpha"],
                max_iterations=1000)
    cuda = dev.type == "cuda"
    f64 = torch.float64
    pre = f"{name}_"
    problems = [p for p in problems if len(p[0])]
    t0 = time.perf_counter()
    cells = [em.em_tables(p[0], p[1], p[2], eff_len, p[3], gene, major,
                          n_genes, n_majors) for p in problems]
    info[pre + "tables_ms"] = f"{(time.perf_counter() - t0) * 1e3:.1f}"

    def native():
        return [em_quantify(p[0], p[1], p[2], eff_len, np.zeros(len(gene)),
                            p[3], gene, major, n_genes, n_majors, **opts)
                for p in problems]

    def plain():
        return [(it, c.numpy()) for it, c in em.squarem_batched_plain(
            cells, **opts, device="cpu", dtype=f64)]

    widths = em.COHORT_WIDTHS
    if cuda:
        t0 = time.perf_counter()
        batch_dev = em.squarem_batched_device(cells, dev, f64)
        torch.cuda.synchronize()
        info[pre + "upload_ms"] = f"{(time.perf_counter() - t0) * 1e3:.1f}"
        forced = {w: em.squarem_batched_device(cells, dev, f64, width=w)
                  for w in widths}
        unstaged = em.squarem_batched_device(cells, dev, f64, stage=False)
        singles = [em.squarem_device(**t, device=dev, dtype=f64)
                   for t in cells]

        def launcher(bd):
            return lambda: em.squarem_batched_launch(bd, **opts)

        def reader(bd):
            return lambda: [(it, c.cpu().numpy()) for it, c in
                            em.squarem_batched_results(bd)]

        def single():
            for d in singles:
                em.squarem_launch(d, **opts)

        def single_result():
            return [(int(d["iterations"].item()), d["count"].cpu().numpy())
                    for d in singles]
        batched, batched_result = launcher(batch_dev), reader(batch_dev)
        runs = {w: (launcher(forced[w]), reader(forced[w])) for w in widths}
        runs["unstaged"] = launcher(unstaged), reader(unstaged)
        info[pre + "launches"] = len(batch_dev["launches"])
        info[pre + "staged_cells"] = int(sum(
            len(g["cells"]) for g in batch_dev["launches"]
            if g["form"] == em.STAGED_FORM))
        for tag, bd in (("", batch_dev), ("w1024_", forced[1024])):
            for g in bd["launches"]:
                a = em.batched_kernel_attrs(f64, g["form"], g["width"],
                                            g["bytes"])
                form = ("device", "shared", "staged")[g["form"]]
                waves = -(-len(g["cells"]) // max(a["blocks_per_sm"] * sms,
                                                  1))
                info[f"{pre}{tag}{form}{g['width']}"] = (
                    f"cells:{len(g['cells'])},regs:{a['registers']},"
                    f"local:{a['local_bytes']},smem:{g['bytes']},"
                    f"blocks_per_sm:{a['blocks_per_sm']},waves:{waves}")
                if not tag and a["local_bytes"]:
                    raise AssertionError(
                        f"cohort {name}: the {form} kernel of width "
                        f"{g['width']} has {a['local_bytes']} bytes of "
                        "local memory")
    else:  # CPU rehearsal: the plain version stands in for every kernel
        out = []

        def batched():
            out[:] = plain()
        single = batched

        def batched_result():
            return out
        single_result = batched_result
        runs = {w: (batched, batched_result) for w in (*widths, "unstaged")}

    def host_ms(fn):
        t0 = time.perf_counter()
        got = fn()
        return (time.perf_counter() - t0) * 1e3, got

    want = native()

    def check(route, res):
        for c, ((it, count), (it_w, count_w)) in enumerate(zip(res, want)):
            if it != it_w or count.tobytes() != count_w.tobytes():
                raise AssertionError(f"cohort {name}: {route} differs from "
                                     f"the native loop in cell {c}")
    reps = 20 if cuda else 1
    times = {k: [] for k in ("native", "batched", "forced1024", "unstaged",
                             "singles", "plain")}
    plain_out = None
    for turn in range(2):
        ms, got = host_ms(native)
        times["native"].append(ms)
        check("native", got)
        pair = [("batched", batched, batched_result),
                ("forced1024", *runs[1024]), ("unstaged", *runs["unstaged"])]
        for route, fn, result in pair if turn == 0 else pair[::-1]:
            times[route].append(time_ms(fn, reps, dev))
            check(route, result())
        times["singles"].append(time_ms(single, 3 if cuda else 1, dev))
        check("singles", single_result())
        if turn == 0:
            ms, plain_out = host_ms(plain)
            times["plain"].append(ms)
            check("plain", plain_out)
    width_ms = {w: [] for w in widths}
    for order in (widths, widths[::-1]):
        for w in order:
            width_ms[w].append(time_ms(runs[w][0], reps, dev))
            check(f"width {w}", runs[w][1]())
    err = max(float(np.abs(b[1] - p[1]).max(initial=0))
              for b, p in zip(batched_result(), plain_out))
    iters = np.array([it for it, _ in want])
    chain_ms = np.array([em_chain_adds(t, it) for t, it in zip(cells, iters)]
                        ) * add_ns / 1e6
    work = [em_work(t, it, reference=False) for t, it in zip(cells, iters)]
    ref_bytes = sum(cells[0][k].nbytes for k in EM_REFERENCE_TABLES)
    work_ms, work_by = bound(sum(w[0] for w in work) + ref_bytes,
                             sum(w[1] for w in work), F64_PER_S)
    spread_ms = chain_ms.sum() / (sms * WARPS_PER_SM)
    b = max((chain_ms.max(), "operations"), (spread_ms, "operations"),
            (work_ms, work_by))
    info[pre + "cells"] = len(cells)
    info[pre + "nnz"] = sum(len(t["rg_ecs"]) for t in cells)
    largest = max(cells, key=lambda t: len(t["rg_counts"]) * len(t["ec_len"]))
    info[pre + "largest"] = \
        f"{len(largest['rg_counts'])}x{len(largest['ec_len'])}"
    info[pre + "iterations"] = f"{iters.min()}-{iters.max()}"
    for k, v in times.items():
        info[pre + k + "_ms"] = " ".join(f"{t:.4f}" for t in v)
    for w, v in width_ms.items():
        info[f"{pre}w{w}_ms"] = " ".join(f"{t:.4f}" for t in v)
    info[pre + "longest_chain_ms"] = f"{chain_ms.max():.4f}"
    info[pre + "spread_chain_ms"] = f"{spread_ms:.6f}"
    info[pre + "work_bound_ms"] = f"{work_ms:.6f}"
    info[pre + "bound_share"] = f"{b[0] / np.mean(times['batched']):.4f}"
    return (float(np.mean(times["batched"])), float(times["plain"][0]), b,
            err, dict(ms_1024=float(np.mean(times["forced1024"])),
                      unstaged_ms=float(np.mean(times["unstaged"])),
                      width_ms={w: float(np.mean(v))
                                for w, v in width_ms.items()}))


def phase_cohort_em_timing(dev, problems_path: str, n_cells: int,
                           info: dict):
    """The cohort form of the EM kernel alone on (a) the problems the
    smartseq phase's port run solved in its second pass and (b)
    `n_cells` cells of benchmarks/cohort_em.py's default shape; the f64
    add latency from the clock probe.  Returns set (b)'s (batched ms,
    plain ms, bound, max |batched - plain|) and the record's extras: set
    (b)'s 1,024-thread and per-width times, set (a)'s times and bound."""
    import pickle

    import torch

    cuda = dev.type == "cuda"
    add_ns, sms = 4.0, 132   # CPU rehearsals: stand-ins
    if cuda:
        n_add = 1 << 22
        _, add_ms = em_clock_probe(dev, 0, n_add)
        add_ns = add_ms * 1e6 / n_add
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info["f64_add_ns"] = f"{add_ns:.4f}"
    info["sms"] = sms
    with open(problems_path, "rb") as f:
        args, kwargs = pickle.load(f)
    plate_ms, _, plate_bound, plate_err, plate_x = cohort_case(
        dev, "plate", (args, kwargs), add_ns, sms, info)
    ms, plain_ms, b, err, extras = cohort_case(
        dev, "cohort", cohort_plate(n_cells), add_ns, sms, info)
    extras.update(plate_ms=plate_ms, plate_ms_1024=plate_x["ms_1024"],
                  plate_width_ms=plate_x["width_ms"],
                  plate_bound_ms=plate_bound[0])
    return ms, plain_ms, b, max(err, plate_err), extras


# t1k_tpu/parallel/scaling_bench.py's problem: read groups, ECs (8 entries
# a group on average), and its iterations
SCALING_RG, SCALING_EC, SCALING_ITERATIONS = 200_000, 4_096, 20
SHARDS = (1, 2, 4)
COHORT_SPLITS = (2, 4)

# one rank of em_quantify_multihost on the scaling problem: argv backend,
# device, output directory and the problem's size; saves
# x_<backend>_<rank>.npy and prints its launch counts and the
# milliseconds of one update's hand-offs (the column chain's receive and
# send, and the broadcast) as the last line
MULTIHOST_CHILD = (
    "import json, os, sys, time\n"
    "import numpy as np, torch\n"
    "import torch.distributed as dist\n"
    "import chip_smoke as cs\n"
    "from t1k_tpu_torch.ops import em\n"
    "from t1k_tpu_torch.parallel import multihost\n"
    "backend, device, out, rg, ec = sys.argv[1:6]\n"
    "rank = multihost.initialize_from_env(device, backend)\n"
    "em.launch_counts.update(dict.fromkeys(em.launch_counts, 0))\n"
    "x = multihost.em_quantify_multihost(\n"
    "    *cs.scaling_problem(int(rg), int(ec)),\n"
    "    iterations=cs.SCALING_ITERATIONS, device=device)\n"
    "np.save(os.path.join(out, f'x_{backend}_{rank}.npy'), x)\n"
    "launches = dict(em.launch_counts)\n"
    "count = torch.ones(len(x), device=multihost.rank_device(device))\n"
    "mesh = multihost.global_data_mesh()\n"
    "sync = torch.cuda.synchronize if count.is_cuda else (lambda: None)\n"
    "def hand_offs():\n"
    "    multihost.receive_partial(count, mesh, rank)\n"
    "    multihost.pass_on(count, mesh, rank)\n"
    "hand_offs()\n"
    "sync()\n"
    "t0 = time.perf_counter()\n"
    "for _ in range(20):\n"
    "    hand_offs()\n"
    "sync()\n"
    "launches['hand_off_ms'] = (time.perf_counter() - t0) * 1e3 / 20\n"
    "dist.destroy_process_group()\n"
    "print(json.dumps(launches))\n")


def scaling_problem(rg_cnt: int = SCALING_RG, ec_cnt: int = SCALING_EC):
    """t1k_tpu_torch/parallel/scaling_bench.py's problem (seed 11): 8
    entries of count 1 a read group on average, repeats among them, as
    em_quantify_sharded's (seg_rg, seg_ec, counts, rg_cnt, ec_len,
    init_x)."""
    from t1k_tpu_torch.parallel.scaling_bench import scaling_problem as make

    p = make(rg_cnt, ec_cnt)
    return (p["seg_rg"], p["seg_ec"], p["counts"], p["rg_cnt"], p["ec_len"],
            p["init"])


def sharded_args(problem: dict) -> tuple:
    """An em_quantify_gpu problem as em_quantify_sharded_squarem's
    arguments after the mesh (counts per read group), and its options."""
    rg_off, rg_ecs = problem["rg_ecs_csr"]
    rg_cnt = len(problem["rg_counts"])
    args = (np.repeat(np.arange(rg_cnt), np.diff(rg_off)), np.asarray(rg_ecs),
            np.asarray(problem["rg_counts"], np.float64), rg_cnt,
            problem["ec_to_alleles"], problem["allele_eff_len"],
            problem["allele_weight"], problem["allele_gene"],
            problem["allele_major"], problem["n_genes"], problem["n_majors"])
    return args, {k: problem[k] for k in ("filter_frac", "min_squarem_alpha",
                                          "max_iterations")}


def sharded_state(mesh, args, opts):
    """em_quantify_sharded_squarem's host loop state on `mesh` (f64),
    built (tables and uploads) but not run."""
    import torch

    from t1k_tpu_torch.ops import em
    from t1k_tpu_torch.parallel import mesh as pm

    seg_rg, seg_ec, counts, rg_cnt, ec_to_alleles, *ref = args
    ec = em.ec_tables(ec_to_alleles, *ref)
    return pm.ShardedEM(mesh, seg_rg, seg_ec, counts[seg_rg], rg_cnt,
                        len(ec_to_alleles), torch.float64, ec["ec_len"],
                        ec["init_x"], **opts,
                        mask={k: ec[k] for k in pm.MASK_TABLES})


def multihost_children(work: str, dev, rg: int, ec: int) -> list:
    """Starts em_quantify_multihost's ranks on the scaling problem: two
    Gloo ranks on `dev`'s card (or the CPU) and, on a card, one NCCL rank
    alone; returns the processes."""
    import socket

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    device = "cuda" if dev.type == "cuda" else "cpu"
    groups = [("gloo", 2)] + ([("nccl", 1)] if dev.type == "cuda" else [])
    procs = []
    for backend, world in groups:
        port = free_port()
        for rank in range(world):
            env = dict(child_env(), T1K_COORDINATOR=f"127.0.0.1:{port}",
                       T1K_NUM_PROCESSES=str(world),
                       T1K_PROCESS_ID=str(rank))
            procs.append((backend, rank, subprocess.Popen(
                [sys.executable, "-c", MULTIHOST_CHILD, backend, device,
                 work, str(rg), str(ec)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


@contextlib.contextmanager
def fused_columns():
    """ops.em's column pass as the first design's fused kernel (no term
    pass; estep_cols_fused_cuda for the fold), to time the sharded loop in
    turns with it."""
    from t1k_tpu_torch.ops import em

    saved = em.estep_terms, em.estep_fold
    em.estep_terms = lambda est, x: None
    em.estep_fold = em.estep_cols_fused_cuda
    try:
        yield
    finally:
        em.estep_terms, em.estep_fold = saved


def sparse_estep(dev, est_tables: dict, x):
    """The E-step as two torch.sparse CSR products (not em.cc's order; the
    counts per read group):
    psum = A x (0 -> 1), local = x * (A^T (counts / psum)), A the shard's
    read group x EC incidence of ones."""
    import warnings

    import torch

    row_off = est_tables["row_off"]
    n_rows, ec_cnt = len(row_off) - 1, est_tables["ec_cnt"]
    # CSR wants each row's columns ascending
    row = np.repeat(np.arange(n_rows), np.diff(row_off))
    ecs = torch.as_tensor(np.asarray(est_tables["row_ecs"], np.int64)[
        np.lexsort((est_tables["row_ecs"], row))])
    row_off = torch.as_tensor(row_off)
    ones = torch.ones(len(ecs), dtype=x.dtype)
    with warnings.catch_warnings():  # torch.sparse's "beta state" note
        warnings.simplefilter("ignore")
        a = torch.sparse_csr_tensor(row_off, ecs, ones, (n_rows, ec_cnt),
                                    check_invariants=True).to(dev)
        at = torch.sparse_csr_tensor(
            torch.as_tensor(est_tables["col_off"]),
            torch.as_tensor(est_tables["col_rows"], dtype=torch.int64), ones,
            (ec_cnt, n_rows), check_invariants=True).to(dev)
    row_cts = torch.zeros(n_rows, dtype=x.dtype)
    row_cts[torch.as_tensor(est_tables["col_rows"], dtype=torch.int64)] = \
        torch.as_tensor(est_tables["col_cts"], dtype=x.dtype)
    row_cts = row_cts.to(dev)

    def run():
        psum = a @ x
        w = row_cts / torch.where(psum == 0, 1.0, psum)
        return x * (at @ w)
    return run


def estep_bound(tables: dict, add_ns: float, itemsize: int = 8):
    """(bound ms, bound by) of one E-step of a shard: its list bytes and
    gathers (per entry: the rows' index and x gather, the columns' index,
    count and psum gather; per row its psum; per EC x and the local
    count) at the memory rate, against its longest dependent chain (the
    longest row plus the longest column) at `add_ns`."""
    nnz, ec = len(tables["row_ecs"]), tables["ec_cnt"]
    rows = len(tables["row_off"]) - 1
    n_bytes = nnz * (4 + itemsize + 4 + 2 * itemsize) + itemsize * (
        rows + 2 * ec)
    chain = (int(np.diff(tables["row_off"]).max(initial=0))
             + int(np.diff(tables["col_off"]).max(initial=0)))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_chain = chain * add_ns / 1e6
    return (t_chain, "operations") if t_chain > t_bytes else (t_bytes,
                                                              "bytes")


def dryrun_scaling(dev, sizes: dict, info: dict) -> dict:
    """The dry run (parallel/dryrun.py: band kernel, FragWeight, sharded
    SQUAREM in f32 and f64 against the native loop) and the scaling
    bench's two loops (parallel/scaling_bench.py) over [dev] x n, n in
    SHARDS; the dry runs' launch counts set to 0 just before them and read
    just after.  Prints the bench's JSON line; returns those counts."""
    from t1k_tpu_torch.ops import align_band as ab
    from t1k_tpu_torch.ops import em
    from t1k_tpu_torch.parallel import scaling_bench as sb

    mesh_of = {n: [dev] * n for n in SHARDS}
    ab.launch_counts.update(dict.fromkeys(ab.launch_counts, 0))
    em.launch_counts.update(dict.fromkeys(em.launch_counts, 0))
    step = sb.bench_full_step(mesh_of)
    dry = {key: d[key] for d, key in ((ab.launch_counts, "band_stats_group"),
                                      (ab.launch_counts, "band_stats_warp"),
                                      (em.launch_counts, "em_squarem"),
                                      *((em.launch_counts, k)
                                        for k in em.ESTEP_KERNELS))}
    if dev.type == "cuda" and min(v for k, v in dry.items()
                                  if k != "band_stats_warp") <= 0:
        raise AssertionError(f"a dry-run kernel never launched: {dry}")
    if dry["band_stats_warp"] or ab.launch_counts["band_stats"]:
        raise AssertionError(f"the dry runs left the lane-group kernel: "
                             f"{dict(ab.launch_counts)}")
    em_scaling = sb.bench_em(mesh_of, sb.scaling_problem(*sizes["scaling"]))
    for n in SHARDS:
        info[f"dryrun_n{n}_s"] = step[n]["s_per_step"]
        info[f"scaling_n{n}_ms"] = em_scaling[n]["ms_per_iteration"]
    info["dryrun_launches"] = " ".join(f"{k}:{v}" for k, v in dry.items())
    print(json.dumps({"metric": "sharded_em_scaling", "results": em_scaling,
                      "full_step_weak_scaling": step}), flush=True)
    return dry


def phase_sharded_em(dev, hla: dict, plate_em: str, sizes: dict, work: str,
                     info: dict):
    """The sharded EM (parallel/mesh.py, multihost.py; the sharded form of
    em_squarem.cu) on one card; see the module docstring.  Returns ((E-step
    ms, plain ms, bound), its launches on the main path, the kernel
    record's other fields)."""
    import pickle

    import torch

    from t1k_tpu_torch.native import em_quantify
    from t1k_tpu_torch.ops import em
    from t1k_tpu_torch.parallel import mesh as pm

    cuda = dev.type == "cuda"
    cpu, f64 = torch.device("cpu"), torch.float64
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    scaling = scaling_problem(*sizes["scaling"])
    children = multihost_children(work, dev, *sizes["scaling"])
    problems = {"hla": hla, "large": em_large(*sizes["em_large"])}
    cases = {name: (*sharded_args(p), em_quantify(**p))
             for name, p in problems.items()}
    # the main path: the sharded SQUAREM at each mesh size, its launch
    # counts set to 0 just before and read just after
    em.launch_counts.update(dict.fromkeys(em.launch_counts, 0))
    solved = {(name, n): pm.em_quantify_sharded_squarem(
        [dev] * n, *args, **opts, single_dispatch=False)
        for name, (args, opts, _) in cases.items() for n in SHARDS}
    launches = dict(em.launch_counts)
    if cuda and not all(launches[k] for k in (*em.ESTEP_KERNELS,
                                              "em_sharded_tail")):
        raise AssertionError(f"sharded EM kernels not launched: {launches}")
    for (name, n), (it, count) in solved.items():
        it_n, count_n = cases[name][2]
        if it != it_n or count.tobytes() != count_n.tobytes():
            raise AssertionError(f"sharded EM {name} n={n}: {it} iterations "
                                 f"(native {it_n}), counts "
                                 f"{np.abs(count - count_n).max()} from the "
                                 "native loop's")
    for name, (args, opts, _) in cases.items():
        it, count = pm.em_quantify_sharded_squarem([dev], *args, **opts)
        if (it, count.tobytes()) != (solved[name, 1][0],
                                     solved[name, 1][1].tobytes()):
            raise AssertionError(f"sharded EM {name}: the single dispatch "
                                 "differs from the host loop")
    args, opts, _ = cases["hla"]
    for n in SHARDS[1:]:
        it, count = pm.em_quantify_sharded_squarem([cpu] * n, *args, **opts)
        if (it, count.tobytes()) != (solved["hla", n][0],
                                     solved["hla", n][1].tobytes()):
            raise AssertionError(f"sharded EM hla n={n}: card differs from "
                                 "the CPU's plain version")
    info["iterations"] = ",".join(f"{k}:{cases[k][2][0]}" for k in cases)

    # the cohort's cell axis over [dev] * k: every cell the native bits
    with open(plate_em, "rb") as f:
        plate = pickle.load(f)
    for name, (cargs, ckw) in (("plate", plate),
                               ("cohort", cohort_plate(sizes["cohort"]))):
        problems_c, eff_len, gene, major, n_genes, n_majors = cargs
        copts = {k: ckw[k] for k in ("filter_frac", "min_squarem_alpha")}
        want = [em_quantify(p[0], p[1], p[2], eff_len, np.zeros(len(gene)),
                            p[3], gene, major, n_genes, n_majors, **copts)
                if len(p[0]) else (0, np.zeros(0)) for p in problems_c]
        for k in (1, *COHORT_SPLITS):
            t0 = time.perf_counter()
            got = em.em_quantify_batched(
                *cargs, **copts, device=dev,
                devices=None if k == 1 else [dev] * k)
            info[f"{name}_cells_x{k}_ms"] = \
                f"{(time.perf_counter() - t0) * 1e3:.1f}"
            for c, ((it, cnt), (it_w, cnt_w)) in enumerate(zip(got, want)):
                if it != it_w or cnt.tobytes() != cnt_w.tobytes():
                    raise AssertionError(f"cohort {name} over {k} devices: "
                                         f"cell {c} differs from native")

    # the plain EM on the scaling problem at each mesh size, then its ranks
    xs = {n: pm.em_quantify_sharded([dev] * n, *scaling,
                                    iterations=SCALING_ITERATIONS)
          for n in SHARDS}
    for n in SHARDS[1:]:
        if xs[n].tobytes() != xs[1].tobytes():
            raise AssertionError(f"sharded plain EM n={n} differs from n=1")
    ranks = {}
    for backend, rank, proc in children:
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{backend} rank {rank} failed:\n"
                                 f"{err[-3000:]}")
        ranks[backend, rank] = json.loads(out.strip().splitlines()[-1])
        x = np.load(os.path.join(work, f"x_{backend}_{rank}.npy"))
        want = xs[2 if backend == "gloo" else 1]
        if x.tobytes() != want.tobytes():
            raise AssertionError(f"{backend} rank {rank} differs from the "
                                 "in-process run")
        info[f"{backend}{rank}_hand_off_ms"] = \
            f"{ranks[backend, rank]['hand_off_ms']:.4f}"
    info["multihost_ranks"] = len(ranks)
    info["multihost_estep_launches"] = sum(r[k] for r in ranks.values()
                                           for k in em.ESTEP_KERNELS)
    dry = dryrun_scaling(dev, sizes, info)

    # timings: the solves in turns with K5 and the native loop; then one
    # update's pieces on a built problem; at n = 1 the E-step and the
    # column pass in turns with the first design's fused column pass
    # (fused, split, split, fused), the term pass and the fold alone
    add_ns = 4.0
    if cuda:
        _, add_ms = em_clock_probe(dev, 0, 1 << 22)
        add_ns = add_ms * 1e6 / (1 << 22)
    info["f64_add_ns"] = f"{add_ns:.4f}"
    extras, ab = {}, {}
    for name, (args, opts, _) in cases.items():
        problem = problems[name]
        tables = em.em_tables(**{k: v for k, v in problem.items() if k not in
                                 ("allele_missing", *opts)})
        k5 = em.squarem_device(**tables, device=dev, dtype=f64) if cuda \
            else None
        ms = {k: [] for k in ("native", "k5_kernel", "k5_wrapper",
                              *(f"solve_n{n}" for n in SHARDS),
                              *(f"loop_n{n}" for n in SHARDS))}

        def host(fn):
            t0 = time.perf_counter()
            fn()
            sync()
            return (time.perf_counter() - t0) * 1e3
        for _ in range(2):
            ms["native"].append(host(lambda: em_quantify(**problem)))
            if cuda:
                ms["k5_kernel"].append(time_ms(
                    lambda: em.squarem_launch(k5, **opts), 2, dev))
            ms["k5_wrapper"].append(host(
                lambda: em.em_quantify_gpu(**problem, device=dev)))
            for n in SHARDS:
                ms[f"solve_n{n}"].append(host(
                    lambda: pm.em_quantify_sharded_squarem(
                        [dev] * n, *args, **opts, single_dispatch=False)))
                sh = sharded_state([dev] * n, args, opts)
                ms[f"loop_n{n}"].append(host(sh.squarem))
        if cuda:   # one shard's loop with the fused column pass, in turns
            ms.update(loop_fused_n1=[], loop_split_n1=[])
            sh = sharded_state([dev], args, opts)   # squarem starts anew
            for key in ("loop_fused_n1", "loop_split_n1", "loop_split_n1",
                        "loop_fused_n1"):
                out = []
                with (fused_columns() if key == "loop_fused_n1"
                      else contextlib.nullcontext()):
                    ms[key].append(host(lambda: out.append(sh.squarem())))
                it, count = out[0]
                if (it, count.cpu().numpy().tobytes()) != (
                        cases[name][2][0], cases[name][2][1].tobytes()):
                    raise AssertionError(f"sharded EM {name}: {key} "
                                         "differs from the native loop")
        for k, v in ms.items():
            info[f"{name}_{k}_ms"] = " ".join(f"{t:.3f}" for t in v)
        it = cases[name][2][0]
        chain_ms = em_chain_adds(tables, it) * add_ns / 1e6
        info[f"{name}_solve_chain_bound_ms"] = f"{chain_ms:.4f}"
        reps = 20 if cuda else 1
        for n in SHARDS:
            sh = sharded_state([dev] * n, args, opts)
            x, count = sh.td["x"][0], sh.td["count"]

            def rows(sh=sh, x=x):
                for est in sh.shards:
                    em.estep_rows(est, x)

            def cols(sh=sh, x=x, count=count):   # as ShardedEM.estep
                for est in sh.shards:
                    em.estep_terms(est, x)
                for s, est in enumerate(sh.shards):
                    em.estep_fold(est, x, count, s > 0)
            for key, fn in (("rows", rows), ("cols", cols),
                            ("tail", lambda sh=sh: em.tail(sh.td, 0))):
                info[f"{name}_n{n}_{key}_ms"] = \
                    f"{time_ms(fn, reps, dev):.4f}"
        # one shard's E-step alone: its set-up, the split against the
        # fused pass in turns, every form bit for bit
        seg_rg, seg_ec, counts, rg_cnt = args[:4]
        t0 = time.perf_counter()
        t = em.shard_tables(seg_rg, seg_ec, counts[seg_rg], rg_cnt,
                            len(args[4]))
        t1 = time.perf_counter()
        em.column_stream(t)
        t2 = time.perf_counter()
        est = em.estep_device(t, dev, f64)
        sync()
        info[f"{name}_setup_s"] = (
            f"shard_tables {t1 - t0:.4f} column_stream {t2 - t1:.4f} "
            f"estep_device {time.perf_counter() - t2:.4f}")
        x = torch.as_tensor(em.ec_tables(*args[4:])["init_x"], dtype=f64,
                            device=dev)
        count = torch.empty_like(x)

        def split():
            em.estep_terms(est, x)
            em.estep_fold(est, x, count, False)

        def fused():
            em.estep_cols_fused_cuda(est, x, count, False)
        pieces = {"estep": lambda: (em.estep_rows(est, x), split()),
                  "estep_fused": lambda: (em.estep_rows(est, x), fused()),
                  "cols": split, "cols_fused": fused,
                  "terms": lambda: em.estep_terms(est, x),
                  "fold": lambda: em.estep_fold(est, x, count, False)}
        order = ("estep_fused", "estep", "estep", "estep_fused",
                 "cols_fused", "cols", "cols", "cols_fused", "terms",
                 "fold") if cuda else ("estep", "cols", "terms", "fold")
        turns = {key: [] for key in order}
        em.estep_rows(est, x)   # psum for the column passes alone
        for key in order:
            turns[key].append(time_ms(pieces[key], reps, dev))
        for key, v in turns.items():
            info[f"{name}_ab_{key}_ms"] = " ".join(f"{ms:.4f}" for ms in v)
        ab[name] = {f"{key}_ms": float(np.mean(v)) for key, v in
                    turns.items()}
        ab[name]["tail_ms"] = float(info[f"{name}_n1_tail_ms"])
        ab[name]["tail_bound_ms"] = t["ec_cnt"] * add_ns / 1e6
        xz = x.clone()
        xz[::7] = 0
        pest = em.estep_device(t, dev, f64, plain=True)
        local, plain, independent = (torch.empty_like(x) for _ in range(3))

        def plain_split():
            em.estep_rows_plain(pest, xz)
            em.estep_terms_plain(pest, xz)
            em.estep_fold_plain(pest, xz, plain, False)
        ab[name]["plain_ms"] = time_ms(plain_split, 2, dev)
        em.estep_cols_plain(pest, xz, independent, False)
        em.estep_rows(est, xz)
        em.estep_terms(est, xz)
        em.estep_fold(est, xz, local, False)
        forms = {"plain split": plain, "estep_cols_plain": independent}
        if cuda:
            forms["fused pass"] = torch.empty_like(x)
            em.estep_cols_fused_cuda(est, xz, forms["fused pass"], False)
        for what, other in forms.items():
            if local.cpu().numpy().tobytes() != other.cpu().numpy().tobytes():
                raise AssertionError(f"sharded E-step {name}: the kernels "
                                     f"differ from the {what}")
        if name != "hla":
            continue
        # the kernel record: one update's E-step on the HLA problem, one
        # shard, against its plain split on the card and torch.sparse
        em.estep_rows(est, x)
        split()
        lib = sparse_estep(dev, t, x)
        # its first call also sets up cuSPARSE: checked, then timed
        lib_err = float(((lib() - count).abs() / count.abs().clamp_min(
            1e-300)).max())
        lib_ms = time_ms(lib, 20, dev)
        info["hla_estep_library_rel_err"] = f"{lib_err:.3e}"
        timed = (ab[name]["estep_ms"], ab[name]["plain_ms"],
                 estep_bound(t, add_ns))
        extras = dict(library_ms=lib_ms,
                      max_abs_err=float((local - plain).abs().max()),
                      **{k: v for k, v in ab[name].items() if k not in
                         ("estep_ms", "plain_ms")})
    extras.update(
        launches_dryrun=dry,
        solve_bound_ms=float(info["hla_solve_chain_bound_ms"]),
        **{f"launches_{k[len('em_sharded_'):]}": launches[k]
           for k in (*em.ESTEP_KERNELS, "em_sharded_tail")},
        launches_multihost=info["multihost_estep_launches"],
        large=ab["large"],
        solve_ms={f"{k}_n{n}": float(np.mean([float(v) for v in info[
            f"{k}_solve_n{n}_ms"].split()])) for k in cases for n in SHARDS},
        loop_ms={f"{k}_n{n}": float(np.mean([float(v) for v in info[
            f"{k}_loop_n{n}_ms"].split()])) for k in cases for n in SHARDS})
    return timed, sum(launches[k] for k in em.ESTEP_KERNELS), extras


# ------------------------------------------------------------ fuzz

# scripts/fuzz_torch.py's fuzzers and their cases, seeds FUZZ_SEED on:
# hla is the driver's case on this smoke's HLA-scale panel
FUZZ_PLAN = (("driver", 16), ("genotyper", 16), ("analyzer", 8),
             ("extractor", 8), ("bam", 8), ("smartseq", 1), ("hla", 2))
FUZZ_SEED = 0
FUZZ_HLA_PAIRS = 2_000
# kernel record -> the fuzz phase's counter
FUZZ_COUNTERS = {"band_stats": "band_stats",
                 "band_stats_group": "band_stats_group",
                 "band_stats_warp": "band_stats_warp",
                 "em_squarem": "em_squarem",
                 "em_squarem_batched": "em_squarem_batched",
                 "phase_a_probe": "phase_a_probe",
                 "phase_a_chain": "phase_a_chain",
                 "cand_census": "cand_census",
                 "device_candidates": "cand_chain",
                 "kmer_classify": "kmer_classify"}


def phase_fuzz(dev, work: str, info: dict) -> dict:
    """The differential fuzz layer (scripts/fuzz_torch.py) on fixed seeds:
    every case generated, then run in one card child (--backend gpu
    --emBackend gpu --device `dev`; seeds 3 mod 4 on the defaults) and
    one native child (--backend native --emBackend native under
    T1K_BACKEND=native) side by side, every output compared.  Any
    failing case fails; the native child must make no CUDA context and
    launch nothing; the card child must launch the probe, chain, band and
    EM kernels, K10 (census and bucket chain) in the --deviceCandidates
    cases and the cohort EM (K6) in the plate.  Returns the card child's
    launches over the phase."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import fuzz_torch

    fz = os.path.join(work, "fuzz")
    os.makedirs(fz)
    got = fuzz_torch.run_fuzz(FUZZ_PLAN, FUZZ_SEED, fz, str(dev),
                              hla_panel=os.path.join(work, "panel.fa"),
                              hla_pairs=FUZZ_HLA_PAIRS)
    summary = got["summary"]
    if got["failures"]:
        raise AssertionError(f"{len(got['failures'])} fuzz cases failed:\n"
                             + "\n".join(got["failures"]))
    if got["native_cuda_context"] or any(got["native_launches"].values()):
        raise AssertionError(f"the native child made a CUDA context or "
                             f"launched: {got['native_launches']}")
    total = {}
    for s in summary.values():
        for k, v in s["launches"].items():
            total[k] = total.get(k, 0) + v
    pruned = {k: sum(launches.get(k, 0) for _, _, _, argv, launches
                     in got["case_launches"] if "--deviceCandidates" in argv)
              for k in ("cand_census", "cand_chain")}
    if dev.type == "cuda":
        need = {k: total.get(k, 0) for k in (
            "phase_a_probe", "phase_a_chain", "band_stats", "em_squarem")}
        need.update(pruned, em_squarem_batched=summary["smartseq"][
            "launches"].get("em_squarem_batched", 0))
        if min(need.values()) <= 0:
            raise AssertionError(f"a kernel of the fuzz cases never "
                                 f"launched: {need}")
    for name, s in summary.items():
        info[name] = f"{s['ok']}/{s['both_failed']}/{s['fail']}"
    info["cases_s"] = f"{got['cases_s']:.1f}"
    info["children_s"] = f"{got['children_s']:.1f}"
    print("  fuzz (ok/both_failed/fail; card child's seconds a fuzzer, "
          "host clock): " + json.dumps({
              "summary": {k: {n: v for n, v in s.items() if n != "launches"}
                          for k, s in summary.items()},
              "seconds": {k: round(v, 3) for k, v in got["seconds"].items()},
              "card_startup_s": round(got["card_startup_s"], 3),
              "native_startup_s": round(got["native_startup_s"], 3),
              "native_cuda_context": got["native_cuda_context"],
              "launches": total, "launches_pruned": pruned}), flush=True)
    return total


SOURCES = ("band_stats", "em_squarem", "align_full", "phase_a_probe",
           "phase_a_chain", "cand_census", "kmer_classify")
# kernel record -> its source under t1k_tpu_torch/csrc/
KERNELS = {"band_stats": "band_stats", "band_stats_analyzer": "band_stats",
           "band_stats_group": "band_stats", "band_stats_warp": "band_stats",
           "em_squarem": "em_squarem", "em_squarem_batched": "em_squarem",
           "em_sharded": "em_squarem",
           "align_full": "align_full",
           "phase_a_probe": "phase_a_probe", "phase_a_chain": "phase_a_chain",
           "cand_census": "cand_census", "device_candidates": "phase_a_chain",
           "kmer_classify": "kmer_classify"}


def run(dev, sizes: dict) -> list:
    """Every phase after `card` on `dev`; returns the kernels' records."""
    import torch

    from t1k_tpu_torch.ops import _build, em

    checks = {name: Checker() for name in KERNELS}
    times = {}  # kernel -> (kernel ms, plain ms, (bound ms, bound by))
    cuda = dev.type == "cuda"
    if cuda:
        with phase("build") as info:
            t0 = time.perf_counter()
            _build.build_all(SOURCES)
            info["all_s"] = f"{time.perf_counter() - t0:.2f}"
            for name in SOURCES:
                with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
                    lines = f.read().splitlines()
                info[f"{name}_s"] = lines[1]
                for line in lines:
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {name}:", line.strip(), flush=True)
    with phase("kernel") as info:
        _, group_timed = phase_kernel(
            dev, checks["band_stats"], checks["band_stats_warp"],
            checks["band_stats_group"], sizes["random_items"], info)
        cuda and torch.cuda.synchronize()
    with phase("em") as info:
        phase_em(dev, *sizes["em"], info)
    with phase("v1") as info:
        v1_launches, times["align_full"], v1_extras = phase_v1(
            dev, checks["align_full"], sizes["v1_pairs"], info)
    with phase("screen") as info:
        phase_screen(dev, info)
        phase_screen_edges(dev, checks["phase_a_probe"],
                           checks["phase_a_chain"], info)
    with tempfile.TemporaryDirectory(prefix="t1k_smoke_") as work:
        with phase("main") as info:
            em_problems = []
            phase_main(dev, work, PANEL_GENES, PANEL_COPIES,
                       sizes["sim_pairs"], info, em_problems)
        with phase("distributed") as info:
            dist_launches = phase_distributed(dev, work, info, sizes["mp"])
        with phase("db") as info:
            db_launches = phase_db(dev, work, sizes["db"], info)
        with phase("candidates") as info:
            cand = phase_candidates(dev, work, info)
            for name, (timed, _, _) in cand.items():
                times[name] = timed
        with phase("em_timing") as info:
            *times["em_squarem"], em_err = phase_em_timing(
                dev, em_problems[0], sizes, info)
        with phase("composite") as info:
            composite_launches = phase_composite(dev, info)
        with phase("timing") as info:
            times["band_stats"], times["band_stats_warp"], group_chunk = \
                phase_timing(dev, checks["band_stats"],
                             checks["band_stats_warp"],
                             checks["band_stats_group"], work, 8192, info)
        with phase("extract") as info:
            prefix = phase_extract(dev, work, info, sizes["extract"])
        with phase("screen_timing") as info:
            times["phase_a_probe"], times["phase_a_chain"] = \
                phase_screen_timing(dev, checks["phase_a_probe"],
                                    checks["phase_a_chain"], work, prefix,
                                    info)
        with phase("run") as info:
            run_launches = phase_run(dev, work, info, sizes["run"])
        with phase("kmer") as info:
            times["kmer_classify"], kmer_launches, kmer_extras = phase_kmer(
                dev, checks["kmer_classify"], work, os.path.join(work, "run"),
                sum(sizes["run"]), info)
        with phase("bam_run") as info:
            bam_launches = phase_bam_run(dev, work, info, sizes["bam"])
        with phase("run_profile") as info:
            batch = phase_run_profile(dev, work, info)
        with phase("analyzer_timing") as info:
            times["band_stats_analyzer"] = phase_analyzer_timing(
                dev, checks["band_stats_analyzer"], batch, info)
        with phase("wgs") as info:
            wgs_launches = phase_wgs(dev, work, info, sizes["wgs"])
        with phase("smartseq") as info:
            plate_launches, plate_em = phase_smartseq(dev, work, info,
                                                      sizes["plate"])
        with phase("cohort_em_timing") as info:
            *times["em_squarem_batched"], batched_err, batched_extras = \
                phase_cohort_em_timing(dev, plate_em, sizes["cohort"], info)
        with phase("sharded_em") as info:
            times["em_sharded"], sharded_launches, sharded_extras = \
                phase_sharded_em(dev, em_problems[0], plate_em, sizes, work,
                                 info)
        with phase("fuzz") as info:
            fuzz_launches = phase_fuzz(dev, work, info)
    # launches over the run-t1k chain, the path users call (the band
    # kernel's as band_stats in the genotyper, band_stats_analyzer in the
    # analyzer); the v1 aligner (on no stage) over its own phase; the
    # batched EM over the SMART-seq plate; and over the run-t1k -b chain
    # and the plate (the v1 aligner's not counted there)
    dry1024 = group_timed["dryrun_1024"]
    times["band_stats_group"] = (dry1024[0], dry1024[2], dry1024[3])
    launches = dict(run_launches, align_full=sum(v1_launches.values()),
                    em_squarem_batched=plate_launches["em_squarem_batched"],
                    em_sharded=sharded_launches,
                    **{name: v[1] for name, v in cand.items()})
    replaces = {"band_stats": "t1k_tpu/ops/align_pallas_band.py:55",
                "band_stats_analyzer": "t1k_tpu/ops/align_pallas_band.py:55",
                "band_stats_group": "t1k_tpu/ops/align_pallas_band.py:55",
                "band_stats_warp": "t1k_tpu/ops/align_pallas_band.py:55",
                "em_squarem": "t1k_tpu/ops/em.py:213",
                "em_squarem_batched": "t1k_tpu/ops/em.py:359",
                "em_sharded": "t1k_tpu/parallel/mesh.py:125",
                "align_full": "t1k_tpu/ops/align_pallas.py:44",
                "phase_a_probe": "t1k_tpu/ops/phase_a.py:343",
                "phase_a_chain": "t1k_tpu/ops/phase_a.py:457",
                "cand_census": "t1k_tpu/ops/phase_a.py:754",
                "device_candidates": "t1k_tpu/ops/phase_a.py:803",
                "kmer_classify": "t1k_tpu/ops/kmer.py:110"}
    errs = {name: checks[name].max_err for name in KERNELS}
    errs["em_squarem"] = em_err
    errs["em_squarem_batched"] = batched_err
    errs["em_sharded"] = sharded_extras.pop("max_abs_err")
    for name, (_, _, extras) in cand.items():
        errs[name] = extras.pop("max_abs_err")
    dry_launches = sharded_extras.pop("launches_dryrun")
    # no single PyTorch call computes the others: their library_ms is null
    # the v1 aligner's paths as one kernel, align_full
    plate_launches["align_full"] = sum(
        v for k, v in plate_launches.items() if k.startswith("align_full_"))
    records = [{"name": name, "route": "cuda",
                "source": f"t1k_tpu_torch/csrc/{KERNELS[name]}.cu",
                "replaces": replaces[name], "launches": launches[name],
                "launches_bam_run": bam_launches.get(name),
                "launches_smartseq": plate_launches.get(name),
                "launches_wgs": wgs_launches.get(name),
                "launches_fuzz": fuzz_launches.get(FUZZ_COUNTERS[name], 0)
                if name in FUZZ_COUNTERS else None,
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": times[name][2][0],
                "bound_by": times[name][2][1], "library_ms": None}
               for name in KERNELS]
    records[list(KERNELS).index("align_full")].update(v1_extras)
    records[list(KERNELS).index("em_sharded")].update(
        sharded_extras, launches_dryrun=sum(
            dry_launches[k] for k in em.ESTEP_KERNELS))
    records[list(KERNELS).index("em_squarem_batched")].update(batched_extras)
    records[list(KERNELS).index("band_stats_warp")][
        "launches_dryrun"] = dry_launches["band_stats_warp"]
    # the lane-group kernel (no stage launches it): timed on the dry run's
    # 1,024-pair slice, its launches the dry runs' and the composite's
    records[list(KERNELS).index("band_stats_group")].update(
        launches_dryrun=dry_launches["band_stats_group"],
        launches_composite=composite_launches,
        warp_ms=group_timed["dryrun_1024"][1],
        batches={name: dict(ms=v[0], warp_ms=v[1], plain_ms=v[2],
                            bound_ms=v[3][0], cpl=v[4], sort=v[5])
                 for name, v in group_timed.items()},
        genotyper_chunk_ms=group_chunk)
    for name, (_, _, extras) in cand.items():
        records[list(KERNELS).index(name)].update(extras)
    # the genotyper's launches on the database the port built (db phase)
    for name, n in db_launches.items():
        records[list(KERNELS).index(name)]["launches_db"] = n
    # the in-process sharded genotyper's (distributed phase)
    for name, n in dist_launches.items():
        records[list(KERNELS).index(name)]["launches_distributed"] = n
    # K11 has no caller on any stage: its launches are the run chain's (0)
    records[list(KERNELS).index("kmer_classify")].update(
        replaces_direct="t1k_tpu/ops/kmer.py:144",
        launches_kmer_phase=kmer_launches, **kmer_extras)
    return records


FULL_SIZES = dict(random_items=RANDOM_ITEMS, em=(EM_RG, EM_EC),
                  em_large=EM_LARGE,
                  v1_pairs=V1_PAIRS, sim_pairs=SIM_PAIRS, mp=MP_PAIRS,
                  db=DB_PAIRS,
                  extract=EXTRACT_SMOKE_PAIRS, run=EXTRACT_PAIRS,
                  bam=BAM_PAIRS,
                  wgs=dict(genes=WGS_GENES, records=WGS_RECORDS,
                           read_genes=WGS_READ_GENES, pairs=WGS_PAIRS,
                           interleaved=WGS_INTERLEAVED, k=WGS_K),
                  plate=(PLATE_CELLS, PLATE_PAIRS, PLATE_WORKERS),
                  cohort=COHORT_CELLS, scaling=(SCALING_RG, SCALING_EC))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    with phase("card") as info:
        print(card_line(), flush=True)
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["python"] = sys.version.split()[0]
    kernels = run(torch.device("cuda"), FULL_SIZES)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
