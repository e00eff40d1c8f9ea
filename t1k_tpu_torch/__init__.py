"""t1k_tpu_torch — t1k_tpu's extraction, genotyper and analyzer stages and
its run-t1k chain on PyTorch and CUDA.

A package of its own beside ``t1k_tpu``: it imports nothing of that
package and keeps its own copy of the host code it runs.

  native/            the C++ host engine (seed/chain/DP, extraction
                     screen, f64 EM, BAM scanner), built at first import
                     into build/t1k_tpu_torch/native/, with ctypes
                     bindings
  constants.py       the reference's numerical contracts
  io/                FASTA/FASTQ ingest, the allele reference model, and
                     io/bam.py: BAM I/O and BAM extraction with the
                     device screen
  device.py          gpu_present / resolve_backend / resolve_device:
                     "auto" runs on the card, or raises without one
  ops/align_band.py  band-packed stats aligner; CUDA kernel in
                     csrc/band_stats.cu, plain PyTorch version beside it
  ops/align.py       v1 full-row aligner; kernel csrc/align_full.cu
  ops/phase_a.py     phase-A k-mer table, probe (csrc/phase_a_probe.cu),
                     chain (csrc/phase_a_chain.cu) and DeviceScreen
  ops/em.py          SQUAREM EM on a torch device in the native loop's
                     order (f64 by default); kernel csrc/em_squarem.cu
  ops/_build.py      nvcc build and ctypes load of the kernels
  core/extractor.py  FASTQ extraction with the device screen
  core/genotyper.py  Genotyper: coalescing, ECs, EM dispatch, selection
  core/pipeline.py   genotyper stage (ingest -> dedupe -> deferred DP ->
                     fragments -> EM -> selection -> outputs)
  core/barcode.py    cell-barcode whitelist correction
  core/analyzer.py   the analyzer (core/fragment.py, core/variant.py)
  utils/             per-stage metrics; torch.profiler traces
  cli/extract.py     extraction command line (--backend gpu, --device)
  cli/bamextract.py  BAM extraction command line (--backend, --device)
  cli/genotype.py    command line (--backend gpu, --emBackend gpu)
  cli/analyze.py     analyzer command line
  cli/run.py         the run-t1k chain from FASTQ or BAM (-b -c)
  db/                the reference database build (.dat -> allele and
                     coordinate FASTAs; VCF, GTF and variant-panel
                     .dat generators), host code only

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``).  It never imports jax.
"""

__version__ = "0.1.0"
