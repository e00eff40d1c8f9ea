"""t1k_tpu_torch — t1k_tpu's extraction and genotyper stages on PyTorch and
CUDA.

A second package beside ``t1k_tpu``: it reuses that package's host-only
modules (the native C++ engine and f64 EM oracle, io, constants, the
fragment and genotyper bookkeeping, the output writers) and replaces the
code that touches a device:

  device.py          gpu_present / resolve_backend / resolve_device
  ops/align_band.py  band-packed stats aligner; CUDA kernel in
                     csrc/band_stats.cu, plain PyTorch version beside it
  ops/align.py       v1 full-row aligner; kernel csrc/align_full.cu
  ops/phase_a.py     phase-A k-mer table, probe (csrc/phase_a_probe.cu),
                     chain (csrc/phase_a_chain.cu) and DeviceScreen
  ops/em.py          SQUAREM EM on a torch device in the native loop's
                     order (f64 by default); kernel csrc/em_squarem.cu
  ops/_build.py      nvcc build and ctypes load of the kernels
  core/extractor.py  FASTQ extraction with the device screen
  core/genotyper.py  Genotyper with the torch EM route
  core/pipeline.py   genotyper stage (ingest -> dedupe -> deferred DP ->
                     fragments -> EM -> selection -> outputs)
  cli/extract.py     extraction command line (--backend gpu, --device)
  cli/genotype.py    command line (--backend gpu, --emBackend gpu)

It never imports jax, directly or through ``t1k_tpu.ops``.
"""

__version__ = "0.1.0"
