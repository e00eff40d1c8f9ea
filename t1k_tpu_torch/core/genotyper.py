"""Genotyper with the torch EM route.

``t1k_tpu.core.genotyper.Genotyper`` is host code except for its EM
dispatch, which imports ``t1k_tpu.ops.em`` and so jax.  This subclass
replaces that dispatch: ``em_backend`` takes "auto", "native" or "gpu",
and the "gpu" route runs ``em_quantify_gpu`` in f64 on ``device``,
bit-identical to the native loop.
"""

from __future__ import annotations

import os

import numpy as np

from t1k_tpu.constants import MAX_EM_ITERATIONS
from t1k_tpu.core.genotyper import Genotyper as _HostGenotyper
from t1k_tpu.native import em_quantify

from ..device import gpu_present
from ..ops.em import em_quantify_gpu

# "auto" sends the EM to the card only past this many dense cells: the
# JAX package's gate, kept until it is measured again on the card.
EM_DEVICE_MIN_CELLS = 5e7


class Genotyper(_HostGenotyper):
    """Statistical core with the EM on a torch device or the native loop."""

    def __init__(self, refset, config=None, device="cpu"):
        super().__init__(refset, config)
        self.device = device

    def quantify(self) -> int:
        """Run SQUAREM EM; returns the iteration count."""
        ec_cnt = len(self.ec_to_alleles)
        self._last_ec_read_count = np.zeros(ec_cnt, dtype=np.float64)
        if ec_cnt == 0:
            return 0
        rg_off, rg_ecs, rg_counts = self._read_group_csr()
        backend = self.cfg.em_backend
        if backend == "auto":
            backend = self._resolve_em_backend(len(rg_counts), ec_cnt)
        problem = (self.ec_to_alleles, (rg_off, rg_ecs), rg_counts,
                   self.allele_eff_len, self.allele_missing,
                   self.allele_weight, self.allele_gene, self.allele_major,
                   self.gene_cnt, self.major_cnt, self.cfg.filter_frac,
                   self.cfg.min_squarem_alpha, MAX_EM_ITERATIONS)
        if backend == "gpu":
            iters, ec_read_count = em_quantify_gpu(*problem,
                                                   device=self.device)
        elif backend == "native":
            iters, ec_read_count = em_quantify(*problem)
        else:
            raise ValueError(f"unknown EM backend {backend!r}")
        self._last_ec_read_count = ec_read_count
        self._set_allele_abundance(ec_read_count)
        return iters

    @staticmethod
    def _resolve_em_backend(rg_cnt: int, ec_cnt: int) -> str:
        """"auto" EM routing: the card when one is present and the
        [read group, EC] problem has at least EM_DEVICE_MIN_CELLS cells;
        the native f64 loop otherwise (the two are bit-identical).
        T1K_EM_BACKEND overrides."""
        env = os.environ.get("T1K_EM_BACKEND", "")
        if env in ("native", "gpu"):
            return env
        if rg_cnt * max(ec_cnt, 1) < EM_DEVICE_MIN_CELLS:
            return "native"
        return "gpu" if gpu_present() else "native"
