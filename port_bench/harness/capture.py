"""What the output check reads from the program besides its output
files, taken as the chain makes it, in every run: each genotyper's read
groups and equivalence classes (Genotyper.finalize), each EM problem
with the program's answer (the genotyper module's em_quantify and
em_quantify_gpu), and every BAND_EVERY-th deferred band item with its
windows' bases and the match count the service returned.  The wrappers
hand every argument and result through unchanged; a sample's record is
open only while the window runs its first completion of a pool sample.
"""

from __future__ import annotations

import functools
import importlib
from typing import Callable, List, Optional

import numpy as np

BAND_EVERY = 64
COMP = np.array([3, 2, 1, 0, 4], np.int8)
# the modules that construct the band service by its module-level name
SERVICE_USERS = ("t1k_tpu_torch.core.pipeline", "t1k_tpu_torch.core.analyzer")


class Capture:
    def __init__(self):
        self._undo: List[Callable[[], None]] = []
        self.records = {}
        self._open: Optional[dict] = None
        geno = importlib.import_module("t1k_tpu_torch.core.genotyper")
        self._patch(geno.Genotyper, "finalize",
                    self._finalize(geno.Genotyper.finalize))
        for name in ("em_quantify", "em_quantify_gpu"):
            self._patch(geno, name, self._em(getattr(geno, name)))
        users = [importlib.import_module(m) for m in SERVICE_USERS]
        service = self._service(users[0].DeferredDescService)
        for mod in users:
            self._patch(mod, "DeferredDescService", service)

    def _patch(self, owner, attr: str, value) -> None:
        old = owner.__dict__[attr]
        setattr(owner, attr, value)
        self._undo.append(lambda: setattr(owner, attr, old))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def open(self, index: int) -> None:
        """Records the coming sample under pool index `index`, unless a
        record of that pool sample is already kept."""
        if index in self.records:
            self._open = None
            return
        self._open = {"genotypers": [], "em": [], "band": [],
                      "band_items": 0}

    def close(self, index: int, ok: bool) -> None:
        if self._open is not None and ok:
            self.records[index] = self._open
        self._open = None

    # ------------------------------------------------------------ wrappers
    def _finalize(self, finalize):
        cap = self

        @functools.wraps(finalize)
        def wrapped(genotyper, *args, **kwargs):
            ret = finalize(genotyper, *args, **kwargs)
            rec = cap._open
            if rec is not None:
                rec["genotypers"].append({
                    "names": [a.name for a in genotyper.refset.alleles],
                    "goff": genotyper._grp_off.copy(),
                    "allele": genotyper._flat_allele.copy(),
                    "weight": genotyper._flat_weight.copy(),
                    "qual": genotyper._flat_qual.copy(),
                    "ecs": [list(ec) for ec in genotyper.ec_to_alleles]})
            return ret

        return wrapped

    def _em(self, quantify):
        cap = self

        @functools.wraps(quantify)
        def wrapped(*problem, **kwargs):
            iters, counts = quantify(*problem, **kwargs)
            rec = cap._open
            if rec is not None:
                rec["em"].append({"problem": problem,
                                  "counts": np.array(counts, np.float64)})
            return iters, counts

        return wrapped

    def _service(self, base):
        cap = self

        class CapturingService(base):
            """The program's band service; every BAND_EVERY-th item's
            windows and answer are kept for the check."""

            def set_ref(self, codes):
                self._cap_ref = np.array(codes, np.int8)
                return super().set_ref(codes)

            def set_layout(self, read_starts, read_lens):
                self._cap_starts = np.array(read_starts, np.int64)
                self._cap_lens = np.array(read_lens, np.int64)
                return super().set_layout(read_starts, read_lens)

            def begin_batch(self, read_codes):
                base_off = super().begin_batch(read_codes)
                self._cap_reads = np.array(read_codes, np.int8)
                self._cap_base = base_off
                return base_off

            def _pattern(self, off: int, n: int) -> np.ndarray:
                if off < self._cap_base:
                    return self._cap_reads[off:off + n].copy()
                q = np.arange(off - self._cap_base, off - self._cap_base + n)
                r = np.searchsorted(self._cap_starts, q, "right") - 1
                src = (2 * self._cap_starts[r] + self._cap_lens[r] - 1 - q)
                return COMP[self._cap_reads[src]]

            def stats_async(self, t_off, t_len, p_off, p_len):
                collect = super().stats_async(t_off, t_len, p_off, p_len)
                rec = cap._open
                n = len(t_len)
                if rec is None or n == 0 or not hasattr(self, "_cap_base"):
                    return collect
                seen = rec["band_items"]
                rec["band_items"] = seen + n
                pick = np.arange((-seen) % BAND_EVERY, n, BAND_EVERY)
                windows = [(self._cap_ref[int(t_off[i]):int(t_off[i])
                                          + int(t_len[i])].copy(),
                            self._pattern(int(p_off[i]), int(p_len[i])))
                           for i in pick]

                def collected():
                    match = collect()
                    rec["band"] += [(t, p, int(match[i]))
                                    for (t, p), i in zip(windows, pick)]
                    return match

                return collected

        return CapturingService
