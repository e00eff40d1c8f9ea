"""What a per-layer metric's reader is handed: the traced run's samples
with their spans, stage records and counts of work, the device trace,
and the roofline arithmetic.  Each reader lives in metrics/<name>.py
and exposes read(run) -> float or None; None leaves the metric out of
the result line."""

from __future__ import annotations

import importlib.util
import os
from typing import List, Optional

from . import roofline
from .trace import Trace


class TracedRun:
    def __init__(self, samples: List[dict], window: List[dict],
                 trace: Optional[Trace], probe_work=(0, 0)):
        # samples completed inside the window (per-sample means), and
        # every sample the traced window ran (work against device time)
        self.samples = samples
        self.window = window
        self.trace = trace
        self.probe_bytes, self.probe_ops = probe_work

    # ------------------------------------------------ per-sample means
    def _mean(self, values) -> Optional[float]:
        values = list(values)
        return sum(values) / len(values) if values else None

    def span_mean(self, name: str) -> Optional[float]:
        """Seconds per sample in the harness span `name`; None where no
        sample entered it."""
        if not any(s for r in self.samples for s in r["spans"]
                   if s[0] == name):
            return None
        return self._mean(sum(b - a for n, a, b in r["spans"] if n == name)
                          for r in self.samples)

    def stage_mean(self, stage: str) -> Optional[float]:
        """Seconds per sample of the program's stage record `stage`."""
        if not any(st for r in self.samples for st in r["stages"]
                   if st[0] == stage):
            return None
        return self._mean(sum(b - a for n, a, b, _ in r["stages"]
                              if n == stage) for r in self.samples)

    def counter_total(self, key: str, stage: Optional[str] = None,
                      samples=None) -> Optional[int]:
        """A counter summed over the stage records that carry it."""
        vals = [c[key] for r in (self.samples if samples is None
                                 else samples)
                for n, _, _, c in r["stages"]
                if key in c and (stage is None or n == stage)]
        return sum(vals) if vals else None

    def counter_mean(self, key: str, stage: Optional[str] = None):
        """A counter per sample."""
        total = self.counter_total(key, stage)
        return None if total is None else total / len(self.samples)

    # ------------------------------------------------------- rooflines
    def roofline_pct(self, n_bytes: float, n_ops: float,
                     match) -> Optional[float]:
        """The least time of the work over the device time of the
        kernels `match` accepts, in %; None where they never ran."""
        if self.trace is None or not n_bytes and not n_ops:
            return None
        spent = self.trace.kernel_s(match)
        if spent <= 0:
            return None
        return 100.0 * roofline.bound_s(n_bytes, n_ops) / spent


def load_reader(root: str, name: str):
    """metrics/<name>.py's read function."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
