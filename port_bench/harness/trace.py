"""Reduction of a torch.profiler Chrome trace to what the per-layer
metrics and the breakdown read: the device's intervals, their union
(the chip smoke test's `device_busy_ms`), the idle gaps between them,
and the time of each kernel by name."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

# Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "port_bench.anchor"


class Trace:
    """Device intervals [(name, start_s, end_s)] on the harness's clock
    (time.perf_counter seconds), cut to the traced window."""

    def __init__(self, ops: List[Tuple[str, float, float]], t0: float,
                 t1: float):
        self.t0, self.t1 = t0, t1
        self.ops = sorted((n, max(a, t0), min(b, t1)) for n, a, b in ops
                          if b > t0 and a < t1)

    @classmethod
    def from_chrome(cls, events: list, anchor_s: float, t0: float,
                    t1: float) -> "Trace":
        """`anchor_s` is the harness clock when the ANCHOR annotation
        opened: it maps the trace's microseconds to that clock."""
        marks = [e["ts"] for e in events
                 if e.get("ph") == "X" and e.get("name") == ANCHOR]
        if not marks:
            raise ValueError("the trace holds no anchor annotation")
        shift = anchor_s - marks[0] / 1e6
        ops = [(e.get("name", ""), e["ts"] / 1e6 + shift,
                (e["ts"] + e.get("dur", 0)) / 1e6 + shift)
               for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        return cls(ops, t0, t1)

    @classmethod
    def from_file(cls, path: str, anchor_s: float, t0: float,
                  t1: float) -> "Trace":
        with open(path) as f:
            return cls.from_chrome(json.load(f)["traceEvents"], anchor_s,
                                   t0, t1)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def union(self) -> List[Tuple[float, float]]:
        """Merged busy intervals, in order."""
        out: List[Tuple[float, float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union())

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the window between the busy ones."""
        out, at = [], self.t0
        for a, b in self.union():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def kernel_s(self, match) -> float:
        """Summed time of the kernels whose name `match` accepts."""
        return sum(b - a for n, a, b in self.ops if match(n))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.ops:
            out[n] = out.get(n, 0.0) + (b - a)
        return out


def label_gaps(gaps, intervals) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap split over the
    innermost (shortest) labelled interval [(label, start, end)] that
    covers each part of it; what none covers is 'harness'."""
    ivs = sorted(intervals, key=lambda iv: iv[2] - iv[1])
    out: Dict[str, float] = {}
    for a, b in gaps:
        cuts = sorted({a, b, *[x for _, s, e in ivs for x in (s, e)
                              if a < x < b]})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            name = next((n for n, s, e in ivs if s <= mid < e), "harness")
            out[name] = out.get(name, 0.0) + (hi - lo)
    return out
