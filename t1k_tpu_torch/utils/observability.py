"""Structured logging, per-stage metrics, and device profiling.

Every pipeline stage records wall time and throughput counters that are
serialized to <prefix>_metrics.json and logged as one timestamped line on
stderr; with T1K_PROFILE_DIR set, a torch.profiler trace of the stage
(CPU, and CUDA where a card is present) is written there as
<stage>.json, a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Metrics:
    stages: Dict[str, dict] = field(default_factory=dict)

    def record(self, stage: str, seconds: float, **counters) -> None:
        entry = {"seconds": round(seconds, 4)}
        for k, v in counters.items():
            entry[k] = v
            if k.endswith("_count") and seconds > 0:
                entry[k[:-6] + "_per_s"] = round(v / seconds, 2)
        self.stages[stage] = entry

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.stages, f, indent=2)
            f.write("\n")


_current = Metrics()


def metrics() -> Metrics:
    return _current


def reset_metrics() -> Metrics:
    global _current
    _current = Metrics()
    return _current


def _profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@contextlib.contextmanager
def stage(name: str, **counters):
    """Time a pipeline stage; counters may be filled in by the caller via
    the yielded dict.  A profiler trace is written when T1K_PROFILE_DIR
    is set."""
    ctx = dict(counters)
    profile_dir = os.environ.get("T1K_PROFILE_DIR")
    prof = _profiler() if profile_dir else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))
        _current.record(name, dt, **ctx)
        ts = time.strftime("%a %b %d %H:%M:%S %Y")
        extras = " ".join(f"{k}={v}" for k, v in ctx.items())
        print(f"[{ts}] stage {name} finished in {dt:.2f}s {extras}",
              file=sys.stderr)
