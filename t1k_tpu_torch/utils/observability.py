"""Structured logging, per-stage metrics, spans, and device profiling.

Every pipeline stage records wall time and throughput counters that are
serialized to <prefix>_metrics.json and logged as one timestamped line on
stderr; with T1K_PROFILE_DIR set, a torch.profiler trace of the stage
(CPU, and CUDA where a card is present) is written there as
<stage>.json, a Chrome trace.  An entry point starts a fresh set of
records (start_metrics) unless it runs inside a metrics_run: the
run-t1k chain's stages, extraction's included, share one set.

Tracing.  A stage traces when a torch.profiler records as it opens: the
one T1K_PROFILE_DIR starts for the stage, or any profiler the caller
runs around the pipeline.  No other switch exists.  While a stage
traces:
  * the stage is a range `t1k.<stage>` in the profiler's trace, and each
    `span(part)` inside it a range `t1k.<stage>.<part>` nested in it,
    beside the kernels and copies the span launched;
  * each span adds its wall time to the stage's record as
    `<part>_seconds` and its uses as `<part>_span_count`, so
    <prefix>_metrics.json holds them too;
  * the host engine counts and times its read-assignment passes, and
    the caller adds those counters to the stage's record
    (NativeEngine.trace_counters: hits, overlaps, deferred items by
    kind, thread-seconds of each phase);
  * `traced_range(name)` functions (the reference load, extraction, the
    device screen's build, the analyzer) are ranges `t1k.<name>`.
With no profiler recording, `span()` returns a shared null context: no
clock read, no record written, no range; the engine reads no clock.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

TRACE_PREFIX = "t1k."


# counts that are no throughput of their stage (a span's uses, the host
# engine's trace counters): their records get no `<name>_per_s` rate
_NO_RATE: Set[str] = set()


def no_rate(*names: str) -> None:
    _NO_RATE.update(names)


@dataclass
class Metrics:
    stages: Dict[str, dict] = field(default_factory=dict)

    def record(self, stage: str, seconds: float, **counters) -> None:
        entry = {"seconds": round(seconds, 4)}
        for k, v in counters.items():
            entry[k] = v
            if (k.endswith("_count") and seconds > 0
                    and k not in _NO_RATE and not k.endswith("_span_count")):
                entry[k[:-6] + "_per_s"] = round(v / seconds, 2)
        self.stages[stage] = entry

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.stages, f, indent=2)
            f.write("\n")


_current = Metrics()
_run_open = False


def metrics() -> Metrics:
    return _current


def reset_metrics(resume: Optional[Metrics] = None) -> Metrics:
    """A fresh set of stage records, or `resume` an earlier set."""
    global _current
    _current = Metrics() if resume is None else resume
    return _current


def start_metrics() -> Metrics:
    """Where an entry point's run starts: a fresh set of stage records,
    unless a metrics_run is open, whose stages the run adds to."""
    return _current if _run_open else reset_metrics()


@contextlib.contextmanager
def metrics_run():
    """One run of several entry points (the run-t1k chain): a fresh set
    of stage records that each entry inside adds to, so one metrics file
    holds every stage of the run."""
    global _run_open
    run = start_metrics()
    outer, _run_open = _run_open, True
    try:
        yield run
    finally:
        _run_open = outer


def _profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _profiling() -> bool:
    """Whether a torch.profiler records in this process (no profiler can
    record before torch is imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _range(name: str):
    from torch.profiler import record_function
    return record_function(TRACE_PREFIX + name)


class _OpenStage:
    __slots__ = ("name", "ctx", "traced")

    def __init__(self, name: str, ctx: dict, traced: bool):
        self.name, self.ctx, self.traced = name, ctx, traced


_open: List[_OpenStage] = []   # the stages open now, innermost last
_NULL = contextlib.nullcontext()


def tracing() -> bool:
    """True inside a stage that opened while a profiler recorded."""
    return bool(_open) and _open[-1].traced


class _Span:
    __slots__ = ("_stage", "_part", "_range", "_t0")

    def __init__(self, stage_: _OpenStage, part: str):
        self._stage, self._part = stage_, part

    def __enter__(self):
        self._range = _range(f"{self._stage.name}.{self._part}")
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        ctx, part = self._stage.ctx, self._part
        ctx[f"{part}_seconds"] = ctx.get(f"{part}_seconds", 0.0) + dt
        ctx[f"{part}_span_count"] = ctx.get(f"{part}_span_count", 0) + 1
        return False


def span(part: str):
    """A part of the innermost open stage: its wall time and uses go to
    the stage's record, its range `t1k.<stage>.<part>` to the profiler's
    trace.  Outside a tracing stage, a shared null context."""
    top = _open[-1] if _open else None
    if top is None or not top.traced:
        return _NULL
    return _Span(top, part)


def traced_range(name: str):
    """Decorator: each call is a range `t1k.<name>` in the profiler's trace
    while a profiler records; otherwise the function runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _range(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def stage(name: str, **counters):
    """Time a pipeline stage; counters may be filled in by the caller via
    the yielded dict.  A profiler trace is written when T1K_PROFILE_DIR
    is set.  While a profiler records, the stage is the range
    `t1k.<name>` and its spans are traced (module docstring)."""
    ctx = dict(counters)
    profile_dir = os.environ.get("T1K_PROFILE_DIR")
    prof = _profiler() if profile_dir else None
    if prof is not None:
        prof.__enter__()
    traced = _profiling()
    rng = _range(name) if traced else None
    if rng is not None:
        rng.__enter__()
    _open.append(_OpenStage(name, ctx, traced))
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        dt = time.perf_counter() - t0
        _open.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))
        _current.record(name, dt, **ctx)
        ts = time.strftime("%a %b %d %H:%M:%S %Y")
        extras = " ".join(f"{k}={v}" for k, v in ctx.items())
        print(f"[{ts}] stage {name} finished in {dt:.2f}s {extras}",
              file=sys.stderr)
