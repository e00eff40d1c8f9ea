"""Spans and counters the traced run takes from the outside of the
program: module attributes wrapped for the traced window only, the
program's own stage records captured as they are made, and a recording
subclass of the band service that counts the work it is sent.  Nothing
inside the program changes."""

from __future__ import annotations

import functools
import time
from typing import Callable, List

from . import roofline
from .capture import SERVICE_USERS

# (harness span, module, attribute path): what each span wraps
SPANS = (
    ("refset_load", "t1k_tpu_torch.io.refset", "RefSet.from_fasta"),
    ("extract", "t1k_tpu_torch.core.extractor", "run_extractor"),
    ("screen_build", "t1k_tpu_torch.ops.phase_a", "DeviceScreen.build"),
    ("analyze", "t1k_tpu_torch.core.analyzer", "run_analyzer"),
)


class Probes:
    """Installs the wrappers; `sample()` opens a sample's record, and
    every span, stage record, band batch and probe launch lands in the
    open one.  `remove()` puts every attribute back."""

    def __init__(self):
        import importlib
        self._undo: List[Callable[[], None]] = []
        self.samples: List[dict] = []
        self.probe_launches: List[tuple] = []
        mods = {m: importlib.import_module(m) for _, m, _ in SPANS}
        for name, mod, path in SPANS:
            self._wrap_span(mods[mod], path, name)
        obs = importlib.import_module("t1k_tpu_torch.utils.observability")
        self._patch(obs.Metrics, "record", self._stage_record(
            obs.Metrics.record))
        phase_a = importlib.import_module("t1k_tpu_torch.ops.phase_a")
        self._patch(phase_a, "probe", self._probe(phase_a.probe))
        users = [importlib.import_module(m) for m in SERVICE_USERS]
        # on top of the service in place (the output check's capture)
        recorder = self._service(users[0].DeferredDescService)
        for mod in users:
            self._patch(mod, "DeferredDescService", recorder)

    # --------------------------------------------------------- plumbing
    def _patch(self, owner, attr: str, value) -> None:
        old = owner.__dict__[attr]
        setattr(owner, attr, value)
        self._undo.append(lambda: setattr(owner, attr, old))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def sample(self, index: int) -> dict:
        rec = {"index": index, "spans": [], "stages": [],
               "band_bytes": 0, "band_ops": 0, "band_items": 0}
        self.samples.append(rec)
        return rec

    def _open(self):
        return self.samples[-1] if self.samples else None

    # ------------------------------------------------------------ spans
    def _wrap_span(self, module, path: str, name: str) -> None:
        owner_name, _, attr = path.rpartition(".")
        owner = getattr(module, owner_name) if owner_name else module
        raw = owner.__dict__[attr]
        is_cm = isinstance(raw, classmethod)
        fn = raw.__func__ if is_cm else raw
        probes = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec = probes._open()
                if rec is not None:
                    rec["spans"].append((name, t0, time.perf_counter()))

        self._patch(owner, attr, classmethod(wrapped) if is_cm else wrapped)

    def _stage_record(self, record):
        probes = self

        @functools.wraps(record)
        def wrapped(metrics, stage, seconds, **counters):
            rec = probes._open()
            if rec is not None:
                end = time.perf_counter()
                rec["stages"].append((stage, end - seconds, end,
                                      dict(counters)))
            return record(metrics, stage, seconds, **counters)

        return wrapped

    def _probe(self, probe):
        probes = self

        @functools.wraps(probe)
        def wrapped(codes, lens, index):
            if probes._open() is not None:
                probes.probe_launches.append((codes, lens, index.k,
                                              bool(index.direct)))
            return probe(codes, lens, index)

        return wrapped

    def _service(self, base):
        probes = self

        class RecordingService(base):
            """Counts the bytes and band-cell operations of every batch
            it is sent, then scores it as the program's service does."""

            def stats_async(self, t_off, t_len, p_off, p_len):
                rec = probes._open()
                if rec is not None and len(t_len):
                    n_bytes, n_ops = roofline.band_work(t_len, p_len)
                    rec["band_bytes"] += n_bytes
                    rec["band_ops"] += n_ops
                    rec["band_items"] += len(t_len)
                return super().stats_async(t_off, t_len, p_off, p_len)

        return RecordingService

    def probe_work(self):
        """(bytes, operations) summed over the recorded probe launches,
        read back once the window has closed."""
        n_bytes = n_ops = 0
        for codes, lens, k, direct in self.probe_launches:
            b, o = roofline.probe_work(codes.cpu().numpy(),
                                       lens.cpu().numpy(), k, direct)
            n_bytes += b
            n_ops += o
        return n_bytes, n_ops


def band_kernel(name: str) -> bool:
    """band_stats.cu's kernels that score deferred items."""
    return any(k in name for k in ("thread_narrow_kernel",
                                   "thread_wide_kernel", "group_kernel",
                                   "band_warp_kernel"))


def probe_kernel(name: str) -> bool:
    """phase_a_probe.cu's kernel."""
    return "probe_kernel" in name and "clock_probe" not in name
