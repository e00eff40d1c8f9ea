"""The metric readers on synthetic records and a small Chrome trace: the
union of overlapping streams against their sum, the idle gaps and their
labels, and the roofline arithmetic."""

from __future__ import annotations

import numpy as np
import pytest

from harness import roofline
from harness.layers import TracedRun, load_reader
from harness.probes import band_kernel, probe_kernel
from harness.trace import ANCHOR, Trace, label_gaps

from conftest import HARNESS


def _events():
    """Two streams that overlap: kernels at 100-300 us and 200-400 us
    after the anchor, a copy at 600-700 us, a set at 650-660 us; a CPU
    op that is no device work."""
    base = 5_000_000
    return [
        {"ph": "X", "cat": "user_annotation", "name": ANCHOR, "ts": base,
         "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "void thread_narrow_kernel<1>",
         "ts": base + 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "probe_kernel", "ts": base + 200,
         "dur": 200},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": base + 600, "dur": 100},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset",
         "ts": base + 650, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": base,
         "dur": 5000},
    ]


def _trace():
    # the anchor opened at 10.0 s on the harness's clock; the window is
    # 10.0-10.001 s
    return Trace.from_chrome(_events(), 10.0, 10.0, 10.001)


def test_union_against_sum_of_overlapping_streams():
    t = _trace()
    summed = sum(b - a for _, a, b in t.ops)
    assert summed == pytest.approx(510e-6)
    assert t.busy_s() == pytest.approx(400e-6)   # 100-400 and 600-700
    assert t.window_s == pytest.approx(1e-3)
    gaps = t.gaps()
    assert [(round((a - 10) * 1e6), round((b - 10) * 1e6))
            for a, b in gaps] == [(0, 100), (400, 600), (700, 1000)]


def test_kernel_time_by_name():
    t = _trace()
    assert t.kernel_s(band_kernel) == pytest.approx(200e-6)
    assert t.kernel_s(probe_kernel) == pytest.approx(200e-6)
    assert not probe_kernel("clock_probe_kernel")
    assert set(t.by_name()) == {"void thread_narrow_kernel<1>",
                                "probe_kernel", "Memcpy HtoD", "Memset"}


def test_gaps_labelled_by_innermost_interval():
    gaps = [(0.0, 1.0), (2.0, 4.0)]
    intervals = [("sample", 0.0, 5.0), ("extract", 0.5, 2.5),
                 ("extraction_screen", 3.0, 3.5)]
    got = label_gaps(gaps, intervals)
    assert got == pytest.approx({"sample": 0.5 + 0.5 + 0.5,
                                 "extract": 0.5 + 0.5,
                                 "extraction_screen": 0.5})


def _samples():
    """Two samples: spans, stage records (name, start, end, counters)."""
    return [
        {"index": 1, "spans": [("refset_load", 0.0, 1.0),
                               ("refset_load", 5.0, 6.5),
                               ("extract", 1.0, 3.0)],
         "stages": [("extraction_screen", 1.5, 3.0,
                     {"device_screened_reads": 900,
                      "device_decided_reads": 855}),
                    ("read_assignment", 3.0, 5.0,
                     {"deferred_item_count": 1000}),
                    ("analyzer_read_assignment", 7.0, 7.5,
                     {"deferred_item_count": 200}),
                    ("em_quantification", 5.0, 5.25, {})],
         "band_bytes": 4000, "band_ops": 2_000_000, "band_items": 100},
        {"index": 2, "spans": [("refset_load", 0.0, 0.5),
                               ("extract", 0.5, 1.5)],
         "stages": [("extraction_screen", 0.6, 1.5,
                     {"device_screened_reads": 100,
                      "device_decided_reads": 45}),
                    ("read_assignment", 2.0, 3.0,
                     {"deferred_item_count": 600}),
                    ("em_quantification", 3.0, 3.75, {})],
         "band_bytes": 1000, "band_ops": 1_000_000, "band_items": 50},
    ]


def _read(name, run):
    return load_reader(HARNESS, name)(run)


def test_span_and_stage_readers():
    run = TracedRun(_samples(), _samples(), _trace())
    assert _read("refset_load_s", run) == pytest.approx((2.5 + 0.5) / 2)
    assert _read("extract_s", run) == pytest.approx((2.0 + 1.0) / 2)
    assert _read("read_assignment_s", run) == pytest.approx(1.5)
    assert _read("em_s", run) == pytest.approx(0.5)
    assert _read("deferred_items", run) == pytest.approx(900)
    assert _read("screen_decided_pct", run) == pytest.approx(90.0)
    # no sample entered these spans: the metric is left out
    assert _read("screen_build_s", run) is None
    assert _read("analyze_s", run) is None


def test_device_readers():
    run = TracedRun(_samples(), _samples(), _trace(), probe_work=(670, 0))
    assert _read("device_idle_pct", run) == pytest.approx(60.0)
    # 3,000,000 int32 operations at the peak against 200 us of kernels
    want = 100 * 3_000_000 / roofline.INT32_PER_S / 200e-6
    assert _read("band_roofline_pct", run) == pytest.approx(want)
    want = 100 * 670 / roofline.HBM_BYTES_PER_S / 200e-6
    assert _read("probe_roofline_pct", run) == pytest.approx(want)
    # without a trace, or with no kernel of the name, nothing is read
    assert _read("band_roofline_pct",
                 TracedRun(_samples(), _samples(), None)) is None
    empty = Trace([], 0.0, 1.0)
    assert _read("probe_roofline_pct",
                 TracedRun(_samples(), _samples(), empty, (670, 9))) is None


def test_roofline_arithmetic():
    t_len, p_len = [100, 120], [100, 100]
    n_bytes, n_ops = roofline.band_work(t_len, p_len)
    assert n_bytes == 420 + 2 * roofline.DESC_ITEM_BYTES
    assert n_ops == 28 * (100 * 11 + 100 * 31)
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, roofline.INT32_PER_S) == pytest.approx(1.0)
    assert roofline.INT32_PER_S == 132 * 64 * 1980e6


def test_probe_work_counts_distinct_windows():
    k = 3
    # one read ACGTA (len 5): forward windows ACG CGT GTA, reverse
    # complement TACGT: TAC ACG CGT; distinct ACG CGT GTA TAC = 4
    codes = np.array([[0, 1, 2, 3, 0, 4]], np.int8)   # padded with N
    lens = np.array([5], np.int32)
    n_bytes, n_ops = roofline.probe_work(codes, lens, k, direct=True)
    W = 6 - k + 1
    assert n_ops == 15 * 2 * 1 * W
    assert n_bytes == 6 + 8 + 16 * W + 4 * 8
