"""The output check fails what it has to fail.  Each test drives a whole
run of the tiny cell on the CPU (the harness's look for a card skipped)
with the timed path broken underneath, and sees `correct` come out
false:

- a step that returns its state unchanged: the EM hands back its start;
- half of the batch left out: the device screen decides the first half
  of each batch and drops the rest;
- an answer altered where it is produced: one EM answer moved by a
  read, and one band answer moved by a match on every item;
- the control: the plain reference's EM in float32 in the place of the
  program's answers (harness/control.py).

The cells run on one card, so no exchange between chips can be left
out.  The card test runs the tiny cell through the kernels on a card.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import TINY, load_run


def _run(tiny_copy, capsys, seed: int, **kw) -> dict:
    root, bench_path = tiny_copy
    run = load_run(root)
    rc = run.main(["--workload", TINY, "--seed", str(seed), "--seconds",
                   "6", "--trace", "0"], require_card=False,
                  bench_path=bench_path, **{"device": "cpu", **kw})
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return json.loads(out.out.splitlines()[-1])


def _value(result, name):
    return result["checks"][name]["value"]


def test_sound_run_is_correct(tiny_copy, capsys):
    result = _run(tiny_copy, capsys, 4242)
    assert result["correct"] is True
    assert _value(result, "exact_pairs") > 50
    assert _value(result, "band_checked") > 50
    assert _value(result, "em_gap") < 1e-12


def _em_fault(monkeypatch, fault):
    from t1k_tpu_torch.core import genotyper
    quantify = genotyper.em_quantify

    def broken(*problem, **kwargs):
        iters, counts = quantify(*problem, **kwargs)
        return iters, fault(problem, np.array(counts, np.float64))

    monkeypatch.setattr(genotyper, "em_quantify", broken)


def test_em_returning_its_start_fails(tiny_copy, capsys, monkeypatch):
    def unchanged(problem, counts):
        ec_to_alleles, weight = problem[0], problem[5]
        return np.array([float(sum(weight[a] for a in ec))
                         for ec in ec_to_alleles])

    _em_fault(monkeypatch, unchanged)
    result = _run(tiny_copy, capsys, 4242)
    assert result["correct"] is False
    assert _value(result, "em_gap") > 1e-3


def test_altered_em_answer_fails(tiny_copy, capsys, monkeypatch):
    def one_read_more(problem, counts):
        counts[int(np.argmax(counts))] += 1.0
        return counts

    _em_fault(monkeypatch, one_read_more)
    result = _run(tiny_copy, capsys, 4242)
    assert result["correct"] is False
    assert _value(result, "em_gap") > 1e-4


def test_altered_band_answers_fail(tiny_copy, capsys, monkeypatch):
    from t1k_tpu_torch.ops import align_band
    stats_async = align_band.DeferredDescService.stats_async

    def broken(self, *items):
        collect = stats_async(self, *items)
        return lambda: collect() + 1

    monkeypatch.setattr(align_band.DeferredDescService, "stats_async",
                        broken)
    result = _run(tiny_copy, capsys, 4242)
    assert result["correct"] is False
    assert _value(result, "band_wrong") > 0


def test_half_batch_left_out_fails(tiny_copy, capsys, monkeypatch):
    from t1k_tpu_torch.ops import phase_a
    screen = phase_a.DeviceScreen.screen

    def half(self, codes, lens):
        verdict, decided = screen(self, codes, lens)
        verdict, decided = verdict.copy(), decided.copy()
        rest = len(verdict) // 2
        verdict[rest:] = False
        decided[rest:] = True
        return verdict, decided

    monkeypatch.setattr(phase_a.DeviceScreen, "screen", half)
    result = _run(tiny_copy, capsys, 4242)
    assert result["correct"] is False
    assert _value(result, "screen_exact_missed") > 0


def test_f32_control_fails(tiny_copy, capsys):
    from harness.control import f32_answer
    result = _run(tiny_copy, capsys, 4242, em_answer=f32_answer)
    assert result["correct"] is False
    assert _value(result, "em_gap") > 1e-9


@pytest.mark.cuda
def test_tiny_cell_on_card(tiny_copy, capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = _run(tiny_copy, capsys, 99, device="cuda")
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
