"""The control of the output check: the plain reference put in the
program's place at the EM, computed in float32, the precision below
the float64 that the configuration states.  Its answers have to fail
the check (em_gap)."""

from __future__ import annotations

import numpy as np

from reference import em


def f32_answer(problem) -> np.ndarray:
    """T1K's EM in float32 over the program's problem, widened."""
    return em.quantify(problem, np.float32).astype(np.float64)
