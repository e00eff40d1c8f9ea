"""Read groups, equivalence classes and the EM's read-group table,
worked out again from the program's read groups.

T1K's genotyper merges fragments with the same assignment into read
groups (a group: its alleles, each with a quality, and a weight per
row).  Alleles supported by the same groups at the same qualities form
one equivalence class (EC), which keeps only its alleles of the highest
summed quality.  The EM sees, per group, its distinct ECs in the order
of the group's rows and the group's largest row weight."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def equivalence_classes(goff: np.ndarray, allele: np.ndarray,
                        qual: np.ndarray,
                        allele_cnt: int) -> List[Tuple[set, set]]:
    """Each EC as (every allele of the class, the alleles it keeps)."""
    grp = np.repeat(np.arange(len(goff) - 1), np.diff(goff))
    support: Dict[int, list] = {}
    qual_sum = np.zeros(allele_cnt, np.float64)
    for g, a, q in zip(grp.tolist(), allele.tolist(), qual.tolist()):
        support.setdefault(a, []).append((g, q))
        qual_sum[a] += q
    classes: Dict[tuple, list] = {}
    for a, rows in support.items():
        classes.setdefault(tuple(sorted(rows)), []).append(a)
    out = []
    for members in classes.values():
        top = max(qual_sum[a] for a in members)
        out.append((set(members),
                    {a for a in members if qual_sum[a] == top}))
    return out


def em_table(goff: np.ndarray, allele: np.ndarray, weight: np.ndarray,
             ec_of: Dict[int, int]) -> Tuple[List[List[int]], np.ndarray]:
    """Per group its distinct ECs in row order (ec_of maps every allele
    of a class, kept or not, to the class's id), and its count."""
    ecs, counts = [], np.zeros(len(goff) - 1, np.float64)
    for g in range(len(goff) - 1):
        s, e = int(goff[g]), int(goff[g + 1])
        seen: List[int] = []
        for a in allele[s:e].tolist():
            c = ec_of.get(a)
            if c is not None and c not in seen:
                seen.append(c)
        ecs.append(seen)
        counts[g] = float(weight[s:e].max()) if e > s else 0.0
    return ecs, counts
