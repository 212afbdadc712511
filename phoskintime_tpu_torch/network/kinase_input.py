"""Kinase input K(t): observed fold-change trajectories on the protein grid.

Counterpart of ``phoskintime_tpu/network/kinase_input.py`` without
pandas: per-kinase step ("bucketed") values over the protein time grid,
default 1.0, clamped >= 1e-6.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def build_kinase_matrix(kinases: Sequence[str],
                        fc_rows: Sequence[tuple[str, float, float]] | None,
                        grid) -> np.ndarray:
    """(K, len(grid)) kinase fold-change matrix.

    fc_rows: ``(protein, time, fc)`` observations (may be empty or None);
    for a repeated (protein, time) the last row wins.
    """
    grid = np.asarray(grid, float)
    Kmat = np.ones((len(kinases), len(grid)))
    per_protein: dict[str, dict[float, float]] = {}
    for p, t, fc in fc_rows or ():
        per_protein.setdefault(p, {})[float(t)] = float(fc)
    for i, k in enumerate(kinases):
        mp = per_protein.get(k)
        if not mp:
            continue
        for j, t in enumerate(grid):
            if t in mp:
                Kmat[i, j] = max(mp[t], 1e-6)
    return Kmat
