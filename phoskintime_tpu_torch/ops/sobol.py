"""Sobol variance-based global sensitivity (Saltelli sampling).

Counterpart of ``phoskintime_tpu/ops/sobol.py`` (numpy and
``scipy.stats.qmc``, copied); :func:`temporal_sobol`'s ``evaluate`` may
return a tensor on the card, which is read back once.

Spec: reference ``scripts/temporal_sensitivity.py`` uses SALib's
``saltelli.sample`` + ``sobol.analyze`` (first-order + total indices,
no second order) per timepoint. SALib is unavailable, so the estimators
are implemented from Saltelli (2010)/Jansen (1999):

    S1_i = Var(E[Y|x_i]) / Var(Y)  ~  mean(f_B * (f_ABi - f_A)) / V
    ST_i = E[Var(Y|x_~i)] / Var(Y) ~  0.5 * mean((f_A - f_ABi)^2) / V

Sampling uses a scrambled Sobol low-discrepancy sequence
(scipy.stats.qmc) with the radial A/B/AB_i scheme; evaluation happens as
ONE batched call (the reference fans out to a process pool).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.stats import qmc


def saltelli_sample(bounds: np.ndarray, n_base: int,
                    seed: int = 42) -> np.ndarray:
    """(n_base * (d + 2), d) design: [A; B; AB_1..AB_d] blocks interleaved
    per base sample (matches SALib's ordering with calc_second_order=False)."""
    d = len(bounds)
    sob = qmc.Sobol(2 * d, scramble=True, seed=seed)
    m = int(np.ceil(np.log2(max(n_base, 2))))
    base = sob.random_base2(m)[:n_base]                # (n, 2d) in [0,1)
    A, B = base[:, :d], base[:, d:]
    lo, hi = bounds[:, 0], bounds[:, 1]
    scale = lambda U: lo + U * (hi - lo)

    rows = []
    for k in range(n_base):
        rows.append(scale(A[k]))
        for i in range(d):
            ab = A[k].copy()
            ab[i] = B[k, i]
            rows.append(scale(ab))
        rows.append(scale(B[k]))
    return np.asarray(rows)


class SobolResult(NamedTuple):
    S1: np.ndarray
    ST: np.ndarray
    S1_conf: np.ndarray
    ST_conf: np.ndarray


def sobol_analyze(d: int, Y: np.ndarray, n_boot: int = 100,
                  seed: int = 42) -> SobolResult:
    """First-order and total Sobol indices from a Saltelli design output.

    Y must follow :func:`saltelli_sample`'s row order,
    length n_base * (d + 2).
    """
    Y = np.asarray(Y, float)
    n_base = len(Y) // (d + 2)
    Y = Y[: n_base * (d + 2)].reshape(n_base, d + 2)
    fA = Y[:, 0]
    fAB = Y[:, 1:d + 1]
    fB = Y[:, d + 1]

    def indices(idx):
        a, b, ab = fA[idx], fB[idx], fAB[idx]
        V = np.var(np.concatenate([a, b]), ddof=0)
        V = max(V, 1e-300)
        S1 = np.mean(b[:, None] * (ab - a[:, None]), axis=0) / V
        ST = 0.5 * np.mean((a[:, None] - ab) ** 2, axis=0) / V
        return S1, ST

    S1, ST = indices(np.arange(n_base))

    rng = np.random.default_rng(seed)
    if n_base > 4 and n_boot > 0:
        boots1, bootst = [], []
        for _ in range(n_boot):
            idx = rng.integers(n_base, size=n_base)
            s1, st = indices(idx)
            boots1.append(s1)
            bootst.append(st)
        S1_conf = 1.96 * np.std(boots1, axis=0, ddof=1)
        ST_conf = 1.96 * np.std(bootst, axis=0, ddof=1)
    else:
        S1_conf = np.zeros(d)
        ST_conf = np.zeros(d)
    return SobolResult(S1, ST, S1_conf, ST_conf)


def temporal_sobol(evaluate, bounds: np.ndarray, n_base: int = 128,
                   seed: int = 42):
    """Per-timepoint Sobol indices of a trajectory-valued model.

    evaluate: (n_samples, d) -> (n_samples, T) batched trajectories, numpy
    or a tensor on any device (read back once).
    Returns (S1 (T, d), ST (T, d), design X).
    """
    X = saltelli_sample(bounds, n_base, seed=seed)
    Y = evaluate(X)
    Y = (Y.to("cpu", torch.float64).numpy() if isinstance(Y, torch.Tensor)
         else np.asarray(Y, float))
    d = bounds.shape[0]
    T = Y.shape[1]
    S1 = np.zeros((T, d))
    ST = np.zeros((T, d))
    for t in range(T):
        res = sobol_analyze(d, Y[:, t], n_boot=0)
        S1[t] = res.S1
        ST[t] = res.ST
    return S1, ST, X
