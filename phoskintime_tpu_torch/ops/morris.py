"""Morris elementary-effects sensitivity analysis.

Counterpart of ``phoskintime_tpu/ops/morris.py`` (numpy only, copied, with
the same ``rng`` streams): the method of Morris (1991) with Campolongo's
mu*. The sampler emits ONE (r*(d+1), d) design matrix, so that all model
evaluations are one batched solve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def compute_bound(value: float, perturbation: float) -> tuple[float, float]:
    """+/- perturbation bounds around a fitted value
    (reference sensitivity/analysis.py:20-36)."""
    if abs(value) < 1e-6:
        return (0.0, 0.1)
    lb = value * (1 - perturbation)
    ub = value * (1 + perturbation)
    lo, hi = max(0.0, min(lb, ub)), max(lb, ub)
    if hi <= lo:  # negative parameter values: fall back like near-zero
        return (0.0, 0.1)
    return (lo, hi)


def morris_sample(bounds: np.ndarray, n_trajectories: int, num_levels: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Morris trajectory design, scaled to ``bounds`` (d, 2).

    Returns (n_trajectories * (d + 1), d); consecutive rows within a
    trajectory differ in exactly one coordinate by delta (in unit space).
    """
    d = len(bounds)
    p = max(int(num_levels), 2)
    delta = p / (2.0 * (p - 1))
    grid = np.arange(0, p // 2) / (p - 1)  # base levels that keep x+delta <= 1

    J = np.ones((d + 1, d))
    B = np.tril(np.ones((d + 1, d)), -1)

    out = np.empty((n_trajectories * (d + 1), d))
    for t in range(n_trajectories):
        x_base = grid[rng.integers(len(grid), size=d)]
        D = np.diag(rng.choice([-1.0, 1.0], size=d))
        P = np.eye(d)[rng.permutation(d)]
        Bstar = (J * x_base + (delta / 2.0) * ((2.0 * B - J) @ D + J)) @ P
        out[t * (d + 1):(t + 1) * (d + 1)] = Bstar

    lo, hi = bounds[:, 0], bounds[:, 1]
    return lo + out * (hi - lo)


class MorrisResult(NamedTuple):
    mu: np.ndarray
    mu_star: np.ndarray
    sigma: np.ndarray
    mu_star_conf: np.ndarray


def morris_analyze(bounds: np.ndarray, X: np.ndarray, Y: np.ndarray,
                   num_levels: int, conf_level: float = 0.99,
                   n_boot: int = 1000, scaled: bool = True,
                   seed: int = 42) -> MorrisResult:
    """Elementary effects from a Morris design + model outputs.

    scaled=True computes effects in the unit hypercube (SALib's default used
    by the reference), making mu* comparable across parameters.
    """
    d = bounds.shape[0]
    r = len(Y) // (d + 1)
    lo, hi = bounds[:, 0], bounds[:, 1]
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    Xu = (X - lo) / span if scaled else X

    # vectorized elementary effects: each consecutive pair within a
    # trajectory changes exactly one coordinate
    Xt = Xu[: r * (d + 1)].reshape(r, d + 1, d)
    Yt = Y[: r * (d + 1)].reshape(r, d + 1)
    diffs = Xt[:, 1:] - Xt[:, :-1]                  # (r, d, d)
    j_idx = np.argmax(np.abs(diffs), axis=2)        # (r, d) changed coord
    steps = np.take_along_axis(diffs, j_idx[:, :, None], axis=2)[:, :, 0]
    dY = Yt[:, 1:] - Yt[:, :-1]
    ee_vals = np.where(steps != 0, dY / np.where(steps == 0, 1.0, steps), 0.0)
    EE = np.zeros((r, d))
    rows = np.repeat(np.arange(r), d)
    EE[rows, j_idx.ravel()] = ee_vals.ravel()

    mu = EE.mean(axis=0)
    mu_star = np.abs(EE).mean(axis=0)
    sigma = EE.std(axis=0, ddof=1) if r > 1 else np.zeros(d)

    # bootstrap CI on mu_star over trajectories
    rng = np.random.default_rng(seed)
    if r > 1:
        idx = rng.integers(r, size=(n_boot, r))
        boots = np.abs(EE)[idx].mean(axis=1)      # (n_boot, d)
        zq = (1 + conf_level) / 2
        from scipy import stats
        z = stats.norm.ppf(zq)
        mu_star_conf = z * boots.std(axis=0, ddof=1)
    else:
        mu_star_conf = np.zeros(d)
    return MorrisResult(mu, mu_star, sigma, mu_star_conf)


# ---------------------------------------------------------------------------
# scalar output metrics over a trajectory (reference _compute_Y,
# sensitivity/analysis.py:89-176)
# ---------------------------------------------------------------------------

def trajectory_metric(solution: np.ndarray, metric: str = "total_signal") -> float:
    """Scalar Y from an ODE solution (T, d_state): all states contribute."""
    vals = solution
    if metric == "total_signal":
        return float(vals.sum())
    if metric in ("mean_activity", "mean"):
        return float(vals.mean())
    if metric == "variance":
        return float(((vals - vals.mean()) ** 2).mean())
    if metric == "dynamics":
        return float((np.diff(vals, axis=0) ** 2).sum())
    if metric == "l2_norm":
        return float(np.sqrt((vals ** 2).sum()))
    raise ValueError(f"Unknown Y metric: {metric}")
