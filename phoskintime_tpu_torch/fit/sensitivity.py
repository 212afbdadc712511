"""Per-gene Morris sensitivity analysis.

Counterpart of ``phoskintime_tpu/fit/sensitivity.py``: a Morris sample
around the fitted parameters (+/-50% by default), one exact solve per
sample, a scalar Y metric, the Morris analysis at conf_level=0.99 (scaled),
and the top-K closest-RMSE trajectories. The design is solved in chunks of
``batch_size`` rows by :func:`solve_ode_batched`; the JAX package pads its
last chunk to one compiled shape, which changes no row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device, working_dtype
from phoskintime_tpu_torch.models.kinetics import solve_ode_batched
from phoskintime_tpu_torch.ops.morris import (MorrisResult, compute_bound, morris_analyze,
                                              morris_sample)


class SensitivityOutput(NamedTuple):
    morris: MorrisResult
    param_names: list[str]
    samples: np.ndarray          # (n_samples, d) design
    Y: np.ndarray                # (n_samples,) scalar metric
    top_solutions: np.ndarray    # (K, T, d_state) closest-RMSE trajectories
    top_indices: np.ndarray


def sensitivity_analysis(popt: np.ndarray,
                         init_cond: np.ndarray,
                         num_psites: int,
                         time_points: np.ndarray,
                         target: np.ndarray,
                         model: str = "distmod",
                         perturbation: float = 0.5,
                         num_trajectories: int = 1000,
                         num_levels: int = 400,
                         y_metric: str = "total_signal",
                         conf_level: float = 0.99,
                         top_k: int | None = None,
                         param_names: list[str] | None = None,
                         seed: int = 42,
                         batch_size: int = 4096,
                         *,
                         device=DEFAULT_DEVICE,
                         dtype=None) -> SensitivityOutput:
    """Morris sweep over one gene's fitted parameters, solved on
    ``device`` (default: the card; raises where there is none) at
    ``dtype`` (default: float32 on the card, float64 on the CPU)."""
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    popt = np.asarray(popt, float)
    d = len(popt)
    bounds = np.asarray([compute_bound(v, perturbation) for v in popt])
    rng = np.random.default_rng(seed)
    X = morris_sample(bounds, num_trajectories, num_levels, rng)

    sols_list, fits_list = [], []
    for i in range(0, len(X), batch_size):
        sols, fits = solve_ode_batched(X[i:i + batch_size], init_cond, num_psites,
                                       time_points, model, device=device, dtype=dtype)
        sols_list.append(sols.cpu().numpy())
        fits_list.append(fits.cpu().numpy())
    sols = np.concatenate(sols_list)
    fits = np.concatenate(fits_list)

    # scalar metric per sample (vectorized trajectory_metric)
    if y_metric == "total_signal":
        Y = sols.sum(axis=(1, 2))
    elif y_metric in ("mean_activity", "mean"):
        Y = sols.mean(axis=(1, 2))
    elif y_metric == "variance":
        Y = sols.var(axis=(1, 2))
    elif y_metric == "dynamics":
        Y = (np.diff(sols, axis=1) ** 2).sum(axis=(1, 2))
    elif y_metric == "l2_norm":
        Y = np.sqrt((sols ** 2).sum(axis=(1, 2)))
    else:
        raise ValueError(f"Unknown y_metric {y_metric}")

    res = morris_analyze(bounds, X, Y, num_levels, conf_level=conf_level, seed=seed)

    # top-K ~ N*10/levels closest-RMSE curves
    if top_k is None:
        top_k = max(1, num_trajectories * 10 // num_levels)
    rmse = np.sqrt(np.mean((fits - np.asarray(target)[None]) ** 2, axis=1))
    top_idx = np.argsort(rmse, kind="stable")[:top_k]

    if param_names is None:
        param_names = [f"p{i}" for i in range(d)]
    return SensitivityOutput(res, param_names, X, Y, sols[top_idx], top_idx)
