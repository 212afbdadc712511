"""Long-horizon steady-state analysis.

Counterpart of ``phoskintime_tpu/network/analysis.py``: simulate seven
days on a log-spaced grid with the RK45 oracle, check each protein's rate
of change at the end against a tolerance, and report the levels; the
kinase dominance of each protein's phospho drive.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.network.simulate import extract_observables, simulate

MINUTES_7_DAYS = 7 * 24 * 60.0


class SteadyStateReport(NamedTuple):
    times: np.ndarray
    tot: np.ndarray            # (T, N) total protein
    rna: np.ndarray            # (T, N)
    converged: np.ndarray      # (N,) bool
    final_rate: np.ndarray     # (N,) |d(tot)/dt| over the last interval
    ss_value: np.ndarray       # (N,) final level


def simulate_until_steady(system, params, *, t_final=MINUTES_7_DAYS,
                          n_points=120, rtol=1e-6, atol=1e-8,
                          max_steps=200_000, y0=None,
                          conv_rtol=1e-6, conv_atol=1e-8) -> SteadyStateReport:
    """One member simulated to ``t_final`` on a log-spaced grid (steps up to
    ``t_final`` long), then a convergence check per protein on the total's
    rate of change over the last interval. Host numpy results."""
    times = np.unique(np.concatenate([
        [0.0], np.logspace(np.log10(0.5), np.log10(t_final), n_points)]))
    res = simulate(system, params, times, rtol=rtol, atol=atol,
                   max_steps=max_steps, y0=y0, dt_max=float(t_final))
    obs = extract_observables(system, res.ys)
    tot = obs.TOT.cpu().numpy()
    rna = obs.R.cpu().numpy()
    dt = times[-1] - times[-2]
    rate = np.abs(tot[-1] - tot[-2]) / dt
    converged = rate <= (conv_atol + conv_rtol * np.abs(tot[-1]))
    return SteadyStateReport(times, tot, rna, converged, rate, tot[-1])


def kinase_dominance(system, params) -> np.ndarray:
    """(N, K): each kinase's share of each protein's total phospho drive,
    sum_j W[i, j, k] c_k[k], normalized per row (rows without drive stay 0)."""
    W = np.asarray(system.topo.W_pad, float)
    ck = params["c_k"]
    ck = ck.cpu().numpy() if isinstance(ck, torch.Tensor) else np.asarray(ck, float)
    contrib = (W * ck[None, None, :]).sum(axis=1)
    total = contrib.sum(axis=1, keepdims=True)
    return contrib / np.where(total > 0, total, 1.0)
