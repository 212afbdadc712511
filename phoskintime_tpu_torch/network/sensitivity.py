"""Global-model Morris sensitivity.

Counterpart of ``phoskintime_tpu/network/sensitivity.py``: Morris over the
fitted raw parameter vector (+/-5% hypercube, 100 trajectories x 40
levels by default), each sample one full-network simulation, a scalar
metric over the fold changes, and the perturbation clouds nearest the
median. Where the JAX package runs ``jax.jit(jax.vmap(run_one))`` over
batches of ``batch_size`` samples, each batch here is one
:func:`~phoskintime_tpu_torch.network.simulate.simulate_batched` call (the
counterpart of ``jax.vmap`` of the JAX ``while_loop``, held to it step for
step), then batched observables and fold changes on the system's device.
On a CUDA model-2 system every RK45 stage launches the edge-flux kernel
(``csrc/hypercube_flux.cu``). The host reads the fold changes once, after
the last batch; the Morris design and analysis
(:mod:`~phoskintime_tpu_torch.ops.morris`) are numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.network.params import unpack_params
from phoskintime_tpu_torch.network.simulate import (extract_observables, fold_changes,
                                                    simulate_batched)
from phoskintime_tpu_torch.ops.morris import MorrisResult, morris_analyze, morris_sample


class GlobalSensitivityOutput(NamedTuple):
    morris: MorrisResult
    samples: np.ndarray
    Y: np.ndarray
    fc_clouds: dict   # {"rna"|"protein"|"phospho": (n_keep, T, ...)}


def run_sensitivity_analysis(system, slices, theta_best: np.ndarray,
                             time_grid: np.ndarray,
                             perturbation: float = 0.05,
                             n_trajectories: int = 100,
                             num_levels: int = 40,
                             metric: str = "total_signal",
                             top_curves: int = 20,
                             rtol: float = 1e-5, atol: float = 1e-7,
                             max_steps: int = 5000,
                             y0=None, seed: int = 42,
                             batch_size: int = 128,
                             use_kernel: bool | None = None) -> GlobalSensitivityOutput:
    """Morris elementary effects of ``metric`` over the fold changes, on the
    system's device and dtype; arguments as the JAX package's.
    ``use_kernel`` goes to the model-2 edge flux (None: the kernel on a CUDA
    system; False: its plain version)."""
    theta_best = np.asarray(theta_best, float)
    lo = theta_best - perturbation * np.abs(theta_best) - 1e-9
    hi = theta_best + perturbation * np.abs(theta_best) + 1e-9
    bounds = np.stack([lo, hi], axis=1)

    rng = np.random.default_rng(seed)
    X = morris_sample(bounds, n_trajectories, num_levels, rng)
    times = np.asarray(time_grid, float)
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device)

    fcs = []
    for i in range(0, len(X), batch_size):
        params_b = unpack_params(torch.as_tensor(X[i:i + batch_size], **f), slices,
                                 system.topo)
        res = simulate_batched(system, params_b, times, rtol=rtol, atol=atol,
                               max_steps=max_steps, y0=y0, use_kernel=use_kernel)
        fcs.append(fold_changes(extract_observables(system, res.ys), times))
    fc_r, fc_p, fc_ph = (torch.cat(parts).to("cpu", torch.float64).numpy()
                         for parts in zip(*fcs))

    stacked = np.concatenate([fc_r.reshape(len(X), -1),
                              fc_p.reshape(len(X), -1),
                              fc_ph.reshape(len(X), -1)], axis=1)
    if metric == "total_signal":
        Y = stacked.sum(axis=1)
    elif metric == "mean":
        Y = stacked.mean(axis=1)
    elif metric == "variance":
        Y = stacked.var(axis=1)
    elif metric == "l2_norm":
        Y = np.sqrt((stacked ** 2).sum(axis=1))
    else:
        raise ValueError(f"Unknown metric {metric}")

    res = morris_analyze(bounds, X, Y, num_levels, seed=seed)

    keep = min(top_curves, len(X))
    order = np.argsort(np.abs(Y - np.median(Y)), kind="stable")[:keep]
    clouds = {"rna": fc_r[order], "protein": fc_p[order], "phospho": fc_ph[order]}
    return GlobalSensitivityOutput(res, X, Y, clouds)
