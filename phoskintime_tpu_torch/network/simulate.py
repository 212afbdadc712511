"""Simulation by the oracle integrators, observables and fold changes.

Counterpart of ``phoskintime_tpu/network/simulate.py``: :func:`simulate`
(one member, the JAX package's signature) and :func:`simulate_batched` (a
population, the counterpart of ``jax.vmap`` of ``simulate``) integrate the
padded system with the solver named, as the JAX package dispatches it:
``"esdirk"`` :func:`~phoskintime_tpu_torch.ops.stiff.odeint_esdirk`,
``"expo"`` :func:`~phoskintime_tpu_torch.network.expo.exponential_simulate`,
any other name :func:`~phoskintime_tpu_torch.ops.integrators.odeint_rk45`
(the default ``"rk45"``), the kinase grid as bucket boundaries;
:func:`extract_observables` and :func:`fold_changes` read a trajectory.
``simulate_and_measure`` returns pandas frames and waits for the host
layer (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.network.expo import exponential_simulate
from phoskintime_tpu_torch.ops.integrators import ODEResult, odeint_rk45
from phoskintime_tpu_torch.ops.stiff import odeint_esdirk

EPS = 1e-12


class Observables(NamedTuple):
    R: torch.Tensor     # (..., T, N) mRNA
    TOT: torch.Tensor   # (..., T, N) total protein
    PHO: torch.Tensor   # (..., T, N, Smax) per-site phospho signal


def simulate_batched(system, params_b: dict, t_eval, rtol=1e-5, atol=1e-7,
                     max_steps=5000, y0=None, dt_max=16.0, solver: str = "rk45",
                     use_kernel: bool | None = None) -> ODEResult:
    """Integrate a population on the system's device and dtype: every leaf
    of ``params_b`` has a leading axis P (tensors or numpy). ``y0``: None
    (the system's default), one padded state (N, width) or (N*width,) for
    every member, or (P, N*width). Returns ys (P, T, N*width) and per-member
    success and step counts. ``solver``: see the module doc; ``"expo"``
    takes no tolerances (its plan's substep is 16). ``use_kernel`` goes to
    the model-2 edge flux (None: the kernel on a CUDA system)."""
    rhs = system.rhs
    f = dict(dtype=rhs.Kmat.dtype, device=rhs.Kmat.device)
    params_b = {k: torch.as_tensor(v, **f) for k, v in params_b.items()}
    P = params_b["c_k"].shape[0]
    d = rhs.N * rhs.width
    y0 = torch.as_tensor(system.y0() if y0 is None else y0, **f)
    y0 = y0.reshape(-1, d).expand(P, d).contiguous()
    if solver == "expo":
        return exponential_simulate(system, params_b, t_eval, y0=y0)
    odeint = odeint_esdirk if solver == "esdirk" else odeint_rk45
    return odeint(system.rhs_batched(params_b, use_kernel), y0, t_eval,
                  boundaries=np.asarray(system.kin_grid, float),
                  max_steps=max_steps, rtol=rtol, atol=atol, dt_max=dt_max)


def simulate(system, params: dict, t_eval, rtol=1e-5, atol=1e-7, max_steps=5000,
             y0=None, dt_max=16.0, solver: str = "rk45") -> ODEResult:
    """One member: :func:`simulate_batched` at P = 1. Returns ys (T, N*width),
    success () and the step counts ()."""
    params_b = {k: v[None] if isinstance(v, torch.Tensor) else np.asarray(v)[None]
                for k, v in params.items()}
    res = simulate_batched(system, params_b, t_eval, rtol, atol, max_steps, y0,
                           dt_max, solver)
    return ODEResult(*(x[0] for x in res))


def extract_observables(system, Y_flat: torch.Tensor) -> Observables:
    """Raw observables from a padded trajectory (..., T, N*width); any
    leading axes (a population) carry through. Model 2: the total is the
    sum over valid states, and site j's signal sums the states with bit
    j set."""
    topo = system.topo
    Y = Y_flat.reshape(*Y_flat.shape[:-1], topo.N, topo.width)
    rhs = system.rhs
    if topo.model == 2:
        X = Y[..., 1:] * rhs.state_mask.to(Y.dtype)
        PHO = torch.einsum("...nm,jm->...nj", X, rhs.bits.to(Y.dtype))
        return Observables(Y[..., 0], X.sum(-1), PHO)
    sites = Y[..., 2:] * rhs.site_mask.to(Y.dtype)
    return Observables(Y[..., 0], Y[..., 1] + sites.sum(-1), sites)


def fold_changes(obs: Observables, times, t0_prot=0.0, t0_rna=4.0, t0_pho=0.0):
    """Fold changes against the baseline time points: returns (fc_rna,
    fc_protein, fc_phospho). The baseline is taken on the time axis (the
    second from last of R and TOT, the third from last of PHO), so any
    leading axes (a population) carry through; one trajectory has T
    leading, as in the JAX package."""
    times = np.asarray(times, float)
    base = lambda t0: int(np.argmin(np.abs(times - t0)))

    def fc(sig, b, axis):
        ref = sig.select(axis, b).unsqueeze(axis)
        return torch.clamp(sig, min=EPS) / torch.clamp(ref, min=EPS)

    return (fc(obs.R, base(t0_rna), -2), fc(obs.TOT, base(t0_prot), -2),
            fc(obs.PHO, base(t0_pho), -3))
