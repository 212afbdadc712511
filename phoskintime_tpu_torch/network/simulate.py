"""Simulation by the oracle integrators, observables and fold changes.

Counterpart of ``phoskintime_tpu/network/simulate.py``: :func:`simulate`
(one member, the JAX package's signature) and :func:`simulate_batched` (a
population, the counterpart of ``jax.vmap`` of ``simulate``) integrate the
padded system with the solver named, as the JAX package dispatches it:
``"esdirk"`` :func:`~phoskintime_tpu_torch.ops.stiff.odeint_esdirk`,
``"expo"`` :func:`~phoskintime_tpu_torch.network.expo.exponential_simulate`,
any other name :func:`~phoskintime_tpu_torch.ops.integrators.odeint_rk45`
(the default ``"rk45"``), the kinase grid as bucket boundaries;
:func:`extract_observables` and :func:`fold_changes` read a trajectory;
:func:`simulate_and_measure` returns one member's fold changes as the
three observation tables (column dicts) on the modality grids.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.network.expo import exponential_simulate
from phoskintime_tpu_torch.ops.integrators import ODEResult, odeint_rk45
from phoskintime_tpu_torch.ops.stiff import odeint_esdirk

EPS = 1e-12
#: RK45 loop passes that one CUDA graph replay holds on the card
RK45_GRAPH_STEPS = 32


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
    the model-2 edge flux (None: the kernel on a CUDA system).

    On the card RK45 runs as replays of a CUDA graph of
    ``RK45_GRAPH_STEPS`` loop passes (:func:`odeint_rk45`; the same results
    at a fraction of the eager loop's launch cost), except where the RHS
    launches the model-2 flux kernel, whose wrapper counts each launch on
    the host (a replay would skip it), or where a gradient is to flow
    through the solve (a replay records no autograd graph)."""
    rhs = system.rhs
    f = dict(dtype=rhs.Kmat.dtype, device=rhs.Kmat.device)
    params_b = {k: torch.as_tensor(v, **f) for k, v in params_b.items()}
    P = params_b["c_k"].shape[0]
    d = rhs.N * rhs.width
    y0 = torch.as_tensor(system.y0() if y0 is None else y0, **f)
    y0 = y0.reshape(-1, d).expand(P, d).contiguous()
    if solver == "expo":
        return exponential_simulate(system, params_b, t_eval, y0=y0)
    rhs_b = system.rhs_batched(params_b, use_kernel)
    kw = dict(boundaries=np.asarray(system.kin_grid, float), max_steps=max_steps, rtol=rtol,
              atol=atol, dt_max=dt_max)
    if solver == "esdirk":
        return odeint_esdirk(rhs_b, y0, t_eval, **kw)
    counted = system.topo.model == 2 and use_kernel is not False
    grad = torch.is_grad_enabled() and any(v.requires_grad for v in (y0, *params_b.values()))
    graphed = y0.is_cuda and not (counted or grad)
    return odeint_rk45(rhs_b, y0, t_eval, graph_steps=RK45_GRAPH_STEPS if graphed else 0, **kw)


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


def simulate_and_measure(system, params, t_points_p, t_points_r, t_points_pho,
                         rtol=1e-5, atol=1e-7, max_steps=5000, y0=None):
    """One member's predicted fold changes as three tables (protein {protein,
    time, pred_fc}, RNA the same, phospho {protein, psite, time, pred_fc}),
    gene-major, then site, then time, each on its modality's grid: one
    RK45 solve on the system's device over the union of the grids."""
    grids = [np.asarray(t, float) for t in (t_points_p, t_points_r, t_points_pho)]
    times = np.unique(np.concatenate(grids))
    res = simulate(system, params, times, rtol=rtol, atol=atol, max_steps=max_steps, y0=y0)
    fc_r, fc_p, fc_pho = (x.to("cpu", torch.float64).numpy() for x in
                          fold_changes(extract_observables(system, res.ys), times))
    on_p, on_r, on_pho = (np.isin(times, g) for g in grids)
    topo = system.topo
    prot = {"protein": [], "time": [], "pred_fc": []}
    rna = {"protein": [], "time": [], "pred_fc": []}
    pho = {"protein": [], "psite": [], "time": [], "pred_fc": []}
    for i, gene in enumerate(topo.proteins):
        for table, fc, on in ((prot, fc_p, on_p), (rna, fc_r, on_r)):
            table["protein"] += [gene] * int(on.sum())
            table["time"].append(times[on])
            table["pred_fc"].append(fc[on, i])
        for j, psite in enumerate(topo.sites[i]):
            pho["protein"] += [gene] * int(on_pho.sum())
            pho["psite"] += [psite] * int(on_pho.sum())
            pho["time"].append(times[on_pho])
            pho["pred_fc"].append(fc_pho[on_pho, i, j])

    def columns(table):
        return {k: np.concatenate(v + [np.zeros(0)]) if k in ("time", "pred_fc")
                else np.asarray(v, dtype=object) for k, v in table.items()}
    return columns(prot), columns(rna), columns(pho)
