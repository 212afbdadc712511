"""Population objectives: thetas (P, n) -> F (P, 3).

Counterpart of ``phoskintime_tpu/network/objective.py``. One evaluation
unpacks the softplus parameters, integrates with the batched exponential
path (:mod:`phoskintime_tpu_torch.network.expo`,
:func:`make_population_objective`) or an oracle solver
(:func:`make_objective`), and scores the three
modalities (protein, RNA, phospho) with a robust loss, each weight-sum
normalized, plus a prior-adherence penalty added to all three. A member
whose integration fails or whose losses are not finite gets ``fail_value``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from phoskintime_tpu_torch.network.expo import (exponential_simulate,
                                                exponential_simulate_batched)
from phoskintime_tpu_torch.network.params import unpack_params
from phoskintime_tpu_torch.network.simulate import extract_observables, simulate_batched
from phoskintime_tpu_torch.ops.losses import robust_loss

EPS = 1e-9
PRIOR_KEYS = ("A_i", "B_i", "C_i", "D_i", "E_i")


def modality_losses(obs_tuple, loss_data, loss_mode: int):
    """(loss_protein, loss_rna, loss_phospho) raw weighted sums, by gathers
    from observables with a leading population axis: R/TOT (P, T, N),
    PHO (P, T, N, Smax). Each loss is (P,)."""
    R, TOT, PHO = obs_tuple
    lf = robust_loss(loss_mode)
    ld = loss_data
    f = dict(device=R.device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), **f)

    def one(sig, base_idx, p_idx, t_idx, s_idx, obs, w):
        key = (idx(t_idx), idx(p_idx)) + (() if s_idx is None else (idx(s_idx),))
        base_key = (base_idx,) + key[1:]
        cur = sig[(slice(None),) + key]
        base = sig[(slice(None),) + base_key]
        pred_fc = torch.clamp(cur, min=EPS) / torch.clamp(base, min=EPS)
        obs = torch.tensor(np.asarray(obs, float), dtype=sig.dtype, **f)
        w = torch.tensor(np.asarray(w, float), dtype=sig.dtype, **f)
        return torch.sum(w * lf(obs - pred_fc, pred_fc, obs), dim=1)

    return (one(TOT, ld.prot_base_idx, ld.p_prot, ld.t_prot, None,
                ld.obs_prot, ld.w_prot),
            one(R, ld.rna_base_idx, ld.p_rna, ld.t_rna, None,
                ld.obs_rna, ld.w_rna),
            one(PHO, ld.pho_base_idx, ld.p_pho, ld.t_pho, ld.s_pho,
                ld.obs_pho, ld.w_pho))


def _dense_loss_tensors(loss_data, T: int, N: int, Smax: int):
    """The observation table scattered into dense (T, N[, Smax]) obs and
    weight arrays (weight 0 at holes, obs 1 there so every robust loss
    stays finite), which makes the loss elementwise. None when a
    (t, p[, s]) key repeats: replicate observations need the gather path,
    whose sums count each one."""
    ld = loss_data

    def dense(shape, t_idx, p_idx, s_idx, obs, w):
        O = np.ones(shape, np.float64)
        W = np.zeros(shape, np.float64)
        idx = ((np.asarray(t_idx), np.asarray(p_idx)) if s_idx is None else
               (np.asarray(t_idx), np.asarray(p_idx), np.asarray(s_idx)))
        flat = np.ravel_multi_index(idx, shape)
        if len(np.unique(flat)) != len(flat):
            return None
        O[idx] = np.asarray(obs, np.float64)
        W[idx] = np.asarray(w, np.float64)
        return O, W

    out = (dense((T, N), ld.t_prot, ld.p_prot, None, ld.obs_prot, ld.w_prot),
           dense((T, N), ld.t_rna, ld.p_rna, None, ld.obs_rna, ld.w_rna),
           dense((T, N, Smax), ld.t_pho, ld.p_pho, ld.s_pho,
                 ld.obs_pho, ld.w_pho))
    return None if any(d is None for d in out) else out


def _auto_pop_chunk(n_proteins: int, lanes_target: int = 81920) -> int:
    """Population chunk holding about ``lanes_target`` ODE lanes (P*N): the
    tables (U, w, w, P*N) and the scan state scale with lanes, not members.
    The same policy as the JAX package; not yet tuned on the GPU."""
    return min(8192, max(256, 2 ** round(
        math.log2(max(1.0, lanes_target / max(1, n_proteins))))))


# entries of ESDIRK's (P, d, d) Jacobians in one population chunk: 268 MB
# at float64; the vmapped RHS of the d tangent columns holds tensors of the
# same size. Sized for memory, not tuned.
_ESDIRK_JACOBIAN_ENTRIES = 1 << 25


def _esdirk_pop_chunk(n_proteins: int, d: int) -> int:
    """ESDIRK's population chunk: the largest power of two P with P d^2 at
    most ``_ESDIRK_JACOBIAN_ENTRIES``, at least 1 and at most
    :func:`_auto_pop_chunk`."""
    fit = max(1, _ESDIRK_JACOBIAN_ENTRIES // (d * d))
    return min(_auto_pop_chunk(n_proteins), 1 << (fit.bit_length() - 1))


def _scorer(system, loss_data, defaults, lambdas, n_times: int, loss_mode: int,
            fail_value: float, dense_loss: bool):
    """``score(params_b, ys, success) -> F (P, 3)``: the three weight-sum
    normalized modality losses of each member's trajectory, each plus the
    prior-adherence penalty (the mean squared relative deviation of the
    protein-level parameters from ``defaults``); ``fail_value`` where the
    integration failed or a loss is not finite. ``dense_loss``: the dense
    masked loss where the observation table allows it, else the gathers of
    :func:`modality_losses`."""
    rhs = system.rhs
    f = dict(dtype=rhs.Kmat.dtype, device=rhs.Kmat.device)
    scales = [(1.0 / max(1e-6, float(np.sum(w))), lambdas[m]) for m, w in
              (("protein", loss_data.w_prot), ("rna", loss_data.w_rna),
               ("phospho", loss_data.w_pho))]
    defaults_t = {k: torch.as_tensor(np.asarray(defaults[k], float), **f)
                  for k in PRIOR_KEYS}
    cnt = max(1, sum(defaults_t[k].numel() for k in PRIOR_KEYS))
    topo = system.topo
    dense = (_dense_loss_tensors(loss_data, n_times, topo.N, topo.max_sites)
             if dense_loss else None)
    if dense is not None:
        dense = [(torch.as_tensor(O, **f), torch.as_tensor(W, **f)) for O, W in dense]
    lf = robust_loss(loss_mode)
    ld = loss_data

    def dense_one(sig, base_idx, OW):
        O, W = OW
        fc = torch.clamp(sig, min=EPS) / torch.clamp(sig[:, base_idx:base_idx + 1], min=EPS)
        return torch.sum((W * lf(O - fc, fc, O)).reshape(sig.shape[0], -1), dim=1)

    def score(params_b, ys, success):
        acc = 0.0
        for k in PRIOR_KEYS:
            diff = (params_b[k] - defaults_t[k][None]) / (defaults_t[k][None] + 1e-6)
            acc = acc + torch.sum((diff ** 2).reshape(diff.shape[0], -1), dim=1)
        prior_penalty = lambdas["prior"] * acc / cnt
        obs = extract_observables(system, ys)
        if dense is not None:
            losses = (dense_one(obs.TOT, ld.prot_base_idx, dense[0]),
                      dense_one(obs.R, ld.rna_base_idx, dense[1]),
                      dense_one(obs.PHO, ld.pho_base_idx, dense[2]))
        else:
            losses = modality_losses(obs, ld, loss_mode)
        F = torch.stack([l * n * lam for l, (n, lam) in zip(losses, scales)], dim=1)
        F = F + prior_penalty[:, None]
        ok = success & torch.isfinite(F).all(dim=1)
        return torch.where(ok[:, None], F, torch.full_like(F, fail_value))

    return score


def _in_chunks(objective_chunk, pop_chunk, n_proteins: int, f: dict):
    """``objective_pop(thetas)``: ``objective_chunk`` over chunks of at most
    ``pop_chunk`` members, the last chunk padded with copies of the last
    row whose results are dropped; ``"auto"`` sizes it by
    :func:`_auto_pop_chunk`, None never chunks."""
    if isinstance(pop_chunk, str):               # "auto"
        pop_chunk = _auto_pop_chunk(n_proteins)

    @torch.no_grad()
    def objective_pop(thetas):
        thetas = torch.as_tensor(thetas, **f)
        P = thetas.shape[0]
        if pop_chunk is None or P <= pop_chunk:
            return objective_chunk(thetas)
        pad = (-P) % pop_chunk
        if pad:
            thetas = torch.cat([thetas, thetas[-1:].expand(pad, -1)], dim=0)
        return torch.cat([objective_chunk(c) for c in thetas.split(pop_chunk)])[:P]

    return objective_pop


def make_population_objective(system, slices, loss_data, defaults, lambdas,
                              time_grid, loss_mode=0, fail_value=1e12,
                              y0=None, substep=16.0, use_kernel=None,
                              differentiable=False, pop_chunk="auto",
                              width_bucketing=None, use_scan_kernel=None):
    """Batched objective ``thetas (P, n) -> F (P, 3)`` on the system's
    device and dtype, by :func:`exponential_simulate_batched` (ETD2RK for
    models 0-2, exponential Rosenbrock for model 4).

    ``pop_chunk``: see :func:`_in_chunks`. ``use_kernel`` goes to the
    propagator-table build (None: the
    CUDA kernels on a CUDA system; False: the plain version).
    ``width_bucketing`` goes to the integrator (None: per-width-class
    tables for the combinatorial mechanism at w >= 9), and so does
    ``use_scan_kernel`` (None: the eager scan; True: the whole unbucketed
    scan as one kernel).
    ``differentiable=True`` is not ported yet and raises."""
    if differentiable:
        raise NotImplementedError(
            "differentiable=True is not ported yet (ROADMAP.md queue 1 item 4, "
            "'Gradients and polish')")
    t_eval = np.asarray(time_grid, float)
    score = _scorer(system, loss_data, defaults, lambdas, len(t_eval), loss_mode,
                    fail_value, dense_loss=True)
    topo = system.topo

    def objective_chunk(thetas):
        params_b = unpack_params(thetas, slices, topo)
        ys, success = exponential_simulate_batched(
            system, params_b, t_eval, substep=substep, y0=y0,
            use_kernel=use_kernel, width_bucketing=width_bucketing,
            use_scan_kernel=use_scan_kernel)
        return score(params_b, ys, success)

    objective_pop = _in_chunks(objective_chunk, pop_chunk, topo.N,
                               dict(dtype=system.rhs.Kmat.dtype,
                                    device=system.rhs.Kmat.device))
    # population-native: run_global_fit may run variation (and survival) on
    # the device around it
    objective_pop._is_population = True
    return objective_pop


def make_objective(system, slices, loss_data, defaults, lambdas, time_grid,
                   loss_mode=0, fail_value=1e12, rtol=1e-5, atol=1e-7,
                   max_steps=5000, y0=None, solver="rk45", substep=16.0,
                   pop_chunk="auto", use_kernel=None):
    """The oracle objective, batched: ``thetas (P, n) -> F (P, 3)``, the
    counterpart of ``jax.vmap`` of the JAX package's ``make_objective``.

    Each member unpacks its softplus parameters and integrates on its own:
    ``solver="expo"`` by the per-candidate
    :func:`~phoskintime_tpu_torch.network.expo.exponential_simulate`
    (``substep``), any other name by
    :func:`~phoskintime_tpu_torch.network.simulate.simulate_batched`
    (``"esdirk"`` or RK45; ``rtol``, ``atol``, ``max_steps``). It is scored
    by the gathers of :func:`modality_losses` plus the prior penalty;
    ``fail_value`` where its integration failed or a loss is not finite.
    ``pop_chunk`` as :func:`make_population_objective`, except that
    ``"auto"`` sizes ESDIRK's chunk by its Jacobians (:func:`_esdirk_pop_chunk`);
    ``use_kernel`` goes to the model-2 edge flux (False: its plain
    version). After each call,
    ``objective.n_steps`` holds the (P,) int32 step counts of its members."""
    t_eval = np.asarray(time_grid, float)
    score = _scorer(system, loss_data, defaults, lambdas, len(t_eval), loss_mode,
                    fail_value, dense_loss=False)
    topo = system.topo
    steps = []
    if solver == "esdirk" and isinstance(pop_chunk, str):
        pop_chunk = _esdirk_pop_chunk(topo.N, topo.N * topo.width)

    def objective_chunk(thetas):
        params_b = unpack_params(thetas, slices, topo)
        if solver == "expo":
            res = exponential_simulate(system, params_b, t_eval, substep=substep, y0=y0)
        else:
            res = simulate_batched(system, params_b, t_eval, rtol=rtol, atol=atol,
                                   max_steps=max_steps, y0=y0, solver=solver,
                                   use_kernel=use_kernel)
        steps.append(res.n_steps)
        return score(params_b, res.ys, res.success)

    run = _in_chunks(objective_chunk, pop_chunk, topo.N,
                     dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device))

    def objective(thetas):
        steps.clear()
        F = run(thetas)
        objective.n_steps = torch.cat(steps)[:F.shape[0]]
        return F

    return objective


def evaluate_population(objective, thetas):
    """Evaluate a (P, n) population on one device. The JAX package's mesh
    sharding is ROADMAP.md queue 1 item 1b, "Population sharding"."""
    return objective(thetas)
