"""tfopt optimizers: local multistart (projected Adam) and evolutionary
3-objective search.

Counterpart of ``phoskintime_tpu/tfopt/optimize.py``: the 48-start
multistart as one batch of projected-Adam steps, and the evolutionary fit
over (loss, alpha-viol^2, beta-viol^2) at pop = min(2 n_var, 400) by the
reference's optimizer codes: 0 U-NSGA-III (on the host, or with
``gens_per_dispatch > 1`` the all-device loop), 1 SMS-EMOA (exact
3-objective hypervolume survival), 2 AGE-MOEA (adaptive p-norm geometry
survival), any other NSGA-II. The host loops evaluate each generation's
population in one call on the device. Every entry runs on the card unless
the caller passes ``device="cpu"``, at the device's working dtype unless
it passes ``dtype``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import (DEFAULT_DEVICE, numpy_dtype, resolve_device,
                                                   working_dtype)
from phoskintime_tpu_torch.ops.constrained import PaddedGroups, project_sum_box, projected_adam
from phoskintime_tpu_torch.ops.nsga import run_agemoea, run_nsga2, run_smsemoa, run_unsga3
from phoskintime_tpu_torch.ops.nsga_device import run_unsga3_device
from phoskintime_tpu_torch.tfopt.model import TfoptProblem, tfopt_loss, violation_sq


class TfoptResult(NamedTuple):
    alpha: np.ndarray
    beta: np.ndarray
    loss: float
    all_losses: np.ndarray
    feasible: bool


def _project(prob: TfoptProblem, device):
    am = torch.as_tensor(prob.alpha_mask, device=device)
    bm = torch.as_tensor(prob.beta_mask, device=device)

    # TFs without psites: the single beta slot is pinned to 1 by the projection
    def proj(x):
        a, b = x
        return project_sum_box(a, 0.0, 1.0, am), project_sum_box(b, prob.lb, prob.ub, bm)
    return proj


def _random_start(prob: TfoptProblem, rng: np.random.Generator):
    """Uniform starts normalized per group (reference utils/params.py:40-66)."""
    a = rng.random(prob.alpha_mask.shape) * prob.alpha_mask
    a /= np.maximum(a.sum(axis=1, keepdims=True), 1e-12)
    b = rng.uniform(prob.lb, prob.ub, prob.beta_mask.shape) * prob.beta_mask
    s = b.sum(axis=1, keepdims=True)
    b = np.where(np.abs(s) > 1e-9, b / np.where(np.abs(s) > 1e-9, s, 1.0), b)
    b[prob.no_psite_tf, 0] = 1.0
    return a, b


def _host(x) -> np.ndarray:
    return x.to("cpu", torch.float64).numpy()


def run_local(prob: TfoptProblem, loss_type: int = 0, n_starts: int = 48,
              steps: int = 800, lr: float = 0.02, seed: int = 42,
              lam1: float = 1e-6, lam2: float = 1e-6, *,
              device=DEFAULT_DEVICE, dtype=None) -> TfoptResult:
    """Multistart projected Adam, every start in one batch on the device;
    the host reads the per-start losses once, at the end."""
    device = resolve_device(device)
    f = dict(dtype=dtype or working_dtype(device), device=device)
    rng = np.random.default_rng(seed)
    starts = [_random_start(prob, rng) for _ in range(n_starts)]
    A0 = torch.as_tensor(np.stack([s[0] for s in starts]), **f)
    B0 = torch.as_tensor(np.stack([s[1] for s in starts]), **f)

    (A, B), losses = projected_adam(
        lambda x: tfopt_loss(prob, x[0], x[1], loss_type, lam1, lam2),
        (A0, B0), _project(prob, device), steps=steps, lr=lr)
    losses = _host(losses)
    i = int(np.nanargmin(losses))
    av, bv = violation_sq(prob, A[i], B[i])
    return TfoptResult(_host(A[i]), _host(B[i]), float(losses[i]), losses,
                       bool(float(av) + float(bv) < 1e-8))


def run_evolutionary(prob: TfoptProblem, optimizer: int = 0,
                     loss_type: int = 0, pop_size: int | None = None,
                     n_gen: int = 200, seed: int = 42,
                     lam1: float = 1e-3, lam2: float = 1e-3,
                     gens_per_dispatch: int = 1, *,
                     device=DEFAULT_DEVICE, dtype=None) -> TfoptResult:
    """3-objective evolutionary fit; optimizer 0/1/2 per the reference's
    codes (see the module doc). ``gens_per_dispatch > 1`` (optimizer 0
    only): the all-device U-NSGA-III loop, one host read a block."""
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    f = dict(dtype=dtype, device=device)
    n = prob.n_alpha + prob.n_beta
    if pop_size is None:
        pop_size = min(2 * n, 400)
    xl = np.concatenate([np.zeros(prob.n_alpha), np.full(prob.n_beta, prob.lb)])
    xu = np.concatenate([np.ones(prob.n_alpha), np.full(prob.n_beta, prob.ub)])

    groups = PaddedGroups(prob.alpha_mask, prob.beta_mask, device)

    @torch.no_grad()
    def eval_multi(X):
        A, B = groups.padded(X)
        return torch.stack([tfopt_loss(prob, A, B, loss_type, lam1, lam2),
                            *violation_sq(prob, A, B)], dim=1)

    evaluate = lambda X: _host(eval_multi(torch.as_tensor(X, **f)))
    host_dtype = numpy_dtype(dtype)
    if optimizer == 0 and gens_per_dispatch > 1:
        res = run_unsga3_device(eval_multi, xl, xu, pop_size=pop_size,
                                n_gen=n_gen, n_obj=3, n_partitions=12,
                                seed=seed, ftol=0.0, n_max_evals=None,
                                gens_per_block=gens_per_dispatch, device=device,
                                dtype=dtype)
    elif optimizer == 0:
        res = run_unsga3(evaluate, xl, xu, pop_size=pop_size, n_gen=n_gen,
                         n_obj=3, n_partitions=12, seed=seed, ftol=0.0,
                         n_max_evals=None, dtype=host_dtype)
    elif optimizer == 1:
        # generational (n_offsprings = pop_size), the pymoo configuration
        # the reference runs: n_gen carries the same evaluation budget as
        # the other codes
        res = run_smsemoa(evaluate, xl, xu, pop_size=pop_size,
                          n_gen=n_gen, seed=seed, dtype=host_dtype)
    elif optimizer == 2:
        res = run_agemoea(evaluate, xl, xu, pop_size=pop_size, n_gen=n_gen,
                          seed=seed, dtype=host_dtype)
    else:
        res = run_nsga2(evaluate, xl, xu, pop_size=pop_size, n_gen=n_gen,
                        seed=seed, dtype=host_dtype)

    pf = res.pareto_F
    viol = pf[:, 1] + pf[:, 2]
    feas = viol <= max(1e-6, float(np.quantile(viol, 0.25)))
    cand = np.where(feas)[0]
    best = cand[np.argmin(pf[cand, 0])]
    a, b = prob.unpack(res.pareto_X[best])
    loss = float(tfopt_loss(prob, torch.as_tensor(a, **f), torch.as_tensor(b, **f),
                            loss_type, lam1, lam2))
    return TfoptResult(a, b, loss,
                       np.asarray([h[1] for h in res.history] or [loss]),
                       bool(viol[best] < 1e-3))
