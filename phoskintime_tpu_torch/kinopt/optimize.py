"""kinopt optimizers: local (multistart projected Adam) and evolutionary
(DE single-objective / NSGA-II 3-objective).

Counterpart of ``phoskintime_tpu/kinopt/optimize.py``. The local path runs
all starts as one batch of projected-Adam steps with the exact simplex-box
projection (feasible by construction); the evolutionary path runs DE with
the whole loop on the device (:mod:`~phoskintime_tpu_torch.ops.de_jit`)
and NSGA-II either on the host (:func:`~phoskintime_tpu_torch.ops.nsga.run_nsga2`,
one device evaluation a generation) or, with ``gens_per_dispatch > 1``,
with the whole generation on the device
(:func:`~phoskintime_tpu_torch.ops.nsga_device.run_nsga2_device`). Every
entry runs on the card unless the caller passes ``device="cpu"``, at the
device's working dtype unless it passes ``dtype``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import (DEFAULT_DEVICE, numpy_dtype, resolve_device,
                                                   working_dtype)
from phoskintime_tpu_torch.kinopt.model import (KinoptProblem, constraint_violations,
                                                kinopt_loss, violation_sq)
from phoskintime_tpu_torch.ops.constrained import PaddedGroups, project_sum_box, projected_adam
from phoskintime_tpu_torch.ops.de_jit import run_de_device
from phoskintime_tpu_torch.ops.nsga import MOOResult, run_nsga2
from phoskintime_tpu_torch.ops.nsga_device import run_nsga2_device


class KinoptResult(NamedTuple):
    alpha: np.ndarray       # (n_gp, Amax) padded
    beta: np.ndarray        # (n_k, Bmax) padded
    loss: float
    all_losses: np.ndarray  # per-start losses (local) or history (evol)
    feasible: bool


def _project(prob: KinoptProblem, device):
    gmask = torch.as_tensor(prob.gp_mask, device=device)
    kmask = torch.as_tensor(prob.k_mask, device=device)

    def proj(x):
        a, b = x
        return (project_sum_box(a, prob.lb, prob.ub, gmask),
                project_sum_box(b, prob.lb, prob.ub, kmask))
    return proj


def _random_start(prob: KinoptProblem, rng: np.random.Generator,
                  jitter_base=None, jitter=0.1):
    if jitter_base is not None:
        a0, b0 = jitter_base
        a = a0 + jitter * rng.normal(size=a0.shape)
        b = b0 + jitter * rng.normal(size=b0.shape)
    else:
        a = rng.uniform(0, 1, prob.gp_mask.shape) * prob.gp_mask
        a /= np.maximum(a.sum(axis=1, keepdims=True), 1e-12)
        b = rng.uniform(0, 1, prob.k_mask.shape) * prob.k_mask
        b /= np.maximum(b.sum(axis=1, keepdims=True), 1e-12)
    return a * prob.gp_mask, b * prob.k_mask


def _device_dtype(device, dtype):
    device = resolve_device(device)
    return device, dtype or working_dtype(device)


def _host(x) -> np.ndarray:
    return x.to("cpu", torch.float64).numpy()


def run_local(prob: KinoptProblem, loss_type: str = "base",
              include_reg: bool = False, n_starts: int = 48,
              steps: int = 800, lr: float = 0.02, seed: int = 42, *,
              device=DEFAULT_DEVICE, dtype=None) -> KinoptResult:
    """Multistart projected-Adam 'local' fit: every start in one batch on
    the device; the host reads the per-start losses once, at the end."""
    device, dtype = _device_dtype(device, dtype)
    f = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    starts = [_random_start(prob, rng) for _ in range(n_starts)]
    A0 = torch.as_tensor(np.stack([s[0] for s in starts]), **f)
    B0 = torch.as_tensor(np.stack([s[1] for s in starts]), **f)

    (A, B), losses = projected_adam(
        lambda x: kinopt_loss(prob, x[0], x[1], loss_type, include_reg),
        (A0, B0), _project(prob, device), steps=steps, lr=lr)
    losses = _host(losses)
    i = int(np.nanargmin(losses))
    g = _host(constraint_violations(prob, A[i], B[i]))
    return KinoptResult(_host(A[i]), _host(B[i]), float(losses[i]), losses,
                        bool(np.all(g <= 1e-5)))


class _Flat(PaddedGroups):
    """Flat kinopt vectors <-> padded (alpha, beta) on one device, with the
    projection repair."""

    def __init__(self, prob: KinoptProblem, device):
        super().__init__(prob.gp_mask, prob.k_mask, device)
        self.prob = prob
        self.gmask = torch.as_tensor(prob.gp_mask, device=device)
        self.kmask = torch.as_tensor(prob.k_mask, device=device)

    def repair(self, X):
        """Project each candidate onto the sum-to-one feasible set: the
        repair operator of the host NSGA-II, the device NSGA-II and DE."""
        p = self.prob
        A, B = self.padded(X)
        return self.flat(project_sum_box(A, p.lb, p.ub, self.gmask),
                         project_sum_box(B, p.lb, p.ub, self.kmask))


def run_evolutionary(prob: KinoptProblem, method: str = "NSGA-II",
                     loss_type: str = "base", include_reg: bool = False,
                     pop_size: int = 100, n_gen: int = 200,
                     seed: int = 42,
                     gens_per_dispatch: int = 1, *,
                     device=DEFAULT_DEVICE, dtype=None) -> KinoptResult:
    """DE (single-objective) or NSGA-II (loss, alpha-viol^2, beta-viol^2).

    DE always runs with the whole loop on the device (reference budget:
    10k generations). ``gens_per_dispatch > 1`` moves the NSGA-II loop to
    the device too (crowding survival and the projection repair inside the
    generation); otherwise NSGA-II survives on the host, at the device's
    dtype for its SBX."""
    device, dtype = _device_dtype(device, dtype)
    f = dict(dtype=dtype, device=device)
    n = prob.n_alpha + prob.n_beta
    xl = np.full(n, prob.lb)
    xu = np.full(n, prob.ub)
    flat = _Flat(prob, device)

    @torch.no_grad()
    def eval_multi(X):
        A, B = flat.padded(X)
        return torch.stack([kinopt_loss(prob, A, B, loss_type, include_reg),
                            *violation_sq(prob, A, B)], dim=1)

    if method.upper() == "DE":
        @torch.no_grad()
        def eval_single(X):
            return kinopt_loss(prob, *flat.padded(X), loss_type, include_reg)

        dres = run_de_device(eval_single, xl, xu, pop_size=pop_size, n_gen=n_gen, seed=seed,
                             repair_fn=flat.repair, device=device, dtype=dtype)
        x_best = _host(dres.x_best)
        hist = _host(dres.history)
        res = MOOResult(_host(dres.X), _host(dres.f)[:, None], x_best[None],
                        _host(dres.f_best)[None, None],
                        [(g, float(h), float(h)) for g, h in
                         enumerate(hist[:: max(1, len(hist) // 100)])],
                        n_gen, pop_size * (n_gen + 1))
    else:
        if gens_per_dispatch > 1:
            res = run_nsga2_device(eval_multi, xl, xu, pop_size=pop_size, n_gen=n_gen,
                                   seed=seed, repair_fn=flat.repair,
                                   gens_per_block=gens_per_dispatch, device=device,
                                   dtype=dtype)
        else:
            res = run_nsga2(lambda X: _host(eval_multi(torch.as_tensor(X, **f))),
                            xl, xu, pop_size=pop_size, n_gen=n_gen, seed=seed,
                            repair_fn=lambda X: _host(flat.repair(torch.as_tensor(X, **f))),
                            dtype=numpy_dtype(dtype))
        # pick min primary loss among near-feasible Pareto members
        pf = res.pareto_F
        feas = (pf[:, 1] + pf[:, 2]) <= np.quantile(pf[:, 1] + pf[:, 2], 0.25) + 1e-9
        cand = np.where(feas)[0]
        x_best = res.pareto_X[cand[np.argmin(pf[cand, 0])]]

    a, b = prob.unpack(x_best)
    at, bt = torch.as_tensor(a, **f), torch.as_tensor(b, **f)
    g = _host(constraint_violations(prob, at, bt))
    loss = float(kinopt_loss(prob, at, bt, loss_type, include_reg))
    return KinoptResult(a, b, loss, np.asarray([h[1] for h in res.history] or [loss]),
                        bool(np.all(g <= 1e-3)))
