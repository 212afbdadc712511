"""Adaptive ESDIRK4(3) (Kvaerno) with simplified-Newton stages, batched
over a population.

Counterpart of ``phoskintime_tpu/ops/stiff.py``: an L-stable, stiffly
accurate singly-diagonally-implicit scheme with an explicit first stage
and an embedded third-order error estimate. Each step factors
M = I - h gamma J once (J the exact Jacobian of the whole RHS, the
counterpart of ``jax.jacfwd``) and runs six simplified-Newton iterations,
each one back-substitution, for every implicit stage. Steps are clamped
to the input's bucket boundaries and dense output is the cubic Hermite
interpolant, as in :mod:`~phoskintime_tpu_torch.ops.integrators`.

As :func:`~phoskintime_tpu_torch.ops.integrators.odeint_rk45`, the
population axis P leads every tensor and the loop runs on the host until
no member is active, reproducing ``jax.vmap`` of the JAX package's
``lax.while_loop`` step for step: each member keeps its own dt, bucket,
step count and ``failed`` flag, the body runs for every member, and a
member that has stopped keeps its whole carry.

The Jacobian is one ``torch.func.jvp`` per state coordinate, vmapped over
the d coordinates, of the batched RHS: member p's output depends on member
p's state alone, so tangent e_i in every member at once gives column i of
every member's Jacobian. The LU factorization and solves are
``torch.linalg``'s batched ones, where the JAX package calls
``jax.scipy.linalg``.
"""

from __future__ import annotations

from typing import Callable

import torch

from phoskintime_tpu_torch.ops.integrators import ODEResult, _hermite, _mean_sq

# Kvaerno 4/3 ESDIRK tableau (gamma = 0.4358665215)
_G = 0.435866521508459
_C = (0.0, 2 * _G, 1.0, 1.0)
_A = (
    (0.0, 0.0, 0.0, 0.0),
    (_G, _G, 0.0, 0.0),
    (0.490563388419108, 0.073570090080892, _G, 0.0),
    (0.308809969973036, 1.490563388254106, -1.235239879727145, _G),
)
_B = (0.308809969973036, 1.490563388254106, -1.235239879727145, _G)   # 3rd order
_BHAT = (0.490563388419108, 0.073570090080892, _G, 0.0)               # embedded
_E = tuple(b - bh for b, bh in zip(_B, _BHAT))
_ORDER = 3.0

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 5.0
_NEWTON_ITERS = 6


def batched_jacobian(rhs_b: Callable, t, y, jb) -> torch.Tensor:
    """(P, d, d) Jacobians d rhs_b(t, y, jb)[p] / d y[p] of a batched RHS
    whose members do not interact: one forward-mode pass per coordinate,
    all coordinates in one ``torch.func.vmap``."""
    P, d = y.shape
    basis = torch.eye(d, dtype=y.dtype, device=y.device)[:, None, :].expand(d, P, d)

    def column(v):
        return torch.func.jvp(lambda z: rhs_b(t, z, jb), (y,), (v,))[1]

    return torch.func.vmap(column)(basis).permute(1, 2, 0)     # (P, d_out, d_in)


def odeint_esdirk(
    rhs: Callable,
    y0: torch.Tensor,
    t_eval,
    boundaries=None,
    max_steps: int = 20_000,
    rtol: float = 1e-5,
    atol: float = 1e-7,
    dt0: float = 1e-2,
    dt_min: float = 1e-7,
    dt_max: float = 64.0,
) -> ODEResult:
    """Integrate a stiff system with adaptive ESDIRK4(3) for every member
    from t = 0, with dense output at ``t_eval``.

    The contract of :func:`~phoskintime_tpu_torch.ops.integrators.odeint_rk45`
    (``rhs(t (P,), y (P, d)[, jb (P,)]) -> (P, d)``, y0 (P, d) setting the
    run's dtype and device), with the JAX package's ESDIRK defaults. The
    RHS must be traceable by ``torch.func`` (the Jacobian is taken through
    it); the model-2 edge-flux kernel has a forward-mode rule for that.
    """
    P, d = y0.shape
    f = dict(dtype=y0.dtype, device=y0.device)
    t_eval = torch.as_tensor(t_eval, **f).reshape(-1)
    t_end = t_eval[-1]
    t = torch.zeros(P, **f)
    inf = torch.full((1,), float("inf"), **f)
    if boundaries is None:
        bnds = inf
        rhs_b = lambda tt, y, jb: rhs(tt, y)
    else:
        bnds = torch.cat([torch.as_tensor(boundaries, **f).reshape(-1), inf])
        rhs_b = rhs
    last = bnds.shape[0] - 1
    jb = torch.clamp(torch.searchsorted(bnds, t, right=True) - 1, 0, last)
    eye = torch.eye(d, **f)

    y = y0
    fy = rhs_b(t, y, jb)
    dt = torch.full((P,), float(dt0), **f)
    ys = torch.where((t_eval <= 0.0)[None, :, None], y[:, None, :], 0.0)
    n_steps = torch.zeros(P, dtype=torch.int32, device=y0.device)
    n_acc = torch.zeros_like(n_steps)
    failed = torch.zeros(P, dtype=torch.bool, device=y0.device)

    while True:
        active = (t < t_end) & (n_steps < max_steps) & ~failed
        if not bool(active.any()):
            break
        # the dt_min floor applies to the controller's free step only: a
        # boundary gap below dt_min is integrated over the actual gap
        nb = bnds[torch.clamp(jb + 1, max=last)]
        limit = torch.minimum(nb, t_end)
        dt_free = torch.clamp(dt, min=dt_min)
        hit = dt_free >= (limit - t)
        h = torch.where(hit, limit - t, dt_free)
        t_new = torch.where(hit, limit, t + h)
        hc = h[:, None]
        hg = (h * _G)[:, None]

        J = batched_jacobian(rhs_b, t, y, jb)
        lu, piv, _ = torch.linalg.lu_factor_ex(eye - hg[:, :, None] * J)

        ks = [fy]                               # explicit first stage
        for i in range(1, 4):
            ti = t + _C[i] * h
            y_base = y + hc * sum(_A[i][j] * ks[j] for j in range(i))
            k = ks[-1]
            for _ in range(_NEWTON_ITERS):
                r = k - rhs_b(ti, y_base + hg * k, jb)
                k = k - torch.linalg.lu_solve(lu, piv, r[:, :, None])[:, :, 0]
            ks.append(k)

        y_new = y + hc * sum(_B[i] * ks[i] for i in range(4))
        err_vec = hc * sum(_E[i] * ks[i] for i in range(4))
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        err = torch.sqrt(_mean_sq(err_vec / scale) + 1e-300)
        finite = torch.isfinite(y_new).all(dim=1) & torch.isfinite(err)
        accept = (err <= 1.0) & finite

        err_c = torch.clamp(err, min=1e-10)
        factor = torch.clamp(_SAFETY * err_c ** (-1.0 / (_ORDER + 1.0)),
                             _MIN_FACTOR, _MAX_FACTOR)
        factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))
        factor = torch.where(finite, factor, _MIN_FACTOR)
        dt_next = torch.clamp(h * factor, dt_min, dt_max)

        # stiffly accurate: ks[3] is rhs(t_new, y_new)
        mask = ((t_eval[None] > t[:, None]) & (t_eval[None] <= t_new[:, None])
                & (accept & active)[:, None])
        ys = torch.where(mask[..., None], _hermite(t_eval, t, t_new, y, y_new, fy, ks[3]), ys)

        crossed = accept & hit & (nb <= t_end)
        jb_next = torch.where(crossed, jb + 1, jb)
        f_fresh = rhs_b(t_new, y_new, jb_next)
        acc1 = accept[:, None]
        f_next = torch.where(acc1, torch.where(crossed[:, None], f_fresh, ks[3]), fy)
        failed_next = ~finite & (h <= dt_min * 1.0000001)

        # frozen members keep their whole carry
        act1 = active[:, None]
        t = torch.where(active, torch.where(accept, t_new, t), t)
        y = torch.where(act1 & acc1, y_new, y)
        fy = torch.where(act1, f_next, fy)
        dt = torch.where(active, dt_next, dt)
        jb = torch.where(active, jb_next, jb)
        n_steps = n_steps + active.to(torch.int32)
        n_acc = n_acc + (active & accept).to(torch.int32)
        failed = torch.where(active, failed_next, failed)

    success = (t >= t_end) & ~failed & torch.isfinite(ys).flatten(1).all(dim=1)
    return ODEResult(ys, success, n_steps, n_acc)
