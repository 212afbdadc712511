"""Adaptive Dormand–Prince RK45 with dense output, batched over a population.

Counterpart of ``phoskintime_tpu/ops/integrators.py``: FSAL, the PI
step-size controller (beta = 0.04), steps clamped to the bucket boundaries
of the piecewise-constant kinase input with the derivative re-evaluated in
the new bucket after a crossed boundary, cubic Hermite dense output at
``t_eval``, dt within [dt_min, dt_max], a bounded step count.

The JAX package writes one member's integration as a ``lax.while_loop``
and ``vmap``s it over a population. Here the population axis P leads every
tensor and the loop runs on the host, ending when no member is active
(one device-to-host read per step). It reproduces the vmapped loop step
for step:

* the loop condition is evaluated per member at the top of each pass; the
  body runs for every member, and a member whose condition was false is
  frozen: each part of its carry is selected, not updated;
* the error norm is the mean over the member's own d entries;
* ``max_steps`` counts per member, and ``success`` is per member.

The stages are summed in the JAX package's order: a step's accept/reject
decision is discontinuous in the error, and another summation order could
flip one near err = 1 and send a whole trajectory elsewhere.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# Dormand-Prince 5(4) tableau.
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
_E = tuple(b5 - b4 for b5, b4 in zip(_B5, _B4))

_ORDER = 5.0
_SAFETY = 0.9
_BETA = 0.04                      # PI controller integral gain
_ALPHA = 1.0 / _ORDER - 0.75 * _BETA
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class ODEResult(NamedTuple):
    ys: torch.Tensor          # (P, T, d) dense output at t_eval
    success: torch.Tensor     # (P,) bool
    n_steps: torch.Tensor     # (P,) int32 accepted + rejected steps
    n_accepted: torch.Tensor  # (P,) int32


def _hermite(t, t0, t1, y0, y1, f0, f1):
    """Cubic Hermite interpolant of each member on its [t0, t1]: t (T,),
    t0 / t1 (P,), y0 / y1 / f0 / f1 (P, d) -> (P, T, d)."""
    h = (t1 - t0)[:, None]                                      # (P, 1)
    s = torch.where(h > 0, (t[None, :] - t0[:, None]) / torch.where(h == 0, 1.0, h), 0.0)
    s = torch.clamp(s, 0.0, 1.0)
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s ** 2 * (3 - 2 * s)
    h11 = s ** 2 * (s - 1)
    hh = h[:, :, None]
    return (h00[..., None] * y0[:, None] + h10[..., None] * (hh * f0[:, None])
            + h01[..., None] * y1[:, None] + h11[..., None] * (hh * f1[:, None]))


def _mean_sq(x):
    return torch.mean(x ** 2, dim=1)


def _initial_dt(rhs, t0, y0, f0, jb, rtol, atol, dt_min, dt_max):
    """Hairer-style starting step of each member (one more evaluation)."""
    scale = atol + torch.abs(y0) * rtol
    d0 = torch.sqrt(_mean_sq(y0 / scale) + 1e-30)
    d1 = torch.sqrt(_mean_sq(f0 / scale) + 1e-30)
    h0 = torch.where(d1 > 1e-12, 0.01 * d0 / d1, 1e-6)
    y1 = y0 + h0[:, None] * f0
    f1 = rhs(t0 + h0, y1, jb)
    d2 = torch.sqrt(_mean_sq((f1 - f0) / scale) + 1e-30) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax > 1e-15, (0.01 / dmax) ** (1.0 / _ORDER),
                     torch.clamp(h0 * 1e-3, min=1e-6))
    return torch.clamp(torch.minimum(100.0 * h0, h1), dt_min, dt_max)


def odeint_rk45(
    rhs: Callable,
    y0: torch.Tensor,
    t_eval,
    boundaries=None,
    max_steps: int = 100_000,
    rtol: float = 1e-5,
    atol: float = 1e-7,
    dt0: float | None = None,
    dt_min: float = 1e-6,
    dt_max: float = 1.0,
) -> ODEResult:
    """Integrate ``dy/dt = rhs(...)`` for every member from t = 0, with dense
    output at ``t_eval``.

    Args:
      rhs: ``(t (P,), y (P, d)) -> dy (P, d)`` when ``boundaries`` is None,
        else ``(t, y, jb) -> dy`` with ``jb (P,)`` each member's index of
        its active input interval ``[boundaries[j], boundaries[j+1])``.
      y0: (P, d) initial states at t = 0; their dtype and device are the
        run's.
      t_eval: (T,) strictly increasing output times, all >= 0.
      boundaries: optional (B,) sorted discontinuity times of the input;
        no step straddles one.
      max_steps / rtol / atol / dt0 / dt_min / dt_max: solver controls, as
        the JAX package's.
    """
    P = y0.shape[0]
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

    y = y0
    fy = rhs_b(t, y, jb)
    dt = (_initial_dt(rhs_b, t, y, fy, jb, rtol, atol, dt_min, dt_max)
          if dt0 is None else torch.full((P,), float(dt0), **f))
    ys = torch.where((t_eval <= 0.0)[None, :, None], y[:, None, :], 0.0)
    err_prev = torch.full((P,), 1e-4, **f)
    n_steps = torch.zeros(P, dtype=torch.int32, device=y0.device)
    n_acc = torch.zeros_like(n_steps)
    failed = torch.zeros(P, dtype=torch.bool, device=y0.device)

    while True:
        active = (t < t_end) & (n_steps < max_steps) & ~failed
        if not bool(active.any()):
            break
        # clamp the step to the next input discontinuity and to t_end; the
        # dt_min floor applies to the controller's free step only
        nb = bnds[torch.clamp(jb + 1, max=last)]
        limit = torch.minimum(nb, t_end)
        dt_free = torch.clamp(dt, min=dt_min)
        hit = dt_free >= (limit - t)
        h = torch.where(hit, limit - t, dt_free)
        t_new = torch.where(hit, limit, t + h)
        hc = h[:, None]

        k = [fy]
        for i in range(1, 7):
            ti = t + _C[i] * h
            yi = y + hc * sum(_A[i][j] * k[j] for j in range(i))
            k.append(rhs_b(ti, yi, jb))
        y_new = y + hc * sum(_B5[i] * k[i] for i in range(7))
        err_vec = hc * sum(_E[i] * k[i] for i in range(7))

        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        err = torch.sqrt(_mean_sq(err_vec / scale) + 1e-300)
        finite = torch.isfinite(y_new).all(dim=1) & torch.isfinite(err)
        accept = (err <= 1.0) & finite

        # PI step-size controller
        err_c = torch.clamp(err, min=1e-10)
        factor = _SAFETY * err_c ** (-_ALPHA) * err_prev ** _BETA
        factor = torch.clamp(factor, _MIN_FACTOR, _MAX_FACTOR)
        factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))
        factor = torch.where(finite, factor, _MIN_FACTOR)
        dt_next = torch.clamp(h * factor, dt_min, dt_max)

        # dense output for the t_eval inside (t, t_new] of accepted steps of
        # active members (the vmapped loop's select folded into the mask)
        mask = ((t_eval[None] > t[:, None]) & (t_eval[None] <= t_new[:, None])
                & (accept & active)[:, None])
        ys = torch.where(mask[..., None], _hermite(t_eval, t, t_new, y, y_new, fy, k[6]), ys)

        # bucket advance and FSAL: k[6] is rhs(t_new, y_new) in the old
        # bucket; crossing a boundary takes a fresh derivative in the new one
        crossed = accept & hit & (nb <= t_end)
        jb_next = torch.where(crossed, jb + 1, jb)
        f_fresh = rhs_b(t_new, y_new, jb_next)
        acc1 = accept[:, None]
        f_next = torch.where(acc1, torch.where(crossed[:, None], f_fresh, k[6]), fy)
        failed_next = ~finite & (h <= dt_min * 1.0000001)

        # frozen members keep their whole carry
        act1 = active[:, None]
        t = torch.where(active, torch.where(accept, t_new, t), t)
        y = torch.where(act1 & acc1, y_new, y)
        fy = torch.where(act1, f_next, fy)
        dt = torch.where(active, dt_next, dt)
        jb = torch.where(active, jb_next, jb)
        err_prev = torch.where(active & accept, err_c, err_prev)
        n_steps = n_steps + active.to(torch.int32)
        n_acc = n_acc + (active & accept).to(torch.int32)
        failed = torch.where(active, failed_next, failed)

    success = (t >= t_end) & ~failed & torch.isfinite(ys).flatten(1).all(dim=1)
    return ODEResult(ys, success, n_steps, n_acc)
