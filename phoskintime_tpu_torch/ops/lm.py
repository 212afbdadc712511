"""Batched bounded Levenberg-Marquardt least squares.

Counterpart of ``phoskintime_tpu/ops/lm.py``: one LM instance per lane,
the lanes a leading axis (where the JAX package vmaps), so that a whole
multistart grid is one batch.

* Jacobians by ``torch.func.vmap(torch.func.jacfwd(residual))`` through
  the exact expm solve (forward mode; the residual comes out of the same
  pass).
* Marquardt scaling ``diag(J^T J)`` (TRF's ``x_scale='jac'``).
* Bounds by projection (clip) after each trial step.
* A fixed count of iterations with accept or reject by ``torch.where``;
  the step's solve is ``torch.linalg.solve_ex`` (a singular system gives a
  non-finite step, which is rejected, as ``jnp.linalg.solve``'s is). The
  loop reads nothing back to the host.
* The covariance ``pinv(J^T J)`` at the optimum cuts singular values at
  JAX's ``rtol = 10 max(M, N) eps`` (:func:`pinv`), not at PyTorch's
  default ``max(M, N) eps``.

The residual takes one lane's parameters and, optionally, per-lane
arguments (``args``, each with a leading lane axis): the JAX package
vmaps a closure over them instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap


class LMResult(NamedTuple):
    p: torch.Tensor           # (..., n) best parameters
    cost: torch.Tensor        # (...,) 0.5 * sum(r^2) at best
    pcov: torch.Tensor        # (..., n, n) pinv(J^T J) at best
    n_accepted: torch.Tensor  # (...,) int32


def pinv(H: torch.Tensor, rtol: float | None = None) -> torch.Tensor:
    """The pseudo-inverse as ``jnp.linalg.pinv``: SVD, singular values at
    or below ``rtol * s_max`` dropped (default rtol 10 max(M, N) eps)."""
    if rtol is None:
        rtol = 10.0 * max(H.shape[-2:]) * torch.finfo(H.dtype).eps
    u, s, vh = torch.linalg.svd(H, full_matrices=False)
    s = torch.where(s > rtol * s[..., :1], s, torch.full_like(s, float("inf")))
    return vh.mT @ (u.mT / s[..., None])


def _jacobian_and_residual(residual_fn: Callable):
    """(p (B, n), *args) -> (J (B, m, n), r (B, m)) in one forward-mode
    pass a lane."""
    def with_aux(p, *args):
        r = residual_fn(p, *args)
        return r, r
    return vmap(jacfwd(with_aux, has_aux=True))


def _cost(r: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(r * r, dim=-1)


def lm_loop(residual_fn: Callable, p0: torch.Tensor, lower, upper, args: tuple = (), *,
            max_iters: int = 60, lam0: float = 1e-3, lam_up: float = 3.0,
            lam_down: float = 0.5, lam_min: float = 1e-10, lam_max: float = 1e8):
    """The iterations over lanes: p0 (B, n), ``residual_fn(p (n,), *args)``
    -> r (m,), bounds (n,) or (B, n). Returns (p, cost, n_accepted, J),
    J (B, m, n) the Jacobian at p. Nothing is read back to the host.

    Each iteration takes one forward-mode pass, at the trial point: its
    residual gives the trial cost, and its Jacobian is kept with the point
    when the step is accepted. The JAX loop evaluates the residual and the
    Jacobian at p and the cost at the trial point; the values are the same."""
    B, n = p0.shape
    dtype, device = p0.dtype, p0.device
    jac_r = _jacobian_and_residual(residual_fn)
    p = torch.clamp(p0, lower, upper)
    J, r = jac_r(p, *args)
    cost = _cost(r)
    lam = torch.full((B,), lam0, dtype=dtype, device=device)
    n_acc = torch.zeros((B,), dtype=torch.int32, device=device)
    eye = torch.eye(n, dtype=dtype, device=device)
    for _ in range(max_iters):
        g = (J.mT @ r[..., None])[..., 0]
        H = J.mT @ J
        diagH = torch.diagonal(H, dim1=-2, dim2=-1)
        scale = torch.where(diagH > 1e-14, diagH, torch.ones_like(diagH))  # x_scale='jac'
        A = H + lam[:, None, None] * torch.diag_embed(scale)
        delta, _ = torch.linalg.solve_ex(A + 1e-14 * eye, g[..., None])
        p_new = torch.clamp(p - delta[..., 0], lower, upper)
        J_new, r_new = jac_r(p_new, *args)
        c_new = _cost(r_new)
        ok = torch.isfinite(c_new) & (c_new < cost)
        p = torch.where(ok[:, None], p_new, p)
        J = torch.where(ok[:, None, None], J_new, J)
        r = torch.where(ok[:, None], r_new, r)
        cost = torch.where(ok, c_new, cost)
        lam = torch.clamp(torch.where(ok, lam * lam_down, lam * lam_up), lam_min, lam_max)
        n_acc = n_acc + ok.to(torch.int32)
    return p, cost, n_acc, J


def lm_batched(residual_fn: Callable, p0s: torch.Tensor, lower, upper, args: tuple = (),
               **kw) -> LMResult:
    """LM over a leading batch of starting points p0s (B, n); the bounds
    shared (n,) or per lane (B, n); ``args`` per-lane residual arguments.
    The covariance pinv(J^T J) at the optimum (curve_fit with
    absolute_sigma=True)."""
    p, cost, n_acc, J = lm_loop(residual_fn, p0s, lower, upper, args, **kw)
    return LMResult(p, cost, pinv(J.mT @ J), n_acc)


def levenberg_marquardt(residual_fn: Callable, p0: torch.Tensor, lower, upper,
                        **kw) -> LMResult:
    """Minimize 0.5*||residual_fn(p)||^2 subject to box bounds, one start
    p0 (n,); runs on p0's device at its dtype."""
    return LMResult(*(x[0] for x in lm_batched(residual_fn, p0[None], lower, upper, **kw)))
