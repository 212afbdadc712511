"""Gradient stage of the global fit: exact-gradient polish and the LM finish.

Counterpart of ``phoskintime_tpu/network/polish.py``. The whole objective
(softplus unpack, the batched exponential integration, the robust
3-modality loss and the prior penalty) is differentiable, so solutions are
sharpened by descent instead of re-sampling:

* :func:`polish_solutions` — bounded Adam in raw (softplus) space on each
  member's scalarized loss ``F(theta) . w``, ``w`` on the 3-objective
  simplex (:func:`simplex_weights`), the best iterate kept per member; each
  step is one forward and one reverse pass of the differentiable objective
  (``make_population_objective(differentiable=True)``: the plain tables
  with a static ladder and the eager scan, as the kernels carry no
  derivative). The polished members are scored at the end by the
  production objective, which launches the table kernel on the card.
* :func:`gradient_multistart` — the same polish from LHS starts along
  Das-Dennis directions, a fit without an evolutionary search.
* :func:`lm_refine` — Levenberg-Marquardt on the residual vector
  (:func:`~phoskintime_tpu_torch.network.objective.make_residual_fn`): the
  Jacobian by forward mode (``torch.func.vmap`` over ``torch.func.jvp``,
  in chunks of tangents), the damped normal equations solved on the host
  in float64; :func:`lm_refine_mixed` runs it at float32, then at float64
  on the same device.

With a ``mesh`` (:class:`~phoskintime_tpu_torch.parallel.mesh.PopulationMesh`)
the polish and the multistart shard the member axis over its ranks, as the
JAX package over its device mesh: each chunk of members, padded with
copies of its last row to a multiple of the mesh, splits into one block a
rank, and the polished members and their objectives are gathered onto
every rank. The LM finish is one member and takes no mesh.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from phoskintime_tpu_torch.network.objective import (evaluate_population,
                                                     make_population_objective,
                                                     make_residual_fn)
from phoskintime_tpu_torch.ops.nsga import das_dennis, lhs_sampling
from phoskintime_tpu_torch.parallel.mesh import pad_rows

# Adam's moment decays and the LM's initial damping, the JAX package's
# defaults
ADAM_B1, ADAM_B2 = 0.9, 0.999
MU0 = 1e-3


def simplex_weights(F: np.ndarray, floor: float = 0.05) -> np.ndarray:
    """Per-member scalarization weights from a population's objectives:
    each member weighted inversely to its normalized objective values (a
    member strong on objective j keeps pushing j), floored so that no
    objective is ignored. Rows sum to 1."""
    F = np.asarray(F, float)
    lo, hi = F.min(axis=0), F.max(axis=0)
    Fn = (F - lo) / np.maximum(hi - lo, 1e-12)
    w = 1.0 / (Fn + 0.25)
    w = np.maximum(w / w.sum(axis=1, keepdims=True), floor)
    return w / w.sum(axis=1, keepdims=True)


def polish_solutions(system, slices, loss_data, defaults, lambdas, time_grid,
                     thetas, xl, xu, *, weights=None, steps: int = 150,
                     lr: float = 0.02, loss_mode: int = 0, y0=None,
                     chunk: int = 128, mesh=None):
    """Polish raw-space solutions with bounded Adam on the system's device.

    Args:
      thetas: (P, n) raw decision vectors (a Pareto set, say).
      weights: (P, 3) scalarization weights; None: uniform (the best-by-sum
        criterion).
      steps: Adam steps; the learning rate decays by cosine to 10%.
      chunk: members a pass; a population above it runs in chunks, the
        last at its own size. With a ``mesh`` it must be a multiple of the
        mesh size (``ValueError``), as in the JAX package.
      mesh: shards each chunk's members over its ranks (see the module
        docstring); every rank returns the same arrays.

    The iterate is float32, as in the JAX package, and is clipped to
    [xl, xu] after every step. Each step scores its incoming iterate with
    the same forward pass its gradient takes, and the final iterate is
    scored after the loop; each member keeps its best iterate.

    Returns (thetas_polished (P, n) float64, F_polished (P, 3) float64),
    F by the production objective: no member ends worse than its input
    under its own weights, as far as the two objectives agree.
    """
    if mesh is not None and chunk % mesh.size:
        raise ValueError(f"polish: chunk ({chunk}) must be a multiple of the mesh size "
                         f"({mesh.size})")
    thetas = np.asarray(thetas, float)
    P = thetas.shape[0]
    weights = np.full((P, 3), 1.0 / 3.0) if weights is None else np.asarray(weights, float)
    args = (system, slices, loss_data, defaults, lambdas, time_grid)
    f32 = dict(dtype=torch.float32, device=system.rhs.Kmat.device)
    lo, hi = (torch.as_tensor(np.asarray(b, float), **f32) for b in (xl, xu))
    objective = make_population_objective(*args, loss_mode=loss_mode, y0=y0,
                                          differentiable=True)

    def scores(X, W):
        return torch.sum(objective(X) * W, dim=1)

    def polish_chunk(X, W):
        m, v = torch.zeros_like(X), torch.zeros_like(X)
        best_X, best_s = X, torch.full((X.shape[0],), math.inf, **f32)
        for i in range(steps):
            Xg = X.detach().requires_grad_(True)
            s = scores(Xg, W)
            g, = torch.autograd.grad(s.sum(), Xg)
            s = s.detach().to(torch.float32)
            better = s < best_s
            best_X = torch.where(better[:, None], X, best_X)
            best_s = torch.where(better, s, best_s)
            lr_i = lr * (0.55 + 0.45 * math.cos(math.pi * i / steps))
            m = ADAM_B1 * m + (1 - ADAM_B1) * g
            v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
            # the bias corrections in float32, as the JAX package takes them
            t = np.float32(i + 1)
            mh = m / float(1 - np.float32(ADAM_B1) ** t)
            vh = v / float(1 - np.float32(ADAM_B2) ** t)
            X = torch.clamp(X - lr_i * mh / (torch.sqrt(vh) + 1e-8), lo, hi)
        # the loop scores each iterate before its step: score the last one
        with torch.no_grad():
            s = scores(X, W).to(torch.float32)
        return torch.where((s < best_s)[:, None], X, best_X)

    out_X = np.empty(thetas.shape, np.float32)
    for c0 in range(0, P, chunk):
        n = min(chunk, P - c0)
        Xc, Wc = (pad_rows(a[c0:c0 + n], mesh).astype(np.float32) for a in (thetas, weights))
        rows = slice(None) if mesh is None else mesh.block(len(Xc))
        best = polish_chunk(torch.as_tensor(Xc[rows], **f32), torch.as_tensor(Wc[rows], **f32))
        if mesh is not None:
            best = mesh.gather_rows(best)
        out_X[c0:c0 + n] = best[:n].cpu().numpy()

    # the polished members through the production objective (the table
    # kernel on the card)
    production = make_population_objective(*args, loss_mode=loss_mode, y0=y0)
    X_prod = torch.as_tensor(pad_rows(out_X, mesh), **f32)
    F_out = evaluate_population(production, X_prod, mesh)[:P]
    return out_X.astype(float), F_out.to("cpu", torch.float64).numpy()


def multistart_draws(xl, xu, pop: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The starts and weights of :func:`gradient_multistart`: ``pop`` LHS
    starts in [xl, xu] and, from the same generator, a Das-Dennis
    direction (3 objectives, 12 partitions) for each, floored at 0.05 and
    renormalized; the JAX package's draws."""
    rng = np.random.default_rng(seed)
    X0 = lhs_sampling(pop, np.asarray(xl, float), np.asarray(xu, float), rng)
    dirs = das_dennis(3, 12)
    W = np.maximum(dirs[rng.integers(0, len(dirs), pop)], 0.05)
    return X0, W / W.sum(axis=1, keepdims=True)


def gradient_multistart(system, slices, loss_data, defaults, lambdas, time_grid, xl, xu, *,
                        pop: int = 256, steps: int = 300, lr: float = 0.03,
                        loss_mode: int = 0, y0=None, seed: int = 42, chunk: int = 128,
                        mesh=None):
    """A gradient-only multistart fit: :func:`polish_solutions` of the
    starts of :func:`multistart_draws`, each along its own direction.
    Returns (X (pop, n), F (pop, 3)); non-dominated sorting of them gives a
    Pareto set. ``mesh``: the polish sharded (:func:`polish_solutions`)."""
    X0, W = multistart_draws(xl, xu, pop, seed)
    return polish_solutions(system, slices, loss_data, defaults, lambdas, time_grid, X0,
                            xl, xu, weights=W, steps=steps, lr=lr, loss_mode=loss_mode,
                            y0=y0, chunk=chunk, mesh=mesh)


def forward_jacobian(residuals, theta: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """The (M, n) Jacobian of ``residuals`` at ``theta`` (n,) by forward
    mode: ``torch.func.vmap`` over ``torch.func.jvp``, ``chunk`` unit
    tangents a pass, the last pass at its own size. On ``theta``'s device
    and dtype."""
    n = theta.numel()
    tangents = torch.func.vmap(lambda v: torch.func.jvp(residuals, (theta,), (v,))[1])
    eye = torch.eye(n, dtype=theta.dtype, device=theta.device)
    return torch.cat([tangents(V) for V in eye.split(max(1, chunk))]).T


def lm_refine_mixed(system, slices, loss_data, defaults, lambdas, time_grid, theta, xl, xu,
                    *, iters_lo: int = 25, iters_hi: int = 10, r_offset_lo=None,
                    r_offset_hi=None, logger=None, **kw):
    """Mixed-precision LM finish: :func:`lm_refine` on ``system`` (float32
    on the card) to its rounding floor, then on ``system.astype(float64)``
    on the same device from the point it reached, where the residual and
    its Jacobian carry full precision. ``r_offset_lo``/``r_offset_hi``: an
    offset for each stage, in its own residual space (see
    :func:`lm_refine`). Returns (theta float64, sse at float64)."""
    th, sse = lm_refine(system, slices, loss_data, defaults, lambdas, time_grid, theta,
                        xl, xu, iters=iters_lo, r_offset=r_offset_lo, logger=logger, **kw)
    if logger is not None:
        logger.info(f"[LM mixed] low-precision stage done: sse={sse:.6g}")
    return lm_refine(system.astype(torch.float64), slices, loss_data, defaults, lambdas,
                     time_grid, th, xl, xu, iters=iters_hi, r_offset=r_offset_hi,
                     logger=logger, **kw)


def lm_refine(system, slices, loss_data, defaults, lambdas, time_grid, theta, xl, xu, *,
              iters: int = 15, y0=None, logger=None, jac_chunk: int = 256,
              gtol: float = 0.0, xtol: float = 0.0, r_offset=None):
    """Levenberg-Marquardt refinement of one solution on the residual
    vector, with an explicit Jacobian and float64 normal equations.

    The residuals and their Jacobian are evaluated on the system's device
    at its dtype, the Jacobian by forward mode (:func:`forward_jacobian`,
    ``jac_chunk`` tangents a pass). Each step solves, on the host in
    float64,

        (J^T J + mu diag(J^T J)) d = -J^T r

    (Marquardt's scaling), clips the trial point to [xl, xu], and accepts
    it if its sum of squares falls and the quadratic model, along the
    step actually taken, predicts a fall; the damping follows Nielsen
    (accept: mu times max(1/3, 1 - (2 rho - 1)^3); reject: mu times a
    doubling nu). ``gtol`` stops on the largest gradient entry, ``xtol``
    on the largest accepted step. The damping starts at ``MU0``.

    ``r_offset`` (M,): minimize ||r(theta) - r_offset||^2; with
    ``r(theta*)`` a synthetic-truth experiment is zero-residual at theta*
    by construction (the data's own integration error no longer moves the
    minimum). Returns (theta float64, sse), never worse than the input.
    """
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device)
    raw = make_residual_fn(system, slices, loss_data, defaults, lambdas, time_grid, y0=y0)
    r_off = None if r_offset is None else torch.as_tensor(np.asarray(r_offset, float), **f)

    def residuals(th):
        r = raw(th)
        return r if r_off is None else r - r_off

    def res_host(th) -> np.ndarray:
        with torch.no_grad():
            return residuals(torch.as_tensor(th, **f)).to("cpu", torch.float64).numpy()

    def jacobian(th) -> np.ndarray:
        J = forward_jacobian(residuals, torch.as_tensor(th, **f), jac_chunk)
        return J.to("cpu", torch.float64).numpy()

    xl_h, xu_h = np.asarray(xl, float), np.asarray(xu, float)
    th = np.asarray(theta, np.float64).reshape(-1).copy()
    r = res_host(th)
    best = float(r @ r)
    mu, nu = MU0, 2.0
    J = None
    for it in range(iters):
        if J is None:
            J = jacobian(th)
            JtJ = J.T @ J
            g = J.T @ r
            D = np.diag(JtJ).copy()
            D = np.maximum(D, 1e-12 * max(float(D.max()), 1e-30))
        if gtol > 0.0 and float(np.max(np.abs(g))) < gtol:
            break
        try:
            d = np.linalg.solve(JtJ + mu * np.diag(D), -g)
        except np.linalg.LinAlgError:
            mu = min(mu * nu, 1e12)
            nu *= 2.0
            continue
        trial = np.clip(th + d, xl_h, xu_h)
        step = trial - th
        r_t = res_host(trial)
        cost_t = float(r_t @ r_t)
        # the quadratic model's fall along the step taken (clipped or not)
        pred = -(g @ step) - 0.5 * step @ (JtJ @ step)
        rho = (best - cost_t) / max(pred, 1e-300)
        if np.isfinite(cost_t) and cost_t < best and pred > 0:
            th, best, r = trial, cost_t, r_t
            J = None                          # relinearize at the new point
            mu = max(mu * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), 1e-14)
            nu = 2.0
            if xtol > 0.0 and float(np.max(np.abs(step))) < xtol:
                if logger is not None:
                    logger.info(f"[LM] iter {it}: converged (step<{xtol})")
                break
        else:
            mu = min(mu * nu, 1e12)
            nu *= 2.0
        if logger is not None:
            logger.info(f"[LM] iter {it}: sse={best:.6g} mu={mu:.2e} rho={rho:.3g}")
    return th, best
