"""Projected optimization under per-group sum-to-one + box constraints.

Counterpart of ``phoskintime_tpu/ops/constrained.py``. kinopt and tfopt
constrain parameter groups to sum to 1 inside box bounds; the reference
enforces this with SLSQP, here it is the exact Euclidean projection onto
{sum(x) = 1, lo <= x <= hi}, computed by a fixed 60-step bisection on the
dual shift over any leading axes, inside a projected-Adam loop over a
leading batch of starts. Neither reads the host: the bisection's step
count is fixed, and so is Adam's. Feasibility is exact at every iterate.

Where the JAX package fuses an Adam step into one XLA program, eager
PyTorch launches each operation: the bisection costs about 10 launches
an iteration, so a step of two groups is over 1,200 launches.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

ITERS = 60


@torch.no_grad()
def project_sum_box(y: torch.Tensor, lo, hi, mask, target: float = 1.0,
                    iters: int = ITERS) -> torch.Tensor:
    """Project each row of y (..., W) onto {sum(x*mask) = target, lo <= x <= hi}.

    Off-mask entries are zeroed; rows with an empty mask come back as
    ``y * mask``, as in the JAX package. ``mask`` (bool) broadcasts against
    y (a (G, W) mask serves a population (P, G, W)); lo and hi are scalars
    or tensors broadcastable to y."""
    f = dict(dtype=y.dtype, device=y.device)
    mask = torch.as_tensor(mask, device=y.device)
    mask_f = mask.to(y.dtype)
    n_valid = mask_f.sum(dim=-1, keepdim=True)
    lo_b = torch.as_tensor(lo, **f).expand(y.shape)
    hi_b = torch.as_tensor(hi, **f).expand(y.shape)
    inf = torch.tensor(float("inf"), **f)

    def g(tau):
        return (torch.clamp(y - tau, lo_b, hi_b) * mask_f).sum(dim=-1, keepdim=True) - target

    # bisection bounds for the shift
    a = torch.where(mask, y - hi_b, inf).amin(dim=-1, keepdim=True) - 1.0
    b = torch.where(mask, y - lo_b, -inf).amax(dim=-1, keepdim=True) + 1.0
    for _ in range(iters):
        m = 0.5 * (a + b)
        pos = g(m) > 0
        a, b = torch.where(pos, m, a), torch.where(pos, b, m)
    x = torch.clamp(y - 0.5 * (a + b), lo_b, hi_b) * mask_f
    return torch.where(n_valid > 0, x, y * mask_f)


def projected_adam(loss_fn: Callable, x0: tuple, project_fn: Callable,
                   steps: int = 500, lr: float = 0.02,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam with a projection after every step over a batch of independent
    starts; returns (x, loss).

    x0: a tuple of tensors with a leading batch axis (the JAX package's
    pytree); ``loss_fn(x) -> (batch,)`` losses; ``project_fn`` maps a tuple
    to the feasible set. The starts are independent, so autograd of the
    summed loss is each start's own gradient. The bias corrections take
    the JAX package's order, ``m / (1 - b1**t)``."""
    x = project_fn(tuple(t.detach() for t in x0))
    m = tuple(torch.zeros_like(t) for t in x)
    v = tuple(torch.zeros_like(t) for t in x)
    for i in range(steps):
        xg = tuple(t.requires_grad_() for t in x)
        with torch.enable_grad():
            g = torch.autograd.grad(loss_fn(xg).sum(), xg)
        t = i + 1
        with torch.no_grad():
            m = tuple(b1 * mm + (1 - b1) * gg for mm, gg in zip(m, g))
            v = tuple(b2 * vv + (1 - b2) * gg * gg for vv, gg in zip(v, g))
            x = tuple(xx - lr * (mm / (1 - b1 ** t)) / (torch.sqrt(vv / (1 - b2 ** t)) + eps)
                      for xx, mm, vv in zip(x, m, v))
        x = project_fn(x)
    with torch.no_grad():
        return x, loss_fn(x)


class PaddedGroups:
    """Flat decision vectors (P, n_a + n_b), the reference's parameter order
    (the valid slots of the first padded group, then of the second, each
    row-major), <-> the padded pair (A (P, *mask_a.shape), B (P,
    *mask_b.shape)) on ``device``; the index tensors are made once."""

    def __init__(self, mask_a: np.ndarray, mask_b: np.ndarray, device):
        self.masks = (mask_a, mask_b)
        self.idx = tuple(tuple(torch.as_tensor(i, device=device) for i in np.where(m))
                         for m in self.masks)
        self.n_a = int(mask_a.sum())

    def padded(self, X: torch.Tensor):
        out = []
        for m, (r, c), part in zip(self.masks, self.idx,
                                   (X[:, :self.n_a], X[:, self.n_a:])):
            Z = X.new_zeros((X.shape[0],) + m.shape)
            Z[:, r, c] = part
            out.append(Z)
        return tuple(out)

    def flat(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        (ra, ca), (rb, cb) = self.idx
        return torch.cat([A[:, ra, ca], B[:, rb, cb]], dim=1)
