"""Differential evolution with the whole run on the device.

Counterpart of ``phoskintime_tpu/ops/de_jit.py``: DE/rand/1/bin whose
population, draws, objective and best-so-far history stay on the device;
the host reads the result once, at the end of the run. The JAX package
runs the generations in one ``lax.fori_loop``; here they are a Python
loop of launches with no host read inside.

Each random function comes in two parts, so that a test can hand in the
JAX package's draws: :func:`de_generation` is a function of explicit
draws, :func:`de_draws` (and :func:`de_init_draws` for the first
population) makes them from a ``torch.Generator``, in the order of the
JAX function's key splits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device, working_dtype


class DEResult(NamedTuple):
    x_best: torch.Tensor
    f_best: torch.Tensor
    X: torch.Tensor
    f: torch.Tensor
    history: torch.Tensor  # (n_gen,) best-so-far per generation


class DEDraws(NamedTuple):
    """The random numbers of one generation, in the split order (k1, k2, k3)."""
    r: torch.Tensor         # (3, P) indices: base and difference vectors
    cross: torch.Tensor     # (P, d) uniform: crossover where <= CR
    jrand: torch.Tensor     # (P,) index: the coordinate always crossed


def de_init_draws(gen: torch.Generator, pop_size: int, d: int, dtype) -> torch.Tensor:
    """(P, d) uniforms of the first population (the JAX package's k0)."""
    return torch.rand((pop_size, d), dtype=dtype, device=gen.device, generator=gen)


def de_draws(gen: torch.Generator, pop_size: int, d: int, dtype=torch.float64) -> DEDraws:
    """Draws of one :func:`de_generation` from ``gen`` (on its device).

    The index draws are INDEPENDENT, as in the JAX package, on purpose: a
    distinct-and-not-target DE/rand/1 variant measured ~10x worse end to end
    there (median best 16.4 vs 1.8 on a 40-d sphere at pop 60 x 200 gens,
    kinopt loss 1.13 vs 0.087); the rare r1 == r2 collision (probability
    1/pop) only yields a crossover-only trial."""
    dev = gen.device
    r = torch.randint(0, pop_size, (3, pop_size), device=dev, generator=gen)
    cross = torch.rand((pop_size, d), dtype=dtype, device=dev, generator=gen)
    jrand = torch.randint(0, d, (pop_size,), device=dev, generator=gen)
    return DEDraws(r, cross, jrand)


def de_generation(X: torch.Tensor, f: torch.Tensor, draws: DEDraws,
                  evaluate_batch: Callable, xl: torch.Tensor, xu: torch.Tensor, *,
                  F_weight: float = 0.8, CR: float = 0.9,
                  repair_fn: Callable | None = None):
    """One DE/rand/1/bin generation on ``draws``: mutation, binomial
    crossover with one forced coordinate, bound clip, repair, and greedy
    replacement. Returns (X, f)."""
    P = X.shape[0]
    r = draws.r
    V = X[r[0]] + F_weight * (X[r[1]] - X[r[2]])
    cross = draws.cross <= CR
    cross[torch.arange(P, device=X.device), draws.jrand] = True
    U = torch.clamp(torch.where(cross, V, X), xl, xu)
    if repair_fn is not None:
        U = repair_fn(U)
    fu = evaluate_batch(U)
    better = fu < f
    return torch.where(better[:, None], U, X), torch.where(better, fu, f)


@torch.no_grad()
def run_de_device(evaluate_batch: Callable, xl, xu, *, pop_size=100, n_gen=1000,
                  seed=42, F_weight=0.8, CR=0.9, repair_fn: Callable | None = None,
                  device=DEFAULT_DEVICE, dtype=None) -> DEResult:
    """DE/rand/1/bin on ``device`` (default: the card; raises where there is
    none) at ``dtype`` (default: the device's working dtype).

    evaluate_batch: (P, d) -> (P,) objective on the device.
    repair_fn: optional (P, d) -> (P, d) feasibility repair on the device.
    The results stay on the device."""
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    f_ = dict(dtype=dtype, device=device)
    xl = torch.as_tensor(np.asarray(xl, float), **f_)
    xu = torch.as_tensor(np.asarray(xu, float), **f_)
    d = xl.shape[0]
    gen = torch.Generator(device=device).manual_seed(int(seed))

    X = xl + de_init_draws(gen, pop_size, d, dtype) * (xu - xl)
    if repair_fn is not None:
        X = repair_fn(X)
    f = evaluate_batch(X)
    hist = torch.zeros(n_gen, dtype=f.dtype, device=device)
    for i in range(n_gen):
        X, f = de_generation(X, f, de_draws(gen, pop_size, d, dtype), evaluate_batch,
                             xl, xu, F_weight=F_weight, CR=CR, repair_fn=repair_fn)
        hist[i] = torch.amin(f)
    best = torch.argmin(f)
    return DEResult(X[best], f[best], X, f, hist)
