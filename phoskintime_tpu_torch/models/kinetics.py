"""Per-gene kinetic models (distributive / successive / random).

Counterpart of ``phoskintime_tpu/models/kinetics.py``. All three per-gene
systems are linear time-invariant ODEs ``dy/dt = M(theta) y + b(theta)``,
solved exactly with batched matrix exponentials
(:mod:`phoskintime_tpu_torch.ops.linear`).

State layouts:

* distributive / successive: ``y = [R, P, P_1..P_n]``
* random (combinatorial):    ``y = [R, P, X_1..X_m]``, ``m = 2^n - 1``,
  where ``X_s`` is the bitmask-s phospho state (bit j <=> site j occupied).

Parameter layouts:

* dist/succ: ``[A, B, C, D, S_1..S_n, Dd_1..Dd_n]`` (4 + 2n)
* random:    ``[A, B, C, D, S_1..S_n, Ddeg_1..Ddeg_m]`` (4 + n + 2^n - 1)

Fit vector: ``concat(R[OFFSET:], P, sites.T.flatten())`` with OFFSET = 5;
for the random model "sites" are the first ``n`` states in bitmask order.

Each builder takes parameters with any leading batch shape and returns
(M, b) with the same leading shape. Every entry of M is affine in the
parameters: the builders compute the entries by the JAX package's own
arithmetic, in its order (so that the two agree bit for bit), and place
them by a static gather, with no in-place write, so that they run under
``torch.func.vmap`` and ``jacfwd``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device, working_dtype
from phoskintime_tpu_torch.ops.linear import solve_lti_batched

OFFSET = 5  # early mRNA timepoints dropped from the fit vector


def _assemble(entries: dict, d: int, like: torch.Tensor) -> torch.Tensor:
    """A (..., d, d) matrix from {(row, col): value (..., 1)}, zero
    elsewhere, by one gather over [values..., 0]. The values keep a last
    axis of 1: under ``torch.func`` a 0-dim value combined with a Python
    scalar gets a float64 tangent, whatever its own dtype."""
    keys = tuple(entries)
    vals = torch.cat([entries[k] for k in keys] + [torch.zeros_like(like)], dim=-1)
    index = _gather_index(keys, d, vals.device)
    return vals.index_select(-1, index).reshape(vals.shape[:-1] + (d, d))


@lru_cache(maxsize=None)
def _gather_index(keys: tuple, d: int, device: torch.device) -> torch.Tensor:
    """The flat (d*d) gather index of :func:`_assemble`, uploaded once per
    device: a host-to-device copy synchronizes, and the builders run in
    every LM iteration."""
    index = np.full(d * d, len(keys), np.int64)
    for i, (r, c) in enumerate(keys):
        index[r * d + c] = i
    return torch.as_tensor(index, device=device)


def _b(params: torch.Tensor, d: int) -> torch.Tensor:
    """b = [A, 0, ..., 0]."""
    A = params[..., :1]
    return torch.cat([A, torch.zeros_like(A).expand(A.shape[:-1] + (d - 1,))], dim=-1)


def _col(x: torch.Tensor, j: int) -> torch.Tensor:
    """Entry j of the last axis, kept as an axis of 1."""
    return x[..., j:j + 1]


def _seq_sum(xs: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from left to right (jnp.sum's order on the
    CPU for these few terms), kept as an axis of 1."""
    acc = _col(xs, 0)
    for j in range(1, xs.shape[-1]):
        acc = acc + _col(xs, j)
    return acc


# ---------------------------------------------------------------------------
# system matrix builders
# ---------------------------------------------------------------------------

def system_matrices_dist(params: torch.Tensor, n_sites: int):
    """Distributive: sites are independent.

    dR   = A - B R
    dP   = C R - (D + sum S) P + sum P_i
    dP_i = S_i P - (1 + Dd_i) P_i
    """
    n = n_sites
    d = 2 + n
    B, C, D = _col(params, 1), _col(params, 2), _col(params, 3)
    S = params[..., 4:4 + n]
    Dd = params[..., 4 + n:4 + 2 * n]
    one = torch.ones_like(B)
    sum_s = _seq_sum(S) if n > 0 else torch.zeros_like(B)
    e = {(0, 0): -B, (1, 0): C, (1, 1): -(D + sum_s)}
    for i in range(n):
        e[(1, 2 + i)] = one
        e[(2 + i, 1)] = _col(S, i)
        e[(2 + i, 2 + i)] = -(1.0 + _col(Dd, i))
    return _assemble(e, d, B), _b(params, d)


def system_matrices_succ(params: torch.Tensor, n_sites: int):
    """Successive chain P -> P_1 -> ... -> P_n with unit dephospho
    feedback."""
    n = n_sites
    d = 2 + n
    B, C, D = _col(params, 1), _col(params, 2), _col(params, 3)
    S = params[..., 4:4 + n]
    Dd = params[..., 4 + n:4 + 2 * n]
    one = torch.ones_like(B)
    e = {(0, 0): -B, (1, 0): C}
    if n == 0:
        e[(1, 1)] = -D
    else:
        e[(1, 1)] = -(D + _col(S, 0))
        e[(1, 2)] = one
        e[(2, 1)] = _col(S, 0)
        if n == 1:
            e[(2, 2)] = -(1.0 + _col(Dd, 0))
        else:
            e[(2, 2)] = -(1.0 + _col(S, 1) + _col(Dd, 0))
            e[(2, 3)] = one
            for j in range(1, n - 1):
                e[(2 + j, 1 + j)] = _col(S, j)
                e[(2 + j, 2 + j)] = -(1.0 + _col(S, j + 1) + _col(Dd, j))
                e[(2 + j, 3 + j)] = one
            j = n - 1
            e[(2 + j, 1 + j)] = _col(S, j)
            e[(2 + j, 2 + j)] = -(1.0 + _col(Dd, j))
    return _assemble(e, d, B), _b(params, d)


@lru_cache(maxsize=None)
def _random_transition_tables(n: int):
    """Static transition tables of the bitmask hypercube: each entry adds
    ``sign * rate`` to ``M[row, col]``, ``rate = S[site]`` for a phospho
    transition (site >= 0) and 1 for a dephospho one (site == -1)."""
    m = (1 << n) - 1
    rows, cols, sites, signs = [], [], [], []

    def st(s):  # state s (bitmask, 1..m) -> y index
        return 2 + s - 1

    def add(row, col, site, sign):
        rows.append(row); cols.append(col); sites.append(site); signs.append(sign)

    for j in range(n):  # mono-phosphorylation P -> X_{1<<j} at rate S_j
        add(st(1 << j), 1, j, +1.0)
        add(1, 1, j, -1.0)

    for s in range(1, m + 1):
        for j in range(n):
            bit = 1 << j
            if s & bit:
                to = s ^ bit
                add(st(to) if to else 1, st(s), -1, +1.0)
                add(st(s), st(s), -1, -1.0)
            else:
                add(st(s | bit), st(s), j, +1.0)
                add(st(s), st(s), j, -1.0)

    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.asarray(sites, np.int32), np.asarray(signs, np.float64), m)


@lru_cache(maxsize=None)
def _random_rates(n: int, device: torch.device, dtype: torch.dtype):
    """(gather, signs) of the table on ``device``, uploaded once: the
    entry's index into [S_1..S_n, 1] and its sign."""
    _, _, sites, signs, _ = _random_transition_tables(n)
    return (torch.as_tensor(np.where(sites >= 0, sites, n).astype(np.int64), device=device),
            torch.as_tensor(signs, dtype=dtype, device=device))


@lru_cache(maxsize=None)
def _random_entry_plan(n: int):
    """The table grouped by matrix entry, in table order: (keys, terms),
    terms[k] the table rows that add to keys[k], in the order the JAX
    package's scatter-add applies them."""
    rows, cols, _, _, _ = _random_transition_tables(n)
    plan: dict = {}
    for i, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
        plan.setdefault((r, c), []).append(i)
    return tuple(plan), tuple(tuple(v) for v in plan.values())


def system_matrices_rand(params: torch.Tensor, n_sites: int):
    """Random (combinatorial) model over all 2^n - 1 phospho bitmask
    states."""
    n = n_sites
    m = (1 << n) - 1
    d = 2 + m
    B, C, D = _col(params, 1), _col(params, 2), _col(params, 3)
    S = params[..., 4:4 + n]
    Ddeg = params[..., 4 + n:4 + n + m]
    # rate per table entry: S[site] for phospho, 1.0 for dephospho
    S_ext = torch.cat([S, torch.ones_like(B)], dim=-1)
    gather, signs = _random_rates(n, params.device, params.dtype)
    vals = signs * S_ext.index_select(-1, gather)
    keys, terms = _random_entry_plan(n)
    e = {}
    for key, idx in zip(keys, terms):
        acc = _col(vals, idx[0])
        for i in idx[1:]:
            acc = acc + _col(vals, i)
        e[key] = acc
    e[(0, 0)] = -B
    e[(1, 0)] = C
    e[(1, 1)] = e[(1, 1)] + (-D) if (1, 1) in e else -D
    for s in range(m):
        k = (2 + s, 2 + s)
        e[k] = e[k] + (-_col(Ddeg, s)) if k in e else -_col(Ddeg, s)
    return _assemble(e, d, B), _b(params, d)


_BUILDERS = {
    "distmod": system_matrices_dist,
    "succmod": system_matrices_succ,
    "randmod": system_matrices_rand,
}


def n_params(model: str, n_sites: int) -> int:
    if model == "randmod":
        return 4 + n_sites + (1 << n_sites) - 1
    return 4 + 2 * n_sites


def state_dim(model: str, n_sites: int) -> int:
    if model == "randmod":
        return 2 + (1 << n_sites) - 1
    return 2 + n_sites


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------

def fit_vector(sol: torch.Tensor, n_sites: int) -> torch.Tensor:
    """[R after OFFSET, P over all t, the first n_sites phospho columns
    site-major]; ``sol`` (..., T, d)."""
    R = sol[..., OFFSET:, 0]
    P = sol[..., :, 1]
    sites = sol[..., :, 2:2 + n_sites].transpose(-1, -2).reshape(sol.shape[:-2] + (-1,))
    return torch.cat([R, P, sites], dim=-1)


def solve_tensors(params: torch.Tensor, init_cond: torch.Tensor, n_sites: int,
                  t: torch.Tensor, model: str = "distmod", normalize: bool = False):
    """(sol (..., T, d), fit) for parameters with any leading batch shape,
    all tensors on one device at one dtype: clipped at zero, optionally
    normalised by y0. Safe under ``torch.func`` transforms."""
    M, b = _BUILDERS[model](params, n_sites)
    y0 = init_cond.expand(M.shape[:-1])
    sol = torch.maximum(solve_lti_batched(M, b, y0, t), torch.zeros_like(init_cond[0]))
    if normalize:
        sol = sol / init_cond
    return sol, fit_vector(sol, n_sites)


def _as(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x if torch.is_tensor(x) else np.array(x), dtype=dtype, device=device)


def solve_ode(params, init_cond, n_sites: int, t, model: str = "distmod",
              normalize: bool = False, *, device=DEFAULT_DEVICE, dtype=None):
    """Solve one per-gene system exactly; return (sol (T, d), fit_vector)
    as tensors on ``device`` (default: the card; raises where there is
    none) at ``dtype`` (default: float32 on the card, float64 on the CPU).

    The solution is clipped >= 0 and optionally normalised by y0."""
    return solve_ode_batched(params, init_cond, n_sites, t, model, normalize,
                             device=device, dtype=dtype)


def solve_ode_batched(params_batch, init_cond, n_sites: int, t, model: str = "distmod",
                      normalize: bool = False, *, device=DEFAULT_DEVICE, dtype=None):
    """:func:`solve_ode` over a leading batch of parameter vectors (B, n)
    -> sol (B, T, d), fit (B, m)."""
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    return solve_tensors(_as(params_batch, device, dtype), _as(init_cond, device, dtype),
                         n_sites, _as(t, device, dtype), model, normalize)


# ---------------------------------------------------------------------------
# steady-state initial conditions
# ---------------------------------------------------------------------------

def initial_condition(n_sites: int, model: str = "distmod", *, device=DEFAULT_DEVICE,
                      dtype=None) -> torch.Tensor:
    """Steady state with ALL rate parameters set to 1: the systems are
    linear, so it is ``y* = -M^{-1} b`` (floored at 1e-12), in bitmask order
    for the random model."""
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    params = torch.ones((n_params(model, n_sites),), dtype=dtype, device=device)
    M, b = _BUILDERS[model](params, n_sites)
    y = torch.linalg.solve(M, -b)
    return torch.clamp(y, min=1e-12)
