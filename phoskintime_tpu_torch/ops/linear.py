"""Exact solution of linear time-invariant ODE systems.

Counterpart of ``phoskintime_tpu/ops/linear.py``. The per-gene kinetic
models are linear ODEs ``dy/dt = M y + b`` with constant ``M`` and ``b``;
they are solved exactly with matrix exponentials of the augmented system

    d/dt [y; 1] = [[M, b], [0, 0]] [y; 1]   =>   y(t) = (expm(A t) [y0; 1])[:d]

propagated step by step over the time grid, as the JAX package's scan does.

:func:`expm` is the JAX package's ``jax.scipy.linalg.expm`` (scaling and
squaring with a Padé approximant chosen by the 1-norm, a fixed scan of 16
masked squarings, NaN where more are needed) over a leading batch axis, as
``jax.vmap`` runs it: every branch is a per-matrix select, the P/Q solve is
``torch.linalg.solve_ex`` (no error check, so no host read on the card) and
the squarings are 16 masked batched matmuls. ``torch.func.jacfwd``
therefore differentiates the same approximant that ``jax.jacfwd`` does.
``torch.linalg.matrix_exp`` (Taylor, no NaN cutoff) is used nowhere here.
"""

from __future__ import annotations

import torch

MAX_SQUARINGS = 16

# (maxnorm, the digitize thresholds of the 1-norm) by precision, and the
# Padé orders the thresholds select (jax/_src/scipy/linalg.py::_calc_P_Q)
_SCALING = {
    torch.float64: (5.371920351148152, (1.495585217958292e-002, 2.539398330063230e-001,
                                        9.504178996162932e-001, 2.097847961257068e+000)),
    torch.float32: (3.925724783138660, (4.258730016922831e-001, 1.880152677804762e+000)),
}
_PADE_B = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240.,
        2162160., 110880., 3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600.,
         1187353796428800., 129060195264000., 10559470521600., 670442572800.,
         33522128640., 1323241920., 40840800., 960960., 16380., 182., 1.),
}


def _pade_terms(A: torch.Tensor, orders: tuple) -> list:
    """(inner, V) of each Padé order, with U = A @ inner: the JAX package's
    ``_pade3`` .. ``_pade13`` term for term, the powers of A shared."""
    ident = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    out = []
    for m in orders:
        b = _PADE_B[m]
        if m == 3:
            inner, V = b[3] * A2 + b[1] * ident, b[2] * A2 + b[0] * ident
        elif m == 5:
            inner = b[5] * A4 + b[3] * A2 + b[1] * ident
            V = b[4] * A4 + b[2] * A2 + b[0] * ident
        elif m == 7:
            inner = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident
            V = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
        elif m == 9:
            A8 = A6 @ A2
            inner = b[9] * A8 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident
            V = b[8] * A8 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
        else:
            inner = (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
                     + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
            V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
                 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident)
        out.append((inner, V))
    return out


def expm(A: torch.Tensor, max_squarings: int = MAX_SQUARINGS) -> torch.Tensor:
    """exp(A) of each (n, n) matrix of ``A`` (..., n, n), float32 or
    float64, by the JAX package's algorithm (see the module doc): NaN where
    more than ``max_squarings`` squarings are needed."""
    if A.dtype not in _SCALING:
        raise TypeError(f"expm: A.dtype={A.dtype} is not supported")
    maxnorm, conds = _SCALING[A.dtype]
    # the squaring count and the branch are piecewise constant in A: no
    # tangent (JAX's floor has none; PyTorch's log2 would promote a float32
    # tangent to float64)
    norm = A.detach().abs().sum(-2).amax(-1)
    n_sq = torch.clamp(torch.floor(torch.log2(norm / maxnorm)), min=0)
    As = A / torch.exp2(n_sq)[..., None, None]
    idx = sum((norm >= c).to(torch.int64) for c in conds)[..., None, None]
    terms = _pade_terms(As, (3, 5, 7, 9, 13) if A.dtype == torch.float64 else (3, 5, 7))
    inner, V = terms[-1]
    for k in range(len(terms) - 2, -1, -1):
        inner = torch.where(idx == k, terms[k][0], inner)
        V = torch.where(idx == k, terms[k][1], V)
    U = As @ inner
    R, _ = torch.linalg.solve_ex(-U + V, U + V)
    n_sq = n_sq[..., None, None]
    live = torch.arange(max_squarings, dtype=n_sq.dtype, device=n_sq.device)
    live = live.reshape((-1,) + (1,) * n_sq.dim()) < n_sq      # squaring i runs where i < s
    for i in range(max_squarings):
        R = torch.where(live[i], R @ R, R)
    return torch.where(n_sq > max_squarings, torch.full_like(R, float("nan")), R)


def affine_augment(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Embed dy = M y + b into the homogeneous (d+1)-dim system."""
    top = torch.cat([M, b[..., :, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def solve_lti_batched(Ms: torch.Tensor, bs: torch.Tensor, y0s: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """Solve dy/dt = M y + b, y(0) = y0 at times ``t`` (T,) for a leading
    batch of systems: Ms (B, d, d), bs (B, d), y0s (B, d) -> ys (B, T, d).

    Each step's exponential expm(A dt_k) is the JAX scan's; all T of them
    are built in one batched call, then applied in sequence."""
    d = Ms.shape[-1]
    A = affine_augment(Ms, bs)
    dts = torch.diff(t, prepend=torch.zeros_like(t[:1]))
    E = expm(A[..., None, :, :] * dts[:, None, None])           # (B, T, d+1, d+1)
    z = torch.cat([y0s, torch.ones_like(y0s[..., :1])], dim=-1)
    ys = []
    for k in range(t.shape[0]):
        z = (E[..., k, :, :] @ z[..., None])[..., 0]
        ys.append(z[..., :d])
    return torch.stack(ys, dim=-2)


def solve_lti(M: torch.Tensor, b: torch.Tensor, y0: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """One system: M (d, d), b (d,), y0 (d,) -> ys (T, d)."""
    return solve_lti_batched(M, b, y0, t)
