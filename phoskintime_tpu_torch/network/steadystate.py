"""Analytic steady states of the global model with every rate 1.

Counterpart of the steady-state half of
``phoskintime_tpu/network/steadystate.py``, the structural oracles of the
RK45 path: with all rates 1 and no TF input, each mechanism's equilibrium
solves a small linear system per protein:

* :func:`steady_state_distributive` — a closed form;
* :func:`steady_state_sequential` — one tridiagonal chain per protein,
  all solved by :func:`~phoskintime_tpu_torch.ops.tridiag.thomas_solve_batched`
  (on the card: one launch of ``csrc/thomas.cu``);
* :func:`steady_state_combinatorial` — one dense (Mmax, Mmax) hypercube
  system per protein, solved together by ``torch.linalg.solve``.

The decay term ``+ D`` of every phospho state is included, as in the JAX
package, so that the RHS vanishes at these states. Each function computes
in float64 on ``device`` (the card by default: the H100 has native FP64)
and returns host numpy (N, width).

The data-driven initial state (``build_y0_from_data``) reads pandas frames
and waits for the host layer (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device
from phoskintime_tpu_torch.ops.tridiag import thomas_solve_batched

# every rate of the oracle: E (dephospho), D (decay), Dp (phospho-state
# decay) and the site rates S
_RATE = 1.0


def _mrna(N: int, TF_inputs, tf_scale: float, f: dict) -> torch.Tensor:
    """R = the synthesis rate at the squashed TF input (B = 1). Like the
    JAX package, the linear activation A (1 + tf_scale u): at zero input it
    equals the RHS's rational rate."""
    u = torch.zeros(N, **f) if TF_inputs is None else torch.as_tensor(
        np.asarray(TF_inputs, float), **f)
    u = u / (1.0 + torch.abs(u))
    synth = torch.where(u >= 0, 1.0 + tf_scale * u, 1.0 / (1.0 + tf_scale * torch.abs(u)))
    return torch.clamp(synth, min=0.0)


def _float64_on(device) -> dict:
    return dict(dtype=torch.float64, device=resolve_device(device))


def steady_state_distributive(topo, TF_inputs=None, tf_scale=1.0,
                              device=DEFAULT_DEVICE) -> np.ndarray:
    """Model 0: R = synth; each site P_j = S_j P / (E + Dp_j + D) = P / 3;
    P = C R / (D + sum_j S_j - sum_j E S_j / (E + Dp_j + D))."""
    f = _float64_on(device)
    R = _mrna(topo.N, TF_inputs, tf_scale, f)
    ns = torch.as_tensor(topo.n_sites, **f)
    msk = torch.as_tensor(topo.site_mask(), **f)
    denom = torch.clamp(1.0 + ns - ns / 3.0, min=np.finfo(float).tiny)
    P = torch.where(ns > 0, R / denom, R)
    sites = (P[:, None] / 3.0) * msk
    Y = torch.cat([R[:, None], torch.clamp(P, min=0.0)[:, None],
                   torch.clamp(sites, min=0.0)], dim=1)
    return Y.cpu().numpy()


def steady_state_sequential(topo, TF_inputs=None, tf_scale=1.0,
                            device=DEFAULT_DEVICE) -> np.ndarray:
    """Model 1: the chain [P0, P1 .. Pns] of each protein (n = Smax + 1
    unknowns, rows past its sites the identity) as a tridiagonal system,
    every protein's at once."""
    f = _float64_on(device)
    R = _mrna(topo.N, TF_inputs, tf_scale, f)
    j = np.arange(topo.max_sites + 1)[None, :]
    ns = np.asarray(topo.n_sites)[:, None]
    E = D = Dp = S = _RATE
    # row 0: (D + S_0) P0 - E P1 = C R (D P0 = C R without sites); row j of
    # the chain: -S P_{j-1} + (S + E + Dp + D) P_j - E P_{j+1} = 0, the last
    # without the step onward
    a = np.where((j >= 1) & (j <= ns), -S, 0.0)
    b = np.where(j == 0, np.where(ns > 0, D + S, D),
                 np.where(j < ns, S + E + Dp + D, np.where(j == ns, E + Dp + D, 1.0)))
    c = np.where(j < ns, -E, 0.0)
    a, b, c = (torch.as_tensor(np.broadcast_to(v, b.shape).copy(), **f) for v in (a, b, c))
    d = torch.zeros_like(b)
    d[:, 0] = R
    x = thomas_solve_batched(a, b, c, d)
    msk = torch.as_tensor(topo.site_mask(), **f)
    Y = torch.cat([R[:, None], torch.clamp(x[:, :1], min=0.0),
                   torch.clamp(x[:, 1:], min=0.0) * msk], dim=1)
    return Y.cpu().numpy()


def steady_state_combinatorial(topo, TF_inputs=None, tf_scale=1.0,
                               max_states_per_protein=4096,
                               device=DEFAULT_DEVICE) -> np.ndarray:
    """Model 2: the 2^ns states of each protein as a dense linear system
    A P = -C R e_0 (rows past its states the identity), every protein's
    solved together."""
    if topo.max_states > max_states_per_protein:
        raise ValueError(f"2^{topo.max_sites} states exceeds cap "
                         f"{max_states_per_protein}")
    f = _float64_on(device)
    R = _mrna(topo.N, TF_inputs, tf_scale, f)
    Mmax = topo.max_states
    E = D = Dp = S = _RATE
    m = np.arange(Mmax)
    A = np.zeros((topo.N, Mmax, Mmax))
    for i, ns in enumerate(np.asarray(topo.n_sites)):
        live = m[m < (1 << int(ns))]
        pad = m[m >= (1 << int(ns))]
        A[i, pad, pad] = 1.0
        A[i, 0, 0] -= D
        for j in range(int(ns)):
            # a set bit j: dephospho out to m ^ 2^j at E, decay Dp + D; a
            # clear one: phospho out to m | 2^j at S
            bit = (live >> j) & 1
            A[i, live, live] -= np.where(bit == 1, E + Dp + D, S)
            A[i, live ^ (1 << j), live] += np.where(bit == 1, E, S)
    rhs = torch.zeros((topo.N, Mmax, 1), **f)
    rhs[:, 0, 0] = -R
    P = torch.linalg.solve(torch.as_tensor(A, **f), rhs)[..., 0]
    P = torch.clamp(P, min=0.0) * torch.as_tensor(topo.state_mask(), **f)
    return torch.cat([R[:, None], P], dim=1).cpu().numpy()
