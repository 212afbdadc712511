"""Right-hand side of the global network model, mechanisms 0, 1, 2 and 4.

Counterpart of ``phoskintime_tpu/network/rhs.py``: distributive (0),
sequential (1), combinatorial (2, the hypercube of phospho-states) and
saturating (4, Michaelis-Menten) phosphorylation with the rational
soft-clipped synthesis rate, over the padded (N, width) state.

Within one kinase bucket mechanisms 0-2 are affine in the state; the
only coupling between proteins is the TF input u, and with u frozen the
linear part is block-diagonal (:meth:`PaddedRHS.linear_blocks` for
models 0/1, ``network/expo.py::_block_linear_operators`` for model 2).
That is the structure the exponential integrator uses. Model 4's
translation and forward fluxes saturate, so its block Jacobian depends on
the state (:meth:`PaddedRHS.jac_blocks_saturating`), which the
exponential-Rosenbrock path refreshes as it goes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device
from phoskintime_tpu_torch.ops.hypercube_flux import hypercube_flux

def check_model(model: int) -> None:
    """Raise for a mechanism id outside 0, 1, 2 and 4."""
    if int(model) not in (0, 1, 2, 4):
        raise ValueError(f"model {model} is not a mechanism (0, 1, 2 or 4)")


@lru_cache(maxsize=None)
def _hypercube_tables(smax: int):
    """Static bitmask tables of the combinatorial mechanism, host numpy:
    ``bits[j, m]`` is bit j of state m (float 0/1) and ``xor_idx[j, m]``
    is ``m XOR (1 << j)``, the neighbour of m across site j."""
    mmax = 1 << smax
    m = np.arange(mmax, dtype=np.int64)[None, :]
    j = np.arange(smax, dtype=np.int64)[:, None]
    bits = ((m >> j) & 1).astype(np.float64)
    xor_idx = (m ^ (1 << j)).astype(np.int32)
    return bits, xor_idx


def synthesis_rate(A, tf_scale, u_squashed):
    """Rational Hill-like synthesis rate; ``u_squashed`` lies in (-1, 1).

    Activation: A * (1 + tf_scale*u / (1 + u + 1e-6));
    repression: A / (1 + tf_scale*|u|)."""
    act = A * (1.0 + (tf_scale * u_squashed) / (1.0 + u_squashed + 1e-6))
    rep = A / (1.0 + tf_scale * torch.abs(u_squashed))
    return torch.where(u_squashed >= 0.0, act, rep)


def tf_inputs(tf_mat, tf_deg, P_vec):
    """Squashed TF drive u in (-1, 1): P_vec (..., N), one row per member."""
    v = torch.matmul(P_vec, tf_mat.T) / tf_deg
    return v / (1.0 + torch.abs(v))


class PaddedRHS:
    """RHS over the padded state, holding the topology tensors at one
    dtype on one device (default: the card). ``rhs(t, y_flat, jb,
    params)`` evaluates one member, ``jb`` an int indexing the kinase grid
    (the bucket of t); :meth:`batched` evaluates a population, each member
    in its own bucket. The mechanisms are written over any leading axes."""

    def __init__(self, topo, Kmat, dtype=torch.float64, device=DEFAULT_DEVICE):
        check_model(topo.model)
        device = resolve_device(device)
        f = dict(dtype=dtype, device=device)
        self.model = int(topo.model)
        self.N = topo.N
        self.Smax = topo.max_sites
        self.width = topo.width
        self.W_pad = torch.as_tensor(topo.W_pad, **f)
        self.W_rows = self.W_pad.reshape(self.N * self.Smax, -1)   # (N*Smax, K)
        self.tf_mat = torch.as_tensor(topo.tf_mat, **f)
        self.tf_deg = torch.as_tensor(topo.tf_deg, **f)
        self.driver_map = torch.as_tensor(topo.driver_map, device=device)
        self.driven = self.driver_map >= 0
        self.driver_idx = torch.clamp(self.driver_map, min=0).long()
        self.site_mask = torch.as_tensor(topo.site_mask(), **f)
        self.Kmat = torch.as_tensor(Kmat, **f)          # (K, n_buckets)
        if self.model == 2:
            bits, _ = _hypercube_tables(self.Smax)
            self.bits = torch.as_tensor(bits, **f)                  # (Smax, Mmax)
            self.state_mask = torch.as_tensor(topo.state_mask(), **f)  # (N, Mmax)
            self.Mmax = topo.max_states

    def kinase_activity(self, params, jb: int):
        """Kt = K(t) * c_k at the clamped bucket index."""
        jb = min(max(int(jb), 0), self.Kmat.shape[1] - 1)
        return self.Kmat[:, jb] * params["c_k"]

    def site_rates(self, Kt):
        """S (..., N, Smax): per-site phospho drive W . Kt, Kt (..., K)."""
        return torch.matmul(Kt, self.W_rows.T).reshape(*Kt.shape[:-1], self.N, self.Smax)

    def total_protein(self, Y):
        if self.model == 2:
            return torch.sum(Y[..., 1:] * self.state_mask, dim=-1)
        return Y[..., 1] + torch.sum(Y[..., 2:] * self.site_mask, dim=-1)

    def p_vec(self, Y, Kt):
        """Observable protein vector; kinase-driven proteins take the live
        kinase activity in place of their simulated total."""
        return torch.where(self.driven, Kt[..., self.driver_idx], self.total_protein(Y))

    def __call__(self, t, y_flat, jb, params, u_override=None):
        """dy/dt for one member (flat (N*width,) state). ``u_override``
        freezes the TF input, which leaves the block-diagonal linear part."""
        Y = y_flat.reshape(self.N, self.width)
        Kt = self.kinase_activity(params, jb)
        S = self.site_rates(Kt)
        u = (tf_inputs(self.tf_mat, self.tf_deg, self.p_vec(Y, Kt))
             if u_override is None else u_override)
        synth = synthesis_rate(params["A_i"], params["tf_scale"], u)
        return self._mechanism(Y, S, synth, params).reshape(-1)

    def batched(self, t, y, jb, params_b, use_kernel: bool | None = None):
        """dy/dt for a population: y (P, N*width), jb (P,) int (each
        member's own bucket), every leaf of ``params_b`` with a leading P.
        Model 2's edge flux runs through :func:`hypercube_flux` on the
        (P*N, Mmax) rows (``use_kernel`` goes there). Returns (P, N*width)."""
        P = y.shape[0]
        Y = y.reshape(P, self.N, self.width)
        jb = torch.clamp(jb, 0, self.Kmat.shape[1] - 1)
        Kt = self.Kmat[:, jb].T * params_b["c_k"]               # (P, K)
        S = self.site_rates(Kt)
        u = tf_inputs(self.tf_mat, self.tf_deg, self.p_vec(Y, Kt))
        synth = synthesis_rate(params_b["A_i"], params_b["tf_scale"][:, None], u)
        return self._mechanism(Y, S, synth, params_b, use_kernel).reshape(P, -1)

    def _mechanism(self, Y, S, synth, p, use_kernel=None):
        if self.model == 2:
            return self._rhs_combinatorial(Y, S, synth, p, use_kernel)
        if self.model == 1:
            return self._rhs_sequential(Y, S, synth, p)
        if self.model == 4:
            return self._rhs_saturating(Y, S, synth, p)
        return self._rhs_distributive(Y, S, synth, p)

    def _rhs_distributive(self, Y, S, synth, p):
        """Model 0: every site is phosphorylated from P0 directly."""
        B, C, D, E, Dp = p["B_i"], p["C_i"], p["D_i"], p["E_i"], p["Dp_i"]
        msk = self.site_mask
        R, P0, sites = Y[..., 0], Y[..., 1], Y[..., 2:] * msk
        Sm = S * msk
        dR = synth - B * R
        d_sites = (Sm * P0[..., None]
                   - (E[..., None] + Dp + D[..., None]) * sites) * msk
        dP0 = C * R - (D + Sm.sum(-1)) * P0 + E * sites.sum(-1)
        return torch.cat([dR[..., None], dP0[..., None], d_sites], dim=-1)

    def _rhs_saturating(self, Y, S, synth, p):
        """Model 4: translation C R / (1 + R) and per-site forward fluxes
        S_j P0 / (1 + P0) saturate; back-steps at E, decay Dp_j + D."""
        B, C, D, E, Dp = p["B_i"], p["C_i"], p["D_i"], p["E_i"], p["Dp_i"]
        msk = self.site_mask
        R, P0, sites = Y[..., 0], Y[..., 1], Y[..., 2:] * msk
        Sm = S * msk
        dR = synth - B * R
        trans = (C * R) / (1.0 + R)
        fflux = (Sm * P0[..., None]) / (1.0 + P0[..., None])
        back = E[..., None] * sites
        d_sites = (fflux - (Dp + D[..., None]) * sites - back) * msk
        dP0 = (trans - D * P0 - torch.sum(fflux * msk, dim=-1)
               + torch.sum(back * msk, dim=-1))
        return torch.cat([dR[..., None], dP0[..., None], d_sites], dim=-1)

    def _rhs_sequential(self, Y, S, synth, p):
        """Model 1: a chain P0 -> s_1 -> s_2 -> ... with back-steps at E."""
        B, C, D, E, Dp = p["B_i"], p["C_i"], p["D_i"], p["E_i"], p["Dp_i"]
        msk = self.site_mask
        R, P0, sites = Y[..., 0], Y[..., 1], Y[..., 2:] * msk
        Sm = S * msk
        has_sites = msk[..., 0]
        zero = torch.zeros_like(Sm[..., :1])
        prev = torch.cat([P0[..., None], sites[..., :-1]], dim=-1)
        k_next = torch.cat([Sm[..., 1:], zero], dim=-1)
        has_next = torch.cat([msk[..., 1:], torch.zeros_like(msk[..., :1])], dim=-1)
        nxt = torch.cat([sites[..., 1:], zero], dim=-1)
        dR = synth - B * R
        d_sites = (Sm * prev
                   + E[..., None] * nxt * has_next
                   - (k_next * has_next + E[..., None] + Dp + D[..., None]) * sites) * msk
        dP0 = (C * R - D * P0 - Sm[..., 0] * P0 * has_sites
               + E * sites[..., 0] * has_sites)
        return torch.cat([dR[..., None], dP0[..., None], d_sites], dim=-1)

    def _rhs_combinatorial(self, Y, S, synth, p, use_kernel=None):
        """Model 2, the hypercube: per set bit of a state, a dephospho edge
        at rate E and decay Dp_j + D; per clear bit, a phospho edge at rate
        S_j. Translation feeds state 0, which decays at plain D.

        The edge flux is :func:`hypercube_flux` of the states masked to the
        valid ones and the rates masked to the valid sites: an invalid site
        j of a protein with ns sites has j >= ns, so every state carrying
        bit j is itself invalid (m >= 2^ns) and its terms vanish, which is
        the JAX package's per-site ``valid`` factor."""
        B, C, D, E, Dp = p["B_i"], p["C_i"], p["D_i"], p["E_i"], p["Dp_i"]
        R = Y[..., 0]
        X = Y[..., 1:] * self.state_mask                # (..., N, Mmax)
        smask = self.site_mask                          # (N, Smax)
        Sm = S * smask
        dR = synth - B * R
        dX = hypercube_flux(X.reshape(-1, self.Mmax).contiguous(),
                            Sm.reshape(-1, self.Smax).contiguous(),
                            E.reshape(-1).contiguous(), self.Smax,
                            use_kernel=use_kernel).reshape(X.shape)

        decay = torch.matmul((Dp + D[..., None]) * smask, self.bits)
        decay = torch.cat([D[..., None], decay[..., 1:]], dim=-1)   # state 0: D
        dX = dX - decay * X
        dX = torch.cat([dX[..., :1] + (C * R)[..., None], dX[..., 1:]], dim=-1)
        dX = dX * self.state_mask
        return torch.cat([dR[..., None], dX], dim=-1)

    def linear_blocks(self, S, p):
        """(N, w, w) block-diagonal linear operator with the TF input frozen,
        models 0/1 (model 2's are written out in lane layout in
        ``network/expo.py``).

        Exact, since these mechanisms are linear in the state; entries are
        written in place rather than contracted against one-hot placement
        tables, so no matmul (and no TF32 question) is involved."""
        if self.model not in (0, 1):
            raise ValueError("linear_blocks is written out for models 0/1 only")
        N, w = self.N, self.width
        msk = self.site_mask
        B, C, D, E, Dp = p["B_i"], p["C_i"], p["D_i"], p["E_i"], p["Dp_i"]
        Sm = S * msk
        L = Sm.new_zeros((N, w, w))
        L[:, 0, 0] = -B
        L[:, 1, 0] = C
        j = torch.arange(self.Smax, device=Sm.device)
        if self.model == 0:
            L[:, 1, 1] = -D - Sm.sum(1)
            L[:, 1, 2 + j] = E[:, None] * msk
            L[:, 2 + j, 1] = Sm
            L[:, 2 + j, 2 + j] = -(E[:, None] + Dp + D[:, None]) * msk
            return L
        has_sites = msk[:, 0]
        zero = torch.zeros_like(Sm[:, :1])
        has_next = torch.cat([msk[:, 1:], zero], dim=1)
        k_next = torch.cat([Sm[:, 1:], zero], dim=1)
        L[:, 1, 1] = -D - Sm[:, 0] * has_sites
        if w > 2:
            L[:, 1, 2] = E * has_sites
        L[:, 2, 1] = Sm[:, 0]
        L[:, 3 + j[:-1], 2 + j[:-1]] = Sm[:, 1:]
        L[:, 2 + j[:-1], 3 + j[:-1]] = (E[:, None] * has_next * msk)[:, :-1]
        L[:, 2 + j, 2 + j] = -(k_next * has_next + E[:, None] + Dp + D[:, None]) * msk
        return L

    def jac_blocks_saturating(self, Y, S, p):
        """(..., N, w, w) block Jacobian of the saturating mechanism with the
        TF input frozen, at the states Y (..., N, w); S (..., N, Smax) and
        the leaves of ``p`` share the leading axes. Entries (slots [R, P0,
        s_1 .. s_Smax], m_j the site mask):

          dR/dR = -B;  dP0/dR = C / (1 + R)^2;
          dP0/dP0 = -D - sum_j S_j m_j / (1 + P0)^2;  dP0/ds_j = E m_j;
          ds_j/dP0 = S_j m_j / (1 + P0)^2;  ds_j/ds_j = -(Dp_j + D + E) m_j.

        Written in place, as :meth:`linear_blocks`, where the JAX package
        contracts against model 0's one-hot placement tables."""
        N, w = self.N, self.width
        msk = self.site_mask
        B, C, D, E, Dp = p["B_i"], p["C_i"], p["D_i"], p["E_i"], p["Dp_i"]
        R, P0 = Y[..., 0], Y[..., 1]
        dflux = S * msk / (1.0 + P0[..., None]) ** 2
        j = torch.arange(self.Smax, device=Y.device)
        L = Y.new_zeros((*Y.shape[:-2], N, w, w))
        L[..., 0, 0] = -B
        L[..., 1, 0] = C / (1.0 + R) ** 2
        L[..., 1, 1] = -D - torch.sum(dflux, dim=-1)
        L[..., 1, 2 + j] = E[..., None] * msk
        L[..., 2 + j, 1] = dflux
        L[..., 2 + j, 2 + j] = -(Dp + D[..., None] + E[..., None]) * msk
        return L
