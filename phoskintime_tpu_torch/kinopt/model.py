"""kinopt: kinase -> phosphosite algebraic optimization model.

Counterpart of ``phoskintime_tpu/kinopt/model.py``:

    P_hat_i(t) = sum_j alpha_{i,j} * A_j(t),
    A_j(t)     = sum_p beta_{j,p} * K_p(t),

with per-site ``sum_j alpha_{i,j} = 1`` and per-kinase ``sum_p beta_{j,p} =
1`` constraints, bounds [-4, 4], and the evolutionary and local losses.

The problem keeps its fields as host numpy arrays (ragged groups padded
into index matrices with masks). Every function takes padded alpha (...,
n_gp, Amax) and beta (..., n_k, Bmax) tensors with optional leading axes,
so a population is one call (where the JAX package vmaps); the problem's
tensors are made once per device and dtype (:meth:`KinoptProblem.on`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device, working_dtype


class KinoptTensors(NamedTuple):
    """A problem's arrays on one device and dtype."""
    P: torch.Tensor           # (n_gp, T) observed series
    K_sel: torch.Tensor       # (n_k, Bmax, T) the source row of each beta slot
    gp_kin_idx: torch.Tensor  # (n_gp, Amax) kinase index of each alpha slot
    gmask: torch.Tensor       # (n_gp, Amax) valid alpha slots, 0/1
    kmask: torch.Tensor       # (n_k, Bmax) valid beta slots, 0/1
    tw: torch.Tensor          # (T,) inverse per-time-point variance ("weighted")


@dataclasses.dataclass
class KinoptProblem:
    """Static padded description of the kinase->site assignment problem."""

    P_obs: np.ndarray             # (n_gp, T) observed phospho time series
    K_array: np.ndarray           # (n_rows, T) kinase-signal source rows
    gp_kin_idx: np.ndarray        # (n_gp, Amax) kinase index per alpha slot
    gp_mask: np.ndarray           # (n_gp, Amax) valid alpha slots
    k_row_idx: np.ndarray         # (n_k, Bmax) K_array row per beta slot
    k_mask: np.ndarray            # (n_k, Bmax) valid beta slots
    gp_names: list = None         # [(gene, psite)]
    kinase_names: list = None
    lb: float = -4.0
    ub: float = 4.0
    _tensors: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    @property
    def n_gp(self):
        return self.P_obs.shape[0]

    @property
    def n_k(self):
        return self.k_row_idx.shape[0]

    @property
    def n_alpha(self):
        return int(self.gp_mask.sum())

    @property
    def n_beta(self):
        return int(self.k_mask.sum())

    # ---- flat (reference-order) <-> padded parameter conversion ----------
    def pack(self, alpha_pad: np.ndarray, beta_pad: np.ndarray) -> np.ndarray:
        return np.concatenate([np.asarray(alpha_pad)[self.gp_mask],
                               np.asarray(beta_pad)[self.k_mask]])

    def unpack(self, x: np.ndarray):
        a = np.zeros(self.gp_mask.shape)
        b = np.zeros(self.k_mask.shape)
        a[self.gp_mask] = np.asarray(x)[: self.n_alpha]
        b[self.k_mask] = np.asarray(x)[self.n_alpha:self.n_alpha + self.n_beta]
        return a, b

    def on(self, device, dtype) -> KinoptTensors:
        """The problem's tensors on ``device`` at ``dtype``, made once."""
        key = (str(torch.device(device)), dtype)
        if key not in self._tensors:
            f = dict(dtype=dtype, device=device)
            P = np.asarray(self.P_obs, float)
            K = np.asarray(self.K_array, float)
            self._tensors[key] = KinoptTensors(
                torch.as_tensor(P, **f), torch.as_tensor(K[self.k_row_idx], **f),
                torch.as_tensor(self.gp_kin_idx.astype(np.int64), device=device),
                torch.as_tensor(self.gp_mask, **f), torch.as_tensor(self.k_mask, **f),
                torch.as_tensor(1.0 / (np.var(P, axis=0) + 1e-8), **f))
        return self._tensors[key]


def build_problem(P_obs, site_kinases: list[list[int]],
                  kinase_rows: list[list[int]], K_array,
                  gp_names=None, kinase_names=None,
                  lb=-4.0, ub=4.0) -> KinoptProblem:
    """Assemble padded index tables from ragged group lists."""
    n_gp = len(site_kinases)
    n_k = len(kinase_rows)
    Amax = max(1, max((len(s) for s in site_kinases), default=1))
    Bmax = max(1, max((len(r) for r in kinase_rows), default=1))
    gp_kin_idx = np.zeros((n_gp, Amax), np.int32)
    gp_mask = np.zeros((n_gp, Amax), bool)
    for i, ks in enumerate(site_kinases):
        gp_kin_idx[i, :len(ks)] = ks
        gp_mask[i, :len(ks)] = True
    k_row_idx = np.zeros((n_k, Bmax), np.int32)
    k_mask = np.zeros((n_k, Bmax), bool)
    for j, rows in enumerate(kinase_rows):
        k_row_idx[j, :len(rows)] = rows
        k_mask[j, :len(rows)] = True
    return KinoptProblem(np.asarray(P_obs, float), np.asarray(K_array, float),
                         gp_kin_idx, gp_mask, k_row_idx, k_mask,
                         gp_names, kinase_names, lb, ub)


# ---------------------------------------------------------------------------
# prediction + losses
# ---------------------------------------------------------------------------

def predict(prob: KinoptProblem, alpha_pad: torch.Tensor, beta_pad: torch.Tensor):
    """(..., n_gp, T) predictions; negatives clipped (a tie at 0 splits the
    gradient evenly, as ``jnp.maximum``)."""
    t = prob.on(alpha_pad.device, alpha_pad.dtype)
    signal = torch.einsum("...kb,kbt->...kt", beta_pad * t.kmask, t.K_sel)
    S_sel = signal[..., t.gp_kin_idx, :]                   # (..., n_gp, Amax, T)
    pred = torch.einsum("...ga,...gat->...gt", alpha_pad * t.gmask, S_sel)
    return torch.maximum(pred, torch.zeros_like(pred))


def _corr_sq_lag1(res):
    """Squared lag-1 autocorrelation per row (..., n_gp)."""
    x0 = res[..., :-1] - res[..., :-1].mean(dim=-1, keepdim=True)
    x1 = res[..., 1:] - res[..., 1:].mean(dim=-1, keepdim=True)
    cov = (x0 * x1).sum(dim=-1)
    v0 = (x0 * x0).sum(dim=-1)
    v1 = (x1 * x1).sum(dim=-1)
    denom = v0 * v1
    r = torch.where(denom > 0, cov / torch.sqrt(torch.clamp(denom, min=1e-300)),
                    torch.zeros_like(cov))
    return r * r


def kinopt_loss(prob: KinoptProblem, alpha_pad, beta_pad,
                loss_type: str = "base", include_reg: bool = False):
    """(...) losses: base (MSE), autocorrelation (lag-1 r^2), huber, mape;
    the local losses weighted (inverse-variance time weights), softl1,
    cauchy, arctan."""
    t = prob.on(alpha_pad.device, alpha_pad.dtype)
    P = t.P
    res = P - predict(prob, alpha_pad, beta_pad)
    n_scalar = P.numel()
    n_gp = P.shape[0]
    total = lambda x: x.sum(dim=(-2, -1))

    if loss_type == "autocorrelation":
        val = _corr_sq_lag1(res).sum(dim=-1)
    elif loss_type == "huber":
        delta = 1.0
        a = torch.abs(res)
        h = torch.where(a <= delta, 0.5 * res * res, delta * (a - 0.5 * delta))
        val = total(h) / n_scalar
    elif loss_type == "mape":
        val = total(torch.abs(res / (P + 1e-12))) / n_scalar * 100.0
    elif loss_type == "weighted":
        val = total(t.tw * res * res) / (t.tw.sum() * n_gp)
    elif loss_type == "softl1":
        val = total(2.0 * (torch.sqrt(1.0 + 0.5 * res * res) - 1.0)) / n_gp
    elif loss_type == "cauchy":
        val = total(torch.log1p(0.5 * res * res)) / n_gp
    elif loss_type == "arctan":
        val = total(torch.arctan(res * res)) / n_gp
    else:  # base MSE
        val = total(res * res) / n_scalar

    if include_reg:
        # UNWEIGHTED L1+L2 (coefficient 1.0), as the reference's evol
        # objectives add `val + l1 + l2` with no lambda
        # (kinopt/evol/objfn/minfndiffevo.py:239-245): with simplex
        # constraints the penalty can rival the data loss; kept for parity
        params = torch.cat([(alpha_pad * t.gmask).flatten(-2),
                            (beta_pad * t.kmask).flatten(-2)], dim=-1)
        val = val + torch.abs(params).sum(dim=-1) + (params ** 2).sum(dim=-1)
    return val


def _group_sums(prob: KinoptProblem, alpha_pad, beta_pad):
    t = prob.on(alpha_pad.device, alpha_pad.dtype)
    return (alpha_pad * t.gmask).sum(dim=-1), (beta_pad * t.kmask).sum(dim=-1)


def constraint_violations(prob: KinoptProblem, alpha_pad, beta_pad,
                          eps_eq: float = 1e-6):
    """g(x) <= 0 pairs per group, |sum - 1| - eps: (..., 2 n_gp + 2 n_k)."""
    sa, sb = _group_sums(prob, alpha_pad, beta_pad)
    return torch.cat([(sa - 1.0) - eps_eq, (1.0 - sa) - eps_eq,
                      (sb - 1.0) - eps_eq, (1.0 - sb) - eps_eq], dim=-1)


def violation_sq(prob: KinoptProblem, alpha_pad, beta_pad):
    """(alpha_violation^2, beta_violation^2), each (...): NSGA objectives 2
    and 3."""
    sa, sb = _group_sums(prob, alpha_pad, beta_pad)
    return ((sa - 1.0) ** 2).sum(dim=-1), ((sb - 1.0) ** 2).sum(dim=-1)


def estimated_series(prob: KinoptProblem, alpha_pad, beta_pad, *,
                     device=DEFAULT_DEVICE, dtype=None) -> torch.Tensor:
    """:func:`predict` of host arrays (or tensors) on ``device`` (default:
    the card; raises where there is none) at ``dtype`` (default: the
    device's working dtype)."""
    device = resolve_device(device)
    f = dict(dtype=dtype or working_dtype(device), device=device)
    return predict(prob, torch.as_tensor(alpha_pad, **f), torch.as_tensor(beta_pad, **f))
