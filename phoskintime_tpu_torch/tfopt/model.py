"""tfopt: TF -> mRNA algebraic optimization model.

Counterpart of ``phoskintime_tpu/tfopt/model.py``:

    R_hat_g(t) = sum_r alpha_{g,r} * [beta_{r,0} * TFprot_r(t)
                                      + sum_k beta_{r,k} * psite_{r,k}(t)]

with per-gene ``sum_r alpha = 1`` (alpha in [0, 1]) and per-TF ``sum beta =
1`` (beta in [lb, ub]; a TF without psites has a single beta, pinned to 1).
Losses 0..6: MSE, MAE, soft-L1, Cauchy, Arctan, Elastic Net (MSE + L1 + L2
on beta), Tikhonov (MSE + L2 on beta).

The regulators are a padded (n_genes, n_reg) index matrix (-1 invalid),
beta a padded (n_TF, 1 + n_psite_max); every function takes alpha (...,
n_genes, n_reg) and beta (..., n_TF, 1 + n_psite_max) tensors with
optional leading axes, so a population is one call; the problem's tensors
are made once per device and dtype (:meth:`TfoptProblem.on`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class TfoptTensors(NamedTuple):
    """A problem's arrays on one device and dtype."""
    R: torch.Tensor           # (n_genes, T) mRNA
    protein: torch.Tensor     # (n_TF, T)
    psites: torch.Tensor      # (n_TF, n_psite_max, T)
    reg_idx: torch.Tensor     # (n_genes, n_reg) regulator index, 0 where none
    amask: torch.Tensor       # (n_genes, n_reg) 0/1
    bmask: torch.Tensor       # (n_TF, 1 + n_psite_max) 0/1


@dataclasses.dataclass
class TfoptProblem:
    mRNA_mat: np.ndarray        # (n_genes, T)
    regulators: np.ndarray      # (n_genes, n_reg) TF indices, -1 = none
    protein_mat: np.ndarray     # (n_TF, T)
    psite_tensor: np.ndarray    # (n_TF, n_psite_max, T) zero-padded
    num_psites: np.ndarray      # (n_TF,)
    gene_ids: list = None
    tf_ids: list = None
    psite_labels: list = None   # per TF
    lb: float = -4.0
    ub: float = 4.0
    _tensors: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    @property
    def n_genes(self):
        return self.mRNA_mat.shape[0]

    @property
    def n_TF(self):
        return self.protein_mat.shape[0]

    @property
    def n_reg(self):
        return self.regulators.shape[1]

    @property
    def n_psite_max(self):
        return self.psite_tensor.shape[1]

    @property
    def no_psite_tf(self):
        return self.num_psites == 0

    @property
    def beta_mask(self) -> np.ndarray:
        """(n_TF, 1 + n_psite_max): protein slot always valid, psite slots
        valid up to num_psites."""
        m = np.zeros((self.n_TF, 1 + self.n_psite_max), bool)
        m[:, 0] = True
        m[:, 1:] = np.arange(self.n_psite_max)[None, :] < self.num_psites[:, None]
        return m

    @property
    def alpha_mask(self) -> np.ndarray:
        return self.regulators >= 0

    @property
    def n_alpha(self):
        return int(self.alpha_mask.sum())

    @property
    def n_beta(self):
        return int(self.beta_mask.sum())

    # flat (reference order: all alphas gene-major, then betas TF-major)
    def pack(self, alpha_pad, beta_pad):
        return np.concatenate([np.asarray(alpha_pad)[self.alpha_mask],
                               np.asarray(beta_pad)[self.beta_mask]])

    def unpack(self, x):
        a = np.zeros(self.alpha_mask.shape)
        b = np.zeros(self.beta_mask.shape)
        a[self.alpha_mask] = np.asarray(x)[: self.n_alpha]
        b[self.beta_mask] = np.asarray(x)[self.n_alpha:self.n_alpha + self.n_beta]
        return a, b

    def on(self, device, dtype) -> TfoptTensors:
        """The problem's tensors on ``device`` at ``dtype``, made once."""
        key = (str(torch.device(device)), dtype)
        if key not in self._tensors:
            f = dict(dtype=dtype, device=device)
            self._tensors[key] = TfoptTensors(
                torch.as_tensor(np.asarray(self.mRNA_mat, float), **f),
                torch.as_tensor(np.asarray(self.protein_mat, float), **f),
                torch.as_tensor(np.asarray(self.psite_tensor, float), **f),
                torch.as_tensor(np.maximum(self.regulators, 0).astype(np.int64),
                                device=device),
                torch.as_tensor(self.alpha_mask, **f), torch.as_tensor(self.beta_mask, **f))
        return self._tensors[key]


def predict(prob: TfoptProblem, alpha_pad: torch.Tensor, beta_pad: torch.Tensor):
    """(..., n_genes, T) predicted expression, clipped >= 0 (a tie at 0
    splits the gradient evenly, as ``jnp.maximum``)."""
    t = prob.on(alpha_pad.device, alpha_pad.dtype)
    beta = beta_pad * t.bmask
    # TF effect: beta_0 * protein + sum_k beta_k * psite_k  -> (..., n_TF, T)
    effect = (beta[..., :1] * t.protein
              + torch.einsum("...fk,fkt->...ft", beta[..., 1:], t.psites))
    eff_sel = effect[..., t.reg_idx, :]                    # (..., n_genes, n_reg, T)
    pred = torch.einsum("...gr,...grt->...gt", alpha_pad * t.amask, eff_sel)
    return torch.maximum(pred, torch.zeros_like(pred))


def tfopt_loss(prob: TfoptProblem, alpha_pad, beta_pad, loss_type: int = 0,
               lam1: float = 1e-6, lam2: float = 1e-6):
    """(...) losses per the reference's loss_type codes 0-6."""
    t = prob.on(alpha_pad.device, alpha_pad.dtype)
    diff = t.R - predict(prob, alpha_pad, beta_pad)
    nT = t.R.numel()
    total = lambda x: x.sum(dim=(-2, -1))

    if loss_type == 1:      # MAE
        val = total(torch.abs(diff))
    elif loss_type == 2:    # soft L1
        val = total(2.0 * (torch.sqrt(1.0 + diff * diff) - 1.0))
    elif loss_type == 3:    # Cauchy
        val = total(torch.log1p(diff * diff))
    elif loss_type == 4:    # Arctan
        val = total(torch.arctan(diff * diff))
    else:                   # MSE (0, 5, 6 base)
        val = total(diff * diff)
    loss = val / nT

    beta = (beta_pad * t.bmask).flatten(-2)
    if loss_type == 5:      # elastic net on beta
        loss = loss + lam1 * torch.abs(beta).sum(dim=-1) + lam2 * (beta * beta).sum(dim=-1)
    elif loss_type == 6:    # Tikhonov — lam1 is the L2 coefficient here,
        # NOT lam2 (the L2 knob of elastic-net above): this mirrors the
        # reference exactly (tfopt/local/objfn/minfn.py:89-91)
        loss = loss + lam1 * (beta * beta).sum(dim=-1)
    return loss


def violation_sq(prob: TfoptProblem, alpha_pad, beta_pad):
    """(alpha_viol^2, beta_viol^2), each (...): evol objectives 2 and 3."""
    t = prob.on(alpha_pad.device, alpha_pad.dtype)
    has_reg = t.amask.sum(dim=-1) > 0
    sa = (alpha_pad * t.amask).sum(dim=-1)
    av = torch.where(has_reg, (sa - 1.0) ** 2, torch.zeros_like(sa)).sum(dim=-1)
    bv = (((beta_pad * t.bmask).sum(dim=-1) - 1.0) ** 2).sum(dim=-1)
    return av, bv
