"""KKT optimality post-checks for the constrained kinopt/tfopt fits.

Counterpart of ``phoskintime_tpu/kinopt/kkt.py``, its numerical part:
after optimization, verify primal feasibility of the sum-to-one
constraints, estimate the Lagrange multipliers and stationarity residuals
from the loss gradient (``torch.autograd``), and count the active box
constraints. The reporting suite (``kkt_suite``, its figures, the LaTeX
tables and the CSV files) belongs to the host layer and raises here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device

_HOST_LAYER = ("the KKT report's figures, LaTeX and CSV files are not ported yet "
               "(ROADMAP.md queue 1 item 8, the host layer): use kkt_check")


class KKTReport(NamedTuple):
    primal_feasible: bool
    max_violation: float
    group_sums_alpha: np.ndarray
    group_sums_beta: np.ndarray
    stationarity_residual: float
    lagrange_alpha: np.ndarray      # per alpha group multiplier estimate
    lagrange_beta: np.ndarray
    n_active_box: int


def kkt_check(prob, alpha_pad: np.ndarray, beta_pad: np.ndarray,
              loss_fn, tol: float = 1e-5, *, device=DEFAULT_DEVICE,
              dtype=torch.float64) -> KKTReport:
    """Evaluate the KKT conditions at (alpha, beta).

    loss_fn: (alpha_pad, beta_pad) tensors -> scalar, differentiable; its
    gradient is taken on ``device`` (default: the card; raises where there
    is none) at ``dtype`` (default float64). The equality multipliers are
    estimated per group as the mean in-group gradient (stationarity
    requires grad - lambda * 1 = 0 on free coordinates); the residual is the
    remaining in-group gradient dispersion over non-active coordinates."""
    alpha_pad = np.asarray(alpha_pad, float)
    beta_pad = np.asarray(beta_pad, float)
    f = dict(dtype=dtype, device=resolve_device(device))
    a = torch.tensor(alpha_pad, **f, requires_grad=True)
    b = torch.tensor(beta_pad, **f, requires_grad=True)
    with torch.enable_grad():
        ga, gb = torch.autograd.grad(loss_fn(a, b), (a, b))
    ga, gb = ga.to("cpu", torch.float64).numpy(), gb.to("cpu", torch.float64).numpy()

    gm, km = prob.gp_mask, prob.k_mask
    sums_a = (alpha_pad * gm).sum(axis=1)
    sums_b = (beta_pad * km).sum(axis=1)
    viol = max(np.abs(sums_a - 1).max(initial=0.0),
               np.abs(sums_b - 1).max(initial=0.0))

    # active box constraints
    act = 0
    for arr, msk in [(alpha_pad, gm), (beta_pad, km)]:
        v = arr[msk]
        act += int(((np.abs(v - prob.lb) < tol) | (np.abs(v - prob.ub) < tol)).sum())

    def group_stats(grad, vals, msk):
        lams, resid = [], 0.0
        for i in range(msk.shape[0]):
            m = msk[i]
            if not m.any():
                lams.append(0.0)
                continue
            free = m & (np.abs(vals[i] - prob.lb) > tol) & (np.abs(vals[i] - prob.ub) > tol)
            g = grad[i][free if free.any() else m]
            lam = float(g.mean())
            lams.append(lam)
            resid = max(resid, float(np.abs(g - lam).max(initial=0.0)))
        return np.asarray(lams), resid

    lam_a, res_a = group_stats(ga, alpha_pad, gm)
    lam_b, res_b = group_stats(gb, beta_pad, km)

    return KKTReport(bool(viol <= tol * 10), float(viol), sums_a, sums_b,
                     float(max(res_a, res_b)), lam_a, lam_b, act)


def _latex_table(summary: dict, caption: str) -> str:
    raise NotImplementedError(_HOST_LAYER)


def plot_constraint_violations(alpha_viol, beta_viol, out_dir,
                               name="constraint_violations.png"):
    raise NotImplementedError(_HOST_LAYER)


def plot_sensitivity_analysis(sens_df, out_dir, name="sensitivity.png"):
    raise NotImplementedError(_HOST_LAYER)


def kkt_suite(prob, result, out_dir, *, loss_type: str = "base",
              include_reg: bool = False, tol: float = 1e-5,
              high_thresh: float = 0.75, logger=None) -> dict:
    raise NotImplementedError(_HOST_LAYER)
