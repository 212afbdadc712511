"""KKT optimality post-checks for the constrained kinopt/tfopt fits.

Counterpart of ``phoskintime_tpu/kinopt/kkt.py``, its numerical part:
after optimization, verify primal feasibility of the sum-to-one
constraints, estimate the Lagrange multipliers and stationarity residuals
from the loss gradient (``torch.autograd``), and count the active box
constraints; :func:`kkt_suite` writes the report's tables (JSON, CSV and
LaTeX) and its two figures (the constraint violations and the
sensitivities), drawn by the port's own drawing layer.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device
from phoskintime_tpu_torch.io.export import sort_asc, sort_desc
from phoskintime_tpu_torch.io.utils import take, write_csv


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
    """A two-column Metric/Value LaTeX table."""
    lines = ["\\begin{table}[H]", "\\centering",
             "\\begin{tabular}{|l|c|}\\hline",
             "Metric & Value \\\\ \\hline"]
    for k, v in summary.items():
        lines.append(f"{k} & {v} \\\\ \\hline")
    lines += ["\\end{tabular}", f"\\caption{{{caption}}}", "\\end{table}"]
    return "\n".join(lines) + "\n"


def plot_constraint_violations(alpha_viol: dict, beta_viol: dict, out_dir,
                               name="constraint_violations.png"):
    """Each protein's |group sum - 1| as stacked bars, alpha under beta, the
    five largest totals in red. ``alpha_viol``: {(gene, psite) or gene:
    violation} (summed over a gene's sites); ``beta_viol``: {kinase:
    violation}; the proteins of either, sorted, in order of their total."""
    from phoskintime_tpu_torch.analysis.fitpanels import group_sum
    from phoskintime_tpu_torch.report.draw import subplots

    keys = [k[0] if isinstance(k, tuple) else k for k in alpha_viol]
    genes, a_sum = group_sum(keys, np.abs(np.asarray(list(alpha_viol.values()), float)))
    a = dict(zip(genes, a_sum))
    b = {k: abs(float(v)) for k, v in beta_viol.items()}
    idx = sorted(set(a) | set(b))
    av = np.asarray([a.get(g, 0.0) for g in idx])
    bv = np.asarray([b.get(g, 0.0) for g in idx])
    order = sort_asc(av + bv)
    idx, av, bv = [idx[i] for i in order], av[order], bv[order]
    top = set(idx[-5:])

    fig, ax = subplots(figsize=(8, 8))
    ax.bar(idx, av, color=["red" if g in top else "dodgerblue" for g in idx], label=r"$\alpha$")
    ax.bar(idx, bv, bottom=av, color=["red" if g in top else "lightgreen" for g in idx],
           label=r"$\beta$")
    ax.set_xlabel("Proteins")
    ax.set_ylabel("Constraint Violations")
    ax.tick_params(axis="x", rotation=45)
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=150)
    return path


def plot_sensitivity_analysis(sens: dict, out_dir, name="sensitivity.png"):
    """Each protein's mean of its sites' min, mean and max sensitivity as
    stacked horizontal bars, in order of the mean. ``sens``: the table
    :func:`kkt_suite` returns (GeneID, Sensitivity Mean, Max Sensitivity,
    Min Sensitivity)."""
    from phoskintime_tpu_torch.analysis.fitpanels import group_sum
    from phoskintime_tpu_torch.report.draw import subplots

    keys = [str(g) for g in sens["GeneID"]]
    genes, mean = group_sum(keys, sens["Sensitivity Mean"], mean=True)
    _, hi = group_sum(keys, sens["Max Sensitivity"], mean=True)
    _, lo = group_sum(keys, sens["Min Sensitivity"], mean=True)
    order = sort_asc(mean)
    genes, mean, hi, lo = [genes[i] for i in order], mean[order], hi[order], lo[order]
    fig, ax = subplots(figsize=(8, 8))
    ax.barh(genes, lo, color="lightgreen", label="Min")
    ax.barh(genes, mean, left=lo, color="dodgerblue", label="Mean")
    ax.barh(genes, hi, left=lo + mean, color="coral", label="Max")
    ax.set_xlabel("Sensitivity")
    ax.set_ylabel("Proteins")
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=150)
    return path


def kkt_suite(prob, result, out_dir, *, loss_type: str = "base",
              include_reg: bool = False, tol: float = 1e-5,
              high_thresh: float = 0.75, logger=None, device=DEFAULT_DEVICE) -> dict:
    """The post-optimization KKT report of a kinopt fit, written to
    ``out_dir``: ``kkt_summary.tex`` (residual, sensitivity and
    stationarity tables), ``active_constraints.csv``,
    ``lagrange_multipliers.csv``, ``high_sensitivity_sites.csv`` and
    ``kkt_report.json``, and the figures ``constraint_violations.png`` and
    ``sensitivity.png``. The loss gradient is taken on ``device``. Returns
    {"report", "paths", "sensitivity"}."""
    from phoskintime_tpu_torch.kinopt.model import kinopt_loss, predict

    os.makedirs(out_dir, exist_ok=True)
    alpha = np.asarray(result.alpha, float)
    beta = np.asarray(result.beta, float)
    rep = kkt_check(prob, alpha, beta,
                    lambda a, b: kinopt_loss(prob, a, b, loss_type, include_reg),
                    tol=tol, device=device)

    names = prob.gp_names or [(f"G{i}", f"S{i}") for i in range(prob.n_gp)]
    kn = prob.kinase_names or [f"K{j}" for j in range(prob.n_k)]
    genes = [g for g, _ in names]
    psites = [s for _, s in names]

    f = dict(dtype=torch.float64)
    est = predict(prob, torch.as_tensor(alpha, **f), torch.as_tensor(beta, **f)).numpy()
    obs = np.asarray(prob.P_obs, float)
    residuals = obs - est
    grads = np.gradient(residuals, axis=1)
    residuals_summary = {
        "Max Residual": round(float(residuals.max()), 2),
        "Min Residual": round(float(residuals.min()), 2),
        "Mean Residual": round(float(residuals.mean()), 2),
        "Max Gradient": round(float(grads.max()), 2),
        "Min Gradient": round(float(grads.min()), 2),
        "Mean Gradient": round(float(grads.mean()), 2),
    }
    sensitivity_summary = {
        "Max Sensitivity": round(float(obs.max()), 2),
        "Min Sensitivity": round(float(obs.min()), 2),
        "Mean Sensitivity": round(float(obs.mean()), 2),
    }
    stationarity_summary = {
        "Primal feasible": rep.primal_feasible,
        "Max constraint violation": f"{rep.max_violation:.3e}",
        "Stationarity residual": f"{rep.stationarity_residual:.3e}",
        "Active box constraints": rep.n_active_box,
    }
    sens = {"GeneID": np.asarray(genes, dtype=object), "Psite": np.asarray(psites, dtype=object),
            "Sensitivity Mean": obs.mean(axis=1), "Max Sensitivity": obs.max(axis=1),
            "Min Sensitivity": obs.min(axis=1)}

    def bound_of(v):
        return "lb" if abs(v - prob.lb) < tol else "ub" if abs(v - prob.ub) < tol else None

    act_rows = [("alpha", g, s, kn[prob.gp_kin_idx[i, c]], float(alpha[i, c]),
                 bound_of(alpha[i, c]))
                for i, (g, s) in enumerate(names) for c in range(prob.gp_mask.shape[1])
                if prob.gp_mask[i, c] and bound_of(alpha[i, c])]
    act_rows += [("beta", k, f"P{c + 1}", "", float(beta[j, c]), bound_of(beta[j, c]))
                 for j, k in enumerate(kn) for c in range(prob.k_mask.shape[1])
                 if prob.k_mask[j, c] and bound_of(beta[j, c])]
    act = {c: np.asarray([r[k] for r in act_rows], float if c == "value" else object)
           for k, c in enumerate(["block", "group", "member", "kinase", "value", "bound"])}

    mult = np.concatenate([rep.lagrange_alpha, rep.lagrange_beta])
    lam = take({"constraint": np.asarray([f"sum_alpha[{g}_{s}]" for g, s in names]
                                         + [f"sum_beta[{k}]" for k in kn], dtype=object),
                "multiplier": mult}, sort_desc(np.abs(mult)))

    high_idx = np.where((obs >= high_thresh).any(axis=1))[0]
    high = {"Gene": np.asarray([genes[i] for i in high_idx], dtype=object),
            "Psite": np.asarray([psites[i] for i in high_idx], dtype=object),
            "Max value": obs[high_idx].max(axis=1) if len(high_idx) else np.zeros(0)}

    a_viol = {name: float(v) for name, v in zip(map(tuple, names),
                                                rep.group_sums_alpha - 1.0)}
    b_viol = {k: float(rep.group_sums_beta[j] - 1.0) for j, k in enumerate(kn)}
    paths = {"violations_png": plot_constraint_violations(a_viol, b_viol, out_dir),
             "sensitivity_png": plot_sensitivity_analysis(sens, out_dir),
             "tex": os.path.join(out_dir, "kkt_summary.tex")}
    with open(paths["tex"], "w") as fh:
        fh.write(_latex_table(residuals_summary, "Residual Summary")
                 + _latex_table(sensitivity_summary, "Sensitivity Summary")
                 + _latex_table(stationarity_summary, "KKT Stationarity Summary"))
    for fname, table in [("active_constraints.csv", act), ("lagrange_multipliers.csv", lam),
                         ("high_sensitivity_sites.csv", high)]:
        paths[fname.split(".")[0]] = write_csv(os.path.join(out_dir, fname), table)
    paths["json"] = os.path.join(out_dir, "kkt_report.json")
    with open(paths["json"], "w") as fh:
        json.dump({"primal_feasible": bool(rep.primal_feasible),
                   "max_violation": float(rep.max_violation),
                   "stationarity_residual": float(rep.stationarity_residual),
                   "n_active_box": int(rep.n_active_box),
                   "residuals": residuals_summary,
                   "sensitivity": sensitivity_summary}, fh, indent=1)
    if logger is not None:
        for k, v in {**residuals_summary, **stationarity_summary}.items():
            logger.info(f"[KKT] {k}: {v}")
    return {"report": rep, "paths": paths, "sensitivity": sens}
