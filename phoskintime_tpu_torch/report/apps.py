"""Result-explorer apps for kinopt and tfopt fits, as static HTML.

Counterpart of ``phoskintime_tpu/report/apps.py``: each app writes the
identity band, breadth-against-load and control-logic DAG figures, an
interactive single-file explorer (curves, knockouts, the network) and a
report page with the fit statistics, the regulator readout and an exact
knockout preview. The preview re-predicts the algebraic model with each
regulator's alpha entries zeroed: all K regulators in one batched
``predict`` call on ``device`` at float64 (the counterpart of JAX's
``jax.vmap`` over them).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device
from phoskintime_tpu_torch.io.export import rows_to_table, sort_desc
from phoskintime_tpu_torch.io.utils import host, n_rows, take


def _fit_stats(obs: np.ndarray, est: np.ndarray) -> dict:
    resid = est - obs
    ss_res = float(np.sum(resid ** 2))
    ss_tot = float(np.sum((obs - obs.mean()) ** 2))
    return {"rmse": float(np.sqrt(np.mean(resid ** 2))), "mae": float(np.mean(np.abs(resid))),
            "r2": 1.0 - ss_res / max(ss_tot, 1e-12)}


def _matrices(sheets: dict) -> tuple[list, np.ndarray, np.ndarray]:
    tcols = [c for c in sheets["Observed"] if c.startswith("x")]
    obs = np.column_stack([np.asarray(sheets["Observed"][c], float) for c in tcols])
    est = np.column_stack([np.asarray(sheets["Estimated"][c], float) for c in tcols])
    return tcols, obs, est


def _top_edges(alpha: dict, source: str, target, weight: str, top_edges: int) -> dict:
    """The ``top_edges`` strongest edges by |weight| (pandas' quicksort
    descending) as a table (source, target, weight)."""
    w = np.asarray(alpha[weight], float)
    order = sort_desc(np.abs(w))[:top_edges]
    tgt = target if not isinstance(target, str) else np.asarray(alpha[target], dtype=object)
    return {"source": np.asarray(alpha[source], dtype=object)[order],
            "target": np.asarray(tgt, dtype=object)[order], "weight": w[order]}


def _batched(alpha, beta, index, K: int, device):
    """(K, ...) alphas with regulator k's entries zeroed in row k, and the
    betas repeated, on ``device`` at float64."""
    f = dict(dtype=torch.float64, device=resolve_device(device))
    a = torch.as_tensor(host(alpha), **f)
    idx = torch.as_tensor(np.asarray(index), device=f["device"])
    keep = idx[None] != torch.arange(K, device=f["device"])[:, None, None]
    b = torch.as_tensor(host(beta), **f)
    return a[None] * keep, b.expand(K, *b.shape)


def kinopt_knockout_predictions(prob, alpha, beta, device=DEFAULT_DEVICE) -> np.ndarray:
    """(K, n_gp, T): the kinopt prediction with each kinase's alpha entries
    zeroed, one batched ``predict`` on ``device`` at float64."""
    from phoskintime_tpu_torch.kinopt.model import predict

    a, b = _batched(alpha, beta, prob.gp_kin_idx, prob.n_k, device)
    return predict(prob, a, b).cpu().numpy()


def tfopt_knockout_predictions(prob, alpha, beta, device=DEFAULT_DEVICE) -> np.ndarray:
    """(K, n_genes, T): the tfopt prediction with each TF's alpha entries
    zeroed, one batched ``predict`` on ``device`` at float64."""
    from phoskintime_tpu_torch.tfopt.model import predict

    a, b = _batched(alpha, beta, prob.regulators, prob.n_TF, device)
    return predict(prob, a, b).cpu().numpy()


def _knockout_table(names, curves, est_ko, est, key: str, with_max: bool) -> dict:
    rows = []
    for j, k in enumerate(names):
        delta = np.abs(est_ko[j] - est)
        per_curve = delta.mean(axis=1)
        row = {key: k, "total_effect": float(delta.sum())}
        if with_max:
            row["max_site_effect"] = float(per_curve.max())
        row["most_affected"] = curves[int(np.argmax(per_curve))]
        rows.append(row)
    table = rows_to_table(rows)
    return take(table, sort_desc(table["total_effect"]))


def render_kinopt_app(prob, result, out_dir: str, meta=None, top_edges: int = 40,
                      device=DEFAULT_DEVICE) -> str:
    """The kinopt result explorer in ``out_dir``: ``identity_band.png``,
    ``breadth_load.png``, ``network_dag.png``,
    ``kinopt_interactive.html`` and ``kinopt_app.html`` (returned)."""
    from phoskintime_tpu_torch.analysis.network_tools import (kinopt_network_readout,
                                                              plot_breadth_vs_load,
                                                              plot_identity_band,
                                                              plot_network_dag)
    from phoskintime_tpu_torch.io.export import kinopt_sheets
    from phoskintime_tpu_torch.report.html import create_report
    from phoskintime_tpu_torch.report.interactive import write_interactive_explorer

    os.makedirs(out_dir, exist_ok=True)
    sheets = kinopt_sheets(prob, result, meta)
    tcols, obs, est = _matrices(sheets)
    names = [f"{g} {s}" for g, s in zip(sheets["Observed"]["Gene"], sheets["Observed"]["Psite"])]
    readout = kinopt_network_readout(sheets["Alpha Values"], sheets["Beta Values"])
    plot_identity_band(obs.ravel(), est.ravel(), os.path.join(out_dir, "identity_band.png"),
                       labels=np.repeat(names, len(tcols)),
                       title="observed vs reconstructed P(t)")
    plot_breadth_vs_load(readout, os.path.join(out_dir, "breadth_load.png"))

    alpha = sheets["Alpha Values"]
    target = [f"{g} {s}" for g, s in zip(alpha["Gene"], alpha["Psite"])]
    edges = _top_edges(alpha, "Kinase", target, "Alpha", top_edges)
    plot_network_dag(edges, os.path.join(out_dir, "network_dag.png"),
                     title="kinase -> site control logic (top edges)")

    kn = prob.kinase_names or [f"K{j}" for j in range(prob.n_k)]
    est_ko = kinopt_knockout_predictions(prob, result.alpha, result.beta, device)
    ko = _knockout_table(kn, names, est_ko, est, "kinase", with_max=True)
    write_interactive_explorer(
        os.path.join(out_dir, "kinopt_interactive.html"), title="kinopt interactive explorer",
        times=np.arange(1, len(tcols) + 1, dtype=float), curve_names=names, obs=obs, est=est,
        ko_names=kn, ko_est=est_ko, network_edges=edges, source_layer_names=set(kn))
    residuals = sheets["Residuals"]
    tables = {"Fit statistics": rows_to_table([_fit_stats(obs, est)]),
              "Kinase network readout": readout,
              "Knockout preview (exact re-prediction)": ko,
              "Residuals (head)": take(residuals, np.arange(min(30, n_rows(residuals))))}
    return create_report(out_dir, output_file="kinopt_app.html",
                         title="kinopt result explorer", tables=tables)


def render_tfopt_app(prob, result, out_dir: str, top_edges: int = 40,
                     device=DEFAULT_DEVICE) -> str:
    """The tfopt result explorer in ``out_dir``: ``identity_band.png``,
    ``breadth_load.png``, ``network_dag.png``, ``tfopt_interactive.html``
    and ``tfopt_app.html`` (returned)."""
    from phoskintime_tpu_torch.analysis.network_tools import (plot_breadth_vs_load,
                                                              plot_identity_band,
                                                              plot_network_dag,
                                                              tfopt_network_readout)
    from phoskintime_tpu_torch.io.export import tfopt_sheets
    from phoskintime_tpu_torch.report.html import create_report
    from phoskintime_tpu_torch.report.interactive import write_interactive_explorer

    os.makedirs(out_dir, exist_ok=True)
    sheets = tfopt_sheets(prob, result)
    tcols, obs, est = _matrices(sheets)
    genes = list(sheets["Observed"]["mRNA"])
    readout = tfopt_network_readout(sheets["Alpha Values"], sheets["Beta Values"])
    plot_identity_band(obs.ravel(), est.ravel(), os.path.join(out_dir, "identity_band.png"),
                       labels=np.repeat(genes, len(tcols)),
                       title="observed vs reconstructed mRNA(t)")
    plot_breadth_vs_load(readout, os.path.join(out_dir, "breadth_load.png"),
                         breadth_col="n_genes")
    edges = _top_edges(sheets["Alpha Values"], "TF", "mRNA", "Value", top_edges)
    plot_network_dag(edges, os.path.join(out_dir, "network_dag.png"),
                     title="TF -> mRNA control logic (top edges)")

    tfs = prob.tf_ids or [f"TF{i}" for i in range(prob.n_TF)]
    est_ko = tfopt_knockout_predictions(prob, result.alpha, result.beta, device)
    ko = _knockout_table(tfs, genes, est_ko, est, "tf", with_max=False)
    write_interactive_explorer(
        os.path.join(out_dir, "tfopt_interactive.html"), title="tfopt interactive explorer",
        times=np.arange(1, len(tcols) + 1, dtype=float), curve_names=genes, obs=obs, est=est,
        ko_names=tfs, ko_est=est_ko, network_edges=edges, source_layer_names=set(tfs))
    tables = {"Fit statistics": rows_to_table([_fit_stats(obs, est)]),
              "TF network readout": readout,
              "Knockout preview (exact re-prediction)": ko}
    return create_report(out_dir, output_file="tfopt_app.html",
                         title="tfopt result explorer", tables=tables)
