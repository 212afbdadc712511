"""Result exporters: the tables of the global model, the kinopt/tfopt
result workbooks and the per-gene results.

Counterpart of ``phoskintime_tpu/io/export.py``, tables only. A table is a
column dict (:mod:`phoskintime_tpu_torch.io.utils`) where the JAX package
has a DataFrame, and a workbook is written as its CSV fallback: each sheet
lands as ``<stem>_<sheet_slug>.csv``, the names the JAX package writes
without an Excel engine and :func:`phoskintime_tpu_torch.io.load.read_table`
reads back. Rows come in the JAX package's order, sorts included
(:func:`sort_desc` is pandas' ``sort_values(ascending=False)``).

The figure, PDF and video writers of the JAX module (``plot_s_rates_report``,
``plot_gof_solutions``, ``create_convergence_video``,
``save_gene_timeseries_plots``, ``save_all_gene_timeseries`` and the
correlation heatmap) raise ``NotImplementedError`` naming ROADMAP.md item
8d-figures; a function that writes tables beside a figure writes its
tables alone. The HTML writers are in :mod:`phoskintime_tpu_torch.report`.
"""

from __future__ import annotations

import itertools
import json
import os
import re

import numpy as np
import torch

from phoskintime_tpu_torch.config.logconf import setup_logger
from phoskintime_tpu_torch.io.utils import merge_obs_est, take, write_csv

logger = setup_logger()

PENDING_FIGURES = ("figures, PDF and video output are not ported yet "
                   "(ROADMAP.md queue 1 item 8d-figures)")


def figures_pending(*_args, **_kwargs):
    """Every figure writer of the port until item 8d-figures: raises."""
    raise NotImplementedError(PENDING_FIGURES)


def host(x) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, float)


class TableWriter:
    """Multi-sheet writer: every sheet a CSV file beside the workbook's
    path (``<stem>_<slug>.csv``)."""

    def __init__(self, path: str):
        self.path = str(path)
        self.sheets: dict[str, dict] = {}

    def add(self, sheet_name: str, table: dict):
        self.sheets[sheet_name] = table

    def save(self) -> list[str]:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        written = []
        for name, table in self.sheets.items():
            slug = re.sub(r"\W+", "_", name.strip().lower())
            written.append(write_csv(re.sub(r"\.xlsx?$", f"_{slug}.csv", self.path), table))
        logger.info(f"[Export] wrote {len(written)} CSVs for {self.path}")
        return written


# ---------------------------------------------------------------------------
# table helpers: pandas' orders on column dicts
# ---------------------------------------------------------------------------

def sort_desc(values) -> np.ndarray:
    """The row order of pandas' ``sort_values(ascending=False)`` on one
    column: its quicksort of the reversed values, reversed, NaN last."""
    v = np.asarray(values, float)
    idx = np.arange(len(v))
    nan = np.isnan(v)
    kept, kept_idx = v[~nan][::-1], idx[~nan][::-1]
    return np.concatenate([kept_idx[kept.argsort(kind="quicksort")][::-1], idx[nan]])


def sort_asc(values) -> np.ndarray:
    """The row order of pandas' ``sort_values()`` on one column
    (quicksort, NaN last)."""
    v = np.asarray(values, float)
    idx = np.arange(len(v))
    nan = np.isnan(v)
    return np.concatenate([idx[~nan][v[~nan].argsort(kind="quicksort")], idx[nan]])


def sort_by(table: dict, keys) -> dict:
    """The table sorted ascending by several columns, stably (pandas'
    lexsort of a multi-column ``sort_values``)."""
    return take(table, np.lexsort([np.asarray(table[k], float) for k in reversed(keys)]))


def rows_to_table(rows: list[dict], columns=None) -> dict:
    """Records as a column dict: the columns in order of first appearance
    (or ``columns``), a missing cell NaN (pandas' ``DataFrame(rows)``)."""
    if columns is None:
        columns = list(dict.fromkeys(k for r in rows for k in r))
    return {c: _column([r.get(c, np.nan) for r in rows]) for c in columns}


def _column(values: list) -> np.ndarray:
    if values and all(isinstance(v, (bool, np.bool_)) for v in values):
        return np.asarray(values, bool)
    if values and all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
                      for v in values):
        return np.asarray(values, np.int64)
    if all(isinstance(v, (int, float, np.integer, np.floating)) for v in values):
        return np.asarray(values, float)
    return np.asarray(values, dtype=object)


def _np_params(params: dict) -> dict:
    return {k: host(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# global-model exports
# ---------------------------------------------------------------------------

def export_pareto(path, pareto_X, pareto_F, param_labels=None):
    """Every Pareto solution and its objectives: sheets Objectives and
    Solutions, each with a leading ``solution`` column."""
    F, X = host(pareto_F), host(pareto_X)
    w = TableWriter(path)
    w.add("Objectives", {"solution": np.arange(len(F)),
                         **{c: F[:, i] for i, c in
                            enumerate(["obj_protein", "obj_rna", "obj_phospho"])}})
    cols = (param_labels if param_labels is not None
            else [f"theta_{i}" for i in range(X.shape[1])])
    w.add("Solutions", {"solution": np.arange(len(X)), **{c: X[:, i] for i, c in enumerate(cols)}})
    return w.save()


def export_trajectories(path, df_prot, df_rna, df_pho,
                        obs_prot=None, obs_rna=None, obs_pho=None):
    """Predicted (and observed) trajectories per modality."""
    w = TableWriter(path)
    w.add("Pred Protein", df_prot)
    w.add("Pred RNA", df_rna)
    w.add("Pred Phospho", df_pho)
    for name, table in (("Obs Protein", obs_prot), ("Obs RNA", obs_rna),
                        ("Obs Phospho", obs_pho)):
        if table is not None:
            w.add(name, table)
    return w.save()


def export_global_params(path, topo, params: dict):
    """Fitted physical parameters with their labels: rows (param, entity,
    detail, value)."""
    p = _np_params(params)
    rows = [("c_k", name, "", float(p["c_k"][k])) for k, name in enumerate(topo.kinases)]
    for i, prot in enumerate(topo.proteins):
        for key, label in [("A_i", "synthesis"), ("B_i", "mRNA_deg"),
                           ("C_i", "translation"), ("D_i", "protein_deg"),
                           ("E_i", "dephospho")]:
            rows.append((key, prot, label, float(p[key][i])))
        for j, site in enumerate(topo.sites[i]):
            rows.append(("Dp_i", prot, site, float(p["Dp_i"][i, j])))
    rows.append(("tf_scale", "GLOBAL", "", float(p["tf_scale"])))
    w = TableWriter(path)
    w.add("Parameters", rows_to_table([dict(zip(("param", "entity", "detail", "value"), r))
                                       for r in rows], ["param", "entity", "detail", "value"]))
    return w.save()


def export_kinase_activities(path, topo, params, Kmat, grid):
    """Kinase activity series K(t) * c_k, one column per grid time."""
    act = host(Kmat) * host(params["c_k"])[:, None]
    table = {"kinase": np.asarray(topo.kinases, dtype=object)}
    table.update({f"t{g:g}": act[:, j] for j, g in enumerate(np.asarray(grid, float))})
    w = TableWriter(path)
    w.add("Kinase Activity", table)
    return w.save()


def export_residuals(path, df_obs, df_pred, keys):
    """Observed beside predicted, joined on ``keys`` and time (each
    observed row in order), with the residual fc - pred_fc."""
    w = TableWriter(path)
    w.add("Residuals", merge_obs_est(df_obs, df_pred, list(keys) + ["time"]))
    return w.save()


def _softplus(x: np.ndarray) -> np.ndarray:
    from phoskintime_tpu_torch.network.params import softplus

    return softplus(torch.as_tensor(x, dtype=torch.float64)).numpy()


def export_param_distributions(path, pareto_X, slices, topo):
    """Mean, std, min and max of each parameter group's physical values
    over the Pareto set."""
    X = host(pareto_X)
    rows = []
    for key, sl in slices.items():
        vals = _softplus(X[:, sl])
        rows.append({"param": key, "mean": vals.mean(), "std": vals.std(),
                     "min": vals.min(), "max": vals.max()})
    w = TableWriter(path)
    w.add("Param Distributions", rows_to_table(rows, ["param", "mean", "std", "min", "max"]))
    return w.save()


def export_param_correlations(path, pareto_X, slices, topo, heatmap_path=None):
    """The correlation matrix of the physical parameters over the Pareto
    set (a row per parameter, its label in ``param``). The heatmap waits
    for item 8d-figures: a ``heatmap_path`` raises."""
    if heatmap_path is not None:
        figures_pending()
    phys = _softplus(host(pareto_X))
    labels = [f"c_k[{k}]" for k in topo.kinases]
    for key in ("A_i", "B_i", "C_i", "D_i"):
        labels += [f"{key}[{p}]" for p in topo.proteins]
    labels += [f"Dp_i[{p}:{s}]" for i, p in enumerate(topo.proteins) for s in topo.sites[i]]
    labels += [f"E_i[{p}]" for p in topo.proteins] + ["tf_scale"]
    labels = labels[: phys.shape[1]]
    if len(phys) >= 3:
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.nan_to_num(np.corrcoef(phys, rowvar=False))
    else:
        corr = np.eye(phys.shape[1])
    table = {"param": np.asarray(labels, dtype=object)}
    table.update({lbl: corr[:, j] for j, lbl in enumerate(labels)})
    w = TableWriter(path)
    w.add("Param Correlations", table)
    return w.save()


def export_S_rates(system, params, output_dir, filename="S_rates_picked.csv", long=True):
    """Per-site phosphorylation drive S(t) = W . (K(t) c_k) at ``params``,
    one value per (site, kinase-grid time): long (protein, psite, time, S)
    or wide (protein, psite, S_t...). Returns the table."""
    os.makedirs(output_dir, exist_ok=True)
    topo = system.topo
    K_scaled = host(system.Kmat) * host(params["c_k"])[:, None]
    S_pad = np.einsum("nsk,kt->nst", np.asarray(topo.W_pad, float), K_scaled)
    times = np.asarray(system.kin_grid, float)
    proteins = [p for i, p in enumerate(topo.proteins) for _ in topo.sites[i]]
    psites = [s for i in range(topo.N) for s in topo.sites[i]]
    S_mat = (np.stack([S_pad[i, j] for i in range(topo.N) for j in range(len(topo.sites[i]))])
             if psites else np.zeros((0, len(times))))
    if long:
        n_sites, n_bins = S_mat.shape
        table = {"protein": np.repeat(np.asarray(proteins, dtype=object), n_bins),
                 "psite": np.repeat(np.asarray(psites, dtype=object), n_bins),
                 "time": np.tile(times, n_sites), "S": S_mat.reshape(-1)}
    else:
        table = {"protein": np.asarray(proteins, dtype=object),
                 "psite": np.asarray(psites, dtype=object)}
        table.update({f"S_t{t:g}": S_mat[:, j] for j, t in enumerate(times)})
    out_path = os.path.join(output_dir, filename)
    write_csv(out_path, table)
    logger.info(f"[Export] Saved S rates to: {out_path}")
    return table


plot_s_rates_report = figures_pending


def scan_prior_reg(out_dir):
    """The lambda-weight scan over the saved Pareto front
    (``out_dir/pareto_F.npy``): for every (lambda_prot, lambda_rna,
    lambda_phospho) on a 9-point log grid and every lambda_prior, the front
    member with the least weighted score. Writes ``lambda_scan.csv``, its
    first row of each pick (``lambda_scan_unique_picks.csv``) and the
    recommended pick (``lambda_scan_recommended.json``). Returns the two
    tables and the recommendation."""
    F = np.load(os.path.join(out_dir, "pareto_F.npy"))
    if F.ndim != 2 or F.shape[1] != 3:
        raise ValueError(f"Expected F shape (n, 3); got {F.shape}")
    lam_grid = np.logspace(-2, 2, 9)
    lam_prior_grid = np.logspace(-4, 0, 9)
    combos = np.asarray(list(itertools.product(lam_grid, lam_grid, lam_grid)))
    base = combos @ F.T.astype(float)
    best_i = base.argmin(axis=1)
    base_best = base[np.arange(len(base)), best_i]
    c = np.repeat(np.arange(len(combos)), len(lam_prior_grid))
    lprior = np.tile(lam_prior_grid, len(combos))
    table = {"lambda_prot": combos[c, 0], "lambda_rna": combos[c, 1],
             "lambda_phospho": combos[c, 2], "lambda_prior": lprior,
             "best_i": best_i[c].astype(np.int64), "best_score": lprior * base_best[c],
             "prot_mse": F[best_i[c], 0].astype(float), "rna_mse": F[best_i[c], 1].astype(float),
             "phospho_mse": F[best_i[c], 2].astype(float)}
    table = sort_by(table, ["lambda_prot", "lambda_rna", "lambda_phospho", "lambda_prior"])
    write_csv(os.path.join(out_dir, "lambda_scan.csv"), table)
    _, first = np.unique(table["best_i"], return_index=True)
    uniq = take(table, np.sort(first))
    write_csv(os.path.join(out_dir, "lambda_scan_unique_picks.csv"), uniq)
    cand = {k: v[0] for k, v in sort_by(uniq, ["prot_mse", "rna_mse", "phospho_mse"]).items()}
    rec = {
        "lambda_prot": float(cand["lambda_prot"]),
        "lambda_rna": float(cand["lambda_rna"]),
        "lambda_phospho": float(cand["lambda_phospho"]),
        "lambda_prior": float(cand["lambda_prior"]),
        "best_i": int(cand["best_i"]),
        "objectives": {"prot_mse": float(cand["prot_mse"]),
                       "rna_mse": float(cand["rna_mse"]),
                       "phospho_mse": float(cand["phospho_mse"])},
        "note": "lambda_prior is a global multiplier; it does not change "
                "best_i for fixed F (only rescales best_score).",
    }
    with open(os.path.join(out_dir, "lambda_scan_recommended.json"), "w") as fh:
        json.dump(rec, fh, indent=2)
    logger.info("[Export] Lambda scan complete.")
    return table, uniq, rec


def export_pareto_trajectories(system, slices, pareto_X, t_points, path, top_idx=None):
    """Predicted fold-change trajectories of Pareto members ``top_idx``
    (default: all) on the union of the ``t_points`` grids: sheets summary
    (sol_id), traj_protein, traj_rna (sol_id, protein, time, pred_fc) and
    traj_phospho (with psite). One batched ETD2RK simulation of every
    member requested, on the system's device and dtype (the table kernel
    on the card)."""
    from phoskintime_tpu_torch.network.expo import exponential_simulate_batched
    from phoskintime_tpu_torch.network.params import unpack_params
    from phoskintime_tpu_torch.network.simulate import extract_observables, fold_changes

    topo = system.topo
    X = host(pareto_X)
    top_idx = np.arange(len(X)) if top_idx is None else np.asarray(top_idx, int)
    times = np.unique(np.concatenate([np.asarray(t, float) for t in t_points]))
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device)
    params_b = unpack_params(torch.as_tensor(X[top_idx], **f), slices, topo)
    ys, _ = exponential_simulate_batched(system, params_b, times)
    fc_r, fc_p, fc_ph = (host(a) for a in fold_changes(extract_observables(system, ys), times))

    T = len(times)
    blocks_p, blocks_ph = [], []
    for s, sid in enumerate(top_idx):
        for i, prot in enumerate(topo.proteins):
            blocks_p.append((int(sid), prot, s, i))
            blocks_ph += [(int(sid), prot, site, s, i, j) for j, site in enumerate(topo.sites[i])]

    def traj(fc):
        return {"sol_id": np.repeat([b[0] for b in blocks_p], T).astype(np.int64),
                "protein": np.repeat(np.asarray([b[1] for b in blocks_p], dtype=object), T),
                "time": np.tile(times, len(blocks_p)),
                "pred_fc": np.concatenate([fc[s, :, i] for _, _, s, i in blocks_p]
                                          + [np.zeros(0)])}
    pho = {"sol_id": np.repeat([b[0] for b in blocks_ph], T).astype(np.int64),
           "protein": np.repeat(np.asarray([b[1] for b in blocks_ph], dtype=object), T),
           "psite": np.repeat(np.asarray([b[2] for b in blocks_ph], dtype=object), T),
           "time": np.tile(times, len(blocks_ph)),
           "pred_fc": np.concatenate([fc_ph[s, :, i, j] for *_, s, i, j in blocks_ph]
                                     + [np.zeros(0)])}
    w = TableWriter(path)
    w.add("summary", {"sol_id": top_idx.astype(np.int64)})
    w.add("traj_protein", traj(fc_p))
    w.add("traj_rna", traj(fc_r))
    w.add("traj_phospho", pho)
    return w.save()


plot_gof_solutions = figures_pending


def process_convergence_history(history, output_dir):
    """The per-generation least objectives as ``convergence_history.csv``
    (gen, min_prot_mse, min_rna_mse, min_phos_mse); returns the table, or
    None without a history. Its log-scale plot waits for item 8d-figures."""
    if not history:
        logger.info("[Export] no convergence history; skipping")
        return None
    mins = np.stack([np.atleast_1d(np.asarray(h[1], float)) for h in history])
    cols = ["min_prot_mse", "min_rna_mse", "min_phos_mse"][: mins.shape[1]]
    table = {"gen": np.asarray([int(h[0]) for h in history], np.int64)}
    table.update({c: mins[:, j] for j, c in enumerate(cols)})
    os.makedirs(output_dir, exist_ok=True)
    write_csv(os.path.join(output_dir, "convergence_history.csv"), table)
    logger.info("[Export] Saved convergence history.")
    return table


create_convergence_video = figures_pending
save_gene_timeseries_plots = figures_pending
save_all_gene_timeseries = figures_pending


# ---------------------------------------------------------------------------
# kinopt / tfopt result workbooks
# ---------------------------------------------------------------------------

def _with_names(columns: dict, values: np.ndarray, tcols) -> dict:
    out = dict(columns)
    out.update({c: values[:, j] for j, c in enumerate(tcols)})
    return out


def kinopt_sheets(prob, result, meta=None) -> dict:
    """Observed, Estimated, Alpha Values, Beta Values and Residuals as
    tables (the Alpha/Beta sheets are what the global model reads back as
    priors); the estimate on the CPU at float64."""
    from phoskintime_tpu_torch.kinopt.model import predict

    f = dict(dtype=torch.float64)
    est = predict(prob, torch.as_tensor(host(result.alpha), **f),
                  torch.as_tensor(host(result.beta), **f)).numpy()
    obs = np.asarray(prob.P_obs, float)
    tcols = [f"x{i + 1}" for i in range(obs.shape[1])]
    names = prob.gp_names or [(f"G{i}", f"S{i}") for i in range(prob.n_gp)]
    ids = {"Gene": np.asarray([g for g, _ in names], dtype=object),
           "Psite": np.asarray([s for _, s in names], dtype=object)}
    kn = prob.kinase_names or [f"K{j}" for j in range(prob.n_k)]

    alpha_rows = [{"Gene": g, "Psite": s, "Kinase": kn[prob.gp_kin_idx[i, c]],
                   "Alpha": float(result.alpha[i, c])}
                  for i, (g, s) in enumerate(names)
                  for c in range(prob.gp_mask.shape[1]) if prob.gp_mask[i, c]]
    kidx = (meta or {}).get("K_index", {})
    beta_rows = []
    for j, k in enumerate(kn):
        labels = [lbl for lbl, _ in kidx.get(k, [])]
        for c in range(prob.k_mask.shape[1]):
            if prob.k_mask[j, c]:
                beta_rows.append({"Kinase": k, "Psite": labels[c] if c < len(labels)
                                  else f"P{c + 1}", "Beta": float(result.beta[j, c])})
    # the per-kinase global betas (Psite empty): each kinase's sum, sorted
    totals: dict = {}
    for r in beta_rows:
        totals[r["Kinase"]] = totals.get(r["Kinase"], 0.0) + r["Beta"]
    beta_rows += [{"Kinase": k, "Psite": "", "Beta": totals[k]} for k in sorted(totals)]
    cols = ["Kinase", "Psite", "Beta"]
    return {"Observed": _with_names(ids, obs, tcols),
            "Estimated": _with_names(ids, est, tcols),
            "Alpha Values": rows_to_table(alpha_rows, ["Gene", "Psite", "Kinase", "Alpha"]),
            "Beta Values": rows_to_table(beta_rows, cols),
            "Residuals": _with_names(ids, obs - est, tcols)}


def export_kinopt_results(path, prob, result, meta=None):
    """The kinopt workbook: :func:`kinopt_sheets` and the time-resolved
    network readout (kinase load, edge load, target fragility, knockout
    effects)."""
    from phoskintime_tpu_torch.analysis.network_tools import kinopt_signal_readout

    w = TableWriter(path)
    for name, table in kinopt_sheets(prob, result, meta).items():
        w.add(name, table)
    for name, table in kinopt_signal_readout(prob, result.alpha, result.beta).items():
        w.add(name, table)
    return w.save()


def tfopt_sheets(prob, result) -> dict:
    """Observed, Estimated, Alpha Values (mRNA, TF, Value) and Beta Values
    (TF, PSite, Value) in the global model's prior schema; the estimate on
    the CPU at float64."""
    from phoskintime_tpu_torch.tfopt.model import predict

    f = dict(dtype=torch.float64)
    est = predict(prob, torch.as_tensor(host(result.alpha), **f),
                  torch.as_tensor(host(result.beta), **f)).numpy()
    tcols = [f"x{i + 1}" for i in range(prob.mRNA_mat.shape[1])]
    genes = prob.gene_ids or [f"G{i}" for i in range(prob.n_genes)]
    tfs = prob.tf_ids or [f"TF{i}" for i in range(prob.n_TF)]
    ids = {"mRNA": np.asarray(genes, dtype=object)}
    alpha_rows = [{"mRNA": genes[g], "TF": tfs[prob.regulators[g, r]],
                   "Value": float(result.alpha[g, r])}
                  for g in range(prob.n_genes) for r in range(prob.n_reg)
                  if prob.regulators[g, r] >= 0]
    beta_rows = []
    for f_ in range(prob.n_TF):
        beta_rows.append({"TF": tfs[f_], "PSite": "", "Value": float(result.beta[f_, 0])})
        labels = prob.psite_labels[f_] if prob.psite_labels else []
        for k in range(int(prob.num_psites[f_])):
            beta_rows.append({"TF": tfs[f_], "PSite": labels[k] if k < len(labels)
                              else f"S{k + 1}", "Value": float(result.beta[f_, 1 + k])})
    return {"Observed": _with_names(ids, np.asarray(prob.mRNA_mat, float), tcols),
            "Estimated": _with_names(ids, est, tcols),
            "Alpha Values": rows_to_table(alpha_rows, ["mRNA", "TF", "Value"]),
            "Beta Values": rows_to_table(beta_rows, ["TF", "PSite", "Value"])}


def export_tfopt_results(path, prob, result):
    """The tfopt workbook: :func:`tfopt_sheets` and the TF-load /
    gene-fragility / knockout readout."""
    from phoskintime_tpu_torch.analysis.network_tools import tfopt_signal_readout

    w = TableWriter(path)
    for name, table in tfopt_sheets(prob, result).items():
        w.add(name, table)
    for name, table in tfopt_signal_readout(prob, result.alpha, result.beta).items():
        w.add(name, table)
    return w.save()


# ---------------------------------------------------------------------------
# per-gene results
# ---------------------------------------------------------------------------

def export_gene_results(path, gene_results: dict):
    """The per-gene fitted parameters and errors: sheet Results, a row a
    gene (gene, error, score, lambda, weight, reg_term, p0...)."""
    rows = []
    for gene, res in gene_results.items():
        row = {"gene": gene, "error": res.error, "score": res.score,
               "lambda": res.lambda_reg, "weight": res.weight_name,
               "reg_term": res.regularization_term}
        row.update({f"p{i}": float(v) for i, v in enumerate(np.asarray(res.params))})
        rows.append(row)
    w = TableWriter(path)
    w.add("Results", rows_to_table(rows))
    return w.save()

