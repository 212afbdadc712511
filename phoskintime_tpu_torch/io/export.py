"""Result exporters: the tables of the global model, the kinopt/tfopt
result workbooks and the per-gene results.

Counterpart of ``phoskintime_tpu/io/export.py``, tables only. A table is a
column dict (:mod:`phoskintime_tpu_torch.io.utils`) where the JAX package
has a DataFrame, and a workbook is written as its CSV fallback: each sheet
lands as ``<stem>_<sheet_slug>.csv``, the names the JAX package writes
without an Excel engine and :func:`phoskintime_tpu_torch.io.load.read_table`
reads back. Rows come in the JAX package's order, sorts included
(:func:`sort_desc` is pandas' ``sort_values(ascending=False)``).

The figure, PDF and video writers (``plot_s_rates_report``,
``plot_gof_solutions``, the convergence plot, ``create_convergence_video``,
``save_gene_timeseries_plots``, ``save_all_gene_timeseries`` and the
correlation heatmap) draw with the port's own drawing layer
(:mod:`phoskintime_tpu_torch.report.draw`): the JAX writers' figure sizes,
dpi, axes, data, colours and labels, the port's pixels. The animation is
always an animated GIF (the JAX writer's route where ffmpeg is missing).
The HTML writers are in :mod:`phoskintime_tpu_torch.report`.
"""

from __future__ import annotations

import itertools
import json
import os
import re

import numpy as np
import torch

from phoskintime_tpu_torch.config.logconf import setup_logger
from phoskintime_tpu_torch.io.utils import (as_numbers, host, is_missing, merge_obs_est,
                                            n_rows, read_csv, take, write_csv)

logger = setup_logger()

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
    set (a row per parameter, its label in ``param``), and with a
    ``heatmap_path`` its heatmap (RdBu_r over [-1, 1]) where there are at
    most 200 parameters. Returns the paths written."""
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
    written = w.save()
    if heatmap_path is not None and corr.shape[0] <= 200:
        from phoskintime_tpu_torch.report.draw import subplots

        fig, ax = subplots(figsize=(8, 7))
        im = ax.imshow(corr, cmap="RdBu_r", vmin=-1, vmax=1)
        ax.set_title("parameter correlations across Pareto ensemble")
        fig.colorbar(im, ax=ax, shrink=0.8)
        fig.savefig(heatmap_path, dpi=110, bbox_inches="tight")
        written.append(heatmap_path)
    return written


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


def _group_mean(keys: list, values: np.ndarray) -> tuple[list, np.ndarray]:
    """pandas' ``groupby(keys).mean()`` of ``values`` by key tuples: the
    sorted distinct keys and each one's mean."""
    groups: dict = {}
    for key, v in zip(keys, values):
        groups.setdefault(key, []).append(v)
    out = sorted(groups)
    return out, np.asarray([np.mean(groups[k]) for k in out], float)


def _cell_text(v) -> str:
    """A cell as pandas' ``str`` shows it (a numpy scalar as its value)."""
    return str(v.item() if isinstance(v, np.generic) else v)


def plot_s_rates_report(csv_path, out_pdf, *, log_x=True, top_k_sites_per_protein=24,
                        max_sites_per_page=12, ncols=3, heatmap_per_protein=True,
                        heatmap_cap_sites=80, dpi=150):
    """A multi-page PDF over the S-rate CSV (protein, psite, time, S): the
    top 30 sites by the AUC of S over time, early (t <= 2) against late
    (t >= min(120, last time)) mean S per site, then for each protein (in
    order) a heatmap of its top sites by AUC over time and its top
    ``top_k_sites_per_protein`` sites' time series, ``max_sites_per_page``
    a page. Rows with a missing cell are dropped and repeated (protein,
    psite, time) rows averaged first (pandas' ``groupby().mean()``)."""
    import math

    from phoskintime_tpu_torch.report.draw import PdfPages, subplots

    t = read_csv(csv_path)
    prot, site = np.asarray(t["protein"], dtype=object), np.asarray(t["psite"], dtype=object)
    time_raw = np.asarray(t["time"])
    time, S = as_numbers(time_raw), as_numbers(t["S"])
    keep = [not (is_missing(p) or is_missing(s) or np.isnan(a) or np.isnan(b))
            for p, s, a, b in zip(prot, site, time, S)]
    keys = [(p, s, float(a)) for p, s, a, k in zip(prot, site, time, keep) if k]
    raw_of = {float(a): v for a, v, k in zip(time, time_raw, keep) if k}
    keys, S = _group_mean(keys, S[np.asarray(keep, bool)])
    P = [k[0] for k in keys]
    Q = [k[1] for k in keys]
    T = np.asarray([k[2] for k in keys], float)

    # AUC ranking per (protein, psite), in pandas' descending sort
    pairs, first = [], {}
    for i, key in enumerate(zip(P, Q)):
        if key not in first:
            first[key] = i
            pairs.append(key)
    bounds = [first[k] for k in pairs] + [len(keys)]
    auc = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        tt, yy = T[a:b], S[a:b]
        auc.append(float(np.trapezoid(yy, tt)) if tt.size > 1 else float(yy[0]))
    order = sort_desc(auc)
    auc_rank = [(pairs[i][0], pairs[i][1], auc[i]) for i in order]

    early_cut, late_cut = 2.0, min(120.0, float(T.max()))
    early_k, early = _group_mean([(p, q) for p, q, tt in zip(P, Q, T) if tt <= early_cut],
                                 S[T <= early_cut])
    late_k, late = _group_mean([(p, q) for p, q, tt in zip(P, Q, T) if tt >= late_cut],
                               S[T >= late_cut])
    late_of = dict(zip(late_k, late))
    el = [(e, late_of[k]) for k, e in zip(early_k, early) if k in late_of]

    def xscale(ax):
        if log_x:
            ax.set_xscale("symlog" if (T == 0).any() else "log")

    out_pdf = str(out_pdf)
    os.makedirs(os.path.dirname(out_pdf) or ".", exist_ok=True)
    with PdfPages(out_pdf) as pdf:
        # page 1: the top sites by AUC
        top_n = min(30, len(auc_rank))
        top = auc_rank[:top_n]
        labels = [f"{_cell_text(p)} {_cell_text(q)}" for p, q, _ in top]
        fig, ax = subplots(figsize=(11, 0.35 * top_n + 2.5))
        ax.barh(range(top_n)[::-1], np.asarray([a for *_, a in top], float)[::-1])
        ax.set_yticks(range(top_n)[::-1])
        ax.set_yticklabels(labels[::-1], fontsize=8)
        ax.set_xlabel("AUC of S over time")
        ax.set_title(f"Top {top_n} sites by total signaling (AUC)")
        ax.grid(True, axis="x", alpha=0.25)
        fig.tight_layout()
        pdf.savefig(fig, dpi=dpi)

        # page 2: early against late
        if el:
            fig, ax = subplots(figsize=(7.5, 6.5))
            x, y = np.asarray([e for e, _ in el]), np.asarray([v for _, v in el])
            ax.scatter(x, y, s=20, alpha=0.7)
            lo, hi = float(min(x.min(), y.min())), float(max(x.max(), y.max()))
            ax.plot([lo, hi], [lo, hi], ls="--", lw=1)
            ax.set_xlabel(f"Early mean S (t <= {early_cut})")
            ax.set_ylabel(f"Late mean S (t >= {late_cut})")
            ax.set_title("Early vs Late signaling per site")
            ax.grid(True, alpha=0.25)
            fig.tight_layout()
            pdf.savefig(fig, dpi=dpi)

        # per-protein pages
        P_arr, Q_arr = np.asarray(P, dtype=object), np.asarray(Q, dtype=object)
        for prot_name in sorted(set(P)):
            mine = P_arr == prot_name
            ranked = [q for p, q, _ in auc_rank if p == prot_name]
            if heatmap_per_protein and ranked:
                sites = ranked[:heatmap_cap_sites]
                in_sites = mine & np.isin(Q_arr, np.asarray(sites, dtype=object))
                cols = np.unique(T[in_sites])
                mat = np.full((len(sites), len(cols)), np.nan)
                row_of = {q: i for i, q in enumerate(sites)}
                for q, tt, v in zip(Q_arr[in_sites], T[in_sites], S[in_sites]):
                    mat[row_of[q], np.searchsorted(cols, tt)] = v
                fig, ax = subplots(figsize=(10.5, max(3.5, 0.18 * mat.shape[0])))
                im = ax.imshow(mat, aspect="auto", interpolation="nearest")
                ax.set_title(f"{_cell_text(prot_name)} — heatmap (top {len(sites)} sites "
                             "by AUC)")
                ax.set_yticks(np.arange(len(sites)))
                ax.set_yticklabels([_cell_text(q) for q in sites], fontsize=7)
                ax.set_xticks(np.arange(len(cols)))
                ax.set_xticklabels([_cell_text(raw_of[c]) for c in cols], rotation=45,
                                   ha="right", fontsize=8)
                fig.colorbar(im, ax=ax, label="S")
                fig.tight_layout()
                pdf.savefig(fig, dpi=dpi)

            chunked = ranked[:top_k_sites_per_protein]
            pages = max(1, math.ceil(len(chunked) / max_sites_per_page))
            for page in range(pages):
                chunk = chunked[page * max_sites_per_page:(page + 1) * max_sites_per_page]
                if not chunk:
                    continue
                nrows = math.ceil(len(chunk) / ncols)
                fig, axes = subplots(nrows, ncols, figsize=(3.8 * ncols, 2.7 * nrows),
                                     squeeze=False)
                axes = axes.ravel()
                for ax_i, q in enumerate(chunk):
                    g = mine & (Q_arr == q)
                    ax = axes[ax_i]
                    ax.plot(T[g], S[g], marker="o", lw=1.5, ms=3)
                    xscale(ax)
                    ax.set_title(f"{_cell_text(prot_name)}  {_cell_text(q)}", fontsize=9)
                    ax.grid(True, alpha=0.25)
                    if ax_i % ncols == 0:
                        ax.set_ylabel("S")
                    ax.set_xlabel("time")
                for j in range(len(chunk), len(axes)):
                    axes[j].axis("off")
                fig.suptitle(f"{_cell_text(prot_name)} — site time series"
                             + (f" — page {page + 1}/{pages}" if pages > 1 else ""),
                             fontsize=12)
                fig.tight_layout(rect=[0, 0, 1, 0.96])
                pdf.savefig(fig, dpi=dpi)
    logger.info(f"[Export] Saved S-rate report to: {out_pdf}")
    return out_pdf


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


def plot_gof_solutions(traj_prot, traj_rna, traj_pho, df_prot, df_rna, df_pho, out_dir,
                       dpi=120):
    """One goodness-of-fit figure a Pareto solution of the trajectory
    tables (``export_pareto_trajectories``' sheets): observed against
    predicted fold change per modality, joined on protein (and psite) and
    time, with R^2 and chi^2 in the title (``gof_sol<id>.png``); an axes
    whose modality has no rows is off. Returns the paths."""
    from phoskintime_tpu_torch.report.draw import subplots

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for sid in sorted({int(v) for v in np.asarray(traj_prot["sol_id"])}):
        fig, axes = subplots(1, 3, figsize=(15, 4.8))
        for ax, traj, obs, keys, title in [
                (axes[0], traj_prot, df_prot, ["protein"], "Protein"),
                (axes[1], traj_rna, df_rna, ["protein"], "mRNA"),
                (axes[2], traj_pho, df_pho, ["protein", "psite"], "Phospho")]:
            sub = take(traj, np.asarray(traj["sol_id"]).astype(int) == sid)
            if obs is None or n_rows(obs) == 0 or n_rows(sub) == 0:
                ax.axis("off")
                continue
            m = merge_obs_est(obs, sub, keys + ["time"])
            if n_rows(m) == 0:
                ax.axis("off")
                continue
            x = np.asarray(m["fc"], float)
            y = np.asarray(m["pred_fc"], float)
            ss_res = float(np.sum((y - x) ** 2))
            ss_tot = float(np.sum((x - x.mean()) ** 2))
            r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
            chi2 = float(np.sum((y - x) ** 2 / np.maximum(np.abs(x), 1e-6)))
            ax.scatter(x, y, s=14, alpha=0.6)
            lo, hi = float(min(x.min(), y.min())), float(max(x.max(), y.max()))
            ax.plot([lo, hi], [lo, hi], "k--", lw=1)
            ax.set_title(f"{title}  R²={r2:.3f}  χ²={chi2:.3g}")
            ax.set_xlabel("observed FC")
            ax.set_ylabel("predicted FC")
            ax.grid(True, alpha=0.3)
        fig.suptitle(f"Goodness of fit — solution {sid}")
        fig.tight_layout()
        p = os.path.join(out_dir, f"gof_sol{sid}.png")
        fig.savefig(p, dpi=dpi)
        paths.append(p)
    return paths


def process_convergence_history(history, output_dir):
    """The per-generation least objectives as ``convergence_history.csv``
    (gen, min_prot_mse, min_rna_mse, min_phos_mse) and their log-scale plot
    ``convergence_plot.png``; returns the table, or None without a
    history."""
    if not history:
        logger.info("[Export] no convergence history; skipping")
        return None
    from phoskintime_tpu_torch.report.draw import subplots

    mins = np.stack([np.atleast_1d(host(h[1])) for h in history])
    cols = ["min_prot_mse", "min_rna_mse", "min_phos_mse"][: mins.shape[1]]
    table = {"gen": np.asarray([int(h[0]) for h in history], np.int64)}
    table.update({c: mins[:, j] for j, c in enumerate(cols)})
    os.makedirs(output_dir, exist_ok=True)
    write_csv(os.path.join(output_dir, "convergence_history.csv"), table)

    fig, ax = subplots(figsize=(10, 6))
    for c, lbl in zip(cols, ["Protein MSE", "RNA MSE", "Phospho MSE"]):
        ax.plot(table["gen"], table[c], label=lbl)
    ax.set_yscale("log")
    ax.set_title("Convergence History (Best Error per Gen)")
    ax.set_xlabel("Generation")
    ax.set_ylabel("MSE (Log Scale)")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(os.path.join(output_dir, "convergence_plot.png"), dpi=150)
    logger.info("[Export] Saved convergence history and plot.")
    return table


def create_convergence_video(pop_history, pareto_F, output_dir,
                             filename="optimization_history.gif", max_frames=60, fps=5,
                             dpi=110):
    """The population's objectives generation by generation as a 3-D
    scatter over the final front (faint red), one frame a snapshot of
    ``pop_history`` ((gen, F (P, 3)) pairs; more than ``max_frames`` are
    subsampled by a stride, the last kept), written as an animated GIF
    (``<stem of filename>.gif``) at ``fps``. Returns the path, or None
    without a history."""
    if not pop_history:
        logger.info("[Export] no population history; skipping video")
        return None
    from phoskintime_tpu_torch.report.draw import Figure, FuncAnimation

    picks = list(range(len(pop_history)))
    if len(picks) > max_frames:
        picks = picks[::int(np.ceil(len(picks) / max_frames))]
        if picks[-1] != len(pop_history) - 1:
            picks.append(len(pop_history) - 1)      # always end on the final generation
    frames = [(pop_history[k][0], host(pop_history[k][1])) for k in picks]
    all_F = np.vstack([F for _, F in frames])
    min_f, max_f = all_F.min(axis=0), all_F.max(axis=0)
    span = np.maximum(max_f - min_f, 1e-12)
    pare = host(pareto_F) if pareto_F is not None else None

    fig = Figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")

    def update(k):
        ax.clear()
        gen, F = frames[k]
        ax.scatter(F[:, 0], F[:, 1], F[:, 2], c="blue", s=10, alpha=0.6, label="Population")
        if pare is not None and pare.shape[1] >= 3:
            ax.scatter(pare[:, 0], pare[:, 1], pare[:, 2], c="red", s=5, alpha=0.15)
        ax.set_title(f"Optimization History - Gen {gen}")
        ax.set_xlabel("Prot MSE")
        ax.set_ylabel("RNA MSE")
        ax.set_zlabel("Phospho MSE")
        ax.set_xlim(min_f[0], min_f[0] + span[0])
        ax.set_ylim(min_f[1], min_f[1] + span[1])
        ax.set_zlim(min_f[2], min_f[2] + span[2])
        ax.view_init(elev=45, azim=45)

    os.makedirs(output_dir, exist_ok=True)
    save_path = os.path.join(output_dir, os.path.splitext(filename)[0] + ".gif")
    FuncAnimation(fig, update, frames=len(frames), interval=200).save(save_path, fps=fps,
                                                                      dpi=dpi)
    logger.info(f"[Export] Saved convergence video: {save_path}")
    return save_path


def _gene_rows(table, gene: str, col: str) -> dict:
    """The rows of ``gene`` with a numeric time and ``col``, by time
    (pandas' ``sort_values("time")``); an empty (time, col) table for none."""
    if table is None or n_rows(table) == 0:
        return {"time": np.zeros(0), col: np.zeros(0)}
    out = take(table, np.asarray([p == gene for p in table["protein"]], bool))
    out["time"], out[col] = as_numbers(out["time"]), as_numbers(out[col])
    out = take(out, ~np.isnan(out["time"]) & ~np.isnan(out[col]))
    return take(out, sort_asc(out["time"]))


def _mean_by_time(table: dict, col: str) -> tuple[np.ndarray, np.ndarray]:
    keys: dict = {}
    for t, v in zip(table["time"], table[col]):
        keys.setdefault(float(t), []).append(v)
    times = sorted(keys)
    return np.asarray(times), np.asarray([np.mean(keys[t]) for t in times])


def save_gene_timeseries_plots(gene, df_prot_obs, df_prot_pred, df_rna_obs, df_rna_pred,
                               df_phos_obs, df_phos_pred, output_dir, filename_prefix="ts",
                               dpi=150, phos_mode="per_psite"):
    """Observed against predicted time series of one protein in three
    panels (protein, mRNA, phospho: a line a site, coloured by the site's
    index, or their means with ``phos_mode="mean"``), as
    ``<prefix>_<gene>.png``; None when the protein has no rows. Observed
    tables carry ``fc``, predicted ``pred_fc``."""
    from phoskintime_tpu_torch.report.draw import lighten, subplots

    p_obs, p_pre = _gene_rows(df_prot_obs, gene, "fc"), _gene_rows(df_prot_pred, gene, "pred_fc")
    r_obs, r_pre = _gene_rows(df_rna_obs, gene, "fc"), _gene_rows(df_rna_pred, gene, "pred_fc")
    ph_obs = _gene_rows(df_phos_obs, gene, "fc")
    ph_pre = _gene_rows(df_phos_pred, gene, "pred_fc")
    if all(n_rows(d) == 0 for d in (p_obs, p_pre, r_obs, r_pre, ph_obs, ph_pre)):
        return None

    fig, (ax_p, ax_r, ax_ph) = subplots(1, 3, figsize=(18, 5.5), sharey=True)
    for ax, obs, pre, col, title in [(ax_p, p_obs, p_pre, "C0", "Protein"),
                                     (ax_r, r_obs, r_pre, "C1", "mRNA")]:
        if n_rows(obs):
            ax.plot(obs["time"], obs["fc"], marker="s", lw=1, label="obs", color=lighten(col),
                    alpha=0.6)
        if n_rows(pre):
            ax.plot(pre["time"], pre["pred_fc"], lw=2, label="pred", color=col)
        ax.set_title(f"{gene} — {title}")
        ax.set_xlabel("Time")
        ax.set_ylabel("FC")
        ax.grid(True, alpha=0.3)
        ax.legend()

    ax_ph.set_title(f"{gene} — Phosphorylation")
    ax_ph.set_xlabel("Time")
    ax_ph.grid(True, alpha=0.3)
    if n_rows(ph_obs) or n_rows(ph_pre):
        if phos_mode == "mean":
            if n_rows(ph_obs):
                ax_ph.plot(*_mean_by_time(ph_obs, "fc"), marker="s", lw=1, label="obs (mean)",
                           color=lighten("C2"), alpha=0.6)
            if n_rows(ph_pre):
                ax_ph.plot(*_mean_by_time(ph_pre, "pred_fc"), lw=2, label="pred (mean)",
                           color="C2")
        else:
            psites = sorted(set(ph_obs.get("psite", ())) | set(ph_pre.get("psite", ())))
            for ps_i, ps in enumerate(psites):
                col = f"C{ps_i % 10}"
                so = take(ph_obs, ph_obs["psite"] == ps) if n_rows(ph_obs) else ph_obs
                sp = take(ph_pre, ph_pre["psite"] == ps) if n_rows(ph_pre) else ph_pre
                if n_rows(so):
                    ax_ph.plot(so["time"], so["fc"], marker="s", lw=1, label=f"obs {ps}",
                               color=lighten(col), alpha=0.6)
                if n_rows(sp):
                    ax_ph.plot(sp["time"], sp["pred_fc"], lw=2, label=f"pred {ps}", color=col)
        ax_ph.legend(ncol=2, fontsize=7)

    fig.suptitle(f"Observed vs Predicted Time Series — {gene}", y=0.995)
    fig.tight_layout()
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"{filename_prefix}_{gene}.png")
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    return out_path


def save_all_gene_timeseries(df_prot_obs, df_prot_pred, df_rna_obs, df_rna_pred, df_phos_obs,
                             df_phos_pred, output_dir, **kw):
    """:func:`save_gene_timeseries_plots` for every protein of any table,
    in sorted order; returns the paths written."""
    genes = set()
    for t in (df_prot_obs, df_prot_pred, df_rna_obs, df_rna_pred, df_phos_obs, df_phos_pred):
        if t is not None and n_rows(t):
            genes |= {str(p) for p in t["protein"]}
    paths = (save_gene_timeseries_plots(g, df_prot_obs, df_prot_pred, df_rna_obs, df_rna_pred,
                                        df_phos_obs, df_phos_pred, output_dir, **kw)
             for g in sorted(genes))
    return [p for p in paths if p]


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

