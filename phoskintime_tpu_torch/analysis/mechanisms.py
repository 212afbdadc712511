"""Mechanism comparison, model selection and knockout exploration.

Counterpart of ``phoskintime_tpu/analysis/mechanisms.py``: the same network
under the four mechanistic hypotheses (0 distributive, 1 sequential, 2
combinatorial, 4 saturating), each fitted to the same data by one batched
global fit and ranked by AIC, AICc, BIC and Akaike weights at its
Fréchet-picked solution; in-silico knockouts as simulations. Tables are
column dicts. Systems are float32 by default, as in the JAX package
(``dtype`` changes it), on ``device`` (default: the card).

With ``out_dir``, :func:`fit_all_mechanisms` writes the selection table and
each model's protein trajectories (``mechanism_selection_*.csv``), the
overlay plots ``overlay_protein.png`` and ``overlay_rna.png`` (drawn by
:mod:`phoskintime_tpu_torch.report.draw`) and the HTML summary
``mechanism_selection.html``, which shows them.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, numpy_dtype
from phoskintime_tpu_torch.io.export import TableWriter, rows_to_table, sort_asc, sort_desc
from phoskintime_tpu_torch.io.utils import merge_obs_est, n_rows, take
from phoskintime_tpu_torch.network.kinase_input import build_kinase_matrix
from phoskintime_tpu_torch.network.objective import make_objective
from phoskintime_tpu_torch.network.params import init_raw_params, unpack_params
from phoskintime_tpu_torch.network.simulate import simulate_and_measure
from phoskintime_tpu_torch.network.system import GlobalSystem, default_params
from phoskintime_tpu_torch.network.topology import build_topology
from phoskintime_tpu_torch.parallel.mesh import is_writer, on_root

MECHANISMS = {0: "distributive", 1: "sequential", 2: "combinatorial", 4: "saturating"}


@dataclass
class MechanismComparison:
    losses: dict          # model id -> (3,) objectives
    trajectories: dict    # model id -> (prot, rna, pho) tables
    best_model: int


def _fc_rows(table: dict):
    return zip(table["protein"], table["time"], table["fc"])


def _in_topology(table: dict, topo) -> dict:
    return take(table, np.asarray([p in topo.p2i for p in table["protein"]], bool))


def _member(thetas: np.ndarray, slices, topo, system) -> dict:
    """One raw theta as a physical parameter dict of the system's tensors."""
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device)
    return {k: v[0] for k, v in unpack_params(torch.as_tensor(
        np.asarray(thetas, float)[None], **f), slices, topo).items()}


def compare_mechanisms(df_kin, df_tf, df_prot, df_rna, df_pho, loss_data_fn,
                       params=None, grid=None, tp=(None, None, None),
                       models=(0, 1, 2, 4), max_sites_cap=6, *,
                       device=DEFAULT_DEVICE, dtype=torch.float32) -> MechanismComparison:
    """Each mechanism's RK45 objective and trajectories at the same
    parameters (``params(topo)``, default all ones). ``loss_data_fn``:
    topo -> LossData, so that indices match each topology."""
    losses, trajs = {}, {}
    tp_p, tp_r, tp_ph = tp
    for model in models:
        topo = build_topology(df_kin, df_tf, model=model,
                              max_sites_cap=max_sites_cap if model == 2 else None)
        Kmat = build_kinase_matrix(topo.kinases, _fc_rows(df_prot), tp_p)
        system = GlobalSystem(topo, tp_p, Kmat, dtype=dtype, device=device)
        p = default_params(topo, numpy_dtype(dtype)) if params is None else params(topo)
        theta0, slices, _, _ = init_raw_params(
            p, topo, {k: (1e-3, 10.0) for k in
                      ["c_k", "A_i", "B_i", "C_i", "D_i", "Dp_i", "E_i", "tf_scale"]})
        obj = make_objective(system, slices, loss_data_fn(topo), p,
                             {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.0}, grid)
        f = dict(dtype=dtype, device=system.device)
        losses[model] = obj(torch.as_tensor(theta0[None], **f))[0].to("cpu", torch.float64).numpy()
        pj = {k: torch.as_tensor(np.asarray(v, float), **f) for k, v in p.items()}
        trajs[model] = simulate_and_measure(system, pj, tp_p, tp_r, tp_ph)
    best = min(losses, key=lambda m: float(np.sum(losses[m])))
    return MechanismComparison(losses, trajs, best)


def knockout_scan_global(system, params, targets: list[dict], tp_p, tp_r, tp_ph,
                         y0=None) -> list:
    """In-silico knockouts, one RK45 simulation each: ``{"kinase": name,
    "factor": f}`` scales c_k, ``{"protein": name, "param": "A_i"|...,
    "factor": f}`` one protein's rate, ``{"site": (protein, psite),
    "factor": f}`` the site's kinase drive (its W row, in a rebuilt
    system). Returns a (prot, rna, pho) triple per knockout."""
    topo = system.topo
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device)
    out = []
    for ko in targets:
        sys_ko = system
        p = {k: torch.as_tensor(v, **f).clone() for k, v in params.items()}
        factor = float(ko.get("factor", 0.0))
        if "kinase" in ko:
            p["c_k"][topo.k2i[ko["kinase"]]] *= factor
        elif "site" in ko:
            prot, site = ko["site"]
            i = topo.p2i[prot]
            W = np.array(topo.W_pad, copy=True)
            W[i, topo.sites[i].index(site), :] *= factor
            sys_ko = GlobalSystem(dataclasses.replace(topo, W_pad=W), system.kin_grid,
                                  system.Kmat, system.custom_y0, system.dtype, system.device)
        elif "protein" in ko:
            p[ko.get("param", "A_i")][topo.p2i[ko["protein"]]] *= factor
        out.append(simulate_and_measure(sys_ko, p, tp_p, tp_r, tp_ph, y0=y0))
    return out


def find_protein_accumulators(report, proteins, threshold: float = 2.0) -> dict:
    """Proteins whose steady level (a :class:`SteadyStateReport`) is at
    least ``threshold`` times their initial level; sorted by the ratio,
    largest first."""
    start = np.asarray(report.tot[0], float)
    ratio = np.asarray(report.ss_value, float) / np.maximum(start, 1e-12)
    table = {"protein": np.asarray(proteins, dtype=object), "start": start,
             "steady_state": np.asarray(report.ss_value, float), "ratio": ratio,
             "accumulator": ratio >= threshold, "converged": np.asarray(report.converged, bool)}
    return take(table, sort_desc(ratio))


# ---------------------------------------------------------------------------
# model selection
# ---------------------------------------------------------------------------

@dataclass
class MechanismSelection:
    """Every mechanism fitted to one dataset."""

    table: dict                # per-model AIC/BIC/GOF, AIC-sorted
    fits: dict                 # model id -> GlobalFitResult
    trajectories: dict         # model id -> (prot, rna, pho) at the pick
    best_model: int            # argmin AIC
    paths: dict | None = None  # written files with out_dir


def _gof_stats(obs_tables, pred_tables):
    """Pooled and per-modality goodness of fit of observed against
    predicted tables (joined on protein[, psite], time)."""
    total_rss, total_tss, total_n = 0.0, 0.0, 0
    per_mod = {}
    for name, obs, pred in zip(("protein", "rna", "phospho"), obs_tables, pred_tables):
        if obs is None or not len(obs["protein"]):
            continue
        keys = [c for c in ("protein", "psite", "time") if c in obs and c in pred]
        m = merge_obs_est(obs, pred, keys)
        if not len(m["protein"]):
            continue
        y = np.asarray(m["fc"], float)
        r = m["residual"]
        rss = float((r ** 2).sum())
        tss = float(((y - y.mean()) ** 2).sum())
        per_mod[name] = {"rmse": np.sqrt(rss / len(y)), "mae": float(np.abs(r).mean()),
                         "r2": 1.0 - rss / max(tss, 1e-300), "n": len(y)}
        total_rss += rss
        total_tss += tss
        total_n += len(y)
    return total_rss, total_tss, total_n, per_mod


def fit_all_mechanisms(df_kin, df_tf, df_prot, df_rna, df_pho, tp, *,
                       models=(0, 1, 2, 4), pop=48, n_gen=25, seed=0,
                       loss_mode=0, polish_steps=0, max_sites_cap=6,
                       lambdas=None, out_dir=None, mesh=None,
                       logger=None, device=DEFAULT_DEVICE,
                       dtype=torch.float32) -> MechanismSelection:
    """Fit every mechanism to the same data and rank them.

    Per mechanism: the topology (model 2 capped at ``max_sites_cap`` sites
    a protein), the observations it covers, the system at ``dtype`` on
    ``device``, one :func:`run_global_fit` with the Fréchet pick, then an
    RK45 simulation of the pick; AIC = n ln(RSS/n) + 2k, AICc, BIC = n
    ln(RSS/n) + k ln(n), Akaike weights and per-modality R^2, RMSE and MAE.
    ``tp``: (t_points_protein, t_points_rna, t_points_phospho). ``mesh``:
    every rank calls this alike; each fit is sharded over its ranks
    (:func:`run_global_fit`), the pick's simulation and the files run on
    rank 0 (the others wait for the simulation's result), and every rank
    returns the same selection."""
    from phoskintime_tpu_torch.network.bounds import calculate_bio_bounds
    from phoskintime_tpu_torch.network.lossdata import prepare_loss_data
    from phoskintime_tpu_torch.network.optimize import run_global_fit

    tp_p, tp_r, tp_ph = tp
    lambdas = lambdas or {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.0}
    grid = np.unique(np.concatenate([np.asarray(tp_p, float), np.asarray(tp_r, float),
                                     np.asarray(tp_ph, float)]))
    fits, trajs, rows = {}, {}, []
    for model in models:
        topo = build_topology(df_kin, df_tf, model=model,
                              max_sites_cap=(max_sites_cap if model == 2 else None))
        dfp, dfr, dfh = (_in_topology(t, topo) for t in (df_prot, df_rna, df_pho))
        Kmat = build_kinase_matrix(topo.kinases, _fc_rows(dfp), tp_p)
        system = GlobalSystem(topo, tp_p, Kmat, dtype=dtype, device=device)
        ld = prepare_loss_data(topo, dfp, dfr, dfh, grid)
        defaults = default_params(topo, numpy_dtype(dtype))
        bounds = calculate_bio_bounds(topo, dfp, dfr, Kmat)
        theta0, slices, xl, xu = init_raw_params(defaults, topo, bounds)
        res = run_global_fit(system, slices, ld, defaults, lambdas, grid, xl, xu,
                             pop=pop, n_gen=n_gen, seed=seed, loss_mode=loss_mode, mesh=mesh,
                             polish_steps=polish_steps, frechet_pick=True,
                             df_prot=dfp, df_rna=dfr, df_pho=dfh,
                             t_points=(tp_p, tp_r, tp_ph))
        fits[model] = res
        pred = on_root(mesh, lambda: simulate_and_measure(
            system, _member(res.pareto_X[res.best_idx], slices, topo, system),
            tp_p, tp_r, tp_ph))
        trajs[model] = pred

        rss, tss, n, per_mod = _gof_stats((df_prot, df_rna, df_pho), pred)
        k = len(theta0)
        aic = n * np.log(max(rss, 1e-300) / n) + 2 * k
        bic = n * np.log(max(rss, 1e-300) / n) + k * np.log(n)
        aicc = aic + (2.0 * k * (k + 1) / (n - k - 1) if n > k + 1 else np.inf)
        row = {"model": model, "mechanism": MECHANISMS[model], "n_params": k, "n_obs": n,
               "rss": rss, "r2": 1.0 - rss / max(tss, 1e-300), "aic": aic, "aicc": aicc,
               "bic": bic, "n_evals": res.n_evals}
        for mname, st in per_mod.items():
            row[f"r2_{mname}"] = st["r2"]
            row[f"rmse_{mname}"] = st["rmse"]
            row[f"mae_{mname}"] = st["mae"]
        rows.append(row)
        if logger is not None and is_writer(mesh):
            logger.info(f"[Mech] {MECHANISMS[model]}: AIC={aic:.1f} BIC={bic:.1f} "
                        f"R2={row['r2']:.3f}")

    table = rows_to_table(rows)
    table = take(table, sort_asc(table["aic"]))
    d = table["aic"] - table["aic"].min()
    table["delta_aic"] = d
    w = np.exp(-0.5 * d)
    table["akaike_weight"] = w / w.sum()
    best = int(table["model"][0])
    paths = (on_root(mesh, lambda: _write_selection_artifacts(
        table, trajs, (df_prot, df_rna, df_pho), out_dir)) if out_dir else None)
    return MechanismSelection(table, fits, trajs, best, paths)


def _write_selection_artifacts(table, trajs, obs_dfs, out_dir):
    """``mechanism_selection.xlsx`` as CSVs (the ModelSelection table and
    each model's protein trajectories, ``fit_<mechanism>``), the overlay
    plots ``overlay_protein.png`` and ``overlay_rna.png`` (the first six
    proteins' observations (``obs_dfs``: protein, rna, phospho) against
    each model's predictions, on a symlog time axis) and the HTML summary
    ``mechanism_selection.html``: the best mechanism by AIC, the table, the
    overlays. Returns {"table", "overlay_protein", "overlay_rna", "html"}
    (an overlay only where its modality has rows)."""
    import html as _html

    from phoskintime_tpu_torch.report.html import table_html

    os.makedirs(out_dir, exist_ok=True)
    w = TableWriter(os.path.join(out_dir, "mechanism_selection.xlsx"))
    w.add("ModelSelection", table)
    for model, (dfp, _, _) in trajs.items():
        w.add(f"fit_{MECHANISMS[model][:12]}", dfp)
    paths = {"table": w.save()}
    paths.update(_write_overlays(trajs, obs_dfs, out_dir))

    rows_html = table_html(table, float_format=lambda v: f"{v:.4g}")
    runner_up = table["delta_aic"][1] if len(table["delta_aic"]) > 1 else 0
    html_doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>Mechanism model selection</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #ccc;padding:4px 8px}}</style></head><body>
<h1>Mechanism model selection</h1>
<p>Best mechanism by AIC: <b>{_html.escape(str(table['mechanism'][0]))}</b>
 (&Delta;AIC of runner-up:
 {runner_up:.1f};
 Akaike weight {table['akaike_weight'][0]:.3f})</p>
{rows_html}
<h2>Overlays</h2>
<p><img src="overlay_protein.png" width="640"></p>
<p><img src="overlay_rna.png" width="640"></p>
<h2>Explorers</h2>
<p>Generate interactive knockout / influence explorers for the winning
mechanism with <code>report.interactive.knockout_explorer</code> and
<code>analysis.influence</code> (CLI: <code>fitanalysis</code>).</p>
</body></html>"""
    paths["html"] = os.path.join(out_dir, "mechanism_selection.html")
    with open(paths["html"], "w") as f:
        f.write(html_doc)
    return paths


def _write_overlays(trajs, obs_dfs, out_dir) -> dict:
    """The protein and RNA overlays: a panel a protein (the first six in
    order of appearance), the observations as black dots and each model's
    predicted fold change in its colour; unused panels off."""
    from phoskintime_tpu_torch.report.draw import subplots

    colors = {0: "tab:blue", 1: "tab:orange", 2: "tab:green", 4: "tab:red"}
    df_prot, df_rna, _ = obs_dfs
    paths = {}
    for mod_name, obs, idx in [("protein", df_prot, 0), ("rna", df_rna, 1)]:
        if obs is None or not n_rows(obs):
            continue
        names = np.asarray(obs["protein"], dtype=object)
        prots = list(dict.fromkeys(names))[:6]
        ncol = min(3, len(prots))
        nrow = int(np.ceil(len(prots) / ncol))
        fig, axes = subplots(nrow, ncol, figsize=(4 * ncol, 3 * nrow), squeeze=False)
        for ax, prot in zip(axes.ravel(), prots):
            o = take(obs, names == prot)
            ax.plot(o["time"], o["fc"], "ko", ms=4, label="observed")
            for model, pred in trajs.items():
                p = pred[idx]
                pi = take(p, np.asarray(p["protein"], dtype=object) == prot)
                ax.plot(pi["time"], pi["pred_fc"], color=colors.get(model, "gray"), lw=1.5,
                        label=MECHANISMS[model])
            ax.set_title(prot, fontsize=9)
            ax.set_xscale("symlog")
        axes.ravel()[0].legend(fontsize=7)
        for ax in axes.ravel()[len(prots):]:
            ax.axis("off")
        fig.suptitle(f"Mechanism overlay — {mod_name} fold change")
        fig.tight_layout()
        path = os.path.join(out_dir, f"overlay_{mod_name}.png")
        fig.savefig(path, dpi=150)
        paths[f"overlay_{mod_name}"] = path
    return paths
