"""The run's dashboard: a reloadable bundle of the run's results and its
static HTML view.

Counterpart of ``phoskintime_tpu/report/dashboard.py``. The bundle keeps
the JAX package's keys (pareto_X, pareto_F, best_idx, df_prot, df_rna,
df_pho, pred_prot, pred_rna, pred_pho, params, topo_summary, history,
extras); its tables are column dicts (:mod:`phoskintime_tpu_torch.io.utils`)
where the JAX bundle holds DataFrames, so the port's
:func:`render_dashboard` reads it and the JAX package's dashboard does not.
The viewer is the static page; the JAX package's Streamlit route is not
ported (Streamlit is on neither machine: ROADMAP.md section 3).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from phoskintime_tpu_torch.io.utils import n_rows, take


def _numpy(x):
    """A tensor as a numpy array of its dtype on the host; anything else
    as numpy does."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _table(t):
    return None if t is None else {k: _numpy(v) for k, v in t.items()}


def save_dashboard_bundle(path: str, *, pareto_X, pareto_F, best_idx, df_prot=None,
                          df_rna=None, df_pho=None, pred_prot=None, pred_rna=None,
                          pred_pho=None, params=None, topo_summary=None, history=None,
                          extras=None) -> str:
    """Pickle the run's results (on the host, numpy) to ``path``."""
    bundle = {
        "pareto_X": _numpy(pareto_X), "pareto_F": _numpy(pareto_F), "best_idx": int(best_idx),
        "df_prot": _table(df_prot), "df_rna": _table(df_rna), "df_pho": _table(df_pho),
        "pred_prot": _table(pred_prot), "pred_rna": _table(pred_rna),
        "pred_pho": _table(pred_pho),
        "params": None if params is None else {k: _numpy(v) for k, v in params.items()},
        "topo_summary": topo_summary, "history": history, "extras": extras or {},
    }
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(str(path), "wb") as fh:
        pickle.dump(bundle, fh, protocol=4)
    return str(path)


def load_dashboard_bundle(path: str) -> dict:
    """A bundle this package wrote (unpickled: read only bundles you
    wrote)."""
    with open(str(path), "rb") as fh:
        return pickle.load(fh)


def render_dashboard(bundle: dict | str, out_dir: str) -> str:
    """The static dashboard ``out_dir/dashboard.html``: the Pareto front in
    3-D, its parallel coordinates and the convergence (where the bundle has
    a history) as PNGs beside it, and the tables (the front with the pick
    marked, the topology, the first 50 predicted protein and RNA rows).
    Returns the page's path."""
    from phoskintime_tpu_torch.report.html import create_report
    from phoskintime_tpu_torch.report.plotter import (plot_convergence,
                                                      plot_parallel_coords_pareto, plot_pareto_3d)

    if isinstance(bundle, str):
        bundle = load_dashboard_bundle(bundle)
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    plot_pareto_3d(bundle["pareto_F"], os.path.join(out_dir, "pareto_3d.png"),
                   best_idx=bundle["best_idx"])
    plot_parallel_coords_pareto(bundle["pareto_F"], os.path.join(out_dir, "pareto_parallel.png"))
    if bundle.get("history"):
        plot_convergence(bundle["history"], os.path.join(out_dir, "convergence.png"))

    F = np.asarray(bundle["pareto_F"])
    tables = {"Pareto objectives": {
        "protein": F[:, 0], "rna": F[:, 1], "phospho": F[:, 2],
        "picked": np.arange(len(F)) == bundle["best_idx"]}}
    if bundle.get("topo_summary") is not None:
        tables["Topology"] = {k: np.asarray([v]) for k, v in bundle["topo_summary"].items()}
    for key, name in [("pred_prot", "Predicted protein FC"), ("pred_rna", "Predicted RNA FC")]:
        if bundle.get(key) is not None:
            tables[name] = take(bundle[key], np.arange(min(50, n_rows(bundle[key]))))
    return create_report(out_dir, output_file="dashboard.html",
                         title="phoskintime-tpu dashboard", tables=tables)


def run_dashboard(bundle_path: str, out_dir: str = "dashboard") -> str:
    """The dashboard of a saved bundle as the static page (the Streamlit
    viewer is not ported yet); returns its path."""
    path = render_dashboard(bundle_path, out_dir)
    print(f"wrote static dashboard: {path} (the Streamlit viewer is not ported: "
          "ROADMAP.md section 3)")
    return path
