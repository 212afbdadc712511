"""Mechanistic discovery: four readouts of a fitted global model.

Counterpart of ``phoskintime_tpu/analysis/insights.py``: the refractory
period (flash against stable signalling), the kinetic lag between protein
and RNA responses (one batched FFT cross-correlation), transcriptional
saturation and the TF -> kinase -> TF feedback gain, all from one
simulation, on column dicts in the JAX package's row orders. The two
documented departures of the JAX module from its reference script are kept:
the stability is D_i (protein degradation) and the transcriptional
efficacy A_i * tf_scale.
"""

from __future__ import annotations

import os

import numpy as np

from phoskintime_tpu_torch.io.export import TableWriter, sort_desc
from phoskintime_tpu_torch.io.utils import host, take


def refractory_period(topo, params) -> dict:
    """Per protein: the signal reset (mean site dephosphorylation plus the
    back-exchange E_i), the stability D_i and their ratio, the flash
    index; sorted by the index, largest first."""
    msk = topo.site_mask().astype(float)
    ns = np.maximum(msk.sum(axis=1), 1.0)
    avg_dephos = (host(params["Dp_i"]) * msk).sum(axis=1) / ns
    avg_dephos = np.where(msk.sum(axis=1) > 0, avg_dephos, 0.0)
    reset = avg_dephos + host(params["E_i"])
    degr = host(params["D_i"])
    table = {"protein": np.asarray(topo.proteins, dtype=object), "signal_reset": reset,
             "protein_stability": degr, "flash_index": reset / (degr + 1e-9)}
    return take(table, sort_desc(table["flash_index"]))


def _pivot_mean(table: dict, rows: list, times: np.ndarray, value: str = "pred_fc"):
    """(len(rows), len(times)) means of ``value`` by (protein, time), NaN
    where a cell has no row (pandas' ``pivot_table`` reindexed)."""
    r_of = {p: i for i, p in enumerate(rows)}
    t_of = {float(t): j for j, t in enumerate(times)}
    total = np.zeros((len(rows), len(times)))
    count = np.zeros_like(total)
    for p, t, v in zip(table["protein"], table["time"], table[value]):
        i, j = r_of.get(p), t_of.get(float(t))
        if i is not None and j is not None and not np.isnan(v):
            total[i, j] += v
            count[i, j] += 1
    with np.errstate(invalid="ignore"):
        return np.where(count > 0, total / np.maximum(count, 1), np.nan)


def kinetic_lag(df_prot: dict, df_rna: dict, time_grid: np.ndarray,
                responder_fc: float = 1.1) -> dict:
    """The lag of the peak cross-correlation of protein and RNA responses
    per responding protein (RNA above ``responder_fc``), on a uniform
    grid; sorted by lag, largest first."""
    time_grid = np.asarray(time_grid, float)
    steps = np.diff(time_grid)
    if len(steps) and (steps.max() - steps.min()) > 1e-9 * max(steps.max(), 1e-12):
        raise ValueError(
            "kinetic_lag requires a uniform time grid (FFT lag indices map to time via a "
            f"single dt); got spacings [{steps.min():g}, {steps.max():g}] — resample first")
    T = len(time_grid)
    dt = time_grid[1] - time_grid[0]
    proteins = sorted(set(np.asarray(df_rna["protein"]).tolist()))
    piv_r = _pivot_mean(df_rna, proteins, time_grid)
    piv_p = _pivot_mean(df_prot, proteins, time_grid)
    with np.errstate(invalid="ignore"):
        row_max = np.array([np.nanmax(r) if np.isfinite(r).any() else np.nan for r in piv_r])
        keep = row_max > responder_fc
    cols = ["protein", "lag_minutes", "rna_peak", "prot_peak"]
    if not keep.any():
        return {c: np.zeros(0, dtype=object if c == "protein" else float) for c in cols}
    rna, prot = piv_r[keep] - 1.0, piv_p[keep] - 1.0
    L = 2 * T - 1
    F = np.fft.rfft(prot, L, axis=1) * np.conj(np.fft.rfft(rna, L, axis=1))
    corr = np.fft.irfft(F, L, axis=1)
    corr = np.concatenate([corr[:, -(T - 1):], corr[:, :T]], axis=1)
    lags = np.arange(-(T - 1), T) * dt
    table = {"protein": np.asarray(proteins, dtype=object)[keep],
             "lag_minutes": np.maximum(0.0, lags[np.argmax(corr, axis=1)]),
             "rna_peak": piv_r[keep].max(axis=1), "prot_peak": piv_p[keep].max(axis=1)}
    return take(table, sort_desc(table["lag_minutes"]))


def transcriptional_saturation(topo, params, df_rna: dict) -> dict:
    """Per protein: the TF efficacy A_i * tf_scale over its largest mRNA
    fold change, the saturation index; sorted by it, largest first."""
    alpha = host(params["A_i"]) * float(host(params["tf_scale"]))
    peak: dict = {}
    for p, v in zip(df_rna["protein"], np.asarray(df_rna["pred_fc"], float)):
        if not np.isnan(v):
            peak[p] = max(peak.get(p, -np.inf), v)
    max_rna = np.asarray([peak.get(p, 0.0) for p in topo.proteins], float)
    table = {"protein": np.asarray(topo.proteins, dtype=object), "tf_efficacy_alpha": alpha,
             "max_mrna_fc": max_rna, "saturation_index": alpha / (max_rna + 1e-9)}
    return take(table, sort_desc(table["saturation_index"]))


def feedback_gain(topo, params, df_tf: dict) -> dict:
    """TF -> kinase -> TF loops: for each TF edge onto a kinase that acts
    back on the TF's sites, alpha (the kinase's A_i * tf_scale), beta (the
    summed W of the kinase on the TF) and the loop gain alpha * beta;
    sorted by the gain, largest first."""
    A = host(params["A_i"]) * float(host(params["tf_scale"]))
    W = np.asarray(topo.W_pad, float)
    rows = []
    for tf, target in zip(df_tf["tf"], df_tf["target"]):
        if target not in topo.k2i or target not in topo.p2i or tf not in topo.p2i:
            continue
        alpha = A[topo.p2i[target]]
        beta = float(W[topo.p2i[tf], :, topo.k2i[target]].sum())
        if beta > 0:
            rows.append((tf, target, alpha * beta, alpha, beta))
    table = {"tf": np.asarray([r[0] for r in rows], dtype=object),
             "kinase": np.asarray([r[1] for r in rows], dtype=object),
             **{c: np.asarray([r[k] for r in rows], float) for k, c in
                enumerate(["loop_gain", "efficacy_alpha", "signaling_beta"], start=2)}}
    return take(table, sort_desc(table["loop_gain"]))


def run_mechanistic_discovery(system, params, df_tf: dict, out_dir: str | None = None,
                              t_max: float = 120.0, n_points: int = 61) -> dict:
    """The four readouts from one RK45 simulation on ``n_points`` uniform
    times to ``t_max`` (on the system's device); with ``out_dir``, written
    as ``mechanistic_discovery_report_<sheet>.csv``.
    Returns the tables."""
    from phoskintime_tpu_torch.network.simulate import simulate_and_measure

    topo = system.topo
    grid = np.linspace(0.0, t_max, n_points)
    df_prot, df_rna, _ = simulate_and_measure(system, params, grid, grid, [])
    tables = {
        "1_refractory_period": refractory_period(topo, params),
        "2_kinetic_lag": kinetic_lag(df_prot, df_rna, grid),
        "3_saturation": transcriptional_saturation(topo, params, df_rna),
        "4_feedback_gain": feedback_gain(topo, params, df_tf),
    }
    if out_dir is not None:
        w = TableWriter(os.path.join(str(out_dir), "mechanistic_discovery_report.xlsx"))
        for name, table in tables.items():
            w.add(name, table)
        w.save()
    return tables
