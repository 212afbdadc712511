"""Post-fit performance analysis.

Counterpart of ``phoskintime_tpu/analysis/postfit.py``: goodness of fit per
series, the indicator summary of a multi-objective result (hypervolume,
its history, ASF and pseudo-weight picks) and the residual summary, on the
host with numpy.
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu_torch.io.export import rows_to_table
from phoskintime_tpu_torch.ops.indicators import asf_pick, hypervolume, igd_plus, pseudo_weight_pick


def goodness_of_fit(observed: np.ndarray, estimated: np.ndarray, labels=None) -> dict:
    """Per-series R^2, RMSE, MAE and correlation as a table (series, r2,
    rmse, mae, corr)."""
    obs = np.atleast_2d(np.asarray(observed, float))
    est = np.atleast_2d(np.asarray(estimated, float))
    rows = []
    for i in range(obs.shape[0]):
        o, e = obs[i], est[i]
        ss_res = float(((o - e) ** 2).sum())
        ss_tot = float(((o - o.mean()) ** 2).sum())
        rows.append({
            "series": labels[i] if labels is not None else i,
            "r2": 1 - ss_res / ss_tot if ss_tot > 0 else np.nan,
            "rmse": float(np.sqrt(((o - e) ** 2).mean())),
            "mae": float(np.abs(o - e).mean()),
            "corr": (np.corrcoef(o, e)[0, 1] if o.std() > 0 and e.std() > 0 else np.nan),
        })
    return rows_to_table(rows, ["series", "r2", "rmse", "mae", "corr"])


def optimization_performance(result, ref_point=None, asf_weights=(1.0, 1.0, 1.0)) -> dict:
    """Indicators of a result with ``pareto_F`` (and ``history``): the
    final front's hypervolume, the hypervolume of each generation's least
    objectives, and the ASF and pseudo-weight picks."""
    F = np.atleast_2d(np.asarray(result.pareto_F, float))
    m = F.shape[1]
    rp = (np.asarray(ref_point, float) if ref_point is not None
          else F.max(axis=0) * 1.1 + 1e-9)
    out = {"hypervolume": hypervolume(F, rp), "n_pareto": len(F),
           "ideal": F.min(axis=0), "nadir": F.max(axis=0)}
    if m > 1:
        w = np.asarray(asf_weights, float)[:m]
        out["asf_pick"] = asf_pick(F, w)
        out["pseudo_weight_pick"] = pseudo_weight_pick(F, w)
        out["igd_plus_vs_self"] = igd_plus(F, F)  # 0 by construction
    hist = getattr(result, "history", None) or []
    out["hv_history"] = [(g, hypervolume(np.atleast_2d(mins), rp)) for g, mins, *_ in hist]
    return out


def residual_summary(residuals: np.ndarray) -> dict:
    """Mean, std, largest magnitude, skew and lag-1 autocorrelation."""
    r = np.asarray(residuals, float).ravel()
    return {
        "mean": float(r.mean()),
        "std": float(r.std()),
        "max_abs": float(np.abs(r).max()),
        "skew": float(((r - r.mean()) ** 3).mean() / max(r.std() ** 3, 1e-12)),
        "lag1_autocorr": (float(np.corrcoef(r[:-1], r[1:])[0, 1])
                          if len(r) > 2 and r.std() > 0 else np.nan),
    }
