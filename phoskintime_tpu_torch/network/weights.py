"""Global-model observation weighting schemes.

Counterpart of ``phoskintime_tpu/network/weights.py``, host numpy, the
same schemes.

Spec: reference ``global_model/optproblem.py:163-352`` — ~15 named
time-weighting schemes (uniform, linear/quad/exp early & late, inv_time,
inv_sqrt_time, log_early, piecewise_early_boost, gaussian_center,
logistic_early, distance_from_baseline, boost_rna_times) each with a
``_mean1`` mean-normalized variant; plus the per-modality factory.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def get_weight_options(time_points, *, rna_time_points=None, early_window=None,
                       center=None, baseline=None, eps=1e-12) -> dict[str, Callable]:
    t = np.asarray(time_points, float)
    tmin, tmax = float(t.min()), float(t.max())
    trng = max(tmax - tmin, eps)

    if early_window is None:
        early_window = float(np.quantile(t, 0.20))
    if center is None:
        center = float(np.median(t))
    if baseline is None:
        baseline = tmin

    c = (center - tmin) / trng
    sigma = 0.18
    k = 10.0
    ewin = (early_window - tmin) / trng

    def clip_pos(x):
        return np.maximum(np.asarray(x, float), eps)

    def mean1(w):
        w = np.asarray(w, float)
        m = float(np.mean(w)) if w.size else 1.0
        return w / max(m, eps)

    tt_n = lambda tt: (np.asarray(tt, float) - tmin) / trng

    schemes: dict[str, Callable] = {
        "uniform": lambda tt: np.ones_like(np.asarray(tt, float)),
        "linear_early": lambda tt: 1.0 + (tmax - np.asarray(tt, float)) / max(tmax, eps),
        "linear_late": lambda tt: 1.0 + tt_n(tt),
        "quad_early": lambda tt: 1.0 + ((tmax - np.asarray(tt, float)) / trng) ** 2,
        "quad_late": lambda tt: 1.0 + tt_n(tt) ** 2,
        "exp_early": lambda tt: np.exp(2.0 * (1.0 - tt_n(tt))),
        "exp_late": lambda tt: np.exp(2.0 * tt_n(tt)),
        "inv_time": lambda tt: 1.0 / clip_pos(np.asarray(tt, float) - tmin + 1.0),
        "inv_sqrt_time": lambda tt: 1.0 / np.sqrt(clip_pos(np.asarray(tt, float) - tmin + 1.0)),
        "log_early": lambda tt: 1.0 + np.log1p((tmax - np.asarray(tt, float)) / trng),
        "piecewise_early_boost": lambda tt, boost=4.0: np.where(
            tt_n(tt) <= ewin, boost, 1.0),
        "gaussian_center": lambda tt: 1.0 + np.exp(
            -0.5 * ((tt_n(tt) - c) / sigma) ** 2),
        "logistic_early": lambda tt: 1.0 + 1.0 / (1.0 + np.exp(k * (tt_n(tt) - c))),
        "distance_from_baseline": lambda tt: 1.0 + np.abs(
            np.asarray(tt, float) - float(baseline)) / trng,
    }

    if rna_time_points is not None:
        rna_set = np.round(np.asarray(rna_time_points, float), 12)
        schemes["boost_rna_times"] = lambda tt: np.where(
            np.isin(np.round(np.asarray(tt, float), 12), rna_set), 2.0, 1.0)

    out: dict[str, Callable] = {}
    for name, f in schemes.items():
        out[name] = f
        out[name + "_mean1"] = (lambda tt, ff=f: mean1(ff(tt)))
    return out


def build_weight_functions(time_points_protein, time_points_rna,
                           scheme_prot_pho: str = "uniform",
                           scheme_rna: str = "uniform",
                           early_window_prot_pho: float = 2.0,
                           early_window_rna: float = 15.0,
                           ) -> Tuple[Callable, Callable]:
    """Per-modality weight callables (reference optproblem.py:298-352)."""
    sp = get_weight_options(np.asarray(time_points_protein, float),
                            early_window=early_window_prot_pho)
    sr = get_weight_options(np.asarray(time_points_rna, float),
                            early_window=early_window_rna)
    if scheme_prot_pho not in sp:
        raise KeyError(f"Unknown protein/phospho scheme '{scheme_prot_pho}'. "
                       f"Available: {sorted(sp)}")
    if scheme_rna not in sr:
        raise KeyError(f"Unknown RNA scheme '{scheme_rna}'. "
                       f"Available: {sorted(sr)}")
    return sp[scheme_prot_pho], sr[scheme_rna]
