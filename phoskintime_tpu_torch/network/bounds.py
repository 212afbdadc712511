"""Data-driven biological bounds.

Counterpart of ``phoskintime_tpu/network/bounds.py``: bounds from the data's
dynamic range, the topology's density and the kinase input's variance,
tightened per mechanism. Host numpy; the observation tables are read by
column (``np.asarray(df["fc"])``), so a pandas DataFrame and the demo's
column dicts serve alike.
"""

from __future__ import annotations

import numpy as np


def _max_fc(df, default: float = 5.0) -> float:
    """The largest fold change of a table, ``default`` for none or empty."""
    fc = np.asarray([] if df is None else df["fc"], float)
    return float(fc.max()) if fc.size else default


def calculate_bio_bounds(topo, df_prot, df_rna, Kmat, model: int | None = None) -> dict:
    model = topo.model if model is None else model

    safe_prot_max = max(2.0, _max_fc(df_prot) * 1.5)
    safe_rna_max = max(2.0, _max_fc(df_rna) * 1.5)

    # mRNA kinetics
    b_min, b_max = 0.005, 0.15
    a_min, a_max = b_min * 0.1, b_max * safe_rna_max

    # protein kinetics
    d_min, d_max = 0.01, 0.10
    c_min, c_max = d_min * 0.1, d_max * safe_prot_max

    # topological sensitivity
    n_edges = int(np.count_nonzero(topo.tf_mat))
    avg_density = n_edges / max(1, topo.N)
    if avg_density < 2.0:
        e_max = 20.0
        tf_scale_min, tf_scale_max = 0.5, 5.0
    else:
        e_max = 5.0
        tf_scale_min, tf_scale_max = 0.1, 2.5

    # signaling velocity
    dp_min, dp_max = 0.1, 10.0
    kin_variance = float(np.var(np.asarray(Kmat)))
    ck_max = 15.0 if kin_variance < 0.02 else 5.0

    bounds = {
        "c_k": (0.01, ck_max),
        "A_i": (a_min, a_max),
        "B_i": (b_min, b_max),
        "C_i": (c_min, c_max),
        "D_i": (d_min, d_max),
        "Dp_i": (dp_min, dp_max),
        "E_i": (0.0, e_max),
        "tf_scale": (tf_scale_min, tf_scale_max),
    }

    if model == 1:
        bounds["Dp_i"] = (0.15, 8.0)
        lo, hi = bounds["c_k"]
        bounds["c_k"] = (lo, max(3.0, 0.75 * hi))
    elif model == 2:
        bounds["Dp_i"] = (0.2, 3.0)
        lo, hi = bounds["c_k"]
        bounds["c_k"] = (lo, min(2.5, hi))
        e_lo, e_hi = bounds["E_i"]
        bounds["E_i"] = (e_lo, min(e_hi, 2.5 if avg_density >= 2.0 else 8.0))
    elif model == 4:
        bounds["Dp_i"] = (0.1, 8.0)
        lo, hi = bounds["c_k"]
        bounds["c_k"] = (lo, min(10.0, 1.5 * hi))
        t_lo, t_hi = bounds["tf_scale"]
        bounds["tf_scale"] = (t_lo, max(t_hi, 6.0 if avg_density >= 2.0 else 10.0))

    return bounds
