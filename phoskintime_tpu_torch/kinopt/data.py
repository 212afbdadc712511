"""kinopt data construction from the input1/input2 tables.

Counterpart of ``phoskintime_tpu/kinopt/data.py``: load input1 (HGNC time
series x1..x14) and input2 (site -> {kinase set}), apply one of the kinopt
scaling methods, optionally estimate missing kinases (synthetic
protein-level rows, or pseudo-site counts from ``kinase_to_psites``), and
build the padded :class:`~phoskintime_tpu_torch.kinopt.model.KinoptProblem`.

The tables are read by column: a mapping of column name to a 1-D array
(what :func:`~phoskintime_tpu_torch.io.utils.read_csv` returns), or a
pandas frame where the caller has one; no module of the port imports
pandas. A missing value is None or NaN.
"""

from __future__ import annotations

import logging

import numpy as np

from phoskintime_tpu_torch.io.utils import is_missing, parse_kinase_set, read_csv
from phoskintime_tpu_torch.kinopt.model import KinoptProblem, build_problem

logger = logging.getLogger("phoskintime_tpu_torch")

TIME_COLS = [f"x{i}" for i in range(1, 15)]

#: pseudo-site counts for kinases absent from the MS data
#: (reference kinopt/evol/config/__init__.py:7-15)
KINASE_TO_PSITES = {
    "CDK5": 1, "TTK": 7, "GSK3B": 4, "MAP2K4": 4,
    "MAP2K1": 2, "MAP2K3": 1, "CDK4": 2,
}


def _col(table, name) -> np.ndarray:
    return np.asarray(table[name])


def _n_rows(table) -> int:
    return len(_col(table, next(iter(table.columns if hasattr(table, "columns") else table))))


def _has_site(psites) -> np.ndarray:
    """A non-missing, non-blank site label per row."""
    return np.array([not is_missing(v) and str(v).strip() != "" for v in psites], bool)


def _minmax_rows(M: np.ndarray) -> np.ndarray:
    lo = M.min(axis=1, keepdims=True)
    hi = M.max(axis=1, keepdims=True)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    return (M - lo) / span


def _minmax_cols(M: np.ndarray) -> np.ndarray:
    lo = M.min(axis=0, keepdims=True)
    hi = M.max(axis=0, keepdims=True)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    return (M - lo) / span


def apply_scaling(df, time_cols=TIME_COLS, method: str = "none",
                  split_point: int = 9, segment_points=None):
    """kinopt scaling modes (reference kinopt/evol/utils/iodata.py:58-125)
    on a copy of the table (a column dict or a frame), the time columns
    replaced."""
    df = df.copy()
    cols = [c for c in time_cols if c in df]
    M = np.stack([np.asarray(df[c], float) for c in cols], axis=1) if cols else \
        np.zeros((_n_rows(df), 0))
    if method == "min_max":
        M = _minmax_rows(M)
    elif method == "log":
        M = np.log(M)
    elif method == "temporal":
        M[:, :split_point] = _minmax_cols(M[:, :split_point])
        M[:, split_point:] = _minmax_cols(M[:, split_point:])
    elif method == "segmented":
        if not segment_points:
            raise ValueError("segment_points required for segmented scaling")
        for a, b in zip(segment_points[:-1], segment_points[1:]):
            M[:, a:b] = _minmax_cols(M[:, a:b])
    elif method == "slope":
        d = np.diff(M, axis=1, prepend=M[:, :1])
        d[:, 0] = 0.0
        M = _minmax_cols(d)
    elif method == "cumulative":
        M = _minmax_cols(np.cumsum(M, axis=1))
    elif method == "none":
        pass
    else:
        raise ValueError(f"Invalid scaling method {method}")
    for j, c in enumerate(cols):
        df[c] = M[:, j]
    return df


def load_kinopt_problem(input1_path, input2_path, *, scaling_method="none",
                        split_point=9, segment_points=None,
                        estimate_missing_kinases=True,
                        lb=-4.0, ub=4.0,
                        kinase_to_psites: dict | None = None):
    """Build a :class:`KinoptProblem` plus bookkeeping metadata from the two
    CSV files."""
    return build_kinopt_problem(read_csv(input1_path), read_csv(input2_path),
                                scaling_method=scaling_method,
                                split_point=split_point,
                                segment_points=segment_points,
                                estimate_missing_kinases=estimate_missing_kinases,
                                lb=lb, ub=ub, kinase_to_psites=kinase_to_psites)


def build_kinopt_problem(full, inter, *, scaling_method="none", split_point=9,
                         segment_points=None, estimate_missing_kinases=True,
                         lb=-4.0, ub=4.0,
                         kinase_to_psites: dict | None = None) -> tuple[KinoptProblem, dict]:
    """The padded problem from input1 (``full``: GeneID, Psite, x1..x14) and
    input2 (``inter``: GeneID, Psite, Kinase), each a column dict or a
    frame."""
    full = apply_scaling(full, TIME_COLS, scaling_method, split_point, segment_points)
    cols = [c for c in TIME_COLS if c in full]
    series = (np.stack([np.asarray(full[c], float) for c in cols], axis=1) if cols
              else np.zeros((_n_rows(full), 0)))
    f_gene, f_psite = _col(full, "GeneID"), _col(full, "Psite")
    f_has_site = _has_site(f_psite)

    kin_sets = [parse_kinase_set(c) for c in _col(inter, "Kinase")]
    rows = list(zip(_col(inter, "GeneID"), _col(inter, "Psite"), kin_sets))
    if not estimate_missing_kinases:
        known = {str(g) for g in f_gene}
        rows = [r for r in rows if all(k in known for k in r[2])]

    # observed site series P_obs
    gp_names, P_rows, site_kinase_names = [], [], []
    for gene, psite, kins in rows:
        hit = np.flatnonzero((f_gene == gene) & (f_psite == psite))
        if not len(hit):
            continue
        gp_names.append((gene, psite))
        P_rows.append(series[hit[0]])
        site_kinase_names.append(list(kins))
    P_obs = np.asarray(P_rows)

    # kinase signal source rows (reference _build_k_array)
    K_rows: list[np.ndarray] = []
    K_index: dict[str, list[tuple[str, int]]] = {}
    unique_kinases = sorted({k for ks in site_kinase_names for k in ks})
    k2p = KINASE_TO_PSITES if kinase_to_psites is None else kinase_to_psites
    for kin in unique_kinases:
        is_kin = f_gene == kin
        site_rows = np.flatnonzero(is_kin & f_has_site)
        if len(site_rows):
            for r in site_rows:
                K_index.setdefault(kin, []).append((str(f_psite[r]), len(K_rows)))
                K_rows.append(series[r])
        elif estimate_missing_kinases:
            prot = np.flatnonzero(is_kin & ~f_has_site)
            base = series[prot[0]] if len(prot) else np.zeros(len(cols))
            for s in range(int(k2p.get(kin, 1))):
                K_index.setdefault(kin, []).append((f"P{s + 1}", len(K_rows)))
                K_rows.append(base)
        else:
            # the kinase has only a protein-level row and estimation is off:
            # it passed the 'known' filter yet contributes no signal rows
            logger.warning(
                f"[kinopt] kinase {kin} has no site rows and "
                f"estimate_missing_kinases=False — sites driven only by "
                f"it will be dropped")
    K_array = np.asarray(K_rows) if K_rows else np.zeros((1, len(cols)))

    kinases = [k for k in unique_kinases if k in K_index]
    k2i = {k: i for i, k in enumerate(kinases)}
    kinase_rows = [[idx for (_, idx) in K_index[k]] for k in kinases]
    site_kinases = [[k2i[k] for k in ks if k in k2i] for ks in site_kinase_names]
    keep = [i for i, sk in enumerate(site_kinases) if sk]
    P_obs = P_obs[keep]
    site_kinases = [site_kinases[i] for i in keep]
    gp_names = [gp_names[i] for i in keep]

    prob = build_problem(P_obs, site_kinases, kinase_rows, K_array,
                         gp_names=gp_names, kinase_names=kinases, lb=lb, ub=ub)
    meta = {"K_index": {k: K_index[k] for k in kinases}, "time_cols": cols}
    return prob, meta


def check_kinases(full, inter) -> dict:
    """Report kinases referenced in input2 but missing from input1
    (reference kinopt/evol/optcon/construct.py:331+)."""
    known = {str(g) for g in _col(full, "GeneID")}
    referenced = set()
    for cell in _col(inter, "Kinase"):
        referenced.update(parse_kinase_set(str(cell)))
    missing = sorted(referenced - known)
    return {"referenced": sorted(referenced), "missing": missing,
            "n_missing": len(missing)}
