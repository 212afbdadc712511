"""Data loading, scaling and reshaping.

Counterpart of ``phoskintime_tpu/io/load.py``, without pandas: the tables
are column dicts (:mod:`phoskintime_tpu_torch.io.utils`) where the JAX
package has DataFrames, in the same row order. What the port does as
pandas does:

* the wide table (x1..xN) becomes a tidy one x-column by x-column: every
  input row's value at x1, then at x2, ..., rows whose value is missing
  dropped after that;
* ``drop_duplicates`` keeps each row's first occurrence;
* a missing cell turned into text reads ``"nan"``, as ``str`` of pandas'
  NaN does; a missing site becomes ``""`` (``fillna("")``), and a site
  written ``"nan"`` or ``"NaN"`` marks a protein row as well;
* a time-point cell that is not a number is NaN (``pd.to_numeric(...,
  errors="coerce")``).

An Excel path is read through its CSV sibling ``<stem>_<sheet_slug>.csv``
(what the exporters write without an Excel engine): the port reads no
workbook.
"""

from __future__ import annotations

import os
import re

import numpy as np

from phoskintime_tpu_torch.config.logconf import setup_logger
from phoskintime_tpu_torch.io.utils import (as_numbers, is_missing, n_rows, parse_kinase_set,
                                            read_csv, take)

logger = setup_logger()


def normalize_columns(df: dict) -> dict:
    """The table with each column name stripped and lower-cased."""
    return {str(c).strip().lower(): v for c, v in df.items()}


def find_col(df: dict, candidates: list[str]) -> str | None:
    """The first of ``candidates`` that names a column, else None."""
    for c in candidates:
        if c in df:
            return c
    return None


def read_table(path: str, sheet_name: str | None = None) -> dict | None:
    """A CSV file, or the CSV sibling of an Excel workbook's sheet
    (``<stem>_<sheet_slug>.csv``; the first sheet is ``sheet1``); None
    where neither exists."""
    if path is None or not os.path.exists(str(path)):
        if path and sheet_name and str(path).endswith(".xlsx"):
            alt = _sheet_csv_path(path, sheet_name)
            if os.path.exists(alt):
                return read_csv(alt)
        return None
    p = str(path)
    if p.endswith((".xlsx", ".xls")):
        alt = _sheet_csv_path(p, sheet_name or "sheet1")
        if os.path.exists(alt):
            return read_csv(alt)
        logger.warning(f"[Data] the port reads no Excel workbook and {p} has no CSV sibling")
        return None
    return read_csv(p)


def _sheet_csv_path(path: str, sheet_name: str) -> str:
    slug = re.sub(r"\W+", "_", sheet_name.strip().lower())
    return re.sub(r"\.xlsx?$", f"_{slug}.csv", str(path))


def _text(v) -> str:
    """A cell as text, a missing one ``"nan"``."""
    return "nan" if is_missing(v) else str(v)


def _first_rows(table: dict, cols) -> dict:
    """The rows whose values in ``cols`` have not appeared before
    (``drop_duplicates``, keep first)."""
    seen, keep = set(), []
    for i, key in enumerate(zip(*(table[c] for c in cols))):
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return take(table, np.asarray(keep, int))


# ---------------------------------------------------------------------------
# scaling + melt
# ---------------------------------------------------------------------------

def _row_reduce(M: np.ndarray, op) -> np.ndarray:
    """A NaN-skipping reduction over each row's x-columns, taken column
    after column as pandas' block layout does (the columns on the leading
    axis)."""
    return op(np.ascontiguousarray(M.T), axis=0)


def process_and_scale_raw_data(df, time_points, id_cols,
                               scale_method: str = "fc_start",
                               epsilon: float = 1e-3) -> dict:
    """Wide (x1..xN) -> tidy {id_cols..., fc, time}, scaled by
    ``scale_method``: "raw"/"none", "fc_start" (over x1, a zero x1 taken
    as ``epsilon``), "robust_fc" (over x1 + epsilon), "max_scale",
    "mean_scale", "l2_norm" (over the row's max, mean or 2-norm, a zero
    one taken as ``epsilon``)."""
    empty = {c: np.asarray([], dtype=object) for c in id_cols} | {
        "time": np.asarray([], float), "fc": np.asarray([], float)}
    if df is None or n_rows(df) == 0:
        return empty
    x_cols = sorted([c for c in df if re.fullmatch(r"x\d+", str(c))],
                    key=lambda c: int(str(c)[1:]))
    if not x_cols:
        logger.warning("[Data] no x-columns found; returning an empty table")
        return empty
    x_cols = x_cols[: len(time_points)]
    times = np.asarray(time_points, float)[: len(x_cols)]

    M = np.stack([as_numbers(df[c]) for c in x_cols], axis=1)           # (rows, x)
    if scale_method in ("raw", "none"):
        pass
    elif scale_method == "fc_start":
        start = M[:, 0]
        M = M / np.where(start == 0, epsilon, start)[:, None]
    elif scale_method == "robust_fc":
        M = M / (M[:, :1] + epsilon)
    elif scale_method in ("max_scale", "mean_scale", "l2_norm"):
        if scale_method == "max_scale":
            d = np.where(np.isnan(M), -np.inf, M).max(axis=1)
            d[np.isnan(M).all(axis=1)] = np.nan
        elif scale_method == "mean_scale":
            n = (~np.isnan(M)).sum(axis=1)
            d = _row_reduce(M, np.nansum) / np.where(n > 0, n, np.nan)
        else:
            d = np.sqrt(_row_reduce(M ** 2, np.nansum))
        M = M / np.where(d == 0, epsilon, d)[:, None]
    else:
        raise ValueError(f"Unknown scale_method {scale_method}")

    ids = [c for c in id_cols if c in df]
    rows = n_rows(df)
    fc = M.T.reshape(-1)                                # x-column-major, as melt stacks
    keep = ~np.isnan(fc)
    out = {c: np.tile(np.asarray(df[c], dtype=object), len(x_cols))[keep] for c in ids}
    out["fc"] = fc[keep]
    out["time"] = np.repeat(times, rows)[keep]
    if "protein" in out:
        out["protein"] = np.asarray([_text(v).strip().upper() for v in out["protein"]],
                                    dtype=object)
    if "psite" in out:
        out["psite"] = np.asarray(["" if is_missing(v) else str(v).strip()
                                   for v in out["psite"]], dtype=object)
    return out


def explode_kinase_sets(df, pcol, scol, kcol) -> dict:
    """{K1, K2} cells -> one row per kinase: {protein, psite, kinase},
    duplicates dropped (the first kept)."""
    rows = [(_text(p).strip().upper(), _text(s).strip(), k)
            for p, s, cell in zip(df[pcol], df[scol], df[kcol])
            for k in parse_kinase_set(_text(cell), upper=True)]
    table = {c: np.asarray([r[j] for r in rows], dtype=object)
             for j, c in enumerate(("protein", "psite", "kinase"))}
    return _first_rows(table, ("protein", "psite", "kinase"))


def _renamed(df: dict, names: dict) -> dict:
    return {names.get(c, c): v for c, v in df.items()}


def _global_rows(df: dict) -> np.ndarray:
    """Rows of a beta sheet without a site: a missing or blank psite."""
    return np.asarray([is_missing(v) or str(v).strip() == "" for v in df["psite"]], bool)


# ---------------------------------------------------------------------------
# the full load
# ---------------------------------------------------------------------------

def load_data(kinase_net, tf_net, ms, rna, kinopt_path=None, tfopt_path=None,
              time_points_protein=None, time_points_rna=None,
              scaling_method: str = "raw"):
    """Load the global model's data.

    Returns (kin, tf, prot, pho, rna, kin_beta_map, tf_beta_map, kin_alpha,
    tf_edge_weights): ``kin`` {protein, psite, kinase, alpha}, ``tf`` {tf,
    target, alpha}, ``prot`` {protein, time, fc}, ``pho`` {protein, psite,
    time, fc}, ``rna`` {protein, fc, time}, each a column dict in the JAX
    package's row order, and the four prior maps."""
    # --- kinase network + alpha priors ----------------------------------
    df_kin = normalize_columns(read_csv(kinase_net))
    pcol = find_col(df_kin, ["geneid", "protein", "gene"])
    scol = find_col(df_kin, ["psite", "site"])
    kcol = find_col(df_kin, ["kinase", "k"])
    kin = explode_kinase_sets(df_kin, pcol, scol, kcol)

    kin_alpha, kin_beta_map = {}, {}
    df_ka = read_table(kinopt_path, "Alpha Values")
    if df_ka is not None:
        df_ka = _renamed(df_ka, {"Gene": "protein", "Psite": "psite", "Kinase": "kinase",
                                 "Alpha": "alpha"})
        for p, s, k, a in zip(df_ka["protein"], df_ka["psite"], df_ka["kinase"],
                              df_ka["alpha"]):
            kin_alpha[(_text(p).strip().upper(), _text(s).strip(),
                       _text(k).strip().upper())] = float(a)
    df_kb = read_table(kinopt_path, "Beta Values")
    if df_kb is not None:
        df_kb = _renamed(df_kb, {"Kinase": "kinase", "Beta": "beta", "Psite": "psite"})
        if "psite" not in df_kb:
            # a per-kinase beta sheet: every row is a global beta
            df_kb["psite"] = np.full(n_rows(df_kb), "", dtype=object)
        g = _global_rows(df_kb)
        kin_beta_map = {_text(k).upper(): float(b)
                        for k, b in zip(np.asarray(df_kb["kinase"])[g],
                                        np.asarray(df_kb["beta"])[g])}
    kin["alpha"] = np.asarray([kin_alpha.get(key, 1.0) for key in
                               zip(kin["protein"], kin["psite"], kin["kinase"])], float)

    # --- TF network + alpha priors ---------------------------------------
    df_tf = normalize_columns(read_csv(tf_net))
    scol_tf = find_col(df_tf, ["source", "tf"])
    tcol = find_col(df_tf, ["target", "gene"])
    tf = _first_rows({
        "tf": np.asarray([_text(v).strip().upper() for v in df_tf[scol_tf]], dtype=object),
        "target": np.asarray([_text(v).strip().upper() for v in df_tf[tcol]], dtype=object),
    }, ("tf", "target"))

    tf_edge_weights, tf_beta_map = {}, {}
    df_ta = read_table(tfopt_path, "Alpha Values")
    if df_ta is not None:
        df_ta = _renamed(df_ta, {"mRNA": "target", "TF": "tf", "Value": "alpha"})
        for t, g, a in zip(df_ta["tf"], df_ta["target"], df_ta["alpha"]):
            tf_edge_weights[(_text(t).strip().upper(), _text(g).strip().upper())] = float(a)
    df_tb = read_table(tfopt_path, "Beta Values")
    if df_tb is not None:
        df_tb = _renamed(df_tb, {"TF": "tf", "Value": "beta", "PSite": "psite",
                                 "Psite": "psite"})
        if "psite" in df_tb:
            df_tb = take(df_tb, _global_rows(df_tb))
        tf_beta_map = {_text(t).upper(): float(b) for t, b in zip(df_tb["tf"], df_tb["beta"])}
    tf["alpha"] = np.asarray([tf_edge_weights.get(key, 1.0)
                              for key in zip(tf["tf"], tf["target"])], float)

    # --- MS data (protein + phospho split) --------------------------------
    ms_norm = normalize_columns(read_csv(ms))
    gcol = find_col(ms_norm, ["geneid", "protein"])
    ms_norm = _renamed(ms_norm, {gcol: "protein"})
    if "psite" not in ms_norm:
        ms_norm["psite"] = np.full(n_rows(ms_norm), "", dtype=object)
    tidy = process_and_scale_raw_data(ms_norm, time_points_protein, ["protein", "psite"],
                                      scaling_method)
    is_prot = np.asarray([s == "" or s in ("nan", "NaN") for s in tidy["psite"]], bool)
    prot = {c: tidy[c][is_prot] for c in ("protein", "time", "fc")}
    pho = {c: tidy[c][~is_prot] for c in ("protein", "psite", "time", "fc")}

    # --- RNA data ----------------------------------------------------------
    df_rna = normalize_columns(read_csv(rna))
    gcol = find_col(df_rna, ["geneid", "mrna", "gene", "protein"])
    df_rna = _renamed(df_rna, {gcol: "protein"})
    rna_t = process_and_scale_raw_data(df_rna, time_points_rna, ["protein"], scaling_method)

    return (kin, tf, prot, pho, rna_t, kin_beta_map, tf_beta_map, kin_alpha, tf_edge_weights)
