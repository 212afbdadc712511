"""Table utilities: the CSV reader, the kinase-set parser, the observed /
estimated merge and the results-directory organiser.

Counterpart of ``phoskintime_tpu/io/utils.py``. A table here is a dict of
equal-length 1-D numpy columns (what :func:`read_csv` returns) where the
JAX package has a pandas DataFrame: a numeric column is float64 (int64
where every cell is an integer), a missing number NaN; any other column is
an object array of strings, a missing cell None.
"""

from __future__ import annotations

import csv
import os
import shutil

import numpy as np
import torch

#: the cells pandas' ``read_csv`` reads as missing by default
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _column(cells: list[str]) -> np.ndarray:
    """One column, typed as pandas types it: integers (no missing cell)
    int64, numbers float64 (missing NaN), anything else strings (missing
    None)."""
    missing = [c in NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not any(missing) and present:
        try:
            return np.array([int(c) for c in present], np.int64)
        except ValueError:
            pass
    try:
        return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)], float)
    except ValueError:
        return np.array([None if m else c for c, m in zip(cells, missing)], dtype=object)


def read_csv(path) -> dict:
    """A CSV file with a header row as {column: 1-D array} (see the module
    doc for the typing); a short row's missing cells are missing values."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], rows[1:]
    return {name: _column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(header)}


def write_csv(path, table: dict) -> str:
    """Write a column table as CSV with a header row: NaN and None as
    empty cells, floats by ``repr`` (they read back exactly)."""
    names = list(table)
    cols = [np.asarray(table[c]) for c in names]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(names)
        for i in range(len(cols[0]) if cols else 0):
            w.writerow([_cell(col[i]) for col in cols])
    return str(path)


def _cell(v) -> str:
    if is_missing(v):
        return ""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def host(x) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, float)


def n_rows(table: dict) -> int:
    """The length of a column table (0 without columns)."""
    return len(next(iter(table.values()))) if table else 0


def take(table: dict, rows) -> dict:
    """The rows ``rows`` (indices or a boolean mask) of every column."""
    return {k: np.asarray(v)[rows] for k, v in table.items()}


def is_missing(v) -> bool:
    """A missing cell: None or a float NaN."""
    return v is None or (isinstance(v, (float, np.floating)) and np.isnan(v))


def as_numbers(col) -> np.ndarray:
    """A column as float64, a cell that is not a number NaN
    (``pd.to_numeric(errors="coerce")``)."""
    col = np.asarray(col)
    if col.dtype.kind in "fiub":
        return col.astype(float)
    out = np.full(len(col), np.nan)
    for i, v in enumerate(col):
        if is_missing(v):
            continue
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def parse_kinase_set(cell, upper: bool = False) -> list[str]:
    """Parse a '{K1, K2}' kinase-set cell into a list of kinase names
    (upper-cased with ``upper``)."""
    out = []
    for k in str(cell).strip("{}").split(","):
        k = k.strip()
        if k:
            out.append(k.upper() if upper else k)
    return out


def merge_obs_est(df_obs: dict, df_est: dict, keys: list[str] | None = None) -> dict:
    """Observed beside estimated rows with their residual: an inner join
    on ``keys`` (default: those of protein, psite and time both tables
    have), each observed row in order joined to its matches in estimated
    order; a column both tables have besides the keys takes the suffixes
    ``_obs`` and ``_est``. ``residual`` is fc (or fc_obs) minus pred_fc (or
    fc_est)."""
    if keys is None:
        keys = [c for c in ("protein", "psite", "time") if c in df_obs and c in df_est]
    index: dict = {}
    for j, key in enumerate(zip(*(df_est[k] for k in keys))):
        index.setdefault(key, []).append(j)
    pairs = [(i, j) for i, key in enumerate(zip(*(df_obs[k] for k in keys)))
             for j in index.get(key, ())]
    li = np.asarray([i for i, _ in pairs], int)
    ri = np.asarray([j for _, j in pairs], int)
    out = {k: np.asarray(df_obs[k])[li] for k in keys}
    for table, other, rows, suffix in ((df_obs, df_est, li, "_obs"), (df_est, df_obs, ri, "_est")):
        for c in table:
            if c not in keys:
                out[c + suffix if c in other else c] = np.asarray(table[c])[rows]
    ocol = "fc" if "fc" in out else "fc_obs"
    ecol = "pred_fc" if "pred_fc" in out else "fc_est"
    out["residual"] = np.asarray(out[ocol], float) - np.asarray(out[ecol], float)
    return out


def organize_output_files(out_dir: str, patterns: dict[str, str] | None = None):
    """Move the loose files of ``out_dir`` into subfolders by suffix
    (figures, tables, workbooks, LaTeX; ``report.html`` stays). Returns the
    names moved."""
    out_dir = str(out_dir)
    patterns = patterns or {"figures": ".png", "tables": ".csv",
                            "workbooks": ".xlsx", "latex": ".tex"}
    moved = []
    for fname in os.listdir(out_dir):
        src = os.path.join(out_dir, fname)
        if not os.path.isfile(src):
            continue
        for sub, suffix in patterns.items():
            if fname.endswith(suffix) and fname != "report.html":
                dst_dir = os.path.join(out_dir, sub)
                os.makedirs(dst_dir, exist_ok=True)
                shutil.move(src, os.path.join(dst_dir, fname))
                moved.append(fname)
                break
    return moved
