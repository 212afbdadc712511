"""Raw-data preprocessing: CollecTRI, MS-Gaussian and Rout-Limma tables
into the model's input CSVs.

Counterpart of ``phoskintime_tpu/io/preprocess.py``, on column dicts
(:mod:`phoskintime_tpu_torch.io.utils`) where the JAX package has
DataFrames, writing with the ``csv`` module:

* CollecTRI -> input4.csv (TF network; COMPLEX sources dropped, targets
  filtered to the genes of input2);
* MS-Gaussian -> input1.csv (2^predict_mean fold changes pivoted to
  x1..x14, sites formatted, kept where they start Y_/S_/T_ or are
  protein rows) and input1_wstd.csv (their propagated stds:
  sigma_y = 2^x ln2 sigma_x);
* Rout-Limma -> input3.csv (the mRNA series).

A pivot keeps, as ``pivot_table(aggfunc="first")`` does, the first
non-missing value of each (row key, time) group, drops groups with a
missing key or no value, and sorts rows by key and columns by time. The
gene-ID symbol mapping is passed in as a dict.
"""

from __future__ import annotations

import os

import numpy as np

from phoskintime_tpu_torch.config.logconf import setup_logger
from phoskintime_tpu_torch.io.utils import is_missing, n_rows, read_csv, take, write_csv

logger = setup_logger()


def format_site(site) -> str:
    """Upper-case the residue prefix, keeping the suffix after '_'."""
    if is_missing(site) or site == "":
        return ""
    site = str(site)
    if "_" in site:
        before, after = site.split("_", 1)
        return before.upper() + "_" + after
    return site.upper()


def _pivot_first(keys: list, times, values) -> tuple[list, list, np.ndarray]:
    """(sorted row keys, sorted times, (rows, times) values) of the first
    non-missing value of each (key, time) group."""
    first: dict = {}
    for key, t, v in zip(keys, times, values):
        if any(is_missing(k) for k in key) or is_missing(t) or np.isnan(v):
            continue
        first.setdefault((key, t), float(v))
    row_keys = sorted({k for k, _ in first})
    cols = sorted({t for _, t in first})
    r_of, c_of = {k: i for i, k in enumerate(row_keys)}, {t: j for j, t in enumerate(cols)}
    M = np.full((len(row_keys), len(cols)), np.nan)
    for (k, t), v in first.items():
        M[r_of[k], c_of[t]] = v
    return row_keys, cols, M


def _x_name(t, suffix: str = "") -> str:
    """The column of time index t: x1..x14 for 0..13, else the value."""
    return f"x{int(t) + 1}{suffix}" if t == int(t) and 0 <= int(t) < 14 else str(t)


def _site_cells(col) -> list[str]:
    return ["" if is_missing(v) else str(v) for v in col]


def _keep_sites(table: dict) -> dict:
    """Sites formatted; rows kept whose site starts Y_/S_/T_ or is empty."""
    table["Psite"] = np.asarray([format_site(s) for s in table["Psite"]], dtype=object)
    keep = np.asarray([s.startswith(("Y_", "S_", "T_")) or s == "" for s in table["Psite"]],
                      bool)
    return take(table, keep)


def _wide(msgauss: dict, values, suffix: str = "") -> dict:
    keys = list(zip(msgauss["GeneID"], _site_cells(msgauss["site"])))
    rows, cols, M = _pivot_first(keys, msgauss["unit_time"], values)
    out = {"GeneID": np.asarray([g for g, _ in rows], dtype=object),
           "Psite": np.asarray([s for _, s in rows], dtype=object)}
    out.update({_x_name(t, suffix): M[:, j] for j, t in enumerate(cols)})
    return out


def process_collecttri(collecttri: dict, input2: dict) -> dict:
    """CollecTRI -> input4 {Source, Target}, filtered to input2's genes."""
    src = collecttri["source"]
    s_sym, t_sym = collecttri["source_genesymbol"], collecttri["target_genesymbol"]
    genes = {str(g).strip() for g in input2["GeneID"] if not is_missing(g)}
    seen, rows = set(), []
    for s, a, b in zip(src, s_sym, t_sym):
        if str(s).startswith("COMPLEX") or is_missing(a) or is_missing(b):
            continue
        if str(a).strip() == "" or str(b).strip() == "" or (a, b) in seen:
            continue
        seen.add((a, b))
        if b in genes:
            rows.append((a, b))
    logger.info(f"[Prep] CollecTRI -> {len(rows)} TF-mRNA edges")
    return {"Source": np.asarray([a for a, _ in rows], dtype=object),
            "Target": np.asarray([b for _, b in rows], dtype=object)}


def process_msgauss(msgauss: dict) -> dict:
    """MS-Gaussian -> input1's wide fold-change table (x1..x14)."""
    fc = 2.0 ** np.asarray(msgauss["predict_mean"], float)
    return _keep_sites(_wide(msgauss, fc))


def process_msgauss_std(msgauss: dict) -> dict:
    """MS-Gaussian -> input1_wstd: the fold changes and their propagated
    stds (x1_std..x14_std), rows in both pivots."""
    fc = 2.0 ** np.asarray(msgauss["predict_mean"], float)
    pm = _wide(msgauss, fc)
    ps = _wide(msgauss, fc * np.log(2) * np.asarray(msgauss["predict_std"], float), "_std")
    at = {k: i for i, k in enumerate(zip(ps["GeneID"], ps["Psite"]))}
    li = [i for i, k in enumerate(zip(pm["GeneID"], pm["Psite"])) if k in at]
    ri = [at[k] for k in zip(pm["GeneID"], pm["Psite"]) if k in at]
    out = take(pm, np.asarray(li, int))
    out.update({c: v[np.asarray(ri, int)] for c, v in ps.items() if c not in ("GeneID", "Psite")})
    return _keep_sites(out)


def process_routlimma(routlimma: dict, value_col: str = "logFC", gene_col: str = "GeneID",
                      time_col: str = "unit_time", log2: bool | None = None) -> dict:
    """Rout-Limma mRNA table -> input3's wide table (x1.. in time order).
    ``log2`` None: the values are log2 fold changes when every |value| is
    below 20 (logged)."""
    v = np.asarray(routlimma[value_col], float)
    if log2 is None:
        vmax = float(np.nanmax(np.abs(v)))
        log2 = bool(vmax < 20)
        logger.info(f"[Prep] Rout-Limma values treated as {'log2FC' if log2 else 'raw FC'} "
                    f"(max |v| = {vmax:.3g}); pass log2= to override")
    fc = 2.0 ** v if log2 else v
    rows, cols, M = _pivot_first([(g,) for g in routlimma[gene_col]], routlimma[time_col], fc)
    out = {gene_col: np.asarray([g for g, in rows], dtype=object)}
    out.update({f"x{j + 1}": M[:, j] for j in range(len(cols))})
    logger.info(f"[Prep] Rout-Limma -> {len(rows)} genes x {len(cols)} timepoints")
    return out


def map_gene_symbols(df: dict, mapping: dict[str, str], column: str = "GeneID") -> dict:
    """Apply an ID -> HGNC symbol mapping to one column (a copy); IDs
    without an entry stay."""
    out = dict(df)
    out[column] = np.asarray([mapping.get(g, g) for g in df[column]], dtype=object)
    return out


def run_cleanup(base_dir, out_dir=".", gene_mapping: dict | None = None) -> dict:
    """The ``prep`` pipeline over a raw-data directory: writes input1,
    input1_wstd (from ``MS_Gaussian*``), input4 (``CollecTRI.csv``),
    input3 (a ``*limma*`` file) and input2 into ``out_dir``; returns
    {file name: table}. ``gene_mapping`` maps the raw tables' GeneIDs
    first, so that every output is in one ID space."""
    base_dir = str(base_dir)
    read = lambda name: read_csv(os.path.join(base_dir, name))

    def mapped(df):
        if gene_mapping and "GeneID" in df:
            return map_gene_symbols(df, gene_mapping)
        return df

    input2 = mapped(read("input2.csv"))
    names = os.listdir(base_dir)
    ms_name = next((f for f in names if f.startswith("MS_Gaussian")), None)
    outputs = {}
    if ms_name:
        ms = mapped(read(ms_name))
        outputs["input1.csv"] = process_msgauss(ms)
        outputs["input1_wstd.csv"] = process_msgauss_std(ms)
    if os.path.exists(os.path.join(base_dir, "CollecTRI.csv")):
        outputs["input4.csv"] = process_collecttri(read("CollecTRI.csv"), input2)
    rout = next((f for f in names if "limma" in f.lower()), None)
    if rout:
        outputs["input3.csv"] = process_routlimma(mapped(read(rout)))
    outputs["input2.csv"] = input2

    for name, df in outputs.items():
        write_csv(os.path.join(str(out_dir), name), df)
        logger.info(f"[Prep] wrote {name} ({n_rows(df)} rows)")
    return outputs
