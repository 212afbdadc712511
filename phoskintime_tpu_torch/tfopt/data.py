"""tfopt data construction from the input1/input3/input4 tables.

Counterpart of ``phoskintime_tpu/tfopt/data.py``: align mRNA (9-point
grid) with the TF protein and psite series (14-point grid), build the
regulator map from the TF network, keep only genes with >= 1 regulator and
the TFs that regulate a kept gene, and pad the psite series into a (n_TF,
n_psite_max, T) tensor. The tables are read by column (a column dict, as
:func:`~phoskintime_tpu_torch.io.utils.read_csv` returns, or a pandas
frame where the caller has one).
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu_torch.io.utils import read_csv
from phoskintime_tpu_torch.kinopt.data import _col, _has_site, _n_rows
from phoskintime_tpu_torch.tfopt.model import TfoptProblem

PROT_COLS = [f"x{i}" for i in range(1, 15)]
RNA_COLS = [f"x{i}" for i in range(1, 10)]


def _names(table) -> list:
    return list(table.columns if hasattr(table, "columns") else table)


def _ids(values) -> list[str]:
    return [str(v).strip().upper() for v in values]


def load_tfopt_problem(input1_path, input3_path, input4_path, *,
                       lb=-4.0, ub=4.0, T_use=9) -> tuple[TfoptProblem, dict]:
    """The padded problem and its metadata from the three CSV files."""
    return build_tfopt_problem(read_csv(input3_path), read_csv(input1_path),
                               read_csv(input4_path), lb=lb, ub=ub, T_use=T_use)


def build_tfopt_problem(mrna, prot, net, *, lb=-4.0, ub=4.0,
                        T_use=9) -> tuple[TfoptProblem, dict]:
    """mrna (GeneID, x1..x9), prot (input1: GeneID, Psite, x1..x14) and net
    (Source, Target), each a column dict or a frame."""
    gcol = "GeneID" if "GeneID" in _names(mrna) else _names(mrna)[0]
    m_gene = _ids(_col(mrna, gcol))
    p_gene = _ids(_col(prot, "GeneID"))

    # regulator map: target gene -> list of TFs (reference load_regulation)
    scol = "Source" if "Source" in _names(net) else _names(net)[0]
    tcol = "Target" if "Target" in _names(net) else _names(net)[1]
    reg_map: dict[str, list[str]] = {}
    for tf, tgt in zip(_ids(_col(net, scol)), _ids(_col(net, tcol))):
        reg_map.setdefault(tgt, [])
        if tf not in reg_map[tgt]:
            reg_map[tgt].append(tf)

    rna_cols = [c for c in RNA_COLS if c in mrna][:T_use]
    prot_cols = [c for c in PROT_COLS if c in prot]
    prot_series = (np.stack([np.asarray(prot[c], float) for c in prot_cols], axis=1)
                   if prot_cols else np.zeros((len(p_gene), 0)))

    # TF series: protein-level row (no psite) + psite rows, in row order
    psite = _col(prot, "Psite") if "Psite" in prot else np.full(len(p_gene), None)
    has_site = _has_site(psite)
    tf_protein: dict[str, np.ndarray] = {}
    tf_psites: dict[str, list[np.ndarray]] = {}
    tf_psite_labels: dict[str, list[str]] = {}
    for r, gid in enumerate(p_gene):
        if not has_site[r]:
            tf_protein.setdefault(gid, prot_series[r])
        else:
            tf_psites.setdefault(gid, []).append(prot_series[r])
            tf_psite_labels.setdefault(gid, []).append(str(psite[r]))

    # keep genes with >= 1 regulator whose TF has protein data; a duplicate
    # GeneID keeps only its FIRST row (a duplicate label would desynchronize
    # mRNA_mat from the regulators)
    first_row: dict[str, int] = {}
    for r, g in enumerate(m_gene):
        first_row.setdefault(g, r)
    gene_ids = [g for g in first_row
                if g in reg_map and any(tf in tf_protein for tf in reg_map[g])]
    gene_set = set(gene_ids)
    tf_ids = sorted({tf for g in gene_ids for tf in reg_map[g] if tf in tf_protein})
    tf2i = {tf: i for i, tf in enumerate(tf_ids)}

    rna = (np.stack([np.asarray(mrna[c], float) for c in rna_cols], axis=1) if rna_cols
           else np.zeros((_n_rows(mrna), 0)))
    expr = rna[[first_row[g] for g in gene_ids]]

    n_TF = len(tf_ids)
    n_ps = max(1, max((len(tf_psites.get(tf, [])) for tf in tf_ids), default=1))
    protein_mat = np.stack([tf_protein[tf][:T_use] for tf in tf_ids]) \
        if n_TF else np.zeros((0, T_use))
    psite_tensor = np.zeros((n_TF, n_ps, T_use))
    num_psites = np.zeros(n_TF, np.int32)
    psite_labels = []
    for i, tf in enumerate(tf_ids):
        rows = tf_psites.get(tf, [])
        num_psites[i] = len(rows)
        psite_labels.append(tf_psite_labels.get(tf, []))
        for j, series in enumerate(rows[:n_ps]):
            psite_tensor[i, j] = series[:T_use]

    n_reg = max(1, max((len([t for t in reg_map[g] if t in tf2i])
                        for g in gene_ids), default=1))
    regulators = -np.ones((len(gene_ids), n_reg), np.int32)
    for gi, g in enumerate(gene_ids):
        tfs = [t for t in reg_map[g] if t in tf2i][:n_reg]
        regulators[gi, :len(tfs)] = [tf2i[t] for t in tfs]

    prob = TfoptProblem(expr, regulators, protein_mat, psite_tensor,
                        num_psites, gene_ids, tf_ids, psite_labels, lb, ub)
    meta = {"reg_map": {g: reg_map[g] for g in gene_set}}
    return prob, meta
