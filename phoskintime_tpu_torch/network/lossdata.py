"""Pre-indexed loss data: every observation mapped to integer grid indices.

Counterpart of ``phoskintime_tpu/network/lossdata.py``. The observation
tables are dicts of equal-length columns (``{"protein": [...], "time":
[...], "fc": [...], "w": [...]}``, ``"psite"`` as well for phospho) in
place of DataFrames; a missing ``"w"`` column means weight 1.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import NamedTuple

import numpy as np


class LossData(NamedTuple):
    p_prot: np.ndarray
    t_prot: np.ndarray
    obs_prot: np.ndarray
    w_prot: np.ndarray
    p_rna: np.ndarray
    t_rna: np.ndarray
    obs_rna: np.ndarray
    w_rna: np.ndarray
    p_pho: np.ndarray
    s_pho: np.ndarray
    t_pho: np.ndarray
    obs_pho: np.ndarray
    w_pho: np.ndarray
    prot_base_idx: int
    rna_base_idx: int
    pho_base_idx: int


Columns = Mapping[str, Sequence]


def _weights(cols: Columns, n: int) -> np.ndarray:
    # NaN weights would turn every objective into fail_value
    w = np.asarray(cols["w"], float) if "w" in cols else np.ones(n)
    return np.nan_to_num(w, nan=1.0)


def prepare_loss_data(topo, prot: Columns, rna: Columns, pho: Columns,
                      time_grid, t0_prot=0.0, t0_rna=4.0,
                      t0_pho=0.0) -> LossData:
    """Index observations against the union time grid and padded layout.

    Phospho rows of a protein or site the topology lacks are dropped; a
    protein or RNA row of an unknown protein, or any time off the grid,
    raises."""
    time_grid = np.asarray(time_grid, float)
    t_map = {float(t): i for i, t in enumerate(time_grid)}

    def map_time(t) -> int:
        t = float(t)
        if t not in t_map:
            raise ValueError(f"Time {t} not in time_grid {sorted(t_map)}")
        return t_map[t]

    def basic(cols):
        proteins = list(cols["protein"])
        unknown = set(proteins) - set(topo.p2i)
        if unknown:
            raise ValueError(f"Proteins not in topology: {sorted(unknown)[:5]}")
        p_idx = np.asarray([topo.p2i[p] for p in proteins], np.int32)
        t_idx = np.asarray([map_time(t) for t in cols["time"]], np.int32)
        obs = np.asarray(cols["fc"], float)
        return p_idx, t_idx, obs, _weights(cols, len(proteins))

    p_prot, t_prot, obs_prot, w_prot = basic(prot)
    p_rna, t_rna, obs_rna, w_rna = basic(rna)

    site_maps = [{s: j for j, s in enumerate(ss)} for ss in topo.sites]
    w_all = _weights(pho, len(pho["protein"]))
    pp, ss_, tt, oo, ww = [], [], [], [], []
    for p, s, t, fc, w in zip(pho["protein"], pho["psite"], pho["time"],
                              pho["fc"], w_all):
        if p not in topo.p2i or s not in site_maps[topo.p2i[p]]:
            continue  # not in the model structure
        pi = topo.p2i[p]
        pp.append(pi)
        ss_.append(site_maps[pi][s])
        tt.append(map_time(t))
        oo.append(float(fc))
        ww.append(float(w))

    def bidx(t0):
        return int(np.argmin(np.abs(time_grid - float(t0))))

    return LossData(
        p_prot, t_prot, obs_prot, w_prot,
        p_rna, t_rna, obs_rna, w_rna,
        np.asarray(pp, np.int32), np.asarray(ss_, np.int32),
        np.asarray(tt, np.int32), np.asarray(oo, float), np.asarray(ww, float),
        bidx(t0_prot), bidx(t0_rna), bidx(t0_pho),
    )
