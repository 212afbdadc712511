"""Network topology: name <-> index maps, padded layouts, proxy redirection.

Counterpart of ``phoskintime_tpu/network/topology.py``: the same fields
and the same arrays, built from plain sequences of tuples instead of
DataFrames.

The state of protein i is a row of a padded (N, width) matrix,
``Y[i] = [R, P0, site_1..site_Smax]`` for the affine mechanisms 0/1 (and
``[R, X_0..X_{Mmax-1}]`` for the combinatorial mechanism 2), with masks
for the slots a protein does not have.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping, Sequence

import numpy as np


def site_key(site: str):
    """Sort key: residue number then string."""
    m = re.search(r"(\d+)", str(site))
    return (int(m.group(1)) if m else 10 ** 9, str(site))


@dataclasses.dataclass
class NetworkTopology:
    """Static description of the kinase-substrate / TF-gene network."""

    proteins: list[str]
    kinases: list[str]
    sites: list[list[str]]          # per protein, residue-sorted
    n_sites: np.ndarray             # (N,) int32
    p2i: dict[str, int]
    k2i: dict[str, int]
    proxy_map: dict[str, str]       # orphan TF -> proxy kinase
    driver_map: np.ndarray          # (N,) int32; >=0 kinase idx, -1 simulated
    W_pad: np.ndarray               # (N, Smax, K) kinase->site weights
    tf_mat: np.ndarray              # (N, N) regulator->gene weights
    tf_deg: np.ndarray              # (N,) input normalizer
    model: int = 0

    @property
    def N(self) -> int:
        return len(self.proteins)

    @property
    def K(self) -> int:
        return len(self.kinases)

    @property
    def max_sites(self) -> int:
        return int(self.W_pad.shape[1])

    @property
    def total_sites(self) -> int:
        return int(self.n_sites.sum())

    @property
    def n_states(self) -> np.ndarray:
        return (1 << self.n_sites.astype(np.int64)).astype(np.int32)

    @property
    def max_states(self) -> int:
        return 1 << self.max_sites

    @property
    def width(self) -> int:
        return (1 + self.max_states) if self.model == 2 else (2 + self.max_sites)

    def site_mask(self) -> np.ndarray:
        """(N, Smax) bool: site slot j valid for protein i."""
        return np.arange(self.max_sites)[None, :] < self.n_sites[:, None]

    def state_mask(self) -> np.ndarray:
        """(N, Mmax) bool: bitmask state m valid for protein i (model 2)."""
        return np.arange(self.max_states)[None, :] < self.n_states[:, None]


def _unique(values) -> list:
    """Distinct values in order of first appearance."""
    return list(dict.fromkeys(values))


def _rows(edges, cols) -> list[tuple]:
    """Edges as tuples, from tuples or from a column table's ``cols``."""
    if edges is None:
        return []
    if isinstance(edges, Mapping):
        return list(zip(*(list(edges[c]) for c in cols)))
    return [tuple(r) for r in edges]


def build_topology(interactions: Sequence[tuple[str, str | None, str]],
                   tf_interactions: Sequence[tuple[str, str]] | None = None,
                   kin_beta_map: dict | None = None,
                   tf_beta_map: dict | None = None,
                   kin_alpha: dict | None = None,
                   tf_edge_weights: dict | None = None,
                   model: int = 0,
                   max_sites_cap: int | None = None) -> NetworkTopology:
    """Build a :class:`NetworkTopology` from interaction tuples.

    Args:
      interactions: ``(protein, psite, kinase)`` kinase-substrate edges,
        or a column table with those columns (what
        :func:`~phoskintime_tpu_torch.io.load.load_data` returns); a
        ``None`` psite is a missing value and names no site.
      tf_interactions: ``(tf, target)`` regulator edges, or a column table
        {tf, target} (optional).
      kin_beta_map / tf_beta_map: optional priors used to pick the best
        proxy kinase for orphan TFs.
      kin_alpha: optional {(protein, psite, kinase): alpha} edge weights
        for W (default 1.0).
      tf_edge_weights: optional {(tf, target): weight} for the TF matrix
        (default 1.0).
      model: mechanism id (0/1/2/4); model 2 uses bitmask states.
      max_sites_cap: optional clamp on sites per protein.
    """
    interactions = _rows(interactions, ("protein", "psite", "kinase"))
    tf_rows = _rows(tf_interactions, ("tf", "target"))

    with_sites = set(p for p, _, _ in interactions)
    prots = set(with_sites)
    prots.update(t for t, _ in tf_rows)
    prots.update(g for _, g in tf_rows)
    proteins = sorted(prots)
    p2i = {p: i for i, p in enumerate(proteins)}

    kinases = sorted(set(k for _, _, k in interactions))
    k2i = {k: i for i, k in enumerate(kinases)}

    # orphan TFs (no phospho sites) are driven by the best kinase among
    # their targets; the tf_beta term is the same for every candidate, so
    # only the kinase beta decides
    proxy_map: dict[str, str] = {}
    for orphan in sorted(set(t for t, _ in tf_rows) - with_sites):
        feedback = [g for t, g in tf_rows if t == orphan and g in k2i]
        if not feedback:
            continue
        best, best_w = feedback[0], -1.0
        for k in feedback:
            w = (tf_beta_map or {}).get(orphan, 0.0)
            w += (kin_beta_map or {}).get(k, 0.0)
            if w > best_w:
                best_w, best = w, k
        proxy_map[orphan] = best

    sites: list[list[str]] = []
    for p in proteins:
        s_list = sorted(_unique(s for q, s, _ in interactions
                                if q == p and s is not None), key=site_key)
        if max_sites_cap is not None:
            s_list = s_list[:max_sites_cap]
        sites.append(s_list)
    n_sites = np.asarray([len(s) for s in sites], np.int32)
    Smax = max(1, int(n_sites.max()) if len(n_sites) else 1)

    K = len(kinases)
    W_pad = np.zeros((len(proteins), Smax, K))
    for p, s, k in interactions:
        i = p2i[p]
        if s not in sites[i]:
            continue
        alpha = 1.0 if kin_alpha is None else float(kin_alpha.get((p, s, k), 1.0))
        W_pad[i, sites[i].index(s), k2i[k]] += alpha

    N = len(proteins)
    tf_mat = np.zeros((N, N))
    for tf, tgt in tf_rows:
        w = 1.0 if tf_edge_weights is None else float(
            tf_edge_weights.get((tf, tgt), 1.0))
        tf_mat[p2i[tgt], p2i[tf]] += w

    # input normalizer: sum of |edge weights| per gene, floored
    deg = np.abs(tf_mat).sum(axis=1).astype(float)
    deg[deg < 1e-12] = 1.0

    driver_map = np.full(N, -1, np.int32)
    for k in kinases:
        if k in p2i:
            driver_map[p2i[k]] = k2i[k]
    for orphan, proxy in proxy_map.items():
        driver_map[p2i[orphan]] = k2i[proxy]

    return NetworkTopology(proteins, kinases, sites, n_sites, p2i, k2i,
                           proxy_map, driver_map, W_pad, tf_mat, deg, model)
