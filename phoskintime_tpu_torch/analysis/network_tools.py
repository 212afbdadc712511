"""Network readouts, subnetworks, curve similarity and clustering, and
their figures.

Counterpart of ``phoskintime_tpu/analysis/network_tools.py``, on column
dicts (:mod:`phoskintime_tpu_torch.io.utils`) in the JAX module's row
orders, its figures drawn by the port's own drawing layer:

* the readout tables of the result workbooks' sheets
  (:func:`kinopt_network_readout`, :func:`tfopt_network_readout`: pandas'
  sorted ``groupby``, a left merge and its quicksort on ``total_alpha``),
  the per-gene regulator counts and priors (:func:`analyze_tf_kin_counts`,
  :func:`map_priors`: pandas' outer join of indexes, the first index's
  order and then each new key in order), and the ego network around a
  protein (:func:`export_subnetwork`);
* :func:`curve_similarity_matrix`, the discrete Fréchet distance of every
  pair of curves in one batched DP (on the card unless the caller passes
  ``device="cpu"``), and :func:`cluster_curves`, scikit-learn's
  ``AgglomerativeClustering(metric="precomputed", linkage="average")``
  written out (SciPy's nearest-neighbour chain, then scikit-learn's cut
  and numbering);
* the time-resolved readouts of a fit (:func:`kinopt_signal_readout`,
  :func:`tfopt_signal_readout`; the prediction is linear in each edge's
  contribution C[i, a, t], so a knockout is the prediction less one
  slice) and their figures (:func:`plot_signal_readout`);
* the figures :func:`plot_identity_band`, :func:`plot_breadth_vs_load`,
  :func:`plot_network_dag` (the layered bipartite DAG) and
  :func:`temporal_sensitivity_heatmap`.

A labelled square matrix (the similarity) is a column dict whose first
column ``curve`` names the rows and whose other columns are named by the
curves.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device
from phoskintime_tpu_torch.io.export import rows_to_table, sort_desc
from phoskintime_tpu_torch.io.utils import as_numbers, is_missing, n_rows, take


def _text(v) -> str:
    """A cell as pandas' ``astype(str)`` spells it (a missing one "nan")."""
    return "nan" if is_missing(v) else str(v)


def _groups(keys) -> dict:
    """{key: row indices in order} of the rows whose key is not missing,
    the keys sorted (pandas' ``groupby``, ``sort=True``, ``dropna=True``)."""
    members: dict = {}
    for i, k in enumerate(keys):
        if not is_missing(k):
            members.setdefault(k, []).append(i)
    return {k: members[k] for k in sorted(members)}


def _nunique(values, idx) -> int:
    return len({values[i] for i in idx if not is_missing(values[i])})


def _union(*indexes) -> list:
    """pandas' union of the indexes of an outer ``concat(axis=1)``: the
    first index's keys in order, then each other's new keys in order."""
    return list(dict.fromkeys(k for index in indexes for k in index))


def _weight_readout(alpha: dict, beta: dict, key: str, target: str, value: str,
                    site: str | None, beta_site: str, beta_value: str, beta_col: str) -> dict:
    a_val = as_numbers(alpha[value])
    rows = []
    for k, idx in _groups(alpha[key]).items():
        v = a_val[idx]
        v = v[~np.isnan(v)]
        row = {key: k, f"n_{'targets' if site else 'genes'}": _nunique(alpha[target], idx)}
        if site:
            row["n_sites"] = sum(not is_missing(alpha[site][i]) for i in idx)
        row["total_alpha"] = float(np.abs(v).sum())
        row["mean_alpha"] = float(v.mean()) if len(v) else np.nan
        rows.append(row)
    b_val = as_numbers(beta[beta_value])
    glob = [i for i in range(n_rows(beta)) if _text(beta[beta_site][i]).strip() == ""]
    means = {}
    for k, idx in _groups([beta[key][i] for i in glob]).items():
        v = b_val[[glob[i] for i in idx]]
        v = v[~np.isnan(v)]
        means[k] = float(v.mean()) if len(v) else np.nan
    for row in rows:
        row[beta_col] = means.get(row[key], np.nan)
    cols = [key, f"n_{'targets' if site else 'genes'}", *(["n_sites"] if site else []),
            "total_alpha", "mean_alpha", beta_col]
    table = rows_to_table(rows, cols)
    if not rows:
        table[key] = np.asarray([], dtype=object)
    return take(table, sort_desc(table["total_alpha"]))


def kinopt_network_readout(alpha_df: dict, beta_df: dict) -> dict:
    """Per-kinase summary of the Alpha Values (Gene, Psite, Kinase, Alpha)
    and Beta Values (Kinase, Psite, Beta) sheets: targets, sites, total
    |alpha|, mean alpha and the mean of its global betas (empty Psite),
    by total |alpha| descending."""
    return _weight_readout(alpha_df, beta_df, "Kinase", "Gene", "Alpha", "Psite", "Psite",
                           "Beta", "beta")


def tfopt_network_readout(alpha_df: dict, beta_df: dict) -> dict:
    """Per-TF summary of the Alpha Values (mRNA, TF, Value) and Beta Values
    (TF, PSite, Value) sheets: regulated genes, total |alpha|, mean alpha
    and the mean of its protein betas (empty PSite)."""
    return _weight_readout(alpha_df, beta_df, "TF", "mRNA", "Value", None, "PSite", "Value",
                           "protein_beta")


SUBNETWORK_COLUMNS = ("kind", "source", "target", "site", "weight")


def export_subnetwork(topo, center: str, radius: int = 1) -> tuple[dict, list]:
    """The ego network around ``center``: its kinase and TF edges out to
    ``radius`` hops as a table (kind, source, target, site, weight; each
    edge once, first found first) and the sorted node names."""
    frontier, nodes, edges = {center}, {center}, []
    W, tf = np.asarray(topo.W_pad), np.asarray(topo.tf_mat)
    for _ in range(radius):
        new = set()
        for i, p in enumerate(topo.proteins):
            for j, site in enumerate(topo.sites[i]):
                for k, kin in enumerate(topo.kinases):
                    if W[i, j, k] != 0 and (p in frontier or kin in frontier):
                        edges.append(("kinase", kin, p, site, float(W[i, j, k])))
                        new.update({p, kin})
        for tgt_i in range(topo.N):
            for src_i in range(topo.N):
                if tf[tgt_i, src_i] != 0:
                    src, tgt = topo.proteins[src_i], topo.proteins[tgt_i]
                    if src in frontier or tgt in frontier:
                        edges.append(("tf", src, tgt, "", float(tf[tgt_i, src_i])))
                        new.update({src, tgt})
        nodes |= new
        frontier = new
    edges = list(dict.fromkeys(edges))                  # drop_duplicates, keep the first
    table = {c: np.asarray([e[k] for e in edges], dtype=object)
             for k, c in enumerate(SUBNETWORK_COLUMNS[:-1])}
    table["weight"] = np.asarray([e[4] for e in edges], float)
    return table, sorted(nodes)


def _frechet_all_pairs(curves: list[torch.Tensor]) -> torch.Tensor:
    """The Fréchet distance of every pair i < j, pairs of one shape in one
    batched DP each; (n, n), symmetric, zero diagonal."""
    from phoskintime_tpu_torch.ops.frechet import frechet_distance

    n = len(curves)
    D = torch.zeros((n, n), dtype=torch.float64, device=curves[0].device if n else "cpu")
    pairs: dict = {}
    for i in range(n):
        for j in range(i + 1, n):
            pairs.setdefault((curves[i].shape, curves[j].shape), []).append((i, j))
    for members in pairs.values():
        ii = torch.as_tensor([i for i, _ in members], device=D.device)
        jj = torch.as_tensor([j for _, j in members], device=D.device)
        a = torch.stack([curves[i] for i, _ in members])
        b = torch.stack([curves[j] for _, j in members])
        d = frechet_distance(a, b)
        D[ii, jj] = d
        D[jj, ii] = d
    return D


def curve_similarity_matrix(curves: dict, device=DEFAULT_DEVICE) -> dict:
    """Pairwise discrete Fréchet distances between named (T, d) curves, as
    a labelled matrix (module doc), at float64; the DP on ``device``."""
    names = list(curves)
    dev = resolve_device(device)
    tensors = [torch.as_tensor(np.asarray(curves[k], float), dtype=torch.float64, device=dev)
               for k in names]
    D = _frechet_all_pairs(tensors).cpu().numpy() if names else np.zeros((0, 0))
    return {"curve": np.asarray(names, dtype=object), **{k: D[:, j] for j, k in enumerate(names)}}


def similarity_matrix(similarity: dict) -> tuple[list, np.ndarray]:
    """(names, matrix) of a labelled matrix."""
    names = list(similarity["curve"])
    return names, np.column_stack([np.asarray(similarity[k], float) for k in names]) \
        if names else np.zeros((0, 0))


def average_linkage(D: np.ndarray) -> np.ndarray:
    """SciPy's ``linkage(squareform(D), method="average")``: the
    nearest-neighbour chain over the condensed distances (a tie keeps the
    chain's previous element, else the lowest index), the merges sorted by
    distance (stably) and relabelled by union-find. Returns (n - 1, 4):
    the two clusters (lower first), the distance, the size."""
    n = len(D)
    D = np.array(D, float)
    size = np.ones(n, int)
    Z = np.zeros((max(n - 1, 0), 4))
    chain: list = []
    for k in range(n - 1):
        if not chain:
            chain = [int(np.flatnonzero(size > 0)[0])]
        while True:
            x = chain[-1]
            if len(chain) > 1:
                y = chain[-2]
                current = D[x, y]
            else:
                y, current = -1, np.inf
            for i in range(n):
                if size[i] == 0 or i == x:
                    continue
                if D[x, i] < current:
                    current, y = D[x, i], i
            if len(chain) > 1 and y == chain[-2]:
                break
            chain.append(y)
        chain = chain[:-2]
        x, y = min(x, y), max(x, y)
        nx, ny = size[x], size[y]
        Z[k] = (x, y, current, nx + ny)
        size[x], size[y] = 0, nx + ny
        for i in range(n):
            if size[i] == 0 or i == y:
                continue
            D[i, y] = D[y, i] = (nx * D[i, x] + ny * D[i, y]) / (nx + ny)
    Z = Z[np.argsort(Z[:, 2], kind="mergesort")]
    parent = list(range(2 * n - 1))
    sizes = [1] * (2 * n - 1)

    def find(v):
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:
            parent[v], v = root, parent[v]
        return root
    for k in range(n - 1):
        a, b = find(int(Z[k, 0])), find(int(Z[k, 1]))
        Z[k, 0], Z[k, 1] = min(a, b), max(a, b)
        parent[a] = parent[b] = n + k
        sizes[n + k] = sizes[a] + sizes[b]
        Z[k, 3] = sizes[n + k]
    return Z


def cut_tree(children: np.ndarray, n_clusters: int, n_leaves: int) -> np.ndarray:
    """scikit-learn's ``_hc_cut``: split the largest node until there are
    ``n_clusters``, and number the clusters in the order of its heap."""
    nodes = [-(int(max(children[-1])) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -int(these[0]))
        heapq.heappushpop(nodes, -int(these[1]))
    labels = np.zeros(n_leaves, np.int64)
    for i, node in enumerate(nodes):
        stack, leaves = [-node], []
        while stack:
            v = stack.pop()
            if v < n_leaves:
                leaves.append(v)
            else:
                stack.extend(int(c) for c in children[v - n_leaves])
        labels[leaves] = i
    return labels


def cluster_curves(similarity: dict, n_clusters: int = 3) -> dict:
    """Average-linkage agglomerative clustering of a precomputed distance
    matrix (a labelled matrix) into ``min(n_clusters, n)`` clusters,
    numbered as scikit-learn's ``AgglomerativeClustering(
    metric="precomputed", linkage="average").fit_predict`` numbers them;
    {"curve": names, "cluster": labels}."""
    names, D = similarity_matrix(similarity)
    n = len(names)
    if n < 2:
        raise ValueError(f"clustering needs at least 2 curves, got {n}")
    if n_clusters <= 0:
        raise ValueError(f"n_clusters must be positive, got {n_clusters}")
    children = average_linkage(D)[:, :2].astype(int)
    return {"curve": np.asarray(names, dtype=object),
            "cluster": cut_tree(children, min(n_clusters, n), n)}


def analyze_tf_kin_counts(df_kin: dict, df_tf: dict) -> dict:
    """Per-gene regulator counts: the distinct kinases targeting its sites,
    its distinct sites, the distinct TFs regulating its mRNA (0 where
    none); the genes in pandas' outer-join order."""
    kin = _groups(df_kin["protein"])
    tf = _groups(df_tf["target"])
    counts = [{p: _nunique(df_kin["kinase"], idx) for p, idx in kin.items()},
              {p: _nunique(df_kin["psite"], idx) for p, idx in kin.items()},
              {t: _nunique(df_tf["tf"], idx) for t, idx in tf.items()}]
    genes = _union(kin, tf)
    out = {"gene": np.asarray(genes, dtype=object)}
    for name, c in zip(("n_kinases", "n_sites", "n_tfs"), counts):
        out[name] = np.asarray([c.get(g, 0) for g in genes], np.int64)
    return out


def map_priors(kin_alpha_df: dict, tf_alpha_df: dict) -> dict:
    """The merged per-gene regulator table of the two prior sheets:
    "kinase:alpha;..." and "tf:value;..." a gene (each weight ``:.3g``, the
    rows in order), None where a gene has none."""
    def joined(table, key, name, value):
        vals = np.asarray(table[value])
        return {g: ";".join(f"{_text(table[name][i])}:{vals[i]:.3g}" for i in idx)
                for g, idx in _groups(table[key]).items()}
    kin = joined(kin_alpha_df, "Gene", "Kinase", "Alpha")
    tf = joined(tf_alpha_df, "mRNA", "TF", "Value")
    genes = _union(kin, tf)
    return {"gene": np.asarray(genes, dtype=object),
            "kinases": np.asarray([kin.get(g) for g in genes], dtype=object),
            "tfs": np.asarray([tf.get(g) for g in genes], dtype=object)}


def _auc(t: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Trapezoid AUC along the last axis."""
    return np.trapezoid(Y, t, axis=-1)


def _normalized_times(T: int, times) -> np.ndarray:
    t = np.arange(T, dtype=float) if times is None else np.asarray(times, float)
    return t / max(float(t.max()), 1e-12)


def _rank_first_desc(values, groups) -> np.ndarray:
    """pandas' ``groupby(groups)[...].rank(ascending=False,
    method="first")`` as integers: within each group, 1 for the largest,
    ties in order of appearance."""
    ranks = np.zeros(len(values), np.int64)
    members: dict = {}
    for i, g in enumerate(groups):
        members.setdefault(g, []).append(i)
    for idx in members.values():
        for r, i in enumerate(sorted(idx, key=lambda i: (-values[i], i))):
            ranks[i] = r + 1
    return ranks


def _edges_and_knockouts(C, pred, pred_auc, t, key_of, mask, source_of, src_col):
    """Per-edge loads and exact knockouts of a linear contribution tensor
    C (rows, slots, T), as records: row i's keys ``key_of(i)``, its valid
    slots ``mask[i]``, slot a's source name ``source_of(i, a)``."""
    edge_rows, ko_rows = [], []
    for i in range(C.shape[0]):
        base, base_peak = pred_auc[i], float(np.abs(pred[i]).max())
        for a in np.where(mask[i])[0]:
            src = source_of(i, a)
            edge_rows.append({**key_of(i), src_col: src,
                              "edge_load_auc_abs": float(_auc(t, np.abs(C[i, a])))})
            ko = np.maximum(C[i].sum(0) - C[i, a], 0.0)
            ko_rows.append({**key_of(i), f"knocked_{src_col}": src,
                            "delta_auc_abs": float(base - _auc(t, np.abs(ko))),
                            "delta_peak_abs": float(base_peak - np.abs(ko).max())})
    return edge_rows, ko_rows


def _dominance_rows(edge_rows, match, n, key_cols, src_col, dom_col, pred_auc, obs_auc):
    rows = []
    for i in range(n):
        mine = [r for r in edge_rows if match(r, i)]
        tot = float(sum(r["edge_load_auc_abs"] for r in mine))
        dom = mine[int(np.argmax([r["edge_load_auc_abs"] for r in mine]))] if mine else None
        rows.append({**key_cols(i), f"n_{src_col}s": len(mine),
                     dom_col: dom[src_col] if dom is not None else "",
                     "dominant_share": (float(dom["edge_load_auc_abs"] / max(tot, 1e-12))
                                        if dom is not None else 0.0),
                     "pred_auc_abs": float(pred_auc[i]), "obs_auc_abs": float(obs_auc[i])})
    return rows


def kinopt_signal_readout(prob, alpha_pad, beta_pad, times=None) -> dict:
    """The kinopt network readout from a fit: {"kinase_load", "edge_load",
    "target_fragility", "knockout_effects"} tables. Kinase load: the AUC of
    each kinase's routed activity |alpha A(t)| over its targets, its latent
    activity's AUC and peak and the share of its betas at a bound; target
    fragility: each site's dominant kinase and its share; knockouts: each
    edge's removal from the reconstructed signal (AUC and peak)."""
    alpha_pad = np.asarray(alpha_pad, float)
    beta_pad = np.asarray(beta_pad, float)
    t = _normalized_times(prob.K_array.shape[1], times)
    K_sel = np.asarray(prob.K_array)[prob.k_row_idx]
    A = ((beta_pad * prob.k_mask)[..., None] * K_sel).sum(1)
    C = (alpha_pad * prob.gp_mask)[..., None] * A[prob.gp_kin_idx]
    pred = np.maximum(C.sum(1), 0.0)
    names = prob.gp_names or [(f"G{i}", f"S{i}") for i in range(prob.n_gp)]
    kin_names = prob.kinase_names or [f"K{j}" for j in range(prob.n_k)]
    pred_auc = _auc(t, np.abs(pred))

    key_of = lambda i: {"gene": names[i][0], "psite": names[i][1]}  # noqa: E731
    edge_rows, ko_rows = _edges_and_knockouts(
        C, pred, pred_auc, t, key_of, prob.gp_mask,
        lambda i, a: kin_names[int(prob.gp_kin_idx[i, a])], "kinase")
    ko = rows_to_table(ko_rows)
    if ko_rows:
        ko["ko_rank_site"] = _rank_first_desc(ko["delta_auc_abs"],
                                              list(zip(ko["gene"], ko["psite"])))

    at_bound = (np.isclose(beta_pad, prob.lb, atol=1e-6)
                | np.isclose(beta_pad, prob.ub, atol=1e-6)) & prob.k_mask
    kl_rows = []
    for j in range(prob.n_k):
        mine = [r for r in edge_rows if r["kinase"] == kin_names[j]]
        kl_rows.append({
            "kinase": kin_names[j], "n_targets": len({r["gene"] for r in mine}),
            "n_sites": len(mine),
            "total_load_auc_abs": float(sum(r["edge_load_auc_abs"] for r in mine)),
            "latent_auc_abs": float(_auc(t, np.abs(A[j]))),
            "latent_peak_abs": float(np.abs(A[j]).max()),
            "frac_beta_at_bound": float(at_bound[j].sum() / max(int(prob.k_mask[j].sum()), 1))})
    kinase_load = rows_to_table(kl_rows)
    kinase_load = take(kinase_load, sort_desc(kinase_load["total_load_auc_abs"]))

    obs_auc = _auc(t, np.abs(np.asarray(prob.P_obs, float)))
    frag = rows_to_table(_dominance_rows(
        edge_rows, lambda r, i: (r["gene"], r["psite"]) == tuple(names[i]), prob.n_gp,
        key_of, "kinase", "dominant_kinase",
        pred_auc, obs_auc))
    return {"kinase_load": kinase_load, "edge_load": rows_to_table(edge_rows),
            "target_fragility": take(frag, sort_desc(frag["dominant_share"])),
            "knockout_effects": ko}


def tfopt_signal_readout(prob, alpha_pad, beta_pad, times=None) -> dict:
    """The tfopt counterpart of :func:`kinopt_signal_readout`: {"tf_load",
    "edge_load", "gene_fragility", "knockout_effects"} from the contribution
    tensor C[g, r, t] = alpha_{g,r} effect_r(t)."""
    alpha_pad = np.asarray(alpha_pad, float)
    beta_pad = np.asarray(beta_pad, float) * prob.beta_mask
    t = _normalized_times(prob.mRNA_mat.shape[1], times)
    effect = (beta_pad[:, :1] * np.asarray(prob.protein_mat)
              + np.einsum("fk,fkt->ft", beta_pad[:, 1:], np.asarray(prob.psite_tensor)))
    C = (alpha_pad * prob.alpha_mask)[..., None] * effect[np.maximum(prob.regulators, 0)]
    pred = np.maximum(C.sum(1), 0.0)
    pred_auc = _auc(t, np.abs(pred))
    genes = prob.gene_ids or [f"G{g}" for g in range(prob.n_genes)]
    tfs = prob.tf_ids or [f"TF{r}" for r in range(prob.n_TF)]

    key_of = lambda g: {"gene": genes[g]}  # noqa: E731
    edge_rows, ko_rows = _edges_and_knockouts(
        C, pred, pred_auc, t, key_of, prob.alpha_mask,
        lambda g, r: tfs[int(prob.regulators[g, r])], "tf")
    ko = rows_to_table(ko_rows)
    if ko_rows:
        ko["ko_rank_gene"] = _rank_first_desc(ko["delta_auc_abs"], list(ko["gene"]))

    tl_rows = []
    for f in range(prob.n_TF):
        mine = [r for r in edge_rows if r["tf"] == tfs[f]]
        tl_rows.append({
            "tf": tfs[f], "n_genes": len({r["gene"] for r in mine}),
            "total_load_auc_abs": float(sum(r["edge_load_auc_abs"] for r in mine)),
            "latent_auc_abs": float(_auc(t, np.abs(effect[f]))),
            "latent_peak_abs": float(np.abs(effect[f]).max())})
    tf_load = rows_to_table(tl_rows)
    tf_load = take(tf_load, sort_desc(tf_load["total_load_auc_abs"]))

    obs_auc = _auc(t, np.abs(np.asarray(prob.mRNA_mat, float)))
    frag = rows_to_table(_dominance_rows(
        edge_rows, lambda r, g: r["gene"] == genes[g], prob.n_genes,
        key_of, "tf", "dominant_tf", pred_auc, obs_auc))
    return {"tf_load": tf_load, "edge_load": rows_to_table(edge_rows),
            "gene_fragility": take(frag, sort_desc(frag["dominant_share"])),
            "knockout_effects": ko}


def _nth(values, n: int, largest: bool) -> np.ndarray:
    """pandas' ``nlargest``/``nsmallest(n)`` row order: by value (NaN
    dropped), ties in row order."""
    v = np.asarray(values, float)
    idx = [i for i in range(len(v)) if not np.isnan(v[i])]
    return np.asarray(sorted(idx, key=lambda i: (-v[i] if largest else v[i], i))[:n], int)


def plot_signal_readout(tables: dict, out_dir: str, *, which: str = "kinopt") -> list:
    """The readout's figures: the top-25 control-load bars, breadth against
    load (the top fifth labelled), the knockout-effect histogram and the
    20 strongest activating and suppressing edges."""
    import os

    from phoskintime_tpu_torch.report.draw import subplots

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    load = tables.get("kinase_load") if which == "kinopt" else tables.get("tf_load")
    actor = "kinase" if which == "kinopt" else "tf"
    tgt_col = "n_sites" if which == "kinopt" else "n_genes"

    def save(fig, name):
        fig.tight_layout()
        p = os.path.join(out_dir, f"{which}_{name}.png")
        fig.savefig(p, dpi=140)
        paths.append(p)

    if load is not None and len(load[actor]):
        top = take(load, np.arange(min(25, len(load[actor]))))
        top = take(top, np.arange(len(top[actor]))[::-1])
        fig, ax = subplots(figsize=(6.4, 0.28 * len(top[actor]) + 1.2))
        ax.barh([str(v) for v in top[actor]], top["total_load_auc_abs"], color="tab:blue")
        ax.set_xlabel("total routed activity (AUC)")
        ax.set_title(f"{actor.capitalize()} control load")
        save(fig, "control_load_top")

        fig, ax = subplots(figsize=(5.6, 4.3))
        total = np.asarray(load["total_load_auc_abs"], float)
        ax.scatter(load[tgt_col], total, s=22, alpha=0.85)
        thr = float(np.quantile(total, 0.8))
        for k in np.flatnonzero(total > thr):
            ax.annotate(load[actor][k], (float(load[tgt_col][k]), total[k]), fontsize=7,
                        xytext=(3, 3), textcoords="offset points")
        ax.set_xlabel("number of targets")
        ax.set_ylabel("control load")
        ax.set_title(f"{actor.capitalize()} breadth vs control load")
        ax.grid(alpha=0.25, lw=0.6)
        save(fig, "breadth_vs_load")

    ko = tables.get("knockout_effects")
    if ko is not None and len(ko.get("delta_auc_abs", ())):
        key = "knocked_kinase" if which == "kinopt" else "knocked_tf"
        delta = np.asarray(ko["delta_auc_abs"], float)
        fig, ax = subplots(figsize=(5.6, 3.6))
        ax.hist(delta, bins=45, density=True, alpha=0.85)
        ax.axvline(0.0, lw=1.0, color="k")
        ax.set_xlabel("change in reconstructed signal")
        ax.set_ylabel("density")
        ax.set_title("Knockout effect distribution")
        ax.grid(alpha=0.25, lw=0.6)
        save(fig, "knockout_distribution")

        lab = [str(g) + (f" {p}" if "psite" in ko else "") + " ← " + str(k)
               for g, p, k in zip(ko["gene"], ko.get("psite", ko["gene"]), ko[key])]
        for name, largest in (("activating", True), ("suppressing", False)):
            sel = _nth(delta, 20, largest)[::-1]
            fig, ax = subplots(figsize=(6.6, 0.28 * len(sel) + 1.2))
            ax.barh([lab[i] for i in sel], delta[sel],
                    color="tab:green" if name == "activating" else "tab:red")
            ax.set_xlabel("change in reconstructed signal")
            ax.set_title(f"Strongest {name} edges")
            save(fig, f"knockout_top_{name}")
    return paths


# ---------------------------------------------------------------------------
# publication figures: the identity band, breadth against load, the layered
# DAG and the temporal sensitivity heatmap
# ---------------------------------------------------------------------------

def plot_identity_band(obs, est, out_path: str, labels=None, q: float = 0.95,
                       title="observed vs reconstructed"):
    """Observed against reconstructed with the band y = x +/- the residuals'
    ``q`` quantile; the points outside the band labelled."""
    from phoskintime_tpu_torch.report.draw import subplots

    obs = np.asarray(obs, float).ravel()
    est = np.asarray(est, float).ravel()
    resid = np.abs(est - obs)
    delta = float(np.quantile(resid, q)) if len(resid) else 0.0
    lim = [min(obs.min(), est.min()), max(obs.max(), est.max())]

    fig, ax = subplots(figsize=(5.5, 5.5))
    ax.scatter(obs, est, s=14, alpha=0.7, edgecolor="none")
    ax.plot(lim, lim, "k-", lw=1)
    ax.fill_between(lim, [v - delta for v in lim], [v + delta for v in lim], color="gray",
                    alpha=0.2, label=f"{int(q*100)}% band (+/-{delta:.3g})")
    if labels is not None:
        out = resid > delta
        for x, y, lab in zip(obs[out], est[out], np.asarray(labels)[out]):
            ax.annotate(str(lab), (x, y), fontsize=6, alpha=0.8)
    ax.set_xlabel("observed")
    ax.set_ylabel("reconstructed")
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path


def plot_breadth_vs_load(readout: dict, out_path: str, name_col: str | None = None,
                         breadth_col: str = "n_targets", load_col: str = "total_alpha",
                         label_above: float = 1.0):
    """Each regulator's breadth against its control load, those above
    ``label_above`` labelled by ``name_col`` (default the first column)."""
    from phoskintime_tpu_torch.report.draw import subplots

    if name_col is None:
        name_col = next(iter(readout))
    breadth, load = readout[breadth_col], as_numbers(readout[load_col])
    fig, ax = subplots(figsize=(6, 4.5))
    ax.scatter(breadth, load, s=18, alpha=0.8)
    for k in np.flatnonzero(load > label_above):
        ax.annotate(str(readout[name_col][k]), (float(breadth[k]), float(load[k])), fontsize=7)
    ax.set_xlabel(breadth_col)
    ax.set_ylabel(load_col)
    ax.set_title("regulator breadth vs control load")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path


def plot_network_dag(edges: dict, out_path: str, title="control logic"):
    """The layered bipartite DAG of a table of edges (source, target,
    weight; other columns ignored): the sources on the top rank, the
    targets below, each edge's width and opacity by |weight|, blue where
    it is positive, red where negative."""
    from phoskintime_tpu_torch.report.draw import subplots

    srcs = sorted(set(edges["source"]))
    tgts = sorted(set(edges["target"]))
    xs = {s: i / max(1, len(srcs) - 1) for i, s in enumerate(srcs)}
    xt = {t: i / max(1, len(tgts) - 1) for i, t in enumerate(tgts)}
    weights = as_numbers(edges["weight"])
    wmax = max(1e-12, float(np.abs(weights).max()))

    fig, ax = subplots(figsize=(max(6, 0.6 * max(len(srcs), len(tgts))), 4.0))
    for s, t, wt in zip(edges["source"], edges["target"], weights):
        w = abs(float(wt)) / wmax
        ax.plot([xs[s], xt[t]], [1.0, 0.0], color="tab:blue" if float(wt) >= 0 else "tab:red",
                lw=0.5 + 2.5 * w, alpha=0.35 + 0.6 * w, zorder=1)
    for names, y, face in ((xs, 1.0, "#ffd27f"), (xt, 0.0, "#9fd4ff")):
        for n, x in names.items():
            ax.scatter([x], [y], s=220, color=face, zorder=2, edgecolor="k", lw=0.5)
            ax.annotate(n, (x, y), ha="center", va="center", fontsize=6, zorder=3)
    ax.set_ylim(-0.25, 1.25)
    ax.axis("off")
    ax.set_title(title)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    return out_path


def temporal_sensitivity_heatmap(S_t, param_names, times, out_path: str,
                                 title="temporal Sobol ST"):
    """Per-timepoint total Sobol indices (times x params) as a heatmap, the
    parameters up the rows, with a colorbar."""
    from phoskintime_tpu_torch.report.draw import subplots

    fig, ax = subplots(figsize=(max(6, 0.35 * len(times)), max(4, 0.3 * len(param_names))))
    im = ax.imshow(np.asarray(S_t, float).T, aspect="auto", cmap="viridis", origin="lower")
    ax.set_xticks(range(len(times)))
    ax.set_xticklabels([f"{t:g}" for t in times], rotation=60, fontsize=7)
    ax.set_yticks(range(len(param_names)))
    ax.set_yticklabels(param_names, fontsize=7)
    ax.set_xlabel("time [min]")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path
