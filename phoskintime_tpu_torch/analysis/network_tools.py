"""Time-resolved network readouts of the kinopt and tfopt fits and their
figures.

Counterpart of the two readouts of ``phoskintime_tpu/analysis/
network_tools.py`` that the result workbooks carry
(:func:`kinopt_signal_readout`, :func:`tfopt_signal_readout`), on column
dicts in the JAX package's row orders, and of :func:`plot_signal_readout`,
their figures, drawn by the port's own drawing layer. The prediction is
linear in each edge's contribution C[i, a, t], so a knockout is the
prediction less one slice. The module's other tools (the readout tables
from workbooks, subnetworks, curve clustering and their five figures)
raise ``NotImplementedError`` naming ROADMAP.md queue 1 item 8d-figures,
part 3.
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu_torch.io.export import rows_to_table, sort_desc
from phoskintime_tpu_torch.io.utils import take

PART3 = ("network_tools.{} is not ported yet (ROADMAP.md queue 1 item 8d-figures, "
         "part 3)")
#: the JAX module's tools that part 3 ports
PENDING = ("kinopt_network_readout", "tfopt_network_readout", "export_subnetwork",
           "curve_similarity_matrix", "cluster_curves", "temporal_sensitivity_heatmap",
           "analyze_tf_kin_counts", "map_priors", "plot_identity_band", "plot_breadth_vs_load",
           "plot_network_dag")


def __getattr__(name: str):
    if name in PENDING:
        raise NotImplementedError(PART3.format(name))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
