"""Post-fit panels of the kinopt and tfopt fits.

Counterpart of ``phoskintime_tpu/analysis/fitpanels.py`` on tables of
columns (the sheets :func:`~phoskintime_tpu_torch.io.export.kinopt_sheets`
and :func:`~phoskintime_tpu_torch.io.export.tfopt_sheets` build, or the
CSV sheets the port writes, read back): goodness of fit with its 95/99%
bands, the per-group KL divergence, PCA and t-SNE of the fitted profiles,
the alpha/beta distributions (KDE, box, CDF, violin), the residual
panels, the network flows as a standalone SVG page, the strongest
connections (table and bars), the tfopt per-mRNA alpha strips and per-TF
beta bars, and the drivers that write them all. The figures are drawn by
the port's own drawing layer with the JAX writers' sizes, data, colours
and labels; the page and the table are the JAX writers' bytes. The
pandas group reductions are computed as pandas computes them (keys
sorted, sums compensated); the t-SNE is the exact method
(:mod:`phoskintime_tpu_torch.analysis.embed`).
"""

from __future__ import annotations

import csv
import html
import os

import numpy as np

from phoskintime_tpu_torch.io.export import sort_asc, sort_desc
from phoskintime_tpu_torch.io.utils import is_missing
from phoskintime_tpu_torch.report.draw import TAB20, cmap_color, subplots, to_hex

COLORS = TAB20


def _save(fig, out_dir, name):
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    return path


def _tcols(table) -> list[str]:
    return [c for c in table if str(c).startswith("x") and str(c)[1:].isdigit()]


def _matrix(table, cols) -> np.ndarray:
    return np.column_stack([np.asarray(table[c], float) for c in cols])


def _strings(values) -> np.ndarray:
    """A column as pandas' ``astype(str)`` spells it (a missing cell
    "nan")."""
    return np.asarray(["nan" if is_missing(v) else str(v) for v in values], dtype=object)


def _first_seen(values) -> list:
    return list(dict.fromkeys(values))


def group_sum(keys, values, mean: bool = False) -> tuple[list, np.ndarray]:
    """pandas' ``groupby(keys)[col].sum()`` (``mean``: ``.mean()``): the
    sorted keys and each group's compensated (Kahan) sum in row order."""
    order = sorted(set(keys))
    at = {k: i for i, k in enumerate(order)}
    total, comp, count = np.zeros(len(order)), np.zeros(len(order)), np.zeros(len(order))
    for k, v in zip(keys, np.asarray(values, float).tolist()):
        i = at[k]
        count[i] += 1
        y = v - comp[i]
        t = total[i] + y
        comp[i] = t - total[i] - y
        if comp[i] != comp[i]:
            comp[i] = 0.0
        total[i] = t
    return order, total / count if mean else total


def _rows(table, mask) -> dict:
    return {c: np.asarray(v)[mask] for c, v in table.items()}


# ---------------------------------------------------------------------------
# shared panels
# ---------------------------------------------------------------------------

def goodness_of_fit_plot(obs_df, est_df, out_dir, group_col="Gene"):
    """Observed against fitted, a scatter a row in its group's colour, the
    diagonal and the 95/99% bands (of the observations' spread); the first
    row of a group outside the 95% band labels the group."""
    tc = _tcols(obs_df)
    obs, est = _matrix(obs_df, tc), _matrix(est_df, tc)
    groups = _strings(obs_df[group_col])
    uniq = _first_seen(groups)
    cmap = {g: COLORS[i % len(COLORS)] for i, g in enumerate(uniq)}

    sd = obs.std()
    ci95, ci99 = 1.96 * sd, 2.576 * sd
    lo = min(obs.min(), est.min())
    hi = max(obs.max(), est.max())

    fig, ax = subplots(figsize=(7.5, 7.5))
    labeled = set()
    for i in range(len(obs)):
        ax.scatter(obs[i], est[i], color=cmap[groups[i]], alpha=0.5, s=40, edgecolor="black",
                   linewidth=0.3)
        if groups[i] not in labeled and np.any(np.abs(est[i] - obs[i]) > ci95):
            j = int(np.argmax(np.abs(est[i] - obs[i])))
            ax.annotate(groups[i], (obs[i][j], est[i][j]), fontsize=7, fontweight="bold",
                        color=cmap[groups[i]])
            labeled.add(groups[i])
    ax.plot([lo, hi], [lo, hi], color="gray", lw=1.2)
    for off, col, lbl in [(ci95, "red", "95% CI"), (ci99, "gray", "99% CI")]:
        ax.plot([lo, hi], [lo + off, hi + off], "--", color=col, lw=0.8, label=lbl)
        ax.plot([lo, hi], [lo - off, hi - off], "--", color=col, lw=0.8)
    ax.set_xlabel("Observed")
    ax.set_ylabel("Fitted")
    ax.grid(alpha=0.1)
    ax.legend(fontsize=8)
    return _save(fig, out_dir, "Goodness_of_Fit.png")


def kld_plot(obs_df, est_df, out_dir, group_col="Gene"):
    """Each group's mean KL divergence of its rows' time profiles (as
    distributions), in increasing order."""
    tc = _tcols(obs_df)
    obs = np.clip(_matrix(obs_df, tc), 1e-12, None)
    est = np.clip(_matrix(est_df, tc), 1e-12, None)
    p = obs / obs.sum(axis=1, keepdims=True)
    q = est / est.sum(axis=1, keepdims=True)
    kl = (p * np.log(p / q)).sum(axis=1)
    keys, means = group_sum(list(_strings(obs_df[group_col])), kl, mean=True)
    order = sort_asc(means)
    keys, means = [keys[i] for i in order], means[order]
    fig, ax = subplots(figsize=(7, 6))
    ax.scatter(range(len(means)), means, marker="s", color="blue")
    ax.set_xticks(range(len(means)))
    ax.set_xticklabels(keys, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("KL divergence")
    return _save(fig, out_dir, "kld.png")


def pca_tsne_plots(est_df, out_dir, group_col="Gene"):
    """The standardized fitted profiles on their first two principal
    components and, from 8 rows on, their t-SNE embedding."""
    tc = _tcols(est_df)
    X = _matrix(est_df, tc)
    X = (X - X.mean(0)) / np.maximum(X.std(0), 1e-12)
    groups = _strings(est_df[group_col])
    uniq = _first_seen(groups)
    cmap = {g: COLORS[i % len(COLORS)] for i, g in enumerate(uniq)}

    _, _, Vt = np.linalg.svd(X, full_matrices=False)
    Z = X @ Vt[:2].T
    if Z.shape[1] < 2:  # single profile: pad PC2 with zeros
        Z = np.pad(Z, ((0, 0), (0, 2 - Z.shape[1])))
    paths = []
    fig, ax = subplots(figsize=(7, 6))
    for g in uniq:
        m = groups == g
        ax.scatter(Z[m, 0], Z[m, 1], color=cmap[g], label=g, s=30, alpha=0.8, edgecolor="black",
                   linewidth=0.3)
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.set_title("PCA of fitted profiles")
    if len(uniq) <= 20:
        ax.legend(fontsize=6, ncol=2)
    paths.append(_save(fig, out_dir, "PCA.png"))

    if len(X) >= 8:
        from phoskintime_tpu_torch.analysis.embed import tsne

        emb = tsne(X, perplexity=min(15, len(X) - 1))
        fig, ax = subplots(figsize=(7, 6))
        for g in uniq:
            m = groups == g
            ax.scatter(emb[m, 0], emb[m, 1], color=cmap[g], label=g, s=30, alpha=0.8,
                       edgecolor="black", linewidth=0.3)
        ax.set_title("t-SNE of fitted profiles")
        if len(uniq) <= 20:
            ax.legend(fontsize=6, ncol=2)
        paths.append(_save(fig, out_dir, "tSNE.png"))
    return paths


def param_distribution_panels(alpha_vals, beta_vals, out_dir, alpha_groups=None,
                              beta_groups=None):
    """KDE (scipy's ``gaussian_kde``; a histogram where a sample has under
    three values or no spread), box, CDF and violin panels of the fitted
    alphas and betas."""
    from scipy.stats import gaussian_kde

    a = np.asarray(alpha_vals, float).ravel()
    b = np.asarray(beta_vals, float).ravel()
    paths = []
    kinds = [(a, "tab:blue", r"$\alpha$"), (b, "tab:green", r"$\beta$")]

    fig, ax = subplots(figsize=(7, 5))
    for vals, col, lbl in kinds:
        if len(vals) > 2 and vals.std() > 1e-12:
            xs = np.linspace(vals.min() - 0.1, vals.max() + 0.1, 200)
            d = gaussian_kde(vals)(xs)
            ax.plot(xs, d, color=col, label=lbl)
            ax.fill_between(xs, d, alpha=0.3, color=col)
        else:
            ax.hist(vals, bins=10, alpha=0.4, color=col, label=lbl, density=True)
    ax.set_xlabel("value")
    ax.set_ylabel("density")
    ax.legend()
    paths.append(_save(fig, out_dir, "distribution_parameters.png"))

    fig, ax = subplots(figsize=(6, 5))
    ax.boxplot([a, b], tick_labels=[r"$\alpha$", r"$\beta$"], patch_artist=True)
    ax.set_ylabel("value")
    paths.append(_save(fig, out_dir, "boxplot_parameters.png"))

    fig, ax = subplots(figsize=(7, 5))
    for vals, col, lbl in kinds:
        xs = np.sort(vals)
        ax.step(xs, np.arange(1, len(xs) + 1) / len(xs), color=col, label=lbl, where="post")
    ax.set_xlabel("value")
    ax.set_ylabel("CDF")
    ax.legend()
    paths.append(_save(fig, out_dir, "cdf_parameters.png"))

    fig, ax = subplots(figsize=(7, 5))
    parts = ax.violinplot([a, b], showmedians=True)
    for pc, col in zip(parts["bodies"], ["tab:blue", "tab:green"]):
        pc.set_facecolor(col)
    ax.set_xticks([1, 2])
    ax.set_xticklabels([r"$\alpha$", r"$\beta$"])
    ax.set_ylabel("estimated value")
    paths.append(_save(fig, out_dir, "violin_parameters.png"))
    return paths


def residual_panels(res_df, out_dir, group_col="Gene"):
    """The residual heatmap, each time's residual variance (the top five
    highlighted), each time's mean |residual| (the top and bottom three
    marked) and each group's cumulative |residual| (the five highest in
    reds, the five lowest in greens)."""
    tc = _tcols(res_df)
    R = _matrix(res_df, tc)
    groups = _strings(res_df[group_col])
    paths = []

    fig, ax = subplots(figsize=(8, max(4, 0.25 * len(R))))
    im = ax.imshow(R, aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(tc)))
    ax.set_xticklabels([c[1:] for c in tc], fontsize=7)
    ax.set_yticks(range(len(groups)))
    ax.set_yticklabels(groups, fontsize=5)
    ax.set_xlabel("time index")
    fig.colorbar(im, ax=ax, label="residual")
    paths.append(_save(fig, out_dir, "time_residuals.png"))

    var = R.var(axis=0)
    top5 = np.argsort(var)[-5:]
    fig, ax = subplots(figsize=(7, 5))
    bars = ax.bar(range(len(tc)), var, color="lightblue", edgecolor="black")
    for i in top5:
        bars[i].set_color("coral")
        ax.text(i, var[i], f"{var[i]:.2g}", ha="center", va="bottom", fontsize=7)
    ax.set_xticks(range(len(tc)))
    ax.set_xticklabels([c[1:] for c in tc], rotation=45, fontsize=7)
    ax.set_xlabel("time index")
    ax.set_ylabel("Var(residuals)")
    paths.append(_save(fig, out_dir, "variance_residuals.png"))

    mae = np.abs(R).mean(axis=0)
    fig, ax = subplots(figsize=(7, 5))
    ax.plot(range(len(tc)), mae, "o-", color="lightblue")
    for i in np.argsort(mae)[-3:]:
        ax.scatter(i, mae[i], color="red", marker="^", s=90, zorder=5)
    for i in np.argsort(mae)[:3]:
        ax.scatter(i, mae[i], color="green", marker="v", s=90, zorder=5)
    ax.set_xticks(range(len(tc)))
    ax.set_xticklabels([c[1:] for c in tc], rotation=45, fontsize=7)
    ax.set_xlabel("time index")
    ax.set_ylabel("mean |residual|")
    paths.append(_save(fig, out_dir, "error_trends.png"))

    keys, cum = group_sum(list(groups), np.abs(R).sum(axis=1))
    order = sort_desc(cum)
    keys, cum = [keys[i] for i in order], cum[order]
    n = len(cum)
    cols = ["teal"] * n
    for r, i in enumerate(range(min(5, n))):
        cols[i] = cmap_color("Reds", 0.9 - 0.12 * r)
    for r, i in enumerate(range(max(0, n - 5), n)):
        cols[i] = cmap_color("Greens", 0.9 - 0.12 * r)
    fig, ax = subplots(figsize=(8, 5))
    ax.bar(range(n), cum, color=cols, edgecolor="black")
    ax.set_xticks([])
    ax.set_ylabel("cumulative |residual|")
    hi = ", ".join(keys[: min(5, n)])
    ax.set_title(f"highest: {hi}", fontsize=8)
    paths.append(_save(fig, out_dir, "residual_profiles.png"))
    return paths


# ---------------------------------------------------------------------------
# network flows (a standalone SVG page)
# ---------------------------------------------------------------------------

def sankey_html(edges: dict, out_path, title="Network flows"):
    """A two-column Sankey page (source -> target, ribbon width ~ value)
    of a table of three columns (source, target, value), the rows with a
    positive value."""
    src_col, tgt_col, val_col = list(edges)[:3]
    val = np.asarray(edges[val_col], float)
    keep = val > 0
    src = list(np.asarray(edges[src_col], dtype=object)[keep])
    tgt = list(np.asarray(edges[tgt_col], dtype=object)[keep])
    val = val[keep]
    srcs, tgts = _first_seen(src), _first_seen(tgt)
    H, W, PAD = max(420, 22 * max(len(srcs), len(tgts))), 860, 30
    s_tot = dict(zip(*group_sum(src, val)))
    t_tot = dict(zip(*group_sum(tgt, val)))
    total = max(val.sum(), 1e-12)
    scale = (H - PAD * 2) / total

    def stack(names, tot):
        pos, y = {}, PAD
        for nm in names:
            h = float(tot.get(nm, 0)) * scale
            pos[nm] = [y, y]  # [top, cursor]
            y += h + 4
        return pos

    sp, tp = stack(srcs, s_tot), stack(tgts, t_tot)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
             f'height="{H + PAD}" font-family="sans-serif">']
    for i, (s, t, v) in enumerate(zip(src, tgt, val)):
        h = v * scale
        y0 = sp[s][1]
        y1 = tp[t][1]
        sp[s][1] += h
        tp[t][1] += h
        c = to_hex(COLORS[i % len(COLORS)])
        parts.append(
            f'<path d="M 150 {y0 + h / 2:.1f} C 430 {y0 + h / 2:.1f} 430 '
            f'{y1 + h / 2:.1f} 710 {y1 + h / 2:.1f}" stroke="{c}" '
            f'stroke-width="{max(h, 1):.1f}" fill="none" opacity="0.55">'
            f'<title>{html.escape(str(s))} → '
            f'{html.escape(str(t))}: {v:.3g}</title>'
            f'</path>')
    for nm in srcs:
        top, bot = sp[nm][0], sp[nm][1]
        parts.append(f'<rect x="140" y="{top:.1f}" width="10" '
                     f'height="{max(bot - top, 1):.1f}" fill="#333"/>'
                     f'<text x="134" y="{(top + bot) / 2:.1f}" font-size="11"'
                     f' text-anchor="end">{html.escape(str(nm))}</text>')
    for nm in tgts:
        top, bot = tp[nm][0], tp[nm][1]
        parts.append(f'<rect x="710" y="{top:.1f}" width="10" '
                     f'height="{max(bot - top, 1):.1f}" fill="#333"/>'
                     f'<text x="726" y="{(top + bot) / 2:.1f}" '
                     f'font-size="11">{html.escape(str(nm))}</text>')
    parts.append("</svg>")
    doc = (f"<!doctype html><html><head><title>{html.escape(title)}</title>"
           f"</head><body><h3>{html.escape(title)}</h3>"
           + "".join(parts) + "</body></html>")
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def _edge_sums(table, cols) -> dict:
    """pandas' ``groupby([src, tgt], as_index=False)[val].sum()``."""
    src, tgt, val = cols
    keys, sums = group_sum(list(zip(table[src], table[tgt])), table[val])
    return {src: np.asarray([k[0] for k in keys], dtype=object),
            tgt: np.asarray([k[1] for k in keys], dtype=object), val: sums}


def _write_frame_csv(path, table) -> None:
    """A table as pandas' ``to_csv(index=False)`` writes it."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(list(table))
        cols = list(table.values())
        for i in range(len(cols[0]) if cols else 0):
            w.writerow([repr(float(c[i])) if isinstance(c[i], (float, np.floating)) else c[i]
                        for c in cols])


def important_connections(alpha_df, out_dir, top_n=20, cols=("Kinase", "Gene", "Alpha")):
    """The ``top_n`` strongest (source, target) edges, their values summed
    over the rows of a pair: ``important_connections.csv`` and its bars."""
    src, tgt, val = cols
    e = _edge_sums(alpha_df, cols)
    order = sort_desc(e[val])[:top_n]
    e = {c: np.asarray(v)[order] for c, v in e.items()}
    fig, ax = subplots(figsize=(8, max(4, 0.3 * len(e[val]))))
    labels = [f"{s} → {t}" for s, t in zip(e[src], e[tgt])]
    ax.barh(labels[::-1], np.asarray(e[val], float)[::-1], color="steelblue", edgecolor="black")
    ax.set_xlabel(val)
    ax.set_title(f"top {len(e[val])} connections")
    path = _save(fig, out_dir, "important_connections.png")
    _write_frame_csv(os.path.join(out_dir, "important_connections.csv"), e)
    return e, path


# ---------------------------------------------------------------------------
# tfopt panels
# ---------------------------------------------------------------------------

def alpha_strips_per_mrna(alpha_df, out_dir, max_genes=None):
    """A strip of each mRNA's regulator alphas, a marker a TF."""
    markers = "osD^vPXh*<>"
    paths = []
    mrna = np.asarray(alpha_df["mRNA"], dtype=object)
    genes = _first_seen(mrna.tolist())
    if max_genes is not None:
        genes = genes[:max_genes]
    for g in genes:
        sub = _rows(alpha_df, mrna == g)
        order = sort_asc(sub["Value"])
        fig, ax = subplots(figsize=(7, 2.6))
        for i, k in enumerate(order):
            ax.scatter(float(sub["Value"][k]), 0, marker=markers[i % len(markers)], s=70,
                       edgecolor="black", label=str(sub["TF"][k]))
        ax.set_yticks([])
        ax.set_xlabel("alpha")
        ax.set_title(f"mRNA: {g}", fontsize=9)
        ax.legend(fontsize=6, ncol=4, loc="upper center", bbox_to_anchor=(0.5, -0.35))
        paths.append(_save(fig, out_dir, f"alpha_distribution_{g}.png"))
    return paths


def beta_bars_per_tf(beta_df, out_dir, max_tfs=None):
    """Each TF's beta0 (protein, as "β₀") and per-site betas as bars."""
    paths = []
    tf_col = np.asarray(beta_df["TF"], dtype=object)
    tfs = _first_seen(tf_col.tolist())
    if max_tfs is not None:
        tfs = tfs[:max_tfs]
    for tf in tfs:
        sub = _rows(beta_df, tf_col == tf)
        sites = ["β₀" if is_missing(s) or s == "" else str(s) for s in sub["PSite"]]
        fig, ax = subplots(figsize=(5.5, 4.5))
        ax.bar(sites, np.asarray(sub["Value"], float),
               color=[COLORS[i % len(COLORS)] for i in range(len(sites))], edgecolor="black",
               linewidth=0.5)
        ax.set_xlabel("residue position")
        ax.set_ylabel("β")
        ax.set_title(f"phospho effect on TF {tf} activity", fontsize=8)
        ax.grid(alpha=0.2)
        paths.append(_save(fig, out_dir, f"TF_{tf}_beta_group.png"))
    return paths


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def kinopt_fit_analysis(prob, result, out_dir, meta=None) -> dict:
    """The kinopt panels of a fit (:func:`kinopt_fit_analysis_from_sheets`
    of its sheets) and its network-readout figures."""
    from phoskintime_tpu_torch.analysis.network_tools import (kinopt_signal_readout,
                                                              plot_signal_readout)
    from phoskintime_tpu_torch.io.export import kinopt_sheets

    out = kinopt_fit_analysis_from_sheets(kinopt_sheets(prob, result, meta), out_dir)
    tabs = kinopt_signal_readout(prob, result.alpha, result.beta)
    out["network_readout"] = plot_signal_readout(tabs, out_dir, which="kinopt")
    return out


def kinopt_fit_analysis_from_sheets(sheets: dict, out_dir) -> dict:
    """The kinopt panels from the result sheets (Observed, Estimated,
    Residuals, Alpha Values, Beta Values), as written or read back."""
    os.makedirs(out_dir, exist_ok=True)
    obs, est, res = sheets["Observed"], sheets["Estimated"], sheets["Residuals"]
    alpha, beta = sheets["Alpha Values"], sheets["Beta Values"]
    site = np.asarray([not (is_missing(p) or p == "") for p in beta["Psite"]])

    out = {"gof": goodness_of_fit_plot(obs, est, out_dir),
           "kld": kld_plot(obs, est, out_dir),
           "embeddings": pca_tsne_plots(est, out_dir),
           "params": param_distribution_panels(np.asarray(alpha["Alpha"], float),
                                               np.asarray(beta["Beta"], float)[site], out_dir),
           "residuals": residual_panels(res, out_dir)}
    e = _edge_sums(alpha, ("Kinase", "Gene", "Alpha"))
    out["sankey"] = sankey_html(e, os.path.join(out_dir, "network_sankey.html"),
                                title="Kinase → substrate flows")
    out["top_connections"] = important_connections(alpha, out_dir)[1]
    return out


def tfopt_fit_analysis(prob, result, out_dir, max_detail=12) -> dict:
    """The tfopt panels of a fit and its TF network-readout figures."""
    from phoskintime_tpu_torch.analysis.network_tools import (plot_signal_readout,
                                                              tfopt_signal_readout)
    from phoskintime_tpu_torch.io.export import tfopt_sheets

    out = tfopt_fit_analysis_from_sheets(tfopt_sheets(prob, result), out_dir,
                                         max_detail=max_detail)
    tabs = tfopt_signal_readout(prob, result.alpha, result.beta)
    out["network_readout"] = plot_signal_readout(tabs, out_dir, which="tfopt")
    return out


def tfopt_fit_analysis_from_sheets(sheets: dict, out_dir, max_detail=12) -> dict:
    """The tfopt panels from the result sheets (Observed, Estimated, Alpha
    Values, Beta Values); the residuals are observed less estimated."""
    os.makedirs(out_dir, exist_ok=True)
    obs, est = sheets["Observed"], sheets["Estimated"]
    alpha, beta = sheets["Alpha Values"], sheets["Beta Values"]
    tc = _tcols(obs)
    res = dict(est)
    diff = _matrix(obs, tc) - _matrix(est, tc)
    res.update({c: diff[:, j] for j, c in enumerate(tc)})

    out = {"gof": goodness_of_fit_plot(obs, est, out_dir, group_col="mRNA"),
           "kld": kld_plot(obs, est, out_dir, group_col="mRNA"),
           "embeddings": pca_tsne_plots(est, out_dir, group_col="mRNA"),
           "params": param_distribution_panels(np.asarray(alpha["Value"], float),
                                               np.asarray(beta["Value"], float), out_dir),
           "residuals": residual_panels(res, out_dir, group_col="mRNA"),
           "alpha_strips": alpha_strips_per_mrna(alpha, out_dir, max_genes=max_detail),
           "beta_bars": beta_bars_per_tf(beta, out_dir, max_tfs=max_detail)}
    out["sankey"] = sankey_html({c: alpha[c] for c in ("TF", "mRNA", "Value")},
                                os.path.join(out_dir, "network_sankey.html"),
                                title="TF → mRNA flows")
    out["top_connections"] = important_connections(alpha, out_dir,
                                                   cols=("TF", "mRNA", "Value"))[1]
    return out


def fit_analysis_from_workbook(path, out_dir, kind: str) -> dict:
    """The panels of ``kind`` ("kinopt" or "tfopt") from a saved results
    workbook's CSV sheets (``<stem>_<sheet>.csv``), without refitting."""
    from phoskintime_tpu_torch.io.load import read_table

    if kind == "kinopt":
        names = ["Observed", "Estimated", "Alpha Values", "Beta Values", "Residuals"]
    elif kind == "tfopt":
        names = ["Observed", "Estimated", "Alpha Values", "Beta Values"]
    else:
        raise ValueError(f"kind must be kinopt|tfopt, got {kind!r}")
    sheets = {}
    for n in names:
        table = read_table(path, sheet_name=n)
        if table is None:
            raise FileNotFoundError(f"sheet {n!r} of {path} not found")
        sheets[n] = table
    if kind == "kinopt":
        return kinopt_fit_analysis_from_sheets(sheets, out_dir)
    return tfopt_fit_analysis_from_sheets(sheets, out_dir)
