"""The per-gene figures (:class:`Plotter`) and the global model's: the
Pareto front in 3-D, the convergence of the ideal point and the front's
parallel coordinates.

Counterpart of ``phoskintime_tpu/report/plotter.py``, drawn by the port's
own drawing layer (:mod:`phoskintime_tpu_torch.report.draw`): the same
figure sizes, dpi, axes, data, colours and labels, the port's pixels.
Each function brings its tensors to the host once. Where the JAX writers
take a pandas DataFrame, these take a table of columns (a dict of 1-D
arrays, as :func:`~phoskintime_tpu_torch.io.utils.read_csv` returns; a
DataFrame serves as well); a results workbook is read from the CSV
sheets the port writes. PCA and t-SNE are the port's own
(:mod:`phoskintime_tpu_torch.analysis.embed`; its t-SNE is the exact
method, scikit-learn's default is Barnes-Hut).
"""

from __future__ import annotations

import glob
import os
import re
from itertools import combinations

import numpy as np

from phoskintime_tpu_torch.io.utils import host, read_csv
from phoskintime_tpu_torch.report.draw import TAB10, Figure, cmap_color, subplots

COLORS = TAB10


def _col(table, name) -> np.ndarray:
    return np.asarray(table[name])


def _pearson_welford(M: np.ndarray) -> np.ndarray:
    """pandas' ``DataFrame.corr()`` of complete columns: each pair's
    Pearson r by Welford's updates in row order (NaN where a column is
    constant)."""
    K = M.shape[1]
    out = np.full((K, K), np.nan)
    for xi in range(K):
        for yi in range(xi + 1):
            nobs = ssqdmx = ssqdmy = covxy = meanx = meany = 0.0
            for vx, vy in zip(M[:, xi].tolist(), M[:, yi].tolist()):
                nobs += 1
                dx, dy = vx - meanx, vy - meany
                meanx += 1.0 / nobs * dx
                meany += 1.0 / nobs * dy
                ssqdmx += (vx - meanx) * dx
                ssqdmy += (vy - meany) * dy
                covxy += (vx - meanx) * dy
            divisor = np.sqrt(ssqdmx * ssqdmy)
            if nobs >= 1 and divisor != 0:
                out[xi, yi] = out[yi, xi] = covxy / divisor
    return out


class Plotter:
    """The per-gene figure factory: every method writes
    ``<out_dir>/<gene>_<name>.png`` and returns its path."""

    def __init__(self, gene: str, out_dir: str):
        self.gene = gene
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)

    def _save(self, fig, name: str) -> str:
        path = os.path.join(self.out_dir, f"{self.gene}_{name}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        return path

    # ------------------------------------------------------------------
    def plot_model_fit(self, time_points, sol, target=None, state_labels=None,
                       rna_time_points=None, name="model_fit"):
        """Fitted trajectories (solid) against the observations (markers:
        mRNA, protein, then each site)."""
        sol = host(sol)
        fig, ax = subplots(figsize=(8, 5))
        for j in range(sol.shape[1]):
            lbl = state_labels[j] if state_labels else f"state {j}"
            ax.plot(time_points, sol[:, j], color=COLORS[j % 10], label=lbl)
        if target is not None:
            tgt = host(target)
            T = len(time_points)
            rna_t = rna_time_points if rna_time_points is not None else time_points[5:]
            n_r = len(rna_t)
            ax.plot(rna_t, tgt[:n_r], "o", color=COLORS[0], ms=4)
            ax.plot(time_points, tgt[n_r:n_r + T], "s", color=COLORS[1], ms=4)
            rest = tgt[n_r + T:]
            for j in range(len(rest) // T):
                ax.plot(time_points, rest[j * T:(j + 1) * T], "^", color=COLORS[(2 + j) % 10],
                        ms=4)
        ax.set_xscale("symlog")
        ax.set_xlabel("time [min]")
        ax.set_ylabel("abundance (FC)")
        ax.set_title(f"{self.gene}: model fit")
        ax.legend(fontsize=7, ncol=2)
        return self._save(fig, name)

    def plot_params_bar(self, ci_results: dict, param_names):
        """Parameter estimates with their 95% CI whiskers; None without CIs."""
        if ci_results is None:
            return None
        est = host(ci_results["beta_hat"])
        lwr = host(ci_results["lwr_ci"])
        upr = host(ci_results["upr_ci"])
        fig, ax = subplots(figsize=(max(6, 0.5 * len(est)), 4))
        x = np.arange(len(est))
        yerr = np.stack([est - lwr, upr - est])
        ax.bar(x, est, color=COLORS[0], alpha=0.8)
        ax.errorbar(x, est, yerr=np.maximum(yerr, 0), fmt="none", ecolor="k", capsize=3, lw=1)
        ax.set_xticks(x)
        ax.set_xticklabels(param_names, rotation=60, ha="right", fontsize=7)
        ax.set_title(f"{self.gene}: parameter estimates (95% CI)")
        return self._save(fig, "params_ci")

    def plot_scree(self, param_samples, target_variance=0.99):
        """Scree plot: each component's and the cumulative explained
        variance, the component count that reaches ``target_variance``
        marked. Returns (k, ratios); None under 3 samples."""
        from phoskintime_tpu_torch.analysis.embed import PCA

        X = host(param_samples)
        if len(X) < 3:
            return None
        p = PCA(n_components=min(X.shape)).fit(X)
        ev = p.explained_variance_ratio_
        cum = np.cumsum(ev)
        k = int(np.argmax(cum >= target_variance) + 1)
        fig, ax = subplots(figsize=(7, 6))
        ax.bar(range(1, len(ev) + 1), ev * 100, alpha=0.6, color=COLORS[0], label="Individual")
        ax.plot(range(1, len(cum) + 1), cum * 100, marker="o", color=COLORS[1],
                label="Cumulative")
        ax.axvline(x=k, color=COLORS[2], ls="--", label=f"{k} components")
        ax.set_title(self.gene)
        ax.set_xlabel("Principal Component")
        ax.set_ylabel("Explained Variance (%)")
        ax.legend()
        ax.grid(True, alpha=0.2)
        self._save(fig, "scree_plot")
        return k, ev

    def plot_pca(self, param_samples, var_target=0.99):
        """The ensemble on its first two principal components; None under
        3 samples."""
        from phoskintime_tpu_torch.analysis.embed import PCA

        X = host(param_samples)
        if len(X) < 3:
            return None
        p = PCA(n_components=min(X.shape))
        Z = p.fit_transform(X)
        k = int(np.searchsorted(np.cumsum(p.explained_variance_ratio_), var_target) + 1)
        fig, ax = subplots(figsize=(6, 5))
        ax.scatter(Z[:, 0], Z[:, 1] if Z.shape[1] > 1 else np.zeros(len(Z)), s=10, alpha=0.6,
                   color=COLORS[0])
        ax.set_xlabel(f"PC1 ({p.explained_variance_ratio_[0]:.0%})")
        if Z.shape[1] > 1:
            ax.set_ylabel(f"PC2 ({p.explained_variance_ratio_[1]:.0%})")
        ax.set_title(f"{self.gene}: parameter PCA ({k} comps -> {var_target:.0%} var)")
        return self._save(fig, "pca")

    def plot_tsne(self, param_samples, perplexity=15):
        """The ensemble's exact t-SNE embedding; None under 10 samples."""
        from phoskintime_tpu_torch.analysis.embed import tsne

        X = host(param_samples)
        if len(X) < 10:
            return None
        Z = tsne(X, perplexity=min(perplexity, len(X) // 3))
        fig, ax = subplots(figsize=(6, 5))
        ax.scatter(Z[:, 0], Z[:, 1], s=10, alpha=0.6, color=COLORS[1])
        ax.set_title(f"{self.gene}: parameter t-SNE")
        return self._save(fig, "tsne")

    def plot_parallel(self, param_samples, param_names, values=None):
        """Parallel coordinates: each sample's parameters scaled to [0, 1]
        over the ensemble, coloured by ``values`` (default: the order)."""
        X = host(param_samples)
        lo, hi = X.min(axis=0), X.max(axis=0)
        span = np.where(hi - lo > 0, hi - lo, 1.0)
        Xn = (X - lo) / span
        fig, ax = subplots(figsize=(max(6, 0.6 * X.shape[1]), 4))
        cvals = host(values) if values is not None else np.arange(len(X))
        vmin, vmax = cvals.min(), cvals.max() + 1e-12
        for i in range(len(Xn)):
            ax.plot(Xn[i], color=cmap_color("viridis", (cvals[i] - vmin) / (vmax - vmin)),
                    alpha=0.4, lw=0.8)
        ax.set_xticks(range(X.shape[1]))
        ax.set_xticklabels(param_names, rotation=60, ha="right", fontsize=7)
        ax.set_title(f"{self.gene}: parallel coordinates")
        return self._save(fig, "parallel")

    def plot_gof(self, target, prediction):
        """Observed against predicted with the diagonal, R^2 and chi^2."""
        t = host(target).ravel()
        p = host(prediction).ravel()
        ss_res = np.sum((t - p) ** 2)
        ss_tot = np.sum((t - t.mean()) ** 2)
        r2 = 1 - ss_res / ss_tot if ss_tot > 0 else np.nan
        chi2 = np.sum((t - p) ** 2 / np.maximum(np.abs(p), 1e-9))
        fig, ax = subplots(figsize=(5, 5))
        ax.scatter(t, p, s=12, alpha=0.6)
        lims = [min(t.min(), p.min()), max(t.max(), p.max())]
        ax.plot(lims, lims, "k--", lw=1)
        ax.set_xlabel("observed")
        ax.set_ylabel("predicted")
        ax.set_title(f"{self.gene}: GOF  R2={r2:.3f}  chi2={chi2:.2f}")
        return self._save(fig, "gof")

    def plot_kld(self, target, prediction, bins=20):
        """The observed and predicted value densities and their KL
        divergence."""
        t = np.abs(host(target).ravel()) + 1e-12
        p = np.abs(host(prediction).ravel()) + 1e-12
        lo, hi = min(t.min(), p.min()), max(t.max(), p.max())
        ht, edges = np.histogram(t, bins=bins, range=(lo, hi), density=True)
        hp, _ = np.histogram(p, bins=bins, range=(lo, hi), density=True)
        ht = ht + 1e-12
        hp = hp + 1e-12
        kld = float(np.sum(ht * np.log(ht / hp)) * (edges[1] - edges[0]))
        centers = 0.5 * (edges[:-1] + edges[1:])
        fig, ax = subplots(figsize=(6, 4))
        ax.plot(centers, ht, label="observed", color=COLORS[0])
        ax.plot(centers, hp, label="predicted", color=COLORS[1])
        ax.set_title(f"{self.gene}: distribution match (KLD={kld:.4f})")
        ax.legend()
        return self._save(fig, "kld")

    def plot_knockouts(self, time_points, wt_sol, ko_sols, ko_labels, state_idx=1):
        """Wild type against each knockout, for one state."""
        fig, ax = subplots(figsize=(8, 5))
        ax.plot(time_points, host(wt_sol)[:, state_idx], "k-", lw=2, label="wild-type")
        for i, (sol, lbl) in enumerate(zip(ko_sols, ko_labels)):
            ax.plot(time_points, host(sol)[:, state_idx], color=COLORS[i % 10], lw=1, alpha=0.7,
                    label=lbl)
        ax.set_xscale("symlog")
        ax.set_title(f"{self.gene}: knockout scan")
        ax.legend(fontsize=6, ncol=2)
        return self._save(fig, "knockouts")

    def plot_perturbation_cloud(self, time_points, solutions, best_sol=None, state_idx=0,
                                opacity=0.05):
        """The Morris perturbations' trajectories of one state, the best
        fit over them."""
        fig, ax = subplots(figsize=(7, 4))
        for sol in host(solutions):
            ax.plot(time_points, sol[:, state_idx], color=COLORS[0], alpha=opacity, lw=0.8)
        if best_sol is not None:
            ax.plot(time_points, host(best_sol)[:, state_idx], "k-", lw=2)
        ax.set_xscale("symlog")
        ax.set_title(f"{self.gene}: perturbation cloud (state {state_idx})")
        return self._save(fig, f"perturb_{state_idx}")

    def plot_morris(self, morris_result, param_names):
        """mu* against sigma with mu*'s confidence as x error bars."""
        mu_star = host(morris_result.mu_star)
        sigma = host(morris_result.sigma)
        fig, ax = subplots(figsize=(6, 5))
        ax.errorbar(mu_star, sigma, xerr=host(morris_result.mu_star_conf), fmt="o", ms=5,
                    capsize=2)
        for x, y, n in zip(mu_star, sigma, param_names):
            ax.annotate(n, (x, y), fontsize=7, textcoords="offset points", xytext=(4, 2))
        ax.set_xlabel("mu* (mean |elementary effect|)")
        ax.set_ylabel("sigma (interaction / nonlinearity)")
        ax.set_title(f"{self.gene}: Morris sensitivity")
        return self._save(fig, "morris")

    def plot_phase_space(self, sol, i=0, j=1, labels=("mRNA", "protein")):
        sol = host(sol)
        fig, ax = subplots(figsize=(5, 5))
        ax.plot(sol[:, i], sol[:, j], "-o", ms=3)
        ax.set_xlabel(labels[0])
        ax.set_ylabel(labels[1])
        ax.set_title(f"{self.gene}: phase space")
        return self._save(fig, "phase")

    def plot_time_state_grid(self, time_points, sol, state_labels=None):
        """One panel a state, four a row."""
        sol = host(sol)
        d = sol.shape[1]
        ncol = min(4, d)
        nrow = int(np.ceil(d / ncol))
        fig, axes = subplots(nrow, ncol, figsize=(3 * ncol, 2.2 * nrow), squeeze=False)
        for j in range(d):
            ax = axes[j // ncol][j % ncol]
            ax.plot(time_points, sol[:, j], color=COLORS[j % 10])
            ax.set_xscale("symlog")
            ax.set_title(state_labels[j] if state_labels else f"state {j}", fontsize=8)
        for j in range(d, nrow * ncol):
            axes[j // ncol][j % ncol].axis("off")
        fig.suptitle(f"{self.gene}: per-state trajectories")
        return self._save(fig, "state_grid")

    def plot_error_summary(self, errors: dict):
        """Bars of named error metrics."""
        names = list(errors)
        vals = [errors[k] for k in names]
        fig, ax = subplots(figsize=(max(5, 0.5 * len(names)), 4))
        ax.bar(names, vals, color=COLORS[2])
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels(names, rotation=60, ha="right", fontsize=7)
        ax.set_title(f"{self.gene}: error summary")
        return self._save(fig, "errors")

    # ------------------------------------------------------------------
    def plot_param_series(self, estimated_params, param_names, time_points):
        """Estimated kinetic rates over time, a line a parameter."""
        arr = np.asarray(host(estimated_params), float)
        fig, ax = subplots(figsize=(7, 5))
        for i in range(arr.shape[1]):
            ax.plot(time_points, arr[:, i], color=COLORS[i % 10],
                    label=param_names[i] if i < len(param_names) else f"p{i}")
        ax.set_xlabel("time [min]")
        ax.set_ylabel("kinetic rate")
        ax.set_title(f"{self.gene}: parameter series")
        ax.grid(alpha=0.2)
        ax.legend(fontsize=7, ncol=2)
        return self._save(fig, "params_series")

    def plot_profiles(self, data):
        """Each column of a table with a ``Time`` column over time."""
        cols = [c for c in data if c != "Time"]
        fig, ax = subplots(figsize=(7, 5))
        for i, c in enumerate(cols):
            ax.plot(_col(data, "Time"), _col(data, c), marker="o", ms=4, color=COLORS[i % 10],
                    label=str(c))
        ax.set_xlabel("time [min]")
        ax.set_ylabel("kinetic rate")
        ax.set_title(f"{self.gene}: parameter profiles")
        ax.grid(alpha=0.2)
        ax.legend(fontsize=7)
        return self._save(fig, "params_profiles")

    def plot_param_scatter(self, est_arr, num_psites, time_vals):
        """A, B, C and D against each site's S rate: a time-coloured
        scatter with a linear trend a site, and a density panel (scipy's
        ``gaussian_kde`` as filled contours). Returns the written paths
        (two a base parameter)."""
        from scipy.stats import gaussian_kde

        est_arr = np.asarray(host(est_arr), float)
        time_vals = np.asarray(time_vals, float)
        markers = "osD^vPXh*"
        paths = []
        for idx, label in enumerate(["A", "B", "C", "D"]):
            x = est_arr[:, idx]
            fig, ax = subplots(figsize=(6.5, 5))
            sc = None
            for i in range(num_psites):
                y = est_arr[:, 4 + i]
                sc = ax.scatter(x, y, c=time_vals, cmap="viridis", s=40, alpha=0.8,
                                marker=markers[i % len(markers)])
                if np.ptp(x) > 0:
                    k, b = np.polyfit(x, y, 1)
                    xs = np.linspace(x.min(), x.max(), 50)
                    ax.plot(xs, k * xs + b, color=COLORS[i % 10], lw=1, label=f"S{i + 1}")
            if sc is not None:
                fig.colorbar(sc, ax=ax, label="time [min]")
            ax.set_xlabel(f"{label} (rate)")
            ax.set_ylabel("S (phosphorylation rate)")
            ax.set_title(self.gene)
            ax.grid(alpha=0.2)
            ax.legend(fontsize=7)
            paths.append(self._save(fig, f"scatter_{label}_S"))

            pts = np.vstack([np.column_stack((x, est_arr[:, 4 + i])) for i in range(num_psites)])
            fig, ax = subplots(figsize=(6.5, 5))
            ax.scatter(pts[:, 0], pts[:, 1], c="k", s=20, alpha=0.5)
            try:
                kde = gaussian_kde(pts.T)
                gx = np.linspace(pts[:, 0].min(), pts[:, 0].max(), 80)
                gy = np.linspace(pts[:, 1].min(), pts[:, 1].max(), 80)
                GX, GY = np.meshgrid(gx, gy)
                D = kde(np.vstack([GX.ravel(), GY.ravel()])).reshape(GX.shape)
                cf = ax.contourf(GX, GY, D, levels=10, cmap="inferno", alpha=0.7)
                fig.colorbar(cf, ax=ax, label="density")
            except np.linalg.LinAlgError:
                pass  # degenerate sample (collinear points): scatter only
            ax.set_xlabel(label)
            ax.set_ylabel("S")
            ax.set_title(self.gene)
            paths.append(self._save(fig, f"density_{label}_S"))
        return paths

    def plot_heatmap(self, param_value_df):
        """The protein x protein correlation of a table of parameter
        profiles (a row a protein, named by its ``Protein`` column)."""
        names = [c for c in param_value_df if c != "Protein"]
        M = np.column_stack([np.asarray(param_value_df[c], float) for c in names])
        index = (list(_col(param_value_df, "Protein")) if "Protein" in param_value_df
                 else list(range(len(M))))
        corr = np.corrcoef(M)
        fig, ax = subplots(figsize=(7, 6))
        im = ax.imshow(corr, cmap="coolwarm", vmin=-1, vmax=1)
        ax.set_xticks(range(len(index)))
        ax.set_yticks(range(len(index)))
        ax.set_xticklabels(index, rotation=90, fontsize=6)
        ax.set_yticklabels(index, fontsize=6)
        fig.colorbar(im, ax=ax, label="Pearson r")
        ax.set_title("parameter-profile correlation")
        return self._save(fig, "heatmap_protein")

    def plot_top_param_pairs(self, perturbations, max_pairs_per_gene=None):
        """Pairwise scatter and regression band of each gene's
        perturbation samples, the pairs in order of |r|.

        ``perturbations``: {gene: table of samples}, or a workbook path
        whose ``<stem>_<gene>_perturbations.csv`` sheets hold them (the
        gene then named as the sheet's file name spells it)."""
        if isinstance(perturbations, (str, os.PathLike)):
            stem = re.sub(r"\.xlsx?$", "", str(perturbations))
            perturbations = {
                f[len(stem) + 1: -len("_perturbations.csv")]: read_csv(f)
                for f in sorted(glob.glob(glob.escape(stem) + "_*_perturbations.csv"))}

        paths = []
        for gene, df in perturbations.items():
            cols = [c for c in df if isinstance(c, str) and c != "RMSE"
                    and re.fullmatch(r"[A-Za-z]\d?", c)]
            if len(cols) < 2:
                continue
            M = np.column_stack([np.asarray(df[c], float) for c in cols])
            M = M[~np.isnan(M).any(axis=1)]
            M = M[sorted({tuple(r): i for i, r in reversed(list(enumerate(M.tolist())))}
                         .values())]
            if not len(M):
                continue
            corr = np.abs(_pearson_welford(M))
            at = {c: k for k, c in enumerate(cols)}
            pairs = sorted(combinations(cols, 2), key=lambda ab: -corr[at[ab[0]], at[ab[1]]])
            if max_pairs_per_gene is not None:
                pairs = pairs[:max_pairs_per_gene]
            for a, b in pairs:
                x, y = M[:, at[a]], M[:, at[b]]
                fig, ax = subplots(figsize=(6, 6))
                ax.scatter(x, y, s=10, alpha=0.7)
                if np.ptp(x) > 0 and len(x) > 2:
                    k, c0 = np.polyfit(x, y, 1)
                    xs = np.linspace(x.min(), x.max(), 60)
                    yh = k * xs + c0
                    resid = y - (k * x + c0)
                    se = np.sqrt(np.sum(resid ** 2) / (len(x) - 2))
                    band = 1.96 * se * np.sqrt(1 / len(x) + (xs - x.mean()) ** 2
                                               / max(np.sum((x - x.mean()) ** 2), 1e-12))
                    ax.plot(xs, yh, color="red", alpha=0.6)
                    ax.fill_between(xs, yh - band, yh + band, color="red", alpha=0.15)
                ax.set_xlabel(a)
                ax.set_ylabel(b)
                ax.set_title(f"{gene}: {a} vs {b}  |r|={corr[at[a], at[b]]:.2f}", fontsize=10)
                path = os.path.join(self.out_dir, f"{gene}_param_scatter_{a}_vs_{b}.png")
                fig.savefig(path, dpi=120, bbox_inches="tight")
                paths.append(path)
        return paths

    def plot_future_fit(self, P_data, R_data, sol, num_psites, psite_labels, time_points,
                        rna_time_points=None, cutoff_idx=8):
        """The fitted window and the extrapolation beside it: mRNA, protein
        and each site, the observations dashed with square markers."""
        sol = np.asarray(host(sol), float)
        P_data = np.asarray(host(P_data), float)
        R_data = np.asarray(host(R_data), float)
        tp = np.asarray(time_points, float)
        rt = (np.asarray(rna_time_points, float) if rna_time_points is not None
              else tp[: len(R_data)])
        n_obs_t = P_data.shape[1]

        fig, axes = subplots(1, 2, figsize=(13, 5.5), sharey=True)
        for side, (ax, sl) in enumerate(zip(axes, [slice(None, cutoff_idx),
                                                   slice(cutoff_idx, None)])):
            t = tp[sl]
            ax.plot(t, sol[sl, 0], "-", color="black", lw=1, label="mRNA (R)" if side else None)
            rmask = (rt >= t[0]) & (rt <= t[-1]) if len(t) else np.zeros_like(rt, bool)
            ax.plot(rt[rmask], R_data[rmask], "s--", ms=4, mec="k", color="black", alpha=0.7,
                    lw=0.8)
            ax.plot(t, sol[sl, 1], "-", color="red", lw=1, label="protein (P)" if side else None)
            for i in range(num_psites):
                obs_sl = slice(sl.start or 0, min(n_obs_t, sl.stop or n_obs_t))
                ax.plot(tp[obs_sl], P_data[i, obs_sl], "s--", ms=4, mec="k",
                        color=COLORS[i % 10], alpha=0.8, lw=0.8)
                ax.plot(t, sol[sl, 2 + i], "-", color=COLORS[i % 10], lw=1,
                        label=psite_labels[i] if side else None)
            ax.set_xlabel("time [min]")
            ax.grid(alpha=0.1)
        axes[0].set_ylabel("FC")
        axes[0].set_title("fitted window")
        axes[1].set_title("extrapolation")
        axes[1].legend(fontsize=7)
        fig.suptitle(self.gene)
        return self._save(fig, "future_fit")

    def plot_regularization(self, results, model_name="model"):
        """Horizontal bars of each gene's L2 regularization term from a
        results table (``gene``/``reg_term`` columns) or its workbook."""
        return self._per_gene_bars(results, ["reg_term", "Regularization"],
                                   "Tikhonov regularization "
                                   r"$R=\frac{\lambda}{m}\sum_j p_j^2$",
                                   f"{model_name}_regularization", color="skyblue")

    def plot_model_error(self, results, model_name="model"):
        """Horizontal bars of each gene's fit error."""
        return self._per_gene_bars(results, ["error", "MSE", "RMSE"],
                                   r"$\mathrm{MSE}=\frac{1}{n}\sum_i"
                                   r"(y_i-\hat y_i)^2$",
                                   f"{model_name}_error", color="coral")

    def _per_gene_bars(self, results, value_cols, title, name, color):
        if isinstance(results, (str, os.PathLike)):
            results = _read_results_table(results)
        col = next((c for c in value_cols if c in results), None)
        gcol = "gene" if "gene" in results else "Gene"
        if col is None or gcol not in results or not len(_col(results, gcol)):
            return None
        genes, vals = _col(results, gcol), np.asarray(results[col], float)
        keep = ~np.isnan(vals) & np.asarray([g is not None and g == g for g in genes])
        genes, vals = genes[keep], vals[keep]
        order = np.argsort(vals, kind="quicksort")
        genes, vals = genes[order], vals[order]
        fig, ax = subplots(figsize=(7, max(4, 0.3 * len(vals))))
        bars = ax.barh([str(g) for g in genes], vals, color=color, edgecolor="black", height=0.6)
        for b in bars:
            ax.text(b.get_width() + max(vals.max(), 1e-12) * 0.01,
                    b.get_y() + b.get_height() / 2, f"{b.get_width():.3g}", va="center",
                    fontsize=6)
        ax.set_xlabel("value", fontsize=8)
        ax.set_ylabel("protein", fontsize=8)
        ax.set_title(title, fontsize=9)
        return self._save(fig, name)


def _read_results_table(path) -> dict:
    """The results table ``export_gene_results`` wrote: the path itself
    where it is a CSV file, else its ``Results`` sheet's CSV sibling."""
    from phoskintime_tpu_torch.io.load import read_table

    p = str(path)
    if os.path.exists(p) and not p.endswith((".xlsx", ".xls")):
        return read_csv(p)
    table = read_table(p if p.endswith((".xlsx", ".xls")) else p.rsplit(".", 1)[0] + ".xlsx",
                       sheet_name="Results")
    if table is None:
        raise FileNotFoundError(f"no results table at {p} or its Results sheet")
    return table


# ---------------------------------------------------------------------------
# global-model figures
# ---------------------------------------------------------------------------

def plot_pareto_3d(pareto_F, out_path, best_idx=None):
    """The front's objectives as a 3-D scatter, the pick as a red star."""
    F = host(pareto_F)
    fig = Figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(F[:, 0], F[:, 1], F[:, 2], s=15, alpha=0.7)
    if best_idx is not None:
        ax.scatter(*F[best_idx], color="red", s=60, marker="*", label="Frechet pick")
        ax.legend()
    ax.set_xlabel("protein")
    ax.set_ylabel("RNA")
    ax.set_zlabel("phospho")
    ax.set_title("Pareto front")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path


def plot_convergence(history, out_path):
    """The least objectives generation by generation, on a log axis (each
    floored at 1e-12); None without a history."""
    if not history:
        return None
    gens = [h[0] for h in history]
    mins = np.asarray([host(h[1]) for h in history])
    fig, ax = subplots(figsize=(7, 4))
    for j, lbl in enumerate(["protein", "RNA", "phospho"][: mins.shape[1]]):
        ax.semilogy(gens, np.maximum(mins[:, j], 1e-12), label=lbl, color=COLORS[j])
    ax.set_xlabel("generation")
    ax.set_ylabel("best objective")
    ax.set_title("convergence")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path


def plot_parallel_coords_pareto(pareto_F, out_path):
    """Each front member's objectives, scaled to [0, 1] over the front, as
    one line across the objectives."""
    F = host(pareto_F)
    lo, hi = F.min(axis=0), F.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    Fn = (F - lo) / span
    fig, ax = subplots(figsize=(6, 4))
    for row in Fn:
        ax.plot(row, alpha=0.4, color=COLORS[0])
    ax.set_xticks(range(F.shape[1]))
    ax.set_xticklabels(["protein", "RNA", "phospho"][: F.shape[1]])
    ax.set_title("Pareto parallel coordinates")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path
