"""Per-gene fitting pipeline.

Counterpart of ``phoskintime_tpu/fit/pipeline.py``: per gene, the
steady-state initial condition, :func:`normest` (or a cohort fit made by
:func:`normest_batch`), the wild-type against every knockout combination
(one batch axis of the exact solve), optionally Morris sensitivity, and
with ``make_plots`` (the default) and an ``out_dir`` the gene's figures in
``<out_dir>/<gene>/``: the mechanism diagram and the :class:`Plotter`
figures the JAX pipeline draws, under its conditions.

The input tables are read by column (``frame["protein"]``, ``["psite"]``,
``["time"]``, ``["fc"]``) through ``np.asarray``, so a pandas DataFrame and
a dict of column arrays serve alike; the port does not import pandas.
With an ``out_dir``, :func:`run_model_pipeline` writes the genes'
figures, the results table (``model_results.xlsx`` as
``model_results_results.csv``) and ``report.html``, which embeds every
gene's PNGs. The port's ``run_model_pipeline`` defaults to
``out_dir=None`` (the JAX package's to ``"results"``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from phoskintime_tpu_torch.config.labels import generate_labels, get_param_names
from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device, working_dtype
from phoskintime_tpu_torch.fit.normest import NormestResult, normest, normest_batch
from phoskintime_tpu_torch.fit.sensitivity import sensitivity_analysis
from phoskintime_tpu_torch.models.kinetics import initial_condition, solve_ode_batched
from phoskintime_tpu_torch.models.knockout import knockout_label, knockout_mask_matrix

logger = logging.getLogger("phoskintime_tpu_torch")


@dataclass
class GeneOutput:
    gene: str
    result: NormestResult
    knockout_labels: list = field(default_factory=list)
    knockout_solutions: np.ndarray | None = None
    sensitivity: object | None = None
    figures: list = field(default_factory=list)


def process_gene(gene: str,
                 pr_data: np.ndarray,
                 p_data: np.ndarray,
                 r_data: np.ndarray,
                 num_psites: int,
                 time_points: np.ndarray,
                 bounds: dict,
                 model: str = "distmod",
                 out_dir: str | None = None,
                 bootstraps: int = 0,
                 run_knockouts: bool = True,
                 run_sensitivity: bool = False,
                 sensitivity_kw: dict | None = None,
                 normest_kw: dict | None = None,
                 make_plots: bool = True,
                 ms_gauss_weights: np.ndarray | None = None,
                 precomputed: NormestResult | None = None,
                 *,
                 device=DEFAULT_DEVICE,
                 dtype=None) -> GeneOutput:
    """Fit one gene end to end (or post-process a cohort-batched fit) on
    ``device`` (default: the card; raises where there is none) at
    ``dtype`` (default: float32 on the card, float64 on the CPU); with
    ``make_plots`` and an ``out_dir``, its figures in ``<out_dir>/<gene>``
    (drawn on the host), their paths in ``GeneOutput.figures``."""
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    init_cond = initial_condition(num_psites, model, device=device, dtype=dtype).cpu().numpy()

    if precomputed is not None:
        res = precomputed
    else:
        logger.info(f"[{gene}] steady-state init, fitting {model} with "
                    f"{num_psites} sites")
        res = normest(gene, pr_data, p_data, r_data, init_cond, num_psites,
                      time_points, bounds, bootstraps=bootstraps, model=model,
                      ms_gauss_weights=ms_gauss_weights, device=device, dtype=dtype,
                      **(normest_kw or {}))
    out = GeneOutput(gene, res)
    target = np.concatenate([np.asarray(r_data).ravel(),
                             np.asarray(pr_data).ravel(),
                             np.asarray(p_data).ravel()])

    # ---- knockout scan (one batch axis) ----------------------------------
    if run_knockouts:
        masks, combos = knockout_mask_matrix(num_psites, len(res.params))
        sols, _ = solve_ode_batched(res.params[None] * masks, init_cond, num_psites,
                                    time_points, model, device=device, dtype=dtype)
        out.knockout_solutions = sols.cpu().numpy()
        out.knockout_labels = [knockout_label(c) for c in combos]

    # ---- Morris sensitivity ----------------------------------------------
    if run_sensitivity:
        kw = dict(num_trajectories=200, num_levels=40)
        kw.update(sensitivity_kw or {})
        out.sensitivity = sensitivity_analysis(
            res.params, init_cond, num_psites, time_points, target,
            model=model, param_names=get_param_names(model, num_psites),
            device=device, dtype=dtype, **kw)

    # ---- figures -----------------------------------------------------------
    if make_plots and out_dir is not None:
        out.figures = gene_figures(out, gene, num_psites, time_points, target, model,
                                   os.path.join(str(out_dir), gene))
    return out


def gene_figures(out: GeneOutput, gene: str, num_psites: int, time_points, target,
                 model: str, gdir: str) -> list[str]:
    """The gene's figures in ``gdir``, as the JAX pipeline draws them: the
    diagram, the fit, goodness of fit, KL divergence, the state grid and
    the phase space; the CI bars with CIs; PCA and parallel coordinates
    of at least 3 bootstrap fits; the first 8 knockouts; Morris and the
    perturbation cloud with a sensitivity run. Returns the paths."""
    from phoskintime_tpu_torch.report.diagram import illustrate
    from phoskintime_tpu_torch.report.plotter import Plotter

    res = out.result
    pl = Plotter(gene, gdir)
    labels = generate_labels(model, num_psites)
    figs = [
        illustrate(gene, num_psites, model, gdir),
        pl.plot_model_fit(time_points, res.sol, target, state_labels=labels),
        pl.plot_gof(target, res.fit),
        pl.plot_kld(target, res.fit),
        pl.plot_time_state_grid(time_points, res.sol, labels),
        pl.plot_phase_space(res.sol),
    ]
    names = get_param_names(model, num_psites)
    if res.ci is not None:
        figs.append(pl.plot_params_bar(res.ci, names))
    if res.boot_params is not None and len(res.boot_params) >= 3:
        phys = np.exp(res.boot_params) if model == "randmod" else res.boot_params
        figs.append(pl.plot_pca(phys))
        figs.append(pl.plot_parallel(phys, names))
    if out.knockout_solutions is not None:
        figs.append(pl.plot_knockouts(time_points, res.sol, out.knockout_solutions[:8],
                                      out.knockout_labels[:8]))
    if out.sensitivity is not None:
        figs.append(pl.plot_morris(out.sensitivity.morris, out.sensitivity.param_names))
        figs.append(pl.plot_perturbation_cloud(time_points, out.sensitivity.top_solutions,
                                               res.sol))
    return [f for f in figs if f]


def _column(frame, name) -> np.ndarray:
    return np.asarray(frame[name])


def extract_gene_data(df_prot, df_pho, df_rna, gene: str,
                      time_points: np.ndarray, rna_time_points: np.ndarray):
    """Tidy tables (pandas frames or dicts of columns) -> (pr_data,
    p_data (n_sites, T), r_data, site_names); a missing point reads 1.0."""
    T = len(time_points)
    g = str(gene)

    def series(frame, mask, grid):
        t, fc = _column(frame, "time")[mask], _column(frame, "fc")[mask]
        order = np.argsort(t, kind="stable")
        mp = dict(zip(t[order].tolist(), fc[order].tolist()))
        return [mp.get(x, 1.0) for x in np.asarray(grid).tolist()]

    pr_data = np.asarray(series(df_prot, _column(df_prot, "protein") == g, time_points))
    r_data = np.asarray(series(df_rna, _column(df_rna, "protein") == g, rna_time_points))

    pho_gene = _column(df_pho, "protein") == g
    psite = _column(df_pho, "psite")
    sites = sorted(np.unique(psite[pho_gene]).tolist())
    p_rows = [series(df_pho, pho_gene & (psite == s), time_points) for s in sites]
    p_data = np.asarray(p_rows) if p_rows else np.zeros((0, T))
    return pr_data, p_data, r_data, sites


def run_model_pipeline(df_prot, df_pho, df_rna, *, time_points,
                       rna_time_points, bounds, model="distmod",
                       out_dir=None, genes=None, dev_test=False,
                       max_sites: int = 5, batch_genes: bool = True,
                       device=DEFAULT_DEVICE, dtype=None,
                       **gene_kw) -> dict[str, GeneOutput]:
    """Cohort driver: fit every gene common to the protein and phospho
    tables, on ``device`` (default: the card) at ``dtype``.

    With ``batch_genes`` (default), genes are grouped by site count and each
    group fits as one batched LM (:func:`normest_batch`); knockouts and
    sensitivity then run per gene. Bootstrapping or ``ms_gauss_weights``
    force the per-gene path. With an ``out_dir``, the results table
    (:func:`~phoskintime_tpu_torch.io.export.export_gene_results`), the
    genes' figures (unless ``make_plots=False``) and ``report.html`` are
    written there."""
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    common = sorted(set(_column(df_prot, "protein").tolist())
                    & set(_column(df_pho, "protein").tolist()))
    if genes is not None:
        common = [g for g in common if g in set(genes)]
    if dev_test:
        common = common[:1]

    gene_data = {}
    for gene in common:
        pr, p, r, sites = extract_gene_data(df_prot, df_pho, df_rna, gene,
                                            time_points, rna_time_points)
        n = len(sites)
        if n == 0 or n > max_sites:
            logger.info(f"[{gene}] skipped ({n} sites)")
            continue
        gene_data[gene] = (pr, p, r, n)

    precomputed: dict[str, NormestResult] = {}
    # the cohort fit does not plumb bootstraps or ms_gauss_weights: with
    # either, every gene takes the per-gene path
    use_batch = (batch_genes and not gene_kw.get("bootstraps")
                 and gene_kw.get("ms_gauss_weights") is None)
    if use_batch:
        groups: dict[int, list[str]] = {}
        for g, (_, _, _, n) in gene_data.items():
            groups.setdefault(n, []).append(g)
        nkw = dict(gene_kw.get("normest_kw") or {})
        for n, members in sorted(groups.items()):
            logger.info(f"[cohort] fitting {len(members)} genes with {n} "
                        f"sites as one batch")
            init_cond = initial_condition(n, model, device=device, dtype=dtype).cpu().numpy()
            precomputed.update(normest_batch(
                members,
                np.stack([gene_data[g][0] for g in members]),
                np.stack([gene_data[g][1] for g in members]),
                np.stack([gene_data[g][2] for g in members]),
                init_cond, n, time_points, bounds, model=model, device=device,
                dtype=dtype, **nkw))

    outputs: dict[str, GeneOutput] = {}
    for gene, (pr, p, r, n) in gene_data.items():
        outputs[gene] = process_gene(gene, pr, p, r, n, time_points, bounds,
                                     model=model, out_dir=out_dir,
                                     precomputed=precomputed.get(gene),
                                     device=device, dtype=dtype, **gene_kw)
        logger.info(f"[{gene}] done: error={outputs[gene].result.error:.4g} "
                    f"score={outputs[gene].result.score:.4g}")

    if out_dir is not None and outputs:
        from phoskintime_tpu_torch.io.export import export_gene_results
        from phoskintime_tpu_torch.report.html import create_report

        export_gene_results(os.path.join(str(out_dir), "model_results.xlsx"),
                            {g: o.result for g, o in outputs.items()})
        create_report(str(out_dir), title=f"phoskintime-tpu {model} results")
    return outputs
