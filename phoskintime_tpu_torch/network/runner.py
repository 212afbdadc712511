"""End-to-end global-model runner: from a config to the result files.

Counterpart of ``phoskintime_tpu/network/runner.py``, in three parts that
can be called on their own:

1. :func:`prepare` (the JAX runner's steps 1-5): load the data; build the
   topology (orphan TFs proxied); keep the observations that map into it;
   the kinase input and the modality weights; the system at ``dtype``
   (float32 by default, as the JAX runner) on ``device`` (the card by
   default) with y0 from the data where the config asks; the union grid,
   the loss data, the bio bounds and the softplus raw parameters.
2. :func:`fit` (steps 6-7): the optional loss-weight scan, then
   :func:`~phoskintime_tpu_torch.network.optimize.run_global_fit` with the
   Fréchet pick.
3. :func:`write_outputs` (steps 8-11): the fit's pickle and arrays, every
   table export at the pick, the lambda scan over the front, the top
   members' trajectories and the Pareto explorer
   (``pareto_interactive.html``), the convergence history, the Morris
   sensitivity, the 7-day steady-state check, the influence sweep with its
   time-slider network, the global knockout explorer (one batched ETD2RK
   simulation of every kinase knockout and the wild type), the live
   re-simulating explorer, the mechanistic discovery tables, the figures
   (the correlation heatmap, the GOF panels, ``S_rates_report.pdf``, the
   convergence plot, the population animation ``optimization_history.gif``,
   the per-gene time series, ``pareto_3d.png``, ``convergence.png``,
   ``pareto_parallel.png``), the dashboard bundle and ``report.html``,
   which embeds every PNG.

Each stage is timed by :func:`~phoskintime_tpu_torch.parallel.profile.timed`
(ended by a synchronize of the card); the figure writers' seconds add up
under ``figures``. The pickles hold numpy arrays, so a JAX user can read
the fit's. With a ``mesh``
(:class:`~phoskintime_tpu_torch.parallel.mesh.PopulationMesh`) every rank
runs :func:`main` alike: :func:`prepare` on each, the scan and the fit
sharded over the ranks, and :func:`write_outputs` on rank 0 alone, the
others waiting for its results; only rank 0 writes files and logs.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from phoskintime_tpu_torch.config.logconf import setup_logger
from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, numpy_dtype, resolve_device
from phoskintime_tpu_torch.io.utils import host, take, write_csv
from phoskintime_tpu_torch.parallel.mesh import is_writer, on_root
from phoskintime_tpu_torch.parallel.profile import timed

logger = setup_logger()


@dataclass
class Problem:
    """What :func:`prepare` builds: the data, the system and the search space."""

    cfg: object
    tp_p: np.ndarray
    tp_r: np.ndarray
    df_kin: dict
    df_tf: dict
    df_prot: dict            # filtered to the topology, with the weight column w
    df_rna: dict
    df_pho: dict
    topo: object
    Kmat: np.ndarray
    system: object
    y0: np.ndarray | None
    grid: np.ndarray
    loss_data: object
    defaults: dict
    bio_bounds: dict
    theta0: np.ndarray
    slices: dict
    xl: np.ndarray
    xu: np.ndarray
    lambdas: dict


def prepare(cfg, device=DEFAULT_DEVICE, dtype=torch.float32, weighting=None) -> Problem:
    """Steps 1-5 of the runner on ``device`` at ``dtype``; ``weighting``
    (protein, rna, phospho) overrides the config's weighting schemes."""
    from phoskintime_tpu_torch.io.load import load_data
    from phoskintime_tpu_torch.network.bounds import calculate_bio_bounds
    from phoskintime_tpu_torch.network.kinase_input import build_kinase_matrix
    from phoskintime_tpu_torch.network.lossdata import prepare_loss_data
    from phoskintime_tpu_torch.network.params import init_raw_params
    from phoskintime_tpu_torch.network.steadystate import build_y0_from_data
    from phoskintime_tpu_torch.network.system import GlobalSystem, default_params
    from phoskintime_tpu_torch.network.topology import build_topology
    from phoskintime_tpu_torch.network.weights import build_weight_functions

    device = resolve_device(device)
    if weighting is None:
        weighting = (cfg.weighting_method_protein, cfg.weighting_method_rna,
                     cfg.weighting_method_phospho)
    root = cfg._root
    tp_p = np.asarray(cfg.time_points_protein, float)
    tp_r = np.asarray(cfg.time_points_rna, float)

    # ---- 1. data ----------------------------------------------------------
    def join(p):
        return p if os.path.isabs(str(p)) else os.path.join(root, str(p))

    (df_kin, df_tf, df_prot, df_pho, df_rna, kin_beta, tf_beta, kin_alpha,
     tf_edges) = load_data(join(cfg.kinase_net), join(cfg.tf_net), join(cfg.ms), join(cfg.rna),
                           kinopt_path=join(cfg.kinopt), tfopt_path=join(cfg.tfopt),
                           time_points_protein=tp_p, time_points_rna=tp_r,
                           scaling_method=cfg.scaling_method)

    # ---- 2. topology (orphan proxying inside), observation filtering ------
    topo = build_topology(df_kin, df_tf, kin_beta_map=kin_beta, tf_beta_map=tf_beta,
                          kin_alpha=kin_alpha, tf_edge_weights=tf_edges, model=cfg.model)
    logger.info(f"[Model] {topo.N} proteins ({len(topo.proxy_map)} orphans rewired), "
                f"{topo.K} kinases, state width {topo.width}")
    df_prot, df_rna, df_pho = (
        take(t, np.asarray([p in topo.p2i for p in t["protein"]], bool))
        for t in (df_prot, df_rna, df_pho))

    # ---- 3. kinase input + weights ----------------------------------------
    Kmat = build_kinase_matrix(topo.kinases,
                               zip(df_prot["protein"], df_prot["time"], df_prot["fc"]), tp_p)
    w_prot, w_rna = build_weight_functions(tp_p, tp_r, weighting[0], weighting[1])
    w_pho, _ = build_weight_functions(tp_p, tp_r, weighting[2], weighting[1])
    df_prot, df_pho, df_rna = ({**t, "w": w(np.asarray(t["time"], float))}
                               for t, w in ((df_prot, w_prot), (df_pho, w_pho),
                                            (df_rna, w_rna)))

    # ---- 4. system + y0 ----------------------------------------------------
    system = GlobalSystem(topo, tp_p, Kmat, dtype=dtype, device=device)
    y0 = None
    if cfg.use_initial_condition_from_data:
        y0 = build_y0_from_data(topo, df_prot, df_rna, df_pho)
        system.custom_y0 = y0

    # ---- 5. solver grid + loss data + bounds -------------------------------
    grid = np.unique(np.concatenate([tp_p, tp_r]))
    loss_data = prepare_loss_data(topo, df_prot, df_rna, df_pho, grid)
    defaults = default_params(topo, numpy_dtype(dtype))
    bio_bounds = calculate_bio_bounds(topo, df_prot, df_rna, Kmat)
    theta0, slices, xl, xu = init_raw_params(defaults, topo, bio_bounds)
    logger.info(f"[Fit] {len(theta0)} decision variables; data points: "
                f"{len(loss_data.obs_prot)} protein, {len(loss_data.obs_rna)} RNA, "
                f"{len(loss_data.obs_pho)} phospho")
    lambdas = {"protein": cfg.lambda_protein, "rna": cfg.lambda_rna,
               "phospho": cfg.lambda_phospho, "prior": cfg.lambda_prior}
    return Problem(cfg, tp_p, tp_r, df_kin, df_tf, df_prot, df_rna, df_pho, topo, Kmat,
                   system, y0, grid, loss_data, defaults, bio_bounds, theta0, slices, xl, xu,
                   lambdas)


def fit(problem: Problem, out_dir: str, mesh=None):
    """Steps 6-7: the loss-weight scan where the config asks (its table and
    checkpoint in ``out_dir/hyperparam_scan``), then the global fit.
    Returns the :class:`GlobalFitResult`; ``problem.lambdas`` becomes the
    scan's pick."""
    from phoskintime_tpu_torch.network.optimize import run_global_fit
    from phoskintime_tpu_torch.network.scan import run_hyperparameter_scan

    cfg, p = problem.cfg, problem
    args = (p.system, p.slices, p.loss_data, p.defaults)
    log = logger if is_writer(mesh) else None
    if cfg.hyperparam_scan:
        scan_dir = os.path.join(out_dir, "hyperparam_scan")
        p.lambdas, _ = run_hyperparameter_scan(
            *args, p.grid, p.xl, p.xu, n_outer=cfg.scan_trials,
            inner_gens=cfg.scan_inner_gens, inner_pop=cfg.scan_inner_pop, seed=cfg.seed,
            loss_mode=cfg.loss, mesh=mesh, logger=log, out_dir=scan_dir,
            checkpoint_path=os.path.join(scan_dir, "scan_state.json"))
        if log is not None:
            log.info(f"[Scan] selected lambdas {p.lambdas}")
    res = run_global_fit(
        *args, p.lambdas, p.grid, p.xl, p.xu, optimizer=cfg.optimizer, pop=cfg.pop,
        n_gen=cfg.n_gen, n_trials=cfg.n_trials, seed=cfg.seed, loss_mode=cfg.loss, mesh=mesh,
        rtol=1e-5, atol=1e-7, max_steps=5000, y0=p.y0, refine=cfg.refine,
        num_refinements=cfg.num_refinements, polish_steps=cfg.polish_steps,
        polish_lr=cfg.polish_lr, gens_per_dispatch=cfg.gens_per_dispatch,
        gn_iters=cfg.gn_iters, frechet_pick=True, df_prot=p.df_prot, df_rna=p.df_rna,
        df_pho=p.df_pho, t_points=(p.tp_p, p.tp_r, p.tp_p), logger=log)
    if log is not None:
        log.info(f"[Fit] done: {res.n_evals} evaluations, {len(res.pareto_X)} Pareto "
                 f"solutions, picked {res.best_idx}")
    return res


def best_params(problem: Problem, theta) -> dict:
    """One raw theta as the physical parameter dict of the system's tensors."""
    from phoskintime_tpu_torch.network.params import unpack_params

    f = dict(dtype=problem.system.rhs.Kmat.dtype, device=problem.system.device)
    return {k: v[0] for k, v in unpack_params(torch.as_tensor(
        np.asarray(theta, float)[None], **f), problem.slices, problem.topo).items()}


def write_outputs(problem: Problem, res, out_dir: str) -> dict:
    """Steps 8-11 from a fit result with ``X``, ``F``, ``pareto_X``,
    ``pareto_F``, ``best_idx``, ``history`` (numpy) and, where the fit
    collected them, ``pop_history`` snapshots (the animation): the files of
    the JAX runner, its figures in its order. Returns {"params_best",
    "predictions", "sensitivity", "steady_state", "kinase_dominance",
    "seconds"}: the seconds of the exports (the correlation heatmap, drawn
    at most 200 parameters, with its table), the figures (with the
    dashboard bundle), the sensitivity, the steady state and the analyses
    (:func:`timed`)."""
    from phoskintime_tpu_torch.analysis.influence import (export_global_knockout_explorer,
                                                          export_influence_sweep)
    from phoskintime_tpu_torch.analysis.insights import run_mechanistic_discovery
    from phoskintime_tpu_torch.io import export as ex
    from phoskintime_tpu_torch.io.load import read_table
    from phoskintime_tpu_torch.network.analysis import kinase_dominance, simulate_until_steady
    from phoskintime_tpu_torch.network.sensitivity import run_sensitivity_analysis
    from phoskintime_tpu_torch.network.simulate import simulate_and_measure
    from phoskintime_tpu_torch.report import plotter
    from phoskintime_tpu_torch.report.dashboard import save_dashboard_bundle
    from phoskintime_tpu_torch.report.html import create_report
    from phoskintime_tpu_torch.report.interactive import pareto_explorer_from_frames
    from phoskintime_tpu_torch.report.live_model import write_live_model_explorer

    cfg, p = problem.cfg, problem
    topo, system, y0 = p.topo, p.system, p.y0
    os.makedirs(out_dir, exist_ok=True)
    seconds = {}
    at = lambda name: os.path.join(out_dir, name)  # noqa: E731
    with timed("exports", logger, system.device, seconds):
        pareto_X = np.asarray(res.pareto_X)
        pareto_F = np.asarray(res.pareto_F)
        with open(at(f"{cfg.optimizer}_optimization_result.pkl"), "wb") as fh:
            pickle.dump({"X": np.asarray(res.X), "F": np.asarray(res.F), "pareto_X": pareto_X,
                         "pareto_F": pareto_F, "best_idx": res.best_idx,
                         "history": res.history, "slices": p.slices}, fh)
        np.save(at("pareto_X.npy"), pareto_X)
        np.save(at("pareto_F.npy"), pareto_F)

        # ---- 8. best-solution exports -------------------------------------
        theta_best = pareto_X[res.best_idx]
        params_best = best_params(p, theta_best)
        params_np = {k: host(v) for k, v in params_best.items()}
        dfp_fit, dfr_fit, dfph_fit = simulate_and_measure(system, params_best, p.tp_p,
                                                          p.tp_r, p.tp_p, y0=y0)
        ex.export_pareto(at("pareto.xlsx"), pareto_X, pareto_F)
        ex.export_trajectories(at("trajectories.xlsx"), dfp_fit, dfr_fit, dfph_fit,
                               p.df_prot, p.df_rna, p.df_pho)
        ex.export_global_params(at("parameters.xlsx"), topo, params_np)
        ex.export_kinase_activities(at("kinase_activity.xlsx"), topo, params_np, p.Kmat,
                                    p.tp_p)
        ex.export_residuals(at("residuals.xlsx"), p.df_prot, dfp_fit, ["protein"])
        ex.export_param_distributions(at("param_distributions.xlsx"), pareto_X, p.slices,
                                      topo)
        ex.export_param_correlations(at("param_correlations.xlsx"), pareto_X, p.slices, topo,
                                     heatmap_path=at("param_correlations.png"))
        ex.export_S_rates(system, params_np, out_dir)
        ex.scan_prior_reg(out_dir)
        n_top = min(3, len(pareto_X))
        top_idx = np.argsort(pareto_F.sum(axis=1))[:n_top]
        if res.best_idx not in top_idx:
            top_idx = np.concatenate([[res.best_idx], top_idx[:-1]])
        ex.export_pareto_trajectories(system, p.slices, pareto_X, (p.tp_p, p.tp_r, p.tp_p),
                                      at("pareto_trajectories.xlsx"), top_idx=top_idx)
        trajs = [read_table(at("pareto_trajectories.xlsx"), sheet_name=f"traj_{m}")
                 for m in ("protein", "rna", "phospho")]
        if all(t is not None for t in trajs):
            pareto_explorer_from_frames(at("pareto_interactive.html"), pareto_F, res.best_idx,
                                        *trajs, p.df_prot, p.df_rna, p.df_pho)

    # ---- 8. the figures, in the JAX runner's order ---------------------------
    with timed("figures", logger, system.device, seconds):
        if all(t is not None for t in trajs):
            ex.plot_gof_solutions(*trajs, p.df_prot, p.df_rna, p.df_pho, at("gof_solutions"))
        if topo.total_sites:
            ex.plot_s_rates_report(at("S_rates_picked.csv"), at("S_rates_report.pdf"))
        ex.process_convergence_history(res.history, out_dir)
        if getattr(res, "pop_history", None):
            ex.create_convergence_video(res.pop_history, pareto_F, out_dir)
        ex.save_all_gene_timeseries(p.df_prot, dfp_fit, p.df_rna, dfr_fit, p.df_pho, dfph_fit,
                                    at("gene_timeseries"))

    # ---- 9. sensitivity ----------------------------------------------------
    sens = None
    with timed("sensitivity", logger, system.device, seconds):
        if cfg.sensitivity_analysis:
            sens = run_sensitivity_analysis(
                system, p.slices, theta_best, p.grid, perturbation=cfg.sensitivity_perturbation,
                n_trajectories=cfg.sensitivity_trajectories, num_levels=cfg.sensitivity_levels,
                metric=cfg.sensitivity_metric, top_curves=cfg.sensitivity_top_curves, y0=y0,
                seed=cfg.seed)
            np.savez(at("sensitivity.npz"), mu=sens.morris.mu, mu_star=sens.morris.mu_star,
                     sigma=sens.morris.sigma)

    # ---- 10. steady-state check (7 days), influence, explorers, discovery --
    with timed("steady_state", logger, system.device, seconds):
        ss = simulate_until_steady(system, params_best, y0=y0)
        dom = kinase_dominance(system, params_best)
    with timed("analyses", logger, system.device, seconds):
        export_influence_sweep(system, params_best, at("influence"),
                               seeds=list(topo.kinases[:2]))
        export_global_knockout_explorer(system, params_best,
                                        at(os.path.join("influence", "global_knockouts.html")))
        write_live_model_explorer(at(os.path.join("influence", "live_explorer.html")), system,
                                  params_best, title="live global-model explorer",
                                  df_prot=p.df_prot, df_rna=p.df_rna, df_pho=p.df_pho)
        write_csv(at("steady_state_check.csv"),
                  {"protein": np.asarray(topo.proteins, dtype=object),
                   "converged": np.asarray(ss.converged, bool),
                   "final_rate": np.asarray(ss.final_rate, float),
                   "ss_value": np.asarray(ss.ss_value, float)})
        run_mechanistic_discovery(system, params_best, p.df_tf, out_dir=out_dir)

    # ---- 11. figures, the dashboard bundle and the report ------------------
    with timed("figures", logger, system.device, seconds):
        plotter.plot_pareto_3d(pareto_F, at("pareto_3d.png"), best_idx=res.best_idx)
        plotter.plot_convergence(res.history, at("convergence.png"))
        plotter.plot_parallel_coords_pareto(pareto_F, at("pareto_parallel.png"))
        save_dashboard_bundle(
            at("dashboard_bundle.pkl"), pareto_X=pareto_X, pareto_F=pareto_F,
            best_idx=res.best_idx, df_prot=p.df_prot, df_rna=p.df_rna, df_pho=p.df_pho,
            pred_prot=dfp_fit, pred_rna=dfr_fit, pred_pho=dfph_fit, params=params_best,
            topo_summary={"N": topo.N, "K": topo.K, "total_sites": topo.total_sites,
                          "orphans_rewired": len(topo.proxy_map), "model": topo.model},
            history=res.history)
    with timed("analyses", logger, system.device, seconds):
        create_report(out_dir, title="phoskintime-tpu global model")
    return dict(params_best=params_best, predictions=(dfp_fit, dfr_fit, dfph_fit),
                sensitivity=sens, steady_state=ss, kinase_dominance=dom, seconds=seconds)


def main(cfg, mesh=None, out_dir=None, weighting=None, device=DEFAULT_DEVICE,
         dtype=torch.float32) -> dict:
    """The whole run from a config (:class:`PhosKinConfig`) on ``device``
    (default: the card; raises where there is none) into ``out_dir``
    (default: the config's ``output_dir`` under its root). Returns the
    result bundle with ``seconds``, each stage's wall clock: prepare, fit,
    exports, figures, sensitivity, steady_state, analyses. ``mesh``: every
    rank calls this alike (see the module docstring) and returns the same
    results; the output stages' seconds are rank 0's."""
    device = resolve_device(device)
    out_dir = str(out_dir or os.path.join(cfg._root, cfg.output_dir))
    quiet, logger.disabled = logger.disabled, not is_writer(mesh)
    try:
        if is_writer(mesh):
            os.makedirs(out_dir, exist_ok=True)
        seconds = {}
        with timed("prepare", logger, device, seconds):
            problem = prepare(cfg, device=device, dtype=dtype, weighting=weighting)
        with timed("fit", logger, device, seconds):
            res = fit(problem, out_dir, mesh)
        out = on_root(mesh, lambda: write_outputs(problem, res, out_dir),
                      device=problem.system.device)
    finally:
        logger.disabled = quiet
    seconds.update(out.pop("seconds"))
    return dict(result=res, system=problem.system, topo=problem.topo, slices=problem.slices,
                loss_data=problem.loss_data, out_dir=out_dir, problem=problem,
                seconds=seconds, **out)
