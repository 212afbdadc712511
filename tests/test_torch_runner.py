"""The port's entry points (``python -m phoskintime_tpu_torch``: ``cli.py``,
``__main__.py``, ``network/runner.py``) against the JAX package's, on the
CPU.

* ``prepare`` (the runner's steps 1-5) against JAX's steps called one by
  one, float32 as both runners build the system: equal.
* ``write_outputs`` (steps 8-11) fed JAX's own fit result on a float64
  system in both packages: every file the port writes against JAX's at
  1e-9 (of each column's largest magnitude), the dashboard bundle's
  DataFrames column by column against the port's dicts, ``report.html``
  with its embedded images masked, and what every figure, PDF page and
  animation frame draws (``tests/torch_figures.py``) against JAX's.
* ``global-model`` end to end through ``cli.main`` on a 7-protein project
  (pop 16, 2 generations, 2 Morris trajectories): its file set equals the
  JAX CLI's at the same config, figures included
  (``optimization_history.gif`` on both sides: there is no ffmpeg here).
  The GA's float32 trajectory is not compared: two float32 GAs part on
  near-ties.
* The CLI: the parser's subcommands, destinations and defaults against
  JAX's ``build_parser()`` (``--device`` aside), ``prep``, ``kinopt`` and
  ``tfopt --mode local``, ``model`` with its figures, ``clean``, the
  command that raises (``diagram``).
"""

import os
import pickle
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_export import RTOL_COMPUTED, assert_same_files, written
from test_torch_io import columns_of, write_raw
from test_torch_report import assert_same_knockout_page
from torch_figures import assert_same_records, capture_jax, capture_port
from torch_project import write_project

import phoskintime_tpu.cli as jcli
from phoskintime_tpu.config.loader import PhosKinConfig as JaxConfig
from phoskintime_tpu.io import export as jex
from phoskintime_tpu.io.load import load_data as jax_load_data
from phoskintime_tpu.network import analysis as jana
from phoskintime_tpu.network.bounds import calculate_bio_bounds as jax_bio_bounds
from phoskintime_tpu.network.kinase_input import build_kinase_matrix as jax_kinase_matrix
from phoskintime_tpu.network.lossdata import prepare_loss_data as jax_loss_data
from phoskintime_tpu.network.params import init_raw_params as jax_init_raw
from phoskintime_tpu.network.params import unpack_params as jax_unpack
from phoskintime_tpu.network.sensitivity import run_sensitivity_analysis as jax_sensitivity
from phoskintime_tpu.network.simulate import simulate_and_measure as jax_measure
from phoskintime_tpu.network.steadystate import build_y0_from_data as jax_y0
from phoskintime_tpu.network.system import GlobalSystem as JaxSystem
from phoskintime_tpu.network.system import default_params as jax_defaults
from phoskintime_tpu.network.topology import build_topology as jax_topology
from phoskintime_tpu.network.weights import build_weight_functions as jax_weights
from phoskintime_tpu_torch import cli
from phoskintime_tpu_torch.config.loader import PhosKinConfig
from phoskintime_tpu_torch.io.utils import read_csv
from phoskintime_tpu_torch.network import runner

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
RTOL_MORRIS = 1e-8      # as tests/test_torch_sensitivity.py, scaled by the largest index


# ---------------------------------------------------------------------------
# the JAX runner's steps, called one by one
# ---------------------------------------------------------------------------

def jax_prepare(cfg, dtype):
    """``phoskintime_tpu/network/runner.py:71-115`` with the system at
    ``dtype`` (the JAX runner's is float32)."""
    join = lambda p: p if os.path.isabs(str(p)) else os.path.join(cfg._root, str(p))  # noqa
    tp_p = np.asarray(cfg.time_points_protein, float)
    tp_r = np.asarray(cfg.time_points_rna, float)
    (df_kin, df_tf, df_prot, df_pho, df_rna, kin_beta, tf_beta, kin_alpha,
     tf_edges) = jax_load_data(join(cfg.kinase_net), join(cfg.tf_net), join(cfg.ms),
                               join(cfg.rna), kinopt_path=join(cfg.kinopt),
                               tfopt_path=join(cfg.tfopt), time_points_protein=tp_p,
                               time_points_rna=tp_r, scaling_method=cfg.scaling_method)
    topo = jax_topology(df_kin, df_tf, kin_beta_map=kin_beta, tf_beta_map=tf_beta,
                        kin_alpha=kin_alpha, tf_edge_weights=tf_edges, model=cfg.model)
    df_prot = df_prot[df_prot["protein"].isin(topo.p2i)]
    df_rna = df_rna[df_rna["protein"].isin(topo.p2i)]
    df_pho = df_pho[df_pho["protein"].isin(topo.p2i)]
    Kmat = jax_kinase_matrix(topo.kinases, df_prot, tp_p)
    w_prot, w_rna = jax_weights(tp_p, tp_r, cfg.weighting_method_protein,
                                cfg.weighting_method_rna)
    w_pho, _ = jax_weights(tp_p, tp_r, cfg.weighting_method_phospho, cfg.weighting_method_rna)
    df_prot = df_prot.assign(w=w_prot(df_prot["time"].to_numpy()))
    df_pho = df_pho.assign(w=w_pho(df_pho["time"].to_numpy()))
    df_rna = df_rna.assign(w=w_rna(df_rna["time"].to_numpy()))
    system = JaxSystem(topo, tp_p, Kmat, dtype=dtype)
    y0 = None
    if cfg.use_initial_condition_from_data:
        y0 = jax_y0(topo, df_prot, df_rna, df_pho)
        system.custom_y0 = y0
    grid = np.unique(np.concatenate([tp_p, tp_r]))
    loss_data = jax_loss_data(topo, df_prot, df_rna, df_pho, grid)
    defaults = jax_defaults(topo, dtype)
    bio_bounds = jax_bio_bounds(topo, df_prot, df_rna, Kmat)
    theta0, slices, xl, xu = jax_init_raw(defaults, topo, bio_bounds)
    return SimpleNamespace(tp_p=tp_p, tp_r=tp_r, df_kin=df_kin, df_tf=df_tf, df_prot=df_prot,
                           df_rna=df_rna, df_pho=df_pho, topo=topo, Kmat=Kmat, system=system,
                           y0=y0, grid=grid, loss_data=loss_data, defaults=defaults,
                           bio_bounds=bio_bounds, theta0=theta0, slices=slices, xl=xl, xu=xu)


def jax_write_outputs(cfg, j, res, out_dir, seen=None):
    """``phoskintime_tpu/network/runner.py:143-318`` at the system's dtype.
    ``seen`` receives what the knockout explorer's writer was given."""
    from phoskintime_tpu.analysis.influence import (export_global_knockout_explorer,
                                                    export_influence_sweep)
    from phoskintime_tpu.analysis.insights import run_mechanistic_discovery
    from phoskintime_tpu.io.load import read_table
    from phoskintime_tpu.report import interactive, plotter
    from phoskintime_tpu.report.dashboard import save_dashboard_bundle
    from phoskintime_tpu.report.html import create_report
    from phoskintime_tpu.report.live_model import write_live_model_explorer

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{cfg.optimizer}_optimization_result.pkl"), "wb") as fh:
        pickle.dump({"X": res.X, "F": res.F, "pareto_X": res.pareto_X,
                     "pareto_F": res.pareto_F, "best_idx": res.best_idx,
                     "history": res.history, "slices": j.slices}, fh)
    np.save(os.path.join(out_dir, "pareto_X.npy"), res.pareto_X)
    np.save(os.path.join(out_dir, "pareto_F.npy"), res.pareto_F)
    topo, system, y0, at = j.topo, j.system, j.y0, lambda n: os.path.join(out_dir, n)
    theta_best = res.pareto_X[res.best_idx]
    params_best = jax_unpack(jnp.asarray(theta_best, system.dtype), j.slices, topo)
    dfp_fit, dfr_fit, dfph_fit = jax_measure(system, params_best, j.tp_p, j.tp_r, j.tp_p,
                                             y0=y0)
    jex.export_pareto(at("pareto.xlsx"), res.pareto_X, res.pareto_F)
    jex.export_trajectories(at("trajectories.xlsx"), dfp_fit, dfr_fit, dfph_fit, j.df_prot,
                            j.df_rna, j.df_pho)
    jex.export_global_params(at("parameters.xlsx"), topo,
                             {k: np.asarray(v) for k, v in params_best.items()})
    jex.export_kinase_activities(at("kinase_activity.xlsx"), topo, params_best, j.Kmat, j.tp_p)
    jex.export_residuals(at("residuals.xlsx"), j.df_prot, dfp_fit, ["protein"])
    jex.export_param_distributions(at("param_distributions.xlsx"), res.pareto_X, j.slices,
                                   topo)
    jex.export_param_correlations(at("param_correlations.xlsx"), res.pareto_X, j.slices, topo,
                                  heatmap_path=at("param_correlations.png"))
    jex.export_S_rates(system, params_best, out_dir)
    jex.scan_prior_reg(out_dir)
    top_idx = np.argsort(res.pareto_F.sum(axis=1))[:min(3, len(res.pareto_X))]
    if res.best_idx not in top_idx:
        top_idx = np.concatenate([[res.best_idx], top_idx[:-1]])
    jex.export_pareto_trajectories(system, j.slices, res.pareto_X, (j.tp_p, j.tp_r, j.tp_p),
                                   at("pareto_trajectories.xlsx"), top_idx=top_idx)
    trajs = [read_table(at("pareto_trajectories.xlsx"), sheet_name=f"traj_{m}")
             for m in ("protein", "rna", "phospho")]
    jex.plot_gof_solutions(*trajs, j.df_prot, j.df_rna, j.df_pho, at("gof_solutions"))
    interactive.pareto_explorer_from_frames(at("pareto_interactive.html"), res.pareto_F,
                                            res.best_idx, *trajs, j.df_prot, j.df_rna, j.df_pho)
    if topo.total_sites:
        jex.plot_s_rates_report(at("S_rates_picked.csv"), at("S_rates_report.pdf"))
    jex.process_convergence_history(res.history, out_dir)
    if getattr(res, "pop_history", None):
        jex.create_convergence_video(res.pop_history, res.pareto_F, out_dir)
    jex.save_all_gene_timeseries(j.df_prot, dfp_fit, j.df_rna, dfr_fit, j.df_pho, dfph_fit,
                                 at("gene_timeseries"))
    sens = jax_sensitivity(system, j.slices, theta_best, j.grid,
                           perturbation=cfg.sensitivity_perturbation,
                           n_trajectories=cfg.sensitivity_trajectories,
                           num_levels=cfg.sensitivity_levels, metric=cfg.sensitivity_metric,
                           top_curves=cfg.sensitivity_top_curves, y0=y0, seed=cfg.seed)
    np.savez(at("sensitivity.npz"), mu=sens.morris.mu, mu_star=sens.morris.mu_star,
             sigma=sens.morris.sigma)
    ss = jana.simulate_until_steady(system, params_best, y0=y0)
    export_influence_sweep(system, params_best, at("influence"), seeds=list(topo.kinases[:2]))
    real = interactive.write_interactive_explorer

    def spy(path, **kw):
        (seen if seen is not None else {}).update(kw)
        return real(path, **kw)
    interactive.write_interactive_explorer = spy
    try:
        export_global_knockout_explorer(system, params_best,
                                        at(os.path.join("influence", "global_knockouts.html")))
    finally:
        interactive.write_interactive_explorer = real
    write_live_model_explorer(at(os.path.join("influence", "live_explorer.html")), system,
                              params_best, title="live global-model explorer",
                              df_prot=j.df_prot, df_rna=j.df_rna, df_pho=j.df_pho)
    pd.DataFrame({"protein": topo.proteins, "converged": ss.converged,
                  "final_rate": ss.final_rate, "ss_value": ss.ss_value}
                 ).to_csv(at("steady_state_check.csv"), index=False)
    run_mechanistic_discovery(system, params_best, j.df_tf, out_dir=out_dir)
    plotter.plot_pareto_3d(res.pareto_F, at("pareto_3d.png"), best_idx=res.best_idx)
    plotter.plot_convergence(res.history, at("convergence.png"))
    plotter.plot_parallel_coords_pareto(res.pareto_F, at("pareto_parallel.png"))
    save_dashboard_bundle(
        at("dashboard_bundle.pkl"), pareto_X=res.pareto_X, pareto_F=res.pareto_F,
        best_idx=res.best_idx, df_prot=j.df_prot, df_rna=j.df_rna, df_pho=j.df_pho,
        pred_prot=dfp_fit, pred_rna=dfr_fit, pred_pho=dfph_fit,
        params={k: np.asarray(v) for k, v in params_best.items()},
        topo_summary={"N": topo.N, "K": topo.K, "total_sites": topo.total_sites,
                      "orphans_rewired": len(topo.proxy_map), "model": topo.model},
        history=res.history)
    create_report(out_dir, title="phoskintime-tpu global model")


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return write_project(tmp_path_factory.mktemp("project"))


def in_dir(path, fn, *a):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn(*a)
    finally:
        os.chdir(cwd)


# the JAX CLI; with FIGURE_RECORDS set, what its figures draw is pickled there
JAX_CLI = """import contextlib, os, pickle, sys, jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
from phoskintime_tpu.cli import main
out = os.environ.get('FIGURE_RECORDS')
if out:
    from torch_figures import capture_jax
with (capture_jax() if out else contextlib.nullcontext({})) as records:
    main(sys.argv[1:])
if out:
    with open(out, 'wb') as fh:
        pickle.dump(records, fh)
"""


def start_jax_cli(cwd, *argv, records=None):
    """The JAX CLI in a process of its own (as the test suite configures
    JAX: the CPU, x64, no persistent cache), so that it runs beside the
    port's command in this process; ``records``: a path where the records
    of its figures are pickled."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PHOSKINTIME_DISABLE_COMPILE_CACHE": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests"),
                                          os.environ.get("PYTHONPATH", "")])}
    if records is not None:
        env["FIGURE_RECORDS"] = str(records)
    return subprocess.Popen([sys.executable, "-c", JAX_CLI, *argv], cwd=cwd, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def finish(proc, timeout=600):
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def global_runs(tmp_path_factory, project):
    """``global-model`` through both CLIs on copies of the project, the JAX
    one in its own process at the same time."""
    dj, dp = (tmp_path_factory.mktemp(n) for n in ("jax_cli", "port_cli"))
    for d in (dj, dp):
        shutil.copytree(project, d, dirs_exist_ok=True)
    proc = start_jax_cli(dj, "global-model")
    try:
        out = in_dir(dp, cli.main, ["global-model", "--device", "cpu"])
    finally:
        finish(proc)
    return SimpleNamespace(jax=dj / "results_global", port=dp / "results_global", out=out)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def assert_frame_equal_table(got: dict, want: pd.DataFrame):
    want = columns_of(want.reset_index(drop=True))
    assert list(got) == list(want)
    for c in want:
        assert np.asarray(got[c]).tolist() == np.asarray(want[c]).tolist(), c


def test_prepare_matches_jax_steps(project):
    """Steps 1-5 at float32: the topology, the filtered and weighted
    tables, Kmat, y0, the grid, the loss data, the bounds and the raw
    parameters equal JAX's."""
    path = str(project / "config.toml")
    j = jax_prepare(JaxConfig.from_toml(path), np.float32)
    p = runner.prepare(PhosKinConfig.from_toml(path), device="cpu")
    t, jt = p.topo, j.topo
    assert (t.proteins, t.kinases, t.sites, t.proxy_map) == (jt.proteins, jt.kinases, jt.sites,
                                                             jt.proxy_map)
    assert t.proxy_map == {"TF1": "KB"}
    for name in ("n_sites", "W_pad", "tf_mat", "tf_deg", "driver_map"):
        np.testing.assert_array_equal(getattr(t, name), getattr(jt, name), err_msg=name)
    for got, want in ((p.df_prot, j.df_prot), (p.df_rna, j.df_rna), (p.df_pho, j.df_pho),
                      (p.df_kin, j.df_kin), (p.df_tf, j.df_tf)):
        assert_frame_equal_table(got, want)
    for name in ("Kmat", "y0", "grid", "theta0", "xl", "xu"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name), err_msg=name)
    for f in j.loss_data._fields:
        np.testing.assert_array_equal(np.asarray(getattr(p.loss_data, f)),
                                      np.asarray(getattr(j.loss_data, f)), err_msg=f)
    assert p.slices == j.slices and p.bio_bounds == j.bio_bounds
    for k in j.defaults:
        assert p.defaults[k].dtype == np.float32
        np.testing.assert_array_equal(p.defaults[k], j.defaults[k], err_msg=k)
    assert p.system.dtype == torch.float32 and p.system.device.type == "cpu"
    np.testing.assert_array_equal(p.system.y0(), j.system.y0())


def test_write_outputs_matches_jax(tmp_path, project):
    """Steps 8-11 fed JAX's own fit result (``run_global_fit`` at float64,
    pop 16, 2 generations, over a [0.05, 0.3] box for every rate, so that
    the 7-day RK45 check stays short on this CPU): every file the port
    writes equals JAX's at 1e-9 of each column's largest magnitude, and
    the port writes every file JAX does. The HTML pages are JAX's outside
    their JSON, whose numbers agree within 1e-4 (the writers' rounding
    unit), and their embedded images, the knockout explorer's as
    ``tests/test_torch_report.py`` holds it; the dashboard bundle's
    DataFrames column by column against the port's dicts; every figure,
    PDF page and animation frame as ``tests/test_torch_figures.py`` holds
    them. The Morris arrays
    are held at 1e-8 of their largest magnitude, the tolerance of
    ``tests/test_torch_sensitivity.py``: an elementary effect divides the
    RK45 runs' last-bit differences by its small step (7.5e-9 of sigma's
    largest 1.68 was measured here). The steady state's ``final_rate`` is
    a difference quotient of the last two levels over the last interval:
    it is held to 1e-9 of the largest level over that interval (the
    levels' own tolerance), since near a steady state the difference is
    cancellation (1e-15 against 1e-15 whose levels agree to 1e-11)."""
    from phoskintime_tpu.network.optimize import run_global_fit as jax_fit

    path = str(project / "config.toml")
    jcfg, cfg = JaxConfig.from_toml(path), PhosKinConfig.from_toml(path)
    j = jax_prepare(jcfg, np.float64)
    _, _, xl, xu = jax_init_raw(j.defaults, j.topo, {k: (0.05, 0.3) for k in j.bio_bounds})
    lambdas = {"protein": 1.0, "rna": 1.0, "phospho": 1.0, "prior": 0.1}
    res = jax_fit(j.system, j.slices, j.loss_data, j.defaults, lambdas, j.grid, xl, xu,
                  pop=16, n_gen=2, seed=0, y0=j.y0, frechet_pick=True, df_prot=j.df_prot,
                  df_rna=j.df_rna, df_pho=j.df_pho, t_points=(j.tp_p, j.tp_r, j.tp_p))
    dj, dp = tmp_path / "jax", tmp_path / "port"
    seen = {}
    with capture_jax() as want:
        jax_write_outputs(jcfg, j, res, str(dj), seen)
    p = runner.prepare(cfg, device="cpu", dtype=torch.float64)
    with capture_port() as got:
        out = runner.write_outputs(p, res, str(dp))
    assert_same_records(got, want, dp, dj)
    assert written(dp) == written(dj)
    ss = read_csv(dj / "steady_state_check.csv")
    times = np.unique(np.concatenate(            # simulate_until_steady's grid
        [[0.0], np.logspace(np.log10(0.5), np.log10(jana.MINUTES_7_DAYS), 120)]))
    rate_atol = RTOL_COMPUTED * np.abs(ss["ss_value"]).max() / (times[-1] - times[-2])
    assert_same_files(dp, dj, RTOL_COMPUTED, rtols={"sensitivity.npz": RTOL_MORRIS},
                      atols={"steady_state_check.csv": {"final_rate": rate_atol}},
                      pages={"influence/global_knockouts.html": partial(
                          assert_same_knockout_page, seen=seen)})
    assert {"pareto_interactive.html", "report.html", "influence/global_knockouts.html",
            "influence/influence_network.html", "influence/live_explorer.html"} <= written(dp)
    assert set(out["seconds"]) == {"exports", "figures", "sensitivity", "steady_state",
                                   "analyses"}
    assert {"S_rates_report.pdf", "optimization_history.gif", "dashboard_bundle.pkl",
            "param_correlations.png"} <= written(dp)
    assert any(f.startswith("gof_solutions/gof_sol") for f in written(dp))


def test_global_model_writes_jax_files(global_runs):
    """The port's ``global-model`` writes every file of the JAX CLI's at
    the same config, figures, PDF, animation and dashboard bundle
    included, and no other; the GOF figures are each run's own top
    solutions (the two float32 GAs' fronts differ), one a solution of its
    trajectory summary."""
    def gof(d):
        return {f for f in written(d) if f.startswith("gof_solutions/")}

    def top_ids(d):
        ids = read_csv(d / "pareto_trajectories_summary.csv")["sol_id"]
        return {f"gof_solutions/gof_sol{int(i)}.png" for i in ids}
    want = written(global_runs.jax) - gof(global_runs.jax)
    got = written(global_runs.port) - gof(global_runs.port)
    assert got == want, (sorted(got - want), sorted(want - got))
    assert gof(global_runs.port) == top_ids(global_runs.port)
    assert gof(global_runs.jax) == top_ids(global_runs.jax)
    got = written(global_runs.port)
    for name in ("S_rates_report.pdf", "convergence.png", "convergence_plot.png",
                 "dashboard_bundle.pkl", "optimization_history.gif", "param_correlations.png",
                 "pareto_3d.png", "pareto_parallel.png", "gene_timeseries/ts_GA.png",
                 "gof_solutions/"):
        assert any(f.startswith(name) for f in got), name


def test_global_model_outputs(global_runs):
    """The run's outputs: the stage timings, a steady-state row a protein,
    finite Morris arrays, the written front's F equal to a re-evaluation of
    its X, and a pickle of numpy arrays."""
    out, d = global_runs.out, global_runs.port
    assert set(out["seconds"]) == {"prepare", "fit", "exports", "figures", "sensitivity",
                                   "steady_state", "analyses"}
    ss = read_csv(d / "steady_state_check.csv")
    assert ss["protein"].tolist() == out["topo"].proteins
    sens = np.load(d / "sensitivity.npz")
    assert all(np.isfinite(sens[k]).all() for k in ("mu", "mu_star", "sigma"))
    from phoskintime_tpu_torch.network.objective import make_population_objective

    p = out["problem"]
    X, F = np.load(d / "pareto_X.npy"), np.load(d / "pareto_F.npy")
    again = make_population_objective(p.system, p.slices, p.loss_data, p.defaults, p.lambdas,
                                      p.grid, y0=p.y0)(torch.as_tensor(X, dtype=torch.float32))
    np.testing.assert_allclose(again.numpy(), F, rtol=1e-5)
    with open(d / "pymoo_optimization_result.pkl", "rb") as fh:
        pk = pickle.load(fh)
    assert all(isinstance(pk[k], np.ndarray) for k in ("X", "F", "pareto_X", "pareto_F"))
    assert "torch" not in repr(type(pk["best_idx"]))


def test_chip_smoke_expects_the_cpu_file_set(global_runs):
    """``chip_smoke.py``'s phase-13 file set, derived from the run as the
    script derives it on the card, is this run's (the cascades of the first
    two kinases, a time-series figure a protein, a GOF figure a top
    solution, the figures)."""
    import chip_smoke

    kin = global_runs.out["topo"].kinases[:2]
    got = written(global_runs.port)
    assert got == chip_smoke.runner_files(global_runs.port, kin)
    assert {f"influence/cascade_{k}.csv" for k in kin} <= got
    assert {f"gene_timeseries/ts_{p}.png" for p in global_runs.out["topo"].proteins} <= got


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _options(parser):
    subs = next(a for a in parser._actions if a.dest == "command")
    out = {}
    for name, sp in subs.choices.items():
        out[name] = {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                              a.required, a.type) for a in sp._actions
                     if a.dest not in ("help", "device")}
    return out


def test_parser_matches_jax():
    """Subcommands, aliases, option strings, destinations, defaults,
    choices: JAX's, with ``--device`` on every command that computes."""
    assert _options(cli.build_parser()) == _options(jcli.build_parser())
    subs = next(a for a in cli.build_parser()._actions if a.dest == "command").choices
    with_device = {n for n, sp in subs.items() if any(a.dest == "device" for a in sp._actions)}
    assert with_device == {"tfopt", "kinopt", "model", "global-model", "global_model",
                           "mechanisms", "all"}
    assert cli.build_parser().parse_args(["model"]).device == "cuda"
    assert cli.parse_bound_pair("1, infinity") == jcli.parse_bound_pair("1, infinity")


def test_prep_matches_jax(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    write_raw(raw)
    for main, d in ((jcli.main, tmp_path / "jax"), (cli.main, tmp_path / "port")):
        d.mkdir()
        main(["prep", "--base-dir", str(raw), "--out-dir", str(d)])
    assert written(tmp_path / "port") == written(tmp_path / "jax")
    assert {"input1.csv", "input2.csv", "input3.csv", "input4.csv"} <= written(tmp_path / "port")
    assert_same_files(tmp_path / "port", tmp_path / "jax", 1e-12)


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_weight_fit_commands_match_jax(tmp_path, project, which):
    """``kinopt``/``tfopt --mode local`` on the project write JAX's result
    sheets within 1e-9 (the two multistart Adam runs agree to rounding)."""
    dirs = []
    for main, name, extra in ((jcli.main, "jax", []), (cli.main, "port", ["--device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(project, d)
        in_dir(d, main, [which, "--mode", "local", *extra])
        dirs.append(d)
    base = {f for f in written(project)}
    for d in dirs:
        for f in base:
            (d / f).unlink()
    assert_same_files(dirs[1], dirs[0], RTOL_COMPUTED)
    assert any(f.startswith(f"data/{which}_results_") for f in written(dirs[1]))


def test_kinopt_command_writes_the_kkt_report(tmp_path, project):
    """With ``fit_analysis`` on, ``kinopt`` writes the KKT report's tables
    and its two figures (the fit-analysis panels beside them:
    ``tests/test_torch_figure_commands.py``)."""
    shutil.copytree(project, tmp_path, dirs_exist_ok=True)
    cfg = (tmp_path / "config.toml").read_text()
    (tmp_path / "config.toml").write_text(cfg.replace(
        'scaling_method = "none"\nfit_analysis = false', 'scaling_method = "none"'))
    in_dir(tmp_path, cli.main, ["kinopt", "--device", "cpu"])
    assert {f for f in written(tmp_path) if f.startswith("data/kinopt_kkt/")} == {
        f"data/kinopt_kkt/{n}" for n in ("kkt_summary.tex", "active_constraints.csv",
                                         "lagrange_multipliers.csv",
                                         "high_sensitivity_sites.csv", "kkt_report.json",
                                         "constraint_violations.png", "sensitivity.png")}


def test_model_command_matches_jax(tmp_path, project):
    """``model`` writes JAX's ``model_results`` sheet, the gene's figures
    (the same files, each drawing the same within 1e-9 of each array's
    largest magnitude or of 1: the two fits agree to rounding) and
    ``report.html`` embedding them (one gene; the JAX command in its own
    process beside the port's)."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    for d in (dj, dp):
        shutil.copytree(project, d)
    proc = start_jax_cli(dj, "model", "--genes", "GA", records=tmp_path / "records.pkl")
    try:
        with capture_port() as got:
            in_dir(dp, cli.main, ["model", "--genes", "GA", "--device", "cpu"])
    finally:
        finish(proc)
    files = written(dp / "results")
    assert files == written(dj / "results")
    assert {"model_results_results.csv", "report.html", "GA/GA_diagram.png",
            "GA/GA_model_fit.png", "GA/GA_knockouts.png"} <= files
    with open(tmp_path / "records.pkl", "rb") as fh:
        want = pickle.load(fh)
    absolute = {k if os.path.isabs(k) else str(dj / k): v for k, v in want.items()}
    assert_same_records({k if os.path.isabs(k) else str(dp / k): v for k, v in got.items()},
                        absolute, dp, dj, scaled=1e-9)
    assert_same_csv_only(dp / "results", dj / "results")
    page = (dp / "results" / "report.html").read_text()
    assert all(f"<figcaption>{Path(f).name}</figcaption>" in page
               for f in files if f.endswith(".png"))


def assert_same_csv_only(got_dir, want_dir):
    """Each file the port wrote but its figures against JAX's of that
    name: CSV by value, HTML by page (``assert_same_html``, the embedded
    images masked)."""
    from test_torch_export import FIGURE_SUFFIXES, assert_same_csv, assert_same_html

    for f in written(got_dir):
        if f.endswith(FIGURE_SUFFIXES):
            continue
        if f.endswith(".html"):
            assert_same_html((got_dir / f).read_text(), (want_dir / f).read_text(), f)
        else:
            assert_same_csv(got_dir / f, want_dir / f, RTOL_COMPUTED)


def test_clean_removes_pycache(tmp_path, monkeypatch):
    """``clean`` removes every ``__pycache__`` under the working directory
    and the kernel build folder (here one under the temporary directory,
    so the checkout's own builds stay)."""
    from phoskintime_tpu_torch.ops import cuda_build

    build = tmp_path / "pkg" / "_build"
    build.mkdir(parents=True)
    (build / "libk.so").write_text("")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    (tmp_path / "a" / "__pycache__").mkdir(parents=True)
    (tmp_path / "a" / "__pycache__" / "m.pyc").write_text("")
    (tmp_path / "a" / "keep.py").write_text("")
    in_dir(tmp_path, cli.main, ["clean"])
    assert not build.exists()
    assert written(tmp_path) == {"a/keep.py"}


@pytest.mark.parametrize("argv", [["diagram"]])
def test_figure_commands_raise(argv, project, tmp_path):
    """The figure command that raised until the schematics were ported now
    writes its six figures (``tests/test_torch_schematic.py`` holds them
    to the JAX command's); without a config.toml it raises as JAX's."""
    paths = cli.main([*argv, "--config", str(project / "config.toml"), "--out-dir",
                      str(tmp_path / "d")])
    assert written(tmp_path / "d") == {f"{k}.png" for k in paths} and len(paths) == 6
    with pytest.raises(FileNotFoundError, match="config.toml not found"):
        in_dir(tmp_path, cli.main, argv)


def test_global_model_needs_the_card_by_default(project):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["global-model", "--config", str(project / "config.toml"),
                  "--out-dir", str(project / "never")])
    assert not (project / "never").exists() or not os.listdir(project / "never")


def test_module_help_in_a_subprocess():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m", "phoskintime_tpu_torch", "--help"], env=env,
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    for name in ("prep", "tfopt", "kinopt", "model", "global-model", "mechanisms", "all",
                 "clean"):
        assert name in out.stdout


def test_global_model_overrides(project):
    """``global-model``'s command-line overrides reach the config."""
    args = cli.build_parser().parse_args([
        "global-model", "--config", str(project / "config.toml"), "--pop", "8", "--n-gen", "3",
        "--refine", "--polish-steps", "0", "--gn-iters", "2", "--gens-per-dispatch", "4",
        "--scan", "--optimizer", "optuna"])
    cfg = cli.global_model_config(args)
    assert (cfg.pop, cfg.n_gen, cfg.refine, cfg.polish_steps, cfg.gn_iters,
            cfg.gens_per_dispatch, cfg.hyperparam_scan, cfg.optimizer) == (
        8, 3, True, 0, 2, 4, True, "optuna")


def test_profile_trace_and_timed(tmp_path, capsys):
    """``parallel/profile.py``: ``trace`` writes a Chrome trace of the block,
    ``timed`` prints its seconds (the JAX module's ``timed`` format)."""
    from phoskintime_tpu_torch.parallel.profile import timed, trace

    with timed("block"):
        with trace(str(tmp_path)) as path:
            torch.ones(64).cumsum(0)
    assert path == str(tmp_path / "trace.json") and os.path.getsize(path) > 0
    assert "[timing] block: " in capsys.readouterr().out
