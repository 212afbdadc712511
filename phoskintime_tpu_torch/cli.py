"""Command-line interface: ``python -m phoskintime_tpu_torch <command>``.

Counterpart of ``phoskintime_tpu/cli.py``: the same subcommands
(``prep | tfopt | kinopt | model | global-model | mechanisms | fitanalysis
| diagram | all | clean``), options, destinations and defaults, each
stage run in this process. Every command that computes takes ``--device
{cuda,cpu}`` (default ``cuda``; the counterpart of the JAX package's
``JAX_PLATFORMS``), and raises where there is no card unless it is given
``--device cpu``. The command modules are imported inside the commands.

``kinopt`` and ``tfopt`` write their fit-analysis folders and ``kinopt``
its KKT report (``fit_analysis``, default on); ``fitanalysis``
re-renders those panels from a saved workbook's CSV sheets; ``model``
writes each gene's figures; ``global-model``, ``mechanisms`` and
``model`` write their HTML pages; ``diagram`` draws the six
optimization-network schematics and, from a kinopt workbook's CSV sheets
(``--alpha-file``), the fitted network.
``clean`` removes ``__pycache__`` folders and the port's kernel build
folder ``phoskintime_tpu_torch/_build/``, where the JAX package removes
its XLA cache.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

from phoskintime_tpu_torch.config.loader import PhosKinConfig, load
from phoskintime_tpu_torch.config.logconf import setup_logger

logger = setup_logger()

def _add_common(p):
    p.add_argument("--config", default=None, help="path to config.toml")
    p.add_argument("--out-dir", default=None)


def _add_device(p):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to compute (default: the card)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="phoskintime_tpu_torch",
        description="ODE parameter estimation of cell-signalling events in temporal "
                    "space, on an NVIDIA GPU (PyTorch and CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prep", help="preprocess raw files into input1..4.csv")
    p.add_argument("--base-dir", required=True)
    _add_common(p)

    for name in ("tfopt", "kinopt"):
        p = sub.add_parser(name, help=f"run {name} optimization")
        p.add_argument("--mode", choices=["local", "evol"], default="local")
        _add_common(p)
        _add_device(p)

    p = sub.add_parser("model", help="per-gene ODE fitting")
    p.add_argument("--model", choices=["distmod", "succmod", "randmod"], default=None)
    p.add_argument("--genes", nargs="*", default=None)
    p.add_argument("--bootstraps", type=int, default=None)
    for bound in ("A", "B", "C", "D", "Ssite", "Dsite"):
        p.add_argument(f"--{bound}-bound", default=None)
    p.add_argument("--sensitivity", action="store_true")
    _add_common(p)
    _add_device(p)

    p = sub.add_parser("global-model", aliases=["global_model"], help="joint network fit")
    p.add_argument("--optimizer", choices=["pymoo", "optuna", "gradient"], default=None)
    p.add_argument("--pop", type=int, default=None)
    p.add_argument("--n-gen", type=int, default=None)
    p.add_argument("--refine", action="store_true")
    p.add_argument("--polish-steps", type=int, default=None,
                   help="exact-gradient Adam polish steps applied to the Pareto set after "
                        "the search (0 = off)")
    p.add_argument("--gn-iters", type=int, default=None,
                   help="Levenberg-Marquardt iterations on the best solution after the "
                        "search")
    p.add_argument("--gens-per-dispatch", type=int, default=None,
                   help="GA generations a block of the all-device loop (>1: variation, "
                        "evaluation and survival on the device)")
    p.add_argument("--scan", action="store_true",
                   help="loss-weight scan (TPE outer loop with median pruning) to pick the "
                        "loss lambdas before the fit")
    _add_common(p)
    _add_device(p)

    p = sub.add_parser("mechanisms",
                       help="fit every mechanistic hypothesis on the same data and rank "
                            "them by AIC/BIC")
    p.add_argument("--models", nargs="*", type=int, default=[0, 1, 2, 4])
    p.add_argument("--pop", type=int, default=48)
    p.add_argument("--n-gen", type=int, default=25)
    p.add_argument("--polish-steps", type=int, default=0)
    _add_common(p)
    _add_device(p)

    p = sub.add_parser("fitanalysis",
                       help="post-fit dashboards from a saved kinopt/tfopt results "
                            "workbook")
    p.add_argument("--which", choices=["kinopt", "tfopt"], required=True)
    p.add_argument("--mode", choices=["local", "evol"], default="local")
    p.add_argument("--file", default=None)
    _add_common(p)

    p = sub.add_parser("diagram",
                       help="the optimization-network schematics; with --alpha-file also the "
                            "fitted network")
    p.add_argument("--kin-psites", type=int, default=1)
    p.add_argument("--tf-psites", type=int, default=1)
    p.add_argument("--alpha-file", default=None,
                   help="kinopt results workbook: the fitted network from its Alpha/Beta "
                        "sheets (read through their CSV files)")
    p.add_argument("--top-edges", type=int, default=60)
    _add_common(p)

    p = sub.add_parser("all", help="prep -> tfopt -> kinopt -> model")
    p.add_argument("--base-dir", default=None)
    _add_common(p)
    _add_device(p)

    p = sub.add_parser("clean", help="remove __pycache__ folders and the kernel builds")
    _add_common(p)
    return ap


def parse_bound_pair(val: str):
    """'lo,hi' -> (float, float); 'inf' and 'infinity' read as infinity."""
    lo, hi = val.split(",")
    hi = hi.strip().lower()
    return float(lo), float("inf") if hi in ("inf", "infinity") else float(hi)


def _ode_bounds(cfg_ode: dict, args) -> dict:
    b = cfg_ode.get("bounds", {}) or {}

    def pair(cli_val, key, default=20.0):
        if cli_val:
            return parse_bound_pair(cli_val)
        return (0.0, float(b.get(key, default)))
    return {
        "A": pair(args.A_bound, "mRNA_prod"),
        "B": pair(args.B_bound, "mRNA_deg"),
        "C": pair(args.C_bound, "protein_prod"),
        "D": pair(args.D_bound, "protein_deg"),
        "S(i)": pair(args.Ssite_bound, "phospho_prod"),
        "D(i)": pair(args.Dsite_bound, "phospho_deg"),
    }


def _joiner(root):
    return lambda p: p if os.path.isabs(str(p)) else os.path.join(root, str(p))


def _ode_data(args):
    """The [ode] section, its time grids and the observations (raw scaling)
    that ``model`` and ``mechanisms`` read."""
    from phoskintime_tpu_torch.io.load import load_data

    sec = load(None, "ode", args.config)
    join = _joiner(sec["_root"])
    times = sec.get("time", {})
    tp = np.asarray(times.get("protein", PhosKinConfig.time_points_protein), float)
    tr = np.asarray(times.get("rna", PhosKinConfig.time_points_rna), float)
    inputs = sec.get("inputs", {}) or {}
    gm = load(None, "global_model", args.config)
    data = load_data(join(gm.get("kinase_net", "data/input2.csv")),
                     join(gm.get("tf_net", "data/input4.csv")),
                     join(inputs.get("protein_excel", "data/input1.csv")),
                     join(gm.get("rna", "data/input3.csv")),
                     time_points_protein=tp, time_points_rna=tr, scaling_method="raw")
    return sec, tp, tr, data


def cmd_prep(args):
    from phoskintime_tpu_torch.io.preprocess import run_cleanup

    out_dir = args.out_dir
    if out_dir is None:
        sec = load(None, "paths", args.config)
        out_dir = os.path.join(sec["_root"], sec.get("data_dir", "data"))
        os.makedirs(out_dir, exist_ok=True)
    run_cleanup(args.base_dir, out_dir)


def cmd_tfopt(args):
    from phoskintime_tpu_torch.io.export import export_tfopt_results
    from phoskintime_tpu_torch.tfopt.data import load_tfopt_problem
    from phoskintime_tpu_torch.tfopt.optimize import run_evolutionary, run_local

    sec = load(args.mode, "tfopt", args.config)
    data_dir = os.path.join(sec["_root"], sec["_paths"].get("data_dir", "data"))
    prob, _ = load_tfopt_problem(
        os.path.join(data_dir, sec.get("input1", "input1.csv")),
        os.path.join(data_dir, sec.get("input3", "input3.csv")),
        os.path.join(data_dir, sec.get("input4", "input4.csv")),
        lb=float(sec.get("lower_bound", -4.0)), ub=float(sec.get("upper_bound", 4.0)))
    loss_type = int(sec.get("loss_type", 5))
    if args.mode == "evol":
        res = run_evolutionary(prob, optimizer=int(sec.get("optimizer", 0)),
                               loss_type=loss_type,
                               gens_per_dispatch=int(sec.get("gens_per_dispatch", 1)),
                               device=args.device)
    else:
        res = run_local(prob, loss_type=loss_type, device=args.device)
    out = os.path.join(data_dir, sec.get("out_file", "tfopt_results.xlsx"))
    export_tfopt_results(out, prob, res)
    if bool(sec.get("fit_analysis", True)):
        from phoskintime_tpu_torch.analysis.fitpanels import tfopt_fit_analysis

        adir = os.path.join(os.path.dirname(out), "tfopt_fitanalysis")
        tfopt_fit_analysis(prob, res, adir)
        logger.info(f"[tfopt:{args.mode}] fit-analysis panels -> {adir}")
    logger.info(f"[tfopt:{args.mode}] loss={res.loss:.6g} -> {out}")


def cmd_kinopt(args):
    from phoskintime_tpu_torch.io.export import export_kinopt_results
    from phoskintime_tpu_torch.kinopt.data import load_kinopt_problem
    from phoskintime_tpu_torch.kinopt.optimize import run_evolutionary, run_local

    sec = load(args.mode, "kinopt", args.config)
    data_dir = os.path.join(sec["_root"], sec["_paths"].get("data_dir", "data"))
    prob, meta = load_kinopt_problem(
        os.path.join(data_dir, sec.get("input1", "input1.csv")),
        os.path.join(data_dir, sec.get("input2", "input2.csv")),
        scaling_method=str(sec.get("scaling_method", "none")),
        split_point=int(sec.get("split_point", 9)),
        segment_points=sec.get("segment_points"),
        estimate_missing_kinases=bool(sec.get("estimate_missing_kinases", True)),
        lb=float(sec.get("lower_bound", -4.0)), ub=float(sec.get("upper_bound", 4.0)))
    loss_type = str(sec.get("loss_type", "base"))
    if args.mode == "evol":
        res = run_evolutionary(prob, method=str(sec.get("method", "NSGA-II")),
                               loss_type=loss_type,
                               include_reg=bool(sec.get("regularization", False)),
                               gens_per_dispatch=int(sec.get("gens_per_dispatch", 1)),
                               device=args.device)
    else:
        res = run_local(prob, loss_type=loss_type, device=args.device)
    out = os.path.join(data_dir, sec.get("out_file", "kinopt_results.xlsx"))
    export_kinopt_results(out, prob, res, meta)
    if bool(sec.get("fit_analysis", True)):
        from phoskintime_tpu_torch.analysis.fitpanels import kinopt_fit_analysis

        adir = os.path.join(os.path.dirname(out), "kinopt_fitanalysis")
        kinopt_fit_analysis(prob, res, adir, meta)
        logger.info(f"[kinopt:{args.mode}] fit-analysis panels -> {adir}")
        from phoskintime_tpu_torch.kinopt.kkt import kkt_suite

        kdir = os.path.join(os.path.dirname(out), "kinopt_kkt")
        kkt_suite(prob, res, kdir, loss_type=loss_type, logger=logger, device=args.device)
        logger.info(f"[kinopt:{args.mode}] KKT optimality report -> {kdir}")
    logger.info(f"[kinopt:{args.mode}] loss={res.loss:.6g} feasible={res.feasible} -> {out}")


def cmd_model(args):
    from phoskintime_tpu_torch.fit.pipeline import run_model_pipeline

    sec, tp, tr, (_, _, df_prot, df_pho, df_rna, *_) = _ode_data(args)
    model = args.model or str(sec.get("model", "distmod"))
    out_dir = args.out_dir or os.path.join(
        sec["_root"], sec.get("_paths", {}).get("results_dir", "results"))
    outputs = run_model_pipeline(
        df_prot, df_pho, df_rna, time_points=tp, rna_time_points=tr,
        bounds=_ode_bounds(sec, args), model=model, out_dir=out_dir, genes=args.genes,
        dev_test=bool(sec.get("dev_test", False)),
        bootstraps=args.bootstraps or int((sec.get("bootstrap") or {}).get("n", 0)),
        run_sensitivity=args.sensitivity, device=args.device)
    logger.info(f"[model] fitted {len(outputs)} genes -> {out_dir}")


def global_model_config(args) -> PhosKinConfig:
    """The config with the command line's overrides."""
    import dataclasses

    cfg = PhosKinConfig.from_toml(args.config)
    overrides = {}
    if args.optimizer:
        overrides["optimizer"] = args.optimizer
    if args.pop:
        overrides["pop"] = args.pop
    if args.n_gen:
        overrides["n_gen"] = args.n_gen
    if args.refine:
        overrides["refine"] = True
    for key in ("polish_steps", "gens_per_dispatch", "gn_iters"):
        if getattr(args, key, None) is not None:
            overrides[key] = getattr(args, key)
    if getattr(args, "scan", False):
        overrides["hyperparam_scan"] = True
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def cmd_global_model(args):
    from phoskintime_tpu_torch.network.runner import main as run_global

    return run_global(global_model_config(args), out_dir=args.out_dir, device=args.device)


def cmd_mechanisms(args):
    """Fit every mechanism to the same data and rank them."""
    from phoskintime_tpu_torch.analysis.mechanisms import MECHANISMS, fit_all_mechanisms

    sec, tp, tr, (df_kin, df_tf, df_prot, df_pho, df_rna, *_) = _ode_data(args)
    out_dir = args.out_dir or os.path.join(
        sec["_root"], sec.get("_paths", {}).get("results_dir", "results"),
        "mechanism_selection")
    sel = fit_all_mechanisms(df_kin, df_tf, df_prot, df_rna, df_pho, (tp, tr, tp),
                             models=tuple(args.models), pop=args.pop, n_gen=args.n_gen,
                             polish_steps=args.polish_steps, out_dir=out_dir, logger=logger,
                             device=args.device)
    logger.info(f"[mechanisms] best={MECHANISMS[sel.best_model]} -> {out_dir}")
    return sel


def cmd_fitanalysis(args):
    """The kinopt or tfopt panels re-rendered from a saved results
    workbook's CSV sheets (``--file``, default the config's ``out_file``)
    into ``--out-dir`` (default ``<which>_fitanalysis`` beside it)."""
    from phoskintime_tpu_torch.analysis.fitpanels import fit_analysis_from_workbook

    sec = load(args.mode, args.which, args.config)
    data_dir = os.path.join(sec["_root"], sec["_paths"].get("data_dir", "data"))
    path = args.file or os.path.join(data_dir, sec.get("out_file", f"{args.which}_results.xlsx"))
    out_dir = args.out_dir or os.path.join(os.path.dirname(path), f"{args.which}_fitanalysis")
    out = fit_analysis_from_workbook(path, out_dir, args.which)
    logger.info(f"[fitanalysis:{args.which}] {len(out)} panel groups -> {out_dir}")
    return out


def cmd_diagram(args):
    """The six kinopt/tfopt/global schematics (plain and with constraints)
    into ``--out-dir`` (default ``<out_dir>/diagrams``) and, with
    ``--alpha-file``, the fitted network of that kinopt workbook's Alpha
    and Beta Values sheets. Returns {name: path}."""
    from phoskintime_tpu_torch.io.load import read_table
    from phoskintime_tpu_torch.io.utils import is_missing, n_rows
    from phoskintime_tpu_torch.report.schematic import (fitted_network_schematic,
                                                        render_all_schematics)

    sec = load("local", "kinopt", args.config)
    out_dir = args.out_dir or os.path.join(sec["_root"], sec["_paths"].get("out_dir", "results"),
                                           "diagrams")
    os.makedirs(out_dir, exist_ok=True)
    paths = render_all_schematics(out_dir, kin_psites=args.kin_psites,
                                  tf_psites=args.tf_psites)
    if args.alpha_file:
        alpha = read_table(args.alpha_file, sheet_name="Alpha Values")
        beta = read_table(args.alpha_file, sheet_name="Beta Values")
        if alpha is None or "Alpha" not in alpha:
            raise FileNotFoundError(
                f"sheet 'Alpha Values' of {args.alpha_file} not found "
                "(pass the workbook path, not an individual sheet CSV)")
        if beta is not None and "Beta" in beta:
            # an empty Psite is a global beta; a per-kinase sheet has no Psite column
            sites = beta.get("Psite", [None] * n_rows(beta))
            beta["Psite"] = np.asarray(["" if is_missing(v) else v for v in sites], dtype=object)
        else:
            beta = None
        paths["fitted_network"] = fitted_network_schematic(
            alpha, beta, os.path.join(out_dir, "fitted_network.png"), top_edges=args.top_edges,
            logger=logger)
    logger.info(f"[diagram] {len(paths)} figures -> {out_dir}")
    return paths


def cmd_all(args):
    if args.base_dir:
        cmd_prep(argparse.Namespace(base_dir=args.base_dir, config=args.config,
                                    out_dir=args.out_dir))
    for mode_cmd in (cmd_tfopt, cmd_kinopt):
        mode_cmd(argparse.Namespace(mode="local", config=args.config, out_dir=args.out_dir,
                                    device=args.device))
    cmd_model(argparse.Namespace(
        model=None, genes=None, bootstraps=None, A_bound=None, B_bound=None,
        C_bound=None, D_bound=None, Ssite_bound=None, Dsite_bound=None,
        sensitivity=False, config=args.config, out_dir=args.out_dir, device=args.device))


def cmd_clean(args):
    """Remove every ``__pycache__`` under the working directory and the
    port's kernel build folder."""
    from phoskintime_tpu_torch.ops.cuda_build import BUILD_DIR

    n = 0
    for root, dirs, _files in os.walk("."):
        for d in list(dirs):
            if d == "__pycache__":
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)
                dirs.remove(d)
                n += 1
    if BUILD_DIR.is_dir():
        shutil.rmtree(BUILD_DIR, ignore_errors=True)
        logger.info(f"[clean] removed the kernel builds {BUILD_DIR}")
    logger.info(f"[clean] removed {n} __pycache__ dirs")


COMMANDS = {"prep": cmd_prep, "tfopt": cmd_tfopt, "kinopt": cmd_kinopt, "model": cmd_model,
            "global_model": cmd_global_model, "fitanalysis": cmd_fitanalysis,
            "mechanisms": cmd_mechanisms, "diagram": cmd_diagram, "all": cmd_all,
            "clean": cmd_clean}


def main(argv=None):
    """Run one command; returns what the command returns (the global-model
    runner's bundle, the mechanism selection), for callers in Python."""
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command.replace("-", "_")](args)


if __name__ == "__main__":
    main(sys.argv[1:])
