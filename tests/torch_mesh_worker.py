"""The sharded runs of ``tests/test_torch_mesh.py``: one gloo rank a process.

    python tests/torch_mesh_worker.py RANK WORLD DIR

``DIR/inputs.pkl`` holds the problem (the port's view of a JAX demo
bundle, its observation tables as column dicts, seeded members) and
``DIR/project`` the runner's input files. Every rank joins a gloo group
through the file ``DIR/rendezvous`` (no port, so that test workers do not
collide), makes :func:`population_mesh`, runs :func:`run_all` with it into
``DIR/sharded`` and pickles what it got to ``DIR/rank<RANK>.pkl``; ranks
above 0 also record every file they open for writing there. The test
process runs :func:`run_all` without a mesh into ``DIR/unsharded``. No JAX.
"""

from __future__ import annotations

import builtins
import dataclasses
import io
import os
import pickle
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from phoskintime_tpu_torch.analysis.mechanisms import fit_all_mechanisms
from phoskintime_tpu_torch.config.loader import PhosKinConfig
from phoskintime_tpu_torch.network import analysis, runner
from phoskintime_tpu_torch.network.objective import (evaluate_population,
                                                     make_population_objective)
from phoskintime_tpu_torch.network.optimize import make_batched_evaluate, run_global_fit
from phoskintime_tpu_torch.network.polish import gradient_multistart, polish_solutions
from phoskintime_tpu_torch.network.scan import run_hyperparameter_scan
from phoskintime_tpu_torch.ops.nsga import das_dennis
from phoskintime_tpu_torch.ops.nsga_device import (device_nd_ranks, device_survival,
                                                   run_nsga2_device, run_unsga3_device,
                                                   survival_draws)
from phoskintime_tpu_torch.parallel.mesh import population_mesh

KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")
# the runner's steady-state check to one hour, not seven days: the 7-day
# RK45 solve is the runner's slowest stage on the CPU and runs on rank 0
# alone either way
STEADY_MINUTES = 60.0


def dtlz2(X):
    g = torch.sum((X[:, 2:] - 0.5) ** 2, dim=1)
    a, b = X[:, 0] * (np.pi / 2), X[:, 1] * (np.pi / 2)
    return torch.stack([(1 + g) * torch.cos(a) * torch.cos(b),
                        (1 + g) * torch.cos(a) * torch.sin(b), (1 + g) * torch.sin(a)], dim=1)


def host(x):
    """Tensors to numpy, through dicts, lists, tuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x) if not hasattr(x, "_fields") else tuple(map(host, x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x


def relative(x, root: Path):
    """The paths in ``x`` (a dict, list or string) relative to ``root``."""
    if isinstance(x, dict):
        return {k: relative(v, root) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [relative(v, root) for v in x]
    return os.path.relpath(x, root)


def fit_fields(res) -> dict:
    return {k: host(getattr(res, k)) for k in ("X", "F", "pareto_X", "pareto_F", "best_idx",
                                                "frechet_scores", "n_evals", "history")
            if hasattr(res, k)}


def run_all(inp: dict, mesh, out: Path) -> dict:
    """Every sharded entry on the problem of ``inp``, its files under
    ``out``; what each returned, as numpy."""
    out.mkdir(parents=True, exist_ok=True)
    b = inp["bundle"]
    args = [b[k] for k in KEYS]
    xl, xu = inp["xl"], inp["xu"]
    obj = make_population_objective(*args)
    r = {"evaluate": host(evaluate_population(obj, inp["X16"], mesh))}
    evaluate = make_batched_evaluate(obj, mesh=mesh)
    for P in (13, 21):
        r[f"batched{P}"] = evaluate(inp[f"X{P}"])

    # the ranking and the survival on their own (float32, as on the card)
    r["ranks"] = host(device_nd_ranks(torch.as_tensor(inp["F1024"]), mesh))
    refs = das_dennis(3, 12)
    unit = torch.as_tensor(refs / np.linalg.norm(refs, axis=1, keepdims=True),
                           dtype=torch.float32)
    draws = survival_draws(torch.Generator().manual_seed(0), 512, len(unit), torch.float32,
                           "cpu")
    r["survival"] = host(device_survival(torch.as_tensor(inp["X512"]),
                                         torch.as_tensor(inp["F512"]), 256, unit, draws, mesh))

    # the all-device loops
    loop = dict(device="cpu", dtype=torch.float64, mesh=mesh)
    r["unsga3_device"] = fit_fields(run_unsga3_device(
        dtlz2, np.zeros(6), np.ones(6), pop_size=32, n_gen=6, seed=0, gens_per_block=3,
        ftol=0.0, n_max_evals=None, **loop))
    r["nsga2_device"] = fit_fields(run_nsga2_device(
        dtlz2, np.zeros(6), np.ones(6), pop_size=32, n_gen=4, seed=1, gens_per_block=2,
        **loop))

    # the gradient stage: 5 members (padded to 8 over the ranks) in chunks of 8
    r["polish"] = polish_solutions(*args, inp["X5"], xl, xu, weights=inp["W5"], steps=4,
                                   chunk=8, mesh=mesh)
    r["multistart"] = gradient_multistart(*args, xl, xu, pop=8, steps=3, chunk=8, mesh=mesh)

    # run_global_fit on each route, with checkpoints (rank 0 writes them)
    pick = dict(frechet_pick=True, df_prot=inp["df_prot"], df_rna=inp["df_rna"],
                df_pho=inp["df_pho"], t_points=inp["t_points"])
    fit = dict(pop=16, n_gen=2, seed=0, ftol=0.0, mesh=mesh, **pick)
    routes = {"default": {}, "host_variation": dict(device_variation=False),
              "all_device": dict(gens_per_dispatch=2),
              "refine": dict(refine=True, num_refinements=1),
              "optuna": dict(optimizer="optuna", n_trials=20)}
    for name, kw in routes.items():
        r[f"fit_{name}"] = fit_fields(run_global_fit(
            *args, xl, xu, checkpoint_path=str(out / f"fit_{name}.ckpt"), checkpoint_every=1,
            **fit, **kw))

    _, trials = run_hyperparameter_scan(
        *args[:4], args[5], xl, xu, n_outer=3, inner_gens=2, inner_pop=8, gen_step=1,
        seed=3, mesh=mesh, out_dir=str(out / "scan"),
        checkpoint_path=str(out / "scan" / "scan_state.json"))
    r["scan"] = [(t.lambdas, t.score, t.state, t.n_gen, t.intermediate) for t in trials]

    cfg = PhosKinConfig.from_toml(str(inp["project"] / "config.toml"))
    steady = analysis.simulate_until_steady
    analysis.simulate_until_steady = lambda *a, **k: steady(*a, **{**k,
                                                                   "t_final": STEADY_MINUTES})
    cwd = os.getcwd()
    os.chdir(inp["project"])
    try:
        p = runner.prepare(cfg, device="cpu", dtype=torch.float64)
        sel = fit_all_mechanisms(p.df_kin, p.df_tf, p.df_prot, p.df_rna, p.df_pho,
                                 (p.tp_p, p.tp_r, p.tp_p), models=(0,), pop=8, n_gen=1,
                                 seed=0, out_dir=str(out / "mechanisms"), mesh=mesh,
                                 device="cpu", dtype=torch.float64)
        got = runner.main(cfg, mesh=mesh, out_dir=str(out / "runner"), device="cpu",
                          dtype=torch.float64)
    finally:
        os.chdir(cwd)
        analysis.simulate_until_steady = steady
    r["mechanisms"] = {"table": host(sel.table), "best": sel.best_model,
                       "fit": fit_fields(sel.fits[0]), "traj": host(sel.trajectories[0]),
                       "paths": relative(sel.paths, out)}
    r["runner"] = {"fit": fit_fields(got["result"]), "params_best": host(got["params_best"]),
                   "predictions": host(got["predictions"]),
                   "mu_star": host(got["sensitivity"].morris.mu_star),
                   "ss_value": host(got["steady_state"].ss_value),
                   "stages": sorted(got["seconds"])}
    return r


def main(rank: int, world: int, d: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    mesh = population_mesh()
    assert mesh is not None and (mesh.rank, mesh.size) == (rank, world)
    half = population_mesh(2)               # the first two ranks; None on the others
    with open(d / "inputs.pkl", "rb") as fh:
        inp = pickle.load(fh)
    seen: list = []
    if rank:
        real = builtins.open

        def spy(file, mode="r", *a, **k):
            if isinstance(file, (str, os.PathLike)) and any(c in mode for c in "wax+"):
                seen.append(str(Path(file).resolve()))
            return real(file, mode, *a, **k)

        builtins.open = io.open = spy
    try:
        r = run_all(inp, mesh, d / "sharded")
    finally:
        if rank:
            builtins.open = io.open = real
    r["writes"] = [p for p in seen if str(d) in p]
    obj = make_population_objective(*[inp["bundle"][k] for k in KEYS])
    r["half_mesh"] = None if half is None else (
        half.size, host(evaluate_population(obj, inp["X16"], half)))
    with open(d / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(r, fh)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]).resolve())
