"""The global network fit: population search, refinement and the Fréchet
pick.

Counterpart of ``phoskintime_tpu/network/optimize.py``: U-NSGA-III
(``optimizer="pymoo"``) over the batched objective on the system's
device, either with host survival around device variation (the default,
``gens_per_dispatch=1``; :func:`~phoskintime_tpu_torch.ops.nsga.run_unsga3`
with :func:`~phoskintime_tpu_torch.ops.nsga.make_device_ga_step`) or with
the whole generation on the device (``gens_per_dispatch > 1``;
:func:`~phoskintime_tpu_torch.ops.nsga_device.run_unsga3_device`);
or a gradient-only multistart (``optimizer="gradient"``); optional
bound-zoom refinement rounds; the exact-gradient Adam polish of the Pareto
set (``polish_steps > 0``) and the Levenberg-Marquardt finish of its
best-by-sum member (``gn_iters > 0``), both from
:mod:`~phoskintime_tpu_torch.network.polish`; and the pick of the Pareto
member whose simulated fold changes lie closest, by discrete Fréchet
distance, to the data.

``optimizer="optuna"`` runs the port's MOTPE
(:class:`~phoskintime_tpu_torch.ops.tpe.MOTPESampler`): batches of 16 asked
on the host, scored by the batched objective on the device and told back.

A ``mesh`` (:class:`~phoskintime_tpu_torch.parallel.mesh.PopulationMesh`)
shards every route's evaluations, the all-device loop's ranking, the polish
and the refinement over its ranks; every rank runs the same fit with the
same seed and ends with the same result, and only rank 0 writes
checkpoints and logs.

The pick reads the observation tables by column (``np.asarray(df[col])``
for ``protein``, ``psite``, ``time`` and ``fc``), so a pandas DataFrame and
the demo's column dicts serve alike; nothing here imports pandas.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import numpy_dtype
from phoskintime_tpu_torch.network.expo import exponential_simulate_batched
from phoskintime_tpu_torch.network.objective import (evaluate_population, make_objective,
                                                     make_population_objective)
from phoskintime_tpu_torch.network.params import unpack_params
from phoskintime_tpu_torch.network.polish import (gradient_multistart, lm_refine,
                                                  polish_solutions, simplex_weights)
from phoskintime_tpu_torch.network.simulate import extract_observables, fold_changes
from phoskintime_tpu_torch.ops.frechet import frechet_distance
from phoskintime_tpu_torch.ops.nsga import (MOOResult, fast_non_dominated_sort, lhs_sampling,
                                            make_device_ga_step, run_unsga3)
from phoskintime_tpu_torch.ops.nsga_device import make_device_ga_blocks, run_unsga3_device
from phoskintime_tpu_torch.ops.tpe import MOTPESampler
from phoskintime_tpu_torch.parallel.checkpoint import (GACheckpointer, load_sampler,
                                                       save_sampler)
from phoskintime_tpu_torch.parallel.mesh import is_writer, on_root, pad_rows


def make_batched_evaluate(objective, mesh=None):
    """numpy (P, n) -> float64 numpy (P, 3) around a batched objective.
    With a ``mesh`` the population is padded with copies of its last row
    to a multiple of it (which divides it evenly over the ranks); the
    padding's rows are dropped from F."""

    def evaluate(X):
        X = np.asarray(X, float)
        F = evaluate_population(objective, pad_rows(X, mesh), mesh=mesh)
        return torch.as_tensor(F).to("cpu", torch.float64).numpy()[:len(X)]
    return evaluate


@dataclass
class GlobalFitResult:
    X: np.ndarray
    F: np.ndarray
    pareto_X: np.ndarray
    pareto_F: np.ndarray
    best_idx: int                 # Frechet-picked solution index (into pareto)
    frechet_scores: np.ndarray
    history: list
    n_evals: int
    pop_history: list = None      # (gen, F) population snapshots


def run_global_fit(system, slices, loss_data, defaults, lambdas, time_grid,
                   xl, xu, *, optimizer="pymoo", pop=300, n_gen=1000,
                   n_trials=1000, seed=42, loss_mode=0, mesh=None,
                   rtol=1e-5, atol=1e-7, max_steps=5000, y0=None,
                   refine=False, num_refinements=0, refine_padding=0.25,
                   frechet_pick=True, df_prot=None, df_rna=None, df_pho=None,
                   t_points=None, callback=None, logger=None,
                   ftol=0.0025, ftol_period=30,
                   n_max_evals=100_000, solver="auto",
                   checkpoint_path=None, checkpoint_every=10,
                   polish_steps=0, polish_lr=0.02,
                   device_variation=True,
                   gens_per_dispatch=1, gn_iters=0) -> GlobalFitResult:
    """End-to-end global fit on the system's device and dtype.

    solver: "auto" and "expo" take the batched exponential objective
    (:func:`make_population_objective`: ETD2RK for models 0-2, exponential
    Rosenbrock for model 4); any other name the oracle objective
    (:func:`make_objective`: "esdirk", else RK45), as in the JAX package.

    device_variation (default True) runs tournament, SBX, PM and clone
    repair on the device beside the population objective, leaving only
    survival on the host (:func:`make_device_ga_step`); False runs the host
    numpy operators. gens_per_dispatch > 1 runs the whole generation loop
    on the device, that many generations a block
    (:func:`run_unsga3_device`); callbacks, checkpoints and the ftol stop
    then act at block granularity. Both need the population objective.

    checkpoint_path: a :class:`GACheckpointer` file; the main search stores
    its whole state there every ``checkpoint_every`` generations, and a run
    started on a file that holds one continues from it to ``n_gen``.

    optimizer="optuna": MOTPE over ``n_trials`` trials in batches of 16,
    each batch one call of the batched objective; with ``checkpoint_path``
    the sampler is stored in ``checkpoint_path + ".tpe"`` every
    ``16 * checkpoint_every`` trials, and a run started where that file
    exists continues from its history. Every trial counts as an evaluation.

    optimizer="gradient": no evolutionary search, but
    :func:`gradient_multistart` of ``pop`` starts for ``max(100,
    polish_steps or 300)`` Adam steps at ``polish_lr``, counted as 3
    evaluations a member and step. polish_steps > 0 (another optimizer)
    polishes the Pareto set after the search and any refinement
    (:func:`polish_solutions`, each member along its own
    :func:`simplex_weights` direction) and merges the polished members
    back by non-dominated sorting (3 evaluations a member and step).
    gn_iters > 0 (loss_mode 0 only) finishes the best-by-sum Pareto member
    with that many :func:`lm_refine` iterations (counted as 30 evaluations
    each) and merges it likewise.

    mesh: a :class:`~phoskintime_tpu_torch.parallel.mesh.PopulationMesh`;
    every rank calls this with the same arguments. The evaluations of
    every route (the host loop's and MOTPE's padded to the mesh), the
    all-device loop's ranking, the polish and the gradient multistart split
    over its ranks; the rest runs the same on every rank, so each returns
    the same result. Only rank 0 writes checkpoints and logs; the others
    read a checkpoint to resume. The LM finish and the Fréchet pick, which
    the JAX package does not shard, run on rank 0 while the others wait
    for their results.

    ``n_trials``, ``rtol``/``atol``/``max_steps`` (expo) are accepted for
    the JAX package's signature and read only where they apply."""
    if solver == "auto":
        solver = "expo"
    args = (system, slices, loss_data, defaults, lambdas, time_grid)
    if solver == "expo":
        objective = make_population_objective(*args, loss_mode=loss_mode, y0=y0)
    else:
        objective = make_objective(*args, loss_mode=loss_mode, rtol=rtol, atol=atol,
                                   max_steps=max_steps, y0=y0, solver=solver)
    evaluate = make_batched_evaluate(objective, mesh=mesh)
    dtype, device = system.rhs.Kmat.dtype, system.rhs.Kmat.device
    if not is_writer(mesh):
        logger = None

    ck = None
    if checkpoint_path is not None:
        ck = GACheckpointer(checkpoint_path, every=checkpoint_every, write=is_writer(mesh))
        if ck.resume_state() is not None and logger is not None:
            logger.info(f"[Fit] resuming from {checkpoint_path} (gen {ck.start_gen})")

    pop_history: list = []

    def cb(gen, X, F):
        pop_history.append((gen, np.asarray(F, float).copy()))
        if callback is not None:
            # a truthy return stops the GA (the pruning protocol)
            return callback(gen, X, F)
        return False

    population = getattr(objective, "_is_population", False)
    device_step = ga_prebuilt = None
    if optimizer == "gradient":
        steps = max(100, polish_steps or 300)
        Xg, Fg = gradient_multistart(*args, xl, xu, pop=pop, steps=steps, lr=polish_lr,
                                     loss_mode=loss_mode, y0=y0, seed=seed, mesh=mesh)
        pf = fast_non_dominated_sort(Fg)[0]
        res = MOOResult(Xg, Fg, Xg[pf], Fg[pf], [], 0, pop * 3 * steps)
    elif optimizer == "optuna":
        res = _run_motpe_fit(evaluate, xl, xu, n_trials, seed, checkpoint_path,
                             checkpoint_every, is_writer(mesh))
    elif population and gens_per_dispatch > 1:
        ga_prebuilt = make_device_ga_blocks(objective, len(np.asarray(xl)), pop, dtype=dtype,
                                            device=device, gens_per_block=gens_per_dispatch,
                                            mesh=mesh)
        res = run_unsga3_device(
            objective, xl, xu, pop_size=pop, n_gen=n_gen, seed=seed, ftol=ftol,
            ftol_period=ftol_period, n_max_evals=n_max_evals,
            gens_per_block=gens_per_dispatch, callback=cb, logger=logger,
            prebuilt=ga_prebuilt, device=device, checkpoint=ck, mesh=mesh)
    else:
        if population and device_variation:
            device_step = make_device_ga_step(objective, xl, xu, pop, dtype=dtype, device=device,
                                              mesh=mesh)
        res = run_unsga3(evaluate, xl, xu, pop_size=pop, n_gen=n_gen, seed=seed, callback=cb,
                         logger=logger, verbose=logger is not None, ftol=ftol,
                         ftol_period=ftol_period, n_max_evals=n_max_evals,
                         device_step=device_step, dtype=numpy_dtype(dtype), checkpoint=ck)

    # ---- iterative refinement (bound zoom + warm start) -------------------
    if refine and num_refinements > 0:
        rng = np.random.default_rng(seed + 1)
        cur = res
        total_evals = res.n_evals
        cur_xl, cur_xu = np.asarray(xl, float), np.asarray(xu, float)
        for _ in range(num_refinements):
            new_xl, new_xu = get_refined_bounds(cur.pareto_X, cur_xl, cur_xu,
                                                padding=refine_padding)
            x0 = create_multistart_population(cur.pareto_X, pop, new_xl, new_xu, rng)
            rounds = dict(pop_size=pop, n_gen=max(10, n_gen // 4), seed=seed + 2, x0=x0,
                          ftol=ftol, ftol_period=ftol_period)
            if ga_prebuilt is not None:
                # the bounds are arguments of the block: the zoomed box
                # reuses the same block function
                nxt = run_unsga3_device(objective, new_xl, new_xu,
                                        gens_per_block=gens_per_dispatch,
                                        prebuilt=ga_prebuilt, device=device, mesh=mesh,
                                        **rounds)
            else:
                nxt = run_unsga3(evaluate, new_xl, new_xu, device_step=device_step,
                                 dtype=numpy_dtype(dtype), **rounds)
            total_evals += nxt.n_evals
            if nxt.pareto_F.min(axis=0).sum() >= cur.pareto_F.min(axis=0).sum():
                break  # no improvement -> stop refining
            cur, cur_xl, cur_xu = nxt, new_xl, new_xu
        # n_evals covers the whole fit, not just the last round
        res = dataclasses.replace(cur, n_evals=total_evals)

    # ---- exact-gradient polish of the Pareto set ---------------------------
    if polish_steps > 0 and optimizer != "gradient" and len(res.pareto_X):
        pX, pF = polish_solutions(*args, res.pareto_X, xl, xu,
                                  weights=simplex_weights(res.pareto_F), steps=polish_steps,
                                  lr=polish_lr, loss_mode=loss_mode, y0=y0, mesh=mesh)
        if logger is not None:
            logger.info(f"[Polish] ideal {res.pareto_F.min(axis=0)} -> {pF.min(axis=0)} "
                        f"({polish_steps} Adam steps)")
        res = _merged(res, pX, pF, 3 * polish_steps * len(pX))

    # ---- the LM (Gauss-Newton) finish of the best-by-sum member ------------
    if gn_iters > 0 and len(res.pareto_X) and loss_mode == 0:
        bi = int(np.argmin(res.pareto_F.sum(axis=1)))
        th_gn, sse = on_root(mesh, lambda: lm_refine(*args, res.pareto_X[bi], xl, xu,
                                                     iters=gn_iters, y0=y0, logger=logger))
        res = _merged(res, th_gn[None], evaluate(th_gn[None]), gn_iters * 30)
        if logger is not None:
            logger.info(f"[GN] best-by-sum sse -> {sse:.6g}")

    # ---- Frechet-distance solution picking --------------------------------
    best_idx, scores = 0, np.zeros(len(res.pareto_X))
    if frechet_pick and df_prot is not None and t_points is not None:
        best_idx, scores = on_root(mesh, lambda: pick_solution_frechet(
            system, slices, res.pareto_X, df_prot, df_rna, df_pho, t_points, lambdas))

    return GlobalFitResult(res.X, res.F, res.pareto_X, res.pareto_F, best_idx, scores,
                           res.history, res.n_evals, pop_history)


MOTPE_BATCH = 16


def _run_motpe_fit(evaluate, xl, xu, n_trials, seed, checkpoint_path,
                   checkpoint_every, write: bool = True) -> MOOResult:
    """MOTPE: ask a batch, score it on the device, tell it; X and F of
    every finite trial, their Pareto set, no generation history. The
    sampler is stored only where ``write``."""
    sampler = MOTPESampler(xl, xu, seed=seed)
    path = None if checkpoint_path is None else checkpoint_path + ".tpe"
    if path is not None:
        load_sampler(path, sampler)
    done = len(sampler.X)
    while done < n_trials:
        bsz = min(MOTPE_BATCH, n_trials - done)
        Xb = sampler.ask_batch(bsz)
        sampler.tell_batch(Xb, evaluate(Xb))
        done += bsz
        if write and path is not None and done % (MOTPE_BATCH * checkpoint_every) < MOTPE_BATCH:
            save_sampler(path, sampler)
    pX, pF = sampler.pareto
    X_all, F_all = np.asarray(sampler.X), np.asarray(sampler.F)
    return MOOResult(X_all, F_all, pX, pF, [], 0, len(X_all))


def _merged(res, X_new, F_new, n_evals: int):
    """``res`` with the members (X_new, F_new) appended and its Pareto set
    re-sorted over all of them; ``n_evals`` more evaluations."""
    X_all = np.vstack([res.X, X_new])
    F_all = np.vstack([res.F, np.asarray(F_new, float)])
    pf = fast_non_dominated_sort(F_all)[0]
    return dataclasses.replace(res, X=X_all, F=F_all, pareto_X=X_all[pf], pareto_F=F_all[pf],
                               n_evals=res.n_evals + n_evals)


# ---------------------------------------------------------------------------
# refinement helpers
# ---------------------------------------------------------------------------

def get_refined_bounds(X, current_xl, current_xu, padding=0.2):
    """Zoom bounds to the Pareto spread +/- padding, clamped to the originals."""
    X = np.asarray(X, float)
    p_min, p_max = X.min(axis=0), X.max(axis=0)
    span = np.maximum(p_max - p_min, 1e-2)
    new_xl = np.maximum(p_min - span * padding, current_xl)
    new_xu = np.minimum(p_max + span * padding, current_xu)
    return new_xl, new_xu


def create_multistart_population(X_best, pop_size, new_xl, new_xu, rng):
    """50% warm start (best individuals, noise-duplicated) + 50% fresh."""
    X_best = np.asarray(X_best, float)
    n_best = len(X_best)
    n_warm = pop_size // 2
    if n_best >= n_warm:
        X_warm = X_best[rng.choice(n_best, n_warm, replace=False)]
    else:
        extra = rng.integers(0, n_best, n_warm - n_best)
        noise = rng.normal(0, 0.05, (n_warm - n_best, X_best.shape[1])) * (new_xu - new_xl)
        X_warm = np.vstack([X_best, X_best[extra] + noise])
    X_warm = np.clip(X_warm, new_xl, new_xu)
    X_fresh = lhs_sampling(pop_size - n_warm, new_xl, new_xu, rng)
    return np.vstack([X_warm, X_fresh])


# ---------------------------------------------------------------------------
# Frechet-distance solution picking
# ---------------------------------------------------------------------------

@torch.no_grad()
def pick_solution_frechet(system, slices, pareto_X, df_prot, df_rna, df_pho,
                          t_points, lambdas):
    """The Pareto member minimising the lambda-weighted sum, over the three
    modalities, of its curves' discrete Fréchet distances to the data.

    One batched ETD2RK simulation of every member on the system's device,
    fold changes as tensors, and one batched (solutions x curves) Fréchet
    DP per curve length and modality."""
    topo = system.topo
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device)
    tp_p, tp_r, tp_ph = (np.asarray(t, float) for t in t_points)
    P = len(pareto_X)
    times = np.unique(np.concatenate([tp_p, tp_r, tp_ph]))

    params_b = unpack_params(torch.as_tensor(np.asarray(pareto_X, float), **f), slices, topo)
    ys, _ = exponential_simulate_batched(system, params_b, times)
    fc_r, fc_p, fc_ph = fold_changes(extract_observables(system, ys), times)  # (P, T, ...)

    t_idx = {float(t): i for i, t in enumerate(times)}

    def modality_score(df, pred_cube, site_axis=False):
        return _modality_frechet_score(df, pred_cube, site_axis, topo, t_idx, P)

    scores = (lambdas["protein"] * modality_score(df_prot, fc_p)
              + lambdas["rna"] * modality_score(df_rna, fc_r)
              + lambdas["phospho"] * modality_score(df_pho, fc_ph, site_axis=True))
    return int(np.argmin(scores)), scores


def _modality_frechet_score(df, pred_cube, site_axis, topo, t_idx, P):
    """Sum of per-curve Fréchet distances over all P solutions: (P,) numpy.
    ``df``'s rows are grouped by protein (and site), each group sorted by
    time, as the JAX package's ``groupby`` then ``sort_values`` do;
    ``pred_cube`` is (P, T, N[, Smax]) on the device."""
    total = np.zeros(P)
    if df is None:
        return total
    time = np.asarray(df["time"], float)
    if time.size == 0:
        return total
    fc = np.asarray(df["fc"], float)
    cols = ["protein", "psite"] if site_axis else ["protein"]
    groups: dict = {}
    for row, key in enumerate(zip(*(np.asarray(df[c]).tolist() for c in cols))):
        groups.setdefault(key, []).append(row)
    obs_list, pred_list = [], []
    for key in sorted(groups):
        rows = np.asarray(groups[key])
        rows = rows[np.argsort(time[rows], kind="stable")]
        if len(rows) < 2:
            continue
        i = topo.p2i.get(key[0])
        if i is None:
            continue
        tsel = torch.as_tensor([t_idx[float(t)] for t in time[rows]], device=pred_cube.device)
        if site_axis:
            if key[1] not in topo.sites[i]:
                continue
            pred_vals = pred_cube[:, tsel, i, topo.sites[i].index(key[1])]   # (P, Tc)
        else:
            pred_vals = pred_cube[:, tsel, i]
        obs = torch.as_tensor(np.stack([time[rows], fc[rows]], axis=1),
                              dtype=pred_cube.dtype, device=pred_cube.device)
        obs_list.append(obs)
        pred_list.append(torch.stack([obs[:, 0].expand_as(pred_vals), pred_vals], dim=-1))
    # curves of one length batch as one DP
    by_len: dict = {}
    for ci, o in enumerate(obs_list):
        by_len.setdefault(len(o), []).append(ci)
    for idxs in by_len.values():
        obs_arr = torch.stack([obs_list[ci] for ci in idxs])                 # (C, Tc, 2)
        pred_arr = torch.stack([pred_list[ci] for ci in idxs], dim=1)        # (P, C, Tc, 2)
        d = frechet_distance(obs_arr[None], pred_arr)                        # (P, C)
        total += d.sum(dim=1).to("cpu", torch.float64).numpy()
    return total
