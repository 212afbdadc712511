"""Hyperparameter scan: an outer search over the loss-weight lambdas.

Counterpart of ``phoskintime_tpu/network/scan.py``: the MOTPE sampler
(:mod:`phoskintime_tpu_torch.ops.tpe`) proposes (lambda_protein,
lambda_rna, lambda_phospho, lambda_prior) in log10 space; each trial runs
a short U-NSGA-III inner fit at those lambdas, reports the best summed
score of its population every ``gen_step`` generations and is stopped
(pruned) where that report exceeds ``prune_factor`` times the median of
the earlier completed trials' reports at the same generation (Optuna's
MedianPruner rule). A trial's score is the least summed objective of its
final Pareto set. Completed trials and the sampler persist to a JSON file
and a pickle beside it, so that a scan can be stopped and resumed.

Two inner solvers, as in the JAX package: ``"expo"`` (the default), the
population objective through the all-device GA loop
(:func:`~phoskintime_tpu_torch.ops.nsga_device.run_unsga3_device`, one
block of ``gen_step`` generations between reports, on the system's device:
the table kernel on the card); ``"rk45"``, the RK45 objective through the
host GA loop (:func:`~phoskintime_tpu_torch.ops.nsga.run_unsga3`).

``out_dir`` writes the per-trial results table and its three plots (the
history, the lambdas' importance, the parallel coordinates:
:func:`scan_report`). A ``mesh``
(:class:`~phoskintime_tpu_torch.parallel.mesh.PopulationMesh`) shards each
inner fit's evaluations (and the all-device loop's ranking) over its ranks;
every rank runs the same scan and returns the same trials, and only rank 0
writes the state, the report and the log.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from phoskintime_tpu_torch.io.export import TableWriter, rows_to_table
from phoskintime_tpu_torch.network.objective import make_objective, make_population_objective
from phoskintime_tpu_torch.network.optimize import make_batched_evaluate
from phoskintime_tpu_torch.ops.nsga import run_unsga3
from phoskintime_tpu_torch.ops.nsga_device import run_unsga3_device
from phoskintime_tpu_torch.ops.tpe import MOTPESampler
from phoskintime_tpu_torch.parallel.mesh import is_writer
from phoskintime_tpu_torch.parallel.checkpoint import load_sampler, save_sampler

KEYS = ("protein", "rna", "phospho", "prior")


@dataclass
class ScanTrial:
    """One outer-loop trial; it also unpacks as ``(lambdas, score)``."""

    lambdas: dict
    score: float
    state: str = "complete"            # complete | pruned
    components: tuple | None = None    # the three objectives of the best member
    intermediate: list = field(default_factory=list)  # [(gen, score), ...]
    n_gen: int = 0

    def __iter__(self):
        return iter((self.lambdas, self.score))


def _weighted_score(F: np.ndarray) -> tuple[float, int]:
    """The least row sum of F and its row. The objective has already
    weighted each component by its lambda, so the score sums them as
    they are."""
    s = F.sum(axis=1)
    i = int(np.argmin(s))
    return float(s[i]), i


def _save_state(path, trials, sampler) -> None:
    state = [{"lambdas": t.lambdas, "score": t.score, "state": t.state,
              "components": t.components, "intermediate": t.intermediate,
              "n_gen": t.n_gen} for t in trials]
    with open(path, "w") as fh:
        json.dump(state, fh)
    save_sampler(path + ".sampler", sampler)


def _load_state(path, sampler) -> list[ScanTrial]:
    """The trials stored at ``path`` (none where there is no file), the
    sampler's state loaded from its pickle beside it."""
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        state = json.load(fh)
    load_sampler(path + ".sampler", sampler)
    return [ScanTrial(t["lambdas"], t["score"], t["state"],
                      tuple(t["components"]) if t["components"] else None,
                      [tuple(x) for x in t["intermediate"]], t["n_gen"])
            for t in state]


def scan_report(trials: list[ScanTrial], out_dir: str) -> dict:
    """The scan's results table ``scan_results.xlsx`` (sheet Trials, as
    ``scan_results_trials.csv``): a row a trial with its state, score,
    generations, lambdas and the three objectives of its best member; and
    its plots: ``optimization_history.png`` (each trial's score, pruned in
    red, the running best of the completed), ``param_importance.png``
    (|Spearman r| of each log10 lambda with the score over the completed
    trials, from 3 of them) and ``parallel_coordinates.png`` (the
    completed trials' log10 lambdas and score scaled to [0, 1], the best
    in green, from 2). Returns {"table", "history"[, "importance",
    "parallel"]: paths}."""
    from scipy.stats import rankdata

    from phoskintime_tpu_torch.report.draw import subplots

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i, t in enumerate(trials):
        row = {"trial": i, "state": t.state, "score": t.score, "n_gen": t.n_gen}
        row.update({f"lambda_{k}": t.lambdas[k] for k in KEYS})
        if t.components is not None:
            row.update({"mse_prot": t.components[0], "mse_rna": t.components[1],
                        "mse_phos": t.components[2]})
        rows.append(row)
    w = TableWriter(os.path.join(out_dir, "scan_results.xlsx"))
    w.add("Trials", rows_to_table(rows))
    paths = {"table": w.save()}

    def save(fig, key, name):
        fig.tight_layout()
        paths[key] = os.path.join(out_dir, name)
        fig.savefig(paths[key], dpi=150)

    score = np.asarray([t.score for t in trials], float)
    done = np.asarray([t.state == "complete" for t in trials], bool)
    idx = np.arange(len(trials))
    fig, ax = subplots(figsize=(7, 4))
    ax.scatter(idx, score, c=["tab:red" if t.state == "pruned" else "tab:blue" for t in trials],
               s=28, label="trial")
    if done.any():
        ax.plot(idx[done], np.minimum.accumulate(score[done]), color="tab:green",
                label="best so far")
    ax.set_xlabel("trial")
    ax.set_ylabel("weighted score")
    ax.set_yscale("log")
    ax.legend()
    save(fig, "history", "optimization_history.png")

    lams = {k: np.asarray([t.lambdas[k] for t in trials], float)[done] for k in KEYS}
    if done.sum() >= 3:
        imp = {}
        ranks_s = rankdata(score[done])
        for k in KEYS:
            c = np.corrcoef(rankdata(np.log10(lams[k])), ranks_s)[0, 1]
            imp[k] = abs(float(c)) if np.isfinite(c) else 0.0
        fig, ax = subplots(figsize=(6, 3.5))
        ks = sorted(imp, key=imp.get)
        ax.barh(ks, [imp[k] for k in ks], color="tab:blue")
        ax.set_xlabel("|Spearman corr| with score")
        ax.set_title("Hyperparameter importance")
        save(fig, "importance", "param_importance.png")

    if done.sum() >= 2:
        M = np.column_stack([np.log10(lams[k]) for k in KEYS] + [np.log10(score[done])])
        lo, hi = M.min(axis=0), M.max(axis=0)
        Mn = (M - lo) / np.maximum(hi - lo, 1e-12)
        best_i = int(score[done].argmin())
        fig, ax = subplots(figsize=(7, 4))
        for r in range(len(Mn)):
            ax.plot(range(M.shape[1]), Mn[r], color="tab:green" if r == best_i else "tab:blue",
                    alpha=1.0 if r == best_i else 0.35, lw=2.0 if r == best_i else 1.0)
        ax.set_xticks(range(M.shape[1]))
        ax.set_xticklabels(list(KEYS) + ["score"], rotation=20)
        ax.set_ylabel("normalized log10")
        save(fig, "parallel", "parallel_coordinates.png")
    return paths


def run_hyperparameter_scan(system, slices, loss_data, defaults, time_grid,
                            xl, xu, *, n_outer=20, inner_gens=15,
                            inner_pop=64, seed=42, loss_mode=0, mesh=None,
                            lambda_ranges=None, logger=None,
                            gen_step=5, n_startup_prune=3,
                            prune_factor=1.0, out_dir=None,
                            checkpoint_path=None, solver="expo"):
    """The nested scan on the system's device and dtype. Returns
    (best_lambdas, trials): the lambdas of the best completed trial (of
    any trial where none completed) and every :class:`ScanTrial`.

    Trial ``it`` runs its inner GA with seed ``seed + it``. After
    ``n_startup_prune`` completed trials, a report above ``prune_factor``
    times the median of the completed trials' reports at its generation
    stops the trial; a pruned trial tells the sampler its last score.
    ``checkpoint_path``: a JSON file of the trials (the sampler in
    ``checkpoint_path + ".sampler"``), written after every trial; a scan
    started where it exists continues from its trials to ``n_outer``.
    ``out_dir``: the results table there (:func:`scan_report`). ``mesh``:
    see the module docstring (``inner_pop`` a multiple of it on the
    ``"expo"`` route)."""
    writer = is_writer(mesh)
    if not writer:
        logger = None
    if lambda_ranges is None:
        lambda_ranges = {"protein": (0.1, 10.0), "rna": (0.1, 10.0),
                         "phospho": (0.1, 10.0), "prior": (0.01, 1.0)}
    keys = list(lambda_ranges)
    lo = np.log10([lambda_ranges[k][0] for k in keys])
    hi = np.log10([lambda_ranges[k][1] for k in keys])
    sampler = MOTPESampler(lo, hi, seed=seed, n_startup_trials=max(5, n_outer // 4))
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.rhs.Kmat.device)

    trials: list[ScanTrial] = []
    if checkpoint_path:
        os.makedirs(os.path.dirname(checkpoint_path) or ".", exist_ok=True)
        trials = _load_state(checkpoint_path, sampler)
        if trials and logger is not None:
            logger.info(f"[Scan] resumed {len(trials)} trials from {checkpoint_path}")

    def reports_at(step):
        return [s for t in trials if t.state == "complete"
                for g, s in t.intermediate if g == step]

    args = (system, slices, loss_data, defaults)
    for it in range(len(trials), n_outer):
        x = sampler.ask()
        lambdas = {k: float(10 ** v) for k, v in zip(keys, x)}
        trial = ScanTrial(lambdas, np.inf, "complete")

        def report(gen, X, F, _t=trial):
            if gen % gen_step:
                return False
            s, _ = _weighted_score(F)
            _t.intermediate.append((gen, s))
            _t.n_gen = gen
            prev = reports_at(gen)
            n_done = sum(t.state == "complete" for t in trials)
            if n_done >= n_startup_prune and prev and s > prune_factor * float(np.median(prev)):
                _t.state = "pruned"
                return True  # stop the inner GA now
            return False

        inner = dict(pop_size=inner_pop, n_gen=inner_gens, seed=seed + it, ftol=0.0,
                     n_max_evals=None, callback=report)
        if solver == "expo":
            objective = make_population_objective(*args, lambdas, time_grid,
                                                  loss_mode=loss_mode)
            res = run_unsga3_device(objective, xl, xu, gens_per_block=gen_step, mesh=mesh, **f,
                                    **inner)
        else:
            objective = make_objective(*args, lambdas, time_grid, loss_mode=loss_mode)
            res = run_unsga3(make_batched_evaluate(objective, mesh=mesh), xl, xu, **inner)
        trial.n_gen = res.n_gen
        trial.score, bi = _weighted_score(res.pareto_F)
        trial.components = tuple(float(v) for v in res.pareto_F[bi])
        # a pruned trial tells its partial score, as Optuna records a
        # pruned trial's last reported value
        sampler.tell(x, np.asarray([trial.score]))
        trials.append(trial)
        if checkpoint_path and writer:
            _save_state(checkpoint_path, trials, sampler)
        if logger is not None:
            logger.info(f"[Scan] trial {it}: {lambdas} -> {trial.score:.4g}"
                        + (" (pruned)" if trial.state == "pruned" else ""))

    done = [t for t in trials if t.state == "complete"] or trials
    best = min(done, key=lambda t: t.score)
    if out_dir and writer:
        scan_report(trials, out_dir)
    return best.lambdas, trials
