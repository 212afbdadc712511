"""The port's MOTPE fit (``run_global_fit(optimizer="optuna")``) and
hyperparameter scan (``network/scan.py``) against the JAX package's, on
the CPU at float64.

The scan's GA is chaotic in its objective's rounding: two objectives
that agree to 1e-12 can take different survivors a few generations on,
and from there different trials (the port's host GA is identical to JAX's
on identical F). So the scan's bookkeeping is held to JAX's bit for bit
with JAX's own objective inside the port's scan, the port's objective to
JAX's at each trial's lambdas, and the whole RK45 scan to JAX's on
``tests/test_coverage_gaps.py``'s tiny network (slow: ~2 minutes, the
port's RK45 is launch-bound on the CPU).
"""

import numpy as np
import pytest
import torch

from phoskintime_tpu.network import init_raw_params as jax_init_raw_params
from phoskintime_tpu.network.objective import make_objective as jax_make_objective
from phoskintime_tpu.network.objective import (
    make_population_objective as jax_make_population_objective)
from phoskintime_tpu.network.optimize import make_batched_evaluate as jax_batched
from phoskintime_tpu.network.optimize import run_global_fit as jax_fit
from phoskintime_tpu.network.scan import _weighted_score as jax_weighted_score
from phoskintime_tpu.network.scan import run_hyperparameter_scan as jax_scan
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import scan
from phoskintime_tpu_torch.network.objective import make_objective, make_population_objective
from phoskintime_tpu_torch.network.optimize import run_global_fit
from phoskintime_tpu_torch.network.scan import ScanTrial, _weighted_score, run_hyperparameter_scan
from test_coverage_gaps import tiny  # noqa: F401  (the module-scoped fixture)
from test_torch_optimize import T_POINTS, bundles, fit_args  # noqa: F401

torch.set_num_threads(2)

RTOL_F64 = 1e-9
BOUNDS = {k: (1e-3, 4.0) for k in ("c_k", "A_i", "B_i", "C_i", "D_i", "Dp_i", "E_i",
                                   "tf_scale")}
# tests/test_coverage_gaps.py:450-481's scan, the rk45 route at its sizes
SCAN_KW = dict(n_outer=4, inner_gens=6, inner_pop=12, seed=0, gen_step=2, n_startup_prune=2,
               prune_factor=0.0)


@pytest.fixture(scope="module")
def problem(tiny):  # noqa: F811
    """(JAX args, port args): system, slices, loss data, defaults, grid,
    xl, xu of the tiny network."""
    sys_, topo, dfp, dfr, dfph, ld, grid = tiny
    from phoskintime_tpu.network import default_params

    defaults = default_params(topo)
    _, slices, xl, xu = jax_init_raw_params(defaults, topo, BOUNDS)
    jargs = (sys_, slices, ld, defaults, grid, xl, xu)
    targs = (from_reference(sys_, device="cpu"), slices, from_reference(ld),
             from_reference(defaults), grid, xl, xu)
    return jargs, targs


def assert_same_trials(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.lambdas == w.lambdas and g.state == w.state and g.n_gen == w.n_gen
        assert [s for s, _ in g.intermediate] == [s for s, _ in w.intermediate]
        if exact:
            assert g.score == w.score and g.components == w.components
            assert g.intermediate == w.intermediate
        else:
            np.testing.assert_allclose(g.score, w.score, rtol=RTOL_F64)
            np.testing.assert_allclose(g.components, w.components, rtol=RTOL_F64)
            np.testing.assert_allclose([v for _, v in g.intermediate],
                                       [v for _, v in w.intermediate], rtol=RTOL_F64)


@pytest.mark.parametrize("F", [
    [[3.0, 1.0, 1.0], [1.0, 1.0, 1.0], [2.0, 2.0, 5.0]],
    [[0.5, 0.5, 0.5]],
    [[1.0, 2.0, 3.0], [3.0, 2.0, 1.0], [2.0, 2.0, 2.5]],
    [[1e12, 1e12, 1e12], [7.0, 1e-3, 2.0]],
])
def test_weighted_score_matches_jax(F):
    F = np.asarray(F)
    assert _weighted_score(F) == jax_weighted_score(F)


def test_scan_trial_unpacks():
    t = ScanTrial({"protein": 1.0}, 2.5)
    lams, score = t
    assert lams == {"protein": 1.0} and score == 2.5 and t.state == "complete"


# ---------------------------------------------------------------------------
# MOTPE in the global fit
# ---------------------------------------------------------------------------

def test_run_global_fit_optuna_matches_jax(bundles):  # noqa: F811
    """48 trials (one uniform batch, two of TPE) on the N = 10 demo: the
    same trials (X bit for bit), F within 1e-9, the same Pareto set and
    Fréchet pick."""
    bj, bt = bundles
    kw = dict(optimizer="optuna", n_trials=48, seed=0, frechet_pick=True,
              df_prot=bj["df_prot"], df_rna=bj["df_rna"], df_pho=bj["df_pho"],
              t_points=T_POINTS)
    want = jax_fit(*fit_args(bj), bj["xl"], bj["xu"], **kw)
    got = run_global_fit(*fit_args(bt), bj["xl"], bj["xu"], **kw)
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_allclose(got.F, want.F, rtol=RTOL_F64)
    np.testing.assert_array_equal(got.pareto_X, want.pareto_X)
    np.testing.assert_allclose(got.pareto_F, want.pareto_F, rtol=RTOL_F64)
    assert got.n_evals == want.n_evals == 48 and got.history == [] and got.pop_history == []
    assert got.best_idx == want.best_idx
    np.testing.assert_allclose(got.frechet_scores, want.frechet_scores, rtol=RTOL_F64)


def test_optuna_checkpoint_resumes(bundles, tmp_path):  # noqa: F811
    """A 48-trial run stored every batch, then continued to 64 from its
    ``.tpe`` file, equals one uninterrupted 64-trial run."""
    bj, bt = bundles
    kw = dict(optimizer="optuna", seed=1, frechet_pick=False)
    ck = str(tmp_path / "fit.ckpt")
    first = run_global_fit(*fit_args(bt), bj["xl"], bj["xu"], n_trials=48,
                           checkpoint_path=ck, checkpoint_every=1, **kw)
    assert (tmp_path / "fit.ckpt.tpe").exists() and len(first.X) == 48
    resumed = run_global_fit(*fit_args(bt), bj["xl"], bj["xu"], n_trials=64,
                             checkpoint_path=ck, checkpoint_every=1, **kw)
    straight = run_global_fit(*fit_args(bt), bj["xl"], bj["xu"], n_trials=64, **kw)
    np.testing.assert_array_equal(resumed.X, straight.X)
    np.testing.assert_array_equal(resumed.F, straight.F)
    np.testing.assert_array_equal(resumed.X[:48], first.X)


# ---------------------------------------------------------------------------
# the scan, rk45 route
# ---------------------------------------------------------------------------

def jax_objective_in_port(monkeypatch, jargs):
    """Run the port's scan on JAX's RK45 objective: the port's sampler,
    pruning and host GA around the same F as JAX's scan sees."""
    sys_, slices, ld, defaults, grid = jargs[:5]

    def objective(system, slices_, loss_data, defaults_, lambdas, time_grid, loss_mode=0):
        evaluate = jax_batched(jax_make_objective(sys_, slices, ld, defaults, lambdas, grid,
                                                  loss_mode=loss_mode))
        return lambda X: np.array(evaluate(X))
    monkeypatch.setattr(scan, "make_objective", objective)


def test_rk45_scan_bookkeeping_matches_jax(problem, monkeypatch):
    """The port's scan around JAX's objective: every trial's lambdas,
    state, generations, reports and score equal to JAX's scan, bit for bit
    (two trials pruned at their first report: prune_factor 0)."""
    jargs, targs = problem
    best_j, want = jax_scan(*jargs, solver="rk45", **SCAN_KW)
    jax_objective_in_port(monkeypatch, jargs)
    best_t, got = run_hyperparameter_scan(*targs, solver="rk45", **SCAN_KW)
    assert_same_trials(got, want, exact=True)
    assert best_t == best_j
    assert [t.state for t in got] == ["complete", "complete", "pruned", "pruned"]


@pytest.mark.parametrize("seed", [0, 1])
def test_rk45_objective_at_scan_lambdas_matches_jax(problem, seed):
    """The port's RK45 objective against JAX's at lambdas drawn from the
    scan's ranges, on three seeded members."""
    jargs, targs = problem
    rng = np.random.default_rng(seed)
    lambdas = {k: float(10 ** rng.uniform(lo, hi)) for k, lo, hi in
               (("protein", -1, 1), ("rna", -1, 1), ("phospho", -1, 1), ("prior", -2, 0))}
    X = rng.uniform(jargs[5], jargs[6], (3, len(jargs[5])))
    want = jax_batched(jax_make_objective(*jargs[:4], lambdas, jargs[4]))(X)
    got = make_objective(*targs[:4], lambdas, targs[4])(torch.as_tensor(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_F64)


@pytest.mark.slow
def test_rk45_scan_matches_jax(problem):
    """The whole RK45 scan, the port's objective against JAX's: the same
    lambdas, states, generations and reports, scores within 1e-9."""
    jargs, targs = problem
    best_j, want = jax_scan(*jargs, solver="rk45", **SCAN_KW)
    best_t, got = run_hyperparameter_scan(*targs, solver="rk45", **SCAN_KW)
    assert_same_trials(got, want)
    assert best_t == best_j


# ---------------------------------------------------------------------------
# the scan, expo route (the device loop; the CPU here)
# ---------------------------------------------------------------------------

def test_expo_scan_pruning_bookkeeping(problem):
    """tests/test_coverage_gaps.py:450-481's checks: pruned trials stopped
    early, every trial has reports, completed ones their components, the
    best from the completed."""
    _, targs = problem
    best, trials = run_hyperparameter_scan(*targs, **SCAN_KW)
    assert [t.state for t in trials].count("pruned") >= 1
    pruned = [t for t in trials if t.state == "pruned"]
    assert all(t.n_gen < 6 and len(t.intermediate) == 1 for t in pruned)
    assert all(t.intermediate for t in trials)
    done = [t for t in trials if t.state == "complete"]
    assert all(t.components is not None and len(t.components) == 3 for t in done)
    assert all(t.n_gen == 6 and [g for g, _ in t.intermediate] == [2, 4, 6] for t in done)
    assert best in [t.lambdas for t in done]
    assert best == min(done, key=lambda t: t.score).lambdas
    for lams, score in trials:
        assert set(lams) == {"protein", "rna", "phospho", "prior"}
        assert np.isfinite(score)
        for k, (lo, hi) in {"protein": (0.1, 10.0), "prior": (0.01, 1.0)}.items():
            assert lo <= lams[k] <= hi


def test_expo_scan_resume_equals_uninterrupted(problem, tmp_path):
    """Two trials stored, then resumed to four: the same four trials as one
    uninterrupted scan, and the stored ones unchanged."""
    _, targs = problem
    ck = str(tmp_path / "scan" / "scan_state.json")
    _, t1 = run_hyperparameter_scan(*targs, checkpoint_path=ck, **dict(SCAN_KW, n_outer=2))
    assert len(t1) == 2 and (tmp_path / "scan" / "scan_state.json.sampler").exists()
    _, t2 = run_hyperparameter_scan(*targs, checkpoint_path=ck, **SCAN_KW)
    _, straight = run_hyperparameter_scan(*targs, **SCAN_KW)
    assert_same_trials(t2, straight, exact=True)
    assert_same_trials(t2[:2], t1, exact=True)


def test_expo_scan_objective_matches_jax(problem):
    """The population objective of each trial's lambdas against JAX's, on
    eight seeded members."""
    jargs, targs = problem
    _, trials = run_hyperparameter_scan(*targs, **SCAN_KW)
    X = np.random.default_rng(1).uniform(jargs[5], jargs[6], (8, len(jargs[5])))
    for t in trials:
        want = np.asarray(jax_make_population_objective(*jargs[:4], t.lambdas, jargs[4])(X))
        got = make_population_objective(*targs[:4], t.lambdas, targs[4])(torch.as_tensor(X))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_F64)

