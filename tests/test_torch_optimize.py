"""The port's global fit (``network/optimize.py``) and its host helpers
against the JAX package's, on the CPU at float64.

With host variation (``device_variation=False``) both packages take the
same numpy draws, so the fit's Pareto set and its Fréchet pick must agree
to float64 rounding. The device routes draw from a ``torch.Generator``;
they are checked for their bookkeeping here and against the JAX draws in
``tests/test_torch_nsga.py``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.demo import GRID, RNA_GRID
from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network import bounds as jbounds
from phoskintime_tpu.network import weights as jweights
from phoskintime_tpu.network.optimize import run_global_fit as jax_fit
from phoskintime_tpu.ops.frechet import frechet_distance as jax_frechet
from phoskintime_tpu_torch.demo import build_demo_network
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import bounds, weights
from phoskintime_tpu_torch.network.objective import make_objective, make_population_objective
from phoskintime_tpu_torch.network.optimize import (make_batched_evaluate,
                                                    pick_solution_frechet, run_global_fit)
from phoskintime_tpu_torch.ops.frechet import frechet_distance

torch.set_num_threads(2)

# float64, the same draws and the same ETD2RK steps: rounding only
RTOL_F64 = 1e-9
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")
T_POINTS = (GRID, RNA_GRID, GRID)


@pytest.fixture(scope="module")
def bundles():
    bj = jax_demo(n_proteins=10, n_kinases=4, seed=0, dtype=np.float64)
    return bj, from_reference({k: bj[k] for k in KEYS}, device="cpu")


def fit_args(b):
    return [b[k] for k in KEYS]


def test_run_global_fit_matches_jax(bundles):
    """Pop 16, 3 generations, host variation, the Fréchet pick: the same
    Pareto set, scores and pick as the JAX package's."""
    bj, bt = bundles
    kw = dict(pop=16, n_gen=3, seed=0, device_variation=False, frechet_pick=True,
              df_prot=bj["df_prot"], df_rna=bj["df_rna"], df_pho=bj["df_pho"],
              t_points=T_POINTS)
    want = jax_fit(*fit_args(bj), bj["xl"], bj["xu"], **kw)
    got = run_global_fit(*fit_args(bt), bj["xl"], bj["xu"], **kw)
    assert got.pareto_F.shape == want.pareto_F.shape and got.n_evals == want.n_evals == 64
    np.testing.assert_allclose(got.pareto_F, want.pareto_F, rtol=RTOL_F64)
    np.testing.assert_allclose(got.X, want.X, rtol=RTOL_F64)
    np.testing.assert_allclose(got.frechet_scores, want.frechet_scores, rtol=RTOL_F64)
    assert got.best_idx == want.best_idx
    assert [g for g, _ in got.pop_history] == [1, 2, 3]


def test_pick_reads_column_dicts(bundles):
    """The pick reads pandas DataFrames and the port demo's column dicts
    alike, and matches the JAX package's pick on the same members."""
    bj, bt = bundles
    rng = np.random.default_rng(1)
    X = bj["theta0"][None] + 0.1 * rng.normal(size=(5, len(bj["theta0"])))
    dfs = [bj[k] for k in ("df_prot", "df_rna", "df_pho")]
    cols = [{c: df[c].tolist() for c in df.columns} for df in dfs]
    got = pick_solution_frechet(bt["system"], bt["slices"], X, *dfs, T_POINTS, bt["lambdas"])
    from_cols = pick_solution_frechet(bt["system"], bt["slices"], X, *cols, T_POINTS,
                                      bt["lambdas"])
    assert got[0] == from_cols[0]
    np.testing.assert_array_equal(got[1], from_cols[1])
    from phoskintime_tpu.network.optimize import pick_solution_frechet as jax_pick
    want = jax_pick(bj["system"], bj["slices"], X, *dfs, T_POINTS, bj["lambdas"])
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL_F64)


@pytest.mark.parametrize("route", ["device_variation", "all_device"])
def test_fit_routes_count_evaluations(route):
    """The device routes on CPU tensors: every evaluation counted, through
    one refinement round too; finite Pareto sets; the pick indexes them."""
    b = build_demo_network(n_proteins=6, n_kinases=3, seed=1, dtype=torch.float64,
                           device="cpu")
    kw = dict(gens_per_dispatch=3) if route == "all_device" else {}
    res = run_global_fit(*fit_args(b), b["xl"], b["xu"], pop=16, n_gen=6, seed=0,
                         frechet_pick=True, df_prot=b["df_prot"], df_rna=b["df_rna"],
                         df_pho=b["df_pho"], t_points=(b["grid"],) * 3, refine=True,
                         num_refinements=1, ftol=0.0, **kw)
    # main fit 16 (1 + 6); the refinement round's 10 generations, in blocks
    # of 3 on the all-device route: 16 (1 + 10) or 16 (1 + 12)
    assert res.n_evals == 16 * 7 + 16 * (13 if route == "all_device" else 11)
    assert np.isfinite(res.pareto_F).all() and 0 <= res.best_idx < len(res.pareto_X)
    assert len(res.frechet_scores) == len(res.pareto_X)


def test_fit_solvers_the_port_lacks_raise(bundles):
    """``solver="esdirk"`` (it raised until ported) takes the ESDIRK oracle
    objective with the fit's ``max_steps``: at 5 steps no member reaches
    the last time point, so every evaluation scores ``fail_value``."""
    bj, bt = bundles
    res = run_global_fit(*fit_args(bt), bj["xl"], bj["xu"], pop=4, n_gen=1, seed=0,
                         solver="esdirk", max_steps=5, device_variation=False,
                         frechet_pick=False)
    assert res.n_evals == 8 and np.all(res.F == 1e12)


def test_fit_resumes_from_its_checkpoint(tmp_path):
    b = build_demo_network(n_proteins=6, n_kinases=3, seed=1, dtype=torch.float64,
                           device="cpu")
    kw = dict(pop=12, seed=0, device_variation=False, frechet_pick=False, ftol=0.0)
    full = run_global_fit(*fit_args(b), b["xl"], b["xu"], n_gen=4, **kw)
    path = str(tmp_path / "fit.ckpt")
    run_global_fit(*fit_args(b), b["xl"], b["xu"], n_gen=2, checkpoint_path=path,
                   checkpoint_every=2, **kw)
    resumed = run_global_fit(*fit_args(b), b["xl"], b["xu"], n_gen=4, checkpoint_path=path,
                             checkpoint_every=2, **kw)
    np.testing.assert_array_equal(resumed.X, full.X)
    assert resumed.n_evals == full.n_evals
    assert [g for g, _ in resumed.pop_history] == [3, 4]


@pytest.mark.parametrize("kw, item", [
    (dict(optimizer="optuna"), "item 7"),
    (dict(optimizer="gradient"), "item 4"),
    (dict(polish_steps=5), "item 4"),
    (dict(gn_iters=3), "item 4"),
    (dict(mesh=object()), "item 1b"),
], ids=["optuna", "gradient", "polish", "gn_iters", "mesh"])
def test_routes_not_ported_raise(bundles, kw, item):
    _, bt = bundles
    with pytest.raises(NotImplementedError, match=item):
        run_global_fit(*fit_args(bt), np.zeros(3), np.ones(3), pop=4, n_gen=1, **kw)


def test_batched_evaluate_and_population_flag(bundles):
    bj, bt = bundles
    objective = make_population_objective(*fit_args(bt))
    assert objective._is_population
    assert not getattr(make_objective(*fit_args(bt)), "_is_population", False)
    rng = np.random.default_rng(2)
    X = bj["theta0"][None] + 0.05 * rng.normal(size=(5, len(bj["theta0"])))
    F = make_batched_evaluate(objective)(X)
    assert F.shape == (5, 3) and F.dtype == np.float64
    np.testing.assert_allclose(F, objective(X).numpy(), rtol=1e-12)


@pytest.mark.parametrize("n, m", [(12, 9), (2, 30), (50, 45)], ids=["short", "row", "long"])
def test_frechet_matches_jax(n, m):
    """Both of the JAX package's branches (unrolled for n m <= 2048, the scan
    beyond), batched over solutions x curves as the pick calls it."""
    rng = np.random.default_rng(n * m)
    a = np.cumsum(rng.normal(size=(3, n, 2)), axis=1)
    b = np.cumsum(rng.normal(size=(4, 3, m, 2)), axis=2)
    got = frechet_distance(torch.as_tensor(a)[None], torch.as_tensor(b)).numpy()
    assert got.shape == (4, 3)
    want = np.array([[float(jax_frechet(a[c], b[p, c])) for c in range(3)] for p in range(4)])
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("model", [0, 1, 2, 4])
def test_bio_bounds_match_jax(bundles, model):
    bj, bt = bundles
    dfs = (bj["df_prot"], bj["df_rna"])
    cols = [{c: df[c].to_numpy() for c in df.columns} for df in dfs]
    want = jbounds.calculate_bio_bounds(bj["topo"], *dfs, np.asarray(bj["system"].Kmat), model)
    assert bounds.calculate_bio_bounds(bt["system"].topo, *cols,
                                       bt["system"].Kmat, model) == want
    assert bounds.calculate_bio_bounds(bt["system"].topo, *dfs,
                                       bt["system"].Kmat, model) == want
    empty = pd.DataFrame({"fc": []})
    assert (bounds.calculate_bio_bounds(bt["system"].topo, None, {"fc": []}, bt["system"].Kmat)
            == jbounds.calculate_bio_bounds(bj["topo"], None, empty,
                                            np.asarray(bj["system"].Kmat)))


def test_weight_schemes_match_jax():
    t = np.unique(np.concatenate([GRID, RNA_GRID]))
    got = weights.get_weight_options(GRID, rna_time_points=RNA_GRID)
    want = jweights.get_weight_options(GRID, rna_time_points=RNA_GRID)
    assert sorted(got) == sorted(want) and len(got) == 30
    for name in want:
        np.testing.assert_array_equal(got[name](t), want[name](t), err_msg=name)
    for pair in (("uniform", "uniform"), ("exp_early_mean1", "log_early")):
        g = weights.build_weight_functions(GRID, RNA_GRID, *pair)
        w = jweights.build_weight_functions(GRID, RNA_GRID, *pair)
        for gf, wf in zip(g, w):
            np.testing.assert_array_equal(gf(t), wf(t))
    with pytest.raises(KeyError):
        weights.build_weight_functions(GRID, RNA_GRID, "nope")
