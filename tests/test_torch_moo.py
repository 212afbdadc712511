"""The port's multi-objective families and indicators against the JAX
package's, on the CPU in float64: NSGA-II, SMS-EMOA, AGE-MOEA and DE on
the host (numpy on both sides, the same ``default_rng`` draws, the same
evaluate: equal results), the exact 3-objective hypervolume and its
contributions (numpy and native), the device NSGA-II survival and
crowding, the all-device NSGA-II loop, the quality indicators and Sobol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.ops import indicators as jind
from phoskintime_tpu.ops import nsga as jnsga
from phoskintime_tpu.ops import nsga_device as jdev
from phoskintime_tpu.ops import sobol as jsobol
from phoskintime_tpu_torch import native
from phoskintime_tpu_torch.ops import indicators, nsga, sobol
from phoskintime_tpu_torch.ops.nsga_device import (device_crowding, device_nd_ranks,
                                                   device_nsga2_survival, run_nsga2_device)

torch.set_num_threads(2)

EXACT = dict(rtol=1e-12, atol=1e-15)


def dtlz2_np(X):
    """DTLZ2 (m = 3): ideal point 0, Pareto front on the unit sphere."""
    X = np.asarray(X, float)
    g = np.sum((X[:, 2:] - 0.5) ** 2, axis=1)
    a, b = X[:, 0] * (np.pi / 2), X[:, 1] * (np.pi / 2)
    return np.stack([(1 + g) * np.cos(a) * np.cos(b), (1 + g) * np.cos(a) * np.sin(b),
                     (1 + g) * np.sin(a)], axis=1)


def dtlz2_torch(X):
    g = torch.sum((X[:, 2:] - 0.5) ** 2, dim=1)
    a, b = X[:, 0] * (np.pi / 2), X[:, 1] * (np.pi / 2)
    return torch.stack([(1 + g) * torch.cos(a) * torch.cos(b),
                        (1 + g) * torch.cos(a) * torch.sin(b), (1 + g) * torch.sin(a)], dim=1)


def sphere_np(X):
    return np.sum((np.asarray(X) - 0.3) ** 2, axis=1)


def box_repair(X):
    """A deterministic repair: rows pushed onto sum(x) = d / 2."""
    X = np.asarray(X, float)
    return X - (X.sum(1, keepdims=True) - X.shape[1] / 2) / X.shape[1]


RUNS = {
    "nsga2": lambda m: m.run_nsga2(dtlz2_np, np.zeros(6), np.ones(6), pop_size=24, n_gen=12,
                                   seed=3),
    "nsga2_repair_x0": lambda m: m.run_nsga2(
        dtlz2_np, np.zeros(6), np.ones(6), pop_size=16, n_gen=6, seed=4,
        x0=np.random.default_rng(0).random((16, 6)), repair_fn=box_repair,
        constraint_fn=lambda X: X[:, :1] - 0.9),
    "smsemoa": lambda m: m.run_smsemoa(dtlz2_np, np.zeros(6), np.ones(6), pop_size=20,
                                       n_gen=10, seed=5),
    "smsemoa_steady": lambda m: m.run_smsemoa(dtlz2_np, np.zeros(6), np.ones(6), pop_size=12,
                                              n_gen=30, n_offsprings=1, seed=6),
    "agemoea": lambda m: m.run_agemoea(dtlz2_np, np.zeros(6), np.ones(6), pop_size=24,
                                       n_gen=12, seed=7),
    "de": lambda m: m.run_de(sphere_np, -np.ones(5), np.ones(5), pop_size=20, n_gen=15,
                             seed=8),
    "de_repair": lambda m: m.run_de(sphere_np, -np.ones(4), np.ones(4), pop_size=12, n_gen=8,
                                    seed=9, repair_fn=box_repair,
                                    constraint_fn=lambda X: X[:, :1] - 0.5),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_host_family_matches_jax(name):
    """The same seed and evaluate through both packages: X, F, the Pareto
    set, the history and the counts equal."""
    got, want = RUNS[name](nsga), RUNS[name](jnsga)
    for k in ("X", "F", "pareto_X", "pareto_F"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), **EXACT, err_msg=k)
    assert (got.n_gen, got.n_evals) == (want.n_gen, want.n_evals)
    for g, w in zip(got.history, want.history):
        assert g[0] == w[0]
        np.testing.assert_allclose(np.asarray(g[1:], float), np.asarray(w[1:], float), **EXACT)


def front_objectives(seed, n=40):
    """Points near the simplex (mostly mutually non-dominated), a few
    dominated ones, and one outside the reference box."""
    rng = np.random.default_rng(seed)
    F = rng.dirichlet(np.ones(3), n) + 0.05 * rng.random((n, 3))
    return np.vstack([F, F[:4] + 0.2, [[2.0, 0.1, 0.1]]])


@pytest.mark.parametrize("seed", [0, 1])
def test_hypervolume_family_matches_jax(seed):
    F = front_objectives(seed)
    ref = np.full(3, 1.2)
    assert nsga.hv3d(F, ref) == pytest.approx(jnsga.hv3d(F, ref), rel=1e-13)
    np.testing.assert_allclose(nsga.hv_contributions_3d(F, ref),
                               jnsga.hv_contributions_3d(F, ref), **EXACT)
    assert nsga._staircase_area(F[:, :2], 1.2, 1.2) == jnsga._staircase_area(F[:, :2], 1.2, 1.2)
    members = np.arange(0, len(F), 2)
    assert nsga._least_hv_truncate(F, members, ref, 9) == \
        jnsga._least_hv_truncate(F, members, ref, 9)
    assert nsga.hv3d(F, ref) == pytest.approx(indicators.hypervolume(F, ref), rel=1e-10)


def test_survivals_match_jax():
    rng = np.random.default_rng(2)
    X = rng.random((60, 4))
    F = np.vstack([front_objectives(3), rng.random((15, 3))])[:60]
    for got, want in zip(nsga.nsga2_survival(X, F, 25), jnsga.nsga2_survival(X, F, 25)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(nsga._agemoea_survival(X, F, 25), jnsga._agemoea_survival(X, F, 25)):
        np.testing.assert_array_equal(got, want)


def test_native_entries_equal_numpy():
    """The port's native crowding and hypervolume contributions against its
    numpy paths (the native library is built with g++ on first use)."""
    if native.get_lib() is None:
        pytest.skip("no C++ compiler: the numpy paths are the only ones")
    F = front_objectives(4)
    idx = np.arange(5, 35)
    want = nsga.crowding_distance(F[idx])
    np.testing.assert_allclose(native.crowding_native(F, idx),
                               np.where(np.isinf(want), 1e300, want), rtol=1e-14)
    ref = np.full(3, 1.3)
    total = nsga.hv3d(F, ref)
    loo = np.array([total - nsga.hv3d(np.delete(F, i, 0), ref) for i in range(len(F))])
    np.testing.assert_allclose(native.hv3d_contrib_native(F, ref), loo, rtol=0, atol=1e-13)
    for i in (0, 7, len(F) - 1):
        assert native.hv3d_one_contrib_native(F, i, ref) == pytest.approx(loo[i], abs=1e-13)
    with pytest.raises(ValueError):
        native.hv3d_contrib_native(F[:, :2], ref)


def test_device_crowding_equals_host_per_front():
    F = np.vstack([front_objectives(5), np.random.default_rng(6).random((20, 3))])
    rank = device_nd_ranks(torch.as_tensor(F))
    got = device_crowding(torch.as_tensor(F), rank).numpy()
    fronts = nsga.fast_non_dominated_sort(F)
    assert len(fronts) > 2 and min(len(f) for f in fronts) <= 2
    for fr in fronts:
        np.testing.assert_allclose(got[fr], nsga.crowding_distance(F[fr]), **EXACT)
    np.testing.assert_allclose(got, np.asarray(jdev.device_crowding(
        jnp.asarray(F), jnp.asarray(rank.numpy()))), **EXACT)


@pytest.mark.parametrize("n_survive", [30, 50])
def test_device_nsga2_survival_matches_jax(n_survive):
    """Tie-free objectives: the same survivors in the same order as JAX's,
    and the same set as the host survival."""
    rng = np.random.default_rng(7)
    F = rng.random((64, 3))
    X = rng.random((64, 5))
    got = device_nsga2_survival(torch.as_tensor(X), torch.as_tensor(F), n_survive)
    want = jdev.device_nsga2_survival(jnp.asarray(X), jnp.asarray(F), n_survive)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EXACT)
    Xh, _ = nsga.nsga2_survival(X, F, n_survive)
    assert {tuple(r) for r in Xh} == {tuple(r) for r in got[0].numpy()}


def test_device_nsga2_loop_on_dtlz2():
    """The all-device NSGA-II converges toward the DTLZ2 front, in whole
    blocks, with a constraint and a repair on the device; mesh raises."""
    res = run_nsga2_device(dtlz2_torch, np.zeros(6), np.ones(6), pop_size=32, n_gen=25,
                           seed=1, gens_per_block=10, device="cpu",
                           constraint_fn=lambda X: X[:, :1] - 0.95,
                           repair_fn=lambda X: torch.clamp(X, 0.0, 1.0))
    assert res.n_gen == 30 and len(res.history) == 30 and res.n_evals == 32 * 31
    ideals = np.array([h[1] for h in res.history])
    assert np.all(np.diff(ideals, axis=0) <= 1e-12)          # elitist: the ideal never rises
    r = np.linalg.norm(res.pareto_F, axis=1)
    assert r.min() < 1.2 and np.isfinite(res.F).all()
    with pytest.raises(NotImplementedError, match="1b"):
        run_nsga2_device(dtlz2_torch, np.zeros(3), np.ones(3), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_nsga2_device(dtlz2_torch, np.zeros(3), np.ones(3), pop_size=8, n_gen=1)


# --- indicators and Sobol -------------------------------------------------------------


def test_indicators_match_jax():
    rng = np.random.default_rng(8)
    F = rng.random((30, 3))
    Z = rng.random((12, 3))
    ref = np.full(3, 1.1)
    assert indicators.hypervolume(F, ref) == jind.hypervolume(F, ref)
    assert indicators.hypervolume(F[:, :2], ref[:2]) == jind.hypervolume(F[:, :2], ref[:2])
    assert indicators.igd_plus(F, Z) == jind.igd_plus(F, Z)
    w = np.array([0.2, 0.5, 0.3])
    assert indicators.asf_pick(F, w) == jind.asf_pick(F, w)
    np.testing.assert_array_equal(indicators.pseudo_weights(F), jind.pseudo_weights(F))
    assert indicators.pseudo_weight_pick(F, w) == jind.pseudo_weight_pick(F, w)
    hist = [(g, rng.random((5, 3))) for g in range(4)]
    assert indicators.convergence_history(hist) == jind.convergence_history(hist)
    assert indicators.convergence_history([]) == []


def test_sobol_matches_jax():
    """The Saltelli design, the indices with their bootstrap, and
    ``temporal_sobol`` with an evaluate that returns a tensor."""
    bounds = np.array([[0.0, 1.0], [-1.0, 2.0], [0.5, 0.7]])
    X = sobol.saltelli_sample(bounds, 64, seed=3)
    np.testing.assert_array_equal(X, jsobol.saltelli_sample(bounds, 64, seed=3))
    Y = X[:, 0] + 2 * X[:, 1] * X[:, 2]
    for g, w in zip(sobol.sobol_analyze(3, Y, n_boot=20), jsobol.sobol_analyze(3, Y, n_boot=20)):
        np.testing.assert_array_equal(g, w)

    def evaluate(Xs):
        t = np.linspace(0, 1, 5)[None, :]
        return Xs[:, :1] * (1 - t) + Xs[:, 1:2] * t * Xs[:, 2:3]

    got = sobol.temporal_sobol(lambda Xs: torch.as_tensor(evaluate(Xs)), bounds, n_base=32)
    want = jsobol.temporal_sobol(evaluate, bounds, n_base=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **EXACT)
