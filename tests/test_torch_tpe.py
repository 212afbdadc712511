"""The port's MOTPE sampler (``ops/tpe.py``) and its checkpoint against
the JAX package's, on the CPU: the same seed and the same told history
give the same asks, bit for bit."""

import numpy as np
import pytest

from phoskintime_tpu.ops import tpe as jtpe
from phoskintime_tpu.parallel import checkpoint as jck
from phoskintime_tpu_torch.ops import tpe
from phoskintime_tpu_torch.parallel import checkpoint


def two_objectives(X):
    """tests/test_optimize.py's MOTPE problem: distances to 0.2 and 0.8."""
    X = np.atleast_2d(X)
    return np.stack([((X - 0.2) ** 2).sum(axis=1), ((X - 0.8) ** 2).sum(axis=1)], axis=1)


@pytest.mark.parametrize("n, low, high", [(0, 0.0, 1.0), (1, 0.0, 1.0), (2, -1.0, 3.0),
                                          (7, 0.0, 1.0), (40, -2.0, -1.0), (150, 0.0, 1e-3)])
def test_parzen_estimator_matches_jax(n, low, high):
    rng = np.random.default_rng(n)
    samples = rng.uniform(low, high, n)
    want = jtpe.ParzenEstimator1D(samples, low, high)
    got = tpe.ParzenEstimator1D(samples, low, high)
    np.testing.assert_array_equal(got.mus, want.mus)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.weights, want.weights)
    x = rng.uniform(low - 0.1, high + 0.1, 64)
    np.testing.assert_allclose(got.log_pdf(x), want.log_pdf(x), rtol=1e-14)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(got.sample(a, 24), want.sample(b, 24))


@pytest.mark.parametrize("dim, n_told, n_obj", [(3, 0, 2), (3, 5, 2), (3, 11, 2), (4, 30, 3),
                                                (6, 80, 1)])
def test_asks_match_jax_bit_for_bit(dim, n_told, n_obj):
    """A told history on either side of n_startup_trials (11): every ask of
    two batches equals the JAX sampler's, which rebuilds its estimators
    for each ask where the port builds them once a batch."""
    rng = np.random.default_rng(dim + n_told)
    xl, xu = -np.ones(dim), 2.0 * np.ones(dim)
    want, got = jtpe.MOTPESampler(xl, xu, seed=3), tpe.MOTPESampler(xl, xu, seed=3)
    X = rng.uniform(xl, xu, (n_told, dim))
    F = rng.uniform(0.0, 1.0, (n_told, n_obj))
    want.tell_batch(X, F)
    got.tell_batch(X, F)
    for bsz in (16, 5):
        a, b = got.ask_batch(bsz), want.ask_batch(bsz)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.ask(), want.ask())


def test_asks_match_across_startup():
    """Ask and tell in batches from an empty history past the startup
    trials: the histories stay identical."""
    xl, xu = np.zeros(3), np.ones(3)
    want, got = jtpe.MOTPESampler(xl, xu, seed=0), tpe.MOTPESampler(xl, xu, seed=0)
    for _ in range(5):
        Xa, Xb = got.ask_batch(6), want.ask_batch(6)
        np.testing.assert_array_equal(Xa, Xb)
        got.tell_batch(Xa, two_objectives(Xa))
        want.tell_batch(Xb, two_objectives(Xb))
    np.testing.assert_array_equal(np.asarray(got.X), np.asarray(want.X))


@pytest.mark.parametrize("n_trials, batch_size, seed", [(120, 10, 0), (37, 16, 7)])
def test_run_motpe_matches_jax(n_trials, batch_size, seed):
    """tests/test_optimize.py:183-188's run: the same trials and front."""
    want = jtpe.run_motpe(two_objectives, np.zeros(3), np.ones(3), n_trials=n_trials,
                          batch_size=batch_size, seed=seed)
    got = tpe.run_motpe(two_objectives, np.zeros(3), np.ones(3), n_trials=n_trials,
                        batch_size=batch_size, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(np.asarray(got[2].X), np.asarray(want[2].X))
    np.testing.assert_array_equal(np.asarray(got[2].F), np.asarray(want[2].F))
    assert len(got[0]) >= 3


def test_run_motpe_callback():
    seen = []
    tpe.run_motpe(two_objectives, np.zeros(2), np.ones(2), n_trials=20, batch_size=8,
                  callback=lambda done, s: seen.append((done, len(s.X))))
    assert seen == [(8, 8), (16, 16), (20, 20)]


@pytest.mark.parametrize("f", [[np.inf, 1.0], [np.nan, 0.0], [1.0, -np.inf]])
def test_rejects_nonfinite(f):
    s = tpe.MOTPESampler(np.zeros(2), np.ones(2))
    s.tell(np.array([0.5, 0.5]), np.array(f))
    assert len(s.X) == 0 and len(s.F) == 0
    s.tell(np.array([0.5, 0.5]), np.array([1.0, 2.0]))
    assert len(s.X) == 1


def test_state_dict_round_trip():
    """A sampler loaded from another's state asks what the other asks."""
    _, _, s = tpe.run_motpe(two_objectives, np.zeros(3), np.ones(3), n_trials=30,
                            batch_size=10, seed=1)
    s2 = tpe.MOTPESampler(np.zeros(3), np.ones(3), seed=99)
    s2.load_state_dict(s.state_dict())
    assert len(s2.X) == len(s.X) == 30
    np.testing.assert_array_equal(s2.ask_batch(4), s.ask_batch(4))


def test_pareto_empty_and_nonempty():
    s = tpe.MOTPESampler(np.zeros(2), np.ones(2))
    pX, pF = s.pareto
    assert pX.shape == (0, 2) and pF.shape == (0, 0)
    s.tell_batch(np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3]]),
                 np.array([[1.0, 2.0], [2.0, 1.0], [3.0, 3.0]]))
    pX, pF = s.pareto
    np.testing.assert_array_equal(pF, [[1.0, 2.0], [2.0, 1.0]])


def test_save_load_sampler_matches_jax(tmp_path):
    """save_sampler / load_sampler: a JAX sampler's file loads into the
    port's and the reverse, and a missing file leaves a sampler fresh."""
    _, _, js = jtpe.run_motpe(two_objectives, np.zeros(3), np.ones(3), n_trials=24,
                              batch_size=8, seed=2)
    _, _, ts = tpe.run_motpe(two_objectives, np.zeros(3), np.ones(3), n_trials=24,
                             batch_size=8, seed=2)
    jp, tp = str(tmp_path / "j.tpe"), str(tmp_path / "sub" / "t.tpe")
    jck.save_sampler(jp, js)
    assert checkpoint.save_sampler(tp, ts) == tp
    a = checkpoint.load_sampler(jp, tpe.MOTPESampler(np.zeros(3), np.ones(3)))
    b = jck.load_sampler(tp, jtpe.MOTPESampler(np.zeros(3), np.ones(3)))
    np.testing.assert_array_equal(a.ask_batch(3), b.ask_batch(3))
    fresh = checkpoint.load_sampler(str(tmp_path / "none.tpe"),
                                    tpe.MOTPESampler(np.zeros(3), np.ones(3), seed=4))
    assert fresh.X == [] and fresh.F == []
