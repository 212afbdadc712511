"""The port's per-gene kinetics (``models/kinetics.py``, ``ops/linear.py``,
``config/labels.py``) against the JAX package on the CPU at float64.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: the (M, b) builders and the labels exactly (the same
arithmetic in the same order); ``expm`` within 1e-13 of the largest entry
(float64; 2e-6 at float32) where it takes no squaring, with NaN in the same
places. Each squaring can double a rounding difference of the Padé step
(exp(A) = R^(2^s)), so after s squarings the bound is
max(1e-13, 8 * 2^s * eps) of the largest entry: measured at float64,
1.7e-11 at s = 16 (5.6e-12 at s = 13), no more than JAX's own gap to
``torch.linalg.matrix_exp`` (4.9e-11 at s = 16). The solves,
``fit_vector`` and ``initial_condition`` within rtol 1e-11; the forward-mode
Jacobian of the fit vector within rtol 1e-9 of ``jax.jacfwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.linalg import expm as jax_expm

from phoskintime_tpu.config import labels as jax_labels
from phoskintime_tpu.models import kinetics as jk
from phoskintime_tpu.ops.linear import solve_lti as jax_solve_lti
from phoskintime_tpu_torch.config import labels
from phoskintime_tpu_torch.models import kinetics as pk
from phoskintime_tpu_torch.ops.linear import MAX_SQUARINGS, expm, solve_lti

torch.set_num_threads(2)

TIME_POINTS = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0,
                        60.0, 120.0, 240.0, 480.0, 960.0])
MODELS = ("distmod", "succmod", "randmod")
EXPM_SCALED = {np.float64: 1e-13, np.float32: 2e-6}
SOLVE_RTOL = 1e-11
JAC_RTOL = 1e-9
# (maxnorm, the digitize thresholds) of JAX's expm by precision
MAXNORM = {np.float64: 5.371920351148152, np.float32: 3.925724783138660}
BRANCH_NORMS = {np.float64: (0.01, 0.1, 0.5, 1.5, 3.0), np.float32: (0.2, 1.0, 3.0)}


def generator(rng, w, norm, count=4, dtype=np.float64):
    """Markov generators (non-negative off-diagonals, columns summing to
    zero) scaled to a 1-norm of ``norm``: exp(A) is column-stochastic, so
    its entries stay O(1) at any squaring count."""
    A = rng.uniform(0.0, 1.0, (count, w, w))
    for i in range(w):
        A[:, i, i] = 0.0
    A -= np.eye(w) * A.sum(axis=1, keepdims=True)
    A *= norm / np.abs(A).sum(axis=1).max(axis=-1)[:, None, None]
    return A.astype(dtype)


def expm_tol(s, dtype):
    """The scaled bound after s squarings (see the module doc)."""
    return max(EXPM_SCALED[dtype], 8 * 2.0 ** s * np.finfo(dtype).eps)


def squarings(norm, dtype):
    return max(0, int(np.floor(np.log2(norm / MAXNORM[dtype]))))


def assert_expm_close(A, dtype, s=0):
    got = expm(torch.as_tensor(A)).numpy()
    want = np.asarray(jax.vmap(jax_expm)(jnp.asarray(A)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    if fin.any():
        scale = np.max(np.abs(want[fin]))
        assert np.max(np.abs(got[fin] - want[fin])) <= expm_tol(s, dtype) * scale
    return got


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_expm_every_pade_branch(dtype):
    rng = np.random.default_rng(0)
    for norm in BRANCH_NORMS[dtype]:
        A = generator(rng, 6, norm, dtype=dtype)
        assert squarings(norm, dtype) == 0
        got = assert_expm_close(A, dtype)
        if dtype == np.float64:   # an independent check: PyTorch's Taylor expm
            np.testing.assert_allclose(got, torch.linalg.matrix_exp(torch.as_tensor(A)).numpy(),
                                       rtol=0, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_expm_squaring_counts_and_nan_cutoff(dtype):
    """Squaring counts 0..16 agree with JAX, and 17 gives NaN in both."""
    rng = np.random.default_rng(1)
    for s in range(MAX_SQUARINGS + 2):
        norm = MAXNORM[dtype] * 2.0 ** s * 1.3
        assert squarings(norm, dtype) == s
        A = generator(rng, 5, norm, dtype=dtype)
        got = assert_expm_close(A, dtype, s)
        assert np.isnan(got).all() == (s > MAX_SQUARINGS)
        if s <= MAX_SQUARINGS and dtype == np.float64:
            np.testing.assert_allclose(got, torch.linalg.matrix_exp(torch.as_tensor(A)).numpy(),
                                       rtol=0, atol=expm_tol(s, dtype))


def test_expm_mixed_batch_selects_per_matrix():
    """One batch holding every branch and the NaN lane: each matrix comes out
    as it does alone (a per-matrix select, as under jax.vmap)."""
    rng = np.random.default_rng(2)
    norms = [0.01, 0.1, 0.5, 1.5, 3.0, 40.0, 3e3, 1e6]
    A = np.concatenate([generator(rng, 4, x, count=1) for x in norms])
    got = assert_expm_close(A, np.float64, squarings(3e3, np.float64))
    alone = np.concatenate([expm(torch.as_tensor(a[None])).numpy() for a in A])
    np.testing.assert_array_equal(got, alone)
    assert np.isnan(got[-1]).all() and np.isfinite(got[:-1]).all()


@pytest.mark.parametrize("model", MODELS)
def test_builders_exact(model):
    rng = np.random.default_rng(3)
    for n in range(6):
        P = rng.uniform(0.0, 20.0, (5, jk.n_params(model, n)))
        M, b = pk._BUILDERS[model](torch.as_tensor(P), n)
        assert M.shape == (5, jk.state_dim(model, n), jk.state_dim(model, n))
        for i, p in enumerate(P):
            Mj, bj = jk._BUILDERS[model](jnp.asarray(p), n)
            np.testing.assert_array_equal(M[i].numpy(), np.asarray(Mj))
            np.testing.assert_array_equal(b[i].numpy(), np.asarray(bj))
        assert pk.n_params(model, n) == jk.n_params(model, n)
        assert pk.state_dim(model, n) == jk.state_dim(model, n)


def test_random_tables_identical():
    for n in range(6):
        for got, want in zip(pk._random_transition_tables(n), jk._random_transition_tables(n)):
            np.testing.assert_array_equal(got, want)


def true_params(rng, model, n, count=None):
    size = (jk.n_params(model, n),) if count is None else (count, jk.n_params(model, n))
    return rng.uniform(0.3, 2.5, size)


@pytest.mark.parametrize("model", MODELS)
def test_initial_condition(model):
    for n in range(6):
        got = pk.initial_condition(n, model, device="cpu")
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(jk.initial_condition(n, model)),
                                   rtol=SOLVE_RTOL)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("normalize", [False, True])
def test_solve_ode_and_fit_vector(model, normalize):
    rng = np.random.default_rng(4)
    for n in (1, 2, 3):
        p = true_params(rng, model, n)
        y0 = np.asarray(jk.initial_condition(n, model))
        sol, fit = jk.solve_ode(jnp.asarray(p), jnp.asarray(y0), n, jnp.asarray(TIME_POINTS),
                                model=model, normalize=normalize)
        got_sol, got_fit = pk.solve_ode(p, y0, n, TIME_POINTS, model, normalize, device="cpu")
        np.testing.assert_allclose(got_sol.numpy(), np.asarray(sol), rtol=SOLVE_RTOL)
        np.testing.assert_allclose(got_fit.numpy(), np.asarray(fit), rtol=SOLVE_RTOL)
        np.testing.assert_array_equal(pk.fit_vector(got_sol, n).numpy(), got_fit.numpy())
        np.testing.assert_array_equal(
            pk.fit_vector(got_sol, n).numpy(), np.asarray(jk.fit_vector(jnp.asarray(got_sol.numpy()), n)))


@pytest.mark.parametrize("model", MODELS)
def test_solve_ode_batched(model):
    rng = np.random.default_rng(5)
    n = 2
    P = true_params(rng, model, n, count=6)
    P[0, 4] = 0.0        # a knocked-out site
    y0 = np.asarray(jk.initial_condition(n, model))
    sols, fits = jk.solve_ode_batched(jnp.asarray(P), jnp.asarray(y0), n,
                                      jnp.asarray(TIME_POINTS), model)
    got_sols, got_fits = pk.solve_ode_batched(P, y0, n, TIME_POINTS, model, device="cpu")
    np.testing.assert_allclose(got_sols.numpy(), np.asarray(sols), rtol=SOLVE_RTOL, atol=1e-300)
    np.testing.assert_allclose(got_fits.numpy(), np.asarray(fits), rtol=SOLVE_RTOL, atol=1e-300)


def test_solve_lti_against_jax():
    rng = np.random.default_rng(6)
    d = 4
    M = generator(rng, d, 3.0, count=1)[0] - np.eye(d) * 0.1
    b, y0 = rng.uniform(0, 1, d), rng.uniform(0, 1, d)
    want = jax_solve_lti(jnp.asarray(M), jnp.asarray(b), jnp.asarray(y0), jnp.asarray(TIME_POINTS))
    got = solve_lti(*(torch.as_tensor(x) for x in (M, b, y0, TIME_POINTS)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SOLVE_RTOL)


@pytest.mark.parametrize("model", MODELS)
def test_jacfwd_of_fit_vector(model):
    """torch.func.jacfwd through the batched expm against jax.jacfwd, and
    under torch.func.vmap over lanes as the LM runs it."""
    rng = np.random.default_rng(7)
    n = 2
    P = true_params(rng, model, n, count=3)
    y0 = np.asarray(jk.initial_condition(n, model))
    t, y0t = torch.as_tensor(TIME_POINTS), torch.tensor(y0)

    def fit_of(p):
        return pk.solve_tensors(p, y0t, n, t, model)[1]

    got = torch.func.vmap(torch.func.jacfwd(fit_of))(torch.as_tensor(P)).numpy()
    for i, p in enumerate(P):
        want = np.asarray(jax.jacfwd(lambda q: jk.solve_ode(
            q, jnp.asarray(y0), n, jnp.asarray(TIME_POINTS), model=model)[1])(jnp.asarray(p)))
        np.testing.assert_allclose(got[i], want, rtol=JAC_RTOL, atol=JAC_RTOL * np.abs(want).max())


def test_labels_exact():
    for n in range(6):
        for model in MODELS:
            assert labels.get_param_names(model, n) == jax_labels.get_param_names(model, n)
            assert labels.generate_labels(model, n) == jax_labels.generate_labels(model, n)
        assert labels.subset_labels(n) == jax_labels.subset_labels(n)
        assert labels.get_number_of_params_rand(n) == jax_labels.get_number_of_params_rand(n)
        assert labels.get_number_of_params_ds(n) == jax_labels.get_number_of_params_ds(n)
    for n_new, ratio in [(0, None), (3, None), (4, 1.5)]:
        np.testing.assert_array_equal(labels.future_times(n_new, ratio),
                                      jax_labels.future_times(n_new, ratio))
    np.testing.assert_array_equal(labels.future_times(2, tp=TIME_POINTS[:5]),
                                  jax_labels.future_times(2, tp=TIME_POINTS[:5]))


def test_entry_points_default_to_the_card():
    """Without a card the default device raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pk.initial_condition(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pk.solve_ode_batched(np.ones((1, 6)), np.ones(3), 1, TIME_POINTS)
