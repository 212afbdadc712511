"""The port's batched LM (``ops/lm.py``), score and CIs against the JAX
package on the CPU at float64.

The residual is a per-gene fit vector against noisy synthetic data, made
with numpy from a seed. Tolerances: p, cost and pcov within rtol 1e-9 of
JAX after 1, 5 and 20 iterations (pcov relative to its largest entry),
``n_accepted`` equal. Where J^T J is ill conditioned two correct pinvs
differ by up to ~cond(J^T J) eps (measured: 2.3e-6 of the largest entry at
cond ~1e10, the randmod n = 1 fit below), so pcov is held to
max(1e-9, 10 cond eps) there; ``pinv``
cuts at JAX's ``rtol = 10 max(M, N) eps``; ``score_fit`` within rtol
1e-12; ``confidence_intervals`` exactly (the same numpy and scipy code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.fit.ci import confidence_intervals as jax_ci
from phoskintime_tpu.fit.score import score_fit as jax_score_fit
from phoskintime_tpu.models import kinetics as jk
from phoskintime_tpu.ops import lm as jlm
from phoskintime_tpu_torch.fit.ci import confidence_intervals
from phoskintime_tpu_torch.fit.score import score_fit
from phoskintime_tpu_torch.models import kinetics as pk
from phoskintime_tpu_torch.ops import lm

torch.set_num_threads(2)

TIME_POINTS = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0,
                        60.0, 120.0, 240.0, 480.0, 960.0])
LM_RTOL = 1e-9
SCORE_RTOL = 1e-12


def problem(model, n, seed, starts=3):
    """(JAX residual, port residual, p0s, lower, upper) of a fit to 5%
    noisy data from known parameters."""
    rng = np.random.default_rng(seed)
    true = rng.uniform(0.3, 2.5, jk.n_params(model, n))
    y0 = np.asarray(jk.initial_condition(n, model))
    _, fit = jk.solve_ode(jnp.asarray(true), jnp.asarray(y0), n, jnp.asarray(TIME_POINTS),
                          model=model)
    target = np.asarray(fit) * (1 + 0.05 * rng.normal(size=fit.shape))
    p0s = rng.uniform(0.5, 3.0, (starts, true.size))
    lower, upper = np.full(true.size, 0.01), np.full(true.size, 20.0)
    t, y0t, tgt = torch.as_tensor(TIME_POINTS), torch.tensor(y0), torch.as_tensor(target)

    def r_jax(p):
        return jk.solve_ode(p, jnp.asarray(y0), n, jnp.asarray(TIME_POINTS), model=model)[1] \
            - jnp.asarray(target)

    def r_port(p):
        return pk.solve_tensors(p, y0t, n, t, model)[1] - tgt

    return r_jax, r_port, p0s, lower, upper


def pcov_tol(pcov):
    """The pcov bound (see the module doc): rtol 1e-9, or 10 cond eps
    where J^T J (the pseudo-inverse of pcov) is ill conditioned."""
    s = np.linalg.svd(pcov, compute_uv=False)
    s = s[..., :1] / np.where(s > 0, s, np.inf).min(axis=-1, keepdims=True)
    return max(LM_RTOL, 10 * float(np.max(s)) * np.finfo(float).eps)


def assert_lm_close(got, want):
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=LM_RTOL, atol=1e-300)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=LM_RTOL)
    pcov = np.asarray(want.pcov)
    np.testing.assert_allclose(got.pcov.numpy(), pcov, rtol=0,
                               atol=pcov_tol(pcov) * np.max(np.abs(pcov)))
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    assert got.n_accepted.dtype == torch.int32


@pytest.mark.parametrize("model,n", [("distmod", 2), ("randmod", 2)])
@pytest.mark.parametrize("iters", [1, 5, 20])
def test_lm_batched_matches_jax(model, n, iters):
    r_jax, r_port, p0s, lo, hi = problem(model, n, seed=1)
    want = jax.jit(lambda p: jlm.lm_batched(r_jax, p, jnp.asarray(lo), jnp.asarray(hi),
                                            max_iters=iters))(jnp.asarray(p0s))
    got = lm.lm_batched(r_port, torch.as_tensor(p0s), torch.as_tensor(lo), torch.as_tensor(hi),
                        max_iters=iters)
    assert_lm_close(got, want)
    if iters == 20:
        assert np.all(got.cost.numpy() < 0.5 * np.sum(np.square(
            torch.func.vmap(r_port)(torch.as_tensor(np.clip(p0s, lo, hi))).numpy()), axis=1))


def test_levenberg_marquardt_single_start():
    r_jax, r_port, p0s, lo, hi = problem("succmod", 2, seed=2, starts=1)
    # this fit is ill conditioned (cond(J^T J) ~ 1e9 after 5 iterations)
    want = jlm.levenberg_marquardt(r_jax, jnp.asarray(p0s[0]), jnp.asarray(lo),
                                   jnp.asarray(hi), max_iters=5)
    got = lm.levenberg_marquardt(r_port, torch.as_tensor(p0s[0]), torch.as_tensor(lo),
                                 torch.as_tensor(hi), max_iters=5)
    assert got.p.shape == p0s[0].shape and got.pcov.shape == (p0s.shape[1],) * 2
    assert_lm_close(got, want)


def test_lm_per_lane_arguments_equal_separate_runs():
    """``args`` carries per-lane data (the JAX package's vmapped closure):
    two lanes with different targets equal two runs with the target baked in."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(8, 3)))
    targets = torch.as_tensor(rng.normal(size=(2, 8)))
    p0 = torch.zeros((2, 3), dtype=torch.float64)
    lo, hi = torch.full((3,), -5.0, dtype=torch.float64), torch.full((3,), 5.0, dtype=torch.float64)
    both = lm.lm_batched(lambda p, y: A @ p - y, p0, lo, hi, args=(targets,), max_iters=6)
    for i in range(2):
        one = lm.lm_batched(lambda p: A @ p - targets[i], p0[i:i + 1], lo, hi, max_iters=6)
        for a, b in zip(both, one):
            # a batch of two and a batch of one round differently
            torch.testing.assert_close(a[i], b[0], rtol=1e-12, atol=1e-13)


def test_singular_step_is_rejected():
    """A residual with no dependence on p: J^T J + lam diag(1) stays regular,
    but a zero-Jacobian parameter gets no step; the run ends finite, with
    no accepted step, like JAX's."""
    r_const = lambda p: jnp.ones(4) + 0.0 * p[0]
    want = jlm.levenberg_marquardt(r_const, jnp.ones(2), jnp.zeros(2), jnp.full(2, 3.0),
                                   max_iters=3)
    got = lm.levenberg_marquardt(lambda p: torch.ones(4, dtype=p.dtype) + 0.0 * p[0],
                                 torch.ones(2, dtype=torch.float64),
                                 torch.zeros(2, dtype=torch.float64),
                                 torch.full((2,), 3.0, dtype=torch.float64), max_iters=3)
    assert int(got.n_accepted) == int(want.n_accepted) == 0
    np.testing.assert_array_equal(got.p.numpy(), np.asarray(want.p))
    np.testing.assert_array_equal(got.pcov.numpy(), np.asarray(want.pcov))


def test_pinv_cutoff_is_jax():
    """A singular value between PyTorch's default cutoff (max(M, N) eps) and
    JAX's (10 max(M, N) eps) is dropped, as jnp.linalg.pinv drops it."""
    n = 4
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s = np.array([1.0, 0.5, 0.25, 5 * n * np.finfo(float).eps])
    H = (Q * s) @ Q.T
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(H)))
    got = lm.pinv(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.max(np.abs(want)) < 10.0                     # the smallest was dropped
    assert np.max(np.abs(torch.linalg.pinv(torch.as_tensor(H)).numpy())) > 1e12


def test_rank_deficient_hessian_pcov():
    """randmod at n = 1 (near-degenerate in (D, Ddeg): cond(J^T J) ~ 1e10)
    with the last degradation rate frozen at its bound (a zero Jacobian
    column): the pcov of both packages drops that direction."""
    r_jax, r_port, p0s, lo, hi = problem("randmod", 1, seed=5, starts=2)
    r0_jax = lambda p: r_jax(p) + 0.0 * p[-1] ** 2
    p0s[:, -1] = lo[-1]
    mask = np.ones(p0s.shape[1]); mask[-1] = 0.0

    def rj(p):
        return r0_jax(p * jnp.asarray(mask) + (1 - jnp.asarray(mask)) * lo[-1])

    def rt(p):
        m = torch.as_tensor(mask)
        return r_port(p * m + (1 - m) * lo[-1])

    want = jax.jit(lambda p: jlm.lm_batched(rj, p, jnp.asarray(lo), jnp.asarray(hi),
                                            max_iters=5))(jnp.asarray(p0s))
    got = lm.lm_batched(rt, torch.as_tensor(p0s), torch.as_tensor(lo), torch.as_tensor(hi),
                        max_iters=5)
    assert_lm_close(got, want)
    assert np.all(got.pcov.numpy()[:, -1, :] == 0.0)


def test_score_fit_matches_jax():
    rng = np.random.default_rng(6)
    for m, npar in [(23, 6), (51, 8), (87, 40)]:
        p, tgt = rng.uniform(0, 3, npar), rng.uniform(0.5, 2, m)
        pred = tgt * (1 + 0.1 * rng.normal(size=m))
        kw = dict(alpha=0.7, beta=1.3, gamma=2.0, delta=0.5, mu=0.9)
        for k in ({}, kw):
            want = float(jax_score_fit(jnp.asarray(p), jnp.asarray(tgt), jnp.asarray(pred), **k))
            got = score_fit(torch.as_tensor(p), torch.as_tensor(tgt), torch.as_tensor(pred), **k)
            np.testing.assert_allclose(float(got), want, rtol=SCORE_RTOL)
    # lanes: each row scored on its own
    P, T = rng.uniform(0, 3, (4, 6)), rng.uniform(0.5, 2, (4, 23))
    got = score_fit(torch.as_tensor(P), torch.as_tensor(T), torch.as_tensor(T * 1.1))
    for i in range(4):
        np.testing.assert_allclose(float(got[i]), float(jax_score_fit(
            jnp.asarray(P[i]), jnp.asarray(T[i]), jnp.asarray(T[i] * 1.1))), rtol=SCORE_RTOL)


@pytest.mark.parametrize("use_custom_weights", [False, True])
def test_confidence_intervals_exact(use_custom_weights):
    rng = np.random.default_rng(7)
    popt = rng.uniform(0.1, 3, 6)
    J = rng.normal(size=(30, 6))
    pcov = np.linalg.pinv(J.T @ J)
    tgt, model = rng.uniform(0.5, 2, 30), rng.uniform(0.5, 2, 30)
    want = jax_ci(popt, pcov, tgt, model, alpha_val=0.05, use_custom_weights=use_custom_weights)
    got = confidence_intervals(popt, pcov, tgt, model, alpha_val=0.05,
                               use_custom_weights=use_custom_weights)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert confidence_intervals(popt, None, tgt, model) is None
