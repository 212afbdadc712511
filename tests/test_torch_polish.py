"""The gradient stage of the port's global fit (``network/polish.py``, the
differentiable objective, ``make_residual_fn``) against the JAX package, on
the CPU at float64.

Seeded numpy inputs go through both packages: the static squaring ladders,
the differentiable objective against JAX's production objective, the
reverse-mode gradient and the forward-mode Jacobian against central
differences of JAX's functions, the residual vector against JAX's, and the
multistart's draws. The polish and the LM finish are checked for their own
guarantees here; runs against the JAX package's polish and LM, whose
reverse-mode compile takes minutes on a CPU, are marked ``slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network import expo as jexpo
from phoskintime_tpu.network.objective import make_population_objective as jax_objective
from phoskintime_tpu.network.objective import make_residual_fn as jax_residual_fn
from phoskintime_tpu.network.polish import lm_refine as jax_lm_refine
from phoskintime_tpu.network.polish import polish_solutions as jax_polish
from phoskintime_tpu.network.polish import simplex_weights as jax_simplex_weights
from phoskintime_tpu.ops.nsga import das_dennis as jax_das_dennis
from phoskintime_tpu.ops.nsga import lhs_sampling as jax_lhs
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import expo, optimize, polish
from phoskintime_tpu_torch.network.objective import make_population_objective, make_residual_fn
from phoskintime_tpu_torch.network.optimize import run_global_fit
from phoskintime_tpu_torch.network.polish import (forward_jacobian, gradient_multistart,
                                                  lm_refine, lm_refine_mixed, multistart_draws,
                                                  polish_solutions, simplex_weights)
from phoskintime_tpu_torch.ops.nsga import fast_non_dominated_sort
from phoskintime_tpu_torch.ops.phi_tables import ladder_len, phi_tables, phi_vectors_lanes

torch.set_num_threads(2)

# float64 on both sides, the same operations: rounding only
RTOL_F64 = 1e-9
# tables by ladders of different lengths, each lane's entries scaled by
# the lane's largest
LADDER_TOL = 1e-12
# a derivative against central differences at EPS along a unit direction
FD_RTOL, EPS = 1e-6, 1e-6
# the forward-mode Jacobian against reverse mode: rounding only
JAC_RTOL = 1e-10
# the polish's guarantee, as the JAX package's test (tests/test_polish.py:80)
POLISH_SLACK = 1e-4
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")


def bundle(model=0, n_proteins=10, n_kinases=4):
    bj = jax_demo(n_proteins=n_proteins, n_kinases=n_kinases, model=model, seed=0,
                  dtype=np.float64)
    keep = KEYS + ("topo", "theta0", "theta_true", "xl", "xu")
    return bj, from_reference({k: bj[k] for k in keep}, device="cpu")


@pytest.fixture(scope="module")
def demo():
    return bundle()


def jax_residual_case(bj):
    """The JAX residual at one theta, jitted: the function, theta, its
    residual vector."""
    import jax

    fn = jax.jit(jax_residual_fn(*(bj[k] for k in KEYS)))
    rng = np.random.default_rng(4)
    th = bj["theta0"] + 0.1 * rng.normal(size=len(bj["theta0"]))
    return fn, th, np.asarray(fn(jnp.asarray(th)))


@pytest.fixture(scope="module")
def residual_case(demo):
    """Model 0's JAX residual, compiled once (~18 s) and shared."""
    return jax_residual_case(demo[0])


def args(b):
    return [b[k] for k in KEYS]


def members(b, P, seed, spread=0.1):
    rng = np.random.default_rng(seed)
    return b["theta0"][None] + spread * rng.normal(size=(P, len(b["theta0"])))


def lane_scaled(a, b):
    """Largest |a - b| over each lane's largest |b| (lanes last)."""
    a, b = np.asarray(a), np.asarray(b)
    axes = tuple(range(b.ndim - 1))
    return float(np.max(np.abs(a - b) / np.max(np.abs(b), axis=axes)))


# --- the static ladder --------------------------------------------------------


@pytest.mark.parametrize("w", [3, 6, 17])
def test_static_ladder_vectors_match_jax(w):
    """``phi_vectors_lanes(unroll=ladder_len)``: exactly that many masked
    doublings, no host read; equal to JAX's unrolled ladder and to the
    port's dynamic one."""
    rng = np.random.default_rng(w)
    B = 24
    L = rng.normal(0.0, 1.0, (w, w, B)) * rng.uniform(0.01, 1.5, B)
    for h in (0.0625, 2.0, 16.0):
        k = ladder_len(w, h)
        got = phi_vectors_lanes(torch.as_tensor(L), h, unroll=k)
        want = jexpo._phi_vectors_lanes(jnp.asarray(L), jnp.full((B,), h), unroll=k)
        dynamic = phi_vectors_lanes(torch.as_tensor(L), h)
        for g, j, d in zip(got, want, dynamic):
            assert lane_scaled(g.numpy(), j) <= LADDER_TOL
            assert lane_scaled(g.numpy(), d.numpy()) <= LADDER_TOL


@pytest.mark.parametrize("ladder", ["masked", "unroll24"])
def test_static_ladder_matrices_match_jax(ladder):
    """Model 4's phi build with the static masked ladder of 24 doublings
    against JAX's masked ladder (``dynamic=False``) and its unrolled one."""
    rng = np.random.default_rng(7)
    w, B = 6, 40
    L = rng.normal(0.0, 1.0, (w, w, B)) * rng.uniform(0.01, 6.0, B)
    h = rng.uniform(0.05, 16.0, B)
    got = expo._phi_matrices_lanes(torch.as_tensor(L), torch.as_tensor(h), unroll=24)
    kw = {"masked": {}, "unroll24": dict(unroll=24)}[ladder]
    want = jexpo._phi_matrices_lanes(jnp.asarray(L), jnp.asarray(h), **kw)
    for g, j in zip(got, want):
        assert lane_scaled(g.numpy(), j) <= LADDER_TOL


def test_static_ladder_traces_under_vmap():
    """The static ladder reads nothing on the host, so ``torch.func.vmap``
    of ``torch.func.jvp`` runs it over a batch of blocks, where the dynamic
    ladder's host read of the trip count raises."""
    rng = np.random.default_rng(1)
    L = torch.as_tensor(rng.normal(0.0, 1.0, (3, 6, 6, 8)))
    V = torch.as_tensor(rng.normal(0.0, 1.0, (3, 6, 6, 8)))

    def tangent(unroll):
        return torch.func.vmap(lambda x, v: torch.func.jvp(
            lambda y: phi_vectors_lanes(y, 4.0, unroll=unroll)[1], (x,), (v,))[1])

    out = tangent(ladder_len(6, 4.0))(L, V)
    eps = 1e-6
    for i in range(3):
        fd = (phi_vectors_lanes(L[i] + eps * V[i], 4.0)[1]
              - phi_vectors_lanes(L[i] - eps * V[i], 4.0)[1]) / (2 * eps)
        np.testing.assert_allclose(out[i].numpy(), fd.numpy(), rtol=FD_RTOL, atol=1e-9)
    with pytest.raises(RuntimeError):
        tangent(None)(L, V)


@pytest.mark.parametrize("w", [6, 17])
def test_static_ladder_tables_match_jax(w):
    """``phi_tables(static_ladder=True)``: every (bucket, h) pair's lanes
    bounded by its own ``ladder_len``, all pairs in one masked ladder;
    equal pair by pair to JAX's differentiable build (a ladder a pair) and
    to the port's dynamic plain tables."""
    rng = np.random.default_rng(10 + w)
    n_buckets, B = 3, 16
    L = rng.normal(0.0, 1.0, (n_buckets, w, w, B)) * rng.uniform(0.01, 1.5, B)
    binv, h_u = [0, 2, 1, 0, 2], [0.0625, 1.0, 4.0, 16.0, 2.0]
    ladder = max(ladder_len(w, h) for h in h_u)
    got = phi_tables(torch.as_tensor(L), binv, h_u, ladder, use_kernel=False,
                     static_ladder=True)
    dynamic = phi_tables(torch.as_tensor(L), binv, h_u, ladder, use_kernel=False)
    for u, (b, h) in enumerate(zip(binv, h_u)):
        want = jexpo._phi_vectors_lanes(jnp.asarray(L[b]), jnp.full((B,), h),
                                        unroll=ladder_len(w, h))
        for g, j, d in zip(got, want, dynamic):
            assert lane_scaled(g[u].numpy(), j) <= LADDER_TOL
            assert lane_scaled(g[u].numpy(), d[u].numpy()) <= LADDER_TOL


def test_differentiable_route_asks_for_the_plain_tables(demo):
    _, bt = demo
    L = torch.zeros((1, 6, 6, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="use_kernel=False"):
        phi_tables(L, [0], [1.0], 4, static_ladder=True)
    for route in (dict(use_kernel=True), dict(use_scan_kernel=True)):
        with pytest.raises(ValueError, match="no derivative"):
            expo.exponential_simulate_batched(bt["system"], {}, bt["grid"],
                                              differentiable=True, **route)


# --- the differentiable objective ---------------------------------------------


@pytest.fixture(scope="module")
def cases(demo):
    """case -> (JAX bundle, port bundle, the objective's options, JAX's
    production objective jitted once for the module)."""
    import jax

    b2, b4 = bundle(2, 6, 3), bundle(4, 6, 3)
    out = {}
    for case, (bj, bt), kw in (("model0", demo, {}), ("model2-bucketed", b2, {}),
                               ("model2-unbucketed", b2, dict(width_bucketing=False)),
                               ("model4", b4, {})):
        out[case] = bj, bt, kw, jax.jit(jax_objective(*args(bj), **kw))
    return out


@pytest.mark.parametrize("case", ["model0", "model2-bucketed", "model2-unbucketed", "model4"])
def test_differentiable_objective_matches_jax(cases, case):
    """``differentiable=True`` (the plain tables by the static ladder, the
    eager scan; model 4's masked ladder) equals JAX's production objective,
    and records a graph where the default objective records none."""
    bj, bt, kw, jax_f = cases[case]
    X = members(bj, 3, seed=2)
    want = np.asarray(jax_f(jnp.asarray(X)))
    Xt = torch.as_tensor(X).requires_grad_(True)
    got = make_population_objective(*args(bt), differentiable=True, **kw)(Xt)
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL_F64)
    assert not make_population_objective(*args(bt), **kw)(Xt).requires_grad


@pytest.mark.parametrize("case", ["model0", "model2-bucketed", "model2-unbucketed", "model4"])
def test_gradient_matches_jax_differences(cases, case):
    """``torch.autograd`` through the differentiable objective of the
    scalarized F . w over three members, against central differences of
    JAX's production objective along three seeded directions."""
    bj, bt, kw, f = cases[case]
    X = members(bj, 3, seed=3)
    W = simplex_weights(np.random.default_rng(3).uniform(1, 2, (3, 3)))
    Xt = torch.as_tensor(X).requires_grad_(True)
    s = torch.sum(make_population_objective(*args(bt), differentiable=True, **kw)(Xt)
                  * torch.as_tensor(W))
    g, = torch.autograd.grad(s, Xt)
    assert bool(torch.isfinite(g).all())

    def scalar(x):
        return float(np.sum(np.asarray(f(jnp.asarray(x))) * W))

    rng = np.random.default_rng(5)
    for _ in range(3):
        d = rng.normal(size=X.shape)
        d /= np.linalg.norm(d)
        fd = (scalar(X + EPS * d) - scalar(X - EPS * d)) / (2 * EPS)
        assert float(np.sum(g.numpy() * d)) == pytest.approx(fd, rel=FD_RTOL)


# --- the residual vector and its Jacobian -------------------------------------


def test_residual_matches_jax(demo, residual_case):
    _, bt = demo
    _, th, want = residual_case
    got = make_residual_fn(*args(bt))(torch.as_tensor(th)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL_F64, atol=1e-15)


@pytest.mark.parametrize("prior", [0.0, 0.3])
def test_residual_sse_equals_objective(demo, prior):
    """sum(r**2) is F.sum() under loss mode 0: data rows weighted by
    sqrt(lambda norm w), prior rows by sqrt(3 lambda_prior / cnt)."""
    _, bt = demo
    lam = {**bt["lambdas"], "prior": prior}
    th = members(bt, 1, seed=6)[0]
    r = make_residual_fn(*args(bt)[:4], lam, bt["grid"])(torch.as_tensor(th))
    F = make_population_objective(*args(bt)[:4], lam, bt["grid"])(th[None])
    assert float(torch.sum(r ** 2)) == pytest.approx(float(F.sum()), rel=1e-12)


def jacobian_columns_match(J, case, k_cols):
    """Columns ``k_cols`` of J against central differences of JAX's
    residual."""
    fn, th, _ = case
    for k in k_cols:
        e = np.zeros(len(th))
        e[k] = EPS
        fd = (np.asarray(fn(jnp.asarray(th + e))) - np.asarray(fn(jnp.asarray(th - e)))) / (2 * EPS)
        np.testing.assert_allclose(J[:, k].numpy(), fd, rtol=FD_RTOL,
                                   atol=FD_RTOL * np.max(np.abs(fd)))


def test_forward_jacobian_matches_reverse_and_jax(demo, residual_case):
    """:func:`forward_jacobian` (chunks of 64, the last shorter) against
    ``torch.autograd.functional.jacobian`` (reverse mode), and four of its
    columns against central differences of JAX's residual."""
    _, bt = demo
    fn, th, _ = residual_case
    residuals = make_residual_fn(*args(bt))
    tht = torch.as_tensor(th)
    J = forward_jacobian(residuals, tht, chunk=64)
    assert J.shape == (len(residual_case[2]), len(th))
    J_rev = torch.autograd.functional.jacobian(residuals, tht, vectorize=True)
    np.testing.assert_allclose(J.numpy(), J_rev.numpy(), rtol=JAC_RTOL,
                               atol=JAC_RTOL * float(J_rev.abs().max()))
    jacobian_columns_match(J, residual_case,
                           np.random.default_rng(8).choice(len(th), 4, replace=False))


def test_forward_jacobian_model4_matches_jax(cases):
    """Model 4's residual (the Rosenbrock route: the saturating block
    Jacobians and the masked ladder of 24 doublings under ``vmap`` of
    ``jvp``): its values against JAX's residual, and four columns of its
    forward-mode Jacobian against central differences of it."""
    bj, bt, _, _ = cases["model4"]
    case = jax_residual_case(bj)
    _, th, want = case
    residuals = make_residual_fn(*args(bt))
    np.testing.assert_allclose(residuals(torch.as_tensor(th)).numpy(), want, rtol=RTOL_F64,
                               atol=1e-15)
    J = forward_jacobian(residuals, torch.as_tensor(th), chunk=48)
    assert J.shape == (len(want), len(th)) and bool(torch.isfinite(J).all())
    jacobian_columns_match(J, case, np.random.default_rng(8).choice(len(th), 4, replace=False))


# --- polish and multistart ----------------------------------------------------


def test_simplex_weights_match_jax():
    F = np.random.default_rng(9).uniform(0.1, 50.0, (17, 3))
    F[3] = F[5]
    np.testing.assert_array_equal(simplex_weights(F), jax_simplex_weights(F))
    np.testing.assert_array_equal(simplex_weights(F[:1]), jax_simplex_weights(F[:1]))


@pytest.mark.parametrize("pop, seed", [(8, 3), (33, 42)])
def test_multistart_draws_match_jax(demo, pop, seed):
    """The LHS starts and Das-Dennis weights drawn as the JAX package's
    ``gradient_multistart`` draws them."""
    bj, _ = demo
    rng = np.random.default_rng(seed)
    X0 = jax_lhs(pop, np.asarray(bj["xl"], float), np.asarray(bj["xu"], float), rng)
    dirs = jax_das_dennis(3, 12)
    W = np.maximum(dirs[rng.integers(0, len(dirs), pop)], 0.05)
    W = W / W.sum(axis=1, keepdims=True)
    got_X, got_W = multistart_draws(bj["xl"], bj["xu"], pop, seed)
    np.testing.assert_array_equal(got_X, X0)
    np.testing.assert_array_equal(got_W, W)


def test_polish_never_worse_and_inside_the_box(demo):
    bj, bt = demo
    rng = np.random.default_rng(2)
    P, xl, xu = 4, bj["xl"], bj["xu"]
    X0 = rng.uniform(xl, xu, (P, len(xl)))
    W = simplex_weights(rng.uniform(1, 2, (P, 3)))
    F0 = make_population_objective(*args(bt))(X0.astype(np.float32)).numpy()
    Xp, Fp = polish_solutions(*args(bt), X0, xl, xu, weights=W, steps=6, lr=0.05)
    s0, s1 = (F0 * W).sum(axis=1), (Fp * W).sum(axis=1)
    assert Xp.shape == X0.shape and Fp.shape == (P, 3)
    assert np.all(s1 <= s0 * (1 + POLISH_SLACK) + 1e-6)
    assert s1.mean() < 0.9 * s0.mean()
    assert np.all(Xp >= xl - 1e-6) and np.all(Xp <= xu + 1e-6)
    # the iterate is float32, as the JAX package's
    np.testing.assert_array_equal(Xp, Xp.astype(np.float32))


def test_polish_chunks_match_one_pass(demo):
    """Chunks of 2 over 3 members (the last of one member) give each member
    the polish it gets in one chunk."""
    bj, bt = demo
    X0 = members(bj, 3, seed=11, spread=0.3)
    one = polish_solutions(*args(bt), X0, bj["xl"], bj["xu"], steps=3, chunk=4)
    chunked = polish_solutions(*args(bt), X0, bj["xl"], bj["xu"], steps=3, chunk=2)
    np.testing.assert_allclose(chunked[0], one[0], rtol=1e-6)
    np.testing.assert_allclose(chunked[1], one[1], rtol=1e-5)


def test_gradient_stage_mesh_raises(demo):
    bj, bt = demo
    with pytest.raises(NotImplementedError, match="item 1b"):
        polish_solutions(*args(bt), bj["theta0"][None], bj["xl"], bj["xu"], steps=1,
                         mesh=object())
    with pytest.raises(NotImplementedError, match="item 1b"):
        gradient_multistart(*args(bt), bj["xl"], bj["xu"], pop=2, steps=1, mesh=object())


# --- the LM finish --------------------------------------------------------------


@pytest.fixture(scope="module")
def zero_residual(demo):
    """theta* (the true parameters, clipped to the box), the float64
    residual there (r_offset: theta* the exact minimum) and a 2% start."""
    bj, bt = demo
    th_star = np.clip(bj["theta_true"], bj["xl"], bj["xu"])
    r_off = make_residual_fn(*args(bt))(torch.as_tensor(th_star)).numpy()
    rng = np.random.default_rng(3)
    th0 = np.clip(th_star + 0.02 * rng.standard_normal(th_star.size) * (1 + np.abs(th_star)),
                  bj["xl"], bj["xu"])
    return th_star, r_off, th0


def test_lm_stays_at_the_zero_residual_minimum(demo, zero_residual):
    bj, bt = demo
    th_star, r_off, _ = zero_residual
    th, sse = lm_refine(*args(bt), th_star, bj["xl"], bj["xu"], iters=3, r_offset=r_off)
    assert sse < 1e-12
    np.testing.assert_allclose(th, th_star, atol=1e-8)


def test_lm_recovers_theta_below_the_raw_floor(demo, zero_residual):
    """From a 2% perturbation, far below the data's own floor (the sse of
    the raw residual at theta*), and inside the box."""
    bj, bt = demo
    th_star, r_off, th0 = zero_residual
    th, sse = lm_refine(*args(bt), th0, bj["xl"], bj["xu"], iters=4, r_offset=r_off)
    assert sse < max(1e-10, 0.01 * float(r_off @ r_off))
    assert np.all(th >= bj["xl"] - 1e-6) and np.all(th <= bj["xu"] + 1e-6)


@pytest.mark.parametrize("stop", ["gtol", "xtol"])
def test_lm_stopping_rules(demo, zero_residual, stop):
    """``gtol`` stops before a step where the largest gradient entry is
    below it: the input comes back. ``xtol`` stops after the first accepted
    step below it: the run equals one cut to the iterations it took."""
    bj, bt = demo
    _, r_off, th0 = zero_residual
    lines = []

    class Log:
        def info(self, msg):
            lines.append(msg)

    def run(**kw):
        return lm_refine(*args(bt), th0, bj["xl"], bj["xu"], r_offset=r_off, **kw)

    r0 = make_residual_fn(*args(bt))(torch.as_tensor(th0)).numpy() - r_off
    if stop == "gtol":
        th, sse = run(iters=5, gtol=1e30)
        np.testing.assert_array_equal(th, th0)
        assert sse == pytest.approx(float(r0 @ r0), rel=1e-12)
        return
    th, sse = run(iters=5, xtol=1e30, logger=Log())
    assert "converged" in lines[-1] and sse < float(r0 @ r0)
    taken = int(lines[-1].split()[2].rstrip(":")) + 1
    assert taken < 5
    th_cut, sse_cut = run(iters=taken)
    np.testing.assert_array_equal(th, th_cut)
    assert sse == sse_cut


def test_lm_mixed_finish_descends_past_the_float32_floor(demo, zero_residual, monkeypatch):
    """float32 LM stalls at its rounding floor; the float64 finish from the
    point it reached ends below 1e-3 of it (tests/test_polish.py:356-389).
    The float32-only sse is the mixed finish's own first stage, read by a
    spy (the same call a float32-only run makes)."""
    bj, bt = demo
    th_star, r64, th0 = zero_residual
    sys32 = bt["system"].astype(torch.float32)
    assert sys32.dtype == torch.float32 and sys32.device == bt["system"].device
    assert sys32.astype(torch.float32) is sys32
    assert sys32.astype(torch.float64).rhs.Kmat.dtype == torch.float64
    rest = args(bt)[1:]
    r32 = make_residual_fn(sys32, *rest)(torch.as_tensor(th_star)).numpy()
    stages = []

    def spy(system, *a, **kw):
        out = lm_refine(system, *a, **kw)
        stages.append((system.dtype, out[1]))
        return out

    monkeypatch.setattr(polish, "lm_refine", spy)
    th, sse = lm_refine_mixed(sys32, *rest, th0, bj["xl"], bj["xu"], iters_lo=8, iters_hi=6,
                              r_offset_lo=r32, r_offset_hi=r64)
    (dt32, sse32), (dt64, _) = stages
    assert (dt32, dt64) == (torch.float32, torch.float64)
    assert th.dtype == np.float64
    assert sse < 1e-13 and sse < 1e-3 * max(sse32, 1e-30)
    assert np.all(th >= bj["xl"] - 1e-6) and np.all(th <= bj["xu"] + 1e-6)


# --- run_global_fit -----------------------------------------------------------


def test_fit_polish_and_lm_bookkeeping(demo):
    """A GA of pop 8 for 1 generation, the polish of its Pareto set (2
    steps) and one LM iteration: 3 evaluations a polished member and step,
    30 an LM iteration, and the Pareto set the front of every member."""
    bj, bt = demo
    res = run_global_fit(*args(bt), bj["xl"], bj["xu"], pop=8, n_gen=1, seed=0,
                         polish_steps=2, gn_iters=1, frechet_pick=False, ftol=0.0)
    n_polished = len(res.X) - 8 - 1
    assert n_polished >= 1
    assert res.n_evals == 8 * 2 + 3 * 2 * n_polished + 30
    front = fast_non_dominated_sort(res.F)[0]
    np.testing.assert_array_equal(res.pareto_F, res.F[front])
    assert np.isfinite(res.F).all()


def test_fit_gradient_optimizer_bookkeeping(demo, monkeypatch):
    """``optimizer="gradient"``: the multistart at max(100, polish_steps)
    steps, counted as pop x 3 x steps evaluations; its run here is cut to
    2 steps (the bookkeeping reads the steps the fit asked for)."""
    bj, bt = demo
    asked = {}

    def short(*a, steps, **kw):
        asked["steps"] = steps
        return gradient_multistart(*a, steps=2, **kw)

    monkeypatch.setattr(optimize, "gradient_multistart", short)
    res = run_global_fit(*args(bt), bj["xl"], bj["xu"], pop=4, n_gen=1, seed=0,
                         optimizer="gradient", polish_steps=30, frechet_pick=False)
    assert asked["steps"] == 100
    assert res.n_evals == 4 * 3 * 100 and len(res.X) == 4
    np.testing.assert_array_equal(res.pareto_F, res.F[fast_non_dominated_sort(res.F)[0]])
    X0, W = multistart_draws(bj["xl"], bj["xu"], 4, 0)
    F0 = make_population_objective(*args(bt))(X0.astype(np.float32)).numpy()
    assert np.all((res.F * W).sum(axis=1) <= (F0 * W).sum(axis=1) * (1 + POLISH_SLACK) + 1e-6)


# --- against the JAX package's own polish and LM (minutes of JAX compile) -----


@pytest.mark.slow
def test_polish_matches_jax(demo):
    """Three Adam steps: X within 1e-6 of JAX's, relative to the largest
    |X| (the float32 iterates differ by a few ulps: XLA's float32 pow in
    the bias corrections differs from the C library's by up to 6.6e-6
    relative, and the JAX objective unpacks float32 thetas in float32)."""
    bj, bt = demo
    X0 = members(bj, 3, seed=12, spread=0.3)
    W = simplex_weights(np.random.default_rng(12).uniform(1, 2, (3, 3)))
    want = jax_polish(*args(bj), X0, bj["xl"], bj["xu"], weights=W, steps=3, lr=0.05)
    got = polish_solutions(*args(bt), X0, bj["xl"], bj["xu"], weights=W, steps=3, lr=0.05)
    assert np.max(np.abs(got[0] - want[0])) <= 1e-6 * np.max(np.abs(want[0]))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


@pytest.mark.slow
def test_lm_refine_matches_jax(demo, zero_residual):
    bj, bt = demo
    _, _, th0 = zero_residual
    want = jax_lm_refine(*args(bj), th0, bj["xl"], bj["xu"], iters=2)
    got = lm_refine(*args(bt), th0, bj["xl"], bj["xu"], iters=2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-8)
    assert got[1] == pytest.approx(want[1], rel=1e-8)
