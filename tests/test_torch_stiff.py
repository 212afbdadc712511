"""The ESDIRK oracle (``ops/stiff.py``, ``solver="esdirk"``) of the PyTorch
port against ``jax.vmap`` of the JAX package's ``odeint_esdirk``, and the
edge-flux kernel's forward-mode and vmap rules.

Seeded inputs go through both packages on the CPU in float64. A step
decision is discontinuous, so the tests hold the per-member step counts
equal, not only the trajectories: the scalar stiff cases of the JAX
package's ``tests/test_stiff.py``, its tiny boundary gap
(``tests/test_ops_core.py``), and the network's models 0 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network.objective import make_objective as jax_make_objective
from phoskintime_tpu.network.simulate import simulate as jax_simulate
from phoskintime_tpu.ops.stiff import odeint_esdirk as jax_esdirk
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network.objective import (_auto_pop_chunk, _esdirk_pop_chunk,
                                                     make_objective)
from phoskintime_tpu_torch.network.simulate import simulate_batched
from phoskintime_tpu_torch.ops.hypercube_flux import FluxKernel, hypercube_flux_reference
from phoskintime_tpu_torch.ops.stiff import batched_jacobian, odeint_esdirk
from test_torch_model4 import GRID, jx, make_system, population

torch.set_num_threads(2)

# float64, the same steps on both sides: rounding accumulated over the run
RTOL_RUN = 1e-9
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")


def assert_runs_match(got, want, atol=1e-14):
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    assert got.ys.dtype == torch.float64 and got.ys.shape == want.ys.shape
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), rtol=RTOL_RUN, atol=atol)


# each case: (port rhs over (P, d), JAX rhs of one member given its
# parameter row q, member parameters (P, n), y0 (P, d), t_eval, solver options)
GAP = [0.0, 0.5, 0.5 + 1e-9]
CASES = {
    "decay": (lambda t, y, q: -q * y, lambda q: (lambda t, y: -q * y),
              [[1.0], [3.0], [0.2]], [[1.0], [2.0], [1.0]], [0.5, 1.0, 2.0],
              dict(rtol=1e-8, atol=1e-10)),
    "stiff_robertson_like": (
        lambda t, y, q: torch.stack([-q[:, 0] * y[:, 0] + q[:, 0] * y[:, 1],
                                     y[:, 0] - y[:, 1] - y[:, 1] * y[:, 1]], dim=1),
        lambda q: (lambda t, y: jnp.array([-q[0] * y[0] + q[0] * y[1],
                                           y[0] - y[1] - y[1] * y[1]])),
        [[1e4], [1e3]], [[1.0, 0.0], [0.5, 0.2]], [0.1, 1.0, 10.0],
        dict(rtol=1e-7, atol=1e-9, dt_max=10.0)),
    "bucketed_input": (
        lambda t, y, jb, q: q[torch.arange(len(q)), torch.clamp(jb, 0, 2)][:, None] - 0.0 * y,
        lambda q: (lambda t, y, jb: jnp.array([q[jnp.clip(jb, 0, 2)]]) - 0.0 * y),
        [[1.0, -0.5, 2.0], [0.5, 1.5, -1.0]], [[0.0], [0.3]], [1.0, 2.0, 3.0],
        dict(boundaries=[0.0, 1.0, 2.5], rtol=1e-9, atol=1e-11)),
    "stiffness_sweep": (
        lambda t, y, q: -q * (y - torch.cos(t)[:, None]),
        lambda q: (lambda t, y: -q * (y - jnp.cos(t))),
        [[1.0], [100.0], [10000.0]], [[0.0], [0.0], [0.0]], [1.0],
        dict(rtol=1e-7, atol=1e-9)),
    "tiny_boundary_gap": (
        lambda t, y, jb, q: torch.ones_like(y) * q,
        lambda q: (lambda t, y, jb: jnp.ones_like(y) * q),
        [[1.0], [2.0]], [[0.0], [0.0]], [1.0],
        dict(boundaries=GAP, dt_min=1e-6)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scalar_cases_match_vmap(case):
    rhs_t, rhs_j, q, y0, t_eval, kw = CASES[case]
    q, y0 = np.asarray(q, float), np.asarray(y0, float)
    kw_j = {k: (jnp.asarray(v) if k == "boundaries" else v) for k, v in kw.items()}
    want = jax.jit(jax.vmap(lambda qq, yy: jax_esdirk(
        rhs_j(qq), yy, jnp.asarray(t_eval, float), **kw_j)))(jnp.asarray(q), jnp.asarray(y0))
    qt = torch.as_tensor(q)
    if "boundaries" in kw:
        port_rhs = lambda t, y, jb: rhs_t(t, y, jb, qt)
    else:
        port_rhs = lambda t, y: rhs_t(t, y, qt)
    got = odeint_esdirk(port_rhs, torch.as_tensor(y0), t_eval, **kw)
    assert bool(got.success.all())
    assert_runs_match(got, want)
    if case == "tiny_boundary_gap":                  # y(t) = q t over the actual gap
        np.testing.assert_allclose(got.ys[:, -1, 0].numpy(), q[:, 0], atol=1e-7)


@pytest.mark.parametrize("model", [0, 2])
def test_network_esdirk_matches_vmap(model):
    """``simulate_batched(solver="esdirk")`` to t = 30 against ``jax.vmap``
    of JAX's ``simulate``; the Jacobian is the whole RHS's, TF coupling
    included (held against ``jax.jacfwd`` first)."""
    sj, st, p = make_system(model)
    pop = population(p, 2, seed=model)
    t_eval = GRID[:9]
    rhs_t = st.rhs_batched({k: torch.as_tensor(v) for k, v in pop.items()})
    rng = np.random.default_rng(model)
    y = rng.uniform(0.1, 1.5, (2, sj.topo.N * sj.topo.width))
    jb = np.asarray([2, 5])
    J = batched_jacobian(rhs_t, torch.zeros(2), torch.as_tensor(y), torch.as_tensor(jb))
    J_want = np.stack([jax.jacfwd(lambda z, i=i: sj.rhs(
        0.0, z, int(jb[i]), jx({k: v[i] for k, v in pop.items()})))(jnp.asarray(y[i]))
        for i in range(2)])
    np.testing.assert_allclose(J.numpy(), J_want, rtol=0, atol=1e-12)

    want = jax.jit(jax.vmap(lambda q: jax_simulate(sj, q, jnp.asarray(t_eval),
                                                   solver="esdirk")))(jx(pop))
    got = simulate_batched(st, pop, t_eval, solver="esdirk")
    assert bool(got.success.all())
    assert_runs_match(got, want, atol=1e-12)


def test_esdirk_objective_matches_jax():
    """``make_objective(solver="esdirk")`` against ``jax.vmap`` of JAX's."""
    bj = jax_demo(n_proteins=4, n_kinases=2, seed=0, dtype=np.float64)
    bt = from_reference({k: bj[k] for k in KEYS}, device="cpu")
    rng = np.random.default_rng(3)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(2, len(bj["theta0"])))
    f_j = jax_make_objective(*(bj[k] for k in KEYS), solver="esdirk")
    want = np.asarray(jax.jit(jax.vmap(f_j))(jnp.asarray(thetas)))
    f_t = make_objective(*(bt[k] for k in KEYS), solver="esdirk")
    got = f_t(thetas)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)
    assert bool((f_t.n_steps > 0).all())


@pytest.mark.parametrize("smax", [1, 3, 4])
def test_flux_rules_match_jacfwd(smax):
    """The kernel route's rules, run here with the plain version as the
    launch: ``jacfwd`` through them in X and in (S, E) equals ``jacfwd`` of
    the plain version in two launches (the primal and every tangent column
    at once; none on the other inputs' zero tangents), and a doubly vmapped
    call equals the unbatched one in one launch."""
    rng = np.random.default_rng(smax)
    B, M = 5, 1 << smax
    X, S, E = (torch.as_tensor(rng.uniform(0.0, 2.0, shape))
               for shape in ((B, M), (B, smax), (B,)))
    via_rule = lambda x, s, e: FluxKernel.apply(x, s, e, smax, hypercube_flux_reference)
    plain = lambda x, s, e: hypercube_flux_reference(x, s, e, smax)
    with torch.no_grad():
        for argnums in (0, 1, 2):
            hypercube_flux_reference.calls = 0
            got = torch.func.jacfwd(via_rule, argnums=argnums)(X, S, E)
            assert hypercube_flux_reference.calls == 2
            assert torch.equal(got, torch.func.jacfwd(plain, argnums=argnums)(X, S, E))
        Xb = X[None, None] * torch.arange(1.0, 7.0, dtype=X.dtype).reshape(2, 3, 1, 1)
        hypercube_flux_reference.calls = 0
        got = torch.func.vmap(torch.func.vmap(lambda x: via_rule(x, S, E)))(Xb)
        assert hypercube_flux_reference.calls == 1
        assert torch.equal(got[1, 2], plain(Xb[1, 2], S, E))


@pytest.mark.parametrize("n_proteins, d, want", [
    (45, 765, 32),          # the model-2 bench network
    (45, 270, 256),         # model 0 on it
    (150, 900, 32),         # the north-star network
    (3, 12, 8192),          # a tiny network: the lanes' chunk bounds it
    (1, 8192, 1),           # a Jacobian past the budget alone
])
def test_esdirk_pop_chunk_bounds_the_jacobian(n_proteins, d, want):
    """``pop_chunk="auto"`` for ESDIRK: a power of two whose (P, d, d)
    Jacobian holds at most 2^25 entries, never above the lanes' chunk."""
    P = _esdirk_pop_chunk(n_proteins, d)
    assert P == want and P & (P - 1) == 0
    assert P * d * d <= 1 << 25 or P == 1
    assert P == 1 or 2 * P * d * d > 1 << 25 or P == _auto_pop_chunk(n_proteins)
