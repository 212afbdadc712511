"""The saturating mechanism (model 4) and the per-candidate exponential
integrator (``solver="expo"``) of the PyTorch port against the JAX package.

Seeded numpy inputs go through both packages on the CPU in float64: the
RHS and its block Jacobian, the chunk plan, the full phi matrices, the
exponential-Rosenbrock path, the per-candidate ETD2RK of models 0-2, the
RK45 oracle on model 4 (step counts included), the objectives, the global
fit and the demo bundle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network.analysis import simulate_until_steady as jax_until_steady
from phoskintime_tpu.network import GlobalSystem, build_kinase_matrix, build_topology
from phoskintime_tpu.network import default_params as jax_default_params
from phoskintime_tpu.network import expo as jexpo
from phoskintime_tpu.network.objective import make_objective as jax_make_objective
from phoskintime_tpu.network.objective import \
    make_population_objective as jax_population_objective
from phoskintime_tpu.network.optimize import run_global_fit as jax_fit
from phoskintime_tpu.network.params import unpack_params as jax_unpack
from phoskintime_tpu.network.simulate import simulate as jax_simulate
from phoskintime_tpu_torch.demo import build_demo_network
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network.analysis import simulate_until_steady
from phoskintime_tpu_torch.network import expo
from phoskintime_tpu_torch.network.objective import make_objective, make_population_objective
from phoskintime_tpu_torch.network.optimize import run_global_fit
from phoskintime_tpu_torch.network.simulate import simulate, simulate_batched

torch.set_num_threads(2)

GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])
# float64 on both sides, the same operations: the RHS and the blocks agree
# to rounding; a whole run to rounding accumulated over its steps
RTOL_RHS, ATOL_JAC, RTOL_RUN = 1e-12, 1e-12, 1e-9
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")


def make_system(model, seed=0):
    """The JAX package's four-protein test network (``tests/test_expo.py``):
    two proteins of one site, one of two, two kinases, two TF edges."""
    inter = pd.DataFrame({"protein": ["GA", "GA", "GB", "GC"],
                          "psite": ["S1", "S2", "S1", "S1"],
                          "kinase": ["K1", "K1", "K2", "K1"]})
    tf = pd.DataFrame({"tf": ["GA", "GC"], "target": ["GB", "GA"]})
    topo = build_topology(inter, tf, model=model)
    Kmat = build_kinase_matrix(topo.kinases, None, GRID)
    Kmat *= 1.0 + 0.25 * np.sin(np.arange(len(GRID)))[None, :]
    sj = GlobalSystem(topo, GRID, Kmat)
    rng = np.random.default_rng(seed)
    p = jax_default_params(topo)
    for k in ["c_k", "A_i", "B_i", "C_i", "D_i", "E_i"]:
        p[k] = rng.uniform(0.1, 1.5, p[k].shape)
    p["Dp_i"] = rng.uniform(0.2, 2.5, p["Dp_i"].shape) * topo.site_mask()
    p["tf_scale"] = 2.2
    return sj, from_reference(sj, device="cpu"), {k: np.asarray(v, float) for k, v in p.items()}


def population(p, P, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    return {k: v[None] * rng.uniform(1 - spread, 1 + spread, (P,) + (1,) * np.ndim(v))
            for k, v in p.items()}


def jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def tt(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def sat():
    return make_system(4, seed=3)


def random_states(sj, P, seed):
    rng = np.random.default_rng(seed)
    return np.abs(rng.normal(1.0, 0.5, (P, sj.topo.N * sj.topo.width)))


@pytest.mark.parametrize("jb", [0, 3, 13])
def test_rhs_matches_jax(sat, jb):
    """One member through ``__call__`` (with and without a frozen TF input)
    and a population through ``batched``, each member in its own bucket."""
    sj, st, p = sat
    pop = population(p, 4, seed=jb)
    Y = random_states(sj, 4, seed=jb)
    jbs = np.asarray([jb, max(jb - 1, 0), jb, 13])
    want = np.stack([np.asarray(sj.rhs(0.0, jnp.asarray(Y[i]), int(jbs[i]),
                                       jx({k: v[i] for k, v in pop.items()})))
                     for i in range(4)])
    got = st.rhs.batched(0.0, torch.as_tensor(Y), torch.as_tensor(jbs), tt(pop))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RHS, atol=1e-15)
    u = np.linspace(-0.5, 0.7, sj.topo.N)
    one = st.rhs(0.0, torch.as_tensor(Y[0]), jb, tt(p), u_override=torch.as_tensor(u))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(sj.rhs(0.0, jnp.asarray(Y[0]), jb, jx(p),
                                       u_override=jnp.asarray(u))),
        rtol=RTOL_RHS, atol=1e-15)


def test_jac_blocks_saturating_matches_jax(sat):
    """The analytic blocks against JAX's analytic blocks, JAX's jvp blocks
    and the port's own jvp blocks (``_jac_blocks_batched``)."""
    sj, st, p = sat
    N, w = sj.topo.N, sj.topo.width
    pop = population(p, 3, seed=1)
    Y = random_states(sj, 3, seed=1).reshape(3, N, w)
    Kt = st.rhs.Kmat[:, 3][None] * torch.as_tensor(pop["c_k"])
    got = st.rhs.jac_blocks_saturating(torch.as_tensor(Y), st.rhs.site_rates(Kt), tt(pop))
    pj = jx(pop)

    def jac_one(Yy, pp):
        return sj.rhs.jac_blocks_saturating(Yy, sj.rhs.site_rates(
            sj.rhs.kinase_activity(pp, 3)), pp)

    want = np.asarray(jax.jit(jax.vmap(jac_one))(jnp.asarray(Y), pj))
    want_jvp = np.asarray(jax.jit(lambda q, Yy: jexpo._jac_blocks_batched(
        sj, q, Yy, 3, 0.0, jnp.float64))(pj, jnp.asarray(Y)))
    got_jvp = expo._jac_blocks_batched(st, tt(pop), torch.as_tensor(Y), 3)
    assert got.shape == (3, N, w, w)
    for a, b in ((got, want), (got, want_jvp), (got_jvp, want_jvp), (got, got_jvp.numpy())):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=ATOL_JAC)


@pytest.mark.parametrize("substep", [16.0, 2.0])
def test_chunk_plan_identical(substep):
    plan = jexpo._segment_plan(tuple(GRID), tuple(GRID), substep)
    want = jexpo._chunk_plan(*plan[:4], 8)
    got = expo._chunk_plan(*plan[:3])
    for a, b in zip(got, want[:4]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[3].sum() == len(plan[0])


@pytest.mark.parametrize("ladder", ["dynamic", "masked", "unroll24"])
@pytest.mark.parametrize("w", [1, 4, 7])
def test_phi_matrices_lanes_match_jax(w, ladder):
    """Full E, Phi1, Phi2 by the port's ladder (to the largest count of the
    lanes) against each of JAX's: its dynamic ladder, its default masked
    one of 24 steps and its static ladder unrolled to 24, per-lane h."""
    rng = np.random.default_rng(w)
    B = 40
    L = rng.normal(0.0, 1.0, (w, w, B)) * rng.uniform(0.01, 6.0, B)
    h = rng.uniform(0.05, 16.0, B)
    got = expo._phi_matrices_lanes(torch.as_tensor(L), torch.as_tensor(h))
    kw = {"dynamic": dict(dynamic=True), "masked": {}, "unroll24": dict(unroll=24)}[ladder]
    want = jexpo._phi_matrices_lanes(jnp.asarray(L), jnp.asarray(h), **kw)
    for a, b in zip(got, want):
        scale = np.max(np.abs(np.asarray(b)), axis=(0, 1))
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   rtol=0, atol=1e-12)


def test_rosenbrock_batched_matches_jax(sat):
    """The population path of model 4: ``exponential_simulate_batched``;
    the options it ignores do not change the run."""
    sj, st, p = sat
    pop = population(p, 3, seed=2)
    ys_j, ok_j = jexpo.exponential_simulate_batched(sj, jx(pop), GRID)
    ys_t, ok_t = expo.exponential_simulate_batched(st, pop, GRID)
    assert ys_t.shape == ys_j.shape and bool(ok_t.all()) and bool(np.all(ok_j))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=RTOL_RUN, atol=1e-14)
    ys_o, _ = expo.exponential_simulate_batched(st, pop, GRID, use_scan_kernel=True,
                                                width_bucketing=True, use_kernel=False)
    assert torch.equal(ys_o, ys_t)


@pytest.mark.parametrize("model", [0, 1, 2, 4])
def test_exponential_simulate_matches_jax(model):
    """``solver="expo"`` per candidate: the port's population axis against
    ``jax.vmap`` of JAX's ``exponential_simulate``, step counts included
    (segments for models 0-2, output times for model 4); ``simulate`` of
    one member (the population's first) against its row."""
    sj, st, p = make_system(model)
    pop = population(p, 3, seed=model)
    want = jax.jit(jax.vmap(lambda q: jexpo.exponential_simulate(sj, q, GRID)))(jx(pop))
    got = expo.exponential_simulate(st, pop, GRID)
    assert bool(got.success.all()) and bool(np.all(want.success))
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), rtol=RTOL_RUN,
                               atol=1e-14)
    one = simulate(st, {k: v[0] for k, v in pop.items()}, GRID, solver="expo")
    assert one.ys.shape == got.ys.shape[1:] and bool(one.success)
    np.testing.assert_allclose(one.ys.numpy(), np.asarray(want.ys[0]), rtol=RTOL_RUN,
                               atol=1e-14)


def test_model4_rk45_matches_vmap(sat):
    """The RK45 oracle on model 4 against ``jax.vmap`` of JAX's ``simulate``:
    per-member step counts equal, trajectories to rounding."""
    sj, st, p = sat
    pop = population(p, 3, seed=5)
    want = jax.jit(jax.vmap(lambda q: jax_simulate(sj, q, jnp.asarray(GRID))))(jx(pop))
    got = simulate_batched(st, pop, GRID)
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    assert bool(got.success.all()) and bool(np.all(want.success))
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), rtol=RTOL_RUN,
                               atol=1e-12)


@pytest.fixture(scope="module")
def demo4():
    bj = jax_demo(n_proteins=6, n_kinases=3, model=4, seed=0, dtype=np.float64)
    return bj, from_reference({k: bj[k] for k in KEYS}, device="cpu")


def thetas_for(bj, P, seed=1):
    rng = np.random.default_rng(seed)
    return bj["theta0"][None] + 0.05 * rng.normal(size=(P, len(bj["theta0"])))


def test_model4_population_objective_matches_jax(demo4):
    bj, bt = demo4
    thetas = thetas_for(bj, 5)
    f_j = jax_population_objective(*(bj[k] for k in KEYS), use_pallas=False)
    want = np.asarray(jax.jit(f_j)(jnp.asarray(thetas)))
    got = make_population_objective(*(bt[k] for k in KEYS), pop_chunk=2)(thetas)
    assert got.shape == (5, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)


def test_expo_objective_matches_jax(demo4):
    """``make_objective(solver="expo", substep=8)`` against ``jax.vmap`` of
    JAX's per-candidate objective; its members' step counts against those
    of JAX's ``exponential_simulate`` on the same unpacked parameters."""
    bj, bt = demo4
    thetas = thetas_for(bj, 3, seed=4)
    f_j = jax_make_objective(*(bj[k] for k in KEYS), solver="expo", substep=8.0)
    want = np.asarray(jax.jit(jax.vmap(f_j))(jnp.asarray(thetas)))
    f_t = make_objective(*(bt[k] for k in KEYS), solver="expo", substep=8.0)
    got = f_t(thetas)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)
    steps_j = jax.jit(jax.vmap(lambda th: jexpo.exponential_simulate(
        bj["system"], jax_unpack(th, bj["slices"], bj["topo"]), bj["grid"],
        substep=8.0).n_steps))(jnp.asarray(thetas))
    assert f_t.n_steps.shape == (3,)
    np.testing.assert_array_equal(f_t.n_steps.numpy(), np.asarray(steps_j))


def test_model4_rk45_objective_and_steady_run_match_jax(demo4):
    """The RK45 oracle's users run model 4 unchanged: ``make_objective``
    against ``jax.vmap`` of JAX's, and ``simulate_until_steady``."""
    bj, bt = demo4
    thetas = thetas_for(bj, 2, seed=6)
    want = np.asarray(jax.jit(jax.vmap(jax_make_objective(*(bj[k] for k in KEYS))))(
        jnp.asarray(thetas)))
    np.testing.assert_allclose(make_objective(*(bt[k] for k in KEYS))(thetas).numpy(), want,
                               rtol=RTOL_RUN)
    kw = dict(t_final=120.0, n_points=20)
    got = simulate_until_steady(bt["system"], bj["true"], **kw)
    ref = jax_until_steady(bj["system"], jx(bj["true"]), **kw)
    for f in ("tot", "rna", "ss_value"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(ref, f)),
                                   rtol=RTOL_RUN, err_msg=f)
    np.testing.assert_array_equal(got.converged, ref.converged)


def test_run_global_fit_model4_matches_jax(demo4):
    """Pop 16, 2 generations, host variation: ``solver="auto"`` takes the
    exponential-Rosenbrock population objective in both packages."""
    bj, bt = demo4
    kw = dict(pop=16, n_gen=2, seed=0, device_variation=False, frechet_pick=False)
    want = jax_fit(*(bj[k] for k in KEYS), bj["xl"], bj["xu"], **kw)
    got = run_global_fit(*(bt[k] for k in KEYS), bj["xl"], bj["xu"], **kw)
    assert got.n_evals == want.n_evals == 48
    np.testing.assert_allclose(got.pareto_F, want.pareto_F, rtol=RTOL_RUN)
    np.testing.assert_allclose(got.X, want.X, rtol=RTOL_RUN)


def test_demo_bundle_model4_matches_jax(demo4):
    """``build_demo_network(model=4)``: the same draws and observations
    (RK45 at float64 on both sides) as the JAX package's, and a model-4
    system carried across by ``from_reference``."""
    bj, bc = demo4
    bt = build_demo_network(n_proteins=6, n_kinases=3, model=4, seed=0,
                            dtype=torch.float64, device="cpu")
    assert bt["topo"].model == bc["system"].topo.model == bc["system"].rhs.model == 4
    np.testing.assert_array_equal(bt["system"].Kmat, bj["system"].Kmat)
    for k in bj["true"]:
        np.testing.assert_array_equal(bt["true"][k], bj["true"][k], err_msg=k)
    np.testing.assert_array_equal(bt["theta0"], bj["theta0"])
    for f, a, b in zip(bj["loss_data"]._fields, bt["loss_data"], bj["loss_data"]):
        if f.startswith("obs"):
            np.testing.assert_allclose(a, b, rtol=RTOL_RUN, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(bc["system"].y0(), np.asarray(bj["system"].y0()))
