"""The RK45 oracle path of the PyTorch port against the JAX package:
``odeint_rk45`` (a population axis in place of ``jax.vmap`` of a
``lax.while_loop``), ``simulate``, the RK45 ``make_objective`` and
``simulate_until_steady``.

Inputs are made with numpy from a seed and fed to both packages at float64
on the CPU, where the port's model-2 RHS runs the plain edge flux. A step
decision is discontinuous, so the tests hold the per-member step counts
equal, not only the trajectories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network.analysis import kinase_dominance as jax_dominance
from phoskintime_tpu.network.analysis import simulate_until_steady as jax_until_steady
from phoskintime_tpu.network.objective import make_objective as jax_make_objective
from phoskintime_tpu.network.simulate import simulate as jax_simulate
from phoskintime_tpu.ops.integrators import odeint_rk45 as jax_odeint
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network.analysis import (kinase_dominance,
                                                    simulate_until_steady)
from phoskintime_tpu_torch.network.objective import evaluate_population, make_objective
from phoskintime_tpu_torch.network.simulate import simulate, simulate_batched
from phoskintime_tpu_torch.ops.integrators import odeint_rk45

torch.set_num_threads(2)

# float64, the same steps on both sides: an entry agrees to 1e-9 of itself
# plus its member's largest entry. Small species late in a run pick up the
# rounding of ~1,500 steps (measured up to 5.5e-9 of an entry of 6e-3,
# 5.8e-12 of the member's largest entry, model 1 at t = 960)
RTOL_RUN = 1e-9
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")
N_EARLY = 11            # the demo grid's first 11 points: t = 0 .. 60


@pytest.fixture(scope="module", params=[0, 1, 2], ids=["model0", "model1", "model2"])
def bundles(request):
    bj = jax_demo(n_proteins=10, n_kinases=4, model=request.param, seed=0,
                  dtype=np.float64)
    return bj, from_reference({k: bj[k] for k in KEYS + ("true",)}, device="cpu")


def population(true, P, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, float)[None]
            * rng.uniform(1 - spread, 1 + spread, (P,) + (1,) * np.ndim(v))
            for k, v in true.items()}


def jax_odeint_vmapped(sj, pop, t_eval, **kw):
    y0 = jnp.asarray(sj.y0().reshape(-1))
    run = jax.jit(jax.vmap(lambda p: jax_odeint(
        sj.rhs_flat(p), y0, jnp.asarray(t_eval), boundaries=jnp.asarray(sj.kin_grid), **kw)))
    return run({k: jnp.asarray(v) for k, v in pop.items()})


def port_odeint(st, pop, t_eval, **kw):
    P = len(pop["c_k"])
    y0 = torch.as_tensor(st.y0().reshape(1, -1)).expand(P, -1).contiguous()
    return odeint_rk45(st.rhs_batched({k: torch.as_tensor(v) for k, v in pop.items()}),
                       y0, t_eval, boundaries=st.kin_grid, **kw)


def assert_runs_match(got, want):
    """Per member: equal step counts and success; ys as RTOL_RUN says."""
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    ys, ys_j = got.ys.numpy(), np.asarray(want.ys)
    assert ys.shape == ys_j.shape and got.ys.dtype == torch.float64
    scale = np.nanmax(np.abs(ys_j), axis=tuple(range(1, ys_j.ndim)), keepdims=True)
    bad = ~(np.abs(ys - ys_j) <= RTOL_RUN * (np.abs(ys_j) + scale))
    bad &= ~(np.isnan(ys) & np.isnan(ys_j))
    assert not bad.any(), f"{bad.sum()} entries differ, max {np.nanmax(np.abs(ys - ys_j))}"


def test_odeint_matches_jax_vmap(bundles):
    """Six members, each with its own parameters, steps and buckets."""
    bj, bt = bundles
    pop = population(bj["true"], 6, seed=1)
    t_eval = bj["grid"][:N_EARLY]
    kw = dict(max_steps=5000, dt_max=16.0)
    got = port_odeint(bt["system"], pop, t_eval, **kw)
    want = jax_odeint_vmapped(bj["system"], pop, t_eval, **kw)
    assert bool(got.success.all())
    assert len(set(got.n_steps.tolist())) > 1          # members step on their own
    assert_runs_match(got, want)


def test_failures_stay_in_their_rows():
    """Member 1 goes non-finite and member 3, ten times faster than the
    rest, runs out of steps: each fails in its own row only, as in the
    vmapped JAX loop, and the other rows are those of a run without them."""
    bj = jax_demo(n_proteins=10, n_kinases=4, model=0, seed=0, dtype=np.float64)
    sj, st = bj["system"], from_reference(bj["system"], device="cpu")
    t_eval = bj["grid"][:N_EARLY]
    clean = population(bj["true"], 5, seed=2)
    n_clean = port_odeint(st, clean, t_eval).n_steps.numpy()
    faulty = {k: v.copy() for k, v in clean.items()}
    faulty["A_i"][1, 0] = np.nan
    for k in ("c_k", "B_i", "C_i", "D_i", "E_i"):
        faulty[k][3] *= 10.0
    kw = dict(max_steps=int(n_clean.max()) + 10)
    got = port_odeint(st, faulty, t_eval, **kw)
    assert got.success.tolist() == [True, False, True, False, True]
    assert int(got.n_steps[1]) == 1 and int(got.n_steps[3]) == kw["max_steps"]
    assert_runs_match(got, jax_odeint_vmapped(sj, faulty, t_eval, **kw))
    ref = port_odeint(st, clean, t_eval, **kw)
    for p in (0, 2, 4):
        assert torch.equal(got.ys[p], ref.ys[p]) and got.n_steps[p] == ref.n_steps[p]


def test_odeint_without_boundaries_matches_jax():
    """dy/dt = -k y for members of their own rates: the closed form, and
    JAX's vmapped loop step for step."""
    k = np.asarray([0.1, 1.0, 7.0, 30.0])
    t_eval = np.asarray([0.0, 0.3, 1.0, 2.5, 6.0])
    y0 = np.ones((4, 3)) * np.asarray([1.0, 2.0, 0.5])
    got = odeint_rk45(lambda t, y: -torch.as_tensor(k)[:, None] * y, torch.as_tensor(y0),
                      t_eval)
    want = jax.vmap(lambda kk, yy: jax_odeint(lambda t, y: -kk * y, yy,
                                              jnp.asarray(t_eval)))(jnp.asarray(k),
                                                                    jnp.asarray(y0))
    assert_runs_match(got, want)
    exact = y0[:, None, :] * np.exp(-k[:, None, None] * t_eval[None, :, None])
    np.testing.assert_allclose(got.ys.numpy(), exact, rtol=1e-4, atol=1e-6)


def test_simulate_matches_jax(bundles):
    """One member at the true parameters: the JAX package's signature."""
    bj, bt = bundles
    t_eval = bj["grid"][:N_EARLY]
    got = simulate(bt["system"], bt["true"], t_eval)
    want = jax_simulate(bj["system"], {k: jnp.asarray(v) for k, v in bj["true"].items()},
                        jnp.asarray(t_eval))
    assert got.ys.shape == (len(t_eval), bt["system"].rhs.N * bt["system"].rhs.width)
    assert bool(got.success) and int(got.n_steps) == int(want.n_steps)
    assert_runs_match(got, want)
    # the batched form at P = 1 is the same run
    batched = simulate_batched(bt["system"], {k: np.asarray(v)[None]
                                              for k, v in bt["true"].items()}, t_eval)
    assert torch.equal(batched.ys[0], got.ys)


def early(ld, n):
    """The loss data's observations at the first n time points."""
    out = {}
    for mod in ("prot", "rna", "pho"):
        keep = np.asarray(getattr(ld, f"t_{mod}")) < n
        for f in ld._fields:
            if f.endswith(f"_{mod}"):
                out[f] = np.asarray(getattr(ld, f))[keep]
    return ld._replace(**out)


def test_make_objective_matches_jax(bundles):
    """pop 3 in chunks of 2, on the observations up to t = 60: F against
    jax.vmap of the JAX package's make_objective."""
    bj, bt = bundles
    rng = np.random.default_rng(4)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(3, len(bj["theta0"])))
    grid = bj["grid"][:N_EARLY]
    args_j = [bj["system"], bj["slices"], early(bj["loss_data"], N_EARLY), bj["defaults"],
              bj["lambdas"], grid]
    args_t = [bt["system"], bt["slices"], from_reference(args_j[2]), bt["defaults"],
              bt["lambdas"], grid]
    want = np.asarray(jax.jit(jax.vmap(jax_make_objective(*args_j)))(jnp.asarray(thetas)))
    objective = make_objective(*args_t, pop_chunk=2)
    got = evaluate_population(objective, thetas)
    assert got.shape == (3, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)
    # the members' step counts, the padded copy of the last row dropped
    assert objective.n_steps.shape == (3,) and bool((objective.n_steps > 0).all())


def test_objective_fail_value_per_member(bundles):
    """A member whose integration fails gets fail_value; the others keep
    their own F."""
    bj, bt = bundles
    thetas = np.repeat(bj["theta0"][None], 3, axis=0)
    thetas[1, 0] = np.nan
    args = [bt[k] for k in KEYS[:-1]] + [bj["grid"][:N_EARLY]]
    args[2] = from_reference(early(bj["loss_data"], N_EARLY))
    F = make_objective(*args, fail_value=1e12, pop_chunk=None)(thetas).numpy()
    np.testing.assert_array_equal(F[1], 1e12)
    assert np.isfinite(F).all() and (F[[0, 2]] < 1e12).all()
    np.testing.assert_array_equal(F[0], F[2])


def test_simulate_until_steady_matches_jax():
    bj = jax_demo(n_proteins=10, n_kinases=4, model=0, seed=0, dtype=np.float64)
    sj, st = bj["system"], from_reference(bj["system"], device="cpu")
    kw = dict(t_final=120.0, n_points=20)
    got = simulate_until_steady(st, bj["true"], **kw)
    want = jax_until_steady(sj, {k: jnp.asarray(v) for k, v in bj["true"].items()}, **kw)
    np.testing.assert_array_equal(got.times, want.times)
    for f in ("tot", "rna", "ss_value"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)),
                                   rtol=RTOL_RUN, err_msg=f)
    # a difference of two levels over the last interval: its own size, not
    # the levels', sets its rounding
    rate_tol = RTOL_RUN * np.max(np.abs(got.tot)) / (got.times[-1] - got.times[-2])
    np.testing.assert_allclose(got.final_rate, want.final_rate, rtol=0, atol=rate_tol)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_allclose(kinase_dominance(st, bj["true"]),
                               jax_dominance(sj, bj["true"]), rtol=1e-12)


@pytest.mark.parametrize("solver", ["esdirk", "expo"])
def test_other_solvers_are_not_ported(solver):
    """The other solver names run (they raised until ported): ``simulate``
    of one member to t = 8 against the JAX package's, the same steps."""
    bj = jax_demo(n_proteins=6, n_kinases=3, seed=0, dtype=np.float64)
    bt = from_reference({k: bj[k] for k in KEYS + ("true",)}, device="cpu")
    t_eval = bj["grid"][:7]
    got = simulate(bt["system"], bt["true"], t_eval, solver=solver)
    want = jax_simulate(bj["system"], {k: jnp.asarray(v) for k, v in bj["true"].items()},
                        jnp.asarray(t_eval), solver=solver)
    assert bool(got.success) and int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), rtol=RTOL_RUN,
                               atol=1e-14)
    assert callable(make_objective(*(bt[k] for k in KEYS), solver=solver))
