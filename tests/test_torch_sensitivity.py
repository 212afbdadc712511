"""The port's network Morris sensitivity and its batched fold changes
against the JAX package's, on the CPU in float64.

``run_sensitivity_analysis`` on the demo network (models 0 and 2, 3
trajectories, a short time grid so that RK45 under ``jax.vmap`` stays
quick): the design, Y, the Morris indices and the perturbation clouds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network.simulate import Observables as JaxObservables
from phoskintime_tpu.network.simulate import extract_observables as jax_observables
from phoskintime_tpu.network.simulate import fold_changes as jax_fold_changes
from phoskintime_tpu.network.sensitivity import run_sensitivity_analysis as jax_sensitivity
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network.params import unpack_params
from phoskintime_tpu_torch.network.sensitivity import run_sensitivity_analysis
from phoskintime_tpu_torch.network.simulate import (extract_observables, fold_changes,
                                                    simulate_batched)

torch.set_num_threads(2)

TIMES = np.array([0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0])
# float64 RK45 held to JAX's step for step, then sums over the fold changes
RTOL = 1e-8


@pytest.fixture(scope="module", params=[0, 2], ids=["model0", "model2"])
def bundles(request):
    bj = jax_demo(n_proteins=6, n_kinases=3, model=request.param, seed=0, dtype=np.float64)
    return bj, from_reference({k: bj[k] for k in ("system", "slices")}, device="cpu")


def close(got, want, err_msg=""):
    """rtol 1e-8, with an absolute floor of 1e-8 of the largest |value| for
    entries near zero (a parameter of no effect)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.mark.parametrize("metric", ["total_signal", "l2_norm"])
def test_sensitivity_matches_jax(bundles, metric):
    """The same design and RK45 runs through both packages (JAX in one
    vmapped batch, the port in batches of 50): Y, mu, mu*, sigma, and the
    clouds."""
    bj, bt = bundles
    theta = bj["theta_true"]
    kw = dict(n_trajectories=3, metric=metric, top_curves=5, seed=3)
    want = jax_sensitivity(bj["system"], bj["slices"], theta, TIMES, batch_size=512, **kw)
    got = run_sensitivity_analysis(bt["system"], bt["slices"], theta, TIMES, batch_size=50,
                                   **kw)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert len(got.Y) == 3 * (len(theta) + 1) > 50
    close(got.Y, want.Y, "Y")
    for k in ("mu", "mu_star", "sigma", "mu_star_conf"):
        close(getattr(got.morris, k), getattr(want.morris, k), k)
    for k in ("rna", "protein", "phospho"):
        assert got.fc_clouds[k].shape == want.fc_clouds[k].shape
        close(got.fc_clouds[k], want.fc_clouds[k], k)


def test_unknown_metric_raises(bundles):
    bj, bt = bundles
    with pytest.raises(ValueError, match="Unknown metric"):
        run_sensitivity_analysis(bt["system"], bt["slices"], bj["theta_true"], TIMES[:3],
                                 n_trajectories=1, metric="nope")


def test_batched_fold_changes(bundles):
    """fold_changes of a population (P, T, ...) against P one-trajectory
    calls and against ``jax.vmap`` of JAX's ``fold_changes``: the baseline
    is each member's own time point."""
    bj, bt = bundles
    rng = np.random.default_rng(0)
    thetas = bj["theta_true"][None] + 0.05 * rng.normal(size=(3, len(bj["theta_true"])))
    sysj, syst = bj["system"], bt["system"]
    res = simulate_batched(syst, unpack_params(torch.as_tensor(thetas), bt["slices"],
                                               syst.topo), TIMES)
    obs = extract_observables(syst, res.ys)
    got = fold_changes(obs, TIMES)
    for p in range(3):
        one = fold_changes(extract_observables(syst, res.ys[p]), TIMES)
        for g, o in zip(got, one):
            assert torch.equal(g[p], o)
    jobs = jax.vmap(lambda y: jax_observables(sysj, y))(jnp.asarray(res.ys.numpy()))
    want = jax.vmap(lambda R, TOT, PHO: jax_fold_changes(
        JaxObservables(R, TOT, PHO, True), jnp.asarray(TIMES)))(jobs.R, jobs.TOT, jobs.PHO)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14)
