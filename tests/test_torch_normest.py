"""The port's per-gene estimator (``fit/normest.py``, ``models/weights.py``)
against the JAX package on the CPU at float64.

The genes are the JAX package's noise-free synthetic ones
(``tests/test_normest.py::synth_gene``), fitted at small settings (2
lambdas, 4 starts, 10 LM iterations) so that JAX's compile stays short.
Tolerances: the bounds, the multistart draws and the 17 weight schemes
exactly (the same numpy code and streams); a fit's lambda and weight name
equal, its params, score, error and CI bounds within rtol 1e-8.
"""

import numpy as np
import pytest

from phoskintime_tpu.fit.normest import _multistart_p0 as jax_multistart
from phoskintime_tpu.fit.normest import build_bounds as jax_build_bounds
from phoskintime_tpu.fit.normest import normest as jax_normest
from phoskintime_tpu.fit.normest import normest_batch as jax_normest_batch
from phoskintime_tpu.models import weights as jax_weights
from phoskintime_tpu_torch.fit.normest import _multistart_p0, build_bounds, normest, normest_batch
from phoskintime_tpu_torch.models import weights
from test_normest import BOUNDS, TIME_POINTS, synth_gene

FIT_RTOL = 1e-8
SMALL = dict(n_starts=4, lm_iters=10, lambdas=np.logspace(-2, 0, 2))


def assert_fit_close(got, want):
    assert got.lambda_reg == want.lambda_reg
    assert got.weight_name == want.weight_name
    for f in ("params", "popt_raw", "sol", "fit"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)),
                                   rtol=FIT_RTOL, atol=1e-300, err_msg=f)
    for f in ("score", "error", "regularization_term"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=FIT_RTOL, err_msg=f)
    assert (got.ci is None) == (want.ci is None)
    if want.ci is not None:
        for k in ("lwr_ci", "upr_ci", "se_lin"):
            np.testing.assert_allclose(got.ci[k], want.ci[k], rtol=FIT_RTOL, atol=1e-300,
                                       err_msg=k)
        assert got.ci["df_lin"] == want.ci["df_lin"]
    assert (got.boot_params is None) == (want.boot_params is None)
    if want.boot_params is not None:
        np.testing.assert_allclose(got.boot_params, want.boot_params, rtol=FIT_RTOL)


@pytest.mark.parametrize("model", ["distmod", "succmod", "randmod"])
def test_build_bounds_exact(model):
    for n in range(6):
        for got, want in zip(build_bounds(BOUNDS, n, model), jax_build_bounds(BOUNDS, n, model)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_starts", [1, 4, 48])
def test_multistart_draws_exact(n_starts):
    lb, ub = build_bounds(BOUNDS, 3, "randmod")
    base = np.random.default_rng(42).uniform(lb, ub)
    got = _multistart_p0(base, lb, ub, n_starts, 0.1, np.random.default_rng(7))
    want = jax_multistart(base, lb, ub, n_starts, 0.1, np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ms", [False, True])
@pytest.mark.parametrize("custom", [False, True])
def test_weight_schemes_exact(ms, custom):
    rng = np.random.default_rng(8)
    n, T = 2, len(TIME_POINTS)
    target = np.abs(rng.normal(1, 0.3, 9 + T + n * T))
    pr, p = target[9:9 + T], target[9 + T:].reshape(n, T)
    ew = weights.early_emphasis(pr, p, TIME_POINTS, n)
    np.testing.assert_array_equal(ew, jax_weights.early_emphasis(pr, p, TIME_POINTS, n))
    msw = rng.uniform(0.1, 1, T * (n + 1)) if ms else None
    got = weights.get_weight_options(target, TIME_POINTS, n, True, 8, ew, msw,
                                     use_custom_weights=custom)
    want = jax_weights.get_weight_options(target, TIME_POINTS, n, True, 8, ew, msw,
                                          use_custom_weights=custom)
    assert list(got) == list(want)
    assert len(got) == (16 + ms if custom else 1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x = rng.normal(size=11)
    np.testing.assert_array_equal(weights._uniform_filter1d(x, 3),
                                  jax_weights._uniform_filter1d(x, 3))


def test_protein_weights_raise_naming_the_host_layer():
    """The host layer is in: get_protein_weights reads the std table (the
    protein row, then input2's sites) as the JAX package does, and raises
    as it does for a gene input2 lacks (the full parity:
    tests/test_torch_io.py)."""
    import pandas as pd

    i1 = pd.DataFrame({"GeneID": ["G", "G"], "Psite": [np.nan, "S_1"],
                       **{f"x{i}_std": [0.1 * i, 0.2 * i] for i in range(1, 15)}})
    i2 = pd.DataFrame({"GeneID": ["G"], "Psite": ["S_1"]})
    cols = lambda df: {c: df[c].to_numpy(object if c in ("GeneID", "Psite") else float)
                       for c in df.columns}
    got = weights.get_protein_weights("G", cols(i1), cols(i2))
    np.testing.assert_array_equal(got, jax_weights.get_protein_weights("G", i1, i2))
    assert got.shape == (28,)
    with pytest.raises(ValueError, match="No entries"):
        weights.get_protein_weights("H", cols(i1), cols(i2))


@pytest.mark.parametrize("model,n,seed,kw", [
    ("distmod", 1, 6, dict(use_custom_weights=True)),
    ("distmod", 2, 5, {}),
    ("randmod", 2, 7, {}),
])
def test_normest_matches_jax(model, n, seed, kw):
    _, y0, pr, p, r = synth_gene(model, n, seed)
    args = ("GENEA", pr, p, r, y0, n, TIME_POINTS, BOUNDS)
    want = jax_normest(*args, model=model, **SMALL, **kw)
    got = normest(*args, model=model, device="cpu", **SMALL, **kw)
    assert_fit_close(got, want)
    assert got.params.dtype == np.float64 and got.sol.shape == np.asarray(want.sol).shape


def test_normest_bootstrap_matches_jax():
    _, y0, pr, p, r = synth_gene("distmod", 1, 8)
    args = ("GENED", pr, p, r, y0, 1, TIME_POINTS, BOUNDS)
    kw = dict(model="distmod", use_regularization=False, bootstraps=3, **SMALL)
    want = jax_normest(*args, **kw)
    got = normest(*args, device="cpu", **kw)
    assert got.boot_params.shape == (3, 6)
    assert_fit_close(got, want)


def cohort(model, n, seeds, names):
    data = [synth_gene(model, n, s) for s in seeds]
    y0 = data[0][1]
    return (list(names), np.stack([d[2] for d in data]), np.stack([d[3] for d in data]),
            np.stack([d[4] for d in data]), y0, n, TIME_POINTS, BOUNDS)


@pytest.mark.parametrize("bootstraps", [0, 2])
def test_normest_batch_matches_jax_and_single(bootstraps):
    args = cohort("distmod", 2, (5, 11), ("GENEA", "GENEX"))
    kw = dict(model="distmod", bootstraps=bootstraps, **SMALL)
    want = jax_normest_batch(*args, **kw)
    got = normest_batch(*args, device="cpu", **kw)
    assert list(got) == list(want) == ["GENEA", "GENEX"]
    for g in want:
        assert_fit_close(got[g], want[g])
    if bootstraps == 0:
        # the cohort fit equals the port's own single-gene fit of a member
        genes, pr, p, r, y0, n, tp, b = args
        single = normest("GENEX", pr[1], p[1], r[1], y0, n, tp, b, model="distmod",
                         device="cpu", **SMALL)
        assert_fit_close(got["GENEX"], single)
