"""The port's kinopt (model, losses, projection, projected Adam, DE, the
evolutionary fits, KKT, data builders) against the JAX package's, on the
CPU in float64.

The same seeded numpy inputs go through both packages. The DE generation
is fed ``jax.random``'s draws, in the split order of JAX's
``run_de_device``. Whole evolutionary runs draw from the port's own
generator and are held to the quality gates of the JAX package's tests
(``tests/test_kinopt_tfopt.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.kinopt import data as jdata
from phoskintime_tpu.kinopt import kkt_check as jax_kkt_check
from phoskintime_tpu.kinopt import model as jmodel
from phoskintime_tpu.kinopt.optimize import run_local as jax_run_local
from phoskintime_tpu.ops import constrained as jcon
from phoskintime_tpu.ops.de_jit import run_de_device as jax_run_de_device
from phoskintime_tpu_torch.interop import kinopt_problem_from_reference
from phoskintime_tpu_torch.kinopt import data, kkt_check, model
from phoskintime_tpu_torch.kinopt.optimize import _Flat, run_evolutionary, run_local
from phoskintime_tpu_torch.ops.constrained import project_sum_box, projected_adam
from phoskintime_tpu_torch.ops.de_jit import DEDraws, de_generation, run_de_device

torch.set_num_threads(2)

T = 14
LOSSES = ["base", "weighted", "softl1", "cauchy", "arctan", "huber", "mape",
          "autocorrelation"]
RTOL_LOSS = 1e-12      # float64, the same operations: rounding only
RTOL_ADAM = 1e-9       # 200 steps of rounding


def kin_problem(seed=0):
    """3 sites, 2 kinases with known ground-truth weights (the JAX package's
    ``tests/test_kinopt_tfopt.py::kin_problem``)."""
    rng = np.random.default_rng(seed)
    K_array = rng.uniform(0.5, 2.0, (4, T))
    kinase_rows = [[0, 1], [2, 3]]
    site_kinases = [[0], [1], [0, 1]]
    beta_true = np.array([[0.7, 0.3], [0.4, 0.6]])
    alpha_true = np.array([[1.0, 0.0], [1.0, 0.0], [0.35, 0.65]])
    signal = np.stack([beta_true[j] @ K_array[kinase_rows[j]] for j in range(2)])
    P_obs = np.stack([signal[0], signal[1], 0.35 * signal[0] + 0.65 * signal[1]])
    return jmodel.build_problem(P_obs, site_kinases, kinase_rows, K_array), alpha_true, beta_true


def bench_problem(n_sites=30, n_kinases=5, rows=4, per_site=2, seed=0):
    """``benchmarks/bench_suite.py:250-256``'s generator (30 sites, 5
    kinases of 4 source rows, 2 kinases a site, T = 14)."""
    rng = np.random.default_rng(seed)
    K_array = rng.uniform(0.5, 2.0, (rows * n_kinases, T))
    kinase_rows = [list(range(rows * j, rows * j + rows)) for j in range(n_kinases)]
    site_kinases = [[(j + k) % n_kinases for k in range(per_site)] for j in range(n_sites)]
    beta = rng.dirichlet(np.ones(rows), n_kinases)
    sig = np.stack([beta[j] @ K_array[kinase_rows[j]] for j in range(n_kinases)])
    P_obs = np.stack([np.mean(sig[s], axis=0) for s in site_kinases])
    return jmodel.build_problem(P_obs, site_kinases, kinase_rows, K_array)


@pytest.fixture(scope="module")
def bench():
    pj = bench_problem()
    return pj, kinopt_problem_from_reference(pj)


def weights(prob, P=None, seed=0):
    """Random padded (alpha, beta), a leading population axis when P."""
    rng = np.random.default_rng(seed)
    lead = () if P is None else (P,)
    a = rng.uniform(-0.5, 1.5, lead + prob.gp_mask.shape) * prob.gp_mask
    b = rng.uniform(-0.5, 1.5, lead + prob.k_mask.shape) * prob.k_mask
    return a, b


@pytest.mark.parametrize("include_reg", [False, True])
@pytest.mark.parametrize("loss_type", LOSSES)
def test_predict_and_loss_match_jax(bench, loss_type, include_reg):
    """Every loss type, with and without the unweighted L1 + L2 term; a
    population of 4 in one call against each member alone in JAX."""
    pj, pt = bench
    A, B = weights(pj, P=4, seed=1)
    got = model.kinopt_loss(pt, torch.as_tensor(A), torch.as_tensor(B), loss_type, include_reg)
    want = [float(jmodel.kinopt_loss(pj, jnp.asarray(a), jnp.asarray(b), loss_type,
                                     include_reg)) for a, b in zip(A, B)]
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_LOSS)
    pred = model.predict(pt, torch.as_tensor(A), torch.as_tensor(B))
    for k in range(4):
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(jmodel.predict(
            pj, jnp.asarray(A[k]), jnp.asarray(B[k]))), rtol=RTOL_LOSS, atol=1e-15)


def test_constraints_match_jax(bench):
    pj, pt = bench
    a, b = weights(pj, seed=2)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_allclose(model.constraint_violations(pt, ta, tb).numpy(), np.asarray(
        jmodel.constraint_violations(pj, jnp.asarray(a), jnp.asarray(b))), rtol=RTOL_LOSS)
    for got, want in zip(model.violation_sq(pt, ta, tb),
                         jmodel.violation_sq(pj, jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL_LOSS)
    np.testing.assert_allclose(model.estimated_series(pt, a, b, device="cpu").numpy(),
                               np.asarray(jmodel.estimated_series(pj, a, b)), rtol=RTOL_LOSS)


def test_zero_at_truth():
    pj, a, b = kin_problem()
    pt = kinopt_problem_from_reference(pj)
    for lt in LOSSES[:-1]:
        assert float(model.kinopt_loss(pt, torch.as_tensor(a), torch.as_tensor(b), lt)) == \
            pytest.approx(0.0, abs=1e-12)
    assert pt.unpack(pt.pack(a, b))[0].tolist() == a.tolist()


def test_project_sum_box_matches_jax():
    """Rows over leading axes, bounds on both sides, an empty-mask row
    (``y * mask``), and a (G, W) mask serving a (P, G, W) population."""
    rng = np.random.default_rng(3)
    y = rng.normal(0.0, 2.0, (5, 6, 4))
    mask = rng.random((6, 4)) < 0.7
    mask[2] = False
    mask[3] = [True, False, False, False]
    want = np.stack([np.asarray(jcon.project_sum_box(jnp.asarray(yy), -1.0, 1.5,
                                                     jnp.asarray(mask))) for yy in y])
    got = project_sum_box(torch.as_tensor(y), -1.0, 1.5, torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.all(got[:, 2] == 0.0)
    np.testing.assert_allclose(got.sum(-1)[:, mask.any(1)], 1.0, atol=1e-12)


def jax_project(pj):
    gm, km = jnp.asarray(pj.gp_mask), jnp.asarray(pj.k_mask)
    return lambda x: (jcon.project_sum_box(x[0], pj.lb, pj.ub, gm),
                      jcon.project_sum_box(x[1], pj.lb, pj.ub, km))


def test_projected_adam_matches_jax(bench):
    """200 steps from 3 starts, rtol 1e-9 on the iterates and losses."""
    pj, pt = bench
    A, B = weights(pj, P=3, seed=4)
    proj = jax_project(pj)

    def one(a, b):
        (xa, xb), loss = jcon.projected_adam(lambda x: jmodel.kinopt_loss(pj, x[0], x[1]),
                                             (a, b), proj, steps=200, lr=0.02)
        return xa, xb, loss

    want = jax.jit(jax.vmap(one))(jnp.asarray(A), jnp.asarray(B))
    gm, km = torch.as_tensor(pt.gp_mask), torch.as_tensor(pt.k_mask)
    (xa, xb), loss = projected_adam(
        lambda x: model.kinopt_loss(pt, x[0], x[1]), (torch.as_tensor(A), torch.as_tensor(B)),
        lambda x: (project_sum_box(x[0], pt.lb, pt.ub, gm),
                   project_sum_box(x[1], pt.lb, pt.ub, km)), steps=200, lr=0.02)
    for g, w in zip((xa, xb, loss), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_ADAM, atol=1e-12)


def test_run_local_matches_jax():
    """The same numpy starts through both packages: alpha and beta within
    1e-8, the per-start losses at rtol 1e-9, the same picked start."""
    pj, *_ = kin_problem()
    pt = kinopt_problem_from_reference(pj)
    want = jax_run_local(pj, n_starts=6, steps=300, lr=0.05, seed=3)
    got = run_local(pt, n_starts=6, steps=300, lr=0.05, seed=3, device="cpu")
    assert np.argmin(got.all_losses) == np.argmin(want.all_losses)
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=RTOL_ADAM, atol=1e-20)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.beta, want.beta, rtol=0, atol=1e-8)
    assert got.feasible == want.feasible and got.feasible


def jax_de_draws(key, pop, d, n_gen):
    """JAX's ``run_de_device`` draws: the first population's uniforms, then
    each generation's (r, cross, jrand) from ``split(key, 4)``."""
    key, k0 = jax.random.split(key)
    u0 = np.asarray(jax.random.uniform(k0, (pop, d), jnp.float64))
    gens = []
    for _ in range(n_gen):
        key, k1, k2, k3 = jax.random.split(key, 4)
        gens.append(DEDraws(
            torch.as_tensor(np.array(jax.random.randint(k1, (3, pop), 0, pop))).long(),
            torch.as_tensor(np.array(jax.random.uniform(k2, (pop, d)))),
            torch.as_tensor(np.array(jax.random.randint(k3, (pop,), 0, d))).long()))
    return u0, gens


def test_de_generation_matches_jax(bench):
    """Three generations with the kinopt loss and the projection repair on
    JAX's draws: X, f and the history within 1e-12."""
    pj, pt = bench
    pop, n_gen = 24, 3
    n = pj.n_alpha + pj.n_beta
    xl, xu = np.full(n, pj.lb), np.full(n, pj.ub)
    am, bm = np.where(pj.gp_mask), np.where(pj.k_mask)
    gm, km = jnp.asarray(pj.gp_mask), jnp.asarray(pj.k_mask)

    def padded(X):
        A = jnp.zeros((X.shape[0],) + pj.gp_mask.shape, X.dtype).at[:, am[0], am[1]].set(
            X[:, :pj.n_alpha])
        B = jnp.zeros((X.shape[0],) + pj.k_mask.shape, X.dtype).at[:, bm[0], bm[1]].set(
            X[:, pj.n_alpha:])
        return A, B

    def j_eval(X):
        return jax.vmap(lambda a, b: jmodel.kinopt_loss(pj, a, b))(*padded(X))

    def j_repair(X):
        A, B = padded(X)
        A = jax.vmap(lambda a: jcon.project_sum_box(a, pj.lb, pj.ub, gm))(A)
        B = jax.vmap(lambda b: jcon.project_sum_box(b, pj.lb, pj.ub, km))(B)
        return jnp.concatenate([A[:, am[0], am[1]], B[:, bm[0], bm[1]]], axis=1)

    want = jax.jit(lambda: jax_run_de_device(j_eval, xl, xu, pop_size=pop, n_gen=n_gen,
                                             seed=5, repair_fn=j_repair))()
    u0, gens = jax_de_draws(jax.random.PRNGKey(5), pop, n, n_gen)
    flat = _Flat(pt, torch.device("cpu"))
    evaluate = lambda X: model.kinopt_loss(pt, *flat.padded(X))
    tl, tu = torch.as_tensor(xl), torch.as_tensor(xu)
    X = flat.repair(tl + torch.as_tensor(u0) * (tu - tl))
    f = evaluate(X)
    hist = []
    for draws in gens:
        X, f = de_generation(X, f, draws, evaluate, tl, tu, repair_fn=flat.repair)
        hist.append(float(f.min()))
    np.testing.assert_allclose(X.numpy(), np.asarray(want.X), rtol=0, atol=1e-12)
    np.testing.assert_allclose(f.numpy(), np.asarray(want.f), rtol=1e-12)
    np.testing.assert_allclose(hist, np.asarray(want.history), rtol=1e-12)


def test_evolutionary_de_quality():
    """The JAX package's gate: DE loss < 1e-2 and feasible (pop 60, 150
    generations), on the port's own generator."""
    pj, *_ = kin_problem()
    res = run_evolutionary(kinopt_problem_from_reference(pj), method="DE", pop_size=60,
                           n_gen=150, seed=1, device="cpu")
    assert res.loss < 1e-2 and res.feasible
    assert np.all(np.diff(res.all_losses) <= 0)


@pytest.mark.parametrize("gens_per_dispatch", [1, 10])
def test_evolutionary_nsga2_quality(gens_per_dispatch):
    """NSGA-II on the host and with the whole loop on the device: the loss
    finite, the picked member near-feasible after the projection repair."""
    pj, *_ = kin_problem()
    res = run_evolutionary(kinopt_problem_from_reference(pj), method="NSGA-II", pop_size=48,
                           n_gen=40, seed=1, gens_per_dispatch=gens_per_dispatch,
                           device="cpu")
    assert np.isfinite(res.loss) and res.feasible
    assert res.all_losses.shape == (40, 3)


def test_kkt_matches_jax():
    """``kkt_check`` at a local optimum equals JAX's report (floats 1e-10)."""
    pj, *_ = kin_problem()
    pt = kinopt_problem_from_reference(pj)
    res = jax_run_local(pj, n_starts=4, steps=400, lr=0.05, seed=3)
    want = jax_kkt_check(pj, res.alpha, res.beta, lambda a, b: jmodel.kinopt_loss(pj, a, b))
    got = kkt_check(pt, res.alpha, res.beta, lambda a, b: model.kinopt_loss(pt, a, b),
                    device="cpu")
    assert got.primal_feasible == want.primal_feasible and got.primal_feasible
    assert got.n_active_box == want.n_active_box
    for k in ("max_violation", "group_sums_alpha", "group_sums_beta", "stationarity_residual",
              "lagrange_alpha", "lagrange_beta"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-10, atol=1e-13,
                                   err_msg=k)


# --- the data builders ----------------------------------------------------------------


def input_frames(seed=0):
    """input1 (site rows, protein-level rows, a kinase with only a protein
    row, a kinase of KINASE_TO_PSITES with no row) and input2."""
    rng = np.random.default_rng(seed)
    rows = []
    for g, sites in [("GA", ["S1", "S2"]), ("GB", ["T5"]), ("KX", ["S9", "Y3"]),
                     ("KY", [np.nan]), ("KZ", ["S4"]), ("GC", ["", "S7"])]:
        for s in sites:
            rows.append([g, s, *rng.uniform(0.5, 3.0, T)])
    full = pd.DataFrame(rows, columns=["GeneID", "Psite", *[f"x{i}" for i in range(1, 15)]])
    inter = pd.DataFrame({
        "GeneID": ["GA", "GA", "GB", "GC", "GD", "KX"],
        "Psite": ["S1", "S2", "T5", "S7", "S1", "S9"],
        "Kinase": ["{KX, KY}", "{KZ}", "{KX,CDK5}", "{KY}", "{KX}", "{KZ, TTK}"]})
    return full, inter


def columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


SCALINGS = [("none", {}), ("min_max", {}), ("log", {}), ("temporal", {}),
            ("segmented", {"segment_points": [0, 5, 10, 14]}), ("slope", {}),
            ("cumulative", {})]


def assert_same_problem(got, want):
    for k in ("P_obs", "K_array", "gp_kin_idx", "gp_mask", "k_row_idx", "k_mask"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=0,
                                   err_msg=k)
    assert got.gp_names == want.gp_names and got.kinase_names == want.kinase_names


@pytest.mark.parametrize("estimate", [True, False])
@pytest.mark.parametrize("method,kw", SCALINGS)
def test_build_kinopt_problem_matches_jax(method, kw, estimate):
    """Column dicts through the port's builder against frames through the
    JAX package's, for every scaling method, with and without estimating
    the missing kinases."""
    full, inter = input_frames()
    want, wmeta = jdata.build_kinopt_problem(full, inter, scaling_method=method,
                                             estimate_missing_kinases=estimate, **kw)
    got, gmeta = data.build_kinopt_problem(columns(full), columns(inter),
                                           scaling_method=method,
                                           estimate_missing_kinases=estimate, **kw)
    assert_same_problem(got, want)
    assert gmeta == wmeta
    frame, _ = data.build_kinopt_problem(full, inter, scaling_method=method,
                                         estimate_missing_kinases=estimate, **kw)
    assert_same_problem(frame, want)


def test_load_and_check_kinases_match_jax(tmp_path):
    full, inter = input_frames(1)
    p1, p2 = tmp_path / "input1.csv", tmp_path / "input2.csv"
    full.to_csv(p1, index=False)
    inter.to_csv(p2, index=False)
    want, wmeta = jdata.load_kinopt_problem(p1, p2, scaling_method="min_max")
    got, gmeta = data.load_kinopt_problem(p1, p2, scaling_method="min_max")
    np.testing.assert_allclose(got.P_obs, want.P_obs, rtol=1e-15)
    np.testing.assert_allclose(got.K_array, want.K_array, rtol=1e-15)
    assert got.gp_names == want.gp_names and gmeta == wmeta
    assert data.check_kinases(columns(full), columns(inter)) == jdata.check_kinases(full, inter)
    with pytest.raises(ValueError, match="segment_points"):
        data.apply_scaling(columns(full), method="segmented")


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pj, *_ = kin_problem()
    pt = kinopt_problem_from_reference(pj)
    a, b = pt.unpack(np.full(pt.n_alpha + pt.n_beta, 0.5))
    for call in (lambda: run_local(pt, n_starts=2, steps=1),
                 lambda: run_evolutionary(pt, method="DE", pop_size=4, n_gen=1),
                 lambda: run_evolutionary(pt, pop_size=4, n_gen=1),
                 lambda: run_de_device(lambda X: X.sum(1), np.zeros(2), np.ones(2), n_gen=1),
                 lambda: model.estimated_series(pt, a, b),
                 lambda: kkt_check(pt, a, b, lambda x, y: x.sum())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
