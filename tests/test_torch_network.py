"""Modules of the PyTorch port's network slice against the JAX package:
topology, loss data, parameter packing, RHS and linear blocks, the
segment plan, observables and the robust losses. Inputs come from a numpy
seed (or the JAX demo bundle, carried across by ``interop.from_reference``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network import expo as jexpo
from phoskintime_tpu.network.lossdata import prepare_loss_data as jax_loss_data
from phoskintime_tpu.network.params import unpack_params as jax_unpack
from phoskintime_tpu.network.simulate import extract_observables as jax_obs
from phoskintime_tpu.network.topology import build_topology as jax_topology
from phoskintime_tpu.ops import losses as jlosses
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import expo
from phoskintime_tpu_torch.network.kinase_input import build_kinase_matrix
from phoskintime_tpu_torch.network.lossdata import prepare_loss_data
from phoskintime_tpu_torch.network.params import (inv_softplus, softplus,
                                                  unpack_params)
from phoskintime_tpu_torch.network.rhs import PaddedRHS
from phoskintime_tpu_torch.network.simulate import (extract_observables,
                                                    fold_changes)
from phoskintime_tpu_torch.network.system import GlobalSystem
from phoskintime_tpu_torch.network.topology import build_topology
from phoskintime_tpu_torch.ops import losses

torch.set_num_threads(2)

# float64 on both sides, same algorithm: only the order of floating-point
# operations may differ
RTOL_F64 = 1e-12


@pytest.fixture(scope="module", params=[0, 1], ids=["model0", "model1"])
def bundles(request):
    """(JAX demo bundle at float64, the port's view of it)."""
    bj = jax_demo(n_proteins=10, n_kinases=4, model=request.param, seed=3,
                  dtype=np.float64)
    keys = ("system", "topo", "slices", "loss_data", "defaults", "true",
            "theta0", "grid", "lambdas")
    return bj, from_reference({k: bj[k] for k in keys}, device="cpu")


def thetas_for(bj, P, seed=1):
    rng = np.random.default_rng(seed)
    return bj["theta0"][None] + 0.05 * rng.normal(size=(P, len(bj["theta0"])))


# --- topology, kinase input, loss data -----------------------------------

INTERACTIONS = [("GA", "S10", "K1"), ("GA", "T5", "K2"), ("GA", "S10", "K2"),
                ("GB", "Y200", "K1"), ("K1", "S99", "K2"), ("GC", None, "K1"),
                ("GA", "S10", "K1")]
TF_EDGES = [("GA", "GB"), ("OT", "K2"), ("OT", "GC"), ("GC", "GA"),
            ("OT", "K1")]


def test_topology_from_tuples_matches_dataframes():
    kin_beta = {"K1": 0.2, "K2": 0.7}
    jt = jax_topology(pd.DataFrame(INTERACTIONS, columns=["protein", "psite", "kinase"]),
                      pd.DataFrame(TF_EDGES, columns=["tf", "target"]),
                      kin_beta_map=kin_beta, model=1)
    tt = build_topology(INTERACTIONS, TF_EDGES, kin_beta_map=kin_beta, model=1)
    for f in ("proteins", "kinases", "sites", "p2i", "k2i", "proxy_map", "model"):
        assert getattr(tt, f) == getattr(jt, f), f
    for f in ("n_sites", "driver_map", "W_pad", "tf_mat", "tf_deg"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)
    assert tt.proxy_map == {"OT": "K2"} and tt.width == jt.width


def test_kinase_matrix_and_loss_data_match():
    from phoskintime_tpu.network.kinase_input import \
        build_kinase_matrix as jax_kmat

    topo_j = jax_topology(pd.DataFrame(INTERACTIONS, columns=["protein", "psite", "kinase"]),
                          pd.DataFrame(TF_EDGES, columns=["tf", "target"]))
    topo = from_reference(topo_j)
    grid = np.array([0.0, 1.0, 4.0, 8.0])
    fc = [("K1", 1.0, 2.5), ("K2", 4.0, 0.0), ("K1", 8.0, 0.7), ("K1", 1.0, 3.0)]
    np.testing.assert_array_equal(
        build_kinase_matrix(topo.kinases, fc, grid),
        jax_kmat(topo_j.kinases, pd.DataFrame(fc, columns=["protein", "time", "fc"]), grid))

    prot = {"protein": ["GA", "GB", "GA"], "time": [0.0, 4.0, 8.0],
            "fc": [1.0, 1.2, 0.8], "w": [1.0, np.nan, 2.0]}
    rna = {"protein": ["GC", "OT"], "time": [4.0, 8.0], "fc": [1.0, 1.5]}
    pho = {"protein": ["GA", "GA", "ZZ", "GB"], "psite": ["T5", "S77", "S1", "Y200"],
           "time": [1.0, 1.0, 1.0, 8.0], "fc": [1.1, 9.0, 9.0, 0.5],
           "w": [0.5, 1.0, 1.0, 1.0]}
    want = jax_loss_data(topo_j, pd.DataFrame(prot), pd.DataFrame(rna),
                         pd.DataFrame(pho), grid)
    got = prepare_loss_data(topo, prot, rna, pho, grid)
    for f, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a, b, err_msg=f)
    with pytest.raises(ValueError, match="not in time_grid"):
        prepare_loss_data(topo, {**prot, "time": [0.0, 3.0, 8.0]}, rna, pho, grid)


def test_interop_carries_the_system(bundles):
    bj, bt = bundles
    sj, st = bj["system"], bt["system"]
    assert isinstance(st, GlobalSystem) and st.dtype == torch.float64
    np.testing.assert_array_equal(st.Kmat, sj.Kmat)
    np.testing.assert_array_equal(st.y0(), sj.y0())
    np.testing.assert_array_equal(st.topo.W_pad, sj.topo.W_pad)
    assert bt["slices"] == bj["slices"]
    for f, a, b in zip(bj["loss_data"]._fields, bt["loss_data"], bj["loss_data"]):
        np.testing.assert_array_equal(a, b, err_msg=f)


# --- parameters ------------------------------------------------------------


def test_softplus_threshold_semantics():
    x = np.array([-50.0, -1.0, 0.0, 3.0, 19.99, 20.0, 20.01, 80.0])
    got = softplus(torch.as_tensor(x)).numpy()
    from phoskintime_tpu.network.params import softplus as jax_softplus

    # libm's exp/log1p may differ from XLA's in the last bit
    np.testing.assert_allclose(got, np.asarray(jax_softplus(jnp.asarray(x))), rtol=1e-15)
    np.testing.assert_array_equal(got[x > 20], x[x > 20])    # identity above 20
    np.testing.assert_allclose(got[x <= 20], np.log1p(np.exp(x[x <= 20])), rtol=1e-15)
    np.testing.assert_allclose(softplus(torch.as_tensor(inv_softplus(got[1:]))).numpy(),
                               got[1:], rtol=1e-12)


def test_unpack_params_matches_jax(bundles):
    bj, bt = bundles
    thetas = thetas_for(bj, 4)
    got = unpack_params(torch.as_tensor(thetas), bt["slices"], bt["topo"])
    want = jax.vmap(lambda th: jax_unpack(th, bj["slices"], bj["topo"]))(jnp.asarray(thetas))
    # the order too (the live explorer emits it); jax.vmap returns the keys
    # sorted, so the order is that of one unbatched call
    assert list(got) == list(jax_unpack(jnp.asarray(thetas[0]), bj["slices"], bj["topo"]))
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL_F64)


# --- RHS, linear blocks, plan ---------------------------------------------


def params_pair(bj, bt, P=3):
    thetas = thetas_for(bj, P)
    pt = unpack_params(torch.as_tensor(thetas), bt["slices"], bt["topo"])
    pj = jax.vmap(lambda th: jax_unpack(th, bj["slices"], bj["topo"]))(jnp.asarray(thetas))
    return pt, pj


def test_linear_blocks_lanes_match_jax(bundles):
    bj, bt = bundles
    pt, pj = params_pair(bj, bt)
    buckets = np.asarray([0, 2, 5, 13])
    got = expo._linear_blocks_lanes(bt["system"], pt, buckets)
    want = jexpo._linear_blocks_lanes(bj["system"], pj, buckets, jnp.float64,
                                      bj["topo"].N)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_F64, atol=1e-15)


def test_rhs_and_linear_blocks_match_jax(bundles):
    bj, bt = bundles
    pt, pj = params_pair(bj, bt, P=1)
    p_t = {k: v[0] for k, v in pt.items()}
    p_j = {k: v[0] for k, v in pj.items()}
    rhs_t, rhs_j = bt["system"].rhs, bj["system"].rhs
    rng = np.random.default_rng(2)
    y = rng.uniform(0.1, 2.0, bt["topo"].N * bt["topo"].width)
    for jb in (0, 4, 13, 20):
        np.testing.assert_allclose(
            rhs_t(0.0, torch.as_tensor(y), jb, p_t).numpy(),
            np.asarray(rhs_j(0.0, jnp.asarray(y), jb, p_j)), rtol=RTOL_F64, atol=1e-15)
        S_t = rhs_t.site_rates(rhs_t.kinase_activity(p_t, jb))
        S_j = rhs_j.site_rates(rhs_j.kinase_activity(p_j, jb))
        np.testing.assert_allclose(rhs_t.linear_blocks(S_t, p_t).numpy(),
                                   np.asarray(rhs_j.linear_blocks(S_j, p_j)),
                                   rtol=RTOL_F64, atol=1e-15)
    # the affine split: rhs(y) = L y + synthesis e0 with u frozen at 0
    u0 = torch.zeros(bt["topo"].N, dtype=torch.float64)
    S_t = rhs_t.site_rates(rhs_t.kinase_activity(p_t, 4))
    Ly = torch.einsum("nij,nj->ni", rhs_t.linear_blocks(S_t, p_t),
                      torch.as_tensor(y).reshape(bt["topo"].N, -1))
    dy = rhs_t(0.0, torch.as_tensor(y), 4, p_t, u_override=u0).reshape(Ly.shape)
    np.testing.assert_allclose((dy - Ly)[:, 1:].numpy(), 0.0, atol=1e-13)
    np.testing.assert_allclose((dy - Ly)[:, 0].numpy(), p_t["A_i"].numpy(), rtol=1e-12)


@pytest.mark.parametrize("substep", [16.0, 4.0, 60.0])
def test_segment_plan_identical(bundles, substep):
    bj, _ = bundles
    key = (tuple(np.asarray(bj["system"].kin_grid, float)),
           tuple(np.asarray(bj["grid"], float)), substep)
    got, want = expo._segment_plan(*key), jexpo._segment_plan(*key)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    runs, out_pos = expo._run_plan(got[4], got[3])
    runs_j, out_pos_j = jexpo._run_plan(want[4], want[3])
    assert runs == runs_j
    np.testing.assert_array_equal(out_pos, out_pos_j)


def test_bench_plan_shape():
    """The bench problem's plan: 133 segments over 14 (bucket, h) pairs."""
    from phoskintime_tpu_torch.demo import GRID, RNA_GRID

    t_eval = np.unique(np.concatenate([GRID, RNA_GRID]))
    plan = expo._segment_plan(tuple(GRID), tuple(t_eval), 16.0)
    assert len(plan[0]) == 133 and len(plan[6]) == 14 and len(t_eval) == 15
    assert len(np.unique(plan[5])) == 13


def test_simulate_batched_and_observables_match_jax(bundles):
    bj, bt = bundles
    pt, pj = params_pair(bj, bt, P=3)
    ys_t, ok_t = expo.exponential_simulate_batched(bt["system"], pt, bt["grid"])
    ys_j, ok_j = jexpo.exponential_simulate_batched(bj["system"], pj, bj["grid"],
                                                    use_pallas=False)
    assert bool(ok_t.all()) and bool(np.all(ok_j))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-10, atol=1e-14)
    obs_t = extract_observables(bt["system"], ys_t)
    obs_j = jax_obs(bj["system"], ys_j[1])
    for a, b in zip(obs_t, obs_j[:3]):
        np.testing.assert_allclose(a[1].numpy(), np.asarray(b), rtol=1e-10)
    fc = fold_changes(extract_observables(bt["system"], ys_t[0]), bt["grid"])
    assert fc[0].shape == (len(bt["grid"]), bt["topo"].N)
    np.testing.assert_allclose(fc[0][int(np.argmin(np.abs(bt["grid"] - 4.0)))].numpy(), 1.0)


def test_unported_mechanisms_raise(bundles):
    """Models 2 and 4 build (their parity tests are in test_torch_model2.py
    and test_torch_model4.py; the differentiable path's in
    test_torch_polish.py)."""
    _, bt = bundles
    topo = bt["topo"]
    for model in (2, 4):
        tm = type(topo)(**{**topo.__dict__, "model": model})
        assert PaddedRHS(tm, bt["system"].Kmat, device="cpu").model == model


# --- losses ----------------------------------------------------------------


@pytest.mark.parametrize("mode", range(8))
def test_robust_losses_match_jax(mode):
    rng = np.random.default_rng(mode)
    obs = rng.uniform(0.05, 3.0, 64)
    pred = np.concatenate([rng.uniform(0.05, 3.0, 60), [1e-12, 25.0, 0.5, -0.3]])
    diff = obs - pred
    diff[:4] = [0.0, 0.5, -0.5, 40.0]        # huber/log-cosh branch edges
    got = losses.robust_loss(mode)(torch.as_tensor(diff), torch.as_tensor(pred),
                                   torch.as_tensor(obs))
    want = jlosses.robust_loss(mode)(jnp.asarray(diff), jnp.asarray(pred),
                                     jnp.asarray(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-300)
