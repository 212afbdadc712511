"""The combinatorial mechanism (model 2) in the PyTorch port against the JAX
package: hypercube tables, RHS, initial state, observables, the block
operators recovered by forward-mode differentiation, the width-class plan,
the batched ETD2RK path (width-bucketed and not), the population objective,
and the plain wide-block tables against the Pallas kernels in interpret
mode. Inputs are made with numpy from a seed and fed to both packages at
float64 on the CPU, where the port runs its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network import GlobalSystem as JaxSystem
from phoskintime_tpu.network import build_kinase_matrix as jax_kmat
from phoskintime_tpu.network import build_topology as jax_topology
from phoskintime_tpu.network import expo as jexpo
from phoskintime_tpu.network.objective import \
    make_population_objective as jax_objective
from phoskintime_tpu.network.params import unpack_params as jax_unpack
from phoskintime_tpu.network.rhs import _hypercube_tables as jax_hypercube
from phoskintime_tpu.network.simulate import extract_observables as jax_obs
from phoskintime_tpu.ops.phi_pallas import (phi_vectors_pallas,
                                            phi_vectors_pallas_all)
from phoskintime_tpu_torch.demo import build_demo_network
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import expo
from phoskintime_tpu_torch.network.objective import make_population_objective
from phoskintime_tpu_torch.network.params import unpack_params
from phoskintime_tpu_torch.network.rhs import PaddedRHS, _hypercube_tables
from phoskintime_tpu_torch.network.simulate import extract_observables
from phoskintime_tpu_torch.network.system import GlobalSystem
from phoskintime_tpu_torch.ops.cuda_build import MAX_SHARED_BYTES
from phoskintime_tpu_torch.ops.phi_tables import (ladder_len, phi_tables,
                                                  phi_tables_reference, phi_tables_wide,
                                                  phi_vectors, wide_launch_shape)

torch.set_num_threads(2)

# float64 on both sides, same algorithm: only the order of floating-point
# operations differs (measured ~1e-15)
RTOL_F64 = 1e-12
# a whole ETD2RK run or objective: 133 steps of the same tables
RTOL_RUN = 1e-9
# float32 tables of one algorithm in two builds, relative to the largest
# entry: the JAX package's own tolerance for its Pallas table kernels
SCALED_ATOL_F32 = 2e-5
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")
GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])


@pytest.fixture(scope="module")
def demo():
    """(JAX model-2 demo bundle at float64, N = 12, w = 17; the port's view)."""
    bj = jax_demo(n_proteins=10, n_kinases=4, model=2, seed=0, dtype=np.float64)
    keys = KEYS + ("topo", "theta0", "true")
    return bj, from_reference({k: bj[k] for k in keys}, device="cpu")


def hetero():
    """(JAX system, parameters) of a model-2 network with site counts
    1/1/2/3, block widths 3/3/5/9, as tests/test_expo.py's."""
    inter = pd.DataFrame({
        "protein": ["GA", "GA", "GB", "GC", "GD", "GD", "GD"],
        "psite": ["S1", "S2", "S1", "S1", "S1", "S2", "S3"],
        "kinase": ["K1", "K1", "K2", "K1", "K2", "K1", "K2"],
    })
    tf = pd.DataFrame({"tf": ["GA", "GC", "GD"], "target": ["GB", "GA", "GC"]})
    topo = jax_topology(inter, tf, model=2)
    Kmat = jax_kmat(topo.kinases, None, GRID)
    Kmat *= 1.0 + 0.25 * np.sin(np.arange(len(GRID)))[None, :]
    rng = np.random.default_rng(0)
    p = {"c_k": rng.uniform(0.1, 1.5, topo.K), "tf_scale": 2.2}
    for k in ("A_i", "B_i", "C_i", "D_i", "E_i"):
        p[k] = rng.uniform(0.1, 1.5, topo.N)
    p["Dp_i"] = rng.uniform(0.2, 2.5, (topo.N, topo.max_sites)) * topo.site_mask()
    return JaxSystem(topo, GRID, Kmat), p


def population(p, P=3, seed=1):
    """P members scattered around ``p``, numpy, a leading axis on every leaf."""
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, float)[None]
            * rng.uniform(0.7, 1.3, (P,) + (1,) * np.ndim(v)) for k, v in p.items()}


def unpacked(bj, bt, P=3, seed=1):
    rng = np.random.default_rng(seed)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(P, len(bj["theta0"])))
    pt = unpack_params(torch.as_tensor(thetas), bt["slices"], bt["topo"])
    pj = jax.vmap(lambda th: jax_unpack(th, bj["slices"], bj["topo"]))(jnp.asarray(thetas))
    return pt, pj


def lanes(blocks_pb):
    """JAX (P, Bu, N, w, w) blocks -> the port's (Bu, w, w, P*N) lanes."""
    P, Bu, N, w, _ = blocks_pb.shape
    return np.transpose(np.asarray(blocks_pb), (1, 3, 4, 0, 2)).reshape(Bu, w, w, P * N)


# --- tables, RHS, y0, observables ---------------------------------------------


@pytest.mark.parametrize("smax", [1, 2, 4, 5])
def test_hypercube_tables_match_jax(smax):
    for got, want in zip(_hypercube_tables(smax), jax_hypercube(smax)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_rhs_y0_and_observables_match_jax(demo):
    bj, bt = demo
    sj, st = bj["system"], bt["system"]
    assert st.topo.width == sj.topo.width == 17 and st.rhs.Mmax == 16
    assert st.topo.max_states == sj.topo.max_states
    np.testing.assert_array_equal(st.topo.state_mask(), sj.topo.state_mask())
    np.testing.assert_array_equal(st.y0(), sj.y0())
    pt, pj = unpacked(bj, bt, P=1)
    p_t = {k: v[0] for k, v in pt.items()}
    p_j = {k: v[0] for k, v in pj.items()}
    rng = np.random.default_rng(2)
    N, w = st.topo.N, st.topo.width
    y = rng.uniform(0.1, 2.0, N * w)
    for jb in (0, 4, 13, 20):
        np.testing.assert_allclose(
            st.rhs(0.0, torch.as_tensor(y), jb, p_t).numpy(),
            np.asarray(sj.rhs(0.0, jnp.asarray(y), jb, p_j)), rtol=RTOL_F64, atol=1e-15)
    u0 = np.linspace(-0.5, 0.5, N)
    np.testing.assert_allclose(
        st.rhs(0.0, torch.as_tensor(y), 3, p_t, u_override=torch.as_tensor(u0)).numpy(),
        np.asarray(sj.rhs(0.0, jnp.asarray(y), 3, p_j, u_override=jnp.asarray(u0))),
        rtol=RTOL_F64, atol=1e-15)
    np.testing.assert_allclose(st.rhs.total_protein(torch.as_tensor(y.reshape(N, w))).numpy(),
                               np.asarray(sj.rhs.total_protein(jnp.asarray(y.reshape(N, w)))),
                               rtol=RTOL_F64)

    Y = rng.uniform(0.1, 2.0, (2, 5, N * w))          # (P, T, N*w)
    got = extract_observables(st, torch.as_tensor(Y))
    for p in range(2):
        want = jax_obs(sj, jnp.asarray(Y[p]))
        for g, r in zip(got, want[:3]):
            np.testing.assert_allclose(g[p].numpy(), np.asarray(r), rtol=RTOL_F64)
    assert got.PHO.shape == (2, 5, N, st.topo.max_sites)


# --- block operators and the width-class plan ---------------------------------


def test_block_operators_match_jax(demo):
    bj, bt = demo
    pt, pj = unpacked(bj, bt, P=2)
    buckets = np.asarray([0, 3, 13])
    sj = bj["system"]
    got = expo._block_linear_operators(bt["system"], pt, buckets)
    want = jax.jit(jax.vmap(lambda p: jexpo._block_linear_operators(
        sj, p, buckets, jnp.float64)))(pj)
    assert tuple(got.shape) == (3, 17, 17, 2 * 12)
    np.testing.assert_allclose(got.numpy(), lanes(want), rtol=RTOL_F64, atol=1e-15)

    for wc, idx in expo.width_classes(bt["topo"]):
        got = expo._block_linear_operators_class(bt["system"], pt, buckets, idx, wc)
        want = jax.jit(jax.vmap(lambda p: jexpo._block_linear_operators_class(
            sj, p, buckets, jnp.float64, idx, wc)))(pj)
        np.testing.assert_allclose(got.numpy(), lanes(want), rtol=RTOL_F64, atol=1e-15,
                                   err_msg=f"class w={wc}")


def test_blocks_are_the_rhs_derivative(demo):
    """The written-out blocks are the Jacobian of the port's own RHS with
    the TF input frozen, recovered by torch.func.jvp through the
    out-of-place hypercube RHS, one probe column at a time."""
    bj, bt = demo
    st = bt["system"]
    rhs, N, w = st.rhs, st.topo.N, st.topo.width
    pt, _ = unpacked(bj, bt, P=1)
    p0 = {k: v[0] for k, v in pt.items()}
    u0, y_lin = torch.zeros(N, dtype=torch.float64), torch.zeros(N * w, dtype=torch.float64)
    for jb in (2, 9):
        blocks = expo._block_linear_operators(st, pt, np.asarray([jb]))[0]   # (w, w, N)
        for col in range(w):
            probe = torch.zeros((N, w), dtype=torch.float64)
            probe[:, col] = 1.0
            _, tangent = torch.func.jvp(lambda y: rhs(0.0, y, jb, p0, u_override=u0),
                                        (y_lin,), (probe.reshape(-1),))
            np.testing.assert_allclose(blocks[:, col, :].T.numpy(),
                                       tangent.reshape(N, w).numpy(),
                                       rtol=RTOL_F64, atol=1e-15)


def expected_classes(n_sites, N):
    """The JAX package's greedy merge, as its docstring states it: ascending
    widths 1 + 2^s accumulate until a group holds >= 5% of the proteins,
    the group takes its largest width; protein order within a group is by
    width, then by index."""
    ws = 1 + 2 ** np.asarray(n_sites)
    out, acc = [], []
    for wc in sorted(set(ws.tolist())):
        acc += list(np.flatnonzero(ws == wc))
        if len(acc) >= 0.05 * N or wc == ws.max():
            out.append((wc, acc))
            acc = []
    return out


def test_width_class_plan():
    """The bench problem's model-2 plan (measured with the JAX package at
    N = 45: five classes (w, proteins) = (2, 7), (3, 12), (5, 9), (9, 7),
    (17, 10)), a merge of rare widths, and the auto and forced rules."""
    topo = build_demo_network(40, 12, model=2, seed=0, device="cpu")["topo"]
    classes = expo.width_classes(topo)
    assert [(wc, len(idx)) for wc, idx in classes] == [(2, 7), (3, 12), (5, 9), (9, 7), (17, 10)]
    for (wc, idx), (wc_e, idx_e) in zip(classes, expected_classes(topo.n_sites, topo.N)):
        assert wc == wc_e
        np.testing.assert_array_equal(idx, idx_e)
    perm = np.concatenate([idx for _, idx in classes])
    np.testing.assert_array_equal(np.sort(perm), np.arange(topo.N))

    # one protein of width 3 among 40 (2.5%) merges into the next class
    n_sites = np.asarray([0] * 20 + [1] + [4] * 19, np.int32)
    rare = type(topo)(**{**topo.__dict__, "n_sites": n_sites,
                         "proteins": [f"P{i}" for i in range(40)]})
    got = expo.width_classes(rare)
    assert [(wc, list(idx)) for wc, idx in got] == [(2, list(range(20))),
                                                    (17, list(range(20, 40)))]
    assert expo.width_classes(rare, False) == []
    t0 = type(topo)(**{**topo.__dict__, "model": 0})
    assert expo.width_classes(t0, True) == []


# --- the integrator and the objective -------------------------------------------


def jax_simulate(sj, pb, grid, **kw):
    fn = jax.jit(lambda p: jexpo.exponential_simulate_batched(
        sj, p, grid, use_pallas=False, **kw))
    ys, ok = fn({k: jnp.asarray(v) for k, v in pb.items()})
    return np.asarray(ys), np.asarray(ok)


@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "unbucketed"])
@pytest.mark.parametrize("case", ["hetero_w9", "demo_w17"])
def test_simulate_matches_jax(demo, case, bucketed):
    if case == "hetero_w9":
        sj, p = hetero()
        st, grid, substep = from_reference(sj, device="cpu"), GRID, 8.0
        pb = population(p)
    else:
        bj, bt = demo
        sj, st, grid, substep = bj["system"], bt["system"], bt["grid"], 16.0
        pb = population(bt["true"])
    got, ok = expo.exponential_simulate_batched(st, pb, grid, substep=substep,
                                                width_bucketing=bucketed)
    want, ok_j = jax_simulate(sj, pb, grid, substep=substep, width_bucketing=bucketed)
    assert bool(ok.all()) and bool(ok_j.all())
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN, atol=1e-14)


def test_bucketed_matches_unbucketed():
    """Width classes are exact: the padded rows and columns of every block
    are zero (the JAX package's own check, tests/test_expo.py)."""
    sj, p = hetero()
    st = from_reference(sj, device="cpu")
    assert [wc for wc, _ in expo.width_classes(st.topo)] == [3, 5, 9]
    pb = population(p)
    ys_b, ok_b = expo.exponential_simulate_batched(st, pb, GRID, substep=8.0,
                                                   width_bucketing=True)
    ys_f, ok_f = expo.exponential_simulate_batched(st, pb, GRID, substep=8.0,
                                                   width_bucketing=False)
    assert bool(ok_b.all()) and bool(ok_f.all())
    np.testing.assert_allclose(ys_b.numpy(), ys_f.numpy(), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("bucketed", [None, False], ids=["auto", "unbucketed"])
def test_population_objective_matches_jax(demo, bucketed):
    """pop 4 in one chunk (chunking is covered for models 0/1 in
    test_torch_objective.py)."""
    bj, bt = demo
    rng = np.random.default_rng(3)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(4, len(bj["theta0"])))
    f_j = jax_objective(*(bj[k] for k in KEYS), use_pallas=False, pop_chunk=None,
                        width_bucketing=bucketed)
    want = np.asarray(jax.jit(f_j)(jnp.asarray(thetas)))
    got = make_population_objective(*(bt[k] for k in KEYS), pop_chunk=None,
                                    width_bucketing=bucketed)(thetas)
    assert got.shape == (4, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)


def test_population_objective_matches_jax_at_six_sites():
    """Model 2 at ``mechanisms``' default cap of 6 sites: width classes
    3, 33 and 65 (the last two those of ``csrc/phi_tables_xwide.cu`` on
    the card), bucketed as by default, pop 3 in one chunk."""
    bj = jax_demo(n_proteins=6, n_kinases=3, max_sites=6, model=2, seed=0, dtype=np.float64)
    bt = from_reference({k: bj[k] for k in KEYS + ("topo",)}, device="cpu")
    assert {33, 65} <= {wc for wc, _ in expo.width_classes(bt["topo"])}
    rng = np.random.default_rng(6)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(3, len(bj["theta0"])))
    f_j = jax_objective(*(bj[k] for k in KEYS), use_pallas=False, pop_chunk=None)
    want = np.asarray(jax.jit(f_j)(jnp.asarray(thetas)))
    got = make_population_objective(*(bt[k] for k in KEYS), pop_chunk=None)(thetas)
    assert got.shape == (3, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)


def test_population_objective_matches_jax_at_seven_sites():
    """Model 2 with a protein of 7 sites (seed 20: width classes 2, 3, 5
    and 129, the last the widest of ``csrc/phi_tables_xwide.cu`` on the
    card), bucketed as by default, pop 3 in one chunk, against JAX's
    objective without Pallas."""
    bj = jax_demo(n_proteins=6, n_kinases=3, max_sites=7, model=2, seed=20, dtype=np.float64)
    bt = from_reference({k: bj[k] for k in KEYS + ("topo",)}, device="cpu")
    assert 129 in {wc for wc, _ in expo.width_classes(bt["topo"])}
    rng = np.random.default_rng(7)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(3, len(bj["theta0"])))
    f_j = jax_objective(*(bj[k] for k in KEYS), use_pallas=False, pop_chunk=None)
    want = np.asarray(jax.jit(f_j)(jnp.asarray(thetas)))
    got = make_population_objective(*(bt[k] for k in KEYS), pop_chunk=None)(thetas)
    assert got.shape == (3, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)


def test_population_objective_matches_jax_at_eight_sites():
    """Model 2 with a protein of 8 sites (seed 7: width classes 2, 3, 9 and
    257, the last the stream kernel's on the card; the JAX package takes
    any width), bucketed as by default, pop 3 in one chunk, float64,
    against JAX's objective without Pallas."""
    bj = jax_demo(n_proteins=4, n_kinases=3, max_sites=8, model=2, seed=7, dtype=np.float64)
    bt = from_reference({k: bj[k] for k in KEYS + ("topo",)}, device="cpu")
    assert 257 in {wc for wc, _ in expo.width_classes(bt["topo"])}
    rng = np.random.default_rng(8)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(3, len(bj["theta0"])))
    f_j = jax_objective(*(bj[k] for k in KEYS), use_pallas=False, pop_chunk=None)
    want = np.asarray(jax.jit(f_j)(jnp.asarray(thetas)))
    got = make_population_objective(*(bt[k] for k in KEYS), pop_chunk=None)(thetas)
    assert got.shape == (3, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN)


def test_demo_bundle_model2(demo):
    """The port's model-2 demo: the JAX package's draws, and observations
    from RK45 at the bundle's dtype (float64 here) on the CPU, as the JAX
    package's."""
    bj, _ = demo
    bt = build_demo_network(n_proteins=10, n_kinases=4, model=2, seed=0,
                            dtype=torch.float64, device="cpu")
    assert bt["topo"].model == 2 and bt["system"].rhs.model == 2
    np.testing.assert_array_equal(bt["topo"].W_pad, bj["topo"].W_pad)
    for k in ("theta0", "theta_true", "grid"):
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    for f, a, b in zip(bj["loss_data"]._fields, bt["loss_data"], bj["loss_data"]):
        if f.startswith("obs"):
            # RK45 at float64 on both sides: the same steps, rounding apart
            # (measured 7e-11 at N = 12)
            np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


# --- wide-block tables ----------------------------------------------------------


def random_blocks(rng, Bu, w, B):
    """Blocks like tests/test_pallas.py's wide-block check: normal
    off-diagonals (sd 0.3), decaying diagonals."""
    L = rng.normal(0, 0.3, (Bu, w, w, B))
    for i in range(w):
        L[:, i, i, :] = -rng.uniform(0.01, 10.0, (Bu, B))
    return L.astype(np.float32)


def assert_scaled_close(got, want, atol=SCALED_ATOL_F32):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.max(np.abs(want)) + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("w, B", [(9, 300), (17, 128)])
def test_wide_reference_matches_pallas_interpret(w, B):
    """The plain version against phi_vectors_pallas_all in interpret mode,
    float32; at w = 9 also one pair against phi_vectors_pallas."""
    rng = np.random.default_rng(w)
    L = random_blocks(rng, 2, w, B)
    binv = np.asarray([0, 1], np.int32)
    h_u = np.asarray([0.5, 4.0], np.float32)
    lad = max(ladder_len(w, float(h)) for h in h_u)
    want = phi_vectors_pallas_all(jnp.asarray(L), binv, h_u, lad, interpret=True)
    got = phi_tables(torch.as_tensor(L), binv, h_u, lad)
    for g, r in zip(got, want):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        assert_scaled_close(g.numpy(), r)
    if w > 9:
        return
    want1 = phi_vectors_pallas(jnp.asarray(L[1]), 2.0, lad, interpret=True)
    got1 = phi_vectors(torch.as_tensor(L[1]), 2.0, lad)
    for g, r in zip(got1, want1):
        assert tuple(g.shape) == r.shape
        assert_scaled_close(g.numpy(), r)


@pytest.mark.parametrize("w", [9, 17])
def test_nan_lane_stays_in_its_lane(w):
    """A NaN member gets NaN tables and leaves the other lanes exactly as
    they were. (The JAX package's wide Pallas kernel does not: its tile
    skip takes the max of the squaring counts over the tile, which a NaN
    lane turns into NaN, and the whole tile then skips its ladder.)"""
    rng = np.random.default_rng(w)
    L = torch.as_tensor(random_blocks(rng, 1, w, 64))
    binv, h_u = [0, 0], [0.5, 4.0]
    clean = phi_tables(L, binv, h_u, 12)
    L[..., 37] = float("nan")
    dirty = phi_tables(L, binv, h_u, 12)
    keep = torch.arange(64) != 37
    for c, d in zip(clean, dirty):
        assert torch.equal(c[..., keep], d[..., keep])
        assert bool(torch.isnan(d[..., 37]).all())


def test_wide_wrappers_on_the_cpu():
    """A CPU tensor takes the plain version at any width and launches no
    kernel; the wide kernel's own wrapper wants a CUDA tensor."""
    rng = np.random.default_rng(0)
    before = (phi_tables.launches, phi_tables_wide.launches)
    for w in (9, 17, 18):
        L = torch.as_tensor(random_blocks(rng, 1, w, 20))
        got = phi_tables(L, [0], [1.0], 8)
        for g, r in zip(got, phi_tables_reference(L, [0], [1.0], 8)):
            assert torch.equal(g, r)
        E, p1, p2 = phi_vectors(L[0], 1.0, 8)
        assert E.shape == (w, w, 20) and p1.shape == p2.shape == (w, 20)
        assert torch.equal(E, got[0][0])
    assert (phi_tables.launches, phi_tables_wide.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        phi_tables_wide(L, [0], [1.0], 8)
    with pytest.raises(ValueError):
        phi_vectors(L, 1.0, 8)                      # (1, w, w, B): not one pair


@pytest.mark.parametrize("w", range(9, 18))
def test_wide_launch_shape(w):
    """The wide kernel's launch shape: a lane's T threads own R rows each
    (T R >= w > (T - 1) R), all in one warp, and a block's slices of two E
    planes and four vectors fit the shared memory a block may opt into."""
    shape = wide_launch_shape(w)
    R, T, lw = shape.rows, shape.threads_per_lane, shape.lanes_per_warp
    assert (T - 1) * R < w <= T * R and lw == 32 // T and T * lw <= 32
    assert 1 <= shape.warps <= 8
    assert shape.shared_bytes == 4 * shape.warps * lw * (2 * w * w + 4 * w) <= MAX_SHARED_BYTES
    for bad in (8, 18):
        with pytest.raises(NotImplementedError):
            wide_launch_shape(bad)


# --- the device default -----------------------------------------------------------


def test_default_device_is_the_card(demo):
    """Without an explicit device the entry points place the model on CUDA;
    where there is no card they raise instead of falling back to the CPU."""
    bj, bt = demo
    topo, Kmat = bt["topo"], bt["system"].Kmat
    makers = [lambda: GlobalSystem(topo, GRID, Kmat),
              lambda: PaddedRHS(topo, Kmat),
              lambda: from_reference(bj["system"]),
              lambda: build_demo_network(n_proteins=6, n_kinases=3, model=2)]
    for make in makers:
        if torch.cuda.is_available():
            made = make()
            rhs = made["system"].rhs if isinstance(made, dict) else getattr(made, "rhs", made)
            assert rhs.Kmat.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
