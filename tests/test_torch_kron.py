"""The Kronecker-factorized model-2 path of the PyTorch port
(``network/kron.py``) against the JAX package's: every case of
``tests/test_kron.py`` (the factor algebra, the phi vectors against the
dense ladder, the R-slot scalars, the end-to-end path in its stable regime
and its divergence past it, the default staying dense, the differentiable
call, the RK45 oracle), and ``return_observables`` on every path of
``exponential_simulate_batched`` as ``tests/test_expo.py`` holds JAX's.
Inputs are made with numpy from a seed and fed to both packages at float64
on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.network import GlobalSystem as JaxSystem
from phoskintime_tpu.network import build_kinase_matrix as jax_kmat
from phoskintime_tpu.network import build_topology as jax_topology
from phoskintime_tpu.network import default_params as jax_default_params
from phoskintime_tpu.network import expo as jexpo
from phoskintime_tpu.network import kron as jkron
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import expo, kron
from phoskintime_tpu_torch.network.simulate import extract_observables, simulate

torch.set_num_threads(2)

# the factor algebra: the same closed forms in another library (~1e-16)
RTOL_ALG = 1e-12
# a whole run: hundreds of segments of the same tables
RTOL_RUN = 1e-9
GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])


def rand_entries(rng, s, B):
    """Generator-shaped random entries: a = -S, c = S, b = E, d = -(E + Dp + D)."""
    S = rng.uniform(0.05, 3.0, (s, B))
    E = rng.uniform(0.05, 2.0, (s, B))
    DpD = rng.uniform(0.1, 2.5, (s, B))
    return -S, E, S, -(E + DpD)


def dense_K(a, b, c, d):
    """The dense 2^s x 2^s Kronecker-sum operator of one lane's entries, by
    independent per-edge accumulation."""
    s = a.shape[0]
    M = 1 << s
    K = np.zeros((M, M))
    for m in range(M):
        for j in range(s):
            if (m >> j) & 1:
                K[m, m] += d[j]
                K[m ^ (1 << j), m] += b[j]
            else:
                K[m, m] += a[j]
                K[m ^ (1 << j), m] += c[j]
    return K


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, rtol=RTOL_ALG, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --- the factor algebra ----------------------------------------------------------------


def test_expm2x2_matches_jax_and_scipy():
    from scipy.linalg import expm

    rng = np.random.default_rng(0)
    a, b, c, d = rand_entries(rng, 5, 7)
    got = kron._expm2x2(*map(t, (a, b, c, d)))
    want = jkron._expm2x2(*map(jnp.asarray, (a, b, c, d)))
    for g, w in zip(got, want):
        close(g.numpy(), w)
    for j in range(5):
        for lane in range(7):
            ref = expm(np.array([[a[j, lane], b[j, lane]], [c[j, lane], d[j, lane]]]))
            mat = np.array([[got[0][j, lane], got[1][j, lane]],
                            [got[2][j, lane], got[3][j, lane]]])
            np.testing.assert_allclose(mat, ref, rtol=5e-6, atol=1e-8)


def test_expm2x2_zero_is_identity():
    z = torch.zeros((2, 3), dtype=torch.float64)
    g00, g01, g10, g11 = kron._expm2x2(z, z, z, z)
    assert bool((g00 == 1).all() and (g11 == 1).all() and (g01 == 0).all() and (g10 == 0).all())


def test_factor_square_matches_jax():
    rng = np.random.default_rng(1)
    G = rng.normal(0, 1, (3, 2, 2, 4))
    got = kron._factor_square(t(G)).numpy()
    close(got, jkron._factor_square(jnp.asarray(G)))
    for j in range(3):
        for lane in range(4):
            close(got[j, :, :, lane], G[j, :, :, lane] @ G[j, :, :, lane])


@pytest.mark.parametrize("s", [1, 2, 4])
def test_kron_mv_matches_jax(s):
    """The factorized apply (bit j at stride 2^j) against JAX's and the
    dense Kronecker product."""
    rng = np.random.default_rng(2)
    M = 1 << s
    G = rng.normal(0, 1, (s, 2, 2, 1))
    X = rng.normal(0, 1, (M, 1))
    got = kron._kron_mv(t(G), t(X), s).numpy()
    close(got, jkron._kron_mv(jnp.asarray(G), jnp.asarray(X), s))
    D = np.array([[np.prod([G[j, (mp >> j) & 1, (m >> j) & 1, 0] for j in range(s)])
                   for m in range(M)] for mp in range(M)])
    close(got[:, 0], D @ X[:, 0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("s", [1, 3])
def test_ksum_mv_matches_jax(s):
    rng = np.random.default_rng(3)
    M = 1 << s
    a, b, c, d = rand_entries(rng, s, 1)
    X = rng.normal(0, 1, (M, 1))
    got = kron._ksum_mv(*map(t, (a, b, c, d)), t(X), s).numpy()
    close(got, jkron._ksum_mv(*map(jnp.asarray, (a, b, c, d)), jnp.asarray(X), s))
    K = dense_K(a[:, 0], b[:, 0], c[:, 0], d[:, 0])
    close(got[:, 0], K @ X[:, 0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("h", [0.25, 2.0, 16.0])
def test_phi_vectors_kron_matches_jax(h):
    """G, q1, q2 against JAX's factorized ladder at the ladder's clip of 24,
    and q1, q2 against the port's dense lane ladder on the assembled
    Kronecker-sum operator (the shared radius and terms), whose E the
    factors reassemble."""
    from phoskintime_tpu_torch.ops.phi_tables import phi_vectors_lanes

    rng = np.random.default_rng(4)
    s, B = 3, 5
    M = 1 << s
    a, b, c, d = rand_entries(rng, s, B)
    G, q1, q2 = kron._phi_vectors_kron(*map(t, (a, b, c, d)), h, 24, torch.float64)
    want = jkron._phi_vectors_kron(*map(jnp.asarray, (a, b, c, d)), h, 24, jnp.float64)
    for g, w in zip((G, q1, q2), want):
        close(g.numpy(), w, rtol=1e-10, atol=1e-14)
    Ks = np.stack([dense_K(a[:, lane], b[:, lane], c[:, lane], d[:, lane])
                   for lane in range(B)], axis=-1)
    E_d, p1_d, p2_d = phi_vectors_lanes(t(Ks), torch.full((B,), h, dtype=torch.float64),
                                        unroll=24)
    close(q1.numpy(), p1_d.numpy(), rtol=1e-9, atol=1e-12)
    close(q2.numpy(), p2_d.numpy(), rtol=1e-9, atol=1e-12)
    for lane in range(B):
        got = np.array([[np.prod([float(G[j, (mp >> j) & 1, (m >> j) & 1, lane])
                                  for j in range(s)]) for m in range(M)] for mp in range(M)])
        close(got, E_d[:, :, lane].numpy(), rtol=1e-8, atol=1e-11)


def test_r_scalars_match_jax():
    for Bv, h in [(0.7, 2.0), (1e-8, 16.0), (3.0, 0.25)]:
        got = kron._r_scalars(t([Bv]), h, torch.float64)
        want = jkron._r_scalars(jnp.asarray([Bv]), h, jnp.float64)
        for g, w in zip(got, want):
            close(g.numpy(), w)
        z = -Bv * h
        assert float(got[0][0]) == pytest.approx(np.exp(z), rel=1e-7)
        assert float(got[1][0]) == pytest.approx(h * np.expm1(z) / z, rel=1e-6)
        assert float(got[2][0]) == pytest.approx(h * h * (np.expm1(z) - z) / z ** 2, rel=1e-6)


# --- the segment scan -----------------------------------------------------------------


def model2_system(hetero=False, seed=0):
    """(JAX system, port system, parameters) of tests/test_kron.py's
    networks: four proteins of 1-2 sites, or (hetero) 1/1/2/3 sites."""
    if hetero:
        inter = pd.DataFrame({
            "protein": ["GA", "GA", "GB", "GC", "GD", "GD", "GD"],
            "psite": ["S1", "S2", "S1", "S1", "S1", "S2", "S3"],
            "kinase": ["K1", "K1", "K2", "K1", "K2", "K1", "K2"]})
        tf = pd.DataFrame({"tf": ["GA", "GC", "GD"], "target": ["GB", "GA", "GC"]})
    else:
        inter = pd.DataFrame({
            "protein": ["GA", "GA", "GB", "GC"],
            "psite": ["S1", "S2", "S1", "S1"],
            "kinase": ["K1", "K1", "K2", "K1"]})
        tf = pd.DataFrame({"tf": ["GA", "GC"], "target": ["GB", "GA"]})
    topo = jax_topology(inter, tf, model=2)
    Kmat = jax_kmat(topo.kinases, None, GRID)
    Kmat *= 1.0 + 0.25 * np.sin(np.arange(len(GRID)))[None, :]
    sj = JaxSystem(topo, GRID, Kmat)
    rng = np.random.default_rng(seed)
    p = jax_default_params(topo)
    for k in ["c_k", "A_i", "B_i", "C_i", "D_i", "E_i"]:
        p[k] = rng.uniform(0.1, 1.5, p[k].shape)
    p["Dp_i"] = rng.uniform(0.2, 2.5, p["Dp_i"].shape) * topo.site_mask()
    p["tf_scale"] = 2.2
    return sj, from_reference(sj, device="cpu"), {k: np.asarray(v, float) for k, v in p.items()}


def population(p, pop=3, seed=1):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v)[None] * rng.uniform(0.7, 1.3, (pop,) + (1,) * np.ndim(v))
            for k, v in p.items()}


def jax_batched(sj, pb, grid=GRID, **kw):
    ys, ok = jexpo.exponential_simulate_batched(sj, {k: jnp.asarray(v) for k, v in pb.items()},
                                                grid, **kw)
    return np.asarray(ys), np.asarray(ok)


@pytest.mark.parametrize("hetero", [False, True], ids=["uniform", "hetero"])
def test_kron_simulate_matches_jax(hetero):
    """``use_kron=True`` at substep 0.5 to t = 16 (the stable regime),
    float64, against JAX's kron path at rtol 1e-9."""
    sj, st, p = model2_system(hetero)
    pb = population(p)
    got, ok = expo.exponential_simulate_batched(st, pb, GRID[:8], substep=0.5, use_kron=True)
    want, ok_j = jax_batched(sj, pb, GRID[:8], substep=0.5, use_kron=True)
    assert bool(ok.all()) and bool(ok_j.all()) and got.dtype == torch.float64
    close(got.numpy(), want, rtol=RTOL_RUN, atol=1e-14)


@pytest.mark.parametrize("hetero", [False, True], ids=["uniform", "hetero"])
def test_matches_dense_path_stable_regime(hetero):
    """substep 0.5 (h D <= ~0.75): the two splittings agree to O(h^3) over
    the whole grid, as in the JAX package."""
    _, st, p = model2_system(hetero)
    pb = population(p)
    ys_k, ok_k = expo.exponential_simulate_batched(st, pb, GRID, substep=0.5, use_kron=True)
    ys_d, ok_d = expo.exponential_simulate_batched(st, pb, GRID, substep=0.5, use_kron=False,
                                                   width_bucketing=False)
    assert bool(ok_k.all()) and bool(ok_d.all())
    close(ys_k.numpy(), ys_d.numpy(), rtol=2e-2, atol=1e-4)


def diverged_at(ys) -> int:
    """The first time index at which a member's state is non-finite or past
    1e12 (len(times) where none)."""
    bad = ~np.isfinite(ys) | (np.abs(np.nan_to_num(ys)) > 1e12)
    hit = np.flatnonzero(bad.any(axis=(0, 2)))
    return int(hit[0]) if len(hit) else ys.shape[1]


def test_unstable_beyond_rk2_bound():
    """At substep 4 (h D > 2) the path diverges, as JAX's does: the same
    first time point past 1e12 or non-finite."""
    sj, st, p = model2_system()
    assert float(np.max(p["D_i"])) * 4.0 > 2.0
    pb = population(p)
    ys, ok = expo.exponential_simulate_batched(st, pb, GRID, substep=4.0, use_kron=True)
    want, ok_j = jax_batched(sj, pb, substep=4.0, use_kron=True)
    got = ys.numpy()
    assert not bool(ok.all()) or float(np.max(np.abs(got))) > 1e12
    assert diverged_at(got) == diverged_at(want) < len(GRID)


def test_default_stays_dense():
    """Neither use_kron=None nor the default routes model 2 through the
    factorized path (it would diverge at the production substep): the
    result is the dense path's, bit for bit, and finite; models 0 and 1
    ignore the flag."""
    _, st, p = model2_system()
    pb = population(p)
    dense, ok = expo.exponential_simulate_batched(st, pb, GRID)
    assert bool(ok.all()) and bool(torch.isfinite(dense).all())
    for kw in (dict(use_kron=None), dict(use_kron=False)):
        assert torch.equal(expo.exponential_simulate_batched(st, pb, GRID, **kw)[0], dense)
    from test_torch_model4 import make_system    # tests/ is on pytest's path
    _, s0, p0 = make_system(0)
    pb0 = population(p0)
    assert torch.equal(expo.exponential_simulate_batched(s0, pb0, GRID, use_kron=True)[0],
                       expo.exponential_simulate_batched(s0, pb0, GRID)[0])


def test_differentiable():
    """torch.autograd through the kron path (stable regime, the first 6
    grid points): a finite, non-zero gradient of sum(ys^2) in c_k that
    agrees with a central difference of the same path."""
    _, st, p = model2_system()
    pb = {k: torch.as_tensor(v)[None] for k, v in p.items()}
    ck = pb["c_k"].clone().requires_grad_(True)

    def loss(c):
        ys, _ = expo.exponential_simulate_batched(st, dict(pb, c_k=c), GRID[:6], substep=0.5,
                                                  use_kron=True, differentiable=True)
        return torch.sum(ys ** 2)

    g, = torch.autograd.grad(loss(ck), ck)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    eps = 1e-6
    for k in range(ck.shape[1]):
        e = torch.zeros_like(ck)
        e[0, k] = eps
        with torch.no_grad():
            fd = (loss(pb["c_k"] + e) - loss(pb["c_k"] - e)) / (2 * eps)
        assert float(g[0, k]) == pytest.approx(float(fd), rel=1e-6, abs=1e-9)


def test_matches_rk45_stable_regime():
    """The kron path at substep 0.5 against the port's RK45 at rtol 1e-10
    on the hetero network to t = 16, at the JAX package's tolerance."""
    _, st, p = model2_system(hetero=True, seed=2)
    ref = simulate(st, {k: torch.as_tensor(v) for k, v in p.items()}, GRID[:8], rtol=1e-10,
                   atol=1e-12, max_steps=500_000)
    assert bool(ref.success)
    ys, ok = expo.exponential_simulate_batched(st, {k: np.asarray(v)[None] for k, v in p.items()},
                                               GRID[:8], substep=0.5, use_kron=True)
    assert bool(ok.all())
    close(ys[0].numpy(), ref.ys.numpy(), rtol=5e-3, atol=1e-5)


# --- return_observables --------------------------------------------------------------


@pytest.mark.parametrize("case", ["model2-unbucketed", "model2-bucketed", "model2-scan-kernel",
                                  "model2-kron", "model0", "model4"])
def test_return_observables(case):
    """((R, TOT, PHO), success) on every path: equal to
    ``extract_observables`` of the returned trajectory, and to JAX's
    ``return_observables=True`` (float64, rtol 1e-9) where JAX has the
    path on the CPU (its scan kernel runs in interpret mode only); to t =
    2, where every path has its early, finely cut segments."""
    from test_torch_model4 import make_system

    if case.startswith("model2"):
        sj, st, p = model2_system(hetero=True)
        kw = {"model2-unbucketed": dict(width_bucketing=False),
              "model2-bucketed": dict(width_bucketing=True),
              "model2-scan-kernel": dict(width_bucketing=False, use_scan_kernel=True),
              "model2-kron": dict(use_kron=True)}[case]
        substep = 0.5 if case == "model2-kron" else 8.0
    else:
        sj, st, p = make_system(0 if case == "model0" else 4)
        kw, substep = {}, 8.0
    pb = population(p, pop=2, seed=7)
    grid = GRID[:5]
    ys, ok = expo.exponential_simulate_batched(st, pb, grid, substep=substep, **kw)
    (R, TOT, PHO), ok2 = expo.exponential_simulate_batched(st, pb, grid, substep=substep,
                                                           return_observables=True, **kw)
    assert torch.equal(ok, ok2)
    obs = extract_observables(st, ys)
    for got, ref in zip((R, TOT, PHO), (obs.R, obs.TOT, obs.PHO)):
        assert torch.equal(got, ref)
    N = st.topo.N
    assert R.shape == TOT.shape == (2, len(grid), N) and PHO.shape[:3] == (2, len(grid), N)
    if case == "model2-scan-kernel":
        return
    jkw = dict(kw, use_pallas=False)
    (Rj, TOTj, PHOj), okj = jexpo.exponential_simulate_batched(
        sj, {k: jnp.asarray(v) for k, v in pb.items()}, grid, substep=substep,
        return_observables=True, **jkw)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    for got, ref in zip((R, TOT, PHO), (Rj, TOTj, PHOj)):
        close(got.numpy(), ref, rtol=RTOL_RUN, atol=1e-14)
