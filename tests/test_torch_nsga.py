"""The port's U-NSGA-III (host machinery, device variation and survival,
the all-device loop, checkpoint and resume, the native sort) against the
JAX package's, on the CPU.

The host functions are numpy on both sides and take the same
``default_rng`` draws, so they must agree exactly. The device functions
draw from another generator (a ``torch.Generator``), so they are fed the
JAX functions' own draws, made with ``jax.random`` in the JAX functions'
split order, and must then agree to float64 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.ops import nsga as jnsga
from phoskintime_tpu.ops import nsga_device as jdev
from phoskintime_tpu_torch import native
from phoskintime_tpu_torch.ops import nsga, nsga_device
from phoskintime_tpu_torch.ops.nsga import (das_dennis, fast_non_dominated_sort,
                                            nsga3_survival, run_unsga3)
from phoskintime_tpu_torch.ops.nsga_device import (SurvivalDraws, VariationDraws,
                                                   device_nd_ranks, device_survival,
                                                   run_unsga3_device, variation)
from phoskintime_tpu_torch.parallel.checkpoint import GACheckpointer, load_checkpoint

torch.set_num_threads(2)

# float64, the same operations on the same draws: rounding only (XLA's and
# PyTorch's pow and matmul differ in the last bits)
RTOL_F64 = 1e-12


def dtlz2_np(X):
    """DTLZ2 (m = 3): ideal point 0, Pareto front on the unit sphere."""
    X = np.asarray(X, float)
    g = np.sum((X[:, 2:] - 0.5) ** 2, axis=1)
    a, b = X[:, 0] * (np.pi / 2), X[:, 1] * (np.pi / 2)
    return np.stack([(1 + g) * np.cos(a) * np.cos(b), (1 + g) * np.cos(a) * np.sin(b),
                     (1 + g) * np.sin(a)], axis=1)


def dtlz2_torch(X):
    g = torch.sum((X[:, 2:] - 0.5) ** 2, dim=1)
    a, b = X[:, 0] * (np.pi / 2), X[:, 1] * (np.pi / 2)
    return torch.stack([(1 + g) * torch.cos(a) * torch.cos(b),
                        (1 + g) * torch.cos(a) * torch.sin(b), (1 + g) * torch.sin(a)], dim=1)


def ranks_of(fronts, n):
    rank = np.empty(n, int)
    for r, fr in enumerate(fronts):
        rank[fr] = r
    return rank


def tied_objectives(seed=0, n=64):
    """Random objectives with duplicate rows and dominated copies."""
    F = np.random.default_rng(seed).random((n, 3))
    return np.vstack([F, F[:5], F[:3] + 0.1])


# --- the host machinery: identical results -------------------------------------------


HOST_CASES = {
    "das_dennis": lambda m: m.das_dennis(3, 12),
    "das_dennis_p0": lambda m: m.das_dennis(4, 0),
    "lhs_sampling": lambda m: m.lhs_sampling(50, np.zeros(4), np.arange(1.0, 5.0),
                                             np.random.default_rng(3)),
    "non_dominated_sort": lambda m: ranks_of(m.fast_non_dominated_sort(tied_objectives()), 72),
    "non_dominated_sort_native": lambda m: ranks_of(
        m.fast_non_dominated_sort(tied_objectives(1, 700)), 708),
    "crowding_distance": lambda m: m.crowding_distance(tied_objectives()[:20]),
    "hyperplane_intercepts": lambda m: m._hyperplane_intercepts(
        tied_objectives(), tied_objectives().min(axis=0)),
    "associate_to_refs": lambda m: m.associate_to_refs(
        np.random.default_rng(4).random((40, 3)), das_dennis(3, 6)),
    "sbx_crossover": lambda m: m.sbx_crossover(
        *np.random.default_rng(5).random((2, 30, 6)), np.zeros(6), np.ones(6),
        np.random.default_rng(6), **({} if m is jnsga else {"dtype": np.float64})),
    "polynomial_mutation": lambda m: m.polynomial_mutation(
        np.random.default_rng(7).random((30, 6)), np.zeros(6), np.ones(6),
        np.random.default_rng(8), prob=0.3),
    "duplicate_mask": lambda m: m._duplicate_mask(
        np.vstack([np.random.default_rng(9).random((10, 4)), np.full((2, 4), 0.25)]),
        np.vstack([np.random.default_rng(10).random((10, 4)), np.full((1, 4), 0.25)]),
        np.zeros(4), np.ones(4)),
    "tournament": lambda m: m._tournament(np.arange(20) % 4, np.random.default_rng(11).random(20),
                                          30, np.random.default_rng(12)),
    "nsga3_survival": lambda m: m.nsga3_survival(
        np.random.default_rng(13).random((120, 5)), tied_objectives(14, 112), 60,
        das_dennis(3, 6), np.random.default_rng(15)),
    # one mutually non-dominated front with every point twice: ties
    "nsga3_survival_one_front": lambda m: m.nsga3_survival(
        np.random.default_rng(16).random((100, 4)),
        das_dennis(3, 12)[np.random.default_rng(17).permutation(91)].repeat(2, 0)[:100] + 0.5,
        37, das_dennis(3, 6), np.random.default_rng(18)),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_op_matches_jax(name):
    """Each host function on the same seeded inputs and rng: the same output
    (sbx at float64, the JAX package's precision under x64)."""
    got, want = HOST_CASES[name](nsga), HOST_CASES[name](jnsga)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("pop, n_gen", [(40, 10), (300, 2)], ids=["pop40", "pop300-native"])
def test_run_unsga3_matches_jax(pop, n_gen):
    """DTLZ2 with host variation: the same X, F and history (pop 300 sorts
    600 candidates, through the native sort on both sides)."""
    n_var = 7
    kw = dict(pop_size=pop, n_gen=n_gen, seed=0, ftol=0.0, n_max_evals=None)
    got = run_unsga3(dtlz2_np, np.zeros(n_var), np.ones(n_var), **kw)
    want = jnsga.run_unsga3(dtlz2_np, np.zeros(n_var), np.ones(n_var), **kw)
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_array_equal(got.F, want.F)
    np.testing.assert_array_equal(got.pareto_F, want.pareto_F)
    assert (got.n_gen, got.n_evals) == (want.n_gen, want.n_evals)
    for (g1, a1, b1), (g2, a2, b2) in zip(got.history, want.history, strict=True):
        assert g1 == g2
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)


def test_native_matches_numpy():
    """The port's own native sort and association against the numpy paths."""
    if native.get_lib() is None:
        pytest.skip("no C++ compiler to build the native library")
    F = tied_objectives(2, 300)
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    assert native.nd_sort_ranks(F).max() > 0
    rank_np = ranks_of(fast_non_dominated_sort(F[:300]), 300)      # numpy path (n <= 512)
    np.testing.assert_array_equal(native.nd_sort_ranks(F[:300]), rank_np)
    assert not (le & lt)[np.ix_(rank_np == 0, rank_np == 0)].any()
    refs = das_dennis(3, 6)
    unit = refs / np.linalg.norm(refs, axis=1, keepdims=True)
    Fn = np.random.default_rng(3).random((200, 3))
    niche, dist = native.associate_native(Fn, unit)
    proj = Fn @ unit.T
    d = np.sqrt(np.maximum((Fn ** 2).sum(1)[:, None] - proj ** 2, 0.0))
    np.testing.assert_array_equal(niche, np.argmin(d, axis=1))
    # the distance is the root of a difference of near squares (|F|^2 - proj^2),
    # summed in another order: absolute error ~ eps |F|^2 / distance
    np.testing.assert_allclose(dist, d.min(axis=1), rtol=0, atol=1e-13)


# --- device variation and survival, fed the JAX package's draws ---------------------


def jax_variation_draws(key, P, n):
    """``variation_kernel``'s draws, in its split order."""
    ka, kb, kcx, ku, ksw, kmd, kmu, kr1, kr2 = jax.random.split(key, 9)

    def tour(k):
        k1, k2 = jax.random.split(k)
        return jax.random.randint(k1, (P,), 0, P), jax.random.randint(k2, (P,), 0, P)

    t = lambda x: torch.as_tensor(np.asarray(x))
    return VariationDraws(
        tuple(map(t, tour(ka))), tuple(map(t, tour(kb))),
        t(jax.random.uniform(kcx, (P,))), t(jax.random.uniform(ku, (P, n), jnp.float64)),
        t(jax.random.uniform(ksw, (P, n))), t(jax.random.uniform(kmd, (P, n))),
        t(jax.random.uniform(kmu, (P, n), jnp.float64)),
        t(jax.random.randint(kr1, (P,), 0, n)), t(jax.random.uniform(kr2, (P,), jnp.float64)))


@pytest.mark.parametrize("seed", [0, 1])
def test_variation_matches_jax(seed):
    """Tournament, SBX, PM and clone repair on JAX's draws: offspring within
    1e-12; some offspring are clones repaired, some mutated."""
    rng = np.random.default_rng(seed)
    P, n = 200, 5
    X = rng.random((P, n))
    rank = rng.integers(0, 4, P)
    nd = rng.random(P)
    xl, xu = np.full(n, 0.0), np.linspace(1.0, 2.0, n)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jdev.variation_kernel(jnp.asarray(X), jnp.asarray(rank), jnp.asarray(nd),
                                            key, jnp.asarray(xl), jnp.asarray(xu),
                                            pop_size=P, n_var=n))
    t = torch.as_tensor
    draws = jax_variation_draws(key, P, n)
    got = variation(t(X), t(rank), t(nd), draws, t(xl), t(xu)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_F64, atol=1e-15)
    cx = draws.cx.numpy() <= 0.9
    assert (~cx).any() and (draws.mut.numpy() <= 1 / n).any()


@pytest.mark.parametrize("case", ["ties", "one_front", "chain"])
def test_device_nd_ranks_matches_jax(case):
    F = {"ties": tied_objectives(),
         "one_front": das_dennis(3, 8) + 0.5,
         "chain": np.arange(12, dtype=float)[:, None] * np.ones((1, 3))}[case]
    got = device_nd_ranks(torch.as_tensor(F)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdev.device_nd_ranks(jnp.asarray(F))))
    np.testing.assert_array_equal(got, ranks_of(fast_non_dominated_sort(F), len(F)))


def unit_refs(n_partitions):
    refs = das_dennis(3, n_partitions)
    return refs / np.linalg.norm(refs, axis=1, keepdims=True)


SURVIVAL_CASES = {
    # random objectives: several fronts, the splitting front partly kept
    "fronts": (lambda rng: rng.random((80, 3)), 32, 6),
    # one front larger than the cap with more members than niches: random
    # levels above the first (T > 1) and random picks within a niche
    "crowded": (lambda rng: np.abs(rng.normal(size=(200, 3))) ** 0.5
                / np.linalg.norm(np.abs(rng.normal(size=(200, 3))) ** 0.5, axis=1,
                                 keepdims=True) + 1.0, 100, 4),
    "exact_fit": (lambda rng: rng.random((24, 3)), 24, 6),
    "ties": (lambda rng: tied_objectives(5), 40, 6),
}


@pytest.mark.parametrize("case", sorted(SURVIVAL_CASES))
def test_device_survival_matches_jax(case):
    """Survival on JAX's draws: the same survivors in the same order."""
    make_F, n_keep, parts = SURVIVAL_CASES[case]
    rng = np.random.default_rng(7)
    F = make_F(rng)
    X = rng.random((len(F), 4))
    unit = unit_refs(parts)
    key = jax.random.PRNGKey(3)
    want = jdev.device_survival(jnp.asarray(X), jnp.asarray(F), n_keep, jnp.asarray(unit), key)
    _, k_n, k_c = jax.random.split(key, 3)
    draws = SurvivalDraws(torch.as_tensor(np.asarray(jax.random.uniform(k_n, (len(unit),)))),
                          torch.as_tensor(np.asarray(jax.random.uniform(k_c, (len(F),)))))
    got = device_survival(torch.as_tensor(X), torch.as_tensor(F), n_keep,
                          torch.as_tensor(unit), draws)
    for name, g, w in zip(("X", "F", "rank", "niche", "nd"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_F64, atol=1e-15,
                                   err_msg=name)


def test_device_survival_matches_host_when_deterministic():
    """Every niching pick through the empty-niche min-distance branch (more
    candidate niches than owed slots, unique distances): the host's set."""
    rng = np.random.default_rng(2)
    refs = das_dennis(3, 9)
    F = refs[rng.permutation(len(refs))[:40]] + 0.2 + rng.uniform(0, 1e-4, (40, 3))
    X = rng.random((40, 4))
    gen = torch.Generator().manual_seed(0)
    got = device_survival(torch.as_tensor(X), torch.as_tensor(F), 12,
                          torch.as_tensor(unit_refs(9)),
                          nsga_device.survival_draws(gen, 40, len(refs), torch.float64, "cpu"))
    _, Fh, *_ = nsga3_survival(X, F, 12, refs, np.random.default_rng(0))
    assert ({tuple(np.round(r, 12)) for r in got[1].numpy()}
            == {tuple(np.round(r, 12)) for r in Fh})


# --- the all-device loop (on the CPU) --------------------------------------------------


def device_run(**kw):
    n_var = kw.pop("n_var", 7)
    base = dict(pop_size=40, n_gen=30, seed=0, gens_per_block=10, ftol=0.0,
                n_max_evals=None, device="cpu")
    return run_unsga3_device(dtlz2_torch, np.zeros(n_var), np.ones(n_var), **{**base, **kw})


def test_device_loop_converges_on_dtlz2():
    res = device_run()
    assert res.n_gen == 30 and res.n_evals == 40 * 31 and len(res.history) == 30
    assert res.X.dtype == np.float64 and (res.pareto_F.min(axis=0) < 0.35).all()
    assert 0.9 < np.median(np.linalg.norm(res.pareto_F, axis=1)) < 1.6
    ideals = np.array([h[1] for h in res.history])
    assert (np.diff(ideals, axis=0) <= 1e-9).all()
    host = run_unsga3(dtlz2_np, np.zeros(7), np.ones(7), pop_size=40, n_gen=30, seed=0,
                      ftol=0.0, n_max_evals=None)
    assert res.pareto_F.min(axis=0).sum() <= host.pareto_F.min(axis=0).sum() * 2.0 + 0.1


def test_device_loop_ftol_stop_and_cap():
    res = device_run(n_var=5, pop_size=16, n_gen=40, gens_per_block=5, ftol=1e9,
                     ftol_period=5)
    assert res.n_gen <= 10                       # the first block past the window
    res2 = device_run(n_var=5, pop_size=16, n_gen=40, gens_per_block=5, n_max_evals=100)
    assert res2.n_evals >= 100 and res2.n_gen <= 10


def test_device_loop_callback_block_granularity():
    seen = []

    def cb(gen, X, F):
        seen.append((gen, X.shape, F.shape))
        return len(seen) >= 2

    res = device_run(n_var=5, pop_size=16, n_gen=40, gens_per_block=4, callback=cb)
    assert [g for g, *_ in seen] == [4, 8] and res.n_gen == 8
    assert seen[0][1:] == ((16, 5), (16, 3))


def test_device_loop_x0_padded():
    res = device_run(n_var=5, pop_size=16, n_gen=4, gens_per_block=2,
                     x0=np.full((10, 5), 0.5))
    assert res.X.shape == (16, 5)


def test_device_loop_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_unsga3_device(dtlz2_torch, np.zeros(3), np.ones(3), pop_size=8, n_gen=1)


# --- checkpoint and resume -------------------------------------------------------------


def host_run(n_gen, ck=None):
    return run_unsga3(dtlz2_np, np.zeros(6), np.ones(6), pop_size=24, n_gen=n_gen, seed=1,
                      ftol=0.0, n_max_evals=None, checkpoint=ck)


@pytest.mark.parametrize("route", ["host", "device"])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, route):
    """A run stopped at generation 4 (its checkpoint written there) and
    resumed with the same arguments ends as the uninterrupted run does: the
    host rng's state (and, on the device route, the torch generator's) come
    back with the population."""
    path = str(tmp_path / f"{route}.ckpt")
    if route == "host":
        full = host_run(8)
        host_run(4, GACheckpointer(path, every=2))
        resumed = host_run(8, GACheckpointer(path, every=2))
    else:
        full = device_run(n_var=6, pop_size=24, n_gen=8, gens_per_block=2)
        device_run(n_var=6, pop_size=24, n_gen=4, gens_per_block=2,
                   checkpoint=GACheckpointer(path, every=2))
        state = load_checkpoint(path)
        assert state["gen"] == 4 and "torch_generator" in state["loop"]
        resumed = device_run(n_var=6, pop_size=24, n_gen=8, gens_per_block=2,
                             checkpoint=GACheckpointer(path, every=2))
    assert (resumed.n_gen, resumed.n_evals) == (full.n_gen, full.n_evals)
    np.testing.assert_array_equal(resumed.X, full.X)
    np.testing.assert_array_equal(resumed.F, full.F)
    assert [h[0] for h in resumed.history] == list(range(1, 9))
    for a, b in zip(resumed.history, full.history, strict=True):
        np.testing.assert_array_equal(a[1], b[1])
    assert GACheckpointer(path).start_gen == 8
