"""The PyTorch port's population objective and demo bundle against the JAX
package: the slice as a whole.

The JAX side runs ``make_population_objective(..., use_pallas=False)``,
its plain propagator build, as the JAX package's own CPU tests do; the
port runs on CPU tensors, which take the plain version of its kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network.objective import \
    make_population_objective as jax_objective
from phoskintime_tpu.network.objective import modality_losses as jax_modality
from phoskintime_tpu_torch.demo import build_demo_network
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network.objective import (_auto_pop_chunk,
                                                     evaluate_population,
                                                     make_population_objective,
                                                     modality_losses)

torch.set_num_threads(2)

# float64, the same ETD2RK steps and tables on both sides: the objective
# agrees to the order of floating-point operations (measured ~1e-15)
RTOL_F64 = 1e-9
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")


@pytest.fixture(scope="module", params=[0, 1], ids=["model0", "model1"])
def bundles(request):
    bj = jax_demo(n_proteins=10, n_kinases=4, model=request.param, seed=0,
                  dtype=np.float64)
    return bj, from_reference({k: bj[k] for k in KEYS}, device="cpu")


def thetas_for(bj, P, seed=1):
    rng = np.random.default_rng(seed)
    return bj["theta0"][None] + 0.05 * rng.normal(size=(P, len(bj["theta0"])))


@pytest.mark.parametrize("loss_mode", [0, 3])
def test_population_objective_matches_jax(bundles, loss_mode):
    """pop 5 in chunks of 2: the last chunk is padded with copies of the
    last row, which must not leak into F."""
    bj, bt = bundles
    thetas = thetas_for(bj, 5)
    f_j = jax_objective(*(bj[k] for k in KEYS), loss_mode=loss_mode,
                        use_pallas=False, pop_chunk=2)
    want = np.asarray(jax.jit(f_j)(jnp.asarray(thetas)))
    f_t = make_population_objective(*(bt[k] for k in KEYS), loss_mode=loss_mode,
                                    pop_chunk=2)
    got = evaluate_population(f_t, thetas)
    assert got.shape == (5, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_F64)
    # each member is independent of its chunk
    one = f_t(thetas[4:5]).numpy()
    np.testing.assert_allclose(one[0], got[4].numpy(), rtol=RTOL_F64)


def test_failed_member_stays_in_its_row(bundles):
    """A NaN member gets fail_value and leaves its chunk-mates untouched.
    (The JAX CPU path does not: its traced squaring trip count is the max
    over the chunk's lanes, which a NaN lane corrupts.)"""
    bj, bt = bundles
    thetas = thetas_for(bj, 5)
    f_t = make_population_objective(*(bt[k] for k in KEYS), pop_chunk=2,
                                    fail_value=1e12)
    clean = f_t(thetas).numpy()
    thetas[2, 0] = np.nan
    got = f_t(thetas).numpy()
    np.testing.assert_array_equal(got[2], 1e12)
    np.testing.assert_array_equal(np.delete(got, 2, 0), np.delete(clean, 2, 0))


def test_gather_loss_path_matches_jax(bundles):
    """A repeated observation disables the dense loss; the gather path
    sums every replicate."""
    bj, bt = bundles
    ld = bj["loss_data"]
    dup = ld._replace(p_prot=np.concatenate([ld.p_prot, ld.p_prot[:1]]),
                      t_prot=np.concatenate([ld.t_prot, ld.t_prot[:1]]),
                      obs_prot=np.concatenate([ld.obs_prot, [1.3]]),
                      w_prot=np.concatenate([ld.w_prot, [0.5]]))
    thetas = thetas_for(bj, 3, seed=4)
    args_j = [bj[k] if k != "loss_data" else dup for k in KEYS]
    args_t = [bt[k] if k != "loss_data" else from_reference(dup) for k in KEYS]
    want = np.asarray(jax_objective(*args_j, use_pallas=False, pop_chunk=None)(
        jnp.asarray(thetas)))
    got = make_population_objective(*args_t, pop_chunk=None)(thetas).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_F64)

    # modality_losses itself, member by member
    R = np.random.default_rng(0).uniform(0.5, 2.0, (2, len(bj["grid"]), bt["system"].topo.N))
    PHO = np.random.default_rng(1).uniform(0.5, 2.0, R.shape + (bt["system"].topo.max_sites,))
    got = modality_losses((torch.as_tensor(R), torch.as_tensor(R * 1.1),
                           torch.as_tensor(PHO)), from_reference(dup), 1)
    for p in range(2):
        want = jax_modality((jnp.asarray(R[p]), jnp.asarray(R[p] * 1.1),
                             jnp.asarray(PHO[p])), dup, 1)
        np.testing.assert_allclose([g[p].item() for g in got],
                                   [float(w) for w in want], rtol=1e-12)


def test_auto_pop_chunk():
    from phoskintime_tpu.network.objective import _auto_pop_chunk as jax_chunk

    for n in (1, 10, 40, 45, 150, 5000):
        assert _auto_pop_chunk(n) == jax_chunk(n)


def test_differentiable_not_ported(bundles):
    _, bt = bundles
    with pytest.raises(NotImplementedError, match="Gradients and polish"):
        make_population_objective(*(bt[k] for k in KEYS), differentiable=True)


def test_demo_bundle_matches_jax():
    """The default float32 bundle: same draws, same structure, observations
    from RK45 at float32 on both sides."""
    check_demo_bundle("float32")


def test_demo_bundle_float64_matches_jax():
    check_demo_bundle("float64")


def check_demo_bundle(dtype):
    bj = jax_demo(n_proteins=12, n_kinases=5, seed=2, dtype=getattr(np, dtype))
    bt = build_demo_network(n_proteins=12, n_kinases=5, seed=2,
                            dtype=getattr(torch, dtype), device="cpu")
    tj, tt = bj["topo"], bt["topo"]
    for f in ("proteins", "kinases", "sites", "p2i", "k2i", "proxy_map"):
        assert getattr(tt, f) == getattr(tj, f), f
    for f in ("n_sites", "driver_map", "W_pad", "tf_mat", "tf_deg"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f), err_msg=f)
    np.testing.assert_array_equal(bt["system"].Kmat, bj["system"].Kmat)
    for k in bj["true"]:
        np.testing.assert_array_equal(bt["true"][k], bj["true"][k], err_msg=k)
        np.testing.assert_array_equal(bt["defaults"][k], bj["defaults"][k], err_msg=k)
    for k in ("theta0", "theta_true", "xl", "xu", "grid"):
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
        assert bt[k].dtype == bj[k].dtype, k
    assert bt["slices"] == bj["slices"] and bt["lambdas"] == bj["lambdas"]
    assert bt["system"].dtype == getattr(torch, dtype)
    # float64: the same RK45 steps on both sides, rounding apart (measured
    # 1.2e-13). float32: the port runs in float32 throughout, while the JAX
    # package's float32 bundle integrates from a float64 y0 and so promotes
    # most of its arithmetic to float64; the two step sequences part at the
    # integrator's own tolerance (measured 1.13e-05 at this size)
    rtol = 1e-9 if dtype == "float64" else 1e-4
    for f, a, b in zip(bj["loss_data"]._fields, bt["loss_data"], bj["loss_data"]):
        if f.startswith("obs"):
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
