"""The analytic steady states and the batched Thomas solve of the PyTorch
port against the JAX package.

The three steady states (distributive, sequential through
``thomas_solve_batched``, combinatorial through ``torch.linalg.solve``)
are held against the JAX package's at float64, and the port's own RHS
vanishes at them on an isolated network. The plain Thomas solve is held
against the JAX package's XLA scan and its Pallas kernel in interpret
mode; the CUDA kernel against the plain version on the card in
``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network import build_topology as jax_topology
from phoskintime_tpu.network import steadystate as jss
from phoskintime_tpu.ops.pallas_kernels import thomas_pallas
from phoskintime_tpu.ops.tridiag import thomas_solve_batched as jax_thomas
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import steadystate as ss
from phoskintime_tpu_torch.network.system import GlobalSystem, default_params
from phoskintime_tpu_torch.network.topology import build_topology
from phoskintime_tpu_torch.ops.tridiag import (thomas_solve, thomas_solve_batched,
                                               thomas_solve_reference)

torch.set_num_threads(2)

GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])
# float64 on both sides: one linear solve per protein (measured ~1e-16)
RTOL_F64 = 1e-12
# three proteins with 2, 1 and 3 sites under one kinase, no TF edges
ISOLATED = [("GA", "S1", "K"), ("GA", "S2", "K"), ("GB", "S1", "K"),
            ("GC", "S1", "K"), ("GC", "S2", "K"), ("GC", "S3", "K")]
FUNCS = {0: "steady_state_distributive", 1: "steady_state_sequential",
         2: "steady_state_combinatorial"}


def isolated(model):
    """The port's isolated network and the JAX package's: u = 0 and no
    kinase drives a protein, so the rates-1 steady states are equilibria."""
    topo = build_topology(ISOLATED, None, model=model)
    topo.driver_map[:] = -1
    p, s, k = zip(*ISOLATED)
    topo_j = jax_topology(pd.DataFrame({"protein": p, "psite": s, "kinase": k}), None,
                          model=model)
    topo_j.driver_map[:] = -1
    return topo, topo_j


@pytest.mark.parametrize("model", [0, 1, 2])
@pytest.mark.parametrize("tf", [None, "inputs"])
def test_steady_states_match_jax(model, tf):
    topo, topo_j = isolated(model)
    kw = {} if tf is None else dict(TF_inputs=np.asarray([0.7, -1.3, 0.0]), tf_scale=2.5)
    got = getattr(ss, FUNCS[model])(topo, device="cpu", **kw)
    want = getattr(jss, FUNCS[model])(topo_j, **kw)
    assert got.shape == want.shape == (topo.N, topo.width) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL_F64, atol=1e-15)


@pytest.mark.parametrize("model", [0, 1, 2])
def test_steady_states_match_jax_on_the_demo_network(model):
    """Proteins with 0 to 4 sites (the demo's draws, N = 12)."""
    topo_j = jax_demo(n_proteins=10, n_kinases=4, model=model, seed=0,
                      dtype=np.float64)["topo"]
    got = getattr(ss, FUNCS[model])(from_reference(topo_j), device="cpu")
    np.testing.assert_allclose(got, getattr(jss, FUNCS[model])(topo_j),
                               rtol=RTOL_F64, atol=1e-15)


@pytest.mark.parametrize("model", [0, 1, 2])
def test_rhs_vanishes_at_steady_state(model):
    topo, _ = isolated(model)
    system = GlobalSystem(topo, GRID, np.ones((topo.K, len(GRID))), device="cpu")
    params = default_params(topo)
    params["Dp_i"] = params["Dp_i"] * topo.site_mask()
    Y = getattr(ss, FUNCS[model])(topo, device="cpu")
    pt = {k: torch.as_tensor(np.asarray(v, float)) for k, v in params.items()}
    dy = system.rhs(0.0, torch.as_tensor(Y).reshape(-1), 0, pt)
    np.testing.assert_allclose(dy.numpy(), 0.0, atol=1e-9)
    dy_b = system.rhs.batched(0.0, torch.as_tensor(Y).reshape(1, -1),
                              torch.zeros(1, dtype=torch.long),
                              {k: v[None] for k, v in pt.items()})
    np.testing.assert_allclose(dy_b.numpy(), 0.0, atol=1e-9)


# --- the Thomas solve -------------------------------------------------------------


def tridiagonal(B, n, seed=0):
    """Diagonally dominant systems, as tests/test_pallas.py's."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (B, n))
    a[:, 0] = 0.0
    c = rng.normal(0, 1, (B, n))
    c[:, -1] = 0.0
    b = np.abs(rng.normal(0, 1, (B, n))) + 4.0
    d = rng.normal(0, 1, (B, n))
    return a, b, c, d


@pytest.mark.parametrize("n", [1, 2, 5, 17])
@pytest.mark.parametrize("B", [1, 45, 300])
def test_thomas_reference_matches_jax(n, B):
    a, b, c, d = tridiagonal(B, n, seed=n + B)
    got = thomas_solve_reference(*(torch.as_tensor(v) for v in (a, b, c, d)))
    assert got.shape == (B, n) and got.dtype == torch.float64
    jargs = [jnp.asarray(v) for v in (a, b, c, d)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_thomas(*jargs)),
                               rtol=RTOL_F64, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), np.asarray(thomas_pallas(*jargs, interpret=True)),
                               rtol=1e-10, atol=1e-12)
    # the entry point routes a CPU tensor to the plain version
    assert torch.equal(thomas_solve_batched(*(torch.as_tensor(v) for v in (a, b, c, d))), got)


def test_thomas_solve_one_system():
    a, b, c, d = (v[0] for v in tridiagonal(1, 6, seed=3))
    A = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    got = thomas_solve(*(torch.as_tensor(v) for v in (a, b, c, d)))
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, d), rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_thomas_tiny_pivot_guard(dtype):
    """A zero pivot becomes 1e-300 in float64, as the JAX scan's guard
    makes it; in float32 1e-300 rounds to 0 and the guard never fires, in
    either package."""
    a, b, c, d = (v.astype(dtype) for v in tridiagonal(3, 4, seed=9))
    b[1, 0] = 0.0
    got = thomas_solve_batched(*(torch.as_tensor(v) for v in (a, b, c, d))).numpy()
    want = np.asarray(jax_thomas(*(jnp.asarray(v) for v in (a, b, c, d))))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    if dtype == "float64":
        assert np.isfinite(got).all()
        # x_0 of the guarded row is the difference of two terms near 1e300,
        # whose value is all rounding; the rest of the row is not
        keep = np.ones(got.shape, bool)
        keep[1, 0] = False
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-12)
    else:
        assert not np.isfinite(got[1]).all()
        np.testing.assert_allclose(np.delete(got, 1, 0), np.delete(want, 1, 0), rtol=1e-5)


@pytest.mark.parametrize("bad", ["shapes", "kernel_on_cpu"])
def test_thomas_rejects(bad):
    a, b, c, d = (torch.as_tensor(v) for v in tridiagonal(4, 3))
    if bad == "shapes":
        d = d[:, :2]
    with pytest.raises(ValueError):
        thomas_solve_batched(a, b, c, d, use_kernel=True if bad == "kernel_on_cpu" else None)
