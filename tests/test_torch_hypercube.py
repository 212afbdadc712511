"""The combinatorial mechanism's edge flux and the batched RHS of the
PyTorch port against the JAX package.

The plain flux (``hypercube_flux_reference``) is held against the JAX
package's reference and its Pallas kernel run in interpret mode;
``PaddedRHS.batched`` (every member in its own kinase bucket, model 2's
flux through ``hypercube_flux``) against the JAX package's one-member RHS.
The CUDA kernel itself is held against the plain version on the card in
``test_torch_kernels_cuda.py``. Inputs are made with numpy from a seed and
fed to both packages at float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.ops.pallas_kernels import hypercube_flux_pallas
from phoskintime_tpu.ops.pallas_kernels import \
    hypercube_flux_reference as jax_flux_reference
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import rhs as rhs_module
from phoskintime_tpu_torch.ops.hypercube_flux import (hypercube_flux,
                                                      hypercube_flux_reference)

torch.set_num_threads(2)

# float64, the same arithmetic in another summation order (measured ~1e-16)
RTOL_F64, ATOL_F64 = 1e-12, 1e-15


def flux_inputs(smax, B=37, seed=0):
    rng = np.random.default_rng(seed + smax)
    return (rng.uniform(0, 1, (B, 1 << smax)), rng.uniform(0.1, 2.0, (B, smax)),
            rng.uniform(0.1, 2.0, B))


@pytest.mark.parametrize("smax", [1, 2, 3, 4, 5, 11, 12])
def test_reference_matches_jax(smax):
    X, S, E = flux_inputs(smax)
    got = hypercube_flux_reference(*(torch.as_tensor(v) for v in (X, S, E)), smax)
    assert got.shape == X.shape and got.dtype == torch.float64
    want = jax_flux_reference(jnp.asarray(X), jnp.asarray(S), jnp.asarray(E), smax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_F64, atol=ATOL_F64)
    # the entry point routes a CPU tensor to the plain version
    assert torch.equal(hypercube_flux(*(torch.as_tensor(v) for v in (X, S, E)), smax), got)


@pytest.mark.parametrize("smax", [1, 2, 3, 4, 5])
def test_reference_matches_pallas_interpret(smax):
    X, S, E = flux_inputs(smax, B=19, seed=7)
    got = hypercube_flux_reference(*(torch.as_tensor(v) for v in (X, S, E)), smax)
    want = hypercube_flux_pallas(jnp.asarray(X), jnp.asarray(S), jnp.asarray(E), smax,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_F64, atol=ATOL_F64)


@pytest.mark.parametrize("smax", [1, 3, 6])
def test_edge_flux_conserves_mass(smax):
    """Edge fluxes only move mass between the states of a row."""
    X, S, E = (torch.as_tensor(v) for v in flux_inputs(smax, seed=2))
    dX = hypercube_flux(X, S, E, smax)
    np.testing.assert_allclose(dX.sum(dim=1).numpy(), 0.0, atol=1e-12)


@pytest.mark.parametrize("bad", ["width", "rates", "kernel_on_cpu"])
def test_flux_rejects(bad):
    X, S, E = (torch.as_tensor(v) for v in flux_inputs(3, B=4))
    if bad == "width":
        X = X[:, :6]
    if bad == "rates":
        S = S[:, :2]
    with pytest.raises(ValueError):
        hypercube_flux(X, S, E, 3, use_kernel=True if bad == "kernel_on_cpu" else None)


# --- the kernel's work map ---------------------------------------------------------

# csrc/hypercube_flux.cu: threads a block
FLUX_THREADS = 256


def emulate_flux_kernel(X, S, E, smax, blocks, items):
    """``csrc/hypercube_flux.cu``'s work map in numpy, float64: 4 rows a
    thread and step below 4 states, ``items`` quads (the launcher takes 1
    or 2) for rows of 4 to 128 states, 1 quad beyond. For each block and
    step of its grid-stride loop, each thread's quads (or rows), the
    neighbours it reads (its own registers for sites 0 and 1, the lane
    q ^ 2^(j-2) of its warp, the block's shared quads, or, past 10 sites,
    the quad of another block's span in device memory), and the terms in
    the kernel's order. Checks that every state is written exactly once
    and that a row fits a warp (4-128 states) or a block (256-1024), or
    spans whole blocks (2,048 and more)."""
    rows, M = X.shape
    T, Q = FLUX_THREADS, 4 if smax < 2 else (items if smax < 8 else 1)
    if 2 <= smax <= 10:
        assert (32 if smax < 8 else T) % (M // 4) == 0
    elif smax > 10:
        assert (M // 4) % T == 0
    out = np.full(X.size, np.nan)
    written = np.zeros(X.size, int)
    flat = X.reshape(-1)
    if smax < 2:
        for blk in range(blocks):
            for base in range(blk * T * Q, rows, blocks * T * Q):
                for i in range(Q):
                    for t in range(T):
                        r = base + i * T + t
                        if r >= rows:
                            continue
                        written[r * M:(r + 1) * M] += 1
                        if smax == 0:
                            out[r] = 0.0
                        else:
                            x0, x1, s, e = X[r, 0], X[r, 1], S[r, 0], E[r]
                            out[2 * r] = (0.0 + e * x1) - s * x0
                            out[2 * r + 1] = (0.0 + s * x0) - e * x1
        assert (written == 1).all()
        return out.reshape(rows, M)
    quads, QR = rows * M // 4, M // 4
    for blk in range(blocks):
        for base in range(blk * T * Q, quads, blocks * T * Q):
            for i in range(Q):
                q = base + i * T + np.arange(T)             # the block's threads
                live = q < quads
                x = np.where(live[:, None], flat[np.minimum(q, quads - 1)[:, None] * 4
                                                 + np.arange(4)], 0.0)
                row = np.minimum(q, quads - 1) // QR
                s = np.where(live[:, None], S[row], 0.0)
                e = np.where(live, E[row], 0.0)
                acc = np.zeros((T, 4))
                for j in range(smax):
                    if j < 2:
                        xn = x[:, np.arange(4) ^ (1 << j)]
                    else:
                        d = 1 << (j - 2)
                        partner = np.arange(T) ^ d
                        if j < 7:                            # within the warp
                            assert (partner // 32 == np.arange(T) // 32).all()
                        if j < 10:                           # within the block
                            xn = x[partner]
                        else:                                # another block's span
                            xn = flat[(q ^ d)[:, None] * 4 + np.arange(4)]
                            assert ((q ^ d) // T != q // T).all() and ((q ^ d) // QR == row).all()
                    for v in range(4):
                        bit = (v >> j) & 1 if j < 2 else ((q % QR) >> (j - 2)) & 1
                        a = np.where(bit, s[:, j], e)
                        b = np.where(bit, e, s[:, j])
                        acc[:, v] = (acc[:, v] + a * xn[:, v]) - b * x[:, v]
                for t in np.flatnonzero(live):
                    out[q[t] * 4:q[t] * 4 + 4] = acc[t]
                    written[q[t] * 4:q[t] * 4 + 4] += 1
    assert (written == 1).all()
    return out.reshape(rows, M)


@pytest.mark.parametrize("items", [1, 2])
@pytest.mark.parametrize("smax, rows, blocks", [
    (0, 1001, 1), (1, 1001, 2), (1, 3000, 1), (2, 1001, 3), (4, 1001, 2), (4, 37, 5),
    (6, 301, 2), (7, 65, 1), (8, 9, 2), (10, 3, 1), (11, 3, 2), (12, 2, 3), (13, 1, 4)])
def test_flux_work_map_matches_reference(smax, rows, blocks, items):
    """Rows that are no multiple of what a step covers, and grids of fewer
    blocks than the work (the grid-stride loop) or more."""
    X, S, E = flux_inputs(smax, B=rows, seed=11)
    got = emulate_flux_kernel(X, S, E, smax, blocks, items)
    want = hypercube_flux_reference(*(torch.as_tensor(v) for v in (X, S, E)), smax)
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL_F64, atol=ATOL_F64)


# --- the batched RHS --------------------------------------------------------------


@pytest.fixture(scope="module", params=[0, 1, 2], ids=["model0", "model1", "model2"])
def system_pair(request):
    bj = jax_demo(n_proteins=10, n_kinases=4, model=request.param, seed=0, dtype=np.float64)
    return bj["system"], from_reference(bj["system"], device="cpu"), bj["true"]


def population(true, P, seed):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, float)[None] * rng.uniform(0.6, 1.4, (P,) + (1,) * np.ndim(v))
            for k, v in true.items()}


def test_batched_matches_jax_per_member(system_pair):
    """Five members, each with its own state, parameters and bucket (two
    buckets outside the grid, clamped as the JAX package clamps them)."""
    sj, st, true = system_pair
    P, d = 5, st.rhs.N * st.rhs.width
    rng = np.random.default_rng(3)
    Y = rng.uniform(0.0, 2.0, (P, d)) * (st.y0().reshape(-1) != 0.0)[None]
    Y[:, 0::st.rhs.width] = rng.uniform(0.2, 2.0, (P, st.rhs.N))
    jb = np.asarray([0, 4, 13, -2, 40])
    pop = population(true, P, 4)
    got = st.rhs.batched(0.0, torch.as_tensor(Y), torch.as_tensor(jb),
                         {k: torch.as_tensor(v) for k, v in pop.items()})
    assert got.shape == (P, d) and got.dtype == torch.float64
    for p in range(P):
        want = sj.rhs(0.0, jnp.asarray(Y[p]), int(jb[p]),
                      {k: jnp.asarray(v[p]) for k, v in pop.items()})
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want),
                                   rtol=RTOL_F64, atol=ATOL_F64, err_msg=f"member {p}")


def test_batched_at_one_member_matches_call(system_pair):
    _, st, true = system_pair
    y = torch.as_tensor(np.random.default_rng(5).uniform(0.0, 1.5, st.rhs.N * st.rhs.width))
    pop = {k: torch.as_tensor(v) for k, v in population(true, 1, 6).items()}
    one = st.rhs(0.0, y, 7, {k: v[0] for k, v in pop.items()})
    got = st.rhs.batched(0.0, y[None], torch.as_tensor([7]), pop)
    np.testing.assert_allclose(got[0].numpy(), one.numpy(), rtol=RTOL_F64, atol=ATOL_F64)
    # the integrator's closures over the same evaluations
    assert torch.equal(st.rhs_flat({k: v[0] for k, v in pop.items()})(0.0, y, 7), one)
    assert torch.equal(st.rhs_batched(pop)(0.0, y[None], torch.as_tensor([7])), got)


def test_model2_flux_goes_through_the_entry_point(monkeypatch):
    """Model 2's batched RHS makes one hypercube_flux call per evaluation,
    on the (P*N, Mmax) rows."""
    bj = jax_demo(n_proteins=6, n_kinases=3, model=2, seed=1, dtype=np.float64)
    st = from_reference(bj["system"], device="cpu")
    calls = []

    def spy(X, S, E, smax, use_kernel=None):
        calls.append((tuple(X.shape), tuple(S.shape), tuple(E.shape), smax, use_kernel))
        return hypercube_flux(X, S, E, smax, use_kernel=use_kernel)

    monkeypatch.setattr(rhs_module, "hypercube_flux", spy)
    P, N, M, smax = 3, st.rhs.N, st.rhs.Mmax, st.rhs.Smax
    pop = {k: torch.as_tensor(v) for k, v in population(bj["true"], P, 1).items()}
    y = torch.as_tensor(np.tile(st.y0().reshape(1, -1), (P, 1)))
    st.rhs.batched(0.0, y, torch.zeros(P, dtype=torch.long), pop, use_kernel=False)
    assert calls == [((P * N, M), (P * N, smax), (P * N,), smax, False)]
