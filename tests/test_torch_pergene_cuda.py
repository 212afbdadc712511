"""The per-gene stack on the card against the port's own CPU results.

The per-gene path launches no hand-written kernel: these tests hold the
plain PyTorch path on CUDA (the batched expm, the solves, the LM and one
small ``normest``) against the same code on the CPU. Every test is marked
``cuda`` and skips without a card. The file imports no JAX:

    python -m pytest tests/test_torch_pergene_cuda.py --noconftest -q

Tolerances: float64 on the card within 1e-12 of the CPU's largest entry
(expm: 8 * 2^s * eps after s squarings, as tests/test_torch_kinetics.py),
float32 within 1e-3; a float64 fit with the same lambda and weight and
params within rtol 1e-6 (the JAX package's batch-vs-single gate).
"""

import numpy as np
import pytest
import torch

from phoskintime_tpu_torch.fit.normest import normest
from phoskintime_tpu_torch.models.kinetics import (initial_condition, solve_ode, solve_ode_batched,
                                                   solve_tensors)
from phoskintime_tpu_torch.ops.linear import expm
from phoskintime_tpu_torch.ops.lm import lm_loop

pytestmark = pytest.mark.cuda

TIME_POINTS = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0,
                        60.0, 120.0, 240.0, 480.0, 960.0])
BOUNDS = {k: (0.0, 20.0) for k in ("A", "B", "C", "D", "S(i)", "D(i)")}
F64_SCALED, F32_SCALED, FIT_RTOL = 1e-12, 1e-3, 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def scaled(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))


def generators(rng, count, w, log2_norms):
    A = rng.uniform(0.0, 1.0, (count, w, w))
    A[:, np.arange(w), np.arange(w)] = 0.0
    A -= np.eye(w) * A.sum(axis=1, keepdims=True)
    norms = 2.0 ** rng.uniform(*log2_norms, count)
    return A * (norms / np.abs(A).sum(axis=1).max(axis=-1))[:, None, None]


def test_expm_card_vs_cpu(cuda_device):
    rng = np.random.default_rng(0)
    A = generators(rng, 512, 9, (-7, 21))        # every branch, squarings 0-16, NaN above
    want = expm(torch.as_tensor(A)).numpy()
    got64 = expm(torch.as_tensor(A, device=cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got64), np.isnan(want))
    assert np.isnan(want).any() and np.isfinite(want).any()
    assert scaled(got64, want) <= 8 * 2.0 ** 16 * np.finfo(float).eps
    small = generators(rng, 512, 9, (-7, 5))     # float32: up to 3 squarings
    got32 = expm(torch.as_tensor(small, dtype=torch.float32, device=cuda_device)).cpu()
    assert scaled(got32, expm(torch.as_tensor(small)).numpy()) <= F32_SCALED


@pytest.mark.parametrize("model,n", [("distmod", 3), ("succmod", 2), ("randmod", 3)])
def test_solve_ode_batched_card_vs_cpu(cuda_device, model, n):
    rng = np.random.default_rng(1)
    y0 = initial_condition(n, model, device="cpu").numpy()
    npar = 4 + n + (1 << n) - 1 if model == "randmod" else 4 + 2 * n
    P = rng.uniform(0.0, 20.0, (256, npar))
    want_sol, want_fit = solve_ode_batched(P, y0, n, TIME_POINTS, model, device="cpu")
    sol, fit = solve_ode_batched(P, y0, n, TIME_POINTS, model, device=cuda_device,
                                 dtype=torch.float64)
    np.testing.assert_array_equal(torch.isnan(sol).cpu().numpy(), torch.isnan(want_sol).numpy())
    assert scaled(sol.cpu(), want_sol) <= F64_SCALED and scaled(fit.cpu(), want_fit) <= F64_SCALED
    sol32, _ = solve_ode_batched(P, y0, n, TIME_POINTS, model, device=cuda_device)
    assert sol32.dtype == torch.float32 and scaled(sol32.cpu(), want_sol) <= F32_SCALED


def test_lm_loop_reads_nothing_back(cuda_device):
    """The LM iterations run under set_sync_debug_mode("error")."""
    rng = np.random.default_rng(2)
    y0 = initial_condition(2, "distmod", device=cuda_device, dtype=torch.float64)
    t = torch.as_tensor(TIME_POINTS, device=cuda_device)
    _, target = solve_ode(rng.uniform(0.3, 2.5, 8), y0, 2, TIME_POINTS, device=cuda_device,
                          dtype=torch.float64)

    def residual(p):
        return solve_tensors(p, y0, 2, t, "distmod")[1] - target

    p0 = torch.as_tensor(rng.uniform(0.5, 3, (16, 8)), device=cuda_device)
    lo, hi = torch.zeros(8, device=cuda_device, dtype=torch.float64), \
        torch.full((8,), 20.0, device=cuda_device, dtype=torch.float64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, cost, n_acc, J = lm_loop(residual, p0, lo, hi, max_iters=5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cost0 = 0.5 * torch.sum(torch.func.vmap(residual)(p0) ** 2, dim=1)
    assert torch.isfinite(cost).all() and bool((cost <= cost0).all()) and int(n_acc.max()) >= 1
    assert J.shape == (16, target.shape[0], 8)


def test_normest_card_vs_cpu(cuda_device):
    rng = np.random.default_rng(3)
    n = 2
    y0 = initial_condition(n, "distmod", device="cpu").numpy()
    _, fit = solve_ode(rng.uniform(0.3, 2.5, 8), y0, n, TIME_POINTS, device="cpu")
    fit = fit.numpy()
    T = len(TIME_POINTS)
    r, pr, p = fit[:T - 5], fit[T - 5:2 * T - 5], fit[2 * T - 5:].reshape(n, T)
    kw = dict(n_starts=8, lm_iters=30, lambdas=np.logspace(-2, 0, 3))
    want = normest("GENEA", pr, p, r, y0, n, TIME_POINTS, BOUNDS, device="cpu", **kw)
    got = normest("GENEA", pr, p, r, y0, n, TIME_POINTS, BOUNDS, device=cuda_device,
                  dtype=torch.float64, **kw)
    assert (got.lambda_reg, got.weight_name) == (want.lambda_reg, want.weight_name)
    np.testing.assert_allclose(got.params, want.params, rtol=FIT_RTOL)
    np.testing.assert_allclose(got.score, want.score, rtol=FIT_RTOL)
    got32 = normest("GENEA", pr, p, r, y0, n, TIME_POINTS, BOUNDS, device=cuda_device, **kw)
    assert got32.params.dtype == np.float32 and np.isfinite(got32.error)
