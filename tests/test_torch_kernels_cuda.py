"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``cuda`` and
skips without one. The file imports no JAX, so on a machine with a card
and without JAX it runs on its own:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phoskintime_tpu_torch.demo import build_demo_network
from phoskintime_tpu_torch.network import steadystate
from phoskintime_tpu_torch.network.expo import width_classes
from phoskintime_tpu_torch.network.objective import (make_objective, make_population_objective,
                                                     make_residual_fn)
from phoskintime_tpu_torch.network.polish import forward_jacobian, polish_solutions
from phoskintime_tpu_torch.network.rhs import tf_inputs
from phoskintime_tpu_torch.network.sensitivity import run_sensitivity_analysis
from phoskintime_tpu_torch.network.simulate import extract_observables, simulate_batched
from phoskintime_tpu_torch.network.system import GlobalSystem
from phoskintime_tpu_torch.network.topology import build_topology
from phoskintime_tpu_torch.ops.hypercube_flux import (FluxKernel, hypercube_flux,
                                                        hypercube_flux_reference)
from phoskintime_tpu_torch.ops.hypercube_flux import _launch as flux_launch
from phoskintime_tpu_torch.ops.tridiag import thomas_solve_batched, thomas_solve_reference
from phoskintime_tpu_torch.ops.phi_tables import (ladder_len, phi_tables,
                                                  phi_tables_reference, phi_tables_stream,
                                                  phi_tables_wide, phi_tables_xwide,
                                                  phi_vectors, resident_clusters,
                                                  stream_launch_shape)
from phoskintime_tpu_torch.ops.scan_kernel import (VARIANTS, etd2rk_scan,
                                                   etd2rk_scan_reference, random_scan_problem,
                                                   scan_launch_shape, scan_runs)
from tools.smoke_cases import hypercube_blocks

pytestmark = pytest.mark.cuda

# float32 against float32: errors relative to the table's largest entry,
# the JAX package's own tolerance for its Pallas table kernels
SCALED_ATOL_F32 = 2e-5
# the whole scan, float32 against float32 on the trajectory: the JAX
# package's tolerance for its Pallas scan kernel (tests/test_pallas.py:262-263)
SCAN_RTOL, SCAN_ATOL = 2e-3, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def compartmental_blocks(rng, Bu, w, B):
    """Blocks shaped like the model's: non-negative transfers off the
    diagonal, each column's outflow plus its own decay on the diagonal."""
    L = rng.uniform(0.0, 2.0, (Bu, w, w, B))
    L[:, np.arange(w), np.arange(w), :] = 0.0
    L[:, np.arange(w), np.arange(w), :] = -(L.sum(axis=1)
                                            + rng.uniform(0.01, 4.0, (Bu, w, B)))
    return L


def assert_scaled_close(got, want, atol=SCALED_ATOL_F32):
    scale = float(torch.max(torch.abs(want))) + 1e-30
    err = float(torch.max(torch.abs(got - want))) / scale
    assert err <= atol, err


@pytest.mark.parametrize("w", range(2, 9))
def test_kernel_matches_plain(cuda_device, w):
    rng = np.random.default_rng(w)
    L = torch.as_tensor(compartmental_blocks(rng, 2, w, 1000),
                        dtype=torch.float32, device=cuda_device)
    binv, h_u = np.asarray([0, 1, 1]), np.asarray([0.0625, 2.0, 16.0])
    lad = max(ladder_len(w, h) for h in h_u)
    before = phi_tables.launches
    got = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    assert phi_tables.launches == before + 1
    for g, r in zip(got, phi_tables_reference(L, binv, h_u, lad)):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert_scaled_close(g, r)


@pytest.mark.parametrize("w", range(9, 18))
def test_wide_kernel_matches_plain(cuda_device, w):
    rng = np.random.default_rng(w)
    L = torch.as_tensor(compartmental_blocks(rng, 2, w, 1000),
                        dtype=torch.float32, device=cuda_device)
    binv, h_u = np.asarray([0, 1, 1]), np.asarray([0.0625, 2.0, 16.0])
    lad = max(ladder_len(w, h) for h in h_u)
    before = (phi_tables.launches, phi_tables_wide.launches)
    got = phi_tables(L, binv, h_u, lad)              # routes w > 8 to the wide kernel
    torch.cuda.synchronize()
    assert (phi_tables.launches, phi_tables_wide.launches) == (before[0], before[1] + 1)
    for g, r in zip(got, phi_tables_reference(L, binv, h_u, lad)):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert_scaled_close(g, r)
    for g, r in zip(phi_vectors(L[1], 2.0, lad), phi_vectors(L[1], 2.0, lad, use_kernel=False)):
        assert_scaled_close(g, r)


@pytest.mark.parametrize("w", [9, 13, 17])
def test_wide_kernel_mixed_squaring_counts(cuda_device, w):
    """Lanes whose squaring counts run from 0 to the ladder's clip side by
    side in every warp (the warp's trip count is its largest lane's, each
    lane stepping only to its own), against the plain version."""
    rng = np.random.default_rng(w)
    B, lad = 640, ladder_len(w, 16.0)
    L = compartmental_blocks(rng, 1, w, B)
    norm = np.abs(L[0]).sum(axis=1).max(axis=0)                # (B,)
    want_s = np.arange(B) % (lad + 3) - 1                      # -1 .. lad + 1, clipped
    L = L * (0.5 * 2.0 ** want_s / norm * rng.uniform(0.6, 0.95, B))[None, None, None]
    L = torch.as_tensor(L, dtype=torch.float32, device=cuda_device)
    binv, h_u = np.asarray([0]), np.asarray([1.0])
    A = L[0].double()
    s = torch.clamp(torch.ceil(torch.log2(torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
                                          / 0.5)), 0, lad)
    assert set(s.long().tolist()) == set(range(lad + 1))
    got = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    for g, r in zip(got, phi_tables_reference(L, binv, h_u, lad)):
        assert_scaled_close(g, r)


@pytest.mark.parametrize("w", [6, 9, 17])
def test_nan_lane_stays_in_its_lane(cuda_device, w):
    """A NaN member gets NaN tables and leaves every other lane, its tile's
    neighbours included, exactly as it was."""
    rng = np.random.default_rng(0)
    L = torch.as_tensor(compartmental_blocks(rng, 1, w, 256),
                        dtype=torch.float32, device=cuda_device)
    binv, h_u = np.asarray([0, 0]), np.asarray([1.0, 16.0])
    lad = max(ladder_len(w, h) for h in h_u)
    clean = phi_tables(L, binv, h_u, lad)
    L[..., 37] = float("nan")
    dirty = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    keep = torch.arange(256, device=cuda_device) != 37
    for c, d in zip(clean, dirty):
        assert torch.equal(c[..., keep], d[..., keep])
        assert bool(torch.isnan(d[..., 37]).all())


def table_counts() -> tuple:
    return (phi_tables.launches, phi_tables_wide.launches, phi_tables_xwide.launches,
            phi_tables_stream.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("w", [130, 257, 513])
def test_stream_kernel_matches_plain(cuda_device, w, dtype):
    """The stream kernel (w >= 130) against the plain version on a few
    lanes (11, no multiple of anything), three pairs over two buckets: one
    launch of its own counter and none of the others, a NaN lane all NaN
    with the others' bits unchanged, and phi_vectors (U = 1). Blocks shaped
    like model 2's at 8 and 9 sites (w = 257, 513), compartmental at 130."""
    rng = np.random.default_rng(w)
    L = (compartmental_blocks(rng, 2, w, 11) if w == 130
         else hypercube_blocks(rng, 2, w.bit_length() - 1, 11))
    L = torch.as_tensor(L, dtype=dtype, device=cuda_device)
    binv, h_u = np.asarray([0, 1, 1]), np.asarray([0.0625, 2.0, 16.0])
    lad = max(ladder_len(w, h) for h in h_u)
    before = table_counts()
    got = phi_tables(L, binv, h_u, lad)              # routes w > 129 to the stream kernel
    torch.cuda.synchronize()
    assert table_counts() == before[:3] + (before[3] + 1,)
    tol = SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64
    for g, r in zip(got, phi_tables_reference(L, binv, h_u, lad)):
        assert g.shape == r.shape and g.dtype == dtype
        assert_scaled_close(g, r, tol)
    L[..., 7] = float("nan")
    dirty = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    keep = torch.arange(11, device=cuda_device) != 7
    for c, d in zip(got, dirty):
        assert torch.equal(c[..., keep], d[..., keep]) and bool(torch.isnan(d[..., 7]).all())
    L[..., 7] = 0.0
    for g, r in zip(phi_vectors(L[1], 2.0, lad), phi_vectors(L[1], 2.0, lad, use_kernel=False)):
        assert_scaled_close(g, r, tol)


def test_stream_kernel_many_items_few_slots(cuda_device):
    """More (pair, lane) items than the grid's clusters (each cluster walks
    its items in strides of the grid's), 2 pairs x 300 lanes at w = 130,
    float32; phi_tables_stream itself takes no width the xwide kernel
    takes."""
    rng = np.random.default_rng(3)
    L = torch.as_tensor(compartmental_blocks(rng, 1, 130, 300), dtype=torch.float32,
                        device=cuda_device)
    clusters = resident_clusters(L.device, torch.float32)
    shape = stream_launch_shape(130, 4, 600, clusters)
    assert 1 <= clusters == shape.slots < 600
    got = phi_tables(L, [0, 0], [0.5, 4.0], ladder_len(130, 4.0))
    torch.cuda.synchronize()
    for g, r in zip(got, phi_tables_reference(L, [0, 0], [0.5, 4.0], ladder_len(130, 4.0))):
        assert_scaled_close(g, r)
    with pytest.raises(NotImplementedError, match="w >= 130"):
        phi_tables_stream(L[:, :129, :129, :20].contiguous(), [0], [1.0], 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("w", [18, 22, 29, 33, 47, 65, 66, 96, 97, 98, 113, 129])
def test_xwide_kernel_matches_plain(cuda_device, w, dtype):
    """The widest kernel (18 <= w <= 129) against the plain version: lanes
    no multiple of a block's, three pairs over two buckets, one launch of
    its own counter and none of the others; phi_vectors (U = 1) too. In
    float64 w = 96 is the widest lane one block holds; from 97 a cluster of
    two blocks holds each lane (xwide_launch_shape)."""
    rng = np.random.default_rng(w)
    L = torch.as_tensor(compartmental_blocks(rng, 2, w, 301), dtype=dtype, device=cuda_device)
    binv, h_u = np.asarray([0, 1, 1]), np.asarray([0.0625, 2.0, 16.0])
    lad = max(ladder_len(w, h) for h in h_u)
    before = table_counts()
    got = phi_tables(L, binv, h_u, lad)              # routes w > 17 to the widest kernel
    torch.cuda.synchronize()
    assert table_counts() == (before[0], before[1], before[2] + 1, before[3])
    tol = SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64
    for g, r in zip(got, phi_tables_reference(L, binv, h_u, lad)):
        assert g.shape == r.shape and g.dtype == dtype
        assert_scaled_close(g, r, tol)
    for g, r in zip(phi_vectors(L[1], 2.0, lad), phi_vectors(L[1], 2.0, lad, use_kernel=False)):
        assert_scaled_close(g, r, tol)


def test_xwide_kernel_every_width(cuda_device):
    """Every width 18..129 at float32, 97 lanes, one pair at h = 2."""
    rng = np.random.default_rng(18)
    for w in range(18, 130):
        L = torch.as_tensor(compartmental_blocks(rng, 1, w, 97), dtype=torch.float32,
                            device=cuda_device)
        lad = ladder_len(w, 2.0)
        got = phi_tables_xwide(L, [0], [2.0], lad)
        torch.cuda.synchronize()
        for g, r in zip(got, phi_tables_reference(L, [0], [2.0], lad)):
            assert_scaled_close(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("w", [22, 33, 65, 98, 129])
def test_xwide_kernel_mixed_squaring_counts(cuda_device, w, dtype):
    """Lanes whose squaring counts run from 0 to the ladder's clip side by
    side in every block (the block's trip count is its largest lane's, each
    lane stepping only to its own), against the plain version; in float64
    at 98 and 129 through the cluster of two blocks."""
    rng = np.random.default_rng(w)
    B, lad = 320, ladder_len(w, 16.0)
    L = compartmental_blocks(rng, 1, w, B)
    norm = np.abs(L[0]).sum(axis=1).max(axis=0)                # (B,)
    want_s = np.arange(B) % (lad + 3) - 1                      # -1 .. lad + 1, clipped
    L = L * (0.5 * 2.0 ** want_s / norm * rng.uniform(0.6, 0.95, B))[None, None, None]
    L = torch.as_tensor(L, dtype=dtype, device=cuda_device)
    A = L[0].double()
    radius = 0.5 if dtype == torch.float32 else 0.25
    s = torch.clamp(torch.ceil(torch.log2(torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
                                          / radius)), 0, lad)
    assert set(s.long().tolist()) == set(range(lad + 1))
    got = phi_tables(L, [0], [1.0], lad)
    torch.cuda.synchronize()
    tol = SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64
    for g, r in zip(got, phi_tables_reference(L, [0], [1.0], lad)):
        assert_scaled_close(g, r, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("w", [22, 65, 97, 129])
def test_xwide_nan_lane_stays_in_its_lane(cuda_device, w, dtype):
    """A NaN member gets NaN tables and leaves every other lane, those of
    its own block included, exactly as it was."""
    rng = np.random.default_rng(0)
    L = torch.as_tensor(compartmental_blocks(rng, 1, w, 64), dtype=dtype, device=cuda_device)
    binv, h_u = np.asarray([0, 0]), np.asarray([1.0, 16.0])
    lad = max(ladder_len(w, h) for h in h_u)
    clean = phi_tables(L, binv, h_u, lad)
    L[..., 37] = float("nan")
    dirty = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    keep = torch.arange(64, device=cuda_device) != 37
    for c, d in zip(clean, dirty):
        assert torch.equal(c[..., keep], d[..., keep])
        assert bool(torch.isnan(d[..., 37]).all())


def test_model2_objective_at_six_sites_goes_through_the_kernels(cuda_device):
    """Model 2 at ``mechanisms``' default cap (classes up to w = 65): one
    launch a width class, each class to its kernel by width, F within 1e-3
    of the plain tables' route."""
    b = build_demo_network(n_proteins=6, n_kinases=3, max_sites=6, model=2, seed=0,
                           dtype=torch.float32, device=cuda_device)
    widths = [wc for wc, _ in width_classes(b["topo"])]
    assert {33, 65} <= set(widths)
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(4, len(b["theta0"])))
    phi_tables.launches = phi_tables_wide.launches = phi_tables_xwide.launches = 0
    phi_tables_stream.launches = 0
    F = make_population_objective(*args, pop_chunk=4)(thetas)
    assert table_counts() == (sum(wc <= 8 for wc in widths),
                              sum(8 < wc <= 17 for wc in widths),
                              sum(wc > 17 for wc in widths), 0)
    Fp = make_population_objective(*args, pop_chunk=4, use_kernel=False)(thetas)
    assert F.shape == (4, 3) and bool(torch.isfinite(F).all())
    assert float(torch.max(torch.abs(F - Fp) / torch.abs(Fp))) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("w", range(2, 9))
def test_kernel_many_blocks_matches_plain(cuda_device, w, dtype):
    """14 pairs of 157 lane tiles (more blocks than the card holds at
    once), lanes no multiple of the tile, squaring counts from 0 to the
    ladder side by side, and NaN lanes (one mid-tile, the last lane) that
    leave every other lane as it was."""
    B = 20037
    rng = np.random.default_rng(w)
    L = torch.as_tensor(compartmental_blocks(rng, 3, w, B), dtype=dtype, device=cuda_device)
    binv = np.asarray([0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1])
    h_u = 2.0 ** np.arange(-4, 10)
    lad = max(ladder_len(w, h) for h in h_u)
    before = phi_tables.launches
    clean = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    assert phi_tables.launches == before + 1
    tol = SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64
    for g, r in zip(clean, phi_tables_reference(L, binv, h_u, lad)):
        assert g.shape == r.shape and g.dtype == dtype
        assert_scaled_close(g, r, tol)
    bad = [1000, B - 1]
    L[..., bad] = float("nan")
    dirty = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    keep = torch.ones(B, dtype=torch.bool, device=cuda_device)
    keep[bad] = False
    for c, d in zip(clean, dirty):
        assert torch.equal(c[..., keep], d[..., keep])
        assert bool(torch.isnan(d[..., bad]).all())


@pytest.mark.parametrize("bad, err", [
    (dict(dtype=torch.float16), NotImplementedError),
    (dict(w=66), NotImplementedError),
    (dict(strided=True), ValueError),
])
def test_kernel_rejects(cuda_device, bad, err):
    w = bad.get("w", 4)
    L = torch.zeros((1, w, w, 64 if bad.get("strided") else 32),
                    dtype=bad.get("dtype", torch.float32), device=cuda_device)
    if bad.get("strided"):
        L = L[..., ::2]
    with pytest.raises(err):
        phi_tables(L, [0], [1.0], 4)


def test_objective_goes_through_the_kernel(cuda_device):
    b = build_demo_network(n_proteins=12, n_kinases=5, seed=0,
                           dtype=torch.float32, device=cuda_device)
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(5, len(b["theta0"])))
    phi_tables.launches = 0
    F = make_population_objective(*args, pop_chunk=2)(thetas)
    assert phi_tables.launches == 3                  # one per chunk
    Fp = make_population_objective(*args, pop_chunk=2, use_kernel=False)(thetas)
    assert F.shape == (5, 3) and bool(torch.isfinite(F).all())
    # float32 tables of one algorithm in two builds, through 133 ETD2RK steps
    assert float(torch.max(torch.abs(F - Fp) / torch.abs(Fp))) <= 1e-3


def test_model2_objective_goes_through_both_kernels(cuda_device):
    b = build_demo_network(n_proteins=12, n_kinases=5, model=2, seed=0,
                           dtype=torch.float32, device=cuda_device)
    widths = [wc for wc, _ in width_classes(b["topo"])]
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(4, len(b["theta0"])))
    phi_tables.launches = phi_tables_wide.launches = 0
    F = make_population_objective(*args, pop_chunk=4)(thetas)
    assert phi_tables.launches == sum(wc <= 8 for wc in widths)
    assert phi_tables_wide.launches == sum(wc > 8 for wc in widths) > 0
    Fp = make_population_objective(*args, pop_chunk=4, use_kernel=False)(thetas)
    assert F.shape == (4, 3) and bool(torch.isfinite(F).all())
    assert float(torch.max(torch.abs(F - Fp) / torch.abs(Fp))) <= 1e-3


@pytest.mark.parametrize("model", [0, 2])
def test_knockout_explorer_goes_through_the_tables(cuda_device, model, monkeypatch, tmp_path):
    """The global knockout explorer's one batched ETD2RK call launches the
    table kernels once a width class (the full width where the mechanism
    has no classes); its float32 fold changes agree with the plain route's
    within 1e-3 relative (|fc| floored at 1e-6), and the page is written."""
    from functools import partial

    from phoskintime_tpu_torch.analysis import influence
    from phoskintime_tpu_torch.network import expo

    b = build_demo_network(n_proteins=12, n_kinases=5, model=model, seed=0,
                           dtype=torch.float32, device=cuda_device)
    widths = [wc for wc, _ in width_classes(b["topo"])] or [b["topo"].width]
    phi_tables.launches = phi_tables_wide.launches = 0
    path = influence.export_global_knockout_explorer(b["system"], b["true"],
                                                     str(tmp_path / "ko.html"))
    assert (phi_tables.launches, phi_tables_wide.launches) == (
        sum(w <= 8 for w in widths), sum(w > 8 for w in widths))
    assert "global-model knockout explorer" in Path(path).read_text()
    ko = influence.knockout_scenarios(b["system"], b["true"])
    monkeypatch.setattr(expo, "exponential_simulate_batched",
                        partial(expo.exponential_simulate_batched, use_kernel=False))
    phi_tables.launches = phi_tables_wide.launches = 0
    plain = influence.knockout_scenarios(b["system"], b["true"])
    assert phi_tables.launches == phi_tables_wide.launches == 0
    for k in ("est", "ko_est"):
        assert np.isfinite(ko[k]).all(), k
        err = np.max(np.abs(ko[k] - plain[k]) / np.maximum(np.abs(plain[k]), 1e-6))
        assert err <= 1e-3, (k, err)


# --- the whole-scan kernel --------------------------------------------------------


@pytest.mark.parametrize("w", range(2, 18))
def test_scan_kernel_matches_plain(cuda_device, w):
    args, plan = random_scan_problem(w, seed=w, device=cuda_device)
    before = etd2rk_scan.launches
    got = etd2rk_scan(*args, plan)
    torch.cuda.synchronize()
    assert etd2rk_scan.launches == before + 1
    want = etd2rk_scan_reference(*args, plan)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=SCAN_RTOL, atol=SCAN_ATOL)


@pytest.mark.parametrize("w", [6, 14, 17])
def test_scan_kernel_wide_member(cuda_device, w):
    """Members of 200 proteins: one member a block, 224 threads, the widest
    blocks the kernel takes."""
    args, plan = random_scan_problem(w, N=200, P=12, seed=w, device=cuda_device)
    got = etd2rk_scan(*args, plan)
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan),
                               rtol=SCAN_RTOL, atol=SCAN_ATOL)


@pytest.mark.parametrize("w, N, variant", [
    (8, 45, "registers"), (9, 45, "shared"), (16, 224, "shared"), (16, 225, "stream"),
    (17, 199, "shared"), (17, 200, "stream")])
def test_scan_kernel_variants_at_their_thresholds(cuda_device, w, N, variant):
    """Each variant of the kernel, at each side of the switch from E in
    registers to E in shared memory (w = 8 / 9) and from shared memory to
    streaming (the largest member whose E rows fit the block, at w = 16 and
    17), against the plain version."""
    assert scan_launch_shape(w, N).variant == variant
    args, plan = random_scan_problem(w, N=N, P=5, seed=N, device=cuda_device)
    before = etd2rk_scan.launches
    got = etd2rk_scan(*args, plan)
    torch.cuda.synchronize()
    assert etd2rk_scan.launches == before + 1
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan),
                               rtol=SCAN_RTOL, atol=SCAN_ATOL)


@pytest.mark.parametrize("w", [6, 13, 17])
def test_scan_kernel_pairs_out_of_order(cuda_device, w):
    """A plan whose pairs come back out of order, in runs of 1 to 6
    segments: each run's rows are loaded at its first segment."""
    args, plan = random_scan_problem(w, N=11, P=40, S=24, seed=w, device=cuda_device)
    uidx = np.asarray([2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 2, 2, 2, 1, 0, 0, 1, 2, 0, 0, 0, 1, 1, 2],
                      np.int32)
    jb = np.asarray([0, 1, 1])[uidx].astype(np.int32)
    plan = plan._replace(uidx=uidx, jb=jb, runs=scan_runs(uidx, jb))
    assert len(plan.runs) == 12
    got = etd2rk_scan(*args, plan)
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan),
                               rtol=SCAN_RTOL, atol=SCAN_ATOL)


def test_scan_shared_segment_end(cuda_device):
    """Two t_eval points (slots 2 and 3) on one segment: the kernel writes
    slot 2 and the wrapper copies it to slot 3, as the plain version does."""
    args, plan = random_scan_problem(7, seed=3, device=cuda_device)
    out_slot = plan.out_slot.copy()
    out_slot[out_slot == 3] = -1
    plan = plan._replace(out_slot=out_slot, slot_map=np.asarray([0, 1, 2, 2, 4, 5]))
    got = etd2rk_scan(*args, plan)
    torch.cuda.synchronize()
    assert torch.equal(got[2], got[3])
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan),
                               rtol=SCAN_RTOL, atol=SCAN_ATOL)


def test_scan_nan_member_stays_in_its_lanes(cuda_device):
    """A NaN member (member 37, which shares its thread block with other
    members) leaves every other member's snapshots bit-identical."""
    args, plan = random_scan_problem(6, N=7, P=200, device=cuda_device)
    clean = etd2rk_scan(*args, plan)
    A = args[5].clone()
    A[7 * 37:7 * 38] = float("nan")
    dirty = etd2rk_scan(*args[:5], A, args[6], plan)
    torch.cuda.synchronize()
    keep = (torch.arange(1400, device=cuda_device) // 7) != 37
    assert torch.equal(clean[..., keep], dirty[..., keep])
    assert bool(torch.isnan(dirty[1:, 0, ~keep]).all())


def test_scan_driven_override_is_a_select(cuda_device):
    """A non-finite state of a kinase-driven protein (protein 0) reaches none
    of its member's other proteins: their TF input reads the kinase drive."""
    args, plan = random_scan_problem(5, N=7, P=50, device=cuda_device)
    assert plan.driven[0] == 1
    clean = etd2rk_scan(*args, plan)
    y0 = args[3].clone()
    y0[1:, 7 * 9] = float("inf")                       # member 9, protein 0
    dirty = etd2rk_scan(*args[:3], y0, *args[4:], plan)
    torch.cuda.synchronize()
    keep = torch.arange(350, device=cuda_device) != 7 * 9
    assert torch.equal(clean[..., keep], dirty[..., keep])


@pytest.mark.parametrize("bad, err", [
    ("float16", NotImplementedError),
    ("strided", ValueError),
])
def test_scan_kernel_rejects(cuda_device, bad, err):
    """float16 raises NotImplementedError, a strided tensor ValueError
    (w = 130 raised here until the stream table kernel: it runs now,
    test_wide_scan_kernel_matches_plain)."""
    args, plan = random_scan_problem(4, N=5, P=2, S=8)      # built on the CPU
    args = [x.to(cuda_device) for x in args]
    if bad == "float16":
        args = [x.half() for x in args]
    if bad == "strided":
        args[0] = args[0].transpose(1, 2)
    with pytest.raises(err):
        etd2rk_scan(*args, plan)


# the shapes past the template kernel's: widths past 17 (a member in a
# block, or over a cluster of up to 7 at w = 129), members past 256 proteins
# (a member a block at w = 6 and N = 257; over clusters, E streamed, the
# state in device memory at w = 129; past 6,144 proteins wide-global with
# several lanes a thread), each in both types
WIDE_SCAN_CASES = [(18, 7), (22, 7), (33, 7), (65, 7), (96, 7), (97, 7), (128, 7), (129, 7),
                   (6, 257), (6, 1024), (6, 4096), (22, 257), (22, 1024), (22, 4096),
                   (65, 257), (129, 1024), (129, 4096), (6, 8193), (22, 8193), (6, 16384),
                   (22, 16384), (130, 7), (257, 7), (257, 300), (513, 7)]
SCAN_TOLS = {torch.float32: (SCAN_RTOL, SCAN_ATOL), torch.float64: (1e-10, 1e-12)}


def wide_members(w, N):
    """Members of a wide-kernel test problem: several, but at most ~33,000
    lanes at the widest blocks and largest members."""
    return (40 if N == 7 and w <= 129 else 4 if N == 7 else 8 if N < 257 or w <= 129 and N < 1024
            else 2 if w <= 22 else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("w, N", WIDE_SCAN_CASES)
def test_wide_scan_kernel_matches_plain(cuda_device, w, N, dtype):
    """The kernel past the template's domain (w >= 18 or N > 256) in each of
    its regimes against the plain version: one launch, no
    NotImplementedError, up to N = 16,384."""
    shape = scan_launch_shape(w, N, dtype.itemsize)
    assert shape.variant in VARIANTS[3:]
    args, plan = random_scan_problem(w, N=N, P=wide_members(w, N), seed=w + N, dtype=dtype,
                                     device=cuda_device)
    before = etd2rk_scan.launches
    got = etd2rk_scan(*args, plan)
    torch.cuda.synchronize()
    assert etd2rk_scan.launches == before + 1 and got.dtype == dtype
    rtol, atol = SCAN_TOLS[dtype]
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan), rtol=rtol, atol=atol)


@pytest.mark.parametrize("w, N, dtype, want", [
    (8, 461, torch.float32, ("wide-shared", 1, 1, 1, False)),
    (7, 321, torch.float64, ("wide-shared", 1, 1, 1, False)),
    (117, 4, torch.float32, ("wide-shared", 1, 2, 1, False)),
    (116, 7, torch.float32, ("wide-shared", 2, 2, 1, True)),
    (116, 7, torch.float64, ("wide-shared", 4, 2, 1, True)),
    (12, 443, torch.float32, ("wide-shared", 2, 1, 1, True)),
    (8, 427, torch.float64, ("wide-shared", 2, 1, 1, True)),
    (21, 200, torch.float32, ("wide-shared", 2, 1, 1, False)),
    (7, 2243, torch.float64, ("wide-shared", 7, 1, 1, False)),
    (112, 497, torch.float32, ("wide-stream", 5, 1, 1, True)),
    (104, 325, torch.float32, ("wide-stream", 3, 1, 1, False)),
    (90, 497, torch.float64, ("wide-global", 1, 1, 1, False)),
    (2, 16384, torch.float32, ("wide-global", 8, 1, 4, True)),
    (2, 9809, torch.float64, ("wide-global", 7, 1, 3, True)),
    (2, 16384, torch.float64, ("wide-global", 8, 1, 4, False))])
def test_wide_scan_kernel_at_its_limits(cuda_device, w, N, dtype, want):
    """Each regime past the template's domain at its largest launch
    (~227 KB of shared memory, or its most threads and lanes): wide-shared
    with a member in one block of a thread a lane (its simple build), with
    a lane's columns over 2 warps, with a
    cluster that copies its totals to each other block (push; also with a
    lane's rows over 2 threads) or reads them across the cluster (pull);
    wide-stream both ways; wide-global in one block and over clusters of
    3-4 lanes a thread. Each schedules and agrees with the plain version."""
    shape = scan_launch_shape(w, N, dtype.itemsize)
    assert (shape.variant, shape.cluster, shape.cols, shape.per, shape.push) == want
    assert shape.threads == 512 or shape.shared_bytes > 220_000
    args, plan = random_scan_problem(w, N=N, P=2, S=12, seed=w, dtype=dtype, device=cuda_device)
    got = etd2rk_scan(*args, plan)
    torch.cuda.synchronize()
    rtol, atol = SCAN_TOLS[dtype]
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("w, N, P, member", [(65, 7, 40, 5), (6, 1024, 3, 1), (129, 7, 6, 2),
                                             (6, 16384, 2, 1)])
def test_wide_scan_nan_member_stays_in_its_lanes(cuda_device, w, N, P, member, dtype):
    """A NaN member of the wide kernel (w = 65: a member a block; N = 1,024
    and w = 129: a member over a cluster that copies its totals between its
    blocks; N = 16,384: over 8 blocks of several lanes a thread) leaves
    every other member's snapshots bit-identical."""
    args, plan = random_scan_problem(w, N=N, P=P, seed=w, dtype=dtype, device=cuda_device)
    clean = etd2rk_scan(*args, plan)
    A = args[5].clone()
    A[N * member:N * (member + 1)] = float("nan")
    dirty = etd2rk_scan(*args[:5], A, args[6], plan)
    torch.cuda.synchronize()
    keep = (torch.arange(N * P, device=cuda_device) // N) != member
    assert torch.equal(clean[..., keep], dirty[..., keep])
    assert bool(torch.isnan(dirty[1:, 0, ~keep]).all())


@pytest.mark.parametrize("w, N", [(22, 7), (6, 300), (129, 7), (6, 16384)])
def test_wide_scan_driven_override_is_a_select(cuda_device, w, N):
    """Past the template's domain too, a non-finite kinase-driven protein
    reaches none of its member's other proteins (at N = 300 across a block
    of a thread a lane, at w = 129 across a cluster that copies its totals
    between blocks, at N = 16,384 over 8 blocks of 4 lanes a thread)."""
    args, plan = random_scan_problem(w, N=N, P=6, seed=w, device=cuda_device)
    clean = etd2rk_scan(*args, plan)
    y0 = args[3].clone()
    y0[1:, N * 4] = float("inf")                       # member 4, protein 0
    dirty = etd2rk_scan(*args[:3], y0, *args[4:], plan)
    torch.cuda.synchronize()
    keep = torch.arange(N * 6, device=cuda_device) != N * 4
    assert torch.equal(clean[..., keep], dirty[..., keep])


@pytest.mark.parametrize("w", [22, 65, 129])
def test_wide_scan_pairs_out_of_order(cuda_device, w):
    """The wide kernel reloads each run's rows at its first segment."""
    args, plan = random_scan_problem(w, N=7, P=20, S=24, seed=w, device=cuda_device)
    uidx = np.asarray([2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 2, 2, 2, 1, 0, 0, 1, 2, 0, 0, 0, 1, 1, 2],
                      np.int32)
    jb = np.asarray([0, 1, 1])[uidx].astype(np.int32)
    plan = plan._replace(uidx=uidx, jb=jb, runs=scan_runs(uidx, jb))
    got = etd2rk_scan(*args, plan)
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan),
                               rtol=SCAN_RTOL, atol=SCAN_ATOL)


@pytest.mark.parametrize("model, kw", [(0, dict(max_sites=20)), (0, dict(n_proteins=300))])
def test_objective_goes_through_the_wide_scan_kernel(cuda_device, model, kw):
    """The objective unbucketed past w = 17 (a 20-site protein: w = 22) and
    past N = 256: one scan launch a chunk, F against the eager scan."""
    b = build_demo_network(**{"n_proteins": 5, "n_kinases": 3, "seed": 5, **kw}, model=model,
                           dtype=torch.float32, device=cuda_device)
    assert b["topo"].width > 17 or b["topo"].N > 256
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(5, len(b["theta0"])))
    etd2rk_scan.launches = 0
    F = make_population_objective(*args, pop_chunk=2, use_scan_kernel=True,
                                  width_bucketing=False)(thetas)
    torch.cuda.synchronize()
    assert etd2rk_scan.launches == 3                 # one per chunk
    Fe = make_population_objective(*args, pop_chunk=2, width_bucketing=False)(thetas)
    assert F.shape == (5, 3) and bool(torch.isfinite(F).all())
    assert float(torch.max(torch.abs(F - Fe) / torch.abs(Fe))) <= 1e-3


@pytest.mark.parametrize("model", [0, 2])
def test_objective_goes_through_the_scan_kernel(cuda_device, model):
    """One scan launch per chunk (model 2 unbucketed: its tables in the wide
    kernel); F against the default objective (eager scan)."""
    b = build_demo_network(n_proteins=12, n_kinases=5, model=model, seed=0,
                           dtype=torch.float32, device=cuda_device)
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(5, len(b["theta0"])))
    kw = dict(width_bucketing=False) if model == 2 else {}
    phi_tables.launches = phi_tables_wide.launches = etd2rk_scan.launches = 0
    F = make_population_objective(*args, pop_chunk=2, use_scan_kernel=True, **kw)(thetas)
    torch.cuda.synchronize()
    assert etd2rk_scan.launches == 3                 # one per chunk
    assert (phi_tables_wide if model == 2 else phi_tables).launches == 3
    Fe = make_population_objective(*args, pop_chunk=2)(thetas)
    assert F.shape == (5, 3) and bool(torch.isfinite(F).all())
    assert float(torch.max(torch.abs(F - Fe) / torch.abs(Fe))) <= 1e-3


# --- the hypercube edge flux and the Thomas solve ------------------------------------

# float64 kernels against float64 plain versions: rounding only
SCALED_ATOL_F64 = 1e-12


def flux_inputs(rng, rows, smax, dtype, device):
    f = dict(dtype=dtype, device=device)
    return (torch.as_tensor(rng.uniform(0, 1, (rows, 1 << smax)), **f),
            torch.as_tensor(rng.uniform(0.1, 2.0, (rows, smax)), **f),
            torch.as_tensor(rng.uniform(0.1, 2.0, rows), **f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("smax", range(0, 14))
def test_hypercube_kernel_matches_plain(cuda_device, smax, dtype):
    """1,001 rows (no multiple of the rows or quads a thread owns, the last
    warp ragged): smax 0-1 a thread a row, 2-7 by registers and warp
    shuffles, 8-10 through shared memory as well, 11-13 over several blocks
    a row (a neighbour past the block's span from device memory)."""
    X, S, E = flux_inputs(np.random.default_rng(smax), 1001, smax, dtype, cuda_device)
    before = hypercube_flux.launches
    got = hypercube_flux(X, S, E, smax)
    torch.cuda.synchronize()
    assert hypercube_flux.launches == before + 1
    assert got.shape == X.shape and got.dtype == dtype
    assert_scaled_close(got, hypercube_flux_reference(X, S, E, smax),
                        SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_hypercube_kernel_many_waves(cuda_device, offset, dtype):
    """The RK45 shape and three rows more (more quads than one wave of
    blocks takes, so the grid strides), with X and dX 16-byte aligned (the
    vector loads) or one element off (the scalar route)."""
    rows, smax = 92163, 4
    X, S, E = flux_inputs(np.random.default_rng(4), rows, smax, dtype, cuda_device)
    if offset:
        X = torch.cat([X.new_zeros(offset), X.reshape(-1)])[offset:].view(rows, 1 << smax)
        assert X.is_contiguous() and X.data_ptr() % 16
    before = hypercube_flux.launches
    got = hypercube_flux(X, S, E, smax)
    torch.cuda.synchronize()
    assert hypercube_flux.launches == before + 1
    assert_scaled_close(got, hypercube_flux_reference(X, S, E, smax),
                        SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_hypercube_kernel_spans_unaligned(cuda_device, dtype):
    """12 sites (rows of 4,096 states over four blocks) with X and dX one
    element off 16 bytes (the scalar loads of the spans' kernel)."""
    rows, smax = 37, 12
    X, S, E = flux_inputs(np.random.default_rng(12), rows, smax, dtype, cuda_device)
    X = torch.cat([X.new_zeros(1), X.reshape(-1)])[1:].view(rows, 1 << smax)
    assert X.is_contiguous() and X.data_ptr() % 16
    got = hypercube_flux(X, S, E, smax)
    torch.cuda.synchronize()
    assert_scaled_close(got, hypercube_flux_reference(X, S, E, smax),
                        SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 2, 5, 17, 64])
def test_thomas_kernel_matches_plain(cuda_device, n, dtype):
    rng = np.random.default_rng(n)
    B = 1000
    a, c, d = (rng.normal(0, 1, (B, n)) for _ in range(3))
    b = np.abs(rng.normal(0, 1, (B, n))) + 4.0
    a[:, 0] = c[:, -1] = 0.0
    args = [torch.as_tensor(v, dtype=dtype, device=cuda_device) for v in (a, b, c, d)]
    before = thomas_solve_batched.launches
    got = thomas_solve_batched(*args)
    torch.cuda.synchronize()
    assert thomas_solve_batched.launches == before + 1
    tol = SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64
    assert_scaled_close(got, thomas_solve_reference(*args), tol)
    dense = (torch.diag_embed(args[1]) + torch.diag_embed(args[0][:, 1:], -1)
             + torch.diag_embed(args[2][:, :-1], 1))
    assert_scaled_close(got, torch.linalg.solve(dense, args[3]), 10 * tol)


def test_thomas_kernel_pivot_guard(cuda_device):
    """A zero pivot: 1e-300 in float64 (finite), no guard in float32."""
    a = torch.zeros((2, 3), dtype=torch.float64, device=cuda_device)
    b = torch.full_like(a, 4.0)
    b[1, 0] = 0.0
    c, d = torch.ones_like(a), torch.ones_like(a)
    assert bool(torch.isfinite(thomas_solve_batched(a, b, c, d)).all())
    got32 = thomas_solve_batched(a.float(), b.float(), c.float(), d.float())
    want32 = thomas_solve_reference(a.float(), b.float(), c.float(), d.float())
    assert torch.equal(torch.isfinite(got32), torch.isfinite(want32))
    assert not bool(torch.isfinite(got32[1]).all())


@pytest.mark.parametrize("bad", ["flux_half", "flux_strided", "thomas_n65", "thomas_half"])
def test_new_kernels_reject(cuda_device, bad):
    rng = np.random.default_rng(0)
    if bad.startswith("flux"):
        X, S, E = flux_inputs(rng, 8, 3, torch.float32, cuda_device)
        if bad == "flux_half":
            X, S, E = X.half(), S.half(), E.half()
        else:
            S = torch.cat([S, S], dim=1)[:, ::2]
        with pytest.raises(NotImplementedError if bad == "flux_half" else ValueError):
            hypercube_flux(X, S, E, 3)
    else:
        n = 65 if bad == "thomas_n65" else 4
        args = [torch.ones((3, n), device=cuda_device) for _ in range(4)]
        if bad == "thomas_half":
            args = [x.half() for x in args]
        with pytest.raises(NotImplementedError):
            thomas_solve_batched(*args)


def test_batched_rhs_matches_call_and_cpu(cuda_device):
    """Model 2 at float64 on the card (the flux kernel): batched at P = 1
    equals the one-member call, and a population equals the CPU's plain
    flux."""
    b = build_demo_network(n_proteins=8, n_kinases=3, model=2, seed=1,
                           dtype=torch.float64, device=cuda_device)
    system = b["system"]
    cpu = GlobalSystem(system.topo, system.kin_grid, system.Kmat, dtype=torch.float64,
                       device="cpu")
    rng = np.random.default_rng(0)
    P, d = 5, system.rhs.N * system.rhs.width
    y = rng.uniform(0.0, 1.5, (P, d))
    jb = np.asarray([0, 3, 6, 9, 13])
    pop = {k: np.asarray(v, float)[None] * rng.uniform(0.7, 1.3, (P,) + (1,) * np.ndim(v))
           for k, v in b["true"].items()}
    on_card = {k: torch.as_tensor(v, device=cuda_device) for k, v in pop.items()}
    before = hypercube_flux.launches
    got = system.rhs.batched(0.0, torch.as_tensor(y, device=cuda_device),
                             torch.as_tensor(jb, device=cuda_device), on_card)
    torch.cuda.synchronize()
    assert hypercube_flux.launches == before + 1
    want = cpu.rhs.batched(0.0, torch.as_tensor(y), torch.as_tensor(jb),
                           {k: torch.as_tensor(v) for k, v in pop.items()})
    assert_scaled_close(got.cpu(), want, SCALED_ATOL_F64)
    one = system.rhs(0.0, torch.as_tensor(y[2], device=cuda_device), int(jb[2]),
                     {k: v[2] for k, v in on_card.items()})
    assert_scaled_close(got[2], one, SCALED_ATOL_F64)


def test_rk45_path_goes_through_the_flux_kernel(cuda_device):
    """Model 2 by RK45 at float32: 7 flux launches a loop iteration (6
    stages and the derivative after the step) and 2 before the loop (f0
    and the starting-step trial); the loop runs as many iterations as the
    slowest member takes steps. F against the plain flux."""
    b = build_demo_network(n_proteins=8, n_kinases=3, model=2, seed=1,
                           dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(4, len(b["theta0"])))
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"], b["lambdas"], b["grid"])
    pop = {k: np.asarray(v, float)[None] * rng.uniform(0.8, 1.2, (4,) + (1,) * np.ndim(v))
           for k, v in b["true"].items()}
    hypercube_flux.launches = 0
    res = simulate_batched(b["system"], pop, b["grid"])
    torch.cuda.synchronize()
    assert bool(res.success.all())
    assert hypercube_flux.launches == 7 * int(res.n_steps.max()) + 2
    hypercube_flux.launches = 0
    F = make_objective(*args, pop_chunk=None)(thetas)
    assert hypercube_flux.launches > 0
    Fp = make_objective(*args, pop_chunk=None, use_kernel=False)(thetas)
    assert F.shape == (4, 3) and bool(torch.isfinite(F).all())
    assert float(torch.max(torch.abs(F - Fp) / torch.abs(Fp))) <= 1e-3


def test_sensitivity_path_goes_through_the_flux_kernel(cuda_device):
    """The network Morris analysis of a model-2 system at float32 launches
    the flux kernel (every RK45 stage of each batch), and its Y and Morris
    indices match the run with the plain flux at rel 1e-3."""
    b = build_demo_network(n_proteins=8, n_kinases=3, model=2, seed=1,
                           dtype=torch.float32, device=cuda_device)
    kw = dict(n_trajectories=2, seed=0, batch_size=64)
    times = np.array([0.0, 1.0, 4.0, 16.0, 30.0])
    hypercube_flux.launches = 0
    got = run_sensitivity_analysis(b["system"], b["slices"], b["theta_true"], times, **kw)
    assert hypercube_flux.launches > 0
    plain = run_sensitivity_analysis(b["system"], b["slices"], b["theta_true"], times,
                                     use_kernel=False, **kw)
    assert np.isfinite(got.Y).all()
    assert np.max(np.abs(got.Y - plain.Y) / np.abs(plain.Y)) <= 1e-3
    for k in ("mu", "mu_star", "sigma"):
        a, p = getattr(got.morris, k), getattr(plain.morris, k)
        assert np.max(np.abs(a - p)) <= 1e-3 * np.max(np.abs(p)), k


def test_steady_state_sequential_launches_thomas_once(cuda_device):
    topo = build_topology([("GA", "S1", "K"), ("GA", "S2", "K"), ("GB", "S1", "K"),
                           ("GC", "S1", "K"), ("GC", "S2", "K"), ("GC", "S3", "K")],
                          None, model=1)
    before = thomas_solve_batched.launches
    got = steadystate.steady_state_sequential(topo, device=cuda_device)
    assert thomas_solve_batched.launches == before + 1
    np.testing.assert_allclose(got, steadystate.steady_state_sequential(topo, device="cpu"),
                               rtol=1e-12, atol=1e-15)


# --- matmul precision ---------------------------------------------------------------

# full float32 against float64 on the same float32 inputs, relative to the
# largest entry: sums of 4 to 48 products keep ~1e-7; TF32's 10-bit
# mantissa gives ~1e-4
TF32_BREAKS = 1e-5


def matmul_pieces(device, dtype, seed=0):
    """(tf_inputs, site_rates, model-2 observables) of the port on a random
    model-2 network of 48 proteins (up to 4 sites of 3 kinases each out of
    12, dense TF rows; 48, so that cuBLAS may pick its tensor-core kernels
    when TF32 is allowed) for 4,096 members, from float32 inputs."""
    rng = np.random.default_rng(seed)
    prots = [f"P{i:02d}" for i in range(48)]
    rows = [(p, f"S{j}", f"K{k:02d}") for p in prots for j in range(int(rng.integers(0, 5)))
            for k in rng.choice(12, size=3, replace=False)]
    tf_rows = [(a, b) for a in prots for b in prots if rng.uniform() < 0.5]
    topo = build_topology(rows, tf_rows, model=2,
                          kin_alpha={r: rng.uniform(0.5, 1.5) for r in rows})
    grid = np.asarray([0.0, 1.0])
    system = GlobalSystem(topo, grid, rng.uniform(0.5, 1.5, (topo.K, 2)), dtype=dtype,
                          device=device)
    rhs = system.rhs
    f = dict(dtype=torch.float32, device=device)
    P = 4096
    Pv = torch.as_tensor(rng.uniform(0.0, 2.0, (P, topo.N)), **f).to(dtype)
    Kt = torch.as_tensor(rng.uniform(0.0, 2.0, (P, topo.K)), **f).to(dtype)
    Y = torch.as_tensor(rng.uniform(0.0, 1.0, (P // 16, 15, topo.N * topo.width)), **f)
    return (tf_inputs(rhs.tf_mat.float().to(dtype), rhs.tf_deg.float().to(dtype), Pv),
            rhs.site_rates(Kt), extract_observables(system, Y.to(dtype)).PHO)


def scaled_errors(device):
    got = matmul_pieces(device, torch.float32)
    want = matmul_pieces(device, torch.float64)
    return [float(torch.max(torch.abs(g.double() - w)) / torch.max(torch.abs(w)))
            for g, w in zip(got, want)]


def test_matmuls_run_in_full_float32(cuda_device):
    """The port's float32 matmuls (the TF matvec, the site-rate and the
    model-2 observable contractions) agree with float64 to 1e-5, which
    TF32 breaks (checked here by turning it on), and importing every
    module of the port leaves TF32 off."""
    root = Path(__file__).resolve().parent.parent
    mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in (root / "phoskintime_tpu_torch").rglob("*.py"))
    code = ("import importlib, torch; "
            f"[importlib.import_module(m.removesuffix('.__init__')) for m in {mods!r}]; "
            "print(torch.backends.cuda.matmul.allow_tf32, "
            "torch.get_float32_matmul_precision())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "highest"], out.stdout

    errs = scaled_errors(cuda_device)
    assert max(errs) <= TF32_BREAKS, errs
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        errs_tf32 = scaled_errors(cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert min(errs_tf32) > TF32_BREAKS, errs_tf32


# --- float64 instances of the table and scan kernels --------------------------------


@pytest.mark.parametrize("w", range(2, 18))
def test_float64_tables_match_plain(cuda_device, w):
    """The float64 instance of either table kernel (12 series terms at radius
    0.25) against the float64 plain version: rounding only."""
    rng = np.random.default_rng(w)
    L = torch.as_tensor(compartmental_blocks(rng, 2, w, 1000), dtype=torch.float64,
                        device=cuda_device)
    binv, h_u = np.asarray([0, 1, 1]), np.asarray([0.0625, 2.0, 16.0])
    lad = max(ladder_len(w, h) for h in h_u)
    before = (phi_tables.launches, phi_tables_wide.launches)
    got = phi_tables(L, binv, h_u, lad)
    torch.cuda.synchronize()
    assert (phi_tables.launches - before[0], phi_tables_wide.launches - before[1]) == \
        ((1, 0) if w <= 8 else (0, 1))
    for g, r in zip(got, phi_tables_reference(L, binv, h_u, lad)):
        assert g.dtype == torch.float64
        assert_scaled_close(g, r, SCALED_ATOL_F64)


@pytest.mark.parametrize("w, N, variant", [
    (6, 7, "registers"), (7, 7, "shared"), (9, 45, "shared"), (13, 20, "shared"),
    (17, 99, "shared"), (17, 100, "stream"), (16, 200, "stream")])
def test_float64_scan_matches_plain(cuda_device, w, N, variant):
    """The float64 scan at each variant and each side of its switches."""
    assert scan_launch_shape(w, N, 8).variant == variant
    args, plan = random_scan_problem(w, N=N, P=300 if N < 20 else 6, seed=w + N,
                                     dtype=torch.float64, device=cuda_device)
    before = etd2rk_scan.launches
    got = etd2rk_scan(*args, plan)
    torch.cuda.synchronize()
    assert etd2rk_scan.launches == before + 1 and got.dtype == torch.float64
    torch.testing.assert_close(got, etd2rk_scan_reference(*args, plan), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("model, kw", [
    (0, {}), (0, dict(use_scan_kernel=True)), (2, {}),
    (2, dict(width_bucketing=False, use_scan_kernel=True))],
    ids=["model0", "model0-scan", "model2", "model2-unbucketed-scan"])
def test_float64_objective_on_the_card_matches_cpu(cuda_device, model, kw):
    """A float64 system on the card runs its kernels (no raise) and matches
    the port's float64 CPU result."""
    b = build_demo_network(n_proteins=8, n_kinases=4, model=model, seed=0,
                           dtype=torch.float64, device=cuda_device)
    cpu = GlobalSystem(b["system"].topo, b["system"].kin_grid, b["system"].Kmat,
                       dtype=torch.float64, device="cpu")
    args = (b["slices"], b["loss_data"], b["defaults"], b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(4, len(b["theta0"])))
    phi_tables.launches = phi_tables_wide.launches = etd2rk_scan.launches = 0
    F = make_population_objective(b["system"], *args, **kw)(thetas)
    torch.cuda.synchronize()
    assert phi_tables.launches + phi_tables_wide.launches > 0
    assert etd2rk_scan.launches == int(bool(kw.get("use_scan_kernel")))
    Fc = make_population_objective(cpu, *args, **kw)(thetas)
    np.testing.assert_allclose(F.cpu().numpy(), Fc.numpy(), rtol=1e-9)


# --- model 4 and ESDIRK ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("smax", [1, 4, 7])
def test_flux_kernel_rules_match_plain_jacfwd(cuda_device, smax, dtype):
    """``jacfwd`` through the kernel (its forward-mode and vmap rules) in X,
    by :func:`hypercube_flux`, and in (S, E), by the rules' class with the
    launch, against ``jacfwd`` of the plain version, which it never calls:
    two launches each, the primal and every tangent column at once (no
    launch on the zero tangents of the other inputs); a vmapped call folds
    its batch into rows for one launch."""
    X, S, E = flux_inputs(np.random.default_rng(smax), 33, smax, dtype, cuda_device)
    tol = SCALED_ATOL_F32 if dtype == torch.float32 else SCALED_ATOL_F64
    hypercube_flux_reference.calls = 0
    for argnums in (0, 1, 2):
        fn = ((lambda x, s, e: hypercube_flux(x, s, e, smax)) if argnums == 0 else
              (lambda x, s, e: FluxKernel.apply(x, s, e, smax, flux_launch)))
        hypercube_flux.launches = 0
        got = torch.func.jacfwd(fn, argnums=argnums)(X, S, E)
        torch.cuda.synchronize()
        assert hypercube_flux.launches == 2 and hypercube_flux_reference.calls == 0
        want = torch.func.jacfwd(lambda x, s, e: hypercube_flux_reference(x, s, e, smax),
                                 argnums=argnums)(X, S, E)
        hypercube_flux_reference.calls = 0
        assert_scaled_close(got, want, tol)
    Xb = X[None] * torch.arange(1.0, 6.0, dtype=dtype, device=cuda_device)[:, None, None]
    hypercube_flux.launches = 0
    got = torch.func.vmap(lambda x: hypercube_flux(x, S, E, smax))(Xb)
    assert hypercube_flux.launches == 1
    assert_scaled_close(got[3], hypercube_flux_reference(Xb[3], S, E, smax), tol)


def test_model4_float64_objective_on_the_card_matches_cpu(cuda_device):
    """The exponential-Rosenbrock objective at float64 on the card against
    the CPU's, and no table or scan kernel launched."""
    b = build_demo_network(n_proteins=8, n_kinases=4, model=4, seed=0,
                           dtype=torch.float64, device=cuda_device)
    cpu = GlobalSystem(b["system"].topo, b["system"].kin_grid, b["system"].Kmat,
                       dtype=torch.float64, device="cpu")
    args = (b["slices"], b["loss_data"], b["defaults"], b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(4, len(b["theta0"])))
    phi_tables.launches = phi_tables_wide.launches = etd2rk_scan.launches = 0
    F = make_population_objective(b["system"], *args)(thetas)
    torch.cuda.synchronize()
    assert phi_tables.launches == phi_tables_wide.launches == etd2rk_scan.launches == 0
    Fc = make_population_objective(cpu, *args)(thetas)
    np.testing.assert_allclose(F.cpu().numpy(), Fc.numpy(), rtol=1e-9)


def test_esdirk_model2_on_the_card_matches_cpu(cuda_device):
    """ESDIRK on model 2 at float64 to t = 30: the card (the flux kernel in
    every stage and, through its rules, in the Jacobian: 21 launches a
    loop iteration and one before; never the plain version) against the
    CPU (the plain flux), the same steps."""
    b = build_demo_network(n_proteins=8, n_kinases=3, model=2, seed=1,
                           dtype=torch.float64, device=cuda_device)
    cpu = GlobalSystem(b["system"].topo, b["system"].kin_grid, b["system"].Kmat,
                       dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    pop = {k: np.asarray(v, float)[None] * rng.uniform(0.8, 1.2, (3,) + (1,) * np.ndim(v))
           for k, v in b["true"].items()}
    t_eval = b["grid"][b["grid"] <= 30.0]
    hypercube_flux.launches = 0
    hypercube_flux_reference.calls = 0
    got = simulate_batched(b["system"], pop, t_eval, solver="esdirk")
    torch.cuda.synchronize()
    # a step: the Jacobian (2), 18 Newton RHS and the RHS after it; one before
    assert hypercube_flux.launches == 21 * int(got.n_steps.max()) + 1
    assert hypercube_flux_reference.calls == 0
    want = simulate_batched(cpu, pop, t_eval, solver="esdirk")
    print("ESDIRK steps, card / CPU:", got.n_steps.tolist(), want.n_steps.tolist())
    assert bool(got.success.all())
    np.testing.assert_array_equal(got.n_steps.cpu().numpy(), want.n_steps.numpy())
    np.testing.assert_allclose(got.ys.cpu().numpy(), want.ys.numpy(), rtol=1e-9, atol=1e-14)


# --- the FMA-peak probe ---------------------------------------------------------------


@pytest.mark.parametrize("nacc", [1, 2, 4, 8])
def test_sq_chain_matches_plain(cuda_device, nacc):
    """The kernel contracts y*y + c into one FMA, the plain version rounds
    twice: at the check's few steps (the output still depends on the seeds
    and on c's x term), within ``CHECK_TOL`` of max |plain|, on outputs
    that spread far beyond it."""
    from phoskintime_tpu_torch.ops import fma_peak

    X = fma_peak.probe_input(cuda_device, cols=4096)
    before = fma_peak.sq_chain.launches
    got = fma_peak.sq_chain(X, fma_peak.CHECK_REPS, nacc)
    torch.cuda.synchronize()
    assert fma_peak.sq_chain.launches == before + 1
    want = fma_peak.sq_chain_reference(X, fma_peak.CHECK_REPS, nacc)
    assert_scaled_close(got, want, atol=fma_peak.CHECK_TOL)
    assert float(want.max() - want.min()) > 1e4 * fma_peak.CHECK_TOL * float(want.abs().max())


def test_sq_chain_instruction_stream_and_slope(cuda_device):
    """reps x nacc FFMAs in each instance's SASS (nothing shortened the
    chains), and a positive slope below the data sheet's rate."""
    from phoskintime_tpu_torch.ops import fma_peak

    counts = fma_peak.sass_ffma_counts()
    assert counts == {(n, r): n * r for n in fma_peak.NACCS for r in fma_peak.BUILT_REPS}
    tf, times = fma_peak.slope_tflops(fma_peak.probe_input(cuda_device), 512, 4, 256, n=2)
    assert times[24] > times[8] and 1.0 < tf < 1.2 * fma_peak.DATASHEET_FP32_TFLOPS


# --- the global fit's device routes ---------------------------------------------------


def test_device_survival_on_the_card_matches_cpu(cuda_device):
    """Ranks, normalisation, association and niching on the card, on the
    same draws as the CPU: the same survivors."""
    from phoskintime_tpu_torch.ops.nsga import das_dennis
    from phoskintime_tpu_torch.ops.nsga_device import SurvivalDraws, device_survival

    rng = np.random.default_rng(4)
    Q, R = 2000, 28
    F, X = rng.random((Q, 3)), rng.random((Q, 6))
    refs = das_dennis(3, 6)
    unit = refs / np.linalg.norm(refs, axis=1, keepdims=True)
    draws = SurvivalDraws(torch.as_tensor(rng.random(R)), torch.as_tensor(rng.random(Q)))
    t = lambda x, d: torch.as_tensor(x, device=d)
    cpu = device_survival(t(X, "cpu"), t(F, "cpu"), Q // 2, t(unit, "cpu"), draws)
    card = device_survival(t(X, cuda_device), t(F, cuda_device), Q // 2, t(unit, cuda_device),
                           SurvivalDraws(*(d.to(cuda_device) for d in draws)))
    for name, c, g in zip(("X", "F", "rank", "niche"), cpu, card):
        np.testing.assert_array_equal(g.cpu().numpy(), c.numpy(), err_msg=name)
    # nd is the root of a difference of near squares (|F|^2 - proj^2), summed
    # in another order on the card: absolute error ~ eps |F|^2 / nd
    np.testing.assert_allclose(card[4].cpu().numpy(), cpu[4].numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("gens_per_dispatch", [1, 3])
def test_global_fit_on_the_card(cuda_device, gens_per_dispatch):
    """run_global_fit at float32 on the card by both routes: evaluations
    counted, finite Pareto set, the pick within it."""
    from phoskintime_tpu_torch.network.optimize import run_global_fit

    b = build_demo_network(n_proteins=8, n_kinases=4, seed=1, dtype=torch.float32,
                           device=cuda_device)
    res = run_global_fit(b["system"], b["slices"], b["loss_data"], b["defaults"],
                         b["lambdas"], b["grid"], b["xl"], b["xu"], pop=64, n_gen=3,
                         seed=0, ftol=0.0, gens_per_dispatch=gens_per_dispatch,
                         frechet_pick=True, df_prot=b["df_prot"], df_rna=b["df_rna"],
                         df_pho=b["df_pho"], t_points=(b["grid"],) * 3)
    assert res.n_evals == 64 * 4 and np.isfinite(res.pareto_F).all()
    assert 0 <= res.best_idx < len(res.pareto_X)


# --- the gradient stage -----------------------------------------------------------------


def _table_launches():
    return phi_tables.launches + phi_tables_wide.launches + etd2rk_scan.launches


@pytest.mark.parametrize("model", [0, 2, 4])
def test_differentiable_objective_on_the_card_matches_cpu(cuda_device, model):
    """The differentiable objective at float64 on the card, and its
    gradient, against the CPU's (rel 1e-9); the forward and reverse passes
    launch no table or scan kernel."""
    b = build_demo_network(n_proteins=8, n_kinases=4, model=model, seed=0,
                           dtype=torch.float64, device=cuda_device)
    cpu = GlobalSystem(b["system"].topo, b["system"].kin_grid, b["system"].Kmat,
                       dtype=torch.float64, device="cpu")
    args = (b["slices"], b["loss_data"], b["defaults"], b["lambdas"], b["grid"])
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(4, len(b["theta0"])))

    def value_and_grad(system):
        X = torch.as_tensor(thetas, device=system.device).requires_grad_(True)
        F = make_population_objective(system, *args, differentiable=True)(X)
        g, = torch.autograd.grad(F.sum(), X)
        return F.detach().cpu().numpy(), g.cpu().numpy()

    before = _table_launches()
    F, g = value_and_grad(b["system"])
    torch.cuda.synchronize()
    assert _table_launches() == before
    Fc, gc = value_and_grad(cpu)
    np.testing.assert_allclose(F, Fc, rtol=1e-9)
    assert np.isfinite(g).all()
    assert np.max(np.abs(g - gc)) <= 1e-9 * np.max(np.abs(gc))
    th = thetas[0]
    J = forward_jacobian(make_residual_fn(b["system"], *args),
                         torch.as_tensor(th, device=cuda_device), chunk=32)
    assert _table_launches() == before
    Jc = forward_jacobian(make_residual_fn(cpu, *args), torch.as_tensor(th), chunk=32)
    assert float(torch.max(torch.abs(J.cpu() - Jc))) <= 1e-9 * float(torch.max(torch.abs(Jc)))


def test_polish_launches_tables_only_to_score(cuda_device):
    """polish_solutions at float32 on the card: no table launch in its
    Adam steps, one in the production scoring of its one chunk; no member
    worse than its input, every member inside the box."""
    b = build_demo_network(n_proteins=8, n_kinases=4, seed=0, dtype=torch.float32,
                           device=cuda_device)
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"], b["lambdas"], b["grid"])
    rng = np.random.default_rng(1)
    X0 = b["theta0"][None] + 0.3 * rng.normal(size=(6, len(b["theta0"])))
    X0 = np.clip(X0, b["xl"], b["xu"])
    F0 = make_population_objective(*args)(X0).cpu().numpy()
    phi_tables.launches = phi_tables_wide.launches = etd2rk_scan.launches = 0
    X, F = polish_solutions(*args, X0, b["xl"], b["xu"], steps=4)
    torch.cuda.synchronize()
    assert (phi_tables.launches, phi_tables_wide.launches, etd2rk_scan.launches) == (1, 0, 0)
    assert np.all(F.sum(axis=1) <= F0.sum(axis=1) * (1 + 1e-4) + 1e-6)
    assert np.all(X >= b["xl"] - 1e-6) and np.all(X <= b["xu"] + 1e-6)


def test_astype_keeps_the_device(cuda_device):
    b = build_demo_network(n_proteins=6, n_kinases=3, seed=0, dtype=torch.float32,
                           device=cuda_device)
    s64 = b["system"].astype(torch.float64)
    assert s64.device == b["system"].device and s64.rhs.Kmat.is_cuda
    assert s64.rhs.Kmat.dtype == torch.float64 and s64.topo is b["system"].topo
    assert b["system"].astype(torch.float32) is b["system"]


# --- MOTPE and the hyperparameter scan ---------------------------------------------------


def test_motpe_float64_on_the_card_matches_cpu(cuda_device):
    """run_global_fit(optimizer="optuna") at float64 on the card and on the
    CPU: the same trials (X bit for bit), F within 1e-9, one table launch
    a batch of 16."""
    from phoskintime_tpu_torch.network.optimize import run_global_fit

    b = build_demo_network(n_proteins=8, n_kinases=4, seed=0, dtype=torch.float64,
                           device=cuda_device)
    cpu = GlobalSystem(b["system"].topo, b["system"].kin_grid, b["system"].Kmat,
                       dtype=torch.float64, device="cpu")
    args = (b["slices"], b["loss_data"], b["defaults"], b["lambdas"], b["grid"],
            b["xl"], b["xu"])
    kw = dict(optimizer="optuna", n_trials=48, seed=0, frechet_pick=False)
    phi_tables.launches = 0
    got = run_global_fit(b["system"], *args, **kw)
    torch.cuda.synchronize()
    assert phi_tables.launches == 3
    want = run_global_fit(cpu, *args, **kw)
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_allclose(got.F, want.F, rtol=1e-9)


def test_hyperparameter_scan_on_the_card(cuda_device):
    """The expo scan at float32 on the card: one table launch an
    evaluation of every trial, pruning bookkeeping as on the CPU."""
    from phoskintime_tpu_torch.network import scan

    b = build_demo_network(n_proteins=8, n_kinases=4, seed=0, dtype=torch.float32,
                           device=cuda_device)
    launches = []
    real = scan.run_unsga3_device

    def spy(*a, **kw):
        before = phi_tables.launches
        res = real(*a, **kw)
        torch.cuda.synchronize()
        launches.append((phi_tables.launches - before, res.n_gen))
        return res

    scan.run_unsga3_device = spy
    try:
        _, trials = scan.run_hyperparameter_scan(
            b["system"], b["slices"], b["loss_data"], b["defaults"], b["grid"], b["xl"],
            b["xu"], n_outer=4, inner_gens=6, inner_pop=16, seed=0, gen_step=2,
            n_startup_prune=2, prune_factor=0.0)
    finally:
        scan.run_unsga3_device = real
    assert [n for n, _ in launches] == [g + 1 for _, g in launches]
    assert [t.n_gen for t in trials] == [g for _, g in launches]
    assert all(np.isfinite(t.score) for t in trials)


@pytest.mark.parametrize("model,use_kernel", [(0, None), (1, None), (2, None), (2, False),
                                              (4, None)])
def test_graphed_rk45_matches_the_eager_loop(cuda_device, monkeypatch, model, use_kernel):
    """``simulate_batched`` on the card replays a CUDA graph of
    ``RK45_GRAPH_STEPS`` loop passes wherever the RHS counts no kernel
    launch, and gives the eager loop's trajectories, flags and step counts
    bit for bit; model 2 through the flux kernel keeps the eager loop, so
    its launches stay 7 an iteration plus 2."""
    from phoskintime_tpu_torch.network import simulate as sim_mod
    from phoskintime_tpu_torch.network.params import unpack_params

    b = build_demo_network(10, 4, model=model, seed=0, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.uniform(b["xl"], b["xu"], (3, len(b["xl"]))),
                        dtype=torch.float32, device="cuda")
    params_b = unpack_params(X, b["slices"], b["topo"])
    odeint, passes, full = sim_mod.odeint_rk45, [], sim_mod.RK45_GRAPH_STEPS

    def spy(*a, graph_steps=0, **kw):
        passes.append(graph_steps)
        return odeint(*a, graph_steps=graph_steps, **kw)
    monkeypatch.setattr(sim_mod, "odeint_rk45", spy)
    runs, launches = [], []
    for graph_steps in (full, 0):
        monkeypatch.setattr(sim_mod, "RK45_GRAPH_STEPS", graph_steps)
        hypercube_flux.launches = 0
        runs.append(simulate_batched(b["system"], params_b, b["grid"], max_steps=300,
                                     use_kernel=use_kernel))
        torch.cuda.synchronize()
        launches.append(hypercube_flux.launches)
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    counted = model == 2 and use_kernel is None
    assert passes == [0 if counted else full, 0]
    steps = int(runs[0].n_steps.max())
    assert launches == ([7 * steps + 2] * 2 if counted else [0, 0])


def test_global_model_on_the_card(cuda_device, tmp_path):
    """``python -m phoskintime_tpu_torch global-model`` at the tests' tiny
    config on the card (its default device): ``phi_tables`` launched, the
    runner's tables written."""
    from torch_project import write_project

    from phoskintime_tpu_torch import cli

    write_project(tmp_path)
    phi_tables.launches = 0
    out = cli.main(["global-model", "--config", str(tmp_path / "config.toml"), "--out-dir",
                    str(tmp_path / "out")])
    torch.cuda.synchronize()
    assert phi_tables.launches > 0
    assert out["system"].device.type == "cuda"
    for name in ("steady_state_check.csv", "sensitivity.npz", "pareto_F.npy",
                 "influence/influence_sweep.csv", "lambda_scan.csv"):
        assert (tmp_path / "out" / name).exists(), name
