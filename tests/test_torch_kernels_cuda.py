"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``cuda`` and
skips without one. The file imports no JAX, so on a machine with a card
and without JAX it runs on its own:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from phoskintime_tpu_torch.demo import build_demo_network
from phoskintime_tpu_torch.network.expo import width_classes
from phoskintime_tpu_torch.network.objective import make_population_objective
from phoskintime_tpu_torch.ops.phi_tables import (ladder_len, phi_tables,
                                                  phi_tables_reference,
                                                  phi_tables_wide, phi_vectors)
from phoskintime_tpu_torch.ops.scan_kernel import (etd2rk_scan, etd2rk_scan_reference,
                                                   random_scan_problem)

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


@pytest.mark.parametrize("bad, err", [
    (dict(dtype=torch.float64), NotImplementedError),
    (dict(w=18), NotImplementedError),
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
    ("float64", NotImplementedError),
    ("w18", NotImplementedError),
    ("proteins", NotImplementedError),
    ("strided", ValueError),
])
def test_scan_kernel_rejects(cuda_device, bad, err):
    w, N = (18 if bad == "w18" else 4), (257 if bad == "proteins" else 5)
    args, plan = random_scan_problem(w, N=N, P=2, S=8)      # built on the CPU
    args = [x.to(cuda_device) for x in args]
    if bad == "float64":
        args = [x.double() for x in args]
    if bad == "strided":
        args[0] = args[0].transpose(1, 2)
    with pytest.raises(err):
        etd2rk_scan(*args, plan)


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
