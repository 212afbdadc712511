"""The whole-scan kernel's module (``ops/scan_kernel.py``) and the
``use_scan_kernel`` route of the port against the JAX package.

The plain version ``etd2rk_scan_reference`` is held against the Pallas
kernel ``etd2rk_scan_pallas`` run in interpret mode on the same packed
inputs; the port's batched ETD2RK and objective with
``use_scan_kernel=True`` against JAX's, by its XLA scan and by its kernel;
the plan against ``prepare_scan_plan`` of the JAX package. Inputs are made
with numpy from a seed and fed to both packages at float64 on the CPU,
where the port runs its plain versions. The CUDA kernel itself is held
against the plain version on the card in ``test_torch_kernels_cuda.py``.
"""

import types

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
from phoskintime_tpu.ops.scan_pallas import etd2rk_scan_pallas
from phoskintime_tpu.ops.scan_pallas import prepare_scan_plan as jax_plan
from phoskintime_tpu_torch.demo import GRID as DEMO_GRID
from phoskintime_tpu_torch.demo import RNA_GRID
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network import expo
from phoskintime_tpu_torch.network.objective import make_population_objective
from phoskintime_tpu_torch.network.system import GlobalSystem
from phoskintime_tpu_torch.network.topology import build_topology
from phoskintime_tpu_torch.ops.cuda_build import MAX_SHARED_BYTES
from phoskintime_tpu_torch.ops.scan_kernel import (VARIANTS, etd2rk_scan,
                                                   etd2rk_scan_reference, prepare_scan_plan,
                                                   random_scan_problem, scan_launch_shape,
                                                   scan_runs, wide_layout, wide_shared_bytes,
                                                   wide_threads)

torch.set_num_threads(2)

# float64 on both sides, the same ETD2RK steps on the same tables: only the
# order of floating-point operations differs (measured ~1e-16). The JAX
# kernel rounds its TF coefficients (tf_mat / tf_deg) to float32; every
# network here has coefficients that float32 holds exactly (asserted), so
# the same tolerance holds against it.
RTOL_RUN = 1e-9
KEYS = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")
GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])


def small_system(model):
    """(JAX system, parameters as numpy) of the three-protein network of
    tests/test_expo.py::make_system: w = 4 (models 0/1) or 5 (model 2)."""
    inter = pd.DataFrame({"protein": ["GA", "GA", "GB", "GC"],
                          "psite": ["S1", "S2", "S1", "S1"],
                          "kinase": ["K1", "K1", "K2", "K1"]})
    tf = pd.DataFrame({"tf": ["GA", "GC"], "target": ["GB", "GA"]})
    topo = jax_topology(inter, tf, model=model)
    Kmat = jax_kmat(topo.kinases, None, GRID)
    Kmat *= 1.0 + 0.25 * np.sin(np.arange(len(GRID)))[None, :]
    rng = np.random.default_rng(0)
    p = {"c_k": rng.uniform(0.1, 1.5, topo.K), "tf_scale": 2.2}
    for k in ("A_i", "B_i", "C_i", "D_i", "E_i"):
        p[k] = rng.uniform(0.1, 1.5, topo.N)
    p["Dp_i"] = rng.uniform(0.2, 2.5, (topo.N, topo.max_sites)) * topo.site_mask()
    return JaxSystem(topo, GRID, Kmat), p


def population(p, P=2, seed=1):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, float)[None]
            * rng.uniform(0.8, 1.2, (P,) + (1,) * np.ndim(v)) for k, v in p.items()}


def plans(sj, st, t_eval=GRID):
    """(JAX plan, port plan) of one system and grid, substep 16."""
    seg = jexpo._segment_plan(tuple(np.asarray(sj.kin_grid, float)),
                              tuple(np.asarray(t_eval, float)), 16.0)
    _, _, seg_jb, out_idx, seg_uidx, _, u_h = seg
    return (jax_plan(sj.rhs, seg_jb, seg_uidx, u_h, out_idx, len(out_idx)),
            prepare_scan_plan(st.rhs, seg_jb, seg_uidx, u_h, out_idx, len(out_idx)))


def assert_f32_exact(mega):
    """The JAX kernel's float32 TF coefficients equal the float64 ones."""
    for c in (mega["c1"], mega["c2"]):
        assert c.dtype == np.float32
        assert np.all(np.isin(c, [0.0, 1.0, -1.0, 0.5, -0.5]))


@pytest.fixture(scope="module", params=[0, 1, 2], ids=["model0", "model1", "model2"])
def small(request):
    """(JAX system, port system, population) of the small network; model 2
    runs unbucketed (its widths are 3 and 5, below the auto threshold)."""
    sj, p = small_system(request.param)
    return sj, from_reference(sj, device="cpu"), population(p)


def jax_ys(sj, pb, grid=GRID, **kw):
    ys, ok = jexpo.exponential_simulate_batched(
        sj, {k: jnp.asarray(v) for k, v in pb.items()}, grid, use_pallas=False, **kw)
    assert bool(np.all(ok))
    return np.asarray(ys)


@pytest.fixture
def scan_calls(monkeypatch):
    """The calls the integrator makes to ``etd2rk_scan`` (on the CPU it
    launches nothing, so its launch count cannot tell the route)."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[-1])
        return etd2rk_scan(*args, **kw)

    monkeypatch.setattr(expo, "etd2rk_scan", spy)
    return calls


# --- the plain version against the Pallas kernel -----------------------------------


def test_reference_matches_pallas_interpret(small):
    """Random tables, state and drives in the port's lane layout (B = P*N)
    and, padded to Npad proteins, in the Pallas kernel's; the snapshots
    agree at the proteins both hold."""
    sj, st, _ = small
    mega, plan = plans(sj, st)
    assert_f32_exact(mega)
    rng = np.random.default_rng(3)
    N, w, P = st.topo.N, st.topo.width, 3
    U, NB, B, Np = int(plan.uidx.max()) + 1, st.rhs.Kmat.shape[1], P * N, mega["Npad"]
    E = rng.uniform(0.0, 0.8 / w, (U, w, w, B))
    p1, p2h = rng.uniform(0.0, 0.5, (U, w, B)), rng.uniform(0.0, 0.2, (U, w, B))
    y0, drv = rng.uniform(0.1, 1.5, (w, B)), rng.uniform(0.1, 2.0, (NB, B))
    A, ts = rng.uniform(0.05, 0.8, B), rng.uniform(0.5, 3.0, B)

    got = etd2rk_scan_reference(*(torch.as_tensor(x) for x in (E, p1, p2h, y0, drv, A, ts)),
                                plan)

    def pad(x):                                    # (..., P*N) -> (..., P*Npad)
        x = x.reshape(x.shape[:-1] + (P, N))
        return np.concatenate([x, np.zeros(x.shape[:-1] + (Np - N,))], -1).reshape(
            x.shape[:-2] + (P * Np,))

    tile = lambda x: jnp.tile(jnp.asarray(x, jnp.float64), (1, P))
    want = etd2rk_scan_pallas(
        *(jnp.asarray(pad(x)) for x in (E, p1, p2h, y0, drv)),
        jnp.asarray(pad(A))[None], jnp.asarray(pad(ts))[None], tile(mega["totw"]),
        tile(mega["dm"]), tile(mega["c1"]), tile(mega["c2"]),
        mega["uidx"], mega["jb"], mega["out_slot"], shifts=mega["shifts"], Npad=Np,
        T=mega["T"], init_slots=mega["init_slots"], interpret=True)
    want = np.asarray(want).reshape(plan.T, w, P, Np)[..., :N].reshape(plan.T, w, B)
    assert got.shape == (plan.T, w, B) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN, atol=1e-14)


# --- the integrator and the objective ----------------------------------------------


def test_simulate_with_scan_kernel_matches_jax(small, scan_calls):
    """The port's use_scan_kernel=True against JAX's XLA scan and its
    interpret-mode kernel, and against the port's own eager scan."""
    sj, st, pb = small
    got, ok = expo.exponential_simulate_batched(st, pb, GRID, use_scan_kernel=True)
    assert len(scan_calls) == 1
    assert bool(ok.all()) and got.dtype == torch.float64
    assert_f32_exact(plans(sj, st)[0])
    for kw in (dict(use_scan_kernel=False), dict(use_scan_kernel=True)):
        np.testing.assert_allclose(got.numpy(), jax_ys(sj, pb, **kw), rtol=RTOL_RUN,
                                   atol=1e-14, err_msg=str(kw))
    eager, _ = expo.exponential_simulate_batched(st, pb, GRID)
    assert len(scan_calls) == 1
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=RTOL_RUN, atol=1e-14)


# The objective's networks: the demo at N = 8 (w = 6 or 17), and the shapes
# past the template kernel's domain that the wide kernel takes on the card:
# chip_smoke.py's phase-3h networks run unbucketed (model 0 with a 20-site
# protein, w = 22; model 2 at 6 and 7 sites, w = 65 and 129), model 2 at 8
# sites (w = 257, the stream table kernel's and a streamed E) and the
# 300-protein demo (N = 285). build_demo_network's arguments, pop, and the
# (w, N) each must give.
SCAN_NETWORKS = {
    "model0": (dict(n_proteins=6, n_kinases=4, model=0, seed=0), 5, (6, 8)),
    "model2": (dict(n_proteins=6, n_kinases=4, model=2, seed=0), 5, (17, 8)),
    "model0-20sites": (dict(n_proteins=5, n_kinases=3, max_sites=20, model=0, seed=5), 3,
                       (22, 6)),
    "model2-6sites": (dict(n_proteins=6, n_kinases=3, max_sites=6, model=2, seed=0), 3,
                      (65, 6)),
    "model2-7sites": (dict(n_proteins=6, n_kinases=3, max_sites=7, model=2, seed=20), 3,
                      (129, 7)),
    "model2-8sites": (dict(n_proteins=4, n_kinases=3, max_sites=8, model=2, seed=7), 2,
                      (257, 5)),
    "N285": (dict(n_proteins=300, n_kinases=24, model=0, seed=1), 3, (6, 285)),
}


@pytest.mark.parametrize("name", list(SCAN_NETWORKS))
def test_objective_with_scan_kernel_matches_jax(name, scan_calls):
    """pop 3-5 in chunks of 2, unbucketed (tf_deg in {1, 2}), against JAX's
    objective by its interpret-mode kernel (or, where its VMEM budget
    refuses the tile, its fallback) and by its XLA scan; one
    ``etd2rk_scan`` a chunk."""
    kw, pop, (w, N) = SCAN_NETWORKS[name]
    bj = jax_demo(**kw, dtype=np.float64)
    bt = from_reference({k: bj[k] for k in KEYS}, device="cpu")
    assert (bt["system"].topo.width, bt["system"].topo.N) == (w, N)
    mega = plans(bj["system"], bt["system"], bj["grid"])[0]
    if mega is not None:                               # None: JAX runs its XLA scan
        assert_f32_exact(mega)
    rng = np.random.default_rng(2)
    thetas = bj["theta0"][None] + 0.05 * rng.normal(size=(pop, len(bj["theta0"])))
    f_t = make_population_objective(*(bt[k] for k in KEYS), pop_chunk=2,
                                    width_bucketing=False, use_scan_kernel=True)
    got = f_t(thetas)
    assert len(scan_calls) == -(-pop // 2)             # one per chunk
    assert all(plan.N == N for plan in scan_calls)
    assert got.shape == (pop, 3) and bool(torch.isfinite(got).all())
    # past w = 129 JAX's kernel refuses the tile (mega None) and both of its
    # calls would run the same XLA scan: it runs once there
    for scan_kernel in (True, False) if mega is not None or w <= 129 else (False,):
        f_j = jax_objective(*(bj[k] for k in KEYS), use_pallas=False, pop_chunk=2,
                            width_bucketing=False, use_scan_kernel=scan_kernel)
        want = np.asarray(jax.jit(f_j)(jnp.asarray(thetas)))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_RUN,
                                   err_msg=f"JAX use_scan_kernel={scan_kernel}")


# --- the plan and its gates -----------------------------------------------------------


def test_plan_matches_jax(small):
    """Snapshot slots (the grid starts at 0: one initial-state slot),
    segment rows and buckets, total-protein weights and drivers as JAX's
    plan has them; the CSR rows rebuild tf_mat."""
    sj, st, _ = small
    mega, plan = plans(sj, st)
    N = st.topo.N
    np.testing.assert_array_equal(plan.out_slot, mega["out_slot"])
    np.testing.assert_array_equal(plan.init_slots, mega["init_slots"])
    assert list(plan.init_slots) == [0] and plan.T == mega["T"] == len(GRID)
    np.testing.assert_array_equal(plan.uidx, mega["uidx"])
    np.testing.assert_array_equal(plan.jb, mega["jb"])
    np.testing.assert_array_equal(plan.totw, mega["totw"][:, :N])
    np.testing.assert_array_equal(plan.driven, mega["dm"][0, :N])
    np.testing.assert_array_equal(plan.driver_idx, mega["driver_idx"][:N])
    tfm = np.zeros((N, N))
    tfm[np.repeat(np.arange(N), np.diff(plan.tf_ptr)), plan.tf_col] = plan.tf_coef
    np.testing.assert_array_equal(tfm, np.asarray(sj.rhs.tf_mat))
    np.testing.assert_array_equal(plan.tf_deg, np.asarray(sj.rhs.tf_deg))


def test_shared_segment_end_runs_the_kernel(scan_calls):
    """Two t_eval points on one segment: JAX has no plan (its kernel writes
    one snapshot per segment) and falls back to its XLA scan; the port's
    kernel writes the segment's end to the first point's slot and
    slot_map copies it to the second, so use_scan_kernel=True still runs
    the kernel and agrees with the eager scan and JAX's."""
    sj, p = small_system(0)
    st = from_reference(sj, device="cpu")
    grid = np.insert(GRID, 4, GRID[4])                 # t = 1.0 at slots 4 and 5
    mega, plan = plans(sj, st, grid)
    assert mega is None
    assert 4 in plan.out_slot and 5 not in plan.out_slot and 6 in plan.out_slot
    np.testing.assert_array_equal(plan.slot_map, [0, 1, 2, 3, 4, 4] + list(range(6, 15)))
    pb = population(p)
    got, _ = expo.exponential_simulate_batched(st, pb, grid, use_scan_kernel=True)
    assert len(scan_calls) == 1
    assert torch.equal(got[:, 4], got[:, 5])
    want, _ = expo.exponential_simulate_batched(st, pb, grid, use_scan_kernel=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL_RUN, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), jax_ys(sj, pb, grid), rtol=RTOL_RUN,
                               atol=1e-14)


def test_bucketed_model2_ignores_the_flag(scan_calls):
    """Width-bucketed model 2 runs its class scan whatever the flag (as in
    JAX); unbucketed it takes the kernel."""
    sj, p = small_system(2)
    st = from_reference(sj, device="cpu")
    pb = population(p)
    got, _ = expo.exponential_simulate_batched(st, pb, GRID, width_bucketing=True,
                                               use_scan_kernel=True)
    assert scan_calls == []
    want, _ = expo.exponential_simulate_batched(st, pb, GRID, width_bucketing=True)
    assert torch.equal(got, want)
    expo.exponential_simulate_batched(st, pb, GRID, width_bucketing=False,
                                      use_scan_kernel=True)
    assert len(scan_calls) == 1


def test_scan_setup_routes_agree():
    """expo.ScanSetup, the one assembly both routes read (and chip_smoke.py
    holds against each other): the kernel's arguments give the eager
    scan's trajectory; a bucketed problem has no kernel plan."""
    sj, p = small_system(0)
    st = from_reference(sj, device="cpu")
    scan = expo.ScanSetup(st, population(p, P=3), GRID)
    ys = etd2rk_scan(*scan.kernel_args(), scan.plan)
    T, w, N = scan.plan.T, st.topo.width, st.topo.N
    np.testing.assert_allclose(
        ys.reshape(T, w, 3, N).permute(2, 0, 3, 1).reshape(3, T, N * w).numpy(),
        scan.run_eager().numpy(), rtol=RTOL_RUN, atol=1e-14)
    np.testing.assert_array_equal(scan.run_kernel().numpy(), ys.reshape(
        T, w, 3, N).permute(2, 0, 3, 1).reshape(3, T, N * w).numpy())
    s2, p2 = small_system(2)
    bucketed = expo.ScanSetup(from_reference(s2, device="cpu"), population(p2), GRID,
                              width_bucketing=True)
    with pytest.raises(ValueError, match="unbucketed"):
        bucketed.plan


# --- the runs and the launch shape -------------------------------------------------


def assert_runs_partition(plan):
    """The plan's runs cover its segments in order, one pair and its bucket
    a run, and are maximal: neighbouring runs have different pairs."""
    runs = plan.runs
    assert runs.dtype == np.int32 and runs.shape == (len(runs), 4)
    assert runs[0, 0] == 0 and np.all(runs[:, 1] >= 1)
    np.testing.assert_array_equal(runs[1:, 0], runs[:-1, 0] + runs[:-1, 1])
    assert runs[-1, 0] + runs[-1, 1] == len(plan.uidx)
    for first, n, pair, bucket in runs:
        assert np.all(plan.uidx[first:first + n] == pair)
        assert np.all(plan.jb[first:first + n] == bucket)
    assert np.all(runs[1:, 2] != runs[:-1, 2])


def test_runs_partition_the_segments(small):
    """The run table of prepare_scan_plan on the small networks' plans."""
    _, plan = plans(*small[:2])
    assert_runs_partition(plan)
    np.testing.assert_array_equal(plan.runs, scan_runs(plan.uidx, plan.jb))


def test_bench_plan_runs():
    """The bench network's plan (kinase grid GRID, t_eval GRID with the RNA
    grid, substep 16) has 133 segments over 14 pairs in 14 runs, one run a
    pair: each table is needed for one stretch of the scan only."""
    topo = build_topology([("GA", "S1", "K"), ("GB", "S1", "K")], None, model=0)
    system = GlobalSystem(topo, DEMO_GRID, np.ones((topo.K, len(DEMO_GRID))), device="cpu")
    t_eval = np.unique(np.concatenate([DEMO_GRID, RNA_GRID]))
    _, _, seg_jb, out_idx, seg_uidx, _, u_h = expo._plan(system, t_eval, 16.0)
    plan = prepare_scan_plan(system.rhs, seg_jb, seg_uidx, u_h, out_idx, len(out_idx))
    assert_runs_partition(plan)
    assert len(plan.uidx) == 133 and len(u_h) == 14
    assert plan.runs[:, 1].tolist() == [8, 8, 8, 8, 8, 4, 4, 4, 4, 8, 16, 8, 15, 30]
    assert sorted(plan.runs[:, 2].tolist()) == list(range(14))


@pytest.mark.parametrize("w", [2, 6, 9, 13, 17])
def test_random_plans_recur_out_of_order(w):
    """random_scan_problem's plans, which the card tests hold the kernel to,
    bring every pair back in several short runs (1 to 5 segments)."""
    for N, P in ((7, 300), (200, 12)):
        _, plan = random_scan_problem(w, N=N, P=P, seed=w)
        assert_runs_partition(plan)
        assert plan.runs[:, 1].max() <= 5
        assert np.all(np.bincount(plan.runs[:, 2]) >= 2)


def test_stale_runs_are_refused():
    """A plan whose runs are not those of its uidx and jb never reaches a
    kernel; a bucket that changes inside a stretch of one pair starts a
    run."""
    args, plan = random_scan_problem(4, N=5, P=4)
    with pytest.raises(ValueError, match="runs"):
        etd2rk_scan(*args, plan._replace(uidx=plan.uidx[::-1].copy()))
    np.testing.assert_array_equal(scan_runs([1, 1, 1, 0], [0, 0, 1, 1]),
                                  [[0, 2, 1, 0], [2, 1, 1, 1], [3, 1, 0, 1]])


# widths past the template kernel's, each side of a power of two and the
# widest tables'
WIDE_WIDTHS = [18, 22, 32, 33, 64, 65, 96, 97, 128, 129, 130, 257, 513]
WIDE_PROTEINS = [1, 2, 6, 7, 45, 199, 256, 257, 285, 320, 321, 511, 1024, 2048, 4095, 4096,
                 6144, 6145, 8192, 8193, 12288, 16383, 16384]
# csrc/etd2rk_scan.cu's wide limits: threads a block, blocks a cluster,
# lanes a thread, warps a lane's columns
WIDE_MAX_THREADS, MAX_CLUSTER, MAX_PER, MAX_COLS = 512, 8, 4, 8


def fits(variant, w, lanes, itemsize, cluster=1):
    """Whether a block of the wide kernel's ``variant`` holds ``lanes``
    lanes: threads a lane from about four rows a thread (a sector's worth
    of lanes a warp where E is streamed), halved while the block would take
    more than 512 threads; in wide-global a thread a lane, up to 4; and the
    lanes' shared words, each block's totals in every block or only its
    own."""
    if variant == "wide-global":
        group = 1
        per = next((p for p in range(1, MAX_PER + 1)
                    if wide_threads(lanes, 1, 1, p) <= WIDE_MAX_THREADS), None)
        if per is None:
            return False
    else:
        per, group = 1, 1
        while group < 32 and 4 * group < w:
            group *= 2
        if variant != "wide-shared":
            group = min(group, itemsize)
        while group > 1 and wide_threads(lanes, group, 1, 1) > WIDE_MAX_THREADS:
            group //= 2
    return (wide_threads(lanes, group, 1, per) <= WIDE_MAX_THREADS
            and wide_shared_bytes(variant, w, lanes, group, itemsize, per=per, cluster=cluster)
            <= MAX_SHARED_BYTES)


def assert_wide_shape(w, N, itemsize):
    """The shape of (w, N) past the template kernel's domain, the wide
    kernel's: the first variant (E and state in shared memory, E streamed,
    both in device memory) whose
    lanes fit; whole members a block, or one member over the fewest blocks
    of a cluster of at most 8; at most 512 threads, a lane's rows over a
    power of two of threads up to 32, its columns over 1-8 warps (only at
    32 and w >= 97 in wide-shared, and in wide-stream past w = 129 with
    one member alone in its block, the most warps that fit), or 1-4 lanes
    a thread (only wide-global); the block's
    threads and shared memory (the kernel's footprint, at least a lane's
    state and in wide-shared its E rows) within the kernel's limits;
    every block's totals in each (push) only in a cluster."""
    shape = scan_launch_shape(w, N, itemsize)
    assert shape.variant in VARIANTS[3:], (w, N, itemsize)
    g, cols, per = shape.group, shape.cols, shape.per
    assert g in (1, 2, 4, 8, 16, 32) and (shape.variant == "wide-shared" or g <= itemsize)
    assert 1 <= cols <= MAX_COLS and (cols == 1 or (shape.variant == "wide-shared" and g == 32
                                                    and w >= 97)
                                      or (shape.variant == "wide-stream" and w >= 130
                                          and shape.members == shape.cluster == 1))
    if shape.variant == "wide-stream" and w >= 130 and shape.cluster == 1:
        assert shape.members == 1 and shape.lanes == N
        more = 2 * cols
        assert cols == MAX_COLS or not (
            wide_threads(N, g, more) <= WIDE_MAX_THREADS
            and wide_shared_bytes("wide-stream", w, N, g, itemsize, cols=more) <= MAX_SHARED_BYTES)
    assert 1 <= per <= MAX_PER and (per == 1 or (shape.variant == "wide-global" and g == 1))
    assert shape.threads == wide_threads(shape.lanes, g, cols, per) <= WIDE_MAX_THREADS
    assert shape.threads % 32 == 0 and shape.threads * per >= shape.lanes * g * cols
    assert per == 1 or wide_threads(shape.lanes, 1, 1, per - 1) > WIDE_MAX_THREADS
    e_row, e_lane, y_lane = wide_layout(w, g)
    assert e_row >= w and e_row % 2 and y_lane >= w and y_lane % 2
    assert e_lane >= w * e_row and (e_lane % 2 if g == 1 else (e_lane - g * e_row) % 32 == 0)
    assert shape.shared_bytes == wide_shared_bytes(shape.variant, w, shape.lanes, g, itemsize,
                                                   cols=cols, per=per, cluster=shape.cluster,
                                                   push=shape.push) <= MAX_SHARED_BYTES
    # at least the two totals' buffers and, but in wide-global, each lane's
    # y, a, p1, p2h and weights, and in wide-shared its E rows
    state = 2 * shape.lanes + (0 if shape.variant == "wide-global" else 5 * shape.lanes * w)
    e_rows = shape.lanes * w * w if shape.variant == "wide-shared" else 0
    assert shape.shared_bytes >= itemsize * (state + e_rows)
    assert 1 <= shape.cluster <= MAX_CLUSTER and not (shape.push and shape.cluster == 1)
    if shape.cluster == 1:
        assert shape.lanes == shape.members * N
        assert shape.members == 1 or shape.threads <= 256 * cols
    else:
        assert shape.members == 1 and (shape.cluster - 1) * shape.lanes < N
        assert shape.cluster * shape.lanes >= N
        if shape.variant != "wide-global":
            assert not fits(shape.variant, w, -(-N // (shape.cluster - 1)), itemsize,
                            shape.cluster - 1)
    # an earlier variant holds no member at any cluster
    for v in VARIANTS[3:VARIANTS.index(shape.variant)]:
        assert not any(fits(v, w, -(-N // c), itemsize, c) for c in range(1, 9)), (w, N, v)
    return shape


@pytest.mark.parametrize("w", list(range(2, 18)) + WIDE_WIDTHS)
def test_scan_launch_shape(w):
    """The kernel's variant and block for every N it takes. The template
    kernel up to w = 17 and N = 256: E in registers up to w = 8, in shared
    memory while one member's rows fit a block (every N up to w = 15, N <=
    224 at w = 16, N <= 199 at w = 17), streamed past that; whole members,
    at most 256 threads, and never more shared memory than a block may opt
    into. Past it the wide kernel (:func:`assert_wide_shape`), up to N =
    16,384 sampled, in both types, at every width the tables take (130,
    257 and 513 past the shared-memory table kernels: E streamed); w = 1
    and N = 0 raise naming the domain (w >= 2), N = 16,385 naming the
    member limit."""
    last_shared = {9: 256, 10: 256, 11: 256, 12: 256, 13: 256, 14: 256, 15: 256,
                   16: 224, 17: 199}
    for N in range(1, 257) if w <= 17 else ():
        shape = scan_launch_shape(w, N)
        want = ("registers" if w <= 8 else "shared" if N <= last_shared[w] else "stream")
        assert shape.variant == want and shape.variant in VARIANTS, (w, N)
        lane_bytes = 4 * (w * w + (w + 1) % 2 + 2) if want == "shared" else 8
        assert shape.shared_bytes == shape.members * N * lane_bytes <= MAX_SHARED_BYTES
        assert shape.members >= 1 and shape.members * N <= shape.threads <= 256
        assert shape.threads % 32 == 0 and shape.threads - shape.members * N < 32
        assert shape.members == 1 or shape.members * N <= 128
        assert shape.lanes == shape.members * N and shape.group == shape.cluster == 1
    for N in WIDE_PROTEINS:
        if w > 17 or N > 256:
            for itemsize in (4, 8):
                assert_wide_shape(w, N, itemsize)
    for bad in ((w, 0), (1, 7)):
        with pytest.raises(NotImplementedError, match="w >= 2"):
            scan_launch_shape(*bad)
    for itemsize in (4, 8):
        with pytest.raises(NotImplementedError, match="up to 16,384 proteins"):
            scan_launch_shape(w, 16385, itemsize)


def test_wide_shapes_of_the_main_path():
    """The regimes of the objective's shapes past w = 17 and N = 256 on the
    card: a member's E rows in shared memory, in one block (w = 22 five
    members; w = 65 one) or over a cluster whose
    blocks copy their totals to each other (w = 129: three blocks of 3
    lanes, 4 warps a lane, in float32; seven of one lane, 8 warps, in
    float64), and the 285-protein network in one block of 288 threads, a
    thread a lane; at N = 4,096 and w = 129 the state in device memory over
    8 blocks, and at N = 16,384 4 lanes a thread."""
    want = {(22, 6, 4): ("wide-shared", 5, 8, 1, 1, 1), (22, 6, 8): ("wide-shared", 5, 8, 1, 1, 1),
            (65, 6, 4): ("wide-shared", 1, 32, 1, 1, 1),
            (65, 6, 8): ("wide-shared", 1, 32, 1, 1, 1),
            (129, 7, 4): ("wide-shared", 1, 32, 3, 4, 1),
            (129, 7, 8): ("wide-shared", 1, 32, 7, 8, 1),
            (6, 285, 4): ("wide-shared", 1, 1, 1, 1, 1),
            (6, 285, 8): ("wide-shared", 1, 1, 1, 1, 1),
            (129, 4096, 4): ("wide-global", 1, 1, 8, 1, 1),
            (129, 4096, 8): ("wide-global", 1, 1, 8, 1, 1),
            (22, 16384, 4): ("wide-global", 1, 1, 8, 1, 4),
            (22, 16384, 8): ("wide-global", 1, 1, 8, 1, 4)}
    for (w, N, itemsize), expect in want.items():
        shape = assert_wide_shape(w, N, itemsize)
        assert (shape.variant, shape.members, shape.group, shape.cluster, shape.cols,
                shape.per) == expect, (w, N, itemsize, shape)
    assert scan_launch_shape(6, 285).threads == 288
    assert scan_launch_shape(129, 7).push and scan_launch_shape(129, 7).threads == 384
    assert scan_launch_shape(129, 7, 8).push and scan_launch_shape(129, 7, 8).threads == 256


def test_mechanism_gate():
    rhs = types.SimpleNamespace(model=4)
    with pytest.raises(NotImplementedError, match="mechanism 4"):
        prepare_scan_plan(rhs, [0], [0], [1.0], [0], 1)


# --- the wrapper on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("w, N, P", [(2, 7, 300), (6, 7, 300), (17, 7, 300), (22, 7, 40),
                                     (65, 7, 6), (129, 7, 2), (6, 300, 3), (6, 7000, 2)],
                         ids=["2", "6", "17", "22", "65", "129", "6-N300", "6-N7000"])
def test_cpu_tensor_takes_the_plain_version(w, N, P):
    """A CPU tensor runs the plain version (no launch) at every width and
    N the kernel takes; float32 agrees with float64 on the same problem at
    the card's gate (rtol 2e-3, atol 1e-5, tests/test_pallas.py:262-263)."""
    args, plan = random_scan_problem(w, N=N, P=P, seed=w)
    before = etd2rk_scan.launches
    got = etd2rk_scan(*args, plan)
    assert etd2rk_scan.launches == before
    assert torch.equal(got, etd2rk_scan_reference(*args, plan))
    assert got.shape == (6, w, P * N) and bool(torch.isfinite(got).all())
    args64, _ = random_scan_problem(w, N=N, P=P, seed=w, dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), etd2rk_scan(*args64, plan).numpy(),
                               rtol=2e-3, atol=1e-5)


def test_nan_member_stays_in_its_lanes():
    """A NaN member leaves every other member's snapshots as they were."""
    args, plan = random_scan_problem(6, N=7, P=20)
    clean = etd2rk_scan(*args, plan)
    A = args[5].clone()
    A[7 * 7:8 * 7] = float("nan")                      # member 7
    dirty = etd2rk_scan(*args[:5], A, args[6], plan)
    keep = (torch.arange(140) // 7) != 7
    assert torch.equal(clean[..., keep], dirty[..., keep])
    assert bool(torch.isnan(dirty[1:, 0, ~keep]).all())


def test_driven_override_is_a_select():
    """A non-finite state of a kinase-driven protein reaches none of its
    member's other proteins. (The Pallas kernel blends, dm * drv +
    (1 - dm) * tot, which turns an infinite total into NaN even where the
    protein is driven.)"""
    args, plan = random_scan_problem(5, N=7, P=10, dtype=torch.float64)
    assert plan.driven[0] == 1
    clean = etd2rk_scan(*args, plan)
    y0 = args[3].clone()
    y0[1:, 7 * 4] = float("inf")                       # member 4, protein 0
    dirty = etd2rk_scan(*args[:3], y0, *args[4:], plan)
    keep = torch.arange(70) != 7 * 4
    assert torch.equal(clean[..., keep], dirty[..., keep])
    assert not bool(torch.isfinite(dirty[..., 7 * 4]).all())


@pytest.mark.parametrize("bad", ["use_kernel", "shape", "members", "dtype"])
def test_wrapper_rejects(bad):
    args, plan = random_scan_problem(4, N=5, P=4)
    args = list(args)
    kw = {}
    if bad == "use_kernel":
        kw["use_kernel"] = True                        # a kernel on the CPU
    elif bad == "shape":
        args[1] = args[1][:, :3]
    elif bad == "members":
        plan = plan._replace(N=3, totw=plan.totw[:, :3])   # 20 lanes, 3 proteins
    else:
        args[3] = args[3].double()
    with pytest.raises(ValueError):
        etd2rk_scan(*args, plan, **kw)
