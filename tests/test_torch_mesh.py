"""Population sharding (``phoskintime_tpu_torch.parallel.mesh``) on the CPU.

Four gloo ranks, each a process of ``tests/torch_mesh_worker.py`` joined
through a ``file://`` rendezvous in the test's own directory (no port, so
that parallel test workers do not collide), run every sharded entry point
once: ``evaluate_population``, ``make_batched_evaluate`` at uneven P, the
column-sharded ranking and survival, the all-device GA loops, the polish
and the multistart, ``run_global_fit`` on each route, the loss-weight scan,
``fit_all_mechanisms`` and ``runner.main``. Meanwhile this process runs the
same calls without a mesh and the JAX package's sharded evaluation on the
conftest's 8-device CPU mesh. Float64. Every rank must return the same
bits. Against the unsharded calls: ``evaluate_population`` bit for bit;
the rest within rtol 1e-9 (the JAX package's sharded-evaluation tolerance,
tests/test_network.py), since PyTorch's CPU kernels compute exp, sin and
their kin vectorized in the body of a tensor and one element at a time in
its tail, which can differ in the last bit, so a member can round
differently in a batch of 4 than in one of 13 (a padded population's last
row: 1.4e-14 of an F of 113 here); the polish iterates in float32, as in
the JAX package, and is held at its sharded-polish tolerance.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.network.objective import evaluate_population as jax_evaluate_population
from phoskintime_tpu.network.objective import \
    make_population_objective as jax_make_population_objective
from phoskintime_tpu.network.optimize import make_batched_evaluate as jax_make_batched_evaluate
from phoskintime_tpu_torch.demo import GRID, RNA_GRID
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network.objective import (evaluate_population,
                                                     make_population_objective)
from phoskintime_tpu_torch.network.optimize import run_global_fit
from phoskintime_tpu_torch.network.polish import polish_solutions, simplex_weights
from phoskintime_tpu_torch.ops.nsga import make_device_ga_step
from phoskintime_tpu_torch.ops.nsga_device import (make_device_ga_blocks, run_nsga2_device,
                                                   run_unsga3_device)
from phoskintime_tpu_torch.parallel import (PopulationMesh, initialize_distributed,
                                            pad_to_devices, population_mesh)
from phoskintime_tpu_torch.parallel.mesh import on_root
from torch_mesh_worker import KEYS, dtlz2, run_all
from torch_project import CONFIG, write_project

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
RTOL_F64 = 1e-9
# tests/test_polish.py's sharded-polish tolerance: the iterate is float32
POLISH_RTOL, POLISH_ATOL = 1e-4, 1e-6


def columns(df) -> dict:
    return {c: np.asarray(df[c]) for c in df.columns}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh").resolve()
    bj = jax_demo(n_proteins=10, n_kinases=4, seed=0, dtype=np.float64)
    rng = np.random.default_rng(0)
    n = len(bj["theta0"])
    members = lambda P: bj["theta0"][None] + 0.05 * rng.normal(size=(P, n))  # noqa: E731
    inp = dict(bundle=from_reference({k: bj[k] for k in KEYS}, device="cpu"),
               xl=bj["xl"], xu=bj["xu"], X16=members(16), X13=members(13), X21=members(21),
               X5=rng.uniform(bj["xl"], bj["xu"], (5, n)),
               W5=simplex_weights(rng.random((5, 3)) + 0.5),
               F1024=rng.random((1024, 3)).astype(np.float32),
               X512=rng.random((512, 10)).astype(np.float32),
               F512=rng.random((512, 3)).astype(np.float32),
               df_prot=columns(bj["df_prot"]), df_rna=columns(bj["df_rna"]),
               df_pho=columns(bj["df_pho"]), t_points=(GRID, RNA_GRID, GRID),
               project=write_project(d / "project", config=CONFIG.replace(
                   "sensitivity_trajectories = 2", "sensitivity_trajectories = 1")))
    with open(d / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")])}
    logs = [open(d / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
                               str(r), str(WORLD), str(d)], env=env, cwd=d,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        unsharded = run_all(inp, None, d / "unsharded")
        mesh8 = Mesh(np.array(jax.devices()[:8]).reshape(8), ("pop",))
        jobj = jax_make_population_objective(*(bj[k] for k in KEYS), use_pallas=False)
        jev = jax_make_batched_evaluate(jobj, mesh=mesh8)
        ref = {"evaluate": np.asarray(jax_evaluate_population(
            jobj, jnp.asarray(inp["X16"]), mesh=mesh8)),
            **{f"batched{P}": jev(inp[f"X{P}"]) for P in (13, 21)}}
        deadline = time.monotonic() + 600
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join((d / f"rank{r}.log").read_text()[-3000:] for r in failed)
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return SimpleNamespace(dir=d, ranks=ranks, unsharded=unsharded, jax=ref)


def assert_same(got, want, path="result", rtol=0.0):
    """Equal through dicts, lists and tuples: float arrays and floats within
    ``rtol`` of their largest magnitude (bit for bit at 0), the rest
    exactly."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]", rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", rtol)
    elif rtol and (isinstance(want, float) or (isinstance(want, np.ndarray)
                                               and want.dtype.kind == "f")):
        want = np.asarray(want)
        scale = float(np.max(np.abs(want), initial=0.0)) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=path)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), path


def assert_sharded(runs, key, rtol=RTOL_F64):
    """Every rank's ``key`` the same bits as rank 0's, and within ``rtol``
    of the unsharded run's."""
    for r in runs.ranks:
        assert_same(r[key], runs.ranks[0][key], key)
    assert_same(runs.ranks[0][key], runs.unsharded[key], key, rtol)


@pytest.mark.parametrize("key", ["evaluate", "batched13", "batched21"])
def test_evaluation_matches_unsharded_and_jax(runs, key):
    """``evaluate_population`` at P = 16 and ``make_batched_evaluate`` at
    P = 13 and 21 (padded to 16 and 24 with copies of the last row): every
    rank gets the same F, the unsharded call's (at P = 16 bit for bit; the
    padded ones within 1e-12: see the module docstring), and the JAX
    package's sharded call (8 devices) within rtol 1e-9."""
    want = runs.unsharded[key]
    assert want.shape == ({"evaluate": 16, "batched13": 13, "batched21": 21}[key], 3)
    assert np.isfinite(want).all()
    assert_sharded(runs, key, 0.0 if key == "evaluate" else 1e-12)
    np.testing.assert_allclose(runs.ranks[0][key], runs.jax[key], rtol=RTOL_F64)


def test_mesh_over_the_first_ranks(runs):
    """``population_mesh(2)`` in a group of four: ranks 0 and 1 share a mesh
    of two (a group made on every rank) and evaluate the unsharded F; ranks
    2 and 3 get None."""
    for r in runs.ranks[2:]:
        assert r["half_mesh"] is None
    for r in runs.ranks[:2]:
        assert r["half_mesh"][0] == 2
        assert_same(r["half_mesh"][1], runs.unsharded["evaluate"], "half_mesh", 1e-12)


@pytest.mark.parametrize("key", ["ranks", "survival"])
def test_sharded_ranking_equals_replicated(runs, key):
    """The column-sharded ranking (Q = 1024) and NSGA-III survival (Q = 512,
    256 survivors), each rank holding a (Q, Q / 4) block of the dominance
    matrix: exactly the replicated results, as tests/test_nsga_device.py
    asks of the JAX package's."""
    assert_sharded(runs, key, 0.0)


@pytest.mark.parametrize("key", ["unsga3_device", "nsga2_device"])
def test_device_loops_match_unsharded(runs, key):
    """The all-device U-NSGA-III (pop 32, 6 generations in blocks of 3) and
    NSGA-II (pop 32, 4 generations) loops: the unsharded runs, every
    generation in the history."""
    want = runs.unsharded[key]
    assert_sharded(runs, key)
    assert len(want["history"]) == {"unsga3_device": 6, "nsga2_device": 4}[key]
    assert want["F"].shape == (32, 3) and np.isfinite(want["F"]).all()


@pytest.mark.parametrize("key", ["polish", "multistart"])
def test_polish_matches_unsharded(runs, key):
    """``polish_solutions`` (5 members padded to 8, chunk 8) and
    ``gradient_multistart`` (8 starts) sharded over the members: the
    unsharded results within the JAX package's sharded-polish tolerance
    (float32 iterates), and the same arrays on every rank."""
    for r in runs.ranks:
        assert_same(r[key], runs.ranks[0][key], key)
    for got, ref in zip(runs.ranks[0][key], runs.unsharded[key]):
        np.testing.assert_allclose(got, ref, rtol=POLISH_RTOL, atol=POLISH_ATOL)


@pytest.mark.parametrize("route", ["default", "host_variation", "all_device", "refine",
                                   "optuna"])
def test_global_fit_matches_unsharded(runs, route):
    """``run_global_fit`` at pop 16 (MOTPE: 20 trials, its last batch of 4
    padded to the mesh) with the Fréchet pick and a checkpoint every
    generation: the unsharded fit, on every rank."""
    want = runs.unsharded[f"fit_{route}"]
    assert np.isfinite(want["F"]).all() and want["n_evals"] > 0
    assert_sharded(runs, f"fit_{route}")


def test_scan_and_mechanisms_match_unsharded(runs):
    """The loss-weight scan (3 trials, inner pop 8) and ``fit_all_mechanisms``
    (model 0, pop 8): the unsharded trials, table and pick, on every rank."""
    assert_sharded(runs, "scan")
    assert_sharded(runs, "mechanisms")


def test_runner_matches_unsharded(runs):
    """``runner.main`` at float64 on the test project: the unsharded fit,
    pick, predictions, Morris indices and steady state on every rank, and
    the same files (the arrays among them within rtol 1e-9)."""
    assert_sharded(runs, "runner")
    sharded, plain = runs.dir / "sharded" / "runner", runs.dir / "unsharded" / "runner"
    files = sorted(p.relative_to(plain) for p in plain.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(sharded) for p in sharded.rglob("*")
                                     if p.is_file())
    for name in ("pareto_X.npy", "pareto_F.npy"):
        assert_same(np.load(sharded / name), np.load(plain / name), name, RTOL_F64)
    with np.load(sharded / "sensitivity.npz") as got, np.load(plain / "sensitivity.npz") as want:
        assert_same(dict(got), dict(want), "sensitivity.npz", RTOL_F64)


def test_only_rank_zero_writes(runs):
    """Checkpoints, the MOTPE sampler, the scan's state and report, the
    mechanism tables and every runner file come from rank 0: the other
    ranks open no file for writing, and the sharded tree holds what the
    unsharded run wrote."""
    for r in runs.ranks[1:]:
        assert r["writes"] == []
    plain = runs.dir / "unsharded"
    want = sorted(p.relative_to(plain) for p in plain.rglob("*") if p.is_file())
    got = sorted(p.relative_to(runs.dir / "sharded")
                 for p in (runs.dir / "sharded").rglob("*") if p.is_file())
    assert got == want
    assert {Path("fit_default.ckpt"), Path("fit_optuna.ckpt.tpe"),
            Path("scan/scan_state.json")} <= set(got)


# --- one process: the mesh's own functions and the errors ------------------------------


def fake_mesh(size: int = 4) -> PopulationMesh:
    """A mesh of ``size`` ranks seen from rank 0, for the checks made
    before any collective."""
    return PopulationMesh(None, 0, size, torch.device("cpu"))


def test_single_process_has_no_mesh(monkeypatch):
    """One process: no group, ``population_mesh`` None (JAX's one-device
    case), ``initialize_distributed`` a no-op returning 1; padding."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert population_mesh() is None and population_mesh(4) is None
    assert initialize_distributed() == 1
    assert pad_to_devices(13, None) == 13
    assert [pad_to_devices(P, fake_mesh()) for P in (13, 16, 21, 1)] == [16, 16, 24, 4]
    m = fake_mesh()
    assert [m.block(16, "x")] == [slice(0, 4)]
    assert on_root(None, lambda: 7) == 7


# one rank as torchrun starts it: the environment names the group
TORCHRUN_RANK = """
import sys, torch
from phoskintime_tpu_torch.network.objective import evaluate_population
from phoskintime_tpu_torch.parallel import initialize_distributed, population_mesh
world = initialize_distributed()
mesh = population_mesh()
F = evaluate_population(lambda X: X * 2.0, torch.arange(8.0).reshape(4, 2), mesh)
ok = world == 2 and mesh.size == 2 and torch.equal(F, torch.arange(8.0).reshape(4, 2) * 2.0)
sys.exit(0 if ok and mesh.backend == "gloo" else 1)
"""


def test_initialize_distributed_reads_the_torchrun_environment():
    """Two processes given torchrun's environment (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) join one gloo group
    (no card here) through ``initialize_distributed`` and shard through
    ``population_mesh``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", TORCHRUN_RANK],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs


@pytest.fixture(scope="module")
def port_bundle():
    bj = jax_demo(n_proteins=6, n_kinases=3, seed=1, dtype=np.float64)
    return from_reference({k: bj[k] for k in KEYS}, device="cpu"), bj["xl"], bj["xu"]


@pytest.mark.parametrize("case", ["evaluate_population", "device_ga_blocks",
                                  "unsga3_device", "nsga2_device", "device_ga_step",
                                  "polish_chunk", "global_fit_all_device",
                                  "global_fit_default"])
def test_multiple_of_the_mesh_errors(port_bundle, case):
    """Where the JAX package needs a population (or the polish's chunk) that
    the mesh divides, the port raises ``ValueError`` naming the mesh, before
    any collective: an uneven ``evaluate_population``, the all-device loops'
    and the device step's ``pop_size``, the polish's chunk."""
    b, xl, xu = port_bundle
    args = [b[k] for k in KEYS]
    obj = make_population_objective(*args)
    n = len(xl)
    mesh = fake_mesh()
    calls = {
        "evaluate_population": lambda: evaluate_population(obj, np.zeros((13, n)), mesh),
        "device_ga_blocks": lambda: make_device_ga_blocks(
            dtlz2, 6, 30, dtype=torch.float64, device="cpu", mesh=mesh),
        "unsga3_device": lambda: run_unsga3_device(
            dtlz2, np.zeros(6), np.ones(6), pop_size=30, n_gen=2, gens_per_block=2,
            device="cpu", mesh=mesh),
        "nsga2_device": lambda: run_nsga2_device(
            dtlz2, np.zeros(6), np.ones(6), pop_size=30, n_gen=2, device="cpu", mesh=mesh),
        "device_ga_step": lambda: make_device_ga_step(
            obj, xl, xu, 30, dtype=torch.float64, device="cpu", mesh=mesh),
        "polish_chunk": lambda: polish_solutions(*args, np.tile(xl, (12, 1)), xl, xu,
                                                 steps=2, chunk=6, mesh=mesh),
        "global_fit_all_device": lambda: run_global_fit(
            *args, xl, xu, pop=30, n_gen=2, gens_per_dispatch=2, mesh=mesh,
            frechet_pick=False),
        "global_fit_default": lambda: run_global_fit(
            *args, xl, xu, pop=30, n_gen=2, mesh=mesh, frechet_pick=False),
    }
    with pytest.raises(ValueError, match="multiple of the mesh"):
        calls[case]()
