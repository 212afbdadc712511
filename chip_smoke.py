"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the script exits
non-zero:

1. device: the card, its power limit, CUDA and nvcc versions; full-float32
   matmuls (TF32 off);
2. build: compile the hand-written kernels from ``phoskintime_tpu_torch/csrc``;
3. kernel vs plain: ``phi_tables`` against ``phi_tables_reference`` on the
   card at the main path's own shapes (one 2048-member chunk of the bench
   problem) and at every block width 2..8, scaled atol 2e-5; both timed;
4. main path: the population objective at pop 8192 in chunks of 2048 on
   the bench problem (``build_demo_network(40, 12, seed=0)``, float32),
   counting kernel launches, checking F against the plain tables, and
   timing evals/s;
5. accuracy: fold changes at the true parameters against a tight SciPy
   LSODA oracle (rtol 1e-7, atol 1e-9) of the same equations, max
   relative error below 1e-3.

The line before the last is a JSON summary of each kernel; the last line
is ``{"ok": true, "device": {...}}``. There is no CPU fallback.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from phoskintime_tpu_torch.demo import build_demo_network
from phoskintime_tpu_torch.network import expo
from phoskintime_tpu_torch.network.objective import make_population_objective
from phoskintime_tpu_torch.network.params import unpack_params
from phoskintime_tpu_torch.network.simulate import extract_observables, fold_changes
from phoskintime_tpu_torch.ops import phi_tables as phi_mod
from phoskintime_tpu_torch.ops.phi_tables import phi_tables, phi_tables_reference

POP, CHUNK, N_PROTEINS, N_KINASES = 8192, 2048, 40, 12
KERNEL_ATOL = 2e-5        # scaled by max |plain|, as tests/test_pallas.py
F_RTOL = 1e-3             # objective with the kernel vs with the plain tables
ACCURACY_GATE = 1e-3      # fold changes vs the LSODA oracle, as bench.py


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, by CUDA
    events after a warm-up call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def scaled_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float(torch.max(torch.abs(got - want)))
    return err, err / (float(torch.max(torch.abs(want))) + 1e-30)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this script runs on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    nvcc = subprocess.run([phi_mod.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs full float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("1 device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc.splitlines()[-1]),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build() -> None:
    path, seconds = phi_mod.build_library()
    log = path.with_suffix(".log").read_text()
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    say("2 build", library=path.name, seconds=f"{seconds:.2f}")
    for ln in regs:
        print("    " + ln)


def phase_kernel(b, thetas, card) -> dict:
    params_b = unpack_params(thetas[:CHUNK], b["slices"], b["topo"])
    L, binv, h_u, ladder = expo.table_inputs(b["system"], params_b, b["grid"])
    got = phi_tables(L, binv, h_u, ladder)
    want = phi_tables_reference(L, binv, h_u, ladder)
    torch.cuda.synchronize()
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    max_abs = max(e[0] for e in errs)
    worst = max(e[1] for e in errs)
    # both float32 versions against the float64 plain tables (12 terms)
    exact = phi_tables_reference(L.double(), binv, h_u, ladder)
    vs64 = lambda outs: max(scaled_err(g.double(), x)[1] for g, x in zip(outs, exact))
    say("3 kernel main-path", shape=tuple(L.shape), pairs=len(binv),
        ladder=ladder, max_abs_err=f"{max_abs:.3e}",
        max_scaled_err=f"{worst:.3e}", tol=KERNEL_ATOL,
        kernel_vs_f64=f"{vs64(got):.3e}", plain_vs_f64=f"{vs64(want):.3e}")
    del exact
    if not worst <= KERNEL_ATOL:
        raise AssertionError(f"phi_tables kernel disagrees: {worst:.3e}")

    # plain, kernel, kernel, plain: each version timed twice
    run_k = lambda: phi_tables(L, binv, h_u, ladder)
    run_p = lambda: phi_tables_reference(L, binv, h_u, ladder)
    p1, k1, k2, p2 = (cuda_ms(run_p, 3), cuda_ms(run_k, 20),
                      cuda_ms(run_k, 20), cuda_ms(run_p, 3))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    say("3 kernel timing", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        runs_ms=[round(x, 4) for x in (p1, k1, k2, p2)], card=repr(card))

    # every block width on compartmental blocks like the model's own:
    # non-negative transfer rates off the diagonal, each column's outflow
    # plus its own decay on the diagonal
    rng = np.random.default_rng(1)
    for w in range(2, 9):
        Bu, B = 2, 1000                    # 1000 lanes: not a multiple of 128
        Lw = rng.uniform(0.0, 2.0, (Bu, w, w, B))
        Lw[:, np.arange(w), np.arange(w), :] = 0.0
        decay = rng.uniform(0.01, 4.0, (Bu, w, B))
        Lw[:, np.arange(w), np.arange(w), :] = -(Lw.sum(axis=1) + decay)
        Lw = torch.as_tensor(Lw, dtype=torch.float32, device="cuda")
        bw = np.asarray([0, 1, 1], np.int32)
        hw = np.asarray([0.0625, 2.0, 16.0])
        lad = max(phi_mod.ladder_len(w, h) for h in hw)
        errs = [scaled_err(g, r) for g, r in
                zip(phi_tables(Lw, bw, hw, lad), phi_tables_reference(Lw, bw, hw, lad))]
        torch.cuda.synchronize()
        worst_w = max(e[1] for e in errs)
        say("3 kernel width", w=w, lanes=B, max_scaled_err=f"{worst_w:.3e}")
        if not worst_w <= KERNEL_ATOL:
            raise AssertionError(f"phi_tables kernel disagrees at w={w}: {worst_w:.3e}")
    return {"name": "phi_tables", "route": "cuda",
            "source": "phoskintime_tpu_torch/csrc/phi_tables.cu",
            "replaces": "phoskintime_tpu/ops/phi_pallas.py:352",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def phase_main_path(b, thetas, card) -> int:
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"])
    objective = make_population_objective(*args, pop_chunk=CHUNK)
    torch.cuda.synchronize()
    objective(thetas)                      # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()

    phi_tables.launches = 0
    F = objective(thetas)
    torch.cuda.synchronize()
    launches = phi_tables.launches
    n_chunks = -(-POP // CHUNK)
    if tuple(F.shape) != (POP, 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError("non-finite or misshapen objectives")
    if launches != n_chunks:
        raise AssertionError(f"phi_tables launched {launches} times for {n_chunks} chunks")
    say("4 main path", pop=POP, chunk=CHUNK, F_shape=tuple(F.shape),
        finite=True, phi_tables_launches=launches)

    plain = make_population_objective(*args, pop_chunk=CHUNK, use_kernel=False)
    Fp = plain(thetas[:256])
    rel = float(torch.max(torch.abs(F[:256] - Fp) / torch.abs(Fp)))
    say("4 main path vs plain", members=256, max_rel_err=f"{rel:.3e}", tol=F_RTOL)
    if not rel <= F_RTOL:
        raise AssertionError(f"objective with the kernel drifted: {rel:.3e}")

    ms = cuda_ms(lambda: objective(thetas), 3)
    say("4 main path rate", evals_per_s=f"{POP / (ms / 1e3):.1f}",
        ms_per_pop=f"{ms:.3f}", card=repr(card))
    return launches


def oracle_rhs(b):
    """dy/dt of the distributive mechanism (model 0), float64 numpy, written
    out from the equations: synthesis from the squashed TF input, mRNA
    decay, translation, per-site phosphorylation and dephosphorylation."""
    topo, system = b["topo"], b["system"]
    p = {k: np.asarray(v, float) for k, v in b["true"].items()}
    Kmat, grid = np.asarray(system.Kmat, float), np.asarray(system.kin_grid, float)
    msk = topo.site_mask().astype(float)
    N, w = topo.N, topo.width
    driven = topo.driver_map >= 0

    def rhs(y, t):
        Y = y.reshape(N, w)
        jb = min(max(int(np.searchsorted(grid, t, side="right") - 1), 0),
                 Kmat.shape[1] - 1)
        Kt = Kmat[:, jb] * p["c_k"]
        S = np.einsum("nsk,k->ns", topo.W_pad, Kt) * msk
        sites = Y[:, 2:] * msk
        Pv = Y[:, 1] + sites.sum(1)
        Pv[driven] = Kt[topo.driver_map[driven]]
        v = (topo.tf_mat @ Pv) / topo.tf_deg
        u = v / (1.0 + np.abs(v))
        act = p["A_i"] * (1.0 + p["tf_scale"] * u / (1.0 + u + 1e-6))
        rep = p["A_i"] / (1.0 + p["tf_scale"] * np.abs(u))
        dY = np.zeros_like(Y)
        dY[:, 0] = np.where(u >= 0.0, act, rep) - p["B_i"] * Y[:, 0]
        dY[:, 1] = (p["C_i"] * Y[:, 0] - (p["D_i"] + S.sum(1)) * Y[:, 1]
                    + p["E_i"] * sites.sum(1))
        dY[:, 2:] = (S * Y[:, 1:2] - (p["E_i"][:, None] + p["Dp_i"]
                                      + p["D_i"][:, None]) * sites) * msk
        return dY.reshape(-1)

    return rhs


def fold_changes_np(Y, times, msk):
    """(fc_rna, fc_protein, fc_phospho at valid sites) of a (T, N, w) run."""
    base = lambda t0: int(np.argmin(np.abs(times - t0)))
    fc = lambda sig, b: np.maximum(sig, 1e-12) / np.maximum(sig[b][None], 1e-12)
    sites = Y[:, :, 2:] * msk
    return (fc(Y[:, :, 0], base(4.0)), fc(Y[:, :, 1] + sites.sum(2), base(0.0)),
            fc(sites, base(0.0))[:, msk])


def phase_accuracy(b) -> None:
    from scipy.integrate import odeint

    system, topo = b["system"], b["topo"]
    times = np.asarray(b["grid"], float)
    msk = topo.site_mask()
    p_b = {k: np.asarray(v)[None] for k, v in b["true"].items()}
    ys, success = expo.exponential_simulate_batched(system, p_b, times)
    if not bool(success[0]):
        raise AssertionError("ETD2RK failed at the true parameters")
    obs = extract_observables(system, ys[0])
    got = [x.double().cpu().numpy() for x in fold_changes(obs, times)]
    got[2] = got[2][:, msk]
    Y = odeint(oracle_rhs(b), system.y0().reshape(-1), times, rtol=1e-7,
               atol=1e-9, mxstep=20000).reshape(len(times), topo.N, topo.width)
    want = fold_changes_np(Y, times, msk)
    err = max(float(np.max(np.abs(g - o) / np.maximum(np.abs(o), 1e-6)))
              for g, o in zip(got, want))
    say("5 accuracy", max_rel_err=f"{err:.3e}", gate=ACCURACY_GATE,
        dtype="float32", oracle="LSODA rtol 1e-7 atol 1e-9")
    if not err < ACCURACY_GATE:
        raise AssertionError(f"ETD2RK drifted from the LSODA oracle: {err:.3e}")


def main() -> int:
    card = phase_device()
    phase_build()
    t0 = time.perf_counter()
    b = build_demo_network(N_PROTEINS, N_KINASES, seed=0, dtype=torch.float32,
                           device="cuda")
    rng = np.random.default_rng(0)
    thetas = torch.as_tensor(
        b["theta0"][None] + 0.05 * rng.normal(size=(POP, len(b["theta0"]))),
        dtype=torch.float32, device="cuda")
    topo = b["topo"]
    say("setup", N=topo.N, K=topo.K, w=topo.width, n_theta=len(b["theta0"]),
        T=len(b["grid"]), seconds=f"{time.perf_counter() - t0:.2f}")
    kernel = phase_kernel(b, thetas, card)
    kernel["launches"] = phase_main_path(b, thetas, card)
    phase_accuracy(b)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
