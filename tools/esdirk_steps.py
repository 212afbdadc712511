"""ESDIRK on the bench network: its step counts against the horizon, and
its objective at the default population chunk.

    python tools/esdirk_steps.py --model 2 --t-end 0.25 0.55 960
    python tools/esdirk_steps.py --model 2 --objective

The first form runs ``simulate_batched(solver="esdirk")`` for one member
at the true parameters of ``build_demo_network(40, 12, model=MODEL,
seed=0)`` at float64 (rtol 1e-8, atol = rtol / 100), once for each end
time given, with six output times over [0, t_end] as ``chip_smoke.py``'s
phase 8b (the output times do not move the steps), and prints one line a
run: the end time, the member's steps and accepted steps, and the seconds
on the host clock.

``--objective`` runs ``make_objective(solver="esdirk")`` with its defaults
(rtol 1e-5, atol 1e-7, the whole time grid) once on one population chunk
of the size ``pop_chunk="auto"`` gives ESDIRK (theta0 plus 0.05 N(0, 1)
from ``default_rng(0)``, as ``chip_smoke.py``) and prints the chunk, the
finite objectives, the step counts, the seconds and the peak device memory.

It runs on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device  # noqa: E402
from phoskintime_tpu_torch.demo import build_demo_network  # noqa: E402
from phoskintime_tpu_torch.network.objective import (_esdirk_pop_chunk,  # noqa: E402
                                                     make_objective)
from phoskintime_tpu_torch.network.simulate import simulate_batched  # noqa: E402


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steps_to(b, model: int, rtol: float, t_ends, device) -> None:
    true = {k: np.asarray(v)[None] for k, v in b["true"].items()}
    for t_end in t_ends:
        t_eval = np.linspace(0.0, t_end, 6)
        t0 = time.perf_counter()
        res = simulate_batched(b["system"], true, t_eval, solver="esdirk", rtol=rtol,
                               atol=rtol * 1e-2, max_steps=100_000)
        sync(device)
        print(f"model={model} rtol={rtol} t_end={t_end} "
              f"steps={int(res.n_steps[0])} accepted={int(res.n_accepted[0])} "
              f"success={bool(res.success[0])} seconds={time.perf_counter() - t0:.1f} "
              f"device={device}", flush=True)


def objective_once(b, model: int, device) -> None:
    topo = b["topo"]
    chunk = _esdirk_pop_chunk(topo.N, topo.N * topo.width)
    rng = np.random.default_rng(0)
    thetas = b["theta0"][None] + 0.05 * rng.normal(size=(chunk, len(b["theta0"])))
    objective = make_objective(b["system"], b["slices"], b["loss_data"], b["defaults"],
                               b["lambdas"], b["grid"], solver="esdirk")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    F = objective(thetas)
    sync(device)
    seconds = time.perf_counter() - t0
    steps = objective.n_steps.cpu().numpy()
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
            if device.type == "cuda" else "not measured")
    print(f"model={model} objective=esdirk d={topo.N * topo.width} pop_chunk={chunk} "
          f"finite={int(torch.isfinite(F).all(dim=1).sum())}/{chunk} "
          f"steps_max={int(steps.max())} steps_median={np.median(steps):.1f} "
          f"seconds={seconds:.1f} ms_per_step={1e3 * seconds / steps.max():.3f} "
          f"peak_memory_GiB={peak} device={device}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=int, default=0)
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--t-end", type=float, nargs="+", default=[960.0])
    ap.add_argument("--objective", action="store_true",
                    help="run the ESDIRK objective on one default chunk instead")
    args = ap.parse_args()
    device = resolve_device(args.device)
    b = build_demo_network(40, 12, model=args.model, seed=0, dtype=torch.float64,
                           device=device)
    if args.objective:
        objective_once(b, args.model, device)
    else:
        steps_to(b, args.model, args.rtol, args.t_end, device)


if __name__ == "__main__":
    main()
