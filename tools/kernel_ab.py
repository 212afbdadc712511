"""Time the table and scan kernels of the PyTorch/CUDA port on the card, and
hold two checkouts of the port against each other on one card.

    python tools/kernel_ab.py tune
    python tools/kernel_ab.py ab PARENT_DIR [--rk45] [--repeats N]

``tune`` sweeps the launch shape of ``csrc/phi_tables_wide.cu`` (rows a
thread owns, warps a block) at w = 9 and 17 (the model-2 bench chunk's own
class shapes) and w = 13 (compartmental blocks over as many lanes), and the
lanes a block of ``csrc/etd2rk_scan.cu`` on the model-0 and unbucketed
model-2 chunks: each candidate's device time by the profiler, its error
against the plain version, and whether its output equals the first
candidate's bit for bit. A candidate the library was not built for (the
source instantiates the chosen R of each width) is reported as such.

``ab`` runs the same measurements (``arm``) in PARENT_DIR, this checkout,
this checkout and PARENT_DIR, one process each, in that order, on one card:
the two kernels' device and event times at the main path's shapes (the
model-2 classes w = 9 and 17, the unbucketed w = 17 tables, the model-0 and
unbucketed model-2 scan chunks), a digest of each output, and the
end-to-end rates that ``chip_smoke.py`` prints (model 0 eager at pop 8192,
model 2 bucketed at pop 2048, both through the scan kernel; with
``--rk45`` also the RK45 model-2 objective at pop 2048; ``--repeats``
measurements of each ETD2RK rate). It prints each
arm's numbers and whether the outputs of the two trees are equal bit for
bit, and equal in value (-0 and +0 taken as equal).

Needs an NVIDIA GPU with nvcc; the last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
POP, CHUNK, POP2 = 8192, 2048, 2048


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` by CUDA events over ``reps`` calls,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, name_part: str, reps: int) -> float | None:
    """Mean device duration (ms) of the kernels whose name holds
    ``name_part`` over ``reps`` calls under torch.profiler; None where the
    trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA and name_part in e.name]
    return sum(durs) / len(durs) / 1e3 if durs else None


def digests(outs) -> tuple[str, str]:
    """(digest of the bits, digest with -0 taken as +0) of a tuple of
    tensors."""
    bits, value = hashlib.sha256(), hashlib.sha256()
    for x in outs:
        bits.update(x.detach().contiguous().cpu().numpy().tobytes())
        value.update((x.detach() + 0.0).contiguous().cpu().numpy().tobytes())
    return bits.hexdigest()[:16], value.hexdigest()[:16]


def scaled_err(got, want) -> float:
    return max(float(torch.max(torch.abs(g - w)) / (torch.max(torch.abs(w)) + 1e-30))
               for g, w in zip(got, want))


def bundles():
    """The bench networks (model 0 and 2, N = 45) and their populations, as
    chip_smoke.py makes them."""
    from phoskintime_tpu_torch.demo import build_demo_network

    out = {}
    for model, pop in ((0, POP), (2, POP2)):
        b = build_demo_network(40, 12, model=model, seed=0, dtype=torch.float32, device="cuda")
        rng = np.random.default_rng(0)
        thetas = torch.as_tensor(b["theta0"][None] + 0.05 * rng.normal(
            size=(pop, len(b["theta0"]))), dtype=torch.float32, device="cuda")
        out[model] = (b, thetas)
    return out


def table_cases(bs) -> dict:
    """{label: (L, binv, h_u, ladder)} at the main path's table shapes."""
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params

    b2, th2 = bs[2]
    params = unpack_params(th2[:CHUNK], b2["slices"], b2["topo"])
    cases = {f"class w={a[0].shape[1]}": a
             for a in expo.table_inputs(b2["system"], params, b2["grid"]) if a[0].shape[1] > 8}
    cases["unbucketed w=17"], = expo.table_inputs(b2["system"], params, b2["grid"],
                                                  width_bucketing=False)
    return cases


def scan_cases(bs) -> dict:
    """{label: (args, plan)}: the scan kernel's inputs at the model-0 chunk
    and the unbucketed model-2 chunk."""
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params

    out = {}
    for model, label, kw in ((0, "model-0 chunk", {}),
                             (2, "model-2 unbucketed chunk", {"width_bucketing": False})):
        b, th = bs[model]
        scan = expo.ScanSetup(b["system"], unpack_params(th[:CHUNK], b["slices"], b["topo"]),
                              b["grid"], **kw)
        out[label] = (scan.kernel_args(), scan.plan)
    return out


def rates(bs, rk45: bool, repeats: int) -> dict:
    """evals/s of the objective paths chip_smoke.py times, ``repeats``
    measurements of each (RK45: one)."""
    from phoskintime_tpu_torch.network.objective import make_objective, make_population_objective

    keys = ("system", "slices", "loss_data", "defaults", "lambdas", "grid")
    out = {}
    for name, model, kw in (("model-0 eager", 0, {}), ("model-2 bucketed", 2, {}),
                            ("model-0 scan", 0, {"use_scan_kernel": True}),
                            ("model-2 unbucketed scan", 2, {"use_scan_kernel": True,
                                                            "width_bucketing": False})):
        b, th = bs[model]
        objective = make_population_objective(*(b[k] for k in keys), pop_chunk=CHUNK, **kw)
        out[name] = [th.shape[0] / (cuda_ms(lambda: objective(th), 3) / 1e3)
                     for _ in range(repeats)]
    if rk45:
        b, th = bs[2]
        objective = make_objective(*(b[k] for k in keys))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        objective(th)
        torch.cuda.synchronize()
        out["model-2 rk45"] = [th.shape[0] / (time.perf_counter() - t0)]
    return out


def arm(rk45: bool, repeats: int) -> dict:
    """One tree's measurements (the tree whose package is imported)."""
    import phoskintime_tpu_torch
    from phoskintime_tpu_torch.ops import cuda_build
    from phoskintime_tpu_torch.ops.phi_tables import phi_tables
    from phoskintime_tpu_torch.ops.scan_kernel import etd2rk_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build_libraries()
    out = {"package": str(Path(phoskintime_tpu_torch.__file__).parent),
           "build_s": time.perf_counter() - t0, "tables": {}, "scan": {}}
    bs = bundles()
    for label, (L, binv, h_u, ladder) in table_cases(bs).items():
        run = lambda: phi_tables(L, binv, h_u, ladder)
        out["tables"][label] = {"ms": cuda_ms(run, 10),
                                "device_ms": device_ms(run, "phi_tables_wide_kernel", 5),
                                "digest": digests(run())}
    for label, (args, plan) in scan_cases(bs).items():
        run = lambda: etd2rk_scan(*args, plan)
        out["scan"][label] = {"ms": cuda_ms(run, 10),
                              "device_ms": device_ms(run, "etd2rk_scan_kernel", 5),
                              "digest": digests((run(),))}
    out["evals_per_s"] = rates(bs, rk45, repeats)
    return out


def ladder_steps(L, binv, h_u, ladder) -> dict:
    """Mean squaring steps a (pair, lane) on these inputs: each lane's own
    count, and the largest count over groups of 8, 10, 16 and 32
    neighbouring lanes (the trip count a warp or tile of that many lanes
    runs)."""
    out = {}
    for b, h in zip(np.asarray(binv), np.asarray(h_u)):
        A = L[int(b)] * float(h)
        norm = torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
        s = torch.clamp(torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / 0.5)), 0.0,
                        float(ladder)).cpu().numpy()
        out.setdefault("lane", []).append(s.mean())
        for g in (8, 10, 16, 32):
            pad = np.concatenate([s, np.zeros(-len(s) % g)])
            out.setdefault(f"max_of_{g}", []).append(pad.reshape(-1, g).max(axis=1).mean())
    return {k: float(np.mean(v)) for k, v in out.items()}


def tune() -> dict:
    """The sweep of the two kernels' launch shapes; see the module note."""
    from phoskintime_tpu_torch.ops import cuda_build, phi_tables as pm, scan_kernel as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_libraries()
    bs = bundles()
    cases = table_cases(bs)
    L9 = cases["class w=9"]
    rng = np.random.default_rng(13)
    Lr = rng.uniform(0.0, 2.0, (L9[0].shape[0], 13, 13, 20480))
    Lr[:, np.arange(13), np.arange(13)] = 0.0
    Lr[:, np.arange(13), np.arange(13)] = -(Lr.sum(axis=1) + rng.uniform(0.01, 4.0, (
        L9[0].shape[0], 13, 20480)))
    cases["random w=13"] = (torch.as_tensor(Lr, dtype=torch.float32, device="cuda"),) + L9[1:]
    rows = {9: (3, 5, 9), 13: (3, 5, 7), 17: (3, 4, 5, 6)}
    report = {"tables": [], "scan": []}
    for label in ("class w=9", "random w=13", "class w=17"):
        L, binv, h_u, ladder = cases[label]
        w = L.shape[1]
        report.setdefault("steps", {})[label] = steps = ladder_steps(L, binv, h_u, ladder)
        log(json.dumps({"case": label, "ladder_steps": steps}))
        want = pm.phi_tables_reference(L, binv, h_u, ladder)
        first = None
        saved = (dict(pm._WIDE_ROWS), pm._WIDE_WARPS)
        for R, warps in itertools.product(rows[w], (1, 2, 4)):
            pm._WIDE_ROWS[w], pm._WIDE_WARPS = R, warps
            entry = {"case": label, "rows": R, "warps": warps,
                     "shape": pm.wide_launch_shape(w)._asdict()}
            try:
                got = pm.phi_tables(L, binv, h_u, ladder)
                torch.cuda.synchronize()
            except RuntimeError as exc:
                entry["error"] = str(exc)
                log(json.dumps(entry))
                continue
            dig = digests(got)
            first = first or dig
            run = lambda: pm.phi_tables(L, binv, h_u, ladder)
            entry.update(max_scaled_err=scaled_err(got, want), bits_equal_first=dig == first,
                         device_ms=device_ms(run, "phi_tables_wide_kernel", 5),
                         ms=cuda_ms(run, 10))
            report["tables"].append(entry)
            log(json.dumps(entry))
        pm._WIDE_ROWS.clear()
        pm._WIDE_ROWS.update(saved[0])
        pm._WIDE_WARPS = saved[1]
    for label, (args, plan) in scan_cases(bs).items():
        first = None
        saved = sk._BLOCK_LANES
        for lanes in (45, 90, 128, 135, 180, 256):
            sk._BLOCK_LANES = lanes
            w = args[0].shape[1]
            got = sk.etd2rk_scan(*args, plan)
            torch.cuda.synchronize()
            dig = digests((got,))
            first = first or dig
            run = lambda: sk.etd2rk_scan(*args, plan)
            entry = {"case": label, "block_lanes": lanes,
                     "shape": sk.scan_launch_shape(w, plan.N)._asdict(),
                     "bits_equal_first": dig == first,
                     "device_ms": device_ms(run, "etd2rk_scan_kernel", 5), "ms": cuda_ms(run, 10)}
            report["scan"].append(entry)
            log(json.dumps(entry))
        sk._BLOCK_LANES = saved
    return report


def ab(parent: Path, rk45: bool, repeats: int) -> dict:
    """parent, change, change, parent: one process each."""
    trees = [("parent", parent.resolve()), ("change", HERE), ("change", HERE),
             ("parent", parent.resolve())]
    arms = []
    for name, root in trees:
        cmd = [sys.executable, str(Path(__file__).resolve()), "arm", "--repeats",
               str(repeats)] + (["--rk45"] if rk45 else [])
        env = dict(os.environ, PYTHONPATH=str(root))
        done = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=1500)
        if done.returncode != 0:
            raise RuntimeError(f"{name} arm failed:\n{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
        res = json.loads(done.stdout.strip().splitlines()[-1])
        res["tree"] = name
        arms.append(res)
        log(json.dumps(res))
    same = {}
    for kind in ("tables", "scan"):
        for label in arms[0][kind]:
            d = [a[kind][label]["digest"] for a in arms]
            same[f"{kind} {label}"] = {"bits_equal": d[0][0] == d[1][0],
                                       "values_equal": d[0][1] == d[1][1],
                                       "each_tree_repeats": d[0] == d[3] and d[1] == d[2]}
    return {"arms": arms, "parent_vs_change": same}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("tune", "ab", "arm"))
    ap.add_argument("parent", nargs="?", type=Path)
    ap.add_argument("--rk45", action="store_true")
    ap.add_argument("--repeats", type=int, default=1,
                    help="measurements of each ETD2RK rate in an arm")
    opts = ap.parse_args()
    if opts.mode != "arm":                 # an arm imports the tree on its PYTHONPATH
        sys.path.insert(0, str(HERE))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if opts.mode == "arm":
        print(json.dumps(arm(opts.rk45, opts.repeats)))
        return 0
    log(smi)
    if opts.mode == "tune":
        out = tune()
    else:
        if opts.parent is None:
            ap.error("ab needs PARENT_DIR")
        out = ab(opts.parent, opts.rk45, opts.repeats)
    print(json.dumps({"card": smi, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
