"""Time the table and scan kernels of the PyTorch/CUDA port on the card, and
hold two checkouts of the port against each other on one card.

    python tools/kernel_ab.py tune
    python tools/kernel_ab.py tune-scan-wide
    python tools/kernel_ab.py ab PARENT_DIR [--rk45] [--repeats N] [--rounds N] [--sections ...]
    python tools/kernel_ab.py ab PARENT_DIR --sections xwide
    python tools/kernel_ab.py ab PARENT_DIR --sections scan-wide

``tune`` sweeps the launch shape of ``csrc/phi_tables_wide.cu`` (rows a
thread owns, warps a block) at w = 9 and 17 (the model-2 bench chunk's own
class shapes) and w = 13 (compartmental blocks over as many lanes), and the
lanes a block of ``csrc/etd2rk_scan.cu`` on the model-0 and unbucketed
model-2 chunks: each candidate's device time by the profiler, its error
against the plain version, and whether its output equals the first
candidate's bit for bit. A candidate the library was not built for (the
source instantiates the chosen R of each width) is reported as such.

``tune-scan-wide`` times the wide scan kernel's launch choices (the TF
rows staged or not, the warps an SM it aims at and the widths from which a
lane's columns split over warps) on the ``scan-wide`` section's scans
(:func:`tune_scan_wide`).

``ab`` runs the same measurements (``arm``) in PARENT_DIR, this checkout,
this checkout and PARENT_DIR, one process each, in that order, ``--rounds``
times, on one card:
the kernels' device and event times at the main path's shapes (section
``wide``: the model-2 classes w = 9 and 17 and the unbucketed w = 17
tables; ``scan``: the model-0 and unbucketed model-2 scan chunks; ``phi``:
``csrc/phi_tables.cu`` at the model-0 chunk in float32 and float64 and at
the fit's chunk, ``build_demo_network(150, 24, seed=1)`` with 512 members;
``flux``: the edge flux at 92,160 x 16 in both types, with the wrapper's
host µs a call, and at smax 1-6, its device time on back-to-back calls and
with L2 flushed before each call; ``xwide``: ``csrc/phi_tables_xwide.cu`` at
chip_smoke.py phase 3h's classes, model 2 at 6 sites, w = 33 and 65, and
model 0 with a 20-site protein, w = 22, float32 and float64, beside
``torch.linalg.matrix_exp`` on the same tables' augmented matrices; the
inputs are made once, by this checkout, and every arm reads them from
one file; ``scan-wide``: ``csrc/etd2rk_scan.cu`` past the template kernel's
domain on the objective's own scans at chip_smoke.py phase 3i's networks,
w = 22, 65, 129 and N = 285, 2,048 members in float32 and 256 in float64:
the networks are built once, by this checkout, every arm reads them from
one file and assembles the scans' inputs with its own table kernel, and
each arm's inputs carry a checksum, equal across arms), a digest of each
output, and the
end-to-end rates that ``chip_smoke.py`` prints (section ``rates``: model
0 eager at pop 8192, model 2 bucketed at pop 2048, both through the scan
kernel; with ``--rk45`` also the RK45 model-2 objective at pop 2048;
``--repeats`` measurements of each ETD2RK rate). It prints each arm's
numbers, whether the outputs of the two trees are equal bit for bit,
and equal in value (-0 and +0 taken as equal), and each tree's median,
least and most of every time over its arms.

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


def device_ms(fn, name_part: str, reps: int, before=None) -> float | None:
    """Mean device duration (ms) of the kernels whose name holds
    ``name_part`` over ``reps`` calls under torch.profiler, each call after
    ``before()`` where one is given; None where the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
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


def bundles(models=(0, 2)):
    """The bench networks (model 0 and 2, N = 45) and their populations, as
    chip_smoke.py makes them."""
    from phoskintime_tpu_torch.demo import build_demo_network

    out = {}
    for model, pop in ((0, POP), (2, POP2)):
        if model not in models:
            continue
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


def host_us(fn, n: int = 1000) -> dict:
    """Per call of ``fn``: the host's µs to issue ``n`` back-to-back calls
    without a synchronize, the wall µs once one synchronize ends them, and
    the µs by CUDA events over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"host_us": 1e6 * (t1 - t0) / n, "wall_us": 1e6 * (t2 - t0) / n,
            "events_us": 1e3 * cuda_ms(fn, n)}


def phi_cases(bs) -> dict:
    """{label: (L, binv, h_u, ladder)}: ``csrc/phi_tables.cu``'s inputs at the
    model-0 chunk in float32 and float64, and at the fit's chunk
    (``build_demo_network(150, 24, seed=1)``, 512 members)."""
    from phoskintime_tpu_torch.demo import build_demo_network
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params

    b, th = bs[0]
    (L, *rest), = expo.table_inputs(b["system"], unpack_params(th[:CHUNK], b["slices"], b["topo"]),
                                    b["grid"])
    ns = build_demo_network(150, 24, seed=1, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    th_ns = torch.as_tensor(ns["theta0"][None] + 0.05 * rng.normal(size=(512, len(ns["theta0"]))),
                            dtype=torch.float32, device="cuda")
    fit, = expo.table_inputs(ns["system"], unpack_params(th_ns, ns["slices"], ns["topo"]),
                             ns["grid"])
    return {"model-0 chunk f32": (L, *rest), "model-0 chunk f64": (L.double(), *rest),
            "fit chunk f32": fit}


def flux_cases() -> dict:
    """{label: (X, S, E, smax)}: the edge flux at the RK45 objective's shape
    (pop 2048 x 45 proteins, 16 states) and at smax 1-6 over as many rows,
    float32 and float64, as chip_smoke.py phase 3d draws them."""
    rows, out = POP2 * 45, {}
    for smax in (4, 1, 2, 3, 5, 6):
        for dtype in (torch.float32, torch.float64):
            rng = np.random.default_rng(rows + smax)
            f = dict(dtype=dtype, device="cuda")
            out[f"{rows}x{1 << smax} {str(dtype)[-7:]}"] = (
                torch.as_tensor(rng.uniform(0, 1, (rows, 1 << smax)), **f),
                torch.as_tensor(rng.uniform(0.1, 2.0, (rows, smax)), **f),
                torch.as_tensor(rng.uniform(0.1, 2.0, rows), **f), smax)
    return out


def xwide_inputs(path: Path) -> Path:
    """Write the ``xwide`` section's inputs to ``path``: chip_smoke.py 3h's
    networks of XWIDE_AB_NETWORKS at float32 and float64 on the card, the
    first objective chunk of its members, and of each table build the
    classes wider than 17 as {label: (L, binv, h_u, ladder)}."""
    from phoskintime_tpu_torch.demo import build_demo_network
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.objective import _auto_pop_chunk
    from phoskintime_tpu_torch.network.params import unpack_params
    from smoke_cases import XWIDE_NETWORKS

    cases = {}
    for name in XWIDE_AB_NETWORKS:
        kw = XWIDE_NETWORKS[name]
        for dtype in (torch.float32, torch.float64):
            b = build_demo_network(**kw, dtype=dtype, device="cuda")
            rng = np.random.default_rng(0)
            th = b["theta0"][None] + 0.05 * rng.normal(size=(POP2, len(b["theta0"])))
            th = torch.as_tensor(th[:_auto_pop_chunk(b["topo"].N)], dtype=dtype, device="cuda")
            for L, binv, h_u, ladder in expo.table_inputs(
                    b["system"], unpack_params(th, b["slices"], b["topo"]), b["grid"]):
                if L.shape[1] > 17:
                    label = f"{name} w={L.shape[1]} {str(dtype)[-7:]}"
                    cases[label] = (L.cpu(), np.asarray(binv), np.asarray(h_u), int(ladder))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(cases, path)
    return path


def scan_wide_inputs(path: Path) -> Path:
    """Write the ``scan-wide`` section's networks to ``path``: chip_smoke.py
    3i's networks as host data (tools/smoke_cases.py: scan_wide_hosts)."""
    from smoke_cases import scan_wide_hosts

    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(scan_wide_hosts(), path)
    return path


def checksum(tensors) -> list:
    """Sums and sums of squares of each tensor at float64, in chunks of 2^26
    entries (E at w = 129 is 13 GB): equal across arms whose inputs are
    equal."""
    out = []
    for x in tensors:
        s1 = s2 = 0.0
        for part in x.reshape(-1).split(1 << 26):
            d = part.double()
            s1, s2 = s1 + float(d.sum()), s2 + float(d.square().sum())
        out.append([s1, s2])
    return out


SECTIONS = ("wide", "scan", "phi", "flux", "rates", "xwide", "scan-wide")
# the networks of chip_smoke.py's phase 3h (tools/smoke_cases.py) that the
# xwide section times: w = 33 and 65, and w = 22. The 7-site network's class
# w = 129 is left out on purpose: a checkout whose kernel stops at w = 65
# raises there, so the A/B could not hold it against such a parent
XWIDE_AB_NETWORKS = ("model2-6sites", "model0-20sites")


def arm(rk45: bool, repeats: int, sections=SECTIONS, inputs: Path | None = None,
        scan_inputs: Path | None = None) -> dict:
    """One tree's measurements (the tree whose package is imported);
    ``inputs``: the ``xwide`` section's file (:func:`xwide_inputs`), and
    ``scan_inputs`` the ``scan-wide`` section's (:func:`scan_wide_inputs`),
    each made here where none is given."""
    import phoskintime_tpu_torch
    from phoskintime_tpu_torch.ops import cuda_build
    from phoskintime_tpu_torch.ops.hypercube_flux import hypercube_flux
    from phoskintime_tpu_torch.ops.phi_tables import phi_tables
    from phoskintime_tpu_torch.ops.scan_kernel import etd2rk_scan
    from smoke_cases import augmented

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build_libraries()
    out = {"package": str(Path(phoskintime_tpu_torch.__file__).parent),
           "build_s": time.perf_counter() - t0, "tables": {}, "scan": {}, "phi": {},
           "flux": {}, "xwide": {}, "scan_wide": {}}
    bs = bundles(() if set(sections) <= {"flux", "xwide", "scan-wide"} else
                 (0,) if set(sections) <= {"phi", "flux", "xwide", "scan-wide"} else (0, 2))
    if "wide" in sections:
        for label, (L, binv, h_u, ladder) in table_cases(bs).items():
            run = lambda: phi_tables(L, binv, h_u, ladder)
            out["tables"][label] = {"ms": cuda_ms(run, 10),
                                    "device_ms": device_ms(run, "phi_tables_wide_kernel", 5),
                                    "digest": digests(run())}
    if "scan" in sections:
        for label, (args, plan) in scan_cases(bs).items():
            run = lambda: etd2rk_scan(*args, plan)
            out["scan"][label] = {"ms": cuda_ms(run, 10),
                                  "device_ms": device_ms(run, "etd2rk_scan_kernel", 5),
                                  "digest": digests((run(),))}
    if "phi" in sections:
        for label, (L, binv, h_u, ladder) in phi_cases(bs).items():
            run = lambda: phi_tables(L, binv, h_u, ladder)
            out["phi"][label] = {"ms": cuda_ms(run, 20),
                                 "device_ms": device_ms(run, "phi_tables_kernel", 10),
                                 "digest": digests(run())}
    if "flux" in sections:
        # read before each cold call: four times the L2, so that none of the
        # flux's data is left there, and no dirty line to write back
        flush = torch.zeros(torch.cuda.get_device_properties(0).L2_cache_size,
                            dtype=torch.float32, device="cuda")
        for label, (X, S, E, smax) in flux_cases().items():
            run = lambda: hypercube_flux(X, S, E, smax)
            out["flux"][label] = {"ms": cuda_ms(run, 50),
                                  "device_ms": device_ms(run, "hypercube_flux_kernel", 20),
                                  "device_ms_l2_flushed": device_ms(
                                      run, "hypercube_flux_kernel", 20, flush.sum),
                                  "digest": digests((run(),))}
            if smax == 4:
                out["flux"][label].update(host_us(run))
    if "xwide" in sections:
        path = inputs or xwide_inputs(HERE / "results_ab" / f"xwide_inputs_{os.getpid()}.pt")
        for label, (L, binv, h_u, ladder) in torch.load(path, weights_only=False).items():
            L = L.cuda()
            run = lambda: phi_tables(L, binv, h_u, ladder)
            M = augmented(L, binv, h_u)
            out["xwide"][label] = {"ms": cuda_ms(run, 5),
                                   "device_ms": device_ms(run, "phi_tables_xwide_kernel", 5),
                                   "matrix_exp_ms": cuda_ms(lambda: torch.linalg.matrix_exp(M), 3),
                                   "digest": digests(run())}
            del M
    if "scan-wide" in sections:
        from phoskintime_tpu_torch.ops.scan_kernel import scan_launch_shape
        from smoke_cases import SCAN_WIDE_NETWORKS, SCAN_WIDE_POP, scan_wide_args

        path = scan_inputs or scan_wide_inputs(
            HERE / "results_ab" / f"scan_wide_inputs_{os.getpid()}.pt")
        hosts = torch.load(path, weights_only=False)
        for dtype, name in itertools.product((torch.float32, torch.float64), SCAN_WIDE_NETWORKS):
            args, plan = scan_wide_args(hosts[name], dtype, SCAN_WIDE_POP[dtype])
            run = lambda: etd2rk_scan(*args, plan)
            w = args[0].shape[1]
            out["scan_wide"][f"{name} w={w} N={plan.N} {str(dtype)[-7:]}"] = {
                "ms": cuda_ms(run, 3), "device_ms": device_ms(run, "etd2rk_scan", 3),
                "shape": str(tuple(scan_launch_shape(w, plan.N, dtype.itemsize))),
                "inputs": checksum(args), "digest": digests((run(),))}
            del args, run
            torch.cuda.empty_cache()
    if "rates" in sections:
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
    """The sweep of the wide table and scan kernels' launch shapes; see the
    module note."""
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


def tune_scan_wide() -> dict:
    """The wide scan kernel's launch choices on the ``scan-wide`` section's
    scans (this checkout): each shape's device ms by its default shape, with
    the TF rows read from device memory (none staged), with the warps an SM
    aimed at 4, 6, 8 and 16 (a lane's column warps), with a lane's columns
    split from w = 65; each arm's error against the default's output."""
    from phoskintime_tpu_torch.ops import cuda_build, scan_kernel as sk
    from smoke_cases import SCAN_WIDE_NETWORKS, SCAN_WIDE_POP, scan_wide_args, scan_wide_hosts

    cuda_build.build_libraries()
    hosts = scan_wide_hosts()
    arms = {"default": {}, "tf_rows_unstaged": {"_tf_cap": lambda *a: 0},
            **{f"target_warps_{n}": {"_TARGET_WARPS": n} for n in (4, 6, 8, 16)},
            "columns_from_w65": {"_COLS_MIN_WIDTH": 65}}
    report = []
    for dtype, name in itertools.product((torch.float32, torch.float64), SCAN_WIDE_NETWORKS):
        args, plan = scan_wide_args(hosts[name], dtype, SCAN_WIDE_POP[dtype])
        w = args[0].shape[1]
        first = None
        for arm_name, patch in arms.items():
            saved = {k: getattr(sk, k) for k in patch}
            for k, v in patch.items():
                setattr(sk, k, v)
            try:
                shape = sk.scan_launch_shape(w, plan.N, dtype.itemsize)
                run = lambda: sk.etd2rk_scan(*args, plan)
                got = run()
                first = got if first is None else first
                entry = {"case": f"{name} w={w} N={plan.N} {str(dtype)[-7:]}", "arm": arm_name,
                         "shape": shape._asdict(), "device_ms": device_ms(run, "etd2rk_scan", 3),
                         "max_scaled_err_vs_default": scaled_err((got,), (first,))}
            finally:
                for k, v in saved.items():
                    setattr(sk, k, v)
            report.append(entry)
            log(json.dumps(entry))
        del args, first, got
        torch.cuda.empty_cache()
    return {"scan_wide": report}


def spread(arms, tree: str, kind: str) -> dict:
    """{label: {key: (median, least, most)}} of ``tree``'s arms' times in
    section ``kind``."""
    mine = [a[kind] for a in arms if a["tree"] == tree]
    out = {}
    for label in mine[0]:
        for key, v in mine[0][label].items():
            if key != "digest" and isinstance(v, (int, float)):
                xs = [m[label][key] for m in mine if m[label][key] is not None]
                out.setdefault(label, {})[key] = (float(np.median(xs)), min(xs), max(xs))
    return out


def ab(parent: Path, rk45: bool, repeats: int, sections=SECTIONS, rounds: int = 1) -> dict:
    """parent, change, change, parent, ``rounds`` times: one process each."""
    trees = [("parent", parent.resolve()), ("change", HERE), ("change", HERE),
             ("parent", parent.resolve())] * rounds
    extra = []
    if "xwide" in sections:                # one set of inputs for every arm
        path = xwide_inputs(HERE / "results_ab" / "xwide_inputs.pt")
        extra = ["--xwide-inputs", str(path)]
    if "scan-wide" in sections:
        extra += ["--scan-wide-inputs",
                  str(scan_wide_inputs(HERE / "results_ab" / "scan_wide_inputs.pt"))]
    arms = []
    for name, root in trees:
        cmd = [sys.executable, str(Path(__file__).resolve()), "arm", "--repeats",
               str(repeats), "--sections", ",".join(sections)] + (["--rk45"] if rk45 else []) \
            + extra
        env = dict(os.environ, PYTHONPATH=str(root))
        done = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=1500)
        if done.returncode != 0:
            raise RuntimeError(f"{name} arm failed:\n{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
        res = json.loads(done.stdout.strip().splitlines()[-1])
        res["tree"] = name
        arms.append(res)
        log(json.dumps(res))
    same, spreads = {}, {}
    for kind in ("tables", "scan", "phi", "flux", "xwide", "scan_wide"):
        for label in arms[0][kind]:
            d = {name: [a[kind][label]["digest"] for a in arms if a["tree"] == name]
                 for name in ("parent", "change")}
            same[f"{kind} {label}"] = {
                "bits_equal": d["parent"][0][0] == d["change"][0][0],
                "values_equal": d["parent"][0][1] == d["change"][0][1],
                "each_tree_repeats": all(x == v[0] for v in d.values() for x in v)}
            if kind == "scan_wide":
                sums = [a[kind][label]["inputs"] for a in arms]
                same[f"{kind} {label}"]["inputs_equal"] = all(x == sums[0] for x in sums)
        if arms[0][kind]:
            spreads[kind] = {name: spread(arms, name, kind) for name in ("parent", "change")}
    return {"arms": arms, "parent_vs_change": same, "median_least_most": spreads}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("tune", "tune-scan-wide", "ab", "arm"))
    ap.add_argument("parent", nargs="?", type=Path)
    ap.add_argument("--rk45", action="store_true")
    ap.add_argument("--repeats", type=int, default=1,
                    help="measurements of each ETD2RK rate in an arm")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times ab runs parent, change, change, parent")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated parts of an arm: " + ", ".join(SECTIONS))
    ap.add_argument("--xwide-inputs", type=Path, default=None,
                    help="the xwide section's inputs (made by ab; an arm alone makes its own)")
    ap.add_argument("--scan-wide-inputs", type=Path, default=None,
                    help="the scan-wide section's networks (made by ab; an arm alone makes its "
                         "own)")
    opts = ap.parse_args()
    sections = tuple(opts.sections.split(","))
    if not set(sections) <= set(SECTIONS):
        ap.error(f"--sections takes {', '.join(SECTIONS)}")
    if opts.mode != "arm":                 # an arm imports the tree on its PYTHONPATH
        sys.path.insert(0, str(HERE))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if opts.mode == "arm":
        print(json.dumps(arm(opts.rk45, opts.repeats, sections, opts.xwide_inputs,
                             opts.scan_wide_inputs)))
        return 0
    log(smi)
    if opts.mode == "tune":
        out = tune()
    elif opts.mode == "tune-scan-wide":
        out = tune_scan_wide()
    else:
        if opts.parent is None:
            ap.error("ab needs PARENT_DIR")
        out = ab(opts.parent, opts.rk45, opts.repeats, sections, opts.rounds)
    print(json.dumps({"card": smi, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
