"""Inputs of the table and scan kernels that ``chip_smoke.py`` and the tools
share: phase 3h's networks, whose width classes pass w = 17, the augmented
matrices of the ``torch.linalg.matrix_exp`` yardstick, and phase 3i's
networks with the scan kernel's arguments at their members. Imports numpy
and torch only at the top (the package inside the functions that need
it), so that a tool can take it whichever checkout's package it times."""

from __future__ import annotations

import numpy as np
import torch

# model 2 at mechanisms' default cap of 6 sites (width classes 2, 3, 33, 65),
# model 0 with a protein of 20 sites (w = 22), model 2 with a protein of 7
# sites (classes 2, 3, 5, 129) and model 2 with a protein of 8 sites (five
# proteins, classes 2, 3, 9, 257: the stream table kernel's), each cut to a
# few proteins: build_demo_network's arguments
XWIDE_NETWORKS = {"model2-6sites": dict(n_proteins=6, n_kinases=3, max_sites=6, model=2, seed=0),
                  "model0-20sites": dict(n_proteins=5, n_kinases=3, max_sites=20, model=0,
                                         seed=5),
                  "model2-7sites": dict(n_proteins=6, n_kinases=3, max_sites=7, model=2,
                                        seed=20),
                  "model2-8sites": dict(n_proteins=4, n_kinases=3, max_sites=8, model=2,
                                        seed=7)}
# the network past w = 129: chip_smoke.py's phase 3j takes it (off the main
# lane), phases 3h and 3i the others
STREAM_NETWORK = "model2-8sites"


def hypercube_blocks(rng, Bu, sites, B) -> np.ndarray:
    """(Bu, w, w, B) blocks shaped like model 2's at ``sites`` sites (w =
    2^sites + 1): state 0 feeds state 1, and each phospho-state passes to
    the states one site away (a phosphorylation one way, a
    dephosphorylation back); rates uniform on (0, 2), each column's outflow
    plus its own decay on the diagonal."""
    w = 2 ** sites + 1
    L = np.zeros((Bu, w, w, B))
    L[:, 1, 0] = rng.uniform(0.0, 2.0, (Bu, B))
    for m in range(2 ** sites):
        for b in range(sites):
            L[:, 1 + (m ^ (1 << b)), 1 + m] = rng.uniform(0.0, 2.0, (Bu, B))
    d = np.arange(w)
    L[:, d, d, :] = -(L.sum(axis=1) + rng.uniform(0.01, 4.0, (Bu, w, B)))
    return L


def augmented(L, binv, h_u) -> torch.Tensor:
    """(U*B, w+2, w+2) matrices [[L h, e0, 0], [0, 0, 1], [0, 0, 0]] whose
    exponential holds E, phi1(L h) e0 and phi2(L h) e0: the input of the
    library yardstick ``torch.linalg.matrix_exp``."""
    U, w, B = len(binv), L.shape[1], L.shape[3]
    h = torch.as_tensor(np.asarray(h_u), dtype=L.dtype, device=L.device)
    M = L.new_zeros((U, B, w + 2, w + 2))
    M[:, :, :w, :w] = (L[torch.as_tensor(np.asarray(binv, np.int64), device=L.device)]
                       * h[:, None, None, None]).permute(0, 3, 1, 2)
    M[:, :, 0, w] = 1.0
    M[:, :, w, w + 1] = 1.0
    return M.reshape(U * B, w + 2, w + 2)


# phase 3i's networks, the wide scan kernel's shapes on the objective's own
# plans: the first three above unbucketed (w = 22, 65, 129) and the 300-protein
# demo (N = 285, w = 6); their members by type
SCAN_WIDE_NETWORKS = {**{k: v for k, v in XWIDE_NETWORKS.items() if k != STREAM_NETWORK},
                      "demo300-N285": dict(n_proteins=300, n_kinases=24, seed=1)}
SCAN_WIDE_POP = {torch.float32: 2048, torch.float64: 256}


def members(theta0, pop: int) -> np.ndarray:
    """theta0 plus seeded noise, as bench.py and benchmarks/model_rates.py."""
    rng = np.random.default_rng(0)
    return theta0[None] + 0.05 * rng.normal(size=(pop, len(theta0)))


def scan_wide_host(name: str) -> dict:
    """The network ``name`` of SCAN_WIDE_NETWORKS, built on the CPU at
    float32, as host data: its topology, kinase grid and matrix, time grid,
    theta0 and parameter slices (what a scan of its members needs on either
    device and in either type)."""
    from phoskintime_tpu_torch.demo import build_demo_network

    torch.set_num_threads(1)
    b = build_demo_network(**SCAN_WIDE_NETWORKS[name], dtype=torch.float32, device="cpu")
    s = b["system"]
    return {"topo": s.topo, "kin_grid": s.kin_grid, "Kmat": s.Kmat, "grid": b["grid"],
            "slices": b["slices"], "theta0": b["theta0"]}


def scan_wide_hosts(names=tuple(SCAN_WIDE_NETWORKS)) -> dict:
    """{name: :func:`scan_wide_host`}, each built in its own spawned worker,
    all at once (their observations come from RK45 on the CPU: ~10-25 s
    each)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    with ProcessPoolExecutor(max_workers=len(names), mp_context=get_context("spawn")) as pool:
        futures = {name: pool.submit(scan_wide_host, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def scan_wide_args(host: dict, dtype, pop: int, device="cuda") -> tuple:
    """(args, plan) of ``etd2rk_scan`` for the first ``pop`` of
    :func:`members` of ``host``'s network at ``dtype`` on ``device``: the
    objective's unbucketed scan (``expo.ScanSetup``) with its tables."""
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params
    from phoskintime_tpu_torch.network.system import GlobalSystem

    system = GlobalSystem(host["topo"], host["kin_grid"], host["Kmat"], dtype=dtype,
                          device=device)
    thetas = torch.as_tensor(members(host["theta0"], max(SCAN_WIDE_POP.values()))[:pop],
                             dtype=dtype, device=device)
    scan = expo.ScanSetup(system, unpack_params(thetas, host["slices"], host["topo"]),
                          host["grid"], width_bucketing=False)
    return scan.kernel_args(), scan.plan
