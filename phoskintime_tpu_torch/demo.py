"""Synthetic demo/benchmark network without pandas.

Counterpart of ``phoskintime_tpu/demo.py::build_demo_network``. The same
numpy ``default_rng`` draws in the same order give the same topology,
kinase input, true parameters and raw packing as the JAX package, for
every mechanism (0, 1, 2 and 4). The synthetic observations are
the fold changes at the true parameters, as the JAX package's
``simulate_and_measure`` makes them: RK45 (``rtol=1e-5``, ``atol=1e-7``,
``max_steps=5000``, ``dt_max=16``) at the bundle's dtype on the CPU, over
the union of ``GRID`` and ``RNA_GRID``, whatever device the bundle's
system is made for.
"""

from __future__ import annotations

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import (DEFAULT_DEVICE, numpy_dtype,
                                                   resolve_device)
from phoskintime_tpu_torch.network.kinase_input import build_kinase_matrix
from phoskintime_tpu_torch.network.lossdata import prepare_loss_data
from phoskintime_tpu_torch.network.params import init_raw_params
from phoskintime_tpu_torch.network.simulate import (extract_observables, fold_changes,
                                                    simulate)
from phoskintime_tpu_torch.network.system import GlobalSystem, default_params
from phoskintime_tpu_torch.network.topology import build_topology

GRID = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0,
                 120.0, 240.0, 480.0, 960.0])
RNA_GRID = np.array([4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 240.0, 480.0, 960.0])
BOUNDS = {"c_k": (1e-3, 4.0), "A_i": (1e-3, 4.0), "B_i": (1e-3, 4.0),
          "C_i": (1e-3, 4.0), "D_i": (1e-3, 4.0), "Dp_i": (0.05, 5.0),
          "E_i": (1e-4, 4.0), "tf_scale": (0.5, 6.0)}


def _observations(system_cpu, true, topo, times):
    """Column tables (protein, RNA, phospho) of fold changes at ``true``,
    sliced to the modality grids, gene-major then site then time."""
    res = simulate(system_cpu, true, times, rtol=1e-5, atol=1e-7, max_steps=5000)
    if not bool(res.success):
        raise RuntimeError("RK45 failed at the demo's true parameters")
    fc_r, fc_p, fc_ph = (x.numpy() for x in fold_changes(
        extract_observables(system_cpu, res.ys), times))
    on_p = np.isin(times, GRID)
    on_r = np.isin(times, RNA_GRID)
    prot = {"protein": [], "time": [], "fc": []}
    rna = {"protein": [], "time": [], "fc": []}
    pho = {"protein": [], "psite": [], "time": [], "fc": []}
    for i, gene in enumerate(topo.proteins):
        for cols, fc, on in ((prot, fc_p, on_p), (rna, fc_r, on_r)):
            cols["protein"] += [gene] * int(on.sum())
            cols["time"] += list(times[on])
            cols["fc"] += list(fc[on, i])
        for j, psite in enumerate(topo.sites[i]):
            pho["protein"] += [gene] * int(on_p.sum())
            pho["psite"] += [psite] * int(on_p.sum())
            pho["time"] += list(times[on_p])
            pho["fc"] += list(fc_ph[on_p, i, j])
    return prot, rna, pho


def build_demo_network(n_proteins: int = 40, n_kinases: int = 12,
                       max_sites: int = 4, model: int = 0, seed: int = 0,
                       dtype: torch.dtype = torch.float32, device=DEFAULT_DEVICE):
    """Deterministic synthetic network + data as a dict bundle; the system
    is made at ``dtype`` on ``device`` (default: the card; raises where
    there is none), host data stays numpy. ``df_prot``, ``df_rna`` and
    ``df_pho`` are the observation tables as column dicts (``protein``,
    ``psite``, ``time``, ``fc``), where the JAX package has DataFrames."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    proteins = [f"P{i:03d}" for i in range(n_proteins)]
    kinases = [f"K{i:02d}" for i in range(n_kinases)]

    rows = []
    for p in proteins[: int(n_proteins * 0.8)]:  # 80% of proteins have sites
        ns = int(rng.integers(1, max_sites + 1))
        for s in range(ns):
            rows.append((p, f"S{10 * (s + 1)}", kinases[int(rng.integers(n_kinases))]))
    # kinases are proteins too (self-signaling rows like the real data)
    for k in kinases[: n_kinases // 2]:
        rows.append((k, "S99", kinases[int(rng.integers(n_kinases))]))

    tf_rows = []
    regs = rng.choice(proteins, size=max(2, n_proteins // 5), replace=False)
    for tf in regs:
        for tgt in rng.choice(proteins, size=3, replace=False):
            if tgt != tf:
                tf_rows.append((str(tf), str(tgt)))

    topo = build_topology(rows, tf_rows, model=model)
    Kmat = build_kinase_matrix(topo.kinases, None, GRID)
    Kmat = Kmat * (1.0 + 0.3 * np.abs(np.sin(
        rng.uniform(0, 3, (topo.K, 1)) + 0.05 * GRID[None, :])))

    np_dt = numpy_dtype(dtype)
    true = default_params(topo, np.float64)
    for k in ["c_k", "A_i", "B_i", "C_i", "D_i", "E_i"]:
        true[k] = rng.uniform(0.05, 0.8, true[k].shape)
    true["Dp_i"] = rng.uniform(0.2, 2.0, true["Dp_i"].shape) * topo.site_mask()
    true["tf_scale"] = 2.0
    true = {k: np.asarray(v, np_dt) for k, v in true.items()}

    grid = np.unique(np.concatenate([GRID, RNA_GRID]))
    system_cpu = GlobalSystem(topo, GRID, Kmat, dtype=dtype, device="cpu")
    prot, rna, pho = _observations(system_cpu, true, topo, grid)
    loss_data = prepare_loss_data(topo, prot, rna, pho, grid)
    defaults = default_params(topo, np_dt)
    theta0, slices, xl, xu = init_raw_params(defaults, topo, BOUNDS)
    theta_true, _, _, _ = init_raw_params(true, topo, BOUNDS)

    return dict(system=GlobalSystem(topo, GRID, Kmat, dtype=dtype, device=device),
                topo=topo, true=true, df_prot=prot, df_rna=rna, df_pho=pho,
                loss_data=loss_data, grid=grid,
                defaults=defaults, theta0=np.asarray(theta0, np_dt),
                theta_true=np.asarray(theta_true, float),
                slices=slices, xl=xl, xu=xu,
                lambdas={"protein": 1.0, "rna": 1.0, "phospho": 1.0,
                         "prior": 0.1})
