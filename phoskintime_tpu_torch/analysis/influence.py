"""State-dependent functional-influence networks of a fitted global model.

Counterpart of ``phoskintime_tpu/analysis/influence.py``, tables only: one
per-candidate exponential simulation gives the state at every sweep time;
the edge tables at all times come from dense masked einsums over the padded
topology (kinase -> site phospho flux, TF -> target synthesis drive); a
seed's influence cascade is a breadth-first walk over one snapshot. The
time-slider HTML (:func:`write_influence_html`) and the global knockout
explorer (:func:`export_global_knockout_explorer`) are not ported yet and
raise naming ROADMAP.md item 8d.
"""

from __future__ import annotations

import os

import numpy as np

from phoskintime_tpu_torch.io.export import figures_pending, host
from phoskintime_tpu_torch.io.utils import take, write_csv

EDGE_COLUMNS = ["time", "kind", "src", "dst", "site", "weight"]


def state_sweep(system, params, times):
    """One member simulated once by the per-candidate exponential
    integrator: (times, Y (T, N, width)) as float64 numpy."""
    from phoskintime_tpu_torch.network.expo import exponential_simulate

    times = np.asarray(times, float)
    res = exponential_simulate(system, {k: v[None] for k, v in params.items()}, times)
    N, w = system.topo.N, system.topo.width
    return times, host(res.ys[0]).reshape(len(times), N, w)


def influence_edges_sweep(system, params, times, Y_sweep) -> dict:
    """The edge tables at every sweep time, as one tidy table (time, kind,
    src, dst, site, weight). ``phospho``: kinase k -> (protein i, site j)
    with weight W[i,j,k] K_k(t) c_k P0_i(t), the phospho flux into the
    site; ``tf``: TF src -> target i with tf_mat[i, src] P_src(t) /
    tf_deg_i, the synthesis drive before squashing."""
    topo = system.topo
    Kmat = np.asarray(system.Kmat, float)
    grid = np.asarray(system.kin_grid, float)
    ck = host(params["c_k"])
    W = np.asarray(topo.W_pad, float)
    tf_mat = np.asarray(topo.tf_mat, float)
    tf_deg = np.asarray(topo.tf_deg, float)
    smask = np.asarray(topo.site_mask(), bool)

    times = np.asarray(times, float)
    jb = np.clip(np.searchsorted(grid, times, side="right") - 1, 0, Kmat.shape[1] - 1)
    Kt = Kmat[:, jb] * ck[:, None]
    if topo.model == 2:
        P0 = (Y_sweep[:, :, 1:] * np.asarray(topo.state_mask(), float)[None]).sum(-1)
        tot = P0
    else:
        P0 = Y_sweep[:, :, 1]
        tot = P0 + (Y_sweep[:, :, 2:] * smask[None]).sum(-1)
    flux = np.einsum("nsk,kt,tn->tnsk", W, Kt, P0)
    drv = np.asarray(topo.driver_map)
    P_vec = tot.copy()
    driven = drv >= 0
    P_vec[:, driven] = Kt[drv[driven], :].T
    tf_drive = tf_mat[None] * P_vec[:, None, :] / tf_deg[None, :, None]

    rows = []
    src_idx, tgt_idx = np.nonzero(tf_mat.T)
    for t_i, t in enumerate(times):
        for i, prot in enumerate(topo.proteins):
            for j, site in enumerate(topo.sites[i]):
                for k, kin in enumerate(topo.kinases):
                    wgt = flux[t_i, i, j, k]
                    if wgt > 0:
                        rows.append((t, "phospho", kin, prot, site, wgt))
        for s, i in zip(src_idx, tgt_idx):
            wgt = tf_drive[t_i, i, s]
            if wgt != 0:
                rows.append((t, "tf", topo.proteins[s], topo.proteins[i], "", wgt))
    return {c: (np.asarray([r[k] for r in rows], float) if c in ("time", "weight")
                else np.asarray([r[k] for r in rows], dtype=object))
            for k, c in enumerate(EDGE_COLUMNS)}


def cascade_from_seed(edges: dict, seed: str, depth: int = 3,
                      rel_threshold: float = 0.05) -> dict:
    """A breadth-first influence cascade from ``seed`` over one snapshot's
    edges: an edge's influence is its weight over the largest |weight| at
    its source, a path keeps the product, and edges below
    ``rel_threshold`` are pruned. Returns (src, dst, site, kind, weight,
    influence, depth)."""
    src = np.asarray(edges["src"], dtype=object)
    weight = np.asarray(edges["weight"], float)
    scale = {s: max(float(np.abs(weight[src == s]).max()), 1e-12) for s in set(src.tolist())}
    rel = np.asarray([w / scale[s] for s, w in zip(src, weight)], float)
    out = []
    frontier = {str(seed): 1.0}
    seen = {str(seed)}
    for d in range(1, depth + 1):
        nxt: dict[str, float] = {}
        for s, infl in frontier.items():
            for r in np.flatnonzero(src == s):
                f = infl * abs(float(rel[r]))
                if f < rel_threshold:
                    continue
                dst = edges["dst"][r]
                out.append((s, dst, edges["site"][r], edges["kind"][r], float(weight[r]), f, d))
                if dst not in seen:
                    nxt[dst] = max(nxt.get(dst, 0.0), f)
        seen |= set(nxt)
        frontier = nxt
        if not frontier:
            break
    cols = ["src", "dst", "site", "kind", "weight", "influence", "depth"]
    return {c: (np.asarray([r[k] for r in out], np.int64) if c == "depth"
                else np.asarray([r[k] for r in out], float) if c in ("weight", "influence")
                else np.asarray([r[k] for r in out], dtype=object))
            for k, c in enumerate(cols)}


def export_influence_sweep(system, params, out_dir, times=None, seeds=None,
                           depth: int = 3) -> dict:
    """The influence analysis as tables: ``influence_sweep.csv`` and a
    ``cascade_<seed>.csv`` for each seed (default: the first two kinases)
    at the last sweep time (default times: every len(grid)//8-th kinase
    grid time). The time-slider HTML waits for item 8d. Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    topo = system.topo
    if times is None:
        g = np.asarray(system.kin_grid, float)
        times = g[:: max(1, len(g) // 8)]
    times, Y = state_sweep(system, params, times)
    edges = influence_edges_sweep(system, params, times, Y)
    out = {"sweep_csv": write_csv(os.path.join(out_dir, "influence_sweep.csv"), edges),
           "cascades": {}}
    snap = take(edges, np.asarray(edges["time"], float) == float(times[-1]))
    for seed in (list(topo.kinases[:2]) if seeds is None else seeds):
        out["cascades"][seed] = write_csv(os.path.join(out_dir, f"cascade_{seed}.csv"),
                                          cascade_from_seed(snap, seed, depth=depth))
    return out


write_influence_html = figures_pending
export_global_knockout_explorer = figures_pending
