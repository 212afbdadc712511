"""State-dependent functional-influence networks of a fitted global model.

Counterpart of ``phoskintime_tpu/analysis/influence.py``: one
per-candidate exponential simulation gives the state at every sweep time;
the edge tables at all times come from dense masked einsums over the padded
topology (kinase -> site phospho flux, TF -> target synthesis drive); a
seed's influence cascade is a breadth-first walk over one snapshot; the
sweep is also written as a time-slider network in one HTML file
(:func:`write_influence_html`). The global knockout explorer
(:func:`export_global_knockout_explorer`) zeroes each kinase in turn and
simulates every scenario and the wild type as one batched ETD2RK call on
the system's device (on the card: one ``phi_tables`` launch a width class).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from phoskintime_tpu_torch.io.export import sort_desc
from phoskintime_tpu_torch.io.utils import host, take, write_csv

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
    """The influence analysis: ``influence_sweep.csv``, a
    ``cascade_<seed>.csv`` for each seed (default: the first two kinases)
    at the last sweep time (default times: every len(grid)//8-th kinase
    grid time) and the time-slider ``influence_network.html``. Returns the
    paths ({"sweep_csv", "cascades", "html"})."""
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
    out["html"] = write_influence_html(os.path.join(out_dir, "influence_network.html"), edges,
                                       kinases=set(topo.kinases))
    return out


_INFLUENCE_JS = """
'use strict';
var D = window.__INFLDATA__;
function el(tag, attrs) {
  var e = document.createElementNS('http://www.w3.org/2000/svg', tag);
  for (var k in (attrs || {})) e.setAttribute(k, attrs[k]);
  return e;
}
var svg = document.getElementById('infl-svg');
var W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
var layers = {};
D.nodes.forEach(function (n) {
  (layers[n.layer] = layers[n.layer] || []).push(n); });
Object.keys(layers).sort().forEach(function (ly, li, arr) {
  layers[ly].forEach(function (n, i) {
    n.x = 90 + (W - 220) * li / Math.max(1, arr.length - 1);
    n.y = 30 + (H - 60) * (i + 0.5) / layers[ly].length;
  });
});
var byId = {};
D.nodes.forEach(function (n) { byId[n.id] = n; });
var slider = document.getElementById('t-slider');
slider.max = D.times.length - 1;
function draw() {
  while (svg.firstChild) svg.removeChild(svg.firstChild);
  var fi = +slider.value;
  document.getElementById('t-label').textContent = D.times[fi];
  var fr = D.frames[fi];
  var wmax = fr.reduce(function (a, e) {
    return Math.max(a, Math.abs(e.w)); }, 1e-12);
  fr.forEach(function (e) {
    var a = byId[e.s], b = byId[e.t];
    if (!a || !b) return;
    var p = el('path', {
      d: 'M' + a.x + ',' + a.y + ' C' + ((a.x + b.x) / 2) + ',' + a.y + ' '
        + ((a.x + b.x) / 2) + ',' + b.y + ' ' + b.x + ',' + b.y,
      fill: 'none', stroke: e.k === 'tf' ? '#b07d2b' : '#1461d6',
      'stroke-opacity': 0.55,
      'stroke-width': (0.5 + 5.0 * Math.abs(e.w) / wmax).toFixed(2)});
    var ti = el('title');
    ti.textContent = e.s + ' -> ' + e.t + '  (' + e.k + ')  w='
      + e.w.toPrecision(4);
    p.appendChild(ti);
    svg.appendChild(p);
  });
  D.nodes.forEach(function (n) {
    svg.appendChild(el('circle', {cx: n.x, cy: n.y, r: 5,
      fill: n.layer === '0' ? '#1a1a2e' : '#1461d6',
      stroke: '#fff', 'stroke-width': 1}));
    var t = el('text', {x: n.x + 8, y: n.y + 3, 'font-size': 9,
      fill: '#333'});
    t.textContent = n.id;
    svg.appendChild(t);
  });
}
slider.addEventListener('input', draw);
draw();
"""


def write_influence_html(path, edges: dict, kinases=frozenset(),
                         max_edges_per_time: int = 150) -> str:
    """Time-slider network of an edge table (:func:`influence_edges_sweep`):
    the edges at each sweep time, the ``max_edges_per_time`` largest by
    |weight| (pandas' sort order, ties included), as a layered SVG (kinases
    left, proteins right) with widths scaled a frame, in one HTML file."""
    from phoskintime_tpu_torch.report.interactive import _CSS

    time_col = np.asarray(edges["time"], float)
    weight = np.asarray(edges["weight"], float)
    times = sorted(set(float(t) for t in time_col))
    frames = []
    nodes = set()
    for t in times:
        rows = np.flatnonzero(time_col == t)
        rows = rows[sort_desc(np.abs(weight[rows]))][:max_edges_per_time]
        fr = [{"s": str(edges["src"][r]),
               "t": str(edges["dst"][r]) + (f":{edges['site'][r]}" if edges["site"][r] else ""),
               "w": float(weight[r]), "k": str(edges["kind"][r])}
              for r in rows]
        frames.append(fr)
        for e in fr:
            nodes.add(e["s"])
            nodes.add(e["t"])
    node_list = [{"id": n, "layer": "0" if n in kinases else "1"}
                 for n in sorted(nodes)]
    data = {"times": times, "frames": frames, "nodes": node_list}
    html = f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>Functional influence network</title><style>{_CSS}</style></head>
<body>
<header><h1>Functional influence over time</h1>
<div class="sub">edge width = |influence| at the selected time; blue =
phospho flux, amber = TF synthesis drive</div></header>
<div class="wrap"><div class="card">
<div class="row">t = <b id="t-label">-</b>
<input id="t-slider" type="range" min="0" value="0" style="flex:1"></div>
<svg id="infl-svg" width="1100" height="560"></svg>
</div></div>
<script>window.__INFLDATA__ = {json.dumps(data)};</script>
<script>{_INFLUENCE_JS}</script>
</body></html>
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


def knockout_scenarios(system, params, times=None) -> dict:
    """The global knockouts as one batched exponential (ETD2RK) simulation
    on the system's device: member 0 the wild type, member k+1 the network
    with kinase k's ``c_k`` zeroed, every other parameter broadcast to the
    K+1 members. Returns {"times", "curve_names", "est" (C, T), "ko_est"
    (K, C, T)}: fold changes as float64 numpy, curves a protein's protein
    and mRNA then its sites (``"P (protein)"``, ``"P (mRNA)"``,
    ``"P:site"``)."""
    from phoskintime_tpu_torch.network.expo import exponential_simulate_batched
    from phoskintime_tpu_torch.network.simulate import extract_observables, fold_changes

    topo = system.topo
    times = np.asarray(system.kin_grid if times is None else times, float)
    K = topo.K
    f = dict(dtype=system.rhs.Kmat.dtype, device=system.device)
    params = {k: torch.as_tensor(v, **f) for k, v in params.items()}
    off = torch.cat([torch.ones(1, K, **f), 1.0 - torch.eye(K, **f)])       # (K+1, K)
    params_b = {k: (params["c_k"][None] * off if k == "c_k"
                    else v[None].expand(K + 1, *v.shape).clone())
                for k, v in params.items()}
    ys, _ = exponential_simulate_batched(system, params_b, times)
    fc_r, fc_p, fc_ph = (host(a) for a in fold_changes(extract_observables(system, ys), times))

    curve_names, rows_wt, rows_ko = [], [], []
    for i, p in enumerate(topo.proteins):
        curve_names.append(f"{p} (protein)")
        rows_wt.append(fc_p[0, :, i])
        rows_ko.append(fc_p[1:, :, i])
        curve_names.append(f"{p} (mRNA)")
        rows_wt.append(fc_r[0, :, i])
        rows_ko.append(fc_r[1:, :, i])
        for j, s in enumerate(topo.sites[i]):
            curve_names.append(f"{p}:{s}")
            rows_wt.append(fc_ph[0, :, i, j])
            rows_ko.append(fc_ph[1:, :, i, j])
    return {"times": times, "curve_names": curve_names, "est": np.stack(rows_wt),
            "ko_est": np.stack(rows_ko, axis=1)}


def export_global_knockout_explorer(system, params, out_path, times=None) -> str:
    """The interactive global-model knockout explorer: the scenarios of
    :func:`knockout_scenarios` (default times: the kinase grid) in the
    single-file explorer of
    :func:`~phoskintime_tpu_torch.report.interactive.write_interactive_explorer`
    (curve browser, before/after knockout overlays, the control network).
    Returns the path."""
    from phoskintime_tpu_torch.report.interactive import write_interactive_explorer

    topo = system.topo
    ko = knockout_scenarios(system, params, times)
    # the static control edges: kinase -> site, then TF -> target protein
    W = np.asarray(topo.W_pad, float)
    rows = []
    for i, p in enumerate(topo.proteins):
        for j, s in enumerate(topo.sites[i]):
            for k, kin in enumerate(topo.kinases):
                if W[i, j, k] > 0:
                    rows.append((kin, f"{p}:{s}", W[i, j, k]))
    tf_mat = np.asarray(topo.tf_mat, float)
    src_i, tgt_i = np.nonzero(tf_mat.T)
    for s_, i in zip(src_i, tgt_i):
        rows.append((topo.proteins[s_], f"{topo.proteins[i]} (protein)", tf_mat[i, s_]))
    edges = {"source": np.asarray([r[0] for r in rows], dtype=object),
             "target": np.asarray([r[1] for r in rows], dtype=object),
             "weight": np.asarray([r[2] for r in rows], float)}
    return write_interactive_explorer(
        out_path, title="global-model knockout explorer",
        times=ko["times"], curve_names=ko["curve_names"], obs=None, est=ko["est"],
        ko_names=[f"ΔKinase {k}" for k in topo.kinases], ko_est=ko["ko_est"],
        network_edges=edges, source_layer_names=set(topo.kinases))
