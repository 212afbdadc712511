"""Self-contained interactive HTML explorers: fits and knockouts, and the
global model's Pareto front.

Counterpart of ``phoskintime_tpu/report/interactive.py``, with the same
templates, CSS and JS: each explorer is ONE static HTML file whose data is
embedded as JSON, drawn by a small vanilla-JS layer (SVG time series, a
knockout browser over exact re-predictions computed by the caller, a
layered network view, an objective-pair scatter whose members open their
curves). Works from ``file://``, with no server. Inputs are numpy arrays or
tensors (brought to the host as float64 before any rounding) and column
tables (:mod:`phoskintime_tpu_torch.io.utils`) where the JAX package takes
DataFrames.
"""

from __future__ import annotations

import json
import os

import numpy as np

from phoskintime_tpu_torch.io.utils import host, is_missing, n_rows

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 0; background: #f6f7f9; color: #1a1a2e; }
header { background: #1a1a2e; color: #fff; padding: 14px 28px; }
header h1 { margin: 0; font-size: 19px; font-weight: 600; }
header .sub { color: #9aa3b2; font-size: 12px; margin-top: 3px; }
.wrap { max-width: 1180px; margin: 18px auto; padding: 0 16px; }
.card { background: #fff; border-radius: 10px; padding: 18px 20px;
        margin-bottom: 18px; box-shadow: 0 1px 4px rgba(16,24,40,.08); }
.card h2 { margin: 0 0 10px; font-size: 15px; }
.row { display: flex; gap: 14px; flex-wrap: wrap; align-items: center; }
select { padding: 6px 10px; border: 1px solid #cfd6e0; border-radius: 6px;
         font-size: 13px; background: #fff; max-width: 320px; }
.stat { display: inline-block; background: #eef2f7; border-radius: 8px;
        padding: 8px 14px; margin: 4px 6px 4px 0; font-size: 12px; }
.stat b { display: block; font-size: 16px; }
svg text { font-family: inherit; }
.legend { font-size: 12px; color: #444; margin-top: 4px; }
.legend span { margin-right: 16px; }
.dot { display: inline-block; width: 10px; height: 10px;
       border-radius: 5px; margin-right: 4px; vertical-align: -1px; }
table.ko { border-collapse: collapse; font-size: 12px; width: 100%; }
table.ko th, table.ko td { border-bottom: 1px solid #e6e9ef;
                           padding: 5px 8px; text-align: left; }
table.ko tr.sel { background: #eef6ff; }
table.ko tbody tr { cursor: pointer; }
.hint { color: #68728a; font-size: 12px; }
"""

_JS = """
'use strict';
var D = window.__FITDATA__;

function el(tag, attrs) {
  var e = document.createElementNS('http://www.w3.org/2000/svg', tag);
  for (var k in (attrs || {})) e.setAttribute(k, attrs[k]);
  return e;
}

function drawSeries(svg, times, series, opts) {
  // series: [{y: [...], color, width, dash, label, marker}]
  while (svg.firstChild) svg.removeChild(svg.firstChild);
  var W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
  var m = {l: 46, r: 12, t: 10, b: 26};
  var xs = times, lo = Infinity, hi = -Infinity;
  series.forEach(function (s) { s.y.forEach(function (v) {
    if (v < lo) lo = v; if (v > hi) hi = v; }); });
  if (!(lo < hi)) { lo -= 1; hi += 1; }
  var pad = (hi - lo) * 0.08; lo -= pad; hi += pad;
  var xmax = xs[xs.length - 1] || 1;
  var X = function (t) { return m.l + (W - m.l - m.r) * t / xmax; };
  var Y = function (v) { return H - m.b - (H - m.t - m.b) * (v - lo) / (hi - lo); };
  // axes
  svg.appendChild(el('line', {x1: m.l, y1: H - m.b, x2: W - m.r,
    y2: H - m.b, stroke: '#b9c0cc'}));
  svg.appendChild(el('line', {x1: m.l, y1: m.t, x2: m.l, y2: H - m.b,
    stroke: '#b9c0cc'}));
  for (var g = 0; g <= 4; g++) {
    var v = lo + (hi - lo) * g / 4, yy = Y(v);
    svg.appendChild(el('line', {x1: m.l, y1: yy, x2: W - m.r, y2: yy,
      stroke: '#edf0f4'}));
    var t = el('text', {x: m.l - 6, y: yy + 4, 'text-anchor': 'end',
      'font-size': 10, fill: '#68728a'});
    t.textContent = v.toPrecision(3); svg.appendChild(t);
  }
  xs.forEach(function (tv, i) {
    if (xs.length > 10 && i % 2) return;
    var t = el('text', {x: X(tv), y: H - m.b + 14, 'text-anchor': 'middle',
      'font-size': 10, fill: '#68728a'});
    t.textContent = tv; svg.appendChild(t);
  });
  series.forEach(function (s) {
    var d = s.y.map(function (v, i) {
      return (i ? 'L' : 'M') + X(xs[i]).toFixed(1) + ',' + Y(v).toFixed(1);
    }).join(' ');
    var p = el('path', {d: d, fill: 'none', stroke: s.color,
      'stroke-width': s.width || 2});
    if (s.dash) p.setAttribute('stroke-dasharray', s.dash);
    svg.appendChild(p);
    if (s.marker) s.y.forEach(function (v, i) {
      svg.appendChild(el('circle', {cx: X(xs[i]), cy: Y(v), r: 2.6,
        fill: s.color}));
    });
  });
}

// ---- curve explorer -------------------------------------------------------
var curveSel = document.getElementById('curve-select');
D.curves.forEach(function (c, i) {
  var o = document.createElement('option');
  o.value = i; o.textContent = c.name; curveSel.appendChild(o);
});
function showCurve() {
  var c = D.curves[+curveSel.value];
  var series = [];
  if (c.obs) series.push({y: c.obs, color: '#8d99ae', width: 1.5,
                          marker: true});
  series.push({y: c.est, color: '#1461d6', width: 2.2});
  drawSeries(document.getElementById('curve-svg'), D.times, series);
  if (c.obs) {
    var resid = c.est.map(function (v, i) { return v - c.obs[i]; });
    var rmse = Math.sqrt(resid.reduce(function (a, r) { return a + r * r; },
                                      0) / resid.length);
    document.getElementById('curve-rmse').textContent = rmse.toPrecision(4);
  } else {
    document.getElementById('curve-rmse').textContent = '-';
  }
}
curveSel.addEventListener('change', showCurve);

// ---- knockout simulator ---------------------------------------------------
var koSel = document.getElementById('ko-select');
D.knockouts.forEach(function (k, i) {
  var o = document.createElement('option');
  o.value = i; o.textContent = k.name; koSel.appendChild(o);
});
var koTargetIdx = 0;
function showKO() {
  var k = D.knockouts[+koSel.value];
  var tbody = document.getElementById('ko-tbody');
  tbody.innerHTML = '';
  k.top.forEach(function (t, row) {
    var tr = document.createElement('tr');
    if (row === koTargetIdx) tr.className = 'sel';
    tr.innerHTML = '<td>' + D.curves[t.c].name
      + (t.bad ? ' <span style="color:#d1342f">(diverged)</span>' : '')
      + '</td><td>' + t.d.toPrecision(4) + '</td>';
    tr.addEventListener('click', function () {
      koTargetIdx = row; showKO();
    });
    tbody.appendChild(tr);
  });
  var pick = k.top[Math.min(koTargetIdx, k.top.length - 1)];
  if (!pick) return;
  var c = D.curves[pick.c];
  var series = [];
  if (c.obs) series.push({y: c.obs, color: '#8d99ae', width: 1.2,
                          marker: true});
  series.push({y: c.est, color: '#1461d6', width: 2});
  series.push({y: pick.ko, color: '#d1342f', width: 2, dash: '6 4'});
  drawSeries(document.getElementById('ko-svg'), D.times, series);
  document.getElementById('ko-total').textContent =
    k.total.toPrecision(4);
}
koSel.addEventListener('change', function () { koTargetIdx = 0; showKO(); });

// ---- network view ---------------------------------------------------------
(function network() {
  var svg = document.getElementById('net-svg');
  var W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
  var nodes = D.network.nodes, edges = D.network.edges;
  var layers = {};
  nodes.forEach(function (n) {
    (layers[n.layer] = layers[n.layer] || []).push(n);
  });
  var L = Object.keys(layers).sort();
  L.forEach(function (ly, li) {
    layers[ly].forEach(function (n, i) {
      n.x = 70 + (W - 140) * li / Math.max(1, L.length - 1);
      n.y = 40 + (H - 80) * (i + 0.5) / layers[ly].length;
    });
  });
  var byId = {};
  nodes.forEach(function (n) { byId[n.id] = n; });
  var wmax = edges.reduce(function (a, e) {
    return Math.max(a, Math.abs(e.w)); }, 1e-12);
  var edgeEls = [];
  edges.forEach(function (e) {
    var a = byId[e.s], b = byId[e.t];
    if (!a || !b) return;
    var p = el('path', {
      d: 'M' + a.x + ',' + a.y + ' C' + ((a.x + b.x) / 2) + ',' + a.y + ' '
        + ((a.x + b.x) / 2) + ',' + b.y + ' ' + b.x + ',' + b.y,
      fill: 'none', stroke: e.w >= 0 ? '#1461d6' : '#d1342f',
      'stroke-opacity': 0.45,
      'stroke-width': (0.6 + 3.4 * Math.abs(e.w) / wmax).toFixed(2)});
    var ti = el('title');
    ti.textContent = e.s + ' -> ' + e.t + '  w=' + e.w.toPrecision(4);
    p.appendChild(ti);
    svg.appendChild(p);
    edgeEls.push({el: p, e: e});
  });
  nodes.forEach(function (n) {
    var g = el('g', {cursor: 'pointer'});
    g.appendChild(el('circle', {cx: n.x, cy: n.y, r: 7,
      fill: n.layer === '0' ? '#1a1a2e' : '#1461d6',
      stroke: '#fff', 'stroke-width': 1.5}));
    var t = el('text', {x: n.x + 10, y: n.y + 4, 'font-size': 10,
      fill: '#333'});
    t.textContent = n.id;
    g.appendChild(t);
    var ti = el('title');
    ti.textContent = n.id;
    g.appendChild(ti);
    g.addEventListener('click', function () {
      edgeEls.forEach(function (pe) {
        var on = pe.e.s === n.id || pe.e.t === n.id;
        pe.el.setAttribute('stroke-opacity', on ? 0.95 : 0.08);
      });
    });
    svg.appendChild(g);
  });
  svg.addEventListener('dblclick', function () {
    edgeEls.forEach(function (pe) {
      pe.el.setAttribute('stroke-opacity', 0.45); });
  });
})();

showCurve();
showKO();
"""


def _round(a, nd=4):
    # nan_to_num: NaN would serialize as bare `NaN`, which is valid JS but
    # invalid JSON — keep the payload strictly parseable
    return np.round(np.nan_to_num(host(a)), nd).tolist()


def write_interactive_explorer(path, *, title, times, curve_names, obs, est,
                               ko_names, ko_est, network_edges,
                               source_layer_names, max_targets_per_ko=12,
                               max_edges=120) -> str:
    """Write the single-file interactive explorer.

    Args:
      times: (T,) time grid.
      curve_names: list of C display names.
      obs, est: (C, T) observed / fitted matrices.
      ko_names: list of K regulator names.
      ko_est: (K, C, T) exact re-predictions with each regulator knocked
        out (computed on the device by the caller).
      network_edges: a column table with source, target and weight; its
        first ``max_edges`` rows are drawn.
      source_layer_names: set of node ids to place on the regulator layer.
    """
    est = host(est)
    ko_est = host(ko_est)
    C = len(curve_names)
    obs = None if obs is None else host(obs)

    curves = [{"name": str(curve_names[c]),
               "obs": None if obs is None else _round(obs[c]),
               "est": _round(est[c])} for c in range(C)]

    knockouts = []
    for k, name in enumerate(ko_names):
        finite = np.isfinite(ko_est[k]).all(axis=1)           # (C,)
        delta = np.abs(np.nan_to_num(ko_est[k]) - est).mean(axis=1)
        # a diverged (non-finite) re-prediction must not masquerade as a
        # real complete-suppression curve (review finding): rank it last
        # and label it
        delta = np.where(finite, delta, -1.0)
        order = np.argsort(delta)[::-1][:max_targets_per_ko]
        top = [{"c": int(c), "d": float(max(delta[c], 0.0)),
                "ko": _round(ko_est[k, c]),
                "bad": bool(~finite[c])} for c in order]
        knockouts.append({"name": str(name) + ("" if finite.all()
                                               else " (diverged)"),
                          "top": top,
                          "total": float(np.abs(
                              np.nan_to_num(ko_est[k]) - est)[finite].sum())})

    rows = []
    for i in range(min(n_rows(network_edges), max_edges)):
        rows.append({"s": str(network_edges["source"][i]),
                     "t": str(network_edges["target"][i]),
                     "w": float(network_edges["weight"][i])})
    node_ids = {e["s"] for e in rows} | {e["t"] for e in rows}
    nodes = [{"id": n, "layer": "0" if n in source_layer_names else "1"}
             for n in sorted(node_ids)]

    data = {"times": _round(times), "curves": curves,
            "knockouts": knockouts,
            "network": {"nodes": nodes, "edges": rows}}

    html = f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>{title}</title><style>{_CSS}</style></head>
<body>
<header><h1>{title}</h1>
<div class="sub">interactive explorer — {C} curves,
{len(ko_names)} knockout scenarios (exact re-predictions), self-contained
HTML (no server)</div></header>
<div class="wrap">

<div class="card"><h2>Curve explorer — observed vs fitted</h2>
<div class="row"><select id="curve-select"></select>
<span class="stat">RMSE <b id="curve-rmse">-</b></span></div>
<svg id="curve-svg" width="1100" height="320"></svg>
<div class="legend"><span><i class="dot" style="background:#8d99ae"></i>
observed</span><span><i class="dot" style="background:#1461d6"></i>
fitted</span></div></div>

<div class="card"><h2>Knockout simulator — exact re-prediction with one
regulator removed</h2>
<div class="row"><select id="ko-select"></select>
<span class="stat">total effect <b id="ko-total">-</b></span>
<span class="hint">click a row to plot that target</span></div>
<div class="row" style="align-items:flex-start">
<svg id="ko-svg" width="760" height="300"></svg>
<div style="flex:1;min-width:260px;max-height:300px;overflow:auto">
<table class="ko"><thead><tr><th>target</th><th>mean |&Delta;|</th></tr>
</thead><tbody id="ko-tbody"></tbody></table></div></div>
<div class="legend"><span><i class="dot" style="background:#8d99ae"></i>
observed</span><span><i class="dot" style="background:#1461d6"></i>
fitted</span><span><i class="dot" style="background:#d1342f"></i>
knockout</span></div></div>

<div class="card"><h2>Regulator network — click a node to highlight its
edges, double-click to reset, hover for weights</h2>
<svg id="net-svg" width="1100" height="520"></svg></div>

</div>
<script>window.__FITDATA__ = {json.dumps(data)};</script>
<script>{_JS}</script>
</body></html>
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


_PARETO_JS = """
'use strict';
var D = window.__PARETODATA__;
var OBJ = D.obj_names;

function el(tag, attrs) {
  var e = document.createElementNS('http://www.w3.org/2000/svg', tag);
  for (var k in (attrs || {})) e.setAttribute(k, attrs[k]);
  return e;
}

var selSol = D.best_idx;

// ---- objective-pair scatter ----------------------------------------------
var axX = document.getElementById('ax-x'), axY = document.getElementById('ax-y');
OBJ.forEach(function (n, i) {
  var o1 = document.createElement('option'); o1.value = i; o1.textContent = n;
  var o2 = document.createElement('option'); o2.value = i; o2.textContent = n;
  axX.appendChild(o1); axY.appendChild(o2);
});
axX.value = 0; axY.value = 1;

function drawScatter() {
  var svg = document.getElementById('pareto-svg');
  while (svg.firstChild) svg.removeChild(svg.firstChild);
  var W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
  var m = {l: 60, r: 14, t: 10, b: 40};
  var xi = +axX.value, yi = +axY.value;
  var xs = D.F.map(function (f) { return f[xi]; });
  var ys = D.F.map(function (f) { return f[yi]; });
  var x0 = Math.min.apply(null, xs), x1 = Math.max.apply(null, xs);
  var y0 = Math.min.apply(null, ys), y1 = Math.max.apply(null, ys);
  if (!(x0 < x1)) { x0 -= 1; x1 += 1; }
  if (!(y0 < y1)) { y0 -= 1; y1 += 1; }
  var X = function (v) { return m.l + (W - m.l - m.r) * (v - x0) / (x1 - x0); };
  var Y = function (v) { return H - m.b - (H - m.t - m.b) * (v - y0) / (y1 - y0); };
  svg.appendChild(el('line', {x1: m.l, y1: H - m.b, x2: W - m.r, y2: H - m.b,
    stroke: '#b9c0cc'}));
  svg.appendChild(el('line', {x1: m.l, y1: m.t, x2: m.l, y2: H - m.b,
    stroke: '#b9c0cc'}));
  var tx = el('text', {x: (W) / 2, y: H - 8, 'text-anchor': 'middle',
    'font-size': 12, fill: '#444'});
  tx.textContent = OBJ[xi]; svg.appendChild(tx);
  var ty = el('text', {x: 14, y: H / 2, 'font-size': 12, fill: '#444',
    transform: 'rotate(-90 14 ' + (H / 2) + ')', 'text-anchor': 'middle'});
  ty.textContent = OBJ[yi]; svg.appendChild(ty);
  D.F.forEach(function (f, i) {
    var has = D.sols.hasOwnProperty(String(i));
    var c = el('circle', {cx: X(f[xi]), cy: Y(f[yi]),
      r: i === selSol ? 8 : (has ? 6 : 3.5),
      fill: i === selSol ? '#d1342f' : (has ? '#1461d6' : '#8d99ae'),
      stroke: '#fff', 'stroke-width': 1, cursor: has ? 'pointer' : 'default'});
    var ti = el('title');
    ti.textContent = 'solution ' + i + '\\n' + OBJ.map(function (n, k) {
      return n + ' = ' + f[k].toPrecision(5); }).join('\\n')
      + (has ? '\\n(click to inspect curves)' : '');
    c.appendChild(ti);
    if (has) c.addEventListener('click', function () {
      selSol = i; drawScatter(); showCurve();
    });
    svg.appendChild(c);
  });
  document.getElementById('sel-label').textContent = selSol;
}
axX.addEventListener('change', drawScatter);
axY.addEventListener('change', drawScatter);

// ---- curve panel for the selected solution --------------------------------
var curveSel = document.getElementById('pcurve-select');
D.curve_names.forEach(function (nm, i) {
  var o = document.createElement('option');
  o.value = i; o.textContent = nm; curveSel.appendChild(o);
});
function showCurve() {
  var sol = D.sols[String(selSol)];
  var svg = document.getElementById('pcurve-svg');
  while (svg.firstChild) svg.removeChild(svg.firstChild);
  if (!sol) return;
  var ci = +curveSel.value;
  var pred = sol[ci];
  var obs = D.obs[ci];                 // may be null
  var times = D.times;
  var W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
  var m = {l: 48, r: 12, t: 12, b: 26};
  var all = pred.slice();
  if (obs) obs.forEach(function (p) { all.push(p[1]); });
  var lo = Math.min.apply(null, all), hi = Math.max.apply(null, all);
  if (!(lo < hi)) { lo -= 1; hi += 1; }
  var pad = (hi - lo) * 0.08; lo -= pad; hi += pad;
  var tmax = times[times.length - 1] || 1;
  var X = function (t) { return m.l + (W - m.l - m.r) * t / tmax; };
  var Y = function (v) { return H - m.b - (H - m.t - m.b) * (v - lo) / (hi - lo); };
  svg.appendChild(el('line', {x1: m.l, y1: H - m.b, x2: W - m.r, y2: H - m.b,
    stroke: '#b9c0cc'}));
  svg.appendChild(el('line', {x1: m.l, y1: m.t, x2: m.l, y2: H - m.b,
    stroke: '#b9c0cc'}));
  for (var g = 0; g <= 4; g++) {
    var v = lo + (hi - lo) * g / 4, yy = Y(v);
    var t = el('text', {x: m.l - 6, y: yy + 4, 'text-anchor': 'end',
      'font-size': 10, fill: '#68728a'});
    t.textContent = v.toPrecision(3); svg.appendChild(t);
  }
  var d = pred.map(function (v, i) {
    return (i ? 'L' : 'M') + X(times[i]).toFixed(1) + ',' + Y(v).toFixed(1);
  }).join(' ');
  svg.appendChild(el('path', {d: d, fill: 'none', stroke: '#1461d6',
    'stroke-width': 2.2}));
  if (obs) obs.forEach(function (p) {
    svg.appendChild(el('circle', {cx: X(p[0]), cy: Y(p[1]), r: 3,
      fill: '#8d99ae'}));
  });
}
curveSel.addEventListener('change', showCurve);
drawScatter();
showCurve();
"""


def write_pareto_explorer(path, *, pareto_F, best_idx, times, curve_names,
                          sol_curves, obs_points,
                          obj_names=("protein MSE", "RNA MSE",
                                     "phospho MSE")) -> str:
    """Interactive Pareto-front explorer for the global model: an
    objective-pair scatter (axis dropdowns, hover values) where members
    with exported trajectories are CLICKABLE — selecting one renders its
    predicted curves against the observations.

    Goes beyond the reference's static dashboard
    (``global_model/dashboard_app/bundle.py``) while staying a single
    dependency-free HTML file.

    Args:
      pareto_F: (P, n_obj) objectives.
      sol_curves: {sol_id: (C, T) predicted series per curve}.
      obs_points: list of C entries, each None or [(t, value), ...].
    """
    F = host(pareto_F)
    sols = {str(int(k)): [_round(r) for r in host(v)[:len(curve_names)]]
            for k, v in sol_curves.items()}
    obs = [None if o is None else [[float(t), float(v)] for t, v in o]
           for o in obs_points]
    data = {"F": [_round(f) for f in F], "best_idx": int(best_idx),
            "obj_names": list(obj_names), "times": _round(times),
            "curve_names": [str(c) for c in curve_names],
            "sols": sols, "obs": obs}

    html = f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>Pareto explorer</title><style>{_CSS}</style></head>
<body>
<header><h1>Global-model Pareto explorer</h1>
<div class="sub">{len(F)} front members — blue points carry exported
trajectories (click to inspect); red = selected</div></header>
<div class="wrap">
<div class="card"><h2>Objective space</h2>
<div class="row">x: <select id="ax-x"></select>
y: <select id="ax-y"></select>
<span class="stat">selected solution <b id="sel-label">-</b></span></div>
<svg id="pareto-svg" width="1100" height="430"></svg></div>
<div class="card"><h2>Fit curves of the selected solution</h2>
<div class="row"><select id="pcurve-select"></select></div>
<svg id="pcurve-svg" width="1100" height="300"></svg>
<div class="legend"><span><i class="dot" style="background:#1461d6"></i>
predicted</span><span><i class="dot" style="background:#8d99ae"></i>
observed</span></div></div>
</div>
<script>window.__PARETODATA__ = {json.dumps(data)};</script>
<script>{_PARETO_JS}</script>
</body></html>
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


def _rows_by_key(table: dict, keys) -> list:
    """(key tuple, row) for every row whose keys are all present, in table
    order: the rows of pandas' ``groupby(keys)``, whose groups are written
    to separate curves, so the order between groups does not matter."""
    cols = [np.asarray(table[k], dtype=object) for k in keys]
    return [(tuple(c[i] for c in cols), i) for i in range(n_rows(table))
            if not any(is_missing(c[i]) for c in cols)]


def pareto_explorer_from_frames(path, pareto_F, best_idx, traj_prot,
                                traj_rna, traj_pho, df_prot=None,
                                df_rna=None, df_pho=None) -> str:
    """Build :func:`write_pareto_explorer` inputs from the per-solution
    trajectory tables of
    :func:`phoskintime_tpu_torch.io.export.export_pareto_trajectories` (as
    :func:`phoskintime_tpu_torch.io.load.read_table` reads them back) plus
    the observed tables (protein/(psite)/time/fc), all column dicts."""
    times = np.unique(np.asarray(traj_prot["time"], float))
    t_index = {float(t): i for i, t in enumerate(times)}
    proteins = sorted({str(p) for p in traj_prot["protein"]})
    has_pho = traj_pho is not None and n_rows(traj_pho) > 0
    sites = (sorted({(str(p), str(s)) for p, s in
                     zip(traj_pho["protein"], traj_pho["psite"])})
             if has_pho else [])

    curve_names = ([f"{p} (protein)" for p in proteins]
                   + [f"{p} (mRNA)" for p in proteins]
                   + [f"{p}:{s} (phospho)" for p, s in sites])
    C, T = len(curve_names), len(times)
    c_index = {n: i for i, n in enumerate(curve_names)}

    parts = [(traj_prot, ["protein"], "{} (protein)"), (traj_rna, ["protein"], "{} (mRNA)")]
    if has_pho:
        parts.append((traj_pho, ["protein", "psite"], "{}:{} (phospho)"))
    sol_curves = {}
    for sid in sorted(set(np.asarray(traj_prot["sol_id"]).astype(int).tolist())):
        M = np.zeros((C, T))
        for table, keys, fmt in parts:
            on = np.asarray(table["sol_id"]).astype(int) == sid
            t_col, v_col = np.asarray(table["time"]), np.asarray(table["pred_fc"])
            for key, i in _rows_by_key(table, keys):
                if on[i]:
                    M[c_index[fmt.format(*key)], t_index[float(t_col[i])]] = float(v_col[i])
        sol_curves[sid] = M

    obs_points = [None] * C
    for table, fmt, keys in [(df_prot, "{} (protein)", ["protein"]),
                             (df_rna, "{} (mRNA)", ["protein"]),
                             (df_pho, "{}:{} (phospho)", ["protein", "psite"])]:
        if table is None or n_rows(table) == 0:
            continue
        groups: dict = {}
        for key, i in _rows_by_key(table, keys):
            groups.setdefault(key, []).append(i)
        t_col, fc_col = np.asarray(table["time"]), np.asarray(table["fc"])
        for key, rows in groups.items():
            row = c_index.get(fmt.format(*key))
            if row is None:
                continue
            obs_points[row] = [(float(t_col[i]), float(fc_col[i])) for i in rows]

    return write_pareto_explorer(
        path, pareto_F=pareto_F, best_idx=best_idx, times=times,
        curve_names=curve_names, sol_curves=sol_curves,
        obs_points=obs_points)
