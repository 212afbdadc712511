"""Live global-model explorer: slider-driven re-simulation in the browser.

Counterpart of ``phoskintime_tpu/report/live_model.py``, with the same
template, CSS and JS. The fitted system (topology arrays, the kinase-input
table, the fitted parameters, y0) is embedded as JSON, and a vanilla-JS
forward model mirrors :class:`phoskintime_tpu_torch.network.rhs.PaddedRHS`
for all four mechanisms (distributive 0, sequential 1, combinatorial 2,
saturating 4), with a segment-wise adaptive Dormand-Prince RK45 and
cubic-Hermite dense output (the kinase input piecewise-constant a
kinase-grid bucket, as :func:`phoskintime_tpu_torch.ops.integrators.odeint_rk45`).
Perturbation sliders (protein-synthesis, kinase-activity and site-drive
scales), the evaluation horizon and per-protein parameter edits each
re-integrate the whole network in the page. Fold changes as
:func:`phoskintime_tpu_torch.network.simulate.fold_changes` (baseline t = 0
for protein and phospho, t = 4 for mRNA).

Everything in the payload is host data but the fitted parameters, which
come to the host as float64 before rounding.
"""

from __future__ import annotations

import json
import os

import numpy as np

from phoskintime_tpu_torch.io.utils import host, is_missing, n_rows
from phoskintime_tpu_torch.report import live_constants as _lmc


def _round(a, nd=6):
    a = host(a)
    a = np.where(np.isfinite(a), a, 0.0)
    return np.round(a, nd).tolist()


_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 0; background: #f6f7f9; color: #1a1a2e; }
header { background: #1a1a2e; color: #fff; padding: 14px 28px; }
header h1 { margin: 0; font-size: 19px; font-weight: 600; }
header .sub { color: #9aa3b2; font-size: 12px; margin-top: 3px; }
.wrap { max-width: 1220px; margin: 18px auto; padding: 0 16px; }
.card { background: #fff; border-radius: 10px; padding: 16px 20px;
        margin-bottom: 16px; box-shadow: 0 1px 4px rgba(16,24,40,.08); }
.card h2 { margin: 0 0 10px; font-size: 15px; }
.row { display: flex; gap: 16px; flex-wrap: wrap; align-items: center; }
.col { display: flex; flex-direction: column; gap: 2px; }
label { font-size: 12px; color: #445; }
select { padding: 5px 9px; border: 1px solid #cfd6e0; border-radius: 6px;
         font-size: 13px; background: #fff; max-width: 280px; }
input[type=range] { width: 180px; }
.val { font-variant-numeric: tabular-nums; font-size: 12px; color: #223; }
.stat { display: inline-block; background: #eef2f7; border-radius: 8px;
        padding: 7px 12px; margin: 3px 6px 3px 0; font-size: 12px; }
.stat b { display: block; font-size: 15px; }
.hint { color: #68728a; font-size: 12px; }
button { padding: 6px 12px; border: 1px solid #cfd6e0; background: #fff;
         border-radius: 6px; cursor: pointer; font-size: 12px; }
.grid2 { display: grid; grid-template-columns: 1fr 1fr; gap: 14px; }
.pp { display: grid; grid-template-columns: repeat(auto-fill, 230px);
      gap: 6px 18px; }
svg text { font-family: inherit; }
.imp { font-size: 12px; } .imp td { padding: 3px 8px;
       border-bottom: 1px solid #e8ebf1; }
"""

# The forward model. D = payload. Mirrors network/rhs.py semantics 1:1;
# its comments cite the Python it mirrors (the JAX package's module names,
# the same in this package).
_JS_MODEL = """
'use strict';
var D = window.__LIVEMODEL__;
var N = D.N, K = D.K, SM = D.smax, W = D.width, MODEL = D.model;
var MM = (MODEL === 2) ? (1 << SM) : 0;

function clone(o) { return JSON.parse(JSON.stringify(o)); }

// ---- parameter state (editable copies of the fitted values) ----------
var P0 = { A: D.params.A_i.slice(), B: D.params.B_i.slice(),
           C: D.params.C_i.slice(), Dd: D.params.D_i.slice(),
           E: D.params.E_i.slice(), tf: D.params.tf_scale.slice(),
           ck: D.params.c_k.slice(),
           Dp: D.params.Dp_i.map(function(r){return r.slice();}) };
var cur = clone(P0);
var pert = { type: 'none', target: 0, scale: 1.0, wscale: 1.0 };
var tMax = D.t_default;

// ---- RHS: mirrors PaddedRHS.__call__ (network/rhs.py:143-165) --------
function kinaseActivity(jb, ck) {          // rhs.py:121-124
  var j = Math.min(Math.max(jb, 0), D.kin_grid.length - 1), out = new Array(K);
  for (var k = 0; k < K; k++) out[k] = D.Kmat[k][j] * ck[k];
  return out;
}
function siteRates(Kt, wmul) {             // rhs.py:126-128 einsum nsk,k->ns
  var S = [];
  for (var n = 0; n < N; n++) { var row = new Array(SM);
    for (var s = 0; s < SM; s++) { var acc = 0;
      for (var k = 0; k < K; k++) acc += D.W[n][s][k] * Kt[k];
      row[s] = acc * ((wmul && wmul[n] && wmul[n][s] !== undefined) ?
                      wmul[n][s] : 1); }
    S.push(row); }
  return S;
}
function totalProtein(Y, n) {              // rhs.py:130-134
  if (MODEL === 2) { var t = 0;
    for (var m = 1; m < MM; m++)
      if (m < D.n_states[n]) t += Y[n * W + 1 + m];
    t += Y[n * W + 1];                     // state 0 (unphospho) included
    return t; }
  var tot = Y[n * W + 1];
  for (var s = 0; s < D.n_sites[n]; s++) tot += Y[n * W + 2 + s];
  return tot;
}
function rhs(t, Y, jb, p, out) {
  var Kt = kinaseActivity(jb, p.ck);
  var S = siteRates(Kt, p.wmul);
  // P_vec with driver override (rhs.py:136-140), u squash (rhs.py:44-47)
  var Pv = new Array(N);
  for (var n = 0; n < N; n++) {
    var d = D.driver_map[n];
    Pv[n] = (d >= 0) ? Kt[d] : totalProtein(Y, n);
  }
  var u = new Array(N);
  for (var i = 0; i < N; i++) { var acc = 0;
    for (var j2 = 0; j2 < N; j2++) acc += D.tf_mat[i][j2] * Pv[j2];
    var v = acc / D.tf_deg[i];
    u[i] = v / (1 + Math.abs(v)); }
  for (var n = 0; n < N; n++) {
    // synthesis_rate (rhs.py:32-41)
    var us = u[n], A = p.A[n] * ((pertA && pertA[n] !== undefined) ? pertA[n] : 1);
    var synth = (us >= 0)
      ? A * (1 + (p.tf[n] * us) / (1 + us + LMC.SYNTH_EPS))
      : A / (1 + p.tf[n] * Math.abs(us));
    var o = n * W;
    var R = Y[o], Pm = Y[o + 1];
    out[o] = synth - p.B[n] * R;                       // dR
    if (MODEL === 2) {                                 // rhs.py:326-361
      var ns = D.n_sites[n], M2 = 1 << ns;
      for (var m = 0; m < MM; m++) out[o + 1 + m] = 0;
      for (var j = 0; j < ns; j++) { var bit = 1 << j;
        for (var m = 0; m < M2; m++) {
          var xm = m ^ bit, Xm = Y[o + 1 + m], Xx = Y[o + 1 + xm];
          var infl, outf;
          if (m & bit) { infl = S[n][j] * Xx; outf = p.E[n] * Xm; }
          else { infl = p.E[n] * Xx; outf = S[n][j] * Xm; }
          out[o + 1 + m] += infl - outf;
        } }
      for (var m = 0; m < M2; m++) {
        var dec = p.Dd[n];
        if (m > 0) { dec = 0;
          for (var j = 0; j < ns; j++)
            if (m & (1 << j)) dec += p.Dp[n][j] + p.Dd[n]; }
        out[o + 1 + m] -= dec * Y[o + 1 + m];
      }
      out[o + 1] += p.C[n] * R;                        // translation
      for (var m = M2; m < MM; m++) out[o + 1 + m] = 0;
    } else if (MODEL === 1) {                          // rhs.py:298-324
      var ns = D.n_sites[n], hs = ns > 0 ? 1 : 0;
      var k0 = ns > 0 ? S[n][0] : 0, P1 = ns > 0 ? Y[o + 2] : 0;
      out[o + 1] = p.C[n] * R - p.Dd[n] * Pm - k0 * Pm * hs
                   + p.E[n] * P1 * hs;
      for (var j = 0; j < SM; j++) {
        if (j >= ns) { out[o + 2 + j] = 0; continue; }
        var prev = (j === 0) ? Pm : Y[o + 1 + j];
        var hasNext = (j + 1 < ns) ? 1 : 0;
        var kNext = hasNext ? S[n][j + 1] : 0;
        var nxt = hasNext ? Y[o + 3 + j] : 0;
        out[o + 2 + j] = S[n][j] * prev + p.E[n] * nxt * hasNext
          - (kNext * hasNext + p.E[n] + p.Dp[n][j] + p.Dd[n]) * Y[o + 2 + j];
      }
    } else if (MODEL === 4) {                          // rhs.py:184-198
      var ns = D.n_sites[n];
      var trans = (p.C[n] * R) / (1 + R), sumF = 0, sumB = 0;
      for (var j = 0; j < SM; j++) {
        if (j >= ns) { out[o + 2 + j] = 0; continue; }
        var sj = Y[o + 2 + j];
        var ff = (S[n][j] * Pm) / (1 + Pm), bk = p.E[n] * sj;
        out[o + 2 + j] = ff - (p.Dp[n][j] + p.Dd[n]) * sj - bk;
        sumF += ff; sumB += bk;
      }
      out[o + 1] = trans - p.Dd[n] * Pm - sumF + sumB;
    } else {                                           // rhs.py:168-182
      var ns = D.n_sites[n], sumS = 0, sumBack = 0;
      for (var j = 0; j < SM; j++) {
        if (j >= ns) { out[o + 2 + j] = 0; continue; }
        var sj = Y[o + 2 + j];
        out[o + 2 + j] = S[n][j] * Pm
          - (p.E[n] + p.Dp[n][j] + p.Dd[n]) * sj;
        sumS += S[n][j]; sumBack += sj;
      }
      out[o + 1] = p.C[n] * R - (p.Dd[n] + sumS) * Pm
                   + p.E[n] * sumBack;
    }
  }
}

// ---- Dormand-Prince RK45, segment-wise over the kinase grid ----------
// DP tableau + all load-bearing numeric constants come from LMC
// (emitted by report/live_constants.py — single source shared with
// the test mirror; do not hardcode numerics here)

var intCapHit = false;   // true when any segment exhausted its step cap

function integrate(p, times) {
  var dim = N * W;
  intCapHit = false;
  var Y = D.y0.slice();
  var outs = [], oi = 0;
  var T = times.length;
  var g = D.kin_grid, nb = g.length;
  if (times[0] <= g[0] + 1e-12) { outs.push(Y.slice()); oi = 1; }
  var ks = []; for (var i = 0; i < 7; i++) ks.push(new Array(dim));
  var ytmp = new Array(dim), y5 = new Array(dim);
  // past the last kinase-grid point the bucket input is held (the clamp
  // in kinaseActivity), so the final segment extends to the horizon
  for (var seg = 0; seg < nb && oi < T; seg++) {
    var t = g[seg],
        tEnd = Math.min(seg + 1 < nb ? g[seg + 1] : times[T - 1],
                        times[T - 1]);
    if (tEnd <= t) continue;
    var h = (tEnd - t) / LMC.H_INIT_DIV;
    rhs(t, Y, seg, p, ks[0]);
    var steps = 0;
    while (t < tEnd - 1e-12 && steps++ < LMC.STEP_CAP) {
      h = Math.min(h, tEnd - t);
      for (var s = 1; s < 7; s++) {
        for (var d = 0; d < dim; d++) { var acc = 0;
          for (var q = 0; q < s; q++) acc += DP_A[s][q] * ks[q][d];
          ytmp[d] = Y[d] + h * acc; }
        rhs(t + h, ytmp, seg, p, ks[s]);
      }
      for (var d = 0; d < dim; d++)
        y5[d] = Y[d] + h * (DP_A[6][0]*ks[0][d] + DP_A[6][2]*ks[2][d] +
          DP_A[6][3]*ks[3][d] + DP_A[6][4]*ks[4][d] + DP_A[6][5]*ks[5][d]);
      var err = 0;
      for (var d = 0; d < dim; d++) {
        var e = h * (DP_E[0]*ks[0][d] + DP_E[2]*ks[2][d] + DP_E[3]*ks[3][d]
          + DP_E[4]*ks[4][d] + DP_E[5]*ks[5][d] + DP_E[6]*ks[6][d]);
        var sc = LMC.ATOL + LMC.RTOL * Math.max(Math.abs(Y[d]), Math.abs(y5[d]));
        var r = e / sc; err += r * r;
      }
      err = Math.sqrt(err / dim);
      if (err <= 1) {
        // dense output: cubic Hermite on [t, t+h] (y, f at both ends)
        while (oi < T && times[oi] <= t + h + 1e-12) {
          var th = (times[oi] - t) / h, row = new Array(dim);
          var h00 = (1+2*th)*(1-th)*(1-th), h10 = th*(1-th)*(1-th),
              h01 = th*th*(3-2*th), h11 = th*th*(th-1);
          for (var d = 0; d < dim; d++)
            row[d] = h00*Y[d] + h*h10*ks[0][d] + h01*y5[d] + h*h11*ks[6][d];
          outs.push(row); oi++;
        }
        t += h;
        for (var d = 0; d < dim; d++) { Y[d] = y5[d]; ks[0][d] = ks[6][d]; }
      }
      var f = LMC.SAFETY * Math.pow(Math.max(err, LMC.ERR_FLOOR), LMC.ERR_EXP);
      h *= Math.min(LMC.H_UP, Math.max(LMC.H_DOWN, f));
    }
    // cap exhausted before reaching the segment end: the trajectory
    // from here on is truncated, not converged — surface it in the UI
    if (t < tEnd - 1e-12) intCapHit = true;
  }
  while (oi < T) { outs.push(Y.slice()); oi++; }      // clamp past grid
  return outs;
}

// ---- observables + fold changes (simulate.py:61-99) ------------------
function observables(sol, times) {
  var T = times.length;
  var Rr = [], TOT = [], PHO = [];
  for (var ti = 0; ti < T; ti++) {
    var y = sol[ti], r = new Array(N), tot = new Array(N), ph = [];
    for (var n = 0; n < N; n++) {
      r[n] = y[n * W];
      tot[n] = totalProtein(y, n);
      var row = new Array(SM);
      if (MODEL === 2) {
        for (var j = 0; j < SM; j++) { var acc = 0;
          for (var m = 1; m < (1 << D.n_sites[n]); m++)
            if (m & (1 << j)) acc += y[n * W + 1 + m];
          row[j] = acc; }
      } else {
        for (var j = 0; j < SM; j++)
          row[j] = (j < D.n_sites[n]) ? y[n * W + 2 + j] : 0;
      }
      ph.push(row);
    }
    Rr.push(r); TOT.push(tot); PHO.push(ph);
  }
  // fold_changes (simulate.py:90-99): baselines t=0 (prot/pho), t=4 (rna)
  function nearest(t0) { var bi = 0, bd = 1e30;
    for (var i = 0; i < T; i++) { var d2 = Math.abs(times[i] - t0);
      if (d2 < bd) { bd = d2; bi = i; } } return bi; }
  var bp = nearest(LMC.PROT_BASE_T), br = nearest(LMC.RNA_BASE_T);
  var EPS = LMC.FC_EPS;
  function fc2(sig, b) { return sig.map(function(rowt) {
    return rowt.map(function(v, n) {
      return Math.max(v, EPS) / Math.max(sig[b][n], EPS); }); }); }
  var fcR = fc2(Rr, br), fcP = fc2(TOT, bp);
  var fcPh = PHO.map(function(rowt) { return rowt.map(function(pr, n) {
    return pr.map(function(v, j) {
      return Math.max(v, EPS) / Math.max(PHO[bp][n][j], EPS); }); }); });
  return { R: fcR, P: fcP, PH: fcPh };
}

var pertA = null;   // per-protein synthesis multipliers (null = none)
function applyPerturbation() {
  cur.ck = P0.ck.slice(); pertA = null; cur.wmul = null;
  if (pert.type === 'kinase') cur.ck[pert.target] *= pert.scale;
  else if (pert.type === 'protein') {
    pertA = {}; pertA[pert.target] = pert.scale; }
  else if (pert.type === 'site') {
    cur.wmul = {}; var t = D.site_index[pert.target];
    cur.wmul[t[0]] = {}; cur.wmul[t[0]][t[1]] = pert.scale; }
}

function makeTimes(tmax) {
  var ts = [], n = 120;
  for (var i = 0; i <= n; i++) ts.push(tmax * i / n);
  // ensure the FC baselines exist on the grid
  if (ts.indexOf(4) < 0 && tmax >= 4) { ts.push(4); ts.sort(function(a,b){return a-b;}); }
  return ts;
}

function solveAll() {
  var times = makeTimes(tMax);
  applyPerturbation();
  var sol = integrate(cur, times);
  return { times: times, obs: observables(sol, times), ok: !intCapHit };
}
"""

_JS_UI = """
// ---------------- UI ----------------
function h(tag, attrs, parent) {
  var e = document.createElement(tag);
  for (var k in (attrs || {})) {
    if (k === 'text') e.textContent = attrs[k]; else e.setAttribute(k, attrs[k]);
  }
  if (parent) parent.appendChild(e);
  return e;
}
function svgEl(tag, attrs) {
  var e = document.createElementNS('http://www.w3.org/2000/svg', tag);
  for (var k in (attrs || {})) e.setAttribute(k, attrs[k]);
  return e;
}
function drawPlot(svg, times, series, dataPts, title) {
  while (svg.firstChild) svg.removeChild(svg.firstChild);
  var Wd = svg.clientWidth || 540, Ht = 230;
  svg.setAttribute('viewBox', '0 0 ' + Wd + ' ' + Ht);
  var mL = 44, mR = 10, mT = 22, mB = 26;
  var lo = 1e30, hi = -1e30;
  series.forEach(function(s) { s.y.forEach(function(v) {
    if (isFinite(v)) { lo = Math.min(lo, v); hi = Math.max(hi, v); } }); });
  (dataPts || []).forEach(function(p) {
    lo = Math.min(lo, p[1]); hi = Math.max(hi, p[1]); });
  if (!(hi > lo)) { hi = lo + 1; }
  var pad = 0.08 * (hi - lo); lo -= pad; hi += pad;
  var tmax = times[times.length - 1];
  function X(t) { return mL + (Wd - mL - mR) * t / tmax; }
  function Yc(v) { return mT + (Ht - mT - mB) * (1 - (v - lo) / (hi - lo)); }
  for (var i = 0; i <= 4; i++) {
    var v = lo + (hi - lo) * i / 4, y = Yc(v);
    svg.appendChild(svgEl('line', {x1: mL, x2: Wd - mR, y1: y, y2: y,
      stroke: '#edf0f5'}));
    var tx = svgEl('text', {x: mL - 6, y: y + 4, 'text-anchor': 'end',
      'font-size': 10, fill: '#68728a'});
    tx.textContent = v.toPrecision(3); svg.appendChild(tx);
  }
  for (var i = 0; i <= 5; i++) {
    var t = tmax * i / 5, x = X(t);
    var tx = svgEl('text', {x: x, y: Ht - 8, 'text-anchor': 'middle',
      'font-size': 10, fill: '#68728a'});
    tx.textContent = Math.round(t); svg.appendChild(tx);
  }
  series.forEach(function(s) {
    var d = '';
    for (var i = 0; i < times.length; i++)
      d += (i ? 'L' : 'M') + X(times[i]).toFixed(1) + ' ' +
           Yc(s.y[i]).toFixed(1);
    svg.appendChild(svgEl('path', {d: d, fill: 'none', stroke: s.color,
      'stroke-width': s.width || 1.8,
      'stroke-dasharray': s.dash ? '5 4' : 'none'}));
  });
  (dataPts || []).forEach(function(p) {
    svg.appendChild(svgEl('circle', {cx: X(p[0]), cy: Yc(p[1]), r: 3,
      fill: '#1a1a2e', 'fill-opacity': 0.65}));
  });
  var tt = svgEl('text', {x: mL, y: 13, 'font-size': 11, fill: '#334',
    'font-weight': 600});
  tt.textContent = title; svg.appendChild(tt);
}

var selProt = 0, wt = null, cache = null;
var paramInputs = [];

function buildControls() {
  var pp = document.getElementById('pertPanel');
  var typeSel = h('select', {id: 'pertType'}, null);
  [['none','None'],['protein','Protein synthesis'],
   ['kinase','Kinase activity'],['site','Site drive']].forEach(function(o) {
    var op = h('option', {value: o[0], text: o[1]}); typeSel.appendChild(op);
  });
  var tgtSel = h('select', {id: 'pertTarget'});
  var scale = h('input', {type: 'range', min: 0, max: 2, step: 0.05,
                          value: 1});
  var sval = h('span', {class: 'val', text: '1.00'});
  var tmaxIn = h('input', {type: 'range', min: D.t_min_slider,
                           max: D.t_max_slider, step: 1,
                           value: D.t_default});
  var tval = h('span', {class: 'val', text: String(D.t_default) + ' min'});
  function refillTargets() {
    while (tgtSel.firstChild) tgtSel.removeChild(tgtSel.firstChild);
    var names = pert.type === 'kinase' ? D.kinases :
      (pert.type === 'site' ? D.site_names : D.proteins);
    names.forEach(function(nm, i) {
      tgtSel.appendChild(h('option', {value: i, text: nm})); });
    pert.target = 0;
  }
  typeSel.addEventListener('change', function() {
    pert.type = typeSel.value; refillTargets(); refresh(); });
  tgtSel.addEventListener('change', function() {
    pert.target = +tgtSel.value; refresh(); });
  scale.addEventListener('input', function() {
    pert.scale = +scale.value; sval.textContent = pert.scale.toFixed(2);
    refresh(); });
  tmaxIn.addEventListener('input', function() {
    tMax = +tmaxIn.value; tval.textContent = tMax + ' min';
    wt = null; refresh(); });
  function wrap(lbl, el, val) {
    var c = h('div', {class: 'col'}, pp);
    h('label', {text: lbl}, c); c.appendChild(el);
    if (val) c.appendChild(val);
  }
  wrap('Perturbation', typeSel); wrap('Target', tgtSel);
  wrap('Scale (0 = KO, 1 = WT)', scale, sval);
  wrap('Horizon t_max', tmaxIn, tval);
  refillTargets();

  var ps = h('select', {id: 'protSel'});
  D.proteins.forEach(function(nm, i) {
    ps.appendChild(h('option', {value: i, text: nm})); });
  ps.addEventListener('change', function() {
    selProt = +ps.value; buildParamSliders(); refresh(); });
  var pc = document.getElementById('protPanel');
  var c = h('div', {class: 'col'}, pc);
  h('label', {text: 'Inspect protein'}, c); c.appendChild(ps);
  var rb = h('button', {text: 'Reset parameters'}, pc);
  rb.addEventListener('click', function() {
    cur.A = P0.A.slice(); cur.B = P0.B.slice(); cur.C = P0.C.slice();
    cur.Dd = P0.Dd.slice(); cur.E = P0.E.slice(); cur.tf = P0.tf.slice();
    cur.Dp = P0.Dp.map(function(r){return r.slice();});
    wt = null; buildParamSliders(); refresh(); });
}

function buildParamSliders() {
  var host = document.getElementById('paramPanel');
  while (host.firstChild) host.removeChild(host.firstChild);
  paramInputs = [];
  var n = selProt;
  var defs = [['A (synthesis)', 'A'], ['B (mRNA decay)', 'B'],
              ['C (translation)', 'C'], ['D (protein decay)', 'Dd'],
              ['E (dephospho)', 'E'], ['tf_scale', 'tf']];
  defs.forEach(function(d) {
    var v0 = cur[d[1]][n];
    addSlider(host, d[0], v0, function(v) { cur[d[1]][n] = v; });
  });
  for (var j = 0; j < D.n_sites[n]; j++) (function(j) {
    addSlider(host, 'Dp site ' + D.sites[n][j], cur.Dp[n][j],
              function(v) { cur.Dp[n][j] = v; });
  })(j);
}
function addSlider(host, label, v0, setter) {
  var c = h('div', {class: 'col'}, host);
  h('label', {text: label}, c);
  var lo = Math.log10(Math.max(v0, 1e-4) / 30),
      hi2 = Math.log10(Math.max(v0, 1e-4) * 30);
  var inp = h('input', {type: 'range', min: lo, max: hi2,
    step: (hi2 - lo) / 200, value: Math.log10(Math.max(v0, 1e-4))}, c);
  var sv = h('span', {class: 'val', text: v0.toPrecision(4)}, c);
  inp.addEventListener('input', function() {
    var v = Math.pow(10, +inp.value);
    sv.textContent = v.toPrecision(4); setter(v); wt = null; refresh();
  });
}

var raf = null;
function refresh() {
  if (raf) return;
  raf = requestAnimationFrame(function() { raf = null; render(); });
}

function render() {
  var t0 = performance.now();
  if (!wt) {                       // wild type at current parameter edits
    var saved = pert.type; pert.type = 'none';
    wt = solveAll(); pert.type = saved;
  }
  cache = (pert.type === 'none') ? wt : solveAll();
  var times = cache.times, obs = cache.obs, n = selProt;
  var dp = D.data && D.data.prot[n] ? D.data.prot[n] : null;
  var dr = D.data && D.data.rna[n] ? D.data.rna[n] : null;
  drawPlot(document.getElementById('plotP'), times, [
    {y: wt.obs.P.map(function(r){return r[n];}), color: '#9aa3b2', dash: 1},
    {y: obs.P.map(function(r){return r[n];}), color: '#2563eb'}],
    dp, D.proteins[n] + ' — total protein FC');
  drawPlot(document.getElementById('plotR'), times, [
    {y: wt.obs.R.map(function(r){return r[n];}), color: '#9aa3b2', dash: 1},
    {y: obs.R.map(function(r){return r[n];}), color: '#059669'}],
    dr, D.proteins[n] + ' — mRNA FC');
  var phSeries = [], colors = ['#dc2626', '#d97706', '#7c3aed', '#0891b2',
                               '#be185d', '#4d7c0f', '#b45309', '#1d4ed8'];
  for (var j = 0; j < D.n_sites[n]; j++) {
    phSeries.push({y: wt.obs.PH.map(function(r){return r[n][j];}),
                   color: '#c9cfda', dash: 1, width: 1.2});
    phSeries.push({y: obs.PH.map(function(r){return r[n][j];}),
                   color: colors[j % colors.length]});
  }
  var dph = D.data && D.data.pho[n] ? D.data.pho[n] : null;
  drawPlot(document.getElementById('plotPh'), times, phSeries, dph,
           D.proteins[n] + ' — per-site phospho FC');

  // network impact: top |log2 perturbed/WT| of total protein at t_max
  var last = times.length - 1, rows = [];
  for (var i = 0; i < N; i++) {
    var a = obs.P[last][i], b = wt.obs.P[last][i];
    rows.push([i, Math.log2(Math.max(a, 1e-12) / Math.max(b, 1e-12))]);
  }
  rows.sort(function(x, y) { return Math.abs(y[1]) - Math.abs(x[1]); });
  var tb = document.getElementById('impact');
  while (tb.firstChild) tb.removeChild(tb.firstChild);
  rows.slice(0, 12).forEach(function(r) {
    var tr = h('tr', {}, tb);
    h('td', {text: D.proteins[r[0]]}, tr);
    h('td', {text: (r[1] >= 0 ? '+' : '') + r[1].toFixed(3)}, tr);
  });
  document.getElementById('solveMs').textContent =
    (performance.now() - t0).toFixed(0) + ' ms';
  // integrator health badge: a stiff parameter edit can exhaust the
  // per-segment step cap — show the failure instead of silently
  // plotting the truncated trajectory
  var warn = document.getElementById('intWarn');
  if (warn) {
    var bad = !(cache.ok && wt.ok);
    warn.style.display = bad ? 'inline-block' : 'none';
    warn.textContent = bad ?
      'integration did not converge — trajectory truncated' : '';
  }
  window.__lastSolve = cache;      // test hook
}

buildControls(); buildParamSliders(); render();
"""


def write_live_model_explorer(out_path, system, params, *, title=None,
                              t_max_default=None, df_prot=None, df_rna=None,
                              df_pho=None) -> str:
    """Write the single-file live explorer for a fitted global model.

    params: one member's structured dict (c_k, A_i, B_i, C_i, D_i, Dp_i,
    E_i, tf_scale) of tensors or arrays, as
    :func:`phoskintime_tpu_torch.network.runner.best_params` gives it.
    Optional observed column tables (protein/(psite)/time/fc) overlay their
    points, in row order, on the selected protein's curves.
    """
    topo = system.topo
    grid = np.asarray(system.kin_grid, float)
    t_def = float(t_max_default if t_max_default is not None else grid[-1])

    site_names, site_index = [], []
    for i, p in enumerate(topo.proteins):
        for j, s in enumerate(topo.sites[i]):
            site_names.append(f"{p}:{s}")
            site_index.append([i, j])

    def _text(v) -> str:
        return "nan" if is_missing(v) else str(v)

    def _pts(df, cols, key):
        out = {}
        if df is None:
            return out
        for r in range(n_rows(df)):
            nm = _text(df[cols[0]][r])
            if key == "pho":
                nm = f"{nm}:{_text(df['psite'][r])}"
                if nm not in site_names:
                    continue
                i = site_index[site_names.index(nm)][0]
            elif nm in topo.p2i:
                i = topo.p2i[nm]
            else:
                continue
            out.setdefault(i, []).append([float(df["time"][r]), float(df["fc"][r])])
        return {str(k): v for k, v in out.items()}

    data = None
    if any(d is not None for d in (df_prot, df_rna, df_pho)):
        data = {"prot": _pts(df_prot, ["protein"], "prot"),
                "rna": _pts(df_rna, ["protein"], "rna"),
                "pho": _pts(df_pho, ["protein"], "pho")}

    payload = {
        "model": int(topo.model), "N": topo.N, "K": topo.K,
        "smax": topo.max_sites, "width": topo.width,
        "proteins": topo.proteins, "kinases": topo.kinases,
        "sites": topo.sites, "n_sites": topo.n_sites.tolist(),
        "n_states": topo.n_states.tolist(),
        "site_names": site_names, "site_index": site_index,
        "driver_map": topo.driver_map.tolist(),
        "W": _round(topo.W_pad), "tf_mat": _round(topo.tf_mat),
        "tf_deg": _round(topo.tf_deg),
        "Kmat": _round(system.Kmat), "kin_grid": _round(grid),
        "y0": _round(np.asarray(system.y0(), float).reshape(-1)),
        "params": {k: _round(v) for k, v in params.items()},
        "t_default": t_def, "t_min_slider": max(10.0, float(grid[1])),
        "t_max_slider": max(t_def * 4, float(grid[-1])),
        "data": data,
    }

    # a protein/site name containing '</script>' (or an HTML-bearing
    # title) must not break out of its context: escape the embedded JSON
    # (the '<\\/' form is inert inside a <script> block and identical to
    # JSON.parse) and HTML-escape the title
    import html as _html

    payload_js = json.dumps(payload).replace("</", "<\\/")
    title_esc = _html.escape(title) if title else None

    html = f"""<!doctype html>
<html><head><meta charset="utf-8">
<title>{title_esc or 'live model explorer'}</title>
<style>{_CSS}</style></head>
<body>
<header><h1>{title_esc or 'Live global-model explorer'}</h1>
<div class="sub">slider-driven exact re-simulation of the fitted network
(model {int(topo.model)}, N={topo.N}, K={topo.K}) — solve time
<span id="solveMs">…</span>
<span id="intWarn" style="display:none;margin-left:10px;padding:2px 8px;
border-radius:4px;background:#fef2f2;color:#b91c1c;font-weight:600">
</span></div></header>
<div class="wrap">
  <div class="card"><h2>Perturbation &amp; horizon</h2>
    <div class="row" id="pertPanel"></div>
    <div class="hint">Every slider movement re-integrates the full network
    ODE in the browser (adaptive RK45, bucket-exact kinase input) — the
    same forward model the fit used, not a precomputed lookup.</div>
  </div>
  <div class="card"><div class="row" id="protPanel"></div>
    <div class="pp" id="paramPanel" style="margin-top:10px"></div></div>
  <div class="grid2">
    <div class="card"><svg id="plotP" style="width:100%"></svg></div>
    <div class="card"><svg id="plotR" style="width:100%"></svg></div>
  </div>
  <div class="grid2">
    <div class="card"><svg id="plotPh" style="width:100%"></svg></div>
    <div class="card"><h2>Network impact (log2 FC vs WT at t_max)</h2>
      <table class="imp"><tbody id="impact"></tbody></table></div>
  </div>
</div>
<script>window.__LIVEMODEL__ = {payload_js};</script>
<script>{_lmc.js_constants_block()}</script>
<script>{_JS_MODEL}</script>
<script>{_JS_UI}</script>
</body></html>"""

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
