"""Optimization-network schematics of the kinopt, tfopt and integrated
models, and the fitted kinase network.

Counterpart of ``phoskintime_tpu/report/schematic.py``, drawn by the port's
own drawing layer: six figures (kinopt, tfopt and the integrated model,
each plain and with its constraints annotated) of the bilinear prior
models

  kinopt:  P_i -> S_s via alpha_s;  S_s -> K_k via beta_{k,s};
           each kinase aggregates its protein input K_k(t) via beta_{0,k}
           and PSite_{p,k}(t) via beta_{p,k}
  tfopt:   TF_j aggregates TF_j(t) via beta_{0,j} + PSite_{p,j}(t) via
           beta_{p,j};  TF_j -> P_i via alpha_{i,j}

(the constraint variants note the simplex sums and the [-4, 4] / [0, 1]
box bounds), laid out by :class:`Diagram`: layered ranks, one barycenter
crossing-reduction sweep down and one up, quadratic Bezier edges with
midpoint labels, and notes attached by dashed connectors.
:func:`fitted_network_schematic` draws an actual kinopt fit from its
Alpha/Beta sheets (column dicts): P -> S -> K layers, edge width by
|weight|, coloured by sign, parallel edges into a kinase fanned out, and the
number of edges dropped by the top-N filter in the title. Every figure is
saved at 300 dpi.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from phoskintime_tpu_torch.io.utils import as_numbers, is_missing, n_rows
from phoskintime_tpu_torch.report.draw import (Circle, FancyBboxPatch, Path, PathPatch,
                                               subplots)

COL_P = "#ff1a1a"
COL_S = "#1f77ff"
COL_K = "#7cb518"
COL_INP = "#00a6ff"
COL_ALPHA = "#7cb518"
COL_BETA = "#1f77ff"
COL_NOTE = "#f2f2f2"


@dataclass
class _Node:
    name: str
    label: str
    color: str
    rank: int
    kind: str = "circle"          # "circle" | "note"
    radius: float = 0.42
    x: float = 0.0
    y: float = 0.0


@dataclass
class _Edge:
    a: str
    b: str
    label: str = ""
    color: str = "#555555"
    style: str = "solid"          # "solid" | "dashed"
    width: float = 1.6
    arrow: bool = True
    bend: float = 0.0             # signed perpendicular bezier offset


@dataclass
class Diagram:
    """A small layered-graph renderer: nodes on ranks, edges between them."""

    nodes: dict = field(default_factory=dict)
    edges: list = field(default_factory=list)

    def node(self, name, label, color, rank, kind="circle", radius=0.42):
        self.nodes[name] = _Node(name, label, color, rank, kind, radius)

    def edge(self, a, b, label="", color="#555555", style="solid",
             width=1.6, arrow=True, bend=0.0):
        self.edges.append(_Edge(a, b, label, color, style, width,
                                arrow, bend))

    # ---- layout -----------------------------------------------------------

    def _layout(self, xgap=1.9, ygap=2.1):
        ranks: dict[int, list[_Node]] = {}
        for n in self.nodes.values():
            ranks.setdefault(n.rank, []).append(n)
        order = sorted(ranks)
        # initial x = insertion order; then one barycenter sweep down and
        # one up to reduce crossings (enough for these shallow DAGs)
        for r in order:
            for i, n in enumerate(ranks[r]):
                n.x = float(i)
        nbrs: dict[str, list[str]] = {}
        for e in self.edges:
            nbrs.setdefault(e.a, []).append(e.b)
            nbrs.setdefault(e.b, []).append(e.a)
        for sweep in (order[1:], order[-2::-1]):
            for r in sweep:
                def bary(n):
                    xs = [self.nodes[m].x for m in nbrs.get(n.name, [])
                          if m in self.nodes and self.nodes[m].rank != r]
                    return np.mean(xs) if xs else n.x
                ranks[r].sort(key=bary)
                for i, n in enumerate(ranks[r]):
                    n.x = float(i)
        # center each rank, assign physical coordinates
        for r in order:
            row = ranks[r]
            off = (len(row) - 1) / 2.0
            for n in row:
                n.x = (n.x - off) * xgap
                n.y = -r * ygap
        return ranks

    # ---- rendering --------------------------------------------------------

    def render(self, outfile, title="", figwidth=None):
        self._layout()
        xs = [n.x for n in self.nodes.values()]
        ys = [n.y for n in self.nodes.values()]
        w = max(xs) - min(xs) + 4.0
        h = max(ys) - min(ys) + 3.0
        fig, ax = subplots(figsize=(figwidth or max(6.0, 0.9 * w), max(4.0, 0.9 * h)))
        ax.set_xlim(min(xs) - 2.0, max(xs) + 2.0)
        ax.set_ylim(min(ys) - 1.5, max(ys) + 1.5)
        ax.set_aspect("equal")
        ax.axis("off")
        if title:
            ax.set_title(title, fontsize=13)

        for e in self.edges:
            a, b = self.nodes[e.a], self.nodes[e.b]
            self._draw_edge(ax, a, b, e)
        for n in self.nodes.values():
            self._draw_node(ax, n)

        fig.savefig(outfile, dpi=300, bbox_inches="tight")
        return outfile

    def _draw_node(self, ax, n):
        if n.kind == "note":
            ax.add_patch(FancyBboxPatch(
                (n.x - 1.25, n.y - 0.55), 2.5, 1.1,
                boxstyle="round,pad=0.08", fc=n.color, ec="#888888",
                lw=1.0, zorder=3))
            ax.text(n.x, n.y, n.label, ha="center", va="center",
                    fontsize=7.5, zorder=4)
        else:
            ax.add_patch(Circle((n.x, n.y), n.radius, fc=n.color,
                                ec="black", lw=1.6, zorder=3))
            ax.text(n.x, n.y, n.label, ha="center", va="center",
                    fontsize=10, zorder=4, color="black")

    def _trim(self, a, b, e):
        """Endpoints pulled back to the node boundaries."""
        v = np.array([b.x - a.x, b.y - a.y], float)
        d = np.hypot(*v) or 1.0
        u = v / d
        ra = a.radius if a.kind == "circle" else 0.6
        rb = b.radius if b.kind == "circle" else 0.6
        p0 = np.array([a.x, a.y]) + u * ra
        p1 = np.array([b.x, b.y]) - u * rb
        return p0, p1, u

    def _draw_edge(self, ax, a, b, e):
        p0, p1, u = self._trim(a, b, e)
        mid = (p0 + p1) / 2.0
        perp = np.array([-u[1], u[0]])
        ctrl = mid + perp * e.bend
        path = Path([p0, ctrl, p1], [Path.MOVETO, Path.CURVE3, Path.CURVE3])
        ax.add_patch(PathPatch(path, fc="none", ec=e.color, lw=e.width,
                               linestyle="--" if e.style == "dashed" else "-", zorder=1))
        if e.arrow:
            tip = p1
            back = 0.88 * p1 + 0.12 * ctrl
            ax.annotate("", xy=tuple(tip), xytext=tuple(back),
                        arrowprops=dict(arrowstyle="-|>", color=e.color,
                                        lw=e.width), zorder=2)
        if e.label:
            lp = mid + perp * (e.bend * 0.6 + 0.28)
            ax.text(lp[0], lp[1], e.label, ha="center", va="center",
                    fontsize=8.5, color="black", zorder=5,
                    bbox=dict(boxstyle="round,pad=0.12", fc="white",
                              ec="none", alpha=0.85))


# ---------------------------------------------------------------------------
# the six model schematics
# ---------------------------------------------------------------------------

_KIN_S = ("S1", "S2")
_KIN_K = ("K1", "K2", "K3", "K4")
_KIN_BETA = (("S1", "K1"), ("S1", "K2"), ("S2", "K3"), ("S2", "K4"))


def _bounds(txt):
    return "\n" + txt  # second line under the symbol, small


def kinopt_schematic(outfile, *, kin_psites=1, constraints=False):
    """The kinopt model's schematic (with ``constraints``, its bounds and
    simplex sums noted)."""
    d = Diagram()
    d.node("P", r"$P_i$", COL_P, 0)
    for i, s in enumerate(_KIN_S, 1):
        d.node(s, rf"$S_{i}$", COL_S, 1)
        lbl = rf"$\alpha_{i}$" + (_bounds("[0,1]") if constraints else "")
        d.edge("P", s, lbl, COL_ALPHA)
    for k, kn in enumerate(_KIN_K, 1):
        d.node(kn, rf"$K_{k}$", COL_K, 2)
    for s, kn in _KIN_BETA:
        si, ki = int(s[1]), int(kn[1])
        lbl = rf"$\beta_{{{ki},{si}}}$" + (
            _bounds("[-4,4]") if constraints else "")
        d.edge(s, kn, lbl, COL_BETA)
    for k, kn in enumerate(_KIN_K, 1):
        d.node(f"{kn}_0", rf"$K_{k}(t)$", COL_INP, 3, radius=0.5)
        d.edge(f"{kn}_0", kn, rf"$\beta_{{0,{k}}}$", COL_BETA)
        for p in range(1, kin_psites + 1):
            nm = f"{kn}_p{p}"
            d.node(nm, rf"$\mathrm{{PS}}_{{{p},{k}}}(t)$", COL_INP, 3,
                   radius=0.5)
            d.edge(nm, kn, rf"$\beta_{{{p},{k}}}$", COL_BETA)
    if constraints:
        d.node("NA", (r"$\sum_s \alpha_s = 1$" "\n" r"$\alpha_s \in [0,1]$"),
               COL_NOTE, 1, kind="note")
        for s in _KIN_S:
            d.edge("NA", s, "", "#999999", style="dashed", arrow=False)
        d.node("NB", (r"$\sum_{p} \beta_{p,k} = 1$" "\n"
                      r"$\beta \in [-4,4]$"), COL_NOTE, 2, kind="note")
        for kn in _KIN_K:
            d.edge("NB", kn, "", "#999999", style="dashed", arrow=False)
    return d.render(outfile, title="kinopt: $\\hat{P}_i = \\sum_j "
                                   r"\alpha_{i,j} A_j(t)$")


def tfopt_schematic(outfile, *, tf_psites=1, constraints=False):
    """The tfopt model's schematic (with ``constraints``, its bounds and
    simplex sums noted)."""
    d = Diagram()
    tfs = ("TF1", "TF2")
    for j, tf in enumerate(tfs, 1):
        d.node(f"{tf}_0", rf"$TF_{j}(t)$", COL_INP, 0, radius=0.5)
        for p in range(1, tf_psites + 1):
            d.node(f"{tf}_p{p}", rf"$\mathrm{{PS}}_{{{p},{j}}}(t)$",
                   COL_INP, 0, radius=0.5)
        d.node(tf, rf"$TF_{j}$", COL_S, 1)
        d.edge(f"{tf}_0", tf, rf"$\beta_{{0,{j}}}$" + (
            _bounds("[-4,4]") if constraints else ""), COL_BETA)
        for p in range(1, tf_psites + 1):
            d.edge(f"{tf}_p{p}", tf, rf"$\beta_{{{p},{j}}}$", COL_BETA)
    d.node("P", r"$P_i$", COL_P, 2)
    for j, tf in enumerate(tfs, 1):
        d.edge(tf, "P", rf"$\alpha_{{i,{j}}}$" + (
            _bounds("[0,1]") if constraints else ""), COL_ALPHA)
    if constraints:
        d.node("NA", (r"$\sum_j \alpha_{i,j} = 1$" "\n"
                      r"$\alpha \in [0,1]$"), COL_NOTE, 2, kind="note")
        d.edge("NA", "P", "", "#999999", style="dashed", arrow=False)
        d.node("NB", (r"$\sum_p \beta_{p,j} = 1$" "\n"
                      r"$\beta \in [-4,4]$"), COL_NOTE, 1, kind="note")
        for tf in tfs:
            d.edge("NB", tf, "", "#999999", style="dashed", arrow=False)
    return d.render(outfile, title=r"tfopt: $\hat{R}_g = \sum_r "
                                   r"\alpha_{g,r}\,[\beta_{r,0} TF_r + "
                                   r"\sum_k \beta_{r,k} PS_{r,k}]$")


def global_schematic(outfile, *, kin_psites=1, tf_psites=1,
                     constraints=False):
    """The integrated kinopt + tfopt schematic around the shared P hub (with
    ``constraints``, its bounds and simplex sums noted)."""
    d = Diagram()
    tfs = ("TF1", "TF2")
    # tfopt module feeds the shared hub from above
    for j, tf in enumerate(tfs, 1):
        d.node(f"{tf}_0", rf"$TF_{j}(t)$", COL_INP, 0, radius=0.5)
        d.node(tf, rf"$TF_{j}$", COL_S, 1)
        d.edge(f"{tf}_0", tf, rf"$\beta_{{0,{j}}}$", COL_BETA)
        for p in range(1, tf_psites + 1):
            d.node(f"{tf}_p{p}", rf"$\mathrm{{PS}}_{{{p},{j}}}(t)$",
                   COL_INP, 0, radius=0.5)
            d.edge(f"{tf}_p{p}", tf, rf"$\beta_{{{p},{j}}}$", COL_BETA)
        d.edge(tf, "P", rf"$\alpha_{{i,{j}}}$" + (
            _bounds("[0,1]") if constraints else ""), COL_ALPHA)
    d.node("P", r"$P_i$", COL_P, 2, radius=0.5)
    # kinopt module hangs off the hub below
    for i, s in enumerate(_KIN_S, 1):
        d.node(s, rf"$S_{i}$", COL_S, 3)
        d.edge("P", s, rf"$\alpha_{i}$" + (
            _bounds("[0,1]") if constraints else ""), COL_ALPHA)
    for k, kn in enumerate(_KIN_K, 1):
        d.node(kn, rf"$K_{k}$", COL_K, 4)
    for s, kn in _KIN_BETA:
        si, ki = int(s[1]), int(kn[1])
        d.edge(s, kn, rf"$\beta_{{{ki},{si}}}$" + (
            _bounds("[-4,4]") if constraints else ""), COL_BETA)
    for k, kn in enumerate(_KIN_K, 1):
        d.node(f"{kn}_0", rf"$K_{k}(t)$", COL_INP, 5, radius=0.5)
        d.edge(f"{kn}_0", kn, rf"$\beta_{{0,{k}}}$", COL_BETA)
        for p in range(1, kin_psites + 1):
            d.node(f"{kn}_p{p}", rf"$\mathrm{{PS}}_{{{p},{k}}}(t)$",
                   COL_INP, 5, radius=0.5)
            d.edge(f"{kn}_p{p}", kn, rf"$\beta_{{{p},{k}}}$", COL_BETA)
    if constraints:
        d.node("NC", (r"$\sum \alpha = 1$ per target" "\n"
                      r"$\sum_p \beta_{p,\cdot} = 1$ per source" "\n"
                      r"$\alpha \in [0,1],\ \beta \in [-4,4]$"),
               COL_NOTE, 2, kind="note")
        d.edge("NC", "P", "", "#999999", style="dashed", arrow=False)
    return d.render(outfile, title="integrated kinopt + tfopt")


def render_all_schematics(out_dir, *, kin_psites=1, tf_psites=1):
    """All six schematics as ``<name>.png`` in ``out_dir``: {name: path}."""
    os.makedirs(str(out_dir), exist_ok=True)
    paths = {}
    for name, fn, kw in [
        ("kinopt_diagram", kinopt_schematic, dict(kin_psites=kin_psites)),
        ("kinopt_constraints", kinopt_schematic,
         dict(kin_psites=kin_psites, constraints=True)),
        ("tfopt_diagram", tfopt_schematic, dict(tf_psites=tf_psites)),
        ("tfopt_constraints", tfopt_schematic,
         dict(tf_psites=tf_psites, constraints=True)),
        ("global_diagram", global_schematic,
         dict(kin_psites=kin_psites, tf_psites=tf_psites)),
        ("global_constraints", global_schematic,
         dict(kin_psites=kin_psites, tf_psites=tf_psites,
              constraints=True)),
    ]:
        paths[name] = fn(os.path.join(str(out_dir), f"{name}.png"), **kw)
    return paths


# ---------------------------------------------------------------------------
# the fitted network of a kinopt result
# ---------------------------------------------------------------------------

def fitted_network_schematic(alpha_df: dict, beta_df: dict | None, outfile, *, top_edges=60,
                             min_weight=1e-3, logger=None):
    """The layered P -> S -> K diagram of a kinopt fit.

    ``alpha_df``: the Alpha Values sheet (Gene, Psite, Kinase, Alpha) as a
    column dict; ``beta_df``: the Beta Values sheet (Kinase, Psite, Beta)
    or None. The edges of |alpha| >= ``min_weight`` by |alpha| descending
    (pandas' quicksort), the first ``top_edges`` of them drawn, each as wide
    as its share of the largest and red where negative; the title says how
    many weaker ones were dropped. Each kinase's global beta (empty Psite;
    without such rows, its betas summed) is a note under it."""
    from phoskintime_tpu_torch.io.export import sort_desc

    alpha = as_numbers(alpha_df["Alpha"])
    kept = np.flatnonzero(np.abs(alpha) >= min_weight)
    absw = np.abs(alpha[kept])
    rows = kept[sort_desc(absw)]
    dropped = max(0, len(rows) - top_edges)
    rows = rows[:top_edges]
    if dropped and logger is not None:
        logger.info("fitted_network_schematic: dropped %d weakest alpha edges (top_edges=%d)",
                    dropped, top_edges)
    gene, psite, kinase = (np.asarray(alpha_df[c], dtype=object)[rows]
                           for c in ("Gene", "Psite", "Kinase"))

    d = Diagram()
    for g in dict.fromkeys(gene):
        d.node(f"g:{g}", g, COL_P, 0, radius=0.5)
    for g, s in dict.fromkeys(zip(gene, psite)):
        d.node(f"s:{g}:{s}", s, COL_S, 1, radius=0.5)
        d.edge(f"g:{g}", f"s:{g}:{s}", "", "#bbbbbb", width=0.8, arrow=False)
    kins = list(dict.fromkeys(kinase))
    for k in kins:
        d.node(f"k:{k}", k, COL_K, 2, radius=0.5)

    wmax = float(np.abs(alpha[rows]).max()) if len(rows) else float("nan")
    wmax = wmax or 1.0
    # parallel edges into one kinase fanned out by a small alternating bend
    fanin: dict[str, int] = {}
    for g, s, k, a in zip(gene, psite, kinase, alpha[rows]):
        node = f"k:{k}"
        i = fanin.get(node, 0)
        fanin[node] = i + 1
        d.edge(f"s:{g}:{s}", node, "", COL_BETA if a >= 0 else "#d62728",
               width=0.6 + 2.6 * abs(a) / wmax, bend=0.18 * ((i % 5) - 2))

    if beta_df is not None and n_rows(beta_df):
        sites = ["nan" if is_missing(v) else str(v) for v in beta_df["Psite"]]
        beta = as_numbers(beta_df["Beta"])
        glob = [i for i, v in enumerate(sites) if v == ""]
        if glob:
            bmap = {beta_df["Kinase"][i]: beta[i] for i in glob}
        else:
            bmap = {}
            for i, k in enumerate(beta_df["Kinase"]):
                if not is_missing(k):
                    bmap[k] = bmap.get(k, 0.0) + (0.0 if np.isnan(beta[i]) else beta[i])
        for k in kins:
            if k in bmap:
                d.node(f"b:{k}", rf"$\Sigma\beta$={bmap[k]:.2f}", COL_NOTE, 3, kind="note")
                d.edge(f"b:{k}", f"k:{k}", "", "#999999", style="dashed", arrow=False)

    title = "fitted kinase network"
    if dropped:
        title += f"  (top {top_edges} edges, {dropped} weaker dropped)"
    return d.render(outfile, title=title)
