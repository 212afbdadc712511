"""The drawing layer's scene: figures, 2-D and 3-D axes, and what they draw.

The API is the small part of matplotlib's that the figure writers use, with
matplotlib's defaults (font sizes, line widths, the tab10 colour cycle,
5% autoscale margins, subplot parameters), so that a writer reads as its
JAX counterpart does:

* :func:`subplots` / :class:`Figure` (``add_subplot``, ``suptitle``,
  ``colorbar`` of an image, a colour-mapped scatter or filled contours,
  ``tight_layout``, ``savefig`` to PNG);
* :class:`Axes`: ``plot`` (line styles ``-`` and ``--``, the markers of
  :data:`~phoskintime_tpu_torch.report.draw.display.MARKERS`, marker edge
  and face colours), ``semilogy``, ``step`` (``where="post"``),
  ``axvline``, ``scatter`` (one colour, a colour a point or values through
  a colormap; edge colours), ``bar`` and ``barh`` (numbers or categories,
  a base, edge colours, a legend label), ``hist``, ``errorbar``,
  ``fill_between``, ``text`` and ``annotate`` (offset points, an arrow),
  ``add_patch`` (:class:`Circle`), ``boxplot`` and ``violinplot``
  (matplotlib's statistics: :func:`boxplot_stats`, :func:`violin_stats`),
  ``contourf`` (matplotlib's levels), ``imshow`` (nearest, ``aspect``
  "auto" or "equal"), titles, labels, scales (linear, log, symlog),
  limits, explicit ticks and tick labels, ``tick_params``, ``set_aspect``,
  ``grid``, ``legend`` (best, a corner, or below the axes), ``axis("off")``;
* :class:`Axes3D`: ``scatter`` with limits and ``view_init`` (an
  orthographic view);
* :class:`PdfPages` (several pages to one PDF) and :class:`FuncAnimation`
  (frames to an animated GIF).

:meth:`Figure.record` gives what a figure draws as plain data (the record
the CPU tests hold against matplotlib's figures): the size, dpi and
suptitle; for each axes in order (a colorbar marked) its title, labels,
scales, limits where set, explicit or categorical ticks and their labels
and style, grid, whether it is off, its legend texts, and each line,
scatter, bar, patch, text, collection (fills, segments, filled contours)
and image with its data, colours and label; a 3-D axes' view angles. The
pixels are the port's own (:mod:`raster`, :mod:`pdf`, :mod:`font`); only
the record follows matplotlib's.
"""

from __future__ import annotations

import math

import numpy as np

from phoskintime_tpu_torch.report.draw import font, scale as sc
from phoskintime_tpu_torch.report.draw.colors import TAB10, map_values, to_rgba
from phoskintime_tpu_torch.report.draw.display import (MARKERS, Fill, Marks, Picture, Stroke,
                                                       bounds, marker_polygon)
from phoskintime_tpu_torch.report.draw.gif import write_gif
from phoskintime_tpu_torch.report.draw.pdf import PdfDocument
from phoskintime_tpu_torch.report.draw.png import write_png
from phoskintime_tpu_torch.report.draw.raster import render

# matplotlib's defaults (rcParams), in points
FONT, TITLE, SUPTITLE = 10.0, 12.0, 12.0
LINE_W, MARKER_SIZE, SCATTER_S = 1.5, 6.0, 36.0
SPINE_W, TICK_LEN, TICK_PAD, LABEL_PAD, TITLE_PAD = 0.8, 3.5, 3.5, 4.0, 6.0
GRID_COLOR, GRID_W = (176 / 255,) * 3, 0.8
DASH = (3.7, 1.6)                     # "--", in line widths
BAR_HEIGHT = 0.8
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2, hspace=0.2)
TIGHT_PAD = 1.08                      # tight_layout's pad, in font sizes
PAD_INCHES = 0.1                      # bbox_inches="tight"'s padding
CBAR_FRACTION, CBAR_PAD, CBAR_ASPECT = 0.15, 0.05, 20.0
LEGEND_ALPHA, LEGEND_EDGE = 0.8, (0.8, 0.8, 0.8, 1.0)
BLACK = (0.0, 0.0, 0.0, 1.0)
LINE_STYLES = {"-": None, "--": DASH, "None": None, "": None, " ": None}


def _arr(v) -> np.ndarray:
    return np.asarray(v, float).ravel()


def _label(label) -> str | None:
    """An artist's legend label: None for none or a hidden one (leading
    underscore), as matplotlib's legend reads it."""
    if label is None:
        return None
    text = str(label)
    return None if text.startswith("_") else text


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def _rot(pts: np.ndarray, deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.column_stack([pts[:, 0] * c - pts[:, 1] * s, pts[:, 0] * s + pts[:, 1] * c])


def _text_box(text: str, size: float, rotation: float) -> tuple[np.ndarray, np.ndarray]:
    """The rotated text box's corners' bounds: (min xy, max xy), y up."""
    w = font.text_width(text, size)
    corners = np.array([[0, -font.descent(size)], [w, -font.descent(size)],
                        [w, font.ascent(size)], [0, font.ascent(size)]], float)
    r = _rot(corners, rotation)
    return r.min(axis=0), r.max(axis=0)


def text_extent(text: str, size: float, rotation: float = 0.0) -> tuple[float, float]:
    """The (width, height) in points of the box of ``text`` rotated by
    ``rotation`` degrees."""
    if not text:
        return 0.0, 0.0
    lo, hi = _text_box(text, size, rotation)
    return float(hi[0] - lo[0]), float(hi[1] - lo[1])


def text_op(text: str, x: float, y: float, size: float, ha: str = "left",
            va: str = "baseline", rotation: float = 0.0, color=BLACK) -> Stroke | None:
    """``text`` as a stroked path anchored at (x, y) (display points, y
    down): the rotated text's box aligned by ``ha`` (left, center, right)
    and ``va`` (top, center, bottom, or the unrotated baseline)."""
    if not text:
        return None
    lo, hi = _text_box(text, size, rotation)
    ox = {"left": -lo[0], "center": -(lo[0] + hi[0]) / 2, "right": -hi[0]}[ha]
    oy = {"top": -hi[1], "center": -(lo[1] + hi[1]) / 2, "bottom": -lo[1],
          "baseline": 0.0}[va]
    lines = []
    for p in font.text_strokes(text, size):
        r = _rot(p, rotation)
        lines.append(np.column_stack([x + r[:, 0] + ox, y - (r[:, 1] + oy)]))
    placed = font.layout(text, size)
    origins = _rot(np.array([[gx, gy] for _, gx, gy, _ in placed]), rotation)
    glyphs = tuple((ch, x + o[0] + ox, y - (o[1] + oy), gs)
                   for (ch, _, _, gs), o in zip(placed, origins))
    return Stroke(lines, color, size * font.STROKE, glyphs=(glyphs, rotation))


# ---------------------------------------------------------------------------
# artists
# ---------------------------------------------------------------------------

class Line:
    zorder = 2

    def __init__(self, x, y, color, ls, marker, lw, ms, alpha, label, drawstyle="default",
                 mec=None, mfc=None, vertical=False):
        self.x, self.y = _arr(x), _arr(y)
        if len(self.x) != len(self.y):
            raise ValueError(f"x and y differ in length: {len(self.x)} and {len(self.y)}")
        if ls not in LINE_STYLES:
            raise ValueError(f"unsupported line style {ls!r}")
        if marker not in MARKERS + ("None",):
            raise ValueError(f"unsupported marker {marker!r}; have {MARKERS}")
        if drawstyle not in ("default", "steps-post"):
            raise ValueError(f"unsupported drawstyle {drawstyle!r}")
        self.color, self.ls, self.marker = to_rgba(color), ls, marker
        self.lw, self.ms, self.alpha, self.label = float(lw), float(ms), alpha, _label(label)
        self.drawstyle = drawstyle
        self.mec = self.color if mec is None else to_rgba(mec)
        self.mfc = self.color if mfc is None else to_rgba(mfc)
        self.vertical = vertical          # axvline: y spans the axes, in axes fractions

    def record(self) -> dict:
        return {"x": self.x, "y": self.y, "color": self.color, "ls": self.ls,
                "marker": self.marker, "lw": self.lw, "ms": self.ms, "alpha": self.alpha,
                "label": self.label, "drawstyle": self.drawstyle,
                "markeredgecolor": self.mec, "markerfacecolor": self.mfc}


class Scatter:
    """Markers at ``offsets`` in one colour or one a point (``colors`` (1
    or n, 4)); ``mapped`` (cmap, vmin, vmax) where the colours come from
    values through a colormap (what a colorbar of it shows); ``edgecolors``
    (1 or n, 4), empty for none."""
    zorder = 1

    def __init__(self, offsets, sizes, colors, alpha, marker, label, edgecolors=None,
                 linewidths=(1.0,), mapped=None, zorder=None, edged=False):
        if marker not in MARKERS:
            raise ValueError(f"unsupported marker {marker!r}; have {MARKERS}")
        self.offsets = np.asarray(offsets, float)
        self.sizes = np.broadcast_to(np.asarray(sizes, float).ravel(),
                                     (max(len(self.offsets), 1),)).copy()
        self.colors = np.atleast_2d(np.asarray(colors, float))
        self.edgecolors = (self.colors if edgecolors is None
                           else np.asarray(edgecolors, float).reshape(-1, 4))
        self.linewidths = np.asarray(linewidths, float).ravel()
        self.alpha, self.marker, self.label = alpha, marker, _label(label)
        self.cmap, self.vmin, self.vmax = mapped if mapped is not None else (None, None, None)
        self.edged = edged
        if zorder is not None:
            self.zorder = zorder

    @property
    def color(self) -> tuple:
        return tuple(float(v) for v in self.colors[0])

    def color_of(self, k: int) -> tuple:
        return tuple(float(v) for v in self.colors[k % len(self.colors)])

    def record(self) -> dict:
        return {"offsets": self.offsets, "sizes": self.sizes[: len(self.offsets)],
                "colors": self.colors, "edgecolors": self.edgecolors,
                "linewidths": self.linewidths, "alpha": self.alpha, "marker": self.marker,
                "label": self.label}


class Rect:
    """One bar (``bar``, ``barh``, ``hist``): x in [x, x + width], y in [y,
    y + height]; ``base`` the axis and value its sticky edge is on."""
    zorder = 1

    def __init__(self, x, y, width, height, color, edgecolor=None, alpha=None, lw=1.0,
                 label=None, base=("y", 0.0)):
        self.x, self.y, self.width, self.height = (float(v) for v in (x, y, width, height))
        self.alpha = alpha
        self.facecolor = to_rgba(color, alpha)
        self.edgecolor = to_rgba("none" if edgecolor is None else edgecolor, alpha)
        self.lw, self.label, self.base = float(lw), _label(label), base

    def get_y(self) -> float:
        return self.y

    def get_width(self) -> float:
        return self.width

    def get_height(self) -> float:
        return self.height

    def set_color(self, color) -> None:
        """The face and the edge, as matplotlib's ``Patch.set_color``."""
        self.facecolor = self.edgecolor = to_rgba(color, self.alpha)

    def record(self) -> dict:
        return {"x": self.x, "y": self.y, "width": self.width, "height": self.height,
                "color": self.facecolor, "edgecolor": self.edgecolor}


class BarContainer(list):
    """The bars of one ``bar``/``barh`` call; its ``label`` is the legend's."""

    def __init__(self, rects, label=None):
        super().__init__(rects)
        self.label = _label(label)


class Circle:
    """A circle patch in data coordinates (``add_patch``); ``color`` sets
    the face and the edge, ``ec`` the edge alone."""
    zorder = 1
    lw = 1.0

    def __init__(self, center, radius, color=None, ec=None, zorder=None):
        self.center, self.radius = tuple(float(v) for v in center), float(radius)
        face = color if color is not None else "C0"
        edge = ec if ec is not None else (color if color is not None else "black")
        self.facecolor, self.edgecolor = to_rgba(face), to_rgba(edge)
        self.label = None
        if zorder is not None:
            self.zorder = zorder

    def outline(self, n: int = 64) -> np.ndarray:
        a = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
        return np.column_stack([self.center[0] + self.radius * np.cos(a),
                                self.center[1] + self.radius * np.sin(a)])

    def record(self) -> dict:
        return {"kind": "circle", "center": self.center, "radius": self.radius,
                "color": self.facecolor, "edgecolor": self.edgecolor}


class PathPatch:
    """A closed polygon patch (a boxplot's box): the vertices as given and
    the first again, as matplotlib closes a path."""
    zorder = 1
    label = None

    def __init__(self, xs, ys, facecolor, edgecolor, lw=1.0):
        pts = np.column_stack([_arr(xs), _arr(ys)])
        self.vertices = np.vstack([pts, pts[:1]])
        self.facecolor, self.edgecolor, self.lw = to_rgba(facecolor), to_rgba(edgecolor), lw

    def outline(self) -> np.ndarray:
        return self.vertices[:-1]

    def record(self) -> dict:
        return {"kind": "path", "vertices": self.vertices, "color": self.facecolor,
                "edgecolor": self.edgecolor}


class Text:
    """A text (``text``) or an annotation (``annotate``): ``text`` at
    ``xytext`` in ``coords`` ("data", or "offset points" from ``xy``),
    with an arrow from there to ``xy`` where ``arrow`` holds its
    arrowprops."""
    zorder = 3
    label = None

    def __init__(self, text, xy, xytext=None, coords="data", arrow=None, ha="left",
                 va="baseline", color="black", size=None, weight="normal"):
        self.text = str(text)
        self.xy = tuple(float(v) for v in xy)
        self.xytext = self.xy if xytext is None else tuple(float(v) for v in xytext)
        if coords not in ("data", "offset points"):
            raise ValueError(f"unsupported text coordinates {coords!r}")
        self.coords, self.arrow = coords, arrow
        if arrow is not None and arrow.get("arrowstyle", "-|>") not in ("-|>", "->", "-"):
            raise ValueError(f"unsupported arrow style {arrow.get('arrowstyle')!r}")
        self.ha, self.va, self.color = ha, va, to_rgba(color)
        self.size, self.weight = float(size or FONT), str(weight)

    def record(self) -> dict:
        arrow = None if self.arrow is None else {
            "style": self.arrow.get("arrowstyle", "-|>"), "lw": float(self.arrow.get("lw", 1.0)),
            "color": to_rgba(self.arrow.get("color", "black"))}
        return {"text": self.text, "xy": self.xy, "xytext": self.xytext, "coords": self.coords,
                "arrow": arrow, "ha": self.ha, "va": self.va, "color": self.color,
                "size": self.size, "weight": self.weight}


class Poly:
    """Filled polygons (``fill_between``, a violin's body): the vertices of
    each as matplotlib's path holds them (closed by the first again)."""
    zorder = 1

    def __init__(self, polys, facecolor, edgecolor=None, alpha=None, label=None):
        self.polys = [np.asarray(p, float) for p in polys]
        self.alpha = alpha
        self.facecolors = np.asarray([to_rgba(facecolor, alpha)], float)
        self.edgecolors = (np.zeros((0, 4)) if edgecolor is None
                           else np.asarray([to_rgba(edgecolor, alpha)], float))
        self.label = _label(label)

    def set_facecolor(self, color) -> None:
        self.facecolors = np.asarray([to_rgba(color, self.alpha)], float)

    def record(self) -> dict:
        return {"kind": "poly", "vertices": np.vstack(self.polys), "facecolors": self.facecolors,
                "edgecolors": self.edgecolors}


class Segments:
    """Line segments of one colour (``errorbar``'s bars, a violin's lines)."""
    zorder = 2
    label = None

    def __init__(self, segments, color, lw):
        self.segments = np.asarray(segments, float).reshape(-1, 2, 2)
        self.colors = np.asarray([to_rgba(color)], float)
        self.linewidths = np.asarray([lw], float)

    def record(self) -> dict:
        return {"kind": "lines", "segments": self.segments, "colors": self.colors,
                "linewidths": self.linewidths}


class Contour:
    """Filled contours of Z on a regular grid (X, Y): the bands between
    ``levels`` coloured at their middles through ``cmap`` over (levels[0],
    levels[-1]), as matplotlib's ``contourf`` colours its layers."""
    zorder = 1
    label = None

    def __init__(self, X, Y, Z, levels, cmap, alpha):
        self.X, self.Y, self.Z = (np.asarray(a, float) for a in (X, Y, Z))
        self.levels = np.asarray(levels, float)
        self.cmap, self.alpha = cmap, alpha
        self.vmin, self.vmax = float(self.levels[0]), float(self.levels[-1])
        map_values(np.zeros(1), cmap, 0.0, 1.0)         # an unknown colormap raises here

    def layer_colors(self) -> np.ndarray:
        layers = 0.5 * (self.levels[:-1] + self.levels[1:])
        rgba = map_values(layers, self.cmap, self.vmin, self.vmax)
        rgba[:, 3] = 1.0 if self.alpha is None else self.alpha
        return rgba

    def rgba(self, n: int = 160) -> np.ndarray:
        """The bands on an n x n grid over the data's range, row 0 at the
        top (bilinear in Z; cells outside every band transparent)."""
        xs = np.linspace(self.X.min(), self.X.max(), n)
        ys = np.linspace(self.Y.max(), self.Y.min(), n)
        gx, gy = self.X[0], self.Y[:, 0]
        fi = np.interp(ys, gy, np.arange(len(gy), dtype=float))
        fj = np.interp(xs, gx, np.arange(len(gx), dtype=float))
        i0 = np.clip(np.floor(fi).astype(int), 0, len(gy) - 2)
        j0 = np.clip(np.floor(fj).astype(int), 0, len(gx) - 2)
        ti, tj = (fi - i0)[:, None], (fj - j0)[None, :]
        Z = self.Z
        z = ((1 - ti) * (1 - tj) * Z[i0][:, j0] + (1 - ti) * tj * Z[i0][:, j0 + 1]
             + ti * (1 - tj) * Z[i0 + 1][:, j0] + ti * tj * Z[i0 + 1][:, j0 + 1])
        band = np.searchsorted(self.levels, z, side="right") - 1
        band = np.where(z == self.levels[-1], len(self.levels) - 2, band)
        inside = (band >= 0) & (band < len(self.levels) - 1)
        out = np.zeros((n, n, 4))
        out[inside] = self.layer_colors()[band[inside]]
        return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def record(self) -> dict:
        return {"kind": "contourf", "levels": self.levels, "cmap": self.cmap,
                "alpha": self.alpha, "clim": (self.vmin, self.vmax)}


class Image:
    zorder = 0
    label = None

    def __init__(self, array, cmap, vmin, vmax):
        a = np.asarray(array, float)
        if a.ndim != 2:
            raise ValueError(f"imshow draws a 2-D array, got shape {a.shape}")
        self.array = np.where(np.isfinite(a), a, np.nan)   # matplotlib masks ±inf with NaN
        finite = self.array[np.isfinite(self.array)]
        self.cmap = cmap
        self.vmin = float(vmin if vmin is not None else (finite.min() if finite.size else 0.0))
        self.vmax = float(vmax if vmax is not None else (finite.max() if finite.size else 1.0))
        map_values(np.zeros(1), cmap, 0.0, 1.0)         # an unknown colormap raises here

    def rgba(self) -> np.ndarray:
        rgba = map_values(self.array, self.cmap, self.vmin, self.vmax)
        return np.clip(rgba * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def record(self) -> dict:
        return {"array": self.array, "cmap": self.cmap, "vmin": self.vmin, "vmax": self.vmax}


COLLECTIONS = (Poly, Segments, Contour)


class _Axis:
    """One axis' settings: label, scale, explicit limits, ticks and tick
    labels, the categories of a categorical axis, grid."""

    def __init__(self, tick_ha: str):
        self.label, self.label_size = "", FONT
        self.scale = "linear"
        self.lim = None
        self.ticks = self.ticklabels = None
        self.categories: dict | None = None
        self.tick_rotation, self.tick_ha, self.tick_size = 0.0, tick_ha, FONT
        self.grid, self.grid_alpha, self.grid_w = False, None, GRID_W


def _is_text(values) -> bool:
    v = np.asarray(values, dtype=object).ravel()
    return bool(len(v)) and all(isinstance(x, str) for x in v)


def _fill_vertices(t, f1, f2) -> np.ndarray:
    """The polygon ``fill_between(t, f1, f2)`` fills, as matplotlib's path
    holds it: (t0, f2_0), each (t, f1), (tn, f2_n), each (t, f2) backwards,
    and the first again."""
    t, f1, f2 = (np.broadcast_to(_arr(v), (len(_arr(t)),)) for v in (t, f1, f2))
    start, end = np.array([[t[0], f2[0]]]), np.array([[t[-1], f2[-1]]])
    return np.vstack([start, np.column_stack([t, f1]), end,
                      np.column_stack([t, f2])[::-1], start])


def gaussian_kde_1d(data, points) -> np.ndarray:
    """matplotlib's ``mlab.GaussianKDE(data).evaluate(points)`` in one
    dimension (Scott's bandwidth), the same operations in the same order:
    the density a violin is drawn from."""
    dataset = np.atleast_2d(np.asarray(data, float))
    points = np.atleast_2d(np.asarray(points, float))
    n, m = dataset.shape[1], points.shape[1]
    factor = np.power(n, -1.0 / 5)
    data_cov = np.atleast_2d(np.cov(dataset, rowvar=1, bias=False))
    covariance = data_cov * factor ** 2
    inv_cov = np.linalg.inv(data_cov) / factor ** 2
    norm_factor = np.sqrt(np.linalg.det(2 * np.pi * covariance)) * n
    result = np.zeros(m)
    if m >= n:
        for i in range(n):
            diff = dataset[:, i, np.newaxis] - points
            tdiff = np.dot(inv_cov, diff)
            result = result + np.exp(-(np.sum(diff * tdiff, axis=0) / 2.0))
    else:
        for i in range(m):
            diff = dataset - points[:, i, np.newaxis]
            tdiff = np.dot(inv_cov, diff)
            result[i] = np.sum(np.exp(-(np.sum(diff * tdiff, axis=0) / 2.0)), axis=0)
    return result / norm_factor


def violin_stats(data, points: int = 100) -> dict:
    """matplotlib's ``cbook.violin_stats`` of one sample with the violin's
    KDE: coords, vals (the density there), mean, median, min, max."""
    x = np.asarray(data, float).ravel()
    lo, hi = np.min(x), np.max(x)
    coords = np.linspace(lo, hi, points)
    vals = ((x[0] == coords).astype(float) if np.all(x[0] == x)
            else gaussian_kde_1d(x, coords))
    return {"coords": coords, "vals": vals, "mean": np.mean(x), "median": np.median(x),
            "min": lo, "max": hi}


def boxplot_stats(data, whis: float = 1.5) -> dict:
    """matplotlib's ``cbook.boxplot_stats`` of one sample: quartiles by
    linear percentiles, whiskers at the furthest data within ``whis`` IQR
    of the box, the fliers beyond them."""
    x = np.asarray(data, float).ravel()
    if not len(x):
        return {k: np.nan for k in ("mean", "med", "q1", "q3", "iqr", "whislo",
                                    "whishi")} | {"fliers": np.array([])}
    q1, med, q3 = np.percentile(x, [25, 50, 75])
    iqr = q3 - q1
    loval, hival = q1 - whis * iqr, q3 + whis * iqr
    hi = x[x <= hival]
    whishi = q3 if len(hi) == 0 or np.max(hi) < q3 else np.max(hi)
    lo = x[x >= loval]
    whislo = q1 if len(lo) == 0 or np.min(lo) > q1 else np.min(lo)
    return {"mean": np.mean(x), "med": med, "q1": q1, "q3": q3, "iqr": iqr, "whislo": whislo,
            "whishi": whishi, "fliers": np.concatenate([x[x < whislo], x[x > whishi]])}


# ---------------------------------------------------------------------------
# 2-D axes
# ---------------------------------------------------------------------------

class Axes:
    """A 2-D axes in cell ``spec`` = (nrows, ncols, index from 1) of its
    figure's grid."""

    kind = "2d"
    names = ("x", "y")

    def __init__(self, figure, spec):
        self.figure, self.spec = figure, spec
        self.share: list = [self]
        self.colorbar = None
        self.clear()

    def clear(self) -> None:
        self.children: list = []
        self.containers: list = []
        self.title, self.title_size = "", TITLE
        self.dims = {n: _Axis("right" if n == "y" else "center") for n in self.names}
        self.off = False
        self.legend_kw = None
        self.aspect = "auto"
        self._cycle = {"lines": 0, "patches": 0}

    # ---- artists ---------------------------------------------------------
    def _next_color(self, kind: str):
        c = TAB10[self._cycle[kind] % len(TAB10)]
        self._cycle[kind] += 1
        return c

    def _add(self, artist):
        self.children.append(artist)
        return artist

    def _positions(self, name: str, values) -> np.ndarray:
        """Values on axis ``name``: numbers as they are, strings as the
        categories' positions 0, 1, ... in order of first appearance (the
        axis then ticks and labels each, as matplotlib's category axis)."""
        if not _is_text(values):
            return _arr(values)
        a = self.dims[name]
        if a.categories is None:
            a.categories = {}
        for v in np.asarray(values, dtype=object).ravel():
            a.categories.setdefault(str(v), float(len(a.categories)))
        a.ticks = np.asarray(list(a.categories.values()), float)
        a.ticklabels = list(a.categories)
        return np.asarray([a.categories[str(v)] for v in np.asarray(values, dtype=object).ravel()],
                          float)

    def plot(self, *args, color=None, lw=LINE_W, ls=None, marker=None, ms=MARKER_SIZE,
             alpha=None, label=None, mec=None, mfc=None, drawstyle="default"):
        """``plot([x,] y[, fmt], ...)``: one line; ``fmt`` as matplotlib's
        (a colour letter, a marker, a line style: "ko", "k--", "o")."""
        fmt = None
        if args and isinstance(args[-1], str):
            fmt, args = args[-1], args[:-1]
        if len(args) == 1:
            y = _arr(args[0])
            x = np.arange(len(y), dtype=float)
        elif len(args) == 2:
            x, y = args
        else:
            raise TypeError("plot takes y, or x and y, and an optional format string")
        f_color, f_marker, f_ls = _parse_fmt(fmt)
        color = color if color is not None else f_color
        if color is None:
            color = self._next_color("lines")
        ls = ls if ls is not None else f_ls
        marker = marker if marker is not None else f_marker
        if ls is None:
            ls = "None" if f_marker is not None else "-"
        line = Line(x, y, color, ls, marker if marker is not None else "None", lw, ms, alpha,
                    label, drawstyle, mec, mfc)
        return [self._add(line)]

    def semilogy(self, *args, **kw):
        self.set_yscale("log")
        return self.plot(*args, **kw)

    def step(self, x, y, *args, where: str = "pre", **kw):
        """A step line; ``where="post"``: each value held until the next x."""
        if where != "post":
            raise ValueError(f"step draws where='post' only, not {where!r}")
        return self.plot(x, y, *args, drawstyle="steps-post", **kw)

    def axvline(self, x: float = 0.0, color=None, lw=LINE_W, ls="-", label=None):
        """A vertical line at ``x`` across the axes' height."""
        line = Line([x, x], [0.0, 1.0], color if color is not None else "C0", ls, "None", lw,
                    MARKER_SIZE, None, label, vertical=True)
        return self._add(line)

    def scatter(self, x, y, s=None, c=None, color=None, alpha=None, marker="o", label=None,
                cmap=None, edgecolor=None, linewidth=None, zorder=None):
        """Markers at (x, y): ``c`` a colour, colours one a point, or values
        mapped through ``cmap`` over their range; ``edgecolor`` (default:
        the face) and ``linewidth`` the outline."""
        offsets = np.column_stack([_arr(x), _arr(y)])
        colors, mapped = self._scatter_colors(c if c is not None else color, len(offsets),
                                              alpha, cmap)
        edges = None if edgecolor is None else [to_rgba(edgecolor, alpha)]
        coll = Scatter(offsets, SCATTER_S if s is None else s, colors, alpha, marker, label,
                       edgecolors=edges, linewidths=[1.0 if linewidth is None else linewidth],
                       mapped=mapped, zorder=zorder, edged=edgecolor is not None)
        return self._add(coll)

    def _scatter_colors(self, c, n, alpha, cmap):
        if c is None:
            return [to_rgba(self._next_color("patches"), alpha)], None
        if isinstance(c, str) or (isinstance(c, tuple) and len(c) in (3, 4)
                                  and all(isinstance(v, float) for v in c)):
            return [to_rgba(c, alpha)], None
        vals = np.asarray(c, dtype=object).ravel()
        if len(vals) == n and not any(isinstance(v, str) for v in vals):
            v = np.asarray(vals, float)
            lo, hi = float(np.nanmin(v)), float(np.nanmax(v))
            name = cmap or "viridis"
            rgba = map_values(v, name, lo, hi)
            rgba[:, 3] = 1.0 if alpha is None else alpha
            return rgba, (name, lo, hi)
        return [to_rgba(v, alpha) for v in vals], None

    def bar(self, x, height, width=BAR_HEIGHT, bottom=None, align: str = "center", color=None,
            edgecolor=None, linewidth=None, alpha=None, label=None):
        """Vertical bars (matplotlib's ``bar``): bar i spans [x_i - width/2,
        x_i + width/2] ("center") or [x_i, x_i + width] ("edge") and
        [bottom_i, bottom_i + height_i]; ``x`` numbers or categories."""
        xs = self._positions("x", x)
        return self._bars("x", xs, height, width, bottom, align, color, edgecolor, linewidth,
                          alpha, label)

    def barh(self, y, width, height=BAR_HEIGHT, left=None, align: str = "center", color=None,
             edgecolor=None, linewidth=None, alpha=None, label=None):
        """Horizontal bars (``barh``): bar i spans [left_i, left_i +
        width_i] and [y_i - height/2, y_i + height/2]; ``y`` numbers or
        categories."""
        ys = self._positions("y", y)
        return self._bars("y", ys, width, height, left, align, color, edgecolor, linewidth,
                          alpha, label)

    def _bars(self, axis, pos, length, thick, base, align, color, edgecolor, linewidth, alpha,
              label):
        if align not in ("center", "edge"):
            raise ValueError(f"unsupported bar alignment {align!r}")
        pos, length, thick, base = np.broadcast_arrays(
            pos, _arr(length), _arr(thick), _arr(0.0 if base is None else base))
        start = pos - thick / 2 if align == "center" else pos
        if color is None:
            colors = [self._next_color("patches")] * len(pos)
        elif isinstance(color, str) or (isinstance(color, tuple) and len(color) in (3, 4)
                                        and all(isinstance(v, float) for v in color)):
            colors = [color] * len(pos)
        else:
            colors = list(color)
        lw = 1.0 if linewidth is None else float(linewidth)
        rects = []
        for k in range(len(pos)):
            c = colors[k % len(colors)]
            if axis == "x":
                r = Rect(start[k], base[k], thick[k], length[k], c, edgecolor, alpha, lw,
                         base=("y", base[k]))
            else:
                r = Rect(base[k], start[k], length[k], thick[k], c, edgecolor, alpha, lw,
                         base=("x", base[k]))
            rects.append(self._add(r))
        container = BarContainer(rects, label)
        self.containers.append(container)
        return container

    def hist(self, x, bins=10, density: bool = False, alpha=None, color=None, label=None):
        """A histogram (``np.histogram``) as bars from each bin's left edge
        to its right; ``label`` on the first bar. Returns (n, edges,
        bars)."""
        n, edges = np.histogram(_arr(x), bins, density=density)
        totwidth = np.diff(edges)
        centers = edges[:-1] + (0.0 + 0.5 * totwidth)
        c = color if color is not None else self._next_color("patches")
        rects = [self._add(Rect(xc - w / 2, 0.0, w, h, c, None, alpha, 1.0,
                                label=label if k == 0 else None))
                 for k, (xc, w, h) in enumerate(zip(centers, totwidth, n))]
        return n, edges, BarContainer(rects)

    def errorbar(self, x, y, yerr=None, xerr=None, fmt: str = "", ecolor=None,
                 capsize: float = 0.0, lw=None, ms=MARKER_SIZE):
        """Error bars as matplotlib draws them: the data line (none for
        ``fmt="none"``), each error as a segment in ``ecolor`` and, with a
        ``capsize``, a cap marker at each end (x errors first)."""
        x, y = _arr(x), _arr(y)
        width = LINE_W if lw is None else lw
        if fmt.lower() != "none":
            base = self.plot(x, y, fmt, lw=width, ms=ms)[0].color
        else:
            base = to_rgba("C0")
        ecolor = base if ecolor is None else to_rgba(ecolor)
        caps = []
        for axis, err in (("x", xerr), ("y", yerr)):
            if err is None:
                continue
            e = np.asarray(err, float)
            lo, hi = (e[0], e[1]) if e.ndim == 2 else (e, e)
            dep = x if axis == "x" else y
            low, high = dep + (-1.0) * lo, dep + 1.0 * hi
            if axis == "x":
                segs = [[[a, b], [c, b]] for a, b, c in zip(low, y, high)]
            else:
                segs = [[[a, b], [a, c]] for a, b, c in zip(x, low, high)]
            self._add(Segments(segs, ecolor, width))
            if capsize > 0:
                marker = "|" if axis == "x" else "_"
                for ends in (low, high):
                    cx, cy = (ends, y) if axis == "x" else (x, ends)
                    caps.append(Line(cx, cy, base, "None", marker, width, 2.0 * capsize, None,
                                     None, mec=ecolor))
        for cap in caps:
            self._add(cap)
        return caps

    def fill_between(self, x, y1, y2=0.0, color=None, alpha=None):
        """The region between y1 and y2 over x; ``color`` (default: the next
        of the cycle, the face alone) sets the face and the edge."""
        face = color if color is not None else self._next_color("patches")
        return self._add(Poly([_fill_vertices(x, y1, y2)], face, color, alpha))

    def _fill_betweenx(self, y, x1, x2, facecolor, alpha):
        poly = Poly([_fill_vertices(y, x1, x2)[:, ::-1]], facecolor, None, alpha)
        return self._add(poly)

    def text(self, x, y, s, ha: str = "left", va: str = "baseline", fontsize=None,
             color="black", fontweight: str = "normal"):
        return self._add(Text(s, (x, y), None, "data", None, ha, va, color, fontsize, fontweight))

    def annotate(self, text, xy, xytext=None, textcoords=None, arrowprops=None, fontsize=None,
                 fontweight: str = "normal", color="black"):
        """A text at ``xy`` or at ``xytext`` (in ``textcoords``: "data" or
        "offset points"), with an arrow to ``xy`` where ``arrowprops`` is
        given."""
        return self._add(Text(text, xy, xytext, textcoords or "data", arrowprops, "left",
                              "baseline", color, fontsize, fontweight))

    def add_patch(self, patch):
        return self._add(patch)

    def boxplot(self, X, tick_labels=None, patch_artist: bool = False) -> dict:
        """Box plots of each sample of ``X`` at 1, 2, ... as matplotlib's
        ``boxplot(patch_artist=True)`` draws them (:func:`boxplot_stats`;
        the boxes as patches); ticks at the positions labelled
        ``tick_labels``."""
        if not patch_artist:
            raise ValueError("boxplot draws its boxes as patches (patch_artist=True) only")
        stats = [boxplot_stats(x) for x in X]
        positions = np.arange(1, len(stats) + 1)
        width = float(np.clip(0.15 * np.ptp(positions), 0.15, 0.5))
        cap = 0.5 * width
        out = {k: [] for k in ("whiskers", "caps", "boxes", "medians", "fliers")}
        for pos, st in zip(positions, stats):
            box_l, box_r = pos - width * 0.5, pos + width * 0.5
            box_x = [box_l, box_r, box_r, box_l, box_l]
            box_y = [st["q1"], st["q1"], st["q3"], st["q3"], st["q1"]]
            out["boxes"].append(self._add(PathPatch(box_x, box_y, "C0", "black")))
            for ys in ([st["q1"], st["whislo"]], [st["q3"], st["whishi"]]):
                out["whiskers"].append(self.plot([pos, pos], ys, color="black", lw=1.0)[0])
            for v in (st["whislo"], st["whishi"]):
                out["caps"].append(self.plot([pos - cap * 0.5, pos + cap * 0.5], np.full(2, v),
                                             color="black", lw=1.0)[0])
            out["medians"].append(self.plot([box_l, box_r], [st["med"], st["med"]], color="C1",
                                            lw=1.0)[0])
            out["fliers"].append(self.plot(np.full(len(st["fliers"]), pos, dtype=np.float64),
                                           st["fliers"], color="black", ls="None", marker="o",
                                           lw=1.0, mec="black", mfc="none")[0])
        labels = tick_labels if tick_labels is not None else list(positions)
        self.set_xticks(positions)
        self.set_xticklabels([str(v) for v in labels])
        return out

    def violinplot(self, dataset, showmedians: bool = False) -> dict:
        """Violins of each sample at 1, 2, ... as matplotlib's
        ``violinplot`` draws them at its default width 0.5
        (:func:`violin_stats`): each body the KDE scaled to the half width,
        the extrema, the bars between them and, with ``showmedians``, the
        medians as segments in the next line colour."""
        stats = [violin_stats(d) for d in dataset]
        positions = np.arange(1, len(stats) + 1)
        w = np.full(len(stats), 0.5)
        ends = [[-0.25], [0.25]] * w + positions
        color = self._next_color("lines")
        bodies = []
        for st, pos, wd in zip(stats, positions, w):
            vals = np.array(st["vals"])
            vals = 0.5 * wd * vals / vals.max()
            bodies.append(self._fill_betweenx(st["coords"], -vals + pos, vals + pos, color, 0.3))
        out = {"bodies": bodies}

        def hlines(ys):
            return self._add(Segments([[[a, y], [b, y]] for y, a, b in zip(ys, *ends)], color,
                                      LINE_W))
        out["cmaxes"] = hlines([st["max"] for st in stats])
        out["cmins"] = hlines([st["min"] for st in stats])
        out["cbars"] = self._add(Segments(
            [[[p, st["min"]], [p, st["max"]]] for p, st in zip(positions, stats)], color, LINE_W))
        if showmedians:
            out["cmedians"] = hlines([st["median"] for st in stats])
        return out

    def contourf(self, X, Y, Z, levels: int = 10, cmap: str = "viridis", alpha=None):
        """Filled contours of Z on the grid (X, Y) (``np.meshgrid``) at
        matplotlib's levels for ``levels`` bands (``MaxNLocator(levels +
        1)`` over Z's range, trimmed to it)."""
        Z = np.asarray(Z, float)
        zmin, zmax = float(Z.min()), float(Z.max())
        lev = sc.maxn_ticks(zmin, zmax, int(levels) + 1, 1)
        under = np.nonzero(lev < zmin)[0]
        i0 = under[-1] if len(under) else 0
        over = np.nonzero(lev > zmax)[0]
        i1 = over[0] + 1 if len(over) else len(lev)
        if i1 - i0 < 3:
            i0, i1 = 0, len(lev)
        return self._add(Contour(X, Y, Z, lev[i0:i1], cmap, alpha))

    def imshow(self, X, cmap: str = "viridis", vmin=None, vmax=None, aspect: str = "equal",
               interpolation: str | None = None):
        """The array's cells as coloured squares (nearest), row 0 at the
        top, the axes limited to its cells; ``aspect`` "equal" keeps the
        cells square."""
        if interpolation not in (None, "nearest"):
            raise ValueError(f"imshow draws nearest cells only, not {interpolation!r}")
        im = Image(X, cmap or "viridis", vmin, vmax)
        self.set_aspect(aspect)
        self.children.append(im)
        return im

    # ---- settings ----------------------------------------------------------
    def set_title(self, text, fontsize=None):
        self.title, self.title_size = str(text), float(fontsize or TITLE)

    def _set_label(self, name, text, fontsize):
        self.dims[name].label, self.dims[name].label_size = str(text), float(fontsize or FONT)

    def set_xlabel(self, text, fontsize=None):
        self._set_label("x", text, fontsize)

    def set_ylabel(self, text, fontsize=None):
        self._set_label("y", text, fontsize)

    def set_xscale(self, value):
        self.dims["x"].scale = sc.check(value)

    def set_yscale(self, value):
        self.dims["y"].scale = sc.check(value)

    def _set_lim(self, name, lo, hi):
        self.dims[name].lim = (float(lo), float(hi))

    def set_xlim(self, lo, hi):
        self._set_lim("x", lo, hi)

    def set_ylim(self, lo, hi):
        self._set_lim("y", lo, hi)

    def set_aspect(self, aspect: str):
        if aspect not in ("auto", "equal"):
            raise ValueError(f"unsupported aspect {aspect!r}")
        self.aspect = aspect

    def _set_ticks(self, name, ticks):
        self.dims[name].ticks = _arr(ticks)

    def _set_ticklabels(self, name, labels, rotation, ha, fontsize):
        a = self.dims[name]
        a.ticklabels = [str(v) for v in labels]
        if rotation is not None:
            a.tick_rotation = float(rotation)
        if ha is not None:
            a.tick_ha = ha
        if fontsize is not None:
            a.tick_size = float(fontsize)

    def set_xticks(self, ticks):
        self._set_ticks("x", ticks)

    def set_yticks(self, ticks):
        self._set_ticks("y", ticks)

    def set_xticklabels(self, labels, rotation=None, ha=None, fontsize=None):
        self._set_ticklabels("x", labels, rotation, ha, fontsize)

    def set_yticklabels(self, labels, rotation=None, ha=None, fontsize=None):
        self._set_ticklabels("y", labels, rotation, ha, fontsize)

    def tick_params(self, axis: str = "both", rotation=None):
        for name in (("x", "y") if axis == "both" else (axis,)):
            if rotation is not None:
                self.dims[name].tick_rotation = float(rotation)

    def grid(self, visible: bool = True, axis: str = "both", alpha=None, lw=None):
        for name in (("x", "y") if axis == "both" else (axis,)):
            self.dims[name].grid = bool(visible)
            if alpha is not None:
                self.dims[name].grid_alpha = float(alpha)
            if lw is not None:
                self.dims[name].grid_w = float(lw)

    def legend(self, ncol: int = 1, fontsize=None, loc=None, bbox_to_anchor=None):
        """A legend of the labelled artists; ``loc`` "best" (the default) or
        "upper center" (at ``bbox_to_anchor``, in axes fractions, when
        given)."""
        self.legend_kw = {"ncol": int(ncol), "fontsize": float(fontsize or FONT),
                          "loc": loc or "best", "anchor": bbox_to_anchor}

    def get_legend_entries(self) -> list:
        """The labelled artists in matplotlib's order: the children, then
        the bar containers."""
        return ([ch for ch in self.children if ch.label is not None]
                + [c for c in self.containers if c.label is not None and len(c)])

    def axis(self, state: str):
        if state != "off":
            raise ValueError(f"axis({state!r}): only 'off' is supported")
        self.off = True

    # ---- record ------------------------------------------------------------
    def _legend_texts(self) -> list[str]:
        return [e.label for e in self.get_legend_entries()]

    def record(self) -> dict:
        rec = {"kind": self.kind, "title": self.title, "off": self.off,
               "legend": None if self.legend_kw is None else self._legend_texts()}
        for n, a in self.dims.items():
            rec[f"{n}label"] = a.label
            rec[f"{n}lim"] = a.lim
        if self.kind == "2d":
            for n, a in self.dims.items():
                rec[f"{n}scale"] = a.scale
                rec[f"{n}ticks"] = a.ticks
                rec[f"{n}ticklabels"] = a.ticklabels
                rec[f"{n}tickstyle"] = (None if not a.ticklabels
                                        else (a.tick_rotation, a.tick_ha))
            alpha = self.dims["x"].grid_alpha
            rec["grid"] = {"x": self.dims["x"].grid, "y": self.dims["y"].grid,
                           "alpha": alpha if alpha is not None else self.dims["y"].grid_alpha}
        else:
            rec["view"] = (self.elev, self.azim)
        rec["lines"] = [ch.record() for ch in self.children if isinstance(ch, Line)]
        rec["scatters"] = [ch.record() for ch in self.children if isinstance(ch, Scatter)]
        rec["bars"] = [ch.record() for ch in self.children if isinstance(ch, Rect)]
        rec["patches"] = [ch.record() for ch in self.children
                          if isinstance(ch, (Circle, PathPatch))]
        rec["texts"] = [ch.record() for ch in self.children if isinstance(ch, Text)]
        rec["collections"] = [ch.record() for ch in self.children
                              if isinstance(ch, COLLECTIONS)]
        rec["images"] = [ch.record() for ch in self.children if isinstance(ch, Image)]
        if self.kind == "3d":                  # a 3-D scatter's edges are shaded when drawn
            for r in rec["scatters"]:
                r["edgecolors"] = None
        return rec

    # ---- view --------------------------------------------------------------
    def _data(self, name: str) -> tuple[list, list]:
        """The values and sticky edges the axis autoscales to."""
        vals, sticky = [], []
        k = self.names.index(name)
        for ch in self.children:
            if isinstance(ch, Line):
                if not (ch.vertical and name == "y"):
                    vals.append((ch.x, ch.y)[k])
            elif isinstance(ch, Scatter):
                vals.append(ch.offsets[:, k])
            elif isinstance(ch, Rect):
                lo = (ch.x, ch.y)[k]
                vals += [[lo, lo + (ch.width, ch.height)[k]]]
                if ch.base[0] == name:
                    sticky.append(ch.base[1])
            elif isinstance(ch, Circle):
                vals.append([ch.center[k] - ch.radius, ch.center[k] + ch.radius])
            elif isinstance(ch, PathPatch):
                vals.append(ch.vertices[:, k])
            elif isinstance(ch, Poly):
                vals += [p[:, k] for p in ch.polys]
            elif isinstance(ch, Segments):
                vals.append(ch.segments[:, :, k].ravel())
            elif isinstance(ch, Contour):
                g = (ch.X, ch.Y)[k]
                vals.append([g.min(), g.max()])
                sticky += [float(g.min()), float(g.max())]
            elif isinstance(ch, Image):
                n = ch.array.shape[1 - k]
                vals.append([-0.5, n - 0.5])
                sticky += [-0.5, n - 0.5]
        return vals, sticky

    def view(self, name: str) -> tuple[float, float]:
        """The axis' (lo, hi): its limits where set, else autoscaled over
        every axes sharing it; an image's rows run down."""
        a = self.dims[name]
        if a.lim is not None:
            return a.lim
        group = self.share if name == "y" else [self]
        vals, sticky = [], []
        for ax in group:
            v, s = ax._data(name)
            vals += [_arr(x) for x in v]
            sticky += s
        lo, hi = sc.autoscale(a.scale, np.concatenate(vals) if vals else np.zeros(0), sticky)
        if name == "y" and any(isinstance(ch, Image) for ch in self.children):
            lo, hi = hi, lo
        return lo, hi

    # ---- layout ------------------------------------------------------------
    def _ticks(self, name: str, box) -> list[tuple[float, str]]:
        a = self.dims[name]
        lo, hi = self.view(name)
        if a.ticks is not None:
            vals = a.ticks
            labels = a.ticklabels or [f"{v:g}" for v in vals]
            inside = [(v, t) for v, t in zip(vals, labels)
                      if min(lo, hi) - 1e-9 <= v <= max(lo, hi) + 1e-9]
            return inside
        length = box[2] if name == "x" else box[3]
        n = sc.nbins(length, (3.0 if name == "x" else 2.0) * a.tick_size)
        return sc.ticks(a.scale, lo, hi, n)

    def _shows_ylabels(self) -> bool:
        """A y axis shared along a row labels its ticks in the first column
        alone."""
        return len(self.share) == 1 or (self.spec[2] - 1) % self.spec[1] == 0

    def decorations(self, box) -> tuple[float, float, float, float]:
        """The room (left, right, top, bottom) in points that the axes'
        labels, ticks, title and colorbar take outside ``box``."""
        top = (text_extent(self.title, self.title_size)[1] + TITLE_PAD) if self.title else 0.0
        if self.off:
            return 0.0, 0.0, top, 0.0
        plot_box = self._plot_box(box)
        xa, ya = self.dims["x"], self.dims["y"]
        xt = [text_extent(t, xa.tick_size, xa.tick_rotation)
              for _, t in self._ticks("x", plot_box)]
        yt = ([text_extent(t, ya.tick_size, ya.tick_rotation)
               for _, t in self._ticks("y", plot_box)] if self._shows_ylabels() else [])
        left = TICK_LEN + TICK_PAD + max((w for w, _ in yt), default=0.0)
        if ya.label:
            left += text_extent(ya.label, ya.label_size)[1] + LABEL_PAD
        bottom = TICK_LEN + TICK_PAD + max((h for _, h in xt), default=0.0)
        if xa.label:
            bottom += text_extent(xa.label, xa.label_size)[1] + LABEL_PAD
        right = max((w / 2 for w, _ in xt), default=0.0) if xa.tick_ha == "center" else 0.0
        if self.colorbar is not None:
            cb_box = self.colorbar.box(box)
            right = max(right, cb_box[0] + cb_box[2] + self.colorbar.decoration(cb_box)
                        - (box[0] + box[2]))
        return left, right, top, bottom

    def _plot_box(self, box):
        """The box the data fill: less a colorbar's room, shrunk to equal
        data units on both axes for ``aspect`` "equal"."""
        x0, y0, w, h = box
        if self.colorbar is not None:
            w *= 1.0 - CBAR_FRACTION - CBAR_PAD
        if self.aspect == "equal" and self.children:
            (xl, xh), (yl, yh) = self.view("x"), self.view("y")
            ratio = abs(yh - yl) / abs(xh - xl)
            if h / w > ratio:
                y0, h = y0 + (h - w * ratio) / 2, w * ratio
            else:
                x0, w = x0 + (w - h / ratio) / 2, h / ratio
        return x0, y0, w, h

    # ---- drawing -----------------------------------------------------------
    def _transform(self, box):
        x0, y0, w, h = box
        (xl, xh), (yl, yh) = self.view("x"), self.view("y")
        xs, ys = self.dims["x"].scale, self.dims["y"].scale
        fx0, fx1 = sc.forward(xs, xl), sc.forward(xs, xh)
        fy0, fy1 = sc.forward(ys, yl), sc.forward(ys, yh)

        def tx(v):
            return x0 + (sc.forward(xs, v) - fx0) / (fx1 - fx0) * w

        def ty(v):
            return y0 + h - (sc.forward(ys, v) - fy0) / (fy1 - fy0) * h
        return tx, ty

    def draw(self, box, ops: list) -> None:
        pbox = self._plot_box(box)
        x0, y0, w, h = pbox
        clip = (x0, y0, x0 + w, y0 + h)
        tx, ty = self._transform(pbox)
        xt, yt = self._ticks("x", pbox), self._ticks("y", pbox)
        if not self.off:
            for name, ticks in (("x", xt), ("y", yt)):
                a = self.dims[name]
                if not a.grid:
                    continue
                color = (*GRID_COLOR, a.grid_alpha if a.grid_alpha is not None else 1.0)
                lines = ([np.array([[tx(v), y0], [tx(v), y0 + h]]) for v, _ in ticks]
                         if name == "x" else
                         [np.array([[x0, ty(v)], [x0 + w, ty(v)]]) for v, _ in ticks])
                ops.append(Stroke(lines, color, a.grid_w, clip=clip))
        for ch in sorted(self.children, key=lambda c: c.zorder):
            self._draw_artist(ch, tx, ty, clip, pbox, ops)
        if not self.off:
            self._draw_frame(pbox, tx, ty, xt, yt, ops)
        if self.title:
            ops.append(text_op(self.title, x0 + w / 2, y0 - TITLE_PAD, self.title_size,
                               "center", "bottom"))
        if self.legend_kw is not None:
            self._draw_legend(pbox, [self._screen(ch, tx, ty) for ch in self.children], ops)
        if self.colorbar is not None:
            self.colorbar.draw(self.colorbar.box(box), ops)

    @staticmethod
    def _screen(ch, tx, ty) -> np.ndarray:
        if isinstance(ch, Line) and not ch.vertical:
            return np.column_stack([tx(ch.x), ty(ch.y)])
        if isinstance(ch, Scatter):
            return np.column_stack([tx(ch.offsets[:, 0]), ty(ch.offsets[:, 1])])
        if isinstance(ch, Rect):
            return np.array([[tx(ch.x), ty(ch.y)], [tx(ch.x + ch.width), ty(ch.y + ch.height)]])
        return np.zeros((0, 2))

    @staticmethod
    def _marks(pts, marker, size, face, edge, lw, clip, ops) -> None:
        """Markers at ``pts``: filled in ``face`` unless it is transparent,
        outlined in ``edge`` where given."""
        if face[3] > 0:
            ops.append(Marks(pts, marker, size, face, clip))
        if edge is not None and edge[3] > 0 and (face[3] == 0 or edge != face):
            poly = marker_polygon(marker, size)
            ops.append(Stroke([np.vstack([poly, poly[:1]]) + p for p in pts], edge, lw,
                              clip=clip))

    def _draw_artist(self, ch, tx, ty, clip, box, ops) -> None:
        if isinstance(ch, Image):
            n_rows, n_cols = ch.array.shape
            xa, xb = tx(-0.5), tx(n_cols - 0.5)
            ya, yb = ty(-0.5), ty(n_rows - 0.5)
            rgba = ch.rgba()
            if xa > xb:
                rgba, (xa, xb) = rgba[:, ::-1], (xb, xa)
            if ya > yb:
                rgba, (ya, yb) = rgba[::-1], (yb, ya)
            ops.append(Picture(rgba, (float(xa), float(ya), float(xb), float(yb)), clip))
        elif isinstance(ch, Contour):
            rect = (float(tx(ch.X.min())), float(ty(ch.Y.max())), float(tx(ch.X.max())),
                    float(ty(ch.Y.min())))
            ops.append(Picture(ch.rgba(), rect, clip))
        elif isinstance(ch, Rect):
            xa, xb = tx(np.array([ch.x, ch.x + ch.width]))
            ya, yb = ty(np.array([ch.y, ch.y + ch.height]))
            quad = np.array([[xa, ya], [xb, ya], [xb, yb], [xa, yb]])
            if not np.isfinite(quad).all():        # a NaN or infinite bar is not drawn
                return
            if ch.facecolor[3] > 0:
                ops.append(Fill([quad], ch.facecolor, clip))
            if ch.edgecolor[3] > 0:
                ops.append(Stroke([np.vstack([quad, quad[:1]])], ch.edgecolor, ch.lw, clip=clip))
        elif isinstance(ch, (Circle, PathPatch)):
            pts = ch.outline()
            poly = np.column_stack([tx(pts[:, 0]), ty(pts[:, 1])])
            ops.append(Fill([poly], ch.facecolor, clip))
            ops.append(Stroke([np.vstack([poly, poly[:1]])], ch.edgecolor, ch.lw, clip=clip))
        elif isinstance(ch, Poly):
            polys = [np.column_stack([tx(p[:, 0]), ty(p[:, 1])]) for p in ch.polys]
            polys = [p for p in polys if np.isfinite(p).all()]
            if not polys:
                return
            ops.append(Fill(polys, tuple(ch.facecolors[0]), clip))
            if len(ch.edgecolors):
                ops.append(Stroke(polys, tuple(ch.edgecolors[0]), 1.0, clip=clip))
        elif isinstance(ch, Segments):
            lines = [np.column_stack([tx(s[:, 0]), ty(s[:, 1])]) for s in ch.segments]
            ops.append(Stroke(lines, tuple(ch.colors[0]), float(ch.linewidths[0]), clip=clip))
        elif isinstance(ch, Text):
            self._draw_text(ch, tx, ty, ops)
        elif isinstance(ch, Scatter):
            pts = self._screen(ch, tx, ty)
            sizes = ch.sizes[: len(pts)]
            lw = float(ch.linewidths[0])
            keys = [(sizes[k], ch.color_of(k)) for k in range(len(pts))]
            for size, face in dict.fromkeys(keys):
                on = np.asarray([key == (size, face) for key in keys])
                edge = tuple(ch.edgecolors[0]) if ch.edged else None
                self._marks(pts[on], ch.marker, math.sqrt(size), face, edge, lw, clip, ops)
        elif isinstance(ch, Line):
            if ch.vertical:
                xv = float(tx(ch.x[0]))
                pts = np.array([[xv, box[1]], [xv, box[1] + box[3]]])
            else:
                pts = self._screen(ch, tx, ty)
            if ch.drawstyle == "steps-post" and len(pts) > 1:
                mid = np.column_stack([pts[1:, 0], pts[:-1, 1]])
                pts = np.vstack([np.column_stack([pts[:-1], mid]).reshape(-1, 2), pts[-1:]])
            color = to_rgba(ch.color, ch.alpha) if ch.alpha is not None else ch.color
            ok = np.isfinite(pts).all(axis=1)
            if ch.ls not in ("None", "", " "):
                pieces = [pts[s:e] for s, e in _runs(ok)]
                dash = None if LINE_STYLES[ch.ls] is None else tuple(
                    d * ch.lw for d in LINE_STYLES[ch.ls])
                ops.append(Stroke(pieces, color, ch.lw, dash, clip))
            if ch.marker != "None":
                alpha = ch.alpha if ch.alpha is not None else None
                face, edge = (to_rgba(c, alpha) if alpha is not None and c[3] > 0 else c
                              for c in (ch.mfc, ch.mec))
                mpts = self._screen(ch, tx, ty)
                mpts = mpts[np.isfinite(mpts).all(axis=1)]
                self._marks(mpts, ch.marker, ch.ms, face, edge, 1.0, clip, ops)

    def _draw_text(self, t, tx, ty, ops) -> None:
        px, py = float(tx(t.xy[0])), float(ty(t.xy[1]))
        if t.coords == "offset points":
            qx, qy = px + t.xytext[0], py - t.xytext[1]
        else:
            qx, qy = float(tx(t.xytext[0])), float(ty(t.xytext[1]))
        if t.arrow is not None:
            color = to_rgba(t.arrow.get("color", "black"))
            lw = float(t.arrow.get("lw", 1.0))
            d = np.array([px - qx, py - qy])
            length = float(np.hypot(*d))
            if length > 4.0:
                u = d / length
                a, b = np.array([qx, qy]) + 2.0 * u, np.array([px, py]) - 2.0 * u
                head = 4.0 * lw + 2.0
                ops.append(Stroke([np.array([a, b - u * head * 0.5])], color, lw))
                if t.arrow.get("arrowstyle", "-|>") != "-":
                    nrm = np.array([-u[1], u[0]]) * head * 0.35
                    ops.append(Fill([np.array([b, b - u * head + nrm, b - u * head - nrm])],
                                    color))
        rgb = t.color
        ops.append(text_op(t.text, qx, qy, t.size, t.ha, t.va, 0.0, rgb))
        if t.weight == "bold" and t.text:
            ops.append(text_op(t.text, qx + 0.3, qy, t.size, t.ha, t.va, 0.0, rgb))

    def _draw_frame(self, box, tx, ty, xt, yt, ops) -> None:
        x0, y0, w, h = box
        ops.append(Stroke([np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h],
                                     [x0, y0]])], BLACK, SPINE_W))
        xa, ya = self.dims["x"], self.dims["y"]
        ops.append(Stroke([np.array([[tx(v), y0 + h], [tx(v), y0 + h + TICK_LEN]])
                           for v, _ in xt] +
                          [np.array([[x0 - TICK_LEN, ty(v)], [x0, ty(v)]]) for v, _ in yt],
                          BLACK, SPINE_W))
        label_y = y0 + h + TICK_LEN + TICK_PAD
        for v, t in xt:
            ops.append(text_op(t, float(tx(v)), label_y, xa.tick_size, xa.tick_ha, "top",
                               xa.tick_rotation))
        xt_h = max((text_extent(t, xa.tick_size, xa.tick_rotation)[1] for _, t in xt),
                   default=0.0)
        if xa.label:
            ops.append(text_op(xa.label, x0 + w / 2, label_y + xt_h + LABEL_PAD, xa.label_size,
                               "center", "top"))
        yt_w = 0.0
        if self._shows_ylabels():
            label_x = x0 - TICK_LEN - TICK_PAD
            for v, t in yt:
                ops.append(text_op(t, label_x, float(ty(v)), ya.tick_size, ya.tick_ha, "center",
                                   ya.tick_rotation))
            yt_w = max((text_extent(t, ya.tick_size, ya.tick_rotation)[0] for _, t in yt),
                       default=0.0)
        if ya.label:
            ops.append(text_op(ya.label, x0 - TICK_LEN - TICK_PAD - yt_w - LABEL_PAD,
                               y0 + h / 2, ya.label_size, "right", "center", 90.0))

    def _draw_legend(self, box, screens, ops) -> None:
        entries = self.get_legend_entries()
        if not entries:
            return
        draw_legend(entries, box, screens, self.legend_kw, ops)


def _runs(ok: np.ndarray) -> list[tuple[int, int]]:
    """The (start, end) of each run of True."""
    out, start = [], None
    for i, v in enumerate(ok):
        if v and start is None:
            start = i
        elif not v and start is not None:
            out.append((start, i))
            start = None
    if start is not None:
        out.append((start, len(ok)))
    return out


def _parse_fmt(fmt: str | None):
    """A matplotlib format string: (colour, marker, line style), each None
    where absent."""
    if not fmt:
        return None, None, None
    color = marker = ls = None
    rest = fmt
    if "--" in rest:
        ls, rest = "--", rest.replace("--", "")
    elif "-" in rest:
        ls, rest = "-", rest.replace("-", "")
    for ch in rest:
        if ch in "bgrcmykw":
            color = ch
        elif ch in MARKERS:
            marker = ch
        else:
            raise ValueError(f"unsupported format string {fmt!r}")
    return color, marker, ls


def _legend_handle(e, cx, yc, handle, size, ops) -> None:
    """The legend's sample of entry ``e`` at (cx, yc), ``handle`` wide."""
    if isinstance(e, Line):
        color = to_rgba(e.color, e.alpha) if e.alpha is not None else e.color
        if e.ls not in ("None", "", " "):
            dash = None if LINE_STYLES[e.ls] is None else tuple(d * e.lw for d in LINE_STYLES[e.ls])
            ops.append(Stroke([np.array([[cx, yc], [cx + handle, yc]])], color, e.lw, dash))
        if e.marker != "None":
            ops.append(Marks(np.array([[cx + handle / 2, yc]]), e.marker, e.ms, color))
    elif isinstance(e, Scatter):
        ops.append(Marks(np.array([[cx + handle / 2, yc]]), e.marker,
                         math.sqrt(e.sizes[0]), e.color))
    else:
        face = (e[0].facecolor if isinstance(e, BarContainer)
                else tuple(e.facecolors[0]) if isinstance(e, Poly) else e.facecolor)
        h = 0.35 * size
        ops.append(Fill([np.array([[cx, yc - h], [cx + handle, yc - h], [cx + handle, yc + h],
                                   [cx, yc + h]])], face))


def draw_legend(entries, box, screens, kw, ops) -> None:
    """A legend box of ``entries`` (artists with labels): for "upper
    center" its upper centre at ``kw["anchor"]`` (axes fractions; the
    axes' top without one), for "best" in the corner of ``box`` that
    covers the fewest of the data's screen points (upper right first, as
    matplotlib's "best" prefers)."""
    size, ncol = kw["fontsize"], max(1, kw["ncol"])
    pad, handle, gap, row_h = 0.4 * size, 2.0 * size, 0.8 * size, 1.25 * size
    nrow = math.ceil(len(entries) / ncol)
    cols = [entries[c * nrow:(c + 1) * nrow] for c in range(ncol)]
    col_w = [handle + gap + max(font.text_width(e.label, size) for e in col) for col in cols if col]
    bw = 2 * pad + sum(col_w) + 2.0 * size * (len(col_w) - 1) / 2
    bh = 2 * pad + nrow * row_h
    x0, y0, w, h = box
    inset = 0.5 * size
    loc, anchor = kw.get("loc", "best"), kw.get("anchor")
    if loc == "upper center":
        ax_, ay_ = (0.5, 1.0) if anchor is None else anchor
        lx, ly = x0 + ax_ * w - bw / 2, y0 + (1.0 - ay_) * h + (inset if anchor is None else 0.0)
    elif loc == "best":
        corners = [(x0 + w - inset - bw, y0 + inset), (x0 + inset, y0 + inset),
                   (x0 + inset, y0 + h - inset - bh), (x0 + w - inset - bw, y0 + h - inset - bh)]
        pts = np.vstack([s for s in screens if len(s)] or [np.zeros((0, 2))])

        def badness(c):
            inside = ((pts[:, 0] >= c[0]) & (pts[:, 0] <= c[0] + bw)
                      & (pts[:, 1] >= c[1]) & (pts[:, 1] <= c[1] + bh))
            return int(inside.sum())
        lx, ly = min(corners, key=badness)
    else:
        raise ValueError(f"unsupported legend location {loc!r}")
    rect = np.array([[lx, ly], [lx + bw, ly], [lx + bw, ly + bh], [lx, ly + bh]])
    ops.append(Fill([rect], (1.0, 1.0, 1.0, LEGEND_ALPHA)))
    ops.append(Stroke([np.vstack([rect, rect[:1]])], LEGEND_EDGE, SPINE_W))
    cx = lx + pad
    for col, cw in zip(cols, col_w):
        for r, e in enumerate(col):
            yc = ly + pad + (r + 0.5) * row_h
            _legend_handle(e, cx, yc, handle, size, ops)
            ops.append(text_op(e.label, cx + handle + gap, yc, size, "left", "center"))
        cx += cw + size


# ---------------------------------------------------------------------------
# colorbar
# ---------------------------------------------------------------------------

class Colorbar:
    """A vertical colorbar beside its axes: the colormap from the image's
    vmin (bottom) to vmax (top), ticks and ``label`` on the right."""

    kind = "colorbar"

    def __init__(self, image: Image, parent: Axes, label: str, shrink: float):
        self.image, self.parent, self.label, self.shrink = image, parent, str(label), shrink

    def record(self) -> dict:
        return {"kind": self.kind, "label": self.label}

    def box(self, parent_box):
        x0, y0, w, h = parent_box
        ch = h * self.shrink
        cw = min(ch / CBAR_ASPECT, CBAR_FRACTION * w)
        return x0 + w * (1.0 - CBAR_FRACTION), y0 + (h - ch) / 2, cw, ch

    def _ticks(self, box):
        return sc.ticks("linear", self.image.vmin, self.image.vmax, sc.nbins(box[3], 2 * FONT))

    def decoration(self, box) -> float:
        """The room right of the bar its ticks and label take."""
        w = max((text_extent(t, FONT)[0] for _, t in self._ticks(box)), default=0.0)
        extra = text_extent(self.label, FONT)[1] + LABEL_PAD if self.label else 0.0
        return TICK_LEN + TICK_PAD + w + extra

    def draw(self, box, ops) -> None:
        x0, y0, w, h = box
        table = map_values(np.linspace(self.image.vmax, self.image.vmin, 256)[:, None],
                           self.image.cmap, self.image.vmin, self.image.vmax)
        ops.append(Picture(np.clip(table * 255 + 0.5, 0, 255).astype(np.uint8),
                           (x0, y0, x0 + w, y0 + h)))
        ops.append(Stroke([np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h],
                                     [x0, y0]])], BLACK, SPINE_W))
        lo, hi = self.image.vmin, self.image.vmax
        span = hi - lo if hi != lo else 1.0
        ticks = self._ticks(box)
        tick_w = 0.0
        for v, t in ticks:
            y = y0 + h - (v - lo) / span * h
            ops.append(Stroke([np.array([[x0 + w, y], [x0 + w + TICK_LEN, y]])], BLACK, SPINE_W))
            ops.append(text_op(t, x0 + w + TICK_LEN + TICK_PAD, y, FONT, "left", "center"))
            tick_w = max(tick_w, text_extent(t, FONT)[0])
        if self.label:
            ops.append(text_op(self.label, x0 + w + TICK_LEN + TICK_PAD + tick_w + LABEL_PAD,
                               y0 + h / 2, FONT, "left", "center", 90.0))


# ---------------------------------------------------------------------------
# 3-D axes
# ---------------------------------------------------------------------------

BOX_ASPECT = np.array([1.0, 1.0, 0.75])          # matplotlib's (4, 4, 3)
PANE_COLORS = ((0.95, 0.95, 0.95, 1.0), (0.9, 0.9, 0.9, 1.0), (0.925, 0.925, 0.925, 1.0))
FIT_3D = 0.62                                    # the cube's share of the box


class Axes3D(Axes):
    """A 3-D axes for scatter plots, seen orthographically from elevation
    ``elev`` and azimuth ``azim`` (degrees; matplotlib's defaults 30 and
    -60)."""

    kind = "3d"
    names = ("x", "y", "z")

    def __init__(self, figure, spec):
        self.elev, self.azim = 30.0, -60.0
        super().__init__(figure, spec)

    def plot(self, *args, **kw):
        raise NotImplementedError("Axes3D draws scatter plots only")

    def scatter(self, xs, ys, zs, s=None, c=None, color=None, alpha=None, marker="o",
                label=None):
        color = c if c is not None else color
        if color is None:
            color = self._next_color("patches")
        coll = Scatter(np.column_stack([_arr(xs), _arr(ys), _arr(zs)]),
                       SCATTER_S if s is None else s, [to_rgba(color, alpha)], alpha, marker,
                       label)
        self.children.append(coll)
        return coll

    def set_zlabel(self, text, fontsize=None):
        self._set_label("z", text, fontsize)

    def set_zlim(self, lo, hi):
        self._set_lim("z", lo, hi)

    def view_init(self, elev=None, azim=None):
        if elev is not None:
            self.elev = float(elev)
        if azim is not None:
            self.azim = float(azim)

    def view(self, name: str) -> tuple[float, float]:
        a = self.dims[name]
        if a.lim is not None:
            return a.lim
        vals, _ = self._data(name)
        return sc.autoscale("linear", np.concatenate([_arr(v) for v in vals])
                            if vals else np.zeros(0))

    def decorations(self, box):
        top = (text_extent(self.title, self.title_size)[1] + TITLE_PAD) if self.title else 0.0
        return 0.0, 0.0, top, 0.0

    def _basis(self):
        el, az = math.radians(self.elev), math.radians(self.azim)
        eye = np.array([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az), math.sin(el)])
        u = np.array([-math.sin(az), math.cos(az), 0.0])
        v = np.array([-math.sin(el) * math.cos(az), -math.sin(el) * math.sin(az), math.cos(el)])
        return eye, u, v

    def draw(self, box, ops: list) -> None:
        x0, y0, w, h = box
        eye, u, v = self._basis()
        views = [self.view(n) for n in self.names]

        def norm(p):                       # data -> the box [-1, 1]^2 x [-0.75, 0.75]
            p = np.atleast_2d(np.asarray(p, float))
            out = np.empty_like(p)
            for k, (lo, hi) in enumerate(views):
                out[:, k] = (2.0 * (p[:, k] - lo) / (hi - lo) - 1.0) * BOX_ASPECT[k]
            return out
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], float) * BOX_ASPECT
        su, sv = corners @ u, corners @ v
        s = FIT_3D * min(w / (su.max() - su.min()), h / (sv.max() - sv.min()))
        cx, cy = x0 + w / 2, y0 + h / 2

        def proj(q):                       # the box -> display points
            return np.column_stack([cx + s * (q @ u), cy - s * (q @ v)])
        back = np.where(eye >= 0, -1.0, 1.0) * BOX_ASPECT     # the far face of each axis
        front = -back
        ticks = []
        for k, n in enumerate(self.names):
            lo, hi = views[k]
            ticks.append([(val, t) for val, t in sc.ticks("linear", lo, hi, 5)])
        for k in range(3):
            i, j = [m for m in range(3) if m != k]
            quad = []
            for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                q = np.zeros(3)
                q[k], q[i], q[j] = back[k], a * BOX_ASPECT[i], b * BOX_ASPECT[j]
                quad.append(q)
            quad = proj(np.array(quad))
            ops.append(Fill([quad], PANE_COLORS[k]))
            grid = []
            for m, other in ((i, j), (j, i)):
                for val, _ in ticks[m]:
                    t = norm(np.array([[val] * 3]))[0][m]
                    q0, q1 = np.zeros(3), np.zeros(3)
                    q0[k] = q1[k] = back[k]
                    q0[m] = q1[m] = t
                    q0[other], q1[other] = -BOX_ASPECT[other], BOX_ASPECT[other]
                    grid.append(proj(np.array([q0, q1])))
            ops.append(Stroke(grid, (*GRID_COLOR, 1.0), GRID_W))
        # axis edges: x and y on the floor's front edges, z on the vertical
        # edge furthest left on the screen
        floor = back[2]
        edges = {0: (np.array([-1, front[1], floor]), np.array([1, front[1], floor])),
                 1: (np.array([front[0], -1, floor]), np.array([front[0], 1, floor]))}
        verticals = [(np.array([front[0], back[1], 0.0]), np.array([back[0], front[1], 0.0]))]
        zx = min(verticals[0], key=lambda q: float((q * BOX_ASPECT) @ u))
        edges[2] = (np.array([zx[0], zx[1], -1]), np.array([zx[0], zx[1], 1]))
        center = proj(np.zeros((1, 3)))[0]
        for k, n in enumerate(self.names):
            a0, a1 = (e * np.where(np.arange(3) == k, BOX_ASPECT, 1.0) for e in edges[k])
            seg = proj(np.array([a0, a1]))
            ops.append(Stroke([seg], BLACK, SPINE_W))
            mid = seg.mean(axis=0)
            out = mid - center
            out = out / (np.hypot(*out) or 1.0)
            tick_w = 0.0
            for val, t in ticks[k]:
                q = a0.copy()
                q[k] = norm(np.array([[val] * 3]))[0][k]
                p = proj(q[None])[0]
                ops.append(Stroke([np.array([p, p + out * TICK_LEN])], BLACK, SPINE_W))
                lp = p + out * (TICK_LEN + TICK_PAD + FONT * 0.6)
                ops.append(text_op(t, lp[0], lp[1], FONT * 0.9, "center", "center"))
                tick_w = max(tick_w, text_extent(t, FONT * 0.9)[0])
            label = self.dims[n].label
            if label:
                lp = mid + out * (TICK_LEN + TICK_PAD + tick_w + 2.2 * FONT)
                ops.append(text_op(label, lp[0], lp[1], self.dims[n].label_size, "center",
                                   "center"))
        screens = []
        for ch in sorted(self.children, key=lambda c: c.zorder):
            if not isinstance(ch, Scatter):
                continue
            q = norm(ch.offsets)
            order = np.argsort(q @ eye, kind="stable")
            pts = proj(q[order])
            screens.append(pts)
            sizes = ch.sizes[: len(ch.offsets)][order]
            for size in np.unique(sizes):
                ops.append(Marks(pts[sizes == size], ch.marker, math.sqrt(size), ch.color))
        if self.title:
            ops.append(text_op(self.title, x0 + w / 2, y0 - TITLE_PAD, self.title_size,
                               "center", "bottom"))
        if self.legend_kw is not None and self.get_legend_entries():
            draw_legend(self.get_legend_entries(), box, screens, self.legend_kw, ops)


# ---------------------------------------------------------------------------
# figure
# ---------------------------------------------------------------------------

class Figure:
    """A figure ``figsize`` inches at ``dpi`` (its pixels when saved
    without another dpi)."""

    def __init__(self, figsize=(6.4, 4.8), dpi: float = 100.0):
        self.size = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self.axes: list = []
        self.suptitle_text, self.suptitle_size, self.suptitle_y = "", SUPTITLE, 0.98
        self.tight_rect = None

    @property
    def points(self) -> tuple[float, float]:
        return self.size[0] * 72.0, self.size[1] * 72.0

    def add_subplot(self, nrows=1, ncols=1, index=1, projection=None):
        if isinstance(nrows, int) and nrows >= 100 and ncols == 1 and index == 1:
            nrows, ncols, index = nrows // 100, (nrows // 10) % 10, nrows % 10
        cls = {None: Axes, "3d": Axes3D}.get(projection)
        if cls is None:
            raise ValueError(f"unsupported projection {projection!r}")
        ax = cls(self, (int(nrows), int(ncols), int(index)))
        self.axes.append(ax)
        return ax

    def suptitle(self, text, fontsize=None, y=None):
        self.suptitle_text = str(text)
        self.suptitle_size = float(fontsize or SUPTITLE)
        if y is not None:
            self.suptitle_y = float(y)

    def colorbar(self, mappable, ax: Axes, label: str = "", shrink: float = 1.0):
        """A colorbar beside ``ax`` of an image, a colour-mapped scatter or
        filled contours (what has ``cmap``, ``vmin`` and ``vmax``)."""
        if getattr(mappable, "cmap", None) is None:
            raise ValueError("a colorbar needs a colour-mapped artist")
        cb = Colorbar(mappable, ax, label, float(shrink))
        ax.colorbar = cb
        self.axes.append(cb)
        return cb

    def tight_layout(self, rect=(0.0, 0.0, 1.0, 1.0)):
        self.tight_rect = tuple(float(v) for v in rect)

    def record(self, dpi=None) -> dict:
        return {"size": self.size, "dpi": float(dpi or self.dpi), "suptitle": self.suptitle_text,
                "axes": [a.record() for a in self.axes]}

    # ---- layout ------------------------------------------------------------
    def _cells(self, params) -> dict:
        """Each axes' box (x0, y0, w, h) in points from subplot parameters
        (fractions of the figure: left, right, bottom, top, wspace, hspace)."""
        W, H = self.points
        out = {}
        for ax in self.plots():
            nr, nc, idx = ax.spec
            r, c = divmod(idx - 1, nc)
            left, right = params["left"] * W, params["right"] * W
            top, bottom = (1 - params["top"]) * H, (1 - params["bottom"]) * H
            cw = (right - left) / (nc + params["wspace"] * (nc - 1))
            chh = (bottom - top) / (nr + params["hspace"] * (nr - 1))
            out[ax] = (left + c * cw * (1 + params["wspace"]),
                       top + r * chh * (1 + params["hspace"]), cw, chh)
        return out

    def plots(self) -> list:
        return [a for a in self.axes if isinstance(a, Axes)]

    def boxes(self) -> dict:
        boxes = self._cells(SUBPLOT)
        if self.tight_rect is None or not boxes:
            return boxes
        for _ in range(2):
            boxes = self._tight(boxes)
        return boxes

    def _tight(self, boxes) -> dict:
        """matplotlib's ``tight_layout``: each grid column and row as wide
        as its axes' decorations need, ``TIGHT_PAD`` font sizes apart and
        from the edges of ``tight_rect`` (and below the suptitle)."""
        W, H = self.points
        nr, nc = self.plots()[0].spec[:2]
        L, R, T, B = np.zeros(nc), np.zeros(nc), np.zeros(nr), np.zeros(nr)
        for ax, box in boxes.items():
            r, c = divmod(ax.spec[2] - 1, ax.spec[1])
            left, right, top, bottom = ax.decorations(box)
            L[c], R[c] = max(L[c], left), max(R[c], right)
            T[r], B[r] = max(T[r], top), max(B[r], bottom)
        pad = TIGHT_PAD * FONT
        x_lo, x_hi = self.tight_rect[0] * W, self.tight_rect[2] * W
        y_lo, y_hi = (1 - self.tight_rect[3]) * H, (1 - self.tight_rect[1]) * H
        if self.suptitle_text:
            y_lo = max(y_lo, (1 - self.suptitle_y) * H
                       + text_extent(self.suptitle_text, self.suptitle_size)[1])
        cw = (x_hi - x_lo - L.sum() - R.sum() - pad * (nc + 1)) / nc
        chh = (y_hi - y_lo - T.sum() - B.sum() - pad * (nr + 1)) / nr
        if cw <= 0.1 * W / nc or chh <= 0.1 * H / nr:
            return boxes                   # no room: keep the subplot parameters
        xs = x_lo + pad + np.concatenate([[0.0], np.cumsum(L + cw + R + pad)[:-1]]) + L
        ys = y_lo + pad + np.concatenate([[0.0], np.cumsum(T + chh + B + pad)[:-1]]) + T
        out = {}
        for ax in boxes:
            r, c = divmod(ax.spec[2] - 1, ax.spec[1])
            out[ax] = (float(xs[c]), float(ys[r]), float(cw), float(chh))
        return out

    # ---- output ------------------------------------------------------------
    def draw(self) -> list:
        """The display list, in figure points."""
        ops: list = []
        for ax, box in self.boxes().items():
            ax.draw(box, ops)
        if self.suptitle_text:
            W, H = self.points
            ops.append(text_op(self.suptitle_text, W / 2, (1 - self.suptitle_y) * H,
                               self.suptitle_size, "center", "top"))
        return [op for op in ops if op is not None]

    def raster(self, dpi=None, tight: bool = False) -> np.ndarray:
        """The figure's pixels (h, w, 3) uint8 at ``dpi``: int(figsize x
        dpi) of them (matplotlib's Agg canvas), or, ``tight``, the drawn
        content's bounds padded by 0.1 inch."""
        dpi = float(dpi or self.dpi)
        ops = self.draw()
        k = dpi / 72.0
        if tight:
            b = bounds(ops) or (0.0, 0.0, *self.points)
            p = PAD_INCHES * 72.0
            origin = (b[0] - p, b[1] - p)
            width, height = int(round((b[2] - b[0] + 2 * p) * k)), int(round((b[3] - b[1] + 2 * p)
                                                                              * k))
        else:
            origin = (0.0, 0.0)
            width, height = int(self.size[0] * dpi), int(self.size[1] * dpi)
        return render(ops, width, height, k, origin)

    def savefig(self, path, dpi=None, bbox_inches=None) -> str:
        """The figure as a PNG file (PDFs go through :class:`PdfPages`);
        ``bbox_inches`` None or "tight"."""
        if bbox_inches not in (None, "tight"):
            raise ValueError(f"unsupported bbox_inches {bbox_inches!r}")
        if not str(path).lower().endswith(".png"):
            raise ValueError(f"a figure is saved as PNG, not {path!r}")
        return write_png(path, self.raster(dpi, bbox_inches == "tight"), dpi or self.dpi)


def subplots(nrows: int = 1, ncols: int = 1, figsize=(6.4, 4.8), dpi: float = 100.0,
             sharey: bool = False, squeeze: bool = True):
    """A figure and its grid of axes (an object array (nrows, ncols), or
    squeezed as matplotlib's ``plt.subplots``); ``sharey`` autoscales
    every axes' y together and labels the first column's alone."""
    fig = Figure(figsize, dpi)
    axes = np.empty((nrows, ncols), dtype=object)
    for i in range(nrows * ncols):
        axes.flat[i] = fig.add_subplot(nrows, ncols, i + 1)
    if sharey:
        group = list(axes.flat)
        for ax in group:
            ax.share = group
    if not squeeze:
        return fig, axes
    if axes.size == 1:
        return fig, axes.flat[0]
    return fig, axes.ravel() if 1 in axes.shape else axes


class PdfPages:
    """Figures as the pages of one PDF, written when the block ends
    without an error (``with PdfPages(path) as pdf: pdf.savefig(fig)``)."""

    def __init__(self, path):
        self.path = str(path)
        self.doc = PdfDocument()

    def savefig(self, fig: Figure, dpi=None) -> None:
        self.doc.add_page(fig.draw(), *fig.points)

    def close(self) -> str:
        return self.doc.save(self.path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            self.close()


class FuncAnimation:
    """``frames`` frames of ``fig``, frame k drawn by ``func(k)``; saved as
    an animated GIF."""

    def __init__(self, fig: Figure, func, frames: int, interval: float = 200.0):
        self.fig, self.func, self.frames, self.interval = fig, func, int(frames), interval

    def save(self, path, fps: float = 5.0, dpi=None) -> str:
        if not str(path).lower().endswith(".gif"):
            raise ValueError(f"animations are written as GIF, not {path!r}")
        images = []
        for k in range(self.frames):
            self.func(k)
            images.append(self.fig.raster(dpi))
        return write_gif(path, images, fps)
