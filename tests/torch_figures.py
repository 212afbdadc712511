"""What a figure draws, as data, from both packages' figure writers.

:func:`capture_jax` records every figure a JAX writer saves through
matplotlib (Agg): ``Figure.savefig`` to a path, each page of
``PdfPages.savefig`` and, for ``Animation.save``, each frame (the update
function called once a frame after the file is written). :func:`capture_port`
records the port's figures through :meth:`Figure.record` the same way. Both
give {path: [record, ...]} (one record a PNG, a page, a frame) in the
structure :meth:`phoskintime_tpu_torch.report.draw.figure.Figure.record`
documents: lines (with their drawstyle and marker colours), scatters (each
point's colour and edge), bars (rectangles), patches (circles, closed
paths), texts and annotations, collections (fills, segments, filled
contours' levels) and images, with the axes' ticks (explicit or
categorical). :func:`assert_same_record` holds two records equal: strings
exactly except the numbers printed in them (rtol 1e-9), colours exactly,
data at rtol 1e-9 (with ``scaled``, also within that share of each array's
largest magnitude or of 1, for the figures of two fits);
:func:`without_points` blanks a figure's scatter points (a t-SNE the two
packages compute by different methods).

It also reads the port's files without the port: the PDF's cross-reference
table and page count, a matplotlib PDF's page count.
"""

from __future__ import annotations

import contextlib
import os
import re

import matplotlib

matplotlib.use("Agg")

import matplotlib.colors as mcolors  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.animation import Animation  # noqa: E402
from matplotlib.backends.backend_pdf import PdfPages as MplPdfPages  # noqa: E402
from matplotlib.category import StrCategoryLocator  # noqa: E402
from matplotlib.collections import LineCollection, PathCollection, PolyCollection  # noqa: E402
from matplotlib.contour import ContourSet  # noqa: E402
from matplotlib.figure import Figure as MplFigure  # noqa: E402
from matplotlib.markers import MarkerStyle  # noqa: E402
from matplotlib.patches import Circle, PathPatch, Rectangle  # noqa: E402
from matplotlib.text import Annotation  # noqa: E402
from matplotlib.ticker import FixedFormatter, FixedLocator, FuncFormatter  # noqa: E402

from phoskintime_tpu_torch.report.draw import figure as port_figure  # noqa: E402

RTOL = 1e-9
#: the markers the port draws, told apart by their paths as a scatter holds them
SCATTER_MARKERS = ("o", "s", "*", "^", "v", "<", ">", "D", "P", "X", "h")
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


# ---------------------------------------------------------------------------
# matplotlib's figures as records
# ---------------------------------------------------------------------------

def _label(artist) -> str | None:
    text = artist.get_label()
    return None if text is None or str(text).startswith("_") else str(text)


def _marker(m) -> str:
    return "None" if m in (None, "None", "", " ") else str(m)


def _scatter_marker(collection) -> str:
    """The marker whose path (scaled as a scatter scales it) is the
    collection's."""
    got = collection.get_paths()[0].vertices
    for m in SCATTER_MARKERS:
        ms = MarkerStyle(m)
        want = ms.get_path().transformed(ms.get_transform()).vertices
        if want.shape == got.shape and np.allclose(want, got):
            return m
    raise AssertionError(f"unknown scatter marker with {len(got)} vertices")


def _rgba_rows(colors) -> np.ndarray:
    return np.asarray(mcolors.to_rgba_array(colors), float).reshape(-1, 4)


def _text_record(t) -> dict:
    ann = isinstance(t, Annotation)
    props = getattr(t, "arrowprops", None) if ann else None
    arrow = None if props is None else {
        "style": props.get("arrowstyle", "-|>"), "lw": float(props.get("lw", 1.0)),
        "color": mcolors.to_rgba(props.get("color", "black"))}
    xy = tuple(float(v) for v in (t.xy if ann else t.get_position()))
    return {"text": t.get_text(), "xy": xy,
            "xytext": tuple(float(v) for v in t.xyann) if ann else xy,
            "coords": t.anncoords if ann else "data", "arrow": arrow, "ha": t.get_ha(),
            "va": t.get_va(), "color": mcolors.to_rgba(t.get_color()),
            "size": float(t.get_fontsize()), "weight": str(t.get_fontweight())}


def _collection_record(c) -> dict:
    if isinstance(c, ContourSet):
        return {"kind": "contourf", "levels": np.asarray(c.levels, float),
                "cmap": c.get_cmap().name, "alpha": c.get_alpha(),
                "clim": tuple(float(v) for v in c.get_clim())}
    if isinstance(c, LineCollection):
        return {"kind": "lines", "segments": np.asarray(c.get_segments(), float),
                "colors": _rgba_rows(c.get_edgecolor()),
                "linewidths": np.asarray(c.get_linewidths(), float)}
    if isinstance(c, PolyCollection):
        return {"kind": "poly",
                "vertices": np.vstack([p.vertices for p in c.get_paths()]).astype(float),
                "facecolors": _rgba_rows(c.get_facecolor()),
                "edgecolors": _rgba_rows(c.get_edgecolor())}
    raise AssertionError(f"unrecorded collection {type(c).__name__}")


def _patch_record(p) -> dict:
    if isinstance(p, Circle):
        return {"kind": "circle", "center": tuple(float(v) for v in p.get_center()),
                "radius": float(p.get_radius()), "color": tuple(p.get_facecolor()),
                "edgecolor": tuple(p.get_edgecolor())}
    if isinstance(p, PathPatch):
        return {"kind": "path", "vertices": np.asarray(p.get_path().vertices, float),
                "color": tuple(p.get_facecolor()), "edgecolor": tuple(p.get_edgecolor())}
    raise AssertionError(f"unrecorded patch {type(p).__name__}")


def _ticks_record(axis) -> tuple:
    """(ticks, labels, style) where the axis' ticks are fixed (explicit or
    categories), else None each."""
    loc, fmt = axis.get_major_locator(), axis.get_major_formatter()
    if isinstance(loc, StrCategoryLocator):
        mapping = axis.units._mapping
        ticks = np.asarray(list(mapping.values()), float)
        labels = [str(k) for k in mapping]
    elif isinstance(loc, FixedLocator):
        ticks = np.asarray(loc.locs, float)
        labels = ([t.get_text() for t in axis.get_ticklabels()]
                  if isinstance(fmt, (FuncFormatter, FixedFormatter)) else None)
    else:
        return None, None, None
    shown = axis.get_ticklabels()
    style = (None if not labels else (float(shown[0].get_rotation()), shown[0].get_ha()))
    return ticks, labels, style


def _axes_record(ax) -> dict:
    if hasattr(ax, "_colorbar"):
        return {"kind": "colorbar", "label": ax.get_ylabel()}
    is3d = ax.name == "3d"
    leg = ax.get_legend()
    on = ax._axis3don if is3d else ax.axison       # a 3-D axes turns its 2-D frame off
    rec = {"kind": "3d" if is3d else "2d", "title": ax.get_title(), "off": not on,
           "legend": None if leg is None else [t.get_text() for t in leg.get_texts()]}
    for n in ("xyz" if is3d else "xy"):
        rec[f"{n}label"] = getattr(ax, f"get_{n}label")()
        auto = getattr(ax, f"get_autoscale{n}_on")()
        rec[f"{n}lim"] = None if auto else tuple(float(v) for v in getattr(ax, f"get_{n}lim")())
    if is3d:
        rec["view"] = (float(ax.elev), float(ax.azim))
    else:
        for n in "xy":
            axis = getattr(ax, f"{n}axis")
            rec[f"{n}scale"] = axis.get_scale()
            rec[f"{n}ticks"], rec[f"{n}ticklabels"], rec[f"{n}tickstyle"] = _ticks_record(axis)
        kx, ky = ax.xaxis._major_tick_kw, ax.yaxis._major_tick_kw
        alpha = kx.get("grid_alpha", ky.get("grid_alpha"))
        rec["grid"] = {"x": bool(kx.get("gridOn", False)), "y": bool(ky.get("gridOn", False)),
                       "alpha": None if alpha is None else float(alpha)}
    rec["lines"] = [{"x": np.asarray(ln.get_xdata(), float),
                     "y": np.asarray(ln.get_ydata(), float),
                     "color": mcolors.to_rgba(ln.get_color()), "ls": ln.get_linestyle(),
                     "marker": _marker(ln.get_marker()), "lw": float(ln.get_linewidth()),
                     "ms": float(ln.get_markersize()), "alpha": ln.get_alpha(),
                     "label": _label(ln), "drawstyle": ln.get_drawstyle(),
                     "markeredgecolor": mcolors.to_rgba(ln.get_markeredgecolor()),
                     "markerfacecolor": mcolors.to_rgba(ln.get_markerfacecolor())}
                    for ln in ax.get_lines()]
    scatters = []
    for c in ax.collections:
        if not isinstance(c, PathCollection):
            continue
        offsets = (np.column_stack([np.asarray(v, float) for v in c._offsets3d]) if is3d
                   else np.asarray(c.get_offsets(), float))
        scatters.append({
            "offsets": offsets,
            "sizes": np.broadcast_to(np.asarray(c.get_sizes(), float), (len(offsets),)),
            "colors": _rgba_rows(c._facecolors),
            "edgecolors": None if is3d else _rgba_rows(c.get_edgecolor()),
            "linewidths": np.asarray(c.get_linewidths(), float), "alpha": c.get_alpha(),
            "marker": _scatter_marker(c), "label": _label(c)})
    rec["scatters"] = scatters
    rec["bars"] = [{"x": float(p.get_x()), "y": float(p.get_y()),
                    "width": float(p.get_width()), "height": float(p.get_height()),
                    "color": tuple(float(v) for v in p.get_facecolor()),
                    "edgecolor": tuple(float(v) for v in p.get_edgecolor())}
                   for p in ax.patches if isinstance(p, Rectangle)]
    rec["patches"] = [_patch_record(p) for p in ax.patches if not isinstance(p, Rectangle)]
    rec["texts"] = [_text_record(t) for t in ax.texts]
    rec["collections"] = [_collection_record(c) for c in ax.collections
                          if not isinstance(c, PathCollection)]
    rec["images"] = [{"array": np.ma.filled(np.ma.asarray(im.get_array(), float), np.nan),
                      "cmap": im.get_cmap().name, "vmin": float(im.get_clim()[0]),
                      "vmax": float(im.get_clim()[1])} for im in ax.images]
    return rec


def mpl_record(fig, dpi) -> dict:
    return {"size": tuple(float(v) for v in fig.get_size_inches()), "dpi": float(dpi),
            "suptitle": fig.get_suptitle(), "axes": [_axes_record(ax) for ax in fig.axes]}


def _is_path(fname) -> bool:
    return isinstance(fname, (str, os.PathLike))


@contextlib.contextmanager
def capture_jax():
    """{path: [record, ...]} of every figure matplotlib saves in the block."""
    records: dict = {}
    real = (MplFigure.savefig, MplPdfPages.savefig, Animation.save)

    def savefig(self, fname, *a, **kw):
        out = real[0](self, fname, *a, **kw)
        if _is_path(fname):
            records[str(fname)] = [mpl_record(self, kw.get("dpi") or self.dpi)]
        return out

    def pdf_savefig(self, figure=None, **kw):
        out = real[1](self, figure, **kw)
        records.setdefault(str(self._filename), []).append(
            mpl_record(figure, kw.get("dpi") or figure.dpi))
        return out

    def anim_save(self, filename, *a, **kw):
        out = real[2](self, filename, *a, **kw)
        frames = []
        for k in self.new_saved_frame_seq():
            self._func(k, *self._args)
            frames.append(mpl_record(self._fig, kw.get("dpi") or self._fig.dpi))
        records[str(filename)] = frames
        return out

    MplFigure.savefig, MplPdfPages.savefig, Animation.save = savefig, pdf_savefig, anim_save
    try:
        yield records
    finally:
        MplFigure.savefig, MplPdfPages.savefig, Animation.save = real


@contextlib.contextmanager
def capture_port():
    """{path: [record, ...]} of every figure the port saves in the block."""
    records: dict = {}
    F, P, A = port_figure.Figure, port_figure.PdfPages, port_figure.FuncAnimation
    real = (F.savefig, P.savefig, A.save)

    def savefig(self, path, dpi=None, bbox_inches=None):
        out = real[0](self, path, dpi, bbox_inches)
        records[str(path)] = [self.record(dpi)]
        return out

    def pdf_savefig(self, fig, dpi=None):
        real[1](self, fig, dpi)
        records.setdefault(self.path, []).append(fig.record(dpi))

    def anim_save(self, path, fps=5.0, dpi=None):
        out = real[2](self, path, fps, dpi)
        frames = []
        for k in range(self.frames):
            self.func(k)
            frames.append(self.fig.record(dpi))
        records[str(path)] = frames
        return out

    F.savefig, P.savefig, A.save = savefig, pdf_savefig, anim_save
    try:
        yield records
    finally:
        F.savefig, P.savefig, A.save = real


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def assert_same_text(got: str, want: str, where: str) -> None:
    """Equal strings, but the numbers in them within ``RTOL``."""
    assert NUMBER.split(got) == NUMBER.split(want), (where, got, want)
    g = [float(v) for v in NUMBER.findall(got)]
    w = [float(v) for v in NUMBER.findall(want)]
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=f"{where}: {got!r} {want!r}")


def _numeric(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating, np.ndarray)) and not isinstance(
        v, (bool, np.bool_))


def assert_same_record(got, want, where: str = "", scaled: float = 0.0) -> None:
    """``got`` (the port's record) equal to ``want`` (matplotlib's);
    ``scaled``: the data also within that share of each array's largest
    magnitude, or of 1 where that is smaller (for figures of two fits that
    agree to rounding, whose values are of order 1)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same_record(got[k], want[k], f"{where}.{k}", scaled)
    elif where.endswith("colors") and want is not None:
        g, w = np.asarray(got, float), np.asarray(want, float)
        assert g.shape == w.shape and np.array_equal(g, w), (where, got, want)
    elif where.endswith("color"):
        assert tuple(float(v) for v in got) == tuple(float(v) for v in want), (where, got, want)
    elif isinstance(want, str):
        assert isinstance(got, str), (where, got)
        assert_same_text(got, want, where)
    elif want is None or isinstance(want, (bool, np.bool_)):
        assert got == want, (where, got, want)
    elif _numeric(want) or (isinstance(want, (list, tuple)) and all(_numeric(v) for v in want)
                            and len(want)):
        g, w = np.asarray(got, float), np.asarray(want, float)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        finite = w[np.isfinite(w)]
        atol = scaled * max(float(np.abs(finite).max(initial=0.0)), 1.0) if scaled else 0.0
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, equal_nan=True, err_msg=where)
    else:
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_record(a, b, f"{where}[{i}]", scaled)


def without_points(records: dict, suffix: str) -> dict:
    """The captures with the scatter points of each file ending in
    ``suffix`` blanked (an embedding the two packages compute differently:
    t-SNE)."""
    for path, recs in records.items():
        if str(path).endswith(suffix):
            for rec in recs:
                for ax in rec["axes"]:
                    for sc in ax.get("scatters", ()):
                        sc["offsets"] = None
    return records


def assert_same_records(got: dict, want: dict, root_got, root_want, scaled: float = 0.0) -> None:
    """The two captures' files (relative to their roots) and each file's
    records in order."""
    rel_g = {os.path.relpath(k, root_got): v for k, v in got.items()}
    rel_w = {os.path.relpath(k, root_want): v for k, v in want.items()}
    assert set(rel_g) == set(rel_w), (sorted(rel_g), sorted(rel_w))
    for name, recs in rel_w.items():
        assert len(rel_g[name]) == len(recs), (name, len(rel_g[name]), len(recs))
        for i, (g, w) in enumerate(zip(rel_g[name], recs)):
            assert_same_record(g, w, f"{name}[{i}]", scaled)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def pdf_xref_ok(data: bytes) -> bool:
    """Every in-use cross-reference entry points at ``<n> 0 obj``."""
    start = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    m = re.match(rb"xref\s+0 (\d+)\s+", data[start:])
    count, pos = int(m.group(1)), start + m.end()
    for n in range(count):
        entry = data[pos + 20 * n: pos + 20 * (n + 1)]
        off, _gen, kind = entry.split()[:3]
        if kind == b"n" and not data[int(off):].startswith(f"{n} 0 obj".encode()):
            return False
    return True


def pdf_pages(data: bytes) -> int:
    """The page count of a PDF (its page objects)."""
    return len(re.findall(rb"/Type\s*/Page(?![a-zA-Z])", data))
