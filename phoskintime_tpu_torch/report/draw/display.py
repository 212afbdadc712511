"""The display list: what a figure draws, as the few primitives both back
ends paint (:mod:`raster` onto pixels, :mod:`pdf` as vector pages).

Coordinates are points (1/72 inch) on the figure, the origin at its top
left corner and y down. Colours are RGBA floats with the artist's alpha
applied. Text reaches the display list as stroked polylines
(:mod:`font`). A ``clip`` is an (x0, y0, x1, y1) rectangle the primitive is
cut to (an axes' box for its data), or None.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: a star's inner radius over its outer one (matplotlib's star marker)
STAR_INNER = 0.381966


@dataclass
class Stroke:
    """Polylines stroked with round caps and joins, optionally dashed
    (``dash``: the on and off lengths in points). Text carries its glyphs
    too, ``((char, x, y, size), ...), rotation``, each at its origin, so
    that a back end may draw a glyph once and place it (the lines are the
    same strokes)."""
    lines: list
    color: tuple
    width: float
    dash: tuple | None = None
    clip: tuple | None = None
    glyphs: tuple | None = None


@dataclass
class Fill:
    """Polygons filled together under the even-odd rule."""
    polys: list
    color: tuple
    clip: tuple | None = None


@dataclass
class Marks:
    """One marker at each of ``centers`` (n, 2): ``shape`` "o" (a disc) or
    another of :data:`MARKERS` (a polygon, :func:`marker_polygon`), ``size``
    points across."""
    centers: np.ndarray
    shape: str
    size: float
    color: tuple
    clip: tuple | None = None


@dataclass
class Picture:
    """An RGBA image (h, w, 4) uint8, row 0 at the top, stretched onto
    ``rect`` (x0, y0, x1, y1) cell by cell (nearest)."""
    rgba: np.ndarray
    rect: tuple
    clip: tuple | None = None


#: the markers: a disc, a square, a star, triangles up, down, left and
#: right, a diamond, a plus and a cross (filled), a hexagon, and the
#: vertical and horizontal line markers (drawn 1 point thick)
MARKERS = ("o", "s", "*", "^", "v", "<", ">", "D", "P", "X", "h", "|", "_")


def _polar(n: int, r: float, phase: float) -> np.ndarray:
    ang = phase + np.arange(n) * 2 * np.pi / n
    return np.column_stack([r * np.cos(ang), r * np.sin(ang)])


def marker_polygon(shape: str, size: float) -> np.ndarray:
    """The outline of a marker ``size`` across, centred on the origin, y
    down (a disc as a 24-gon)."""
    r = size / 2.0
    if shape == "o":
        return _polar(24, r, 0.0)
    if shape == "s":
        return np.array([[-r, -r], [r, -r], [r, r], [-r, r]])
    if shape == "*":
        ang = -np.pi / 2 + np.arange(10) * np.pi / 5
        rad = np.where(np.arange(10) % 2 == 0, r, r * STAR_INNER)
        return np.column_stack([rad * np.cos(ang), rad * np.sin(ang)])
    if shape in "^v<>":
        tri = np.array([[0.0, -r], [r, r], [-r, r]])
        turn = {"^": 0, ">": 1, "v": 2, "<": 3}[shape]
        for _ in range(turn):
            tri = np.column_stack([-tri[:, 1], tri[:, 0]])
        return tri
    if shape == "D":
        d = r * 0.71
        return np.array([[0.0, -d], [d, 0.0], [0.0, d], [-d, 0.0]])
    if shape == "h":
        return _polar(6, r, -np.pi / 2)
    if shape in "PX":
        a, b = r / 3, r
        plus = np.array([[-a, -b], [a, -b], [a, -a], [b, -a], [b, a], [a, a], [a, b], [-a, b],
                         [-a, a], [-b, a], [-b, -a], [-a, -a]])
        if shape == "P":
            return plus
        c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
        return np.column_stack([plus[:, 0] * c - plus[:, 1] * s, plus[:, 0] * s + plus[:, 1] * c])
    if shape in "|_":
        h = 0.5
        bar = np.array([[-h, -r], [h, -r], [h, r], [-h, r]])
        return bar if shape == "|" else bar[:, ::-1]
    raise ValueError(f"unsupported marker {shape!r}; have {MARKERS}")


def extent(op) -> tuple | None:
    """The (x0, y0, x1, y1) points a primitive covers, cut to its clip;
    None when it covers nothing."""
    if isinstance(op, Stroke):
        pts = [p for p in op.lines if len(p)]
        if not pts:
            return None
        p = np.vstack(pts)
        h = op.width / 2
        box = (p[:, 0].min() - h, p[:, 1].min() - h, p[:, 0].max() + h, p[:, 1].max() + h)
    elif isinstance(op, Fill):
        pts = [p for p in op.polys if len(p)]
        if not pts:
            return None
        p = np.vstack(pts)
        box = (p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max())
    elif isinstance(op, Marks):
        if not len(op.centers):
            return None
        h = op.size / 2
        c = op.centers
        box = (c[:, 0].min() - h, c[:, 1].min() - h, c[:, 0].max() + h, c[:, 1].max() + h)
    else:
        box = tuple(op.rect)
    if op.clip is not None:
        box = (max(box[0], op.clip[0]), max(box[1], op.clip[1]),
               min(box[2], op.clip[2]), min(box[3], op.clip[3]))
    if not all(np.isfinite(box)) or box[2] < box[0] or box[3] < box[1]:
        return None
    return tuple(float(v) for v in box)


def bounds(ops) -> tuple | None:
    """The union of the primitives' extents."""
    boxes = [b for b in (extent(op) for op in ops) if b is not None]
    if not boxes:
        return None
    b = np.asarray(boxes)
    return (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max())
