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
    """One marker at each of ``centers`` (n, 2): ``shape`` "o" (a disc), "s"
    (a square) or "*" (a five-pointed star), ``size`` points across."""
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


MARKERS = ("o", "s", "*")


def marker_polygon(shape: str, size: float) -> np.ndarray:
    """The outline of a square or star marker ``size`` across, centred on
    the origin, y down."""
    r = size / 2.0
    if shape == "s":
        return np.array([[-r, -r], [r, -r], [r, r], [-r, r]])
    if shape == "*":
        ang = -np.pi / 2 + np.arange(10) * np.pi / 5
        rad = np.where(np.arange(10) % 2 == 0, r, r * STAR_INNER)
        return np.column_stack([rad * np.cos(ang), rad * np.sin(ang)])
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
