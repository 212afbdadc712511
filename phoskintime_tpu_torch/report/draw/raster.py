"""The raster back end: a display list painted onto an RGB numpy canvas.

Each primitive is turned into a coverage mask over its bounding box and
composited once (source over, with its alpha), so that overlapping pieces
of one semi-transparent line do not darken where they meet. Lines are
anti-aliased by their distance to the pixel centres (round caps), but
horizontal and vertical ones (frames, ticks, grids), which are rectangles
covered exactly; text by glyphs, each drawn once for its size, angle and
quarter-pixel offset and then placed; polygons by exact horizontal
coverage on four sub-rows a pixel; discs by their distance to the centre.
Images are sampled cell by cell (nearest).
"""

from __future__ import annotations

import functools

import numpy as np

from phoskintime_tpu_torch.report.draw import font
from phoskintime_tpu_torch.report.draw.display import Fill, Marks, Picture, Stroke, marker_polygon

SUBROWS = 4                 # sub-rows a pixel row for polygon coverage
PIECE = 8.0                 # pixels: strokes are covered piece by piece


class Canvas:
    """``height`` x ``width`` white pixels; points map to pixels as
    (pt - origin) * scale."""

    def __init__(self, width: int, height: int, scale: float, origin=(0.0, 0.0)):
        self.rgb = np.ones((height, width, 3), np.float32)
        self.scale = float(scale)
        self.origin = np.asarray(origin, float)

    def px(self, pts) -> np.ndarray:
        return (np.asarray(pts, float) - self.origin) * self.scale

    def _window(self, box, clip) -> tuple | None:
        """The integer pixel window of a pixel box, cut to the canvas and
        to the clip rectangle (in points)."""
        h, w = self.rgb.shape[:2]
        x0, y0, x1, y1 = box
        if clip is not None:
            c0, c1 = self.px(clip[:2]), self.px(clip[2:])
            x0, y0, x1, y1 = max(x0, c0[0]), max(y0, c0[1]), min(x1, c1[0]), min(y1, c1[1])
        i0, j0 = max(int(np.floor(y0)), 0), max(int(np.floor(x0)), 0)
        i1, j1 = min(int(np.ceil(y1)), h), min(int(np.ceil(x1)), w)
        if i1 <= i0 or j1 <= j0:
            return None
        return i0, i1, j0, j1

    def _composite(self, win, cover, color) -> None:
        i0, i1, j0, j1 = win
        a = (cover * color[3]).astype(np.float32)[..., None]
        region = self.rgb[i0:i1, j0:j1]
        region *= 1.0 - a
        region += a * np.asarray(color[:3], np.float32)

    def paint(self, ops) -> None:
        for op in ops:
            if isinstance(op, Stroke):
                self._stroke(op)
            elif isinstance(op, Fill):
                self._fill(op)
            elif isinstance(op, Marks):
                self._marks(op)
            elif isinstance(op, Picture):
                self._picture(op)
            else:
                raise TypeError(f"not a display-list primitive: {op!r}")

    def to_uint8(self) -> np.ndarray:
        out = self.rgb * 255.0
        out += 0.5
        return out.astype(np.uint8)

    # ---- primitives ------------------------------------------------------
    def _stroke(self, op: Stroke) -> None:
        hw = max(op.width * self.scale, 1.0) / 2
        if op.glyphs is not None and op.clip is None:
            self._glyphs(op, hw)
            return
        lines = [self.px(p) for p in op.lines if len(p)]
        if op.dash is not None:
            lines = dashes(lines, op.dash[0] * self.scale, op.dash[1] * self.scale)
        segs = [np.hstack([p[:-1], p[1:]]) if len(p) > 1 else np.hstack([p, p]) for p in lines]
        if not segs:
            return
        s = np.vstack(segs)
        s = s[np.isfinite(s).all(axis=1)]
        if not len(s):
            return
        if ((s[:, 0] == s[:, 2]) | (s[:, 1] == s[:, 3])).all():
            self._rules(s, hw, op)
            return
        mask, i0, j0 = segment_cover(s, hw)
        self._composite_mask(mask, i0, j0, op.clip, op.color)

    def _composite_mask(self, mask, i0, j0, clip, color) -> None:
        """Composite a coverage mask whose pixel (0, 0) is (i0, j0), cut to
        the canvas and ``clip``, at its covered pixels only."""
        win = self._window((j0, i0, j0 + mask.shape[1], i0 + mask.shape[0]), clip)
        if win is None:
            return
        a0, a1, b0, b1 = win
        sub = np.ascontiguousarray(mask[a0 - i0:a1 - i0, b0 - j0:b1 - j0])
        idx = np.flatnonzero(sub)
        width = b1 - b0
        r, c = a0 + idx // width, b0 + idx % width
        a = (sub.ravel()[idx] * color[3])[:, None]
        self.rgb[r, c] = self.rgb[r, c] * (1.0 - a) + a * np.asarray(color[:3], np.float32)

    def _rules(self, s, hw, op) -> None:
        """Horizontal and vertical segments as rectangles (square ends),
        their edges' partial pixels covered exactly."""
        for x0, y0, x1, y1 in s:
            xa, xb = min(x0, x1) - hw, max(x0, x1) + hw
            ya, yb = min(y0, y1) - hw, max(y0, y1) + hw
            win = self._window((xa, ya, xb, yb), op.clip)
            if win is None:
                continue
            i0, i1, j0, j1 = win
            cols = np.arange(j0, j1, dtype=np.float32)
            rows = np.arange(i0, i1, dtype=np.float32)
            cx = np.clip(np.minimum(cols + 1, xb) - np.maximum(cols, xa), 0.0, 1.0)
            cy = np.clip(np.minimum(rows + 1, yb) - np.maximum(rows, ya), 0.0, 1.0)
            self._composite(win, cy[:, None] * cx[None, :], op.color)

    def _glyphs(self, op: Stroke, hw: float) -> None:
        """Text: each glyph's coverage drawn once for its size, angle and
        quarter-pixel offset (:func:`glyph_cover`), placed at its origin."""
        glyphs, rotation = op.glyphs
        placed = []
        for ch, x, y, size in glyphs:
            if not font.glyph(ch)[1]:             # a space
                continue
            px, py = self.px((x, y))
            ix, iy = int(np.floor(px)), int(np.floor(py))
            mask, di, dj = glyph_cover(ch, round(size * self.scale, 3), float(rotation),
                                       round(hw, 3), round((px - ix) * 4) / 4,
                                       round((py - iy) * 4) / 4)
            placed.append((mask, iy + di, ix + dj))
        if not placed:
            return
        i0 = min(i for _, i, _ in placed)
        j0 = min(j for _, _, j in placed)
        i1 = max(i + m.shape[0] for m, i, _ in placed)
        j1 = max(j + m.shape[1] for m, _, j in placed)
        mask = np.zeros((i1 - i0, j1 - j0), np.float32)
        for m, i, j in placed:
            region = mask[i - i0:i - i0 + m.shape[0], j - j0:j - j0 + m.shape[1]]
            np.maximum(region, m, out=region)
        self._composite_mask(mask, i0, j0, None, op.color)

    def _fill(self, op: Fill) -> None:
        polys = [self.px(p) for p in op.polys if len(p) >= 3]
        if not polys:
            return
        p = np.vstack(polys)
        win = self._window((p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()), op.clip)
        if win is None:
            return
        i0, i1, j0, j1 = win
        self._composite(win, coverage(polys, j0, i0, j1 - j0, i1 - i0), op.color)

    def _marks(self, op: Marks) -> None:
        c = self.px(op.centers)
        c = c[np.isfinite(c).all(axis=1)]
        size = round(max(op.size * self.scale, 1.0), 3)
        for x, y in c:
            ix, iy = int(np.floor(x)), int(np.floor(y))
            stamp = marker_cover(op.shape, size, round((x - ix) * 4) / 4, round((y - iy) * 4) / 4)
            half = stamp.shape[0] // 2
            box = (ix - half, iy - half, ix - half + stamp.shape[1], iy - half + stamp.shape[0])
            win = self._window(box, op.clip)
            if win is None:
                continue
            i0, i1, j0, j1 = win
            self._composite(win, stamp[i0 - box[1]:i1 - box[1], j0 - box[0]:j1 - box[0]],
                            op.color)

    def _picture(self, op: Picture) -> None:
        p0, p1 = self.px(op.rect[:2]), self.px(op.rect[2:])
        win = self._window((p0[0], p0[1], p1[0], p1[1]), op.clip)
        if win is None:
            return
        i0, i1, j0, j1 = win
        h, w = op.rgba.shape[:2]
        rows = np.clip(((np.arange(i0, i1) + 0.5 - p0[1]) / (p1[1] - p0[1]) * h).astype(int),
                       0, h - 1)
        cols = np.clip(((np.arange(j0, j1) + 0.5 - p0[0]) / (p1[0] - p0[0]) * w).astype(int),
                       0, w - 1)
        cells = op.rgba[rows[:, None], cols[None, :]].astype(np.float32) / 255.0
        a = cells[..., 3:4]
        region = self.rgb[i0:i1, j0:j1]
        region *= 1.0 - a
        region += a * cells[..., :3]


def segment_cover(s: np.ndarray, hw: float) -> tuple[np.ndarray, int, int]:
    """The coverage of segments ``s`` (k, 4) in pixels, stroked with half
    width ``hw`` and round caps, over their bounding box: (mask, row and
    column of its pixel (0, 0)). Each segment is cut into pieces of at most
    :data:`PIECE` pixels, each piece's distance field taken on its own
    window, and the windows merged by their maximum."""
    s = split(s, PIECE)
    pad = hw + 1.0
    i0 = int(np.floor(min(s[:, 1].min(), s[:, 3].min()) - pad))
    j0 = int(np.floor(min(s[:, 0].min(), s[:, 2].min()) - pad))
    i1 = int(np.ceil(max(s[:, 1].max(), s[:, 3].max()) + pad)) + 1
    j1 = int(np.ceil(max(s[:, 0].max(), s[:, 2].max()) + pad)) + 1
    k = int(np.ceil(PIECE + 2 * pad)) + 2
    gx = np.floor(np.minimum(s[:, 0], s[:, 2]) - pad).astype(int)[:, None] + np.arange(k)
    gy = np.floor(np.minimum(s[:, 1], s[:, 3]) - pad).astype(int)[:, None] + np.arange(k)
    xs = (gx[:, None, :] + 0.5).astype(np.float32)
    ys = (gy[:, :, None] + 0.5).astype(np.float32)
    ax, ay, bx, by = (s[:, c].astype(np.float32)[:, None, None] for c in range(4))
    dx, dy = bx - ax, by - ay
    l2 = dx * dx + dy * dy
    t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / np.where(l2 > 0, l2, 1.0), 0.0, 1.0)
    cov = np.clip(hw + 0.5 - np.hypot(xs - (ax + t * dx), ys - (ay + t * dy)), 0.0, 1.0)
    rows = np.broadcast_to(gy[:, :, None], cov.shape)
    cols = np.broadcast_to(gx[:, None, :], cov.shape)
    on = (cov > 0) & (rows < i1) & (cols < j1)
    width = j1 - j0
    mask = np.zeros((i1 - i0) * width, np.float32)
    np.maximum.at(mask, (rows[on] - i0) * width + (cols[on] - j0), cov[on])
    return mask.reshape(i1 - i0, width), i0, j0


@functools.lru_cache(maxsize=8192)
def glyph_cover(ch: str, size_px: float, rotation: float, hw: float, fx: float,
                fy: float) -> tuple[np.ndarray, int, int]:
    """One glyph's coverage at ``size_px`` pixels, rotated by ``rotation``
    degrees, stroked with half width ``hw``, its origin at (fx, fy) within
    pixel (0, 0): (mask, row and column offset of its pixel (0, 0))."""
    lines = font.glyph_strokes(ch, size_px)
    a = np.radians(rotation)
    c, sn = np.cos(a), np.sin(a)
    pts = []
    for p in lines:
        q = np.column_stack([fx + p[:, 0] * c - p[:, 1] * sn, fy - (p[:, 0] * sn + p[:, 1] * c)])
        pts.append(np.hstack([q[:-1], q[1:]]) if len(q) > 1 else np.hstack([q, q]))
    mask, i0, j0 = segment_cover(np.vstack(pts), hw)
    mask.flags.writeable = False
    return mask, i0, j0


@functools.lru_cache(maxsize=1024)
def marker_cover(shape: str, size: float, fx: float, fy: float) -> np.ndarray:
    """A marker's coverage, ``size`` pixels across, its centre at (fx, fy)
    within the middle pixel of an odd square stamp."""
    half = int(np.ceil(size / 2 + 1.0))
    n = 2 * half + 1
    if shape == "o":
        grid = np.arange(n) - half + 0.5
        d = np.hypot(grid[None, :] - fx, grid[:, None] - fy)
        out = np.clip(size / 2 + 0.5 - d, 0.0, 1.0).astype(np.float32)
    else:
        out = coverage([marker_polygon(shape, size) + [half + fx, half + fy]], 0, 0, n, n)
    out.flags.writeable = False
    return out


def split(s: np.ndarray, piece: float) -> np.ndarray:
    """Segments (k, 4) cut into pieces no longer than ``piece``."""
    length = np.hypot(s[:, 2] - s[:, 0], s[:, 3] - s[:, 1])
    n = np.maximum(np.ceil(length / piece).astype(int), 1)
    if (n == 1).all():
        return s
    seg = np.repeat(s, n, axis=0)
    k = np.concatenate([np.arange(m) for m in n])
    f0 = (k / np.repeat(n, n))[:, None]
    f1 = ((k + 1) / np.repeat(n, n))[:, None]
    a, d = seg[:, :2], seg[:, 2:] - seg[:, :2]
    return np.hstack([a + f0 * d, a + f1 * d])


def coverage(polys, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """The (h, w) share of each pixel (from column ``x0``, row ``y0``)
    inside the polygons (pixel coordinates, even-odd rule): exact along
    each of :data:`SUBROWS` sub-rows a pixel, averaged."""
    edges = np.vstack([np.hstack([p, np.roll(p, -1, axis=0)]) for p in polys])
    edges = edges[edges[:, 1] != edges[:, 3]]
    if not len(edges) or w <= 0 or h <= 0:
        return np.zeros((max(h, 0), max(w, 0)), np.float32)
    ys = (y0 + (np.arange(h * SUBROWS) + 0.5) / SUBROWS)[:, None]
    ax, ay, bx, by = edges.T
    cross = (ay <= ys) != (by <= ys)
    t = (ys - ay) / (by - ay)
    xs = np.where(cross, ax + t * (bx - ax), np.inf)
    xs.sort(axis=1)
    k = int(cross.sum(axis=1).max())
    k -= k % 2
    if k == 0:
        return np.zeros((h, w), np.float32)
    a, b = xs[:, 0:k:2] - x0, xs[:, 1:k:2] - x0
    open_ = ~np.isfinite(a) | ~np.isfinite(b)
    a, b = np.where(open_, 0.0, a), np.where(open_, 0.0, b)
    cols = np.arange(w, dtype=float)
    cov = np.clip(np.minimum(b[..., None], cols + 1) - np.maximum(a[..., None], cols),
                  0.0, 1.0).sum(axis=1)
    return np.clip(cov.reshape(h, SUBROWS, w).mean(axis=1), 0.0, 1.0).astype(np.float32)


def dashes(lines, on: float, off: float) -> list:
    """The ``on`` pieces of each polyline under an on/off dash pattern
    (lengths in the polylines' units), the pattern restarting at each."""
    out = []
    period = on + off
    for p in lines:
        if len(p) < 2:
            continue
        seg = np.hypot(*np.diff(p, axis=0).T)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        total = s[-1]
        start = 0.0
        while start < total:
            end = min(start + on, total)
            inner = (s > start) & (s < end)
            pts = [np.array([np.interp(start, s, p[:, 0]), np.interp(start, s, p[:, 1])])]
            pts += list(p[inner])
            pts.append(np.array([np.interp(end, s, p[:, 0]), np.interp(end, s, p[:, 1])]))
            out.append(np.asarray(pts))
            start += period
    return out


def render(ops, width: int, height: int, scale: float, origin=(0.0, 0.0)) -> np.ndarray:
    """The display list painted on a white ``height`` x ``width`` canvas:
    an (height, width, 3) uint8 array."""
    canvas = Canvas(width, height, scale, origin)
    canvas.paint(ops)
    return canvas.to_uint8()
