"""Axis scales of the drawing layer: the transforms, autoscaling and ticks.

Three scales, as matplotlib defines them: ``linear``; ``log`` (base 10,
non-positive values dropped); ``symlog`` with linthresh 1, linscale 1 and
base 10 (linear within [-1, 1], logarithmic beyond). Autoscaling takes the
data's range in the transformed space and widens it by 5% on each side
(matplotlib's default margins), not past a sticky edge (a bar's base, an
image's border) that the data reach. Ticks are "nice": linear ones at
multiples of 1, 2, 2.5, 5 or 10 times a power of ten, at most ``nbins``
intervals; log and symlog ones at the decades.
"""

from __future__ import annotations

import math

import numpy as np

SCALES = ("linear", "log", "symlog")
MARGIN = 0.05
LINSCALE = 1.0 / (1.0 - 1.0 / 10.0)     # matplotlib's linscale_adj at linscale 1, base 10
STEPS = (1.0, 2.0, 2.5, 5.0, 10.0)
MAXN_STEPS = (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0)


def check(scale: str) -> str:
    if scale not in SCALES:
        raise ValueError(f"unsupported axis scale {scale!r}; have {SCALES}")
    return scale


def forward(scale: str, v) -> np.ndarray:
    """Data values to the scale's linear space (NaN where log has none)."""
    v = np.asarray(v, float)
    if scale == "linear":
        return v
    with np.errstate(divide="ignore", invalid="ignore"):
        if scale == "log":
            return np.where(v > 0, np.log10(np.where(v > 0, v, 1.0)), np.nan)
        a = np.abs(v)
        return np.where(a > 1, np.sign(v) * (LINSCALE + np.log10(np.maximum(a, 1.0))),
                        v * LINSCALE)


def inverse(scale: str, t) -> np.ndarray:
    t = np.asarray(t, float)
    if scale == "linear":
        return t
    if scale == "log":
        return 10.0 ** t
    a = np.abs(t)
    return np.where(a > LINSCALE, np.sign(t) * 10.0 ** (a - LINSCALE), t / LINSCALE)


def autoscale(scale: str, values, sticky=(), margin: float = MARGIN) -> tuple[float, float]:
    """View limits for the data ``values``: their range in the scale's
    space, widened by ``margin`` of it on each side (not past a ``sticky``
    value the data reach), a zero range widened by 5% of its value (±0.05
    at 0), no data (0, 1) or (1, 10) on log."""
    t = forward(scale, np.asarray(values, float).ravel())
    t = t[np.isfinite(t)]
    if not t.size:
        return (1.0, 10.0) if scale == "log" else (0.0, 1.0)
    lo, hi = float(t.min()), float(t.max())
    st = forward(scale, np.asarray(sticky, float).ravel())
    st = st[np.isfinite(st)]
    d = (hi - lo) * margin
    vlo, vhi = lo - d, hi + d
    below = st[(st <= lo) & (st > vlo)]
    above = st[(st >= hi) & (st < vhi)]
    if below.size:
        vlo = float(below.max())
    if above.size:
        vhi = float(above.min())
    if vhi - vlo <= max(abs(vlo), abs(vhi)) * 1e-15:
        if vlo == 0.0 and vhi == 0.0:
            vlo, vhi = -0.05, 0.05
        else:
            vlo, vhi = vlo - 0.05 * abs(vlo), vhi + 0.05 * abs(vhi)
    return float(inverse(scale, vlo)), float(inverse(scale, vhi))


def nbins(length_pt: float, per_tick_pt: float) -> int:
    """matplotlib's ``nbins='auto'``: as many intervals as the axis length
    leaves room for, 1 to 9."""
    return max(1, min(9, int(length_pt // per_tick_pt)))


def ticks(scale: str, lo: float, hi: float, n: int) -> list[tuple[float, str]]:
    """(value, label) ticks within [lo, hi] (either order); labels may
    carry ``^{...}`` superscripts."""
    lo, hi = min(lo, hi), max(lo, hi)
    out = []
    if scale == "log":
        out = _log_ticks(lo, hi, n)
    elif scale == "symlog":
        out = _symlog_ticks(lo, hi, n)
    return out if len(out) >= 2 else _linear_ticks(lo, hi, n)


def _linear_ticks(lo: float, hi: float, n: int) -> list[tuple[float, str]]:
    span = hi - lo
    if not np.isfinite(span) or span <= 0:
        return [(lo, _plain(lo, 3))]
    mag = 10.0 ** math.floor(math.log10(span / n))
    for s in STEPS:
        step = s * mag
        if span / step <= n + 1e-9:
            break
    k0, k1 = math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9)
    values = [k * step for k in range(k0, k1 + 1)]
    big = max(abs(v) for v in values) if values else 0.0
    if big >= 1e5 or 0.0 < big < 1e-3:
        return [(v, _plain(v, 6, "g")) for v in values]
    dec = max(0, -math.floor(math.log10(step) + 1e-9)) + (1 if s == 2.5 else 0)
    return [(v, _plain(v, dec)) for v in values]


def _plain(v: float, digits: int, kind: str = "f") -> str:
    text = f"{v:.{digits}{kind}}"
    return text[1:] if text.startswith("-") and float(text) == 0.0 else text


def _decades(k0: int, k1: int, n: int) -> range:
    stride = max(1, math.ceil((k1 - k0 + 1) / max(n, 1)))
    return range(k0 + (-k0) % stride, k1 + 1, stride)


def _log_ticks(lo: float, hi: float, n: int) -> list[tuple[float, str]]:
    if not (lo > 0 and hi > 0):
        return []
    t0, t1 = math.log10(lo), math.log10(hi)
    k0, k1 = math.ceil(t0 - 1e-9), math.floor(t1 + 1e-9)
    if k1 - k0 + 1 >= 2:
        return [(10.0 ** k, f"10^{{{k}}}") for k in _decades(k0, k1, n)]
    out = []
    for k in range(math.floor(t0) - 1, math.ceil(t1) + 1):
        for m in (1, 2, 5):
            v = m * 10.0 ** k
            if lo * (1 - 1e-9) <= v <= hi * (1 + 1e-9):
                out.append((v, f"{v:g}"))
    return out


def _symlog_ticks(lo: float, hi: float, n: int) -> list[tuple[float, str]]:
    kmax = int(math.floor(math.log10(max(abs(lo), abs(hi), 1.0)) + 1e-9))
    cands = [(-(10.0 ** k), f"-10^{{{k}}}") for k in range(kmax, -1, -1)]
    cands += [(0.0, "0")] + [(10.0 ** k, f"10^{{{k}}}") for k in range(0, kmax + 1)]
    inside = [c for c in cands if lo - 1e-12 <= c[0] <= hi + 1e-12]
    stride = max(1, math.ceil(len(inside) / max(n, 1)))
    return inside[::stride]


def _nonsingular(vmin: float, vmax: float, expander: float, tiny: float) -> tuple[float, float]:
    """matplotlib's ``transforms.nonsingular`` (increasing)."""
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    vmin, vmax = sorted((float(vmin), float(vmax)))
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        return vmin - expander * abs(vmin), vmax + expander * abs(vmax)
    return vmin, vmax


def maxn_ticks(vmin: float, vmax: float, nbins: int, min_n_ticks: int = 2) -> np.ndarray:
    """matplotlib's ``MaxNLocator(nbins, min_n_ticks=...).tick_values``
    with its default steps (1, 1.5, 2, 2.5, 3, 4, 5, 6, 8, 10): the values
    that filled contours take as their levels."""
    vmin, vmax = _nonsingular(vmin, vmax, 1e-13, 1e-14)
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0 if abs(meanv) / dv < 100 else math.copysign(
        10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    base = np.asarray(MAXN_STEPS)
    steps = np.concatenate([0.1 * base[:-1], base, [10 * base[1]]]) * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = int(np.nonzero(large)[0][0]) if large.any() else len(steps) - 1
    ticks = np.zeros(0)
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        tol = 1e-10
        if offset:
            tol = min(0.4999, max(1e-10, 10 ** (np.log10(abs(offset) / step) - 12)))
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if abs(m / step - 1) < tol else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if abs(m / step) < tol else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= min_n_ticks:
            break
    return ticks + offset
