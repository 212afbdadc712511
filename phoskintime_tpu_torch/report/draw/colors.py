"""Colours of the drawing layer: the ``tab10`` and ``tab20`` cycles, the
named colours the figures use, colour parsing and the colormaps.

A colour is an RGBA tuple of floats in [0, 1]. :func:`to_rgba` reads what
the figure writers pass: ``"C0"``-``"C9"`` (the tab10 cycle), ``"tab:blue"``
and the rest of tab10, the single letters ``bgrcmykw``, the CSS names the
writers use, ``"none"``, ``#rrggbb``, an RGB or RGBA tuple. Their values
are matplotlib's, so that a figure's record holds the same floats in both
packages. Anything else raises.
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu_torch.report.draw._cmaps import (COOLWARM, GREENS, INFERNO, RDBU_R, REDS,
                                                      TAB20 as _TAB20, VIRIDIS)


def _hex(code: str) -> tuple:
    return tuple(int(code[i:i + 2], 16) / 255 for i in (1, 3, 5))


TAB10_HEX = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
             "#7f7f7f", "#bcbd22", "#17becf")
#: the default colour cycle (matplotlib's ``tab10``), RGB tuples
TAB10 = tuple(_hex(h) for h in TAB10_HEX)
_TAB_NAMES = ("blue", "orange", "green", "red", "purple", "brown", "pink", "gray", "olive",
              "cyan")

NAMED = {
    "b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0), "c": (0.0, 0.75, 0.75),
    "m": (0.75, 0.0, 0.75), "y": (0.75, 0.75, 0.0), "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0),
    "red": (1.0, 0.0, 0.0), "blue": (0.0, 0.0, 1.0), "gray": _hex("#808080"),
    "black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0), "green": _hex("#008000"),
    "steelblue": _hex("#4682b4"), "skyblue": _hex("#87ceeb"), "coral": _hex("#ff7f50"),
    "lightblue": _hex("#add8e6"), "teal": _hex("#008080"), "dodgerblue": _hex("#1e90ff"),
    "lightgreen": _hex("#90ee90"),
}
NAMED.update({f"C{i}": c for i, c in enumerate(TAB10)})
NAMED.update({f"tab:{n}": c for n, c in zip(_TAB_NAMES, TAB10)})

#: matplotlib's ``tab20`` colours, RGB tuples
TAB20 = tuple(tuple(c) for c in _TAB20)

#: the colormaps, 256 RGB entries each
COLORMAPS = {"viridis": np.asarray(VIRIDIS, float), "RdBu_r": np.asarray(RDBU_R, float),
             "coolwarm": np.asarray(COOLWARM, float), "inferno": np.asarray(INFERNO, float),
             "Greens": np.asarray(GREENS, float), "Reds": np.asarray(REDS, float)}


def to_rgba(color, alpha: float | None = None) -> tuple:
    """``color`` as an RGBA tuple; ``alpha``, where given, replaces its
    alpha (matplotlib's rule)."""
    if isinstance(color, str):
        if color.lower() == "none":
            return (0.0, 0.0, 0.0, 0.0)           # matplotlib's: transparent whatever the alpha
        if color.startswith("#") and len(color) == 7:
            rgba = (*_hex(color), 1.0)
        elif color in NAMED:
            rgba = (*NAMED[color], 1.0)
        else:
            raise ValueError(f"unknown colour {color!r}")
    else:
        c = tuple(float(v) for v in color)
        if len(c) not in (3, 4) or not all(0.0 <= v <= 1.0 for v in c):
            raise ValueError(f"not an RGB(A) colour: {color!r}")
        rgba = c if len(c) == 4 else (*c, 1.0)
    return rgba if alpha is None else (*rgba[:3], float(alpha))


def to_rgb(color) -> tuple:
    return to_rgba(color)[:3]


def lighten(color, amount: float = 0.65) -> tuple:
    """``color`` mixed with white: each channel (1 - amount) c + amount
    (``phoskintime_tpu/io/export.py``'s rule)."""
    return tuple((1 - amount) * c + amount for c in to_rgb(color))


def colormap(name: str) -> np.ndarray:
    """The (256, 3) table of a colormap; an unknown name raises."""
    if name not in COLORMAPS:
        raise ValueError(f"unknown colormap {name!r}; have {sorted(COLORMAPS)}")
    return COLORMAPS[name]


def map_values(values, name: str, vmin: float, vmax: float) -> np.ndarray:
    """Values through a colormap as (..., 4) RGBA floats: normalised to
    [0, 1] by (vmin, vmax), binned into the table's 256 entries (1 in the
    last, values outside clipped to the ends), NaN transparent."""
    v = np.asarray(values, float)
    table = colormap(name)
    span = vmax - vmin
    x = (v - vmin) / span if span > 0 else np.zeros_like(v)
    idx = np.clip(np.floor(np.nan_to_num(x) * len(table)), 0, len(table) - 1).astype(int)
    out = np.concatenate([table[idx], np.ones(v.shape + (1,))], axis=-1)
    out[np.isnan(v)] = 0.0
    return out


def cmap_color(name: str, x: float) -> tuple:
    """The RGBA colour of ``x`` in [0, 1] through a colormap, as
    matplotlib's ``cmap(x)`` picks it: entry ``int(x * 256)`` (the last at
    1, the ends outside)."""
    table = colormap(name)
    k = min(max(int(float(x) * len(table)), 0), len(table) - 1) if x >= 0 else 0
    return (*(float(v) for v in table[k]), 1.0)


def to_hex(color) -> str:
    """``#rrggbb`` of a colour, each channel rounded as matplotlib's
    ``to_hex``."""
    return "#" + "".join(f"{round(c * 255):02x}" for c in to_rgb(color))
