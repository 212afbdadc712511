"""The drawing layer's stroke font: each glyph a few polylines on a small
grid, drawn at any size and angle by both back ends as stroked paths.

The grid: the baseline at y = 0, the x-height at 8, the cap height at 12,
descenders to -4; most glyphs are 8 units wide and advance 10. A cap
height of 12 units is 0.73 of the font size (a sans-serif's proportion),
so a unit is ``size * 0.73 / 12`` points. The font covers printable ASCII
and the characters the figure writers print beyond it (``—``, ``²``,
``χ``, ``≤``, ``≥``, ``α``, ``β``, ``λ``, ``Σ``, ``ŷ``, ``₀``, ``→``,
``←``); any other character raises.

Text may carry superscripts as ``^{...}`` runs (the log axes' ``10^{3}``)
and subscripts as ``_{...}`` runs; :func:`runs` splits them out. A label
written in matplotlib's mathtext (``$\\alpha$``, ``$R=\\frac{\\lambda}{m}
\\sum_j p_j^2$``) is drawn through :func:`plain`, which spells the few
commands the writers use in the font's characters.
"""

from __future__ import annotations

import re

import numpy as np

CAP = 12.0                  # the cap height in grid units
UNIT = 0.73 / CAP           # points a grid unit, for a font size of 1 point
STROKE = 0.075              # the stroke width, in points for a font size of 1 point
SUPER_SCALE, SUPER_RISE = 0.7, 0.45       # a superscript's size and rise (of the size)

# glyph: "x,y x,y ... | x,y ..." (strokes), or (advance, strokes); advance 10 by default
_GLYPHS = {
    " ": (5, ""),
    "!": (4, "1,12 1,3 | 1,0 1,0.8"),
    '"': (6, "1,12 1,9 | 4,12 4,9"),
    "#": (11, "3,0 4,12 | 6,0 7,12 | 0,4 9,4 | 1,8 10,8"),
    "$": "8,10 6,11 2,11 0,9 1,7 3,6 5,6 7,5 8,3 6,1 2,1 0,2 | 4,13 4,-1",
    "%": (11, "0,0 9,12 | 1,12 0,11 0,9 1,8 2,9 2,11 1,12 | 8,4 7,3 7,1 8,0 9,1 9,3 8,4"),
    "&": "8,0 1,8 1,10 2,12 4,12 5,10 5,9 0,4 0,2 2,0 4,0 8,5",
    "'": (3, "1,12 1,9"),
    "(": (5, "3,13 1,10 1,1 3,-2"),
    ")": (5, "1,13 3,10 3,1 1,-2"),
    "*": "4,12 4,6 | 1,11 7,7 | 1,7 7,11",
    "+": "4,1 4,9 | 0,5 8,5",
    ",": (4, "1.5,1 1.5,0 0.5,-2"),
    "-": (7, "1,5 6,5"),
    ".": (4, "1,0 1,0.8"),
    "/": (7, "0,-1 5,13"),
    "0": "3,0 5,0 7,1 8,3 8,9 7,11 5,12 3,12 1,11 0,9 0,3 1,1 3,0",
    "1": "2,9 5,12 5,0 | 2,0 8,0",
    "2": "0,10 1,11 3,12 5,12 7,11 8,9 8,7 0,0 8,0",
    "3": "0,11 2,12 6,12 8,10 8,8 6,6 3,6 | 6,6 8,4 8,2 6,0 2,0 0,1",
    "4": "6,0 6,12 0,4 8,4",
    "5": "8,12 1,12 0,7 3,8 5,8 7,7 8,5 8,3 7,1 5,0 3,0 0,1",
    "6": "7,12 4,12 2,11 0,8 0,3 1,1 3,0 5,0 7,1 8,3 8,5 7,7 5,8 3,8 1,7 0,5",
    "7": "0,12 8,12 3,0",
    "8": "3,6 1,7 0,9 1,11 3,12 5,12 7,11 8,9 7,7 5,6 3,6 1,5 0,3 1,1 3,0 5,0 7,1 8,3 7,5 "
         "5,6",
    "9": "8,7 7,5 5,4 3,4 1,5 0,7 0,9 1,11 3,12 5,12 7,11 8,9 8,4 6,1 4,0 1,0",
    ":": (4, "1,0 1,0.8 | 1,7 1,7.8"),
    ";": (4, "1.5,7 1.5,7.8 | 1.5,1 1.5,0 0.5,-2"),
    "<": "8,9 0,5 8,1",
    "=": "0,3 8,3 | 0,7 8,7",
    ">": "0,9 8,5 0,1",
    "?": "0,10 1,11 3,12 5,12 7,11 8,9 7,7 4,5 4,3 | 4,0 4,0.8",
    "@": (13, "8,4 7,3 5,3 4,4 4,6 5,7 7,7 8,6 8,3 9,2 10,3 10,8 8,11 5,12 3,11 1,9 0,6 0,3 "
              "2,0 5,-1 8,0"),
    "A": "0,0 4,12 8,0 | 1.3,4 6.7,4",
    "B": "0,0 0,12 5,12 7,11 8,9 7,7 5,6 0,6 | 5,6 7,5 8,3 7,1 5,0 0,0",
    "C": "8,10 7,11 5,12 3,12 1,11 0,9 0,3 1,1 3,0 5,0 7,1 8,2",
    "D": "0,0 0,12 4,12 6,11 8,8 8,4 6,1 4,0 0,0",
    "E": "8,12 0,12 0,0 8,0 | 0,6 6,6",
    "F": "8,12 0,12 0,0 | 0,6 6,6",
    "G": "8,10 7,11 5,12 3,12 1,11 0,9 0,3 1,1 3,0 5,0 7,1 8,3 8,6 5,6",
    "H": "0,0 0,12 | 8,0 8,12 | 0,6 8,6",
    "I": (6, "0,0 4,0 | 2,0 2,12 | 0,12 4,12"),
    "J": (8, "6,12 6,3 5,1 3,0 1,1 0,3"),
    "K": "0,0 0,12 | 8,12 0,4 | 3,7 8,0",
    "L": (9, "0,12 0,0 7,0"),
    "M": (12, "0,0 0,12 5,4 10,12 10,0"),
    "N": "0,0 0,12 8,0 8,12",
    "O": "3,0 5,0 7,1 8,3 8,9 7,11 5,12 3,12 1,11 0,9 0,3 1,1 3,0",
    "P": "0,0 0,12 5,12 7,11 8,9 7,7 5,6 0,6",
    "Q": "3,0 5,0 7,1 8,3 8,9 7,11 5,12 3,12 1,11 0,9 0,3 1,1 3,0 | 5,3 8,0",
    "R": "0,0 0,12 5,12 7,11 8,9 7,7 5,6 0,6 | 4,6 8,0",
    "S": "8,10 7,11 5,12 3,12 1,11 0,9 1,7 3,6 5,6 7,5 8,3 7,1 5,0 3,0 1,1 0,2",
    "T": "0,12 8,12 | 4,12 4,0",
    "U": "0,12 0,3 1,1 3,0 5,0 7,1 8,3 8,12",
    "V": "0,12 4,0 8,12",
    "W": (12, "0,12 2.5,0 5,9 7.5,0 10,12"),
    "X": "0,0 8,12 | 0,12 8,0",
    "Y": "0,12 4,6 8,12 | 4,6 4,0",
    "Z": "0,12 8,12 0,0 8,0",
    "[": (5, "4,13 1,13 1,-2 4,-2"),
    "\\": (7, "0,13 5,-1"),
    "]": (5, "0,13 3,13 3,-2 0,-2"),
    "^": "1,9 4,12 7,9",
    "_": "0,-2 8,-2",
    "`": (5, "1,12 3,10"),
    "a": (9, "1,7 3,8 5,8 7,6 7,0 | 7,4 2,4 0,3 0,1 2,0 5,0 7,2"),
    "b": (9, "0,12 0,0 | 0,6 2,8 5,8 7,6 7,2 5,0 2,0 0,2"),
    "c": (9, "7,7 5,8 2,8 0,6 0,2 2,0 5,0 7,1"),
    "d": (9, "7,12 7,0 | 7,6 5,8 2,8 0,6 0,2 2,0 5,0 7,2"),
    "e": (9, "0,4 7,4 7,6 5,8 2,8 0,6 0,2 2,0 5,0 7,1"),
    "f": (6, "5,12 3,12 2,11 2,0 | 0,8 5,8"),
    "g": (9, "7,8 7,-2 5,-4 2,-4 0,-3 | 7,6 5,8 2,8 0,6 0,2 2,0 5,0 7,2"),
    "h": (9, "0,12 0,0 | 0,6 2,8 5,8 7,6 7,0"),
    "i": (4, "1,0 1,8 | 1,10.5 1,11.3"),
    "j": (5, "3,8 3,-2 2,-4 0,-4 | 3,10.5 3,11.3"),
    "k": (8, "0,12 0,0 | 6,8 0,3 | 2,4.5 6,0"),
    "l": (4, "1,12 1,0"),
    "m": (12, "0,8 0,0 | 0,6 2,8 4,8 5,6 5,0 | 5,6 7,8 9,8 10,6 10,0"),
    "n": (9, "0,8 0,0 | 0,6 2,8 5,8 7,6 7,0"),
    "o": (9, "2,0 5,0 7,2 7,6 5,8 2,8 0,6 0,2 2,0"),
    "p": (9, "0,8 0,-4 | 0,6 2,8 5,8 7,6 7,2 5,0 2,0 0,2"),
    "q": (9, "7,8 7,-4 | 7,6 5,8 2,8 0,6 0,2 2,0 5,0 7,2"),
    "r": (7, "0,8 0,0 | 0,5 2,7 4,8 6,8"),
    "s": (9, "7,7 5,8 2,8 0,7 0,5 2,4 5,4 7,3 7,1 5,0 2,0 0,1"),
    "t": (6, "2,11 2,1 3,0 5,0 | 0,8 5,8"),
    "u": (9, "0,8 0,2 2,0 5,0 7,2 | 7,8 7,0"),
    "v": (9, "0,8 3.5,0 7,8"),
    "w": (11, "0,8 2,0 4.5,7 7,0 9,8"),
    "x": (9, "0,8 7,0 | 0,0 7,8"),
    "y": (9, "0,8 3.5,0 | 7,8 2,-4 0,-4"),
    "z": (9, "0,8 7,8 0,0 7,0"),
    "{": (6, "5,13 3,12 3,7 1,5.5 3,4 3,-1 5,-2"),
    "|": (4, "1,13 1,-3"),
    "}": (6, "0,13 2,12 2,7 4,5.5 2,4 2,-1 0,-2"),
    "~": "0,5 2,7 4,6 6,5 8,7",
    "—": (16, "0,5 15,5"),
    "²": (6, "0,11 1,12 3,12 4,11 4,10 0,7 4,7"),
    "χ": (9, "0,8 1,8 6,-4 7,-4 | 0,-4 7,8"),
    "≤": "8,11 0,8 8,5 | 0,2 8,2",
    "≥": "0,11 8,8 0,5 | 0,2 8,2",
    "α": (10, "8,8 6,2 4,0 2,0 0,2 0,6 2,8 4,8 6,6 8,0"),
    "β": (9, "0,-4 0,10 2,12 5,12 7,10 7,8 5,6 2,6 | 5,6 8,4 8,2 6,0 3,0 0,2"),
    "λ": (9, "0,12 2,12 8,0 | 4,7 0,0"),
    "Σ": "8,12 0,12 4,6 0,0 8,0",
    "ŷ": (9, "0,8 3.5,0 | 7,8 2,-4 0,-4 | 1.5,10 3.5,12 5.5,10"),
    "₀": (6, "2,-2 4,-2 5,-1 5,3 4,4 2,4 1,3 1,-1 2,-2"),
    "→": (11, "0,5 9,5 | 6,8 9,5 6,2"),
    "←": (11, "9,5 0,5 | 3,8 0,5 3,2"),
}


def _parse(spec) -> tuple[float, list[np.ndarray]]:
    advance, strokes = spec if isinstance(spec, tuple) else (10, spec)
    lines = []
    for stroke in strokes.split("|"):
        pts = [tuple(float(v) for v in p.split(",")) for p in stroke.split()]
        if pts:
            lines.append(np.asarray(pts, float))
    return float(advance), lines


GLYPHS = {ch: _parse(spec) for ch, spec in _GLYPHS.items()}
_SCRIPT = re.compile(r"([\^_])\{([^}]*)\}")
SUB_RISE = -0.2                       # a subscript's rise (of the size)
_MATH_NAMES = {r"\alpha": "α", r"\beta": "β", r"\lambda": "λ", r"\sum": "Σ",
               r"\chi": "χ", r"\leq": "≤", r"\geq": "≥"}


def glyph(ch: str) -> tuple[float, list[np.ndarray]]:
    if ch not in GLYPHS:
        raise ValueError(f"the figure font has no glyph for {ch!r} (U+{ord(ch):04X})")
    return GLYPHS[ch]


def _math(expr: str) -> str:
    """One mathtext expression (between ``$``) in the font's characters,
    its sub- and superscripts as ``_{...}`` and ``^{...}`` runs."""
    expr = re.sub(r"\\mathrm\{([^{}]*)\}", r"\1", expr)
    expr = re.sub(r"\\hat\s*\{?y\}?", "ŷ", expr)
    for name, ch in sorted(_MATH_NAMES.items(), key=lambda kv: -len(kv[0])):
        expr = expr.replace(name, ch)
    expr = re.sub(r"\\frac\{([^{}]*)\}\{([^{}]*)\}", r"\1/\2", expr)
    expr = expr.replace(" ", "")
    return re.sub(r"([\^_])([^{])", r"\1{\2}", expr)


def plain(text: str) -> str:
    """``text`` with each ``$...$`` mathtext span spelled by :func:`_math`;
    text without a pair of ``$`` as it is."""
    parts = text.split("$")
    if len(parts) < 3:
        return text
    return "".join(_math(p) if k % 2 else p for k, p in enumerate(parts))


def runs(text: str) -> list[tuple[str, float, float]]:
    """``text`` (mathtext spelled by :func:`plain`) as (text, scale, rise)
    runs: ``^{...}`` a superscript run, ``_{...}`` a subscript run, the
    rest at scale 1 on the baseline."""
    text = plain(text)
    out, pos = [], 0
    for m in _SCRIPT.finditer(text):
        if m.start() > pos:
            out.append((text[pos:m.start()], 1.0, 0.0))
        out.append((m.group(2), SUPER_SCALE, SUPER_RISE if m.group(1) == "^" else SUB_RISE))
        pos = m.end()
    if pos < len(text) or not out:
        out.append((text[pos:], 1.0, 0.0))
    return out


def text_width(text: str, size: float) -> float:
    """The advance of ``text`` at font size ``size``, in points."""
    return sum(sum(glyph(c)[0] for c in t) * scale for t, scale, _ in runs(text)) * UNIT * size


def layout(text: str, size: float) -> list[tuple[str, float, float, float]]:
    """Each character of ``text`` at ``size`` points as (char, x, y, its
    size): its origin in points from the left end of the baseline, y up."""
    out, x = [], 0.0
    for t, scale, rise in runs(text):
        for ch in t:
            out.append((ch, x, rise * size, size * scale))
            x += glyph(ch)[0] * UNIT * size * scale
    return out


def glyph_strokes(ch: str, size: float) -> list[np.ndarray]:
    """The polylines of one glyph at ``size`` points, from its origin, y up."""
    return [p * (UNIT * size) for p in glyph(ch)[1]]


def text_strokes(text: str, size: float) -> list[np.ndarray]:
    """The polylines of ``text`` at ``size`` points, in points with the
    origin at the left end of the baseline and y up."""
    return [p + (x, y) for ch, x, y, s in layout(text, size) for p in glyph_strokes(ch, s)]


def ascent(size: float) -> float:
    """The height above the baseline that a line of text takes (the cap
    height with room for accents), in points."""
    return 1.1 * CAP * UNIT * size


def descent(size: float) -> float:
    """The depth below the baseline of the descenders, in points."""
    return 4.0 * UNIT * size
