"""LaTeX table and figure emitters.

Counterpart of ``phoskintime_tpu/report/latexit.py`` (the reference's
``utils/latexit.py``), on column tables: a column of text (an object
array, as pandas before 3.0 holds text) is left-aligned, any other
right-aligned; a float cell goes through ``float_fmt``, any other cell
through ``str`` and LaTeX escaping, as the JAX package formats a
DataFrame's rows.
"""

from __future__ import annotations

import os

import numpy as np

from phoskintime_tpu_torch.io.utils import n_rows


def _escape(s: str) -> str:
    # backslash goes through a placeholder: replacing it with
    # \textbackslash{} FIRST would let the later brace rules re-escape
    # its own braces (review: 'a\\b' rendered as literal 'a\\{}b')
    s = s.replace("\\", "\x00")
    for a, b in [("&", r"\&"), ("%", r"\%"), ("$", r"\$"), ("#", r"\#"),
                 ("_", r"\_"), ("{", r"\{"), ("}", r"\}")]:
        s = s.replace(a, b)
    return s.replace("\x00", r"\textbackslash{}")


def dataframe_to_latex(df: dict, caption: str = "", label: str = "",
                       float_fmt: str = "%.4g") -> str:
    """A column table as a LaTeX ``table`` environment."""
    cols = " | ".join("l" if np.asarray(df[c]).dtype == object else "r" for c in df)
    lines = [r"\begin{table}[ht]", r"\centering",
             rf"\begin{{tabular}}{{{cols}}}", r"\hline"]
    lines.append(" & ".join(_escape(str(c)) for c in df) + r" \\")
    lines.append(r"\hline")
    for r in range(n_rows(df)):
        cells = []
        for v in _row(df, r):
            if isinstance(v, (float, np.floating)):
                cells.append(float_fmt % v)
            else:
                cells.append(_escape(str(v)))
        lines.append(" & ".join(cells) + r" \\")
    lines += [r"\hline", r"\end{tabular}"]
    if caption:
        lines.append(rf"\caption{{{_escape(caption)}}}")
    if label:
        lines.append(rf"\label{{{label}}}")
    lines.append(r"\end{table}")
    return "\n".join(lines)


def _row(df: dict, r: int) -> list:
    """Row ``r`` as ``DataFrame.iterrows`` gives it: where the columns are
    integers and floats, the row is one float64 Series (the integers become
    floats); otherwise each cell keeps its column's type."""
    cols = [np.asarray(df[c]) for c in df]
    kinds = {c.dtype.kind for c in cols}
    if "f" in kinds and kinds <= set("iuf"):
        return [np.float64(c[r]) for c in cols]
    return [c[r] for c in cols]


def figure_to_latex(image_path: str, caption: str = "", label: str = "",
                    width: str = r"0.8\linewidth") -> str:
    return "\n".join([
        r"\begin{figure}[ht]", r"\centering",
        rf"\includegraphics[width={width}]{{{image_path}}}",
        rf"\caption{{{_escape(caption)}}}" if caption else "",
        rf"\label{{{label}}}" if label else "",
        r"\end{figure}"])


def write_latex_report(out_dir: str, tables: dict[str, dict],
                       figures: list[str], filename: str = "report.tex") -> str:
    parts = [r"\documentclass{article}",
             r"\usepackage{graphicx}", r"\usepackage[margin=2cm]{geometry}",
             r"\begin{document}"]
    for name, df in tables.items():
        parts.append(dataframe_to_latex(df, caption=name))
    for fig in figures:
        parts.append(figure_to_latex(fig, caption=os.path.basename(fig)))
    parts.append(r"\end{document}")
    path = os.path.join(str(out_dir), filename)
    with open(path, "w") as fh:
        fh.write("\n".join(parts))
    return path
