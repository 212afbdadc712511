"""Self-contained HTML report and the HTML table writer.

Counterpart of ``phoskintime_tpu/report/html.py``: one HTML file with the
result tables and a gallery of every PNG found under the results folder
(base64-inlined, so the file is portable), grouped by subfolder. Tables are
column dicts (:mod:`phoskintime_tpu_torch.io.utils`); :func:`table_html`
renders one as pandas' ``DataFrame.to_html(index=False, float_format=...)``
renders the same frame, byte for byte.
"""

from __future__ import annotations

import base64
import os
from datetime import datetime

import numpy as np

from phoskintime_tpu_torch.io.utils import is_missing, n_rows

_CSS = """
body { font-family: -apple-system, Helvetica, Arial, sans-serif; margin: 2em;
       color: #222; }
h1 { border-bottom: 2px solid #444; }
h2 { color: #2a5db0; margin-top: 1.6em; }
.gallery { display: flex; flex-wrap: wrap; gap: 12px; }
.gallery figure { margin: 0; }
.gallery img { max-width: 420px; border: 1px solid #ccc; border-radius: 4px; }
figcaption { font-size: 0.8em; color: #666; text-align: center; }
table { border-collapse: collapse; font-size: 0.85em; }
th, td { border: 1px solid #bbb; padding: 3px 8px; }
th { background: #eef; }
"""


def _html_text(text: str) -> str:
    """pandas' HTML cell: ``&``, ``<`` and ``>`` escaped, stripped, double
    spaces as non-breaking."""
    for a, b in (("&", "&amp;"), ("<", "&lt;"), (">", "&gt;")):
        text = text.replace(a, b)
    return text.strip().replace("  ", "&nbsp;&nbsp;")


def _column_cells(col, float_format) -> list[str]:
    """One column's cells as pandas formats them: a float column through
    ``float_format`` (a ``%`` format or a callable), missing as ``NaN``;
    integers and booleans by ``str``; text with tab, return and newline
    shown escaped, a missing cell ``NaN`` (pandas 3 reads such a column as
    strings)."""
    col = np.asarray(col)
    if col.dtype.kind == "f":
        fmt = float_format if callable(float_format) else (lambda v: float_format % v)
        return ["NaN" if np.isnan(v) else fmt(v) for v in col]
    if col.dtype.kind in "iub":
        return [str(v) for v in col.tolist()]
    out = []
    for v in col:
        if is_missing(v):
            out.append("NaN")
            continue
        text = str(v)
        for a, b in (("\t", r"\t"), ("\r", r"\r"), ("\n", r"\n")):
            text = text.replace(a, b)
        out.append(text)
    return out


def table_html(table: dict, float_format="%.4g") -> str:
    """A column table as ``pd.DataFrame(table).to_html(index=False,
    float_format=float_format)`` writes it."""
    names = list(table)
    cells = [_column_cells(table[c], float_format) for c in names]
    lines = ['<table border="1" class="dataframe">', "  <thead>",
             '    <tr style="text-align: right;">']
    lines += [f"      <th>{_html_text(str(c))}</th>" for c in names]
    lines += ["    </tr>", "  </thead>", "  <tbody>"]
    for i in range(n_rows(table)):
        lines.append("    <tr>")
        lines += [f"      <td>{_html_text(col[i])}</td>" for col in cells]
        lines.append("    </tr>")
    lines += ["  </tbody>", "</table>"]
    return "\n".join(lines)


def _img_tag(path: str) -> str:
    with open(path, "rb") as fh:
        b64 = base64.b64encode(fh.read()).decode()
    name = os.path.basename(path)
    return (f'<figure><img src="data:image/png;base64,{b64}" alt="{name}"/>'
            f"<figcaption>{name}</figcaption></figure>")


def create_report(results_dir: str, output_file: str = "report.html",
                  title: str = "phoskintime-tpu report",
                  tables: dict[str, dict] | None = None) -> str:
    """Walk ``results_dir`` and write one HTML file with the ``tables``
    (column dicts, floats as ``%.4g``) and every PNG under it. Returns the
    path."""
    results_dir = str(results_dir)
    sections: dict[str, list[str]] = {}
    for root, _dirs, files in os.walk(results_dir):
        pngs = sorted(f for f in files if f.endswith(".png"))
        if pngs:
            rel = os.path.relpath(root, results_dir)
            sections[rel] = [os.path.join(root, f) for f in pngs]

    parts = [f"<html><head><meta charset='utf-8'><title>{title}</title>",
             f"<style>{_CSS}</style></head><body>",
             f"<h1>{title}</h1>",
             f"<p>Generated {datetime.now():%Y-%m-%d %H:%M}</p>"]

    if tables:
        for name, table in tables.items():
            parts.append(f"<h2>{name}</h2>")
            parts.append(table_html(table, "%.4g"))

    for section in sorted(sections):
        parts.append(f"<h2>{section if section != '.' else 'figures'}</h2>")
        parts.append("<div class='gallery'>")
        parts.extend(_img_tag(p) for p in sections[section])
        parts.append("</div>")

    parts.append("</body></html>")
    out = os.path.join(results_dir, output_file)
    with open(out, "w") as fh:
        fh.write("\n".join(parts))
    return out
