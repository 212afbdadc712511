"""The per-gene mechanism diagram: gene -> mRNA -> protein -> the
phosphorylated states, with arrows for the chosen hypothesis.

Counterpart of ``phoskintime_tpu/report/diagram.py``, drawn by the port's
own drawing layer (:mod:`phoskintime_tpu_torch.report.draw`): the same
nodes, labels, arrows, limits and title.
"""

from __future__ import annotations

import os

import numpy as np

from phoskintime_tpu_torch.report.draw import Circle, subplots


def illustrate(gene: str, num_psites: int, model: str, out_dir: str) -> str:
    """The mechanism graph of ``model`` (distmod: each site from P;
    succmod: a chain of sites; randmod: up to 7 of the site subsets) as
    ``<out_dir>/<gene>_diagram.png``; returns its path."""
    os.makedirs(str(out_dir), exist_ok=True)
    fig, ax = subplots(figsize=(7, 4.5))
    ax.axis("off")

    def node(x, y, label, color="#cfe2ff"):
        ax.add_patch(Circle((x, y), 0.22, color=color, ec="k", zorder=2))
        ax.text(x, y, label, ha="center", va="center", fontsize=8)

    def arrow(x0, y0, x1, y1, **kw):
        ax.annotate("", xy=(x1, y1), xytext=(x0, y0),
                    arrowprops=dict(arrowstyle="-|>", lw=1.2, **kw))

    node(0.5, 2.0, "gene", "#ffe9a8")
    node(1.6, 2.0, "R")
    node(2.7, 2.0, "P")
    arrow(0.75, 2.0, 1.35, 2.0)
    arrow(1.85, 2.0, 2.45, 2.0)

    if model == "succmod":
        for i in range(num_psites):
            x = 3.8 + i * 1.1
            node(x, 2.0, f"P{i + 1}", "#d3f8d3")
            arrow(x - 0.85, 2.05, x - 0.25, 2.05)
            arrow(x - 0.25, 1.95, x - 0.85, 1.95, color="gray")
    elif model == "randmod":
        m = (1 << num_psites) - 1
        shown = min(m, 7)
        for s in range(1, shown + 1):
            ang = np.pi * (0.15 + 0.7 * (s - 1) / max(shown - 1, 1))
            x, y = 2.7 + 1.6 * np.cos(ang - np.pi / 2), 2.0 + 1.4 * np.sin(ang - np.pi / 2)
            bits = ",".join(str(j + 1) for j in range(num_psites) if s >> j & 1)
            node(x, y, f"P{{{bits}}}", "#d3f8d3")
            arrow(2.85, 2.1 if y > 2 else 1.9, x - 0.2, y)
    else:  # distributive
        for i in range(num_psites):
            x = 3.8
            y = 2.8 - i * 0.8
            node(x, y, f"P{i + 1}", "#d3f8d3")
            arrow(2.9, 2.0, x - 0.25, y)
            arrow(x - 0.25, y - 0.08, 2.92, 1.9, color="gray")

    ax.set_xlim(0, 8)
    ax.set_ylim(0, 4)
    ax.set_title(f"{gene}: {model} mechanism ({num_psites} sites)")
    path = os.path.join(str(out_dir), f"{gene}_diagram.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    return path
