"""The global model's figures: the Pareto front in 3-D, the convergence of
the ideal point and the front's parallel coordinates.

Counterpart of ``phoskintime_tpu/report/plotter.py``'s global-model
figures (``plot_pareto_3d``, ``plot_convergence``,
``plot_parallel_coords_pareto``), drawn by the port's own drawing layer
(:mod:`phoskintime_tpu_torch.report.draw`): the same figure sizes, dpi,
axes, data, colours and labels, the port's pixels. Each function brings
its tensors to the host once. The per-gene :class:`Plotter` is not ported
yet (ROADMAP.md queue 1 item 8d-figures, part 2) and raises.
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu_torch.io.utils import host
from phoskintime_tpu_torch.report.draw import TAB10, Figure, subplots

COLORS = TAB10


class Plotter:
    """The per-gene figure factory: not ported yet."""

    def __init__(self, *_args, **_kwargs):
        raise NotImplementedError("the per-gene Plotter is not ported yet (ROADMAP.md queue 1 "
                                  "item 8d-figures, part 2)")


def plot_pareto_3d(pareto_F, out_path, best_idx=None):
    """The front's objectives as a 3-D scatter, the pick as a red star."""
    F = host(pareto_F)
    fig = Figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(F[:, 0], F[:, 1], F[:, 2], s=15, alpha=0.7)
    if best_idx is not None:
        ax.scatter(*F[best_idx], color="red", s=60, marker="*", label="Frechet pick")
        ax.legend()
    ax.set_xlabel("protein")
    ax.set_ylabel("RNA")
    ax.set_zlabel("phospho")
    ax.set_title("Pareto front")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path


def plot_convergence(history, out_path):
    """The least objectives generation by generation, on a log axis (each
    floored at 1e-12); None without a history."""
    if not history:
        return None
    gens = [h[0] for h in history]
    mins = np.asarray([host(h[1]) for h in history])
    fig, ax = subplots(figsize=(7, 4))
    for j, lbl in enumerate(["protein", "RNA", "phospho"][: mins.shape[1]]):
        ax.semilogy(gens, np.maximum(mins[:, j], 1e-12), label=lbl, color=COLORS[j])
    ax.set_xlabel("generation")
    ax.set_ylabel("best objective")
    ax.set_title("convergence")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path


def plot_parallel_coords_pareto(pareto_F, out_path):
    """Each front member's objectives, scaled to [0, 1] over the front, as
    one line across the objectives."""
    F = host(pareto_F)
    lo, hi = F.min(axis=0), F.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    Fn = (F - lo) / span
    fig, ax = subplots(figsize=(6, 4))
    for row in Fn:
        ax.plot(row, alpha=0.4, color=COLORS[0])
    ax.set_xticks(range(F.shape[1]))
    ax.set_xticklabels(["protein", "RNA", "phospho"][: F.shape[1]])
    ax.set_title("Pareto parallel coordinates")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return out_path
