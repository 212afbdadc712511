"""Multi-objective quality indicators and decision-making helpers.

Counterpart of ``phoskintime_tpu/ops/indicators.py`` (numpy only, copied).

Spec: reference kinopt post-optimization analysis
(``kinopt/evol/opt/optrun.py:505-540``, pymoo Hypervolume / IGD+ history,
ASF and pseudo-weight solution picking). pymoo is unavailable, so the
indicators are implemented directly:

* hypervolume: exact WFG-style recursive exclusive-volume computation
  (fine for <= 3 objectives and front sizes in the hundreds);
* IGD+ (Ishibuchi 2015): mean over reference points of the modified
  distance max(a - z, 0);
* ASF (Wierzbicki achievement scalarizing) and pseudo-weights (pymoo's
  normalized-distance weights) for picking one solution off a front.
"""

from __future__ import annotations

import numpy as np


def _pareto_filter(F: np.ndarray) -> np.ndarray:
    keep = np.ones(len(F), bool)
    for i in range(len(F)):
        if not keep[i]:
            continue
        dom = (F <= F[i]).all(axis=1) & (F < F[i]).any(axis=1)
        if dom.any():
            keep[i] = False
    return F[keep]


def hypervolume(F: np.ndarray, ref_point: np.ndarray) -> float:
    """Exact hypervolume dominated by F relative to ref_point (minimize)."""
    F = np.asarray(F, float)
    ref = np.asarray(ref_point, float)
    F = F[(F < ref).all(axis=1)]
    if len(F) == 0:
        return 0.0
    F = _pareto_filter(F)

    def hv(points, ref):
        m = points.shape[1]
        if m == 1:
            return float(ref[0] - points[:, 0].min())
        # sweep the last objective (sorted), slicing into (m-1)-dim volumes
        order = np.argsort(points[:, -1])
        pts = points[order]
        total = 0.0
        prev = ref[-1]
        for i in range(len(pts) - 1, -1, -1):
            z = pts[i, -1]
            depth = prev - z
            if depth > 0:
                sub = _pareto_filter(pts[: i + 1, :-1])
                total += depth * hv(sub, ref[:-1])
                prev = z
        return total

    return hv(F, ref)


def igd_plus(F: np.ndarray, reference_front: np.ndarray) -> float:
    """IGD+ of front F against a reference front (both minimized)."""
    F = np.asarray(F, float)
    Z = np.asarray(reference_front, float)
    d = np.maximum(F[None, :, :] - Z[:, None, :], 0.0)   # (|Z|, |F|, m)
    dist = np.sqrt((d ** 2).sum(-1))
    return float(dist.min(axis=1).mean())


def asf_pick(F: np.ndarray, weights: np.ndarray) -> int:
    """Index of the front member minimizing the augmented ASF."""
    F = np.asarray(F, float)
    ideal = F.min(axis=0)
    nadir = F.max(axis=0)
    Fn = (F - ideal) / np.maximum(nadir - ideal, 1e-12)
    w = np.maximum(np.asarray(weights, float), 1e-12)
    asf = np.max(Fn / w, axis=1) + 1e-4 * (Fn / w).sum(axis=1)
    return int(np.argmin(asf))


def pseudo_weights(F: np.ndarray) -> np.ndarray:
    """pymoo-style pseudo-weights: normalized distance to the worst point."""
    F = np.asarray(F, float)
    ideal = F.min(axis=0)
    nadir = F.max(axis=0)
    dist = (nadir - F) / np.maximum(nadir - ideal, 1e-12)
    s = dist.sum(axis=1, keepdims=True)
    return dist / np.maximum(s, 1e-12)


def pseudo_weight_pick(F: np.ndarray, target_weights: np.ndarray) -> int:
    """Front member whose pseudo-weights are closest to the target."""
    pw = pseudo_weights(F)
    tw = np.asarray(target_weights, float)
    tw = tw / max(tw.sum(), 1e-12)
    return int(np.argmin(((pw - tw) ** 2).sum(axis=1)))


def convergence_history(history, ref_point=None):
    """Per-generation hypervolume from a MOOResult.history list.

    history entries are (gen, F_min, F_mean); for full-front histories pass
    a list of (gen, F_front) pairs instead. When ``ref_point`` is None it
    is fixed ONCE from the max across the whole history — a per-generation
    reference would make the series incomparable across generations
    (review finding).
    """
    if not history:
        return []
    if ref_point is None:
        all_F = np.vstack([np.atleast_2d(np.asarray(e[1], float))
                           for e in history])
        ref_point = all_F.max(axis=0) * 1.1 + 1e-9
    rp = np.asarray(ref_point, float)
    rows = []
    for entry in history:
        gen, data = entry[0], entry[1]
        F = np.atleast_2d(np.asarray(data, float))
        rows.append((gen, hypervolume(F, rp)))
    return rows
