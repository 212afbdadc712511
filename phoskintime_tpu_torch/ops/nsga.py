"""Evolutionary multi-objective optimizers: U-NSGA-III, NSGA-II,
SMS-EMOA, AGE-MOEA and DE, with the fused device variation step.

Counterpart of ``phoskintime_tpu/ops/nsga.py``. The host functions are
numpy, copied so that the same ``default_rng`` draws give the same
results: Das-Dennis directions, LHS, non-dominated sorting (the native C++
sort for large populations, :mod:`phoskintime_tpu_torch.native`),
NSGA-III normalisation, association and niching survival, NSGA-II
crowding survival, the exact 3-objective hypervolume and its
contributions (native where available) behind SMS-EMOA, AGE-MOEA's
p-norm survival, SBX, polynomial mutation, duplicate elimination and the
binary tournament. :func:`run_unsga3` (the global fit), :func:`run_nsga2`,
:func:`run_smsemoa`, :func:`run_agemoea` and :func:`run_de` (kinopt and
tfopt) are the generation loops with batched evaluation.

:func:`make_device_ga_step` runs variation and the population objective on
the objective's device (:func:`~phoskintime_tpu_torch.ops.nsga_device.variation`,
draws from a ``torch.Generator`` seeded from the host rng each
generation, as the JAX package seeds its ``PRNGKey``); the host keeps
survival only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Callable

import numpy as np
import torch


# ---------------------------------------------------------------------------
# reference directions / sampling
# ---------------------------------------------------------------------------

def das_dennis(n_obj: int, n_partitions: int) -> np.ndarray:
    """Das-Dennis simplex lattice reference directions."""
    if n_partitions == 0:
        return np.full((1, n_obj), 1.0 / n_obj)
    out = []
    for c in combinations(range(n_partitions + n_obj - 1), n_obj - 1):
        c = np.asarray(c)
        prev = np.concatenate([[-1], c])
        counts = np.diff(prev) - 1
        counts = np.append(counts, n_partitions + n_obj - 2 - (c[-1] if len(c) else -1))
        out.append(counts / n_partitions)
    return np.asarray(out)


def lhs_sampling(n: int, xl: np.ndarray, xu: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """Latin hypercube sampling in [xl, xu].

    Vectorized: per-column independent shuffles via ``rng.permuted``
    (the per-column Python loop was ~8 ms/call at n_var=1103)."""
    d = len(xl)
    U = (np.arange(n)[:, None] + rng.random((n, d))) / n
    U = rng.permuted(U, axis=0)
    return xl + U * (xu - xl)


# ---------------------------------------------------------------------------
# dominance machinery
# ---------------------------------------------------------------------------

def fast_non_dominated_sort(F: np.ndarray) -> list[np.ndarray]:
    """Fronts of indices, best first (Deb et al. 2002).

    Large populations route through the native C++ kernel
    (:mod:`phoskintime_tpu_torch.native`): the numpy path materializes three
    (n, n, m) broadcasts — ~1.2 GB per sort at the 10k-candidate
    north-star ensemble — while the native sort is allocation-light.
    """
    n = F.shape[0]
    if n > 512:
        from phoskintime_tpu_torch.native import nd_sort_ranks

        ranks = nd_sort_ranks(np.asarray(F, float))
        if ranks is not None:
            n_fronts = int(ranks.max()) + 1
            order = np.argsort(ranks, kind="stable")
            bounds = np.searchsorted(ranks[order], np.arange(n_fronts + 1))
            return [order[bounds[r]:bounds[r + 1]] for r in range(n_fronts)]
    # dominance matrix: d[i, j] = True iff i dominates j
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    dom = le & lt
    n_dominated_by = dom.sum(axis=0)
    fronts = []
    remaining = np.ones(n, bool)
    counts = n_dominated_by.copy()
    while remaining.any():
        front = np.where(remaining & (counts == 0))[0]
        if len(front) == 0:  # numerical ties; dump the rest
            front = np.where(remaining)[0]
        fronts.append(front)
        remaining[front] = False
        counts = counts - dom[front].sum(axis=0)
    return fronts


def crowding_distance(F: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance within one front."""
    n, m = F.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for j in range(m):
        order = np.argsort(F[:, j], kind="stable")
        fj = F[order, j]
        span = fj[-1] - fj[0]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span > 0:
            dist[order[1:-1]] += (fj[2:] - fj[:-2]) / span
    return dist


def _achievement_scalarizing(F: np.ndarray, weights: np.ndarray) -> np.ndarray:
    w = np.where(weights > 1e-10, weights, 1e-10)
    return np.max(F / w, axis=-1)


def _hyperplane_intercepts(F: np.ndarray, ideal: np.ndarray) -> np.ndarray:
    """NSGA-III normalization intercepts from extreme points."""
    m = F.shape[1]
    Fs = F - ideal
    extremes = np.empty(m, int)
    for j in range(m):
        w = np.full(m, 1e-6)
        w[j] = 1.0
        extremes[j] = int(np.argmin(_achievement_scalarizing(Fs, w)))
    E = Fs[extremes]
    try:
        plane = np.linalg.solve(E, np.ones(m))
        with np.errstate(divide="ignore"):
            intercepts = np.where(plane != 0, 1.0 / np.where(plane != 0, plane, 1.0),
                                  np.inf)
        if np.any(intercepts < 1e-10) or not np.all(np.isfinite(intercepts)):
            raise np.linalg.LinAlgError
    except np.linalg.LinAlgError:
        intercepts = Fs.max(axis=0)
    return np.where(intercepts > 1e-10, intercepts, Fs.max(axis=0) + 1e-10)


def associate_to_refs(Fn: np.ndarray, ref_dirs: np.ndarray):
    """Closest reference line (perpendicular distance) per solution."""
    norms = np.linalg.norm(ref_dirs, axis=1)
    unit = ref_dirs / norms[:, None]
    if Fn.shape[0] * ref_dirs.shape[0] > 1_000_000:
        from phoskintime_tpu_torch.native import associate_native

        out = associate_native(Fn, unit)
        if out is not None:
            return out
    proj = Fn @ unit.T                       # (n, R)
    d2 = (Fn ** 2).sum(axis=1)[:, None] - proj ** 2
    dist = np.sqrt(np.maximum(d2, 0.0))
    niche = np.argmin(dist, axis=1)
    return niche, dist[np.arange(len(Fn)), niche]


def nsga3_survival(X: np.ndarray, F: np.ndarray, n_survive: int,
                   ref_dirs: np.ndarray, rng: np.random.Generator):
    """NSGA-III environmental selection. Returns (X, F, rank, niche, dist)."""
    fronts = fast_non_dominated_sort(F)
    rank = np.empty(len(F), int)
    for r, fr in enumerate(fronts):
        rank[fr] = r

    ideal = F.min(axis=0)
    intercepts = _hyperplane_intercepts(F, ideal)
    Fn = (F - ideal) / intercepts
    niche, nd = associate_to_refs(Fn, ref_dirs)

    chosen: list[int] = []
    for fr in fronts:
        if len(chosen) + len(fr) <= n_survive:
            chosen.extend(fr.tolist())
            if len(chosen) == n_survive:
                break
        else:
            k = n_survive - len(chosen)
            # niche counts from already-chosen members
            counts = np.bincount(niche[np.asarray(chosen, int)] if chosen else
                                 np.zeros(0, int), minlength=len(ref_dirs))
            # array-resident niching (the list.remove + per-iteration
            # asarray variant measured ~19 ms/gen at pop 384)
            cand = np.asarray(fr, int)
            cn = niche[cand]
            cd = nd[cand]
            alive = np.ones(len(cand), bool)
            selected: list[int] = []
            while len(selected) < k and alive.any():
                cc = np.where(alive, counts[cn], np.iinfo(np.int64).max)
                min_count = cc.min()
                pool = np.where(cc == min_count)[0]
                # within the niche pool, prefer smallest perpendicular
                # distance for empty niches, random otherwise
                pick = (int(pool[np.argmin(cd[pool])]) if min_count == 0
                        else int(pool[rng.integers(len(pool))]))
                selected.append(int(cand[pick]))
                alive[pick] = False
                counts[cn[pick]] += 1
            chosen.extend(selected)
            break
    idx = np.asarray(chosen[:n_survive], int)
    return X[idx], F[idx], rank[idx], niche[idx], nd[idx]


def nsga2_survival(X: np.ndarray, F: np.ndarray, n_survive: int):
    """NSGA-II survival (rank + crowding)."""
    fronts = fast_non_dominated_sort(F)
    chosen: list[int] = []
    for fr in fronts:
        if len(chosen) + len(fr) <= n_survive:
            chosen.extend(fr.tolist())
        else:
            cd = crowding_distance(F[fr])
            order = np.argsort(-cd, kind="stable")
            chosen.extend(fr[order[: n_survive - len(chosen)]].tolist())
            break
    idx = np.asarray(chosen, int)
    return X[idx], F[idx]


# ---------------------------------------------------------------------------
# variation operators
# ---------------------------------------------------------------------------

def sbx_crossover(parents_a, parents_b, xl, xu, rng, prob=0.9, eta=15.0,
                  dtype=np.float64):
    """Simulated binary crossover (per-variable, pymoo-compatible form), at
    ``dtype``: the JAX package runs it in float32 unless its working dtype
    is float64; here the caller passes the working dtype (the system's, in
    :func:`~phoskintime_tpu_torch.network.optimize.run_global_fit`).

    The spread factor is computed with a SINGLE fused power."""
    f32 = np.dtype(dtype).type
    Xa = parents_a.astype(f32)
    Xb = parents_b.astype(f32)
    n, d = Xa.shape
    do_cx = rng.random(n) <= prob
    u = rng.random((n, d), dtype=f32)
    base = np.where(u <= 0.5, 2 * u, 1.0 / np.maximum(2 * (1 - u), f32(1e-7)))
    beta = base ** f32(1.0 / (eta + 1))
    swap = rng.random((n, d)) <= 0.5
    c1 = f32(0.5) * ((1 + beta) * Xa + (1 - beta) * Xb)
    c2 = f32(0.5) * ((1 - beta) * Xa + (1 + beta) * Xb)
    o1 = np.where(swap, c2, c1)
    o2 = np.where(swap, c1, c2)
    o1 = np.where(do_cx[:, None], o1, Xa)
    o2 = np.where(do_cx[:, None], o2, Xb)
    xl32 = np.asarray(xl, f32)
    xu32 = np.asarray(xu, f32)
    return np.clip(o1, xl32, xu32), np.clip(o2, xl32, xu32)


def polynomial_mutation(X, xl, xu, rng, prob=None, eta=10.0):
    """Polynomial mutation (Deb & Goyal 1996).

    With prob = 1/n_var only ~n entries mutate, so the expensive powers run
    on the SELECTED entries only (sparse path), not on the (n, d) matrix."""
    X = np.array(X, copy=True)
    n, d = X.shape
    if prob is None:
        prob = 1.0 / d
    do = rng.random((n, d)) <= prob
    rows, cols = np.nonzero(do)
    if len(rows) == 0:
        return np.clip(X, xl, xu)
    u = rng.random(len(rows))

    xl_b = np.broadcast_to(xl, (n, d))
    xu_b = np.broadcast_to(xu, (n, d))
    lo = xl_b[rows, cols]
    hi = xu_b[rows, cols]
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    x = X[rows, cols]
    d1 = (x - lo) / span
    d2 = (hi - x) / span
    mut_pow = 1.0 / (eta + 1.0)
    val_lo = 2 * u + (1 - 2 * u) * (1 - d1) ** (eta + 1)
    val_hi = 2 * (1 - u) + 2 * (u - 0.5) * (1 - d2) ** (eta + 1)
    delta = np.where(u <= 0.5,
                     val_lo ** mut_pow - 1.0,
                     1.0 - val_hi ** mut_pow)
    X[rows, cols] = x + delta * span
    return np.clip(X, xl, xu)


def _duplicate_mask(off: np.ndarray, X: np.ndarray,
                    xl: np.ndarray | None = None,
                    xu: np.ndarray | None = None) -> np.ndarray:
    """True per offspring row that duplicates a population row.

    Row-bytes hashing (tuple-of-1103-floats keys measured ~30 ms/gen at
    n_var=1103). Both sides are cast f32 THEN rounded: offspring come out
    of the f32 SBX path, so an f64-only key never matches a cloned f64
    parent and the guard would silently no-op (caught in review).

    Quantization is RELATIVE to the per-variable span when bounds are
    given — absolute 1e-5 rounding misclassified genuinely-distinct
    near-converged offspring as duplicates late in a run, wasting their
    evaluations on random replacements (advisor finding r2)."""
    offq = np.asarray(off, np.float32)
    popq = np.asarray(X, np.float32)
    if xl is not None and xu is not None:
        span = np.maximum(np.asarray(xu, np.float32)
                          - np.asarray(xl, np.float32), 1e-12)
        lo = np.asarray(xl, np.float32)
        offq = (offq - lo) / span
        popq = (popq - lo) / span
    key = np.ascontiguousarray(np.round(offq, 6))
    pop_rows = np.ascontiguousarray(np.round(popq, 6))
    pop_key = {pop_rows[i].tobytes() for i in range(len(pop_rows))}
    return np.fromiter((key[i].tobytes() in pop_key
                        for i in range(len(key))), bool, len(key))


def _tournament(rank_like: np.ndarray, tiebreak: np.ndarray, n_pairs: int,
                rng: np.random.Generator) -> np.ndarray:
    """Binary tournament: lower rank wins, tie -> lower tiebreak value."""
    n = len(rank_like)
    a = rng.integers(n, size=n_pairs)
    b = rng.integers(n, size=n_pairs)
    better = np.where(rank_like[a] < rank_like[b], a,
                      np.where(rank_like[b] < rank_like[a], b,
                               np.where(tiebreak[a] <= tiebreak[b], a, b)))
    return better


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@dataclass
class MOOResult:
    X: np.ndarray            # final population decision vectors
    F: np.ndarray            # final population objectives
    pareto_X: np.ndarray     # non-dominated set
    pareto_F: np.ndarray
    history: list = field(default_factory=list)  # (gen, F_min, F_mean)
    n_gen: int = 0
    n_evals: int = 0


def _ideal_stop(ideal_history, ftol, ftol_period) -> bool:
    """The sliding-window termination: the relative movement of the ideal
    point over the last ``ftol_period`` generations is below ``ftol``."""
    if len(ideal_history) <= ftol_period:
        return False
    prev = ideal_history[-ftol_period - 1]
    cur = ideal_history[-1]
    denom = np.maximum(np.abs(prev), 1e-12)
    return bool(np.max(np.abs(cur - prev) / denom) < ftol)


def run_unsga3(evaluate: Callable[[np.ndarray], np.ndarray],
               xl: np.ndarray, xu: np.ndarray,
               pop_size: int = 300, n_gen: int = 100,
               n_obj: int = 3, n_partitions: int = 20,
               seed: int = 42,
               sbx_prob: float = 0.9, sbx_eta: float = 15.0,
               pm_eta: float = 10.0,
               ftol: float = 0.0025, ftol_period: int = 30,
               n_max_evals: int | None = 100_000,
               x0: np.ndarray | None = None,
               callback: Callable | None = None,
               verbose: bool = False,
               logger=None,
               device_step=None,
               dtype=np.float64,
               checkpoint=None) -> MOOResult:
    """U-NSGA-III loop with batched evaluation, as the JAX package's.

    evaluate: (P, n) -> (P, n_obj) numpy. The reference configuration
    (das-dennis, LHS, SBX, PM, duplicate elimination, sliding-window ftol
    termination). ``dtype``: the host variation's precision (SBX); the JAX
    package takes its working dtype there.

    device_step: optional fused variation + evaluation from
    :func:`make_device_ga_step`, which replaces the host tournament, SBX,
    PM and duplicate elimination with one call on the device a
    generation; the host keeps survival only.

    checkpoint: a :class:`~phoskintime_tpu_torch.parallel.checkpoint.GACheckpointer`.
    Every ``checkpoint.every`` generations it stores the whole loop state
    (population, ranks, the host rng's state, the histories); a run given
    a checkpoint that holds one continues from it to generation ``n_gen``,
    so an interrupted run resumed with the same arguments ends as the
    uninterrupted one would.
    """
    rng = np.random.default_rng(seed)
    xl = np.asarray(xl, float)
    xu = np.asarray(xu, float)
    ref_dirs = das_dennis(n_obj, n_partitions)

    state = None if checkpoint is None else checkpoint.resume_state()
    if state is None:
        X = lhs_sampling(pop_size, xl, xu, rng) if x0 is None else np.array(x0)
        if x0 is not None and len(X) < pop_size:
            X = np.vstack([X, lhs_sampling(pop_size - len(X), xl, xu, rng)])
        F = np.asarray(evaluate(X), float)
        n_evals = len(X)
        X, F, rank, niche, nd = nsga3_survival(X, F, pop_size, ref_dirs, rng)
        history: list = []
        ideal_history = [F.min(axis=0)]
        gen0 = 0
    else:
        X, F, rank, niche, nd = (state[k] for k in ("X", "F", "rank", "niche", "nd"))
        rng.bit_generator.state = state["rng"]
        history, ideal_history = list(state["history"]), list(state["ideal_history"])
        n_evals, gen0 = state["n_evals"], state["gen"]

    gen = gen0
    for gen in range(gen0 + 1, n_gen + 1):
        n_off = pop_size
        if device_step is not None:
            off, F_off = device_step(X, rank, nd, int(rng.integers(2 ** 31 - 1)), xl, xu)
            F_off = np.asarray(F_off, float)
        else:
            # U-NSGA-III tournament: rank, tie-broken by ref-line distance
            pa = _tournament(rank, nd, n_off, rng)
            pb = _tournament(rank, nd, n_off, rng)
            o1, o2 = sbx_crossover(X[pa], X[pb], xl, xu, rng,
                                   prob=sbx_prob, eta=sbx_eta, dtype=dtype)
            off = np.vstack([o1, o2])[:n_off]
            off = polynomial_mutation(off, xl, xu, rng, eta=pm_eta)

            # duplicate elimination against current pop
            dup = _duplicate_mask(off, X, xl, xu)
            if dup.any():
                off[dup] = lhs_sampling(int(dup.sum()), xl, xu, rng)

            F_off = np.asarray(evaluate(off), float)
        n_evals += len(off)

        X, F, rank, niche, nd = nsga3_survival(np.vstack([X, off]), np.vstack([F, F_off]),
                                               pop_size, ref_dirs, rng)
        history.append((gen, F.min(axis=0).copy(), F.mean(axis=0).copy()))
        ideal_history.append(F.min(axis=0))
        if checkpoint is not None:
            checkpoint(gen, X, F, loop={
                "X": X, "F": F, "rank": rank, "niche": niche, "nd": nd,
                "rng": rng.bit_generator.state, "history": history,
                "ideal_history": ideal_history, "n_evals": n_evals, "gen": gen})
        if callback is not None and callback(gen, X, F):
            break  # truthy callback return = early stop (pruning bridge)
        if verbose and logger is not None and gen % 10 == 0:
            logger.info(f"[UNSGA3] gen {gen}: ideal={F.min(axis=0)}")
        if _ideal_stop(ideal_history, ftol, ftol_period):
            break
        if n_max_evals is not None and n_evals >= n_max_evals:
            break

    fronts = fast_non_dominated_sort(F)
    pf = fronts[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)


def run_nsga2(evaluate, xl, xu, pop_size=100, n_gen=100, seed=42,
              sbx_prob=0.9, sbx_eta=15.0, pm_eta=20.0,
              constraint_fn=None, x0=None, repair_fn=None,
              callback=None, dtype=np.float64) -> MOOResult:
    """NSGA-II with optional constraint handling (feasibility-first:
    infeasible solutions are penalized by total violation). ``dtype``: the
    host SBX's precision, as :func:`run_unsga3`'s."""
    rng = np.random.default_rng(seed)
    xl, xu = np.asarray(xl, float), np.asarray(xu, float)

    def eval_all(Xb):
        F = np.asarray(evaluate(Xb), float)
        if constraint_fn is not None:
            G = np.asarray(constraint_fn(Xb), float)
            cv = np.maximum(G, 0.0).sum(axis=1)
            F = F + 1e6 * cv[:, None]
        return F

    X = lhs_sampling(pop_size, xl, xu, rng) if x0 is None else np.array(x0)
    if repair_fn is not None:
        X = repair_fn(X)
    F = eval_all(X)
    n_evals = len(X)
    history = []

    gen = 0
    for gen in range(1, n_gen + 1):
        fronts = fast_non_dominated_sort(F)
        rank = np.empty(len(F), int)
        cd = np.empty(len(F))
        for r, fr in enumerate(fronts):
            rank[fr] = r
            cd[fr] = crowding_distance(F[fr])
        pa = _tournament(rank, -cd, pop_size, rng)
        pb = _tournament(rank, -cd, pop_size, rng)
        o1, o2 = sbx_crossover(X[pa], X[pb], xl, xu, rng, prob=sbx_prob, eta=sbx_eta,
                               dtype=dtype)
        off = polynomial_mutation(np.vstack([o1, o2])[:pop_size], xl, xu, rng,
                                  eta=pm_eta)
        if repair_fn is not None:
            off = repair_fn(off)
        F_off = eval_all(off)
        n_evals += len(off)
        X, F = nsga2_survival(np.vstack([X, off]), np.vstack([F, F_off]), pop_size)
        history.append((gen, F.min(axis=0).copy(), F.mean(axis=0).copy()))
        if callback is not None:
            callback(gen, X, F)

    fronts = fast_non_dominated_sort(F)
    pf = fronts[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)


# ---------------------------------------------------------------------------
# hypervolume (3-objective, minimization) — the S-metric behind SMS-EMOA
# ---------------------------------------------------------------------------

def _staircase_area(xy: np.ndarray, rx: float, ry: float) -> float:
    """Area of union of [x_i, rx] x [y_i, ry] rectangles (minimization)."""
    if len(xy) == 0:
        return 0.0
    order = np.argsort(xy[:, 0], kind="stable")
    xs, ys = xy[order, 0], xy[order, 1]
    # keep the lower staircase: strictly decreasing y as x increases
    keep_x, keep_y = [], []
    best_y = np.inf
    for x, y in zip(xs, ys):
        if y < best_y:
            keep_x.append(x)
            keep_y.append(y)
            best_y = y
    area = 0.0
    y_prev = ry
    for x, y in zip(keep_x, keep_y):
        area += (y_prev - y) * (rx - x)
        y_prev = y
    return area


def hv3d(F: np.ndarray, ref: np.ndarray) -> float:
    """Exact hypervolume of a 3-objective minimization set w.r.t. ``ref``
    (z-sweep of 2D staircase areas, Fonseca-style). Points outside the
    reference box contribute nothing.

    This is the m=3 fast path for SMS-EMOA's per-iteration survival;
    the general-m recursive implementation lives in
    ``ops.indicators.hypervolume`` (equivalence covered by tests)."""
    F = np.asarray(F, float)
    if F.ndim != 2 or F.shape[1] != 3:
        raise ValueError("hv3d expects (n, 3)")
    ref = np.asarray(ref, float)
    inside = np.all(F < ref, axis=1)
    F = F[inside]
    if len(F) == 0:
        return 0.0
    order = np.argsort(F[:, 2], kind="stable")
    F = F[order]
    zs = F[:, 2]
    vol = 0.0
    for k in range(len(F)):
        z_hi = zs[k + 1] if k + 1 < len(F) else ref[2]
        dz = z_hi - zs[k]
        if dz <= 0:
            continue
        vol += dz * _staircase_area(F[: k + 1, :2], ref[0], ref[1])
    return vol


def hv_contributions_3d(F: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Leave-one-out hypervolume contributions (exact).

    Routed through the native C++ kernel when available (incremental
    staircase sweep, O(n^2 log n) — the pure-Python fallback rebuilds
    the staircase per slab and is O(n^3)-ish, fine only for small n)."""
    F = np.asarray(F, float)
    if F.ndim != 2 or F.shape[1] != 3:
        raise ValueError(f"hv_contributions_3d expects (n, 3); got {F.shape}")
    if len(F) == 0:
        return np.empty(0)
    from phoskintime_tpu_torch.native import hv3d_contrib_native

    native = hv3d_contrib_native(F, np.asarray(ref, float))
    if native is not None:
        return native
    total = hv3d(F, ref)
    out = np.empty(len(F))
    for i in range(len(F)):
        out[i] = total - hv3d(np.delete(F, i, axis=0), ref)
    return out


def _least_hv_truncate(F_all: np.ndarray, members: np.ndarray, ref: np.ndarray,
                       n_keep: int) -> list[int]:
    """Iteratively drop the least-hypervolume contributor until ``n_keep``
    members remain (SMS-EMOA / pymoo LeastHypervolumeContribution survival).

    Exact semantics at amortized ~O(n log n) per removal instead of the
    naive O(n^2 log n) full-recompute (advisor r2 finding): a point's
    contribution can only GROW when another point is removed, so values
    computed against an earlier (larger) set are LOWER BOUNDS of the
    current ones. The lazy greedy pops the stale argmin, refreshes just
    that point with the native single-point exclusive-volume kernel, and
    removes it only when its fresh value is <= every remaining key.
    """
    from phoskintime_tpu_torch.native import hv3d_one_contrib_native

    idx = np.asarray(members, int)
    n = len(idx)
    if n <= n_keep:
        return idx.tolist()
    vals = np.asarray(hv_contributions_3d(F_all[idx], ref), float).copy()
    fresh = np.ones(n, bool)
    alive = np.ones(n, bool)
    n_alive = n
    while n_alive > n_keep:
        sub = np.where(alive)[0]
        k = sub[int(np.argmin(vals[sub]))]
        if fresh[k]:
            alive[k] = False
            n_alive -= 1
            fresh[alive] = False  # remaining values become lower bounds
        else:
            pos = int(np.searchsorted(sub, k))
            one = hv3d_one_contrib_native(F_all[idx[sub]], pos, ref)
            if one is None:  # no native lib: exact full recompute
                vals[sub] = hv_contributions_3d(F_all[idx[sub]], ref)
                fresh[sub] = True
            else:
                vals[k] = one
                fresh[k] = True
    return idx[alive].tolist()


def run_smsemoa(evaluate, xl, xu, pop_size=100, n_gen=1000,
                n_offsprings: int | None = None, seed=42,
                sbx_prob=0.9, sbx_eta=15.0, pm_eta=20.0,
                callback=None, dtype=np.float64) -> MOOResult:
    """SMS-EMOA (Beume, Naujoks & Emmerich 2007): survival iteratively
    discards the least hypervolume contributor of the splitting front
    (exact 3-objective S-metric, native C++ contributions kernel).

    ``n_offsprings`` defaults to ``pop_size`` — the pymoo configuration
    the reference runs (``tfopt/evol/opt/optrun.py:58``), so ``n_gen``
    carries the same evaluation budget as the generational algorithms.
    ``n_offsprings=1`` recovers the paper's original steady-state form,
    where the multi-front case drops the worst-front member dominated by
    the most points (the paper's d(x) criterion, Eq. 4).

    Cost note: the splitting-front truncation keeps pymoo's exact
    least-contributor-per-removal semantics via a lazy greedy backed by a
    native O(n log n) single-point refresh (:func:`_least_hv_truncate`) —
    amortized near-linear per removal instead of the naive full
    O(n^2 log n) recompute."""
    rng = np.random.default_rng(seed)
    xl, xu = np.asarray(xl, float), np.asarray(xu, float)
    if n_offsprings is None:
        n_offsprings = pop_size

    X = lhs_sampling(pop_size, xl, xu, rng)
    F = np.asarray(evaluate(X), float)
    n_evals = len(X)
    history = []

    gen = 0
    for gen in range(1, n_gen + 1):
        fronts = fast_non_dominated_sort(F)
        rank = np.empty(len(F), int)
        for r, fr in enumerate(fronts):
            rank[fr] = r
        pa = _tournament(rank, rng.random(len(F)), n_offsprings, rng)
        pb = _tournament(rank, rng.random(len(F)), n_offsprings, rng)
        o1, o2 = sbx_crossover(X[pa], X[pb], xl, xu, rng, prob=sbx_prob,
                               eta=sbx_eta, dtype=dtype)
        off = polynomial_mutation(np.vstack([o1, o2])[:n_offsprings],
                                  xl, xu, rng, eta=pm_eta)
        F_off = np.asarray(evaluate(off), float)
        n_evals += len(off)

        X_all = np.vstack([X, off])
        F_all = np.vstack([F, F_off])
        fronts = fast_non_dominated_sort(F_all)
        if n_offsprings == 1 and len(fronts) > 1:
            # original steady-state rule: d(x) on the worst front
            worst = fronts[-1]
            le = (F_all[:, None, :] <= F_all[None, worst, :]).all(-1)
            lt = (F_all[:, None, :] < F_all[None, worst, :]).any(-1)
            d = (le & lt).sum(axis=0)
            keep = np.ones(len(F_all), bool)
            keep[worst[int(np.argmax(d))]] = False
            X, F = X_all[keep], F_all[keep]
        else:
            # fill whole fronts; iteratively remove the least HV
            # contributor from the splitting front (exact per removal)
            chosen: list[int] = []
            for fr in fronts:
                if len(chosen) + len(fr) <= pop_size:
                    chosen.extend(fr.tolist())
                    if len(chosen) == pop_size:
                        break
                    continue
                ref = F_all[fr].max(axis=0) + 1.0
                chosen.extend(_least_hv_truncate(F_all, fr, ref,
                                                 pop_size - len(chosen)))
                break
            idx = np.asarray(chosen[:pop_size], int)
            X, F = X_all[idx], F_all[idx]

        history.append((gen, F.min(axis=0).copy(), F.mean(axis=0).copy()))
        if callback is not None:
            callback(gen, X, F)

    fronts = fast_non_dominated_sort(F)
    pf = fronts[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)


def _agemoea_survival(X, F, n_survive):
    """AGE-MOEA environmental selection (Panichella, GECCO 2019).

    Normalize by front-1 intercepts, estimate the front's geometry
    exponent p from the central point (front assumed on sum f_i^p = 1:
    a central point with ~equal coords c gives m c^p = 1, so
    p = ln m / -ln c), then keep extremes + maximize
    diversity/proximity under the p-norm; later fronts rank by proximity.
    """
    fronts = fast_non_dominated_sort(F)
    f1 = fronts[0]
    ideal = F.min(axis=0)
    intercepts = _hyperplane_intercepts(F[f1], ideal)
    Fn = (F - ideal) / np.where(intercepts > 1e-12, intercepts, 1.0)

    m = F.shape[1]
    # central point: minimum perpendicular distance to the unit diagonal
    diag = np.ones(m) / np.sqrt(m)
    proj = Fn[f1] @ diag
    perp = np.sqrt(np.maximum((Fn[f1] ** 2).sum(1) - proj ** 2, 0.0))
    central = Fn[f1][int(np.argmin(perp))]
    c = float(np.clip(central.mean(), 1e-3, 0.999))
    p = float(np.clip(np.log(m) / -np.log(c), 0.1, 10.0))

    def pnorm(A):
        return np.maximum(np.abs(A) ** p, 1e-12).sum(axis=-1) ** (1.0 / p)

    chosen: list[int] = []
    for r, fr in enumerate(fronts):
        if len(chosen) + len(fr) <= n_survive:
            chosen.extend(fr.tolist())
            if len(chosen) == n_survive:
                break
            continue
        k = n_survive - len(chosen)
        sub = Fn[fr]
        prox = pnorm(sub)
        if r == 0:
            # always keep the m extreme points first (axis-wise ASF, as
            # in the NSGA-III normalization)
            extremes = []
            for j in range(m):
                w = np.full(m, 1e-6)
                w[j] = 1.0
                extremes.append(int(np.argmin(
                    _achievement_scalarizing(sub, w))))
            sel = list(dict.fromkeys(extremes))[:k]
            remaining = [i for i in range(len(fr)) if i not in sel]
            # p-norm pairwise distances for the diversity term
            D = (np.abs(sub[:, None, :] - sub[None, :, :]) ** p
                 ).sum(-1) ** (1.0 / p)
            np.fill_diagonal(D, np.inf)
            while len(sel) < k and remaining:
                Dsel = D[np.ix_(remaining, sel)]
                if Dsel.shape[1] >= 2:
                    near2 = np.partition(Dsel, 1, axis=1)[:, :2].sum(1)
                else:
                    near2 = Dsel.min(axis=1)
                score = near2 / np.maximum(prox[remaining], 1e-12)
                pick = int(np.argmax(score))
                sel.append(remaining.pop(pick))
            chosen.extend(int(fr[i]) for i in sel[:k])
        else:
            order = np.argsort(prox, kind="stable")[:k]
            chosen.extend(int(fr[i]) for i in order)
        break
    idx = np.asarray(chosen[:n_survive], int)
    return X[idx], F[idx]


def run_agemoea(evaluate, xl, xu, pop_size=100, n_gen=100, seed=42,
                sbx_prob=0.9, sbx_eta=15.0, pm_eta=20.0,
                callback=None, dtype=np.float64) -> MOOResult:
    """AGE-MOEA (adaptive geometry estimation, Panichella 2019):
    generational GA with the p-norm survival above. Reference consumer:
    tfopt optimizer code 2 (``tfopt/evol/opt/optrun.py``, pymoo AGEMOEA
    there)."""
    rng = np.random.default_rng(seed)
    xl, xu = np.asarray(xl, float), np.asarray(xu, float)
    X = lhs_sampling(pop_size, xl, xu, rng)
    F = np.asarray(evaluate(X), float)
    n_evals = len(X)
    history = []

    gen = 0
    for gen in range(1, n_gen + 1):
        fronts = fast_non_dominated_sort(F)
        rank = np.empty(len(F), int)
        for r, fr in enumerate(fronts):
            rank[fr] = r
        pa = _tournament(rank, rng.random(len(F)), pop_size, rng)
        pb = _tournament(rank, rng.random(len(F)), pop_size, rng)
        o1, o2 = sbx_crossover(X[pa], X[pb], xl, xu, rng, prob=sbx_prob,
                               eta=sbx_eta, dtype=dtype)
        off = polynomial_mutation(np.vstack([o1, o2])[:pop_size], xl, xu,
                                  rng, eta=pm_eta)
        F_off = np.asarray(evaluate(off), float)
        n_evals += len(off)
        X, F = _agemoea_survival(np.vstack([X, off]),
                                 np.vstack([F, F_off]), pop_size)
        history.append((gen, F.min(axis=0).copy(), F.mean(axis=0).copy()))
        if callback is not None:
            callback(gen, X, F)

    fronts = fast_non_dominated_sort(F)
    pf = fronts[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)


def run_de(evaluate, xl, xu, pop_size=100, n_gen=1000, seed=42,
           F_weight=0.8, CR=0.9, constraint_fn=None, x0=None,
           repair_fn=None, callback=None) -> MOOResult:
    """DE/rand/1/bin single-objective minimizer with feasibility penalty
    (kinopt's DE mode, reference kinopt/evol/opt/optrun.py:352)."""
    rng = np.random.default_rng(seed)
    xl, xu = np.asarray(xl, float), np.asarray(xu, float)
    d = len(xl)

    def eval_all(Xb):
        f = np.asarray(evaluate(Xb), float).reshape(len(Xb))
        if constraint_fn is not None:
            G = np.asarray(constraint_fn(Xb), float)
            f = f + 1e6 * np.maximum(G, 0.0).sum(axis=1)
        return f

    X = lhs_sampling(pop_size, xl, xu, rng) if x0 is None else np.array(x0)
    if repair_fn is not None:
        X = repair_fn(X)
    f = eval_all(X)
    n_evals = len(X)
    history = []

    gen = 0
    for gen in range(1, n_gen + 1):
        idx = np.arange(pop_size)
        r1, r2, r3 = (rng.permutation(pop_size) for _ in range(3))
        V = X[r1] + F_weight * (X[r2] - X[r3])
        cross = rng.random((pop_size, d)) <= CR
        jrand = rng.integers(d, size=pop_size)
        cross[idx, jrand] = True
        U = np.clip(np.where(cross, V, X), xl, xu)
        if repair_fn is not None:
            U = repair_fn(U)
        fu = eval_all(U)
        n_evals += pop_size
        better = fu < f
        X = np.where(better[:, None], U, X)
        f = np.where(better, fu, f)
        history.append((gen, f.min(), f.mean()))
        if callback is not None:
            callback(gen, X, f)

    best = int(np.argmin(f))
    return MOOResult(X, f[:, None], X[best:best + 1], f[best:best + 1, None],
                     history, gen, n_evals)


# ---------------------------------------------------------------------------
# on-device variation (fused tournament -> SBX -> PM -> evaluation)
# ---------------------------------------------------------------------------

def make_device_ga_step(pop_objective, xl, xu, pop_size: int, *, dtype: torch.dtype,
                        device, sbx_prob=0.9, sbx_eta=15.0, pm_eta=10.0):
    """Variation and the population objective on ``device``, one call a
    generation: binary tournament, SBX, polynomial mutation, clone repair
    (:func:`~phoskintime_tpu_torch.ops.nsga_device.variation`) and
    ``pop_objective``, at ``dtype`` (the system's). The draws come from a
    ``torch.Generator`` on the device seeded with the host's ``seed``: the
    same distributions as the host operators, other draws.

    pop_objective: batched objective (P, n) -> (P, n_obj) on ``device``.
    Returns step(X, rank, nd, seed, xl=None, xu=None) -> (off, F_off) as
    float64 numpy; the bounds default to the ones given here."""
    from phoskintime_tpu_torch.ops.nsga_device import variation, variation_draws

    f = dict(dtype=dtype, device=device)
    xl0, xu0 = np.asarray(xl, float), np.asarray(xu, float)
    n_var = len(xl0)

    @torch.no_grad()
    def run(X, rank, nd, seed, xl=None, xu=None):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        lo = torch.as_tensor(xl0 if xl is None else np.asarray(xl, float), **f)
        hi = torch.as_tensor(xu0 if xu is None else np.asarray(xu, float), **f)
        off = variation(torch.as_tensor(np.asarray(X), **f),
                        torch.as_tensor(np.asarray(rank), device=device),
                        torch.as_tensor(np.asarray(nd), **f),
                        variation_draws(gen, pop_size, n_var, dtype, device), lo, hi,
                        sbx_prob=sbx_prob, sbx_eta=sbx_eta, pm_eta=pm_eta)
        F = pop_objective(off)
        return (off.to("cpu", torch.float64).numpy(),
                torch.as_tensor(F).to("cpu", torch.float64).numpy())

    return run
