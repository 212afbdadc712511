"""U-NSGA-III and NSGA-II with the whole generation on the device:
variation, evaluation and survival.

Counterpart of ``phoskintime_tpu/ops/nsga_device.py``. The host GA
(:mod:`phoskintime_tpu_torch.ops.nsga`) keeps survival on the host and
pays a round trip a generation. Here tournament, SBX, polynomial
mutation, clone repair, the population objective, non-dominated ranking
and the survival (NSGA-III normalisation, association and niching, or
NSGA-II crowding, :func:`run_nsga2_device` for kinopt) all run on the
device, ``gens_per_block`` generations a block in a Python loop: the
population stays on the device, and the host reads only the (gens,
n_obj) ideal and mean history at the end of a block.

Each random function comes in two parts, so that a test can hand in the
JAX package's own draws: a function of explicit draws (:func:`variation`,
:func:`device_survival`) and a maker of the draws from a
``torch.Generator`` (:func:`variation_draws`, :func:`survival_draws`).
The draws are the JAX functions', in the order of their key splits; the
bits differ (another generator), the distributions do not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import DEFAULT_DEVICE, resolve_device, working_dtype
from phoskintime_tpu_torch.ops.nsga import (MOOResult, _ideal_stop, das_dennis,
                                            fast_non_dominated_sort, lhs_sampling)

# ---------------------------------------------------------------------------
# variation
# ---------------------------------------------------------------------------


class VariationDraws(NamedTuple):
    """The random numbers of one variation pass, in ``variation_kernel``'s
    split order (ka, kb, kcx, ku, ksw, kmd, kmu, kr1, kr2)."""
    ta: tuple               # tournament of the first parents: (a, b) indices (P,)
    tb: tuple               # of the second parents
    cx: torch.Tensor        # (P,) uniform: crossover when <= sbx_prob
    u: torch.Tensor         # (P, n) uniform: SBX spread
    swap: torch.Tensor      # (P, n) uniform: swap the children when <= 0.5
    mut: torch.Tensor       # (P, n) uniform: mutate when <= 1 / n
    um: torch.Tensor        # (P, n) uniform: mutation spread
    j: torch.Tensor         # (P,) index: the coordinate clone repair resamples
    new: torch.Tensor       # (P,) uniform: its new value within the bounds


def variation_draws(gen: torch.Generator, pop_size: int, n_var: int, dtype, device
                    ) -> VariationDraws:
    """Draws for :func:`variation` from ``gen`` (on ``device``)."""
    f = dict(dtype=dtype, device=device, generator=gen)

    def idx(size):
        return torch.randint(0, size, (pop_size,), device=device, generator=gen)

    ta = (idx(pop_size), idx(pop_size))
    tb = (idx(pop_size), idx(pop_size))
    cx = torch.rand(pop_size, **f)
    u, swap, mut, um = (torch.rand((pop_size, n_var), **f) for _ in range(4))
    return VariationDraws(ta, tb, cx, u, swap, mut, um, idx(n_var), torch.rand(pop_size, **f))


def variation(X, rank, nd, draws: VariationDraws, xl, xu, *, sbx_prob=0.9,
              sbx_eta=15.0, pm_eta=10.0):
    """One U-NSGA-III variation pass, the port of ``variation_kernel``:
    binary tournament (rank, tie-broken by reference-line distance), SBX,
    polynomial mutation, bound clip and clone repair (an offspring equal to
    its first parent gets one coordinate resampled). Returns the (P, n)
    offspring."""
    n_var = X.shape[1]
    span = torch.where(xu - xl > 0, xu - xl, torch.ones_like(xu))

    def tourney(ab):
        a, b = ab
        return torch.where(rank[a] < rank[b], a,
                           torch.where(rank[b] < rank[a], b, torch.where(nd[a] <= nd[b], a, b)))

    Xa = X[tourney(draws.ta)]
    Xb = X[tourney(draws.tb)]
    # SBX, one fused power as the host op
    u = draws.u
    base = torch.where(u <= 0.5, 2 * u, 1.0 / torch.clamp(2 * (1 - u), min=1e-7))
    beta = base ** (1.0 / (sbx_eta + 1.0))
    c1 = 0.5 * ((1 + beta) * Xa + (1 - beta) * Xb)
    c2 = 0.5 * ((1 - beta) * Xa + (1 + beta) * Xb)
    off = torch.where(draws.swap <= 0.5, c2, c1)
    off = torch.where((draws.cx <= sbx_prob)[:, None], off, Xa)
    off = torch.clamp(off, xl, xu)
    # polynomial mutation, dense
    um = draws.um
    d1 = (off - xl) / span
    d2 = (xu - off) / span
    mp = 1.0 / (pm_eta + 1.0)
    val_lo = 2 * um + (1 - 2 * um) * (1 - d1) ** (pm_eta + 1)
    val_hi = 2 * (1 - um) + 2 * (um - 0.5) * (1 - d2) ** (pm_eta + 1)
    delta = torch.where(um <= 0.5, val_lo ** mp - 1.0, 1.0 - val_hi ** mp)
    off = torch.where(draws.mut <= 1.0 / n_var, off + delta * span, off)
    off = torch.clamp(off, xl, xu)
    # clone repair
    clone = torch.all(off == Xa, dim=1)
    j = draws.j
    newv = xl[j] + draws.new * (xu[j] - xl[j])
    hit = clone[:, None] & (torch.arange(n_var, device=X.device)[None, :] == j[:, None])
    return torch.where(hit, newv[:, None], off)


# ---------------------------------------------------------------------------
# environmental selection
# ---------------------------------------------------------------------------


# fixpoint iterations of device_nd_ranks between two host reads of whether
# the ranks moved
_RANK_CHECK_EVERY = 4


def device_nd_ranks(F):
    """Non-dominated front index of each row, on F's device: the longest
    dominator chain, front(j) = max over dominators i of front(i) + 1 (0
    if none), a max-plus fixpoint that settles in as many iterations as
    there are fronts. The (Q, Q) dominance matrix is built one objective at
    a time (no (Q, Q, m) temporaries). The host reads whether the ranks
    moved once every ``_RANK_CHECK_EVERY`` iterations (past the fixpoint an
    iteration changes nothing), so a call makes about fronts / 4
    synchronizing reads."""
    le = F[:, None, 0] <= F[None, :, 0]
    lt = F[:, None, 0] < F[None, :, 0]
    for k in range(1, F.shape[1]):
        le &= F[:, None, k] <= F[None, :, k]
        lt |= F[:, None, k] < F[None, :, k]
    dom = le & lt                                   # dom[i, j]: i dominates j
    del le, lt
    zero = torch.zeros((), dtype=torch.int32, device=F.device)
    r = torch.zeros(F.shape[0], dtype=torch.int32, device=F.device)
    while True:
        prev = r
        for _ in range(_RANK_CHECK_EVERY):
            r = torch.where(dom, r[:, None] + 1, zero).amax(dim=0)
        if torch.equal(r, prev):
            return r


def _device_normalize(F):
    """NSGA-III ideal/intercept normalisation, branch-free (the host
    semantics of :func:`nsga._hyperplane_intercepts`). The linear solve
    reports a singular system in ``info`` instead of raising (which would
    read it on the host); that case takes the fallback, as non-finite
    intercepts do."""
    m = F.shape[1]
    ideal = torch.amin(F, dim=0)
    Fs = F - ideal
    eye = torch.eye(m, dtype=torch.bool, device=F.device)
    W = torch.where(eye, torch.ones((), dtype=F.dtype, device=F.device),
                    torch.full((), 1e-6, dtype=F.dtype, device=F.device))
    asf = torch.amax(Fs[None, :, :] / W[:, None, :], dim=-1)        # (m, Q)
    E = Fs[torch.argmin(asf, dim=1)]                               # (m, m) extremes
    plane, info = torch.linalg.solve_ex(E, torch.ones(m, dtype=F.dtype, device=F.device))
    nz = plane != 0
    icpt = torch.where(nz, 1.0 / torch.where(nz, plane, torch.ones_like(plane)),
                       torch.full_like(plane, float("inf")))
    fallback = torch.amax(Fs, dim=0)
    bad = (info != 0) | torch.any(icpt < 1e-10) | ~torch.all(torch.isfinite(icpt))
    icpt = torch.where(bad, fallback, icpt)
    icpt = torch.where(icpt > 1e-10, icpt, fallback + 1e-10)
    return Fs / icpt


def _device_associate(Fn, unit_refs):
    """Closest reference line (perpendicular distance) of each row."""
    proj = Fn @ unit_refs.T                                        # (Q, R)
    d2 = torch.sum(Fn ** 2, dim=1)[:, None] - proj ** 2
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    niche = torch.argmin(dist, dim=1)
    return niche, torch.gather(dist, 1, niche[:, None])[:, 0]


class SurvivalDraws(NamedTuple):
    """The random numbers of one survival, in ``device_survival``'s split
    order (k_n, k_c)."""
    niche_u: torch.Tensor   # (R,) uniform: order of the partial level's niches
    cand_u: torch.Tensor    # (Q,) uniform: order of the members within a niche


def survival_draws(gen: torch.Generator, Q: int, R: int, dtype, device) -> SurvivalDraws:
    """Draws for :func:`device_survival` from ``gen`` (on ``device``)."""
    f = dict(dtype=dtype, device=device, generator=gen)
    return SurvivalDraws(torch.rand(R, **f), torch.rand(Q, **f))


def _segment_min(values, ids, n, fill):
    """Minimum of ``values`` over each id in [0, n); ``fill`` where none."""
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, ids, values, "amin", include_self=True)


def device_survival(X_all, F_all, n_survive: int, unit_refs, draws: SurvivalDraws):
    """NSGA-III environmental selection on the device, the port of the JAX
    package's water-filling niching.

    Niche filling follows pymoo's sequential semantics (repeatedly take,
    from the splitting front, a candidate of the niche that holds the
    fewest survivors: its min-distance candidate for an empty niche, a
    random one otherwise), computed batched: serving min-count niches one
    at a time is raising a fill level T, at which niche j (count c_j, a_j
    candidates) absorbs min(a_j, max(0, T - c_j)) members. A 32-step
    binary search finds the level at which the front owes its last slot;
    the partial top level serves its niches by min distance (level 0) or at
    random; one segmented sort picks the members within each niche. Ties
    break as JAX's stable sorts do (``torch.sort(stable=True)``, twice for
    the lexicographic order). Returns (X, F, rank, niche, nd) of the
    survivors, ordered by front."""
    Q, R = F_all.shape[0], unit_refs.shape[0]
    dev = F_all.device
    rank = device_nd_ranks(F_all).long()
    niche, nd = _device_associate(_device_normalize(F_all), unit_refs)

    # splitting front L: the first rank whose cumulative count reaches the cap
    cum = torch.cumsum(torch.bincount(rank, minlength=Q), dim=0)
    L = torch.argmax((cum >= n_survive).to(torch.int32))
    n_before = torch.where(L > 0, cum[torch.clamp(L - 1, min=0)], torch.zeros_like(L))
    need = n_survive - n_before
    keep = rank < L
    cand = rank == L
    R_t = torch.full_like(niche, R)
    counts = torch.bincount(torch.where(keep, niche, R_t), minlength=R + 1)[:R]
    avail = torch.bincount(torch.where(cand, niche, R_t), minlength=R + 1)[:R]

    # the water-filling level: the least T with K(T) >= need
    def K(t):
        return torch.sum(torch.minimum(avail, torch.clamp(t - counts, min=0)))

    lo = torch.zeros((), dtype=counts.dtype, device=dev)
    hi = torch.amax(counts) + (Q + 1)
    for _ in range(32):
        mid = (lo + hi) // 2
        ge = K(mid) >= need
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    T = hi

    # full levels below T - 1, then a partial pass at level T - 1 that serves
    # only the first `rem` of the niches still holding candidates there
    k_full = torch.minimum(avail, torch.clamp((T - 1) - counts, min=0))
    rem = need - torch.sum(k_full)
    eligible = (counts <= T - 1) & (counts + avail > T - 1)

    idxs = torch.arange(Q, device=dev)
    ids = torch.where(cand, niche, R_t)                       # candidates by niche
    niche_min_nd = _segment_min(nd, ids, R + 1, float("inf"))[:R]
    part_score = torch.where(T == 1, niche_min_nd, draws.niche_u)
    score = torch.where(eligible, part_score, torch.full_like(part_score, float("inf")))
    niche_pos = torch.argsort(torch.argsort(score, stable=True), stable=True)
    k = k_full + (eligible & (niche_pos < rem)).to(k_full.dtype)

    # within-niche members: the first pick from an initially empty niche is
    # its min-distance candidate (priority -1); the rest are uniform random
    first_idx = _segment_min(torch.where(cand & (nd == niche_min_nd[niche]),
                                         idxs, torch.full_like(idxs, Q)), ids, R + 1, Q)[:R]
    is_first = cand & (idxs == first_idx[niche])
    prio = torch.where(is_first & (counts[niche] == 0),
                       torch.full_like(draws.cand_u, -1.0), draws.cand_u)
    by_prio = torch.argsort(prio, stable=True)
    order_c = by_prio[torch.argsort(ids[by_prio], stable=True)]   # ids, then prio
    ids_s = ids[order_c].contiguous()
    starts = torch.searchsorted(ids_s, torch.arange(R + 1, device=dev))
    pos_in = idxs - starts[ids_s]
    k_pad = torch.cat([k, torch.zeros(1, dtype=k.dtype, device=dev)])
    sel_s = (ids_s < R) & (pos_in < k_pad[ids_s])
    selected = torch.zeros(Q, dtype=torch.bool, device=dev)
    selected[order_c] = sel_s
    keep_all = keep | selected
    order = torch.argsort(torch.where(keep_all, rank, torch.full_like(rank, Q + 1)), stable=True)
    idx = order[:n_survive]
    return X_all[idx], F_all[idx], rank[idx], niche[idx], nd[idx]


def device_crowding(F, rank):
    """NSGA-II crowding distance on the device, fronts given by ``rank``:
    the host's :func:`~phoskintime_tpu_torch.ops.nsga.crowding_distance`
    applied to every front at once. Per objective the members are sorted by
    (rank, f_j) (two stable sorts, as ``jnp.lexsort``); boundary members of
    a front get inf, interior ones add (next - prev) / (front max - min),
    the spans by ``scatter_reduce``."""
    Q, m = F.shape
    rank = rank.long()
    crowd = torch.zeros(Q, dtype=F.dtype, device=F.device)
    inf = torch.full((), float("inf"), dtype=F.dtype, device=F.device)
    edge = torch.zeros(1, dtype=torch.bool, device=F.device)
    for j in range(m):
        fj = F[:, j]
        by_f = torch.argsort(fj, stable=True)
        order = by_f[torch.argsort(rank[by_f], stable=True)]     # rank, then f_j
        r_s, f_s = rank[order], fj[order]
        fmin = _segment_min(fj, rank, Q, float("inf"))
        fmax = torch.full((Q,), -float("inf"), dtype=F.dtype, device=F.device).scatter_reduce(
            0, rank, fj, "amax", include_self=True)
        span_s = (fmax - fmin)[r_s]
        prev_same = torch.cat([edge, r_s[1:] == r_s[:-1]])
        next_same = torch.cat([r_s[:-1] == r_s[1:], edge])
        gap = torch.roll(f_s, -1) - torch.roll(f_s, 1)
        pos = span_s > 0
        contrib = torch.where(pos, gap / torch.where(pos, span_s, torch.ones_like(span_s)),
                              torch.zeros_like(gap))
        crowd = crowd.index_add(0, order, torch.where(prev_same & next_same, contrib, inf))
    return crowd


def device_nsga2_survival(X_all, F_all, n_survive: int):
    """NSGA-II environmental selection on the device, (rank ascending,
    crowding descending): the host :func:`~phoskintime_tpu_torch.ops.nsga.nsga2_survival`'s
    semantics, deterministic; members equal in both keys keep their order.
    Returns (X, F, rank, crowd) of the survivors."""
    rank = device_nd_ranks(F_all)
    crowd = device_crowding(F_all, rank)
    by_crowd = torch.argsort(-crowd, stable=True)
    order = by_crowd[torch.argsort(rank[by_crowd], stable=True)]   # rank, then -crowd
    idx = order[:n_survive]
    return X_all[idx], F_all[idx], rank[idx], crowd[idx]


def run_nsga2_device(pop_objective, xl, xu, *, pop_size: int = 100,
                     n_gen: int = 100, seed: int = 42,
                     sbx_prob=0.9, sbx_eta=15.0, pm_eta=20.0,
                     constraint_fn=None, repair_fn=None,
                     x0: np.ndarray | None = None,
                     gens_per_block: int = 10,
                     callback=None, mesh=None, device=DEFAULT_DEVICE,
                     dtype=None) -> MOOResult:
    """NSGA-II with the whole generation loop on ``device`` (default: the
    card; raises where there is none), at ``dtype`` (default: the device's
    working dtype): the drop-in for :func:`nsga.run_nsga2` on a population
    objective (P, n) -> (P, n_obj) on the device.

    ``repair_fn`` / ``constraint_fn`` run on the device ((P, n) -> (P, n) /
    (P, n_con)); violations are penalised feasibility-first (1e6 x the
    total), as on the host. Each block of ``gens_per_block`` generations
    draws from a ``torch.Generator`` seeded from the host rng (the JAX
    package's ``PRNGKey`` a block); the host reads the block's ideal and
    mean history once. Whole blocks run, so the generation count rounds up
    to a multiple of the block, as in the JAX package. ``mesh`` is not
    ported (it raises)."""
    if mesh is not None:
        raise NotImplementedError("population sharding (mesh=...) is not ported yet "
                                  "(ROADMAP.md queue 1 item 1b, 'Population sharding')")
    device = resolve_device(device)
    dtype = dtype or working_dtype(device)
    f = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    xl = np.asarray(xl, float)
    xu = np.asarray(xu, float)
    n_var = len(xl)
    bl, bu = torch.as_tensor(xl, **f), torch.as_tensor(xu, **f)

    def eval_all(Xb):
        F = pop_objective(Xb)
        if constraint_fn is not None:
            G = constraint_fn(Xb)
            F = F + 1e6 * torch.clamp(G, min=0.0).sum(dim=1)[:, None]
        return F

    @torch.no_grad()
    def block(X, F, rank, crowd, gen):
        ideals, means = [], []
        for _ in range(gens_per_block):
            off = variation(X, rank, -crowd, variation_draws(gen, pop_size, n_var, dtype, device),
                            bl, bu, sbx_prob=sbx_prob, sbx_eta=sbx_eta, pm_eta=pm_eta)
            if repair_fn is not None:
                off = repair_fn(off)
            X, F, rank, crowd = device_nsga2_survival(
                torch.cat([X, off]), torch.cat([F, eval_all(off)]), pop_size)
            ideals.append(torch.amin(F, dim=0))
            means.append(torch.mean(F, dim=0))
        return X, F, rank, crowd, torch.stack(ideals), torch.stack(means)

    X0 = lhs_sampling(pop_size, xl, xu, rng) if x0 is None else np.array(x0)
    with torch.no_grad():
        X0 = torch.as_tensor(X0, **f)
        if repair_fn is not None:
            X0 = repair_fn(X0)
        carry = device_nsga2_survival(X0, eval_all(X0), pop_size)
    n_evals = pop_size
    history: list = []
    gen = 0
    while gen < n_gen:
        gen_t = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 31 - 1)))
        *carry, ideals, means = block(*carry, gen_t)
        ideals, means = _host(ideals), _host(means)          # the block's one read
        for g in range(gens_per_block):
            gen += 1
            n_evals += pop_size
            history.append((gen, ideals[g].copy(), means[g].copy()))
        if callback is not None:
            callback(gen, _host(carry[0]), _host(carry[1]))

    X, F = _host(carry[0]), _host(carry[1])
    pf = fast_non_dominated_sort(F)[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)


# ---------------------------------------------------------------------------
# the block loop
# ---------------------------------------------------------------------------


def make_device_ga_blocks(pop_objective, n_var: int, pop_size: int, *, dtype, device,
                          n_obj: int = 3, n_partitions: int = 20, sbx_prob=0.9,
                          sbx_eta=15.0, pm_eta=10.0, gens_per_block: int = 10):
    """(init_fn, block_fn, dtype) of the all-device GA at ``dtype`` on
    ``device`` (the system's).

    init_fn(X0) -> carry (X, F, rank, niche, nd): evaluates the initial
    population and ranks it on the device (survival over the population
    itself keeps everyone).
    block_fn(*carry, gen, bl, bu) -> (*carry, ideals, means): a Python loop
    of ``gens_per_block`` whole generations, its draws from the
    ``torch.Generator`` ``gen``; ideals and means are the (gens_per_block,
    n_obj) history, still on the device. The bounds are arguments, so
    refinement rounds with zoomed boxes reuse the same functions."""
    refs = das_dennis(n_obj, n_partitions)
    unit = torch.as_tensor(refs / np.linalg.norm(refs, axis=1, keepdims=True),
                           dtype=dtype, device=device)
    R = unit.shape[0]

    @torch.no_grad()
    def block(X, F, rank, niche, nd, gen, bl, bu):
        ideals, means = [], []
        for _ in range(gens_per_block):
            off = variation(X, rank, nd, variation_draws(gen, pop_size, n_var, dtype, device),
                            bl, bu, sbx_prob=sbx_prob, sbx_eta=sbx_eta, pm_eta=pm_eta)
            F_off = pop_objective(off)
            X, F, rank, niche, nd = device_survival(
                torch.cat([X, off]), torch.cat([F, F_off]), pop_size, unit,
                survival_draws(gen, 2 * pop_size, R, dtype, device))
            ideals.append(torch.amin(F, dim=0))
            means.append(torch.mean(F, dim=0))
        return X, F, rank, niche, nd, torch.stack(ideals), torch.stack(means)

    @torch.no_grad()
    def init(X0):
        X0 = torch.as_tensor(np.asarray(X0), dtype=dtype, device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        return device_survival(X0, pop_objective(X0), pop_size, unit,
                               survival_draws(gen, pop_size, R, dtype, device))

    return init, block, dtype


def _host(x) -> np.ndarray:
    return x.to("cpu", torch.float64).numpy()


def run_unsga3_device(pop_objective, xl, xu, *, pop_size: int = 300,
                      n_gen: int = 100, n_obj: int = 3,
                      n_partitions: int = 20, seed: int = 42,
                      sbx_prob=0.9, sbx_eta=15.0, pm_eta=10.0,
                      ftol: float = 0.0025, ftol_period: int = 30,
                      n_max_evals: int | None = 100_000,
                      x0: np.ndarray | None = None,
                      gens_per_block: int = 10,
                      callback=None, logger=None, prebuilt=None,
                      device=DEFAULT_DEVICE, dtype=None,
                      checkpoint=None) -> MOOResult:
    """U-NSGA-III with the whole generation loop on ``device`` (default:
    the card; raises where there is none), at ``dtype`` (default: the
    device's working dtype).

    The same operators and survival as :func:`nsga.run_unsga3`; the host
    touches only the per-generation ideal and mean history between blocks
    of ``gens_per_block`` generations, so the ftol window, the
    ``n_max_evals`` cap and the callback act at block granularity (the
    callback sees the population only when it fires). One
    ``torch.Generator`` on the device, seeded from the host rng, draws for
    the whole run.

    prebuilt: (init_fn, block_fn, dtype) from :func:`make_device_ga_blocks`,
    to reuse across calls (refinement rounds with zoomed bounds).
    checkpoint: a ``GACheckpointer``; it stores the whole loop state, the
    generator's state included, at block ends whose generation is a
    multiple of its ``every``, and a run given one that holds a state
    continues from it to ``n_gen``.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    xl = np.asarray(xl, float)
    xu = np.asarray(xu, float)
    if prebuilt is None:
        prebuilt = make_device_ga_blocks(
            pop_objective, len(xl), pop_size, dtype=dtype or working_dtype(device),
            device=device, n_obj=n_obj, n_partitions=n_partitions, sbx_prob=sbx_prob,
            sbx_eta=sbx_eta, pm_eta=pm_eta, gens_per_block=gens_per_block)
    init_fn, block_fn, dtype = prebuilt
    f = dict(dtype=dtype, device=device)
    bl, bu = torch.as_tensor(xl, **f), torch.as_tensor(xu, **f)

    state = None if checkpoint is None else checkpoint.resume_state()
    gen_t = torch.Generator(device=device)
    if state is None:
        X0 = lhs_sampling(pop_size, xl, xu, rng) if x0 is None else np.array(x0)
        if x0 is not None and len(X0) < pop_size:
            X0 = np.vstack([X0, lhs_sampling(pop_size - len(X0), xl, xu, rng)])
        gen_t.manual_seed(int(rng.integers(2 ** 31 - 1)))
        carry = init_fn(X0)
        n_evals = pop_size
        history: list = []
        ideal_history = [_host(torch.amin(carry[1], dim=0))]
        gen = 0
    else:
        X, F, nd = (torch.as_tensor(state[k], **f) for k in ("X", "F", "nd"))
        rank, niche = (torch.as_tensor(state[k], device=device) for k in ("rank", "niche"))
        carry = (X, F, rank, niche, nd)
        rng.bit_generator.state = state["rng"]
        gen_t.set_state(torch.from_numpy(np.asarray(state["torch_generator"], np.uint8)))
        history, ideal_history = list(state["history"]), list(state["ideal_history"])
        n_evals, gen = state["n_evals"], state["gen"]

    stop = False
    while gen < n_gen and not stop:
        *carry, ideals, means = block_fn(*carry, gen_t, bl, bu)
        ideals, means = _host(ideals), _host(means)          # the block's one read
        for g in range(gens_per_block):
            gen += 1
            n_evals += pop_size
            history.append((gen, ideals[g].copy(), means[g].copy()))
            ideal_history.append(ideals[g])
        X, F = carry[0], carry[1]
        if checkpoint is not None and gen % checkpoint.every == 0:
            rank, niche, nd = (x.cpu().numpy() for x in carry[2:])
            checkpoint(gen, _host(X), _host(F), loop={
                "X": _host(X), "F": _host(F), "rank": rank, "niche": niche, "nd": nd,
                "rng": rng.bit_generator.state, "torch_generator": gen_t.get_state().numpy(),
                "history": history, "ideal_history": ideal_history, "n_evals": n_evals,
                "gen": gen})
        if callback is not None and callback(gen, _host(X), _host(F)):
            stop = True
        if logger is not None:
            logger.info(f"[UNSGA3/device] gen {gen}: ideal={ideals[-1]}")
        # the host loop's window, on the exact per-generation ideal history
        # (block granularity bounds only how late the loop can stop)
        if _ideal_stop(ideal_history, ftol, ftol_period):
            stop = True
        if n_max_evals is not None and n_evals >= n_max_evals:
            stop = True

    X, F = _host(carry[0]), _host(carry[1])
    pf = fast_non_dominated_sort(F)[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)
