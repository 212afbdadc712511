"""Exponential (ETD2RK) integrator for the global network model, batched
over a population.

Counterpart of ``phoskintime_tpu/network/expo.py``:
:func:`exponential_simulate_batched` (the population path) and
:func:`exponential_simulate` (the per-candidate path of ``solver="expo"``,
with a leading population axis). For the affine mechanisms 0, 1 and 2,
within one kinase bucket the RHS splits as dy = L y + g(y): L is
block-diagonal per protein (width w = 2 + Smax, or 1 + 2^Smax for the
combinatorial mechanism) and g is the synthesis drive in the R slot, the
only coupling between proteins. Each segment of the static plan takes the
exponential trapezoidal step (Cox & Matthews 2002)

    a   = E y + p1 g(y)
    y+  = a + (p2 / h) (g(a) - g(y))

with E = expm(L h), p1 = h phi1(L h) e0, p2 = h^2 phi2(L h) e0 built once
per (bucket, h) pair by :func:`~phoskintime_tpu_torch.ops.phi_tables.phi_tables`.

Every mechanism's blocks are written out as lane planes
(:func:`_linear_blocks_lanes` for models 0/1, :func:`_block_linear_operators`
for model 2, where the JAX package differentiates its RHS instead). Model 2
runs width-bucketed by
default: proteins with s sites keep blocks of width 1 + 2^s, grouped into
width classes, each with its own tables and its own slice of the state
(:func:`width_classes`).

Layout: the state is (w, P*N) — slot planes with member-major lanes — so
the tables, the state and the synthesis drive all keep the lane axis last.

The unbucketed scan runs eagerly (:func:`_full_scan`, one launch per
operation) or, with ``use_scan_kernel=True``, as one kernel
(:func:`~phoskintime_tpu_torch.ops.scan_kernel.etd2rk_scan`).

The saturating mechanism (4) has a state-dependent linear part, so no
static table exists: it integrates by the exponential-Rosenbrock variant
of the same step (:func:`_rosenbrock_simulate_batched`), the block
Jacobian refreshed and the full E, Phi1, Phi2 matrices built
(:func:`_phi_matrices_lanes`, plain PyTorch, as XLA builds them in the
JAX package) at the entry of every chunk of equal-(h, bucket) segments
(:func:`_chunk_plan`).
"""

from __future__ import annotations

from functools import cached_property, lru_cache

import numpy as np
import torch

from phoskintime_tpu_torch.network.rhs import synthesis_rate
from phoskintime_tpu_torch.ops.integrators import ODEResult
from phoskintime_tpu_torch.ops.phi_tables import (_MAX_SQUARINGS, _mm_lanes, ladder_len,
                                                  phi_tables)
from phoskintime_tpu_torch.ops.scan_kernel import etd2rk_scan, prepare_scan_plan


@lru_cache(maxsize=None)
def _segment_plan(kin_grid: tuple, t_eval: tuple, substep: float,
                  early_t: float = 64.0, early_div: int = 4,
                  very_early_t: float = 4.0, very_early_div: int = 8):
    """Static plan: segments (t0, h, bucket) covering [0, t_end], with every
    t_eval point on a segment boundary. Intervals before ``early_t`` are
    subdivided ``early_div``-fold and before ``very_early_t``
    ``very_early_div``-fold, where the synthesis drive moves fastest.

    Returns (seg_t0, seg_h, seg_jb, out_idx, seg_uidx, u_jb, u_h): out_idx
    maps each t_eval point to the segment ending there (-1: the initial
    state); seg_uidx maps each segment to its unique (bucket, h) pair."""
    grid = np.asarray(kin_grid, float)
    te = np.asarray(t_eval, float)
    t_end = te[-1]
    knots = np.unique(np.concatenate([[0.0], te, grid[(grid > 0) & (grid < t_end)]]))
    knots = knots[(knots >= 0.0) & (knots <= t_end)]

    seg_t0, seg_h, seg_jb = [], [], []
    for a, b in zip(knots[:-1], knots[1:]):
        n_sub = max(1, int(np.ceil((b - a) / substep)))
        if a < very_early_t:
            n_sub *= very_early_div
        elif a < early_t:
            n_sub *= early_div
        hs = (b - a) / n_sub
        for k in range(n_sub):
            t0 = a + k * hs
            jb = int(np.clip(np.searchsorted(grid, t0, side="right") - 1, 0,
                             len(grid) - 1))
            seg_t0.append(t0)
            seg_h.append(hs)
            seg_jb.append(jb)
    seg_t0 = np.asarray(seg_t0)
    seg_h = np.asarray(seg_h)
    seg_jb = np.asarray(seg_jb, np.int32)
    seg_end = seg_t0 + seg_h

    out_idx = np.asarray([-1 if t <= 0.0 else int(np.argmin(np.abs(seg_end - t)))
                          for t in te], np.int64)

    # one table per unique (bucket, h) pair; h rounded so that equal
    # substeps computed from different knots share a pair
    pairs = np.stack([seg_jb.astype(float), np.round(seg_h, 9)], axis=1)
    uniq, uidx = np.unique(pairs, axis=0, return_inverse=True)
    u_jb = uniq[:, 0].astype(np.int32)
    u_h = uniq[:, 1]
    return (seg_t0, seg_h, seg_jb, out_idx, uidx.astype(np.int32), u_jb, u_h)


def _run_plan(seg_uidx, out_idx):
    """Runs of consecutive segments sharing one (bucket, h) pair, split so
    that every t_eval segment ends a run.

    Returns (runs [(start, n)], out_pos (T,) int64) with out_pos[k] the
    index into [y0] + [run-end states] for t_eval[k]."""
    S = len(seg_uidx)
    out_set = {int(i) for i in np.asarray(out_idx) if i >= 0}
    runs = []
    i = 0
    while i < S:
        j = i + 1
        while j < S and seg_uidx[j] == seg_uidx[i] and (j - 1) not in out_set:
            j += 1
        runs.append((i, j - i))
        i = j
    end_to_run = {start + n - 1: r for r, (start, n) in enumerate(runs)}
    out_pos = np.asarray([0 if o < 0 else end_to_run[int(o)] + 1
                          for o in np.asarray(out_idx)], np.int64)
    return runs, out_pos


def _linear_blocks_lanes(system, params_b: dict, buckets: np.ndarray):
    """(Bu, w, w, P*N) linear blocks of mechanisms 0/1, one slab per bucket,
    assembled as w*w lane planes: every entry is elementwise in parameter
    lanes except the site rates, Smax (Bu, P, K) @ (K, N) products that
    land already in lane order."""
    rhs = system.rhs
    N, w, Smax = rhs.N, rhs.width, rhs.Smax
    P = params_b["c_k"].shape[0]
    Bu = len(buckets)
    lanes = P * N
    bk = torch.as_tensor(np.asarray(buckets, np.int64), device=rhs.Kmat.device)
    Kt = params_b["c_k"][None] * rhs.Kmat[:, bk].T[:, None, :]   # (Bu, P, K)
    msk = rhs.site_mask                                          # (N, Smax)

    def lane(x):                                    # (P, N) -> (1, P*N)
        return x.reshape(1, lanes)

    Sm = [torch.einsum("bpk,nk->bpn", Kt, rhs.W_pad[:, j, :] * msk[:, j:j + 1])
          .reshape(Bu, lanes) for j in range(Smax)]
    B_l, C_l, D_l, E_l = (lane(params_b[k]) for k in ("B_i", "C_i", "D_i", "E_i"))
    msk_l = [lane(msk[None, :, j].expand(P, N)) for j in range(Smax)]
    Dp_l = [lane(params_b["Dp_i"][:, :, j]) for j in range(Smax)]
    zero = Kt.new_zeros((Bu, lanes))
    bc = lambda x: x.expand(Bu, lanes)

    rows = [[zero] * w for _ in range(w)]
    rows[0][0] = bc(-B_l)
    rows[1][0] = bc(C_l)
    if rhs.model == 0:
        rows[1][1] = bc(-D_l) - sum(Sm)
        for j in range(Smax):
            rows[1][2 + j] = bc(E_l * msk_l[j])
            rows[2 + j][1] = Sm[j]
            rows[2 + j][2 + j] = bc(-(E_l + Dp_l[j] + D_l) * msk_l[j])
    else:                                           # model 1, the chain
        has_next = msk_l[1:] + [torch.zeros_like(msk_l[0])]
        k_next = Sm[1:] + [zero]
        rows[1][1] = bc(-D_l) - Sm[0] * bc(msk_l[0])
        if w > 2:
            rows[1][2] = bc(E_l * msk_l[0])
        rows[2][1] = Sm[0] * bc(msk_l[0])
        for j in range(1, Smax):
            rows[2 + j][1 + j] = Sm[j] * bc(msk_l[j])
        for j in range(Smax):
            if j + 1 < Smax:
                rows[2 + j][3 + j] = bc(E_l * has_next[j] * msk_l[j])
            rows[2 + j][2 + j] = -(k_next[j] * bc(has_next[j]) + bc(E_l)
                                   + bc(Dp_l[j]) + bc(D_l)) * bc(msk_l[j])
    return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)


def _block_linear_operators_class(system, params_b: dict, buckets: np.ndarray,
                                  idx: np.ndarray, wc: int):
    """(Bu, wc, wc, P*Nc) model-2 linear blocks of the proteins ``idx`` at
    width ``wc``, one slab per bucket, lanes member-major.

    The JAX package recovers these blocks with one ``jax.jvp`` of the RHS
    per column, the TF input frozen. The RHS is affine in the state, so
    the port writes the same entries out as wc*wc lane planes, each an
    elementwise function of parameter lanes and the Smax site rates
    (Bu, P, K) @ (K, Nc), as :func:`_linear_blocks_lanes` does for models
    0/1; on the card the derivative route (a vmapped ``torch.func.jvp``)
    took most of the objective's time (PERF.md). Slots are
    [R, X_0 .. X_{wc-2}], X_m the state whose set bits are the
    phosphorylated sites:

      dR/dR = -B;  dX_0/dR = C (translation);
      dX_m/dX_m = -(sum_j v_j (E if bit j of m else S_j)) - decay_m;
      dX_m/dX_{m^2^j} = v_j (S_j if bit j of m else E),

    with v_j the site mask, decay_0 = D and decay_m the sum of Dp_j + D
    over the set bits of m, and every row and column masked by the
    protein's valid states. ``tests/test_torch_model2.py`` holds them
    against the JAX package's jvp blocks and the port's own RHS."""
    rhs = system.rhs
    Smax = rhs.Smax
    dev = rhs.Kmat.device
    idx_t = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
    P = params_b["c_k"].shape[0]
    Bu, lanes = len(buckets), P * len(idx_t)
    bk = torch.as_tensor(np.asarray(buckets, np.int64), device=dev)
    Kt = params_b["c_k"][None] * rhs.Kmat[:, bk].T[:, None, :]   # (Bu, P, K)
    msk = rhs.site_mask[idx_t]                                   # (Nc, Smax)
    stm = rhs.state_mask[idx_t]                                  # (Nc, Mmax)

    def lane(x):                                    # (P, Nc) -> (1, P*Nc)
        return x.reshape(1, lanes)

    def bc(x):
        return x.expand(Bu, lanes)

    S = [torch.einsum("bpk,nk->bpn", Kt, rhs.W_pad[idx_t, j, :]).reshape(Bu, lanes)
         for j in range(Smax)]
    B_l, C_l, D_l, E_l = (lane(params_b[k][:, idx_t]) for k in ("B_i", "C_i", "D_i", "E_i"))
    Dp_l = [lane(params_b["Dp_i"][:, idx_t, j]) for j in range(Smax)]
    v_l = [lane(msk[None, :, j].expand(P, -1)) for j in range(Smax)]
    st_l = [lane(stm[None, :, m].expand(P, -1)) for m in range(wc - 1)]
    zero = Kt.new_zeros((Bu, lanes))

    rows = [[zero] * wc for _ in range(wc)]
    rows[0][0] = bc(-B_l)
    if wc > 1:
        rows[1][0] = bc(C_l * st_l[0])
    for m in range(wc - 1):
        set_bits = [j for j in range(Smax) if (m >> j) & 1]
        out = sum(v_l[j] * (E_l if j in set_bits else S[j]) for j in range(Smax))
        decay = D_l if m == 0 else sum((Dp_l[j] + D_l) * v_l[j] for j in set_bits)
        rows[1 + m][1 + m] = bc((-out - decay) * st_l[m] * st_l[m])
        for j in range(Smax):
            m2 = m ^ (1 << j)
            if m2 < wc - 1:
                rate = S[j] if j in set_bits else E_l
                rows[1 + m][1 + m2] = bc(v_l[j] * rate * st_l[m] * st_l[m2])
    return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)


def _block_linear_operators(system, params_b: dict, buckets: np.ndarray):
    """(Bu, w, w, P*N) model-2 linear blocks of every protein at the full
    width, written out as :func:`_block_linear_operators_class` does."""
    rhs = system.rhs
    return _block_linear_operators_class(system, params_b, buckets,
                                         np.arange(rhs.N), rhs.width)


def width_classes(topo, width_bucketing: bool | None = None) -> list:
    """Width classes of the combinatorial mechanism: [(wc, protein idx)].

    ``width_bucketing`` None is the auto rule (model 2 at w >= 9); False
    keeps the single full-width path (an empty list); True lifts the auto
    threshold. Models 0/1 never bucket. Protein widths 1 + 2^s are merged
    greedily in ascending order until a group holds at least 5% of the
    proteins; a group runs at its largest width, which is exact for its
    narrower members (their padded rows and columns are zero)."""
    if width_bucketing is None:
        width_bucketing = topo.model == 2 and topo.width >= 9
    if not (width_bucketing and topo.model == 2):
        return []
    ws_prot = 1 + 2 ** np.asarray(topo.n_sites)
    uniq_ws = sorted({int(v) for v in ws_prot})
    classes: list = []
    if len(uniq_ws) > 1:
        acc: list = []
        for wc in uniq_ws:
            acc.append(np.where(ws_prot == wc)[0])
            if sum(len(a) for a in acc) / topo.N >= 0.05 or wc == uniq_ws[-1]:
                classes.append((wc, np.concatenate(acc)))
                acc = []
    return classes if len(classes) > 1 else []


def _plan(system, t_eval, substep: float):
    return _segment_plan(tuple(np.asarray(system.kin_grid, float)),
                         tuple(np.asarray(t_eval, float)), float(substep))


def table_inputs(system, params_b: dict, t_eval, substep: float = 16.0,
                 width_bucketing: bool | None = None) -> list:
    """The arguments the main path hands to :func:`phi_tables`, one tuple
    per width class (a single one unless model 2 runs width-bucketed):
    [(L (Bu, wc, wc, P*Nc), binv (U,) int32, u_h (U,), ladder)]."""
    u_jb, u_h = _plan(system, t_eval, substep)[5:]
    bucket_uniq, bucket_inv = np.unique(u_jb, return_inverse=True)
    binv = bucket_inv.astype(np.int32)
    classes = width_classes(system.topo, width_bucketing)
    if classes:
        blocks = [(_block_linear_operators_class(system, params_b, bucket_uniq,
                                                 idx, wc), wc)
                  for wc, idx in classes]
    elif system.topo.model == 2:
        blocks = [(_block_linear_operators(system, params_b, bucket_uniq),
                   system.topo.width)]
    else:
        blocks = [(_linear_blocks_lanes(system, params_b, bucket_uniq),
                   system.topo.width)]
    return [(L, binv, u_h, max(ladder_len(wc, float(h)) for h in u_h))
            for L, wc in blocks]


def _lanes_mv(M, v):
    """(w, w, B) x (w, B) -> (w, B), the lane-batched matvec."""
    return torch.sum(M * v[None], dim=1)


def _setup(system, params_b: dict, y0):
    """Parameters as tensors and y0 as (N, w), at the system's dtype and
    device."""
    rhs = system.rhs
    f = dict(dtype=rhs.Kmat.dtype, device=rhs.Kmat.device)
    params_b = {k: torch.as_tensor(v, **f) for k, v in params_b.items()}
    if y0 is None:
        y0 = system.y0()
    y0 = torch.as_tensor(np.asarray(y0, float).reshape(rhs.N, rhs.width), **f)
    return params_b, y0


def _drive_fn(rhs, params_b: dict):
    """drive_at(jb): the (P, N) live kinase drive of bucket ``jb`` (clipped
    to the grid) for driven proteins."""
    n_buckets = rhs.Kmat.shape[1]

    def drive_at(jb):
        jb = min(max(int(jb), 0), n_buckets - 1)
        return (rhs.Kmat[:, jb][None, :] * params_b["c_k"])[:, rhs.driver_idx]

    return drive_at


class ScanSetup:
    """The scan of one :func:`exponential_simulate_batched` call, assembled
    once: the parameters and y0 at the system's dtype and device, the
    static segment plan, the width classes and their tables
    (:func:`phi_tables`, ``use_kernel`` routing it; ``differentiable``: the
    plain version with its static ladder, asked for by name). Both routes
    read these same inputs and return ys (P, T, N*w):

    * :meth:`run_eager` — the run-structured scan (:func:`_class_scan` where
      model 2 runs width-bucketed, else :func:`_full_scan`);
    * :meth:`run_kernel` — the unbucketed scan as one :func:`etd2rk_scan`
      on :meth:`kernel_args` and :attr:`plan`.
    """

    def __init__(self, system, params_b: dict, t_eval, substep: float = 16.0,
                 y0=None, use_kernel: bool | None = None,
                 width_bucketing: bool | None = None, differentiable: bool = False):
        self.system = system
        self.params_b, self.y0 = _setup(system, params_b, y0)
        (_, self.seg_h, self.seg_jb, self.out_idx, self.seg_uidx, _,
         self.u_h) = _plan(system, t_eval, substep)
        self.classes = width_classes(system.topo, width_bucketing)
        route = (dict(use_kernel=False, static_ladder=True) if differentiable
                 else dict(use_kernel=use_kernel))
        self.tables = [phi_tables(*args, **route) for args in
                       table_inputs(system, self.params_b, t_eval, substep,
                                    width_bucketing)]

    def run_eager(self):
        runs, out_pos = _run_plan(self.seg_uidx, self.out_idx)
        rest = (runs, out_pos, self.seg_uidx, self.seg_jb, self.seg_h,
                _drive_fn(self.system.rhs, self.params_b))
        if self.classes:
            return _class_scan(self.system, self.params_b, self.y0, self.classes,
                               self.tables, *rest)
        return _full_scan(self.system, self.params_b, self.y0, self.tables[0], *rest)

    @cached_property
    def plan(self):
        """:func:`prepare_scan_plan` of the unbucketed path."""
        if self.classes:
            raise ValueError("the scan kernel runs the unbucketed path only")
        return prepare_scan_plan(self.system.rhs, self.seg_jb, self.seg_uidx, self.u_h,
                                 self.out_idx, len(self.out_idx))

    def kernel_args(self) -> tuple:
        """The arguments of :func:`etd2rk_scan` but its plan: (E, p1, p2h,
        y0 (w, P*N), drv (NB, P*N), A, ts).

        The 1/h of the correction term is folded into p2 per pair, with the
        h of the pair's first segment (the eager scan takes the h of each
        run's first segment; a pair's segments share h up to rounding).
        ``drv`` holds the live kinase drive of every lane in every bucket,
        read by the kernel for driven proteins only."""
        rhs, plan, params_b = self.system.rhs, self.plan, self.params_b
        N, w = rhs.N, rhs.width
        P = params_b["c_k"].shape[0]
        lanes = P * N
        E_u, P1_u, P2_u = self.tables[0]
        first = np.unique(plan.uidx, return_index=True)[1]
        inv_h = torch.as_tensor(1.0 / np.asarray(self.seg_h, float)[first],
                                dtype=P2_u.dtype, device=P2_u.device)
        p2h = P2_u * inv_h[:, None, None]
        didx = torch.as_tensor(plan.driver_idx, device=rhs.Kmat.device)
        drv = (params_b["c_k"][:, :, None] * rhs.Kmat[None])[:, didx, :]
        drv = drv.permute(2, 0, 1).reshape(-1, lanes).contiguous()     # (NB, P*N)
        A = params_b["A_i"].reshape(lanes).contiguous()
        ts = params_b["tf_scale"][:, None].expand(P, N).reshape(lanes).contiguous()
        yl = self.y0.reshape(1, N, w).expand(P, N, w).reshape(lanes, w).T.contiguous()
        return E_u, P1_u, p2h, yl, drv, A, ts

    def run_kernel(self, use_kernel: bool | None = None):
        """The counterpart of the JAX package's ``_run_scan_megakernel``."""
        rhs, plan = self.system.rhs, self.plan
        P = self.params_b["c_k"].shape[0]
        ys = etd2rk_scan(*self.kernel_args(), plan, use_kernel=use_kernel)
        return (ys.reshape(plan.T, rhs.width, P, rhs.N).permute(2, 0, 3, 1)
                .reshape(P, plan.T, rhs.N * rhs.width))


def exponential_simulate_batched(system, params_b: dict, t_eval,
                                 substep: float = 16.0, y0=None,
                                 use_kernel: bool | None = None,
                                 differentiable: bool = False,
                                 width_bucketing: bool | None = None,
                                 use_scan_kernel: bool | None = None):
    """Batched ETD2RK over a population: ``params_b`` leaves carry a leading
    axis P. Returns (ys (P, T, N*w), success (P,)) on the system's device.

    ``use_kernel`` goes to :func:`phi_tables` and :func:`etd2rk_scan` (None:
    the CUDA kernels on a CUDA system, the plain versions on the CPU;
    False: the plain versions). ``width_bucketing`` picks the model-2 layout
    (see :func:`width_classes`). ``use_scan_kernel``: None (the default, as
    in the JAX package) or False runs the eager scan; True runs the whole
    unbucketed scan as one :func:`etd2rk_scan`. The width-bucketed model-2
    path ignores it.

    Model 4 takes the exponential-Rosenbrock path
    (:func:`_rosenbrock_simulate_batched`) before any table or layout
    choice, so ``use_kernel``, ``width_bucketing`` and ``use_scan_kernel``
    do not apply to it, as in the JAX package.

    ``differentiable=True``: a route that ``torch.autograd`` and
    ``torch.func`` can differentiate, on the CPU and on the card alike, as
    the JAX package's: the tables by the plain version with its static
    ladder and the eager scan (the kernels carry no derivative, so
    ``use_kernel=True`` and ``use_scan_kernel=True`` raise), and for
    model 4 the static masked ladder of its phi builds. No host read
    depends on the parameters.
    """
    if differentiable and (use_kernel or use_scan_kernel):
        raise ValueError("differentiable=True takes the plain tables and the eager scan; "
                         "the kernels carry no derivative (use_kernel=True or "
                         "use_scan_kernel=True)")
    if system.topo.model == 4:
        params_b, y0 = _setup(system, params_b, y0)
        P, d = params_b["c_k"].shape[0], y0.numel()
        seg_t0, seg_h, seg_jb, out_idx = _plan(system, t_eval, substep)[:4]
        return _rosenbrock_simulate_batched(system, params_b, y0.reshape(1, d).expand(P, d),
                                            seg_t0, seg_h, seg_jb, out_idx, differentiable)
    scan = ScanSetup(system, params_b, t_eval, substep, y0, use_kernel, width_bucketing,
                     differentiable)
    if use_scan_kernel and not scan.classes:
        ys = scan.run_kernel(use_kernel)
    else:
        ys = scan.run_eager()
    success = torch.isfinite(ys).all(dim=2).all(dim=1)
    return ys, success


def _full_scan(system, params_b, y0, table, runs, out_pos, seg_uidx, seg_jb,
               seg_h, drive_at):
    """The run-structured scan at the full width: every protein in one
    (w, P*N) state."""
    rhs = system.rhs
    N, w = rhs.N, rhs.width
    P = params_b["c_k"].shape[0]
    lanes = P * N
    E_u, P1_u, P2_u = table

    # synthesis drive g(y) in the R slot: total protein per lane, replaced
    # by the live kinase activity for kinase-driven proteins, then the TF
    # matvec and the rational rate
    if rhs.model == 2:
        stm_lane = rhs.state_mask.T.repeat(1, P)             # (Mmax, P*N)
    else:
        msk_lane = rhs.site_mask.T.repeat(1, P)              # (Smax, P*N)
    driven = rhs.driven.repeat(P)
    A_b = params_b["A_i"]                                    # (P, N)
    ts_b = params_b["tf_scale"][:, None]                     # (P, 1)
    tf_T = rhs.tf_mat.T

    def synth_of(yl, drive):
        if rhs.model == 2:
            tot = torch.sum(yl[1:] * stm_lane, dim=0)
        else:
            tot = yl[1] + torch.sum(yl[2:] * msk_lane, dim=0)
        Pv = torch.where(driven, drive, tot)
        v = (Pv.reshape(P, N) @ tf_T) / rhs.tf_deg
        u = v / (1.0 + torch.abs(v))
        return synthesis_rate(A_b, ts_b, u).reshape(lanes)

    # runs of equal (bucket, h): the table row, the bucket's kinase drive
    # and 1/h are fixed for the whole run; only run ends are kept
    yl = y0.reshape(1, N, w).expand(P, N, w).reshape(lanes, w).T.contiguous()
    states = [yl]
    for start, n in runs:
        uidx = int(seg_uidx[start])
        Es, P1 = E_u[uidx], P1_u[uidx]
        P2h = P2_u[uidx] * (1.0 / float(seg_h[start]))
        drive = drive_at(seg_jb[start]).reshape(lanes)
        for _ in range(n):
            s_n = synth_of(yl, drive)
            a = _lanes_mv(Es, yl) + P1 * s_n
            s_a = synth_of(a, drive)
            yl = a + P2h * (s_a - s_n)
        states.append(yl)
    # selected on the host, so the scan issues no copy and can be captured
    # in a CUDA graph
    sel = torch.stack([states[int(k)] for k in out_pos])        # (T, w, PN)
    T = len(out_pos)
    return sel.reshape(T, w, P, N).permute(2, 0, 3, 1).reshape(P, T, N * w)


def _class_scan(system, params_b, y0, classes, tables, runs, out_pos, seg_uidx,
                seg_jb, seg_h, drive_at):
    """The run-structured scan over width classes (model 2).

    Proteins are permuted once so that each class is a contiguous range;
    each class keeps its own (wc, P*Nc) state and its own tables, and the
    synthesis drive runs on the permuted topology, so no step gathers
    lanes. The padded full-width trajectory is assembled once at the end.
    """
    rhs = system.rhs
    N, w = rhs.N, rhs.width
    P = params_b["c_k"].shape[0]
    dev = y0.device
    prot_perm = np.concatenate([idx for _, idx in classes])
    pp = torch.as_tensor(prot_perm, device=dev)
    poffs = np.cumsum([0] + [len(idx) for _, idx in classes])
    spans = [(int(poffs[ci]), len(idx), wc) for ci, (wc, idx) in enumerate(classes)]

    tfm_T = rhs.tf_mat[pp][:, pp].T
    tfd_p = rhs.tf_deg[pp]
    driven_p = rhs.driven[pp]
    inv = pp.new_tensor(np.argsort(prot_perm))        # permuted -> original
    stm_p = rhs.state_mask[pp]                          # (N, Mmax), permuted
    A_p = params_b["A_i"][:, pp]                        # (P, N)
    ts_b = params_b["tf_scale"][:, None]                # (P, 1)
    # per-class valid-state planes, tiled member-major: (wc - 1, P*nc)
    stm_lane = [stm_p[off:off + nc, :wc - 1].T.repeat(1, P) for off, nc, wc in spans]

    def synth_perm(yls, drive_p):
        """(P, N) synthesis drive, permuted order, from the class states."""
        tot = torch.cat([torch.sum(yc[1:] * sm, dim=0).reshape(P, nc)
                         for yc, sm, (_, nc, _) in zip(yls, stm_lane, spans)], dim=1)
        Pv = torch.where(driven_p[None, :], drive_p, tot)
        v = (Pv @ tfm_T) / tfd_p[None, :]
        u = v / (1.0 + torch.abs(v))
        return synthesis_rate(A_p, ts_b, u)

    def class_part(x, off, nc):                          # (P, N) -> (P*nc,)
        return x[:, off:off + nc].reshape(P * nc)

    Y0p = y0[pp]                                         # (N, w), permuted
    yls = [Y0p[off:off + nc, :wc].T.repeat(1, P).contiguous() for off, nc, wc in spans]
    states = [yls]
    for start, n in runs:
        uidx = int(seg_uidx[start])
        h = float(seg_h[start])
        rows = [(Ec[uidx], P1c[uidx], P2c[uidx] / h) for Ec, P1c, P2c in tables]
        drive_p = drive_at(seg_jb[start])[:, pp]
        for _ in range(n):
            s_n = synth_perm(yls, drive_p)
            a = [_lanes_mv(Es, yc) + P1 * class_part(s_n, off, nc)
                 for yc, (Es, P1, _), (off, nc, _) in zip(yls, rows, spans)]
            d = synth_perm(a, drive_p) - s_n
            yls = [ac + P2h * class_part(d, off, nc)
                   for ac, (_, _, P2h), (off, nc, _) in zip(a, rows, spans)]
        states.append(yls)

    sel = torch.as_tensor(out_pos, device=dev)
    T = len(out_pos)
    parts = []
    for ci, (off, nc, wc) in enumerate(spans):
        sc = torch.stack([st[ci] for st in states])[sel]          # (T, wc, P*nc)
        full = torch.cat([sc, sc.new_zeros((T, w - wc, P * nc))], dim=1)
        parts.append(full.reshape(T, w, P, nc))
    ys_p = torch.cat(parts, dim=3)                                # (T, w, P, N) permuted
    return ys_p[..., inv].permute(2, 0, 3, 1).reshape(P, T, N * w)


# ---------------------------------------------------------------------------
# full phi matrices: the per-candidate path and model 4
# ---------------------------------------------------------------------------

# model 4's segments a chunk, one Jacobian and one phi build each (the JAX
# package's default)
_CHUNK = 8


def _phi_matrices_lanes(L, h, unroll: int | None = None):
    """E = expm(L h), Phi1 = h phi1(L h) and Phi2 = h^2 phi2(L h) as full
    matrices, lane layout: L (w, w, B), h (B,) -> three (w, w, B).

    Scaling, Taylor series (12 terms at radius 0.25 for float64, 8 at 0.5
    for float32) and the doubling identities

        E(2h) = E(h)^2,  Phi1(2h) = (I + E) Phi1,  Phi2(2h) = (I + E) Phi2 + h Phi1.

    The squaring ladder runs to the largest squaring count of the finite
    lanes (one non-finite lane does not set the others' trip count; it
    never steps), each lane's count clipped to 24: the JAX package's
    dynamic ladder. ``unroll=k`` runs exactly k masked doublings, each
    lane's count clipped at k, with no host read (the differentiable
    route takes k = 24, the JAX package's masked ladder): the same
    matrices wherever k covers every lane's count."""
    w, B = L.shape[0], L.shape[-1]
    taylor_terms, rad = (12, 0.25) if L.dtype == torch.float64 else (8, 0.5)
    A = L * h
    norm = torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
    s = torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / rad))
    s = torch.clamp(s, min=0.0, max=float(_MAX_SQUARINGS if unroll is None else unroll))
    scale = torch.exp2(s)
    A = A / scale
    hs = h / scale

    eye = torch.eye(w, dtype=L.dtype, device=L.device)[:, :, None]
    E = eye.expand(w, w, B)
    for k in range(taylor_terms, 0, -1):
        E = eye + _mm_lanes(A / k, E)
    term = F1 = eye.expand(w, w, B)
    F2 = F1 / 2.0
    for k in range(1, taylor_terms + 1):
        term = _mm_lanes(term, A) / k                 # A^k / k!
        F1 = F1 + term / (k + 1)
        F2 = F2 + term / ((k + 1) * (k + 2))
    Phi1 = F1 * hs
    Phi2 = F2 * (hs * hs)

    hc = hs
    trips = unroll if unroll is not None else (
        int(torch.nan_to_num(s, nan=0.0).max()) if B else 0)
    for i in range(trips):
        go = i < s
        P2n = Phi2 + _mm_lanes(E, Phi2) + Phi1 * hc
        P1n = Phi1 + _mm_lanes(E, Phi1)
        E = torch.where(go, _mm_lanes(E, E), E)
        Phi1 = torch.where(go, P1n, Phi1)
        Phi2 = torch.where(go, P2n, Phi2)
        hc = torch.where(go, 2.0 * hc, hc)
    return E, Phi1, Phi2


def _to_lanes(Y, w: int):
    """(P, N*w) member states -> (w, P*N) slot planes, lanes member-major."""
    return Y.reshape(-1, w).T


def _from_lanes(yl, P: int):
    """(w, P*N) -> (P, N*w)."""
    return yl.T.reshape(P, -1)


def _remainder_fn(system, params_b: dict, P: int):
    """g(t, yl, jb, L) = rhs(yl) - L yl in lane layout: the part of the RHS
    the frozen linear operator L (w, w, P*N) leaves, the whole RHS
    evaluated for every member in bucket ``jb``."""
    rhs = system.rhs
    dev = rhs.Kmat.device

    def g_of(t, yl, jb: int, L):
        jbv = torch.full((P,), int(jb), dtype=torch.long, device=dev)
        r = rhs.batched(t, _from_lanes(yl, P), jbv, params_b)
        return _to_lanes(r, rhs.width) - _lanes_mv(L, yl)

    return g_of


def _select_outputs(states, out_idx, P: int, N: int, w: int):
    """ys (P, T, N*w) from [y0] + one state per segment, at ``out_idx + 1``."""
    sel = torch.stack(states)[torch.as_tensor(np.asarray(out_idx) + 1,
                                              device=states[0].device)]
    T = len(out_idx)
    return sel.reshape(T, w, P, N).permute(2, 0, 3, 1).reshape(P, T, N * w)


def _chunk_plan(seg_t0, seg_h, seg_jb):
    """Chunks of at most ``_CHUNK`` consecutive segments sharing h and the
    bucket (and contiguous in t): model 4 freezes its block Jacobian, and
    so its phi matrices, for a chunk. Returns (c_t0, c_h, c_jb, c_n),
    c_n the segments of each chunk. The JAX package also returns the map of
    its padded chunk slots; the port keeps no padded slot, so the
    segments' own ``out_idx`` serves."""
    S = len(seg_t0)
    c_t0, c_h, c_jb, c_n = [], [], [], []
    i = 0
    while i < S:
        j = i + 1
        while (j < S and j - i < _CHUNK and seg_jb[j] == seg_jb[i]
               and seg_h[j] == seg_h[i]
               and abs(seg_t0[j] - (seg_t0[j - 1] + seg_h[j - 1])) < 1e-9):
            j += 1
        c_t0.append(seg_t0[i])
        c_h.append(seg_h[i])
        c_jb.append(seg_jb[i])
        c_n.append(j - i)
        i = j
    return (np.asarray(c_t0), np.asarray(c_h), np.asarray(c_jb, np.int32),
            np.asarray(c_n, np.int32))


def _rosenbrock_simulate_batched(system, params_b: dict, y0b, seg_t0, seg_h, seg_jb,
                                 out_idx, differentiable: bool = False):
    """Model 4: exponential Rosenbrock (exprb2 with the ETD2RK inner
    stage). At each chunk's entry the block Jacobian at the current state
    (:meth:`PaddedRHS.jac_blocks_saturating`, TF input frozen) is taken as
    L and the full phi matrices are built once; every segment of the chunk
    then steps with the remainder g = rhs - L y evaluated exactly.
    ``params_b`` tensors with a leading P, y0b (P, N*w). Returns (ys (P, T,
    N*w), success (P,)). ``differentiable``: the phi builds take the
    static masked ladder (no host read)."""
    rhs = system.rhs
    N, w = rhs.N, rhs.width
    P = y0b.shape[0]
    f = dict(dtype=y0b.dtype, device=y0b.device)
    g_of = _remainder_fn(system, params_b, P)
    yl = _to_lanes(y0b, w)
    states = [yl]
    for t0, h, jb, n in zip(*_chunk_plan(seg_t0, seg_h, seg_jb)):
        Kt = rhs.Kmat[:, int(jb)][None, :] * params_b["c_k"]          # (P, K)
        Y = _from_lanes(yl, P).reshape(P, N, w)
        L = rhs.jac_blocks_saturating(Y, rhs.site_rates(Kt), params_b)
        L = L.reshape(P * N, w, w).permute(1, 2, 0)                    # (w, w, P*N)
        Es, P1, P2 = _phi_matrices_lanes(L, torch.full((P * N,), float(h), **f),
                                         unroll=_MAX_SQUARINGS if differentiable else None)
        P2h = P2 / float(h)
        for k in range(int(n)):
            t = float(t0) + k * float(h)
            g_n = g_of(t, yl, jb, L)
            a = _lanes_mv(Es, yl) + _lanes_mv(P1, g_n)
            g_a = g_of(t + float(h), a, jb, L)
            yl = a + _lanes_mv(P2h, g_a - g_n)
            states.append(yl)
    ys = _select_outputs(states, out_idx, P, N, w)
    return ys, torch.isfinite(ys).all(dim=2).all(dim=1)


def exponential_simulate(system, params_b: dict, t_eval, substep: float = 16.0,
                         y0=None) -> ODEResult:
    """The per-candidate exponential integrator of ``solver="expo"``, over
    a population: every leaf of ``params_b`` has a leading axis P; ``y0``
    None (the system's), one padded state or (P, N*w). Returns ys (P, T,
    N*w), success (P,) and the segment count as each member's steps.

    Counterpart of ``jax.vmap`` of the JAX package's
    ``exponential_simulate``. Models 0-2: full E, Phi1, Phi2 matrices per
    (bucket, h) pair (:func:`_phi_matrices_lanes`), the blocks the batched
    path writes out, and per segment the ETD2RK step with the remainder g
    = rhs - L y of the whole RHS. Model 4: the exponential-Rosenbrock path
    of :func:`exponential_simulate_batched`."""
    rhs = system.rhs
    N, w = rhs.N, rhs.width
    f = dict(dtype=rhs.Kmat.dtype, device=rhs.Kmat.device)
    params_b = {k: torch.as_tensor(v, **f) for k, v in params_b.items()}
    P = params_b["c_k"].shape[0]
    y0b = torch.as_tensor(system.y0() if y0 is None else y0, **f)
    y0b = y0b.reshape(-1, N * w).expand(P, N * w)
    seg_t0, seg_h, seg_jb, out_idx, seg_uidx, u_jb, u_h = _plan(system, t_eval, substep)
    S = len(seg_t0)
    if system.topo.model == 4:
        ys, success = _rosenbrock_simulate_batched(system, params_b, y0b, seg_t0, seg_h,
                                                   seg_jb, out_idx)
    else:
        bucket_uniq, bucket_inv = np.unique(u_jb, return_inverse=True)
        blocks = _block_linear_operators if system.topo.model == 2 else _linear_blocks_lanes
        L_b = blocks(system, params_b, bucket_uniq)                   # (Bu, w, w, P*N)
        tables = [_phi_matrices_lanes(L_b[int(b)], torch.full((P * N,), float(h), **f))
                  for b, h in zip(bucket_inv, u_h)]
        g_of = _remainder_fn(system, params_b, P)
        yl = _to_lanes(y0b, w)
        states = [yl]
        for t0, h, jb, u in zip(seg_t0, seg_h, seg_jb, seg_uidx):
            Es, P1, P2 = tables[int(u)]
            L = L_b[int(bucket_inv[int(u)])]
            g_n = g_of(float(t0), yl, jb, L)
            a = _lanes_mv(Es, yl) + _lanes_mv(P1, g_n)
            g_a = g_of(float(t0 + h), a, jb, L)
            yl = a + _lanes_mv(P2 / float(h), g_a - g_n)
            states.append(yl)
        ys = _select_outputs(states, out_idx, P, N, w)
        success = torch.isfinite(ys).all(dim=2).all(dim=1)
    steps = torch.full((P,), S, dtype=torch.int32, device=f["device"])
    return ODEResult(ys, success, steps, steps)


def _jac_blocks_batched(system, params_b: dict, Yb, jb: int):
    """(P, N, w, w) block Jacobians of the RHS at the states Yb (P, N, w),
    the TF input frozen: w ``torch.func.jvp`` passes a member (column j
    lights slot j of every protein at once, exact as the frozen-input RHS
    is block-diagonal), vmapped over the members. The check on
    :meth:`PaddedRHS.jac_blocks_saturating`, as in the JAX package."""
    rhs = system.rhs
    N, w = rhs.N, rhs.width
    u0 = Yb.new_zeros(N)
    basis = torch.eye(w, dtype=Yb.dtype, device=Yb.device)[:, None, :].expand(w, N, w)
    basis = basis.reshape(w, N * w)

    def one(Y, p):
        def column(v):
            return torch.func.jvp(lambda z: rhs(0.0, z, jb, p, u_override=u0),
                                  (Y.reshape(-1),), (v,))[1].reshape(N, w)
        return torch.func.vmap(column)(basis).permute(1, 2, 0)    # (N, w, w)

    return torch.func.vmap(one)(Yb, params_b)
