"""Exponential (ETD2RK) integrator for the global network model, batched
over a population.

Counterpart of the unbucketed path of
``phoskintime_tpu/network/expo.py::exponential_simulate_batched`` for the
affine mechanisms 0 and 1. Within one kinase bucket the RHS splits as
dy = L y + g(y): L is block-diagonal per protein (width w = 2 + Smax) and
g is the synthesis drive in the R slot, the only coupling between
proteins. Each segment of the static plan takes the exponential
trapezoidal step (Cox & Matthews 2002)

    a   = E y + p1 g(y)
    y+  = a + (p2 / h) (g(a) - g(y))

with E = expm(L h), p1 = h phi1(L h) e0, p2 = h^2 phi2(L h) e0 built once
per (bucket, h) pair by :func:`~phoskintime_tpu_torch.ops.phi_tables.phi_tables`.

Layout: the state is (w, P*N) — slot planes with member-major lanes — so
the tables, the state and the synthesis drive all keep the lane axis last.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from phoskintime_tpu_torch.network.rhs import check_model, synthesis_rate
from phoskintime_tpu_torch.ops.phi_tables import ladder_len, phi_tables


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


def _plan(system, t_eval, substep: float):
    return _segment_plan(tuple(np.asarray(system.kin_grid, float)),
                         tuple(np.asarray(t_eval, float)), float(substep))


def table_inputs(system, params_b: dict, t_eval, substep: float = 16.0):
    """The arguments the main path hands to :func:`phi_tables`:
    (L (Bu, w, w, P*N), binv (U,) int32, u_h (U,), ladder)."""
    u_jb, u_h = _plan(system, t_eval, substep)[5:]
    bucket_uniq, bucket_inv = np.unique(u_jb, return_inverse=True)
    L = _linear_blocks_lanes(system, params_b, bucket_uniq)
    ladder = max(ladder_len(system.topo.width, float(h)) for h in u_h)
    return L, bucket_inv.astype(np.int32), u_h, ladder


def exponential_simulate_batched(system, params_b: dict, t_eval,
                                 substep: float = 16.0, y0=None,
                                 use_kernel: bool | None = None,
                                 differentiable: bool = False):
    """Batched ETD2RK over a population: ``params_b`` leaves carry a leading
    axis P. Returns (ys (P, T, N*w), success (P,)) on the system's device.

    ``use_kernel`` goes to :func:`phi_tables` (None: the CUDA kernel on a
    CUDA system, the plain version on the CPU; False: the plain version).
    """
    if differentiable:
        raise NotImplementedError(
            "differentiable=True is not ported yet (ROADMAP.md queue 1: "
            "'Gradients and polish')")
    topo = system.topo
    check_model(topo.model)
    rhs = system.rhs
    N, w = topo.N, topo.width
    dev, dt = rhs.Kmat.device, rhs.Kmat.dtype
    params_b = {k: torch.as_tensor(v, dtype=dt, device=dev)
                for k, v in params_b.items()}
    P = params_b["c_k"].shape[0]
    lanes = P * N
    if y0 is None:
        y0 = system.y0()
    y0 = torch.as_tensor(np.asarray(y0, float).reshape(N, w), dtype=dt, device=dev)

    _, seg_h, seg_jb, out_idx, seg_uidx, _, _ = _plan(system, t_eval, substep)
    E_u, P1_u, P2_u = phi_tables(*table_inputs(system, params_b, t_eval, substep),
                                 use_kernel=use_kernel)

    # synthesis drive g(y) in the R slot: total protein per lane, replaced
    # by the live kinase activity for kinase-driven proteins, then the TF
    # matvec and the rational rate
    msk_lane = rhs.site_mask.T.repeat(1, P)                  # (Smax, P*N)
    driven = rhs.driven.repeat(P)
    A_b = params_b["A_i"]                                    # (P, N)
    ts_b = params_b["tf_scale"][:, None]                     # (P, 1)
    tf_T = rhs.tf_mat.T
    n_buckets = rhs.Kmat.shape[1]

    def synth_of(yl, drive):
        tot = yl[1] + torch.sum(yl[2:] * msk_lane, dim=0)
        Pv = torch.where(driven, drive, tot)
        v = (Pv.reshape(P, N) @ tf_T) / rhs.tf_deg
        u = v / (1.0 + torch.abs(v))
        return synthesis_rate(A_b, ts_b, u).reshape(lanes)

    # runs of equal (bucket, h): the table row, the bucket's kinase drive
    # and 1/h are fixed for the whole run; only run ends are kept
    runs, out_pos = _run_plan(seg_uidx, out_idx)
    yl = y0.reshape(1, N, w).expand(P, N, w).reshape(lanes, w).T.contiguous()
    states = [yl]
    for start, n in runs:
        uidx = int(seg_uidx[start])
        jb = min(max(int(seg_jb[start]), 0), n_buckets - 1)
        Es, P1 = E_u[uidx], P1_u[uidx]
        P2h = P2_u[uidx] * (1.0 / float(seg_h[start]))
        drive = (rhs.Kmat[:, jb][None, :] * params_b["c_k"])[:, rhs.driver_idx]
        drive = drive.reshape(lanes)
        for _ in range(n):
            s_n = synth_of(yl, drive)
            a = torch.sum(Es * yl[None], dim=1) + P1 * s_n
            s_a = synth_of(a, drive)
            yl = a + P2h * (s_a - s_n)
        states.append(yl)
    sel = torch.stack(states)[torch.as_tensor(out_pos, device=dev)]  # (T, w, PN)
    T = len(out_idx)
    ys = sel.reshape(T, w, P, N).permute(2, 0, 3, 1).reshape(P, T, N * w)
    success = torch.isfinite(ys).all(dim=2).all(dim=1)
    return ys, success
