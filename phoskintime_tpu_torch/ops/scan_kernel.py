"""The whole ETD2RK segment scan as one kernel.

Counterpart of ``phoskintime_tpu/ops/scan_pallas.py``:

* :func:`prepare_scan_plan` — the static plan of the scan (segment table
  rows, buckets and snapshot slots; the runs of segments that share a
  pair, :func:`scan_runs`; the total-protein weights; the driven
  proteins; the TF coupling as CSR rows).
* :func:`etd2rk_scan` — the entry point. On a CUDA float32 or float64
  tensor it launches ``csrc/etd2rk_scan.cu`` (the port of
  ``etd2rk_scan_pallas``; an entry for each type) in the variant
  :func:`scan_launch_shape` picks by (w, N, type), and adds one
  to ``etd2rk_scan.launches``; on a CPU tensor, or with
  ``use_kernel=False``, it runs the plain version.
* :func:`etd2rk_scan_reference` — the plain PyTorch version, segment by
  segment.

The lane layout is the eager scan's (``network/expo.py::_full_scan``):
member-major, protein-minor lanes, B = P * N, no padding. The Pallas
kernel pads proteins to a multiple of 8 and turns the TF matvec into lane
rotations over cyclic diagonals (``tf_diagonals``); both are TPU layout
devices with no use here, and so are its VMEM budget and diagonal cap.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.network.rhs import synthesis_rate
from phoskintime_tpu_torch.ops.cuda_build import CSRC, MAX_SHARED_BYTES, entry

SOURCE = CSRC / "etd2rk_scan.cu"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_MIN_WIDTH, _MAX_WIDTH = 2, 17      # the widths of the two table kernels
_MAX_PROTEINS = 256                 # one member's lanes fit one thread block
# E's w^2 entries in a thread's registers, by element size: float64 takes
# two registers a word
_MAX_REGISTER_WIDTH = {4: 8, 8: 6}
_ENTRY = {torch.float32: "etd2rk_scan_f32", torch.float64: "etd2rk_scan_f64"}
# lanes per thread block, in whole members: the fastest of 64-1024 at the
# bench chunk on the H100 (PERF.md)
_BLOCK_LANES = 128
# csrc/etd2rk_scan.cu's variants, by where a run's E rows stay
VARIANTS = ("registers", "shared", "stream")

_NOT_COVERED = ("the etd2rk_scan kernel takes float32 or float64 with 2 <= w <= 17 "
                "and at most 256 proteins; got {} at w = {}, N = {} (ROADMAP.md "
                "queue 2, kernel 2b: 'etd2rk_scan beyond w = 17 or N = 256')")


class ScanPlan(NamedTuple):
    """Static plan of the scan, host numpy. S segments, T snapshots, N
    proteins per member, w slots per protein."""
    N: int
    T: int
    uidx: np.ndarray        # (S,) int32: the segment's table row (pair)
    jb: np.ndarray          # (S,) int32: its kinase bucket, in [0, NB - 1]
    out_slot: np.ndarray    # (S,) int32: snapshot written after it, -1 none
    runs: np.ndarray        # (R, 4) int32: (first segment, length, pair, bucket) a run
    init_slots: np.ndarray  # (n,) int32: snapshots equal to y0 (t_eval <= 0)
    slot_map: np.ndarray    # (T,) int64: the written snapshot of each t_eval point
    totw: np.ndarray        # (w, N): total-protein weight of each slot; row 0 is 0
    driven: np.ndarray      # (N,) int32: 1 where the kinase drive replaces the total
    driver_idx: np.ndarray  # (N,) int64: the kinase of a driven protein
    tf_ptr: np.ndarray      # (N + 1,) int32: CSR rows of tf_mat
    tf_col: np.ndarray      # (nnz,) int32
    tf_coef: np.ndarray     # (nnz,) float64: tf_mat entries
    tf_deg: np.ndarray      # (N,) float64: the TF input's normaliser


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scan_runs(uidx, jb) -> np.ndarray:
    """(R, 4) int32 (first segment, length, pair, bucket): the maximal
    stretches of consecutive segments that share one pair and one kinase
    bucket, in order (a pair of the segment plan has one bucket, so these
    are the runs of the pairs). Unlike ``network/expo.py::_run_plan`` a run
    is not split at snapshots: the kernel writes a snapshot after any
    segment."""
    uidx, jb = np.asarray(uidx, np.int32), np.asarray(jb, np.int32)
    first = np.flatnonzero(np.diff(uidx, prepend=-1) | np.diff(jb, prepend=-1))
    lengths = np.diff(np.append(first, len(uidx)))
    return np.stack([first, lengths, uidx[first], jb[first]], axis=1).astype(np.int32)


class ScanShape(NamedTuple):
    """The launch shape of ``csrc/etd2rk_scan.cu`` for one (w, N)."""
    variant: str            # where a run's E rows stay: one of VARIANTS
    members: int            # whole members a thread block
    threads: int            # threads a block: the members' lanes, in whole warps
    shared_bytes: int       # dynamic shared memory a block


def scan_launch_shape(w: int, N: int, itemsize: int = 4) -> ScanShape:
    """The scan kernel's variant and block for width ``w``, ``N`` proteins
    a member and elements of ``itemsize`` bytes (4 or 8), by (w, N,
    itemsize) alone. Small blocks (w <= 8 in float32, w <= 6 in float64)
    keep a run's E rows in registers; wider ones keep them in shared
    memory, itemsize (w^2 + 2) bytes a lane with the totals' two buffers
    (one word more at even w, whose rows are padded to an odd stride),
    while one member's fit the block's 232,448 bytes (in float32: w <= 15
    always, w = 16 up to N = 224, w = 17 up to N = 199; in float64 about
    half those N), and past that stream them from memory at every segment.
    A block holds the whole members that fit ``_BLOCK_LANES`` lanes (at
    least one) and its shared memory. Raises NotImplementedError outside
    the kernel's domain."""
    if not (_MIN_WIDTH <= w <= _MAX_WIDTH and 1 <= N <= _MAX_PROTEINS):
        raise NotImplementedError(_NOT_COVERED.format("a shape", w, N))
    lane_bytes = itemsize * 2                              # the totals' buffers
    shared_lane = itemsize * (w * w + (w + 1) % 2 + 2)
    if w <= _MAX_REGISTER_WIDTH[itemsize]:
        variant = "registers"
    elif N * shared_lane <= MAX_SHARED_BYTES:
        variant, lane_bytes = "shared", shared_lane
    else:
        variant = "stream"
    members = max(1, min(_BLOCK_LANES // N, MAX_SHARED_BYTES // (N * lane_bytes)))
    return ScanShape(variant, members, -(-members * N // 32) * 32,
                     members * N * lane_bytes)


def prepare_scan_plan(rhs, seg_jb, seg_uidx, u_h, out_idx, T):
    """The plan of :func:`etd2rk_scan` for ``rhs`` (a ``PaddedRHS``) and a
    segment plan (``network/expo.py::_segment_plan``).

    The kernel writes one snapshot per segment: where several t_eval points
    end on one segment, it writes the first of their slots, and
    ``slot_map`` copies that snapshot to the others. Raises
    NotImplementedError for a mechanism outside {0, 1, 2}, whose RHS is
    not affine in the state."""
    model = int(rhs.model)
    if model not in (0, 1, 2):
        raise NotImplementedError(f"mechanism {model} is not affine in the state; "
                                  "the scan kernel takes mechanisms 0, 1 and 2")
    out_idx = np.asarray(out_idx)
    seg_uidx = np.asarray(seg_uidx, np.int32)
    if len(seg_uidx) and seg_uidx.max() >= len(u_h):
        raise ValueError("seg_uidx indexes past the pairs of u_h")
    ends = np.flatnonzero(out_idx >= 0)
    segs, first = np.unique(out_idx[ends], return_index=True)
    out_slot = np.full(len(seg_uidx), -1, np.int32)
    out_slot[segs] = ends[first]
    slot_map = np.arange(len(out_idx))
    slot_map[ends] = out_slot[out_idx[ends]]

    N, w = int(rhs.N), int(rhs.width)
    totw = np.zeros((w, N))
    if model == 2:
        totw[1:] = _host(rhs.state_mask).T
    else:
        totw[1] = 1.0
        totw[2:] = _host(rhs.site_mask).T
    tfm = _host(rhs.tf_mat).astype(np.float64)
    rows, cols = np.nonzero(tfm)
    n_buckets = int(rhs.Kmat.shape[1])
    jb = np.clip(np.asarray(seg_jb, np.int32), 0, n_buckets - 1)
    return ScanPlan(
        N=N, T=int(T), uidx=seg_uidx, jb=jb, out_slot=out_slot, runs=scan_runs(seg_uidx, jb),
        init_slots=np.flatnonzero(out_idx < 0).astype(np.int32),
        slot_map=slot_map, totw=totw, driven=_host(rhs.driven).astype(np.int32),
        driver_idx=_host(rhs.driver_idx).astype(np.int64),
        tf_ptr=np.searchsorted(rows, np.arange(N + 1)).astype(np.int32),
        tf_col=cols.astype(np.int32), tf_coef=tfm[rows, cols],
        tf_deg=_host(rhs.tf_deg).astype(np.float64))


def _check(E, p1, p2h, y0, drv, A, ts, plan: ScanPlan):
    if E.dim() != 4 or E.shape[1] != E.shape[2]:
        raise ValueError(f"E must be (U, w, w, B); got {tuple(E.shape)}")
    U, w, _, B = E.shape
    want = {"p1": (U, w, B), "p2h": (U, w, B), "y0": (w, B), "A": (B,), "ts": (B,)}
    for name, x in zip(want, (p1, p2h, y0, A, ts)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}; got {tuple(x.shape)}")
    if drv.dim() != 2 or drv.shape[1] != B:
        raise ValueError(f"drv must be (NB, {B}); got {tuple(drv.shape)}")
    for x in (p1, p2h, y0, drv, A, ts):
        if x.device != E.device or x.dtype != E.dtype:
            raise ValueError("every tensor must share E's device and dtype")
    if plan.slot_map.shape != (plan.T,):
        raise ValueError(f"slot_map must be ({plan.T},); got {plan.slot_map.shape}")
    if B % plan.N or plan.totw.shape != (w, plan.N):
        raise ValueError(f"B = {B} lanes and totw {plan.totw.shape} do not fit "
                         f"N = {plan.N} proteins at w = {w}")
    S = len(plan.uidx)
    if ((S and (plan.uidx.max() >= U or plan.jb.max() >= drv.shape[0]
                or plan.out_slot.max() >= plan.T))
            or (len(plan.init_slots) and plan.init_slots.max() >= plan.T)):
        raise ValueError("the plan indexes past the tables, buckets or snapshots")
    if not np.array_equal(plan.runs, scan_runs(plan.uidx, plan.jb)):
        raise ValueError("the plan's runs are not the runs of its uidx and jb")


def etd2rk_scan_reference(E, p1, p2h, y0, drv, A, ts, plan: ScanPlan):
    """Plain version of :func:`etd2rk_scan`: the S segments one by one,

        a  = E y + p1 g(y)
        y' = a + p2h (g(a) - g(y)),

    g the synthesis drive of each lane (total protein, or the live kinase
    drive for a driven protein; the TF matvec; u / (1 + |u|); the rational
    rate). Returns the snapshots ys (T, w, B)."""
    _check(E, p1, p2h, y0, drv, A, ts, plan)
    w, B = y0.shape
    N = plan.N
    P = B // N
    f = dict(dtype=E.dtype, device=E.device)
    totw = torch.as_tensor(plan.totw[1:], **f).repeat(1, P)          # (w - 1, B)
    driven = torch.as_tensor(plan.driven != 0, device=E.device).repeat(P)
    tfm = torch.zeros((N, N), **f)
    rows = np.repeat(np.arange(N), np.diff(plan.tf_ptr))
    tfm[torch.as_tensor(rows, device=E.device),
        torch.as_tensor(plan.tf_col, dtype=torch.long, device=E.device)] = \
        torch.as_tensor(plan.tf_coef, **f)
    deg = torch.as_tensor(plan.tf_deg, **f)

    def synth(yl, drive):
        tot = torch.sum(yl[1:] * totw, dim=0)
        Pv = torch.where(driven, drive, tot)
        v = (Pv.reshape(P, N) @ tfm.T) / deg
        u = v / (1.0 + torch.abs(v))
        return synthesis_rate(A, ts, u.reshape(B))

    ys = y0.new_empty((plan.T, w, B))
    ys[torch.as_tensor(plan.init_slots, dtype=torch.long, device=E.device)] = y0
    y = y0
    for u, b, slot in zip(plan.uidx.tolist(), plan.jb.tolist(), plan.out_slot.tolist()):
        s_n = synth(y, drv[b])
        a = torch.sum(E[u] * y[None], dim=1) + p1[u] * s_n
        y = a + p2h[u] * (synth(a, drv[b]) - s_n)
        if slot >= 0:
            ys[slot] = y
    return _copy_shared_ends(ys, plan)


def _copy_shared_ends(ys, plan: ScanPlan):
    """Each t_eval point's snapshot from the slot its segment was written
    to (a copy only where two points end on one segment)."""
    if np.array_equal(plan.slot_map, np.arange(plan.T)):
        return ys
    return ys[torch.as_tensor(plan.slot_map, device=ys.device)]


def _launch(E, p1, p2h, y0, drv, A, ts, plan: ScanPlan, shape: ScanShape):
    """Allocate the snapshots and launch the kernel on E's device and stream."""
    tensors = (E, p1, p2h, y0, drv, A, ts)
    isz = E.element_size()
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the scan's tensors must be contiguous")
    w, B = y0.shape
    if not 0 < B < 2 ** 31:
        raise ValueError(f"unsupported lane count B={B}")
    dev = E.device
    # the plan's small arrays in one int32 and one upload at E's type (never
    # rounded to float32 in a float64 scan); freed on
    # return, their memory is reused only by work queued after the kernel on
    # this stream (PyTorch's caching allocator is stream-ordered)
    ints = (plan.driven, plan.tf_ptr, plan.tf_col, plan.runs, plan.out_slot,
            plan.init_slots)
    floats = (plan.totw, plan.tf_coef, plan.tf_deg)
    i_off = np.cumsum([0] + [a.size for a in ints])
    f_off = np.cumsum([0] + [a.size for a in floats])
    i_dev = torch.from_numpy(np.concatenate([np.ravel(a) for a in ints])
                             .astype(np.int32)).to(dev)
    f_dev = torch.from_numpy(np.concatenate([np.ravel(a) for a in floats])
                             .astype(np.float32 if isz == 4 else np.float64)).to(dev)
    ip = [i_dev.data_ptr() + 4 * int(o) for o in i_off[:-1]]
    fp = [f_dev.data_ptr() + isz * int(o) for o in f_off[:-1]]
    ptrs = [x.data_ptr() for x in tensors] + [
        fp[0], ip[0], ip[1], ip[2], fp[1], fp[2], ip[3], ip[4], ip[5]]
    ys = torch.empty((plan.T, w, B), dtype=E.dtype, device=dev)
    fn, err = entry(SOURCE, _ENTRY[E.dtype], _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), ys.data_ptr(), w,
                VARIANTS.index(shape.variant), shape.members, len(plan.init_slots),
                len(plan.runs), plan.N, B // plan.N,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("etd2rk_scan kernel launch failed: " + err(rc).decode())
    return ys


def etd2rk_scan(E, p1, p2h, y0, drv, A, ts, plan: ScanPlan, *,
                use_kernel: bool | None = None):
    """The whole ETD2RK scan.

    Args:
      E: (U, w, w, B) propagator tables E = expm(L h), one per pair; lanes
        member-major, B = P * N.
      p1: (U, w, B) h phi1(L h) e0.
      p2h: (U, w, B) h^2 phi2(L h) e0 / h (1/h folded in per pair).
      y0: (w, B) initial state.
      drv: (NB, B) the live kinase drive of each lane in each bucket (read
        for driven proteins only).
      A, ts: (B,) synthesis amplitude and TF scale of each lane.
      plan: :func:`prepare_scan_plan`.
      use_kernel: None routes by device (the kernel on CUDA, the plain
        version on the CPU); False forces the plain version (comparisons).
    Returns ys (T, w, B), the state at each t_eval point.
    """
    _check(E, p1, p2h, y0, drv, A, ts, plan)
    if use_kernel is None:
        use_kernel = E.is_cuda
    if not use_kernel:
        return etd2rk_scan_reference(E, p1, p2h, y0, drv, A, ts, plan)
    if not E.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    w = E.shape[1]
    if (E.dtype not in _ENTRY or not _MIN_WIDTH <= w <= _MAX_WIDTH
            or plan.N > _MAX_PROTEINS):
        raise NotImplementedError(_NOT_COVERED.format(E.dtype, w, plan.N))
    ys = _launch(E, p1, p2h, y0, drv, A, ts, plan,
                 scan_launch_shape(w, plan.N, E.element_size()))
    etd2rk_scan.launches += 1
    return _copy_shared_ends(ys, plan)


etd2rk_scan.launches = 0


def random_scan_problem(w: int, N: int = 7, P: int = 300, S: int = 40, *,
                        seed: int = 0, dtype=torch.float32, device="cpu"):
    """A seeded scan problem at block width ``w``, to hold the kernel
    against its plain version at every width: compartmental blocks
    (non-negative transfers, each column's outflow plus a decay on the
    diagonal) over two buckets and three pairs, tables from
    :func:`phi_tables`, a random TF graph, driven proteins 0 and 3, random
    total-protein masks, S segments with T = 6 snapshots, one of them the
    initial state. Returns (args, plan), ``args + (plan,)`` the arguments
    of :func:`etd2rk_scan`."""
    from phoskintime_tpu_torch.ops.phi_tables import ladder_len, phi_tables

    rng = np.random.default_rng(seed)
    B = P * N
    f = dict(dtype=dtype, device=device)
    L = rng.uniform(0.0, 2.0, (2, w, w, B))
    L[:, np.arange(w), np.arange(w), :] = 0.0
    L[:, np.arange(w), np.arange(w), :] = -(L.sum(axis=1) + rng.uniform(0.01, 4.0, (2, w, B)))
    binv, h_u = np.asarray([0, 1, 1]), np.asarray([0.0625, 2.0, 16.0])
    E, p1, p2 = phi_tables(torch.as_tensor(L, **f), binv, h_u,
                           max(ladder_len(w, h) for h in h_u))
    p2h = p2 / torch.as_tensor(h_u, **f)[:, None, None]
    lanes = lambda lo, hi, *shape: torch.as_tensor(rng.uniform(lo, hi, shape + (B,)), **f)
    args = (E, p1, p2h, lanes(0.1, 1.5, w), lanes(0.1, 2.0, 2), lanes(0.05, 0.8),
            lanes(0.5, 3.0))

    tfm = (rng.uniform(size=(N, N)) < 0.3) * rng.choice([-1.0, 1.0], (N, N))
    deg = np.abs(tfm).sum(axis=1)
    deg[deg == 0] = 1.0
    rows, cols = np.nonzero(tfm)
    totw = np.zeros((w, N))
    totw[1] = 1.0
    totw[2:] = rng.uniform(size=(w - 2, N)) < 0.7
    uidx = rng.integers(0, 3, S).astype(np.int32)
    jb = binv[uidx].astype(np.int32)
    out_slot = np.full(S, -1, np.int32)
    out_slot[np.sort(rng.choice(S - 1, 4, replace=False))] = [1, 2, 3, 4]
    out_slot[S - 1] = 5
    driven = np.zeros(N, np.int32)
    driven[[0, 3]] = 1
    plan = ScanPlan(
        N=N, T=6, uidx=uidx, jb=jb, out_slot=out_slot, runs=scan_runs(uidx, jb),
        init_slots=np.asarray([0], np.int32), slot_map=np.arange(6), totw=totw,
        driven=driven, driver_idx=np.zeros(N, np.int64),
        tf_ptr=np.searchsorted(rows, np.arange(N + 1)).astype(np.int32),
        tf_col=cols.astype(np.int32), tf_coef=tfm[rows, cols], tf_deg=deg)
    return args, plan
