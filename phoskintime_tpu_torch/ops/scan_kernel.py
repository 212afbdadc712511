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
  ``use_kernel=False``, it runs the plain version. The kernel takes every
  width of the table kernels, w >= 2, and members of up to 16,384
  proteins (a cluster of 8 blocks): the template kernel up to w = 17 and
  N = 256, the wide kernel past them.
* :func:`etd2rk_scan_reference` — the plain PyTorch version, segment by
  segment.

The lane layout is the eager scan's (``network/expo.py::_full_scan``):
member-major, protein-minor lanes, B = P * N, no padding. The Pallas
kernel pads proteins to a multiple of 8 and turns the TF matvec into lane
rotations over cyclic diagonals (``tf_diagonals``); both are TPU layout
devices with no use here, and so are its VMEM budget and diagonal cap
(past which the JAX package falls back to its XLA scan; the port's kernel
takes those shapes).
"""

from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.network.rhs import synthesis_rate
from phoskintime_tpu_torch.ops.cuda_build import CSRC, MAX_SHARED_BYTES, entry

SOURCE = CSRC / "etd2rk_scan.cu"
# (the tensors' pointers, ys, the launch shape's ints, the stream)
_ARGTYPES = [ctypes.c_void_p] * 4
# the narrowest width of the table kernels (which take every wider one)
_MIN_WIDTH = 2
# the template kernel's domain: w compiled in, one member a block of at
# most 256 threads; the wide kernel takes every other shape
_TEMPLATE_MAX_WIDTH, _TEMPLATE_MAX_PROTEINS = 17, 256
# E's w^2 entries in a thread's registers, by element size: float64 takes
# two registers a word
_MAX_REGISTER_WIDTH = {4: 8, 8: 6}
_ENTRY = {torch.float32: "etd2rk_scan_f32", torch.float64: "etd2rk_scan_f64"}
# lanes per thread block, in whole members: the fastest of 64-1024 at the
# bench chunk on the H100 (PERF.md)
_BLOCK_LANES = 128
# the wide kernel: threads a block at most (its launch bound), and the
# threads a block holds where several members fit; blocks a member at most
# (the portable cluster size); lanes a thread at most (wide-global); the
# warps an SM should hold where threads and shared memory allow (2, 4 or 8
# warps a lane's columns until then, from _COLS_MIN_WIDTH)
_WIDE_MAX_THREADS, _WIDE_THREADS, _MAX_CLUSTER, _MAX_PER = 512, 256, 8, 4
_TARGET_WARPS = 8
# a lane's columns go over several warps only where its rows are more than
# 3 a thread of a warp (w = 65 float64 measured slower with a second column
# warp: tools/kernel_ab.py tune-scan-wide); in wide-stream past the
# shared-memory table kernels' widths, where a block holds one member
_COLS_MIN_WIDTH = 97
_STREAM_COLS_MIN_WIDTH = 130
# an SM's shared memory (228 KB), of which each block also takes 1 KB; the
# threads an SM holds at the 64 registers the wide-shared builds take
_SM_SHARED_BYTES, _SM_THREADS = 233472, 1024
# the most proteins a member may have: a cluster of 8 wide-global blocks of
# 512 threads, 4 lanes a thread
_MAX_PROTEINS = _MAX_CLUSTER * _WIDE_MAX_THREADS * _MAX_PER
# csrc/etd2rk_scan.cu's variants, by where a run's E rows stay: the
# template kernel's three, then the wide kernel's (E and the state in
# shared memory; E streamed, the state in shared memory; both in device
# memory)
VARIANTS = ("registers", "shared", "stream", "wide-shared", "wide-stream", "wide-global")
_WIDE_VARIANTS = VARIANTS[3:]

_NOT_COVERED = ("the etd2rk_scan kernel takes float32 or float64 with w >= 2 and N >= 1 "
                "proteins; got {} at w = {}, N = {}")
_TOO_MANY = ("the etd2rk_scan kernel holds a member of up to 16,384 proteins (a cluster of "
             "8 blocks of 512 threads, 4 lanes a thread); got N = {} at w = {} in {}")


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
    members: int            # whole members a thread block (1 where a member spans a cluster)
    threads: int            # threads a block, in whole warps
    shared_bytes: int       # dynamic shared memory a block (without staged TF rows)
    lanes: int              # lanes a block (a cluster's block: its share of a member)
    group: int = 1          # threads a lane's rows (the wide kernel)
    cluster: int = 1        # blocks a member (the wide kernel)
    cols: int = 1           # warps a lane's columns (wide-shared, group 32)
    per: int = 1            # lanes a thread (wide-global)
    push: bool = False      # a cluster's blocks copy their totals to each other


def wide_layout(w: int, group: int) -> tuple[int, int, int]:
    """The wide kernel's shared layout in words, (e_row, e_lane, y_lane): a
    lane's E rows e_row apart (w rounded up to odd) and lanes e_lane apart,
    so that the 32 threads of a warp, at thread (g, lq) the row g of lane
    lq, read 32 banks (e_lane = group * e_row mod 32; odd for one thread a
    lane); a lane's y and a y_lane (odd) apart."""
    e_row = w | 1
    e_lane = w * e_row
    step = e_row * group % 32 if group > 1 else 1
    mod = 32 if group > 1 else 2
    e_lane += (step - e_lane) % mod
    return e_row, e_lane, w | 1


def wide_threads(lanes: int, group: int, cols: int = 1, per: int = 1) -> int:
    """Threads of a wide block of ``lanes`` lanes: ``group`` threads a
    lane's rows, 32 / group lanes a warp, and a lane's ``cols`` column
    warps; or ``per`` lanes a thread (group 1)."""
    if per > 1:
        return -(-(-(-lanes // per)) // 32) * 32
    return -(-lanes // (32 // group)) * 32 * cols


def wide_shared_bytes(variant: str, w: int, lanes: int, group: int, itemsize: int, *,
                      cols: int = 1, per: int = 1, cluster: int = 1, push: bool = False,
                      tf_cap: int = 0) -> int:
    """Dynamic shared bytes of a wide block (the kernel's own sum): two
    mbarriers; the two totals' buffers (``cols`` partials a lane, padded to
    16 bytes a block; every block's where the cluster pushes); 3 synthesis
    constants a lane; in wide-global each thread's sn and drive a lane; but
    in wide-global, y, a, the run's p1 and p2h rows and the weights, y_lane
    words each; the column warps' partial rows (cols > 1); the lanes' E
    rows (wide-shared); the staged TF coefficients; then as
    ints 3 a lane (the TF row's bounds, the driven flag) and the staged TF
    columns."""
    e_row, e_lane, y_lane = wide_layout(w, group)
    pad = 16 // itemsize
    words = 2 * (cluster if push else 1) * cols * (-(-lanes // pad) * pad) + 3 * lanes + tf_cap
    if variant == "wide-global":
        words += 2 * per * wide_threads(lanes, group, cols, per)
    else:
        words += 5 * lanes * y_lane
    if cols > 1:
        words += cols * lanes * y_lane
    if variant == "wide-shared":
        words += lanes * e_lane
    return 16 + itemsize * words + 4 * (3 * lanes + tf_cap)


def _blocks_an_sm(threads: int, shared_bytes: int) -> int:
    """Blocks an SM holds by its shared memory and its threads (at ~64
    registers a thread)."""
    return min(_SM_SHARED_BYTES // (shared_bytes + 1024), _SM_THREADS // threads)


def _wide_group(w: int, itemsize: int, streamed: bool) -> int:
    """Threads a lane's rows: about four rows a thread, a warp at most;
    where E is streamed, at most ``itemsize`` so that a warp reads whole
    32-byte sectors (32 / group lanes of each row)."""
    group = 1
    while group < 32 and 4 * group < w:
        group *= 2
    return min(group, itemsize) if streamed else group


def _wide_block(variant: str, w: int, lanes: int, cluster: int, itemsize: int,
                max_per: int = _MAX_PER) -> dict | None:
    """A block of ``lanes`` lanes in ``variant`` (a cluster's block where
    ``cluster`` > 1): its group, lanes a thread (at most ``max_per``),
    threads, whether the cluster pushes its totals (where every block's copy
    fits) and shared bytes; None where it does not fit."""
    if variant == "wide-global":
        group = 1
        per = next((p for p in range(1, max_per + 1)
                    if wide_threads(lanes, 1, 1, p) <= _WIDE_MAX_THREADS), None)
        if per is None:
            return None
    else:
        per = 1
        group = _wide_group(w, itemsize, variant != "wide-shared")
        while group > 1 and wide_threads(lanes, group) > _WIDE_MAX_THREADS:
            group //= 2
    threads = wide_threads(lanes, group, 1, per)
    if threads > _WIDE_MAX_THREADS:
        return None
    for push in ((True, False) if cluster > 1 else (False,)):
        shared = wide_shared_bytes(variant, w, lanes, group, itemsize, per=per,
                                   cluster=cluster, push=push)
        if shared <= MAX_SHARED_BYTES:
            return dict(group=group, per=per, threads=threads, push=push, shared=shared)
    return None


def _wide_shape(w: int, N: int, itemsize: int) -> ScanShape | None:
    """The wide kernel's shape: the first variant of _WIDE_VARIANTS (in
    wide-global, the fewest lanes a thread) whose block holds a member, with
    the whole members that fit _WIDE_THREADS threads, or a cluster's share
    of one over the fewest blocks of at most 8; then, in wide-shared at
    group 32 and w >= _COLS_MIN_WIDTH, the fewest warps a lane's columns
    (2, 4 or 8) that give an SM _TARGET_WARPS warps, or the most it can
    hold. None past N = 16,384."""
    tries = [(v, 1) for v in _WIDE_VARIANTS[:2]] + [
        ("wide-global", p) for p in range(1, _MAX_PER + 1)]
    for (variant, max_per), split in itertools.product(tries, range(1, _MAX_CLUSTER + 1)):
        lanes = -(-N // split)
        cluster = -(-N // lanes)
        blk = _wide_block(variant, w, lanes, cluster, itemsize, max_per)
        if blk is None:
            continue
        members = 1
        if cluster == 1:
            def fits(m):
                return (wide_threads(m * N, blk["group"], 1, blk["per"]) <= _WIDE_THREADS
                        and _wide_block(variant, w, m * N, 1, itemsize, max_per) is not None)
            while fits(members + 1):
                members += 1
            lanes = members * N
            blk = _wide_block(variant, w, lanes, 1, itemsize, max_per)
        if variant == "wide-stream" and cluster == 1 and w >= _STREAM_COLS_MIN_WIDTH:
            return _stream_cols_shape(w, N, itemsize, blk["group"])
        kw = dict(per=blk["per"], cluster=cluster, push=blk["push"])
        group, cols, threads, shared = blk["group"], 1, blk["threads"], blk["shared"]
        warps = lambda t, b: _blocks_an_sm(t, b) * t // 32          # noqa: E731
        if variant == "wide-shared" and group == 32 and w >= _COLS_MIN_WIDTH:
            for more in (2, 4, 8):
                if warps(threads, shared) >= _TARGET_WARPS:
                    break
                t2 = wide_threads(lanes, 32, more)
                s2 = wide_shared_bytes(variant, w, lanes, 32, itemsize, cols=more, **kw)
                if (t2 <= _WIDE_MAX_THREADS and s2 <= MAX_SHARED_BYTES
                        and warps(t2, s2) > warps(threads, shared)):
                    cols, threads, shared = more, t2, s2
        return ScanShape(variant, members, threads, shared, lanes, group, cluster, cols,
                         blk["per"], blk["push"])
    return None


def _stream_cols_shape(w: int, N: int, itemsize: int, group: int) -> ScanShape:
    """wide-stream past the shared-memory table kernels' widths, a member in
    one block: one member a block, a lane's columns over the most warps (2,
    4 or 8) whose threads (512 at most) and shared memory fit; a lane's
    rows are tens a thread there, and E's reads need every warp the card
    can hold."""
    cols = 1
    for more in (2, 4, 8):
        if (wide_threads(N, group, more) <= _WIDE_MAX_THREADS
                and wide_shared_bytes("wide-stream", w, N, group, itemsize, cols=more)
                <= MAX_SHARED_BYTES):
            cols = more
    return ScanShape("wide-stream", 1, wide_threads(N, group, cols),
                     wide_shared_bytes("wide-stream", w, N, group, itemsize, cols=cols), N,
                     group, 1, cols)


def scan_launch_shape(w: int, N: int, itemsize: int = 4) -> ScanShape:
    """The scan kernel's variant and block for width ``w``, ``N`` proteins
    a member and elements of ``itemsize`` bytes (4 or 8), by (w, N,
    itemsize) alone.

    Up to w = 17 and N = 256 the template kernel (w compiled in, a thread a
    lane, whole members a block): small blocks (w <= 8 in float32, w <= 6
    in float64) keep a run's E rows in registers; wider ones keep them in
    shared memory, itemsize (w^2 + 2) bytes a lane with the totals' two
    buffers (one word more at even w, whose rows are padded to an odd
    stride), while one member's fit the block's 232,448 bytes (in float32:
    w <= 15 always, w = 16 up to N = 224, w = 17 up to N = 199; in float64
    about half those N), and past that stream them from memory at every
    segment. A block holds the whole members that fit ``_BLOCK_LANES``
    lanes (at least one) and its shared memory.

    Past that the wide kernel (:func:`_wide_shape`): w at run time, any
    w the tables take, ``group`` threads a lane's rows and ``cols`` warps its columns, a
    member in one block or over a cluster of up to 8 whose blocks copy
    their totals to each other (or read each other's, past what a block
    holds); a run's E rows and the state in shared memory where they fit
    (wide-shared), else E streamed (wide-stream), else the state in device
    memory too (wide-global, up to 4 lanes a thread), up to N = 16,384.
    Past w = 129 a wide-stream member in one block takes the block alone
    and its lanes' columns over up to 8 warps (:func:`_stream_cols_shape`).
    Raises NotImplementedError outside the kernel's domain."""
    if not (_MIN_WIDTH <= w and N >= 1 and itemsize in (4, 8)):
        raise NotImplementedError(_NOT_COVERED.format(f"{itemsize}-byte items", w, N))
    if w <= _TEMPLATE_MAX_WIDTH and N <= _TEMPLATE_MAX_PROTEINS:
        return _template_shape(w, N, itemsize)
    shape = _wide_shape(w, N, itemsize) if N <= _MAX_PROTEINS else None
    if shape is None:
        raise NotImplementedError(_TOO_MANY.format(N, w, f"{itemsize}-byte items"))
    return shape


def _template_shape(w: int, N: int, itemsize: int) -> ScanShape:
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
                     members * N * lane_bytes, members * N)


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


def _tf_cap(plan: ScanPlan, shape: ScanShape, itemsize: int) -> int:
    """TF entries the wide kernel stages in shared memory: its blocks' most
    (a member's, or a cluster block's proteins'), where they fit beside the
    block's other words without lowering its blocks an SM; else 0 (read
    from device memory)."""
    if shape.variant not in _WIDE_VARIANTS:
        return 0
    ptr = np.asarray(plan.tf_ptr, np.int64)
    starts = np.arange(0, plan.N, shape.lanes)
    nnz = int(np.max(ptr[np.minimum(starts + shape.lanes, plan.N)] - ptr[starts]))
    staged = shape.shared_bytes + nnz * (itemsize + 4)
    if staged > MAX_SHARED_BYTES or (_blocks_an_sm(shape.threads, staged)
                                     < _blocks_an_sm(shape.threads, shape.shared_bytes)):
        return 0
    return nnz


def _launch(E, p1, p2h, y0, drv, A, ts, plan: ScanPlan, shape: ScanShape):
    """Allocate the snapshots (and the wide-global variant's state) and
    launch the kernel on E's device and stream."""
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
    state = (torch.empty((2, w, B), dtype=E.dtype, device=dev)
             if shape.variant == "wide-global" else None)
    ptrs = [x.data_ptr() for x in tensors] + [
        fp[0], ip[0], ip[1], ip[2], fp[1], fp[2], ip[3], ip[4], ip[5],
        0 if state is None else state.data_ptr()]
    ys = torch.empty((plan.T, w, B), dtype=E.dtype, device=dev)
    e_row, e_lane, y_lane = wide_layout(w, shape.group)
    # the launch shape in csrc/etd2rk_scan.cu's order (launch_any)
    ints = [w, VARIANTS.index(shape.variant), shape.members, len(plan.init_slots),
            len(plan.runs), plan.N, B // plan.N, shape.lanes, shape.group, shape.cols,
            shape.per, shape.cluster, int(shape.push), _tf_cap(plan, shape, isz), e_lane, e_row,
            y_lane]
    fn, err = entry(SOURCE, _ENTRY[E.dtype], _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), ys.data_ptr(),
                (ctypes.c_int * len(ints))(*ints), torch.cuda.current_stream(dev).cuda_stream)
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
    Returns ys (T, w, B), the state at each t_eval point. On a CUDA tensor
    the kernel takes float32 and float64 at every w >= 2 and N <= 16,384
    (:func:`scan_launch_shape`) and raises NotImplementedError past them.
    """
    _check(E, p1, p2h, y0, drv, A, ts, plan)
    if use_kernel is None:
        use_kernel = E.is_cuda
    if not use_kernel:
        return etd2rk_scan_reference(E, p1, p2h, y0, drv, A, ts, plan)
    if not E.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    if E.dtype not in _ENTRY:
        raise NotImplementedError(_NOT_COVERED.format(E.dtype, E.shape[1], plan.N))
    ys = _launch(E, p1, p2h, y0, drv, A, ts, plan,
                 scan_launch_shape(E.shape[1], plan.N, E.element_size()))
    etd2rk_scan.launches += 1
    return _copy_shared_ends(ys, plan)


etd2rk_scan.launches = 0


def random_scan_problem(w: int, N: int = 7, P: int = 300, S: int = 40, *,
                        seed: int = 0, dtype=torch.float32, device="cpu"):
    """A seeded scan problem at block width ``w``, to hold the kernel
    against its plain version at every width: compartmental blocks
    (non-negative transfers, each column's outflow plus a decay on the
    diagonal) over two buckets and three pairs, tables from
    :func:`phi_tables`, a random TF graph (each entry present with
    probability 0.3 up to N = 4,096; past that, as an N x N draw would take
    gigabytes, 8 entries a row), driven proteins 0 and 3, random
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

    if N <= 4096:
        tfm = (rng.uniform(size=(N, N)) < 0.3) * rng.choice([-1.0, 1.0], (N, N))
        rows, cols = np.nonzero(tfm)
        coef = tfm[rows, cols]
    else:
        rows = np.repeat(np.arange(N), 8)
        cols = np.sort(rng.integers(0, N - 7, (N, 8)), axis=1)
        cols = (cols + np.arange(8)).ravel()            # 8 distinct columns a row
        coef = rng.choice([-1.0, 1.0], N * 8)
    deg = np.bincount(rows, np.abs(coef), minlength=N)
    deg[deg == 0] = 1.0
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
        tf_col=cols.astype(np.int32), tf_coef=coef, tf_deg=deg)
    return args, plan
