"""ETD2RK propagator tables: E = expm(L h), p1 = h phi1(L h) e0,
p2 = h^2 phi2(L h) e0, for every (bucket, h) pair of the segment plan.

Counterpart of ``phoskintime_tpu/ops/phi_pallas.py``:

* :func:`phi_tables` — the entry point. On a CUDA float32 or float64
  tensor it launches a hand-written kernel (one template, an entry for
  each type): ``csrc/phi_tables.cu`` for 2 <= w <= 8
  (the port of ``phi_vectors_pallas_pages``; one more in
  ``phi_tables.launches``), or, through :func:`phi_tables_wide`,
  ``csrc/phi_tables_wide.cu`` for 9 <= w <= 17 (the port of
  ``phi_vectors_pallas_all``; one more in ``phi_tables_wide.launches``),
  or, through :func:`phi_tables_xwide`, ``csrc/phi_tables_xwide.cu`` for
  18 <= w <= 129 (the same Pallas entry at the widest blocks, model 2 at
  5, 6 and 7 sites; one more in ``phi_tables_xwide.launches``), or,
  through :func:`phi_tables_stream`, ``csrc/phi_tables_stream.cu`` for
  every w >= 130 (a lane's planes in device memory, model 2 at 8 sites
  and past; one more in ``phi_tables_stream.launches``). On a CPU tensor
  it runs the plain version at any width.
* :func:`phi_vectors` — one pair, the port of ``phi_vectors_pallas``: the
  same kernels with U = 1.
* :func:`phi_tables_reference` — the plain PyTorch version at any width,
  the port of ``network/expo.py::_phi_vectors_lanes`` looped over the pairs.

Each kernel source is compiled on first use and bound with ``ctypes``
(:mod:`phoskintime_tpu_torch.ops.cuda_build`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.ops.cuda_build import CSRC, MAX_SHARED_BYTES, entry, launch_on

# kernel (float32) series: 8 Taylor terms after scaling to radius 0.5
_TAYLOR_TERMS = 8
_RADIUS = 0.5
# ladder sizing: ||L h||_inf <= RATE_CAP * w * h for softplus-bounded rates
_RATE_CAP = 32.0
_MAX_SQUARINGS = 24
_MAX_KERNEL_WIDTH = 8           # csrc/phi_tables.cu
_MAX_WIDE_WIDTH = 17            # csrc/phi_tables_wide.cu: model 2 up to Smax = 4
_MAX_XWIDE_WIDTH = 129          # csrc/phi_tables_xwide.cu: model 2 up to Smax = 7; wider
                                # blocks to csrc/phi_tables_stream.cu

SOURCE = CSRC / "phi_tables.cu"
WIDE_SOURCE = CSRC / "phi_tables_wide.cu"
XWIDE_SOURCE = CSRC / "phi_tables_xwide.cu"
STREAM_SOURCE = CSRC / "phi_tables_stream.cu"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_WIDE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_XWIDE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_STREAM_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_CLUSTERS_ARGTYPES = [ctypes.POINTER(ctypes.c_int)]

# csrc/phi_tables_wide.cu: R, the rows of a lane's products one thread
# owns, at each width (T = ceil(w / R) threads a lane, 32 // T lanes a
# warp), and the warps a block; float32 chosen on the H100 (PERF.md). The
# float64 instances hold twice the registers a row, so take fewer rows.
_WIDE_ROWS = {9: 9, 10: 5, 11: 6, 12: 6, 13: 3, 14: 5, 15: 5, 16: 4, 17: 5}
_WIDE_ROWS_F64 = {9: 3, 10: 3, 11: 3, 12: 3, 13: 2, 14: 2, 15: 2, 16: 2, 17: 2}
_WIDE_WARPS = 2
_ENTRY_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_NOT_COVERED = "the phi_tables kernels take float32 or float64 with w >= 2; got {} at w = {}"
_OUTSIDE = "csrc/{} takes float32 or float64 with {} <= w <= {}; got {} at w = {}"
_STREAM_OUTSIDE = ("csrc/phi_tables_stream.cu takes float32 or float64 with w >= 130; "
                   "got {} at w = {}")
# csrc/phi_tables_xwide.cu: the threads a block at most (its launch bound),
# the threads a block aims at, the words after each plane, and a float64
# warp's tile: 2 (up to w = 48) or 1 (above) blocks of 16 rows by 3 blocks
# of 8 columns
_XWIDE_MAX_THREADS = 512
_XWIDE_TARGET_THREADS = 256
_XWIDE_MARGIN = 8
_XWIDE_TALL_MAX_W = 48
_XWIDE_TILE_COLS_F64 = 3
# an H100 SM's shared memory (228 KB), of which each resident block takes
# 1 KB for itself
_SM_SHARED_BYTES = 233472
_BLOCK_RESERVED_BYTES = 1024
# csrc/phi_tables_stream.cu: threads a block, a tile's rows and columns (the
# planes' unit), the words of a slot's head, blocks a lane (the kernel's
# kCluster, the portable cluster size), and the clusters an H100 80GB HBM3
# holds at once where the card is not asked (the occupancy API's count
# there: its GPCs hold 15 clusters of 8 at one block an SM, not 132 / 8)
_STREAM_THREADS, _STREAM_TILE, _STREAM_HEAD = 256, 64, 64
_STREAM_CLUSTER, _H100_CLUSTERS = 8, 15


def ladder_len(w: int, h: float, max_squarings: int = _MAX_SQUARINGS) -> int:
    """Static squaring count covering ||L h|| <= RATE_CAP * w * h."""
    norm = max(_RATE_CAP * w * float(h), 1e-30)
    need = int(np.ceil(np.log2(max(norm / _RADIUS, 1.0)))) + 1  # +1 headroom
    return int(np.clip(need, 1, max_squarings))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _mm_lanes(x, y):
    """(w, w, B) @ (w, w, B) block matmul with the batch on the last axis:
    the JAX package's j-loop of w elementwise products up to w = 129, one
    batched product over the lanes past it (the j-loop's w operations a
    product made the CPU's float64 objective of 8 members at w = 257 take
    minutes)."""
    if x.shape[0] > _MAX_XWIDE_WIDTH:
        return torch.bmm(x.permute(2, 0, 1), y.permute(2, 0, 1)).permute(1, 2, 0)
    acc = x[:, 0, None, :] * y[None, 0, :, :]
    for j in range(1, x.shape[0]):
        acc = acc + x[:, j, None, :] * y[None, j, :, :]
    return acc


def _mv_lanes(M, v):
    """(w, w, B) x (w, B) -> (w, B)."""
    return torch.sum(M * v[None, :, :], dim=1)


def phi_vectors_lanes(L: torch.Tensor, h, max_squarings=_MAX_SQUARINGS,
                      unroll: int | None = None):
    """E = expm(L h) and column 0 of h phi1(L h) and h^2 phi2(L h).
    L (w, w, B) -> E (w, w, B), p1 (w, B), p2 (w, B); ``h`` one float for
    all lanes or a (B,) tensor, one a lane.

    Scaling and squaring with a per-lane squaring count s clipped to
    ``max_squarings`` (an int, or a (B,) tensor of each lane's bound); the
    series follows the JAX package's dtype policy: 8 terms at radius 0.5
    for float32, 12 terms at radius 0.25 for float64.

    The ladder runs to the largest count of the finite lanes, read on the
    host. ``unroll=k`` instead runs exactly k masked doublings with each
    lane's count clipped at k as well, and reads nothing on the host, so
    ``torch.func`` transforms can trace it: the same values wherever k
    covers every lane's need (the JAX package's ``unroll`` ladder).
    """
    w, B = L.shape[0], L.shape[-1]
    f64 = L.dtype == torch.float64
    terms, rad = (12, 0.25) if f64 else (_TAYLOR_TERMS, _RADIUS)
    h = torch.as_tensor(h, dtype=L.dtype, device=L.device)
    A = L * h
    norm = torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
    s = torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / rad))
    s = torch.minimum(torch.clamp(s, min=0.0),
                      torch.as_tensor(max_squarings, dtype=L.dtype, device=L.device))
    if unroll is not None:
        s = torch.clamp(s, max=float(unroll))
    scale = torch.exp2(s)
    A = A / scale
    hs = h / scale

    eye = torch.eye(w, dtype=L.dtype, device=L.device)[:, :, None]
    E = eye.expand(w, w, B)
    for k in range(terms, 0, -1):
        E = eye + _mm_lanes(A / k, E)

    e0 = torch.zeros((w, B), dtype=L.dtype, device=L.device)
    e0[0] = 1.0
    term, v1, v2 = e0, e0, e0 / 2.0
    for k in range(1, terms + 1):
        term = _mv_lanes(A, term) / k                 # A^k e0 / k!
        v1 = v1 + term / (k + 1)
        v2 = v2 + term / ((k + 1) * (k + 2))
    p1 = v1 * hs
    p2 = v2 * (hs * hs)

    # doubling: E(2h) = E^2, p1(2h) = (I + E) p1, p2(2h) = (I + E) p2 + h p1;
    # lanes past their own s keep their values. A non-finite lane (s NaN)
    # never steps and does not set the trip count of the others.
    hc = hs
    trips = unroll if unroll is not None else (
        int(torch.nan_to_num(s, nan=0.0).max()) if B else 0)
    for i in range(trips):
        go = i < s
        p2n = p2 + _mv_lanes(E, p2) + p1 * hc
        p1n = p1 + _mv_lanes(E, p1)
        E = torch.where(go, _mm_lanes(E, E), E)
        p1 = torch.where(go, p1n, p1)
        p2 = torch.where(go, p2n, p2)
        hc = torch.where(go, 2.0 * hc, hc)
    return E, p1, p2


def phi_tables_reference(L: torch.Tensor, binv, h_u, ladder: int,
                         static_ladder: bool = False):
    """Plain version of :func:`phi_tables`: the tables pair by pair, with
    each lane's squaring count clipped to ``ladder`` as the kernel does.

    ``static_ladder=True``: each pair's lanes take ``ladder_len(w, h)``
    as their bound and all pairs run as one batch of lanes through the
    masked ladder of the largest bound (``phi_vectors_lanes(unroll=...)``),
    with no host read, as the JAX package's differentiable build bounds
    them; the same values where that bounds each lane's need, in one pass
    where the dynamic ladder takes one a pair."""
    w = L.shape[1]
    binv, h_u = np.asarray(binv), np.asarray(h_u, float)
    if static_ladder:
        U, B = len(h_u), L.shape[-1]
        lanes = L[torch.as_tensor(binv, device=L.device)]            # (U, w, w, B)
        lanes = lanes.permute(1, 2, 0, 3).reshape(w, w, U * B)
        bounds = [ladder_len(w, h) for h in h_u]
        E, p1, p2 = phi_vectors_lanes(lanes, np.repeat(h_u, B),
                                      max_squarings=np.repeat(bounds, B),
                                      unroll=max(bounds))
        return (E.reshape(w, w, U, B).permute(2, 0, 1, 3).contiguous(),
                p1.reshape(w, U, B).permute(1, 0, 2).contiguous(),
                p2.reshape(w, U, B).permute(1, 0, 2).contiguous())
    outs = [phi_vectors_lanes(L[int(b)], float(h), max_squarings=ladder)
            for b, h in zip(binv, h_u)]
    return tuple(torch.stack(x) for x in zip(*outs))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check(L: torch.Tensor, binv, h_u):
    if L.dim() != 4 or L.shape[1] != L.shape[2]:
        raise ValueError(f"L must be (Bu, w, w, B); got {tuple(L.shape)}")
    binv = np.asarray(binv)
    h_u = np.asarray(h_u)
    if binv.shape != h_u.shape or binv.ndim != 1:
        raise ValueError("binv and h_u must be (U,) arrays of one length")
    if len(binv) and (binv.min() < 0 or binv.max() >= L.shape[0]):
        raise ValueError("binv indexes past the buckets of L")
    return binv, h_u


class WideShape(NamedTuple):
    """The launch shape of ``csrc/phi_tables_wide.cu`` at one width."""
    rows: int               # R: rows of a lane's products a thread owns
    threads_per_lane: int   # T = ceil(w / R)
    lanes_per_warp: int     # 32 // T
    warps: int              # warps a block
    shared_bytes: int       # dynamic shared memory a block


def wide_launch_shape(w: int, itemsize: int = 4) -> WideShape:
    """The wide kernel's launch shape at width ``w`` (9..17) for elements of
    ``itemsize`` bytes (4 or 8): each warp's slice of shared memory holds
    two E planes and four vectors of its lanes, ``2 w^2 + 4 w`` words a
    lane. Raises NotImplementedError outside the kernel's domain."""
    if not _MAX_KERNEL_WIDTH < w <= _MAX_WIDE_WIDTH:
        raise NotImplementedError(_OUTSIDE.format("phi_tables_wide.cu", _MAX_KERNEL_WIDTH + 1,
                                                  _MAX_WIDE_WIDTH, "a width", w))
    R = {4: _WIDE_ROWS, 8: _WIDE_ROWS_F64}[itemsize][w]
    T = -(-w // R)
    lw = 32 // T
    return WideShape(R, T, lw, _WIDE_WARPS,
                     itemsize * _WIDE_WARPS * lw * (2 * w * w + 4 * w))


class XWideShape(NamedTuple):
    """The launch shape of ``csrc/phi_tables_xwide.cu`` at one width."""
    lanes: int              # LB: lanes a block, all its threads sharing them
    threads: int            # threads a block
    shared_bytes: int       # dynamic shared memory a block
    cluster: int            # blocks a lane: 1, or 2 (float64 past one block's memory)


def xwide_layout(w: int, cluster: int = 1) -> tuple[int, int, int, int]:
    """(K, rows, ld, plane) of the widest kernel's planes at width ``w``:
    K rows of a plane (w rounded up to 4, or to 8 in a cluster of two), the
    rows one block holds (K / cluster), the row stride (the least ld >= K + 2
    with ld = 4 mod 8) and the words of a plane in a block (rows ld and a
    margin of 8)."""
    K = -(-w // (4 * cluster)) * 4 * cluster
    ld = (K + 5) // 8 * 8 + 4
    rows = K // cluster
    return K, rows, ld, rows * ld + _XWIDE_MARGIN


def xwide_shared_bytes(w: int, lanes: int, cluster: int, itemsize: int) -> int:
    """A block's shared memory: the lanes' three planes (A and two E), two
    words a lane (h / 2^s, 2^-s), four the cluster's blocks exchange, and
    two ints a lane (the step count, the quotient route)."""
    plane = xwide_layout(w, cluster)[3]
    return itemsize * (3 * lanes * plane + 2 * lanes + 4) + 4 * 2 * lanes


def _xwide_lane_threads(w: int, itemsize: int, cluster: int) -> int:
    """Threads the widest product of one lane (the ladder's, K + 2 columns)
    gives work to: a thread a 4 x 8 tile in float32; in float64 a warp a
    tile of 2 x 3 (w <= 48) or 1 x 3 blocks of 16 x 8 over the rows a block
    holds."""
    K, rows, _, _ = xwide_layout(w, cluster)
    if itemsize == 4:
        return (K // 4) * -(-(K + 2) // 8)
    mb, nb = -(-min(rows, w) // 16), -(-(K + 2) // 8)
    tm = 2 if w <= _XWIDE_TALL_MAX_W else 1
    return 32 * -(-mb // tm) * -(-nb // _XWIDE_TILE_COLS_F64)


def xwide_launch_shape(w: int, itemsize: int = 4) -> XWideShape:
    """The widest kernel's launch shape at width ``w`` (18..129) for
    elements of ``itemsize`` bytes (4 or 8). A lane takes three planes of
    shared memory (:func:`xwide_layout`); where one lane passes the 227 KB a
    block may use (float64 from w = 97) a cluster of two blocks holds it,
    each half the rows. Otherwise a block takes as many lanes as give it
    about 256 threads of work, and no more than let two blocks share an SM,
    at least one. Threads: one a piece of work (a tile, or a warp a tile)
    in whole warps, or, past 512, the fewest warps that take the work in
    equal passes. Raises NotImplementedError outside the domain."""
    if not _MAX_WIDE_WIDTH < w <= _MAX_XWIDE_WIDTH or itemsize not in (4, 8):
        raise NotImplementedError(_OUTSIDE.format("phi_tables_xwide.cu", _MAX_WIDE_WIDTH + 1,
                                                  _MAX_XWIDE_WIDTH, f"{itemsize}-byte items",
                                                  w))
    cluster = 1 if xwide_shared_bytes(w, 1, 1, itemsize) <= MAX_SHARED_BYTES else 2
    work = _xwide_lane_threads(w, itemsize, cluster)
    lanes = 1
    if cluster == 1:
        half_sm = _SM_SHARED_BYTES // 2 - _BLOCK_RESERVED_BYTES
        while (lanes + 1) * work <= _XWIDE_TARGET_THREADS and \
                xwide_shared_bytes(w, lanes + 1, 1, itemsize) <= half_sm:
            lanes += 1
    passes = -(-lanes * work // _XWIDE_MAX_THREADS)
    threads = -(-lanes * work // passes // 32) * 32
    return XWideShape(lanes, threads, xwide_shared_bytes(w, lanes, cluster, itemsize), cluster)


def _launch(source, name: str, L, binv, h_u, ladder: int, argtypes=_ARGTYPES,
            extra: tuple = ()):
    """Allocate the tables and launch one kernel on L's device and stream
    (``extra``: the launch-shape integers after ``ladder``)."""
    if not L.is_contiguous():
        raise ValueError("L must be contiguous")
    w, B = L.shape[1], L.shape[3]
    U = len(binv)
    # grid: (lane tiles, U), lane index a 32-bit int
    if not (0 < U <= 65535 and 0 < B < 2 ** 31 // w):
        raise ValueError(f"unsupported table size U={U}, B={B}")
    if not 0 <= int(ladder) <= _MAX_SQUARINGS:
        raise ValueError(f"ladder {ladder} outside [0, {_MAX_SQUARINGS}]")
    dev, f = L.device, dict(dtype=L.dtype, device=L.device)
    binv_d = torch.as_tensor(binv, dtype=torch.int32).to(dev)
    h_d = torch.as_tensor(h_u, dtype=L.dtype).to(dev)
    E = torch.empty((U, w, w, B), **f)
    p1 = torch.empty((U, w, B), **f)
    p2 = torch.empty((U, w, B), **f)
    fn, err = entry(source, f"{name}_{_ENTRY_SUFFIX[L.dtype]}", argtypes)
    rc = launch_on(dev, fn, L.data_ptr(), binv_d.data_ptr(), h_d.data_ptr(), E.data_ptr(),
                   p1.data_ptr(), p2.data_ptr(), w, U, B, int(ladder), *extra)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: " + err(rc).decode())
    return E, p1, p2


def phi_tables(L: torch.Tensor, binv, h_u, ladder: int, *,
               use_kernel: bool | None = None, static_ladder: bool = False):
    """Tables for all (bucket, h) pairs.

    Args:
      L: (Bu, w, w, B) linear blocks, one slab per bucket, lanes last.
      binv: (U,) host int array, the bucket of each pair.
      h_u: (U,) host float array, the segment length of each pair.
      ladder: bound on each lane's squaring count (the max of
        :func:`ladder_len` over the pairs).
      use_kernel: None routes by device (a kernel on CUDA, the plain
        version on the CPU); False forces the plain version (comparisons,
        and the differentiable route: the kernels carry no derivative).
      static_ladder: the plain version's static ladder (see
        :func:`phi_tables_reference`); it needs ``use_kernel=False``.
    Returns E (U, w, w, B), p1 (U, w, B), p2 (U, w, B).
    """
    binv, h_u = _check(L, binv, h_u)
    if static_ladder and use_kernel is not False:
        raise ValueError("static_ladder=True is the plain version's; pass use_kernel=False")
    if use_kernel is None:
        use_kernel = L.is_cuda
    if not use_kernel:
        return phi_tables_reference(L, binv, h_u, ladder, static_ladder)
    w = L.shape[1]
    if L.dtype not in _ENTRY_SUFFIX or w < 2:
        raise NotImplementedError(_NOT_COVERED.format(L.dtype, w))
    if not L.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    if w > _MAX_XWIDE_WIDTH:
        return phi_tables_stream(L, binv, h_u, ladder)
    if w > _MAX_WIDE_WIDTH:
        return phi_tables_xwide(L, binv, h_u, ladder)
    if w > _MAX_KERNEL_WIDTH:
        return phi_tables_wide(L, binv, h_u, ladder)
    out = _launch(SOURCE, "phi_tables", L, binv, h_u, ladder)
    phi_tables.launches += 1
    return out


phi_tables.launches = 0


def phi_tables_wide(L: torch.Tensor, binv, h_u, ladder: int):
    """The wide-block kernel ``csrc/phi_tables_wide.cu`` (9 <= w <= 17,
    float32 or float64, CUDA), the port of ``phi_vectors_pallas_all``.
    Arguments and results as :func:`phi_tables`, which routes these widths
    here."""
    binv, h_u = _check(L, binv, h_u)
    w = L.shape[1]
    if not L.is_cuda:
        raise ValueError("phi_tables_wide needs a CUDA tensor")
    if L.dtype not in _ENTRY_SUFFIX or not _MAX_KERNEL_WIDTH < w <= _MAX_WIDE_WIDTH:
        raise NotImplementedError(_OUTSIDE.format("phi_tables_wide.cu", _MAX_KERNEL_WIDTH + 1,
                                                  _MAX_WIDE_WIDTH, L.dtype, w))
    shape = wide_launch_shape(w, L.element_size())
    out = _launch(WIDE_SOURCE, "phi_tables_wide", L, binv, h_u, ladder,
                  _WIDE_ARGTYPES, (shape.rows, shape.warps))
    phi_tables_wide.launches += 1
    return out


phi_tables_wide.launches = 0


def phi_tables_xwide(L: torch.Tensor, binv, h_u, ladder: int):
    """The widest-block kernel ``csrc/phi_tables_xwide.cu`` (18 <= w <= 129,
    float32 or float64, CUDA), the port of ``phi_vectors_pallas_all`` at
    these widths. Arguments and results as :func:`phi_tables`, which routes
    these widths here."""
    binv, h_u = _check(L, binv, h_u)
    w = L.shape[1]
    if not L.is_cuda:
        raise ValueError("phi_tables_xwide needs a CUDA tensor")
    if L.dtype not in _ENTRY_SUFFIX or not _MAX_WIDE_WIDTH < w <= _MAX_XWIDE_WIDTH:
        raise NotImplementedError(_OUTSIDE.format("phi_tables_xwide.cu", _MAX_WIDE_WIDTH + 1,
                                                  _MAX_XWIDE_WIDTH, L.dtype, w))
    shape = xwide_launch_shape(w, L.element_size())
    out = _launch(XWIDE_SOURCE, "phi_tables_xwide", L, binv, h_u, ladder,
                  _XWIDE_ARGTYPES, (shape.lanes, shape.threads, shape.cluster))
    phi_tables_xwide.launches += 1
    return out


phi_tables_xwide.launches = 0


class StreamShape(NamedTuple):
    """The launch shape of ``csrc/phi_tables_stream.cu`` at one width."""
    K: int                  # the k extent: w rounded up to a k-step of 128 bytes
    R: int                  # a plane's rows: w rounded up to the 64-row tile
    ld: int                 # a plane's columns: K + 3 rounded up to 64
    slot_words: int         # a slot: its head (64 words) and three planes
    cluster: int            # blocks a lane
    threads: int            # threads a block
    slots: int              # clusters of the grid, a slot of scratch each


def stream_layout(w: int, itemsize: int = 4) -> tuple[int, int, int, int]:
    """(K, R, ld, slot_words) of the stream kernel's planes at width ``w``
    for elements of ``itemsize`` bytes: the kernel's ``layout``."""
    bk = 128 // itemsize
    K = -(-w // bk) * bk
    R = -(-w // _STREAM_TILE) * _STREAM_TILE
    ld = -(-(K + 3) // _STREAM_TILE) * _STREAM_TILE
    return K, R, ld, _STREAM_HEAD + 3 * R * ld


def stream_launch_shape(w: int, itemsize: int = 4, items: int | None = None,
                        clusters: int = _H100_CLUSTERS) -> StreamShape:
    """The stream kernel's launch shape at width ``w`` (any w >= 130) for
    elements of ``itemsize`` bytes: a cluster of 8 blocks of 256 threads a
    lane, and as many clusters as the card holds at once (``clusters``:
    :func:`resident_clusters` on the card), so that the grid runs in one
    wave, at most one a (pair, lane) item. The
    scratch is ``slots * slot_words`` words. Raises NotImplementedError
    outside the kernel's domain."""
    if w <= _MAX_XWIDE_WIDTH or itemsize not in (4, 8):
        raise NotImplementedError(_STREAM_OUTSIDE.format(f"{itemsize}-byte items", w))
    K, R, ld, slot_words = stream_layout(w, itemsize)
    slots = max(1, int(clusters) if items is None else min(int(clusters), int(items)))
    return StreamShape(K, R, ld, slot_words, _STREAM_CLUSTER, _STREAM_THREADS, slots)


_RESIDENT: dict = {}


def resident_clusters(device: torch.device, dtype) -> int:
    """The clusters of the stream kernel (8 blocks each) ``device`` holds at
    once, by the occupancy API (cached a device and type). Where the API
    gives no count, a cluster for every 8 SMs: the grid's size sets only
    how many items run side by side, never the tables."""
    key = (device.index, dtype)
    if key not in _RESIDENT:
        fn, _ = entry(STREAM_SOURCE, f"phi_tables_stream_clusters_{_ENTRY_SUFFIX[dtype]}",
                      _CLUSTERS_ARGTYPES)
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(ctypes.byref(n))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _RESIDENT[key] = n.value if rc == 0 and n.value >= 1 else max(1, sms // _STREAM_CLUSTER)
    return _RESIDENT[key]


def phi_tables_stream(L: torch.Tensor, binv, h_u, ladder: int):
    """The streaming table kernel ``csrc/phi_tables_stream.cu`` (w >= 130,
    float32 or float64, CUDA; :func:`phi_tables` routes these widths here), the
    port of ``phi_vectors_pallas_all`` at these widths: a lane's planes in
    a slot of device memory, ``stream_launch_shape``'s slots of it
    allocated a call. Arguments and results as :func:`phi_tables`."""
    binv, h_u = _check(L, binv, h_u)
    w = L.shape[1]
    if not L.is_cuda:
        raise ValueError("phi_tables_stream needs a CUDA tensor")
    if L.dtype not in _ENTRY_SUFFIX or w <= _MAX_XWIDE_WIDTH:
        raise NotImplementedError(_STREAM_OUTSIDE.format(L.dtype, w))
    shape = stream_launch_shape(w, L.element_size(), len(binv) * L.shape[3],
                                resident_clusters(L.device, L.dtype))
    scratch = torch.empty(shape.slots * shape.slot_words, dtype=L.dtype, device=L.device)
    # freed on return: the caching allocator reuses it only for work queued
    # after the kernel on this stream
    out = _launch(STREAM_SOURCE, "phi_tables_stream", L, binv, h_u, ladder, _STREAM_ARGTYPES,
                  (scratch.data_ptr(), shape.slot_words, shape.slots))
    phi_tables_stream.launches += 1
    return out


phi_tables_stream.launches = 0


def phi_vectors(L: torch.Tensor, h: float, ladder: int, *,
                use_kernel: bool | None = None):
    """One (L, h) pair: L (w, w, B) -> E (w, w, B), p1 (w, B), p2 (w, B).
    The port of ``phi_vectors_pallas``: :func:`phi_tables` with U = 1."""
    if L.dim() != 3:
        raise ValueError(f"L must be (w, w, B); got {tuple(L.shape)}")
    E, p1, p2 = phi_tables(L[None], np.zeros(1, np.int32), np.asarray([float(h)]),
                           ladder, use_kernel=use_kernel)
    return E[0], p1[0], p2[0]
