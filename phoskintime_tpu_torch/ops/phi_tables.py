"""ETD2RK propagator tables: E = expm(L h), p1 = h phi1(L h) e0,
p2 = h^2 phi2(L h) e0, for every (bucket, h) pair of the segment plan.

Counterpart of ``phoskintime_tpu/ops/phi_pallas.py``:

* :func:`phi_tables` — the entry point. On a CUDA float32 or float64
  tensor it launches a hand-written kernel (one template, an entry for
  each type): ``csrc/phi_tables.cu`` for 2 <= w <= 8
  (the port of ``phi_vectors_pallas_pages``; one more in
  ``phi_tables.launches``), or, through :func:`phi_tables_wide`,
  ``csrc/phi_tables_wide.cu`` for 9 <= w <= 17 (the port of
  ``phi_vectors_pallas_all``; one more in ``phi_tables_wide.launches``).
  On a CPU tensor it runs the plain version.
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

from phoskintime_tpu_torch.ops.cuda_build import CSRC, entry, launch_on

# kernel (float32) series: 8 Taylor terms after scaling to radius 0.5
_TAYLOR_TERMS = 8
_RADIUS = 0.5
# ladder sizing: ||L h||_inf <= RATE_CAP * w * h for softplus-bounded rates
_RATE_CAP = 32.0
_MAX_SQUARINGS = 24
_MAX_KERNEL_WIDTH = 8           # csrc/phi_tables.cu
_MAX_WIDE_WIDTH = 17            # csrc/phi_tables_wide.cu: model 2 up to Smax = 4

SOURCE = CSRC / "phi_tables.cu"
WIDE_SOURCE = CSRC / "phi_tables_wide.cu"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_WIDE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

# csrc/phi_tables_wide.cu: R, the rows of a lane's products one thread
# owns, at each width (T = ceil(w / R) threads a lane, 32 // T lanes a
# warp), and the warps a block; float32 chosen on the H100 (PERF.md). The
# float64 instances hold twice the registers a row, so take fewer rows.
_WIDE_ROWS = {9: 9, 10: 5, 11: 6, 12: 6, 13: 3, 14: 5, 15: 5, 16: 4, 17: 5}
_WIDE_ROWS_F64 = {9: 3, 10: 3, 11: 3, 12: 3, 13: 2, 14: 2, 15: 2, 16: 2, 17: 2}
_WIDE_WARPS = 2
_ENTRY_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_NOT_COVERED = ("the phi_tables kernels take float32 or float64 with 2 <= w <= {}; "
                "got {} at w = {} (wider blocks, model 2 at Smax >= 5, are "
                "ROADMAP.md queue 2, kernel 1b: 'phi_tables_wide above w = 17')")


def ladder_len(w: int, h: float, max_squarings: int = _MAX_SQUARINGS) -> int:
    """Static squaring count covering ||L h|| <= RATE_CAP * w * h."""
    norm = max(_RATE_CAP * w * float(h), 1e-30)
    need = int(np.ceil(np.log2(max(norm / _RADIUS, 1.0)))) + 1  # +1 headroom
    return int(np.clip(need, 1, max_squarings))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _mm_lanes(x, y):
    """(w, w, B) @ (w, w, B) block matmul with the batch on the last axis."""
    acc = x[:, 0, None, :] * y[None, 0, :, :]
    for j in range(1, x.shape[0]):
        acc = acc + x[:, j, None, :] * y[None, j, :, :]
    return acc


def _mv_lanes(M, v):
    """(w, w, B) x (w, B) -> (w, B)."""
    return torch.sum(M * v[None, :, :], dim=1)


def phi_vectors_lanes(L: torch.Tensor, h: float,
                      max_squarings: int = _MAX_SQUARINGS):
    """E = expm(L h) and column 0 of h phi1(L h) and h^2 phi2(L h), one h
    for all lanes. L (w, w, B) -> E (w, w, B), p1 (w, B), p2 (w, B).

    Scaling and squaring with a per-lane squaring count s clipped to
    ``max_squarings``; the series follows the JAX package's dtype policy:
    8 terms at radius 0.5 for float32, 12 terms at radius 0.25 for float64.
    """
    w, B = L.shape[0], L.shape[-1]
    f64 = L.dtype == torch.float64
    terms, rad = (12, 0.25) if f64 else (_TAYLOR_TERMS, _RADIUS)
    h = torch.tensor(h, dtype=L.dtype, device=L.device)
    A = L * h
    norm = torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
    s = torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / rad))
    s = torch.clamp(s, min=0.0, max=float(max_squarings))
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
    for i in range(int(torch.nan_to_num(s, nan=0.0).max()) if B else 0):
        go = i < s
        p2n = p2 + _mv_lanes(E, p2) + p1 * hc
        p1n = p1 + _mv_lanes(E, p1)
        E = torch.where(go, _mm_lanes(E, E), E)
        p1 = torch.where(go, p1n, p1)
        p2 = torch.where(go, p2n, p2)
        hc = torch.where(go, 2.0 * hc, hc)
    return E, p1, p2


def phi_tables_reference(L: torch.Tensor, binv, h_u, ladder: int):
    """Plain version of :func:`phi_tables`: the tables pair by pair, with
    each lane's squaring count clipped to ``ladder`` as the kernel does."""
    outs = [phi_vectors_lanes(L[int(b)], float(h), max_squarings=ladder)
            for b, h in zip(np.asarray(binv), np.asarray(h_u))]
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
        raise NotImplementedError(_NOT_COVERED.format(_MAX_WIDE_WIDTH, "a width", w))
    R = {4: _WIDE_ROWS, 8: _WIDE_ROWS_F64}[itemsize][w]
    T = -(-w // R)
    lw = 32 // T
    return WideShape(R, T, lw, _WIDE_WARPS,
                     itemsize * _WIDE_WARPS * lw * (2 * w * w + 4 * w))


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
               use_kernel: bool | None = None):
    """Tables for all (bucket, h) pairs.

    Args:
      L: (Bu, w, w, B) linear blocks, one slab per bucket, lanes last.
      binv: (U,) host int array, the bucket of each pair.
      h_u: (U,) host float array, the segment length of each pair.
      ladder: bound on each lane's squaring count (the max of
        :func:`ladder_len` over the pairs).
      use_kernel: None routes by device (a kernel on CUDA, the plain
        version on the CPU); False forces the plain version (comparisons
        only).
    Returns E (U, w, w, B), p1 (U, w, B), p2 (U, w, B).
    """
    binv, h_u = _check(L, binv, h_u)
    if use_kernel is None:
        use_kernel = L.is_cuda
    if not use_kernel:
        return phi_tables_reference(L, binv, h_u, ladder)
    if not L.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    w = L.shape[1]
    if L.dtype not in _ENTRY_SUFFIX or not 2 <= w <= _MAX_WIDE_WIDTH:
        raise NotImplementedError(_NOT_COVERED.format(_MAX_WIDE_WIDTH, L.dtype, w))
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
        raise NotImplementedError(_NOT_COVERED.format(_MAX_WIDE_WIDTH, L.dtype, w))
    shape = wide_launch_shape(w, L.element_size())
    out = _launch(WIDE_SOURCE, "phi_tables_wide", L, binv, h_u, ladder,
                  _WIDE_ARGTYPES, (shape.rows, shape.warps))
    phi_tables_wide.launches += 1
    return out


phi_tables_wide.launches = 0


def phi_vectors(L: torch.Tensor, h: float, ladder: int, *,
                use_kernel: bool | None = None):
    """One (L, h) pair: L (w, w, B) -> E (w, w, B), p1 (w, B), p2 (w, B).
    The port of ``phi_vectors_pallas``: :func:`phi_tables` with U = 1."""
    if L.dim() != 3:
        raise ValueError(f"L must be (w, w, B); got {tuple(L.shape)}")
    E, p1, p2 = phi_tables(L[None], np.zeros(1, np.int32), np.asarray([float(h)]),
                           ladder, use_kernel=use_kernel)
    return E[0], p1[0], p2[0]
