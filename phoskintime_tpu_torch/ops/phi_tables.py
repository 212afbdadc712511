"""ETD2RK propagator tables: E = expm(L h), p1 = h phi1(L h) e0,
p2 = h^2 phi2(L h) e0, for every (bucket, h) pair of the segment plan.

Counterpart of ``phoskintime_tpu/ops/phi_pallas.py``. Two versions of one
function:

* :func:`phi_tables` — the entry point. On a CUDA float32 tensor with
  w <= 8 it launches the hand-written kernel ``csrc/phi_tables.cu`` (the
  port of ``phi_vectors_pallas_pages``) and adds one to
  ``phi_tables.launches``. On a CPU tensor it runs the plain version.
* :func:`phi_tables_reference` — the plain PyTorch version, the port of
  ``network/expo.py::_phi_vectors_lanes`` looped over the pairs.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use, into
``phoskintime_tpu_torch/_build/`` under a name keyed by a hash of the
source and flags, and bound with ``ctypes`` through a plain C interface.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

# kernel (float32) series: 8 Taylor terms after scaling to radius 0.5
_TAYLOR_TERMS = 8
_RADIUS = 0.5
# ladder sizing: ||L h||_inf <= RATE_CAP * w * h for softplus-bounded rates
_RATE_CAP = 32.0
_MAX_SQUARINGS = 24
_MAX_KERNEL_WIDTH = 8

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "phi_tables.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_WIDE_NOT_PORTED = ("phi_tables kernel takes float32 with 2 <= w <= {}; "
                    "got {} at w = {} (the wide-block kernel is ROADMAP.md "
                    "queue 2, kernel 2: phi_vectors_pallas_all)")


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
# the kernel
# ---------------------------------------------------------------------------


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: building csrc/phi_tables.cu needs "
                       "the CUDA toolkit")


def library_path() -> Path:
    """Where the built library lives: keyed by the source and flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libphi_tables_{key}.so"


def build_library() -> tuple[Path, float]:
    """Compile the kernel if its library is not built yet; returns the
    library path and the seconds the build took (0 when it was there).
    The compiler's register report is kept beside it as ``.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, seconds


_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()[0]))
        lib.phi_tables_f32.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.phi_tables_f32.restype = ctypes.c_int
        lib.phi_tables_error_string.argtypes = [ctypes.c_int]
        lib.phi_tables_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def phi_tables(L: torch.Tensor, binv, h_u, ladder: int, *,
               use_kernel: bool | None = None):
    """Tables for all (bucket, h) pairs.

    Args:
      L: (Bu, w, w, B) linear blocks, one slab per bucket, lanes last.
      binv: (U,) host int array, the bucket of each pair.
      h_u: (U,) host float array, the segment length of each pair.
      ladder: bound on each lane's squaring count (the max of
        :func:`ladder_len` over the pairs).
      use_kernel: None routes by device (kernel on CUDA, plain version on
        the CPU); False forces the plain version (comparisons only).
    Returns E (U, w, w, B), p1 (U, w, B), p2 (U, w, B).
    """
    if L.dim() != 4 or L.shape[1] != L.shape[2]:
        raise ValueError(f"L must be (Bu, w, w, B); got {tuple(L.shape)}")
    binv = np.asarray(binv)
    h_u = np.asarray(h_u)
    if binv.shape != h_u.shape or binv.ndim != 1:
        raise ValueError("binv and h_u must be (U,) arrays of one length")
    if len(binv) and (binv.min() < 0 or binv.max() >= L.shape[0]):
        raise ValueError("binv indexes past the buckets of L")
    if use_kernel is None:
        use_kernel = L.is_cuda
    if not use_kernel:
        return phi_tables_reference(L, binv, h_u, ladder)
    if not L.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    w, B = L.shape[1], L.shape[3]
    if L.dtype != torch.float32 or not 2 <= w <= _MAX_KERNEL_WIDTH:
        raise NotImplementedError(
            _WIDE_NOT_PORTED.format(_MAX_KERNEL_WIDTH, L.dtype, w))
    if not L.is_contiguous():
        raise ValueError("L must be contiguous")
    U = len(binv)
    # grid: (ceil(B / 128), U), lane index a 32-bit int
    if not (0 < U <= 65535 and 0 < B < 2 ** 31):
        raise ValueError(f"unsupported table size U={U}, B={B}")
    if not 0 <= int(ladder) <= _MAX_SQUARINGS:
        raise ValueError(f"ladder {ladder} outside [0, {_MAX_SQUARINGS}]")
    dev = L.device
    binv_d = torch.as_tensor(binv, dtype=torch.int32).to(dev)
    h_d = torch.as_tensor(h_u, dtype=torch.float32).to(dev)
    E = torch.empty((U, w, w, B), dtype=torch.float32, device=dev)
    p1 = torch.empty((U, w, B), dtype=torch.float32, device=dev)
    p2 = torch.empty((U, w, B), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):          # launch in L's device context
        rc = lib.phi_tables_f32(L.data_ptr(), binv_d.data_ptr(), h_d.data_ptr(),
                                E.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                                w, U, B, int(ladder),
                                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("phi_tables kernel launch failed: "
                           + lib.phi_tables_error_string(rc).decode())
    phi_tables.launches += 1
    return E, p1, p2


phi_tables.launches = 0
