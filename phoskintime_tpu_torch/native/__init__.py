"""Native (C++) host bookkeeping for the GA, loaded with ctypes.

The port's counterpart of ``phoskintime_tpu/native``: its own copy of
``nsga_core.cpp`` (the non-dominated sort, NSGA-II crowding, NSGA-III
association and the 3-objective hypervolume contributions), built with
``g++`` on first use into the port's ``_build/`` under a name keyed by the
source, and bound with ctypes. This is host code beside the device
kernels, not one of them. Where no compiler or library is available each
function returns None and the caller takes its numpy path, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nsga_core.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")


class _Loader:
    """The library, built and loaded at most once per process."""

    def __init__(self):
        self.lib = None
        self.tried = False

    def library_path(self) -> Path:
        key = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"libnsga_core_{key}.so"

    def _build(self, path: Path) -> bool:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        os.replace(tmp, path)          # atomic: concurrent builds race safely
        return True

    def get(self):
        if self.tried:
            return self.lib
        self.tried = True
        path = self.library_path()
        if not path.exists() and not self._build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.nd_sort.restype = ctypes.c_int
        lib.nd_sort.argtypes = [f64, ctypes.c_int, ctypes.c_int, i32]
        lib.crowding.restype = None
        lib.crowding.argtypes = [f64, ctypes.c_int, ctypes.c_int, i32, ctypes.c_int, f64]
        lib.associate.restype = None
        lib.associate.argtypes = [f64, ctypes.c_int, ctypes.c_int, f64, ctypes.c_int, i32, f64]
        lib.hv3d_contrib.restype = None
        lib.hv3d_contrib.argtypes = [f64, ctypes.c_int, f64, f64]
        lib.hv3d_one_contrib.restype = ctypes.c_double
        lib.hv3d_one_contrib.argtypes = [f64, ctypes.c_int, ctypes.c_int, f64]
        self.lib = lib
        return lib


_LOADER = _Loader()


def get_lib():
    """The loaded native library, or None when unavailable."""
    return _LOADER.get()


def nd_sort_ranks(F: np.ndarray) -> np.ndarray | None:
    """(n,) int32 front rank per solution, or None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    F = np.ascontiguousarray(F, np.float64)
    n, m = F.shape
    ranks = np.empty(n, np.int32)
    lib.nd_sort(F, n, m, ranks)
    return ranks


def associate_native(Fn: np.ndarray, unit_dirs: np.ndarray):
    """(niche (n,) int32, distance (n,)) of each row's closest reference
    line, or None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    Fn = np.ascontiguousarray(Fn, np.float64)
    U = np.ascontiguousarray(unit_dirs, np.float64)
    niche = np.empty(Fn.shape[0], np.int32)
    dist = np.empty(Fn.shape[0], np.float64)
    lib.associate(Fn, Fn.shape[0], Fn.shape[1], U, U.shape[0], niche, dist)
    return niche, dist


def crowding_native(F: np.ndarray, idx: np.ndarray) -> np.ndarray | None:
    """NSGA-II crowding distance of the rows ``idx`` of F (n, m) as one
    front (1e300 where numpy has inf), or None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    F = np.ascontiguousarray(F, np.float64)
    idx = np.ascontiguousarray(idx, np.int32)
    if len(idx) and (idx.min() < 0 or idx.max() >= F.shape[0]):
        raise IndexError("crowding_native: idx out of range")
    out = np.empty(len(idx), np.float64)
    lib.crowding(F, F.shape[0], F.shape[1], idx, len(idx), out)
    return out


def _check_3obj(F: np.ndarray, ref: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    F = np.ascontiguousarray(F, np.float64)
    ref = np.ascontiguousarray(ref, np.float64)
    if F.ndim != 2 or F.shape[1] != 3 or ref.shape != (3,):
        raise ValueError(f"expected F (n, 3) and ref (3,); got {F.shape}, {ref.shape}")
    return F, ref


def hv3d_contrib_native(F: np.ndarray, ref: np.ndarray) -> np.ndarray | None:
    """Leave-one-out 3-objective hypervolume contributions (exact), or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    F, ref = _check_3obj(F, ref)
    out = np.empty(len(F), np.float64)
    lib.hv3d_contrib(F, len(F), ref, out)
    return out


def hv3d_one_contrib_native(F: np.ndarray, i: int, ref: np.ndarray) -> float | None:
    """Exact exclusive hypervolume of point ``i`` of F (n, 3) w.r.t. ref,
    O(n log n): the single-point refresh behind SMS-EMOA's lazy-greedy
    survival. None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    F, ref = _check_3obj(F, ref)
    if not 0 <= int(i) < len(F):
        raise IndexError(f"hv3d_one_contrib_native: point {i} of {len(F)}")
    return float(lib.hv3d_one_contrib(F, len(F), int(i), ref))
