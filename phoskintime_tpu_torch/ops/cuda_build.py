"""Build and bind the port's hand-written CUDA kernels.

Each source in :data:`SOURCES` is compiled with ``nvcc`` for ``sm_90a`` on
first use (one ``nvcc`` per source, or per part of a source in
:data:`PARTS`, all started together), into
``phoskintime_tpu_torch/_build/`` under a name keyed by a hash of the
source and flags, and bound with ``ctypes`` through a plain C interface:
every library exports its launch functions (a part's, those whose names
end in ``_<part>``) and ``<stem>_error_string``.
The sources share the headers ``csrc/*.cuh``, whose bytes are part of
every library's key.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = tuple(CSRC / f"{stem}.cu" for stem in (
    "phi_tables", "phi_tables_wide", "phi_tables_xwide", "phi_tables_stream", "etd2rk_scan",
    "hypercube_flux", "thomas", "sq_chain"))
# sources built in parts, {stem: ((part, nvcc flag), ...)}: the scan
# kernels, the longest compile, one library a type
PARTS = {"etd2rk_scan": (("f32", "-DETD2RK_SCAN_TYPES=1"), ("f64", "-DETD2RK_SCAN_TYPES=2"))}
BUILD_DIR = _PKG / "_build"
# dynamic shared memory one thread block may opt into on the H100 (227 KB)
MAX_SHARED_BYTES = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: building the kernels in csrc/ needs "
                       "the CUDA toolkit")


def parts(source: Path) -> tuple:
    """((part, nvcc flags), ...) of ``source``: ("", ()) where it is built
    whole."""
    return tuple((part, (flag,)) for part, flag in PARTS.get(source.stem, ())) or (("", ()),)


def library_path(source: Path, part: str = "") -> Path:
    """Where the library of ``source`` (of its ``part``) lives: keyed by the
    source, the shared headers and the flags."""
    flags = dict(parts(source)).get(part, ())
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(NVCC_FLAGS + flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}{'_' * bool(part)}{part}_{key}.so"


def build_libraries() -> dict:
    """Compile every kernel source (part) whose library is not built yet,
    one ``nvcc`` each, all started together. Returns {library path:
    seconds its build took (0 when it was there)}. The compiler's register
    report is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, jobs = {}, []
    t0 = time.perf_counter()
    for src in SOURCES:
        for part, flags in parts(src):
            lib = library_path(src, part)
            if lib.exists():
                out[lib] = 0.0
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((lib, tmp, proc))
    failed = []
    for lib, tmp, proc in jobs:
        log = proc.communicate()[0]
        out[lib] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_ENTRIES: dict = {}


def entry(source: Path, name: str, argtypes: list):
    """(launch function, error-string function) of the C entry ``name`` in
    the library built from ``source`` (the part that ``name`` ends in),
    which returns a CUDA error code; builds the libraries if needed."""
    if name not in _ENTRIES:
        part = next((p for p, _ in parts(source) if p and name.endswith("_" + p)), "")
        lib_path = library_path(source, part)
        if not lib_path.exists():
            build_libraries()
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{source.stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _ENTRIES[name] = (fn, err)
    return _ENTRIES[name]


def launch_on(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)``: a C launch entry called with ``dev``'s current
    stream as a raw handle, in ``dev``'s context (not entered where ``dev``
    is the current device already). Returns the entry's code."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)
