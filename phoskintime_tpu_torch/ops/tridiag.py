"""Tridiagonal (Thomas) solves, batched over rows.

Counterpart of ``phoskintime_tpu/ops/tridiag.py`` and of ``thomas_pallas``
in ``phoskintime_tpu/ops/pallas_kernels.py``:

* :func:`thomas_solve_batched` — the entry point. On a CUDA tensor it
  launches ``csrc/thomas.cu`` (float32 or float64) and adds one to
  ``thomas_solve_batched.launches``; on a CPU tensor, or with
  ``use_kernel=False``, it runs the plain version.
* :func:`thomas_solve_reference` — the plain PyTorch version, the sweeps
  over columns with every row at once.
* :func:`thomas_solve` — one system.

Every row is a system: ``a`` the lower diagonal (``a[:, 0]`` unused), ``b``
the main one, ``c`` the upper (``c[:, -1]`` unused), ``d`` the right-hand
side. A pivot smaller than 1e-300 in magnitude becomes +-1e-300, as in the
JAX package (in float32 that bound is 0, so the guard never fires there).
"""

from __future__ import annotations

import ctypes

import torch

from phoskintime_tpu_torch.ops.cuda_build import CSRC, entry

SOURCE = CSRC / "thomas.cu"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_TINY = 1e-300
_MAX_N = 64                     # csrc/thomas.cu keeps cp, dp in a per-thread array


def _safe(x: torch.Tensor) -> torch.Tensor:
    tiny = torch.full_like(x, _TINY)
    return torch.where(torch.abs(x) < _TINY, torch.where(x < 0, -tiny, tiny), x)


def thomas_solve_reference(a, b, c, d) -> torch.Tensor:
    """Plain version of :func:`thomas_solve_batched`: (B, n) -> x (B, n)."""
    n = a.shape[1]
    denom = _safe(b[:, 0])
    cp, dp = [c[:, 0] / denom], [d[:, 0] / denom]
    for i in range(1, n):
        denom = _safe(b[:, i] - a[:, i] * cp[-1])
        cp.append(c[:, i] / denom)
        dp.append((d[:, i] - a[:, i] * dp[-1]) / denom)
    xs = [dp[-1]]
    for i in range(n - 2, -1, -1):
        xs.append(dp[i] - cp[i] * xs[-1])
    return torch.stack(xs[::-1], dim=1)


def thomas_solve_batched(a, b, c, d, *, use_kernel: bool | None = None) -> torch.Tensor:
    """Solve the tridiagonal systems of the rows of (B, n) tensors.

    ``use_kernel``: None routes by device (the kernel on CUDA, the plain
    version on the CPU); False forces the plain version (comparisons)."""
    if not (a.dim() == 2 and a.shape == b.shape == c.shape == d.shape):
        raise ValueError("a, b, c, d must be (B, n) of one shape; got "
                         f"{[tuple(v.shape) for v in (a, b, c, d)]}")
    if use_kernel is None:
        use_kernel = a.is_cuda
    if not use_kernel:
        return thomas_solve_reference(a, b, c, d)
    if not a.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    B, n = a.shape
    if a.dtype not in (torch.float32, torch.float64) or not 1 <= n <= _MAX_N:
        raise NotImplementedError(
            f"the thomas kernel takes float32 or float64 chains of 1 to {_MAX_N} "
            f"unknowns; got {a.dtype}, n = {n}")
    if any(v.dtype != a.dtype or v.device != a.device for v in (b, c, d)):
        raise ValueError("a, b, c, d must share a dtype and a device")
    if not all(v.is_contiguous() for v in (a, b, c, d)):
        raise ValueError("a, b, c, d must be contiguous")
    x = torch.empty_like(a)
    if B == 0:
        return x
    name = "thomas_f32" if a.dtype == torch.float32 else "thomas_f64"
    fn, err = entry(SOURCE, name, _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), x.data_ptr(),
                B, n, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: " + err(rc).decode())
    thomas_solve_batched.launches += 1
    return x


thomas_solve_batched.launches = 0


def thomas_solve(a, b, c, d) -> torch.Tensor:
    """One tridiagonal system: a, b, c, d (n,) -> x (n,)."""
    return thomas_solve_batched(a[None], b[None], c[None], d[None])[0]
