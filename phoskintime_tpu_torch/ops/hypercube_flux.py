"""The combinatorial mechanism's edge flux over the hypercube of states.

Counterpart of ``hypercube_flux_pallas`` and ``hypercube_flux_reference``
in ``phoskintime_tpu/ops/pallas_kernels.py``:

* :func:`hypercube_flux` — the entry point. On a CUDA tensor it launches
  ``csrc/hypercube_flux.cu`` (float32 or float64) and adds one to
  ``hypercube_flux.launches``; on a CPU tensor, or with
  ``use_kernel=False``, it runs the plain version.
* :func:`hypercube_flux_reference` — the plain PyTorch version, site by
  site through the XOR neighbour map.

The JAX package keeps its Pallas kernel off every path (it lost to the
XLA gather on its TPU). The port's model-2 RHS
(:meth:`~phoskintime_tpu_torch.network.rhs.PaddedRHS.batched`) calls this
entry on every evaluation, so on the card each RK45 stage launches the
kernel once.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from phoskintime_tpu_torch.ops.cuda_build import CSRC, entry, launch_on

SOURCE = CSRC / "hypercube_flux.cu"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_MAX_SITES = 10                 # rows of up to 1024 states: one thread block


@lru_cache(maxsize=None)
def _xor_map(smax: int, device: torch.device):
    """(perm (smax, 2^smax) int64, bit (smax, 2^smax) int64): the
    neighbour m ^ 2^j of each state m across site j, and bit j of m."""
    m = np.arange(1 << smax)[None, :]
    j = np.arange(smax)[:, None]
    return (torch.as_tensor(m ^ (1 << j), device=device),
            torch.as_tensor((m >> j) & 1, device=device))


def hypercube_flux_reference(X: torch.Tensor, S: torch.Tensor, E: torch.Tensor,
                             smax: int) -> torch.Tensor:
    """Plain version of :func:`hypercube_flux`: for each site j, the
    neighbour of state m is m ^ 2^j; a set bit j gains S_j X[m ^ 2^j] and
    loses E X[m], a clear bit gains E X[m ^ 2^j] and loses S_j X[m]. The
    flows of every site are formed at once and summed site by site, in the
    JAX reference's order."""
    perm, bit = _xor_map(int(smax), X.device)
    bit = bit.to(X.dtype)
    Xx = X[:, perm]                                   # (B, smax, M)
    Sj = S[:, :, None]
    Ec = E[:, None, None]
    inflow = bit * Sj * Xx + (1 - bit) * Ec * Xx
    outflow = bit * Ec * X[:, None] + (1 - bit) * Sj * X[:, None]
    dX = torch.zeros_like(X)
    for j in range(smax):
        dX = dX + inflow[:, j] - outflow[:, j]
    return dX


def hypercube_flux(X: torch.Tensor, S: torch.Tensor, E: torch.Tensor, smax: int, *,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """Edge flux ``dX (B, M) = sum_j (inflow - outflow)`` across sites j.

    Args:
      X: (B, M) state values, M = 2^smax, already masked to valid states.
      S: (B, smax) per-site phospho rates, already masked to valid sites.
      E: (B,) dephospho rate per row.
      use_kernel: None routes by device (the kernel on CUDA, the plain
        version on the CPU); False forces the plain version (comparisons).
    """
    smax = int(smax)
    if X.dim() != 2 or X.shape[1] != 1 << smax:
        raise ValueError(f"X must be (B, 2^smax) = (B, {1 << smax}); got {tuple(X.shape)}")
    if tuple(S.shape) != (X.shape[0], smax) or tuple(E.shape) != (X.shape[0],):
        raise ValueError(f"S must be (B, smax) and E (B,); got {tuple(S.shape)}, "
                         f"{tuple(E.shape)}")
    if use_kernel is None:
        use_kernel = X.is_cuda
    if not use_kernel:
        return hypercube_flux_reference(X, S, E, smax)
    if not X.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    if X.dtype not in (torch.float32, torch.float64) or smax > _MAX_SITES:
        raise NotImplementedError(
            f"the hypercube_flux kernel takes float32 or float64 with at most "
            f"{_MAX_SITES} sites (one thread block a row); got {X.dtype}, smax {smax}")
    if not (S.dtype == E.dtype == X.dtype and S.device == E.device == X.device):
        raise ValueError("X, S and E must share a dtype and a device")
    if not (X.is_contiguous() and S.is_contiguous() and E.is_contiguous()):
        raise ValueError("X, S and E must be contiguous")
    out = torch.empty_like(X)
    if X.shape[0] == 0:
        return out
    name = "hypercube_flux_f32" if X.dtype == torch.float32 else "hypercube_flux_f64"
    fn, err = entry(SOURCE, name, _ARGTYPES)
    rc = launch_on(X.device, fn, X.data_ptr(), S.data_ptr(), E.data_ptr(), out.data_ptr(),
                   X.shape[0], smax)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: " + err(rc).decode())
    hypercube_flux.launches += 1
    return out


hypercube_flux.launches = 0
