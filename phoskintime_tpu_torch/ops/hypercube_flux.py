"""The combinatorial mechanism's edge flux over the hypercube of states.

Counterpart of ``hypercube_flux_pallas`` and ``hypercube_flux_reference``
in ``phoskintime_tpu/ops/pallas_kernels.py``:

* :func:`hypercube_flux` — the entry point. On a CUDA tensor it launches
  ``csrc/hypercube_flux.cu`` (float32 or float64) and adds one to
  ``hypercube_flux.launches``; on a CPU tensor, or with
  ``use_kernel=False``, it runs the plain version.
* :func:`hypercube_flux_reference` — the plain PyTorch version, site by
  site through the XOR neighbour map; ``hypercube_flux_reference.calls``
  counts its calls, so a run on the card can show it never took them.

The JAX package keeps its Pallas kernel off every path (it lost to the
XLA gather on its TPU). The port's model-2 RHS
(:meth:`~phoskintime_tpu_torch.network.rhs.PaddedRHS.batched`) calls this
entry on every evaluation, so on the card each RK45 or ESDIRK stage
launches the kernel once.

The flux is linear in X at fixed (S, E), and linear in (S, E) at fixed X,
so its tangent is the flux of the tangents. Under ``torch.func``
transforms (ESDIRK's Jacobian, ``jacfwd``) the kernel route runs through
:class:`FluxKernel`, whose forward-mode rule launches the kernel on the
tangent and whose ``vmap`` rule folds the batch into rows for one launch;
the Jacobian never falls back to the plain version. The route is chosen
by X alone: every transform the port applies is taken with respect to the
state, so X is wrapped whenever S or E is, and a wrapped S or E beside a
plain X has no data pointer for the direct launch, which then raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
from torch._C._functorch import is_functorch_wrapped_tensor

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
    hypercube_flux_reference.calls += 1
    return dX


hypercube_flux_reference.calls = 0


def _launch(X, S, E, smax: int) -> torch.Tensor:
    """One launch of ``csrc/hypercube_flux.cu`` on plain CUDA tensors."""
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


class FluxKernel(torch.autograd.Function):
    """The flux through ``impl`` (the kernel's launch; the tests pass the
    plain version) with the rules ``torch.func`` needs: the tangent of a
    flux bilinear in X and (S, E) is impl(dX, S, E) + impl(X, dS, dE), and
    a vmapped call folds its batch into rows for one call of ``impl``.
    Tangents are not materialized: an input without one (S and E in the
    Jacobian with respect to the state) costs no launch on zeros."""

    @staticmethod
    def forward(X, S, E, smax, impl):
        return impl(X, S, E, smax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        X, S, E, smax, impl = inputs
        ctx.save_for_forward(X, S, E)
        ctx.set_materialize_grads(False)
        ctx.smax, ctx.impl = smax, impl

    @staticmethod
    def jvp(ctx, dX, dS, dE, _smax, _impl):
        X, S, E = ctx.saved_tensors
        out = None
        if dX is not None:
            out = FluxKernel.apply(dX, S, E, ctx.smax, ctx.impl)
        if dS is not None or dE is not None:
            dS = torch.zeros_like(S) if dS is None else dS
            dE = torch.zeros_like(E) if dE is None else dE
            d_rates = FluxKernel.apply(X, dS, dE, ctx.smax, ctx.impl)
            out = d_rates if out is None else out + d_rates
        return torch.zeros_like(X) if out is None else out

    @staticmethod
    def vmap(info, in_dims, X, S, E, smax, impl):
        n = info.batch_size

        def rows(x, dim):
            x = x.unsqueeze(0).expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(-1, *x.shape[2:]).contiguous()

        out = FluxKernel.apply(rows(X, in_dims[0]), rows(S, in_dims[1]),
                               rows(E, in_dims[2]), smax, impl)
        return out.reshape(n, -1, out.shape[-1]), 0


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
    if is_functorch_wrapped_tensor(X):
        return FluxKernel.apply(X, S, E, smax, _launch)
    return _launch(X, S, E, smax)


hypercube_flux.launches = 0
