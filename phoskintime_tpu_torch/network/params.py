"""Softplus parameter packing: flat raw theta <-> physical parameter dict.

Counterpart of ``phoskintime_tpu/network/params.py``. The flat vector is
ordered [c_k, A_i, B_i, C_i, D_i, Dp_i, E_i, tf_scale] with a ``slices``
dict; positivity comes from softplus. Per-site Dp_i travels flat
(protein-major, valid sites only) and is re-padded to (N, Smax) on unpack.

:func:`unpack_params` is batched: thetas (P, n) -> a dict whose leaves
carry the leading population axis P (the JAX package vmaps instead).
"""

from __future__ import annotations

import numpy as np
import torch

PARAM_ORDER = ["c_k", "A_i", "B_i", "C_i", "D_i", "Dp_i", "E_i", "tf_scale"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), exactly x above 20 (the JAX package's threshold)."""
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(torch.clamp(x, max=20.0))))


def inv_softplus(y):
    """log(expm1(y)) on the host, floored at y = 1e-12; y above 20 maps to y."""
    y = np.maximum(np.asarray(y, float), 1e-12)
    return np.where(y > 20.0, y, np.log(np.expm1(y)))


def init_raw_params(defaults: dict, topo, bounds_config: dict,
                    custom_bounds: dict | None = None):
    """Flatten physical ``defaults`` into raw theta0 plus slices and
    raw-space bounds: returns (theta0, slices, xl, xu), numpy on the host.

    defaults: physical dict with Dp_i padded (N, Smax)."""
    from phoskintime_tpu_torch.network.system import flat_site_values

    custom_bounds = custom_bounds or {}
    vecs, slices, bl, bu = [], {}, [], []
    curr = 0
    for k in PARAM_ORDER:
        v = np.asarray(defaults[k], float)
        if k == "Dp_i":
            v = flat_site_values(topo, v)
        raw = np.atleast_1d(inv_softplus(v))
        vecs.append(raw)
        n = raw.shape[0]
        slices[k] = slice(curr, curr + n)
        curr += n
        lo, hi = custom_bounds[k] if k in custom_bounds else bounds_config[k]
        bl.extend([float(inv_softplus(lo))] * n)
        bu.extend([float(inv_softplus(hi))] * n)
    return np.concatenate(vecs), slices, np.asarray(bl), np.asarray(bu)


def _dp_gather(topo) -> tuple[np.ndarray, np.ndarray]:
    """Padded slot (i, j) -> flat Dp index; invalid slots point at the pad
    entry appended after the last site."""
    valid = topo.site_mask()
    flat = np.cumsum(valid.ravel()) - 1
    gather = np.where(valid.ravel(), flat, topo.total_sites)
    return gather.reshape(valid.shape), valid


def unpack_params(thetas: torch.Tensor, slices: dict, topo) -> dict:
    """Raw thetas (P, n) -> physical parameter dict with a leading P axis:
    c_k (P, K), A_i..E_i (P, N), Dp_i (P, N, Smax) zero-padded, tf_scale (P,)."""
    gather, valid = _dp_gather(topo)
    dev, dt = thetas.device, thetas.dtype
    dp_flat = softplus(thetas[:, slices["Dp_i"]])
    dp_flat = torch.cat([dp_flat, dp_flat.new_zeros((dp_flat.shape[0], 1))], 1)
    dp_pad = (dp_flat[:, torch.as_tensor(gather, device=dev)]
              * torch.as_tensor(valid, dtype=dt, device=dev))
    # the JAX package's key order: writers that walk the dict (the live
    # explorer's payload) emit it as it stands
    out = {k: softplus(thetas[:, slices[k]]) for k in ("c_k", "A_i", "B_i", "C_i", "D_i")}
    out["Dp_i"] = dp_pad
    out["E_i"] = softplus(thetas[:, slices["E_i"]])
    out["tf_scale"] = softplus(thetas[:, slices["tf_scale"]])[:, 0]
    return out
