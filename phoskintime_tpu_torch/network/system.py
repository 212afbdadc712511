"""GlobalSystem: topology + kinase input + the RHS tensors on one device.

Counterpart of ``phoskintime_tpu/network/system.py``. Parameters are a
plain dict of tensors (physical space):
c_k (K,), A_i/B_i/C_i/D_i/E_i (N,), Dp_i (N, Smax) padded, tf_scale ();
the batched paths carry a leading population axis on every leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phoskintime_tpu_torch.config.numerics import (DEFAULT_DEVICE,
                                                   resolve_device,
                                                   working_dtype)
from phoskintime_tpu_torch.network.rhs import PaddedRHS
from phoskintime_tpu_torch.network.topology import NetworkTopology


def default_params(topo: NetworkTopology, dtype=np.float64) -> dict:
    """Neutral defaults (all ones) as host numpy arrays, Dp padded."""
    return {
        "c_k": np.ones(topo.K, dtype),
        "A_i": np.ones(topo.N, dtype),
        "B_i": np.ones(topo.N, dtype),
        "C_i": np.ones(topo.N, dtype),
        "D_i": np.ones(topo.N, dtype),
        "Dp_i": np.ones((topo.N, topo.max_sites), dtype),
        "E_i": np.ones(topo.N, dtype),
        "tf_scale": dtype(1.0),
    }


def flat_site_values(topo: NetworkTopology, padded: np.ndarray) -> np.ndarray:
    """(N, Smax) padded per-site values -> flat (total_sites,) order."""
    return np.asarray(padded)[topo.site_mask()]


@dataclasses.dataclass
class GlobalSystem:
    """Static topology, kinase input and default y0, with the RHS tensors
    made once at ``dtype`` on ``device`` (default: the card, where the
    working dtype is float32; ``device="cpu"`` works at float64). Host
    inputs (Kmat, grid, y0) stay float64 numpy."""

    topo: NetworkTopology
    kin_grid: np.ndarray      # protein timepoint grid (bucket boundaries)
    Kmat: np.ndarray          # (K, len(grid))
    custom_y0: np.ndarray | None = None
    dtype: torch.dtype | None = None      # None: working_dtype(device)
    device: torch.device | str = DEFAULT_DEVICE

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.dtype is None:
            self.dtype = working_dtype(self.device)
        self.rhs = PaddedRHS(self.topo, self.Kmat, dtype=self.dtype,
                             device=self.device)

    def y0(self) -> np.ndarray:
        """Padded (N, width) initial state: R = 1, then P0 = 1 and the
        valid phospho slots 0.01 (models 0/1), or the unphosphorylated
        state X_0 = 1 and the valid states X_1.. 0.01 (model 2)."""
        if self.custom_y0 is not None:
            return np.array(self.custom_y0, dtype=float, copy=True)
        topo = self.topo
        Y = np.zeros((topo.N, topo.width))
        Y[:, 0] = 1.0
        Y[:, 1] = 1.0
        if topo.model == 2:
            Y[:, 2:] = 0.01 * topo.state_mask()[:, 1:]
        else:
            Y[:, 2:] = 0.01 * topo.site_mask()
        return Y

    def rhs_flat(self, params):
        """Bucketed RHS of one member for the integrator: (t, y_flat, jb) -> dy."""
        return lambda t, y, jb: self.rhs(t, y, jb, params)

    def rhs_batched(self, params_b, use_kernel: bool | None = None):
        """Bucketed RHS of a population for the batched integrator:
        (t (P,), y (P, N*width), jb (P,)) -> dy (P, N*width); ``use_kernel``
        goes to the model-2 edge flux."""
        return lambda t, y, jb: self.rhs.batched(t, y, jb, params_b, use_kernel)
