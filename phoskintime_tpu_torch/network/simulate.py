"""Observables and fold changes of a simulated trajectory.

Counterpart of ``extract_observables`` and ``fold_changes`` in
``phoskintime_tpu/network/simulate.py``. The RK45 ``simulate`` there is
the oracle integrator, ROADMAP queue 1 item "Oracle integrators"; the
port's objective runs the ETD2RK path of ``network/expo.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.network.rhs import check_model

EPS = 1e-12


class Observables(NamedTuple):
    R: torch.Tensor     # (..., T, N) mRNA
    TOT: torch.Tensor   # (..., T, N) total protein
    PHO: torch.Tensor   # (..., T, N, Smax) per-site phospho signal


def extract_observables(system, Y_flat: torch.Tensor) -> Observables:
    """Raw observables from a padded trajectory (..., T, N*width); any
    leading axes (a population) carry through. Model 2: the total is the
    sum over valid states, and site j's signal sums the states with bit
    j set."""
    topo = system.topo
    check_model(topo.model)
    Y = Y_flat.reshape(*Y_flat.shape[:-1], topo.N, topo.width)
    rhs = system.rhs
    if topo.model == 2:
        X = Y[..., 1:] * rhs.state_mask.to(Y.dtype)
        PHO = torch.einsum("...nm,jm->...nj", X, rhs.bits.to(Y.dtype))
        return Observables(Y[..., 0], X.sum(-1), PHO)
    sites = Y[..., 2:] * rhs.site_mask.to(Y.dtype)
    return Observables(Y[..., 0], Y[..., 1] + sites.sum(-1), sites)


def fold_changes(obs: Observables, times, t0_prot=0.0, t0_rna=4.0, t0_pho=0.0):
    """Fold changes of one trajectory (T leading) against the baseline
    time points: returns (fc_rna, fc_protein, fc_phospho)."""
    times = np.asarray(times, float)
    base = lambda t0: int(np.argmin(np.abs(times - t0)))

    def fc(sig, b):
        return torch.clamp(sig, min=EPS) / torch.clamp(sig[b][None], min=EPS)

    return (fc(obs.R, base(t0_rna)), fc(obs.TOT, base(t0_prot)),
            fc(obs.PHO, base(t0_pho)))
