"""Inputs of the table kernels that ``chip_smoke.py`` and the tools share:
phase 3h's networks, whose width classes pass w = 17, and the augmented
matrices of the ``torch.linalg.matrix_exp`` yardstick. Imports numpy and
torch only, so that a tool can take it whichever checkout's package it
times."""

from __future__ import annotations

import numpy as np
import torch

# model 2 at mechanisms' default cap of 6 sites (width classes 2, 3, 33, 65),
# model 0 with a protein of 20 sites (w = 22) and model 2 with a protein of
# 7 sites (classes 2, 3, 5, 129), each cut to a few proteins:
# build_demo_network's arguments
XWIDE_NETWORKS = {"model2-6sites": dict(n_proteins=6, n_kinases=3, max_sites=6, model=2, seed=0),
                  "model0-20sites": dict(n_proteins=5, n_kinases=3, max_sites=20, model=0,
                                         seed=5),
                  "model2-7sites": dict(n_proteins=6, n_kinases=3, max_sites=7, model=2,
                                        seed=20)}


def augmented(L, binv, h_u) -> torch.Tensor:
    """(U*B, w+2, w+2) matrices [[L h, e0, 0], [0, 0, 1], [0, 0, 0]] whose
    exponential holds E, phi1(L h) e0 and phi2(L h) e0: the input of the
    library yardstick ``torch.linalg.matrix_exp``."""
    U, w, B = len(binv), L.shape[1], L.shape[3]
    h = torch.as_tensor(np.asarray(h_u), dtype=L.dtype, device=L.device)
    M = L.new_zeros((U, B, w + 2, w + 2))
    M[:, :, :w, :w] = (L[torch.as_tensor(np.asarray(binv, np.int64), device=L.device)]
                       * h[:, None, None, None]).permute(0, 3, 1, 2)
    M[:, :, 0, w] = 1.0
    M[:, :, w, w + 1] = 1.0
    return M.reshape(U * B, w + 2, w + 2)
