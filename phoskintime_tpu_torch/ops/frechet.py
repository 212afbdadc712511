"""Discrete Fréchet distance, batched.

Counterpart of ``phoskintime_tpu/ops/frechet.py``: the DP over the pairwise
L2 distance matrix with the max/min recurrence, over any leading batch
axes at once (the JAX package vmaps it over solutions x curves). One DP
serves short and long curves alike (JAX unrolls the short ones, n m <=
2048, and scans the long ones; both compute this recurrence); it runs row
by row, each cell a tensor op over the whole batch.
"""

from __future__ import annotations

import torch


def frechet_distance(true_coords: torch.Tensor, pred_coords: torch.Tensor) -> torch.Tensor:
    """Discrete Fréchet distance between curves (..., n, d) and (..., m, d),
    the leading axes broadcast; returns (...)."""
    dist = torch.sqrt(torch.sum(
        (true_coords[..., :, None, :] - pred_coords[..., None, :, :]) ** 2, dim=-1))
    n, m = dist.shape[-2:]
    prev = [dist[..., 0, 0]]
    for j in range(1, m):
        prev.append(torch.maximum(prev[j - 1], dist[..., 0, j]))
    for i in range(1, n):
        cur = [torch.maximum(prev[0], dist[..., i, 0])]
        for j in range(1, m):
            best = torch.minimum(torch.minimum(cur[j - 1], prev[j]), prev[j - 1])
            cur.append(torch.maximum(best, dist[..., i, j]))
        prev = cur
    return prev[-1]
