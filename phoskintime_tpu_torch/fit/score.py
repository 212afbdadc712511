"""Composite fit score.

Counterpart of ``phoskintime_tpu/fit/score.py``:
score = delta*MSE + alpha*RMSE + beta*MAE + gamma*Var + mu*L2(params)/n
over the residuals |target - prediction| / target.size. Here the inputs
may carry leading lane axes; each lane is scored over its last axis.
"""

from __future__ import annotations

import torch

from phoskintime_tpu_torch.config.labels import future_times  # noqa: F401


def score_fit(params: torch.Tensor, target: torch.Tensor, prediction: torch.Tensor,
              alpha: float = 1.0, beta: float = 1.0, gamma: float = 1.0,
              delta: float = 1.0, mu: float = 1.0) -> torch.Tensor:
    residual = torch.abs(target - prediction) / target.shape[-1]
    mse = torch.sum(residual ** 2, dim=-1)
    rmse = torch.sqrt(torch.mean(residual ** 2, dim=-1))
    mae = torch.mean(residual, dim=-1)
    variance = torch.var(residual, dim=-1, correction=0)
    l2_norm = torch.linalg.vector_norm(params, dim=-1) / params.shape[-1]
    return delta * mse + alpha * rmse + beta * mae + gamma * variance + mu * l2_norm
