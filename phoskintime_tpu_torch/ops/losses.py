"""Robust losses, elementwise in (diff, pred, obs).

Counterpart of ``phoskintime_tpu/ops/losses.py``: eight losses selected by
an integer mode (0 sq, 1 huber, 2 pseudo-huber on logs, 3 log-cosh,
4 cauchy, 5 poisson-scaled MSE, 6 geman-mcclure, anything else
charbonnier).
"""

from __future__ import annotations

import torch

EPS = 1e-9


def sq(diff, pred=None, obs=None):
    return diff * diff


def huber(diff, pred=None, obs=None, delta=0.5):
    a = torch.abs(diff)
    return torch.where(a <= delta, 0.5 * diff * diff, delta * (a - 0.5 * delta))


def pseudo_huber_log(diff, pred, obs, delta=0.5):
    """Pseudo-Huber on the log-ratio residual log(pred) - log(obs); pred and
    obs are clamped to a positive floor first."""
    d = torch.log(torch.clamp(pred, min=EPS)) - torch.log(torch.clamp(obs, min=EPS))
    x = d / delta
    return (delta * delta) * (torch.sqrt(1.0 + x * x) - 1.0)


def log_cosh(diff, pred=None, obs=None):
    s = torch.abs(diff)
    return torch.where(s > 20.0, s - 0.69314718056,
                       torch.log(torch.cosh(torch.clamp(s, max=20.0))))


def cauchy(diff, pred=None, obs=None, c=1.0):
    return torch.log1p((diff / c) ** 2)


def poisson_scaled_mse(diff, pred, obs=None, eps=1e-6):
    return (diff * diff) / (torch.abs(pred) + eps)


def geman_mcclure(diff, pred=None, obs=None, delta=1.0):
    x2 = diff * diff
    return x2 / (x2 + delta * delta)


def charbonnier(diff, pred=None, obs=None, eps=1e-3):
    return torch.sqrt(diff * diff + eps * eps) - eps


_LOSSES = {0: sq, 1: huber, 2: pseudo_huber_log, 3: log_cosh, 4: cauchy,
           5: poisson_scaled_mse, 6: geman_mcclure}


def robust_loss(mode: int):
    """The elementwise loss for an integer loss mode."""
    return _LOSSES.get(int(mode), charbonnier)
