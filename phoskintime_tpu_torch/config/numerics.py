"""Device and dtype policy.

Counterpart of ``phoskintime_tpu/config/numerics.py``. The JAX package
flips a process-wide x64 switch; here the working dtype follows the
device a tensor lives on:

* CUDA runs float32 — the production precision, the one the propagator
  kernel is written for;
* the CPU runs float64 — parity with the JAX package at tight tolerance.

:class:`~phoskintime_tpu_torch.network.system.GlobalSystem` takes this
default; a caller that wants another dtype passes it explicitly. No
environment variable is read.
"""

from __future__ import annotations

import numpy as np
import torch


def working_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 elsewhere."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch float dtype (host-side arrays)."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def torch_dtype(dtype) -> torch.dtype:
    """The torch float dtype of a numpy or torch float dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
