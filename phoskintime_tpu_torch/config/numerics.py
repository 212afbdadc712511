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

The entry points place the model on the card unless the caller asks for
the CPU (``device="cpu"``); :func:`resolve_device` raises where there is
no card rather than falling back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of quietly becoming the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default: pass device='cpu' to run on the CPU")
    return device


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
