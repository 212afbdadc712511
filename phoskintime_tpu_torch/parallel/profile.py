"""Profiling and timing.

Counterpart of ``phoskintime_tpu/parallel/profile.py``: :func:`trace`
records a ``torch.profiler`` trace (the host, and the card where there is
one) and writes it as a Chrome trace; :func:`timed` is a wall-clock timer
that waits for the card's queued work before it stops. The JAX module's
persistent compilation cache has no counterpart: the port's kernels are
built once into ``phoskintime_tpu_torch/_build/`` and reused from there.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def _synchronize(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    elif device is None and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``with trace() as path: ...`` profiles the block (CPU, and CUDA
    where available) and writes ``<log_dir>/trace.json``; yields that
    path. The default directory is ``phoskintime_torch_trace`` in the
    system's temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "phoskintime_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        _synchronize(None)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def timed(label: str, logger=None, device=None, into: dict | None = None):
    """Wall-clock seconds of the block, ended by a synchronize of
    ``device`` (a CUDA device) or, with none given, of the card where CUDA
    is in use; logged (or printed) as ``[timing] <label>: <s>s`` and, with
    ``into``, added to ``into[label]`` (so that blocks of one label sum)."""
    t0 = time.perf_counter()
    yield
    _synchronize(device)
    seconds = time.perf_counter() - t0
    if into is not None:
        into[label] = into.get(label, 0.0) + seconds
    (logger.info if logger else print)(f"[timing] {label}: {seconds:.3f}s")
