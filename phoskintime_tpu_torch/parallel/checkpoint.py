"""Checkpoint and resume for long optimisation runs.

Counterpart of ``phoskintime_tpu/parallel/checkpoint.py``. One atomic
pickle holds the generation, the population (X, F) and, from the port's GA
loops, the whole loop state: ranks, niches, the host rng's state, the
device loop's ``torch.Generator`` state and the histories, so that a
resumed run continues the stream the interrupted one was drawing from.
:func:`save_sampler` and :func:`load_sampler` store a
:class:`~phoskintime_tpu_torch.ops.tpe.MOTPESampler`'s ask/tell history and
rng state the same way (the MOTPE fit and the hyperparameter scan).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def save_checkpoint(path: str, state: dict) -> str:
    """Atomic pickle write (tmp + rename)."""
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh, protocol=4)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> dict | None:
    """The stored state, or None where there is no file. Unpickles: load
    only checkpoints this program wrote."""
    if not os.path.exists(str(path)):
        return None
    with open(str(path), "rb") as fh:
        return pickle.load(fh)


class GACheckpointer:
    """Checkpoint callback of :func:`phoskintime_tpu_torch.ops.nsga.run_unsga3`
    and :func:`phoskintime_tpu_torch.ops.nsga_device.run_unsga3_device`,
    passed as their ``checkpoint``::

        ck = GACheckpointer("run.ckpt", every=10)
        res = run_unsga3(..., checkpoint=ck)   # resumes if run.ckpt holds a state

    Every ``every`` generations it stores the generation, X, F and the
    loop's state; :meth:`resume_state` hands that state back to a loop,
    which then continues from it. ``write=False`` reads a stored state but
    never writes (the ranks of a sharded run but rank 0).
    """

    def __init__(self, path: str, every: int = 10, write: bool = True):
        self.path = str(path)
        self.every = int(every)
        self.write = bool(write)
        self.state = load_checkpoint(self.path)

    def resume_state(self) -> dict | None:
        """The stored loop state, or None for a fresh run."""
        return None if self.state is None else self.state.get("loop")

    @property
    def start_gen(self) -> int:
        return 0 if self.state is None else int(self.state["gen"])

    def __call__(self, gen, X, F, loop: dict | None = None):
        if self.write and gen % self.every == 0:
            save_checkpoint(self.path, {"gen": gen, "X": np.asarray(X),
                                        "F": np.asarray(F), "loop": loop})


def save_sampler(path: str, sampler) -> str:
    """Store a MOTPE sampler's state (its told history and rng)."""
    return save_checkpoint(path, sampler.state_dict())


def load_sampler(path: str, sampler):
    """Load a stored state into ``sampler``; a missing file leaves it as
    it is. Returns the sampler."""
    st = load_checkpoint(path)
    if st is not None:
        sampler.load_state_dict(st)
    return sampler
