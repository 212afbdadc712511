"""Checkpoint and resume for long optimisation runs.

Counterpart of ``phoskintime_tpu/parallel/checkpoint.py`` (its GA part:
the MOTPE sampler's ``save_sampler``/``load_sampler`` wait for
``ops/tpe.py``, ROADMAP.md queue 1 item 7.5). One atomic pickle holds the
generation, the population (X, F) and, from the port's GA loops, the whole
loop state: ranks, niches, the host rng's state, the device loop's
``torch.Generator`` state and the histories, so that a resumed run
continues the stream the interrupted one was drawing from.
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
    which then continues from it.
    """

    def __init__(self, path: str, every: int = 10):
        self.path = str(path)
        self.every = int(every)
        self.state = load_checkpoint(self.path)

    def resume_state(self) -> dict | None:
        """The stored loop state, or None for a fresh run."""
        return None if self.state is None else self.state.get("loop")

    @property
    def start_gen(self) -> int:
        return 0 if self.state is None else int(self.state["gen"])

    def __call__(self, gen, X, F, loop: dict | None = None):
        if gen % self.every == 0:
            save_checkpoint(self.path, {"gen": gen, "X": np.asarray(X),
                                        "F": np.asarray(F), "loop": loop})
