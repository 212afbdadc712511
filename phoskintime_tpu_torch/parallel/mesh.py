"""Population sharding over ``torch.distributed``.

Counterpart of ``phoskintime_tpu/parallel/mesh.py``. The workload's
scaling axis is the candidate population: members are independent, so the
"mesh" is one axis over the ranks of a process group, each rank with its
own device. The programs are SPMD, as under JAX's mesh: every rank calls
the same function with the same arguments and seeds; where a function
takes a ``mesh``, the population's rows split into contiguous blocks of
P / n, each rank evaluates its own block on its own device, and the
results are gathered onto every rank, so that all later state (the GA's
survival, the histories, the picks) is the same on every rank. Only rank 0
writes files, checkpoints and logs; a stage that the JAX package does not
shard runs on rank 0 while the others wait, and its result is broadcast.

Start the ranks with ``torchrun --nproc_per_node N`` and call
:func:`initialize_distributed` first (NCCL between cards, gloo on the
CPU), then :func:`population_mesh`. A group made otherwise (two ranks on
one card over gloo, say) goes into a :class:`PopulationMesh` as it is.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class PopulationMesh:
    """One population axis over a process group: this rank's place in it
    and its device. ``group`` None is the default group."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def _global(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def block(self, P: int, what: str = "the population") -> slice:
        """This rank's rows of a P-row population; P must be a multiple of
        the mesh, as the JAX package's shardings require."""
        if P % self.size:
            raise ValueError(f"{what} ({P}) must be a multiple of the mesh size ({self.size})")
        n = P // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order, on every rank: the
        same bits on each. Gloo moves CUDA tensors in broadcasts and
        all-reduces only, so there each rank's block is broadcast in turn."""
        local = local.contiguous()
        if local.is_cuda and self.backend == "gloo":
            parts = [local if r == self.rank else torch.empty_like(local)
                     for r in range(self.size)]
            for r, part in enumerate(parts):
                dist.broadcast(part, src=self._global(r), group=self.group)
            return torch.cat(parts)
        if self.backend == "nccl":
            out = local.new_empty((self.size * local.shape[0], *local.shape[1:]))
            dist.all_gather_into_tensor(out, local, group=self.group)
            return out
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local, group=self.group)
        return torch.cat(parts)

    def broadcast(self, obj, device=None):
        """Rank 0's ``obj`` on every rank (pickled; its tensors cross on the
        host and land on ``device``, default this rank's)."""
        box = [_to_device(obj, "cpu") if self.is_root else None]
        if self.backend == "nccl":
            dist.broadcast_object_list(box, src=self._global(0), group=self.group,
                                       device=self.device)
        else:
            dist.broadcast_object_list(box, src=self._global(0), group=self.group)
        return obj if self.is_root else _to_device(box[0], device or self.device)


def _to_device(obj, device):
    """``obj`` with every tensor in its dicts, lists, tuples and
    dataclasses moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return type(obj)({k: _to_device(v, device) for k, v in obj.items()})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_device(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def population_mesh(n_devices: int | None = None) -> PopulationMesh | None:
    """A mesh over the first ``n_devices`` ranks (default: all) of the
    default process group, each rank on its current card (else the CPU);
    None where that is one rank or none has been initialised, as the JAX
    package's single-device case. Every rank calls it (a smaller group is
    made collectively); a rank outside the first ``n_devices`` gets None
    and computes on its own."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    n = world if n_devices is None else min(int(n_devices), world)
    if n <= 1:
        return None
    group = None if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    device = (torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
              else torch.device("cpu"))
    return PopulationMesh(group, rank, n, device)


def pad_to_devices(P: int, mesh) -> int:
    """Smallest population size >= P divisible by the mesh."""
    if mesh is None:
        return P
    return int(np.ceil(P / mesh.size) * mesh.size)


def pad_rows(X: np.ndarray, mesh) -> np.ndarray:
    """``X`` with copies of its last row appended up to a multiple of the
    mesh (``X`` itself where the mesh divides it or there is none)."""
    n = pad_to_devices(len(X), mesh)
    return X if n == len(X) else np.vstack([X, np.repeat(X[-1:], n - len(X), axis=0)])


def is_writer(mesh) -> bool:
    """Whether this rank writes files, checkpoints and logs: rank 0, or
    any rank without a mesh."""
    return mesh is None or mesh.is_root


def on_root(mesh, fn, device=None):
    """``fn()`` on rank 0 only, its result broadcast to the others, who wait
    for it (``device``: where its tensors land on them). Without a mesh,
    ``fn()``. An error on rank 0 is raised there and named on the others."""
    if mesh is None:
        return fn()
    if mesh.is_root:
        try:
            out = fn()
        except BaseException as exc:
            mesh.broadcast(("error", repr(exc)))
            raise
        mesh.broadcast(("ok", out))
        return out
    status, out = mesh.broadcast(None, device)
    if status == "error":
        raise RuntimeError(f"rank 0 failed: {out}")
    return out


def initialize_distributed() -> int:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on the card (after ``torch.cuda.set_device(
    LOCAL_RANK)``), gloo on the CPU. A no-op in a single process or where a
    group exists already. Returns the world size."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or not dist.is_available():
        return 1
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()
