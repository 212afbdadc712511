"""Long-run support: checkpoint and resume; population sharding over
``torch.distributed`` (:mod:`phoskintime_tpu_torch.parallel.mesh`)."""

from phoskintime_tpu_torch.parallel.mesh import (PopulationMesh, initialize_distributed,
                                                 pad_to_devices, population_mesh)

__all__ = ["PopulationMesh", "initialize_distributed", "pad_to_devices", "population_mesh"]
