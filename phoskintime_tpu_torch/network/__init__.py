"""Global network model: topology, system, RHS, the batched ETD2RK
integrator and the population objective.

Import the submodules directly (``phoskintime_tpu_torch.network.expo``);
this package ``__init__`` stays empty so importing one module loads only
what it needs."""
