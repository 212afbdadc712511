"""Per-gene kinetic models: distributive / successive / random mechanisms,
weight schemes, knockout engine, steady-state initialization."""

from phoskintime_tpu_torch.models.kinetics import (  # noqa: F401
    initial_condition,
    n_params,
    solve_ode,
    solve_ode_batched,
    state_dim,
)
