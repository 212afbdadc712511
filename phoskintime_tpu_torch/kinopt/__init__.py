"""kinopt: kinase -> phosphosite weight optimization (local + evolutionary)."""

from phoskintime_tpu_torch.kinopt.kkt import KKTReport, kkt_check  # noqa: F401
from phoskintime_tpu_torch.kinopt.model import (  # noqa: F401
    KinoptProblem,
    build_problem,
    constraint_violations,
    estimated_series,
    kinopt_loss,
    predict,
)
from phoskintime_tpu_torch.kinopt.optimize import (  # noqa: F401
    KinoptResult,
    run_evolutionary,
    run_local,
)
