"""tfopt: TF -> mRNA weight optimization (local + evolutionary)."""

from phoskintime_tpu_torch.tfopt.model import (  # noqa: F401
    TfoptProblem,
    predict,
    tfopt_loss,
    violation_sq,
)
from phoskintime_tpu_torch.tfopt.optimize import (  # noqa: F401
    TfoptResult,
    run_evolutionary,
    run_local,
)
