"""Per-gene estimation stack: batched LM multistart fitting, composite
scoring, Wald confidence intervals, Morris sensitivity, knockout scans,
cohort pipeline."""

from phoskintime_tpu_torch.fit.ci import confidence_intervals  # noqa: F401
from phoskintime_tpu_torch.fit.normest import (  # noqa: F401
    NormestResult,
    build_bounds,
    normest,
    normest_batch,
)
from phoskintime_tpu_torch.fit.pipeline import (  # noqa: F401
    GeneOutput,
    extract_gene_data,
    process_gene,
    run_model_pipeline,
)
from phoskintime_tpu_torch.fit.score import score_fit  # noqa: F401
from phoskintime_tpu_torch.fit.sensitivity import sensitivity_analysis  # noqa: F401
