"""Host-side IO without pandas: the CSV reader and column tables, data
loading and scaling, raw-data preprocessing, and the result tables
(``io/export.py``, imported from there: its figure writers wait for
ROADMAP.md queue 1 item 8d-figures)."""

from phoskintime_tpu_torch.io.load import (  # noqa: F401
    explode_kinase_sets,
    load_data,
    process_and_scale_raw_data,
    read_table,
)
from phoskintime_tpu_torch.io.preprocess import (  # noqa: F401
    format_site,
    process_collecttri,
    process_msgauss,
    process_msgauss_std,
    run_cleanup,
)
