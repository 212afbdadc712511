"""Host-side IO without pandas: the CSV reader and column tables, data
loading and scaling, raw-data preprocessing, and the result writers
(``io/export.py``, imported from there: the tables, and the figures, PDF
and animation drawn by :mod:`phoskintime_tpu_torch.report.draw`)."""

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
