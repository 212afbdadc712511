"""Reporting layer: the HTML report and its table writer, the interactive
explorers (fits and knockouts, the Pareto front, the live re-simulating
model), the live fit monitor, the LaTeX emitters, the drawing layer
(``draw``: PNG, PDF and GIF without matplotlib), the per-gene and global
model's figures (``plotter``), the mechanism diagram (``diagram``), the
dashboard (``dashboard``), the optimization-network schematics
(``schematic``) and the kinopt/tfopt result-explorer apps (``apps``).

Counterpart of ``phoskintime_tpu/report``.
"""

from phoskintime_tpu_torch.report import apps, schematic  # noqa: F401
from phoskintime_tpu_torch.report.apps import render_kinopt_app, render_tfopt_app  # noqa: F401
from phoskintime_tpu_torch.report.dashboard import (  # noqa: F401
    load_dashboard_bundle,
    render_dashboard,
    run_dashboard,
    save_dashboard_bundle,
)
from phoskintime_tpu_torch.report.diagram import illustrate  # noqa: F401
from phoskintime_tpu_torch.report.html import create_report, table_html  # noqa: F401
from phoskintime_tpu_torch.report.interactive import (  # noqa: F401
    pareto_explorer_from_frames,
    write_interactive_explorer,
    write_pareto_explorer,
)
from phoskintime_tpu_torch.report.latexit import (  # noqa: F401
    dataframe_to_latex,
    figure_to_latex,
    write_latex_report,
)
from phoskintime_tpu_torch.report.live import LiveMonitor  # noqa: F401
from phoskintime_tpu_torch.report.live_model import write_live_model_explorer  # noqa: F401
from phoskintime_tpu_torch.report.plotter import (  # noqa: F401
    Plotter,
    plot_convergence,
    plot_parallel_coords_pareto,
    plot_pareto_3d,
)
