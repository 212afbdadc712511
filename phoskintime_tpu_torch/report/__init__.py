"""Reporting layer, the half that draws no figure: the HTML report and its
table writer, the interactive explorers (fits and knockouts, the Pareto
front, the live re-simulating model), the live fit monitor and the LaTeX
emitters.

Counterpart of ``phoskintime_tpu/report`` less its figure half: the
matplotlib plot suite (``plotter``), the reaction diagrams (``diagram``,
``schematic``), the kinopt/tfopt apps (``apps``) and the dashboard
(``dashboard``) are not ported yet (ROADMAP.md queue 1 item 8d-figures),
and every name of theirs that the JAX package's ``report`` exports raises
``NotImplementedError`` here.
"""

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

#: the figure half's modules and the names the JAX package's ``report`` exports from them
FIGURE_HALF = frozenset({
    "plotter", "diagram", "schematic", "apps", "dashboard", "illustrate", "render_kinopt_app",
    "render_tfopt_app", "Plotter", "plot_convergence", "plot_parallel_coords_pareto",
    "plot_pareto_3d"})


def __getattr__(name: str):
    if name in FIGURE_HALF:
        raise NotImplementedError(
            f"report.{name} draws figures, which are not ported yet (ROADMAP.md queue 1 "
            "item 8d-figures)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
