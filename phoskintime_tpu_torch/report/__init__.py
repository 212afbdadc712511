"""Reporting layer: the HTML report and its table writer, the interactive
explorers (fits and knockouts, the Pareto front, the live re-simulating
model), the live fit monitor, the LaTeX emitters, the drawing layer
(``draw``: PNG, PDF and GIF without matplotlib), the per-gene and global
model's figures (``plotter``), the mechanism diagram (``diagram``) and the
dashboard (``dashboard``).

Counterpart of ``phoskintime_tpu/report``. Part 3 of ROADMAP.md queue 1
item 8d-figures still owes the optimization-network schematics
(``schematic``) and the kinopt/tfopt apps (``apps``): every name of theirs
that the JAX package's ``report`` exports raises ``NotImplementedError``
here.
"""

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

#: the modules part 3 of item 8d-figures owes and the names the JAX
#: package's ``report`` exports from them
FIGURE_PART3 = frozenset({"schematic", "apps", "render_kinopt_app", "render_tfopt_app"})


def __getattr__(name: str):
    if name in FIGURE_PART3:
        raise NotImplementedError(
            f"report.{name} draws figures that are not ported yet (ROADMAP.md queue 1 "
            "item 8d-figures, part 3)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
