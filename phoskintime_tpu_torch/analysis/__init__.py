"""Analyses of fitted models: mechanism comparison and selection, global
knockouts, accumulator detection, functional-influence sweeps, mechanistic
discovery (refractory period, lag, saturation, feedback gain), post-fit
indicators and the kinopt/tfopt network readouts.

Counterpart of ``phoskintime_tpu/analysis`` with the HTML writers of its
influence and mechanism modules (the time-slider network, the global
knockout explorer, ``mechanism_selection.html``), the mechanism overlays,
the kinopt/tfopt fit panels (``fitpanels``), the readout figures and the
port's own PCA and t-SNE (``embed``); ``thermal.py`` and the rest of
``network_tools.py`` wait for ROADMAP.md queue 1 item 8d-figures, part 3.
"""

from phoskintime_tpu_torch.analysis.influence import (  # noqa: F401
    cascade_from_seed,
    export_global_knockout_explorer,
    export_influence_sweep,
    influence_edges_sweep,
    knockout_scenarios,
    state_sweep,
    write_influence_html,
)
from phoskintime_tpu_torch.analysis.insights import (  # noqa: F401
    feedback_gain,
    kinetic_lag,
    refractory_period,
    run_mechanistic_discovery,
    transcriptional_saturation,
)
from phoskintime_tpu_torch.analysis.mechanisms import (  # noqa: F401
    MECHANISMS,
    compare_mechanisms,
    find_protein_accumulators,
    fit_all_mechanisms,
    knockout_scan_global,
)
from phoskintime_tpu_torch.analysis.fitpanels import (  # noqa: F401
    fit_analysis_from_workbook,
    kinopt_fit_analysis,
    tfopt_fit_analysis,
)
from phoskintime_tpu_torch.analysis import network_tools as _network_tools
from phoskintime_tpu_torch.analysis.network_tools import (  # noqa: F401
    kinopt_signal_readout,
    plot_signal_readout,
    tfopt_signal_readout,
)
from phoskintime_tpu_torch.analysis.postfit import (  # noqa: F401
    goodness_of_fit,
    optimization_performance,
    residual_summary,
)

#: the names the JAX package's ``analysis`` exports that part 3 of item
#: 8d-figures ports: thermal.py's and the rest of network_tools.py's
FIGURE_PART3 = frozenset({"compare_thermal_standard", "folded_fraction", "thermalize",
                          *_network_tools.PENDING})


def __getattr__(name: str):
    if name in FIGURE_PART3:
        raise NotImplementedError(f"analysis.{name} is not ported yet (ROADMAP.md queue 1 item "
                                  "8d-figures, part 3)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
