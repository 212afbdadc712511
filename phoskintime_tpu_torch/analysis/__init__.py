"""Analyses of fitted models: mechanism comparison and selection, global
knockouts, accumulator detection, functional-influence sweeps, mechanistic
discovery (refractory period, lag, saturation, feedback gain), post-fit
indicators and the kinopt/tfopt network readouts.

Counterpart of ``phoskintime_tpu/analysis`` with the HTML writers of its
influence and mechanism modules (the time-slider network, the global
knockout explorer, ``mechanism_selection.html``) and the mechanism
overlays; ``thermal.py``, ``fitpanels.py``, the rest of
``network_tools.py`` and their figures wait for ROADMAP.md queue 1 item
8d-figures, part 2.
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
from phoskintime_tpu_torch.analysis.network_tools import (  # noqa: F401
    kinopt_signal_readout,
    tfopt_signal_readout,
)
from phoskintime_tpu_torch.analysis.postfit import (  # noqa: F401
    goodness_of_fit,
    optimization_performance,
    residual_summary,
)
