"""Analyses of fitted models: mechanism comparison and selection, global
knockouts, accumulator detection, functional-influence sweeps, mechanistic
discovery (refractory period, lag, saturation, feedback gain), post-fit
indicators, the kinopt/tfopt network readouts and tools (subnetworks,
curve similarity and clustering, their figures) and the thermal variant.

Counterpart of ``phoskintime_tpu/analysis`` with the HTML writers of its
influence and mechanism modules (the time-slider network, the global
knockout explorer, ``mechanism_selection.html``), the mechanism overlays,
the kinopt/tfopt fit panels (``fitpanels``), the readout figures and the
port's own PCA and t-SNE (``embed``).
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
from phoskintime_tpu_torch.analysis.network_tools import (  # noqa: F401
    analyze_tf_kin_counts,
    cluster_curves,
    curve_similarity_matrix,
    export_subnetwork,
    kinopt_network_readout,
    kinopt_signal_readout,
    map_priors,
    plot_breadth_vs_load,
    plot_identity_band,
    plot_network_dag,
    plot_signal_readout,
    temporal_sensitivity_heatmap,
    tfopt_network_readout,
    tfopt_signal_readout,
)
from phoskintime_tpu_torch.analysis.postfit import (  # noqa: F401
    goodness_of_fit,
    optimization_performance,
    residual_summary,
)
from phoskintime_tpu_torch.analysis.thermal import (  # noqa: F401
    compare_thermal_standard,
    folded_fraction,
    thermalize,
)
