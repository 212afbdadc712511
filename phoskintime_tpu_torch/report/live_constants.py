"""The live explorer's numeric constants, each defined once.

Counterpart of ``phoskintime_tpu/report/live_constants.py``, with the same
values: the explorer (:mod:`phoskintime_tpu_torch.report.live_model`)
embeds a vanilla-JS forward model (Dormand-Prince RK45 and the four RHS
mechanisms) that reads every load-bearing constant as ``LMC.<name>`` from
the ``var LMC = {...};`` block :func:`js_constants_block` emits, so the
template holds no numeric literal of its own. Tests read the emitted block
back out of the HTML and hold it equal to this module.

The tableau is that of the reference's custom Dormand-Prince RK45
(``global_model/solvers.py``); the fold-change baselines are those of its
``global_model/simulate.py`` and of
:func:`phoskintime_tpu_torch.network.simulate.fold_changes`.
"""

from __future__ import annotations

import json

# Dormand-Prince RK45(4) tableau (A rows incl. the 5th-order b row as
# DP_A[6]; E = b5 - b4 error weights). Same values as the reference's
# solvers.py and ops/integrators.py.
DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
DP_E = [71 / 57600, 0, -71 / 16695, 71 / 1920, -17253 / 339200,
        22 / 525, -1 / 40]

# integrate(): step control
STEP_CAP = 4000          # max accepted+rejected steps per kinase segment
H_INIT_DIV = 8           # first trial step = segment length / this
ATOL = 1e-7              # error scale: ATOL + RTOL * max(|y|, |y5|)
RTOL = 1e-5
SAFETY = 0.9             # step factor = SAFETY * err^ERR_EXP
ERR_FLOOR = 1e-10        # err clamped up to this before the power
ERR_EXP = -0.2           # 1/(order+1) for the 4th-order error estimate
H_UP = 5.0               # max step growth per accept
H_DOWN = 0.2             # max step shrink per reject

# observables / fold changes
FC_EPS = 1e-12           # max(signal, eps)/max(base, eps)
PROT_BASE_T = 0.0        # protein/phospho FC baseline time
RNA_BASE_T = 4.0         # mRNA FC baseline time
SYNTH_EPS = 1e-6         # rational-Hill activation denominator epsilon

_SCALARS = {
    "STEP_CAP": STEP_CAP, "H_INIT_DIV": H_INIT_DIV, "ATOL": ATOL,
    "RTOL": RTOL, "SAFETY": SAFETY, "ERR_FLOOR": ERR_FLOOR,
    "ERR_EXP": ERR_EXP, "H_UP": H_UP, "H_DOWN": H_DOWN,
    "FC_EPS": FC_EPS, "PROT_BASE_T": PROT_BASE_T,
    "RNA_BASE_T": RNA_BASE_T, "SYNTH_EPS": SYNTH_EPS,
}


def constants_dict() -> dict:
    """All constants (scalars + tableau) as one JSON-able dict."""
    return dict(_SCALARS, DP_A=DP_A, DP_E=DP_E)


def js_constants_block() -> str:
    """The ``var LMC = {...};`` line the JS template embeds.

    ``json.dumps`` of Python floats round-trips exactly through
    ``JSON.parse``/JS number literals (both IEEE-754 doubles), so the JS
    arithmetic sees bit-identical constants to the Python mirror's.
    """
    return ("var LMC = " + json.dumps(constants_dict()) + ";\n"
            "var DP_A = LMC.DP_A, DP_E = LMC.DP_E;")
