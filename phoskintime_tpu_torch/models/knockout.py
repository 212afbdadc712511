"""In-silico knockout engine.

Counterpart of ``phoskintime_tpu/models/knockout.py`` (numpy only,
copied): knockouts are parameter-vector zeroings (transcription A=0,
translation C=0, phosphorylation all-or-per-site S_i=0) over the full
cartesian product of options, expressed as a (n_combos, n_params)
multiplier-mask matrix, so that the whole scan is one batch axis of the
exact solve.
"""

from __future__ import annotations

import itertools

import numpy as np


def apply_knockout(base_params: np.ndarray, knockout_targets: dict,
                   num_psites: int) -> np.ndarray:
    """Zero out parameters per the knockout spec (single combination)."""
    params = np.array(base_params, copy=True)
    if knockout_targets.get("transcription", False):
        params[0] = 0.0
    if knockout_targets.get("translation", False):
        params[2] = 0.0
    k = knockout_targets.get("phosphorylation", False)
    start, end = 4, 4 + num_psites
    if isinstance(k, bool) and k:
        params[start:end] = 0.0
    elif isinstance(k, (list, tuple)):
        for idx in k:
            if 0 <= idx < num_psites:
                params[start + idx] = 0.0
    return params


def generate_knockout_combinations(num_psites: int) -> list[dict]:
    """All (transcription x translation x phospho) combinations
    (2 * 2 * (2 + n) entries)."""
    phospho_options = [False, True] + [[i] for i in range(num_psites)]
    combos = []
    for trans, transl, phospho in itertools.product(
            [False, True], [False, True], phospho_options):
        combos.append({"transcription": trans, "translation": transl,
                       "phosphorylation": phospho})
    return combos


def knockout_mask_matrix(num_psites: int, n_params: int) -> tuple[np.ndarray, list[dict]]:
    """Batchable form: (n_combos, n_params) multiplicative masks.

    ``params[None] * masks`` yields every knockout parameter vector at once;
    feed through ``solve_ode_batched`` for the full scan in one program.
    """
    combos = generate_knockout_combinations(num_psites)
    masks = np.ones((len(combos), n_params))
    for i, ko in enumerate(combos):
        masks[i] = apply_knockout(np.ones(n_params), ko, num_psites)
    return masks, combos


def knockout_label(ko: dict) -> str:
    parts = []
    if ko.get("transcription"):
        parts.append("transcription")
    if ko.get("translation"):
        parts.append("translation")
    p = ko.get("phosphorylation")
    if isinstance(p, bool) and p:
        parts.append("phospho(all)")
    elif isinstance(p, (list, tuple)) and p:
        parts.append("phospho(" + ",".join(str(i + 1) for i in p) + ")")
    return " + ".join(parts) if parts else "wild-type"
