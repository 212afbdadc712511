"""Parameter-name and state-label helpers of the per-gene models.

Counterpart of ``phoskintime_tpu/config/labels.py`` (numpy and itertools
only, copied): the random (combinatorial) per-gene model has
4 + n + (2^n - 1) parameters (A, B, C, D, S_1..S_n, one degradation rate per
non-empty site subset); the distributive and successive models have
4 + 2n (A, B, C, D, S_i, D_i).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

# the protein time grid, minutes (the JAX package reads it from its config
# loader, PhosKinConfig.time_points_protein; the loader is not ported yet)
TIME_POINTS_PROTEIN = (0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0,
                       60.0, 120.0, 240.0, 480.0, 960.0)


def get_number_of_params_rand(num_psites: int) -> int:
    return 4 + num_psites + (2 ** num_psites - 1)


def get_number_of_params_ds(num_psites: int) -> int:
    return 4 + 2 * num_psites


def subset_labels(num_psites: int) -> list[str]:
    """Non-empty subsets of sites ordered by cardinality, then
    lexicographically (the order of ``itertools.combinations``)."""
    labels = []
    for k in range(1, num_psites + 1):
        for comb in combinations(range(1, num_psites + 1), k):
            labels.append("".join(str(c) for c in comb))
    return labels


def get_param_names_rand(num_psites: int) -> list[str]:
    names = ["A", "B", "C", "D"]
    names += [f"S{i + 1}" for i in range(num_psites)]
    names += [f"D{lbl}" for lbl in subset_labels(num_psites)]
    return names


def get_param_names_ds(num_psites: int) -> list[str]:
    names = ["A", "B", "C", "D"]
    names += [f"S{i + 1}" for i in range(num_psites)]
    names += [f"D{i + 1}" for i in range(num_psites)]
    return names


def generate_labels_rand(num_psites: int) -> list[str]:
    """State labels [R, P, P_subset...] of the random model."""
    return ["mRNA (R)", "Protein (P)"] + [f"P{lbl}" for lbl in subset_labels(num_psites)]


def generate_labels_ds(num_psites: int) -> list[str]:
    return ["mRNA (R)", "Protein (P)"] + [f"P{i + 1}" for i in range(num_psites)]


def get_param_names(model: str, num_psites: int) -> list[str]:
    return get_param_names_rand(num_psites) if model == "randmod" else get_param_names_ds(num_psites)


def generate_labels(model: str, num_psites: int) -> list[str]:
    return generate_labels_rand(num_psites) if model == "randmod" else generate_labels_ds(num_psites)


def future_times(n_new: int, ratio: float | None = None, tp=None) -> np.ndarray:
    """Extend a time grid (default: the protein grid) by ``n_new`` points,
    each gap the previous one times ``ratio`` (inferred from the last two
    points when None)."""
    times = list(np.asarray(TIME_POINTS_PROTEIN if tp is None else tp, float))
    if ratio is None:
        ratio = times[-1] / times[-2]
    for _ in range(n_new):
        times.append(times[-1] * ratio)
    return np.asarray(times)
