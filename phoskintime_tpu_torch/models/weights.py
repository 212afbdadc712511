"""Per-gene fitting weight (sigma) schemes.

Counterpart of ``phoskintime_tpu/models/weights.py`` (numpy only, copied):
17 named weighting schemes over the stacked target vector [rna(9),
protein(14), sites(14*n)], an "early emphasis" kernel, and the MS-Gaussian
measurement-std weights (``uncertainties_from_data``) when the caller passes
them.

As in the JAX package, the time-index schemes tile ``num_psites + 1``
blocks (protein and each site), so every scheme has the target's length;
all schemes are host arrays, computed once per gene, that feed the batched
LM as per-residual sigmas.
"""

from __future__ import annotations

import numpy as np

N_RNA = 9  # RNA timepoints precede the protein/site blocks in the target


def early_emphasis(pr_data: np.ndarray, p_data: np.ndarray,
                   time_points: np.ndarray, num_psites: int) -> np.ndarray:
    """Early-timepoint emphasis weights (reference weights.py:10-76).

    Returns a vector of length ``n_times * (1 + num_psites)``:
    protein weights first, then per-site weights.
    """
    p_data = np.atleast_2d(np.asarray(p_data, float))
    pr_data = np.atleast_2d(np.asarray(pr_data, float))
    n_times = len(time_points)

    time_diffs = np.zeros(n_times)
    time_diffs[1:] = np.diff(np.asarray(time_points, float))
    time_w = np.where(np.arange(n_times) > 0, 1.0 / (time_diffs + 1e-5), 1.0)

    early = np.arange(n_times) < 8
    weights_pr = np.where(
        early, (1.0 / (np.abs(pr_data[0]) + 1e-5)) * time_w,
        1.0 / (np.abs(pr_data[0]) + 1e-5))

    weights_p = np.where(
        early[None, :],
        (1.0 / (np.abs(p_data[:num_psites]) + 1e-5)) * time_w[None, :],
        1.0 / (np.abs(p_data[:num_psites]) + 1e-5))

    return np.concatenate([weights_pr, weights_p.reshape(-1)])


def full_weight(p_data_weight: np.ndarray, use_regularization: bool,
                reg_len: int) -> np.ndarray:
    """Prepend unit RNA weights; append unit regularization weights
    (reference weights.py:148-163)."""
    base = np.concatenate([np.ones(N_RNA), np.asarray(p_data_weight, float)])
    if use_regularization:
        base = np.concatenate([base, np.ones(reg_len)])
    return base


def get_weight_options(target: np.ndarray, t_target: np.ndarray,
                       num_psites: int, use_regularization: bool,
                       reg_len: int, early_weights: np.ndarray,
                       ms_gauss_weights: np.ndarray | None,
                       use_custom_weights: bool = True) -> dict[str, np.ndarray]:
    """The 17-scheme weight library (reference weights.py:166-240)."""
    target = np.asarray(target, float)
    nt = len(t_target)
    # one block per signal chain: protein + each site (bug-fixed length)
    time_indices = np.tile(np.arange(1, nt + 1), num_psites + 1).astype(float)

    log_scale = np.log1p(np.abs(target))
    sqrt_signal = np.sqrt(np.maximum(np.abs(target), 1e-5))

    if len(target) >= 2:
        grad = np.gradient(target)
        flat_region_penalty = 1 / np.maximum(np.abs(grad), 1e-5)
    else:
        flat_region_penalty = 1 / np.maximum(np.abs(target), 1e-5)

    fw = lambda w: full_weight(w, use_regularization, reg_len)
    sig = target[N_RNA:]

    base_weights = {
        "inverse": fw(1 / np.maximum(np.abs(sig), 1e-5)),
        "exponential_decay": fw(np.exp(-0.5 * sig)),
        "inverse_log_scale": fw(1 / np.maximum(log_scale[N_RNA:], 1e-5)),
        "inverse_time_diff": fw(1 / np.maximum(
            np.abs(np.diff(sig, prepend=sig[0])), 1e-5)),
        "inverse_moving_avg": fw(1 / np.maximum(
            np.abs(sig - _uniform_filter1d(sig, 3)), 1e-5)),
        "sigmoid_decay": fw(1 / (1 + np.exp(time_indices - 5))),
        "exponential_early_decay": fw(np.exp(-0.5 * time_indices)),
        "polynomial_time_decay": fw(1 / (1 + 0.5 * time_indices)),
        "signal_noise": fw(1 / sqrt_signal[N_RNA:]),
        "inverse_variance": fw(1 / (np.maximum(np.abs(sig), 1e-5) ** 0.7)),
        "flat_penalty": fw(flat_region_penalty[N_RNA:]),
        "steady_decay": fw(np.exp(-0.1 * time_indices)),
        "inverse_square_root_data": fw(1 / sqrt_signal[N_RNA:]),
        # NOTE (reference-faithful, weights.py:217-231): these two span
        # the FLAT concatenated vector positionally, so the "early"
        # emphasis only reaches the protein block — unlike the sibling
        # time-based schemes whose time_indices restart per block.
        # Reproduced as-is; flagged in review.
        "early_moderate_decay": fw(np.linspace(1.0, 0.3, len(time_indices))),
        "early_steep_decay": fw(np.concatenate([
            np.full(min(8, len(time_indices)), 0.05),
            np.full(min(2, max(len(time_indices) - 8, 0)), 0.2),
            np.ones(max(len(time_indices) - 10, 0)),
        ])),
        "early_emphasis": fw(early_weights),
    }
    if ms_gauss_weights is not None:
        base_weights["uncertainties_from_data"] = fw(ms_gauss_weights)

    if not use_custom_weights:
        if "uncertainties_from_data" in base_weights:
            return {"uncertainties_from_data": base_weights["uncertainties_from_data"]}
        return {"inverse": base_weights["inverse"]}
    return base_weights


def _uniform_filter1d(x: np.ndarray, size: int) -> np.ndarray:
    """Centered moving average with edge replication (scipy-compatible
    'nearest' mode for odd sizes)."""
    half = size // 2
    xp = np.concatenate([np.repeat(x[:1], half), x, np.repeat(x[-1:], half)])
    kernel = np.ones(size) / size
    return np.convolve(xp, kernel, mode="valid")


def get_protein_weights(gene: str, input1_wstd, input2) -> np.ndarray:
    """The MS-Gaussian std weights of one gene, read from the input
    tables: not ported yet (they are pandas frames of the input files;
    ROADMAP.md queue 1 item 8, "The host layer"). Pass the weights to
    ``normest(ms_gauss_weights=...)`` directly instead."""
    raise NotImplementedError(
        "get_protein_weights reads the input files' pandas frames, which the port "
        "does not load yet (ROADMAP.md queue 1 item 8, the host layer); pass "
        "ms_gauss_weights as an array")
