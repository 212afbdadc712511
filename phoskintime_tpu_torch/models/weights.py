"""Per-gene fitting weight (sigma) schemes.

Counterpart of ``phoskintime_tpu/models/weights.py`` (numpy only, copied):
17 named weighting schemes over the stacked target vector [rna(9),
protein(14), sites(14*n)], an "early emphasis" kernel, and the MS-Gaussian
measurement-std weights (``uncertainties_from_data``), read from the
input1_wstd table by :func:`get_protein_weights` or passed in.

As in the JAX package, the time-index schemes tile ``num_psites + 1``
blocks (protein and each site), so every scheme has the target's length;
all schemes are host arrays, computed once per gene, that feed the batched
LM as per-residual sigmas.
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu_torch.io.utils import is_missing

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
    """The MS-Gaussian std weights of one gene: its protein row, then its
    sites in input2's order, each x1_std..x14_std, flattened.

    ``input1_wstd`` ({GeneID, Psite, x1_std..x14_std}) and ``input2``
    ({GeneID, Psite, ...}) are column tables (or frames); an empty or
    missing Psite is a protein row. The protein row is input1_wstd's own
    (exactly one), else input2's protein rows' stds. Raises where the gene
    has no input2 row, a site has no std row or there is no protein row."""
    std_cols = [f"x{i}_std" for i in range(1, 15)]
    i1 = {str(c).strip(): np.asarray(v) for c, v in _columns(input1_wstd).items()}
    i2 = {str(c).strip(): np.asarray(v) for c, v in _columns(input2).items()}
    site = lambda v: None if is_missing(v) or v == "" else v
    i1_site = [site(v) for v in i1["Psite"]]
    stds = np.stack([np.asarray(i1[c], float) for c in std_cols], axis=1)
    by_key: dict = {}
    for r, key in enumerate(zip(i1["GeneID"], i1_site)):
        by_key.setdefault(key, []).append(r)
    gene_sites = [site(s) for g, s in zip(i2["GeneID"], i2["Psite"]) if g == gene]
    if not gene_sites:
        raise ValueError(f"No entries for GeneID {gene} in input2")

    # input2's rows joined to every matching std row (a left join)
    merged = [(s, stds[r] if r is not None else np.full(14, np.nan))
              for s in gene_sites for r in by_key.get((gene, s), [None])]
    if any(np.isnan(v).any() for _, v in merged):
        missing = [s for s, v in merged if np.isnan(v).any()]
        raise ValueError(f"Missing (GeneID, Psite) std rows for {gene}: {missing}")

    own = by_key.get((gene, None), [])
    if len(own) > 1:
        raise ValueError(f"{gene}: {len(own)} duplicate protein-level std rows in "
                         f"input1_wstd — expected exactly one")
    prot = [stds[own[0]]] if own else [v for s, v in merged if s is None]
    if not prot:
        # one block short would misalign 'uncertainties_from_data' against
        # every other sigma
        raise ValueError(f"{gene}: no protein-level (empty-Psite) std row found in "
                         f"input1_wstd — the fit vector needs protein + site blocks")
    phos = [v for s, v in merged if s is not None]
    return np.concatenate([np.reshape(prot, -1), np.reshape(phos, -1)])


def _columns(table) -> dict:
    """A column table or a frame as {name: column}."""
    return {c: table[c] for c in (table.columns if hasattr(table, "columns") else table)}
