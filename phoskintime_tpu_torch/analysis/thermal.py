"""The thermal (temperature-dependent) variant of the network model and its
comparison across temperatures.

Counterpart of ``phoskintime_tpu/analysis/thermal.py``. Each protein has a
melting temperature Tm; at ambient temperature T its folded fraction is

    f_i = 1 / (1 + exp(c_fold * (T - Tm_i))),

which (1) multiplies every forward phosphorylation flux (only folded
protein is a substrate) and (2) inflates degradation, D -> D * (1 +
k_unfold * (1 - f)) and the same for each site's Dp (unfolded protein is
cleared faster). The temperature enters only through state-independent
scale factors, so the variant is a (topology, params) transform
(:func:`thermalize`) that every integrator runs as it is, the exponential
path (and its table kernels) included: the RHS stays affine a bucket.

The thermal system keeps the original's device and working dtype, and the
degradation rates keep their kind: numpy arrays stay numpy, tensors stay
tensors on their device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def folded_fraction(T: float, Tm_i, c_fold: float = 0.8) -> np.ndarray:
    """The sigmoid folded fraction of each protein at temperature ``T``."""
    return 1.0 / (1.0 + np.exp(c_fold * (np.asarray(T, float) - np.asarray(Tm_i, float))))


def _scaled(rates, mult: np.ndarray):
    if isinstance(rates, torch.Tensor):
        return rates * torch.as_tensor(mult, dtype=rates.dtype, device=rates.device)
    return np.asarray(rates) * mult


def thermalize(system, params: dict, T: float, Tm_i, c_fold: float = 0.8,
               k_unfold: float = 4.0):
    """(thermal_system, thermal_params) at ambient temperature ``T``: the
    kinase-to-site weights W of protein i scaled by f_i, D_i and Dp_i by the
    unfolding multiplier; everything else shared. The system is built on
    ``system``'s device at its dtype."""
    from phoskintime_tpu_torch.network.system import GlobalSystem

    topo = system.topo
    f = folded_fraction(T, Tm_i, c_fold)
    mult = 1.0 + k_unfold * (1.0 - f)
    topo_T = dataclasses.replace(topo, W_pad=np.asarray(topo.W_pad) * f[:, None, None])
    system_T = GlobalSystem(topo_T, system.kin_grid, np.asarray(system.Kmat),
                            custom_y0=system.custom_y0, dtype=system.dtype,
                            device=system.device)
    params_T = dict(params)
    params_T["D_i"] = _scaled(params["D_i"], mult)
    params_T["Dp_i"] = _scaled(params["Dp_i"], mult[:, None])
    return system_T, params_T


DEFAULT_TEMPERATURES = (
    ("standard_20C", 20.0),
    ("physiological_37C", 37.0),
    ("heat_shock_42C", 42.0),
)


def compare_thermal_standard(system, params, Tm_i, temperatures=DEFAULT_TEMPERATURES,
                             t_eval=None, c_fold: float = 0.8, k_unfold: float = 4.0,
                             out_dir: str | None = None) -> dict:
    """The model simulated at each of ``temperatures`` (default 20 °C, 37 °C
    and a 42 °C heat shock over [0, 960] min at 97 points): {label:
    (protein, RNA, phospho tables)}, one RK45 solve
    (:func:`~phoskintime_tpu_torch.network.simulate.simulate_and_measure`)
    a temperature on the system's device; with ``out_dir``, the
    per-protein comparison figure ``thermal_comparison.png`` too."""
    from phoskintime_tpu_torch.network.simulate import simulate_and_measure

    t_eval = np.linspace(0.0, 960.0, 97) if t_eval is None else np.asarray(t_eval, float)
    out = {}
    for label, T in temperatures:
        sys_T, p_T = thermalize(system, params, T, Tm_i, c_fold=c_fold, k_unfold=k_unfold)
        out[label] = simulate_and_measure(sys_T, p_T, t_eval, t_eval, t_eval)
    if out_dir is not None:
        _plot_thermal_grid(system.topo, out, Tm_i, out_dir)
    return out


def _plot_thermal_grid(topo, results: dict, Tm_i, out_dir: str) -> str:
    """The first six proteins' total-protein fold changes, a row a protein
    and a column a temperature."""
    from phoskintime_tpu_torch.report.draw import subplots

    labels = list(results)
    n_prot = min(len(topo.proteins), 6)
    fig, axes = subplots(n_prot, len(labels), figsize=(4 * len(labels), 2.2 * n_prot),
                         sharex=True, squeeze=False)
    for c, lab in enumerate(labels):
        prot_table = results[lab][0]
        for r in range(n_prot):
            prot = topo.proteins[r]
            rows = np.asarray(prot_table["protein"]) == prot
            ax = axes[r][c]
            ax.plot(np.asarray(prot_table["time"])[rows], np.asarray(prot_table["pred_fc"])[rows],
                    lw=1.2)
            if r == 0:
                ax.set_title(lab, fontsize=10)
            if c == 0:
                ax.set_ylabel(f"{prot}\nTm={np.asarray(Tm_i)[r]:.0f}C", fontsize=8)
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "thermal_comparison.png")
    fig.savefig(path, dpi=110)
    return path
