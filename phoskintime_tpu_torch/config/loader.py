"""TOML configuration loader.

Counterpart of ``phoskintime_tpu/config/loader.py`` (its own copy; the
standard library's ``tomllib`` only): walk up from the current directory
to find ``config.toml``, read a named section, deep-merge
``[section.modes.<mode>]`` overrides on top of the section defaults, and
inject the project root and the global ``[paths]`` table under the
reserved keys ``_root`` / ``_paths``. :class:`PhosKinConfig` is a frozen
typed view of the ``[global_model]`` section, with the JAX package's
fields and defaults.
"""

from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path
from typing import Any, Mapping


def find_config(start: str | Path | None = None, name: str = "config.toml") -> Path:
    """Walk up from `start` (default: cwd) until `name` is found."""
    cur = Path(start or Path.cwd()).resolve()
    for cand in [cur, *cur.parents]:
        p = cand / name
        if p.is_file():
            return p
    raise FileNotFoundError(f"{name} not found walking up from {cur}")


def load_config_toml(path: str | Path | None = None) -> dict[str, Any]:
    p = Path(path) if path is not None else find_config()
    with open(p, "rb") as fh:
        data = tomllib.load(fh)
    data["_root"] = str(p.parent)
    return data


def _deep_merge(base: Mapping[str, Any], override: Mapping[str, Any]) -> dict[str, Any]:
    """Recursively merge `override` onto `base` (dicts merge, leaves replace)."""
    out: dict[str, Any] = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load(mode: str | None, section: str, path: str | Path | None = None) -> dict[str, Any]:
    """Load `[section]` merged with `[section.modes.<mode>]`.

    Returns the merged dict with `_root` (project root dir) and `_paths`
    (the global `[paths]` table) injected, mirroring the reference loader's
    contract (``config_loader.py:52-75``).
    """
    data = load_config_toml(path)
    sec = dict(data.get(section, {}) or {})
    modes = sec.pop("modes", {}) or {}
    if mode and mode in modes:
        sec = _deep_merge(sec, modes[mode])
    sec["_root"] = data["_root"]
    sec["_paths"] = dict(data.get("paths", {}) or {})
    return sec


@dataclasses.dataclass(frozen=True)
class PhosKinConfig:
    """Frozen typed view of `[global_model]` (reference `config_loader.py:104-177`)."""

    # inputs
    kinase_net: str = "data/input2.csv"
    tf_net: str = "data/input4.csv"
    ms: str = "data/input1.csv"
    rna: str = "data/input3.csv"
    phospho: str = "data/input1.csv"
    kinopt: str = "data/kinopt_results.xlsx"
    tfopt: str = "data/tfopt_results.xlsx"
    # run settings
    output_dir: str = "results_model_global"
    cores: int = 0
    seed: int = 42
    optimizer: str = "pymoo"          # "pymoo"-equivalent GA | "optuna"-equivalent TPE
    n_trials: int = 1000
    n_gen: int = 1000
    pop: int = 300
    refine: bool = False
    num_refinements: int = 0
    polish_steps: int = 0             # exact-gradient Adam polish of the Pareto set
    polish_lr: float = 0.02
    gens_per_dispatch: int = 1        # >1: all-device GA loop (nsga_device)
    gn_iters: int = 0                 # LM/Gauss-Newton finish on the pick
    loss: int = 0
    # loss weights
    lambda_prior: float = 0.1
    lambda_protein: float = 1.0
    lambda_rna: float = 1.0
    lambda_phospho: float = 1.0
    hyperparam_scan: bool = False
    # scan sizing (reference global_model/scan.py pulls N_TRIALS etc. from
    # its config module; these feed run_hyperparameter_scan)
    scan_trials: int = 20
    scan_inner_gens: int = 15
    scan_inner_pop: int = 64
    # data flags
    normalize_fc_steady: bool = False
    use_initial_condition_from_data: bool = False
    scaling_method: str = "raw"
    weighting_method_protein: str = "uniform"
    weighting_method_rna: str = "uniform"
    weighting_method_phospho: str = "uniform"
    # sensitivity
    sensitivity_analysis: bool = True
    sensitivity_perturbation: float = 0.05
    sensitivity_trajectories: int = 100
    sensitivity_levels: int = 40
    sensitivity_top_curves: int = 20
    sensitivity_metric: str = "total_signal"
    # model / solver
    model: int = 0                     # 0 dist | 1 seq | 2 comb | 4 saturating
    use_custom_solver: bool = True
    ode_abs_tol: float = 1e-8
    ode_rel_tol: float = 1e-8
    ode_max_steps: int = 200_000
    # timepoints
    time_points_protein: tuple = (0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0,
                                  30.0, 60.0, 120.0, 240.0, 480.0, 960.0)
    time_points_rna: tuple = (4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 240.0, 480.0, 960.0)
    # bounds (physical space)
    bounds: Mapping[str, tuple] = dataclasses.field(default_factory=lambda: dict(DEFAULT_BOUNDS))
    _root: str = "."

    @classmethod
    def from_toml(cls, path: str | Path | None = None) -> "PhosKinConfig":
        data = load_config_toml(path)
        gm = dict(data.get("global_model", {}) or {})
        tp = gm.pop("timepoints", {}) or {}
        bounds_tbl = gm.pop("bounds", {}) or {}
        solver = gm.pop("solver", {}) or {}
        models_tbl = gm.pop("models", {}) or {}
        kw: dict[str, Any] = {}
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in gm.items():
            if k in names:
                kw[k] = v
        if "protein" in tp:
            kw["time_points_protein"] = tuple(float(t) for t in tp["protein"])
        if "rna" in tp:
            kw["time_points_rna"] = tuple(float(t) for t in tp["rna"])
        if bounds_tbl:
            merged = dict(DEFAULT_BOUNDS)
            merged.update({k: tuple(v) for k, v in bounds_tbl.items()})
            kw["bounds"] = merged
        if solver:
            kw["ode_abs_tol"] = float(solver.get("absolute_tolerance", 1e-8))
            kw["ode_rel_tol"] = float(solver.get("relative_tolerance", 1e-8))
            kw["ode_max_steps"] = int(solver.get("max_timesteps", 200_000))
            kw["use_custom_solver"] = bool(solver.get("use_custom_solver", True))
        default_model = str(models_tbl.get("default_model", "distributive"))
        kw.setdefault("model", MODEL_NAMES.get(default_model, 0))
        kw["_root"] = data["_root"]
        return cls(**kw)


#: physical-space bounds per parameter group (reference `config.toml:367-396`)
DEFAULT_BOUNDS: dict[str, tuple] = {
    "c_k": (1e-3, 4.0),
    "A_i": (1e-6, 10.0),
    "B_i": (1e-3, 1.0),
    "C_i": (1e-3, 2.0),
    "D_i": (0.1, 0.5),
    "Dp_i": (0.05, 5.0),
    "E_i": (1e-4, 10.0),
    "tf_scale": (2.0, 10.0),
}

MODEL_NAMES = {"distributive": 0, "sequential": 1, "combinatorial": 2, "saturation": 4,
               "saturating": 4}
