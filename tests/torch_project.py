"""A small project for the entry points' tests: input files and a config.

Seven proteins (GA, GB, GC, GD, KA, KB, TF1): kinases KA and KB, each also
a protein; nine kinase -> site edges on seven sites of four proteins, at
most three a protein (within model 2's kernels); TF edges with a cycle,
and an orphan TF (TF1, no sites) that feeds back to kinase KB and so is
driven by it. It imports no JAX: ``tests/test_torch_kernels_cuda.py`` uses
it on the card.
"""

from pathlib import Path

import numpy as np

from phoskintime_tpu_torch.io.utils import write_csv

# the project: kinase -> site edges (protein, site, kinases), TF edges
SITES = {"GA": {"S10": ["KA"], "T20": ["KA", "KB"]}, "GB": {"S5": ["KB"]},
         "GC": {"S1": ["KA"], "S2": ["KB"], "Y3": ["KA", "KB"]}, "KA": {"S7": ["KB"]}}
TF_EDGES = [("GA", "GB"), ("GB", "GC"), ("GC", "GA"), ("KA", "GD"), ("TF1", "KB")]
GENES = ["GA", "GB", "GC", "GD", "KA", "KB", "TF1"]
CONFIG = """[paths]
data_dir = "data"
results_dir = "results"

[tfopt]
input1 = "input1.csv"
input3 = "input3.csv"
input4 = "input4.csv"
out_file = "tfopt_results.xlsx"
loss_type = 0
fit_analysis = false

[kinopt]
input1 = "input1.csv"
input2 = "input2.csv"
out_file = "kinopt_results.xlsx"
loss_type = "base"
estimate_missing_kinases = true
scaling_method = "none"
fit_analysis = false

[ode]
model = "distmod"
[ode.bounds]
mRNA_prod = 10
[ode.inputs]
protein_excel = "data/input1.csv"

[global_model]
kinase_net = "data/input2.csv"
tf_net = "data/input4.csv"
ms = "data/input1.csv"
rna = "data/input3.csv"
kinopt = "data/kinopt_results.xlsx"
tfopt = "data/tfopt_results.xlsx"
output_dir = "results_global"
optimizer = "pymoo"
pop = 16
n_gen = 2
seed = 42
sensitivity_analysis = true
sensitivity_trajectories = 2
sensitivity_levels = 4
use_initial_condition_from_data = true
"""


def write_project(root: Path, seed: int = 0, config: str = CONFIG) -> Path:
    """Input files input1-input4 (12 significant digits, which pandas reads
    exactly) under ``root/data`` and ``root/config.toml``."""
    rng = np.random.default_rng(seed)
    data = root / "data"
    data.mkdir(parents=True, exist_ok=True)
    rows = [(g, "") for g in GENES] + [(g, s) for g, sites in SITES.items() for s in sites]
    fc = lambda n: np.round(rng.uniform(0.6, 1.8, n), 10)  # noqa: E731
    vals = fc((len(rows), 14))
    write_csv(data / "input1.csv", {"GeneID": [r[0] for r in rows], "Psite": [r[1] for r in rows],
                                    **{f"x{j + 1}": vals[:, j] for j in range(14)}})
    edges = [(g, s, ks) for g, sites in SITES.items() for s, ks in sites.items()]
    write_csv(data / "input2.csv", {"GeneID": [e[0] for e in edges],
                                    "Psite": [e[1] for e in edges],
                                    "Kinase": ["{" + ", ".join(e[2]) + "}" for e in edges]})
    rna = fc((len(GENES), 9))
    write_csv(data / "input3.csv", {"GeneID": GENES, **{f"x{j + 1}": rna[:, j]
                                                        for j in range(9)}})
    write_csv(data / "input4.csv", {"Source": [a for a, _ in TF_EDGES],
                                    "Target": [b for _, b in TF_EDGES]})
    (root / "config.toml").write_text(config)
    return root
