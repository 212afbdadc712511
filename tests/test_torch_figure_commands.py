"""The commands that write the fit figures, end to end through
``cli.main`` on the CPU, against the JAX CLI on the same project: ``kinopt``
and ``tfopt --mode local`` with ``fit_analysis`` on (the default: the
fit-analysis folder, the readout figures, the KKT report), then
``fitanalysis --which kinopt|tfopt`` re-rendering the panels from the
CSV sheets each command wrote.

The JAX command runs in its own process beside the port's and pickles
what its figures draw (``tests/test_torch_runner.py::start_jax_cli``).
The file sets are equal; each figure draws the same within 1e-9 of each
array's largest magnitude or of 1 (the two fits agree to rounding);
``important_connections.csv`` is compared after parsing at the same
tolerance, and ``network_sankey.html`` outside its numbers byte for byte,
its numbers (printed to 0.1) within 0.11, since they come from the fits.
"""

import os
import pickle
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
from test_torch_export import RTOL_COMPUTED, assert_same_csv, written
from test_torch_runner import finish, in_dir, start_jax_cli
from torch_figures import assert_same_records, capture_port
from torch_project import CONFIG, write_project

from phoskintime_tpu_torch import cli


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """The shared project with ``fit_analysis`` on for kinopt and tfopt."""
    return write_project(tmp_path_factory.mktemp("figure_project"),
                         config=CONFIG.replace("fit_analysis = false\n", ""))


def absolute(records: dict, root: Path) -> dict:
    return {k if os.path.isabs(k) else str(root / k): v for k, v in records.items()}


def run_both(tmp_path, src_jax, src_port, argv):
    """``argv`` through both CLIs on copies of the given folders; returns
    the two folders and the port's new files (held equal to JAX's), the
    figures held equal by record."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src_jax, dj)
    shutil.copytree(src_port, dp)
    before = written(dp)
    proc = start_jax_cli(dj, *argv, records=tmp_path / "records.pkl")
    try:
        with capture_port() as got:
            extra = ["--device", "cpu"] if argv[0] != "fitanalysis" else []
            in_dir(dp, cli.main, [*argv, *extra])
    finally:
        finish(proc)
    new = written(dp) - before
    assert new == written(dj) - written(src_jax), sorted(new ^ (written(dj) - before))
    with open(tmp_path / "records.pkl", "rb") as fh:
        want = pickle.load(fh)
    assert_same_records(absolute(got, dp), absolute(want, dj), dp, dj, scaled=RTOL_COMPUTED)
    return dj, dp, new


@pytest.fixture(scope="module")
def fits(tmp_path_factory, project):
    """``kinopt`` and ``tfopt`` through both CLIs; {which: (jax, port)}."""
    out = {}
    for which in ("kinopt", "tfopt"):
        tmp = tmp_path_factory.mktemp(f"{which}_command")
        dj, dp, new = run_both(tmp, project, project, [which, "--mode", "local"])
        out[which] = (dj, dp, new)
    return out


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_weight_fit_command_writes_the_jax_panels(fits, which):
    dj, dp, new = fits[which]
    folder = f"data/{which}_fitanalysis/"
    panels = {f[len(folder):] for f in new if f.startswith(folder)}
    assert {"Goodness_of_Fit.png", "kld.png", "PCA.png", "violin_parameters.png",
            "residual_profiles.png", "network_sankey.html", "important_connections.csv",
            f"{which}_control_load_top.png", f"{which}_knockout_top_suppressing.png"} <= panels
    if which == "kinopt":
        assert {"data/kinopt_kkt/constraint_violations.png",
                "data/kinopt_kkt/sensitivity.png"} <= new
    else:
        assert any(p.startswith("alpha_distribution_") for p in panels)
        assert any(p.startswith("TF_") for p in panels)
    assert_same_csv(dp / folder / "important_connections.csv",
                    dj / folder / "important_connections.csv", RTOL_COMPUTED)
    page, want = ((d / folder / "network_sankey.html").read_text() for d in (dp, dj))
    num = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
    assert re.split(num, page) == re.split(num, want)
    np.testing.assert_allclose([float(v) for v in re.findall(num, page)],
                               [float(v) for v in re.findall(num, want)], rtol=1e-9, atol=0.11)


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_fitanalysis_command_matches_jax(tmp_path, fits, which):
    """``fitanalysis --which`` re-renders the panels from each command's
    own CSV sheets into a fresh folder: the JAX command's files and
    figures."""
    dj, dp, _ = fits[which]
    out = f"rerendered_{which}"
    _, port, new = run_both(tmp_path, dj, dp, ["fitanalysis", "--which", which,
                                               "--out-dir", out])
    assert new and all(f.startswith(f"{out}/") for f in new)
    assert {f"{out}/Goodness_of_Fit.png", f"{out}/network_sankey.html"} <= new


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_chip_smoke_expects_the_cpu_file_set(tmp_path, fits, which):
    """``chip_smoke.py``'s phase-14 file sets, derived from the run's
    sheets as the script derives them on the card, are the files the
    command and the re-rendering wrote here."""
    import chip_smoke

    _, dp, new = fits[which]
    got = {f[len("data/"):] for f in new if f.startswith(f"data/{which}_")}
    assert got == chip_smoke.weight_fit_files(dp / "data", which)
    assert chip_smoke.panel_files(dp / "data", which) == {
        f[len(f"{which}_fitanalysis/"):] for f in got
        if f.startswith(f"{which}_fitanalysis/") and not f.split("/")[1].startswith(which)}
