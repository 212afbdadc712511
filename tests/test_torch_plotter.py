"""The per-gene figures (``report/plotter.py``'s :class:`Plotter`,
``report/diagram.py``'s ``illustrate``) and the figures of the per-gene
pipeline, against the JAX package's, on the CPU.

Every writer gets the same seeded inputs in both packages (DataFrames for
JAX, the same columns as dicts for the port). What each figure draws is
captured as a record (``tests/torch_figures.py``) and the records are
held equal: strings exactly but the numbers in them (rtol 1e-9), colours
exactly, data at rtol 1e-9. The t-SNE panel is held outside its embedded
points: the port computes the exact t-SNE, the JAX writer scikit-learn's
Barnes-Hut one (``tests/test_torch_fitpanels.py`` holds the port's to
scikit-learn's exact method). PIL (in this sandbox, never in the port)
decodes the port's PNGs.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
from PIL import Image as PILImage
from torch_figures import (assert_same_record, assert_same_records, capture_jax, capture_port,
                           without_points)

from phoskintime_tpu.report import diagram as jdiagram
from phoskintime_tpu.report.plotter import Plotter as JaxPlotter
from phoskintime_tpu_torch.report import diagram
from phoskintime_tpu_torch.report.plotter import Plotter

TIMES = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0, 120.0, 240.0, 480.0,
                  960.0])


def frame(table):
    return pd.DataFrame({k: list(v) for k, v in table.items()})


def run_both(tmp_path, call, tsne: bool = False):
    """``call(plotter, tables)`` with JAX's Plotter (tables as DataFrames)
    and the port's (as dicts); the records held equal and each PNG
    decoded. Returns the two captures."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    with capture_jax() as want:
        jout = call(JaxPlotter("GA", str(dj)), frame)
    with capture_port() as got:
        pout = call(Plotter("GA", str(dp)), lambda t: t)
    if tsne:
        without_points(want, "_tsne.png"), without_points(got, "_tsne.png")
    assert_same_records(got, want, dp, dj)
    for path in got:
        with PILImage.open(path) as im:
            im.load()
            assert im.size[0] > 0 and im.size[1] > 0
    assert (jout is None) == (pout is None)
    return want, got


@pytest.fixture(scope="module")
def gene():
    """A gene's fit-shaped arrays: 3 sites (5 states), the target in the
    pipeline's order (mRNA at the 9 RNA times, protein, the sites), a
    bootstrap ensemble, CIs, knockouts and a Morris result."""
    rng = np.random.default_rng(0)
    T, d = len(TIMES), 5
    sol = rng.uniform(0.5, 2.0, (T, d))
    target = rng.uniform(0.5, 2.0, 9 + T * 4)
    boot = rng.normal(1.0, 0.2, (12, 7))
    names = [f"p{i}" for i in range(7)]
    return SimpleNamespace(
        sol=sol, target=target, fit=target + rng.normal(0, 0.1, target.shape), boot=boot,
        names=names, labels=["R", "P", "P1", "P2", "P3"],
        ci={"beta_hat": boot[0], "lwr_ci": boot[0] - 0.1, "upr_ci": boot[0] + 0.2},
        kos=rng.uniform(0.5, 2.0, (4, T, d)), ko_labels=["WT", "KO1", "KO2", "KO12"],
        morris=SimpleNamespace(mu_star=rng.uniform(0, 1, 7), sigma=rng.uniform(0, 1, 7),
                               mu_star_conf=rng.uniform(0, 0.1, 7)),
        est=rng.uniform(0.1, 2.0, (10, 7)),
        profiles={"Time": TIMES[:6], "A": rng.uniform(size=6), "B": rng.uniform(size=6)},
        heat={"Protein": ["GA", "GB", "GC", "GD"], "a": rng.uniform(size=4),
              "b": rng.uniform(size=4), "c": rng.uniform(size=4)},
        pert={"GA": {"A": rng.uniform(size=20), "B": rng.uniform(size=20),
                     "S1": rng.uniform(size=20), "RMSE": rng.uniform(size=20)}},
        results={"gene": np.array(["GA", "GB", "GC"], dtype=object),
                 "error": np.array([0.3, 0.1, 0.2]), "reg_term": np.array([0.01, 0.03, 0.02])})


WRITERS = {
    "model_fit": lambda g: lambda P, f: P.plot_model_fit(TIMES, g.sol, g.target,
                                                          state_labels=g.labels),
    "model_fit_rna_grid": lambda g: lambda P, f: P.plot_model_fit(
        TIMES, g.sol, g.target[2:], rna_time_points=TIMES[7:], name="fit2"),
    "params_bar": lambda g: lambda P, f: P.plot_params_bar(g.ci, g.names),
    "params_bar_none": lambda g: lambda P, f: P.plot_params_bar(None, g.names),
    "scree": lambda g: lambda P, f: P.plot_scree(g.boot),
    "pca": lambda g: lambda P, f: P.plot_pca(g.boot),
    "pca_two_samples": lambda g: lambda P, f: P.plot_pca(g.boot[:2]),
    "parallel": lambda g: lambda P, f: P.plot_parallel(g.boot, g.names),
    "parallel_values": lambda g: lambda P, f: P.plot_parallel(g.boot, g.names,
                                                              values=g.boot[:, 0]),
    "gof": lambda g: lambda P, f: P.plot_gof(g.target, g.fit),
    "kld": lambda g: lambda P, f: P.plot_kld(g.target, g.fit),
    "knockouts": lambda g: lambda P, f: P.plot_knockouts(TIMES, g.sol, g.kos, g.ko_labels),
    "perturbation_cloud": lambda g: lambda P, f: P.plot_perturbation_cloud(TIMES, g.kos, g.sol),
    "morris": lambda g: lambda P, f: P.plot_morris(g.morris, g.names),
    "phase_space": lambda g: lambda P, f: P.plot_phase_space(g.sol),
    "time_state_grid": lambda g: lambda P, f: P.plot_time_state_grid(TIMES, g.sol, g.labels),
    "error_summary": lambda g: lambda P, f: P.plot_error_summary({"mse": 0.1, "rmse": 0.3}),
    "param_series": lambda g: lambda P, f: P.plot_param_series(g.est[:, :4], g.names,
                                                               TIMES[:10]),
    "profiles": lambda g: lambda P, f: P.plot_profiles(f(g.profiles)),
    "param_scatter": lambda g: lambda P, f: P.plot_param_scatter(g.est, 3, TIMES[:10]),
    "heatmap": lambda g: lambda P, f: P.plot_heatmap(f(g.heat)),
    "top_param_pairs": lambda g: lambda P, f: P.plot_top_param_pairs(
        {k: f(v) for k, v in g.pert.items()}, max_pairs_per_gene=2),
    "future_fit": lambda g: lambda P, f: P.plot_future_fit(
        g.sol[:, 2:].T, g.sol[5:, 0], g.sol, 3, ["S1", "S2", "S3"], TIMES, TIMES[5:], 8),
    "regularization": lambda g: lambda P, f: P.plot_regularization(f(g.results)),
    "model_error": lambda g: lambda P, f: P.plot_model_error(f(g.results), "distmod"),
}


@pytest.mark.parametrize("name", list(WRITERS))
def test_plotter_writer_matches_jax(tmp_path, gene, name):
    run_both(tmp_path, WRITERS[name](gene))


def test_plotter_tsne_matches_jax_outside_its_points(tmp_path, gene):
    """``plot_tsne``: the figure outside its embedded points, the points
    finite and one a sample; None under 10 samples in both."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(24, 6))
    _, got = run_both(tmp_path, lambda P, f: P.plot_tsne(X), tsne=True)
    run_both(tmp_path / "few", lambda P, f: P.plot_tsne(X[:9]))
    from phoskintime_tpu_torch.analysis.embed import tsne

    Z = tsne(X, perplexity=8)
    assert Z.shape == (24, 2) and np.isfinite(Z).all()
    assert len(got) == 1


def test_plotter_reads_results_and_perturbation_sheets(tmp_path, gene):
    """The per-gene bars from a results workbook's CSV sheet, and the
    pairs from its ``<stem>_<gene>_perturbations.csv`` sheets, equal the
    figures of the same tables passed directly."""
    from phoskintime_tpu_torch.io.export import TableWriter

    w = TableWriter(str(tmp_path / "model_results.xlsx"))
    w.add("Results", gene.results)
    w.add("GA_perturbations", gene.pert["GA"])
    w.save()
    d1, d2 = tmp_path / "direct", tmp_path / "sheet"
    with capture_port() as direct:
        Plotter("GA", str(d1)).plot_model_error(gene.results)
        Plotter("GA", str(d1)).plot_top_param_pairs({"ga": gene.pert["GA"]})
    with capture_port() as sheet:
        Plotter("GA", str(d2)).plot_model_error(str(tmp_path / "model_results.xlsx"))
        Plotter("GA", str(d2)).plot_top_param_pairs(str(tmp_path / "model_results.xlsx"))
    assert_same_records(sheet, direct, d2, d1)
    assert any("ga_param_scatter_" in p for p in sheet)


@pytest.mark.parametrize("model,n", [("distmod", 3), ("succmod", 2), ("randmod", 3),
                                     ("randmod", 1)])
def test_illustrate_matches_jax(tmp_path, model, n):
    dj, dp = tmp_path / "jax", tmp_path / "port"
    with capture_jax() as want:
        jp = jdiagram.illustrate("GA", n, model, str(dj))
    with capture_port() as got:
        pp = diagram.illustrate("GA", n, model, str(dp))
    assert_same_records(got, want, dp, dj)
    assert Path(pp).name == Path(jp).name == "GA_diagram.png"
    rec = next(iter(got.values()))[0]["axes"][0]
    arrows = [t for t in rec["texts"] if t["arrow"] is not None]
    assert rec["off"] and len(rec["patches"]) >= 3
    assert len(rec["texts"]) == len(rec["patches"]) + len(arrows)


def test_process_gene_figures_match_jax(tmp_path):
    """``process_gene``'s default figures with bootstraps (CIs, PCA and
    parallel coordinates) and Morris sensitivity, against JAX's: the same
    files (``chip_smoke.py``'s phase-14 derivation too); the records
    within 1e-9 of each array's largest magnitude or of 1 (the two fits
    agree to rounding)."""
    from test_normest import BOUNDS, synth_gene
    from test_torch_normest import SMALL

    from phoskintime_tpu.fit.pipeline import process_gene as jax_process_gene
    from phoskintime_tpu_torch.fit.pipeline import process_gene

    _, _, pr, p, r = synth_gene("distmod", 2, 3)
    kw = dict(bootstraps=4, run_sensitivity=True, normest_kw=SMALL,
              sensitivity_kw=dict(num_trajectories=4, num_levels=4))
    dj, dp = tmp_path / "jax", tmp_path / "port"
    with capture_jax() as want:
        jout = jax_process_gene("GP", pr, p, r, 2, TIMES, BOUNDS, out_dir=str(dj), **kw)
    with capture_port() as got:
        out = process_gene("GP", pr, p, r, 2, TIMES, BOUNDS, out_dir=str(dp), device="cpu", **kw)
    names = sorted(Path(f).name for f in out.figures)
    assert names == sorted(Path(f).name for f in jout.figures)
    assert {"GP_diagram.png", "GP_params_ci.png", "GP_pca.png", "GP_morris.png",
            "GP_perturb_0.png"} <= set(names)
    assert_same_records(got, want, dp, dj, scaled=1e-9)
    import chip_smoke

    assert {str(Path(f).relative_to(dp)) for f in out.figures} == chip_smoke.gene_files(out)


def test_record_holds_every_new_artist():
    """A figure with each artist the part-2 writers added holds each in
    its record (a record that skipped one would compare as empty)."""
    from phoskintime_tpu_torch.report.draw import Circle, subplots

    fig, ax = subplots()
    ax.bar(["a", "b"], [1.0, 2.0], label="bars")
    ax.errorbar([0.0, 1.0], [1.0, 2.0], yerr=[0.1, 0.2], fmt="none", capsize=2)
    ax.fill_between([0.0, 1.0], [1.0, 2.0])
    ax.add_patch(Circle((0.5, 0.5), 0.1))
    ax.annotate("x", (0.5, 0.5), xytext=(2, 2), textcoords="offset points")
    ax.axvline(0.5)
    rec = fig.record()["axes"][0]
    assert len(rec["bars"]) == 2 and len(rec["patches"]) == 1 and len(rec["texts"]) == 1
    assert [c["kind"] for c in rec["collections"]] == ["lines", "poly"]
    assert len(rec["lines"]) == 3 and rec["xticklabels"] == ["a", "b"]
    assert_same_record(rec, rec)
