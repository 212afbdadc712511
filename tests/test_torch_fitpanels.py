"""The kinopt/tfopt fit panels (``analysis/fitpanels.py``), the readout
figures (``analysis/network_tools.py::plot_signal_readout``), the KKT
and scan plots, and the port's own PCA, t-SNE, box and violin
statistics, against the JAX package, scikit-learn and matplotlib on the
CPU.

The panels get the same seeded sheets in both packages (DataFrames for
JAX, dicts of columns for the port) and their figures' records are held
equal (``tests/torch_figures.py``: strings exactly but their numbers at
rtol 1e-9, colours exactly, data at rtol 1e-9); ``network_sankey.html``
and ``important_connections.csv`` are held equal byte for byte. The
t-SNE figure is held outside its points: JAX calls scikit-learn's
Barnes-Hut t-SNE, the port computes the exact method, which is held to
``TSNE(method="exact", init="pca")`` here. The drivers on a fit compare
their figures within 1e-9 of each array's largest magnitude (or of 1),
since the two packages' predictions of the same weights agree to
rounding.
"""

import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
from test_torch_export import weight_problems  # noqa: F401  (the shared fixture)
from torch_figures import assert_same_records, capture_jax, capture_port, without_points

import phoskintime_tpu.analysis.fitpanels as jfp
from phoskintime_tpu_torch.analysis import embed
from phoskintime_tpu_torch.analysis import fitpanels as fp

#: the exact t-SNE against scikit-learn's, of the largest |coordinate|. The
#: port repeats scikit-learn's operations in its order (float32 embedding,
#: float64 probabilities, the C library's exp in the perplexity search), so
#: in this sandbox the two are equal bit for bit; the tolerance leaves room
#: for a BLAS that sums the PCA start's products in another order, a float32
#: ulp there, which 1,000 gradient steps carry forward but do not grow past
#: it at these sizes.
TSNE_ATOL = 1e-5


def frame(table):
    return pd.DataFrame({k: list(v) for k, v in table.items()})


def frames(sheets):
    return {k: frame(v) for k, v in sheets.items()}


def both(tmp_path, jax_fn, port_fn, scaled=0.0, tsne=False):
    """Both writers into their own folder; the records held equal (the
    t-SNE figure outside its points). Returns the two folders."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(parents=True, exist_ok=True), dp.mkdir(parents=True, exist_ok=True)
    with capture_jax() as want:
        jax_fn(str(dj))
    with capture_port() as got:
        port_fn(str(dp))
    if tsne:
        without_points(want, "tSNE.png"), without_points(got, "tSNE.png")
    assert_same_records(got, want, dp, dj, scaled)
    return dj, dp


def written(d: Path) -> set:
    return {str(p.relative_to(d)) for p in Path(d).rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def sheets():
    """kinopt- and tfopt-shaped sheets: 12 site rows of 5 genes (the t-SNE
    branch needs 8), 24 alpha rows over 3 kinases, betas with the
    per-kinase rows (empty Psite); 9 mRNA rows, their TF alphas and betas
    (empty PSite for the protein's)."""
    rng = np.random.default_rng(1)
    n, T = 12, 8
    tc = [f"x{j + 1}" for j in range(T)]
    genes = np.array([f"G{i % 5}" for i in range(n)], dtype=object)
    sites = np.array([f"S{i}" for i in range(n)], dtype=object)
    obs = rng.uniform(0.5, 2.0, (n, T))
    est = obs + rng.normal(0, 0.3, (n, T))

    def rows(vals, **ids):
        return {**ids, **{c: vals[:, j] for j, c in enumerate(tc)}}
    kin = {"Observed": rows(obs, Gene=genes, Psite=sites),
           "Estimated": rows(est, Gene=genes, Psite=sites),
           "Residuals": rows(obs - est, Gene=genes, Psite=sites),
           "Alpha Values": {"Gene": np.concatenate([genes, genes]),
                            "Psite": np.concatenate([sites, sites]),
                            "Kinase": np.array([f"K{i % 3}" for i in range(2 * n)], dtype=object),
                            "Alpha": rng.uniform(0, 1, 2 * n)},
           "Beta Values": {"Kinase": np.array(["K0", "K0", "K1", "K2", "K0", "K1", "K2"],
                                              dtype=object),
                           "Psite": np.array(["P1", "P2", "P1", "P1", "", "", ""], dtype=object),
                           "Beta": rng.uniform(-1, 2, 7)}}
    m = 9
    mrna = np.array([f"M{i}" for i in range(m)], dtype=object)
    tobs = rng.uniform(0.5, 2.0, (m, T))
    tf = {"Observed": rows(tobs, mRNA=mrna),
          "Estimated": rows(tobs + rng.normal(0, 0.2, (m, T)), mRNA=mrna),
          "Alpha Values": {"mRNA": np.repeat(mrna, 2),
                           "TF": np.array([f"T{i % 4}" for i in range(2 * m)], dtype=object),
                           "Value": rng.uniform(0, 1, 2 * m)},
          "Beta Values": {"TF": np.array(["T0", "T0", "T1", "T2", "T2", "T3"], dtype=object),
                          "PSite": np.array(["", "S5", "", "", "Y7", ""], dtype=object),
                          "Value": rng.uniform(-1, 1, 6)}}
    return SimpleNamespace(kin=kin, tf=tf)


# ---------------------------------------------------------------------------
# the port's own statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8), (5, 9), (30, 3), (200, 14), (12, 4)])
def test_pca_matches_sklearn(shape):
    """Components (signs included), explained variance ratios and the
    transform against ``PCA(n_components=min(X.shape))``: the covariance
    route at ten samples a feature, the SVD route below."""
    from sklearn.decomposition import PCA

    rng = np.random.default_rng(sum(shape))
    X = rng.normal(size=shape) * rng.uniform(0.1, 5, shape[1])
    want = PCA(n_components=min(X.shape))
    Zw = want.fit_transform(X)
    got = embed.PCA(min(X.shape))
    Zg = got.fit_transform(X)
    scale = np.abs(Zw).max()
    np.testing.assert_allclose(Zg, Zw, rtol=1e-9, atol=1e-12 * scale)
    np.testing.assert_allclose(got.explained_variance_ratio_, want.explained_variance_ratio_,
                               rtol=1e-9)
    np.testing.assert_allclose(got.components_, want.components_, rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("n,perplexity", [(9, 3), (40, 13), (150, 15)])
def test_tsne_probabilities_match_sklearn(n, perplexity):
    from sklearn.manifold._t_sne import _joint_probabilities
    from sklearn.metrics import pairwise_distances

    X = np.random.default_rng(n).normal(size=(n, 14))
    D = pairwise_distances(X, squared=True)
    np.testing.assert_array_equal(embed.squared_distances(X), D)
    np.testing.assert_allclose(embed.joint_probabilities(D.astype(np.float32), perplexity),
                               _joint_probabilities(D, perplexity, 0), rtol=1e-9, atol=0)


@pytest.mark.parametrize("n,perplexity", [(12, 3), (60, 15)])
def test_tsne_matches_sklearn_exact(n, perplexity):
    from sklearn.manifold import TSNE

    X = np.random.default_rng(n).normal(size=(n, 14)) * np.linspace(0.2, 3.0, 14)
    want = TSNE(perplexity=perplexity, method="exact", init="pca",
                random_state=0).fit_transform(X)
    got = embed.tsne(X, perplexity)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TSNE_ATOL * np.abs(want).max())
    with pytest.raises(ValueError, match="perplexity"):
        embed.tsne(X[:perplexity], perplexity)


@pytest.mark.parametrize("data", [[1.0, 2, 3, 4, 17], [0.5, 1, 1.5, 3.0], [2.0, 2, 2],
                                  list(np.random.default_rng(2).normal(size=40))])
def test_box_and_violin_statistics_match_matplotlib(data):
    from matplotlib import cbook, mlab

    from phoskintime_tpu_torch.report.draw.figure import boxplot_stats, violin_stats

    want = cbook.boxplot_stats(np.asarray(data))[0]
    got = boxplot_stats(data)
    for k in ("mean", "med", "q1", "q3", "iqr", "whislo", "whishi", "fliers"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def kde(X, coords):
        return ((X[0] == coords).astype(float) if np.all(X[0] == X)
                else mlab.GaussianKDE(X, None).evaluate(coords))
    want = cbook.violin_stats([np.asarray(data)], kde)[0]
    got = violin_stats(data)
    for k in ("coords", "vals", "mean", "median", "min", "max"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the panels
# ---------------------------------------------------------------------------

PANELS = {
    "gof": lambda m, s, d: m.goodness_of_fit_plot(s.kin["Observed"], s.kin["Estimated"], d),
    "kld": lambda m, s, d: m.kld_plot(s.tf["Observed"], s.tf["Estimated"], d, group_col="mRNA"),
    "pca_tsne": lambda m, s, d: m.pca_tsne_plots(s.kin["Estimated"], d),
    "pca_only": lambda m, s, d: m.pca_tsne_plots(_head(s.kin["Estimated"], 5), d),
    "params": lambda m, s, d: m.param_distribution_panels(s.kin["Alpha Values"]["Alpha"],
                                                          s.kin["Beta Values"]["Beta"], d),
    "params_histogram": lambda m, s, d: m.param_distribution_panels([0.2, 0.2, 0.2],
                                                                    [0.1, 0.5], d),
    "residuals": lambda m, s, d: m.residual_panels(s.kin["Residuals"], d),
    "residuals_few": lambda m, s, d: m.residual_panels(_head(s.kin["Residuals"], 4), d),
    "alpha_strips": lambda m, s, d: m.alpha_strips_per_mrna(s.tf["Alpha Values"], d,
                                                            max_genes=3),
    "beta_bars": lambda m, s, d: m.beta_bars_per_tf(s.tf["Beta Values"], d),
}


def _head(table, n):
    if isinstance(table, pd.DataFrame):
        return table.head(n)
    return {k: np.asarray(v)[:n] for k, v in table.items()}


def _as(module, sheets):
    """The sheets as the module's writers take them."""
    if module is fp:
        return sheets
    return SimpleNamespace(kin=frames(sheets.kin), tf=frames(sheets.tf))


@pytest.mark.parametrize("name", list(PANELS))
def test_panel_matches_jax(tmp_path, sheets, name):
    both(tmp_path, lambda d: PANELS[name](jfp, _as(jfp, sheets), d),
         lambda d: PANELS[name](fp, sheets, d), tsne=True)


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_sankey_and_connections_equal_jax_bytes(tmp_path, sheets, which):
    """``network_sankey.html`` and ``important_connections.csv`` byte for
    byte, the connections' bars by record."""
    cols = ("Kinase", "Gene", "Alpha") if which == "kinopt" else ("TF", "mRNA", "Value")
    alpha = (sheets.kin if which == "kinopt" else sheets.tf)["Alpha Values"]
    dj, dp = both(tmp_path, lambda d: jfp.important_connections(frame(alpha), d, cols=cols),
                  lambda d: fp.important_connections(alpha, d, cols=cols))
    edges = {c: alpha[c] for c in cols}
    jfp.sankey_html(frame(edges), str(dj / "s.html"), title="A → B & <flows>")
    fp.sankey_html(edges, str(dp / "s.html"), title="A → B & <flows>")
    for f in ("important_connections.csv", "s.html"):
        assert (dp / f).read_bytes() == (dj / f).read_bytes(), f


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_fit_analysis_from_sheets_matches_jax(tmp_path, sheets, which):
    """The whole panel set from sheets: the same files, figures by record,
    the page and the table by bytes."""
    if which == "kinopt":
        jfn, pfn, s = jfp.kinopt_fit_analysis_from_sheets, fp.kinopt_fit_analysis_from_sheets, \
            sheets.kin
    else:
        jfn, pfn, s = jfp.tfopt_fit_analysis_from_sheets, fp.tfopt_fit_analysis_from_sheets, \
            sheets.tf
    dj, dp = both(tmp_path, lambda d: jfn(frames(s), d), lambda d: pfn(s, d), tsne=True)
    assert written(dp) == written(dj)
    for f in ("network_sankey.html", "important_connections.csv"):
        assert (dp / f).read_bytes() == (dj / f).read_bytes(), f


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_fit_analysis_of_a_fit_matches_jax(tmp_path, weight_problems, which):  # noqa: F811
    """``kinopt_fit_analysis``/``tfopt_fit_analysis`` on the shared
    project's fit: the panels and the readout figures, the same files; then
    ``fit_analysis_from_workbook`` re-renders the panels from the port's
    CSV sheets, in both packages, to the same records."""
    from phoskintime_tpu_torch.io import export as ex

    w = weight_problems
    (jp, jmeta), (tp, tmeta) = w.kin if which == "kinopt" else w.tf
    res = w.kres if which == "kinopt" else w.tres
    if which == "kinopt":
        jfn = lambda d: jfp.kinopt_fit_analysis(jp, res, d, jmeta)  # noqa: E731
        pfn = lambda d: fp.kinopt_fit_analysis(tp, res, d, tmeta)  # noqa: E731
    else:
        jfn = lambda d: jfp.tfopt_fit_analysis(jp, res, d)  # noqa: E731
        pfn = lambda d: fp.tfopt_fit_analysis(tp, res, d)  # noqa: E731
    dj, dp = both(tmp_path / "fit", jfn, pfn, scaled=1e-9, tsne=True)
    got = written(dp)
    assert got == written(dj)
    assert {f"{which}_control_load_top.png", f"{which}_knockout_distribution.png",
            f"{which}_knockout_top_activating.png", "network_sankey.html",
            "important_connections.csv"} <= got

    book = tmp_path / "book" / f"{which}_results.xlsx"
    book.parent.mkdir()
    if which == "kinopt":
        ex.export_kinopt_results(str(book), tp, res, tmeta)
    else:
        ex.export_tfopt_results(str(book), tp, res)
    both(tmp_path / "book", lambda d: jfp.fit_analysis_from_workbook(str(book), d, which),
         lambda d: fp.fit_analysis_from_workbook(str(book), d, which), tsne=True)
    with pytest.raises(FileNotFoundError, match="sheet"):
        fp.fit_analysis_from_workbook(str(tmp_path / "none.xlsx"), str(tmp_path / "x"), which)
    with pytest.raises(ValueError, match="kind"):
        fp.fit_analysis_from_workbook(str(book), str(tmp_path / "x"), "other")


# ---------------------------------------------------------------------------
# the readout, KKT and scan figures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_signal_readout_figures_match_jax(tmp_path, weight_problems, which):  # noqa: F811
    from phoskintime_tpu.analysis import network_tools as jnt
    from phoskintime_tpu_torch.analysis import network_tools as nt

    w = weight_problems
    (jp, _), (tp, _) = w.kin if which == "kinopt" else w.tf
    res = w.kres if which == "kinopt" else w.tres
    read = f"{which}_signal_readout"
    jt = getattr(jnt, read)(jp, res.alpha, res.beta)
    pt = getattr(nt, read)(tp, res.alpha, res.beta)
    dj, dp = both(tmp_path, lambda d: jnt.plot_signal_readout(jt, d, which=which),
                  lambda d: nt.plot_signal_readout(pt, d, which=which), scaled=1e-9)
    assert len(written(dp)) == 5
    empty = {k: {c: np.asarray(v)[:0] for c, v in t.items()} for k, t in pt.items()}
    assert nt.plot_signal_readout(empty, str(tmp_path / "none"), which=which) == []


def test_network_tools_part3_raises():
    from phoskintime_tpu_torch import analysis
    from phoskintime_tpu_torch.analysis import network_tools as nt

    for name in ("kinopt_network_readout", "plot_network_dag", "cluster_curves"):
        with pytest.raises(NotImplementedError, match="8d-figures, part 3"):
            getattr(nt, name)
    for name in ("thermalize", "plot_identity_band", "compare_thermal_standard"):
        with pytest.raises(NotImplementedError, match="8d-figures, part 3"):
            getattr(analysis, name)
    with pytest.raises(AttributeError):
        nt.nothing_here  # noqa: B018


def test_kkt_figures_match_jax(tmp_path):
    """The constraint violations (alpha summed a gene, a kinase that is no
    substrate kept) and the sensitivity bars, against JAX's."""
    from phoskintime_tpu.kinopt import kkt as jkkt
    from phoskintime_tpu_torch.kinopt import kkt

    rng = np.random.default_rng(5)
    names = [("GB", "S1"), ("GA", "S2"), ("GA", "S3"), ("GC", "S1"), ("KX", "S1"),
             ("GD", "S9"), ("GE", "S1")]
    kn = ["KX", "KA", "GA", "KB", "KC", "KD"]
    av, bv = rng.normal(0, 0.1, len(names)), rng.normal(0, 0.1, len(kn))
    ja = pd.Series(av, index=pd.MultiIndex.from_tuples(names, names=["Gene", "Psite"]))
    jb = pd.Series(bv, index=pd.Index(kn, name="Gene"))
    sens = {"GeneID": np.array([g for g, _ in names], dtype=object),
            "Psite": np.array([s for _, s in names], dtype=object),
            "Sensitivity Mean": rng.uniform(size=7), "Max Sensitivity": rng.uniform(1, 2, 7),
            "Min Sensitivity": rng.uniform(0, 0.1, 7)}

    def jax_fn(d):
        jkkt.plot_constraint_violations(ja, jb, d)
        jkkt.plot_sensitivity_analysis(frame(sens), d)

    def port_fn(d):
        kkt.plot_constraint_violations(dict(zip(names, av)), dict(zip(kn, bv)), d)
        kkt.plot_sensitivity_analysis(sens, d)
    dj, dp = both(tmp_path, jax_fn, port_fn)
    assert written(dp) == {"constraint_violations.png", "sensitivity.png"}


@pytest.mark.parametrize("n_trials,pruned", [(7, (3, 5)), (3, (0,)), (2, (0, 1))])
def test_scan_report_plots_match_jax(tmp_path, n_trials, pruned):
    """``scan_report``'s history, importance (from 3 completed trials) and
    parallel coordinates (from 2)."""
    from phoskintime_tpu.network.scan import ScanTrial as JaxTrial
    from phoskintime_tpu.network.scan import scan_report as jax_scan_report
    from phoskintime_tpu_torch.network.scan import ScanTrial, scan_report

    rng = np.random.default_rng(n_trials)
    specs = [({k: float(v) for k, v in zip(("protein", "rna", "phospho", "prior"),
                                           rng.uniform(0.1, 10, 4))},
              float(rng.uniform(1, 5)), "pruned" if i in pruned else "complete",
              tuple(rng.uniform(0, 1, 3)), [(5, 2.0)], 5 * (i + 1)) for i in range(n_trials)]
    dj, dp = both(tmp_path, lambda d: jax_scan_report([JaxTrial(*s) for s in specs], d),
                  lambda d: scan_report([ScanTrial(*s) for s in specs], d))
    assert written(dp) == written(dj)
    assert "optimization_history.png" in written(dp)


def test_alpha_strips_stop_at_max_genes(tmp_path):
    """One alpha strip a shown mRNA, the first ``max_genes`` of them."""
    s = SimpleNamespace(
        tf={"Alpha Values": {"mRNA": np.array(["A", "A", "B"], dtype=object),
                             "TF": np.array(["T1", "T2", "T1"], dtype=object),
                             "Value": np.array([0.2, 0.5, 0.9])}})
    paths = fp.alpha_strips_per_mrna(s.tf["Alpha Values"], str(tmp_path), max_genes=1)
    assert [os.path.basename(p) for p in paths] == ["alpha_distribution_A.png"]
