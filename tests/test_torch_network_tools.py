"""``analysis/network_tools.py``'s tables, clustering and figures against the
JAX package (and scikit-learn) on the CPU at float64.

The same seeded sheets go through both packages (DataFrames for JAX, column
dicts for the port): the tables are held equal column by column, text
exactly and numbers at rtol 1e-12, rows in order (pandas' sorted
``groupby``, its quicksort of ``total_alpha`` with ties, its outer-join
order of ``concat``); ``cluster_curves`` is held to scikit-learn's
``AgglomerativeClustering(metric="precomputed", linkage="average")``
labels exactly, ties and ``n_clusters >= n`` included; the figures by
their records (``tests/torch_figures.py``).
"""

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import AgglomerativeClustering
from torch_figures import assert_same_records, capture_jax, capture_port

import phoskintime_tpu.analysis.network_tools as jnt
from phoskintime_tpu_torch.analysis import network_tools as nt
from phoskintime_tpu_torch.demo import build_demo_network

RTOL = 1e-12


def frame(table):
    return pd.DataFrame({k: list(v) for k, v in table.items()})


def assert_same_table(got: dict, want: pd.DataFrame, name=""):
    """Columns in order, each row in order: numbers at ``RTOL`` (NaN where
    NaN), text exactly (a missing cell None for NaN)."""
    assert list(got) == list(want.columns), (name, list(got), list(want.columns))
    for c in want.columns:
        w, g = want[c].to_numpy(), np.asarray(got[c])
        assert len(g) == len(w), (name, c)
        if w.dtype.kind in "fiub":
            assert g.dtype.kind in "fiub", (name, c, g.dtype)
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=RTOL, atol=0,
                                       equal_nan=True, err_msg=f"{name}:{c}")
        else:
            want_text = [None if (isinstance(v, float) and np.isnan(v)) else v for v in w]
            assert g.tolist() == want_text, (name, c, g.tolist(), want_text)


def kin_sheets(seed: int, ties: bool, globals_: bool):
    """Alpha and Beta Values sheets of kinopt's schema: 16 edges over 5
    kinases, rounded alphas where ``ties`` (equal total |alpha|), the
    per-kinase global betas (empty Psite) where ``globals_``, a NaN."""
    rng = np.random.default_rng(seed)
    n = 16
    kin = rng.choice(["KC", "KA", "KB", "KE", "KD"], n)
    alpha = np.round(rng.uniform(-1, 1, n), 0 if ties else 12)
    if ties:
        kin = np.array(["KC", "KA", "KB", "KE"] * 4)
        alpha = np.array([1.0, -1.0, 1.0, 0.5] * 4)
    a = {"Gene": np.array([f"G{int(v)}" for v in rng.integers(0, 6, n)], dtype=object),
         "Psite": np.array([f"S{int(v)}" for v in rng.integers(1, 4, n)], dtype=object),
         "Kinase": kin.astype(object), "Alpha": alpha}
    a["Alpha"][3] = np.nan
    bk = ["KA", "KB", "KA", "KC", "KF", "KB"]
    b = {"Kinase": np.array(bk, dtype=object),
         "Psite": np.array(["", "S1", "S2", "", "", ""] if globals_ else ["S1"] * 6,
                           dtype=object),
         "Beta": rng.uniform(-2, 2, len(bk))}
    return a, b


@pytest.mark.parametrize("seed,ties,globals_", [(0, False, True), (1, True, True),
                                                (2, False, False)])
def test_kinopt_network_readout_matches_jax(seed, ties, globals_):
    a, b = kin_sheets(seed, ties, globals_)
    assert_same_table(nt.kinopt_network_readout(a, b),
                      jnt.kinopt_network_readout(frame(a), frame(b)))


@pytest.mark.parametrize("seed,ties", [(3, False), (4, True)])
def test_tfopt_network_readout_matches_jax(seed, ties):
    a, b = kin_sheets(seed, ties, True)
    ta = {"mRNA": a["Gene"], "TF": a["Kinase"], "Value": a["Alpha"]}
    tb = {"TF": b["Kinase"], "PSite": b["Psite"], "Value": b["Beta"]}
    assert_same_table(nt.tfopt_network_readout(ta, tb),
                      jnt.tfopt_network_readout(frame(ta), frame(tb)))


@pytest.fixture(scope="module")
def demo():
    return build_demo_network(8, 4, seed=3, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("center,radius", [("P000", 1), ("P003", 2), ("K01", 1)])
def test_export_subnetwork_matches_jax(demo, center, radius):
    """The same topology through both functions (JAX's reads it by
    attribute): the edges in order, each once, and the nodes."""
    topo = demo["topo"]
    got, nodes = nt.export_subnetwork(topo, center, radius)
    want, want_nodes = jnt.export_subnetwork(topo, center, radius)
    assert len(want) > 0
    assert_same_table(got, want.reset_index(drop=True))
    assert nodes == want_nodes


def curves_of(seed, n, lengths=(9,)):
    rng = np.random.default_rng(seed)
    return {f"c{i}": np.column_stack([np.arange(lengths[i % len(lengths)], dtype=float),
                                      rng.normal(size=lengths[i % len(lengths)])])
            for i in range(n)}


@pytest.mark.parametrize("lengths", [(9,), (6, 9, 7)])
def test_curve_similarity_matrix_matches_jax(lengths):
    """Every pair's Fréchet distance (pairs of one shape in one batched
    DP) against JAX's pair-by-pair loop."""
    curves = curves_of(5, 7, lengths)
    got = nt.curve_similarity_matrix(curves, device="cpu")
    want = jnt.curve_similarity_matrix(curves)
    assert list(got["curve"]) == list(want.index)
    names, D = nt.similarity_matrix(got)
    np.testing.assert_allclose(D, want.to_numpy(), rtol=RTOL, atol=0)
    assert names == list(want.columns)


def test_curve_similarity_batches_each_shape_once(monkeypatch):
    """All pairs of one shape go through one ``frechet_distance`` call."""
    from phoskintime_tpu_torch.ops import frechet

    calls = []
    real = frechet.frechet_distance
    monkeypatch.setattr(frechet, "frechet_distance",
                        lambda a, b: calls.append(a.shape[0]) or real(a, b))
    nt.curve_similarity_matrix(curves_of(1, 10), device="cpu")
    assert calls == [45]


def distance_matrix(seed: int, n: int, ties: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, 2)).astype(float) if ties else rng.normal(size=(n, 3))
    D = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    return np.round(D) if ties else D


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ties", [False, True])
def test_cluster_curves_matches_sklearn(seed, ties):
    """The labels as scikit-learn numbers them, for 2..n + 2 clusters (a
    count above n cut to n), and JAX's ``cluster_curves`` on the same
    matrix."""
    n = 3 + seed
    D = distance_matrix(seed, n, ties)
    names = [f"c{i}" for i in range(n)]
    sim = {"curve": np.array(names, dtype=object), **{k: D[:, j] for j, k in enumerate(names)}}
    for k in range(1, n + 3):
        want = AgglomerativeClustering(n_clusters=min(k, n), metric="precomputed",
                                       linkage="average").fit_predict(D)
        got = nt.cluster_curves(sim, n_clusters=k)
        np.testing.assert_array_equal(got["cluster"], want, err_msg=f"k={k}")
        assert list(got["curve"]) == names
    jax_labels = jnt.cluster_curves(pd.DataFrame(D, index=names, columns=names), n_clusters=2)
    np.testing.assert_array_equal(nt.cluster_curves(sim, 2)["cluster"], jax_labels.to_numpy())


def test_average_linkage_matches_scipy():
    from scipy.cluster.hierarchy import linkage
    from scipy.spatial.distance import squareform

    for seed in range(4):
        D = distance_matrix(seed, 9, seed % 2 == 1)
        np.testing.assert_allclose(nt.average_linkage(D),
                                   linkage(squareform(D, checks=False), method="average"),
                                   rtol=1e-14)


def test_cluster_curves_refuses_one_curve():
    with pytest.raises(ValueError, match="at least 2"):
        nt.cluster_curves({"curve": np.array(["a"], dtype=object), "a": np.zeros(1)})


def interaction_tables(seed: int):
    rng = np.random.default_rng(seed)
    kin = {"protein": np.array([f"G{int(v)}" for v in rng.integers(0, 6, 14)], dtype=object),
           "psite": np.array([f"S{int(v)}" for v in rng.integers(1, 4, 14)], dtype=object),
           "kinase": np.array([f"K{int(v)}" for v in rng.integers(0, 4, 14)], dtype=object)}
    tf = {"tf": np.array([f"T{int(v)}" for v in rng.integers(0, 3, 9)], dtype=object),
          "target": np.array([f"G{int(v)}" for v in rng.integers(3, 10, 9)], dtype=object)}
    return kin, tf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_tf_kin_counts_matches_jax(seed):
    kin, tf = interaction_tables(seed)
    assert_same_table(nt.analyze_tf_kin_counts(kin, tf),
                      jnt.analyze_tf_kin_counts(frame(kin), frame(tf)))


@pytest.mark.parametrize("seed", [0, 1])
def test_map_priors_matches_jax(seed):
    a, _ = kin_sheets(seed, False, True)
    a["Alpha"][3] = 0.5
    rng = np.random.default_rng(seed)
    tf = {"mRNA": np.array(["G9", "G1", "G7", "G1", "G0"], dtype=object),
          "TF": np.array(["T1", "T2", "T0", "T0", "T3"], dtype=object),
          "Value": rng.uniform(-3, 3, 5)}
    assert_same_table(nt.map_priors(a, tf), jnt.map_priors(frame(a), frame(tf)))


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def both(tmp_path, jax_fn, port_fn):
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dp.mkdir()
    with capture_jax() as want:
        jax_fn(dj)
    with capture_port() as got:
        port_fn(dp)
    assert_same_records(got, want, dp, dj)


@pytest.mark.parametrize("labels", [True, False])
def test_identity_band_matches_jax(tmp_path, labels):
    rng = np.random.default_rng(7)
    obs = rng.uniform(0, 2, 40)
    est = obs + rng.normal(0, 0.1, 40)
    lab = np.array([f"n{i}" for i in range(40)]) if labels else None
    both(tmp_path, lambda d: jnt.plot_identity_band(obs, est, str(d / "b.png"), labels=lab),
         lambda d: nt.plot_identity_band(obs, est, str(d / "b.png"), labels=lab))


def test_breadth_vs_load_matches_jax(tmp_path):
    a, b = kin_sheets(0, False, True)
    a["Alpha"] = a["Alpha"] * 3
    ro = nt.kinopt_network_readout(a, b)
    jro = jnt.kinopt_network_readout(frame(a), frame(b))
    both(tmp_path, lambda d: jnt.plot_breadth_vs_load(jro, str(d / "l.png")),
         lambda d: nt.plot_breadth_vs_load(ro, str(d / "l.png")))


def test_network_dag_matches_jax(tmp_path):
    a, _ = kin_sheets(1, False, True)
    edges = {"source": a["Kinase"], "target": a["Gene"], "weight": np.nan_to_num(a["Alpha"])}
    both(tmp_path, lambda d: jnt.plot_network_dag(frame(edges), str(d / "g.png"), title="t"),
         lambda d: nt.plot_network_dag(edges, str(d / "g.png"), title="t"))


def test_temporal_sensitivity_heatmap_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    S = rng.uniform(0, 1, (14, 5))
    times = [0, 0.5, 1, 2, 4, 8, 16, 30, 60, 120, 240, 480, 960, 1200]
    names = [f"p{i}" for i in range(5)]
    both(tmp_path, lambda d: jnt.temporal_sensitivity_heatmap(S, names, times, str(d / "h.png")),
         lambda d: nt.temporal_sensitivity_heatmap(S, names, times, str(d / "h.png")))


def test_analysis_package_exports_what_jax_exports():
    import phoskintime_tpu.analysis as ja
    import phoskintime_tpu_torch.analysis as pa

    public = [n for n in dir(ja) if not n.startswith("_")]
    missing = [n for n in public if not hasattr(pa, n)]
    assert not missing, missing
