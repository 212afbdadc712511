"""The port's data-in layer against the JAX package's, on the CPU: the
config loader, the CSV reader and column tables, ``load_data`` for every
scaling method, the preprocessing of raw files, ``get_protein_weights``,
``simulate_and_measure`` and ``build_y0_from_data``. The JAX package
reads with pandas; the port reads the same files with the ``csv`` module
into column dicts, in the same row order."""

import logging
import os
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.config import loader as jloader
from phoskintime_tpu.demo import GRID, RNA_GRID
from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.io import load as jload
from phoskintime_tpu.io import preprocess as jprep
from phoskintime_tpu.io import utils as jutils
from phoskintime_tpu.models.weights import get_protein_weights as jax_protein_weights
from phoskintime_tpu.network.simulate import simulate_and_measure as jax_measure
from phoskintime_tpu.network.steadystate import build_y0_from_data as jax_y0
from phoskintime_tpu_torch.config import loader, logconf
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.io import load, preprocess, utils
from phoskintime_tpu_torch.models.weights import get_protein_weights
from phoskintime_tpu_torch.network.simulate import simulate_and_measure
from phoskintime_tpu_torch.network.steadystate import build_y0_from_data
from phoskintime_tpu_torch.network.topology import build_topology

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# pandas' CSV float parser may round a last bit differently from float();
# the test files carry 12 significant digits, which pandas 3's default
# parser reads exactly (from about 13 on it can differ from the written
# value by up to ~1e-12 relative: test_read_csv_keeps_every_digit)
FLOAT_RTOL = 1e-15
CSV = dict(index=False, float_format="%.12g")
SCALINGS = ("raw", "none", "fc_start", "robust_fc", "max_scale", "mean_scale", "l2_norm")
TP = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0, 120.0, 240.0, 480.0,
               960.0])
TR = np.array([4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 240.0, 480.0, 960.0])


def columns_of(df: pd.DataFrame) -> dict:
    """A frame as the port's column table (strings as objects, a missing
    string None)."""
    out = {}
    for c in df.columns:
        v = df[c].to_numpy()
        if v.dtype.kind not in "fiub":
            v = np.asarray([None if (isinstance(x, float) and np.isnan(x)) else x for x in v],
                           dtype=object)
        out[c] = v
    return out


def assert_table(got: dict, want: pd.DataFrame, rtol=FLOAT_RTOL):
    """Every column of ``want`` in ``got``, the same rows in the same order;
    floats within ``rtol`` (NaN where NaN), anything else equal."""
    assert set(got) == {str(c) for c in want.columns}, (sorted(got), list(want.columns))
    for c in want.columns:
        w, g = want[c].to_numpy(), np.asarray(got[str(c)])
        assert len(g) == len(w), c
        if w.dtype.kind in "fiub" and g.dtype.kind in "fiub":
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=rtol, atol=0,
                                       err_msg=str(c))
        else:
            norm = lambda xs: [None if x is None or (isinstance(x, float) and np.isnan(x))
                               else x for x in xs]
            assert norm(g.tolist()) == norm(w.tolist()), c


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_from_toml_matches_jax():
    path = ROOT / "examples" / "config.toml"
    got, want = loader.PhosKinConfig.from_toml(path), jloader.PhosKinConfig.from_toml(path)
    names = [f.name for f in jloader.dataclasses.fields(want)]
    assert names == [f.name for f in loader.dataclasses.fields(got)]
    for n in names:
        assert getattr(got, n) == getattr(want, n), n
    assert loader.DEFAULT_BOUNDS == jloader.DEFAULT_BOUNDS
    assert loader.MODEL_NAMES == jloader.MODEL_NAMES


CONFIG = """
[paths]
data_dir = "data"

[global_model]
pop = 16
n_gen = 4
optimizer = "optuna"
use_initial_condition_from_data = true
scaling_method = "fc_start"
[global_model.timepoints]
protein = [0, 1, 2]
rna = [4, 8]
[global_model.bounds]
c_k = [0.5, 2.0]
[global_model.solver]
absolute_tolerance = 1e-6
max_timesteps = 1000
[global_model.models]
default_model = "combinatorial"

[kinopt]
lr = 0.1
[kinopt.opt]
steps = 10
tol = 1e-3
[kinopt.modes.evol]
lr = 0.5
[kinopt.modes.evol.opt]
steps = 20
"""


@pytest.mark.parametrize("mode", [None, "evol", "absent"])
def test_load_deep_merge_matches_jax(tmp_path, mode):
    (tmp_path / "config.toml").write_text(CONFIG)
    got = loader.load(mode, "kinopt", tmp_path / "config.toml")
    want = jloader.load(mode, "kinopt", tmp_path / "config.toml")
    assert got == want
    if mode == "evol":
        assert got["lr"] == 0.5 and got["opt"] == {"steps": 20, "tol": 1e-3}
    assert got["_paths"] == {"data_dir": "data"} and got["_root"] == str(tmp_path)


def test_from_toml_tables_match_jax(tmp_path):
    (tmp_path / "config.toml").write_text(CONFIG)
    got = loader.PhosKinConfig.from_toml(tmp_path / "config.toml")
    want = jloader.PhosKinConfig.from_toml(tmp_path / "config.toml")
    assert got == jloader.dataclasses.replace(want) or vars(got) == vars(want)
    assert got.model == 2 and got.time_points_protein == (0.0, 1.0, 2.0)
    assert got.bounds["c_k"] == (0.5, 2.0) and got.ode_max_steps == 1000


def test_find_config_walks_up(tmp_path):
    (tmp_path / "config.toml").write_text(CONFIG)
    deep = tmp_path / "a" / "b"
    deep.mkdir(parents=True)
    assert loader.find_config(deep) == jloader.find_config(deep) == tmp_path / "config.toml"
    with pytest.raises(FileNotFoundError):
        loader.find_config(deep, name="absent.toml")
    cwd = os.getcwd()
    os.chdir(deep)
    try:
        assert loader.load_config_toml()["_root"] == str(tmp_path)
    finally:
        os.chdir(cwd)


def test_setup_logger(tmp_path):
    log = logconf.setup_logger("phoskintime_tpu_torch.test", log_dir=tmp_path)
    assert logconf.setup_logger("phoskintime_tpu_torch.test", log_dir=tmp_path) is log
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert "hello" in (tmp_path / "phoskintime_tpu_torch.test.log").read_text()
    assert logconf.setup_logger().name == "phoskintime_tpu_torch"
    assert log.level == logging.INFO and not log.propagate


# ---------------------------------------------------------------------------
# the CSV reader and the small utilities
# ---------------------------------------------------------------------------

def test_read_csv_types_as_pandas(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b,c,d,e,f\n1,x,1.5,,3,NA\n2,,2.25,,4,n/a\n3,z,nan,,5.0,1e3\n")
    got, want = utils.read_csv(p), pd.read_csv(p)
    assert got["a"].dtype == np.int64 and got["c"].dtype == np.float64
    assert got["b"].tolist() == ["x", None, "z"] and np.isnan(got["d"]).all()
    assert_table(got, want)


def test_read_csv_keeps_every_digit(tmp_path):
    """The port reads back every float pandas writes (shortest repr, up to
    17 digits) exactly; pandas 3's default parser only within ~1e-12."""
    x = np.random.default_rng(0).uniform(0.01, 0.2, 2000)
    pd.DataFrame({"a": x}).to_csv(tmp_path / "x.csv", index=False)
    np.testing.assert_array_equal(utils.read_csv(tmp_path / "x.csv")["a"], x)
    np.testing.assert_allclose(pd.read_csv(tmp_path / "x.csv")["a"], x, rtol=1e-11)
    utils.write_csv(tmp_path / "y.csv", {"a": x, "b": np.asarray(["s"] * 2000, dtype=object)})
    assert (tmp_path / "y.csv").read_text().split("\n")[:3] == \
        ["a,b", f"{float(x[0])!r},s", f"{float(x[1])!r},s"]


@pytest.mark.parametrize("cell, upper, want", [("{K1, k2}", False, ["K1", "k2"]),
                                               ("{K1, k2}", True, ["K1", "K2"]),
                                               ("{}", False, []), ("K3", True, ["K3"]),
                                               ("{ A ,, B }", False, ["A", "B"])])
def test_parse_kinase_set_matches_jax(cell, upper, want):
    assert utils.parse_kinase_set(cell, upper) == jutils.parse_kinase_set(cell, upper) == want


@pytest.mark.parametrize("keys", [None, ["protein", "time"]])
def test_merge_obs_est_matches_jax(keys):
    obs = pd.DataFrame({"protein": ["A", "A", "B", "C"], "psite": ["", "", "", ""],
                        "time": [0.0, 1.0, 0.0, 0.0], "fc": [1.0, 2.0, 3.0, 4.0]})
    est = pd.DataFrame({"protein": ["B", "A", "A", "A"], "psite": ["", "", "", ""],
                        "time": [0.0, 1.0, 0.0, 1.0], "pred_fc": [2.5, 1.5, 0.5, 1.75]})
    want = jutils.merge_obs_est(obs, est, keys)
    got = utils.merge_obs_est(columns_of(obs), columns_of(est), keys)
    # the port keeps the left table's order (matches in the right's);
    # pandas' inner merge on several keys orders its rows otherwise, so the
    # rows are compared as a set
    assert got["protein"].tolist() == ["A", "A", "A", "B"]
    order = want.sort_values(list(want.columns)).index
    rows = sorted(zip(*(got[c].tolist() for c in want.columns)))
    assert rows == list(want.loc[order].itertuples(index=False, name=None))
    assert set(got) == set(want.columns)


def test_organize_output_files(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        d.mkdir()
        for name in ("x.png", "y.csv", "z.xlsx", "r.tex", "report.html", "keep.txt"):
            (d / name).write_text("1")
    assert sorted(utils.organize_output_files(a)) == sorted(jutils.organize_output_files(b))
    assert sorted(p.relative_to(a).as_posix() for p in a.rglob("*")) == \
        sorted(p.relative_to(b).as_posix() for p in b.rglob("*"))


def test_read_table_routes(tmp_path):
    """A plain CSV; an absent workbook through its sheet's CSV sibling; a
    workbook on disk without an Excel engine through the sibling too."""
    frame = pd.DataFrame({"Kinase": ["K1", "K2"], "Beta": [0.5, 1.25]})
    frame.to_csv(tmp_path / "plain.csv", **CSV)
    frame.to_csv(tmp_path / "res_beta_values.csv", **CSV)
    frame.to_csv(tmp_path / "disk_sheet1.csv", **CSV)
    with zipfile.ZipFile(tmp_path / "disk.xlsx", "w") as z:   # a workbook's signature
        z.writestr("xl/workbook.xml", "<workbook/>")
    for path, sheet in (("plain.csv", None), ("res.xlsx", "Beta Values"), ("disk.xlsx", None)):
        p = str(tmp_path / path)
        assert_table(load.read_table(p, sheet), jload.read_table(p, sheet))
    assert load.read_table(str(tmp_path / "none.xlsx"), "Alpha Values") is None
    assert load.read_table(None) is None and jload.read_table(None) is None


# ---------------------------------------------------------------------------
# load_data
# ---------------------------------------------------------------------------

def write_project(root: Path) -> dict:
    """tests/test_cli.py:76-98's project, with what the loader must
    handle: lower-case IDs, a duplicated kinase edge, a two-kinase set, a
    missing and a non-numeric cell, a zero first value, a site written
    "nan", and kinopt/tfopt Alpha and Beta sheets as CSV siblings."""
    rng = np.random.default_rng(0)

    def wide(genes, psites, n=14):
        d = {"GeneID": genes, "Psite": psites}
        for i in range(1, n + 1):
            d[f"x{i}"] = rng.uniform(0.5, 2.0, len(genes))
        return pd.DataFrame(d)

    input1 = wide(["GA", "GA", "GA", "gb", "GB", "KIN1", "KIN1", "KIN2"],
                  ["", "S_10", "T_20", "", "S_5", "", "S_99", "nan"])
    input1 = input1.astype({"x3": object})
    input1.loc[1, "x3"] = "n.d."
    input1.loc[2, "x5"] = np.nan
    input1.loc[4, "x1"] = 0.0
    input1.to_csv(root / "input1.csv", **CSV)
    pd.DataFrame({
        "GeneID": ["GA", "GA", "GB", "ga"],
        "Psite": ["S_10", "T_20", "S_5", "S_10"],
        "Kinase": ["{KIN1}", "{KIN1, kin2}", "{KIN1}", "{kin1}"],
    }).to_csv(root / "input2.csv", **CSV)
    wide(["GA", "GB", "KIN1", "KIN2"], None, n=9).drop(columns=["Psite"]).assign(
        x10=1.0).to_csv(root / "input3.csv", **CSV)
    pd.DataFrame({"Source": ["GA", "GB", "KIN2", "GA"], "Target": ["GB", "GA", "GA", "GB"]}
                 ).to_csv(root / "input4.csv", **CSV)
    pd.DataFrame({"Gene": ["GA", "GA", "GB"], "Psite": ["S_10", "T_20", "S_5"],
                  "Kinase": ["KIN1", "KIN2", "KIN1"], "Alpha": [0.7, 0.4, 1.0]}
                 ).to_csv(root / "kinopt_results_alpha_values.csv", **CSV)
    pd.DataFrame({"Kinase": ["KIN1", "KIN1", "KIN2"], "Psite": ["", "S_99", ""],
                  "Beta": [0.9, 0.3, 0.6]}
                 ).to_csv(root / "kinopt_results_beta_values.csv", **CSV)
    pd.DataFrame({"mRNA": ["GB", "GA"], "TF": ["GA", "GB"], "Value": [0.8, 0.2]}
                 ).to_csv(root / "tfopt_results_alpha_values.csv", **CSV)
    pd.DataFrame({"TF": ["GA", "GB", "GA"], "PSite": ["", "", "S_10"], "Value": [0.5, 0.25, 2.0]}
                 ).to_csv(root / "tfopt_results_beta_values.csv", **CSV)
    return {"kinase_net": root / "input2.csv", "tf_net": root / "input4.csv",
            "ms": root / "input1.csv", "rna": root / "input3.csv",
            "kinopt_path": str(root / "kinopt_results.xlsx"),
            "tfopt_path": str(root / "tfopt_results.xlsx")}


@pytest.mark.parametrize("scaling", SCALINGS)
def test_load_data_matches_jax(tmp_path, scaling):
    paths = write_project(tmp_path)
    kw = dict(time_points_protein=TP, time_points_rna=TR, scaling_method=scaling)
    got = load.load_data(**paths, **kw)
    want = jload.load_data(**paths, **kw)
    for g, w in zip(got[:5], want[:5]):
        assert_table(g, w)
    for g, w in zip(got[5:], want[5:]):
        assert g == w
    assert len(got[2]["fc"]) and len(got[3]["fc"]) and len(got[4]["fc"])
    # the maps reach the tables
    assert got[0]["alpha"].tolist().count(1.0) < len(got[0]["alpha"])


def test_load_data_feeds_topology(tmp_path):
    """build_topology of the loaded column tables equals the JAX package's
    of its frames."""
    from phoskintime_tpu.network.topology import build_topology as jax_topology

    paths = write_project(tmp_path)
    kw = dict(time_points_protein=TP, time_points_rna=TR)
    kin, tf, *_, kb, tb, ka, te = load.load_data(**paths, **kw)
    jkin, jtf, *_, jkb, jtb, jka, jte = jload.load_data(**paths, **kw)
    got = build_topology(kin, tf, kin_beta_map=kb, tf_beta_map=tb, kin_alpha=ka,
                         tf_edge_weights=te)
    want = jax_topology(jkin, jtf, kin_beta_map=jkb, tf_beta_map=jtb, kin_alpha=jka,
                        tf_edge_weights=jte)
    assert got.proteins == want.proteins and got.kinases == want.kinases
    assert got.sites == want.sites and got.proxy_map == want.proxy_map
    np.testing.assert_array_equal(got.W_pad, want.W_pad)
    np.testing.assert_array_equal(got.tf_mat, want.tf_mat)


@pytest.mark.parametrize("method", SCALINGS)
def test_process_and_scale_matches_jax(method):
    """Rows with missing values, an all-missing row and a zero row."""
    rng = np.random.default_rng(3)
    M = rng.uniform(0.1, 3.0, (5, 6))
    M[1, 2] = np.nan
    M[2] = np.nan
    M[3] = 0.0
    df = pd.DataFrame(M, columns=[f"x{i}" for i in (1, 2, 3, 4, 5, 10)])
    df.insert(0, "protein", [" a", "b", "c", "d", "e"])
    want = jload.process_and_scale_raw_data(df, TP[:5], ["protein"], method)
    got = load.process_and_scale_raw_data(columns_of(df), TP[:5], ["protein"], method)
    assert_table(got, want)


def test_process_and_scale_rejects_unknown():
    df = {"protein": np.asarray(["A"], dtype=object), "x1": np.ones(1)}
    with pytest.raises(ValueError, match="Unknown"):
        load.process_and_scale_raw_data(df, [0.0], ["protein"], "nope")
    assert load.n_rows(load.process_and_scale_raw_data({"protein": df["protein"]}, [0.0],
                                                       ["protein"])) == 0


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def write_raw(root: Path) -> None:
    rng = np.random.default_rng(4)
    rows = []
    for gene, site in (("G1", ""), ("G1", "s_10"), ("G1", "X_3"), ("G2", "t_7"), ("G2", None),
                       ("G3", "Y_1")):
        for t in range(14):
            rows.append((gene, site, t, rng.normal(), abs(rng.normal()) * 0.1))
    rows.append(("G1", "s_10", 3, 9.0, 0.5))           # a second value: the first is kept
    rows.append(("G3", "Y_1", 5, np.nan, 0.1))
    pd.DataFrame(rows, columns=["GeneID", "site", "unit_time", "predict_mean", "predict_std"]
                 ).to_csv(root / "MS_Gaussian_updated_09032023.csv", **CSV)
    pd.DataFrame({"GeneID": ["G1", "G2", "G3"], "Psite": ["S_10", "T_7", "Y_1"],
                  "Kinase": ["{K1}", "{K1, K2}", "{K2}"]}).to_csv(root / "input2.csv",
                                                                  **CSV)
    pd.DataFrame({"source": ["TF1", "COMPLEX:X", "TF2", "TF1", "TF3", "TF4"],
                  "source_genesymbol": ["TF1", "CX", "TF2", "TF1", "", None],
                  "target_genesymbol": ["G1", "G2", "G9", "G1", "G2", "G3"]}
                 ).to_csv(root / "CollecTRI.csv", **CSV)
    lim = [(g, t, rng.normal()) for g in ("G2", "G1") for t in (4, 8, 15, 30)]
    pd.DataFrame(lim, columns=["GeneID", "unit_time", "logFC"]).to_csv(
        root / "Rout_LimmaTable.csv", **CSV)


@pytest.mark.parametrize("mapping", [None, {"G1": "GENE1", "G2": "GENE2"}])
def test_run_cleanup_matches_jax(tmp_path, mapping):
    raw, out_j, out_t = tmp_path / "raw", tmp_path / "j", tmp_path / "t"
    for d in (raw, out_j, out_t):
        d.mkdir()
    write_raw(raw)
    want = jprep.run_cleanup(raw, out_j, gene_mapping=mapping)
    got = preprocess.run_cleanup(raw, out_t, gene_mapping=mapping)
    assert sorted(got) == sorted(want) == sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in want:
        assert_table(got[name], want[name])
        # both write floats as their shortest repr: the same text
        assert (out_t / name).read_text() == (out_j / name).read_text(), name


def test_process_functions_match_jax(tmp_path):
    write_raw(tmp_path)
    ms = pd.read_csv(tmp_path / "MS_Gaussian_updated_09032023.csv")
    msc = utils.read_csv(tmp_path / "MS_Gaussian_updated_09032023.csv")
    assert_table(preprocess.process_msgauss(msc), jprep.process_msgauss(ms))
    assert_table(preprocess.process_msgauss_std(msc), jprep.process_msgauss_std(ms))
    ct, i2 = (pd.read_csv(tmp_path / n) for n in ("CollecTRI.csv", "input2.csv"))
    assert_table(preprocess.process_collecttri(columns_of(ct), columns_of(i2)),
                 jprep.process_collecttri(ct, i2))
    lim = pd.read_csv(tmp_path / "Rout_LimmaTable.csv")
    for log2 in (None, False):
        assert_table(preprocess.process_routlimma(columns_of(lim), log2=log2),
                     jprep.process_routlimma(lim, log2=log2))
    for s in ("", "s_10", "t", "Y_1_a", None, np.nan):
        assert preprocess.format_site(s) == jprep.format_site(s)


# ---------------------------------------------------------------------------
# get_protein_weights
# ---------------------------------------------------------------------------

def weight_tables(tmp_path):
    rng = np.random.default_rng(5)
    rows = [("GA", ""), ("GA", "S_1"), ("GA", "T_2"), ("GB", "S_3"), ("GC", ""), ("GC", ""),
            ("GD", "S_9")]
    wstd = pd.DataFrame(rows, columns=["GeneID", "Psite"])
    for i in range(1, 15):
        wstd[f"x{i}_std"] = rng.uniform(0.01, 0.2, len(rows))
    wstd[" x0"] = 0.0     # a column the function ignores; its name stripped
    i2 = pd.DataFrame({"GeneID": ["GA", "GA", "GB", "GB", "GC", "GD", "GE"],
                       "Psite": ["T_2", "S_1", "S_3", "", "S_5", "S_9", "S_1"],
                       "Kinase": ["{K}"] * 7})
    wstd.to_csv(tmp_path / "wstd.csv", **CSV)
    i2.to_csv(tmp_path / "i2.csv", **CSV)
    return ((pd.read_csv(tmp_path / "wstd.csv"), pd.read_csv(tmp_path / "i2.csv")),
            (utils.read_csv(tmp_path / "wstd.csv"), utils.read_csv(tmp_path / "i2.csv")))


@pytest.mark.parametrize("gene", ["GA", "GB", "GC", "GD", "GX", "GE"])
def test_get_protein_weights_matches_jax(tmp_path, gene):
    """GA: its own protein row then its sites in input2's order; GB: input2's
    protein row; GC: duplicate protein rows; GD: no protein row; GX: not
    in input2; GE: a site without a std row. The raises are the JAX
    package's."""
    (jw, ji2), (tw, ti2) = weight_tables(tmp_path)
    try:
        want = jax_protein_weights(gene, jw, ji2)
    except ValueError:
        with pytest.raises(ValueError):
            get_protein_weights(gene, tw, ti2)
        assert gene != "GA"
        return
    got = get_protein_weights(gene, tw, ti2)
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL)
    assert gene in ("GA", "GB") and len(got) % 14 == 0
    np.testing.assert_array_equal(get_protein_weights(gene, jw, ji2), got)


# ---------------------------------------------------------------------------
# simulate_and_measure and build_y0_from_data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demos():
    out = {}
    for model in (0, 2):
        bj = jax_demo(n_proteins=10, n_kinases=4, model=model, seed=0, dtype=np.float64)
        out[model] = bj, from_reference(bj["system"], device="cpu")
    return out


@pytest.mark.parametrize("model", [0, 2])
@pytest.mark.parametrize("grids", ["demo", "subset"])
def test_simulate_and_measure_matches_jax(demos, model, grids):
    bj, system = demos[model]
    tp, tr, tph = (GRID, RNA_GRID, GRID) if grids == "demo" else (GRID[:6], RNA_GRID[3:],
                                                                   GRID[::2])
    y0 = None if grids == "demo" else bj["system"].y0() * 1.1
    want = jax_measure(bj["system"], bj["true"], tp, tr, tph, y0=y0)
    got = simulate_and_measure(system, from_reference(bj["true"]), tp, tr, tph, y0=y0)
    for g, w in zip(got, want):
        assert_table(g, w.reset_index(drop=True), rtol=1e-9)


def tables_of(bj) -> tuple:
    return tuple(columns_of(bj[k]) for k in ("df_prot", "df_rna", "df_pho"))


@pytest.mark.parametrize("model", [0, 2])
def test_build_y0_from_data_matches_jax(demos, model):
    """The demo's tables plus replicates at t = 0 (averaged) and a missing
    fold change (skipped)."""
    bj, system = demos[model]
    dfp, dfr, dfph = (bj[k].copy() for k in ("df_prot", "df_rna", "df_pho"))
    first = dfp[dfp["time"] == 0.0].iloc[:3].assign(fc=lambda d: d["fc"] * 1.3)
    dfp = pd.concat([dfp, first, first.assign(fc=np.nan)], ignore_index=True)
    dfph = pd.concat([dfph, dfph[dfph["time"] == 0.0].iloc[:4].assign(fc=0.2)],
                     ignore_index=True)
    want = jax_y0(bj["topo"], dfp, dfr, dfph)
    got = build_y0_from_data(system.topo, columns_of(dfp), columns_of(dfr), columns_of(dfph))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    assert got.shape == (system.topo.N, system.topo.width)
    np.testing.assert_array_equal(build_y0_from_data(system.topo, dfp, dfr, dfph), got)


def test_build_y0_without_data(demos):
    bj, system = demos[0]
    got = build_y0_from_data(system.topo, None, None, None)
    np.testing.assert_array_equal(got, jax_y0(bj["topo"], None, None, None))


def test_build_y0_rna_tie_takes_first_row(demos):
    """Two RNA replicates at a protein's earliest time: the port takes the
    first in the table's order (the JAX package's unstable sort leaves it
    undefined); a later time never wins."""
    bj, system = demos[0]
    gene = system.topo.proteins[0]
    rna = {"protein": np.asarray([gene, gene, gene], dtype=object),
           "time": np.asarray([8.0, 4.0, 4.0]), "fc": np.asarray([9.0, 2.5, 3.5])}
    got = build_y0_from_data(system.topo, None, rna, None)
    assert got[0, 0] == 2.5
    swapped = {k: v[[0, 2, 1]] for k, v in rna.items()}
    assert build_y0_from_data(system.topo, None, swapped, None)[0, 0] == 3.5
