"""The port's result exporters against the JAX package's, on the CPU.

The same seeded inputs go through both packages' exporters; the JAX
package writes its CSV fallback (no Excel engine here), the port its CSV
files. Every file is compared after parsing, both sides read by the port's
exact reader: the same file names, the same columns in order, the same
rows, numbers within 1e-12 relative for the table exporters and 1e-9 (of
each column's largest magnitude) for computed outputs, text equal. JSON,
``.npy``, ``.npz`` and pickles are compared by value, LaTeX by text, HTML
by :func:`assert_same_html` (the page byte for byte, its embedded JSON by
value, its embedded images masked). The PNG, PDF and GIF files are left
out of these comparisons: ``tests/test_torch_figures.py`` holds what each
figure draws to JAX's.

The 7-protein project of input files and a config comes from
``tests/torch_project.py``, which imports no JAX (the card's tests use it).
"""

import json
import os
import pickle
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.io import export as jex
from phoskintime_tpu.network.system import GlobalSystem as JaxSystem
from phoskintime_tpu.network.topology import build_topology as jax_topology
from torch_figures import assert_same_records, capture_jax, capture_port
from torch_project import SITES, TF_EDGES, write_project

from phoskintime_tpu_torch.io import export as ex
from phoskintime_tpu_torch.io.load import read_table
from phoskintime_tpu_torch.io.utils import read_csv
from phoskintime_tpu_torch.network.params import init_raw_params, unpack_params
from phoskintime_tpu_torch.network.system import GlobalSystem, default_params
from phoskintime_tpu_torch.network.topology import build_topology

torch.set_num_threads(2)

TP = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0, 120.0, 240.0, 480.0,
               960.0])
TR = np.array([4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 240.0, 480.0, 960.0])
RTOL_TABLE = 1e-12      # exporters: the same numbers, written and parsed
RTOL_COMPUTED = 1e-9    # computed outputs (simulations, fits), float64
FIGURE_SUFFIXES = (".png", ".pdf", ".gif", ".mp4")
#: the HTML writers' own rounding unit (``report/interactive.py``'s
#: ``_round(a, nd=4)``): a value the two packages compute alike to 1e-12 can
#: round to two neighbouring last digits
ATOL_HTML = 1e-4
#: an embedded JSON payload: ``window.__NAME__ = {...};`` up to its script's end
PAYLOAD = re.compile(r"(window\.__\w+__ = )(\{.*?\});</script>", re.DOTALL)
#: the report's time stamp
GENERATED = re.compile(r"<p>Generated \d{4}-\d\d-\d\d \d\d:\d\d</p>")
#: an image embedded in a page (its pixels are each package's own)
EMBEDDED_PNG = re.compile(r"data:image/png;base64,[A-Za-z0-9+/=]*")

# ---------------------------------------------------------------------------
# file comparison
# ---------------------------------------------------------------------------

def written(d: Path) -> set:
    return {str(p.relative_to(d)) for p in d.rglob("*") if p.is_file()}


def assert_close(got, want, rtol, name, atol=None):
    """Elementwise within ``rtol``; for a computed output (``rtol`` above
    the exporters') also within ``rtol`` of the largest magnitude, or
    within ``atol`` where one is given."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    ok = ~np.isnan(want)
    scale = np.max(np.abs(want[ok & np.isfinite(want)]), initial=0.0)
    if atol is None:
        atol = 0.0 if rtol == RTOL_TABLE else rtol * scale
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=name)


def assert_same_value(got, want, rtol, name):
    """Nested values: dicts and sequences by element, numbers at ``rtol``."""
    if isinstance(want, dict):
        assert list(got) == list(want), name
        for k in want:
            assert_same_value(got[k], want[k], rtol, f"{name}[{k}]")
    elif isinstance(want, (list, tuple)) and not all(isinstance(x, (int, float)) for x in want):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_value(g, w, rtol, f"{name}[{i}]")
    elif isinstance(want, pd.DataFrame):
        assert list(got) == list(want.columns), name
        for c in want.columns:
            w, g = want[c].to_numpy(), np.asarray(got[c])
            if w.dtype.kind in "fiub":
                assert_close(g, w, rtol, f"{name}[{c}]")
            else:
                assert g.tolist() == w.tolist(), f"{name}[{c}]"
    elif isinstance(want, (str, bool, type(None), slice)):
        assert got == want, name
    else:
        assert_close(got, want, rtol, name)


def split_html(text: str) -> tuple[str, list]:
    """A page as (its text with every embedded JSON payload, embedded PNG
    and the time stamp replaced by a marker, the payloads parsed)."""
    payloads = [json.loads(m.group(2)) for m in PAYLOAD.finditer(text)]
    text = EMBEDDED_PNG.sub("data:image/png;base64,@", text)
    return GENERATED.sub("<p>Generated</p>", PAYLOAD.sub(r"\1@;</script>", text)), payloads


def assert_same_json(got, want, atol: float, name: str):
    """Parsed JSON: the same structure, keys in order, strings, booleans
    and nulls equal, numbers within ``atol``."""
    if isinstance(want, dict):
        assert list(got) == list(want), name
        for k in want:
            assert_same_json(got[k], want[k], atol, f"{name}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, atol, f"{name}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and not isinstance(got, bool), name
        assert abs(got - want) <= atol or got == want, (name, got, want)
    else:
        assert got == want, (name, got, want)


def assert_same_html(got: str, want: str, name: str, atol: float = ATOL_HTML):
    """Two pages: equal byte for byte outside their embedded JSON payloads
    and the report's time stamp, the payloads equal by
    :func:`assert_same_json` at ``atol``."""
    (g_text, g_json), (w_text, w_json) = split_html(got), split_html(want)
    assert g_text == w_text, name
    assert len(g_json) == len(w_json), name
    for i, (g, w) in enumerate(zip(g_json, w_json)):
        assert_same_json(g, w, atol, f"{name}:payload{i}")


def assert_same_csv(got_path, want_path, rtol, atols=None):
    got, want = read_csv(got_path), read_csv(want_path)
    assert list(got) == list(want), (got_path, list(got), list(want))
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert len(g) == len(w), (got_path, c)
        if w.dtype.kind in "fiub" and g.dtype.kind in "fiub":
            assert_close(g, w, rtol, f"{got_path}:{c}", (atols or {}).get(c))
        else:
            assert g.tolist() == w.tolist(), (got_path, c)


def assert_same_files(got_dir: Path, want_dir: Path, rtol: float, pending=(), rtols=None,
                      atols=None, pages=None):
    """Every file JAX wrote but its figures (and ``pending``) was written by
    the port, and no other file but figures; each the same after parsing,
    at ``rtol`` or at ``rtols[name]``, a CSV column at
    ``atols[name][column]`` where given, an HTML page by
    ``pages[name](got, want)`` where given."""
    want = {f for f in written(want_dir) if not f.endswith(FIGURE_SUFFIXES)} - set(pending)
    got = {f for f in written(got_dir) if not f.endswith(FIGURE_SUFFIXES)}
    assert want and got == want, (sorted(got - want), sorted(want - got))
    for f in sorted(want):
        g, w = got_dir / f, want_dir / f
        tol = (rtols or {}).get(f, rtol)
        if f.endswith(".csv"):
            assert_same_csv(g, w, tol, (atols or {}).get(f))
        elif f.endswith(".json"):
            assert_same_value(json.loads(g.read_text()), json.loads(w.read_text()), tol, f)
        elif f.endswith(".npy"):
            assert_close(np.load(g), np.load(w), tol, f)
        elif f.endswith(".npz"):
            a, b = np.load(g), np.load(w)
            assert sorted(a.files) == sorted(b.files), f
            for k in b.files:
                assert_close(a[k], b[k], tol, f"{f}:{k}")
        elif f.endswith(".pkl"):
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert_same_value(pickle.load(fg), pickle.load(fw), tol, f)
        elif f.endswith(".html"):
            (pages or {}).get(f, lambda a, b: assert_same_html(a, b, f))(g.read_text(),
                                                                      w.read_text())
        else:
            assert g.read_text() == w.read_text(), f


# ---------------------------------------------------------------------------
# a small network in both packages
# ---------------------------------------------------------------------------

def frame(table: dict) -> pd.DataFrame:
    return pd.DataFrame({k: list(v) if np.asarray(v).dtype == object else v
                         for k, v in table.items()})


@pytest.fixture(scope="module")
def net():
    rng = np.random.default_rng(1)
    kin = {"protein": [], "psite": [], "kinase": []}
    for g, sites in SITES.items():
        for s, ks in sites.items():
            for k in ks:
                kin["protein"].append(g), kin["psite"].append(s), kin["kinase"].append(k)
    kin = {k: np.asarray(v, dtype=object) for k, v in kin.items()}
    tf = {"tf": np.asarray([a for a, _ in TF_EDGES], dtype=object),
          "target": np.asarray([b for _, b in TF_EDGES], dtype=object)}
    topo = build_topology(kin, tf)
    jtopo = jax_topology(frame(kin), frame(tf))
    Kmat = rng.uniform(0.5, 2.0, (topo.K, len(TP)))
    system = GlobalSystem(topo, TP, Kmat, dtype=torch.float64, device="cpu")
    jsystem = JaxSystem(jtopo, TP, Kmat, dtype=np.float64)
    theta0, slices, xl, xu = init_raw_params(default_params(topo), topo,
                                             {k: (0.2, 2.0) for k in default_params(topo)})
    X = theta0 + 0.3 * rng.normal(size=(7, len(theta0)))
    F = rng.uniform(0.1, 2.0, (7, 3))
    params = {k: v[0].numpy() for k, v in unpack_params(torch.as_tensor(X[2:3]), slices,
                                                        topo).items()}

    def obs(with_site):
        rows = [(g, s, t) for g in topo.proteins for s in (topo.sites[topo.p2i[g]]
                                                           if with_site else [""]) for t in TP]
        out = {"protein": np.asarray([r[0] for r in rows], dtype=object)}
        if with_site:
            out["psite"] = np.asarray([r[1] for r in rows], dtype=object)
        out["time"] = np.asarray([r[2] for r in rows], float)
        return out
    prot, pho = obs(False), obs(True)
    obs_prot = {**prot, "fc": rng.uniform(0.5, 2, len(prot["time"])),
                "w": np.ones(len(prot["time"]))}
    pred_prot = {**prot, "pred_fc": rng.uniform(0.5, 2, len(prot["time"]))}
    pred_pho = {**pho, "pred_fc": rng.uniform(0.5, 2, len(pho["time"]))}
    history = [(g, rng.uniform(0.1, 1, 3), rng.uniform(1, 2, 3)) for g in range(4)]
    return SimpleNamespace(topo=topo, jtopo=jtopo, system=system, jsystem=jsystem, Kmat=Kmat,
                           slices=slices, X=X, F=F, params=params, obs_prot=obs_prot,
                           pred_prot=pred_prot, pred_pho=pred_pho, history=history)


def gene_results():
    rng = np.random.default_rng(2)
    fields = ("error", "score", "lambda_reg", "weight_name", "regularization_term", "params")
    return {g: SimpleNamespace(**dict(zip(fields, (*rng.uniform(0, 1, 3), f"w{i}",
                                                   float(rng.uniform()),
                                                   rng.uniform(0, 5, 4 + i)))))
            for i, g in enumerate(["GA", "GB", "GC"])}


def _pareto(pkg, n, d, s):
    return pkg.export_pareto(d / "pareto.xlsx", n.X, n.F)


def _trajectories(pkg, n, d, s):
    tables = (n.pred_prot, n.pred_prot, n.pred_pho, n.obs_prot, None, n.obs_prot)
    if pkg is jex:
        tables = tuple(None if t is None else frame(t) for t in tables)
    return pkg.export_trajectories(d / "trajectories.xlsx", *tables)


def _residuals(pkg, n, d, s):
    tables = (n.obs_prot, n.pred_prot)
    if pkg is jex:
        tables = tuple(frame(t) for t in tables)
    return pkg.export_residuals(d / "residuals.xlsx", *tables, ["protein"])


def _scan_prior_reg(pkg, n, d, s):
    np.save(d / "pareto_F.npy", n.F)
    pkg.scan_prior_reg(str(d))


def _gene_results(pkg, n, d, s):
    return pkg.export_gene_results(d / "model_results.xlsx", gene_results())


EXPORTERS = {
    "pareto": _pareto,
    "trajectories": _trajectories,
    "global_params": lambda pkg, n, d, s: pkg.export_global_params(
        d / "parameters.xlsx", n.jtopo if pkg is jex else n.topo, n.params),
    "kinase_activities": lambda pkg, n, d, s: pkg.export_kinase_activities(
        d / "kinase_activity.xlsx", n.jtopo if pkg is jex else n.topo, n.params, n.Kmat, TP),
    "residuals": _residuals,
    "param_distributions": lambda pkg, n, d, s: pkg.export_param_distributions(
        d / "param_distributions.xlsx", n.X, n.slices, n.topo),
    "param_correlations": lambda pkg, n, d, s: pkg.export_param_correlations(
        d / "param_correlations.xlsx", n.X, n.slices, n.jtopo if pkg is jex else n.topo),
    "S_rates_long": lambda pkg, n, d, s: pkg.export_S_rates(s, n.params, str(d)),
    "S_rates_wide": lambda pkg, n, d, s: pkg.export_S_rates(s, n.params, str(d),
                                                            filename="wide.csv", long=False),
    "scan_prior_reg": _scan_prior_reg,
    "convergence_history": lambda pkg, n, d, s: pkg.process_convergence_history(
        n.history, str(d)),
    "gene_results": _gene_results,
}


@pytest.mark.parametrize("name", list(EXPORTERS))
def test_exporter_matches_jax(tmp_path, net, name):
    """Each table exporter of ``io/export.py`` writes JAX's files."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dp.mkdir()
    EXPORTERS[name](jex, net, dj, net.jsystem)
    EXPORTERS[name](ex, net, dp, net.system)
    assert_same_files(dp, dj, RTOL_TABLE)


def test_pareto_trajectories_match_jax(tmp_path, net):
    """The top members' trajectories, one batched ETD2RK simulation in
    each package (computed: 1e-9 of each column's largest value)."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    for pkg, d, s in ((jex, dj, net.jsystem), (ex, dp, net.system)):
        pkg.export_pareto_trajectories(s, net.slices, net.X, (TP, TR, TP),
                                       str(d / "pareto_trajectories.xlsx"), top_idx=[3, 0, 5])
    assert_same_files(dp, dj, RTOL_COMPUTED)
    got = read_table(str(dp / "pareto_trajectories.xlsx"), sheet_name="traj_phospho")
    assert set(got["sol_id"].tolist()) == {0, 3, 5}


def test_workbook_sheets_read_back(tmp_path, net):
    """A workbook's sheets come back through ``read_table`` by sheet name
    as the tables written (floats exactly)."""
    path = str(tmp_path / "trajectories.xlsx")
    ex.export_trajectories(path, net.pred_prot, net.pred_prot, net.pred_pho, net.obs_prot)
    for sheet, table in (("Pred Protein", net.pred_prot), ("Pred Phospho", net.pred_pho),
                         ("Obs Protein", net.obs_prot)):
        back = read_table(path, sheet_name=sheet)
        assert list(back) == list(table)
        for c in table:
            assert np.asarray(back[c]).tolist() == np.asarray(table[c]).tolist()


def test_pandas_orders():
    """The sort helpers order rows as pandas' ``sort_values`` does, ties
    and NaN included."""
    rng = np.random.default_rng(3)
    v = np.round(rng.uniform(0, 4, 60))
    v[[5, 17]] = np.nan
    s = pd.Series(v)
    assert ex.sort_desc(v).tolist() == s.sort_values(ascending=False).index.tolist()
    assert ex.sort_asc(v).tolist() == s.sort_values().index.tolist()


# ---------------------------------------------------------------------------
# kinopt / tfopt workbooks and the KKT report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weight_problems(tmp_path_factory):
    """The kinopt and tfopt problems of the shared project in both
    packages, with seeded feasible weights."""
    from phoskintime_tpu.kinopt.data import load_kinopt_problem as jax_kinopt
    from phoskintime_tpu.tfopt.data import load_tfopt_problem as jax_tfopt
    from phoskintime_tpu_torch.kinopt.data import load_kinopt_problem
    from phoskintime_tpu_torch.tfopt.data import load_tfopt_problem

    data = write_project(tmp_path_factory.mktemp("weights")) / "data"
    rng = np.random.default_rng(4)
    kin = [load(str(data / "input1.csv"), str(data / "input2.csv"))
           for load in (jax_kinopt, load_kinopt_problem)]
    tf = [load(str(data / "input1.csv"), str(data / "input3.csv"), str(data / "input4.csv"))
          for load in (jax_tfopt, load_tfopt_problem)]

    def weights(mask):
        a = rng.uniform(0, 1, mask.shape) * mask
        return a / np.maximum(a.sum(axis=1, keepdims=True), 1e-12)
    pk = kin[1][0]
    kres = SimpleNamespace(alpha=weights(pk.gp_mask), beta=weights(pk.k_mask))
    kres.beta[0, 0] = pk.lb                      # one beta at its bound
    pt = tf[1][0]
    tres = SimpleNamespace(alpha=weights(pt.alpha_mask),
                           beta=rng.uniform(-1, 1, pt.beta_mask.shape) * pt.beta_mask)
    return SimpleNamespace(kin=kin, tf=tf, kres=kres, tres=tres)


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_weight_workbooks_match_jax(tmp_path, weight_problems, which):
    """``kinopt_sheets``/``tfopt_sheets`` and the network readouts, as the
    result workbooks (``export_kinopt_results``/``export_tfopt_results``)."""
    w = weight_problems
    (jp, jmeta), (tp, tmeta) = w.kin if which == "kinopt" else w.tf
    res = w.kres if which == "kinopt" else w.tres
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dp.mkdir()
    if which == "kinopt":
        jex.export_kinopt_results(dj / "kinopt_results.xlsx", jp, res, jmeta)
        ex.export_kinopt_results(dp / "kinopt_results.xlsx", tp, res, tmeta)
    else:
        jex.export_tfopt_results(dj / "tfopt_results.xlsx", jp, res)
        ex.export_tfopt_results(dp / "tfopt_results.xlsx", tp, res)
    assert_same_files(dp, dj, RTOL_TABLE)


def test_kkt_suite_matches_jax(tmp_path, weight_problems):
    """``kkt_suite``'s JSON, CSVs and LaTeX against JAX's (the gradient by
    autograd against JAX's: 1e-9), and its two figures by record."""
    from phoskintime_tpu.kinopt.kkt import kkt_suite as jax_kkt_suite
    from phoskintime_tpu_torch.kinopt import kkt

    w = weight_problems
    dj, dp = tmp_path / "jax", tmp_path / "port"
    with capture_jax() as want:
        jout = jax_kkt_suite(w.kin[0][0], w.kres, str(dj))
    with capture_port() as got:
        out = kkt.kkt_suite(w.kin[1][0], w.kres, str(dp), device="cpu")
    assert_same_files(dp, dj, RTOL_COMPUTED)
    assert_same_records(got, want, dp, dj, scaled=RTOL_COMPUTED)
    assert out["report"].n_active_box >= 1
    assert sorted(out["paths"]) == sorted(jout["paths"])
    assert {"constraint_violations.png", "sensitivity.png"} <= written(dp)


# ---------------------------------------------------------------------------
# the scan's table and the per-gene results
# ---------------------------------------------------------------------------

def test_scan_report_matches_jax(tmp_path):
    """``scan_report``'s results table (sheet Trials) from the same trials,
    complete and pruned."""
    from phoskintime_tpu.network.scan import ScanTrial as JaxTrial
    from phoskintime_tpu.network.scan import scan_report as jax_scan_report
    from phoskintime_tpu_torch.network.scan import ScanTrial, scan_report

    rng = np.random.default_rng(5)
    specs = [({k: float(v) for k, v in zip(("protein", "rna", "phospho", "prior"),
                                           rng.uniform(0.1, 10, 4))},
              float(rng.uniform(1, 5)), "pruned" if i == 3 else "complete",
              tuple(rng.uniform(0, 1, 3)), [(5, 2.0)], 5 * (i + 1)) for i in range(5)]
    dj, dp = tmp_path / "jax", tmp_path / "port"
    jax_scan_report([JaxTrial(*s) for s in specs], str(dj))
    scan_report([ScanTrial(*s) for s in specs], str(dp))
    assert_same_files(dp, dj, RTOL_TABLE)


def test_run_model_pipeline_out_dir_matches_jax(tmp_path):
    """``run_model_pipeline(out_dir=...)`` writes JAX's results table, the
    gene's figures (the same files, each drawing the same within 1e-9 of
    each array's largest magnitude or of 1) and ``report.html`` embedding
    them (its images masked)."""
    from test_torch_pipeline import BOUNDS, SMALL, TIME_POINTS, tidy_frames

    from phoskintime_tpu.fit.pipeline import run_model_pipeline as jax_pipeline
    from phoskintime_tpu_torch.fit.pipeline import run_model_pipeline

    frames = tidy_frames([(7, "GC", 1)])
    kw = dict(time_points=TIME_POINTS, rna_time_points=TIME_POINTS[5:], bounds=BOUNDS,
              model="distmod", normest_kw=SMALL)
    dj, dp = tmp_path / "jax", tmp_path / "port"
    with capture_jax() as want:
        jax_pipeline(*frames, out_dir=str(dj), **kw)
    with capture_port() as got:
        outputs = run_model_pipeline(*frames, out_dir=str(dp), device="cpu", **kw)
    assert_same_files(dp, dj, RTOL_COMPUTED)
    assert_same_records(got, want, dp, dj, scaled=RTOL_COMPUTED)
    assert written(dp) == written(dj)
    assert {"model_results_results.csv", "report.html", "GC/GC_diagram.png"} <= written(dp)
    import chip_smoke

    assert written(dp) == chip_smoke.model_files(outputs)      # phase 14's derivation
    assert read_csv(dp / "model_results_results.csv")["gene"].tolist() == ["GC"]
    make_plots = tmp_path / "no_figures"
    run_model_pipeline(*frames, out_dir=str(make_plots), make_plots=False, device="cpu", **kw)
    assert written(make_plots) == {"model_results_results.csv", "report.html"}


def test_process_convergence_history_without_history(tmp_path):
    assert ex.process_convergence_history([], str(tmp_path)) is None
    assert not list(tmp_path.iterdir())


def test_table_writer_names_match_jax(tmp_path):
    """Sheet names become JAX's slugs, a path without .xlsx keeps its name."""
    for pkg, d in ((jex, tmp_path / "jax"), (ex, tmp_path / "port")):
        w = pkg.TableWriter(str(d / "book.xlsx"))
        for name in ("Alpha Values", " Beta-Values (all) ", "x"):
            w.add(name, pd.DataFrame({"a": [1.5]}) if pkg is jex else {"a": [1.5]})
        w.save()
    assert written(tmp_path / "port") == written(tmp_path / "jax") == {
        "book_alpha_values.csv", "book_beta_values_all_.csv", "book_x.csv"}
    assert os.path.exists(tmp_path / "port" / "book_x.csv")
