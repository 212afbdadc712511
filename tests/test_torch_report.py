"""The port's report layer that draws no figure (``report/``, the HTML
writers of ``analysis/influence.py``, ``mechanism_selection.html``) against
the JAX package's, on the CPU at float64.

* Writers fed the same numpy arrays or tables (a column dict on the port's
  side, the same DataFrame on JAX's): byte for byte. ``report.html`` with
  its time stamp masked.
* Writers whose numbers the port computes (the global knockout explorer,
  the Pareto explorer from the port's trajectory tables): the page byte for
  byte outside its embedded JSON, the JSON's numbers within 1e-4, the
  writers' own rounding unit (``_round(a, nd=4)``); the knockout explorer's
  fold changes before rounding within 1e-9 relative (the objective's parity
  tolerance).
* ``table_html`` against pandas' ``DataFrame.to_html`` byte for byte;
  ``LiveMonitor`` served on port 0.
"""

import json
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_export import ATOL_HTML, assert_same_html, assert_same_json, split_html
from test_torch_io import columns_of
from torch_figures import assert_same_records, capture_jax, capture_port

import phoskintime_tpu.analysis.influence as jinfl
import phoskintime_tpu.report.interactive as jinter
from phoskintime_tpu.analysis.mechanisms import _write_selection_artifacts as jax_selection
from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu.io import export as jex
from phoskintime_tpu.io.load import read_table as jax_read_table
from phoskintime_tpu.report import html as jhtml
from phoskintime_tpu.report import latexit as jlatex
from phoskintime_tpu.report.live import LiveMonitor as JaxMonitor
from phoskintime_tpu.report.live_model import write_live_model_explorer as jax_live
from phoskintime_tpu_torch import report
from phoskintime_tpu_torch.analysis import influence as infl
from phoskintime_tpu_torch.analysis.mechanisms import _write_selection_artifacts
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.io import export as ex
from phoskintime_tpu_torch.io.load import read_table
from phoskintime_tpu_torch.report import html, interactive, latexit, live_model
from phoskintime_tpu_torch.report.live import LiveMonitor

torch.set_num_threads(2)
RTOL_FC = 1e-9          # fold changes, float64 in both packages


def frame(table: dict) -> pd.DataFrame:
    """A column table as the DataFrame the JAX package is given."""
    return pd.DataFrame({k: list(v) if np.asarray(v).dtype == object else v
                         for k, v in table.items()})


def text(path) -> str:
    with open(path) as fh:
        return fh.read()


@pytest.fixture(scope="module", params=[0, 2], ids=["model0", "model2"])
def bundles(request):
    """(JAX demo bundle at float64, the port's system, topology and true
    parameters, the observations as column tables)."""
    bj = jax_demo(n_proteins=12, n_kinases=5, seed=3, model=request.param, dtype=np.float64)
    bp = from_reference({k: bj[k] for k in ("system", "topo", "true", "slices", "theta0")},
                        device="cpu")
    for k in ("df_prot", "df_rna", "df_pho"):
        bp[k] = columns_of(bj[k])
    return bj, bp


# ---------------------------------------------------------------------------
# the HTML table
# ---------------------------------------------------------------------------

TABLES = {
    "mixed": {"model": np.array([0, 4, 2]), "mechanism": np.array(["a", "b & c", "<d>"], object),
              "aic": np.array([1.23456789, -1e-9, 12345678.9]), "ok": np.array([True, False, True]),
              "aicc": np.array([np.inf, np.nan, 0.0])},
    "missing_text": {"protein": np.array(["P1", None, "P  3\twide"], object),
                     "w": np.array([np.nan, np.nan, np.nan])},
    "no_rows": {"a": np.array([], float), "b": np.array([], object)},
    "no_columns": {},
    "ints": {"n": np.array([-3, 0, 10 ** 12]), "name <x>": np.array([1.5, 2.5, -0.0])},
}


@pytest.mark.parametrize("fmt", ["%.4g", "callable"])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_html_matches_pandas(name, fmt):
    """``table_html`` writes what ``DataFrame.to_html(index=False,
    float_format=...)`` writes: ints, floats (inf, NaN, -0), booleans,
    escaped text, a missing string, no rows, no columns."""
    table = TABLES[name]
    float_format = fmt if fmt != "callable" else (lambda v: f"{v:.4g}")
    want = frame(table).to_html(index=False, float_format=float_format)
    assert html.table_html(table, float_format) == want


def test_create_report_matches_jax(tmp_path):
    """``report.html`` with two tables and PNGs in the folder and in a
    subfolder: JAX's bytes but the time stamp."""
    rng = np.random.default_rng(0)
    tables = {"fit": {"protein": np.array(["P1", "P2"], object), "rmse": rng.uniform(0, 1, 2),
                      "n": np.array([3, 4])},
              "empty": {"a": np.array([], float)}}
    for d in ("jax", "port"):
        (tmp_path / d / "panels").mkdir(parents=True)
        for f in ("b.png", "a.png", "panels/c.png"):
            (tmp_path / d / f).write_bytes(bytes(range(7)) + f.encode())
    jp = jhtml.create_report(str(tmp_path / "jax"), title="t <r>",
                             tables={k: frame(v) for k, v in tables.items()})
    pp = html.create_report(str(tmp_path / "port"), title="t <r>", tables=tables)
    got, want = text(pp), text(jp)
    assert split_html(got) == split_html(want)
    assert "<p>Generated " in got and got.count("<figure>") == 3


# ---------------------------------------------------------------------------
# the explorers fed the same arrays
# ---------------------------------------------------------------------------

def explorer_inputs(seed=0, C=7, T=9, K=3):
    rng = np.random.default_rng(seed)
    est = rng.uniform(0.2, 3.0, (C, T))
    ko = est[None] * rng.uniform(0.5, 1.5, (K, C, T))
    ko[1, 2, 4] = np.nan                                 # a diverged re-prediction
    edges = {"source": np.array([f"K{i % K}" for i in range(10)], object),
             "target": np.array([f"P{i}" for i in range(10)], object),
             "weight": rng.normal(size=10)}
    return dict(times=np.linspace(0.0, 16.0, T), curve_names=[f"P{c}" for c in range(C)],
                obs=rng.uniform(0.2, 3.0, (C, T)), est=est, ko_names=[f"K{k}" for k in range(K)],
                ko_est=ko, source_layer_names={f"K{k}" for k in range(K)}), edges


@pytest.mark.parametrize("with_obs", [True, False])
def test_interactive_explorer_matches_jax(tmp_path, with_obs):
    kw, edges = explorer_inputs()
    if not with_obs:
        kw["obs"] = None
    jinter.write_interactive_explorer(str(tmp_path / "j.html"), title="fit <x>",
                                      network_edges=frame(edges), max_edges=6, **kw)
    interactive.write_interactive_explorer(str(tmp_path / "p.html"), title="fit <x>",
                                           network_edges=edges, max_edges=6,
                                           **{k: (torch.as_tensor(v) if k == "est" else v)
                                              for k, v in kw.items()})
    assert text(tmp_path / "p.html") == text(tmp_path / "j.html")


def test_pareto_explorer_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    names = ["P1 (protein)", "P1 (mRNA)", "P1:S1 (phospho)"]
    kw = dict(pareto_F=rng.uniform(0, 1, (6, 3)), best_idx=2, times=np.arange(5.0),
              curve_names=names, sol_curves={2: rng.normal(size=(3, 5)),
                                             4: rng.normal(size=(3, 5))},
              obs_points=[[(0.0, 1.0), (2.0, float("nan"))], None, [(1.0, 0.5)]])
    jinter.write_pareto_explorer(str(tmp_path / "j.html"), **kw)
    interactive.write_pareto_explorer(str(tmp_path / "p.html"), **kw)
    assert text(tmp_path / "p.html") == text(tmp_path / "j.html")


def test_live_model_explorer_matches_jax(tmp_path, bundles):
    """The payload (topology, Kmat, y0, the true parameters as tensors, the
    observed points in row order) and the page: JAX's bytes."""
    bj, bp = bundles
    params = {k: torch.as_tensor(v) for k, v in bp["true"].items()}
    for title in (None, "live </script> <b>"):
        jax_live(str(tmp_path / "j.html"), bj["system"], bj["true"], title=title,
                 df_prot=bj["df_prot"], df_rna=bj["df_rna"], df_pho=bj["df_pho"])
        live_model.write_live_model_explorer(str(tmp_path / "p.html"), bp["system"], params,
                                             title=title, df_prot=bp["df_prot"],
                                             df_rna=bp["df_rna"], df_pho=bp["df_pho"])
        assert text(tmp_path / "p.html") == text(tmp_path / "j.html")
    jax_live(str(tmp_path / "j.html"), bj["system"], bj["true"], t_max_default=30.0)
    live_model.write_live_model_explorer(str(tmp_path / "p.html"), bp["system"], bp["true"],
                                         t_max_default=30.0)
    assert text(tmp_path / "p.html") == text(tmp_path / "j.html")
    payload = split_html(text(tmp_path / "p.html"))[1][0]
    assert payload["data"] is None and payload["N"] == bp["topo"].N


def test_influence_html_matches_jax(tmp_path):
    """The time-slider network on the same edge table (distinct |weights|,
    so that no tie orders the cut of 150 a frame): JAX's bytes."""
    rng = np.random.default_rng(2)
    n = 400
    kinds = rng.choice(["phospho", "tf"], n)
    edges = {"time": rng.choice([0.0, 4.0, 16.0], n),
             "kind": kinds.astype(object),
             "src": np.array([f"K{i}" for i in rng.integers(0, 6, n)], object),
             "dst": np.array([f"P{i}" for i in rng.integers(0, 30, n)], object),
             "site": np.array(["" if k == "tf" else f"S{i}" for k, i in
                               zip(kinds, rng.integers(0, 3, n))], object),
             "weight": rng.permutation(np.linspace(-3.0, 3.0, n))}
    kin = {f"K{i}" for i in range(4)}
    jinfl.write_influence_html(str(tmp_path / "j.html"), frame(edges), kinases=kin)
    infl.write_influence_html(str(tmp_path / "p.html"), edges, kinases=kin)
    assert text(tmp_path / "p.html") == text(tmp_path / "j.html")


def test_influence_sweep_writes_jax_html(tmp_path, bundles):
    """``export_influence_sweep`` writes ``influence_network.html`` beside
    its tables: JAX's page, the computed weights within 1e-4."""
    bj, bp = bundles
    jout = jinfl.export_influence_sweep(bj["system"], bj["true"], str(tmp_path / "j"))
    out = infl.export_influence_sweep(bp["system"], bp["true"], str(tmp_path / "p"))
    assert out["html"].endswith("influence_network.html") and jout["html"].endswith(
        "influence_network.html")
    assert_same_html(text(out["html"]), text(jout["html"]), "influence_network.html")


# ---------------------------------------------------------------------------
# the global knockout explorer: the port computes the fold changes
# ---------------------------------------------------------------------------

def test_knockout_explorer_matches_jax(tmp_path, bundles, monkeypatch):
    """All K knockouts and the wild type as one batched ETD2RK call: the
    fold changes before rounding within 1e-9 of JAX's, the curve names,
    the control edges, and the page (JAX's bytes outside the JSON, its
    numbers within 1e-4)."""
    bj, bp = bundles
    seen = {"jax": {}, "port": {}}
    for side, mod in (("jax", jinter), ("port", interactive)):
        def spy(path, _real=mod.write_interactive_explorer, _into=seen[side], **kw):
            _into.update(kw)
            return _real(path, **kw)
        monkeypatch.setattr(mod, "write_interactive_explorer", spy)
    jp = jinfl.export_global_knockout_explorer(bj["system"], bj["true"],
                                               str(tmp_path / "j" / "ko.html"))
    pp = infl.export_global_knockout_explorer(bp["system"], bp["true"],
                                              str(tmp_path / "p" / "ko.html"))
    got, want = seen["port"], seen["jax"]
    assert got["curve_names"] == want["curve_names"]
    np.testing.assert_array_equal(got["times"], want["times"])
    for k in ("est", "ko_est"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_FC, atol=0, err_msg=k)
    assert got["ko_est"].shape == (bp["topo"].K, len(got["curve_names"]), len(got["times"]))
    for c in ("source", "target", "weight"):
        assert np.asarray(got["network_edges"][c]).tolist() == want["network_edges"][c].tolist()
    assert_same_knockout_page(text(pp), text(jp), want)


def assert_same_knockout_page(got: str, want: str, seen: dict):
    """The knockout explorer's page against JAX's: the same bytes outside
    the JSON and the same JSON within 1e-4 but the order of each
    knockout's top targets. Those are ranked by their mean |change|, which
    ties (to rounding) between targets the knockout leaves alike, and a
    tie's order follows the last bits. So each listed target is one of
    JAX's curves with JAX's re-prediction and change; position by position
    the changes agree within 1e-9 relative, and where the two lists name
    different targets, JAX's changes of the two are a tie within 1e-9."""
    (g_text, (g,)), (w_text, (w,)) = split_html(got), split_html(want)
    assert g_text == w_text
    g_ko, w_ko = g.pop("knockouts"), w.pop("knockouts")
    assert_same_json(g, w, ATOL_HTML, "global_knockouts.html")
    est, ko = np.asarray(seen["est"], float), np.asarray(seen["ko_est"], float)
    delta = np.abs(np.nan_to_num(ko) - est[None]).mean(-1)               # (K, C)
    assert len(g_ko) == len(w_ko)
    for k, (gk, wk) in enumerate(zip(g_ko, w_ko)):
        assert (gk["name"], len(gk["top"])) == (wk["name"], len(wk["top"]))
        assert abs(gk["total"] - wk["total"]) <= RTOL_FC * max(abs(wk["total"]), 1.0)
        for ge, we in zip(gk["top"], wk["top"]):
            c = ge["c"]
            finite = bool(np.isfinite(ko[k, c]).all())
            assert ge["bad"] == (not finite)
            assert abs(ge["d"] - (delta[k, c] if finite else 0.0)) <= RTOL_FC * max(ge["d"], 1.0)
            assert abs(ge["d"] - we["d"]) <= RTOL_FC * max(we["d"], 1.0)
            assert_same_json(ge["ko"], np.round(np.nan_to_num(ko[k, c]), 4).tolist(), ATOL_HTML,
                             f"knockout {k} target {c}")
            if c != we["c"]:
                assert abs(delta[k, c] - delta[k, we["c"]]) <= RTOL_FC * max(we["d"], 1.0)


def test_knockout_explorer_is_one_batched_call(bundles, monkeypatch):
    """One ``exponential_simulate_batched`` call of K + 1 members: the wild
    type, then member k+1 with c_k[k] = 0 and every other parameter the
    wild type's."""
    from phoskintime_tpu_torch.network import expo

    _, bp = bundles
    calls = []
    real = expo.exponential_simulate_batched

    def spy(system, params_b, *a, **kw):
        calls.append({k: v.clone() for k, v in params_b.items()})
        return real(system, params_b, *a, **kw)
    monkeypatch.setattr(expo, "exponential_simulate_batched", spy)
    infl.knockout_scenarios(bp["system"], bp["true"])
    assert len(calls) == 1
    K = bp["topo"].K
    ck = torch.as_tensor(bp["true"]["c_k"])
    want = ck.repeat(K + 1, 1)
    want[1:].fill_diagonal_(0.0)
    assert torch.equal(calls[0]["c_k"], want)
    for k, v in bp["true"].items():
        if k != "c_k":
            assert torch.equal(calls[0][k], torch.as_tensor(v).expand(K + 1, *np.shape(v)))


# ---------------------------------------------------------------------------
# the Pareto explorer from the port's trajectory tables
# ---------------------------------------------------------------------------

def test_pareto_explorer_from_frames_matches_jax(tmp_path, bundles):
    """``pareto_explorer_from_frames`` on the trajectory tables each package
    wrote and read back, with the observations: JAX's page, the numbers
    within 1e-4; and on the same tables read by both: JAX's bytes."""
    bj, bp = bundles
    rng = np.random.default_rng(4)
    X = bj["theta0"][None] + 0.1 * rng.normal(size=(5, len(bj["theta0"])))
    F = rng.uniform(0.1, 2.0, (5, 3))
    tp = (np.asarray(bj["system"].kin_grid), np.asarray(bj["system"].kin_grid)[3:],
          np.asarray(bj["system"].kin_grid))
    book = "pareto_trajectories.xlsx"
    jex.export_pareto_trajectories(bj["system"], bj["slices"], X, tp, str(tmp_path / "j" / book),
                                   top_idx=np.array([3, 0]))
    ex.export_pareto_trajectories(bp["system"], bp["slices"], X, tp, str(tmp_path / "p" / book),
                                  top_idx=np.array([3, 0]))
    sheets = [f"traj_{m}" for m in ("protein", "rna", "phospho")]
    jt = [jax_read_table(str(tmp_path / "j" / book), sheet_name=s) for s in sheets]
    pt = [read_table(str(tmp_path / "p" / book), sheet_name=s) for s in sheets]
    obs = (bj["df_prot"], bj["df_rna"], bj["df_pho"])
    jinter.pareto_explorer_from_frames(str(tmp_path / "j.html"), F, 3, *jt, *obs)
    interactive.pareto_explorer_from_frames(str(tmp_path / "p.html"), F, 3, *pt,
                                            bp["df_prot"], bp["df_rna"], bp["df_pho"])
    assert_same_html(text(tmp_path / "p.html"), text(tmp_path / "j.html"), "pareto")
    # the JAX package's own tables read by both readers: the same bytes
    same = [read_table(str(tmp_path / "j" / book), sheet_name=s) for s in sheets]
    interactive.pareto_explorer_from_frames(str(tmp_path / "p2.html"), F, 3, *same,
                                            bp["df_prot"], bp["df_rna"], bp["df_pho"])
    assert text(tmp_path / "p2.html") == text(tmp_path / "j.html")
    # without phospho trajectories or observations
    jinter.pareto_explorer_from_frames(str(tmp_path / "j3.html"), F, 0, jt[0], jt[1],
                                       jt[2].iloc[:0])
    interactive.pareto_explorer_from_frames(str(tmp_path / "p3.html"), F, 0, same[0], same[1],
                                            {k: v[:0] for k, v in same[2].items()})
    assert text(tmp_path / "p3.html") == text(tmp_path / "j3.html")


# ---------------------------------------------------------------------------
# the mechanism summary, LaTeX, the live monitor, the package
# ---------------------------------------------------------------------------

def selection_table(rng, rows: int) -> dict:
    models = np.array([2, 0, 4, 1][:rows])
    aic = np.sort(rng.uniform(-50, 50, rows))
    w = np.exp(-0.5 * (aic - aic[0]))
    return {"model": models, "mechanism": np.array(["combinatorial", "distributive",
                                                    "saturating", "sequential"][:rows], object),
            "n_params": np.array([40, 31, 44, 31][:rows]), "n_obs": np.array([90] * rows),
            "rss": rng.uniform(0, 3, rows), "r2": rng.uniform(0, 1, rows), "aic": aic,
            "aicc": np.array([np.inf] + [1.5] * (rows - 1)), "bic": aic + 3.0,
            "n_evals": np.array([1200] * rows), "r2_protein": rng.uniform(0, 1, rows),
            "rmse_rna": np.array([np.nan] + list(rng.uniform(0, 1, rows - 1))),
            "delta_aic": aic - aic[0], "akaike_weight": w / w.sum()}


@pytest.mark.parametrize("rows", [1, 4])
def test_mechanism_selection_html_matches_jax(tmp_path, bundles, rows):
    """``mechanism_selection.html`` from the same table: JAX's bytes; the
    selection sheets as JAX's; the two overlays (``overlay_protein.png``,
    ``overlay_rna.png``) drawing what JAX's draw (``tests/torch_figures.py``)."""
    bj, bp = bundles
    table = selection_table(np.random.default_rng(rows), rows)
    jtrajs = {int(m): tuple(bj[k].rename(columns={"fc": "pred_fc"})
                            for k in ("df_prot", "df_rna", "df_pho")) for m in table["model"]}
    trajs = {m: tuple(columns_of(t) for t in v) for m, v in jtrajs.items()}
    with capture_jax() as want:
        jpaths = jax_selection(frame(table), jtrajs,
                               (bj["df_prot"], bj["df_rna"], bj["df_pho"]), str(tmp_path / "j"))
    with capture_port() as got:
        paths = _write_selection_artifacts(table, trajs, (bp["df_prot"], bp["df_rna"],
                                                          bp["df_pho"]), str(tmp_path / "p"))
    assert list(paths) == list(jpaths) == ["table", "overlay_protein", "overlay_rna", "html"]
    assert_same_records(got, want, tmp_path / "p", tmp_path / "j")
    assert text(paths["html"]) == text(jpaths["html"])
    assert [p.rsplit("/", 1)[1] for p in paths["table"]] == [
        p.rsplit("/", 1)[1] for p in jpaths["table"]]


def latex_tables():
    rng = np.random.default_rng(3)
    return {"fit & score": {"gene": np.array(["G_1", "G#2", "a\\b"], object),
                            "n": np.array([1, 2, 3]), "rmse": rng.uniform(0, 1, 3)},
            "numbers": {"n": np.array([1, 2]), "x": np.array([0.5, 1e-7])},
            "ints": {"n": np.array([1, 2]), "m": np.array([3, 4])},
            "flags": {"ok": np.array([True, False]), "x": np.array([0.5, 2.0])}}


def test_latex_matches_jax(tmp_path):
    """``dataframe_to_latex`` (a text column held as objects on both sides,
    as pandas before 3.0 holds text), ``figure_to_latex`` and
    ``write_latex_report``: JAX's text."""
    tables = latex_tables()
    jframes = {k: frame(v).astype({c: object for c, col in v.items() if col.dtype == object})
               for k, v in tables.items()}
    for name in tables:
        assert (latexit.dataframe_to_latex(tables[name], caption=name, label="t:x")
                == jlatex.dataframe_to_latex(jframes[name], caption=name, label="t:x")), name
    assert (latexit.figure_to_latex("a/b_c.png", caption="50% & more", label="f:1")
            == jlatex.figure_to_latex("a/b_c.png", caption="50% & more", label="f:1"))
    assert latexit.figure_to_latex("x.png") == jlatex.figure_to_latex("x.png")
    figs = ["figs/one.png", "two_b.png"]
    jp = jlatex.write_latex_report(str(tmp_path), jframes, figs, filename="j.tex")
    pp = latexit.write_latex_report(str(tmp_path), tables, figs, filename="p.tex")
    assert text(pp) == text(jp)


def test_live_monitor_serves_state():
    """Started on port 0 and fed the same generations as the JAX package's
    monitor (the port's F a tensor): the same history and evaluation count
    at /state.json, the page at /, a 404 elsewhere."""
    rng = np.random.default_rng(0)
    Fs = [np.abs(rng.normal(1, 0.3, (8, 3))) for _ in range(3)]
    jmon = JaxMonitor(port=0)
    with LiveMonitor(port=0) as mon:
        for g, F in enumerate(Fs):
            mon(g, torch.zeros(8, 2), torch.as_tensor(F, dtype=torch.float32))
            jmon(g, None, np.asarray(F, np.float32))
        url = f"http://127.0.0.1:{mon.port}"
        state = json.loads(urllib.request.urlopen(url + "/state.json", timeout=30).read())
        page = urllib.request.urlopen(url + "/", timeout=30).read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/nope", timeout=30)
    want = jmon.state()
    assert state["history"] == want["history"] and state["n_evals"] == want["n_evals"] == 24
    assert "live fit" in page and mon.port == 0           # stopped: the port asked for


def test_report_package_exports_the_html_half():
    """``report`` exports the writers the port has (the HTML half, the
    per-gene and global model's figures, the diagram and the dashboard);
    the names part 3 of item 8d-figures owes raise naming it."""
    for name in ("create_report", "table_html", "write_interactive_explorer",
                 "write_pareto_explorer", "pareto_explorer_from_frames",
                 "write_live_model_explorer", "LiveMonitor", "dataframe_to_latex",
                 "figure_to_latex", "write_latex_report", "plot_pareto_3d", "plot_convergence",
                 "plot_parallel_coords_pareto", "save_dashboard_bundle", "render_dashboard",
                 "Plotter", "illustrate"):
        assert callable(getattr(report, name)), name
    for name in ("schematic", "apps", "render_kinopt_app", "render_tfopt_app"):
        with pytest.raises(NotImplementedError, match="item 8d-figures, part 3"):
            getattr(report, name)
    with pytest.raises(AttributeError):
        report.nothing_here        # noqa: B018


def test_json_comparison_holds_its_tolerance():
    """The HTML comparison the computed writers are held to: numbers within
    1e-4 pass, beyond fail; structure, strings and the page outside the
    payload must be equal."""
    assert_same_json({"a": [1.0, "x"]}, {"a": [1.0 + 0.9 * ATOL_HTML, "x"]}, ATOL_HTML, "ok")
    for got in ({"a": [1.0 + 2 * ATOL_HTML, "x"]}, {"a": [1.0, "y"]}, {"a": [1.0]},
                {"b": [1.0, "x"]}, {"a": [True, "x"]}):
        with pytest.raises(AssertionError):
            assert_same_json(got, {"a": [1.0, "x"]}, ATOL_HTML, "bad")
    page = "<p>x</p><script>window.__D__ = {\"v\": 1.0};</script>"
    assert_same_html(page.replace("1.0", "1.00001"), page, "ok")
    with pytest.raises(AssertionError):
        assert_same_html(page.replace("<p>x", "<p>y"), page, "bad")
