"""The optimization-network schematics (``report/schematic.py``) and the
``diagram`` command against the JAX package's, on the CPU.

Each figure is held to the JAX writer's matplotlib figure by its record
(``tests/torch_figures.py``: the circles, the Bezier edges with their
codes and dashes, the arrows, the labels on their rounded boxes, the notes'
rounded boxes, data at rtol 1e-9); :class:`Diagram`'s layered layout (one
barycenter sweep down and one up, Python's stable sort on ``np.mean``) is
held to JAX's node coordinates exactly. PIL (here only) decodes the
port's 300-dpi PNGs.
"""

import numpy as np
import pandas as pd
import pytest
from PIL import Image
from test_torch_export import weight_problems, written  # noqa: F401
from torch_figures import assert_same_records, capture_jax, capture_port
from torch_project import write_project

import phoskintime_tpu.cli as jcli
from phoskintime_tpu.report import schematic as js
from phoskintime_tpu_torch import cli
from phoskintime_tpu_torch.io.export import export_kinopt_results
from phoskintime_tpu_torch.report import schematic as ps

SIX = {"kinopt_diagram", "kinopt_constraints", "tfopt_diagram", "tfopt_constraints",
       "global_diagram", "global_constraints"}


def both(tmp_path, jax_fn, port_fn):
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(exist_ok=True), dp.mkdir(exist_ok=True)
    with capture_jax() as want:
        jout = jax_fn(dj)
    with capture_port() as got:
        out = port_fn(dp)
    assert_same_records(got, want, dp, dj)
    return jout, out


@pytest.mark.parametrize("kin_psites,tf_psites", [(1, 1), (2, 1), (1, 3)])
def test_schematics_match_jax(tmp_path, kin_psites, tf_psites):
    jout, out = both(tmp_path,
                     lambda d: js.render_all_schematics(d, kin_psites=kin_psites,
                                                        tf_psites=tf_psites),
                     lambda d: ps.render_all_schematics(d, kin_psites=kin_psites,
                                                        tf_psites=tf_psites))
    assert set(out) == set(jout) == SIX
    for name, path in out.items():
        with Image.open(path) as im:
            im.load()
            assert im.mode == "RGB" and min(im.size) > 1000, (name, im.size)


def random_graph(d, seed: int):
    """A seeded layered graph: 4 ranks of 2-5 nodes, each node of a rank
    below the first joined to 1-3 nodes of the rank above, some edges
    bent, labelled or dashed, a note on rank 1."""
    rng = np.random.default_rng(seed)
    ranks = [[f"r{r}n{i}" for i in range(int(rng.integers(2, 6)))] for r in range(4)]
    for r, names in enumerate(ranks):
        for n in names:
            d.node(n, n, "#1f77ff", r)
    for r in range(1, 4):
        for n in ranks[r]:
            for m in rng.choice(ranks[r - 1], int(rng.integers(1, 4))):
                d.edge(str(m), n, label=f"e{r}", bend=float(rng.choice([0.0, 0.3, -0.2])),
                       style=str(rng.choice(["solid", "dashed"])))
    d.node("note", "a\nnote", "#f2f2f2", 1, kind="note")
    d.edge("note", ranks[1][0], "", "#999999", style="dashed", arrow=False)
    return d


@pytest.mark.parametrize("seed", range(4))
def test_diagram_layout_matches_jax(tmp_path, seed):
    """The node coordinates after the layout, exactly; and the figure."""
    jd, pd_ = random_graph(js.Diagram(), seed), random_graph(ps.Diagram(), seed)
    jd._layout(), pd_._layout()
    assert list(pd_.nodes) == list(jd.nodes)
    for name, n in jd.nodes.items():
        assert (pd_.nodes[name].x, pd_.nodes[name].y) == (n.x, n.y), name
    both(tmp_path, lambda d: random_graph(js.Diagram(), seed).render(str(d / "g.png"), "t"),
         lambda d: random_graph(ps.Diagram(), seed).render(str(d / "g.png"), "t"))


def alpha_beta(beta_kind: str):
    rng = np.random.default_rng(0)
    rows = [(g, s, k, float(rng.normal(0.3, 0.4))) for g in ["GA", "GB"] for s in ["S1", "T2"]
            for k in ["K1", "K2", "K3"]]
    alpha = pd.DataFrame(rows, columns=["Gene", "Psite", "Kinase", "Alpha"])
    alpha.loc[5, "Alpha"] = 1e-4                         # under min_weight
    beta = {"global": pd.DataFrame({"Kinase": ["K1", "K2", "K3"], "Psite": ["", "", ""],
                                    "Beta": [0.5, 0.3, 0.2]}),
            "per-site": pd.DataFrame({"Kinase": ["K1", "K2", "K1"], "Psite": ["a", "b", "c"],
                                      "Beta": [0.5, 0.3, 0.2]}),
            "empty": pd.DataFrame({"Kinase": [], "Psite": [], "Beta": []}),
            "none": None}[beta_kind]
    return alpha, beta


def table(df):
    return None if df is None else {c: df[c].to_numpy() for c in df.columns}


@pytest.mark.parametrize("beta_kind", ["global", "per-site", "empty", "none"])
@pytest.mark.parametrize("top", [60, 8, 4])
def test_fitted_network_matches_jax(tmp_path, beta_kind, top):
    """The fitted network: the top edges by |alpha| (and the title saying how
    many were dropped), the fan-in bends, the beta notes."""
    alpha, beta = alpha_beta(beta_kind)
    both(tmp_path,
         lambda d: js.fitted_network_schematic(alpha, beta, str(d / "f.png"), top_edges=top),
         lambda d: ps.fitted_network_schematic(table(alpha), table(beta), str(d / "f.png"),
                                               top_edges=top))


@pytest.fixture(scope="module")
def workbook(tmp_path_factory, weight_problems):  # noqa: F811
    """A kinopt workbook's CSV sheets from the shared fit, and a project."""
    root = write_project(tmp_path_factory.mktemp("diagram"))
    (_, _), (tp, tmeta) = weight_problems.kin
    path = root / "data" / "kinopt_results.xlsx"
    export_kinopt_results(path, tp, weight_problems.kres, tmeta)
    return root, path


@pytest.mark.parametrize("extra", [[], ["--alpha-file", "@", "--top-edges", "5",
                                        "--kin-psites", "2"]])
def test_diagram_command_matches_jax(tmp_path, workbook, extra):
    """``diagram`` through both CLIs: the six schematics and, with
    ``--alpha-file``, the fitted network of the workbook's Alpha and Beta
    sheets (read through their CSV files); the file sets and the records."""
    root, path = workbook
    argv = [a if a != "@" else str(path) for a in extra]
    cfg = ["--config", str(root / "config.toml")]
    jout, out = both(tmp_path, lambda d: jcli.main(["diagram", *argv, *cfg, "--out-dir", str(d)]),
                     lambda d: cli.main(["diagram", *argv, *cfg, "--out-dir", str(d)]))
    want = SIX | ({"fitted_network"} if extra else set())
    assert set(out) == want
    assert written(tmp_path / "port") == written(tmp_path / "jax") == {f"{k}.png" for k in want}


def test_diagram_command_refuses_a_sheet_path(tmp_path, workbook):
    root, path = workbook
    with pytest.raises(FileNotFoundError, match="Alpha Values"):
        cli.main(["diagram", "--config", str(root / "config.toml"), "--alpha-file",
                  str(root / "nothing.xlsx"), "--out-dir", str(tmp_path)])
