"""The port's figure writers against the JAX package's, on the CPU.

Every writer gets the same seeded inputs in both packages (DataFrames for
JAX, the same columns as dicts for the port). What each figure draws is
captured as a record (``tests/torch_figures.py``: matplotlib's figures as
the JAX writers save them, the port's through ``Figure.record``) and the
records are held equal: the figure size, dpi and suptitle; each axes'
titles, labels, scales, limits where set, explicit ticks and tick labels,
grid, ``axis("off")`` and legend texts; every line, scatter, bar and image
with its data, colours and label; the PDF's pages and the animation's
frames in order. Strings are equal but for the numbers printed in them
(rtol 1e-9), colours exactly, data at rtol 1e-9.

The port's own files are checked with PIL (never imported by the port):
each PNG decodes, and where JAX saves without ``bbox_inches="tight"`` its
size equals JAX's; the PDF's cross-reference offsets each point at their
object and its page count is JAX's; the GIF decodes with JAX's frame
count. The rasteriser puts a line, a bar and an image cell on the pixels
the axes' transform gives, in their colours, and the colormaps equal
matplotlib's.
"""

import base64
import io
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
from PIL import Image as PILImage
from test_torch_export import GENERATED, net  # noqa: F401  (the shared network fixture)
from torch_figures import (assert_same_record, assert_same_records, capture_jax, capture_port,
                           pdf_pages, pdf_xref_ok)

from phoskintime_tpu.io import export as jex
from phoskintime_tpu_torch.io import export as ex
from phoskintime_tpu_torch.io.utils import write_csv
from phoskintime_tpu_torch.report import draw

TIMES = np.array([0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0, 120.0, 240.0])


def frame(table):
    return None if table is None else pd.DataFrame({k: list(v) for k, v in table.items()})


def run_both(tmp_path, jax_fn, port_fn):
    """Both writers into their own folder under captures; returns the two
    folders and captures."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(parents=True), dp.mkdir(parents=True)
    with capture_jax() as want:
        jout = jax_fn(dj)
    with capture_port() as got:
        pout = port_fn(dp)
    assert_same_records(got, want, dp, dj)
    return SimpleNamespace(dj=dj, dp=dp, want=want, got=got, jout=jout, pout=pout)


def png_size(path) -> tuple:
    with PILImage.open(path) as im:
        im.load()
        return im.size


def check_pngs(runs, exact_size: bool):
    """Each PNG the port wrote decodes; ``exact_size``: its size is JAX's."""
    for path in runs.got:
        if not path.endswith(".png"):
            continue
        size = png_size(path)
        assert size[0] > 0 and size[1] > 0
        if exact_size:
            assert size == png_size(runs.dj / Path(path).relative_to(runs.dp)), path


# ---------------------------------------------------------------------------
# the drawing layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["viridis", "RdBu_r"])
def test_colormaps_equal_matplotlibs(name):
    from matplotlib import colormaps

    want = colormaps[name](np.arange(256))[:, :3]
    np.testing.assert_array_equal(draw.colormap(name), want)


def test_colours_equal_matplotlibs():
    import matplotlib.colors as mcolors

    for c in ["C0", "C7", "tab:red", "k", "red", "blue", "gray", (0.1, 0.2, 0.3)]:
        assert draw.to_rgba(c) == mcolors.to_rgba(c), c
        assert draw.to_rgba(c, 0.4) == mcolors.to_rgba(c, 0.4), c
    assert draw.TAB10 == tuple(mcolors.to_rgb(f"C{i}") for i in range(10))
    with pytest.raises(ValueError, match="unknown colour"):
        draw.to_rgba("nocolour")


def test_font_covers_the_writers_text():
    from phoskintime_tpu_torch.report.draw import font

    for ch in [chr(c) for c in range(32, 127)] + list("—²χ≤≥αβλΣŷ₀→←"):
        assert ch in font.GLYPHS, ch
    assert font.text_width("R²=0.5 — χ²", 10) > 0
    assert font.text_width(r"$\beta$ → β₀ ← $\frac{1}{n}\sum_i(y_i-\hat y_i)^2$", 10) > 0
    with pytest.raises(ValueError, match="no glyph"):
        font.text_width("ж", 10)


def test_rasteriser_puts_artists_on_their_pixels(tmp_path):
    """A horizontal line, a bar and an image cell land on the pixels the
    axes' transform gives, in their colours (inside each, where coverage
    is whole)."""
    fig, (a_line, a_bar, a_img) = draw.subplots(1, 3, figsize=(9, 3), dpi=100)
    a_line.plot([0.0, 1.0], [0.5, 0.5], color="red", lw=6)
    a_bar.barh([0.0, 1.0], [2.0, 3.0], color="C0")
    a_img.imshow(np.array([[0.0, 1.0], [0.5, 0.25]]), cmap="viridis", vmin=0, vmax=1)
    path = tmp_path / "r.png"
    fig.savefig(path)
    with PILImage.open(path) as im:
        px = np.asarray(im.convert("RGB"))
    assert px.shape == (300, 900, 3)
    k = 100 / 72
    boxes = fig.boxes()

    def at(ax, x, y):
        tx, ty = ax._transform(ax._plot_box(boxes[ax]))
        return px[int(ty(np.float64(y)) * k), int(tx(np.float64(x)) * k)]

    assert tuple(at(a_line, 0.5, 0.5)) == (255, 0, 0)
    assert tuple(at(a_bar, 1.0, 0.0)) == (31, 119, 180)
    assert tuple(at(a_bar, 2.5, 1.0)) == (31, 119, 180)
    assert tuple(at(a_bar, 2.5, 0.0)) == (255, 255, 255)          # past bar 0's end
    viridis = np.round(draw.colormap("viridis") * 255).astype(int)
    assert tuple(at(a_img, 1.0, 0.0)) == tuple(viridis[255])       # row 0, column 1: 1.0
    assert tuple(at(a_img, 0.0, 1.0)) == tuple(viridis[128])       # row 1, column 0: 0.5
    assert tuple(at(a_img, 1.0, 1.0)) == tuple(viridis[64])        # 0.25


def test_png_pdf_gif_encoders(tmp_path):
    """PNG round-trips through PIL exactly; the GIF holds each frame on the
    palette; the PDF's xref is exact with one page a figure."""
    from phoskintime_tpu_torch.report.draw import gif, png

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    with PILImage.open(io.BytesIO(png.encode_png(rgb, dpi=150))) as im:
        np.testing.assert_array_equal(np.asarray(im), rgb)
    frames = [rng.integers(0, 256, (120, 90, 3), dtype=np.uint8),     # forces table resets
              np.full((120, 90, 3), 255, np.uint8)]
    with PILImage.open(io.BytesIO(gif.encode_gif(frames, 20))) as im:
        assert im.n_frames == 2 and im.info["duration"] == 200 and im.info["loop"] == 0
        for k, f in enumerate(frames):
            im.seek(k)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          gif.palette()[gif.quantize(f)])
    with draw.PdfPages(tmp_path / "two.pdf") as pdf:
        for _ in range(2):
            fig, ax = draw.subplots()
            ax.plot([0, 1], [1, 0], "k--")
            pdf.savefig(fig)
    data = (tmp_path / "two.pdf").read_bytes()
    assert pdf_xref_ok(data) and pdf_pages(data) == 2


# ---------------------------------------------------------------------------
# report/plotter.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def front():
    rng = np.random.default_rng(2)
    F = rng.uniform(0.1, 3.0, (25, 3))
    history = [(g, rng.uniform(0.01, 1, 3), rng.uniform(1, 2, 3)) for g in range(6)]
    return SimpleNamespace(F=F, history=history)


@pytest.mark.parametrize("best_idx", [4, None])
def test_pareto_3d_matches_jax(tmp_path, front, best_idx):
    from phoskintime_tpu.report import plotter as jp
    from phoskintime_tpu_torch.report import plotter

    runs = run_both(tmp_path, lambda d: jp.plot_pareto_3d(front.F, str(d / "p.png"), best_idx),
                    lambda d: plotter.plot_pareto_3d(front.F, str(d / "p.png"), best_idx))
    check_pngs(runs, exact_size=False)


@pytest.mark.parametrize("n_gen", [6, 0])
def test_convergence_matches_jax(tmp_path, front, n_gen):
    from phoskintime_tpu.report import plotter as jp
    from phoskintime_tpu_torch.report import plotter

    hist = front.history[:n_gen]
    runs = run_both(tmp_path, lambda d: jp.plot_convergence(hist, str(d / "c.png")),
                    lambda d: plotter.plot_convergence(hist, str(d / "c.png")))
    assert (runs.pout is None) == (runs.jout is None) == (n_gen == 0)


def test_parallel_coords_matches_jax(tmp_path, front):
    from phoskintime_tpu.report import plotter as jp
    from phoskintime_tpu_torch.report import plotter

    F = front.F.copy()
    F[:, 2] = 1.5                       # a constant objective: span 1
    run_both(tmp_path, lambda d: jp.plot_parallel_coords_pareto(F, str(d / "p.png")),
             lambda d: plotter.plot_parallel_coords_pareto(F, str(d / "p.png")))


# ---------------------------------------------------------------------------
# io/export.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_members", [7, 2])
def test_correlation_heatmap_matches_jax(tmp_path, net, n_members):  # noqa: F811
    """The heatmap beside the table (2 members: the identity)."""
    X = net.X[:n_members]

    def go(pkg, topo):
        return lambda d: pkg.export_param_correlations(
            str(d / "c.xlsx"), X, net.slices, topo, heatmap_path=str(d / "c.png"))
    runs = run_both(tmp_path, go(jex, net.jtopo), go(ex, net.topo))
    assert runs.pout[-1] == str(runs.dp / "c.png") and runs.jout[-1] == str(runs.dj / "c.png")
    check_pngs(runs, exact_size=False)


def test_correlation_heatmap_only_up_to_200_parameters(tmp_path, net):  # noqa: F811
    """Past 200 parameters neither package draws the heatmap."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(5, 201))
    topo = SimpleNamespace(kinases=[f"K{i}" for i in range(201)], proteins=[], sites=[])
    runs = run_both(tmp_path, lambda d: jex.export_param_correlations(
        str(d / "c.xlsx"), X, net.slices, topo, heatmap_path=str(d / "c.png")),
        lambda d: ex.export_param_correlations(str(d / "c.xlsx"), X, net.slices, topo,
                                               heatmap_path=str(d / "c.png")))
    assert not runs.got and not (runs.dp / "c.png").exists()


def s_rates_csv(path, case: str) -> str:
    """A long S-rate table: P1 three sites, P2 fourteen (two pages), P3 one;
    a repeated row (averaged) and a row with a missing S. ``zero``: times
    from 0 (symlog); ``positive``: integer times from 1 (log, int labels)
    and an infinite S at an early time (kept, as pandas' ``dropna`` keeps
    it: P2 S3 heads the AUC ranking and the early/late scatter holds it)."""
    rng = np.random.default_rng(7)
    times = TIMES if case == "zero" else np.array([1, 2, 4, 8, 15, 30, 60, 120, 240])
    rows = []
    for prot, n in (("P1", 3), ("P2", 14), ("P3", 1)):
        for s in range(n):
            for t in times:
                rows.append((prot, f"S{s + 1}", t, float(rng.uniform(0, 2))))
    rows.append(("P1", "S1", times[2], 0.75))
    table = {"protein": np.asarray([r[0] for r in rows], dtype=object),
             "psite": np.asarray([r[1] for r in rows], dtype=object),
             "time": np.asarray([r[2] for r in rows]),
             "S": np.asarray([r[3] for r in rows], float)}
    table["S"][5] = np.nan
    if case == "positive":
        table["S"][(3 + 2) * len(times) + 1] = np.inf        # P2 S3 at t = 2
    return write_csv(path, table)


@pytest.mark.parametrize("case", ["zero", "positive"])
def test_s_rates_report_matches_jax(tmp_path, case):
    """Every page: the AUC bars, early against late, each protein's
    heatmap and time-series pages."""
    csv = s_rates_csv(tmp_path / "S.csv", case)
    runs = run_both(tmp_path, lambda d: jex.plot_s_rates_report(csv, str(d / "S.pdf")),
                    lambda d: ex.plot_s_rates_report(csv, str(d / "S.pdf")))
    pages = runs.got[str(runs.dp / "S.pdf")]
    assert len(pages) == 2 + 3 + 4           # AUC, early/late, 3 heatmaps, P1 P2 P2 P3 series
    data = (runs.dp / "S.pdf").read_bytes()
    assert pdf_xref_ok(data)
    assert pdf_pages(data) == pdf_pages((runs.dj / "S.pdf").read_bytes()) == len(pages)
    scale = pages[-1]["axes"][0]["xscale"]
    assert scale == ("symlog" if case == "zero" else "log")


def gof_tables(rng, empty_phospho: bool):
    proteins, sites = ["GA", "GB", "GC"], {"GA": ["S1", "S2"], "GC": ["T3"]}
    t = TIMES[1:8]

    def traj(with_site):
        rows = [(sid, p, s, tt) for sid in (3, 0) for p in proteins
                for s in (sites.get(p, []) if with_site else [None]) for tt in t]
        out = {"sol_id": np.asarray([r[0] for r in rows], np.int64),
               "protein": np.asarray([r[1] for r in rows], dtype=object)}
        if with_site:
            out["psite"] = np.asarray([r[2] for r in rows], dtype=object)
        out["time"] = np.asarray([r[3] for r in rows], float)
        out["pred_fc"] = rng.uniform(0.5, 2, len(rows))
        return out

    def obs(with_site):
        rows = [(p, s, tt) for p in proteins for s in (sites.get(p, []) if with_site else [None])
                for tt in TIMES[::-1]]          # some times the trajectories lack
        out = {"protein": np.asarray([r[0] for r in rows], dtype=object)}
        if with_site:
            out["psite"] = np.asarray([r[1] for r in rows], dtype=object)
        out["time"] = np.asarray([r[2] for r in rows], float)
        out["fc"] = rng.uniform(0.5, 2, len(rows))
        out["w"] = np.ones(len(rows))
        return out
    pho = obs(True)
    if empty_phospho:
        pho = {k: v[:0] for k, v in pho.items()}
    return (traj(False), traj(False), traj(True)), (obs(False), obs(False), pho)


@pytest.mark.parametrize("empty_phospho", [False, True])
def test_gof_solutions_match_jax(tmp_path, empty_phospho):
    """One figure a solution; an empty modality's axes off."""
    trajs, obs = gof_tables(np.random.default_rng(3), empty_phospho)
    runs = run_both(
        tmp_path,
        lambda d: jex.plot_gof_solutions(*map(frame, trajs), *map(frame, obs), str(d / "g")),
        lambda d: ex.plot_gof_solutions(*trajs, *obs, str(d / "g")))
    assert [Path(p).name for p in runs.pout] == ["gof_sol0.png", "gof_sol3.png"]
    assert runs.got[runs.pout[0]][0]["axes"][2]["off"] is empty_phospho
    check_pngs(runs, exact_size=True)


@pytest.mark.parametrize("n_gen", [5, 0])
def test_convergence_plot_matches_jax(tmp_path, front, n_gen):
    hist = front.history[:n_gen]
    runs = run_both(tmp_path, lambda d: jex.process_convergence_history(hist, str(d)),
                    lambda d: ex.process_convergence_history(hist, str(d)))
    assert (runs.pout is None) is (n_gen == 0)
    check_pngs(runs, exact_size=True)


@pytest.mark.parametrize("snapshots,max_frames", [(4, 60), (8, 3), (0, 60)])
def test_convergence_video_matches_jax(tmp_path, snapshots, max_frames):
    """Every frame; more snapshots than ``max_frames`` subsampled with the
    last kept; none: no file. Both packages write a GIF here (no ffmpeg)."""
    rng = np.random.default_rng(11)
    hist = [(g, rng.uniform(0.1, 2.0, (12, 3))) for g in range(snapshots)]
    pareto = rng.uniform(0.1, 2.0, (5, 3))
    runs = run_both(
        tmp_path,
        lambda d: jex.create_convergence_video(hist, pareto, str(d), max_frames=max_frames),
        lambda d: ex.create_convergence_video(hist, pareto, str(d), max_frames=max_frames))
    if not snapshots:
        assert runs.pout is None and runs.jout is None and not runs.got
        return
    assert runs.jout.endswith("optimization_history.gif")
    frames = runs.got[runs.pout]
    want_frames = {4: 4, 8: 4}[snapshots]              # 8 by a stride of 3: 0 3 6, then 7
    assert len(frames) == want_frames
    for path in (runs.pout, runs.jout):
        with PILImage.open(path) as im:
            assert im.n_frames == want_frames
    assert frames[-1]["axes"][0]["title"] == f"Optimization History - Gen {snapshots - 1}"


def series_tables(rng):
    """Observed and predicted tables: GA (two sites), GB (no phospho), GC
    (phospho observed only), GD (eleven sites: the colours wrap), GE (one
    site)."""
    def table(rows, col):
        out = {"protein": np.asarray([r[0] for r in rows], dtype=object)}
        if rows and len(rows[0]) == 3:
            out["psite"] = np.asarray([r[1] for r in rows], dtype=object)
        out["time"] = np.asarray([r[-1] for r in rows], float)
        out[col] = rng.uniform(0.5, 2, len(rows))
        return out
    prot = [(g, t) for g in ("GA", "GB", "GD", "GE") for t in TIMES[::-1]]
    sites = {"GA": ["S1", "T2"], "GC": ["Y1"], "GD": [f"S{i}" for i in range(11)], "GE": ["S9"]}
    pho_obs = [(g, s, t) for g, ss in sites.items() for s in ss for t in TIMES]
    pho_pred = [(g, s, t) for g, ss in sites.items() if g != "GC" for s in ss for t in TIMES]
    return (table(prot, "fc"), table(prot, "pred_fc"), table(prot[:22], "fc"),
            table(prot[:22], "pred_fc"), table(pho_obs, "fc"), table(pho_pred, "pred_fc"))


@pytest.mark.parametrize("phos_mode", ["per_psite", "mean"])
def test_gene_timeseries_match_jax(tmp_path, phos_mode):
    """``save_all_gene_timeseries``: a figure a protein of any table."""
    tables = series_tables(np.random.default_rng(4))
    runs = run_both(
        tmp_path,
        lambda d: jex.save_all_gene_timeseries(*map(frame, tables), str(d / "ts"),
                                               phos_mode=phos_mode),
        lambda d: ex.save_all_gene_timeseries(*tables, str(d / "ts"), phos_mode=phos_mode))
    assert [Path(p).name for p in runs.pout] == [f"ts_G{c}.png" for c in "ABCDE"]
    check_pngs(runs, exact_size=False)


def test_gene_timeseries_of_an_absent_protein(tmp_path):
    tables = series_tables(np.random.default_rng(4))
    assert ex.save_gene_timeseries_plots("nope", *tables, str(tmp_path)) is None
    assert jex.save_gene_timeseries_plots("nope", *map(frame, tables), str(tmp_path)) is None


# ---------------------------------------------------------------------------
# analysis/mechanisms.py and report/dashboard.py
# ---------------------------------------------------------------------------

def mechanism_inputs(rng):
    from phoskintime_tpu_torch.io.export import rows_to_table

    t = TIMES
    prot_names, rna_names = ["GA", "GB", "GC", "GD"], [f"R{i}" for i in range(7)]

    def obs(names):
        return {"protein": np.asarray([p for p in names for _ in t], dtype=object),
                "time": np.tile(t, len(names)), "fc": rng.uniform(0.5, 2, len(names) * len(t))}

    def pred(names):
        return {"protein": np.asarray([p for p in names for _ in t], dtype=object),
                "time": np.tile(t, len(names)),
                "pred_fc": rng.uniform(0.5, 2, len(names) * len(t))}
    trajs = {m: (pred(prot_names), pred(rna_names), pred([])) for m in (1, 0, 2, 4)}
    rows = [{"model": m, "mechanism": name, "aic": aic, "delta_aic": aic - 10.0,
             "akaike_weight": w} for m, name, aic, w in
            [(1, "sequential", 10.0, 0.6), (0, "distributive", 11.0, 0.3),
             (2, "combinatorial", 12.5, 0.08), (4, "saturating", 15.0, 0.02)]]
    return rows_to_table(rows), trajs, (obs(prot_names), obs(rna_names), None)


def test_mechanism_overlays_match_jax(tmp_path):
    """``overlay_protein.png`` (four proteins: two panels off) and
    ``overlay_rna.png`` (the first six of seven), and the summary page."""
    from phoskintime_tpu.analysis import mechanisms as jmech
    from phoskintime_tpu_torch.analysis import mechanisms

    table, trajs, obs = mechanism_inputs(np.random.default_rng(6))
    jtrajs = {m: tuple(frame(t) for t in v) for m, v in trajs.items()}
    runs = run_both(
        tmp_path,
        lambda d: jmech._write_selection_artifacts(frame(table), jtrajs, tuple(map(frame, obs)),
                                                   str(d)),
        lambda d: mechanisms._write_selection_artifacts(table, trajs, obs, str(d)))
    assert list(runs.pout) == list(runs.jout) == ["table", "overlay_protein", "overlay_rna",
                                                   "html"]
    assert [a["off"] for a in runs.got[runs.pout["overlay_protein"]][0]["axes"]] == [
        False] * 4 + [True] * 2
    check_pngs(runs, exact_size=True)
    assert (runs.dp / "mechanism_selection.html").read_text() == (
        runs.dj / "mechanism_selection.html").read_text()


IMG = re.compile(r'src="data:image/png;base64,[A-Za-z0-9+/=]*"')


def test_dashboard_matches_jax(tmp_path, front):
    """``save_dashboard_bundle`` keeps JAX's keys; ``render_dashboard``'s
    figures match JAX's and its page is JAX's with the images masked."""
    from phoskintime_tpu.report import dashboard as jdash
    from phoskintime_tpu_torch.report import dashboard

    rng = np.random.default_rng(9)
    pred = {"protein": np.asarray(["GA"] * 60, dtype=object), "time": np.arange(60.0),
            "pred_fc": rng.uniform(0.5, 2, 60)}
    kw = dict(pareto_X=rng.normal(size=(25, 4)), pareto_F=front.F, best_idx=3,
              topo_summary={"N": 7, "K": 2, "total_sites": 7, "orphans_rewired": 1, "model": 0},
              history=front.history)
    dj, dp = tmp_path / "jax", tmp_path / "port"
    jdash.save_dashboard_bundle(str(dj / "b.pkl"), pred_prot=frame(pred), **kw)
    dashboard.save_dashboard_bundle(str(dp / "b.pkl"), pred_prot=pred, **kw)
    jb, pb = jdash.load_dashboard_bundle(str(dj / "b.pkl")), dashboard.load_dashboard_bundle(
        str(dp / "b.pkl"))
    assert list(pb) == list(jb)
    for c in pred:
        assert np.asarray(pb["pred_prot"][c]).tolist() == jb["pred_prot"][c].tolist()
    runs = run_both(tmp_path / "render",
                    lambda d: jdash.render_dashboard(str(dj / "b.pkl"), str(d)),
                    lambda d: dashboard.render_dashboard(str(dp / "b.pkl"), str(d)))
    pages = [GENERATED.sub("", IMG.sub("", Path(p).read_text())) for p in (runs.pout, runs.jout)]
    assert pages[0] == pages[1]
    assert Path(runs.pout).read_text().count("<img") == 3
    for b64 in re.findall(r"base64,([A-Za-z0-9+/=]+)", Path(runs.pout).read_text()):
        with PILImage.open(io.BytesIO(base64.b64decode(b64))) as im:
            im.load()


def test_run_dashboard_writes_the_static_page(tmp_path, front, capsys):
    from phoskintime_tpu_torch.report import dashboard

    path = dashboard.save_dashboard_bundle(str(tmp_path / "b.pkl"), pareto_X=front.F,
                                           pareto_F=front.F, best_idx=0)
    out = dashboard.run_dashboard(path, str(tmp_path / "dash"))
    assert out == str(tmp_path / "dash" / "dashboard.html")
    assert "the Streamlit viewer is not ported" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "dash").iterdir()) == [
        "dashboard.html", "pareto_3d.png", "pareto_parallel.png"]


def test_one_record_compares_exactly():
    """The comparison: a changed colour, label or number fails."""
    fig, ax = draw.subplots()
    ax.plot([0, 1], [1, 2], color="C1", label="a")
    rec = fig.record(100)
    assert_same_record(fig.record(100), rec)
    ax.children[0].color = draw.to_rgba("C2")
    with pytest.raises(AssertionError):
        assert_same_record(fig.record(100), rec)
    ax.children[0].color, ax.children[0].label = draw.to_rgba("C1"), "b"
    with pytest.raises(AssertionError):
        assert_same_record(fig.record(100), rec)
