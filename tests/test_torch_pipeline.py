"""The port's per-gene pipeline (``fit/pipeline.py``, ``fit/sensitivity.py``,
``ops/morris.py``, ``models/knockout.py``) against the JAX package on the
CPU at float64.

Tolerances: the knockout masks, labels and combinations and the Morris
design and analysis of one (X, Y) exactly (the same numpy code and
streams); Morris outputs of the solved design within rtol 1e-8 (elementary
effects divide differences of Y by the step, which amplifies the solves'
1e-11); knockout trajectories within rtol 1e-8 (atol 1e-8 of the largest
state: a knocked-out state decays to ~1e-40); the fits as in ``test_torch_normest.py`` (rtol 1e-8).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from phoskintime_tpu.fit.pipeline import extract_gene_data as jax_extract
from phoskintime_tpu.fit.pipeline import process_gene as jax_process_gene
from phoskintime_tpu.fit.pipeline import run_model_pipeline as jax_run_model_pipeline
from phoskintime_tpu.fit.sensitivity import sensitivity_analysis as jax_sensitivity
from phoskintime_tpu.models import knockout as jax_knockout
from phoskintime_tpu.ops import morris as jax_morris
from phoskintime_tpu_torch.fit.normest import NormestResult
from phoskintime_tpu_torch.fit.pipeline import extract_gene_data, process_gene, run_model_pipeline
from phoskintime_tpu_torch.fit.sensitivity import sensitivity_analysis
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.models import knockout
from phoskintime_tpu_torch.ops import morris
from test_normest import BOUNDS, TIME_POINTS, synth_gene
from test_torch_normest import SMALL, assert_fit_close

torch.set_num_threads(2)

RTOL = 1e-8
MORRIS_SMALL = dict(num_trajectories=20, num_levels=8)


def test_knockouts_exact():
    for n in range(6):
        assert knockout.generate_knockout_combinations(n) == \
            jax_knockout.generate_knockout_combinations(n)
        for npar in (4 + 2 * n, 4 + n + (1 << n) - 1):
            masks, combos = knockout.knockout_mask_matrix(n, npar)
            want_masks, want_combos = jax_knockout.knockout_mask_matrix(n, npar)
            np.testing.assert_array_equal(masks, want_masks)
            assert combos == want_combos
            assert [knockout.knockout_label(c) for c in combos] == \
                [jax_knockout.knockout_label(c) for c in combos]
    p = np.arange(1.0, 9.0)
    ko = {"transcription": True, "phosphorylation": [1, 7]}
    np.testing.assert_array_equal(knockout.apply_knockout(p, ko, 2),
                                  jax_knockout.apply_knockout(p, ko, 2))


@pytest.mark.parametrize("d,levels", [(6, 4), (9, 40)])
def test_morris_sample_and_analyze_exact(d, levels):
    rng = np.random.default_rng(d)
    bounds = np.asarray([morris.compute_bound(v, 0.5) for v in rng.uniform(-1, 3, d)])
    np.testing.assert_array_equal(
        bounds, np.asarray([jax_morris.compute_bound(v, 0.5) for v in np.random.default_rng(
            d).uniform(-1, 3, d)]))
    X = morris.morris_sample(bounds, 12, levels, np.random.default_rng(1))
    np.testing.assert_array_equal(
        X, jax_morris.morris_sample(bounds, 12, levels, np.random.default_rng(1)))
    Y = np.sin(X).sum(axis=1) + X[:, 0] * X[:, -1]
    for got, want in zip(morris.morris_analyze(bounds, X, Y, levels, seed=3),
                         jax_morris.morris_analyze(bounds, X, Y, levels, seed=3)):
        np.testing.assert_array_equal(got, want)
    for metric in ("total_signal", "mean", "variance", "dynamics", "l2_norm"):
        sol = X[:14, :5]
        assert morris.trajectory_metric(sol, metric) == jax_morris.trajectory_metric(sol, metric)


def assert_sensitivity_close(got, want):
    # the design scales with the fitted parameters, equal to rounding
    np.testing.assert_allclose(got.samples, want.samples, rtol=RTOL)
    np.testing.assert_allclose(got.Y, want.Y, rtol=RTOL)
    for a, b in zip(got.morris, want.morris):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.max(np.abs(b)))
    np.testing.assert_array_equal(got.top_indices, want.top_indices)
    np.testing.assert_allclose(got.top_solutions, want.top_solutions, rtol=RTOL, atol=1e-300)
    assert got.param_names == want.param_names


@pytest.mark.parametrize("model,n,metric", [("distmod", 2, "total_signal"),
                                            ("randmod", 2, "dynamics")])
def test_sensitivity_analysis_matches_jax(model, n, metric):
    true, y0, pr, p, r = synth_gene(model, n, 3)
    target = np.concatenate([r, pr, p.ravel()])
    kw = dict(model=model, y_metric=metric, **MORRIS_SMALL)
    # batch_size splits the design into chunks (the JAX package pads the last)
    want = jax_sensitivity(true, y0, n, TIME_POINTS, target, batch_size=64, **kw)
    got = sensitivity_analysis(true, y0, n, TIME_POINTS, target, batch_size=64,
                               device="cpu", **kw)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert_sensitivity_close(got, want)


def assert_gene_close(got, want):
    assert_fit_close(got.result, want.result)
    assert got.knockout_labels == want.knockout_labels
    # knocked-out states decay to ~1e-40: their error is relative to the scan's scale
    np.testing.assert_allclose(got.knockout_solutions, want.knockout_solutions, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(want.knockout_solutions)))
    assert (got.sensitivity is None) == (want.sensitivity is None)
    if want.sensitivity is not None:
        assert_sensitivity_close(got.sensitivity, want.sensitivity)


def test_process_gene_matches_jax():
    """Fit, knockouts and Morris on; then the same post-processing of the
    JAX fit carried across by from_reference."""
    n = 2
    _, _, pr, p, r = synth_gene("succmod", n, 4)
    kw = dict(model="succmod", run_sensitivity=True, sensitivity_kw=MORRIS_SMALL,
              normest_kw=SMALL)
    want = jax_process_gene("GENEP", pr, p, r, n, TIME_POINTS, BOUNDS, make_plots=False, **kw)
    got = process_gene("GENEP", pr, p, r, n, TIME_POINTS, BOUNDS, make_plots=False,
                       device="cpu", **kw)
    assert_gene_close(got, want)
    assert got.knockout_solutions.shape == (2 * 2 * (2 + n), len(TIME_POINTS), 2 + n)

    carried = from_reference(want.result)
    assert isinstance(carried, NormestResult) and carried.weight_name == want.result.weight_name
    post = process_gene("GENEP", pr, p, r, n, TIME_POINTS, BOUNDS, precomputed=carried,
                        device="cpu", **kw)
    assert post.result is carried
    assert_gene_close(post, want)


def tidy_frames(genes):
    rows_p, rows_ph, rows_r = [], [], []
    for seed, name, n in genes:
        _, _, pr, p, r = synth_gene("distmod", n, seed)
        rows_p += [(name, t, v) for t, v in zip(TIME_POINTS, pr)]
        rows_ph += [(name, f"S{j + 1}", t, v) for j in range(n) for t, v in zip(TIME_POINTS, p[j])]
        rows_r += [(name, t, v) for t, v in zip(TIME_POINTS[5:], r)]
    return (pd.DataFrame(rows_p, columns=["protein", "time", "fc"]),
            pd.DataFrame(rows_ph, columns=["protein", "psite", "time", "fc"]),
            pd.DataFrame(rows_r, columns=["protein", "time", "fc"]))


def as_columns(df):
    return {c: df[c].to_numpy() for c in df.columns}


def test_extract_gene_data_frames_and_columns():
    frames = tidy_frames([(5, "GA", 2), (7, "GC", 1)])
    for g in ("GA", "GC", "GZ"):
        got = extract_gene_data(*frames, g, TIME_POINTS, TIME_POINTS[5:])
        cols = extract_gene_data(*map(as_columns, frames), g, TIME_POINTS, TIME_POINTS[5:])
        want = jax_extract(*frames, g, TIME_POINTS, TIME_POINTS[5:])
        for a, b, c in zip(got[:3], cols[:3], want[:3]):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
        assert got[3] == cols[3] == list(want[3])


def test_run_model_pipeline_frames_and_columns_match_jax():
    frames = tidy_frames([(5, "GA", 2), (11, "GB", 2), (7, "GC", 1)])
    kw = dict(time_points=TIME_POINTS, rna_time_points=TIME_POINTS[5:], bounds=BOUNDS,
              model="distmod", normest_kw=SMALL)
    want = jax_run_model_pipeline(*frames, out_dir=None, make_plots=False, **kw)
    got = run_model_pipeline(*frames, device="cpu", **kw)
    cols = run_model_pipeline(*map(as_columns, frames), device="cpu", **kw)
    assert list(got) == list(cols) == list(want) == ["GA", "GB", "GC"]
    for g in want:
        assert_gene_close(got[g], want[g])
        assert_gene_close(cols[g], want[g])


def test_out_dir_and_default_device_raise():
    frames = tidy_frames([(7, "GC", 1)])
    kw = dict(time_points=TIME_POINTS, rna_time_points=TIME_POINTS[5:], bounds=BOUNDS)
    with pytest.raises(NotImplementedError, match="item 8"):
        run_model_pipeline(*frames, out_dir="results", device="cpu", **kw)
    _, _, pr, p, r = synth_gene("distmod", 1, 7)
    with pytest.raises(NotImplementedError, match="item 8"):
        process_gene("GC", pr, p, r, 1, TIME_POINTS, BOUNDS, out_dir="results", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_model_pipeline(*frames, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_gene("GC", pr, p, r, 1, TIME_POINTS, BOUNDS)
