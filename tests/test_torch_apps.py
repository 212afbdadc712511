"""The kinopt and tfopt result-explorer apps (``report/apps.py``) against the
JAX package's, on the CPU at float64.

Both packages render their app from the same carried-across fit (the
shared project's problems with seeded feasible weights,
``tests/test_torch_export.py::weight_problems``). The two pages are held
equal by ``assert_same_html`` (outside their JSON payloads byte for byte,
the time stamp and embedded images masked; the payloads' numbers within
the writers' rounding unit, 1e-4), the three figures by their records
(``tests/torch_figures.py``: data at rtol 1e-9), and the knockout preview,
one batched ``predict`` over the K regulators, against JAX's ``jax.vmap``
of its ``predict`` at rtol 1e-12.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_export import assert_same_html, weight_problems  # noqa: F401
from torch_figures import assert_same_records, capture_jax, capture_port

from phoskintime_tpu.report import apps as japps
from phoskintime_tpu_torch.report import apps

APP_FILES = {"identity_band.png", "breadth_load.png", "network_dag.png"}


def written(d: Path) -> set:
    return {str(p.relative_to(d)) for p in Path(d).rglob("*") if p.is_file()}


def fit_of(w, which):
    (jp, jmeta), (tp, tmeta) = w.kin if which == "kinopt" else w.tf
    return jp, jmeta, tp, tmeta, (w.kres if which == "kinopt" else w.tres)


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_app_matches_jax(tmp_path, weight_problems, which):  # noqa: F811
    """The written file set, the two pages and the three figures."""
    jp, jmeta, tp, tmeta, res = fit_of(weight_problems, which)
    dj, dp = tmp_path / "jax", tmp_path / "port"
    with capture_jax() as want:
        if which == "kinopt":
            jpage = japps.render_kinopt_app(jp, res, str(dj), meta=jmeta)
        else:
            jpage = japps.render_tfopt_app(jp, res, str(dj))
    with capture_port() as got:
        if which == "kinopt":
            page = apps.render_kinopt_app(tp, res, str(dp), meta=tmeta, device="cpu")
        else:
            page = apps.render_tfopt_app(tp, res, str(dp), device="cpu")
    assert written(dp) == written(dj) == APP_FILES | {f"{which}_interactive.html",
                                                      f"{which}_app.html"}
    assert Path(page).name == Path(jpage).name == f"{which}_app.html"
    for name in (f"{which}_app.html", f"{which}_interactive.html"):
        assert_same_html((dp / name).read_text(), (dj / name).read_text(), name)
    assert_same_records(got, want, dp, dj, scaled=1e-9)


@pytest.mark.parametrize("which", ["kinopt", "tfopt"])
def test_knockout_preview_matches_jax_vmap(weight_problems, which):  # noqa: F811
    """One batched predict of the K knockouts against ``jax.vmap`` of JAX's
    predict with each regulator's alpha entries zeroed."""
    jp, _, tp, _, res = fit_of(weight_problems, which)
    if which == "kinopt":
        from phoskintime_tpu.kinopt.model import predict
        index, K = jnp.asarray(jp.gp_kin_idx), tp.n_k
        got = apps.kinopt_knockout_predictions(tp, res.alpha, res.beta, device="cpu")
    else:
        from phoskintime_tpu.tfopt.model import predict
        index, K = jnp.asarray(jp.regulators), tp.n_TF
        got = apps.tfopt_knockout_predictions(tp, res.alpha, res.beta, device="cpu")
    alpha, beta = jnp.asarray(res.alpha), jnp.asarray(res.beta)
    want = np.asarray(jax.vmap(lambda j: predict(jp, alpha * (index != j), beta))(
        jnp.arange(K)))
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_app_knockouts_run_on_the_given_device(weight_problems):  # noqa: F811
    """The preview runs where the caller says: the card by default, which
    raises here where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, _, tp, _, res = fit_of(weight_problems, "kinopt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apps.kinopt_knockout_predictions(tp, res.alpha, res.beta)


def test_report_package_exports_the_apps():
    """``report`` exports what the JAX package's ``report`` exports."""
    import phoskintime_tpu.report as jrep
    import phoskintime_tpu_torch.report as rep

    public = [n for n in dir(jrep) if not n.startswith("_")]
    missing = [n for n in public if not hasattr(rep, n)]
    assert not missing, missing
    assert rep.render_kinopt_app is apps.render_kinopt_app
