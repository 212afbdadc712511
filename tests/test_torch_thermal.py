"""The thermal variant (``analysis/thermal.py``) against the JAX package's,
on the CPU at float64.

The JAX demo network (mechanism 0 at 6 proteins and 3 kinases, mechanism 2
at 4 and 2, whose RK45 solves cost most on the CPU) is carried
across with ``from_reference``: ``thermalize`` is held equal bit for bit
(the scaled weights and degradation rates, numpy or tensor, with the
system's device and dtype kept), ``compare_thermal_standard``'s three
RK45 tables within rtol 1e-9 and its figure by its record; then the JAX
package's own three checks of the variant (tests/test_coverage_gaps.py's
thermal class) run on the port.
"""

import numpy as np
import pytest
import torch
from torch_figures import assert_same_records, capture_jax, capture_port

import phoskintime_tpu.analysis.thermal as jth
from phoskintime_tpu.demo import build_demo_network as jax_demo
from phoskintime_tpu_torch.analysis import thermal as th
from phoskintime_tpu_torch.interop import from_reference
from phoskintime_tpu_torch.network.expo import (exponential_simulate,
                                                exponential_simulate_batched)
from phoskintime_tpu_torch.network.simulate import simulate

RTOL = 1e-9
GRID = np.array([0.0, 1.0, 4.0, 16.0, 60.0, 240.0])
T_SHORT = np.linspace(0.0, 240.0, 25)


@pytest.fixture(scope="module", params=[(0, 6, 3), (2, 4, 2)], ids=["model0", "model2"])
def nets(request):
    model, n, k = request.param
    bj = jax_demo(n_proteins=n, n_kinases=k, model=model, seed=0, dtype=np.float64)
    system = from_reference(bj["system"], device="cpu")
    Tm = np.random.default_rng(model).uniform(36.0, 44.0, bj["topo"].N)
    return bj, system, Tm


def test_folded_fraction_matches_jax():
    Tm = np.linspace(30, 50, 9)
    for T in (0.0, 20.0, 37.0, 42.0):
        np.testing.assert_array_equal(th.folded_fraction(T, Tm, 0.7),
                                      jth.folded_fraction(T, Tm, 0.7))
    assert th.DEFAULT_TEMPERATURES == jth.DEFAULT_TEMPERATURES


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_thermalize_matches_jax(nets, as_tensor):
    """W, D_i and Dp_i equal JAX's exactly; the rates keep their kind and
    device, the system its device and dtype; the rest is shared."""
    bj, system, Tm = nets
    true = bj["true"]
    params = ({k: torch.as_tensor(v, dtype=torch.float64) for k, v in true.items()}
              if as_tensor else dict(true))
    sys_T, p_T = th.thermalize(system, params, 39.0, Tm, c_fold=0.9, k_unfold=3.0)
    jsys, jp = jth.thermalize(bj["system"], true, 39.0, Tm, c_fold=0.9, k_unfold=3.0)
    np.testing.assert_array_equal(sys_T.topo.W_pad, np.asarray(jsys.topo.W_pad))
    for k in ("D_i", "Dp_i"):
        got = p_T[k].numpy() if as_tensor else p_T[k]
        assert isinstance(p_T[k], torch.Tensor) == as_tensor
        np.testing.assert_array_equal(got, np.asarray(jp[k]))
    assert sys_T.device == system.device and sys_T.dtype == system.dtype == torch.float64
    assert p_T["A_i"] is params["A_i"]
    np.testing.assert_array_equal(sys_T.Kmat, system.Kmat)

    sys32 = system.astype(torch.float32)
    assert th.thermalize(sys32, true, 39.0, Tm)[0].dtype == torch.float32


def frames_equal(got: dict, want, name):
    assert list(got) == list(want.columns), name
    for c in want.columns:
        w, g = want[c].to_numpy(), np.asarray(got[c])
        if w.dtype.kind in "fiub":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * np.abs(w).max(),
                                       err_msg=f"{name}:{c}")
        else:
            assert g.tolist() == w.tolist(), (name, c)


def test_compare_thermal_standard_matches_jax(nets, tmp_path):
    """The three temperatures' protein, RNA and phospho tables and the
    comparison figure, against JAX's (RK45 to t = 240 on 25 points)."""
    bj, system, Tm = nets
    with capture_jax() as want:
        jout = jth.compare_thermal_standard(bj["system"], bj["true"], Tm, t_eval=T_SHORT,
                                            out_dir=str(tmp_path / "jax"))
    with capture_port() as got:
        out = th.compare_thermal_standard(system, bj["true"], Tm, t_eval=T_SHORT,
                                          out_dir=str(tmp_path / "port"))
    assert list(out) == list(jout) == [lab for lab, _ in th.DEFAULT_TEMPERATURES]
    for lab in out:
        for k, name in enumerate(("protein", "rna", "phospho")):
            frames_equal(out[lab][k], jout[lab][k], f"{lab}:{name}")
    assert_same_records(got, want, tmp_path / "port", tmp_path / "jax")


# ---------------------------------------------------------------------------
# the JAX package's thermal checks, on the port
# ---------------------------------------------------------------------------

def test_cold_limit_recovers_standard_model(nets):
    """Far below every Tm, f -> 1: the thermal system is the standard one."""
    bj, system, _ = nets
    params = bj["true"]
    sys_T, p_T = th.thermalize(system, params, T=0.0, Tm_i=np.full(system.topo.N, 40.0))
    r0 = simulate(system, params, GRID)
    rT = simulate(sys_T, p_T, GRID)
    np.testing.assert_allclose(rT.ys.numpy(), r0.ys.numpy(), rtol=1e-5, atol=1e-7)


def test_heat_shock_reduces_protein(nets, tmp_path):
    """Above Tm, faster clearance and a slower phospho flux lower the late
    total protein; the comparison figure is written."""
    bj, system, _ = nets
    out = th.compare_thermal_standard(system, bj["true"], Tm_i=np.full(system.topo.N, 40.0),
                                      t_eval=T_SHORT, out_dir=str(tmp_path))
    cold, hot = out["standard_20C"][0], out["heat_shock_42C"][0]
    assert hot["pred_fc"][-1] < cold["pred_fc"][-1]
    assert (tmp_path / "thermal_comparison.png").exists()


def test_expo_path_valid_for_thermal_system(nets):
    """The thermal transform keeps the RHS affine a bucket: both ETD2RK
    routes (the batched table path and the per-candidate one) agree with a
    tight RK45 solve of the thermal system."""
    bj, system, _ = nets
    sys_T, p_T = th.thermalize(system, bj["true"], T=39.0, Tm_i=np.full(system.topo.N, 40.0))
    ref = simulate(sys_T, p_T, GRID, rtol=1e-9, atol=1e-11, max_steps=200000).ys.numpy()
    p_b = {k: np.asarray(v)[None] for k, v in p_T.items()}
    for ys in (exponential_simulate_batched(sys_T, p_b, GRID)[0][0].numpy(),
               exponential_simulate(sys_T, p_b, GRID).ys[0].numpy()):
        err = np.max(np.abs(ys - ref) / (np.abs(ref) + 1e-8))
        assert err < 1e-3, err
