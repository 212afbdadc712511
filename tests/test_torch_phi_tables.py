"""Propagator tables of the PyTorch port against the JAX package.

The plain version (``phi_tables_reference``) is held against the JAX
lane-layout table build ``_phi_vectors_lanes`` and against the Pallas pages
kernel run in interpret mode; the CUDA kernel itself is held against the
plain version on the card in ``test_torch_kernels_cuda.py``.
Inputs are made with numpy from a seed and fed to both packages.
"""

import re
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoskintime_tpu.network.expo import _phi_vectors_lanes
from phoskintime_tpu.ops.phi_pallas import ladder_len as jax_ladder_len
from phoskintime_tpu.ops.phi_pallas import phi_vectors_pallas_pages
from phoskintime_tpu_torch.ops import cuda_build
from phoskintime_tpu_torch.ops import phi_tables as pm
from phoskintime_tpu_torch.ops.phi_tables import (ladder_len, phi_tables,
                                                  phi_tables_reference)

torch.set_num_threads(2)

# float32 tolerance: two float32 builds of one table differ by rounding
# that the squaring ladder amplifies, so errors are taken relative to the
# table's largest entry (the JAX package's own pages-kernel tolerance)
SCALED_ATOL_F32 = 2e-5
# float64: the same algorithm in another summation order; rtol 1e-12 with a
# floor of 1e-12 of the largest entry for entries that decay towards zero,
# whose own relative error is set by cancellation, not by the algorithm
RTOL_F64 = 1e-12


def random_blocks(rng, Bu, w, B):
    """Blocks like test_pallas.py's: normal off-diagonals, strongly
    decaying diagonals."""
    L = rng.normal(0, 0.5, (Bu, w, w, B))
    for i in range(w):
        L[:, i, i, :] = -rng.uniform(0.01, 20.0, (Bu, B))
    return L


def assert_scaled_close(got, want, atol):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.max(np.abs(want)) + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def test_package_imports_without_jax():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter:
    none loads JAX, the JAX package, pandas, matplotlib, PIL, sklearn or
    seaborn (the card's machine has none of the last five: the port draws
    its figures with its own ``report/draw`` and computes its embeddings in
    ``analysis/embed``), and none turns on TF32 matmuls.
    ``__main__`` runs the command line when imported, so it is read, not
    imported."""
    root = Path(__file__).resolve().parent.parent
    mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in (root / "phoskintime_tpu_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods
            if m != "phoskintime_tpu_torch.__main__"] + ["chip_smoke"]
    assert "phoskintime_tpu_torch.network.expo" in mods and len(mods) > 15
    for new in ("ops.hypercube_flux", "ops.tridiag", "ops.integrators",
                "network.analysis", "network.steadystate", "ops.fma_peak", "ops.nsga",
                "ops.nsga_device", "ops.frechet", "native", "parallel.checkpoint",
                "network.optimize", "network.bounds", "network.weights", "network.polish",
                "config.labels", "ops.linear", "models", "models.kinetics", "models.weights",
                "models.knockout", "ops.lm", "fit", "fit.score", "fit.ci", "fit.normest",
                "ops.morris", "fit.sensitivity", "fit.pipeline", "ops.indicators",
                "ops.sobol", "network.sensitivity", "ops.constrained", "ops.de_jit",
                "kinopt", "kinopt.model", "kinopt.optimize", "kinopt.kkt", "kinopt.data",
                "tfopt", "tfopt.model", "tfopt.optimize", "tfopt.data", "ops.tpe",
                "network.scan", "config", "config.loader", "config.logconf", "io",
                "io.utils", "io.load", "io.preprocess", "cli", "network.runner", "io.export",
                "analysis", "analysis.postfit", "analysis.insights", "analysis.influence",
                "analysis.mechanisms", "analysis.network_tools", "parallel.profile",
                "report", "report.html", "report.interactive", "report.live_constants",
                "report.live_model", "report.live", "report.latexit", "report.draw",
                "report.draw.figure", "report.draw.raster", "report.draw.png",
                "report.draw.pdf", "report.draw.gif", "report.draw.font",
                "report.draw.colors", "report.plotter", "report.dashboard",
                "report.diagram", "analysis.fitpanels", "analysis.embed"):
        assert f"phoskintime_tpu_torch.{new}" in mods, new
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'phoskintime_tpu' or m.startswith('phoskintime_tpu.') "
            "or m == 'pandas' or m.startswith('pandas.') "
            "or m == 'matplotlib' or m.startswith('matplotlib.') "
            "or m.split('.')[0] in ('PIL', 'plotly', 'streamlit', 'sklearn', 'seaborn')]; "
            "import torch; tf32 = torch.backends.cuda.matmul.allow_tf32; "
            "print(bad, tf32); sys.exit(1 if bad or tf32 else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
    # nor inside a function: no source line of the port imports pandas,
    # matplotlib, PIL, plotly, streamlit, sklearn, seaborn or JAX
    lazy = re.compile(r"^\s*(import|from)\s+(pandas|matplotlib|PIL|plotly|streamlit|sklearn|"
                      r"seaborn|jax|phoskintime_tpu)(\.|\s|$)")
    for path in [*(root / "phoskintime_tpu_torch").rglob("*.py"), root / "chip_smoke.py"]:
        bad = [ln for ln in path.read_text().splitlines() if lazy.match(ln)]
        assert not bad, (path, bad)


@pytest.mark.parametrize("w", [3, 6])
def test_ladder_len_matches_jax(w):
    for h in [0.03125, 0.0625, 0.5, 1.75, 3.75, 15.0, 16.0, 100.0]:
        assert ladder_len(w, h) == jax_ladder_len(w, h)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reference_matches_jax_lanes(dtype):
    rng = np.random.default_rng(5)
    Bu, w, B = 3, 6, 200
    L = random_blocks(rng, Bu, w, B).astype(dtype)
    binv = np.asarray([0, 1, 2, 1, 0], np.int32)
    h_u = np.asarray([0.0625, 1.0, 16.0, 4.0, 0.5])
    # the JAX CPU path clips each lane's squaring count at 24; so does this
    E, p1, p2 = phi_tables_reference(torch.as_tensor(L), binv, h_u, 24)
    assert E.dtype == torch.from_numpy(L).dtype and E.shape == (5, w, w, B)
    for u in range(len(binv)):
        want = _phi_vectors_lanes(jnp.asarray(L[binv[u]]),
                                  jnp.full((B,), h_u[u], dtype))
        for got, ref in zip((E[u], p1[u], p2[u]), want):
            ref = np.asarray(ref)
            if dtype == np.float64:
                np.testing.assert_allclose(
                    got.numpy(), ref, rtol=RTOL_F64,
                    atol=RTOL_F64 * np.max(np.abs(ref)))
            else:
                assert_scaled_close(got.numpy(), ref, SCALED_ATOL_F32)


def test_reference_matches_pallas_pages_interpret():
    """Smallest shape (w = 3, two pairs): interpret mode traces the
    unrolled w^3-per-step ladder, which grows fast with w."""
    rng = np.random.default_rng(7)
    Bu, w, B = 2, 3, 100
    L = random_blocks(rng, Bu, w, B).astype(np.float32)
    binv = np.asarray([0, 1], np.int32)
    h_u = np.asarray([0.5, 2.0], np.float32)
    lad = max(ladder_len(w, float(h)) for h in h_u)
    want = phi_vectors_pallas_pages(jnp.asarray(L), binv, h_u, lad,
                                    blk8=128, interpret=True)
    got = phi_tables(torch.as_tensor(L), binv, h_u, lad)
    for g, ref in zip(got, want):
        assert g.shape == ref.shape and g.dtype == torch.float32
        assert_scaled_close(g.numpy(), ref, SCALED_ATOL_F32)


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(0)
    L = torch.as_tensor(random_blocks(rng, 2, 4, 33), dtype=torch.float32)
    binv, h_u = np.asarray([1, 0, 1]), np.asarray([0.25, 1.0, 4.0])
    before = phi_tables.launches
    got = phi_tables(L, binv, h_u, 12)
    want = phi_tables_reference(L, binv, h_u, 12)
    assert phi_tables.launches == before          # no kernel on the CPU
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_clip_at_ladder():
    """A lane whose need exceeds the ladder stops there, as in the kernel."""
    L = torch.full((1, 2, 2, 1), -64.0, dtype=torch.float64)
    E_clip = phi_tables(L, [0], [16.0], 3)[0]
    E_full = phi_tables(L, [0], [16.0], 24)[0]
    assert not torch.allclose(E_clip, E_full)


@pytest.mark.parametrize("bad", [
    dict(L=torch.zeros((2, 3, 4, 5))),                        # not square
    dict(binv=[0, 2], h_u=[1.0, 1.0]),                        # bucket out of range
    dict(binv=[0], h_u=[1.0, 2.0]),                           # length mismatch
    dict(use_kernel=True),                                    # kernel on the CPU
])
def test_wrapper_rejects(bad):
    args = dict(L=torch.zeros((2, 3, 3, 5)), binv=[0, 1], h_u=[1.0, 2.0])
    args.update(bad)
    use_kernel = args.pop("use_kernel", None)
    with pytest.raises(ValueError):
        phi_tables(args["L"], args["binv"], args["h_u"], 8, use_kernel=use_kernel)


def test_library_path_is_keyed_by_source():
    path = cuda_build.library_path(pm.SOURCE)
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
    assert "csrc" in str(pm.SOURCE) and pm.SOURCE.exists()
    assert pm.SOURCE in cuda_build.SOURCES and all(s.exists() for s in cuda_build.SOURCES)
    assert len(cuda_build.SOURCES) == 6
    assert len({cuda_build.library_path(s) for s in cuda_build.SOURCES}) == 6
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


# --- the wide kernel's division -----------------------------------------------------


def _round_f32(q: Fraction) -> float:
    """The float32 nearest the rational q (ties to even), in the normal range."""
    if q == 0:
        return 0.0
    sign, a = (-1 if q < 0 else 1), abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length() - 24
    while a / Fraction(2) ** e >= 2 ** 24:
        e += 1
    while a / Fraction(2) ** e < 2 ** 23:
        e -= 1
    m = a / Fraction(2) ** e
    n, rest = divmod(m.numerator, m.denominator)
    if 2 * rest > m.denominator or (2 * rest == m.denominator and n % 2):
        n += 1
    return sign * float(Fraction(n) * Fraction(2) ** e)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 20, 30, 42, 56, 72, 90])
def test_markstein_division_is_correctly_rounded(k):
    """csrc/phi_tables_wide.cu divides by its constants (the Taylor index
    k, k + 1 and (k + 1)(k + 2)) without the division operator: q = x rk,
    then q + (x - q k) rk with rk the correctly rounded 1 / k and each
    step a float32 fma. In exact rational arithmetic that is the correctly
    rounded x / k, the operator's result, for seeded x over 60 decades."""
    rng = np.random.default_rng(k)
    xs = np.concatenate([rng.uniform(-1, 1, 300),
                         rng.uniform(-1, 1, 300) * 10.0 ** rng.integers(-30, 30, 300)])
    rk = Fraction(_round_f32(Fraction(1, k)))
    for x in xs.astype(np.float32):
        fx = Fraction(float(x))
        q = Fraction(_round_f32(fx * rk))
        residual = Fraction(_round_f32(fx - q * k))          # fma(-q, k, x): exact
        assert residual == fx - q * k
        assert _round_f32(q + residual * rk) == _round_f32(fx / k), (k, float(x))

