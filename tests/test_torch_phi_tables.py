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
from tools.smoke_cases import hypercube_blocks

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


def compartmental_blocks(rng, Bu, w, B):
    """Blocks like the model's: non-negative transfer rates off the
    diagonal, each column's outflow plus its own decay on the diagonal."""
    L = rng.uniform(0.0, 2.0, (Bu, w, w, B))
    L[:, np.arange(w), np.arange(w), :] = 0.0
    decay = rng.uniform(0.01, 4.0, (Bu, w, B))
    L[:, np.arange(w), np.arange(w), :] = -(L.sum(axis=1) + decay)
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
                "report.diagram", "analysis.fitpanels", "analysis.embed",
                "analysis.thermal", "report.apps", "report.schematic", "parallel",
                "parallel.mesh", "network.kron"):
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


@pytest.mark.parametrize("w", [18, 22, 33, 65, 129])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_matches_jax_lanes_wide_blocks(w, dtype):
    """The widths of ``csrc/phi_tables_xwide.cu`` (model 2 at 5, 6 and 7
    sites, w = 33, 65 and 129, the last at 8 lanes; models 0/1 past 15
    sites): the plain version
    against JAX's lane build, which ``network/expo.py`` reaches for every
    w > 8, at the ladder's clip of 24, as at the narrow widths. Float64 on
    arbitrary blocks; float32 on blocks like the model's own (transfer
    rates off the diagonal, each column's outflow and decay on it), whose
    exponentials contract: on arbitrary blocks each of the ~10 squarings
    at h = 8 doubles the two builds' rounding difference past the JAX
    package's 2e-5 (5.3e-5 at w = 33). At w = 129 float32 takes blocks
    shaped like model 2's own at 7 sites (:func:`hypercube_blocks`): on
    dense blocks that wide float32 itself is 7e-5 to 9e-5 of the largest
    entry from float64 at h = 8 (either build), so no two float32 builds
    agree to 2e-5; on the model's shape both are 1.5e-5 from it."""
    rng = np.random.default_rng(w)
    B = 24 if w <= 65 else 8
    if dtype == np.float64:
        L = random_blocks(rng, 2, w, B)
    elif w == 129:
        L = hypercube_blocks(rng, 2, 7, B).astype(dtype)
    else:
        L = compartmental_blocks(rng, 2, w, B).astype(dtype)
    binv = np.asarray([0, 1, 1], np.int32)
    h_u = np.asarray([0.0625, 1.0, 8.0])
    E, p1, p2 = phi_tables_reference(torch.as_tensor(L), binv, h_u, 24)
    assert E.shape == (3, w, w, B) and p1.shape == p2.shape == (3, w, B)
    for u in range(len(binv)):
        want = _phi_vectors_lanes(jnp.asarray(L[binv[u]]), jnp.full((B,), h_u[u], dtype))
        for got, ref in zip((E[u], p1[u], p2[u]), want):
            ref = np.asarray(ref)
            if dtype == np.float64:
                np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL_F64,
                                           atol=RTOL_F64 * np.max(np.abs(ref)))
            else:
                assert_scaled_close(got.numpy(), ref, SCALED_ATOL_F32)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_xwide_launch_shape(itemsize):
    """Every width 18..129 in both types: three planes a lane of K rows (w
    rounded up to 4, or to 8 in a cluster) at a stride ld >= K + 2 with ld
    = 4 (mod 8), within the 227 KB of shared memory a block may opt into;
    a cluster of two blocks, each half the rows, exactly where one lane
    would pass it (float64 from w = 97, float32 never); whole warps, at
    most 512 threads, which take the work (a tile a thread, or a tile a
    warp) in equal passes; lanes that give a block about 256 threads of
    work, and no more than let two blocks share an SM's 228 KB; outside
    18..129 it raises."""
    for w in range(18, 130):
        shape = pm.xwide_launch_shape(w, itemsize)
        K, rows, ld, plane = pm.xwide_layout(w, shape.cluster)
        assert K % (4 * shape.cluster) == 0 and w <= K < w + 4 * shape.cluster
        assert rows * shape.cluster == K and ld >= K + 2 and ld % 8 == 4 and ld < K + 10
        assert plane == rows * ld + 8
        words = 3 * shape.lanes * plane + 2 * shape.lanes + 4
        assert shape.shared_bytes == itemsize * words + 4 * 2 * shape.lanes
        assert shape.shared_bytes <= cuda_build.MAX_SHARED_BYTES
        single = pm.xwide_shared_bytes(w, 1, 1, itemsize)
        assert shape.cluster == (1 if single <= cuda_build.MAX_SHARED_BYTES else 2)
        assert shape.cluster == (2 if itemsize == 8 and w >= 97 else 1)
        assert shape.cluster == 1 or shape.lanes == 1
        assert shape.lanes >= 1 and shape.threads % 32 == 0 and 32 <= shape.threads <= 512
        work = pm._xwide_lane_threads(w, itemsize, shape.cluster)
        passes = -(-shape.lanes * work // 512)
        assert shape.threads == -(-shape.lanes * work // passes // 32) * 32
        assert shape.threads * passes >= shape.lanes * work
        assert shape.lanes == 1 or (shape.lanes * work <= 256
                                    and 2 * (shape.shared_bytes + 1024) <= 233472)
    assert pm.xwide_launch_shape(65, itemsize).lanes == 1
    assert pm.xwide_launch_shape(129, itemsize).lanes == 1
    # the largest blocks: float32 at 129 in one block, float64 in two
    assert pm.xwide_launch_shape(129, 4).shared_bytes > 200 * 1024
    for bad in (17, 130):
        with pytest.raises(NotImplementedError):
            pm.xwide_launch_shape(bad, itemsize)


def test_width_66_raises_naming_the_roadmap_item():
    """Past the widest shared-memory kernel (w = 65 once, hence the name;
    w = 129 since) the stream kernel takes every width: its launch shape at
    w = 130, 257, 513 and 1,025 in both types (planes of R rows, w rounded
    up to the 64-row tile, ld columns, K + 3 rounded up to 64, K the k
    extent, w rounded up to 128 bytes of row; a slot its 64-word head and
    three planes; clusters of 8 blocks of 256 threads, R a multiple of the
    cluster; as many clusters as the card holds at once, 15 on an H100 at
    one block an SM, at most one an item).
    The raises that stay: no kernel below w = 2 or for another dtype, none
    on a CPU tensor; the xwide and stream wrappers keep their own domains
    (w <= 129 is not the stream kernel's). The plain version takes any
    width."""
    for itemsize in (4, 8):
        bk = 128 // itemsize
        for w in (130, 257, 513, 1025):
            shape = pm.stream_launch_shape(w, itemsize)
            K, R, ld, slot = pm.stream_layout(w, itemsize)
            assert (shape.K, shape.R, shape.ld, shape.slot_words) == (K, R, ld, slot)
            assert K % bk == 0 and w <= K < w + bk
            assert R % 64 == 0 and w <= R < w + 64 and K <= R
            assert ld % 64 == 0 and K + 3 <= ld < K + 67
            assert slot == 64 + 3 * R * ld and slot % 4 == 0
            assert shape.cluster == 8 and R % shape.cluster == 0 and shape.threads == 256
            assert shape.slots == 15
            assert pm.stream_launch_shape(w, itemsize, items=5).slots == 5
            assert pm.stream_launch_shape(w, itemsize, 600, clusters=3).slots == 3
        assert pm.stream_layout(257, itemsize)[1:3] == (320, 320)
    assert pm.stream_layout(257, 4)[0] == 288 and pm.stream_layout(257, 8)[0] == 272
    # 15 slots at w = 257: 18.4 MB of scratch in float32, inside the 50 MB L2
    assert 15 * pm.stream_layout(257, 4)[3] * 4 < 18.5e6
    for bad in (129, 1, 0):
        with pytest.raises(NotImplementedError):
            pm.stream_launch_shape(bad, 4)
    with pytest.raises(NotImplementedError):
        pm.stream_launch_shape(257, 2)
    rng = np.random.default_rng(66)
    L = torch.as_tensor(random_blocks(rng, 1, 130, 2))
    with pytest.raises(ValueError, match="CUDA"):
        phi_tables(L, [0], [1.0], 8, use_kernel=True)
    with pytest.raises(NotImplementedError, match="w >= 2"):
        phi_tables(L.to(torch.float16), [0], [1.0], 8, use_kernel=True)
    with pytest.raises(NotImplementedError, match="w >= 2"):
        phi_tables(L[:, :1, :1].contiguous(), [0], [1.0], 8, use_kernel=True)
    E, p1, p2 = phi_tables(L, [0], [1.0], 8)
    assert E.shape == (1, 130, 130, 2) and bool(torch.isfinite(E).all())
    assert pm.xwide_launch_shape(66, 8).lanes == 1          # 66 is a kernel width now
    with pytest.raises(ValueError, match="CUDA"):
        pm.phi_tables_xwide(L[:, :33, :33].contiguous(), [0], [1.0], 8)
    with pytest.raises(ValueError, match="CUDA"):
        pm.phi_tables_stream(L, [0], [1.0], 8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_matches_jax_lanes_at_257(dtype):
    """Model 2 at 8 sites (w = 257, the stream kernel's class): the plain
    tables at 2 pairs x 2 lanes against JAX's lane build
    (``network/expo.py::_phi_vectors_lanes``), which the JAX package takes
    at any width, at the ladder's clip of 24; float64 at rtol 1e-9,
    float32 at the scaled 2e-5, on blocks shaped like model 2's own. JAX
    takes both pairs in one call, their lanes side by side (h a lane; its
    eager j-loop over 257 columns costs seconds a call)."""
    rng = np.random.default_rng(257)
    L = hypercube_blocks(rng, 2, 8, 2).astype(dtype)
    binv, h_u = np.asarray([0, 1], np.int32), np.asarray([0.5, 8.0])
    E, p1, p2 = phi_tables_reference(torch.as_tensor(L), binv, h_u, 24)
    assert E.shape == (2, 257, 257, 2)
    want = _phi_vectors_lanes(jnp.asarray(np.concatenate([L[b] for b in binv], axis=-1)),
                              jnp.asarray(np.repeat(h_u, 2), dtype))
    for u in range(2):
        for got, ref in zip((E[u], p1[u], p2[u]), want):
            ref = np.asarray(ref)[..., 2 * u:2 * u + 2]
            if dtype == np.float64:
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                           atol=1e-9 * np.max(np.abs(ref)))
            else:
                assert_scaled_close(got.numpy(), ref, SCALED_ATOL_F32)


def stream_emulation(L: np.ndarray, binv, h_u, ladder: int):
    """csrc/phi_tables_stream.cu's arithmetic in numpy, lane by lane, on its
    padded planes (``stream_layout``): A = L h unscaled, E = I + A 2^-s / n
    with the series' term, v1 and v2 in columns K..K+2, each Horner step E'
    = I + (A E) 2^-s / k over k < K with the series' step in the same
    product's columns K..K+2 and p1 = v1 hs, p2 = v2 hs^2 at the last, then
    the lane's own s ladder steps on [E | p1 | p2]."""
    dt = L.dtype.type
    _, w, _, B = L.shape
    K, R, ld, _ = pm.stream_layout(w, L.dtype.itemsize)
    terms, rad = (12, 0.25) if dt == np.float64 else (8, 0.5)
    U = len(binv)
    E_out, p1_out, p2_out = (np.empty((U, w, w, B), dt), np.empty((U, w, B), dt),
                             np.empty((U, w, B), dt))
    eye = np.eye(w, dtype=dt)
    e0 = eye[:, 0]
    for u, (b, h) in enumerate(zip(binv, h_u)):
        h = dt(h)
        for lane in range(B):
            A = np.zeros((R, ld), dt)
            A[:w, :w] = L[b, :, :, lane] * h
            rows = np.abs(A).sum(axis=1)
            nan = bool(np.isnan(rows).any())
            norm = np.nanmax(rows) if not nan else dt(0)
            s = min(max(np.ceil(np.log2(max(norm, dt(1e-30)) / dt(rad))), 0), ladder)
            steps, inv = (0, dt(np.nan)) if nan else (int(s), dt(2.0 ** -s))
            hs = h * inv
            E = np.zeros((R, ld), dt)
            E[:w, :w] = (A[:w, :w] * inv) / dt(terms) + eye
            term = A[:w, 0] * inv
            E[:w, K], E[:w, K + 1], E[:w, K + 2] = term, e0 + term / dt(2), e0 / 2 + term / dt(6)
            for k in range(terms - 1, 0, -1):
                ks = dt(terms + 1 - k)
                raw = A[:, :K] @ E[:K]
                nxt = np.zeros((R, ld), dt)
                nxt[:w, :w] = (raw[:w, :w] * inv) / dt(k) + eye
                term = (raw[:w, K] * inv) / ks
                v1 = E[:w, K + 1] + term / (ks + 1)
                v2 = E[:w, K + 2] + term / ((ks + 1) * (ks + 2))
                if k == 1:
                    nxt[:w, K], nxt[:w, K + 1] = v1 * hs, v2 * (hs * hs)
                else:
                    nxt[:w, K], nxt[:w, K + 1], nxt[:w, K + 2] = term, v1, v2
                E = nxt
            for it in range(steps):
                raw = E[:, :K] @ E[:K]
                nxt = np.zeros((R, ld), dt)
                nxt[:w, :w] = raw[:w, :w]
                p1, p2 = E[:w, K], E[:w, K + 1]
                nxt[:w, K] = p1 + raw[:w, K]
                nxt[:w, K + 1] = p2 + raw[:w, K + 1] + p1 * (hs * dt(2.0 ** it))
                E = nxt
            E_out[u, :, :, lane] = E[:w, :w]
            p1_out[u, :, lane], p2_out[u, :, lane] = E[:w, K], E[:w, K + 1]
    return E_out, p1_out, p2_out


@pytest.mark.parametrize("w", [130, 257])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stream_arithmetic_matches_reference(w, dtype):
    """The stream kernel's padded planes and epilogues (the series carried
    in columns K..K+2 of the Horner products, p1 and p2 in columns K, K+1 of
    the ladder's), emulated in numpy, against the plain version at 2 pairs
    x 3 lanes, one lane NaN (all NaN in both): float64 within 1e-12 of the
    largest entry, float32 within the scaled 2e-5 (the card's gates)."""
    rng = np.random.default_rng(w)
    L = (hypercube_blocks(rng, 2, 8, 3) if w == 257
         else compartmental_blocks(rng, 2, w, 3)).astype(dtype)
    L[1, 5, 7, 2] = np.nan
    binv, h_u = np.asarray([0, 1], np.int32), np.asarray([0.25, 8.0])
    got = stream_emulation(L, binv, h_u, 24)
    want = phi_tables_reference(torch.as_tensor(L), binv, h_u, 24)
    for g, r in zip(got, want):
        r = r.numpy()
        assert np.isnan(g[1, ..., 2]).all() and np.isnan(r[1, ..., 2]).all()
        g, r = g.copy(), r.copy()
        g[1, ..., 2] = r[1, ..., 2] = 0.0
        if dtype == np.float64:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * np.max(np.abs(r)))
        else:
            assert_scaled_close(g, r, SCALED_ATOL_F32)


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
    assert pm.XWIDE_SOURCE in cuda_build.SOURCES and pm.STREAM_SOURCE in cuda_build.SOURCES
    assert len(cuda_build.SOURCES) == 8
    assert len({cuda_build.library_path(s) for s in cuda_build.SOURCES}) == 8
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



@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 20, 30, 42, 56, 72, 90,
                               110, 132, 156, 182])
def test_markstein_division_is_correctly_rounded_float64(k):
    """csrc/phi_tables_xwide.cu divides by its float64 constants (the
    Horner steps' k = 11..2 and the series' k, k + 1 and (k + 1)(k + 2))
    the same way, each step a float64 fma, inside [2^-1000, 2^1000]: in
    exact rational arithmetic that is the correctly rounded x / k, the
    division operator's result, for seeded x over 500 decades (float() of
    a Fraction rounds correctly to the nearest double)."""
    rng = np.random.default_rng(100 + k)
    xs = np.concatenate([rng.uniform(-1, 1, 300),
                         rng.uniform(-1, 1, 300) * 10.0 ** rng.integers(-250, 250, 300)])
    rk = Fraction(float(Fraction(1, k)))
    for x in xs:
        fx = Fraction(float(x))
        q = Fraction(float(fx * rk))
        residual = Fraction(float(fx - q * k))                # fma(-q, k, x): exact
        assert residual == fx - q * k
        assert float(q + residual * rk) == float(x) / k, (k, float(x))
