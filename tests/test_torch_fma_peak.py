"""The FMA-peak probe's plain version against the JAX package's kernel body,
and the float64 launch shapes of the table and scan kernels, on the CPU.

The probe's kernel and the float64 kernel instances run only on the card
(``tests/test_torch_kernels_cuda.py``); here their plain version and the
pure-Python launch arithmetic that sizes them.
"""

import numpy as np
import pytest
import torch

from benchmarks import vpu_peak
from phoskintime_tpu_torch.ops import fma_peak
from phoskintime_tpu_torch.ops.cuda_build import MAX_SHARED_BYTES
from phoskintime_tpu_torch.ops.phi_tables import wide_launch_shape
from phoskintime_tpu_torch.ops.scan_kernel import scan_launch_shape

# float32 on both sides, the same operations in the same order (numpy and
# PyTorch round each multiply and add alike)
ATOL_F32 = 1e-6
# the H100's registers: 65,536 a SM, at most 255 a thread
REGS_PER_THREAD = 255


@pytest.mark.parametrize("nacc", [1, 2, 4, 8])
def test_reference_matches_vpu_peak_kernel(nacc):
    """``vpu_peak._kernel`` on numpy refs (as its Pallas body sees them)
    against the plain version, float32, at reps 32 and at the kernel
    check's few steps, where the output still depends on the seeds and on
    c's x term (past about ten steps it sits on the map's fixed point)."""
    X = np.random.default_rng(nacc).uniform(0.4, 0.9, (8, 256)).astype(np.float32)
    for reps in (32, fma_peak.CHECK_REPS):
        out = np.empty_like(X)
        vpu_peak._kernel(reps, nacc, X, out)
        got = fma_peak.sq_chain(torch.from_numpy(X), reps, nacc)  # CPU: the plain version
        assert got.dtype == torch.float32 and got.shape == X.shape
        np.testing.assert_allclose(got.numpy(), out, rtol=0, atol=ATOL_F32)
    # at the check's reps the comparison can fail: the outputs spread far
    # beyond both tolerances
    assert np.ptp(out) > 1e4 * max(ATOL_F32, fma_peak.CHECK_TOL * np.abs(out).max())


def test_probe_sizes_and_checks():
    X = fma_peak.probe_input("cpu")
    assert X.shape == (8, 131072) and X.dtype == torch.float32
    assert X.numel() * 4 == 4 * 1024 * 1024                     # vpu_peak's 4 MB
    assert float(X.min()) >= 0.4 and float(X.max()) <= 0.9
    assert fma_peak.chain_flops(X, 512, 4) == 2.0 * X.numel() * 512 * 4
    with pytest.raises(ValueError, match="CUDA"):
        fma_peak.sq_chain(X, fma_peak.CHECK_REPS, 1, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        fma_peak.slope_tflops(X)
    for bad in (dict(reps=32), dict(nacc=3), dict(threads=100)):
        args = {"reps": fma_peak.CHECK_REPS, "nacc": 1, "threads": 256, **bad}
        with pytest.raises(ValueError):
            fma_peak._check(X, args["reps"], args["nacc"], args["threads"])
    fma_peak._check(X, fma_peak.CHECK_REPS, 8, 256)             # a built instance
    with pytest.raises(ValueError):
        fma_peak._check(X.double(), fma_peak.CHECK_REPS, 1, 256)


@pytest.mark.parametrize("w", range(9, 18))
def test_wide_launch_shape_float64(w):
    """The float64 wide kernel: T R >= w > (T - 1) R, a lane's threads in one
    warp, twice the bytes a lane of shared memory, within a block's budget,
    and a thread's words of A and A/k (2 R w doubles, 4 R w registers) well
    inside 255 registers."""
    s32, s64 = wide_launch_shape(w), wide_launch_shape(w, 8)
    R, T, lw = s64.rows, s64.threads_per_lane, s64.lanes_per_warp
    assert (T - 1) * R < w <= T * R and lw == 32 // T and T * lw <= 32
    assert R <= s32.rows
    assert s64.shared_bytes == 8 * s64.warps * lw * (2 * w * w + 4 * w) <= MAX_SHARED_BYTES
    assert 4 * R * w <= 0.8 * REGS_PER_THREAD


@pytest.mark.parametrize("w", range(2, 18))
def test_scan_launch_shape_float64(w):
    """The float64 scan kernel: E in registers up to w = 6, in shared memory
    while one member's rows fit (8 (w^2 + 2) bytes a lane), streamed past
    that; at float32 the shapes are unchanged."""
    lane = 8 * (w * w + (w + 1) % 2 + 2)
    for N in range(1, 257):
        shape = scan_launch_shape(w, N, 8)
        want = ("registers" if w <= 6 else
                "shared" if N * lane <= MAX_SHARED_BYTES else "stream")
        assert shape.variant == want, (w, N)
        lane_bytes = lane if want == "shared" else 16
        assert shape.shared_bytes == shape.members * N * lane_bytes <= MAX_SHARED_BYTES
        assert shape.members >= 1 and shape.members * N <= shape.threads <= 256
        assert scan_launch_shape(w, N) == scan_launch_shape(w, N, 4)
    if w == 17:
        assert scan_launch_shape(17, 99, 8).variant == "shared"
        assert scan_launch_shape(17, 100, 8).variant == "stream"
        assert scan_launch_shape(17, 45, 8).members == 2          # the bench's model 2
