"""The card's FP32 FMA peak, measured: the port of the JAX package's probe
``benchmarks/vpu_peak.py``.

* :func:`sq_chain` — the entry point. On a CUDA float32 tensor it launches
  ``csrc/sq_chain.cu`` (the port of ``vpu_peak.py::sq_chain``; one more in
  ``sq_chain.launches`` a launch); on a CPU tensor it runs the plain
  version.
* :func:`sq_chain_reference` — the plain PyTorch version, the same loop.
* :func:`slope_tflops` — FLOP/s by the slope between 8 and 24 chained
  launches, each reading the previous one's output, timed with CUDA
  events: the slope cancels what a chain costs besides its launches.
* :func:`measure_peak` — the sweep over chains a thread and threads a
  block; the best arm is the peak.
* :func:`sass_ffma_counts` — the FFMA instructions of each instance in the
  built library (``cuobjdump -sass``), to show that nothing shortened the
  chains: ``reps * nacc`` an element.

Run on the card::

    python -m phoskintime_tpu_torch.ops.fma_peak

prints the card's name and power limit, one JSON line per arm and a
``peak`` line.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from phoskintime_tpu_torch.ops.cuda_build import CSRC, entry, library_path, nvcc_path

SOURCE = CSRC / "sq_chain.cu"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
REPS = 512                        # map steps an element a launch (vpu_peak.py)
ROWS = 8
# the JAX probe's 4 MB working set: X (8, B) float32
COLS = 4 * 1024 * 1024 // ROWS // 4
NACCS = (1, 2, 4, 8)              # independent chains an element (csrc builds)
# The kernel is held against its plain version at CHECK_REPS steps. The map
# contracts onto its fixed point y* ~ -0.0916 (|f'| ~ 0.18) within about ten
# steps, after which every output is nacc y* whatever the seeds, the x term of
# c or the step count; at two steps the output still spans about 0.5 nacc,
# and dropping the seeds moves it by 2e-3 or more (nacc > 1), c's x term by
# 2.3e-6 nacc, a step more or less by 0.34 nacc. The plain version rounds
# the multiply and the add apart where the kernel fuses them: at two steps
# that differs by under 4e-7 of max |plain| on the probe's input (3.6e-7 at
# nacc 8 on the H100), so CHECK_TOL (of max |plain|) passes the kernel and
# fails each of those.
CHECK_REPS = 2
CHECK_TOL = 1e-6
BUILT_REPS = (CHECK_REPS, REPS)
THREADS = (128, 256, 512, 1024)   # threads a block in the sweep
CHAIN_COUNTS = (8, 24)
# the H100 SXM data sheet's FP32 rate outside the tensor cores, printed
# beside the measured peak
DATASHEET_FP32_TFLOPS = 67.0


def sq_chain_reference(X: torch.Tensor, reps: int, nacc: int) -> torch.Tensor:
    """Plain version of :func:`sq_chain`: ``vpu_peak._kernel``'s loop, each
    multiply and add rounded on its own."""
    c = X * 1e-6 - 0.1                     # keeps iterates in (-0.1, 1)
    ys = [X * (1.0 + 0.001 * j) for j in range(nacc)]
    for _ in range(reps):
        ys = [y * y + c for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


def _check(X: torch.Tensor, reps: int, nacc: int, threads: int) -> None:
    if X.dtype != torch.float32 or not X.is_contiguous():
        raise ValueError("sq_chain takes a contiguous float32 tensor")
    if reps not in BUILT_REPS or nacc not in NACCS:
        raise ValueError(f"sq_chain is built for reps {BUILT_REPS} and nacc {NACCS}; "
                         f"got reps={reps}, nacc={nacc}")
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"threads a block must be a multiple of 32 up to 1024: {threads}")
    if not 0 < X.numel() < 2 ** 31:
        raise ValueError(f"unsupported size {X.numel()}")


def _launch(a: torch.Tensor, b: torch.Tensor, reps: int, nacc: int, threads: int,
            launches: int) -> None:
    """``launches`` chained kernels on a's stream, ping-ponging a -> b -> a."""
    fn, err = entry(SOURCE, "sq_chain_f32", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), a.numel(), reps, nacc, threads, launches,
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("sq_chain kernel launch failed: " + err(rc).decode())
    sq_chain.launches += launches


def sq_chain(X: torch.Tensor, reps: int = REPS, nacc: int = 1, *, threads: int = 256,
             use_kernel: bool | None = None) -> torch.Tensor:
    """The probe on X (any shape, float32): the sum of ``nacc`` chains of
    ``reps`` map steps an element. None routes by device (the kernel on
    CUDA, the plain version on the CPU); False forces the plain version."""
    if use_kernel is None:
        use_kernel = X.is_cuda
    if not use_kernel:
        return sq_chain_reference(X, reps, nacc)
    if not X.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    _check(X, reps, nacc, threads)
    out = torch.empty_like(X)
    _launch(X, out, reps, nacc, threads, 1)
    return out


sq_chain.launches = 0


def probe_input(device="cuda", cols: int = COLS) -> torch.Tensor:
    """X (8, cols) float32 in (0.4, 0.9), seeded, as vpu_peak.py's."""
    g = torch.Generator(device="cpu").manual_seed(0)
    return (0.4 + 0.5 * torch.rand((ROWS, cols), generator=g)).to(device)


def chain_flops(X: torch.Tensor, reps: int, nacc: int) -> float:
    """FLOPs of one launch: an FMA (2 FLOPs) a step, chain and element."""
    return 2.0 * X.numel() * reps * nacc


def slope_tflops(X: torch.Tensor, reps: int = REPS, nacc: int = 1, threads: int = 256,
                 counts=CHAIN_COUNTS, n: int = 3) -> tuple[float, dict]:
    """TFLOP/s of the kernel by the slope between two chain lengths: for
    each count K, the median over ``n`` runs of K chained launches timed
    with CUDA events (after a warm-up run); the time a launch is the
    difference over the difference of counts. Returns (TFLOP/s, {K: ms})."""
    if not X.is_cuda:
        raise ValueError("slope_tflops measures the card: X must be a CUDA tensor")
    _check(X, reps, nacc, threads)
    times = {}
    for K in counts:
        a, b = X.clone(), torch.empty_like(X)
        _launch(a, b, reps, nacc, threads, K)            # warm-up
        runs = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            _launch(a, b, reps, nacc, threads, K)
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop))
        times[K] = statistics.median(runs)
    per_launch_ms = (times[counts[1]] - times[counts[0]]) / (counts[1] - counts[0])
    return chain_flops(X, reps, nacc) / (per_launch_ms * 1e-3) / 1e12, times


def measure_peak(X: torch.Tensor | None = None, reps: int = REPS, naccs=NACCS,
                 threads=THREADS, emit=None) -> dict:
    """Every (nacc, threads) arm by :func:`slope_tflops`; ``emit`` (if
    given) gets each arm's dict as it is measured. Returns {"arms": [...],
    "peak_tflops": the best arm's rate, "best": that arm}."""
    X = probe_input() if X is None else X
    arms = []
    for nacc in naccs:
        for th in threads:
            tf, times = slope_tflops(X, reps, nacc, th)
            arm = {"nacc": nacc, "threads": th, "reps": reps, "tflops": tf,
                   "chain_ms": {str(k): v for k, v in times.items()}}
            arms.append(arm)
            if emit is not None:
                emit(arm)
    best = max(arms, key=lambda a: a["tflops"])
    return {"arms": arms, "peak_tflops": best["tflops"], "best": best}


def sass_ffma_counts() -> dict:
    """{(nacc, reps): FFMA instructions} of each kernel instance in the
    built library, read with ``cuobjdump -sass`` (the toolkit's, beside
    nvcc). Each instance runs one thread an element, so its count must be
    ``reps * nacc``."""
    lib = library_path(SOURCE)
    if not lib.exists():
        entry(SOURCE, "sq_chain_f32", _ARGTYPES)         # builds the libraries
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*sq_chain_kernelILi(\d+)ELi(\d+)E", line)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            counts[key] = 0
        elif "Function :" in line:
            key = None
        elif key is not None and re.search(r"\bFFMA\b", line):
            counts[key] += 1
    return counts


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fma_peak: no CUDA device; the probe measures the card")
    card = card_line()
    print(card, flush=True)
    ffma = sass_ffma_counts()
    print(json.dumps({"sass_ffma": {f"nacc{k[0]}_reps{k[1]}": v for k, v in sorted(ffma.items())},
                      "want": "reps * nacc"}), flush=True)
    out = measure_peak(emit=lambda arm: print(json.dumps(arm), flush=True))
    print(json.dumps({"peak": out["peak_tflops"], "unit": "TFLOP/s FP32 FMA",
                      "best": {k: out["best"][k] for k in ("nacc", "threads")},
                      "datasheet_tflops": DATASHEET_FP32_TFLOPS,
                      "share_of_datasheet": out["peak_tflops"] / DATASHEET_FP32_TFLOPS,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
