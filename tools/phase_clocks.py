"""Where the wide table kernel spends its time, phase by phase, on the card.

    python tools/phase_clocks.py

Builds a copy of ``phoskintime_tpu_torch/csrc/phi_tables_wide.cu`` with
``clock64()`` stamps at its phase boundaries (lane 0 of every warp; the
copy and its library go to the git-ignored ``phoskintime_tpu_torch/_build``)
and runs it on the model-2 bench chunk's w = 9 and w = 17 classes
(``build_demo_network(40, 12, model=2, seed=0)``, 2048 members). Prints,
for each, the mean cycles a warp spends loading L, taking the norm and
scaling, building E's start and the phi series, in the Horner steps, in
the squaring ladder and storing the tables. The stamps cost a few
instructions a phase; the numbers locate time, they are not the kernel's
time. The source's phase markers are found by text: a change to those
lines of the kernel needs the same change here.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PHASES = ["load+rowsum", "norm+scale", "Einit+series", "horner", "ladder", "store"]
# (text in the kernel, the same text with a stamp)
MARKS = [
    ("int B, int ladder) {\n  using S = Shape<W, R>;",
     "int B, int ladder, unsigned long long* clk) {\n  using S = Shape<W, R>;\n"
     "  unsigned long long* ck = clk + 8ull * ((size_t)(blockIdx.y * gridDim.x + blockIdx.x)"
     " * (blockDim.x / 32) + threadIdx.x / 32);\n"
     "#define MARK(k) if (threadIdx.x % 32 == 0) ck[k] = clock64();\n  MARK(0)"),
    ("  __syncwarp(mask);\n\n  // inf-norm", "  __syncwarp(mask);\n  MARK(1)\n\n  // inf-norm"),
    ("  __syncwarp(mask);                    // every read of the row sums done\n",
     "  __syncwarp(mask);                    // every read of the row sums done\n  MARK(2)\n"),
    ("  // E = expm(A) by Horner", "  MARK(3)\n  // E = expm(A) by Horner"),
    ("  float p1[R], p2[R];\n", "  MARK(4)\n  float p1[R], p2[R];\n"),
    ("  if (live) {\n#pragma unroll\n    for (int r = 0; r < R; ++r) {",
     "  MARK(5)\n  if (live) {\n#pragma unroll\n    for (int r = 0; r < R; ++r) {"),
    ("        p2_out[row * plane + lane] = p2[r];\n      }\n    }\n  }\n}",
     "        p2_out[row * plane + lane] = p2[r];\n      }\n    }\n  }\n  MARK(6)\n}"),
    ("static_cast<float*>(p1), static_cast<float*>(p2), B, ladder);",
     "static_cast<float*>(p1), static_cast<float*>(p2), B, ladder, g_clk);"),
    ("namespace {\n\nconstexpr int kTaylorTerms",
     "namespace {\nunsigned long long* g_clk = nullptr;\nconstexpr int kTaylorTerms"),
]


def build() -> ctypes.CDLL:
    from phoskintime_tpu_torch.ops import cuda_build

    src = (ROOT / "phoskintime_tpu_torch/csrc/phi_tables_wide.cu").read_text()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise SystemExit(f"phase_clocks.py: the kernel's text changed near {old[:40]!r}")
        src = src.replace(old, new)
    src += '\nextern "C" void set_clk(void* p) { g_clk = static_cast<unsigned long long*>(p); }\n'
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / "phi_tables_wide_clocks.cu"
    lib = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.phi_tables_wide_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    so.phi_tables_wide_f32.restype = ctypes.c_int
    so.set_clk.argtypes = [ctypes.c_void_p]
    return so


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks.py: needs an NVIDIA GPU")
    from phoskintime_tpu_torch.demo import build_demo_network
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params
    from phoskintime_tpu_torch.ops.phi_tables import wide_launch_shape

    so = build()
    b = build_demo_network(40, 12, model=2, seed=0, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    thetas = torch.as_tensor(b["theta0"][None] + 0.05 * rng.normal(size=(2048, len(b["theta0"]))),
                             dtype=torch.float32, device="cuda")
    params = unpack_params(thetas, b["slices"], b["topo"])
    for L, binv, h_u, ladder in expo.table_inputs(b["system"], params, b["grid"]):
        w = L.shape[1]
        if w <= 8:
            continue
        shape = wide_launch_shape(w)
        U, B = len(binv), L.shape[3]
        lanes = shape.warps * shape.lanes_per_warp
        n_warps = U * -(-B // lanes) * shape.warps
        clk = torch.zeros(n_warps * 8, dtype=torch.int64, device="cuda")
        so.set_clk(clk.data_ptr())
        f = dict(device="cuda")
        binv_d = torch.as_tensor(binv, dtype=torch.int32, **f)
        h_d = torch.as_tensor(h_u, dtype=torch.float32, **f)
        E = torch.empty((U, w, w, B), **f)
        p1, p2 = torch.empty((U, w, B), **f), torch.empty((U, w, B), **f)
        for _ in range(3):                 # the last run's stamps are kept
            rc = so.phi_tables_wide_f32(L.data_ptr(), binv_d.data_ptr(), h_d.data_ptr(),
                                        E.data_ptr(), p1.data_ptr(), p2.data_ptr(), w, U, B,
                                        int(ladder), shape.rows, shape.warps,
                                        torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"phase_clocks.py: launch failed ({rc})")
        d = np.diff(clk.reshape(n_warps, 8).cpu().numpy()[:, :7].astype(np.int64), axis=1)
        print(json.dumps({"w": w, "rows": shape.rows, "warps_a_block": shape.warps,
                          "mean_cycles_a_warp": dict(zip(PHASES, d.mean(axis=0).round(0).tolist())),
                          "total": float(d.sum(axis=1).mean())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
