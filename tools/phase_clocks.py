"""Where the table kernels spend their time, phase by phase, on the card.

    python tools/phase_clocks.py [--kernel wide|tables|both]

Builds a copy of a table kernel with ``clock64()`` stamps at its phase
boundaries (lane 0 of every warp; the copy and its library go to the
git-ignored ``phoskintime_tpu_torch/_build``) and runs it at the main
path's shapes:

* ``wide``: ``csrc/phi_tables_wide.cu`` on the model-2 bench chunk's w = 9
  and w = 17 classes (``build_demo_network(40, 12, model=2, seed=0)``,
  2048 members): the mean cycles a warp spends loading L, taking the norm
  and scaling, building E's start and the phi series, in the Horner steps,
  in the squaring ladder and storing the tables. Its phase markers are
  found by text: a change to those lines of the kernel needs the same
  change here.
* ``tables``: ``csrc/phi_tables.cu`` on the model-0 bench chunk
  (``build_demo_network(40, 12, seed=0)``, 2048 members, w = 6) in float32
  and float64: the cycles a warp spends, per (pair, 128-lane tile) it
  processes, loading L (and forming A and its norm), in the Horner steps,
  in the phi series, in the squaring ladder and storing its tables; the SM
  clock in the run; the register report and the resident blocks an SM.

Both sources are stamped by text: a change to the marked lines of a kernel
needs the same change here. The stamps cost a few instructions a phase;
the numbers locate time, they are not the kernel's time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
    ("  Real p1[R], p2[R];\n", "  MARK(4)\n  Real p1[R], p2[R];\n"),
    ("  if (live) {\n#pragma unroll\n    for (int r = 0; r < R; ++r) {",
     "  MARK(5)\n  if (live) {\n#pragma unroll\n    for (int r = 0; r < R; ++r) {"),
    ("        p2_out[row * plane + lane] = p2[r];\n      }\n    }\n  }\n}",
     "        p2_out[row * plane + lane] = p2[r];\n      }\n    }\n  }\n  MARK(6)\n}"),
    ("static_cast<Real*>(p1), static_cast<Real*>(p2), B, ladder);",
     "static_cast<Real*>(p1), static_cast<Real*>(p2), B, ladder, g_clk);"),
    ("namespace {\n\n// the JAX package's series",
     "namespace {\nunsigned long long* g_clk = nullptr;\n\n// the JAX package's series"),
]

# csrc/phi_tables.cu: the phases of one (pair, lane tile); slot 5 holds a
# warp's cycles and slot 6 its globaltimer ns up to its last tile, slot 7
# counts its tiles
TABLE_PHASES = ["load", "horner", "series", "ladder", "store"]
# the stamps put into a copy of csrc/phi_tables.cu by TABLE_MARKS
CLOCK_PRELUDE = r"""
#include <cuda_runtime.h>
__device__ unsigned long long* g_phase_clk;
__device__ __forceinline__ void phase_dep(float x) { asm volatile("" :: "f"(x)); }
__device__ __forceinline__ void phase_dep(double x) { asm volatile("" :: "d"(x)); }
__device__ __forceinline__ unsigned long long phase_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_BEGIN()                                                                  \
  unsigned long long* ph_ck_ = g_phase_clk + 8ull * ((blockIdx.y * gridDim.x + blockIdx.x) \
      * (blockDim.x / 32) + threadIdx.x / 32);                                          \
  const unsigned long long ph_ns0_ = phase_ns();                                        \
  unsigned long long ph_last_ = clock64();                                              \
  const unsigned long long ph_c0_ = ph_last_;
#define PHASE(k, dep)                                                                  \
  {                                                                                    \
    phase_dep(dep);                                                                    \
    const unsigned long long ph_now_ = clock64();                                      \
    if (threadIdx.x % 32 == 0) {                                                       \
      ph_ck_[k] += ph_now_ - ph_last_;                                                 \
      if ((k) == 4) {                                                                  \
        ph_ck_[5] = ph_now_ - ph_c0_;                                                  \
        ph_ck_[6] = phase_ns() - ph_ns0_;                                              \
        ph_ck_[7] += 1;                                                                \
      }                                                                                \
    }                                                                                  \
    ph_last_ = ph_now_;                                                                \
  }
extern "C" int phase_clocks_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, &p, sizeof(p)));
}
"""
# csrc/phi_tables.cu's phase boundaries (one thread per (pair, lane))
TABLE_MARKS = [
    ("  const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n  if (lane >= B) return;",
     "  PHASE_BEGIN()\n  const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (lane >= B) return;"),
    ("  T s = real::ceil(", "  PHASE(0, norm)\n  T s = real::ceil("),
    ("  // phi1 / phi2 e0 columns", "  PHASE(1, E[W - 1][W - 1])\n  // phi1 / phi2 e0 columns"),
    ("  // doubling ladder", "  PHASE(2, p2[W - 1])\n  // doubling ladder"),
    ("  T* Eo = E_out", "  PHASE(3, E[W - 1][W - 1])\n  T* Eo = E_out"),
    ("    p2o[i * plane] = p2[i];\n  }\n}", "    p2o[i * plane] = p2[i];\n  }\n  PHASE(4, T(0))\n}"),
]


def stamped(name: str, marks, prelude: str = "") -> str:
    """The text of ``csrc/<name>`` with each (old, new) of ``marks``
    replaced (each old text must be there exactly once) and ``prelude``
    put after its include of real.cuh."""
    src = (ROOT / "phoskintime_tpu_torch/csrc" / name).read_text()
    src = src.replace('#include "real.cuh"\n', '#include "real.cuh"\n' + prelude, 1)
    for old, new in marks:
        if src.count(old) != 1:
            raise SystemExit(f"phase_clocks.py: the kernel's text changed near {old[:40]!r}")
        src = src.replace(old, new)
    return src


def nvcc_build(name: str, src: str) -> tuple[ctypes.CDLL, str]:
    """Build ``src`` (its includes resolved in csrc/) into _build; returns
    (library, ptxas report)."""
    from phoskintime_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f"{name}.cu"
    lib = cu.with_suffix(".so")
    cu.write_text(src)
    done = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-I", str(cuda_build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"phase_clocks.py: nvcc failed:\n{done.stdout}\n{done.stderr}")
    return ctypes.CDLL(str(lib)), done.stdout + done.stderr


def build() -> ctypes.CDLL:
    src = stamped("phi_tables_wide.cu", MARKS)
    src += '\nextern "C" void set_clk(void* p) { g_clk = static_cast<unsigned long long*>(p); }\n'
    so, _ = nvcc_build("phi_tables_wide_clocks", src)
    so.phi_tables_wide_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    so.phi_tables_wide_f32.restype = ctypes.c_int
    so.set_clk.argtypes = [ctypes.c_void_p]
    return so


def bench_population(b, pop: int) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.as_tensor(b["theta0"][None] + 0.05 * rng.normal(size=(pop, len(b["theta0"]))),
                           dtype=torch.float32, device="cuda")


def wide_clocks() -> None:
    from phoskintime_tpu_torch.demo import build_demo_network
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params
    from phoskintime_tpu_torch.ops.phi_tables import wide_launch_shape

    so = build()
    b = build_demo_network(40, 12, model=2, seed=0, dtype=torch.float32, device="cuda")
    params = unpack_params(bench_population(b, 2048), b["slices"], b["topo"])
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
        print(json.dumps({"kernel": "phi_tables_wide", "w": w, "rows": shape.rows,
                          "warps_a_block": shape.warps,
                          "mean_cycles_a_warp": dict(zip(PHASES, d.mean(axis=0).round(0).tolist())),
                          "total": float(d.sum(axis=1).mean())}), flush=True)


def register_report(log: str) -> dict:
    """{"float32 w=6": "Used N registers, ..."} from a ptxas report of the
    table kernel's instances."""
    out, inst = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?phi_tables_kernelI([fd])Li(\d+)E", ln)
        if m:
            inst = f"{'float64' if m.group(1) == 'd' else 'float32'} w={m.group(2)}"
        elif inst and "registers" in ln:
            out[inst] = ln.split("ptxas info    : ")[-1].strip()
    return out


def table_clocks() -> None:
    """The ``tables`` measurement: the stamped copy of csrc/phi_tables.cu
    through its C entry at the model-0 chunk, float32 and float64."""
    from phoskintime_tpu_torch.demo import build_demo_network
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params
    from phoskintime_tpu_torch.ops import phi_tables as pm

    so, log = nvcc_build("phi_tables_clocks", stamped("phi_tables.cu", TABLE_MARKS, CLOCK_PRELUDE))
    so.phase_clocks_set.argtypes = [ctypes.c_void_p]
    regs = register_report(log)
    b = build_demo_network(40, 12, seed=0, dtype=torch.float32, device="cuda")
    params = unpack_params(bench_population(b, 2048), b["slices"], b["topo"])
    (L32, binv, h_u, ladder), = expo.table_inputs(b["system"], params, b["grid"])
    tile = 128                                  # the kernel's block
    for L in (L32, L32.double()):
        w, U, B = L.shape[1], len(binv), L.shape[3]
        n_warps = U * -(-B // tile) * (tile // 32)
        clk = torch.zeros(n_warps * 8, dtype=torch.int64, device="cuda")
        if so.phase_clocks_set(clk.data_ptr()) != 0:
            raise SystemExit("phase_clocks.py: could not set the stamp buffer")
        sfx = "f32" if L.dtype == torch.float32 else "f64"
        fn = getattr(so, f"phi_tables_{sfx}")
        f = dict(dtype=L.dtype, device="cuda")
        binv_d = torch.as_tensor(binv, dtype=torch.int32, device="cuda")
        h_d = torch.as_tensor(h_u, **f)
        E, p1, p2 = (torch.empty((U, w, w, B), **f), torch.empty((U, w, B), **f),
                     torch.empty((U, w, B), **f))
        fn.argtypes = pm._ARGTYPES
        fn.restype = ctypes.c_int
        for _ in range(3):                 # the last run's stamps are kept
            clk.zero_()
            rc = fn(L.data_ptr(), binv_d.data_ptr(), h_d.data_ptr(), E.data_ptr(),
                    p1.data_ptr(), p2.data_ptr(), w, U, B, int(ladder),
                    torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"phase_clocks.py: launch failed ({rc})")
        want = pm.phi_tables_reference(L, binv, h_u, ladder)
        err = max(float(torch.max(torch.abs(g - r)) / torch.max(torch.abs(r)))
                  for g, r in zip((E, p1, p2), want))
        ck = clk.reshape(n_warps, 8).cpu().numpy().astype(np.int64)
        ck = ck[ck[:, 7] > 0]
        tiles = ck[:, 7]
        per_tile = ck[:, :5].sum(axis=0) / tiles.sum()
        reg = regs.get(f"{'float32' if sfx == 'f32' else 'float64'} w={w}", "not in the report")
        m = re.match(r"Used (\d+) registers", reg)
        blocks = None
        if m:                                # registers a warp in units of 256
            per_warp = -(-int(m.group(1)) * 32 // 256) * 256
            blocks = min(32, 65536 // (tile // 32 * per_warp))
        print(json.dumps({
            "kernel": "phi_tables", "dtype": sfx, "w": w, "pairs": U, "lanes": B,
            "tile": tile, "ptxas": reg, "blocks_an_sm": blocks,
            "warps_stamped": int(len(ck)), "tiles_a_warp_mean": float(tiles.mean()),
            "mean_cycles_a_warp_tile": dict(zip(TABLE_PHASES, per_tile.round(1).tolist())),
            "load_and_store_share": float((per_tile[0] + per_tile[4]) / per_tile.sum()),
            # cycles over globaltimer ns from a warp's start to its last tile
            "sm_ghz_in_run": float(ck[:, 5].sum() / max(ck[:, 6].sum(), 1)),
            "mean_cycles_a_warp": float(ck[:, :5].sum(axis=1).mean()),
            "max_scaled_err_vs_plain": err}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("wide", "tables", "both"), default="both")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if opts.kernel in ("tables", "both"):
        table_clocks()
    if opts.kernel in ("wide", "both"):
        wide_clocks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
