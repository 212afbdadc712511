"""Where the table kernels spend their time, phase by phase, on the card.

    python tools/phase_clocks.py [--kernel wide|tables|xwide|scan|stream|both]

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

* ``xwide``: ``csrc/phi_tables_xwide.cu`` at chip_smoke.py phase 3h's
  classes w = 22, 33, 65 in float32 and float64 (the inputs of
  ``tools/kernel_ab.py``'s xwide section): the mean cycles a block spends
  zeroing its planes and loading L and the norm, scaling, in the Horner
  steps (with the series beside them), in the ladder and storing, and the
  cycles of one Horner phase and one ladder product.

* ``scan``: the wide kernel of ``csrc/etd2rk_scan.cu`` on the objective's
  own scans at phase 3i's networks (``tools/smoke_cases.py``; w = 22, 65,
  129 at N = 6-7, N = 285 at w = 6; float32 at 2,048 members, float64 at
  256): a warp's mean cycles a run issuing the copy of the run's rows and
  waiting for it, and a segment in each synthesis (split into its wait,
  the barrier or the cluster's signal, and the rest), in E y and in the
  update. ``--tree DIR`` clocks the kernel and wrapper of another checkout
  (a ``git archive`` of the parent, unpacked in a git-ignored directory).

* ``stream``: ``csrc/phi_tables_stream.cu`` at chip_smoke.py phase 3j's w =
  257 class (the 8-site network, 2,048 members in float32, 256 in
  float64): a warp's mean cycles in an item's load and norm, its start, the
  products' tiled sums and epilogues, the cluster barrier after each
  product and the store, and the cycles a product.

The sources are stamped by text: a change to the marked lines of a kernel
needs the same change here. The stamps cost a few instructions a phase;
the numbers locate time, they are not the kernel's time.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
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


def stamped(name: str, marks, prelude: str = "", root: Path = ROOT) -> str:
    """The text of ``csrc/<name>`` in the checkout ``root`` with each (old,
    new) of ``marks`` replaced (each old text must be there exactly once)
    and ``prelude`` put after its include of real.cuh."""
    src = (root / "phoskintime_tpu_torch/csrc" / name).read_text()
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


# csrc/phi_tables_xwide.cu: a warp's stamps at its block's phase boundaries
# (every warp of a block passes them together), its block's ladder trips
XWIDE_PHASES = ["zero+load+norm", "scale", "series setup", "horner+series", "ladder", "store"]
XWIDE_PRELUDE = r"""
__device__ unsigned long long* g_phase_clk;
#define XMARK(k)                                                                       \
  if ((threadIdx.x & 31) == 0)                                                         \
    g_phase_clk[(((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (blockDim.x / 32)     \
                 + threadIdx.x / 32) * 8 + (k)] = clock64();
extern "C" int phase_clocks_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, &p, sizeof(p)));
}
"""
XWIDE_MARKS = [
    ("  for (int e = tid; e < LB * lanestride * static_cast<int>(sizeof(Real)) / 16; e += nth)",
     "  XMARK(0)\n"
     "  for (int e = tid; e < LB * lanestride * static_cast<int>(sizeof(Real)) / 16; e += nth)"),
    ("  // A /= 2^s; E = I + A/n into plane 1",
     "  XMARK(1)\n  // A /= 2^s; E = I + A/n into plane 1"),
    ("  // phi1 / phi2 e0: term", "  XMARK(2)\n  // phi1 / phi2 e0: term"),
    ("  // E = expm(A) by Horner", "  XMARK(3)\n  // E = expm(A) by Horner"),
    ("  // p1 = v1 hs, p2 = v2 hs^2 into columns K, K+1 of E",
     "  XMARK(4)\n  // p1 = v1 hs, p2 = v2 hs^2 into columns K, K+1 of E"),
    ("    barrier<kCluster>();\n  }\n\n  for (int e = tid; e < LB * nrow * w; e += nth) {",
     "    barrier<kCluster>();\n  }\n  XMARK(5)\n  if ((threadIdx.x & 31) == 0) g_phase_clk["
     "(((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32) * 8"
     " + 7] = n_block;\n\n  for (int e = tid; e < LB * nrow * w; e += nth) {"),
    ("  if constexpr (kCluster == 2) barrier<2>();   // no block leaves",
     "  XMARK(6)\n  if constexpr (kCluster == 2) barrier<2>();   // no block leaves"),
]


def xwide_clocks() -> None:
    """The ``xwide`` measurement: a stamped copy of csrc/phi_tables_xwide.cu
    through its C entries at kernel_ab.py's xwide inputs (chip_smoke.py
    3h's classes w = 22, 33, 65 in both types): the mean cycles a block
    spends in each phase, a Horner product's and a ladder product's."""
    sys.path.insert(0, str(ROOT / "tools"))
    import kernel_ab
    from phoskintime_tpu_torch.ops import phi_tables as pm

    so, log = nvcc_build("phi_tables_xwide_clocks",
                         stamped("phi_tables_xwide.cu", XWIDE_MARKS, XWIDE_PRELUDE))
    so.phase_clocks_set.argtypes = [ctypes.c_void_p]
    print(json.dumps({"ptxas": re.findall(r"Used \d+ registers|\d+ bytes spill stores", log)}))
    path = kernel_ab.xwide_inputs(ROOT / "results_ab" / "xwide_clock_inputs.pt")
    cases = torch.load(path, weights_only=False)
    for (label, (L, binv, h_u, ladder)), alone in itertools.product(cases.items(), (False, True)):
        shape = pm.xwide_launch_shape(L.shape[1], L.element_size())
        if alone:                          # one block an SM: no other block beside it
            L = L[..., :132 // (len(binv) * shape.cluster) * shape.lanes].contiguous()
        L = L.cuda()
        w, U, B = L.shape[1], len(binv), L.shape[3]
        blocks = U * shape.cluster * -(-B // shape.lanes)
        clk = torch.zeros(blocks * (shape.threads // 32) * 8, dtype=torch.int64, device="cuda")
        if so.phase_clocks_set(clk.data_ptr()) != 0:
            raise SystemExit("phase_clocks.py: could not set the stamp buffer")
        fn = getattr(so, f"phi_tables_xwide_{'f32' if L.dtype == torch.float32 else 'f64'}")
        fn.argtypes = pm._XWIDE_ARGTYPES
        fn.restype = ctypes.c_int
        f = dict(dtype=L.dtype, device="cuda")
        binv_d = torch.as_tensor(binv, dtype=torch.int32, device="cuda")
        h_d = torch.as_tensor(h_u, **f)
        E, p1, p2 = (torch.empty((U, w, w, B), **f), torch.empty((U, w, B), **f),
                     torch.empty((U, w, B), **f))
        for _ in range(2):
            rc = fn(L.data_ptr(), binv_d.data_ptr(), h_d.data_ptr(), E.data_ptr(),
                    p1.data_ptr(), p2.data_ptr(), w, U, B, int(ladder), shape.lanes,
                    shape.threads, shape.cluster, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"phase_clocks.py: launch failed ({rc})")
        ck = clk.reshape(-1, 8).cpu().numpy().astype(np.int64)[:: shape.threads // 32]
        d = np.diff(ck[:, :7], axis=1)
        trips = ck[:, 7]
        terms = 8 if L.dtype == torch.float32 else 12
        print(json.dumps({
            "kernel": "phi_tables_xwide", "case": label, "lanes": B, "alone": alone,
            "shape": shape._asdict(),
            "blocks": int(len(ck)),
            "mean_cycles_a_block": dict(zip(XWIDE_PHASES, d.mean(axis=0).round(0).tolist())),
            "ladder_trips_mean": float(trips.mean()),
            "cycles_a_horner_product": float(d[:, 3].mean() / (terms - 1)),
            "cycles_a_ladder_product": float(d[:, 4].sum() / max(trips.sum(), 1)),
            "cycles_a_block_total": float(d.sum(axis=1).mean())}), flush=True)


# csrc/etd2rk_scan.cu's wide kernel: a warp's cycles, summed by lane 0 of
# every warp into a device array with the warps counted, in these slots: a
# run's copy of its rows, issuing it and waiting for it; a segment's first
# synthesis, E y, second synthesis and update; and, inside each synthesis,
# its wait (the barrier, or the signal of the cluster's other blocks)
SCAN_SLOTS = ["copy_issue", "copy_wait", "synth_y", "E_y", "synth_a", "update",
              "synth_y_wait", "synth_a_wait"]
SCAN_PRELUDE = """__device__ unsigned long long g_scan_clk[9];
#define SCAN_STAMP(k) { const unsigned long long now_ = clock64(); clk_[k] += now_ - tk_; tk_ = now_; }
"""
SCAN_TAIL = ("  if (t % 32 == 0) {\n"
             "    for (int k = 0; k < 8; ++k) atomicAdd(g_scan_clk + k, clk_[k]);\n"
             "    atomicAdd(g_scan_clk + 8, 1ull);\n  }\n")
# the marks of the kernel in this checkout: the copies issued at a run's
# start (its p1 and p2h rows, its E rows by wide_copy_rows); the
# synthesis's wait in wide_wait; its gathers after it
SCAN_MARKS = [
    ("  T drive1 = T(0);",
     "  unsigned long long clk_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tk_ = clock64();\n"
     "  T drive1 = T(0);"),
    ("    for (int s = s0; s < s1; ++s) {\n      // --- the first synthesis",
     "    SCAN_STAMP(0)\n    for (int s = s0; s < s1; ++s) {\n      // --- the first synthesis"),
    ("        if (s == s0) wait_async();\n      }\n",
     "        if (s == s0) wait_async();\n      }\n      SCAN_STAMP(1)\n"),
    ("      wide_wait(0);\n",
     "      { const unsigned long long w0_ = clock64(); wide_wait(0); "
     "clk_[6] += clock64() - w0_; }\n"),
    ("        const T sn = act ? gather(0, l, lane_base(l)) : T(0);\n",
     "        const T sn = act ? gather(0, l, lane_base(l)) : T(0);\n        SCAN_STAMP(2)\n"),
    ("        put(1, l, act, act && is_driven(l), part_a);\n",
     "        put(1, l, act, act && is_driven(l), part_a);\n        SCAN_STAMP(3)\n"),
    ("      wide_wait(1);\n",
     "      { const unsigned long long w0_ = clock64(); wide_wait(1); "
     "clk_[7] += clock64() - w0_; }\n"),
    ("          const T d = gather(1, l, lane_base(l)) - sn;\n",
     "          const T d = gather(1, l, lane_base(l)) - sn;\n          SCAN_STAMP(4)\n"),
    ("        put(0, l, act, act && is_driven(l), part);\n      }\n    }\n  }\n",
     "        put(0, l, act, act && is_driven(l), part);\n        SCAN_STAMP(5)\n      }\n    }\n"
     "  }\n" + SCAN_TAIL),
]
# the marks of the first wide kernel (a warp a lane, a cluster barrier; this
# one's parent), to clock a checkout of it with --tree: the copy issued in
# the run's prologue, the synthesis's wait in wide_barrier
SCAN_MARKS_FIRST = [
    ("                                        const T* __restrict__ tf_coef) {\n"
     "  for (int off = Q;",
     "                                        const T* __restrict__ tf_coef,"
     " unsigned long long& bar_) {\n  for (int off = Q;"),
    ("  wide_barrier(cluster);\n  if (!ln.active) return T(0);",
     "  const unsigned long long b0_ = clock64();\n  wide_barrier(cluster);\n"
     "  bar_ += clock64() - b0_;\n  if (!ln.active) return T(0);"),
    ("  T part = T(0);\n  ln.driven = false;",
     "  unsigned long long clk_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tk_ = 0;\n"
     "  T part = T(0);\n  ln.driven = false;"),
    ("    T drive = T(0);\n    if (ln.active && ln.driven) drive",
     "    tk_ = clock64();\n    T drive = T(0);\n    if (ln.active && ln.driven) drive"),
    ("    if constexpr (kSharedState) wait_async();\n    for (int s = s0; s < s1; ++s) {\n"
     "      const T sn = synth_wide(part, drive, pv, ln, Q, lanes, cluster, cst, rows, tf_col,\n"
     "                              tf_coef);\n",
     "    SCAN_STAMP(0)\n    if constexpr (kSharedState) wait_async();\n    SCAN_STAMP(1)\n"
     "    for (int s = s0; s < s1; ++s) {\n"
     "      const T sn = synth_wide(part, drive, pv, ln, Q, lanes, cluster, cst, rows, tf_col,\n"
     "                              tf_coef, clk_[6]);\n      SCAN_STAMP(2)\n"),
    ("      const T sa = synth_wide(part_a, drive, pv + lanes, ln, Q, lanes, cluster, cst, rows,\n"
     "                              tf_col, tf_coef);\n",
     "      SCAN_STAMP(3)\n"
     "      const T sa = synth_wide(part_a, drive, pv + lanes, ln, Q, lanes, cluster, cst, rows,\n"
     "                              tf_col, tf_coef, clk_[7]);\n      SCAN_STAMP(4)\n"),
    ("          if (slot >= 0) ys[(static_cast<size_t>(slot) * w + i) * B + lane] = yi;\n"
     "        }\n      }\n    }\n  }\n",
     "          if (slot >= 0) ys[(static_cast<size_t>(slot) * w + i) * B + lane] = yi;\n"
     "        }\n      }\n      SCAN_STAMP(5)\n    }\n  }\n" + SCAN_TAIL),
]
SCAN_READ = """
extern "C" int scan_clocks_read(unsigned long long* out, int reset) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_scan_clk, sizeof(g_scan_clk));
  if (rc == cudaSuccess && reset) {
    const unsigned long long zero[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    rc = cudaMemcpyToSymbol(g_scan_clk, zero, sizeof(zero));
  }
  return static_cast<int>(rc);
}
"""


def scan_marks(src: str) -> list:
    """The mark set whose every text is in ``src`` exactly once: this
    checkout's kernel's or the first wide kernel's."""
    for marks in (SCAN_MARKS, SCAN_MARKS_FIRST):
        if marks and all(src.count(old) == 1 for old, _ in marks):
            return marks
    raise SystemExit("phase_clocks.py: the scan kernel's text matches no mark set")


def scan_clocks(tree: Path) -> None:
    """The ``scan`` measurement: a stamped copy of ``tree``'s
    csrc/etd2rk_scan.cu through ``tree``'s wrapper (its library swapped in)
    on the objective's own scans at phase 3i's networks
    (tools/smoke_cases.py: SCAN_WIDE_NETWORKS unbucketed, ``expo.ScanSetup``
    at 2,048 members in float32 and 256 in float64): a warp's mean cycles a
    run issuing the run's copy and waiting for it, and a segment in each
    synthesis (its wait and the rest), E y and the update; and the stamped
    kernel's ms (CUDA events). A shape that runs the template kernel (no
    stamps) reports its ms alone."""
    from phoskintime_tpu_torch.ops import scan_kernel as sk
    from smoke_cases import SCAN_WIDE_NETWORKS, SCAN_WIDE_POP, scan_wide_args, scan_wide_hosts

    src = (tree / "phoskintime_tpu_torch/csrc/etd2rk_scan.cu").read_text()
    marks = scan_marks(src)
    so, log = nvcc_build("etd2rk_scan_clocks",
                         stamped("etd2rk_scan.cu", marks, SCAN_PRELUDE, root=tree) + SCAN_READ)
    so.scan_clocks_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    err = so.etd2rk_scan_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    wide = [part for part in log.split("Compiling entry function '")[1:]
            if "etd2rk_scan_wide_kernel" in part.split("'")[0]]
    print(json.dumps({"tree": str(tree), "marks": "this checkout" if marks is SCAN_MARKS
                      else "first wide kernel", "ptxas_wide": [
                          re.findall(r"Used \d+ registers|\d+ bytes spill stores", p)
                          for p in wide]}), flush=True)

    def fake_entry(source, name, argtypes):
        fn = getattr(so, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn, err

    hosts = scan_wide_hosts()
    out = np.zeros(9, dtype=np.uint64)
    saved = sk.entry
    sk.entry = fake_entry
    try:
        for dtype, name in itertools.product((torch.float32, torch.float64), SCAN_WIDE_NETWORKS):
            args, plan = scan_wide_args(hosts[name], dtype, SCAN_WIDE_POP[dtype])
            sk.etd2rk_scan(*args, plan)
            torch.cuda.synchronize()
            so.scan_clocks_read(out.ctypes.data, 1)
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            sk.etd2rk_scan(*args, plan)
            stop.record()
            torch.cuda.synchronize()
            if so.scan_clocks_read(out.ctypes.data, 1) != 0:
                raise SystemExit("phase_clocks.py: could not read the stamps")
            w, B = args[0].shape[1], args[0].shape[3]
            warps, S, R = int(out[8]), len(plan.uidx), len(plan.runs)
            per = dict(zip(SCAN_SLOTS, out[:8].astype(np.float64) / max(warps, 1)))
            row = {"kernel": "etd2rk_scan", "network": name, "w": w, "N": plan.N,
                   "members": B // plan.N, "dtype": str(dtype).split(".")[-1],
                   "segments": S, "runs": R,
                   "shape": sk.scan_launch_shape(w, plan.N, args[0].element_size())._asdict(),
                   "warps_stamped": warps, "ms": round(start.elapsed_time(stop), 4)}
            if warps:
                row["mean_cycles_a_run"] = {k: round(per[k] / R, 1)
                                            for k in ("copy_issue", "copy_wait")}
                row["mean_cycles_a_segment"] = {
                    "synth_y_wait": round(per["synth_y_wait"] / S, 1),
                    "synth_y_rest": round((per["synth_y"] - per["synth_y_wait"]) / S, 1),
                    "E_y": round(per["E_y"] / S, 1),
                    "synth_a_wait": round(per["synth_a_wait"] / S, 1),
                    "synth_a_rest": round((per["synth_a"] - per["synth_a_wait"]) / S, 1),
                    "update": round(per["update"] / S, 1)}
                row["mean_cycles_a_warp"] = round(float(sum(per[k] for k in SCAN_SLOTS[:6])), 1)
            print(json.dumps(row), flush=True)
            del args
            torch.cuda.empty_cache()
    finally:
        sk.entry = saved


# csrc/phi_tables_stream.cu: a warp's cycles, summed by lane 0 of every warp
# into a device array with the warps counted, in these slots: an item's L h
# with its norm and first cluster barrier, its E and series start with the
# second; the products' tiled sums (copies and multiply-adds) and their
# epilogues; the cluster barrier after each product (a block with no tile
# in a product's last round waits here); the tables' store; the products
# and the items a warp ran
STREAM_SLOTS = ["load_norm", "init", "tile_sums", "epilogue", "product_barrier", "store",
                "products", "items"]
STREAM_PRELUDE = """__device__ unsigned long long g_stream_clk[9];
#define SSTAMP(k) { const unsigned long long now_ = clock64(); clk_[k] += now_ - tk_; tk_ = now_; }
"""
STREAM_MARKS = [
    ("                        int rank, const Step<T>& sp) {",
     "                        int rank, const Step<T>& sp, unsigned long long& sums_,\n"
     "                        unsigned long long& epi_) {"),
    ("    tile_sums(sm, X, Y, ld, K, m0, n0);\n",
     "    const unsigned long long g0_ = clock64();\n    tile_sums(sm, X, Y, ld, K, m0, n0);\n"
     "    const unsigned long long g1_ = clock64();\n    sums_ += g1_ - g0_;\n"),
    ("    __syncthreads();   // the tile's sums are read before the next tile's copies land\n",
     "    __syncthreads();   // the tile's sums are read before the next tile's copies land\n"
     "    epi_ += clock64() - g1_;\n"),
    ("  const long long items = static_cast<long long>(U) * B;\n",
     "  const long long items = static_cast<long long>(U) * B;\n"
     "  unsigned long long clk_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tk_ = clock64();\n"),
    ("    // the lane's squaring count s from every block's share",
     "    SSTAMP(0)\n    // the lane's squaring count s from every block's share"),
    ("    // Horner, E = I + (A E) 2^-s / k", "    SSTAMP(1)\n    // Horner, E = I + (A E) 2^-s / k"),
    ("      product<kHorner>(sm, planeA, plane[cur], plane[cur ^ 1], g, w, rank, sp);\n"
     "      cluster_barrier();\n",
     "      product<kHorner>(sm, planeA, plane[cur], plane[cur ^ 1], g, w, rank, sp, clk_[2],\n"
     "                       clk_[3]);\n      tk_ = clock64();\n      cluster_barrier();\n"
     "      SSTAMP(4)\n      clk_[6] += 1;\n"),
    ("      product<kLadder>(sm, plane[cur], plane[cur], plane[cur ^ 1], g, w, rank, sp);\n"
     "      cluster_barrier();\n",
     "      product<kLadder>(sm, plane[cur], plane[cur], plane[cur ^ 1], g, w, rank, sp, clk_[2],\n"
     "                       clk_[3]);\n      tk_ = clock64();\n      cluster_barrier();\n"
     "      SSTAMP(4)\n      clk_[6] += 1;\n"),
    ("      p2_out[row] = __ldcg(fin + static_cast<size_t>(i) * ld + K + 1);\n    }\n  }\n}\n",
     "      p2_out[row] = __ldcg(fin + static_cast<size_t>(i) * ld + K + 1);\n    }\n"
     "    SSTAMP(5)\n    clk_[7] += 1;\n  }\n"
     "  if (threadIdx.x % 32 == 0) {\n"
     "    for (int k = 0; k < 8; ++k) atomicAdd(g_stream_clk + k, clk_[k]);\n"
     "    atomicAdd(g_stream_clk + 8, 1ull);\n  }\n}\n"),
]
STREAM_READ = SCAN_READ.replace("scan_clocks_read", "stream_clocks_read").replace(
    "g_scan_clk", "g_stream_clk")


def stream_clocks() -> None:
    """The ``stream`` measurement: a stamped copy of
    csrc/phi_tables_stream.cu through the wrapper (its library swapped in)
    at chip_smoke.py phase 3j's w = 257 class (tools/smoke_cases.py's
    STREAM_NETWORK, 2,048 members in float32 and 256 in float64, the
    objective's first chunk): a warp's mean cycles in each slot, the share
    of the products' tiled sums, epilogues and barriers, the cycles a
    product, the stamped kernel's ms (CUDA events) and its largest scaled
    difference from the plain version on 16 lanes."""
    from phoskintime_tpu_torch.demo import build_demo_network
    from phoskintime_tpu_torch.network import expo
    from phoskintime_tpu_torch.network.params import unpack_params
    from phoskintime_tpu_torch.ops import phi_tables as pm
    from smoke_cases import STREAM_NETWORK, XWIDE_NETWORKS

    so, log = nvcc_build("phi_tables_stream_clocks",
                         stamped("phi_tables_stream.cu", STREAM_MARKS, STREAM_PRELUDE)
                         + STREAM_READ)
    so.stream_clocks_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    err = so.phi_tables_stream_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    print(json.dumps({"ptxas": re.findall(r"Used \d+ registers|\d+ bytes spill stores", log)}),
          flush=True)

    def fake_entry(source, name, argtypes):
        fn = getattr(so, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn, err

    out = np.zeros(9, dtype=np.uint64)
    saved = pm.entry
    pm.entry = fake_entry
    try:
        for dtype, pop in ((torch.float32, 2048), (torch.float64, 256)):
            b = build_demo_network(**XWIDE_NETWORKS[STREAM_NETWORK], dtype=dtype, device="cuda")
            params = unpack_params(bench_population(b, pop).to(dtype), b["slices"], b["topo"])
            (L, binv, h_u, ladder), = [t for t in expo.table_inputs(b["system"], params, b["grid"])
                                       if t[0].shape[1] > 129]
            pm.phi_tables_stream(L, binv, h_u, ladder)
            torch.cuda.synchronize()
            so.stream_clocks_read(out.ctypes.data, 1)
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            pm.phi_tables_stream(L, binv, h_u, ladder)
            stop.record()
            torch.cuda.synchronize()
            if so.stream_clocks_read(out.ctypes.data, 1) != 0:
                raise SystemExit("phase_clocks.py: could not read the stamps")
            sub = L[..., :16].contiguous()
            got, want = pm.phi_tables_stream(sub, binv, h_u, ladder), pm.phi_tables_reference(
                sub, binv, h_u, ladder)
            scaled = max(float(torch.max(torch.abs(g - r)) / torch.max(torch.abs(r)))
                         for g, r in zip(got, want))
            w = L.shape[1]
            K, R, ld, _ = pm.stream_layout(w, L.element_size())
            tiles = (R // pm._STREAM_TILE) * (ld // pm._STREAM_TILE)
            warps = int(out[8])
            per = dict(zip(STREAM_SLOTS, out[:8].astype(np.float64) / max(warps, 1)))
            timed = sum(per[k] for k in STREAM_SLOTS[:6])
            products = max(per["products"], 1.0)
            print(json.dumps({
                "kernel": "phi_tables_stream", "network": STREAM_NETWORK,
                "dtype": str(dtype).split(".")[-1], "w": w, "pairs": len(binv),
                "lanes": L.shape[3], "ladder": int(ladder),
                "tiles_a_product": tiles, "tile_rounds": -(-tiles // pm._STREAM_CLUSTER),
                "idle_tile_slots_a_product": -(-tiles // pm._STREAM_CLUSTER) * pm._STREAM_CLUSTER
                - tiles, "warps_stamped": warps,
                "items_a_warp": round(per["items"], 2),
                "products_an_item": round(per["products"] / max(per["items"], 1.0), 3),
                "mean_cycles_a_warp": {k: round(per[k], 1) for k in STREAM_SLOTS[:6]},
                "share": {k: round(per[k] / timed, 4) for k in STREAM_SLOTS[:6]},
                "cycles_a_product": {k: round(per[k] / products, 1)
                                     for k in ("tile_sums", "epilogue", "product_barrier")},
                "ms_stamped": round(start.elapsed_time(stop), 4),
                "max_scaled_err_vs_plain_16_lanes": scaled}), flush=True)
            del L, params, b
            torch.cuda.empty_cache()
    finally:
        pm.entry = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("wide", "tables", "xwide", "scan", "stream", "both"),
                    default="both")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="scan: the checkout whose kernel and wrapper are clocked "
                         "(default this one; a git archive of another commit to clock its)")
    opts = ap.parse_args()
    sys.path.insert(0, str(opts.tree.resolve()))
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if opts.kernel in ("tables", "both"):
        table_clocks()
    if opts.kernel in ("wide", "both"):
        wide_clocks()
    if opts.kernel == "xwide":
        xwide_clocks()
    if opts.kernel == "scan":
        scan_clocks(opts.tree.resolve())
    if opts.kernel == "stream":
        stream_clocks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
