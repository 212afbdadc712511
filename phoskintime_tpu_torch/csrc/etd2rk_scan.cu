// The whole ETD2RK segment scan of the population objective in one launch,
// float32 and float64 (one template), block widths 2 <= w <= 17. For each segment s of the static plan,
// with u = uidx[s] its (bucket, h) pair and b = jb[s] its kinase bucket,
//   a  = E[u] y + p1[u] g(y)
//   y' = a + p2h[u] (g(a) - g(y))
// where g is the synthesis drive in the R slot: the lane's total protein
// (or, for a kinase-driven protein, the live kinase drive drv[b]), the TF
// matvec over the proteins of the same member, u = v / (1 + |v|) and the
// rational rate. The state after segment s is written to snapshot
// out_slot[s] when that is >= 0; the snapshots in init_slots get y0.
//
// Replaces: phoskintime_tpu/ops/scan_pallas.py::etd2rk_scan_pallas (kernel
// body _scan_kernel), the opt-in whole-scan kernel of the population
// objective (use_scan_kernel=True) for mechanisms 0, 1 and unbucketed 2.
// Plain PyTorch version:
// phoskintime_tpu_torch/ops/scan_kernel.py::etd2rk_scan_reference.
//
// Layout. Lanes are member-major, protein-minor (lane = member * N + q), the
// lane axis last everywhere: E (U, w, w, B), p1 / p2h (U, w, B), y0 (w, B),
// drv (NB, B), A / ts (B,), ys (T, w, B), with B = P * N. Per protein:
// totw (w, N), the total-protein weight of each slot (row 0, the R slot,
// is never read); driven (N,); the TF rows of (tf_mat / tf_deg) as CSR
// (tf_ptr (N+1,), tf_col, tf_coef) and tf_deg (N,). The plan comes as runs,
// (first segment, length, pair, bucket), a run being a maximal stretch of
// consecutive segments of one pair (ops/scan_kernel.py::scan_runs; a pair
// has one bucket), with each segment's snapshot slot out_slot.
//
// What bounds it on this card. Read once, the tables are U (w^2 + 2w) B
// floats: 248 MB for the bench's model-0 chunk (U = 14, w = 6, B = 92,160),
// 1.67 GB for its unbucketed model-2 chunk (w = 17), 0.074 and 0.50 ms at
// 3.35 TB/s; the arithmetic is about S B (w^2 + 4w + 2 nnz/N + 20) FMAs,
// 1.0 G and 4.1 G there (0.03 and 0.12 ms at 67 TFLOP/s). So bytes bound
// it, if each table is read once. The tables do not fit on chip (248 MB
// against 50 MB of L2), and a design that reads a pair's rows at every
// segment moves S (w^2 + 2w) B floats: 2.35 GB at w = 6, from L2 while a
// 17.7 MB pair slab fits there, and 15.8 GB at w = 17, all from HBM (a
// pair slab is 119 MB).
//
// What the design does about it. The segment plan is run-structured: the
// bench's 133 segments fall into 14 runs, one pair each. A thread block
// loads its lanes' rows of a run's pair once, at the run's first segment,
// and keeps them on chip until the run's last, so every table is read once;
// the live kinase drive of a driven lane is read once a run too.
// Where they stay depends on the width, in three variants of one template,
// chosen by (w, N) alone (ops/scan_kernel.py::scan_launch_shape):
//   registers (w <= 8): E's w^2 entries and p1, p2h in the thread's
//     registers (w^2 + 2w <= 80 floats beside y, a and tw); no spills.
//   shared (9 <= w <= 17, a member's E rows fit 227 KB): E in dynamic
//     shared memory, each lane's w^2 entries contiguous (padded to an odd
//     stride at even w, so a warp's 32 lanes read 32 banks and every
//     address is the lane's base plus a constant), copied in with cp.async
//     at the run's first segment (each thread copies and reads only its
//     own lane's entries, so no barrier guards the slab); p1 and p2h in
//     registers. 4 (w^2 + 2) bytes a lane with the totals' buffers (4 more
//     at even w): a member fits while w <= 15, at w = 16 up to N = 224,
//     at w = 17 up to N = 199; at the bench's N = 45, two members a block
//     (90 lanes, 104,760 B).
//   stream (w = 16, 17 above those N): E read from memory at every segment
//     as the first design did (L2 or HBM); p1 and p2h in registers per run.
// One thread per (member, protein) lane keeps its w-slot state, a, and its
// total-protein weights in registers for all S segments; nothing but the
// snapshots is written back. The TF matvec couples proteins only within a
// member, so a thread block holds whole members (about 128 lanes, fewer
// where shared memory runs out) and no block needs another block's data:
// the members' totals Pv are exchanged through shared memory, one
// __syncthreads() per synthesis evaluation (two per segment), with two
// buffers alternating so that a segment's second write cannot overrun a
// read of its first. Each thread reads only its own member's Pv, so a
// non-finite member changes no other member's values. The arithmetic is
// the first design's, FMA for FMA (the same fmaf chains over j, the same
// synthesis), so the output does not depend on the variant. The driven
// override is a select, not the Pallas kernel's blend, so a non-finite
// total cannot poison a driven protein. FP32 FMA only: no tensor cores.
// The kernel is latency-bound: each segment is a chain of two barriers, the
// TF gathers and four divisions, so the more blocks an SM holds the better.
// The w = 6 build (the bench's model 0) is bounded to 85 registers (80
// used, a 52-byte spill), which fits the chunk's 1,024 blocks in one wave
// (0.49 -> 0.35 ms on the H100); w = 7 and 8 use 148 and 167, the shared
// variant 168 at w = 17, the stream variant up to 255, and nothing else
// spills. chip_smoke.py's build phase prints ptxas's report of every
// instantiation.
//
// float64: the same template at twice the bytes (so bytes bound it still).
// The plan's coefficients (totals' weights, TF rows, degrees) come at the
// working type, never rounded to float32 as the Pallas kernel rounds its
// TF coefficients. E's w^2 words take twice the registers, so the register
// variant stops at w = 6 and w = 7, 8 keep E in shared memory; a lane takes
// 8 (w^2 + 2) bytes there, so a member's E rows fit 227 KB up to N = 99 at
// w = 17 (ops/scan_kernel.py::scan_launch_shape picks by w, N and type).

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

// One build of each width and variant, bounded at 256 threads a block (up
// to 255 registers a thread), so a member holds at most 256 proteins.
constexpr int kMaxThreads = 256;
constexpr int kMaxShared = 232448;       // dynamic shared memory a block may opt into
constexpr int kDefaultShared = 48 * 1024;

enum Variant { kRegisters = 0, kShared = 1, kStream = 2 };

// Shared variant: a lane's E takes kStride words, its w^2 entries row-major
// and one more at even w, so that the 32 lanes of a warp, kStride (odd)
// words apart, read 32 different banks (in float64, each half-warp's 16
// lanes read 16 different bank pairs).
template <int W>
constexpr int kStride = W * W + (W % 2 == 0 ? 1 : 0);

template <typename T>
struct Lane {
  bool active;
  int base;            // this member's first slot in a Pv buffer
  int row_beg, row_end;
  bool driven;
  T amp, tsc, deg;
};

// g(v): the synthesis drive of this lane. Every thread of the block calls it
// (the barrier is block-wide); only active lanes write or read `buf`.
template <typename T, int W>
__device__ __forceinline__ T synth(const T (&v)[W], const T (&tw)[W], T drive, T* buf,
                                   const Lane<T>& ln, const int* __restrict__ tf_col,
                                   const T* __restrict__ tf_coef) {
  if (ln.active) {
    T tot = T(0);
#pragma unroll
    for (int i = 1; i < W; ++i) tot = real::fma(tw[i], v[i], tot);
    buf[threadIdx.x] = ln.driven ? drive : tot;
  }
  __syncthreads();
  if (!ln.active) return T(0);
  T acc = T(0);
  for (int k = ln.row_beg; k < ln.row_end; ++k)
    acc = real::fma(__ldg(tf_coef + k), buf[ln.base + __ldg(tf_col + k)], acc);
  const T x = acc / ln.deg;
  const T u = x / (T(1) + real::abs(x));
  const T act = ln.amp * (T(1) + (ln.tsc * u) / ((T(1) + u) + T(1e-6)));
  const T rep = ln.amp / (T(1) + ln.tsc * real::abs(u));
  return u >= T(0) ? act : rep;
}

// An asynchronous copy of one 4- or 8-byte word from device to shared
// memory, and the wait for all of this thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int W, int V>
__global__ void __launch_bounds__(kMaxThreads,
                                  sizeof(T) == 4 && V == kRegisters && W <= 6 ? 3 : 1)
etd2rk_scan_kernel(const T* __restrict__ E, const T* __restrict__ p1,
                   const T* __restrict__ p2h, const T* __restrict__ y0,
                   const T* __restrict__ drv, const T* __restrict__ A,
                   const T* __restrict__ ts, const T* __restrict__ totw,
                   const int* __restrict__ driven, const int* __restrict__ tf_ptr,
                   const int* __restrict__ tf_col, const T* __restrict__ tf_coef,
                   const T* __restrict__ tf_deg, const int* __restrict__ runs,
                   const int* __restrict__ out_slot,
                   const int* __restrict__ init_slots, T* __restrict__ ys,
                   int n_init, int n_runs, int N, int P, int members_per_block) {
  // 2 x span Pv words, then (shared variant) each lane's E: kStride a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int span = members_per_block * N;
  const int t = threadIdx.x;
  T* pv = smem;
  T* Es = smem + 2 * span + t * kStride<W>;
  const int member = blockIdx.x * members_per_block + t / N;
  const size_t B = static_cast<size_t>(P) * N;
  const size_t lane = static_cast<size_t>(member) * N + t % N;

  Lane<T> ln;
  ln.active = t < span && member < P;
  ln.base = (t / N) * N;
  T y[W], a[W], tw[W], q1[W], q2[W];
  T e[V == kRegisters ? W * W : 1];
  if (ln.active) {
    const int q = t % N;
    ln.row_beg = tf_ptr[q];
    ln.row_end = tf_ptr[q + 1];
    ln.driven = driven[q] != 0;
    ln.amp = A[lane];
    ln.tsc = ts[lane];
    ln.deg = tf_deg[q];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      y[i] = y0[i * B + lane];
      tw[i] = totw[i * N + q];
    }
    for (int k = 0; k < n_init; ++k) {
      T* out = ys + static_cast<size_t>(init_slots[k]) * W * B + lane;
#pragma unroll
      for (int i = 0; i < W; ++i) out[i * B] = y[i];
    }
  }

  for (int r = 0; r < n_runs; ++r) {
    const int s0 = __ldg(runs + 4 * r), s1 = s0 + __ldg(runs + 4 * r + 1);
    const int u = __ldg(runs + 4 * r + 2), bucket = __ldg(runs + 4 * r + 3);
    const T* Eu = E + static_cast<size_t>(u) * W * W * B + lane;
    // the plane stride, opaque to the compiler: hoisted out of the run loop
    // its w^2 multiples would be as many live registers, and spill
    size_t Br = B;
    asm volatile("" : "+l"(Br));
    T drive = T(0);
    if (ln.active) {                   // the run's rows and drive, read once
      const T* p1u = p1 + static_cast<size_t>(u) * W * B + lane;
      const T* p2u = p2h + static_cast<size_t>(u) * W * B + lane;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        q1[i] = p1u[i * Br];
        q2[i] = p2u[i * Br];
      }
      if (ln.driven) drive = drv[static_cast<size_t>(bucket) * Br + lane];
      if constexpr (V == kRegisters) {
#pragma unroll
        for (int k = 0; k < W * W; ++k) e[k] = Eu[k * Br];
      } else if constexpr (V == kShared) {
#pragma unroll
        for (int k = 0; k < W * W; ++k) copy_async(Es + k, Eu + k * Br);
        wait_async();
      }
    }
    for (int s = s0; s < s1; ++s) {
      // the stream variant's E addresses, opaque to the compiler likewise
      const T* Eseg = Eu;
      size_t Bseg = B;
      if constexpr (V == kStream) asm volatile("" : "+l"(Eseg), "+l"(Bseg));
      const T sn = synth<T, W>(y, tw, drive, pv, ln, tf_col, tf_coef);
      if (ln.active) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          T acc = T(0);
#pragma unroll
          for (int j = 0; j < W; ++j) {
            T eij;
            if constexpr (V == kRegisters) eij = e[i * W + j];
            else if constexpr (V == kShared) eij = Es[i * W + j];
            else eij = Eseg[(i * W + j) * Bseg];
            acc = real::fma(eij, y[j], acc);
          }
          a[i] = real::fma(q1[i], sn, acc);
        }
      }
      const T sa = synth<T, W>(a, tw, drive, pv + span, ln, tf_col, tf_coef);
      if (ln.active) {
        const T d = sa - sn;
#pragma unroll
        for (int i = 0; i < W; ++i) y[i] = real::fma(q2[i], d, a[i]);
        const int slot = __ldg(out_slot + s);
        if (slot >= 0) {
          T* out = ys + static_cast<size_t>(slot) * W * B + lane;
#pragma unroll
          for (int i = 0; i < W; ++i) out[i * B] = y[i];
        }
      }
    }
  }
}

template <typename T, int W, int V>
int launch(const void* const* in, void* ys, int n_init, int n_runs, int N, int P,
           int members, cudaStream_t stream) {
  const int span = members * N;
  const int threads = (span + 31) / 32 * 32;
  const size_t shared = (2 + (V == kShared ? kStride<W> : 0)) * static_cast<size_t>(span)
                        * sizeof(T);
  if (members < 1 || threads > kMaxThreads || shared > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = etd2rk_scan_kernel<T, W, V>;
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int blocks = (P + members - 1) / members;
  kernel<<<blocks, threads, shared, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const int*>(in[8]), static_cast<const int*>(in[9]),
      static_cast<const int*>(in[10]), static_cast<const T*>(in[11]),
      static_cast<const T*>(in[12]), static_cast<const int*>(in[13]),
      static_cast<const int*>(in[14]), static_cast<const int*>(in[15]),
      static_cast<T*>(ys),
      n_init, n_runs, N, P, members);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `in` holds 16 device pointers, in the kernel's order: E, p1, p2h, y0, drv,
// A, ts, totw, driven, tf_ptr, tf_col, tf_coef, tf_deg, runs, out_slot,
// init_slots (int arrays int32, the rest in the entry's type). `variant` is 0
// (registers: w <= 8 in float32, w <= 6 in float64), 1 (shared) or 2
// (stream, both for the wider blocks); `members` whole members a block.
// Writes ys (T, w, B). Launches on `stream` without synchronising and
// returns the first CUDA error code (0 on success).
#define ETD2RK_CASE(T, W, V)                                                      \
  if (w == W && variant == V)                                                     \
    return launch<T, W, V>(in, ys, n_init, n_runs, N, P, members,                 \
                           static_cast<cudaStream_t>(stream));
#define ETD2RK_REGS(T, W) ETD2RK_CASE(T, W, kRegisters)
#define ETD2RK_WIDE(T, W) ETD2RK_CASE(T, W, kShared) ETD2RK_CASE(T, W, kStream)
extern "C" int etd2rk_scan_f32(const void* const* in, void* ys, int w, int variant,
                               int members, int n_init, int n_runs, int N, int P,
                               void* stream) {
  ETD2RK_REGS(float, 2) ETD2RK_REGS(float, 3) ETD2RK_REGS(float, 4)
  ETD2RK_REGS(float, 5) ETD2RK_REGS(float, 6) ETD2RK_REGS(float, 7)
  ETD2RK_REGS(float, 8)
  ETD2RK_WIDE(float, 9) ETD2RK_WIDE(float, 10) ETD2RK_WIDE(float, 11)
  ETD2RK_WIDE(float, 12) ETD2RK_WIDE(float, 13) ETD2RK_WIDE(float, 14)
  ETD2RK_WIDE(float, 15) ETD2RK_WIDE(float, 16) ETD2RK_WIDE(float, 17)
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int etd2rk_scan_f64(const void* const* in, void* ys, int w, int variant,
                               int members, int n_init, int n_runs, int N, int P,
                               void* stream) {
  ETD2RK_REGS(double, 2) ETD2RK_REGS(double, 3) ETD2RK_REGS(double, 4)
  ETD2RK_REGS(double, 5) ETD2RK_REGS(double, 6)
  ETD2RK_WIDE(double, 7) ETD2RK_WIDE(double, 8)
  ETD2RK_WIDE(double, 9) ETD2RK_WIDE(double, 10) ETD2RK_WIDE(double, 11)
  ETD2RK_WIDE(double, 12) ETD2RK_WIDE(double, 13) ETD2RK_WIDE(double, 14)
  ETD2RK_WIDE(double, 15) ETD2RK_WIDE(double, 16) ETD2RK_WIDE(double, 17)
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef ETD2RK_WIDE
#undef ETD2RK_REGS
#undef ETD2RK_CASE

extern "C" const char* etd2rk_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
