// The whole ETD2RK segment scan of the population objective in one launch,
// float32 and float64, block widths 2 <= w <= 129 (the widest tables), a
// member of up to 6,144 proteins (8,192 where its state fits shared
// memory). For each segment s of the static plan,
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
//
// Past w = 17 or N = 256: the wide kernel (etd2rk_scan_wide_kernel, three
// variants of one template a type, w at run time). What bounds it there.
// A lane's state is 2w words and its E rows w^2: at w = 65 the state alone
// is 130 floats, past what a thread holds in registers, and a member's E
// rows (16.9 KB a lane in float32 at w = 65, 66.6 KB at w = 129, twice that
// in float64) outgrow a block's 227 KB at w = 129 for any member. Read
// once, the tables are still the bytes bound (U (w^2 + 2w) B floats: 4.05
// ms at w = 129, B = 14,336, U = 14); streamed at every segment they are
// S / U ~ 10 times that. A member of more than 256 proteins (a thread a
// lane in the template) or of more than fits one block's shared memory
// needs its totals exchanged between blocks twice a segment.
// What the design does about it:
//   * a lane's rows of E y are split over `group` threads of one warp (a
//     power of two, about 4 rows a thread, up to 32): the thread of rank g
//     owns rows g, g + group, ...; each takes its rows two or four at a time
//     (register tiles; y read once a tile) over the same fmaf chain in j as
//     the template's. Its partial totals meet by xor shuffles; y, a, the
//     run's p1 and p2h rows and the totals' weights sit in shared memory
//     (y_lane words a lane, odd), so a thread's rows read every y_j there
//     and a segment reads from device memory only E, where E is streamed,
//     and the TF rows; each lane's synthesis constants and TF row bounds
//     sit there too. (Read from device memory at every segment, through
//     an L1 that the run's copies overwrite, they were a chain of
//     dependent loads a row.)
//   * wide-shared: a run's E rows in shared memory, each lane's rows e_row
//     (odd) words apart and lanes e_lane apart, e_lane = group * e_row mod
//     32, so that a warp's 32 threads, thread (g, lq) reading row g of lane
//     lq, hit 32 banks; copied with cp.async by the whole block at the
//     run's first segment, consecutive threads on consecutive lanes of an
//     entry (the run's first barrier orders them), so every table is read
//     once. A member whose lanes do not fit one block spans
//     a cluster of up to 8 blocks (thread block clusters): each block holds
//     `lanes` of its proteins and their E rows, and the member's totals are
//     read across the cluster's shared memory (distributed shared memory,
//     protein c in block c / lanes) after a cluster barrier in place of the
//     block's. Model 2 at 7 sites (w = 129, N = 7) takes a cluster of 3
//     blocks (3 lanes, 203 KB each) in float32 and of 7 (a lane each, 135
//     KB) in float64.
//   * wide-stream: where even 8 blocks cannot hold a member's E rows, E is
//     read from device memory at every segment, `group` at most the item
//     size so that a warp reads whole 32-byte sectors; the state stays in
//     shared memory.
//   * wide-global: where the state does not fit either (w >= 33 at N =
//     4,096), y and a live in device memory (2 w B words the wrapper
//     allocates), and p1, p2h and the weights are read from it, through
//     L1; only the totals and the constants sit in shared memory.
// A cluster's blocks run the same plan, so every barrier is reached by all
// of them; a block leaves only after a last cluster barrier, once no other
// block reads its totals. Each thread reads only its own member's totals,
// so a non-finite member changes no other member's values; the driven
// override is a select, as in the template. The launch bound is 1,024
// threads (64 registers), 768 for wide-global, whose float64 build spills
// at 64; ptxas reports no spill in any of the six builds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "real.cuh"

namespace cg = cooperative_groups;

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

// The rational synthesis rate of a lane whose TF matvec is `acc`.
template <typename T>
__device__ __forceinline__ T rate(T acc, T deg, T amp, T tsc) {
  const T x = acc / deg;
  const T u = x / (T(1) + real::abs(x));
  const T act = amp * (T(1) + (tsc * u) / ((T(1) + u) + T(1e-6)));
  const T rep = amp / (T(1) + tsc * real::abs(u));
  return u >= T(0) ? act : rep;
}

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
  return rate(acc, ln.deg, ln.amp, ln.tsc);
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

// The wide kernel: every shape past the template's (w >= 18, or N > 256),
// w at run time up to 129, a member in one block or over a cluster of up to
// 8. `group` threads (a power of two) share a lane: the thread of rank g
// owns rows g, g + group, ... of E y, a warp holds Q = 32 / group lanes,
// thread (g, lq) at g * Q + lq, and the group's partial totals meet by
// shuffles. A block's shared memory, by lane: the two Pv buffers and the
// synthesis constants (amplitude, TF scale, the TF normaliser; the TF
// row's bounds as ints at the end); then, but in wide-global, y, a, the
// run's p1 and p2h rows and the totals' weights, y_lane words each; then,
// in wide-shared, the run's E rows (lane stride e_lane, row stride e_row).
// wide-global keeps y and a in `state` (2 w B words, slot stride B) and
// reads p1, p2h and the weights from device memory.
constexpr int kWideMaxWidth = 129;
constexpr int kWideMaxThreads = 1024;
constexpr int kMaxCluster = 8;

enum WideVariant { kWideShared = 3, kWideStream = 4, kWideGlobal = 5 };

// A thread's lane.
struct WideLane {
  bool active;
  bool driven;
  int l, g;            // the lane in the block; the thread's rank in the lane's group
  int base;            // one block a member or more: the member's first slot in a Pv buffer
};

// Rows a thread takes at once in E y: four where E sits in shared memory
// in float32, two where it is streamed or in float64 (fewer live registers).
template <typename T, int V>
constexpr int kWideTile = sizeof(T) == 4 && V == kWideShared ? 4 : 2;

// The block-wide (or, in a cluster, cluster-wide) barrier of a synthesis.
__device__ __forceinline__ void wide_barrier(int cluster) {
  if (cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// g of one lane from its group's partial totals `part` (each thread's rows
// but row 0). Every thread of the block calls it. A member's Pv sits in its
// block's buffer, or in a cluster at protein c's block (c / lanes), slot
// c % lanes, read through distributed shared memory. `cst` and `rows` are
// the block's synthesis constants and TF row bounds.
template <typename T>
__device__ __forceinline__ T synth_wide(T part, T drive, T* buf, const WideLane& ln, int Q,
                                        int lanes, int cluster, const T* cst, const int* rows,
                                        const int* __restrict__ tf_col,
                                        const T* __restrict__ tf_coef) {
  for (int off = Q; off < 32; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (ln.active && ln.g == 0) buf[ln.l] = ln.driven ? drive : part;
  wide_barrier(cluster);
  if (!ln.active) return T(0);
  T acc = T(0);
  const int row_beg = rows[ln.l], row_end = rows[lanes + ln.l];
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    for (int k = row_beg; k < row_end; ++k) {
      const int c = __ldg(tf_col + k);
      acc = real::fma(__ldg(tf_coef + k), *cl.map_shared_rank(buf + c % lanes, c / lanes), acc);
    }
  } else {
    for (int k = row_beg; k < row_end; ++k)
      acc = real::fma(__ldg(tf_coef + k), buf[ln.base + __ldg(tf_col + k)], acc);
  }
  return rate(acc, cst[2 * lanes + ln.l], cst[ln.l], cst[lanes + ln.l]);
}

// R of the thread's rows (i, i + group, ...) of a = E y + p1 g: written to
// the lane's a, their weighted sum added to `part`, the same fmaf chains
// over j as the template kernel's. Each of y, a, p1 and the weights is a
// base and a step between rows (1 in shared memory).
template <typename T, int V, int R>
__device__ __forceinline__ T wide_rows(int i, int group, int w, const T* Eu, const T* Es,
                                       int e_row, const T* Y, T* Aa, size_t ystep,
                                       const T* Q1, size_t qstep, const T* TW, size_t twstep,
                                       size_t B, T sn, T part) {
  const size_t estep = V == kWideShared ? 1 : B;
  const T* e[R];
  T c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = i + r * group;
    e[r] = V == kWideShared ? Es + row * e_row : Eu + static_cast<size_t>(row) * w * B;
    c[r] = T(0);
  }
#pragma unroll(V == kWideShared ? 4 : 2)
  for (int j = 0; j < w; ++j) {
    const T yj = Y[j * ystep];
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = real::fma(e[r][j * estep], yj, c[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = i + r * group;
    const T a = real::fma(Q1[row * qstep], sn, c[r]);
    Aa[row * ystep] = a;
    if (row > 0) part = real::fma(TW[row * twstep], a, part);
  }
  return part;
}

// Threads a block at most, by variant: the wide-global float64 build holds
// the state's addresses beside the float64 values, and spills at 64
// registers a thread, so that variant stops at 768 threads (80 registers).
template <int V>
constexpr int kWideThreads = V == kWideGlobal ? 768 : kWideMaxThreads;

template <typename T, int V>
__global__ void __launch_bounds__(kWideThreads<V>, 1)
etd2rk_scan_wide_kernel(const T* __restrict__ E, const T* __restrict__ p1,
                        const T* __restrict__ p2h, const T* __restrict__ y0,
                        const T* __restrict__ drv, const T* __restrict__ A,
                        const T* __restrict__ ts, const T* __restrict__ totw,
                        const int* __restrict__ driven, const int* __restrict__ tf_ptr,
                        const int* __restrict__ tf_col, const T* __restrict__ tf_coef,
                        const T* __restrict__ tf_deg, const int* __restrict__ runs,
                        const int* __restrict__ out_slot, const int* __restrict__ init_slots,
                        T* __restrict__ ys, T* state, int w, int n_init, int n_runs, int N,
                        int P, int members, int lanes, int group, int cluster, int e_lane,
                        int e_row, int y_lane) {
  constexpr bool kSharedState = V != kWideGlobal;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const pv = reinterpret_cast<T*>(smem_raw);       // 2 x lanes
  T* const cst = pv + 2 * lanes;                      // 3 x lanes
  T* const lane_words = cst + 3 * lanes;              // y, a, p1, p2h, weights; then E
  const int ly = kSharedState ? lanes * y_lane : 0;
  int* const rows = reinterpret_cast<int*>(
      lane_words + 5 * ly + (V == kWideShared ? lanes * e_lane : 0));   // 2 x lanes
  const int Q = 32 / group;
  const int t = threadIdx.x;
  const size_t B = static_cast<size_t>(P) * N;
  WideLane ln;
  ln.g = (t & 31) / Q;
  ln.l = (t >> 5) * Q + (t & 31) % Q;
  size_t first;
  int count;
  if (cluster > 1) {          // one member a cluster, `lanes` proteins a block
    const int rank = static_cast<int>(blockIdx.x) % cluster;
    first = static_cast<size_t>(blockIdx.x / cluster) * N + static_cast<size_t>(rank) * lanes;
    count = min(lanes, N - rank * lanes);
  } else {                    // `members` whole members a block
    first = static_cast<size_t>(blockIdx.x) * members * N;
    count = static_cast<int>(min(static_cast<size_t>(lanes), B - first));
  }
  ln.active = ln.l < count;
  ln.base = (ln.l / N) * N;
  const size_t lane = first + ln.l;
  const int q = static_cast<int>(lane % N);
  // this lane's y, a, p1, p2h and weights: shared (step 1) or device memory
  T* const sq1 = lane_words + 2 * ly + ln.l * y_lane;   // shared state: p1, then p2h, weights
  T* const sq2 = sq1 + ly;
  T* const stw = sq2 + ly;
  T* Y;
  T* Aa;
  const T* Q1;
  const T* Q2;
  const T* TW;
  size_t ystep, qstep, twstep;
  if constexpr (kSharedState) {
    Y = lane_words + ln.l * y_lane;
    Aa = Y + ly;
    Q1 = sq1;
    Q2 = sq2;
    TW = stw;
    ystep = qstep = twstep = 1;
  } else {
    Y = state + lane;
    Aa = state + static_cast<size_t>(w) * B + lane;
    Q1 = Q2 = nullptr;                                 // the run's, below
    TW = totw + q;
    ystep = qstep = B;
    twstep = N;
  }
  T* const Es0 = lane_words + 5 * ly;                  // wide-shared: E of lane 0
  T* const Es = Es0 + ln.l * e_lane;
  // the block's copy of a run's rows: thread t's first entry (j, lane) of a
  // row, and its stride over the row's w x count entries
  const int copy_j = t / count, copy_l = t % count;
  const int copy_dj = static_cast<int>(blockDim.x) / count;
  const int copy_dl = static_cast<int>(blockDim.x) % count;

  T part = T(0);
  ln.driven = false;
  if (ln.active) {
    ln.driven = driven[q] != 0;
    if (ln.g == 0) {          // read by the group after the first barrier
      cst[ln.l] = A[lane];
      cst[lanes + ln.l] = ts[lane];
      cst[2 * lanes + ln.l] = tf_deg[q];
      rows[ln.l] = tf_ptr[q];
      rows[lanes + ln.l] = tf_ptr[q + 1];
    }
    for (int i = ln.g; i < w; i += group) {
      const T yi = y0[i * B + lane];
      const T twi = totw[i * N + q];
      Y[i * ystep] = yi;
      if constexpr (kSharedState) stw[i] = twi;
      if (i > 0) part = real::fma(twi, yi, part);
      for (int k = 0; k < n_init; ++k)
        ys[(static_cast<size_t>(init_slots[k]) * w + i) * B + lane] = yi;
    }
  }

  const size_t wB = static_cast<size_t>(w) * B;
  for (int r = 0; r < n_runs; ++r) {
    const int s0 = __ldg(runs + 4 * r), s1 = s0 + __ldg(runs + 4 * r + 1);
    const int u = __ldg(runs + 4 * r + 2), bucket = __ldg(runs + 4 * r + 3);
    const T* const Eu = E + static_cast<size_t>(u) * w * wB + lane;
    const T* const p1u = p1 + static_cast<size_t>(u) * wB + lane;
    const T* const p2u = p2h + static_cast<size_t>(u) * wB + lane;
    T drive = T(0);
    if (ln.active && ln.driven) drive = drv[static_cast<size_t>(bucket) * B + lane];
    if constexpr (kSharedState) {
      // the run's p1 and p2h rows, each thread its own (it alone reads them)
      if (ln.active) {
        for (int i = ln.g; i < w; i += group) {
          copy_async(sq1 + i, p1u + i * B);
          copy_async(sq2 + i, p2u + i * B);
        }
      }
    } else {
      Q1 = p1u;
      Q2 = p2u;
    }
    if constexpr (V == kWideShared) {
      // the run's E rows, read once, by the whole block: consecutive threads
      // on consecutive lanes of one entry (the block's lanes are contiguous
      // in E), so that a warp reads a few sectors, not one an entry. The
      // last reads of the previous run's rows came before the last
      // barrier, and the first barrier of the run's first segment comes
      // before the next.
      for (int i = 0; i < w; ++i) {
        const T* src = E + (static_cast<size_t>(u) * w + i) * wB + first;
        int j = copy_j, l = copy_l;
        while (j < w) {
          copy_async(Es0 + l * e_lane + i * e_row + j, src + static_cast<size_t>(j) * B + l);
          j += copy_dj;
          l += copy_dl;
          if (l >= count) {
            l -= count;
            ++j;
          }
        }
      }
    }
    if constexpr (kSharedState) wait_async();
    for (int s = s0; s < s1; ++s) {
      const T sn = synth_wide(part, drive, pv, ln, Q, lanes, cluster, cst, rows, tf_col,
                              tf_coef);
      T part_a = T(0);
      if (ln.active) {
        // the thread's rows in tiles of kWideTile, then of 2, then one
        constexpr int R = kWideTile<T, V>;
        int i = ln.g;
        for (; i + (R - 1) * group < w; i += R * group)
          part_a = wide_rows<T, V, R>(i, group, w, Eu, Es, e_row, Y, Aa, ystep, Q1, qstep, TW,
                                      twstep, B, sn, part_a);
        if constexpr (R > 2) {
          if (i + group < w) {
            part_a = wide_rows<T, V, 2>(i, group, w, Eu, Es, e_row, Y, Aa, ystep, Q1, qstep,
                                        TW, twstep, B, sn, part_a);
            i += 2 * group;
          }
        }
        if (i < w)
          part_a = wide_rows<T, V, 1>(i, group, w, Eu, Es, e_row, Y, Aa, ystep, Q1, qstep, TW,
                                      twstep, B, sn, part_a);
      }
      const T sa = synth_wide(part_a, drive, pv + lanes, ln, Q, lanes, cluster, cst, rows,
                              tf_col, tf_coef);
      part = T(0);
      if (ln.active) {
        const T d = sa - sn;
        const int slot = __ldg(out_slot + s);
        for (int i = ln.g; i < w; i += group) {
          const T yi = real::fma(Q2[i * qstep], d, Aa[i * ystep]);
          Y[i * ystep] = yi;
          if (i > 0) part = real::fma(TW[i * twstep], yi, part);
          if (slot >= 0) ys[(static_cast<size_t>(slot) * w + i) * B + lane] = yi;
        }
      }
    }
  }
  if (cluster > 1) cg::this_cluster().sync();   // no block leaves while another reads its Pv
}

template <typename T, int V>
int launch_wide(const void* const* in, void* ys, int w, int members, int n_init, int n_runs,
                int N, int P, int lanes, int group, int cluster, int e_lane, int e_row,
                int y_lane, cudaStream_t stream) {
  // the wrapper's shape (ops/scan_kernel.py::scan_launch_shape, wide_layout)
  const bool whole = cluster == 1 && members >= 1 && lanes == members * N;
  const bool split = cluster > 1 && cluster <= kMaxCluster && members == 1 && lanes >= 1
                     && (cluster - 1) * lanes < N && cluster * lanes >= N;
  if (w < 2 || w > kWideMaxWidth || N < 1 || P < 1 || group < 1 || group > 32
      || (group & (group - 1)) || !(whole || split)
      || (V != kWideGlobal && y_lane < w)
      || (V == kWideShared && (e_row < w || e_lane < (w - 1) * e_row + w))
      || (V == kWideGlobal && in[16] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Q = 32 / group;
  const long threads = (lanes + Q - 1L) / Q * 32L;
  const size_t words = 5 + (V != kWideGlobal ? 5 * static_cast<size_t>(y_lane) : 0)
                       + (V == kWideShared ? static_cast<size_t>(e_lane) : 0);
  const size_t shared = (words * sizeof(T) + 2 * sizeof(int)) * lanes;
  if (threads > kWideThreads<V> || shared > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = etd2rk_scan_wide_kernel<T, V>;
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster > 1 ? static_cast<unsigned>(P) * cluster
                                 : static_cast<unsigned>((P + members - 1) / members));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = shared;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const int*>(in[8]), static_cast<const int*>(in[9]),
      static_cast<const int*>(in[10]), static_cast<const T*>(in[11]),
      static_cast<const T*>(in[12]), static_cast<const int*>(in[13]),
      static_cast<const int*>(in[14]), static_cast<const int*>(in[15]),
      static_cast<T*>(ys), static_cast<T*>(const_cast<void*>(in[16])), w, n_init, n_runs, N,
      P, members, lanes, group, cluster, e_lane, e_row, y_lane);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <typename T>
int launch_wide_variant(int variant, const void* const* in, void* ys, int w, int members,
                        int n_init, int n_runs, int N, int P, int lanes, int group,
                        int cluster, int e_lane, int e_row, int y_lane, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kWideShared:
      return launch_wide<T, kWideShared>(in, ys, w, members, n_init, n_runs, N, P, lanes,
                                         group, cluster, e_lane, e_row, y_lane, s);
    case kWideStream:
      return launch_wide<T, kWideStream>(in, ys, w, members, n_init, n_runs, N, P, lanes,
                                         group, cluster, e_lane, e_row, y_lane, s);
    case kWideGlobal:
      return launch_wide<T, kWideGlobal>(in, ys, w, members, n_init, n_runs, N, P, lanes,
                                         group, cluster, e_lane, e_row, y_lane, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// `in` holds 17 device pointers, in the kernels' order: E, p1, p2h, y0, drv,
// A, ts, totw, driven, tf_ptr, tf_col, tf_coef, tf_deg, runs, out_slot,
// init_slots (int arrays int32, the rest in the entry's type), then the
// wide-global variant's state (2 w B words; null otherwise). `variant` is 0
// (registers: w <= 8 in float32, w <= 6 in float64), 1 (shared) or 2
// (stream), the template kernel for w <= 17 and N <= 256, `members` whole
// members a block; or 3 (wide-shared), 4 (wide-stream) or 5 (wide-global),
// the wide kernel, with `lanes` a block, `group` threads a lane, `cluster`
// blocks a member (1: `members` whole members a block) and the shared
// layout's strides in words (ops/scan_kernel.py::scan_launch_shape and
// wide_layout). Writes ys (T, w, B). Launches on `stream` without
// synchronising and returns the first CUDA error code (0 on success).
#define ETD2RK_CASE(T, W, V)                                                      \
  if (w == W && variant == V)                                                     \
    return launch<T, W, V>(in, ys, n_init, n_runs, N, P, members,                 \
                           static_cast<cudaStream_t>(stream));
#define ETD2RK_REGS(T, W) ETD2RK_CASE(T, W, kRegisters)
#define ETD2RK_WIDE(T, W) ETD2RK_CASE(T, W, kShared) ETD2RK_CASE(T, W, kStream)
#define ETD2RK_ARGS                                                                \
  const void* const* in, void* ys, int w, int variant, int members, int n_init,   \
      int n_runs, int N, int P, int lanes, int group, int cluster, int e_lane,     \
      int e_row, int y_lane, void* stream
extern "C" int etd2rk_scan_f32(ETD2RK_ARGS) {
  if (variant >= kWideShared)
    return launch_wide_variant<float>(variant, in, ys, w, members, n_init, n_runs, N, P,
                                      lanes, group, cluster, e_lane, e_row, y_lane, stream);
  ETD2RK_REGS(float, 2) ETD2RK_REGS(float, 3) ETD2RK_REGS(float, 4)
  ETD2RK_REGS(float, 5) ETD2RK_REGS(float, 6) ETD2RK_REGS(float, 7)
  ETD2RK_REGS(float, 8)
  ETD2RK_WIDE(float, 9) ETD2RK_WIDE(float, 10) ETD2RK_WIDE(float, 11)
  ETD2RK_WIDE(float, 12) ETD2RK_WIDE(float, 13) ETD2RK_WIDE(float, 14)
  ETD2RK_WIDE(float, 15) ETD2RK_WIDE(float, 16) ETD2RK_WIDE(float, 17)
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int etd2rk_scan_f64(ETD2RK_ARGS) {
  if (variant >= kWideShared)
    return launch_wide_variant<double>(variant, in, ys, w, members, n_init, n_runs, N, P,
                                       lanes, group, cluster, e_lane, e_row, y_lane, stream);
  ETD2RK_REGS(double, 2) ETD2RK_REGS(double, 3) ETD2RK_REGS(double, 4)
  ETD2RK_REGS(double, 5) ETD2RK_REGS(double, 6)
  ETD2RK_WIDE(double, 7) ETD2RK_WIDE(double, 8)
  ETD2RK_WIDE(double, 9) ETD2RK_WIDE(double, 10) ETD2RK_WIDE(double, 11)
  ETD2RK_WIDE(double, 12) ETD2RK_WIDE(double, 13) ETD2RK_WIDE(double, 14)
  ETD2RK_WIDE(double, 15) ETD2RK_WIDE(double, 16) ETD2RK_WIDE(double, 17)
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef ETD2RK_ARGS
#undef ETD2RK_WIDE
#undef ETD2RK_REGS
#undef ETD2RK_CASE

extern "C" const char* etd2rk_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
