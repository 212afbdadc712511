// The whole ETD2RK segment scan of the population objective in one launch,
// float32 and float64, every block width w >= 2 the tables take (the wide
// kernel streams a run's E rows past w = 129), a member of up to 16,384
// proteins. For each segment s of the static plan,
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
//     registers (w^2 + 2w <= 80 floats beside y, a and tw); the w = 6
//     float32 build spills 52 bytes (below), no other register build.
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
// Past w = 17 or N = 256. What bounds it there: a lane's state is 2w
// words and its E rows w^2: at w = 65 the state alone is 130 floats, past
// what a thread holds in registers, and a member's E rows (16.9 KB a lane
// in float32 at w = 65, 66.6 KB at w = 129, twice that in float64) outgrow
// a block's 227 KB at w = 129 for any member. Read once, the tables are
// still the bytes bound (U (w^2 + 2w) B floats: 4.09 ms at w = 129, B =
// 14,336, U = 14); E y needs one shared-memory word an FMA, 32 a cycle an
// SM, which is ~4.3 ms there. The first wide kernel ran at 0.03-0.13
// of the bytes bound (tools/phase_clocks.py --kernel scan): at w = 129 an
// SM held 3 lanes in 3 warps (float64: 1 lane, 1 warp), so E y ran at a
// quarter of shared memory's rate and nothing hid a synthesis's cluster
// barrier, its TF rows read from device memory and its divisions; a run's
// copy, 4-byte words waited for in full, moved ~3 bytes a cycle an SM.
// What this design does about each, in three regimes chosen by (w, N,
// type) alone (ops/scan_kernel.py::scan_launch_shape):
//   * wide-shared: a run's E rows, the state and the run's p1, p2h rows in
//     shared memory. A lane's rows are split over `group` threads (a power
//     of two up to 32: the thread of rank g owns rows g, g + group, ...), and
//     where a lane takes a whole warp and its rows are more than 3 a
//     thread (w >= 97), its columns over `cols` warps (2, 4 or 8), the
//     fewest that give an SM 8 warps (w = 129: 12 warps of 3 lanes in
//     float32, 8 warps of one lane in float64, against 3 and 1); each
//     warp's partial rows meet in shared memory after a block barrier (at
//     w = 65 a second column warp measured slower). Each E word is read
//     once a segment, from a lane layout whose rows are e_row (odd) words
//     apart and lanes e_lane apart (e_lane = group * e_row mod 32), so that
//     a warp's 32 threads hit 32 banks.
//     The copy of a run's rows is 4- or 8-byte cp.async words, issued by
//     every thread of the block, consecutive threads on consecutive lanes
//     of an entry, at the run's start, into one E buffer, and waited for
//     (with the run's p1 and p2h rows) before its first barrier. At w = 129
//     neither the tensor memory accelerator nor 16-byte copies fit E's
//     layout (U, w, w, B), lanes last: a block's lanes of one entry are 12
//     bytes (3 lanes) and 8 in float64 (1 lane), while a TMA box's inner
//     extent and a 16-byte copy take 16 bytes of lanes, 4 lanes' rows that
//     do not fit the 227 KB; and a box lands entries major, lanes minor, a
//     layout in which a lane's rows split over a warp's threads read 4-8
//     threads to a bank. At w = 22 (120 bytes of lanes an entry) and w = 65
//     (24) part of each entry's span is 16-byte aligned; 16-byte copies of
//     that part, with a 4- or 8-byte head and tail, were not tried. What
//     speeds the copy at w = 129 is the warps that issue it (float64: 8
//     warps in place of 1, a third of the cycles). Issuing the next run's
//     rows right after the run's last E y, into the one buffer, measured no
//     better than at the run's start and was not kept.
//   * wide-stream: where even a cluster cannot hold a member's E rows, E
//     is read from device memory at every segment, `group` at most the
//     item size so that a warp reads whole 32-byte sectors; the state stays
//     in shared memory. Past w = 129 (every w the stream table kernel
//     takes: a lane's rows are 257 / 4 = 64 a thread at w = 257 in
//     float32) a block holds one member and a lane's columns go over
//     `cols` warps (up to 8) as in wide-shared, so that the card has warps
//     enough to keep its reads of E in flight.
//   * wide-global: where the state does not fit either, y and a live in
//     device memory (2 w B words the wrapper allocates) and p1, p2h and the
//     weights are read from it; a thread a lane, or `per` lanes a thread
//     (up to 4) where a block's lanes outnumber its 512 threads, their sn
//     and drive in shared memory; members past 6,144 proteins, up to
//     16,384, land here over a cluster of 8 blocks of up to 2,048 lanes.
// The syntheses: a lane's TF row, columns and coefficients, are copied into
// shared memory once a launch where they fit beside the block's other words
// without lowering its blocks an SM (`tf_cap` words; else read from device
// memory). A member's totals Pv sit in two buffers that alternate (g(y),
// g(a)), each lane's as `cols` partials (a warp's each), written where they
// are made (the end of E y, of the update); a driven lane writes 0 there
// and its drive at the synthesis, a select. A member in one block reads
// them after __syncthreads(). A member over a cluster of up to 8 blocks
// (thread block clusters): where every block holds a copy of the whole
// member's totals (`push`), each block, after its own barrier, sends its
// lanes' slice to every other block with one bulk copy each
// (cp.async.bulk shared::cta -> shared::cluster), which completes on the
// receiver's mbarrier for that buffer, and waits only for its own mbarrier:
// a one-way signal in place of the cluster barrier, and the TF gathers read
// local shared memory. Two buffers suffice: a block sends into a buffer
// again only after every other block's next-buffer slice has arrived,
// which each sends after its own barrier, after its reads of the first.
// Where the copies do not fit (a member of thousands of proteins), the
// block keeps its slice and, after a cluster barrier, the gathers read the
// other blocks' slices through distributed shared memory. A cluster's
// blocks run the same plan; a block leaves only after a last cluster
// barrier, once no copy to or from it is in flight and no block reads its
// shared memory. Each thread reads only its own member's totals, so a
// non-finite member changes no other member's values.
// Order of sums: with cols > 1 a row of E y is summed over each warp's
// columns (the same fmaf chain over j) and the warps' partial rows are
// added in warp order; a lane's total is the sum of its warps' partials,
// taken where it is read. The plain version sums each in one pass. The TF
// input is the matvec times the normaliser's reciprocal (the plain version
// divides): one division fewer of a synthesis's four, within an ulp.
// wide-shared has two builds a type: one where a member sits in one block,
// a warp or less a lane and a thread a lane (cols, per and cluster are 1 at
// compile time: at w = 22 the general build's divisions and branches
// measured 5-7% slower), one for the rest; wide-stream and wide-global,
// off the objective's shapes, have the general one. Launch bounds: 512
// threads, two blocks an SM for wide-shared (64 registers), one for
// wide-stream and wide-global (128: wide-stream's float64 build spills at
// 64); ptxas reports no spill in any of the eight builds, and
// chip_smoke.py phase 3i fails on one. Members of 257-320 proteins at
// small w take wide-shared too (one block of a thread a lane at w = 6): the
// template's register variant built at a 320-thread bound measured slower
// on the objective's N = 285 scans (4.19 against 3.83 ms in float32) and
// faster only on plans whose runs are a segment or two long
// (tools/kernel_ab.py tune-scan-wide).

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

// The rational synthesis rate of a lane whose normalised TF input is x.
template <typename T>
__device__ __forceinline__ T rate_of(T x, T amp, T tsc) {
  const T u = x / (T(1) + real::abs(x));
  const T act = amp * (T(1) + (tsc * u) / ((T(1) + u) + T(1e-6)));
  const T rep = amp / (T(1) + tsc * real::abs(u));
  return u >= T(0) ? act : rep;
}

// ... of a lane whose TF matvec is `acc` and normaliser `deg`.
template <typename T>
__device__ __forceinline__ T rate(T acc, T deg, T amp, T tsc) {
  return rate_of(acc / deg, amp, tsc);
}

// The same with the normaliser's reciprocal `rdeg` (the wide kernel: a
// multiplication in place of one of a synthesis's four divisions, within
// an ulp of it).
template <typename T>
__device__ __forceinline__ T rate_scaled(T acc, T rdeg, T amp, T tsc) {
  return rate_of(acc * rdeg, amp, tsc);
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
// w at run time (any w the table kernels take), a member in one block or over a cluster of up to
// 8. A block's shared memory, in order: two
// mbarriers (push); the two Pv buffers (each `cols` partials of
// `lanes_pad` words a block slice, every block's slice where the cluster
// pushes); the synthesis constants (amplitude, TF scale, the TF
// normaliser's reciprocal), 3 words a lane; in wide-global each thread's sn and drive of its `per`
// lanes; but in wide-global, y, a, the run's p1 and p2h rows and the
// totals' weights, y_lane words a lane each; with cols > 1 the warps'
// partial rows, cols y_lane words a lane; in wide-shared the lanes' E rows
// (e_lane words a lane, e_row a row); the staged TF
// coefficients (tf_cap); then as ints the TF row bounds and the driven flag
// (3 a lane) and the staged TF columns (tf_cap).
constexpr int kWideMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kMaxPer = 4;

enum WideVariant { kWideShared = 3, kWideStream = 4, kWideGlobal = 5 };

// The launch shape (ops/scan_kernel.py::scan_launch_shape, wide_layout and
// _launch), passed by value.
struct WideShape {
  int w, members, n_init, n_runs, N, P, lanes, group, cols, per, cluster, push, tf_cap,
      e_lane, e_row, y_lane;
};

// Rows a thread takes at once in E y: four where E sits in shared memory
// in float32, two where it is streamed or in float64 (fewer live registers).
template <typename T, int V>
constexpr int kWideTile = sizeof(T) == 4 && V == kWideShared ? 4 : 2;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// This block's shared address `addr` in the cluster's block `rank`.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// `bytes` (a multiple of 16) of this block's shared memory at `src` into
// another block's at `dst`, completing on that block's mbarrier `bar`.
__device__ __forceinline__ void bulk_to_peer(unsigned dst, unsigned src, unsigned bytes,
                                             unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// acc[r] = the sum over j in [j0, j1) of E[i + r step][j] y[j]: the same
// fmaf chain over j as the template kernel's. E rows erow words apart, an
// entry B apart where E is streamed (1 in shared memory); y at step ystep.
template <typename T, int V, int R>
__device__ __forceinline__ void dot_rows(T (&acc)[R], int i, int step, int j0, int j1,
                                         const T* Eb, size_t erow, size_t B, const T* Y,
                                         size_t ystep) {
  const T* e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    e[r] = Eb + static_cast<size_t>(i + r * step) * erow;
    acc[r] = T(0);
  }
#pragma unroll(V == kWideShared ? 4 : 2)
  for (int j = j0; j < j1; ++j) {
    const T yj = V == kWideGlobal ? Y[j * ystep] : Y[j];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = real::fma(V == kWideShared ? e[r][j] : e[r][j * B], yj, acc[r]);
  }
}

template <typename T, int V, bool kMulti>
__global__ void __launch_bounds__(kWideMaxThreads, V == kWideShared ? 2 : 1)
etd2rk_scan_wide_kernel(const T* __restrict__ E, const T* __restrict__ p1,
                        const T* __restrict__ p2h, const T* __restrict__ y0,
                        const T* __restrict__ drv, const T* __restrict__ A,
                        const T* __restrict__ ts, const T* __restrict__ totw,
                        const int* __restrict__ driven, const int* __restrict__ tf_ptr,
                        const int* __restrict__ tf_col, const T* __restrict__ tf_coef,
                        const T* __restrict__ tf_deg, const int* __restrict__ runs,
                        const int* __restrict__ out_slot, const int* __restrict__ init_slots,
                        T* __restrict__ ys, T* state, const WideShape sh) {
  constexpr bool kSmemState = V != kWideGlobal;
  constexpr int kPad = 16 / static_cast<int>(sizeof(T));
  // kMulti: a member over a cluster, a lane's columns over warps or several
  // lanes a thread; else (whole members a block, a warp or less a lane, a
  // thread a lane) these are constants
  const int w = sh.w, N = sh.N, lanes = sh.lanes, group = sh.group;
  const int cols = kMulti ? sh.cols : 1, per = kMulti ? sh.per : 1;
  const int cluster = kMulti ? sh.cluster : 1, y_lane = sh.y_lane;
  const bool push = kMulti && sh.push;
  const int t = threadIdx.x, threads = blockDim.x;
  const size_t B = static_cast<size_t>(sh.P) * N, wB = static_cast<size_t>(w) * B;

  // shared memory (see above)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* const mbar = reinterpret_cast<unsigned long long*>(smem_raw);
  const int lanes_pad = (lanes + kPad - 1) / kPad * kPad;
  const int slice = cols * lanes_pad;                   // a block's totals in one buffer
  const int pv_words = (push ? cluster : 1) * slice;
  T* const pv = reinterpret_cast<T*>(smem_raw + 16);
  T* const cst = pv + 2 * pv_words;
  T* words = cst + 3 * lanes;
  T* const lane_slots = words;                          // wide-global: sn, then drive
  if constexpr (V == kWideGlobal) words += 2 * per * threads;
  T* const st = words;                                  // y, a, p1, p2h, weights
  if constexpr (kSmemState) words += 5 * lanes * y_lane;
  T* const part_rows = words;                           // cols > 1: the warps' partial rows
  if (cols > 1) words += cols * lanes * y_lane;
  T* const Es0 = words;                                 // wide-shared: E rows
  if constexpr (V == kWideShared) words += lanes * sh.e_lane;
  T* const scoef = words;
  int* const rows = reinterpret_cast<int*>(words + sh.tf_cap);
  int* const scol = rows + 3 * lanes;

  // the thread's lane (per == 1), its rank g among the lane's row threads
  // and its column chunk c; wide-global with per > 1 takes lanes t,
  // t + threads, ...
  // (a lane's `cols` column warps are consecutive warps; wide-shared takes
  // them only at group 32, wide-stream at any group)
  const int Q = group < 32 ? 32 / group : 1;
  int l1, g, c;
  if (group < 32) {
    if constexpr (V == kWideStream) {
      l1 = ((t >> 5) / cols) * Q + (t & 31) % Q;
      c = (t >> 5) % cols;
    } else {
      l1 = (t >> 5) * Q + (t & 31) % Q;
      c = 0;
    }
    g = (t & 31) / Q;
  } else {
    l1 = (t >> 5) / cols;
    c = (t >> 5) % cols;
    g = t & 31;
  }
  // own rows: this, + group * cols, ...
  const int rank_in_lane = V == kWideStream ? c * group + g : c * 32 + g;
  const int own_step = group * cols;

  // the block's lanes: a cluster block's share of one member, or whole members
  int rank = 0, count;
  size_t first;
  if (cluster > 1) {
    rank = static_cast<int>(blockIdx.x) % cluster;
    first = static_cast<size_t>(blockIdx.x / cluster) * N + static_cast<size_t>(rank) * lanes;
    count = min(lanes, N - rank * lanes);
  } else {
    first = static_cast<size_t>(blockIdx.x) * sh.members * N;
    count = static_cast<int>(min(static_cast<size_t>(lanes), B - first));
  }
  const int slice0 = push ? rank * slice : 0;
  const int q_lo = cluster > 1 ? rank * lanes : 0, q_hi = cluster > 1 ? q_lo + count : N;
  const int tf0 = sh.tf_cap ? tf_ptr[q_lo] : 0;
  // the Pv slot of a TF column: the member's protein (after the lane's
  // member base), or in a pushing cluster its place in its block's slice
  auto slot_of = [&](int col) { return push ? (col / lanes) * slice + col % lanes : col; };
  unsigned phase[2] = {0u, 0u};

  if (cluster > 1) {
    if (push && t == 0) {
      mbar_init(mbar, 1);
      mbar_init(mbar + 1, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cg::this_cluster().sync();
  }
  // the TF rows of the block's proteins, once a launch (read after the
  // first synthesis's barrier)
  if (sh.tf_cap) {
    const int nnz = tf_ptr[q_hi] - tf0;
    for (int k = t; k < nnz; k += threads) {
      scol[k] = cluster > 1 && !push ? tf_col[tf0 + k] : slot_of(tf_col[tf0 + k]);
      scoef[k] = tf_coef[tf0 + k];
    }
  }

  auto lane_of = [&](int k) { return per == 1 ? l1 : k * threads + t; };
  // whether an active lane is driven: read by each thread (per == 1: rows'
  // flag is written by another thread of the lane) or from rows (per > 1,
  // a thread a lane)
  bool dvn1 = false;
  auto is_driven = [&](int l) { return per == 1 ? dvn1 : rows[2 * lanes + l] != 0; };
  // a lane's partial total into buffer b: the lane's row threads' sums meet
  // by shuffles; a driven lane writes 0 (its drive goes in at the synthesis)
  auto put = [&](int b, int l, bool act, bool dvn, T part) {
    for (int off = Q; off < 32; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (act && g == 0) pv[b * pv_words + slice0 + c * lanes_pad + l] = dvn ? T(0) : part;
  };
  // the member's total of the protein in TF entry k (its `cols` partials
  // added in order), for a lane whose member starts at `base` (one block a
  // member; 0 in a cluster), from buffer `buf`
  auto total = [&](const T* buf, int k, int base) -> T {
    if (cluster > 1 && !push) {
      const int col = sh.tf_cap ? scol[k] : __ldg(tf_col + k);
      cg::cluster_group cl = cg::this_cluster();
      T v = *cl.map_shared_rank(const_cast<T*>(buf) + col % lanes, col / lanes);
      for (int cc = 1; cc < cols; ++cc)
        v += *cl.map_shared_rank(const_cast<T*>(buf) + col % lanes + cc * lanes_pad,
                                 col / lanes);
      return v;
    }
    const T* s = buf + base + (sh.tf_cap ? scol[k] : slot_of(__ldg(tf_col + k)));
    T v = s[0];
    for (int cc = 1; cc < cols; ++cc) v += s[cc * lanes_pad];
    return v;
  };
  // g of lane l (its member's base `base`) from buffer b, after wide_wait:
  // the TF row's matvec, then the rate with the normaliser's reciprocal
  auto gather = [&](int b, int l, int base) -> T {
    const T* buf = pv + b * pv_words;
    T acc = T(0);
    const int k0 = rows[l], k1 = rows[lanes + l];
    if (sh.tf_cap) {
      for (int k = k0; k < k1; ++k) acc = real::fma(scoef[k], total(buf, k, base), acc);
    } else {
      for (int k = k0; k < k1; ++k) acc = real::fma(__ldg(tf_coef + k), total(buf, k, base), acc);
    }
    return rate_scaled(acc, cst[2 * lanes + l], cst[l], cst[lanes + l]);
  };
  // every block's totals of buffer b in place for the gathers
  auto wide_wait = [&](int b) {
    if (cluster == 1) {
      __syncthreads();
    } else if (!push) {
      cg::this_cluster().sync();
    } else {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      unsigned long long* const bar = mbar + b;
      if (t == 0) {
        const unsigned bytes = static_cast<unsigned>(slice * sizeof(T));
        const unsigned src = smem_u32(pv + b * pv_words + slice0), at = smem_u32(bar);
        mbar_expect_tx(bar, bytes * (cluster - 1));
        for (int r2 = 0; r2 < cluster; ++r2)
          if (r2 != rank) bulk_to_peer(peer_addr(src, r2), src, bytes, peer_addr(at, r2));
      }
      mbar_wait(bar, phase[b]);
      phase[b] ^= 1u;
    }
  };
  // the block's copy of a run's E rows (pair u): consecutive threads on
  // consecutive lanes of one entry
  const int copy_j = t / count, copy_l = t % count;
  const int copy_dj = threads / count, copy_dl = threads % count;
  auto wide_copy_rows = [&](int u) {
    for (int i = 0; i < w; ++i) {
      const T* src = E + (static_cast<size_t>(u) * w + i) * wB + first;
      int j = copy_j, l = copy_l;
      while (j < w) {
        copy_async(Es0 + l * sh.e_lane + i * sh.e_row + j, src + static_cast<size_t>(j) * B + l);
        j += copy_dj;
        l += copy_dl;
        if (l >= count) {
          l -= count;
          ++j;
        }
      }
    }
  };

  // the initial state, the weights, the first snapshots and totals
  for (int k = 0; k < per; ++k) {
    const int l = lane_of(k);
    const bool act = l < count;
    const size_t lane = first + l;
    const int q = act ? static_cast<int>(lane % N) : 0;
    const bool dvn = act && driven[q] != 0;
    T part = T(0);
    if (act) {
      if (rank_in_lane == 0) {
        cst[l] = A[lane];
        cst[lanes + l] = ts[lane];
        cst[2 * lanes + l] = T(1) / tf_deg[q];
        rows[l] = tf_ptr[q] - tf0;
        rows[lanes + l] = tf_ptr[q + 1] - tf0;
        rows[2 * lanes + l] = dvn;
      }
      for (int i = rank_in_lane; i < w; i += own_step) {
        const T yi = y0[i * B + lane], twi = totw[i * N + q];
        if constexpr (kSmemState) {
          st[l * y_lane + i] = yi;
          st[(4 * lanes + l) * y_lane + i] = twi;
        } else {
          state[i * B + lane] = yi;
        }
        if (i > 0) part = real::fma(twi, yi, part);
        for (int n = 0; n < sh.n_init; ++n)
          ys[(static_cast<size_t>(init_slots[n]) * w + i) * B + lane] = yi;
      }
    }
    put(0, l, act, dvn, part);
  }

  if (l1 < count) dvn1 = driven[(first + l1) % N] != 0;
  T drive1 = T(0);                                    // per == 1: the lane's drive
  // a lane's protein and its member's first lane in the block (one block a
  // member), once for per == 1: a division costs ~25 instructions, a
  // tenth of a segment's at w = 22
  const int q1 = static_cast<int>((first + l1) % N), base1 = cluster == 1 ? l1 / N * N : 0;
  auto lane_q = [&](int l) { return per == 1 ? q1 : static_cast<int>((first + l) % N); };
  auto lane_base = [&](int l) { return per == 1 ? base1 : cluster == 1 ? l / N * N : 0; };
  for (int r = 0; r < sh.n_runs; ++r) {
    const int s0 = __ldg(runs + 4 * r), s1 = s0 + __ldg(runs + 4 * r + 1);
    const int u = __ldg(runs + 4 * r + 2), bucket = __ldg(runs + 4 * r + 3);
    const T* const p1u = p1 + static_cast<size_t>(u) * wB;
    const T* const p2u = p2h + static_cast<size_t>(u) * wB;
    // the run's drives, and its p1 and p2h rows (each thread its own rows)
    for (int k = 0; k < per; ++k) {
      const int l = lane_of(k);
      if (l >= count) continue;
      const size_t lane = first + l;
      const T d = is_driven(l) ? drv[static_cast<size_t>(bucket) * B + lane]
                                                           : T(0);
      if constexpr (V == kWideGlobal) {
        lane_slots[(per + k) * threads + t] = d;
      } else {
        drive1 = d;
        for (int i = rank_in_lane; i < w; i += own_step) {
          copy_async(st + (2 * lanes + l) * y_lane + i, p1u + i * B + lane);
          copy_async(st + (3 * lanes + l) * y_lane + i, p2u + i * B + lane);
        }
      }
    }
    if constexpr (V == kWideShared) wide_copy_rows(u);
    for (int s = s0; s < s1; ++s) {
      // --- the first synthesis, g(y)
      if constexpr (kSmemState) {
        if (s == s0) wait_async();
      }
      for (int k = 0; k < per; ++k) {
        const int l = lane_of(k);
        if (l < count && rank_in_lane == 0 && is_driven(l))
          pv[slice0 + l] = V == kWideGlobal ? lane_slots[(per + k) * threads + t] : drive1;
      }
      wide_wait(0);
      // --- E y and a = E y + p1 g(y), its totals into buffer 1
      T sn1 = T(0);
      for (int k = 0; k < per; ++k) {
        const int l = lane_of(k);
        const bool act = l < count;
        const size_t lane = first + l;
        const T sn = act ? gather(0, l, lane_base(l)) : T(0);
        if constexpr (V == kWideGlobal) lane_slots[k * threads + t] = sn;
        else sn1 = sn;
        // the lane's y, a, p1 and weights: shared memory (step 1) or device memory
        const T* Y;
        T* Aa;
        const T* Q1;
        const T* TW;
        size_t ystep, twstep;
        if constexpr (kSmemState) {
          Y = st + l * y_lane;
          Aa = const_cast<T*>(Y) + lanes * y_lane;
          Q1 = Y + 2 * lanes * y_lane;
          TW = Y + 4 * lanes * y_lane;
          ystep = twstep = 1;
        } else {
          Y = state + lane;
          Aa = state + wB + lane;
          Q1 = p1u + lane;
          TW = totw + lane_q(l);
          ystep = B;
          twstep = N;
        }
        const T* const Eb = V == kWideShared
                                ? Es0 + l * sh.e_lane
                                : E + static_cast<size_t>(u) * w * wB + lane;
        const size_t erow = V == kWideShared ? static_cast<size_t>(sh.e_row) : wB;
        constexpr int R = kWideTile<T, V>;
        T part_a = T(0);
        // the thread's rows (g, g + group, ...) in tiles of R, then of 2, then one
        auto row_tiles = [&]() {
            if (act) {
              auto finish = [&](int row, T acc) {
                const T a = real::fma(Q1[row * ystep], sn, acc);
                Aa[row * ystep] = a;
                if (row > 0) part_a = real::fma(TW[row * twstep], a, part_a);
              };
              int i = g;
              for (; i + (R - 1) * group < w; i += R * group) {
                T acc[R];
                dot_rows<T, V, R>(acc, i, group, 0, w, Eb, erow, B, Y, ystep);
  #pragma unroll
                for (int q = 0; q < R; ++q) finish(i + q * group, acc[q]);
              }
              if constexpr (R > 2) {
                if (i + group < w) {
                  T acc[2];
                  dot_rows<T, V, 2>(acc, i, group, 0, w, Eb, erow, B, Y, ystep);
                  finish(i, acc[0]);
                  finish(i + group, acc[1]);
                  i += 2 * group;
                }
              }
              if (i < w) {
                T acc[1];
                dot_rows<T, V, 1>(acc, i, group, 0, w, Eb, erow, B, Y, ystep);
                finish(i, acc[0]);
              }
            }
        };
        if constexpr (V != kWideGlobal) {
          if (cols > 1) {
            // a warp a column chunk (wide-shared, or wide-stream past w =
            // 129): its partial rows (g, g + group, ...) over columns [j0,
            // j1), met in shared memory
            T* const S = part_rows + l * cols * y_lane;
            const int rs = V == kWideShared ? 32 : group;   // a lane's row threads
            if (act) {
              const int j0 = c * w / cols, j1 = (c + 1) * w / cols;
              int i = g;
              for (; i + (R - 1) * rs < w; i += R * rs) {
                T acc[R];
                dot_rows<T, V, R>(acc, i, rs, j0, j1, Eb, erow, B, Y, ystep);
  #pragma unroll
                for (int q = 0; q < R; ++q) S[c * y_lane + i + q * rs] = acc[q];
              }
              for (; i < w; i += rs) {
                T acc[1];
                dot_rows<T, V, 1>(acc, i, rs, j0, j1, Eb, erow, B, Y, ystep);
                S[c * y_lane + i] = acc[0];
              }
            }
            __syncthreads();
            if (act) {
              for (int i = rank_in_lane; i < w; i += own_step) {
                T acc = S[i];
                for (int cc = 1; cc < cols; ++cc) acc += S[cc * y_lane + i];
                const T a = real::fma(Q1[i], sn, acc);
                Aa[i] = a;
                if (i > 0) part_a = real::fma(TW[i], a, part_a);
              }
            }
          } else {
            row_tiles();
          }
        } else {
          row_tiles();
        }
        put(1, l, act, act && is_driven(l), part_a);
      }
      // --- the second synthesis, g(a)
      for (int k = 0; k < per; ++k) {
        const int l = lane_of(k);
        if (l < count && rank_in_lane == 0 && is_driven(l))
          pv[pv_words + slice0 + l] = V == kWideGlobal ? lane_slots[(per + k) * threads + t]
                                                       : drive1;
      }
      wide_wait(1);
      // --- y' = a + p2h (g(a) - g(y)), its totals into buffer 0
      const int slot = __ldg(out_slot + s);
      for (int k = 0; k < per; ++k) {
        const int l = lane_of(k);
        const bool act = l < count;
        const size_t lane = first + l;
        T part = T(0);
        if (act) {
          const T sn = V == kWideGlobal ? lane_slots[k * threads + t] : sn1;
          const T d = gather(1, l, lane_base(l)) - sn;
          const T* Q2;
          const T* Aa;
          const T* TW;
          T* Y;
          size_t ystep, twstep;
          if constexpr (kSmemState) {
            Y = st + l * y_lane;
            Aa = Y + lanes * y_lane;
            Q2 = Y + 3 * lanes * y_lane;
            TW = Y + 4 * lanes * y_lane;
            ystep = twstep = 1;
          } else {
            Y = state + lane;
            Aa = state + wB + lane;
            Q2 = p2u + lane;
            TW = totw + lane_q(l);
            ystep = B;
            twstep = N;
          }
          for (int i = rank_in_lane; i < w; i += own_step) {
            const T yi = real::fma(Q2[i * ystep], d, Aa[i * ystep]);
            Y[i * ystep] = yi;
            if (i > 0) part = real::fma(TW[i * twstep], yi, part);
            if (slot >= 0) ys[(static_cast<size_t>(slot) * w + i) * B + lane] = yi;
          }
        }
        put(0, l, act, act && is_driven(l), part);
      }
    }
  }
  if (cluster > 1) cg::this_cluster().sync();   // no copy in flight, no block reads another's
}

// The threads and shared bytes of a wide launch (ops/scan_kernel.py's
// wide_threads and wide_shared_bytes are the same arithmetic).
template <typename T, int V>
void wide_footprint(const WideShape& sh, long* threads, size_t* shared) {
  const int Q = sh.group < 32 ? 32 / sh.group : 1;
  if (sh.per > 1) *threads = ((sh.lanes + sh.per - 1L) / sh.per + 31L) / 32 * 32;
  else *threads = (sh.lanes + Q - 1L) / Q * 32 * sh.cols;
  const size_t pad = 16 / sizeof(T), lanes = static_cast<size_t>(sh.lanes);
  const size_t lanes_pad = (lanes + pad - 1) / pad * pad;
  size_t words = 2 * static_cast<size_t>(sh.push ? sh.cluster : 1) * sh.cols * lanes_pad
                 + 3 * lanes + sh.tf_cap;
  if (V == kWideGlobal) words += 2 * static_cast<size_t>(sh.per) * *threads;
  else words += 5 * lanes * sh.y_lane;
  if (sh.cols > 1) words += static_cast<size_t>(sh.cols) * lanes * sh.y_lane;
  if (V == kWideShared) words += lanes * sh.e_lane;
  *shared = 16 + words * sizeof(T) + 4 * (3 * lanes + sh.tf_cap);
}

template <typename T, int V>
int launch_wide(const void* const* in, void* ys, const WideShape& sh, cudaStream_t stream) {
  const int w = sh.w, N = sh.N, lanes = sh.lanes;
  const bool whole = sh.cluster == 1 && sh.members >= 1 && lanes == sh.members * N;
  const bool split = sh.cluster > 1 && sh.cluster <= kMaxCluster && sh.members == 1
                     && lanes >= 1 && (sh.cluster - 1) * lanes < N && sh.cluster * lanes >= N;
  const bool group_ok = sh.group >= 1 && sh.group <= 32 && !(sh.group & (sh.group - 1));
  const bool cols_ok = sh.cols >= 1 && sh.cols <= 8
                       && (sh.cols == 1 || (V == kWideShared && sh.group == 32)
                           || V == kWideStream);
  const bool per_ok = sh.per >= 1 && sh.per <= kMaxPer
                      && (sh.per == 1 || (V == kWideGlobal && sh.group == 1));
  if (w < 2 || N < 1 || sh.P < 1 || !group_ok || !cols_ok || !per_ok
      || !(whole || split) || (sh.push && sh.cluster == 1) || sh.tf_cap < 0
      || (V != kWideGlobal && sh.y_lane < w)
      || (V == kWideShared && (sh.e_row < w || sh.e_lane < (w - 1) * sh.e_row + w))
      || (V == kWideGlobal && in[16] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  long threads;
  size_t shared;
  wide_footprint<T, V>(sh, &threads, &shared);
  if (threads > kWideMaxThreads || shared > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  // wide-shared's simple build where it applies; the other variants (off the
  // objective's shapes) have only their general build
  auto kernel = etd2rk_scan_wide_kernel<T, V, true>;
  if constexpr (V == kWideShared) {
    if (sh.cluster == 1 && sh.cols == 1 && sh.per == 1)
      kernel = etd2rk_scan_wide_kernel<T, V, false>;
  }
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.cluster > 1 ? static_cast<unsigned>(sh.P) * sh.cluster
                                    : static_cast<unsigned>((sh.P + sh.members - 1) / sh.members));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = shared;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = sh.cluster > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const int*>(in[8]), static_cast<const int*>(in[9]),
      static_cast<const int*>(in[10]), static_cast<const T*>(in[11]),
      static_cast<const T*>(in[12]), static_cast<const int*>(in[13]),
      static_cast<const int*>(in[14]), static_cast<const int*>(in[15]),
      static_cast<T*>(ys), static_cast<T*>(const_cast<void*>(in[16])), sh);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// The shape's ints, in the wrapper's order (ops/scan_kernel.py::_launch):
// w, variant, members, n_init, n_runs, N, P, lanes, group, cols, per,
// cluster, push, tf_cap, e_lane, e_row, y_lane.
constexpr int kShapeInts = 17;

template <typename T>
int launch_any(const void* const* in, void* ys, const int* s, void* stream_) {
  const auto stream = static_cast<cudaStream_t>(stream_);
  const int w = s[0], variant = s[1], members = s[2], n_init = s[3], n_runs = s[4];
  const int N = s[5], P = s[6];
  if (variant >= kWideShared) {
    const WideShape sh = {w,     members, n_init, n_runs, N,     P,     s[7], s[8], s[9],
                          s[10], s[11],   s[12],  s[13],  s[14], s[15], s[16]};
    switch (variant) {
      case kWideShared: return launch_wide<T, kWideShared>(in, ys, sh, stream);
      case kWideStream: return launch_wide<T, kWideStream>(in, ys, sh, stream);
      case kWideGlobal: return launch_wide<T, kWideGlobal>(in, ys, sh, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#define ETD2RK_CASE(W, V)                                                          \
  if (w == W && variant == V) return launch<T, W, V>(in, ys, n_init, n_runs, N, P, members, stream);
#define ETD2RK_REGS(W) ETD2RK_CASE(W, kRegisters)
#define ETD2RK_WIDE(W) ETD2RK_CASE(W, kShared) ETD2RK_CASE(W, kStream)
  ETD2RK_REGS(2) ETD2RK_REGS(3) ETD2RK_REGS(4) ETD2RK_REGS(5) ETD2RK_REGS(6)
  if constexpr (sizeof(T) == 4) {
    ETD2RK_REGS(7) ETD2RK_REGS(8)
  } else {
    ETD2RK_WIDE(7) ETD2RK_WIDE(8)
  }
  ETD2RK_WIDE(9) ETD2RK_WIDE(10) ETD2RK_WIDE(11) ETD2RK_WIDE(12) ETD2RK_WIDE(13)
  ETD2RK_WIDE(14) ETD2RK_WIDE(15) ETD2RK_WIDE(16) ETD2RK_WIDE(17)
#undef ETD2RK_WIDE
#undef ETD2RK_REGS
#undef ETD2RK_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `in` holds 17 device pointers, in the kernels' order: E, p1, p2h, y0, drv,
// A, ts, totw, driven, tf_ptr, tf_col, tf_coef, tf_deg, runs, out_slot,
// init_slots (int arrays int32, the rest in the entry's type), then the
// wide-global variant's state (2 w B words; null otherwise). `shape` holds
// kShapeInts ints (launch_any): `variant` is 0 (registers: w <= 8 in
// float32, w <= 6 in float64), 1 (shared) or 2 (stream), the template
// kernel for w <= 17 and N <= 256, `members` whole members a block; or 3
// (wide-shared), 4 (wide-stream) or 5 (wide-global), the wide kernel,
// with `lanes` a block, `group` threads a lane's rows, `cols` warps a
// lane's columns, `per` lanes a thread, `cluster` blocks a member (1:
// `members` whole members a block), `push` (the cluster's blocks copy
// their totals to each other), `tf_cap` staged TF
// entries and the shared layout's strides in words
// (ops/scan_kernel.py::scan_launch_shape and wide_layout). Writes ys (T,
// w, B). Launches on `stream` without synchronising and returns the first
// CUDA error code (0 on success). ETD2RK_SCAN_TYPES picks the entries a
// build holds (1: float32, 2: float64, 3: both): ops/cuda_build.py builds
// one library a type, two nvcc runs side by side.
#ifndef ETD2RK_SCAN_TYPES
#define ETD2RK_SCAN_TYPES 3
#endif
#if ETD2RK_SCAN_TYPES & 1
extern "C" int etd2rk_scan_f32(const void* const* in, void* ys, const int* shape,
                               void* stream) {
  return launch_any<float>(in, ys, shape, stream);
}
#endif

#if ETD2RK_SCAN_TYPES & 2
extern "C" int etd2rk_scan_f64(const void* const* in, void* ys, const int* shape,
                               void* stream) {
  return launch_any<double>(in, ys, shape, stream);
}
#endif

extern "C" const char* etd2rk_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
