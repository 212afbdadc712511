// The whole ETD2RK segment scan of the population objective in one launch,
// float32, block widths 2 <= w <= 17. For each segment s of the static plan,
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
// (tf_ptr (N+1,), tf_col, tf_coef) and tf_deg (N,).
//
// What bounds it on this card. Read once, the tables are U (w^2 + 2w) B
// floats: 248 MB for the bench chunk (U = 14, w = 6, B = 92,160), 0.074 ms
// at 3.35 TB/s; the arithmetic is about S B (w^2 + 4w + 2 nnz/N + 20) FMAs,
// ~1.0 G there, 0.03 ms at 67 TFLOP/s. So bytes bound it. The scan cannot hold the
// tables on chip (248 MB against 50 MB of L2 and 33 MB of registers and
// shared memory), so each segment streams its pair's rows from L2 or HBM:
// S (w^2 + 2w) B floats, 2.35 GB at the bench chunk, which is what this
// simple design moves.
//
// What the design does about it. One thread per (member, protein) lane
// keeps its w-slot state, a, and its total-protein weights in registers for
// all S segments; nothing but the snapshots is written back. The TF matvec
// couples proteins only within a member, so a thread block holds whole
// members (members_per_block of them, about block_threads / N) and no block
// ever needs another block's data: the members' totals Pv are exchanged
// through shared memory, one __syncthreads() per synthesis evaluation (two
// per segment), with two buffers alternating so that a segment's second
// write cannot overrun a read of its first. Each thread reads only its own
// member's Pv, so a non-finite member changes no other member's values.
// The E row of the segment's pair is read lanes fastest: a warp's loads are
// coalesced, and consecutive segments of one pair find it in L2 (13 MB per
// pair at the bench chunk). The per-segment uidx, jb and out_slot are small
// device arrays read by every thread (cache broadcasts). The driven
// override is a select, not the Pallas kernel's blend, so a non-finite
// total cannot poison a driven protein. FP32 FMA only: no tensor cores.

#include <cuda_runtime.h>

namespace {

// One build of each width, bounded at 256 threads a block (up to 255
// registers a thread: no width spills), so a member holds at most 256
// proteins.
constexpr int kMaxThreads = 256;

struct Lane {
  bool active;
  int base;            // this member's first slot in a Pv buffer
  int row_beg, row_end;
  bool driven;
  float amp, tsc, deg;
};

// g(v): the synthesis drive of this lane. Every thread of the block calls it
// (the barrier is block-wide); only active lanes write or read `buf`.
template <int W>
__device__ __forceinline__ float synth(const float (&v)[W], const float (&tw)[W],
                                       float drive, float* buf, const Lane& ln,
                                       const int* __restrict__ tf_col,
                                       const float* __restrict__ tf_coef) {
  if (ln.active) {
    float tot = 0.0f;
#pragma unroll
    for (int i = 1; i < W; ++i) tot = fmaf(tw[i], v[i], tot);
    buf[threadIdx.x] = ln.driven ? drive : tot;
  }
  __syncthreads();
  if (!ln.active) return 0.0f;
  float acc = 0.0f;
  for (int k = ln.row_beg; k < ln.row_end; ++k)
    acc = fmaf(__ldg(tf_coef + k), buf[ln.base + __ldg(tf_col + k)], acc);
  const float x = acc / ln.deg;
  const float u = x / (1.0f + fabsf(x));
  const float act = ln.amp * (1.0f + (ln.tsc * u) / ((1.0f + u) + 1e-6f));
  const float rep = ln.amp / (1.0f + ln.tsc * fabsf(u));
  return u >= 0.0f ? act : rep;
}

template <int W>
__global__ void __launch_bounds__(kMaxThreads)
etd2rk_scan_kernel(const float* __restrict__ E, const float* __restrict__ p1,
                   const float* __restrict__ p2h, const float* __restrict__ y0,
                   const float* __restrict__ drv, const float* __restrict__ A,
                   const float* __restrict__ ts, const float* __restrict__ totw,
                   const int* __restrict__ driven, const int* __restrict__ tf_ptr,
                   const int* __restrict__ tf_col, const float* __restrict__ tf_coef,
                   const float* __restrict__ tf_deg, const int* __restrict__ uidx,
                   const int* __restrict__ jb, const int* __restrict__ out_slot,
                   const int* __restrict__ init_slots, float* __restrict__ ys,
                   int n_init, int S, int N, int P, int members_per_block) {
  extern __shared__ float pv[];                       // 2 x members_per_block x N
  const int span = members_per_block * N;
  const int t = threadIdx.x;
  const int member = blockIdx.x * members_per_block + t / N;
  const size_t B = static_cast<size_t>(P) * N;
  const size_t lane = static_cast<size_t>(member) * N + t % N;

  Lane ln;
  ln.active = t < span && member < P;
  ln.base = (t / N) * N;
  float y[W], a[W], tw[W];
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
      float* out = ys + static_cast<size_t>(init_slots[k]) * W * B + lane;
#pragma unroll
      for (int i = 0; i < W; ++i) out[i * B] = y[i];
    }
  }

  for (int s = 0; s < S; ++s) {
    const int u = __ldg(uidx + s);
    const float drive = (ln.active && ln.driven)
                            ? drv[static_cast<size_t>(__ldg(jb + s)) * B + lane] : 0.0f;
    const float sn = synth<W>(y, tw, drive, pv, ln, tf_col, tf_coef);
    if (ln.active) {
      const float* Eu = E + static_cast<size_t>(u) * W * W * B + lane;
      const float* p1u = p1 + static_cast<size_t>(u) * W * B + lane;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < W; ++j) acc = fmaf(Eu[(i * W + j) * B], y[j], acc);
        a[i] = fmaf(p1u[i * B], sn, acc);
      }
    }
    const float sa = synth<W>(a, tw, drive, pv + span, ln, tf_col, tf_coef);
    if (ln.active) {
      const float* p2u = p2h + static_cast<size_t>(u) * W * B + lane;
      const float d = sa - sn;
#pragma unroll
      for (int i = 0; i < W; ++i) y[i] = fmaf(p2u[i * B], d, a[i]);
      const int slot = __ldg(out_slot + s);
      if (slot >= 0) {
        float* out = ys + static_cast<size_t>(slot) * W * B + lane;
#pragma unroll
        for (int i = 0; i < W; ++i) out[i * B] = y[i];
      }
    }
  }
}

template <int W>
int launch(const void* const* in, void* ys, int n_init, int S, int N, int P,
           int block_threads, cudaStream_t stream) {
  const int members = block_threads / N > 0 ? block_threads / N : 1;
  const int span = members * N;
  const int threads = (span + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + members - 1) / members;
  const size_t shared = 2 * static_cast<size_t>(span) * sizeof(float);
  etd2rk_scan_kernel<W><<<blocks, threads, shared, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const int*>(in[8]), static_cast<const int*>(in[9]),
      static_cast<const int*>(in[10]), static_cast<const float*>(in[11]),
      static_cast<const float*>(in[12]), static_cast<const int*>(in[13]),
      static_cast<const int*>(in[14]), static_cast<const int*>(in[15]),
      static_cast<const int*>(in[16]), static_cast<float*>(ys),
      n_init, S, N, P, members);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `in` holds 17 device pointers, in the kernel's order: E, p1, p2h, y0, drv,
// A, ts, totw, driven, tf_ptr, tf_col, tf_coef, tf_deg, uidx, jb, out_slot,
// init_slots (int arrays int32, the rest float32). Writes ys (T, w, B).
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success).
extern "C" int etd2rk_scan_f32(const void* const* in, void* ys, int w, int n_init,
                               int S, int N, int P, int block_threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ETD2RK_CASE(W) \
  case W: return launch<W>(in, ys, n_init, S, N, P, block_threads, st);
  switch (w) {
    ETD2RK_CASE(2) ETD2RK_CASE(3) ETD2RK_CASE(4) ETD2RK_CASE(5)
    ETD2RK_CASE(6) ETD2RK_CASE(7) ETD2RK_CASE(8) ETD2RK_CASE(9)
    ETD2RK_CASE(10) ETD2RK_CASE(11) ETD2RK_CASE(12) ETD2RK_CASE(13)
    ETD2RK_CASE(14) ETD2RK_CASE(15) ETD2RK_CASE(16) ETD2RK_CASE(17)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ETD2RK_CASE
}

extern "C" const char* etd2rk_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
