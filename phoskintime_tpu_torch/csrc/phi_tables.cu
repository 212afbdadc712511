// ETD2RK propagator tables for every (bucket, h) pair and every lane:
//   E = expm(L h),  p1 = h phi1(L h) e0,  p2 = h^2 phi2(L h) e0
// for w x w blocks, 2 <= w <= 8, in float32 and float64 (one template).
//
// Replaces: phoskintime_tpu/ops/phi_pallas.py::phi_vectors_pallas_pages
// (kernel body _phi_kernel_pages, math _phi_math_pages), the TPU kernel on
// the population objective's main path for the affine mechanisms. Plain
// PyTorch version: phoskintime_tpu_torch/ops/phi_tables.py::phi_tables_reference.
//
// Math, step for step as in _phi_math_pages:
//   A = L h; s = ceil(log2(||A||_inf / r)) clipped to [0, ladder];
//   A *= 2^-s, hs = h 2^-s;
//   E by an n-term Horner series with reciprocal constants 1/k, the first
//   step peeled (E = I + A/n);
//   with the JAX package's series for each type: n = 8 at radius r = 0.5
//   in float32, n = 12 at r = 0.25 in float64 (as the plain version);
//   the phi1/phi2 e0 columns by the shared power series;
//   then s doubling steps  p2 <- p2 + E p2 + hc p1,  p1 <- p1 + E p1,
//   E <- E E,  hc <- 2 hc.
//
// What bounds it on this card. Per (pair, lane) the kernel reads w^2
// words of L and writes w^2 + 2w words of tables: 84 floats, 336 bytes at
// w = 6. Against that it runs about 8 w^3 (Horner) + 7 w^2 (series)
// + s (w^3 + 2 w^2) (ladder) FMAs: at the model-0 chunk (w = 6, 92,160
// lanes, 14 pairs, mean s 4.0) the bytes take 0.125 ms at 3.35 TB/s and
// the FMAs 0.112 ms at 67 TFLOP/s. The two limits are as large, so the
// kernel comes near either only if memory traffic runs while the SM
// computes. Here it does not: a thread loads its lane's L and stores its
// tables itself, 84 memory instructions a (pair, lane) in two bursts; the
// warps of an SM start together and stay in step, so their bursts meet
// and wait on the memory while the FMA pipes idle, and the FMA phases then
// leave the memory idle (tools/phase_clocks.py --kernel tables: a third of
// a warp's cycles in its load and store phases, 128 registers a thread,
// 4 blocks an SM, and a device time near the sum of the two limits).
//
// The design. One thread per (pair, lane): the block lives in registers
// for the whole build, so every byte of L is read once and every table
// entry written once, and nothing in between touches memory (the plain
// version moves the (w, w, lanes) carry through device memory at every
// Horner term and ladder step). The lane is the minor axis of L and of the
// tables, so each warp's loads and stores are coalesced. Each thread runs
// its own s rather than the static worst case `ladder`, which is the
// per-lane mask of _phi_math_pages; the tile-wide skip there has no
// counterpart because a thread that is done simply stops. FP32 FMA only:
// no tensor cores, no TF32. A persistent grid that moved each 128-lane
// tile through shared memory by tensor-memory copies was tried: it took
// the copies off the warps but was no faster, its block barriers waiting
// on the warp whose lanes square the most (PERF.md has the runs).
//
// float64 (the float64 instance of the same template): twice the bytes,
// and FP64 FMAs at half the FP32 rate (34 TFLOP/s on the H100 SXM), with
// 12 series terms, so FMAs bound it. The three live w x w blocks take
// twice the registers: w = 6, the model-0 block, holds them; w = 7 and 8
// may spill (ptxas's report is kept beside the library).

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

constexpr int kBlock = 128;

// the JAX package's series for each type: terms, and 1 / the pre-squaring radius
template <typename T> struct Series;
template <> struct Series<float> {
  static constexpr int kTerms = 8;
  static constexpr float kInvRadius = 2.0f;   // 1 / 0.5
};
template <> struct Series<double> {
  static constexpr int kTerms = 12;
  static constexpr double kInvRadius = 4.0;   // 1 / 0.25
};

template <typename T, int W>
__device__ __forceinline__ void matvec(const T (&m)[W][W], const T (&v)[W], T (&out)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    T acc = m[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < W; ++j) acc = real::fma(m[i][j], v[j], acc);
    out[i] = acc;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kBlock)
phi_tables_kernel(const T* __restrict__ L, const int* __restrict__ binv,
                  const T* __restrict__ h_u, T* __restrict__ E_out,
                  T* __restrict__ p1_out, T* __restrict__ p2_out,
                  int B, int ladder) {
  constexpr int kTerms = Series<T>::kTerms;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int u = blockIdx.y;
  const size_t plane = static_cast<size_t>(B);
  const T h = h_u[u];
  const T* Lb = L + static_cast<size_t>(binv[u]) * W * W * plane + lane;

  // A = L h and its inf-norm (max absolute row sum)
  T A[W][W];
  T norm = T(0);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    T row = T(0);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      A[i][j] = Lb[(i * W + j) * plane] * h;
      row += real::abs(A[i][j]);
    }
    norm = real::max(norm, row);
  }
  T s = real::ceil(real::log2(real::max(norm, T(1e-30)) * Series<T>::kInvRadius));
  s = real::min(real::max(s, T(0)), static_cast<T>(ladder));
  const T inv = real::exp2(-s);
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) A[i][j] *= inv;
  const T hs = h * inv;

  // E = expm(A) by Horner: E = I + A/n, then E = I + (A/k) E for k = n-1..1
  T E[W][W], Tm[W][W];
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j)
      E[i][j] = A[i][j] * (T(1) / T(kTerms)) + (i == j ? T(1) : T(0));
#pragma unroll
  for (int k = kTerms - 1; k >= 1; --k) {
    const T rk = T(1) / T(k);
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        T acc = (A[i][0] * rk) * E[0][c];
#pragma unroll
        for (int j = 1; j < W; ++j) acc = real::fma(A[i][j] * rk, E[j][c], acc);
        Tm[i][c] = acc + (i == c ? T(1) : T(0));
      }
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) E[i][c] = Tm[i][c];
  }

  // phi1 / phi2 e0 columns: term_k = A^k e0 / k!,
  // v1 = sum term_k / (k+1), v2 = sum term_k / ((k+1)(k+2))
  T term[W], v1[W], v2[W], q1[W], q2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    term[i] = A[i][0];
    v1[i] = term[i] * T(0.5) + (i == 0 ? T(1) : T(0));
    v2[i] = term[i] * (T(1) / T(6)) + (i == 0 ? T(0.5) : T(0));
  }
#pragma unroll
  for (int k = 2; k <= kTerms; ++k) {
    const T rk = T(1) / T(k);
    const T r1 = T(1) / T(k + 1);
    const T r2 = T(1) / T((k + 1) * (k + 2));
    matvec<T, W>(A, term, q1);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      term[i] = q1[i] * rk;
      v1[i] = v1[i] + term[i] * r1;
      v2[i] = v2[i] + term[i] * r2;
    }
  }
  T p1[W], p2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    p1[i] = v1[i] * hs;
    p2[i] = v2[i] * (hs * hs);
  }

  // doubling ladder, this lane's own s steps
  T hc = hs;
  const int n_steps = static_cast<int>(s);
  for (int it = 0; it < n_steps; ++it) {
    matvec<T, W>(E, p1, q1);
    matvec<T, W>(E, p2, q2);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      p2[i] = p2[i] + q2[i] + p1[i] * hc;
      p1[i] = p1[i] + q1[i];
    }
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        T acc = E[i][0] * E[0][c];
#pragma unroll
        for (int j = 1; j < W; ++j) acc = real::fma(E[i][j], E[j][c], acc);
        Tm[i][c] = acc;
      }
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) E[i][c] = Tm[i][c];
    hc *= T(2);
  }

  T* Eo = E_out + static_cast<size_t>(u) * W * W * plane + lane;
  T* p1o = p1_out + static_cast<size_t>(u) * W * plane + lane;
  T* p2o = p2_out + static_cast<size_t>(u) * W * plane + lane;
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) Eo[(i * W + j) * plane] = E[i][j];
    p1o[i * plane] = p1[i];
    p2o[i * plane] = p2[i];
  }
}

template <typename T, int W>
int launch(const void* L, const void* binv, const void* h_u, void* E, void* p1,
           void* p2, int U, int B, int ladder, cudaStream_t stream) {
  const dim3 grid((B + kBlock - 1) / kBlock, U);
  phi_tables_kernel<T, W><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(L), static_cast<const int*>(binv),
      static_cast<const T*>(h_u), static_cast<T*>(E),
      static_cast<T*>(p1), static_cast<T*>(p2), B, ladder);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* L, const void* binv, const void* h_u, void* E, void* p1,
             void* p2, int w, int U, int B, int ladder, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 2: return launch<T, 2>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 3: return launch<T, 3>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 4: return launch<T, 4>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 5: return launch<T, 5>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 6: return launch<T, 6>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 7: return launch<T, 7>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 8: return launch<T, 8>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// L (Bu, w, w, B), binv (U,) int32, h_u (U,), all on the device, L, h_u and
// the tables in the entry's type; writes E (U, w, w, B), p1 (U, w, B), p2
// (U, w, B). Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int phi_tables_f32(const void* L, const void* binv, const void* h_u,
                              void* E, void* p1, void* p2, int w, int U, int B,
                              int ladder, void* stream) {
  return dispatch<float>(L, binv, h_u, E, p1, p2, w, U, B, ladder, stream);
}

extern "C" int phi_tables_f64(const void* L, const void* binv, const void* h_u,
                              void* E, void* p1, void* p2, int w, int U, int B,
                              int ladder, void* stream) {
  return dispatch<double>(L, binv, h_u, E, p1, p2, w, U, B, ladder, stream);
}

extern "C" const char* phi_tables_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
