// ETD2RK propagator tables for the widest blocks, 18 <= w <= 65, in float32
// and float64 (one template, the width a runtime argument):
//   E = expm(L h),  p1 = h phi1(L h) e0,  p2 = h^2 phi2(L h) e0
// for every (bucket, h) pair and every lane. These widths are model 2's
// classes of 5 and 6 sites (w = 33, 65: `mechanisms` caps model 2 at 6
// sites by default) and models 0 and 1 past 15 sites (w = 2 + Smax).
//
// Replaces: phoskintime_tpu/ops/phi_pallas.py::phi_vectors_pallas_all
// above w = 17 (the Pallas entry takes any width; csrc/phi_tables_wide.cu
// takes 9..17). Plain PyTorch version:
// phoskintime_tpu_torch/ops/phi_tables.py::phi_tables_reference.
//
// Math: csrc/phi_tables_wide.cu's, step for step (its head note has the
// series, the Horner steps and the masked doubling ladder), with the same
// j order in every sum (the first product alone, then one FMA a term), the
// identity added after each Horner product, Markstein's division by the
// constant divisors in float32 and the division operator in float64. So
// the tables do not depend on how lanes group into blocks.
//
// What bounds it on this card. Per (pair, lane) the kernel reads w^2 words
// of L and writes w^2 + 2w words of tables, and runs (n - 1)(w^3 + w^2)
// (series and Horner, n terms) + s (w^3 + 2 w^2) (ladder) FMAs: at w = 65
// in float32, 2.0M + 0.28M s FMAs for 34 KB, some 60-140 FMAs a byte, far
// above the H100's 10 (67 TFLOP/s over 3.35 TB/s). FMAs bound it.
//
// What stops csrc/phi_tables_wide.cu's design here. There a lane's
// threads sit in one warp and each thread holds 2 R w words of A and A/k in
// registers: at w = 65, 32 threads a lane need R >= 3, 390 words against
// the 255-register limit, and a lane's shared slice (2 w^2 + 4 w words) is
// 35 KB in float32, 70 KB in float64.
//
// The design here: a block owns LB lanes (the wrapper's
// xwide_launch_shape: 1 at w = 65, up to 20 at w = 18) and all its warps
// share them, with __syncthreads() between phases.
//   * Everything a lane needs lives in shared memory, lanes fastest:
//     A = L h (scaled), A/k for the current Horner step, two E planes, the
//     series' term (double-buffered), v1, v2 and the ladder's p1/p2
//     (double-buffered): 4 w^2 + 8 w words a lane, 139 KB at w = 65 in
//     float64.
//   * Products are register-tiled: a thread computes a 4 x 4 tile of one
//     lane's result, rows i0..i0+3 and columns tj, tj + nTj, .. (strided, so
//     neighbouring threads read neighbouring words), loading 8 words for
//     16 FMAs at each j. A/k is computed once a Horner step into its own
//     plane, not again in every tile.
//   * The ladder's trip count is the block's largest count over its lanes;
//     a lane commits a step only while it is below its own s and copies its
//     E over at its first idle step, as csrc/phi_tables_wide.cu. A lane with
//     a NaN in A takes no part in the trip count; its tables are all NaN.
// A simple design: one barrier a phase, no asynchronous copies, no tensor
// cores (TF32 breaks the 2e-5 agreement), FP32 or FP64 FMAs only.

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

template <typename T> struct Series;
template <> struct Series<float> {
  static constexpr int kTerms = 8;
  static constexpr float kRadius = 0.5f;
};
template <> struct Series<double> {
  static constexpr int kTerms = 12;
  static constexpr double kRadius = 0.25;
};
constexpr int kMaxThreads = 512;
constexpr int kMinWidth = 18;
constexpr int kMaxWidth = 65;
constexpr int kTile = 4;           // a thread's tile: kTile rows x kTile columns
constexpr int kMaxShared = 232448;
constexpr int kDefaultShared = 48 * 1024;

// x / k for a constant divisor k > 0, rk its correctly rounded reciprocal:
// csrc/phi_tables_wide.cu's Markstein correction, the correctly rounded
// quotient; `off` is set outside the normal range (the caller then divides
// with the operator), a zero x returned as it is
__device__ __forceinline__ float div_k(float x, float k, float rk, bool& off) {
  const float q = x * rk;
  const float q1 = fmaf(fmaf(-q, k, x), rk, q);
  const float m = fabsf(q1);
  off = off || (x != 0.0f && !(m >= 0x1p-124f && m <= 0x1p124f));
  return x == 0.0f ? x : q1;
}
__device__ __forceinline__ double div_k(double x, double k, double, bool&) { return x / k; }

// x 2^n, exact (the plain version's hc doubled n times)
__device__ __forceinline__ float times_pow2(float x, int n) { return scalbnf(x, n); }
__device__ __forceinline__ double times_pow2(double x, int n) { return scalbn(x, n); }

template <typename Real>
__device__ __forceinline__ Real quotient(Real x, Real k, Real rk) {
  bool off = false;
  const Real q = div_k(x, k, rk, off);
  return off ? x / k : q;
}

// C = X Y (+ I where `diag`) for every lane of the block: a thread a 4 x 4
// tile at a time. Entry (i, c) of lane l of a plane is [(i w + c) LB + l].
// `go(l)` says whether lane l commits its product; a lane that does not
// copies Y's entries where `copy(l)` (its first idle ladder step).
template <typename Real, typename Go, typename Copy>
__device__ __forceinline__ void product(const Real* X, const Real* Y, Real* C, int w, int LB,
                                        bool diag, Go go, Copy copy) {
  const int nT = (w + kTile - 1) / kTile;
  const int items = LB * nT * nT;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int l = t % LB, tt = t / LB;
    const int i0 = (tt / nT) * kTile, tj = tt % nT;
    if (!go(l)) {
      if (copy(l)) {
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
#pragma unroll
          for (int q = 0; q < kTile; ++q) {
            const int i = i0 + r, c = tj + q * nT;
            if (i < w && c < w) C[(i * w + c) * LB + l] = Y[(i * w + c) * LB + l];
          }
        }
      }
      continue;
    }
    Real acc[kTile][kTile], x[kTile], y[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) x[r] = i0 + r < w ? X[((i0 + r) * w) * LB + l] : Real(0);
#pragma unroll
    for (int q = 0; q < kTile; ++q) y[q] = tj + q * nT < w ? Y[(tj + q * nT) * LB + l] : Real(0);
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
#pragma unroll
      for (int q = 0; q < kTile; ++q) acc[r][q] = x[r] * y[q];
    }
#pragma unroll 2
    for (int j = 1; j < w; ++j) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) x[r] = i0 + r < w ? X[((i0 + r) * w + j) * LB + l] : Real(0);
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        y[q] = tj + q * nT < w ? Y[(j * w + tj + q * nT) * LB + l] : Real(0);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
#pragma unroll
        for (int q = 0; q < kTile; ++q) acc[r][q] = real::fma(x[r], y[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const int i = i0 + r, c = tj + q * nT;
        if (i < w && c < w)
          C[(i * w + c) * LB + l] = diag ? acc[r][q] + (i == c ? Real(1) : Real(0)) : acc[r][q];
      }
    }
  }
}

template <typename Real>
__global__ void __launch_bounds__(kMaxThreads)
phi_tables_xwide_kernel(const Real* __restrict__ L, const int* __restrict__ binv,
                        const Real* __restrict__ h_u, Real* __restrict__ E_out,
                        Real* __restrict__ p1_out, Real* __restrict__ p2_out,
                        int w, int B, int ladder, int LB) {
  constexpr int kTerms = Series<Real>::kTerms;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Real* const smem = reinterpret_cast<Real*>(smem_raw);
  const int plane = w * w * LB, vec = w * LB;
  Real* const A = smem;
  Real* const AK = A + plane;
  Real* const Ep[2] = {AK + plane, AK + 2 * plane};
  Real* const Tv[2] = {AK + 3 * plane, AK + 3 * plane + vec};     // the series' term
  Real* const V1 = Tv[1] + vec;
  Real* const V2 = V1 + vec;
  Real* const P[2] = {V2 + vec, V2 + 3 * vec};                     // p1 in 0..w-1, p2 in w..2w-1
  Real* const hs_l = P[1] + 2 * vec;                               // a lane's h / 2^s
  Real* const inv_l = hs_l + LB;                                   // and 2^-s
  int* const n_l = reinterpret_cast<int*>(inv_l + LB);             // and its step count
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane0 = blockIdx.x * LB;
  const int u = blockIdx.y;
  const size_t stride = static_cast<size_t>(B);
  const Real h = h_u[u];
  const Real* const Lb = L + static_cast<size_t>(binv[u]) * w * w * stride;

  // A = L h; lanes past B hold a zero block
  for (int e = tid; e < plane; e += nth) {
    const int l = e % LB, ij = e / LB;
    const int lane = lane0 + l;
    A[e] = lane < B ? Lb[ij * stride + lane] * h : Real(0);
  }
  __syncthreads();
  // row sums of |A| (into V1), then each lane's inf-norm and step count
  for (int e = tid; e < vec; e += nth) {
    const int l = e % LB, i = e / LB;
    Real row = Real(0);
    for (int j = 0; j < w; ++j) row += real::abs(A[(i * w + j) * LB + l]);
    V1[e] = row;
  }
  __syncthreads();
  for (int l = tid; l < LB; l += nth) {
    Real norm = Real(0);
    bool finite = true;
    for (int i = 0; i < w; ++i) {
      const Real v = V1[i * LB + l];
      finite = finite && (v == v);
      norm = real::max(norm, v);
    }
    Real s = real::ceil(real::log2(real::max(norm, Real(1e-30)) / Series<Real>::kRadius));
    s = real::min(real::max(s, Real(0)), static_cast<Real>(ladder));
    const Real scale = finite ? real::exp2(s) : real::nan<Real>();
    n_l[l] = finite ? static_cast<int>(s) : 0;
    inv_l[l] = finite ? real::exp2(-s) : scale;   // x / 2^s = x 2^-s exactly
    hs_l[l] = h / scale;
  }
  __syncthreads();

  // A /= 2^s; E = I + A/n into plane 0 (n the series' terms)
  for (int e = tid; e < plane; e += nth) {
    const int l = e % LB, ij = e / LB;
    const Real a = A[e] * inv_l[l];
    A[e] = a;
    Ep[0][e] = a * (Real(1) / Real(kTerms)) + (ij / w == ij % w ? Real(1) : Real(0));
  }
  __syncthreads();
  // the series' first term, A e0
  for (int e = tid; e < vec; e += nth) {
    const int l = e % LB, i = e / LB;
    const Real t = A[(i * w) * LB + l];
    Tv[0][e] = t;
    V1[e] = (i == 0 ? Real(1) : Real(0)) + t * Real(0.5);
    V2[e] = (i == 0 ? Real(0.5) : Real(0)) + t / Real(6);
  }
  __syncthreads();

  // phi1 / phi2 e0: term = (A term) / k, v1 += term / (k+1), v2 += term / ((k+1)(k+2))
  int tc = 0;
#pragma unroll 1
  for (int k = 2; k <= kTerms; ++k) {
    const Real d0 = k, d1 = k + 1, d2 = (k + 1) * (k + 2);
    const Real r0 = real::rcp(d0), r1 = real::rcp(d1), r2 = real::rcp(d2);
    const Real* tv = Tv[tc];
    for (int e = tid; e < vec; e += nth) {
      const int l = e % LB, i = e / LB;
      Real acc = A[(i * w) * LB + l] * tv[l];
      for (int j = 1; j < w; ++j) acc = real::fma(A[(i * w + j) * LB + l], tv[j * LB + l], acc);
      const Real term = quotient(acc, d0, r0);
      Tv[tc ^ 1][e] = term;
      V1[e] = V1[e] + quotient(term, d1, r1);
      V2[e] = V2[e] + quotient(term, d2, r2);
    }
    __syncthreads();
    tc ^= 1;
  }

  // E = expm(A) by Horner: E = I + (A/k) E for k = n-1..1, plane to plane
  const auto always = [](int) { return true; };
  const auto never = [](int) { return false; };
  int cur = 0;
#pragma unroll 1
  for (int k = kTerms - 1; k >= 1; --k) {
    const Real kf = k, rk = real::rcp(kf);
    for (int e = tid; e < plane; e += nth) AK[e] = quotient(A[e], kf, rk);
    __syncthreads();
    product(AK, Ep[cur], Ep[cur ^ 1], w, LB, true, always, never);
    __syncthreads();
    cur ^= 1;
  }

  // p1 = v1 hs, p2 = v2 hs^2
  for (int e = tid; e < vec; e += nth) {
    const int l = e % LB, i = e / LB;
    const Real hs = hs_l[l];
    P[0][i * LB + l] = V1[e] * hs;
    P[0][(w + i) * LB + l] = V2[e] * (hs * hs);
  }
  int n_block = 0;
  for (int l = 0; l < LB; ++l) n_block = max(n_block, n_l[l]);
  __syncthreads();

  // doubling ladder: p2 <- p2 + E p2 + hc p1, p1 <- p1 + E p1, E <- E E while
  // it < the lane's own count, hc = hs 2^it
  int vc = 0;
#pragma unroll 1
  for (int it = 0; it < n_block; ++it) {
    const Real* Ec = Ep[cur];
    const Real* Pc = P[vc];
    Real* Pn = P[vc ^ 1];
    for (int e = tid; e < vec; e += nth) {
      const int l = e % LB, i = e / LB;
      Real p1 = Pc[i * LB + l], p2 = Pc[(w + i) * LB + l];
      if (it < n_l[l]) {
        const Real e0 = Ec[(i * w) * LB + l];
        Real q1 = e0 * Pc[l], q2 = e0 * Pc[w * LB + l];
        for (int j = 1; j < w; ++j) {
          const Real eij = Ec[(i * w + j) * LB + l];
          q1 = real::fma(eij, Pc[j * LB + l], q1);
          q2 = real::fma(eij, Pc[(w + j) * LB + l], q2);
        }
        const Real hc = times_pow2(hs_l[l], it);
        p2 = p2 + q2 + p1 * hc;
        p1 = p1 + q1;
      }
      Pn[i * LB + l] = p1;
      Pn[(w + i) * LB + l] = p2;
    }
    product(Ec, Ec, Ep[cur ^ 1], w, LB, false, [&](int l) { return it < n_l[l]; },
            [&](int l) { return it == n_l[l]; });
    __syncthreads();
    cur ^= 1;
    vc ^= 1;
  }

  const Real* Ef = Ep[cur];
  const Real* Pf = P[vc];
  for (int e = tid; e < plane; e += nth) {
    const int l = e % LB, ij = e / LB;
    const int lane = lane0 + l;
    if (lane < B) E_out[(static_cast<size_t>(u) * w * w + ij) * stride + lane] = Ef[e];
  }
  for (int e = tid; e < vec; e += nth) {
    const int l = e % LB, i = e / LB;
    const int lane = lane0 + l;
    if (lane < B) {
      const size_t row = (static_cast<size_t>(u) * w + i) * stride + lane;
      p1_out[row] = Pf[i * LB + l];
      p2_out[row] = Pf[(w + i) * LB + l];
    }
  }
}

template <typename Real>
int launch(const void* L, const void* binv, const void* h_u, void* E, void* p1, void* p2,
           int w, int U, int B, int ladder, int LB, int threads, cudaStream_t stream) {
  // the wrapper's layout: LB (4 w^2 + 8 w + 2) words and LB ints
  const size_t shared = static_cast<size_t>(LB) * (4 * w * w + 8 * w + 2) * sizeof(Real)
                        + static_cast<size_t>(LB) * sizeof(int);
  if (w < kMinWidth || w > kMaxWidth || LB < 1 || threads < 32 || threads > kMaxThreads
      || threads % 32 || shared > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = phi_tables_xwide_kernel<Real>;
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((B + LB - 1) / LB, U);
  kernel<<<grid, threads, shared, stream>>>(
      static_cast<const Real*>(L), static_cast<const int*>(binv),
      static_cast<const Real*>(h_u), static_cast<Real*>(E), static_cast<Real*>(p1),
      static_cast<Real*>(p2), w, B, ladder, LB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (Bu, w, w, B), binv (U,) int32, h_u (U,), all on the device, L, h_u and
// the tables in the entry's type; writes E (U, w, w, B), p1 (U, w, B), p2
// (U, w, B) for 18 <= w <= 65. `lanes` is LB, the lanes a block, and
// `threads` the threads a block (ops/phi_tables.py::xwide_launch_shape).
// Launches on `stream` without synchronising and returns the first CUDA
// error code (0 on success).
extern "C" int phi_tables_xwide_f32(const void* L, const void* binv, const void* h_u, void* E,
                                    void* p1, void* p2, int w, int U, int B, int ladder,
                                    int lanes, int threads, void* stream) {
  return launch<float>(L, binv, h_u, E, p1, p2, w, U, B, ladder, lanes, threads,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int phi_tables_xwide_f64(const void* L, const void* binv, const void* h_u, void* E,
                                    void* p1, void* p2, int w, int U, int B, int ladder,
                                    int lanes, int threads, void* stream) {
  return launch<double>(L, binv, h_u, E, p1, p2, w, U, B, ladder, lanes, threads,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* phi_tables_xwide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
