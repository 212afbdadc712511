// ETD2RK propagator tables for wide blocks, 9 <= w <= 17, in float32 and
// float64 (one template):
//   E = expm(L h),  p1 = h phi1(L h) e0,  p2 = h^2 phi2(L h) e0
// for every (bucket, h) pair and every lane. These are the combinatorial
// mechanism's width classes (w = 1 + 2^s for a protein with s sites).
//
// Replaces: phoskintime_tpu/ops/phi_pallas.py::phi_vectors_pallas_all
// (kernel body _phi_kernel_all, math _phi_math), and with U = 1 its
// single-pair entry phi_vectors_pallas (_phi_kernel). Plain PyTorch
// version: phoskintime_tpu_torch/ops/phi_tables.py::phi_tables_reference.
//
// Math, step for step as in _phi_math:
//   A = L h; s = ceil(log2(max(||A||_inf, 1e-30) / 0.5)) clipped to
//   [0, ladder]; A /= 2^s, hs = h / 2^s;
//   E = I + A/8, then E = I + (A/k) E for k = 7..1 (8 Horner terms);
//   term = A e0, v1 = e0 + term/2, v2 = e0/2 + term/6, then for
//   k = 2..8: term = (A term)/k, v1 += term/(k+1), v2 += term/((k+1)(k+2));
//   p1 = v1 hs, p2 = v2 hs^2;
//   then the masked doubling ladder: while it < s,
//   p2 <- p2 + E p2 + hc p1, p1 <- p1 + E p1, E <- E E, hc <- 2 hc.
//
// What bounds it on this card. Per (pair, lane) the kernel reads w^2
// floats of L and writes w^2 + 2w floats of tables (2,448 bytes at
// w = 17), and runs 7 w^3 (Horner) + 7 w^2 (series) + s (w^3 + 2 w^2)
// (ladder) FP32 FMAs: 36,414 + 5,491 s at w = 17, that is 15 to 51 FMAs
// per byte as s runs from 0 to 16. The H100 SXM's published FP32 rate
// over its HBM bandwidth (67 TFLOP/s over 3.35 TB/s) is 10 FMAs per
// byte, so the build is bound by FMAs, not by HBM.
//
// What the design does about it. The products are w x w x w per lane, far
// too small for the tensor cores' tiles in full float32 (TF32 breaks the
// kernels' 2e-5 agreement), so they run on the FP32 pipes, and the task
// is to keep those fed. A warp issues one instruction a cycle on each of
// the SM's four schedulers, and shared memory serves one 32-word load a
// cycle for the whole SM, so a product that takes one shared load per FMA
// runs at most at a quarter of the FMA peak. Here:
//   * Register tiling. A thread owns R consecutive rows of one lane's
//     products, T = ceil(w / R) threads a lane. It keeps its rows of the
//     left operand in registers (A/k in the Horner steps; its rows of E,
//     loaded once a step, in the ladder) and walks the columns, loading a
//     whole column of the right operand before its FMAs: each shared load
//     feeds R FMAs, and a column's load latency is paid once. The series
//     matvecs and the ladder's E p1, E p2 follow the same rows.
//   * Warp-owned lanes. The T threads of a lane sit in one warp, and each
//     warp owns LW = 32 / T lanes and its own slice of shared memory, so
//     every barrier is a __syncwarp(). Within the slice E is held twice,
//     [w][w][LW] lanes fastest (a warp's loads hit LW consecutive words,
//     each broadcast to the lane's T threads): a product reads one plane
//     and writes the other, one barrier a product. The vectors (row sums,
//     the series term, p1 and p2) are double-buffered the same way.
//   * No division in a loop. The division operator ends in a check and a
//     branch to its slow path, so the compiler runs a batch of divisions
//     one after another at full latency: with them a Horner step (w R of
//     A/k) costs three ladder steps (clock64() stamps,
//     tools/phase_clocks.py), and the kernel twice its time. Every
//     divisor here is a constant: powers of two are exact multiplies, and
//     the others take Markstein's correction (div_k below), correctly
//     rounded, so the tables are the operator's to the bit.
//   * The ladder's trip count is the warp's largest count over its LW
//     lanes; each lane commits a step only while it is below its own s
//     (past it, it copies its E into the other plane once), as the Pallas
//     kernel skips a tile once all its lanes are done. A lane with a NaN in
//     A takes no part in the warp's trip count (its tables are all NaN, as
//     the plain version's), so one failed member cannot change the tables
//     of its warp's other members.
// The arithmetic is the first design's, FMA for FMA (the same j order in
// every sum, the identity added after each Horner product), so the tables
// do not depend on R or on the lane grouping. FP32 FMA only: no tensor
// cores, no TF32.
// Launch shapes (ops/phi_tables.py::wide_launch_shape), from a sweep of R
// in {3..9} and 1, 2 or 4 warps a block on the H100 (PERF.md): R = 9 at
// w = 9 (T = 1, 32 lanes a warp), R = 5 at w = 17 (T = 4, 8 lanes a warp,
// 20.7 KB of shared memory a warp), 2 warps a block; the other widths take
// an R that compiles without spills. At w = 17 the kernel uses 255
// registers a thread (8 warps an SM) and spills nothing.
//
// float64. The same steps with the JAX package's float64 series (12
// Horner terms at radius 0.25, as the plain version) and the division
// operator (IEEE, correctly rounded) in place of Markstein's correction,
// which is written for float. A thread's 2 R w words of A and A/k are
// twice the registers, so the float64 instances take smaller R (3 up to
// w = 12, 2 above: _WIDE_ROWS_F64 in ops/phi_tables.py), and the shared
// slice of a lane is 8 (2 w^2 + 4 w) bytes. FP64 FMAs run at half the
// FP32 rate, so FMAs bound it all the more.

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

// the JAX package's series for each type: terms and pre-squaring radius
template <typename T> struct Series;
template <> struct Series<float> {
  static constexpr int kTerms = 8;
  static constexpr float kRadius = 0.5f;
};
template <> struct Series<double> {
  static constexpr int kTerms = 12;
  static constexpr double kRadius = 0.25;
};
constexpr int kMaxWarps = 8;       // warps a block
constexpr int kMaxShared = 232448;
constexpr int kDefaultShared = 48 * 1024;

// x / k for a constant divisor k > 0 with rk its correctly rounded
// reciprocal, without a division: q = x rk is within an ulp of x / k, the
// residual x - q k is exact by fma, and q + (x - q k) rk, rounded, is the
// correctly rounded quotient (Markstein), the division operator's result,
// wherever it lies in the normal range. Outside it (and for a NaN or an
// infinite x) `off` is set, and the caller redoes its batch with the
// operator. A zero x is returned as it is, sign and all, as 0 / k is.
// The operator's own fast path ends in a check and a branch to its slow
// path, and the compiler does not overlap one division with the next: a
// batch of them runs at their full latency, one after another.
__device__ __forceinline__ float div_k(float x, float k, float rk, bool& off) {
  const float q = x * rk;
  const float q1 = fmaf(fmaf(-q, k, x), rk, q);
  const float m = fabsf(q1);
  off = off || (x != 0.0f && !(m >= 0x1p-124f && m <= 0x1p124f));
  return x == 0.0f ? x : q1;
}

// float64: the division operator, correctly rounded; `off` is never set
__device__ __forceinline__ double div_k(double x, double k, double, bool&) { return x / k; }

template <int W, int R>
struct Shape {
  static constexpr int T = (W + R - 1) / R;   // threads a lane
  static constexpr int LW = 32 / T;           // lanes a warp
  static constexpr int kThreads = T * LW;     // busy threads a warp
  static constexpr int kPlane = W * W * LW;   // words of one E plane
  static constexpr int kVec = W * LW;         // words of one vector
  static constexpr int kWarpWords = 2 * kPlane + 4 * kVec;
};

template <typename Real, int W, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
phi_tables_wide_kernel(const Real* __restrict__ L, const int* __restrict__ binv,
                       const Real* __restrict__ h_u, Real* __restrict__ E_out,
                       Real* __restrict__ p1_out, Real* __restrict__ p2_out,
                       int B, int ladder) {
  using S = Shape<W, R>;
  constexpr int LW = S::LW;
  constexpr int kTerms = Series<Real>::kTerms;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Real* const smem = reinterpret_cast<Real*>(smem_raw);
  const int warp = threadIdx.x / 32, tw = threadIdx.x % 32;
  if (tw >= S::kThreads) return;       // the warp's spare threads hold no lane
  const unsigned mask = S::kThreads == 32 ? 0xffffffffu : (1u << S::kThreads) - 1u;
  const int g = tw / LW;               // row group: rows i0 .. i0 + R - 1
  const int l = tw % LW;               // lane within the warp
  const int i0 = g * R;
  const int lane = (blockIdx.x * (blockDim.x / 32) + warp) * LW + l;
  const bool live = lane < B;          // lanes past B run a zero block
  const int u = blockIdx.y;
  const size_t plane = static_cast<size_t>(B);
  const Real h = h_u[u];

  Real* const base = smem + warp * S::kWarpWords + l;
  Real* const Ep[2] = {base, base + S::kPlane};        // entry (i, c): [(i W + c) LW]
  Real* const vec = base + 2 * S::kPlane;              // vector k, entry i: [(k W + i) LW]

  // rows i0.. of A = L h, and their absolute sums
  Real a[R][W];
  const Real* Lb = L + static_cast<size_t>(binv[u]) * W * W * plane + lane;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    Real row = Real(0);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      a[r][j] = (live && i < W) ? Lb[(i * W + j) * plane] * h : Real(0);
      row += real::abs(a[r][j]);
    }
    if (i < W) vec[i * LW] = row;
  }
  __syncwarp(mask);

  // inf-norm over the lane's rows; a NaN row marks the lane non-finite
  Real norm = Real(0);
  bool finite = true;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const Real v = vec[r * LW];
    finite = finite && (v == v);
    norm = real::max(norm, v);
  }
  Real s = real::ceil(real::log2(real::max(norm, Real(1e-30)) / Series<Real>::kRadius));
  s = real::min(real::max(s, Real(0)), static_cast<Real>(ladder));
  const int n_lane = finite ? static_cast<int>(s) : 0;
  const int n_warp = __reduce_max_sync(mask, n_lane);
  const Real scale = finite ? real::exp2(s) : real::nan<Real>();
  const Real inv_scale = finite ? real::exp2(-s) : scale;  // x / 2^s = x 2^-s exactly
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < W; ++j) a[r][j] = a[r][j] * inv_scale;
  }
  const Real hs = h / scale;
  __syncwarp(mask);                    // every read of the row sums done

  // E = I + A/n into plane 0 (n the series' terms)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i < W) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        Ep[0][(i * W + c) * LW] =
            a[r][c] * (Real(1) / Real(kTerms)) + (i == c ? Real(1) : Real(0));
    }
  }

  // phi1 / phi2 e0 columns; this thread holds entries i0.. of each vector
  Real term[R], v1[R], v2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    term[r] = a[r][0];                 // (A e0)_i
    v1[r] = (i == 0 ? Real(1) : Real(0)) + term[r] * Real(0.5);
    v2[r] = (i == 0 ? Real(0.5) : Real(0)) + term[r] / Real(6);
  }
#pragma unroll 1
  for (int k = 2; k <= kTerms; ++k) {
    Real* tv = vec + (k & 1) * S::kVec;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i0 + r < W) tv[(i0 + r) * LW] = term[r];
    __syncwarp(mask);                  // the term complete (and, at k = 2, E)
    Real acc[R];
    {
      const Real b = tv[0];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = a[r][0] * b;
    }
#pragma unroll
    for (int j = 1; j < W; ++j) {
      const Real b = tv[j * LW];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = real::fma(a[r][j], b, acc[r]);
    }
    const Real d0 = k, d1 = k + 1, d2 = (k + 1) * (k + 2);
    const Real r0 = real::rcp(d0), r1 = real::rcp(d1), r2 = real::rcp(d2);
    bool off = false;
    Real t1[R], t2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      term[r] = div_k(acc[r], d0, r0, off);
      t1[r] = div_k(term[r], d1, r1, off);
      t2[r] = div_k(term[r], d2, r2, off);
    }
    if (off) {                         // a quotient outside the normal range
#pragma unroll
      for (int r = 0; r < R; ++r) {
        term[r] = acc[r] / d0;
        t1[r] = term[r] / d1;
        t2[r] = term[r] / d2;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v1[r] = v1[r] + t1[r];
      v2[r] = v2[r] + t2[r];
    }
  }

  // E = expm(A) by Horner: E = I + (A/k) E for k = n-1..1, plane to plane
  int cur = 0;
#pragma unroll 1
  for (int k = kTerms - 1; k >= 1; --k) {
    const Real kf = k, rk = real::rcp(kf);
    Real ak[R][W];
    bool off = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < W; ++j) ak[r][j] = div_k(a[r][j], kf, rk, off);
    }
    if (off) {                         // a quotient outside the normal range
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < W; ++j) ak[r][j] = a[r][j] / kf;
      }
    }
    const Real* Ec = Ep[cur];
    Real* En = Ep[cur ^ 1];
#pragma unroll 1
    for (int c = 0; c < W; ++c) {
      Real b[W], acc[R];
#pragma unroll
      for (int j = 0; j < W; ++j) b[j] = Ec[(j * W + c) * LW];   // the column first
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = ak[r][0] * b[0];
#pragma unroll
      for (int j = 1; j < W; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = real::fma(ak[r][j], b[j], acc[r]);
      }
      // + 0 here and + 1 on the diagonal below: the plain version's
      // acc + (i == c), without a compare for every entry
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r < W) En[((i0 + r) * W + c) * LW] = acc[r] + Real(0);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i < W) En[(i * W + i) * LW] = En[(i * W + i) * LW] + Real(1);
    }
    __syncwarp(mask);                  // E complete, every read of the old one done
    cur ^= 1;
  }

  Real p1[R], p2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p1[r] = v1[r] * hs;
    p2[r] = v2[r] * (hs * hs);
  }

  // doubling ladder: the warp's largest step count, each lane masked at its
  // own; vector buffer b holds p1 in entries 0..W-1 and p2 in W..2W-1
  Real* const V[2] = {vec, vec + 2 * S::kVec};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i < W) {
      V[0][i * LW] = p1[r];
      V[0][(W + i) * LW] = p2[r];
    }
  }
  __syncwarp(mask);
  Real hc = hs;
  int vc = 0;
#pragma unroll 1
  for (int it = 0; it < n_warp; ++it) {
    const bool go = it < n_lane;
    const Real* Ec = Ep[cur];
    Real* En = Ep[cur ^ 1];
    const Real* Vc = V[vc];
    Real e[R][W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < W; ++j) e[r][j] = i0 + r < W ? Ec[((i0 + r) * W + j) * LW] : Real(0);
    }
    Real q1[R], q2[R];
    {
      const Real b1 = Vc[0], b2 = Vc[W * LW];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        q1[r] = e[r][0] * b1;
        q2[r] = e[r][0] * b2;
      }
    }
#pragma unroll
    for (int j = 1; j < W; ++j) {
      const Real b1 = Vc[j * LW], b2 = Vc[(W + j) * LW];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        q1[r] = real::fma(e[r][j], b1, q1[r]);
        q2[r] = real::fma(e[r][j], b2, q2[r]);
      }
    }
#pragma unroll 1
    for (int c = 0; c < W; ++c) {
      Real b[W], acc[R];
#pragma unroll
      for (int j = 0; j < W; ++j) b[j] = Ec[(j * W + c) * LW];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = e[r][0] * b[0];
#pragma unroll
      for (int j = 1; j < W; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = real::fma(e[r][j], b[j], acc[r]);
      }
      // a lane past its own count copies its E over once, at its first idle
      // step; both planes hold it from then on
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int at = ((i0 + r) * W + c) * LW;
        if (i0 + r < W && go) En[at] = acc[r];
        else if (i0 + r < W && it == n_lane) En[at] = Ec[at];
      }
    }
    if (go) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p2[r] = p2[r] + q2[r] + p1[r] * hc;
        p1[r] = p1[r] + q1[r];
      }
      hc = Real(2) * hc;
    }
    Real* Vn = V[vc ^ 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i < W) {
        Vn[i * LW] = p1[r];
        Vn[(W + i) * LW] = p2[r];
      }
    }
    __syncwarp(mask);                  // E, p1 and p2 complete; every read done
    cur ^= 1;
    vc ^= 1;
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i < W) {
        const size_t row = static_cast<size_t>(u) * W + i;
        Real* Eo = E_out + row * W * plane + lane;
#pragma unroll
        for (int c = 0; c < W; ++c) Eo[c * plane] = Ep[cur][(i * W + c) * LW];
        p1_out[row * plane + lane] = p1[r];
        p2_out[row * plane + lane] = p2[r];
      }
    }
  }
}

template <typename Real, int W, int R>
int launch(const void* L, const void* binv, const void* h_u, void* E, void* p1,
           void* p2, int U, int B, int ladder, int warps, cudaStream_t stream) {
  using S = Shape<W, R>;
  const size_t shared = static_cast<size_t>(warps) * S::kWarpWords * sizeof(Real);
  if (warps < 1 || warps > kMaxWarps || shared > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = phi_tables_wide_kernel<Real, W, R>;
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int lanes = warps * S::LW;
  const dim3 grid((B + lanes - 1) / lanes, U);
  kernel<<<grid, warps * 32, shared, stream>>>(
      static_cast<const Real*>(L), static_cast<const int*>(binv),
      static_cast<const Real*>(h_u), static_cast<Real*>(E),
      static_cast<Real*>(p1), static_cast<Real*>(p2), B, ladder);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (Bu, w, w, B), binv (U,) int32, h_u (U,), all on the device, L, h_u and
// the tables in the entry's type; writes E (U, w, w, B), p1 (U, w, B), p2
// (U, w, B). `rows` is R (rows of a lane's products a thread owns; the
// builds below, _WIDE_ROWS and _WIDE_ROWS_F64 in ops/phi_tables.py) and
// `warps` the warps a block. Launches on `stream` without synchronising and
// returns the first CUDA error code (0 on success).
#define WIDE_CASE(T, W, R)                                                        \
  if (w == W && rows == R)                                                        \
    return launch<T, W, R>(L, binv, h_u, E, p1, p2, U, B, ladder, warps,          \
                           static_cast<cudaStream_t>(stream));
extern "C" int phi_tables_wide_f32(const void* L, const void* binv, const void* h_u,
                                   void* E, void* p1, void* p2, int w, int U, int B,
                                   int ladder, int rows, int warps, void* stream) {
  WIDE_CASE(float, 9, 9) WIDE_CASE(float, 10, 5) WIDE_CASE(float, 11, 6)
  WIDE_CASE(float, 12, 6) WIDE_CASE(float, 13, 3) WIDE_CASE(float, 14, 5)
  WIDE_CASE(float, 15, 5) WIDE_CASE(float, 16, 4) WIDE_CASE(float, 17, 5)
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int phi_tables_wide_f64(const void* L, const void* binv, const void* h_u,
                                   void* E, void* p1, void* p2, int w, int U, int B,
                                   int ladder, int rows, int warps, void* stream) {
  WIDE_CASE(double, 9, 3) WIDE_CASE(double, 10, 3) WIDE_CASE(double, 11, 3)
  WIDE_CASE(double, 12, 3) WIDE_CASE(double, 13, 2) WIDE_CASE(double, 14, 2)
  WIDE_CASE(double, 15, 2) WIDE_CASE(double, 16, 2) WIDE_CASE(double, 17, 2)
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef WIDE_CASE

extern "C" const char* phi_tables_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
