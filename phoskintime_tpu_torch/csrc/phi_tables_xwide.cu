// ETD2RK propagator tables for the widest blocks, 18 <= w <= 129, in float32
// and float64 (one template, the width a runtime argument):
//   E = expm(L h),  p1 = h phi1(L h) e0,  p2 = h^2 phi2(L h) e0
// for every (bucket, h) pair and every lane. These widths are model 2's
// classes of 5, 6 and 7 sites (w = 33, 65, 129) and models 0 and 1 past 15
// sites (w = 2 + Smax).
//
// Replaces: phoskintime_tpu/ops/phi_pallas.py::phi_vectors_pallas_all
// above w = 17 (the Pallas entry takes any width; csrc/phi_tables_wide.cu
// takes 9..17). Plain PyTorch version:
// phoskintime_tpu_torch/ops/phi_tables.py::phi_tables_reference.
//
// Math: csrc/phi_tables_wide.cu's, step for step (its head note has the
// series, the Horner steps and the masked doubling ladder): the identity
// added after each Horner product, each lane's own squaring count clipped
// to `ladder`, correctly rounded divisions by the constant divisors. A
// lane's tables depend on nothing but its own inputs, so they do not
// depend on how lanes group into blocks, and a lane with a NaN is all NaN.
//
// What bounds it on this card. Per (pair, lane) the kernel reads w^2 words
// of L and writes w^2 + 2w words of tables, and runs (n - 1)(w^3 + w^2)
// (series and Horner, n terms) + s (w^3 + 2 w^2) (ladder) FMAs: 60-140
// FMAs a byte at w = 65, far above the H100's 10. So FMAs bound it: the
// FP32 pipes (67 TFLOP/s) in float32 and the FP64 tensor cores (67
// TFLOP/s, twice the FP64 pipes' 34) in float64. Registers, shared-memory
// traffic and the tensor cores are where the time goes.
//
// The design. A block owns LB lanes of one pair (the wrapper's
// xwide_launch_shape), or, in float64 where one lane's planes pass the 227
// KB a block may use (w >= 97), a cluster of two blocks owns one lane.
//   * A lane holds three planes in shared memory, row-major with a row
//     stride ld = 4 (mod 8): A = L h (scaled), and E and E' (ping-pong).
//     The rows run to K = w rounded up to 4 (8 in a cluster) and the
//     columns past w are zero: a zero row and column of A stay decoupled
//     through every product, so the padding is exact and no width mask
//     sits in an inner loop. Columns K..K+3 of A hold the series' v1, v2
//     and its term (two buffers), of E the ladder's p1 and p2 (ld >= K + 4
//     always). 3 K ld words a lane, no fourth plane.
//   * A/k is formed in registers as a tile loads A, by csrc/phi_tables_wide
//     .cu's Markstein division (q = x rk, then q + (x - q k) rk): the
//     correctly rounded quotient in both types wherever the lane's A holds
//     no entry outside [2^-120, 2^120] (float32; 2^-1000, 2^1000 in float64)
//     but zero; a lane that does takes quotient(), the same values.
//   * float32 products on the FP32 pipes: a thread owns a 4 x 8 tile (rows
//     rt + q nRT, columns 4 ct..4 ct+3 and H + 4 ct..H + 4 ct+3), the left
//     operand loaded as a float4 of four k along each row, the right one as
//     two float4 along row k: 12 shared loads feed 128 FMAs. Neighbouring
//     threads take neighbouring rows and columns, conflict-free with ld = 4
//     (mod 8). No TF32.
//   * float64 products on the tensor cores: mma.sync m16n8k4 .f64, a warp a
//     tile of 2 x 3 blocks of 16 x 8 up to w = 48 (7 fragment loads for 6
//     mma of 512 FMAs a step of four k) and of 1 x 3 above (more warps, so
//     the four schedulers of an SM share the tiles evenly: at w = 65, 15
//     warps of 3 in place of 9 of up to 6), fragments loaded from shared
//     memory (conflict-free with ld = 4 (mod 8)). m16n8k4, a 16-row form
//     sm_90 adds, leaves the registers for the 2 x 3 tile (m16n8k8's
//     spilled). The FMAs on the padding (65 -> 80 rows, 72 columns) are
//     done, not counted: the bound is stated on the unpadded work.
//   * The ladder's step is one product E [E | p1 | p2] of K + 2 columns; its
//     epilogue forms p1 += E p1 and p2 += E p2 + hc p1. A lane steps while it
//     is below its own count and keeps its own parity of the ping-pong, so a
//     lane that stops copies nothing.
//   * The series splits each row's dot product over lanes of a warp (a
//     shuffle reduction), as many as give every row its lanes in one round:
//     every thread works. Its n - 1 steps run in the n - 1 Horner phases,
//     each beside a product under the same barrier.
//   * In a cluster each block holds half of every plane's rows and reads the
//     other half of the right operand through distributed shared memory; a
//     cluster barrier closes each phase.
// Against the first version of this kernel (4 x 4 tiles of scalar loads,
// two shared loads an FMA, a thread a row in the matrix-vector phases, an
// A/k plane, FP64 FMAs): 12 shared loads for 128 FMAs; the matrix-vector
// phases on every thread, the ladder's folded into its product, the series'
// steps under the Horner phases' barriers; three planes in place of four;
// FP64 on the tensor cores; integer division by the block's constants as a
// multiply (2-12% of the time) and power-of-two divisors as a multiply (up to
// 1.4%); no spill in any instance. On an H100 (tools/kernel_ab.py, same
// card) that took model 2's w = 65 class from 29.8 to 12.0 ms in float32
// and from 66.1 to 19.2 ms in float64, past torch.linalg.matrix_exp (26.3
// and 45.2 ms); PERF.md, section 6, has every width and phase.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "real.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T> struct Series;
template <> struct Series<float> {
  static constexpr int kTerms = 8;
  static constexpr float kRadius = 0.5f;
  static constexpr float kLo = 0x1p-120f, kHi = 0x1p120f;   // the fast quotient's range
};
template <> struct Series<double> {
  static constexpr int kTerms = 12;
  static constexpr double kRadius = 0.25;
  static constexpr double kLo = 0x1p-1000, kHi = 0x1p1000;
};
constexpr int kMaxThreads = 512;
constexpr int kMinWidth = 18;
constexpr int kMaxWidth = 129;
constexpr int kMaxShared = 232448;
constexpr int kDefaultShared = 48 * 1024;
constexpr int kMargin = 8;         // words after a plane: the columns a tile reads past ld
constexpr int kNB = 3;             // float64: a warp's tile, kMB blocks of 16 rows by kNB
                                   // blocks of 8 columns (kMB a template argument)
// float64 up to this width takes warp tiles of 2 x 3 blocks, above it 1 x 3
// (the wrapper's _XWIDE_TALL_MAX_W)
constexpr int kTallMaxWidth = 48;

// A plane: `rows` rows of stride ld (K rows, or K / 2 in a cluster of two)
struct Layout {
  int K, rows, ld, plane;
};

__host__ __device__ inline Layout layout(int w, int cluster) {
  const int K = cluster == 2 ? (w + 7) / 8 * 8 : (w + 3) / 4 * 4;
  const int ld = (K + 5) / 8 * 8 + 4;            // the least ld >= K + 2 with ld = 4 (mod 8)
  const int rows = K / cluster;
  return {K, rows, ld, rows * ld + kMargin};
}

// LB lanes' three planes, then hs, 2^-s of each lane and 4 words the
// cluster's blocks exchange, then each lane's step count and quotient route
__host__ __device__ inline size_t shared_bytes(int w, int LB, int cluster, size_t item) {
  const Layout g = layout(w, cluster);
  return item * (3 * static_cast<size_t>(LB) * g.plane + 2 * LB + 4) + sizeof(int) * 2 * LB;
}

// x / k for a constant divisor k > 0, rk its correctly rounded reciprocal:
// csrc/phi_tables_wide.cu's Markstein correction, the correctly rounded
// quotient in either type; `off` is set outside the normal range (the
// caller then divides with the operator), a zero x returned as it is
__device__ __forceinline__ float div_k(float x, float k, float rk, bool& off) {
  const float q = x * rk;
  const float q1 = fmaf(fmaf(-q, k, x), rk, q);
  const float m = fabsf(q1);
  off = off || (x != 0.0f && !(m >= 0x1p-124f && m <= 0x1p124f));
  return x == 0.0f ? x : q1;
}
__device__ __forceinline__ double div_k(double x, double k, double rk, bool& off) {
  const double q = x * rk;
  const double q1 = ::fma(::fma(-q, k, x), rk, q);
  const double m = ::fabs(q1);
  off = off || (x != 0.0 && !(m >= 0x1p-1000 && m <= 0x1p1000));
  return x == 0.0 ? x : q1;
}

template <typename Real>
__device__ __forceinline__ Real quotient(Real x, Real k, Real rk) {
  bool off = false;
  const Real q = div_k(x, k, rk, off);
  return off ? x / k : q;
}

// the same quotient where x is zero or inside [kLo, kHi]
template <typename Real>
__device__ __forceinline__ Real quotient_fast(Real x, Real k, Real rk) {
  const Real q = x * rk;
  return real::fma(real::fma(-q, k, x), rk, q);
}

// x 2^n, exact (the plain version's hc doubled n times)
__device__ __forceinline__ float times_pow2(float x, int n) { return scalbnf(x, n); }
__device__ __forceinline__ double times_pow2(double x, int n) { return scalbn(x, n); }

// n / d and n % d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery's division by invariant integers): the elementwise phases divide
// by the lanes a block and the width, fixed for a block, where an integer
// divide would cost a few dozen instructions. A build with `/` and `%` here
// was 2-12% slower at 3h's classes, with the same bits (tools/kernel_ab.py,
// H100 80GB HBM3 at 700 W; PERF.md, section 6)
struct FastDiv {
  unsigned d, m, s;
  __device__ explicit FastDiv(int divisor) : d(static_cast<unsigned>(divisor)), s(0) {
    while ((1u << s) < d) ++s;
    m = static_cast<unsigned>(((((1ull << s) - d) << 32) / d) + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    const unsigned u = static_cast<unsigned>(n);
    return static_cast<int>((__umulhi(m, u) + u) >> s);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * static_cast<int>(d); }
};

template <int kCluster>
__device__ __forceinline__ void barrier() {
  if constexpr (kCluster == 2) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

enum Op { kHorner = 0, kLadder = 1 };
// how a product's left operand is taken: as it is (k = 1), times 1/k (k a power
// of two: exact, x / k itself), over k fast, over k by quotient(). kScale gives
// kFast's bits with one operation in place of three: a build without it was
// 0.4-1.4% slower at w = 22 and 33 and level at w = 65 (tools/kernel_ab.py, H100)
enum Quot { kPlain = 0, kScale = 1, kFast = 2, kExact = 3 };

template <int kQ, typename Real>
__device__ __forceinline__ Real take(Real x, Real kf, Real rk) {
  if constexpr (kQ == kScale) return x * rk;
  if constexpr (kQ == kFast) return quotient_fast(x, kf, rk);
  if constexpr (kQ == kExact) return quotient(x, kf, rk);
  return x;
}

// the route for a divisor k >= 1 where the lane's A is in the fast range
template <typename Real>
__device__ __forceinline__ int quotient_route(Real kf) {
  const int k = static_cast<int>(kf);
  return k == 1 ? kPlain : (k & (k - 1)) == 0 ? kScale : kFast;
}

// ---- float32: 4 x 8 register tiles on the FP32 pipes ----------------------------------

// acc += X Y over k < K for one tile: X rows at offsets xr[q], Y columns c0..c0+3
// and c0+H..c0+H+3
template <int kQ>
__device__ __forceinline__ void mac_f32(const float* X, const int (&xr)[4], const float* Y,
                                        int ld, int K, int c0, int H, float kf, float rk,
                                        float (&acc)[4][8]) {
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 4) {
    float x[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(X + xr[q] + kk);
      x[q][0] = take<kQ>(v.x, kf, rk);
      x[q][1] = take<kQ>(v.y, kf, rk);
      x[q][2] = take<kQ>(v.z, kf, rk);
      x[q][3] = take<kQ>(v.w, kf, rk);
    }
    const float* yr = Y + kk * ld + c0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float4 ya = *reinterpret_cast<const float4*>(yr + d * ld);
      const float4 yb = *reinterpret_cast<const float4*>(yr + d * ld + H);
      const float y[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(x[q][d], y[c], acc[q][c]);
      }
    }
  }
}

// Horner: E' = I + (A/k) E; ladder: E' = E [E | p1 | p2] with the p-update
template <int kOp>
__device__ void product_f32(float* smem, int lanestride, int plane, int LB, int w, int K,
                            int ld, int src, int dst, float kf, const int* n_l,
                            const int* tiny_l, const float* hs_l, int it) {
  const int nRT = K / 4;
  const int nCT = ((kOp == kHorner ? w : K + 2) + 7) / 8;
  const int H = 4 * nCT;
  const int per = nRT * nCT;
  const int route = quotient_route(kf);
  const float rk = real::rcp(kf);
  for (int t = threadIdx.x; t < LB * per; t += blockDim.x) {
    const int l = t / per, rem = t - l * per;
    const int rt = rem / nCT, ct = rem - rt * nCT;
    if (kOp == kLadder && !(it < n_l[l])) continue;
    float* const base = smem + l * lanestride;
    const float* X = base + (kOp == kHorner ? 0 : src * plane);
    const float* Y = base + src * plane;
    float* C = base + dst * plane;
    int xr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) xr[q] = (rt + q * nRT) * ld;
    const int c0 = 4 * ct;
    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[q][c] = 0.0f;
    }
    const int q = route == kPlain || !tiny_l[l] ? route : kExact;
    if (q == kFast) {
      mac_f32<kFast>(X, xr, Y, ld, K, c0, H, kf, rk, acc);
    } else if (q == kScale) {
      mac_f32<kScale>(X, xr, Y, ld, K, c0, H, kf, rk, acc);
    } else if (q == kExact) {
      mac_f32<kExact>(X, xr, Y, ld, K, c0, H, kf, rk, acc);
    } else {
      mac_f32<kPlain>(X, xr, Y, ld, K, c0, H, kf, rk, acc);
    }
    const float hc = kOp == kLadder ? times_pow2(hs_l[l], it) : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = rt + q * nRT;
      if (i >= w) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + half * H;
        float v[4] = {acc[q][4 * half], acc[q][4 * half + 1], acc[q][4 * half + 2],
                      acc[q][4 * half + 3]};
        if (c + 4 <= K) {
          if (kOp == kHorner) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] += i == c + e ? 1.0f : 0.0f;
          }
          *reinterpret_cast<float4*>(C + i * ld + c) = make_float4(v[0], v[1], v[2], v[3]);
        } else if (kOp == kLadder && c == K) {
          const float p1 = X[i * ld + K], p2 = X[i * ld + K + 1];
          C[i * ld + K + 1] = p2 + v[1] + p1 * hc;
          C[i * ld + K] = p1 + v[0];
        }
      }
    }
  }
}

// ---- float64: mma.sync on the FP64 tensor cores -------------------------------------

// d += a b for one block of 16 x 8 by m16n8k4: a0 (g, t), a1 (g+8, t) of the 16 x 4
// left block, b0 (t, g) of the 4 x 8 right block; d0, d1 columns 2t, 2t+1 of row g,
// d2, d3 of row g+8 (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_k4(double (&d)[4], double a0, double a1, double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// acc += X Y over the k of one half of the rows of Y (Yh, `rows` rows, a
// multiple of 4), X's columns from kofs: ar[m] the offsets of rows g and g+8 of
// row block m, bc[n] column g of column block n
template <int kQ, int kMB>
__device__ __forceinline__ void mac_f64(const double* X, const int (&ar)[kMB][2], int kofs,
                                        const double* Yh, const int (&bc)[kNB], int ld,
                                        int rows, const bool (&mv)[kMB],
                                        const bool (&nv)[kNB], int t, double kf, double rk,
                                        double (&acc)[kMB][kNB][4]) {
#pragma unroll 2
  for (int kk = 0; kk < rows; kk += 4) {
    double a[kMB][2], b[kNB];
#pragma unroll
    for (int m = 0; m < kMB; ++m) {
      a[m][0] = mv[m] ? take<kQ>(X[ar[m][0] + kofs + kk + t], kf, rk) : 0.0;
      a[m][1] = mv[m] ? take<kQ>(X[ar[m][1] + kofs + kk + t], kf, rk) : 0.0;
    }
    const double* y = Yh + (kk + t) * ld;
#pragma unroll
    for (int n = 0; n < kNB; ++n) b[n] = nv[n] ? y[bc[n]] : 0.0;
#pragma unroll
    for (int m = 0; m < kMB; ++m) {
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        if (mv[m] && nv[n]) mma_k4(acc[m][n], a[m][0], a[m][1], b[n]);
      }
    }
  }
}

// Horner and ladder products as product_f32's, a warp a tile of kMB blocks of 16
// rows by kNB blocks of 8 columns; in a cluster the block's rows are
// r0..r0+rows-1 and the other half of Y is the other block's
template <int kOp, int kCluster, int kMB>
__device__ void product_f64(double* smem, int lanestride, int plane, int LB, int w, int K,
                            int rows, int ld, int r0, int rank, int src, int dst, double kf,
                            const int* n_l, const int* tiny_l, const double* hs_l, int it) {
  const int nrow = max(0, min(rows, w - r0));
  const int nMB = (nrow + 15) / 16;
  const int nNB = ((kOp == kHorner ? w : K + 2) + 7) / 8;
  const int nCG = (nNB + kNB - 1) / kNB;
  const int per = ((nMB + kMB - 1) / kMB) * nCG;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int route = quotient_route(kf);
  const double rk = real::rcp(kf);
  for (int task = threadIdx.x >> 5; task < LB * per; task += blockDim.x >> 5) {
    const int l = task / per, rem = task - l * per;
    const int rg = rem / nCG, cgi = rem - rg * nCG;
    if (kOp == kLadder && !(it < n_l[l])) continue;
    double* const base = smem + l * lanestride;
    const double* X = base + (kOp == kHorner ? 0 : src * plane);
    const double* Y = base + src * plane;
    double* C = base + dst * plane;
    int ar[kMB][2], bc[kNB];
    bool mv[kMB], nv[kNB];
#pragma unroll
    for (int m = 0; m < kMB; ++m) {
      const int mb = rg * kMB + m;
      mv[m] = mb < nMB;
      ar[m][0] = min(mb * 16 + g, rows - 1) * ld;
      ar[m][1] = min(mb * 16 + g + 8, rows - 1) * ld;
    }
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int nb = cgi * kNB + n;
      nv[n] = nb < nNB;
      bc[n] = nb * 8 + g;
    }
    double acc[kMB][kNB][4];
#pragma unroll
    for (int m = 0; m < kMB; ++m) {
#pragma unroll
      for (int n = 0; n < kNB; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0;
    }
    const int q = route == kPlain || !tiny_l[l] ? route : kExact;
#pragma unroll 1
    for (int hf = 0; hf < kCluster; ++hf) {
      const double* Yh = Y;
      if constexpr (kCluster == 2) {
        if (hf != rank) Yh = cg::this_cluster().map_shared_rank(Y, hf);
      }
      const int kofs = hf * rows;
      if (q == kFast) {
        mac_f64<kFast, kMB>(X, ar, kofs, Yh, bc, ld, rows, mv, nv, t, kf, rk, acc);
      } else if (q == kScale) {
        mac_f64<kScale, kMB>(X, ar, kofs, Yh, bc, ld, rows, mv, nv, t, kf, rk, acc);
      } else if (q == kExact) {
        mac_f64<kExact, kMB>(X, ar, kofs, Yh, bc, ld, rows, mv, nv, t, kf, rk, acc);
      } else {
        mac_f64<kPlain, kMB>(X, ar, kofs, Yh, bc, ld, rows, mv, nv, t, kf, rk, acc);
      }
    }
    const double hc = kOp == kLadder ? times_pow2(hs_l[l], it) : 0.0;
    // one row's pair of columns c, c+1: Horner's I added, the ladder's p-update
    const auto put = [&](int i, int c, double v0, double v1) {
      if (i >= nrow) return;
      const int ig = r0 + i;
      if (c < K) {
        if (kOp == kHorner) {
          if (ig == c) v0 += 1.0;
          if (ig == c + 1) v1 += 1.0;
        }
        *reinterpret_cast<double2*>(C + i * ld + c) = make_double2(v0, v1);
      } else if (kOp == kLadder && c == K) {
        const double p1 = X[i * ld + K], p2 = X[i * ld + K + 1];
        C[i * ld + K + 1] = p2 + v1 + p1 * hc;
        C[i * ld + K] = p1 + v0;
      }
    };
#pragma unroll
    for (int m = 0; m < kMB; ++m) {
      if (!mv[m]) continue;
      const int i = (rg * kMB + m) * 16 + g;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        if (!nv[n]) continue;
        const int c = (cgi * kNB + n) * 8 + 2 * t;
        put(i, c, acc[m][n][0], acc[m][n][1]);
        put(i + 8, c, acc[m][n][2], acc[m][n][3]);
      }
    }
  }
}

template <int kOp, int kCluster, int kMB, typename Real>
__device__ __forceinline__ void product(Real* smem, int lanestride, const Layout& g, int LB,
                                        int w, int r0, int rank, int src, int dst, Real kf,
                                        const int* n_l, const int* tiny_l, const Real* hs_l,
                                        int it) {
  if constexpr (sizeof(Real) == 4) {
    product_f32<kOp>(smem, lanestride, g.plane, LB, w, g.K, g.ld, src, dst, kf, n_l, tiny_l,
                     hs_l, it);
  } else {
    product_f64<kOp, kCluster, kMB>(smem, lanestride, g.plane, LB, w, g.K, g.rows, g.ld, r0,
                                    rank, src, dst, kf, n_l, tiny_l, hs_l, it);
  }
}

// Planes of lane l: 0 A, 1 and 2 the two E planes.
template <typename Real, int kCluster, int kMB>
__global__ void __launch_bounds__(kMaxThreads)
phi_tables_xwide_kernel(const Real* __restrict__ L, const int* __restrict__ binv,
                        const Real* __restrict__ h_u, Real* __restrict__ E_out,
                        Real* __restrict__ p1_out, Real* __restrict__ p2_out,
                        int w, int B, int ladder, int LB) {
  constexpr int kTerms = Series<Real>::kTerms;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Real* const smem = reinterpret_cast<Real*>(smem_raw);
  const Layout g = layout(w, kCluster);
  const int K = g.K, ld = g.ld, plane = g.plane, lanestride = 3 * plane;
  Real* const hs_l = smem + LB * lanestride;          // a lane's h / 2^s
  Real* const inv_l = hs_l + LB;                      // and 2^-s
  Real* const xchg = inv_l + LB;                      // the blocks' (norm, finite) in a cluster
  int* const n_l = reinterpret_cast<int*>(xchg + 4);  // a lane's step count
  int* const tiny_l = n_l + LB;                       // and whether it takes quotient()
  int rank = 0;
  if constexpr (kCluster == 2) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int r0 = rank * g.rows;                       // the first row this block holds
  const int nrow = max(0, min(g.rows, w - r0));       // its rows inside the block
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid >> 5, wl = tid & 31, nwarps = nth >> 5;
  const int lane0 = (blockIdx.x / kCluster) * LB;
  const int u = blockIdx.y;
  const size_t stride = static_cast<size_t>(B);
  const Real h = h_u[u];
  const Real* const Lb = L + static_cast<size_t>(binv[u]) * w * w * stride;
  const FastDiv byLB(LB), byW(w);
  const auto P = [&](int l, int p) { return smem + l * lanestride + p * plane; };

  for (int e = tid; e < LB * lanestride * static_cast<int>(sizeof(Real)) / 16; e += nth)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  barrier<kCluster>();   // in a cluster: both blocks have started before either writes the other
  // A = L h for the block's rows, eight loads in flight a thread; lanes past B
  // hold a zero block
  for (int e0 = tid; e0 < LB * nrow * w; e0 += 8 * nth) {
    Real v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = e0 + q * nth, lane = lane0 + byLB.mod(e);
      v[q] = e < LB * nrow * w && lane < B ? Lb[(r0 * w + byLB.div(e)) * stride + lane] : Real(0);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = e0 + q * nth;
      if (e < LB * nrow * w) {
        const int l = byLB.mod(e), ij = byLB.div(e), i = byW.div(ij), j = ij - i * w;
        P(l, 0)[i * ld + j] = v[q] * h;
      }
    }
  }
  __syncthreads();
  // row sums of |A| (into plane 1), then each lane's inf-norm and step count
  for (int e = tid; e < LB * nrow; e += nth) {
    const int l = byLB.mod(e), i = byLB.div(e);
    const Real* a = P(l, 0) + i * ld;
    Real row = Real(0);
    for (int j = 0; j < w; ++j) row += real::abs(a[j]);
    P(l, 1)[i] = row;
  }
  __syncthreads();
  const auto partial = [&](int l, Real& norm, bool& finite) {
    norm = Real(0);
    finite = true;
    for (int i = 0; i < nrow; ++i) {
      const Real v = P(l, 1)[i];
      finite = finite && (v == v);
      norm = real::max(norm, v);
    }
  };
  const auto steps = [&](int l, Real norm, bool finite) {
    Real s = real::ceil(real::log2(real::max(norm, Real(1e-30)) / Series<Real>::kRadius));
    s = real::min(real::max(s, Real(0)), static_cast<Real>(ladder));
    const Real scale = finite ? real::exp2(s) : real::nan<Real>();
    n_l[l] = finite ? static_cast<int>(s) : 0;
    inv_l[l] = finite ? real::exp2(-s) : scale;   // x / 2^s = x 2^-s exactly
    hs_l[l] = h / scale;
    tiny_l[l] = 0;
  };
  if constexpr (kCluster == 2) {
    if (tid == 0) {
      Real norm;
      bool finite;
      partial(0, norm, finite);
      Real* other = cg::this_cluster().map_shared_rank(xchg, rank ^ 1);
      xchg[2 * rank] = other[2 * rank] = norm;
      xchg[2 * rank + 1] = other[2 * rank + 1] = finite ? Real(1) : Real(0);
    }
    barrier<2>();
    if (tid == 0) {
      steps(0, real::max(xchg[0], xchg[2]), xchg[1] != Real(0) && xchg[3] != Real(0));
    }
  } else {
    for (int l = tid; l < LB; l += nth) {
      Real norm;
      bool finite;
      partial(l, norm, finite);
      steps(l, norm, finite);
    }
  }
  __syncthreads();

  // A /= 2^s; E = I + A/n into plane 1 (n the series' terms); the series'
  // first term A e0 (column K+2 of A), v1 and v2 (columns K, K+1); whether a
  // lane's A leaves the fast quotient's range
  for (int e = tid; e < LB * nrow * w; e += nth) {
    const int l = byLB.mod(e), ij = byLB.div(e), i = byW.div(ij), j = ij - i * w;
    const int ig = r0 + i;
    Real* const a = P(l, 0) + i * ld;
    const Real x = a[j] * inv_l[l];
    a[j] = x;
    const Real m = real::abs(x);
    if (x != Real(0) && !(m >= Series<Real>::kLo && m <= Series<Real>::kHi)) tiny_l[l] = 1;
    P(l, 1)[i * ld + j] = x * (Real(1) / Real(kTerms)) + (ig == j ? Real(1) : Real(0));
    if (j == 0) {
      a[K + 2] = x;
      a[K] = (ig == 0 ? Real(1) : Real(0)) + x * Real(0.5);
      a[K + 1] = (ig == 0 ? Real(0.5) : Real(0)) + x / Real(6);
    }
  }
  barrier<kCluster>();

  // phi1 / phi2 e0: term = (A term) / k, v1 += term / (k+1), v2 += term / ((k+1)(k+2)),
  // one step a Horner phase (both take n - 1 steps, and neither reads what the other
  // writes), each row's dot product split over `seg` lanes of a warp: the most (a
  // power of two up to 32) that still give every row of the block its lanes in one
  // round. Term j of buffer tc is column K + 2 + tc of A's row j, in a cluster
  // the other block's A for the other half.
  int seg = 32;
  while (seg > 1 && nth / seg < LB * nrow) seg >>= 1;
  const Real* A_other = P(0, 0);                       // the other block's A, in a cluster
  if constexpr (kCluster == 2) A_other = cg::this_cluster().map_shared_rank(P(0, 0), rank ^ 1);
  const auto series_step = [&](int k, int tc) {
    const Real d0 = k, d1 = k + 1, d2 = (k + 1) * (k + 2);
    const Real q0 = real::rcp(d0), q1 = real::rcp(d1), q2 = real::rcp(d2);
    const auto tv = [&](int l, int j) {
      if constexpr (kCluster == 2) {
        const int o = j >= g.rows;
        return (o == rank ? P(0, 0) : A_other)[(j - o * g.rows) * ld + K + 2 + tc];
      } else {
        return P(l, 0)[j * ld + K + 2 + tc];
      }
    };
    for (int first = warp * (32 / seg); first < LB * nrow; first += nwarps * (32 / seg)) {
      const int task = first + wl / seg, part = wl % seg;
      const bool on = task < LB * nrow;
      const int l = on ? byLB.mod(task) : 0, i = on ? byLB.div(task) : 0;
      Real* const a = P(l, 0) + i * ld;
      Real acc4[4] = {Real(0), Real(0), Real(0), Real(0)};   // four chains, one a j mod 4 seg
      if (on) {
        int j = part;
        for (; j + 3 * seg < w; j += 4 * seg) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc4[q] = real::fma(a[j + q * seg], tv(l, j + q * seg), acc4[q]);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (j + q * seg < w) acc4[q] = real::fma(a[j + q * seg], tv(l, j + q * seg), acc4[q]);
        }
      }
      Real acc = (acc4[0] + acc4[1]) + (acc4[2] + acc4[3]);
      for (int o = seg / 2; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (on && part == 0) {
        const Real term = quotient(acc, d0, q0);
        a[K + 2 + (tc ^ 1)] = term;
        a[K] = a[K] + quotient(term, d1, q1);
        a[K + 1] = a[K + 1] + quotient(term, d2, q2);
      }
    }
  };

  // E = expm(A) by Horner: E = I + (A/k) E for k = n-1..1, plane to plane, beside
  // the series' terms 2..n
  int cur = 0;
#pragma unroll 1
  for (int k = kTerms - 1; k >= 1; --k) {
    product<kHorner, kCluster, kMB>(smem, lanestride, g, LB, w, r0, rank, 1 + cur, 2 - cur,
                                    static_cast<Real>(k), n_l, tiny_l, hs_l, 0);
    series_step(kTerms + 1 - k, cur);
    barrier<kCluster>();
    cur ^= 1;
  }

  // p1 = v1 hs, p2 = v2 hs^2 into columns K, K+1 of E
  for (int e = tid; e < LB * nrow; e += nth) {
    const int l = byLB.mod(e), i = byLB.div(e);
    const Real hs = hs_l[l];
    const Real* a = P(l, 0) + i * ld;
    Real* const E = P(l, 1 + cur) + i * ld;
    E[K] = a[K] * hs;
    E[K + 1] = a[K + 1] * (hs * hs);
  }
  int n_block = 0;
  for (int l = 0; l < LB; ++l) n_block = max(n_block, n_l[l]);
  barrier<kCluster>();

  // doubling ladder: [E | p1 | p2] <- E [E | p1 | p2], then p1 += E p1 and
  // p2 += E p2 + hc p1, while it < the lane's own count, hc = hs 2^it
#pragma unroll 1
  for (int it = 0; it < n_block; ++it) {
    const int src = 1 + ((cur + it) & 1);
    product<kLadder, kCluster, kMB>(smem, lanestride, g, LB, w, r0, rank, src, 3 - src, Real(1),
                                    n_l, tiny_l, hs_l, it);
    barrier<kCluster>();
  }

  for (int e = tid; e < LB * nrow * w; e += nth) {
    const int l = byLB.mod(e), ij = byLB.div(e), i = byW.div(ij), j = ij - i * w;
    const int lane = lane0 + l;
    if (lane < B) {
      const Real* Ef = P(l, 1 + ((cur + n_l[l]) & 1));
      E_out[(static_cast<size_t>(u) * w * w + (r0 + i) * w + j) * stride + lane] = Ef[i * ld + j];
    }
  }
  for (int e = tid; e < LB * nrow; e += nth) {
    const int l = byLB.mod(e), i = byLB.div(e);
    const int lane = lane0 + l;
    if (lane < B) {
      const Real* Ef = P(l, 1 + ((cur + n_l[l]) & 1)) + i * ld;
      const size_t row = (static_cast<size_t>(u) * w + r0 + i) * stride + lane;
      p1_out[row] = Ef[K];
      p2_out[row] = Ef[K + 1];
    }
  }
  if constexpr (kCluster == 2) barrier<2>();   // no block leaves while the other reads it
}

template <typename Real, int kCluster, int kMB>
int launch_as(const void* L, const void* binv, const void* h_u, void* E, void* p1, void* p2,
              int w, int U, int B, int ladder, int LB, int threads, size_t shared,
              cudaStream_t stream) {
  const auto kernel = phi_tables_xwide_kernel<Real, kCluster, kMB>;
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * ((B + LB - 1) / LB), U);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster == 2 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Real*>(L), static_cast<const int*>(binv),
      static_cast<const Real*>(h_u), static_cast<Real*>(E), static_cast<Real*>(p1),
      static_cast<Real*>(p2), w, B, ladder, LB);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <typename Real>
int launch(const void* L, const void* binv, const void* h_u, void* E, void* p1, void* p2,
           int w, int U, int B, int ladder, int LB, int threads, int cluster,
           cudaStream_t stream) {
  // the wrapper's layout (ops/phi_tables.py::xwide_launch_shape); a cluster of
  // two takes float64 and one lane
  const bool pair = cluster == 2 && sizeof(Real) == 8 && LB == 1;
  if (w < kMinWidth || w > kMaxWidth || LB < 1 || threads < 32 || threads > kMaxThreads
      || threads % 32 || !(cluster == 1 || pair))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = shared_bytes(w, LB, cluster, sizeof(Real));
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(Real) == 8) {
    if (pair) return launch_as<Real, 2, 1>(L, binv, h_u, E, p1, p2, w, U, B, ladder, LB, threads,
                                           shared, stream);
    if (w > kTallMaxWidth)
      return launch_as<Real, 1, 1>(L, binv, h_u, E, p1, p2, w, U, B, ladder, LB, threads, shared,
                                   stream);
    return launch_as<Real, 1, 2>(L, binv, h_u, E, p1, p2, w, U, B, ladder, LB, threads, shared,
                                 stream);
  }
  return launch_as<Real, 1, 1>(L, binv, h_u, E, p1, p2, w, U, B, ladder, LB, threads, shared,
                               stream);
}

}  // namespace

// L (Bu, w, w, B), binv (U,) int32, h_u (U,), all on the device, L, h_u and
// the tables in the entry's type; writes E (U, w, w, B), p1 (U, w, B), p2
// (U, w, B) for 18 <= w <= 129. `lanes` is LB, the lanes a block, `threads`
// the threads a block and `cluster` the blocks a lane (1, or 2 in float64:
// ops/phi_tables.py::xwide_launch_shape). Launches on `stream` without
// synchronising and returns the first CUDA error code (0 on success).
extern "C" int phi_tables_xwide_f32(const void* L, const void* binv, const void* h_u, void* E,
                                    void* p1, void* p2, int w, int U, int B, int ladder,
                                    int lanes, int threads, int cluster, void* stream) {
  return launch<float>(L, binv, h_u, E, p1, p2, w, U, B, ladder, lanes, threads, cluster,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int phi_tables_xwide_f64(const void* L, const void* binv, const void* h_u, void* E,
                                    void* p1, void* p2, int w, int U, int B, int ladder,
                                    int lanes, int threads, int cluster, void* stream) {
  return launch<double>(L, binv, h_u, E, p1, p2, w, U, B, ladder, lanes, threads, cluster,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* phi_tables_xwide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
