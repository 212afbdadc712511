// ETD2RK propagator tables at every width w >= 130 (past csrc/phi_tables_
// xwide.cu's 129), in float32 and float64, the width a runtime argument:
//   E = expm(L h),  p1 = h phi1(L h) e0,  p2 = h^2 phi2(L h) e0
// for every (bucket, h) pair and every lane. w = 257 is model 2's class of 8
// sites (w = 1 + 2^Smax), w = 513 of 9.
//
// Replaces: phoskintime_tpu/ops/phi_pallas.py::phi_vectors_pallas_all above
// w = 129 (the Pallas entry takes any width; csrc/phi_tables_xwide.cu holds a
// lane's planes in shared memory and stops at 129). Plain PyTorch version:
// phoskintime_tpu_torch/ops/phi_tables.py::phi_tables_reference.
//
// Math: the series, Horner steps and masked doubling ladder of
// csrc/phi_tables_xwide.cu (each lane's own squaring count clipped to
// `ladder`, a lane with a NaN all NaN), with one difference in rounding: a
// product's 1/k and the lane's 2^-s are applied to its sums in the epilogue,
// (A E) 2^-s / k, where the plain version forms (A 2^-s / k) E. 2^-s is
// exact; the plain version's order is matched to the tolerance, not bit for
// bit.
//
// What bounds it on this card. Per (pair, lane) the kernel reads w^2 words of
// L and writes w^2 + 2w words of tables, and runs (n - 1)(w^3 + w^2) + s (w^3
// + 2 w^2) FMAs (n series terms, s squarings): thousands of FMAs a byte at w
// = 257. So FMAs bound it: the FP32 pipes (67 TFLOP/s) in float32, the FP64
// tensor cores (67 TFLOP/s) in float64.
//
// The design. At w = 257 one float32 plane is 264 KB: a lane's three planes
// do not fit a block's 227 KB, nor a cluster's past w of about 365 (float32)
// and 257 (float64). So the planes live in device memory, and L2 keeps them:
//   * A cluster of kCluster blocks (8, the portable maximum) owns one lane
//     of one pair at a time and walks the (pair, lane) items in strides of
//     the clusters the grid holds (`slots`), lanes fastest, so that the
//     clusters in flight read neighbouring lanes of L and write neighbouring
//     lanes of the tables: a 32-byte sector of L and of the tables holds 8
//     float32 (4 float64) lanes, and its other lanes come from L2. No
//     transposition pass.
//   * A slot (a cluster's scratch in device memory, `slot_words` words) holds
//     three planes, A = L h, and E, E' (ping-pong), R x ld each (R = w
//     rounded up to the 64-row tile, ld = K + 3 rounded up to 64, K = w
//     rounded up to the k-step), zero outside the lane's block: a zero row
//     and column stay decoupled through every product, so the padding is
//     exact. Columns K, K+1, K+2 of E hold the series' term, v1 and v2, then
//     the ladder's p1 and p2: each product carries them as extra columns of
//     its right operand. The slots of the grid, as many as the card holds
//     clusters at once (15 on the H100 by the occupancy API, one block an
//     SM: 18.4 MB at w = 257 in float32), stay in L2; a grid of no more
//     clusters runs in one wave, every cluster with the same count of
//     items, give or take one.
//   * Each product C = X Y runs as a tiled GEMM: a block takes 64 x 64
//     output tiles (the cluster's blocks in turn), walks k in steps of 128
//     bytes of row, and copies each step's X and Y tiles into shared memory
//     with 16-byte cp.async.cg copies, two stages, the next step's copies in
//     flight while the current one is multiplied. cp.async works in the
//     generic proxy and reads L2 (not L1), so a product sees the stores of
//     the cluster's other blocks once the cluster barrier has passed, with
//     no proxy fence (a TMA or bulk copy would need one after every
//     epilogue).
//   * float32 products on the FP32 pipes: a thread owns a 4 x 4 tile of
//     accumulators, fed by float4 loads of four k along each of its rows
//     and four columns along each k (broadcast and conflict-free). No TF32.
//   * float64 products on the tensor cores: mma.sync m16n8k4 .f64, a warp a
//     16 x 32 tile (4 blocks of 16 x 8), fragments from shared memory with
//     row strides of 4 (mod 16) words, conflict-free.
//   * The epilogue goes through shared memory (the tile's sums, then a
//     thread 16 columns of a row), so the columns K..K+2 of a row are one
//     thread's: the Horner step E' = I + (A E)/k, the series step term' = (A
//     term)/k', v1 += term'/(k'+1), v2 += term'/((k'+1)(k'+2)) and, at the
//     last Horner step, p1 = v1 hs and p2 = v2 hs^2; the ladder step [E | p1
//     | p2] <- E [E | p1 | p2], p1 += E p1, p2 += E p2 + hc p1.
//   * A lane's s squarings are its own: the cluster runs exactly s ladder
//     steps, so no mask sits in a product. The cluster's blocks meet at the
//     cluster barrier (after a fence) between dependent products.
// The padding costs work: at w = 257 a product covers 320 x 320 outputs over
// K = 288 (float32), 1.7 times the unpadded FMAs, and the 25 tiles take four
// rounds of 8 blocks. The bound is stated on the unpadded work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "real.cuh"

namespace cg = cooperative_groups;

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

constexpr int kThreads = 256;
constexpr int kTile = 64;          // output tile rows and columns; the plane's row and column unit
constexpr int kPad = 4;            // words after each shared tile row
constexpr int kCluster = 8;        // blocks a lane: the portable cluster maximum
constexpr int kMinWidth = 130;     // narrower blocks go to csrc/phi_tables_xwide.cu
constexpr int kMaxLadder = 24;
constexpr int kPartWords = 64;     // the slot's head: each block's (norm, NaN flag)

// a k-step: 128 bytes of a row (32 float32, 16 float64)
template <typename T> constexpr int kBK = 128 / static_cast<int>(sizeof(T));

// A lane's planes: K the k extent (w rounded up to the k-step), R rows (w
// rounded up to the tile), ld columns (K + 3 rounded up to the tile), and
// the words of a slot (its head, then three planes)
struct Layout {
  int K, R, ld;
  long long plane, slot;
};

template <typename T>
__host__ __device__ inline Layout layout(int w) {
  const int K = (w + kBK<T> - 1) / kBK<T> * kBK<T>;
  const int R = (w + kTile - 1) / kTile * kTile;
  const int ld = (K + 3 + kTile - 1) / kTile * kTile;
  const long long plane = static_cast<long long>(R) * ld;
  return {K, R, ld, plane, kPartWords + 3 * plane};
}

template <typename T>
struct alignas(16) Stages {
  T a[2][kTile][kBK<T> + kPad];   // X rows m0.., k-step columns
  T b[2][kBK<T>][kTile + kPad];   // Y k-step rows, columns n0..
};

template <typename T>
union Smem {
  Stages<T> st;
  T c[kTile][kTile + kPad];       // a tile's sums, for the epilogue
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory (through L2, not L1) into shared memory
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x 2^n, exact (the plain version's hc doubled n times)
__device__ __forceinline__ float times_pow2(float x, int n) { return scalbnf(x, n); }
__device__ __forceinline__ double times_pow2(double x, int n) { return scalbn(x, n); }

// every block of the cluster has finished the phase; its stores to the slot
// are visible to the others' loads (which read through L2)
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}

// d += a b for one block of 16 x 8 by m16n8k4: a0 (g, t), a1 (g+8, t) of the
// 16 x 4 left block, b0 (t, g) of the 4 x 8 right block; d0, d1 columns 2t,
// 2t+1 of row g, d2, d3 of row g+8 (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_k4(double (&d)[4], double a0, double a1, double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// One k-step's X and Y tiles into stage `st`: 512 chunks of 16 bytes each,
// two a thread
template <typename T>
__device__ __forceinline__ void load_stage(Smem<T>& sm, int st, const T* X, const T* Y, int ld,
                                           int m0, int n0, int k0) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // words a chunk
  constexpr int kRowA = kBK<T> / kPer;                     // chunks a row of the X tile
  constexpr int kRowB = kTile / kPer;                      // chunks a row of the Y tile
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = threadIdx.x + q * kThreads;
    const int ra = c / kRowA, pa = c % kRowA;
    copy16(&sm.st.a[st][ra][pa * kPer], X + static_cast<size_t>(m0 + ra) * ld + k0 + pa * kPer);
    const int rb = c / kRowB, pb = c % kRowB;
    copy16(&sm.st.b[st][rb][pb * kPer], Y + static_cast<size_t>(k0 + rb) * ld + n0 + pb * kPer);
  }
}

// The sums of one 64 x 64 tile of X Y over k < K into sm.c
__device__ void tile_sums(Smem<float>& sm, const float* X, const float* Y, int ld, int K,
                          int m0, int n0) {
  constexpr int BK = kBK<float>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
  }
  const int nk = K / BK;
  load_stage(sm, 0, X, Y, ld, m0, n0, 0);
  copy_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(sm, (kt + 1) & 1, X, Y, ld, m0, n0, (kt + 1) * BK);
    copy_commit();
    copy_wait<1>();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = *reinterpret_cast<const float4*>(&sm.st.a[st][ty + 16 * q][kk]);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float4 bv = *reinterpret_cast<const float4*>(&sm.st.b[st][kk + d][4 * tx]);
        const float y[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = d == 0 ? av[q].x : d == 1 ? av[q].y : d == 2 ? av[q].z : av[q].w;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[q][c] = fmaf(x, y[c], acc[q][c]);
        }
      }
    }
    __syncthreads();
  }
  copy_wait<0>();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sm.c[ty + 16 * q][4 * tx + c] = acc[q][c];
  }
  __syncthreads();
}

__device__ void tile_sums(Smem<double>& sm, const double* X, const double* Y, int ld, int K,
                          int m0, int n0) {
  constexpr int BK = kBK<double>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp >> 1), c0 = 32 * (warp & 1);
  double acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
  const int nk = K / BK;
  load_stage(sm, 0, X, Y, ld, m0, n0, 0);
  copy_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(sm, (kt + 1) & 1, X, Y, ld, m0, n0, (kt + 1) * BK);
    copy_commit();
    copy_wait<1>();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const double a0 = sm.st.a[st][r0 + g][kk + t];
      const double a1 = sm.st.a[st][r0 + g + 8][kk + t];
      double b[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = sm.st.b[st][kk + t][c0 + 8 * n + g];
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_k4(acc[n], a0, a1, b[n]);
    }
    __syncthreads();
  }
  copy_wait<0>();
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    sm.c[r0 + g][c] = acc[n][0];
    sm.c[r0 + g][c + 1] = acc[n][1];
    sm.c[r0 + g + 8][c] = acc[n][2];
    sm.c[r0 + g + 8][c + 1] = acc[n][3];
  }
  __syncthreads();
}

enum Op { kHorner = 0, kLadder = 1 };

// The scalars of one product's epilogue
template <typename T>
struct Step {
  T kh, ks;      // Horner: E' = I + (A E) inv / kh; the series' divisor ks
  T inv, hs;     // the lane's 2^-s and h 2^-s
  bool last;     // Horner's last step: write p1 and p2
  T hc;          // ladder: hs 2^it
};

// dst = the product's result for every tile of the cluster's block `rank`
template <int kOp, typename T>
__device__ void product(Smem<T>& sm, const T* X, const T* Y, T* dst, const Layout& g, int w,
                        int rank, const Step<T>& sp) {
  const int K = g.K, ld = g.ld;
  const int ncol = ld / kTile, ntiles = (g.R / kTile) * ncol;
  const int r = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
  for (int tile = rank; tile < ntiles; tile += kCluster) {
    const int m0 = (tile / ncol) * kTile, n0 = (tile % ncol) * kTile;
    tile_sums(sm, X, Y, ld, K, m0, n0);
    const int i = m0 + r;
    T* const out = dst + static_cast<size_t>(i) * ld;
    const T* const yrow = Y + static_cast<size_t>(i) * ld;
#pragma unroll 4
    for (int cc = 0; cc < 16; ++cc) {
      const int j = n0 + c0 + cc;
      const T raw = sm.c[r][c0 + cc];
      if (i >= w) {
        out[j] = T(0);
      } else if (j < w) {
        out[j] = kOp == kHorner ? (raw * sp.inv) / sp.kh + (i == j ? T(1) : T(0)) : raw;
      } else if (j == K) {
        // columns K..K+2 are this thread's (K is a multiple of 16)
        if (kOp == kHorner) {
          const T term = (raw * sp.inv) / sp.ks;
          const T v1 = __ldcg(yrow + K + 1) + term / (sp.ks + T(1));
          const T v2 = __ldcg(yrow + K + 2) + term / ((sp.ks + T(1)) * (sp.ks + T(2)));
          out[K] = sp.last ? v1 * sp.hs : term;
          out[K + 1] = sp.last ? v2 * (sp.hs * sp.hs) : v1;
          out[K + 2] = sp.last ? T(0) : v2;
        } else {
          const T p1 = __ldcg(yrow + K), p2 = __ldcg(yrow + K + 1);
          out[K] = p1 + raw;
          out[K + 1] = p2 + sm.c[r][c0 + cc + 1] + p1 * sp.hc;
          out[K + 2] = T(0);
        }
      } else if (j > K + 2 || j < K) {
        out[j] = T(0);
      }
    }
    __syncthreads();   // the tile's sums are read before the next tile's copies land
  }
}

// One block an SM at the least: the registers the compiler wants (a
// bound of two blocks an SM, 128 a thread, spilled 4 bytes in float32 and
// 76 in float64 on the H100); the wrapper sizes the grid to the clusters
// the card holds at once (resident_clusters).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
phi_tables_stream_kernel(const T* __restrict__ L, const int* __restrict__ binv,
                         const T* __restrict__ h_u, T* __restrict__ E_out,
                         T* __restrict__ p1_out, T* __restrict__ p2_out, T* __restrict__ scratch,
                         long long slot_words, int w, int U, int B, int ladder) {
  constexpr int kTerms = Series<T>::kTerms;
  __shared__ Smem<T> sm;
  __shared__ T warp_norm[kThreads / 32];
  __shared__ int warp_nan[kThreads / 32];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long slot = blockIdx.x / kCluster, slots = gridDim.x / kCluster;
  const Layout g = layout<T>(w);
  const int K = g.K, ld = g.ld;
  T* const head = scratch + slot * slot_words;   // each block's (norm, NaN flag)
  T* const planeA = head + kPartWords;
  T* const plane[2] = {planeA + g.plane, planeA + 2 * g.plane};
  const int rows = g.R / kCluster, r0 = rank * rows, r1 = r0 + rows;   // the block's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t stride = static_cast<size_t>(B);
  const long long items = static_cast<long long>(U) * B;

  for (long long item = slot; item < items; item += slots) {
    const int u = static_cast<int>(item / B), lane_b = static_cast<int>(item % B);
    const T h = h_u[u];
    const T* const Lb = L + static_cast<size_t>(binv[u]) * w * w * stride + lane_b;

    // A = L h for the block's rows (zero past the block), a warp a row; the
    // rows' sums of |A|, their max and whether one is NaN
    T norm = T(0);
    int nan = 0;
    for (int i = r0 + warp; i < r1; i += kThreads / 32) {
      T sum = T(0);
      T* const arow = planeA + static_cast<size_t>(i) * ld;
      for (int j = lane; j < ld; j += 32) {
        const T v = i < w && j < w ? __ldg(Lb + (static_cast<size_t>(i) * w + j) * stride) * h
                                   : T(0);
        arow[j] = v;
        sum += real::abs(v);
      }
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      nan |= sum != sum;
      norm = real::max(norm, sum);
    }
    if (lane == 0) {
      warp_norm[warp] = norm;
      warp_nan[warp] = nan;
    }
    __syncthreads();
    if (tid == 0) {
      for (int q = 1; q < kThreads / 32; ++q) {
        norm = real::max(norm, warp_norm[q]);
        nan |= warp_nan[q];
      }
      head[2 * rank] = norm;
      head[2 * rank + 1] = nan ? T(1) : T(0);
    }
    cluster_barrier();

    // the lane's squaring count s from every block's share (each thread
    // alike), 2^-s and hs = h 2^-s (NaN for a NaN lane, which never steps)
    norm = T(0);
    nan = 0;
    for (int q = 0; q < kCluster; ++q) {
      norm = real::max(norm, __ldcg(head + 2 * q));
      nan |= __ldcg(head + 2 * q + 1) != T(0);
    }
    T s = real::ceil(real::log2(real::max(norm, T(1e-30)) / Series<T>::kRadius));
    s = real::min(real::max(s, T(0)), static_cast<T>(ladder));
    const int steps = nan ? 0 : static_cast<int>(s);
    const T inv = nan ? real::nan<T>() : real::exp2(-s);
    const T hs = h * inv;

    // E = I + A 2^-s / n into plane 0; the series' first term A 2^-s e0, v1
    // and v2 into its columns K..K+2 (plane 0 was last read before the
    // barrier above)
    for (int e = tid; e < rows * ld; e += kThreads) {
      const int i = r0 + e / ld, j = e % ld;
      const T* const arow = planeA + static_cast<size_t>(i) * ld;
      T v = T(0);
      if (i < w) {
        if (j < w) {
          v = (__ldcg(arow + j) * inv) / static_cast<T>(kTerms) + (i == j ? T(1) : T(0));
        } else if (j >= K && j <= K + 2) {
          const T term = __ldcg(arow) * inv;
          v = j == K ? term
                     : j == K + 1 ? (i == 0 ? T(1) : T(0)) + term / T(2)
                                  : (i == 0 ? T(0.5) : T(0)) + term / T(6);
        }
      }
      plane[0][static_cast<size_t>(i) * ld + j] = v;
    }
    cluster_barrier();

    // Horner, E = I + (A E) 2^-s / k for k = n-1..1, beside the series'
    // steps 2..n
    int cur = 0;
    for (int k = kTerms - 1; k >= 1; --k) {
      Step<T> sp{static_cast<T>(k), static_cast<T>(kTerms + 1 - k), inv, hs, k == 1, T(0)};
      product<kHorner>(sm, planeA, plane[cur], plane[cur ^ 1], g, w, rank, sp);
      cluster_barrier();
      cur ^= 1;
    }
    // the doubling ladder, the lane's own s steps
    for (int it = 0; it < steps; ++it) {
      Step<T> sp{T(1), T(1), inv, hs, false, times_pow2(hs, it)};
      product<kLadder>(sm, plane[cur], plane[cur], plane[cur ^ 1], g, w, rank, sp);
      cluster_barrier();
      cur ^= 1;
    }

    // the block's rows of the tables (the next item first writes plane A and
    // the head, and plane 0 only after its first barrier)
    const T* const fin = plane[cur];
    for (int e = tid; e < rows * w; e += kThreads) {
      const int i = r0 + e / w, j = e % w;
      if (i < w)
        E_out[((static_cast<size_t>(u) * w + i) * w + j) * stride + lane_b] =
            __ldcg(fin + static_cast<size_t>(i) * ld + j);
    }
    for (int i = r0 + tid; i < min(r1, w); i += kThreads) {
      const size_t row = (static_cast<size_t>(u) * w + i) * stride + lane_b;
      p1_out[row] = __ldcg(fin + static_cast<size_t>(i) * ld + K);
      p2_out[row] = __ldcg(fin + static_cast<size_t>(i) * ld + K + 1);
    }
  }
}

// a launch's cluster dimension: kCluster blocks
inline cudaLaunchAttribute cluster_attr() {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// The clusters the current device holds at once (the occupancy API, which
// knows the kernel's registers and the GPCs' SMs)
template <typename T>
int resident_clusters(int* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kCluster * 64));
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1] = {cluster_attr()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, phi_tables_stream_kernel<T>, &cfg));
}

template <typename T>
int launch(const void* L, const void* binv, const void* h_u, void* E, void* p1, void* p2, int w,
           int U, int B, int ladder, void* scratch, long long slot_words, int slots,
           cudaStream_t stream) {
  const Layout g = layout<T>(w);
  if (w < kMinWidth || U < 1 || B < 1 || ladder < 0 || ladder > kMaxLadder || slots < 1
      || slot_words < g.slot || slot_words % 4 || scratch == nullptr
      || static_cast<long long>(slots) * kCluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(slots * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_attr()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, phi_tables_stream_kernel<T>, static_cast<const T*>(L),
      static_cast<const int*>(binv), static_cast<const T*>(h_u), static_cast<T*>(E),
      static_cast<T*>(p1), static_cast<T*>(p2), static_cast<T*>(scratch), slot_words, w, U, B,
      ladder);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace

// L (Bu, w, w, B), binv (U,) int32, h_u (U,), all on the device, L, h_u, the
// tables and `scratch` in the entry's type; writes E (U, w, w, B), p1 (U, w,
// B), p2 (U, w, B) for any w >= 130. `scratch` holds `slots` slots of
// `slot_words` words (at least the kernel's layout; a multiple of 4), one a
// cluster of 8 blocks: ops/phi_tables.py::stream_launch_shape, `slots` at
// most the clusters the card holds at once (phi_tables_stream_clusters_*).
// Launches on `stream` without synchronising and returns the first CUDA
// error code (0 on success).
extern "C" int phi_tables_stream_f32(const void* L, const void* binv, const void* h_u, void* E,
                                     void* p1, void* p2, int w, int U, int B, int ladder,
                                     void* scratch, long long slot_words, int slots,
                                     void* stream) {
  return launch<float>(L, binv, h_u, E, p1, p2, w, U, B, ladder, scratch, slot_words, slots,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int phi_tables_stream_f64(const void* L, const void* binv, const void* h_u, void* E,
                                     void* p1, void* p2, int w, int U, int B, int ladder,
                                     void* scratch, long long slot_words, int slots,
                                     void* stream) {
  return launch<double>(L, binv, h_u, E, p1, p2, w, U, B, ladder, scratch, slot_words, slots,
                        static_cast<cudaStream_t>(stream));
}

// The clusters of 8 blocks of each instance the current device holds at
// once, into `*clusters`; returns the CUDA error code (0 on success).
extern "C" int phi_tables_stream_clusters_f32(int* clusters) {
  return resident_clusters<float>(clusters);
}

extern "C" int phi_tables_stream_clusters_f64(int* clusters) {
  return resident_clusters<double>(clusters);
}

extern "C" const char* phi_tables_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
