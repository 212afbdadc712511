// ETD2RK propagator tables for wide blocks, 9 <= w <= 17, in float32:
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
// What the design does about it. The w <= 8 kernel keeps a whole block in
// one thread's registers; at w = 17 that is 3 x 289 floats, beyond the
// 255-register limit. Here one thread block owns one pair and a tile of
// 32 lanes, and each thread owns one (row, lane): it keeps its row of A
// (and of A/k, and of the product it is forming) in registers, while E
// lives in shared memory as [w][w][32], lanes fastest, so each warp's
// shared loads and stores hit 32 consecutive words (no bank conflicts).
// A product is formed row by row in registers, then written back after a
// __syncthreads(). Nothing between loading L and storing the tables
// touches device memory, and the loads and stores of L and the tables
// are coalesced along the lane axis. Each FMA takes one shared load,
// which caps the rate at a quarter of the FMA peak; more rows per thread
// (register tiling) or tensor-core products are later work. FP32 FMA
// only: no tensor cores, no TF32.
//
// The ladder runs the tile's largest s, as the Pallas kernel skips a tile
// once all its lanes are done; each lane commits a step only while it is
// below its own s, so its values do not depend on its neighbours. A lane
// with a NaN in A takes no part in the tile's trip count (its tables are
// all NaN, as the plain version's), so one failed member cannot change
// the tables of the members that share its tile.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;          // lanes per thread block
constexpr int kTaylorTerms = 8;
constexpr float kRadius = 0.5f;    // pre-squaring radius of the series

template <int W>
__global__ void __launch_bounds__(W * kTile)
phi_tables_wide_kernel(const float* __restrict__ L, const int* __restrict__ binv,
                       const float* __restrict__ h_u, float* __restrict__ E_out,
                       float* __restrict__ p1_out, float* __restrict__ p2_out,
                       int B, int ladder) {
  __shared__ float Es[W][W][kTile];  // E, lanes fastest
  __shared__ float va[W][kTile];     // row sums, then the series term, then p1
  __shared__ float vb[W][kTile];     // p2
  __shared__ float s_tile[kTile];    // each lane's step count

  const int l = threadIdx.x % kTile;  // lane within the tile
  const int i = threadIdx.x / kTile;  // the row this thread owns
  const int lane = blockIdx.x * kTile + l;
  const bool live = lane < B;         // lanes past B run a zero block
  const int u = blockIdx.y;
  const size_t plane = static_cast<size_t>(B);
  const float h = h_u[u];

  // row i of A = L h, and its absolute sum
  float a[W];
  float row = 0.0f;
  const float* Lr = L + (static_cast<size_t>(binv[u]) * W + i) * W * plane + lane;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    a[j] = live ? Lr[j * plane] * h : 0.0f;
    row += fabsf(a[j]);
  }
  va[i][l] = row;
  __syncthreads();

  // inf-norm over the lane's rows; a NaN row marks the lane non-finite
  float norm = 0.0f;
  bool finite = true;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const float v = va[r][l];
    finite = finite && (v == v);
    norm = fmaxf(norm, v);
  }
  float s = ceilf(log2f(fmaxf(norm, 1e-30f) / kRadius));
  s = fminf(fmaxf(s, 0.0f), static_cast<float>(ladder));
  const int n_lane = finite ? static_cast<int>(s) : 0;
  if (i == 0) s_tile[l] = static_cast<float>(n_lane);
  const float scale = finite ? exp2f(s) : __int_as_float(0x7fc00000);  // NaN
#pragma unroll
  for (int j = 0; j < W; ++j) a[j] = a[j] / scale;
  const float hs = h / scale;
  __syncthreads();                    // s_tile written, va free again
  int n_tile = 0;
#pragma unroll
  for (int t = 0; t < kTile; ++t) n_tile = max(n_tile, static_cast<int>(s_tile[t]));

  // E = expm(A) by Horner: E = I + A/8, then E = I + (A/k) E for k = 7..1
#pragma unroll
  for (int c = 0; c < W; ++c)
    Es[i][c][l] = a[c] / static_cast<float>(kTaylorTerms) + (i == c ? 1.0f : 0.0f);
  float t[W];
  for (int k = kTaylorTerms - 1; k >= 1; --k) {
    float ak[W];
#pragma unroll
    for (int j = 0; j < W; ++j) ak[j] = a[j] / static_cast<float>(k);
    __syncthreads();                  // E complete
#pragma unroll
    for (int c = 0; c < W; ++c) {
      float acc = ak[0] * Es[0][c][l];
#pragma unroll
      for (int j = 1; j < W; ++j) acc = fmaf(ak[j], Es[j][c][l], acc);
      t[c] = acc;
    }
    __syncthreads();                  // every read of E done
#pragma unroll
    for (int c = 0; c < W; ++c) Es[i][c][l] = t[c] + (i == c ? 1.0f : 0.0f);
  }

  // phi1 / phi2 e0 columns; this thread holds entry i of each vector
  float term = a[0];                  // (A e0)_i
  float v1 = (i == 0 ? 1.0f : 0.0f) + term / 2.0f;
  float v2 = (i == 0 ? 0.5f : 0.0f) + term / 6.0f;
  for (int k = 2; k <= kTaylorTerms; ++k) {
    va[i][l] = term;
    __syncthreads();
    float acc = a[0] * va[0][l];
#pragma unroll
    for (int j = 1; j < W; ++j) acc = fmaf(a[j], va[j][l], acc);
    __syncthreads();                  // every read of the term done
    term = acc / static_cast<float>(k);
    v1 = v1 + term / static_cast<float>(k + 1);
    v2 = v2 + term / static_cast<float>((k + 1) * (k + 2));
  }
  float p1 = v1 * hs;
  float p2 = v2 * (hs * hs);

  // doubling ladder: the tile's largest step count, each lane masked at its own
  float hc = hs;
  for (int it = 0; it < n_tile; ++it) {
    va[i][l] = p1;
    vb[i][l] = p2;
    float e[W];
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = Es[i][j][l];
    __syncthreads();                  // p1, p2 and E complete
    float q1 = e[0] * va[0][l];
    float q2 = e[0] * vb[0][l];
#pragma unroll
    for (int j = 1; j < W; ++j) {
      q1 = fmaf(e[j], va[j][l], q1);
      q2 = fmaf(e[j], vb[j][l], q2);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
      float acc = e[0] * Es[0][c][l];
#pragma unroll
      for (int j = 1; j < W; ++j) acc = fmaf(e[j], Es[j][c][l], acc);
      t[c] = acc;
    }
    __syncthreads();                  // every read of E, p1 and p2 done
    if (it < n_lane) {
#pragma unroll
      for (int c = 0; c < W; ++c) Es[i][c][l] = t[c];
      p2 = p2 + q2 + p1 * hc;
      p1 = p1 + q1;
      hc = 2.0f * hc;
    }
  }

  if (live) {
    const size_t r = static_cast<size_t>(u) * W + i;
    float* Eo = E_out + r * W * plane + lane;
#pragma unroll
    for (int c = 0; c < W; ++c) Eo[c * plane] = Es[i][c][l];  // this thread's own row
    p1_out[r * plane + lane] = p1;
    p2_out[r * plane + lane] = p2;
  }
}

template <int W>
int launch(const void* L, const void* binv, const void* h_u, void* E, void* p1,
           void* p2, int U, int B, int ladder, cudaStream_t stream) {
  const dim3 grid((B + kTile - 1) / kTile, U);
  phi_tables_wide_kernel<W><<<grid, W * kTile, 0, stream>>>(
      static_cast<const float*>(L), static_cast<const int*>(binv),
      static_cast<const float*>(h_u), static_cast<float*>(E),
      static_cast<float*>(p1), static_cast<float*>(p2), B, ladder);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (Bu, w, w, B), binv (U,) int32, h_u (U,) float32, all on the device;
// writes E (U, w, w, B), p1 (U, w, B), p2 (U, w, B). Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int phi_tables_wide_f32(const void* L, const void* binv, const void* h_u,
                                   void* E, void* p1, void* p2, int w, int U, int B,
                                   int ladder, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 9: return launch<9>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 10: return launch<10>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 11: return launch<11>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 12: return launch<12>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 13: return launch<13>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 14: return launch<14>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 15: return launch<15>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 16: return launch<16>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 17: return launch<17>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* phi_tables_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
