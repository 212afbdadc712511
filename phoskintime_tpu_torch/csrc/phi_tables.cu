// ETD2RK propagator tables for every (bucket, h) pair and every lane:
//   E = expm(L h),  p1 = h phi1(L h) e0,  p2 = h^2 phi2(L h) e0
// for w x w blocks, 2 <= w <= 8, in float32.
//
// Replaces: phoskintime_tpu/ops/phi_pallas.py::phi_vectors_pallas_pages
// (kernel body _phi_kernel_pages, math _phi_math_pages), the TPU kernel on
// the population objective's main path for the affine mechanisms. Plain
// PyTorch version: phoskintime_tpu_torch/ops/phi_tables.py::phi_tables_reference.
//
// Math, step for step as in _phi_math_pages:
//   A = L h; s = ceil(log2(||A||_inf / 0.5)) clipped to [0, ladder];
//   A *= 2^-s, hs = h 2^-s;
//   E by an 8-term Horner series with reciprocal constants 1/k, the first
//   step peeled (E = I + A/8);
//   the phi1/phi2 e0 columns by the shared power series;
//   then s doubling steps  p2 <- p2 + E p2 + hc p1,  p1 <- p1 + E p1,
//   E <- E E,  hc <- 2 hc.
//
// What bounds it on this card. Per (pair, lane) the kernel reads w^2
// floats of L and writes w^2 + 2w floats of tables: 84 floats, 336 bytes
// at w = 6. Against that it runs about 8 w^3 (Horner) + 7 w^2 (series)
// + s (w^3 + 2 w^2) (ladder) FP32 FMAs: about 2,000 + 288 s at w = 6,
// 6 to 18 FMAs per byte as s runs from 0 to the bench plan's bound of 14.
// The H100 SXM's published FP32 rate over its HBM bandwidth (67 TFLOP/s
// over 3.35 TB/s) is 10 FMAs per byte, so the build sits near the balance
// point, and register pressure (3 w^2 live floats) decides how many lanes
// an SM keeps in flight to cover either limit.
//
// What the design does about it. One thread per (pair, lane): the block
// lives in registers for the whole build, so every byte of L is read once
// and every table entry written once, and nothing in between touches
// memory (the plain version moves the (w, w, lanes) carry through device
// memory at every Horner term and ladder step). The lane is the minor axis
// of L and of the tables, so each warp's loads and stores are coalesced.
// Each thread runs its own s rather than the static worst case `ladder`,
// which is the per-lane mask of _phi_math_pages; the tile-wide skip there
// has no counterpart because a thread that is done simply stops. FP32 FMA
// only: no tensor cores, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTaylorTerms = 8;
constexpr float kInvRadius = 2.0f;  // 1 / 0.5, the pre-squaring radius

template <int W>
__device__ __forceinline__ void matvec(const float (&m)[W][W], const float (&v)[W],
                                       float (&out)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    float acc = m[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < W; ++j) acc = fmaf(m[i][j], v[j], acc);
    out[i] = acc;
  }
}

template <int W>
__global__ void __launch_bounds__(kBlock)
phi_tables_kernel(const float* __restrict__ L, const int* __restrict__ binv,
                  const float* __restrict__ h_u, float* __restrict__ E_out,
                  float* __restrict__ p1_out, float* __restrict__ p2_out,
                  int B, int ladder) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int u = blockIdx.y;
  const size_t plane = static_cast<size_t>(B);
  const float h = h_u[u];
  const float* Lb = L + static_cast<size_t>(binv[u]) * W * W * plane + lane;

  // A = L h and its inf-norm (max absolute row sum)
  float A[W][W];
  float norm = 0.0f;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    float row = 0.0f;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      A[i][j] = Lb[(i * W + j) * plane] * h;
      row += fabsf(A[i][j]);
    }
    norm = fmaxf(norm, row);
  }
  float s = ceilf(log2f(fmaxf(norm, 1e-30f) * kInvRadius));
  s = fminf(fmaxf(s, 0.0f), static_cast<float>(ladder));
  const float inv = exp2f(-s);
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) A[i][j] *= inv;
  const float hs = h * inv;

  // E = expm(A) by Horner: E = I + A/8, then E = I + (A/k) E for k = 7..1
  float E[W][W], T[W][W];
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j)
      E[i][j] = A[i][j] * (1.0f / kTaylorTerms) + (i == j ? 1.0f : 0.0f);
#pragma unroll
  for (int k = kTaylorTerms - 1; k >= 1; --k) {
    const float rk = 1.0f / k;
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        float acc = (A[i][0] * rk) * E[0][c];
#pragma unroll
        for (int j = 1; j < W; ++j) acc = fmaf(A[i][j] * rk, E[j][c], acc);
        T[i][c] = acc + (i == c ? 1.0f : 0.0f);
      }
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) E[i][c] = T[i][c];
  }

  // phi1 / phi2 e0 columns: term_k = A^k e0 / k!,
  // v1 = sum term_k / (k+1), v2 = sum term_k / ((k+1)(k+2))
  float term[W], v1[W], v2[W], q1[W], q2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    term[i] = A[i][0];
    v1[i] = term[i] * 0.5f + (i == 0 ? 1.0f : 0.0f);
    v2[i] = term[i] * (1.0f / 6.0f) + (i == 0 ? 0.5f : 0.0f);
  }
#pragma unroll
  for (int k = 2; k <= kTaylorTerms; ++k) {
    const float rk = 1.0f / k;
    const float r1 = 1.0f / (k + 1);
    const float r2 = 1.0f / ((k + 1) * (k + 2));
    matvec<W>(A, term, q1);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      term[i] = q1[i] * rk;
      v1[i] = v1[i] + term[i] * r1;
      v2[i] = v2[i] + term[i] * r2;
    }
  }
  float p1[W], p2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    p1[i] = v1[i] * hs;
    p2[i] = v2[i] * (hs * hs);
  }

  // doubling ladder, this lane's own s steps
  float hc = hs;
  const int n_steps = static_cast<int>(s);
  for (int it = 0; it < n_steps; ++it) {
    matvec<W>(E, p1, q1);
    matvec<W>(E, p2, q2);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      p2[i] = p2[i] + q2[i] + p1[i] * hc;
      p1[i] = p1[i] + q1[i];
    }
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        float acc = E[i][0] * E[0][c];
#pragma unroll
        for (int j = 1; j < W; ++j) acc = fmaf(E[i][j], E[j][c], acc);
        T[i][c] = acc;
      }
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) E[i][c] = T[i][c];
    hc *= 2.0f;
  }

  float* Eo = E_out + static_cast<size_t>(u) * W * W * plane + lane;
  float* p1o = p1_out + static_cast<size_t>(u) * W * plane + lane;
  float* p2o = p2_out + static_cast<size_t>(u) * W * plane + lane;
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j < W; ++j) Eo[(i * W + j) * plane] = E[i][j];
    p1o[i * plane] = p1[i];
    p2o[i * plane] = p2[i];
  }
}

template <int W>
int launch(const void* L, const void* binv, const void* h_u, void* E, void* p1,
           void* p2, int U, int B, int ladder, cudaStream_t stream) {
  const dim3 grid((B + kBlock - 1) / kBlock, U);
  phi_tables_kernel<W><<<grid, kBlock, 0, stream>>>(
      static_cast<const float*>(L), static_cast<const int*>(binv),
      static_cast<const float*>(h_u), static_cast<float*>(E),
      static_cast<float*>(p1), static_cast<float*>(p2), B, ladder);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (Bu, w, w, B), binv (U,) int32, h_u (U,) float32, all on the device;
// writes E (U, w, w, B), p1 (U, w, B), p2 (U, w, B). Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int phi_tables_f32(const void* L, const void* binv, const void* h_u,
                              void* E, void* p1, void* p2, int w, int U, int B,
                              int ladder, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 2: return launch<2>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 3: return launch<3>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 4: return launch<4>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 5: return launch<5>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 6: return launch<6>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 7: return launch<7>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    case 8: return launch<8>(L, binv, h_u, E, p1, p2, U, B, ladder, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* phi_tables_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
