// Batched tridiagonal (Thomas) solve, float32 and float64. Each row i of the
// (B, n) arrays is one system: a the lower diagonal (a[i, 0] unused), b the
// main one, c the upper (c[i, n-1] unused), d the right-hand side. The
// forward sweep
//   cp[0] = c[0] / g(b[0]),  dp[0] = d[0] / g(b[0]),
//   q = g(b[k] - a[k] cp[k-1]),  cp[k] = c[k] / q,  dp[k] = (d[k] - a[k] dp[k-1]) / q,
// then x[n-1] = dp[n-1], x[k] = dp[k] - cp[k] x[k+1]. g is the reference's
// tiny-pivot guard: |p| < 1e-300 becomes +-1e-300 (sign of p, + at 0). In
// float32 1e-300 rounds to 0 and the guard never fires, as in the reference.
//
// Replaces: phoskintime_tpu/ops/pallas_kernels.py::thomas_pallas (kernel body
// _thomas_kernel) and the XLA scan it stands beside,
// phoskintime_tpu/ops/tridiag.py::thomas_solve_batched, which the sequential
// mechanism's steady state solves through. Plain PyTorch version:
// phoskintime_tpu_torch/ops/tridiag.py::thomas_solve_reference.
//
// What bounds it on this card. Each of the five (B, n) arrays is moved once:
// 5 n B elements, 36.9 MB for B = 368,640 chains of n = 5 in float32, 11 us
// at 3.35 TB/s; about 8 n operations a system. So bytes bound it. The
// steady state's own call (one chain a protein) is tiny, and the launch
// takes longer than the bound.
//
// What the design does about it. One thread per system; cp and dp live in
// a per-thread array (n <= 64, local memory, cached in L1). The TPU kernel
// put the chain on sublanes and padded the batch to 128 lanes; here any B
// runs, with no padding. The rows are row-major, so a warp's loads stride by
// n elements: each load instruction touches several cache lines, but the
// next n - 1 loads of the same rows find them in L1, so device memory still
// moves each byte about once. Staging tiles in shared memory to coalesce is
// left for when this kernel matters.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 64;

template <typename T>
__device__ __forceinline__ T guard(T p) {
  const T tiny = static_cast<T>(1e-300);
  const T mag = p < T(0) ? -p : p;
  return mag < tiny ? (p < T(0) ? -tiny : tiny) : p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
thomas_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ c, const T* __restrict__ d,
              T* __restrict__ x, long long B, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long o = i * n;
  T cp[kMaxN], dp[kMaxN];
  T q = guard(b[o]);
  cp[0] = c[o] / q;
  dp[0] = d[o] / q;
  for (int k = 1; k < n; ++k) {
    const T ak = a[o + k];
    q = guard(b[o + k] - ak * cp[k - 1]);
    cp[k] = c[o + k] / q;
    dp[k] = (d[o + k] - ak * dp[k - 1]) / q;
  }
  T xn = dp[n - 1];
  x[o + n - 1] = xn;
  for (int k = n - 2; k >= 0; --k) {
    xn = dp[k] - cp[k] * xn;
    x[o + k] = xn;
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c, const void* d, void* x,
           long long B, int n, void* stream) {
  if (n < 1 || n > kMaxN || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  thomas_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(d), static_cast<T*>(x), B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, c, d, x: (B, n) contiguous on the device, float32 (_f32) or float64
// (_f64), 1 <= n <= 64. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int thomas_f32(const void* a, const void* b, const void* c, const void* d,
                          void* x, long long B, int n, void* stream) {
  return launch<float>(a, b, c, d, x, B, n, stream);
}

extern "C" int thomas_f64(const void* a, const void* b, const void* c, const void* d,
                          void* x, long long B, int n, void* stream) {
  return launch<double>(a, b, c, d, x, B, n, stream);
}

extern "C" const char* thomas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
