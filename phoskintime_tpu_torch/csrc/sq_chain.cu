// The FP32 FMA-peak probe: each element x of X seeds NACC independent
// chains y_j = x (1 + 0.001 j) with c = x 1e-6 - 0.1, iterates
//   y = y * y + c
// REPS times (one FMA a step; the map has no closed form, so no compiler
// can shorten the chain), and writes the sum of its chains.
//
// Replaces: benchmarks/vpu_peak.py::sq_chain (kernel body _kernel), the
// JAX package's VPU-peak probe. Plain PyTorch version:
// phoskintime_tpu_torch/ops/fma_peak.py::sq_chain_reference.
//
// What bounds it on this card: operations, by design. Per element it reads
// and writes 4 bytes against 2 REPS NACC FLOPs (1,024 to 8,192 at REPS =
// 512), so at the H100's FP32 rate the bytes take a thousandth of the time.
//
// What the design does about it. One thread an element, its NACC chains in
// registers, the REPS x NACC steps unrolled at compile time (REPS and NACC
// are template arguments) into exactly REPS x NACC FFMA instructions: the
// seeds and the sum use the round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn), which the compiler never contracts into an FMA, so the count
// of FFMAs in the SASS is the probe's own (ops/fma_peak.py checks it with
// cuobjdump). NACC independent chains a thread give the FMA pipe NACC
// instructions in flight a warp; the warps of an SM cover the rest of its
// latency. A launch of `launches` chained kernels ping-pongs between two
// buffers, each launch reading the previous one's output, so a chain of
// launches is timed without a host call between them.

#include <cuda_runtime.h>

namespace {

template <int NACC, int REPS>
__global__ void __launch_bounds__(1024)
sq_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  const float c = __fadd_rn(__fmul_rn(xi, 1e-6f), -0.1f);   // keeps iterates in (-0.1, 1)
  float y[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) y[j] = __fmul_rn(xi, static_cast<float>(1.0 + 0.001 * j));
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) y[j] = fmaf(y[j], y[j], c);
  }
  float acc = y[0];
#pragma unroll
  for (int j = 1; j < NACC; ++j) acc = __fadd_rn(acc, y[j]);
  out[i] = acc;
}

template <int NACC, int REPS>
int launch_chain(float* a, float* b, int n, int threads, int launches, cudaStream_t stream) {
  const int blocks = (n + threads - 1) / threads;
  for (int k = 0; k < launches; ++k) {
    const bool even = k % 2 == 0;
    sq_chain_kernel<NACC, REPS><<<blocks, threads, 0, stream>>>(even ? a : b, even ? b : a, n);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

}  // namespace

// `a` and `b`: n float32 on the device. Launches the probe `launches` times
// on `stream`, the first reading `a` and writing `b`, each next one reading
// the previous output and writing the other buffer (so `a` is written only
// when launches >= 2; the result is in `b` after an odd count, in `a` after
// an even one). reps is 2 or 512, nacc 1, 2, 4 or 8, threads a multiple of
// 32 up to 1024. Does not synchronise; returns the first CUDA error code (0
// on success).
extern "C" int sq_chain_f32(void* a, void* b, int n, int reps, int nacc, int threads,
                            int launches, void* stream) {
  if (n < 1 || threads < 32 || threads > 1024 || threads % 32 || launches < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* fa = static_cast<float*>(a);
  float* fb = static_cast<float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SQ_CASE(NACC, REPS) \
  if (nacc == NACC && reps == REPS) return launch_chain<NACC, REPS>(fa, fb, n, threads, launches, st);
  SQ_CASE(1, 2) SQ_CASE(2, 2) SQ_CASE(4, 2) SQ_CASE(8, 2)
  SQ_CASE(1, 512) SQ_CASE(2, 512) SQ_CASE(4, 512) SQ_CASE(8, 512)
#undef SQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sq_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
