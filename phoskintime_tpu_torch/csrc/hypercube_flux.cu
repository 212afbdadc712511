// The combinatorial mechanism's edge flux, float32 and float64. For each row
// r (one protein of one member) of X (rows, M), M = 2^log_m states, and each
// state m:
//   dX[r, m] = sum over sites j < smax of
//              bit j of m ? S[r, j] X[r, m ^ 2^j] - E[r] X[r, m]    (in, out)
//                         : E[r] X[r, m ^ 2^j] - S[r, j] X[r, m]
// accumulated over j in order, inflow added before outflow is taken away,
// as the plain version does.
//
// Replaces: phoskintime_tpu/ops/pallas_kernels.py::hypercube_flux_pallas
// (kernel body _hypercube_kernel), the edge flux of the model-2 RHS
// (phoskintime_tpu/network/rhs.py::_rhs_combinatorial), which every stage of
// the RK45 oracle integrator evaluates. Plain PyTorch version:
// phoskintime_tpu_torch/ops/hypercube_flux.py::hypercube_flux_reference.
//
// What bounds it on this card. Each state is read once and its flux written
// once, with smax site rates and one dephospho rate per row: at the RK45
// objective's shape (92,160 rows of 16 states, smax 4, float32) 13.6 MB,
// 4.1 us at 3.35 TB/s; the arithmetic is 4 smax operations a state, far
// below the FP32 peak. So bytes bound it, and at this size the launch
// itself takes longer than the bound.
//
// What the design does about it. One thread per (row, state): loads and
// stores are coalesced, lanes fastest, and nothing is read twice from
// memory but the row's rates (cache broadcasts). The Pallas kernel reaches
// the neighbour m ^ 2^j by rolling the lane axis; here, for 2^j < 32, the
// row lies inside one warp and the neighbour is __shfl_xor_sync(x, 2^j):
// the XOR map itself, no gather and no shared memory. Rows of more than 32
// states (smax 6 and up) also put the block's states in shared memory and
// read the neighbours across warps from there. Rows are aligned to the
// block and the warp (both are multiples of M), and threads past the last
// row take part in the shuffles and the barrier with a zero state and store
// nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // a block: whole rows, at least one warp
constexpr int kMaxLogM = 10;      // rows of up to 1024 states: one block

template <typename T>
__global__ void __launch_bounds__(1024)
hypercube_flux_kernel(const T* __restrict__ X, const T* __restrict__ S,
                      const T* __restrict__ E, T* __restrict__ out,
                      long long total, int smax, int log_m) {
  extern __shared__ unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = idx < total;
  const long long row = idx >> log_m;
  const int m = static_cast<int>(idx & ((1LL << log_m) - 1));
  const T x = live ? X[idx] : T(0);
  const T e = live ? E[row] : T(0);
  if (log_m > 5) {                // uniform over the block
    xs[threadIdx.x] = x;
    __syncthreads();
  }
  T acc = T(0);
  for (int j = 0; j < smax; ++j) {
    const int b = 1 << j;
    const T xn = b < 32 ? __shfl_xor_sync(0xffffffffu, x, b)
                        : xs[threadIdx.x ^ b];
    const T s = live ? S[row * smax + j] : T(0);
    if (m & b) {
      acc = acc + s * xn;
      acc = acc - e * x;
    } else {
      acc = acc + e * xn;
      acc = acc - s * x;
    }
  }
  if (live) out[idx] = acc;
}

template <typename T>
int launch(const void* X, const void* S, const void* E, void* out, long long rows,
           int smax, int log_m, void* stream) {
  if (log_m < 0 || log_m > kMaxLogM || smax < 0 || smax > log_m || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (1 << log_m) > kThreads ? (1 << log_m) : kThreads;
  const long long total = rows << log_m;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = log_m > 5 ? threads * sizeof(T) : 0;
  hypercube_flux_kernel<T><<<static_cast<unsigned>(blocks), threads, shared,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(S), static_cast<const T*>(E),
      static_cast<T*>(out), total, smax, log_m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (rows, 2^log_m), S (rows, smax), E (rows,), out (rows, 2^log_m), all
// contiguous on the device, float32 (_f32) or float64 (_f64). Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success); cudaErrorInvalidValue for a size the kernel does not take.
extern "C" int hypercube_flux_f32(const void* X, const void* S, const void* E, void* out,
                                  long long rows, int smax, int log_m, void* stream) {
  return launch<float>(X, S, E, out, rows, smax, log_m, stream);
}

extern "C" int hypercube_flux_f64(const void* X, const void* S, const void* E, void* out,
                                  long long rows, int smax, int log_m, void* stream) {
  return launch<double>(X, S, E, out, rows, smax, log_m, stream);
}

extern "C" const char* hypercube_flux_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
