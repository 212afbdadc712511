// The combinatorial mechanism's edge flux, float32 and float64. For each row
// r (one protein of one member) of X (rows, M), M = 2^smax states, and each
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
// below the FP32 peak. So bytes bound it. That bound holds where the bytes
// come from HBM; 13.6 MB fits the 50 MB L2, and where the states were just
// written (an RK45 stage) or the call repeats, they come from L2 faster.
// The first design (one thread per state: one 4-byte load and store, and
// smax reloads of the row's rates) took 8.5 us on back-to-back calls, the
// data in L2: 1.47M threads with a single 4-byte load each
// keep too few bytes in flight to cover the memory's latency, and the
// rates' reloads cost as many load instructions as the states.
//
// What the design does about it. A thread owns 4 consecutive states (a
// quad: one 16-byte load and store in float32, two of each in float64,
// through the read-only path), two quads a step, both loaded before either
// is computed, so several 16-byte loads are in flight a thread (one quad
// where the work is small: more threads then keep the memory busier); it
// reads its row's smax rates and the dephospho rate once. A row of M states spans
// M / 4 neighbouring threads. Site 0 and 1 neighbours (m ^ 1, m ^ 2) are
// the thread's own registers; site j >= 2 is quad q ^ 2^(j-2), a
// __shfl_xor_sync at that lane distance while a row fits a warp (smax <= 7),
// and shared memory across the warps of the block beyond (smax 8..10, a
// block of 256 threads holding whole rows of up to 1024 states). Rows of 1
// and 2 states (smax 0 and 1) take one thread a row. The grid walks the
// work in strides of at most the resident blocks, so a launch is at most
// one wave. The sums are the first design's, term for term.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // a block
constexpr int kMaxSites = 10;     // rows of up to 1024 states: 256 quads, one block

// the most items (rows or quads) a thread takes a step at each site count:
// rows of 1 and 2 states 4 rows, rows of 4 to 128 states 2 quads (1 where
// the work is small, see launch_quads), larger rows 1 quad
__host__ __device__ constexpr int items_for(int smax) {
  return smax < 2 ? 4 : (smax < 8 ? 2 : 1);
}

// One site's terms of one state, as the first design wrote them.
template <typename T>
__device__ __forceinline__ T edge(T acc, bool set, T s, T e, T xn, T x) {
  if (set) {
    acc = acc + s * xn;
    acc = acc - e * x;
  } else {
    acc = acc + e * xn;
    acc = acc - s * x;
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void load_quad(const T* p, bool vec, T (&x)[4]);
template <>
__device__ __forceinline__ void load_quad<float>(const float* p, bool vec, float (&x)[4]) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) x[v] = __ldg(p + v);
  }
}
template <>
__device__ __forceinline__ void load_quad<double>(const double* p, bool vec, double (&x)[4]) {
  if (vec) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) x[v] = __ldg(p + v);
  }
}

template <typename T>
__device__ __forceinline__ void store_quad(T* p, bool vec, const T (&x)[4]);
template <>
__device__ __forceinline__ void store_quad<float>(float* p, bool vec, const float (&x)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) p[v] = x[v];
  }
}
template <>
__device__ __forceinline__ void store_quad<double>(double* p, bool vec, const double (&x)[4]) {
  if (vec) {
    reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) p[v] = x[v];
  }
}

// Rows of 1 or 2 states (SMAX 0, 1): one thread a row, Q rows a step.
template <typename T, int SMAX>
__global__ void __launch_bounds__(kThreads)
hypercube_flux_kernel_rows(const T* __restrict__ X, const T* __restrict__ S,
                           const T* __restrict__ E, T* __restrict__ out, long long rows) {
  constexpr int Q = items_for(SMAX);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * Q;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * Q + threadIdx.x;
       base < rows; base += stride) {
    T x0[Q], x1[Q], s[Q], e[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const long long r = base + static_cast<long long>(i) * kThreads;
      const bool live = r < rows;
      if constexpr (SMAX == 1) {
        x0[i] = live ? __ldg(X + 2 * r) : T(0);
        x1[i] = live ? __ldg(X + 2 * r + 1) : T(0);
        s[i] = live ? __ldg(S + r) : T(0);
        e[i] = live ? __ldg(E + r) : T(0);
      }
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const long long r = base + static_cast<long long>(i) * kThreads;
      if (r >= rows) continue;
      if constexpr (SMAX == 0) {
        out[r] = T(0);
      } else {
        out[2 * r] = edge(T(0), false, s[i], e[i], x1[i], x0[i]);
        out[2 * r + 1] = edge(T(0), true, s[i], e[i], x0[i], x1[i]);
      }
    }
  }
}

// Rows of 4 to 1024 states (SMAX 2..10): a thread owns quads, Q a step;
// a block's step covers kThreads * Q consecutive quads in Q chunks of
// kThreads, each chunk whole rows (M / 4 divides kThreads).
template <typename T, int SMAX, int Q, bool VEC>
__global__ void __launch_bounds__(kThreads)
hypercube_flux_kernel(const T* __restrict__ X, const T* __restrict__ S,
                      const T* __restrict__ E, T* __restrict__ out, long long quads) {
  constexpr int QR = (1 << SMAX) / 4;             // quads a row
  constexpr bool kShared = SMAX > 7;              // a row spans more than a warp
  __shared__ T xs[kShared ? 4 * kThreads : 1];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * Q;
  // uniform over the block: every thread takes part in each step's barrier
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * Q; base < quads;
       base += stride) {
    T x[Q][4], s[Q][SMAX], e[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const long long q = base + static_cast<long long>(i) * kThreads + threadIdx.x;
      const bool live = q < quads;
      const long long row = q / QR;
      if (live) {
        load_quad<T>(X + 4 * q, VEC, x[i]);
        e[i] = __ldg(E + row);
#pragma unroll
        for (int j = 0; j < SMAX; ++j) s[i][j] = __ldg(S + row * SMAX + j);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) x[i][v] = T(0);
        e[i] = T(0);
#pragma unroll
        for (int j = 0; j < SMAX; ++j) s[i][j] = T(0);
      }
    }
    if (kShared) {
      __syncthreads();                            // the last step's reads are done
#pragma unroll
      for (int v = 0; v < 4; ++v) xs[v * kThreads + threadIdx.x] = x[0][v];
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const long long q = base + static_cast<long long>(i) * kThreads + threadIdx.x;
      const int qr = static_cast<int>(q % QR);    // the quad's place in its row
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int j = 0; j < SMAX; ++j) {
        T xn[4];
        if (j == 0) {
          xn[0] = x[i][1]; xn[1] = x[i][0]; xn[2] = x[i][3]; xn[3] = x[i][2];
        } else if (j == 1) {
          xn[0] = x[i][2]; xn[1] = x[i][3]; xn[2] = x[i][0]; xn[3] = x[i][1];
        } else if (j < 7) {
#pragma unroll
          for (int v = 0; v < 4; ++v) xn[v] = __shfl_xor_sync(0xffffffffu, x[i][v], 1 << (j - 2));
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) xn[v] = xs[v * kThreads + (threadIdx.x ^ (1 << (j - 2)))];
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const bool set = j < 2 ? ((v >> j) & 1) : ((qr >> (j - 2)) & 1);
          acc[v] = edge(acc[v], set, s[i][j], e[i], xn[v], x[i][v]);
        }
      }
      if (q < quads) store_quad<T>(out + 4 * q, VEC, acc);
    }
  }
}

// The resident blocks of ``kernel`` on the current device (its SMs times
// its blocks an SM by the occupancy API), cached per instance and device;
// 0 if the runtime cannot say.
template <typename Tag, typename K>
int wave_blocks(K kernel) {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <typename T, int SMAX, int Q, bool VEC> struct Instance {};

// One launch of ``kernel`` over ``work`` items (rows or quads), Q a thread
// and step: as many blocks as the work needs, at most one wave.
template <typename Tag, typename K, typename T>
int run(K kernel, int Q, const T* X, const T* S, const T* E, T* out, long long work,
        cudaStream_t stream) {
  const int wave = wave_blocks<Tag>(kernel);
  if (wave <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long need = (work + static_cast<long long>(kThreads) * Q - 1) /
                         (static_cast<long long>(kThreads) * Q);
  kernel<<<static_cast<int>(need < wave ? need : wave), kThreads, 0, stream>>>(X, S, E, out,
                                                                              work);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int SMAX, int Q, bool VEC>
int run_quads(const T* X, const T* S, const T* E, T* out, long long quads,
              cudaStream_t stream) {
  return run<Instance<T, SMAX, Q, VEC>>(hypercube_flux_kernel<T, SMAX, Q, VEC>, Q, X, S, E, out,
                                        quads, stream);
}

// Rows of 4 to 128 states take 2 quads a thread and step (twice the loads
// in flight a thread) unless the quads are fewer than half the threads one
// wave of 1-quad blocks holds; there 1 quad a thread keeps more threads on
// the memory.
template <typename T, int SMAX, bool VEC>
int launch_quads(const T* X, const T* S, const T* E, T* out, long long quads,
                 cudaStream_t stream) {
  if constexpr (items_for(SMAX) == 2) {
    const long long one = wave_blocks<Instance<T, SMAX, 1, VEC>>(
        hypercube_flux_kernel<T, SMAX, 1, VEC>) * static_cast<long long>(kThreads);
    if (2 * quads >= one) return run_quads<T, SMAX, 2, VEC>(X, S, E, out, quads, stream);
  }
  return run_quads<T, SMAX, 1, VEC>(X, S, E, out, quads, stream);
}

template <typename T, int SMAX>
int launch_sites(const T* X, const T* S, const T* E, T* out, long long rows,
                 cudaStream_t stream) {
  if constexpr (SMAX < 2) {
    return run<Instance<T, SMAX, 4, false>>(hypercube_flux_kernel_rows<T, SMAX>,
                                            items_for(SMAX), X, S, E, out, rows, stream);
  } else {
    const long long quads = rows << (SMAX - 2);
    if (reinterpret_cast<std::uintptr_t>(X) % 16 == 0 &&
        reinterpret_cast<std::uintptr_t>(out) % 16 == 0)
      return launch_quads<T, SMAX, true>(X, S, E, out, quads, stream);
    return launch_quads<T, SMAX, false>(X, S, E, out, quads, stream);
  }
}

template <typename T>
int launch(const void* Xv, const void* Sv, const void* Ev, void* outv, long long rows,
           int smax, void* stream) {
  if (smax < 0 || smax > kMaxSites || rows <= 0 || rows > (1LL << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* X = static_cast<const T*>(Xv);
  const T* S = static_cast<const T*>(Sv);
  const T* E = static_cast<const T*>(Ev);
  T* out = static_cast<T*>(outv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (smax) {
    case 0: return launch_sites<T, 0>(X, S, E, out, rows, st);
    case 1: return launch_sites<T, 1>(X, S, E, out, rows, st);
    case 2: return launch_sites<T, 2>(X, S, E, out, rows, st);
    case 3: return launch_sites<T, 3>(X, S, E, out, rows, st);
    case 4: return launch_sites<T, 4>(X, S, E, out, rows, st);
    case 5: return launch_sites<T, 5>(X, S, E, out, rows, st);
    case 6: return launch_sites<T, 6>(X, S, E, out, rows, st);
    case 7: return launch_sites<T, 7>(X, S, E, out, rows, st);
    case 8: return launch_sites<T, 8>(X, S, E, out, rows, st);
    case 9: return launch_sites<T, 9>(X, S, E, out, rows, st);
    default: return launch_sites<T, 10>(X, S, E, out, rows, st);
  }
}

}  // namespace

// X (rows, 2^smax), S (rows, smax), E (rows,), out (rows, 2^smax), all
// contiguous on the device, float32 (_f32) or float64 (_f64); the entry
// picks the launch shape. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success); cudaErrorInvalidValue for a
// size the kernel does not take.
extern "C" int hypercube_flux_f32(const void* X, const void* S, const void* E, void* out,
                                  long long rows, int smax, void* stream) {
  return launch<float>(X, S, E, out, rows, smax, stream);
}

extern "C" int hypercube_flux_f64(const void* X, const void* S, const void* E, void* out,
                                  long long rows, int smax, void* stream) {
  return launch<double>(X, S, E, out, rows, smax, stream);
}

extern "C" const char* hypercube_flux_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
