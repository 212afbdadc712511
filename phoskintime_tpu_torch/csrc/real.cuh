// Overloads that let one kernel template run in float32 and float64: each
// names the single-precision intrinsic for float and the double one for
// double, so a float instance compiles to the same instructions as code
// written with fmaf, fabsf and the rest.

#pragma once

#include <cuda_runtime.h>

namespace real {

__device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma(double a, double b, double c) { return ::fma(a, b, c); }
__device__ __forceinline__ float abs(float x) { return fabsf(x); }
__device__ __forceinline__ double abs(double x) { return ::fabs(x); }
__device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max(double a, double b) { return ::fmax(a, b); }
__device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min(double a, double b) { return ::fmin(a, b); }
__device__ __forceinline__ float ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil(double x) { return ::ceil(x); }
__device__ __forceinline__ float log2(float x) { return log2f(x); }
__device__ __forceinline__ double log2(double x) { return ::log2(x); }
__device__ __forceinline__ float exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2(double x) { return ::exp2(x); }
// the correctly rounded reciprocal
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// A quiet NaN of the type.
template <typename T>
__device__ __forceinline__ T nan() { return static_cast<T>(__int_as_float(0x7fc00000)); }

}  // namespace real
