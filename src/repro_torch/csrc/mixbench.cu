// mixbench intensity sweep for Hopper (sm_90a): K8, in float32 and
// bfloat16, with a fused (fma) and an unfused (mul_add) arm.
//
// Replaces mixbench_pallas in src/repro/kernels/mixbench/kernel.py: a
// 1-D grid of blocks, each loaded from HBM once, then `iters` dependent
// steps y = y * a + b per element on the VPU (a = 0.999, b = 1e-3 in
// x's dtype), written back once.  The paper (Graphs 3-1..3-5) sweeps
// `iters` to trace the roofline knee and to expose the CMP 170HX's
// throttled FMA pipe; `-fmad=false` moved its FP32 work onto separate
// multiply and add instructions and brought the rate back 15.9x.
//
// The two arms are written with intrinsics, never as `y * a + b`:
//   * fma:     __fmaf_rn(y, a, b)               -> FFMA
//              (bf16: __hfma2(y, a, b) -> HFMA2)
//   * mul_add: __fadd_rn(__fmul_rn(y, a), b)    -> FMUL + FADD
//              (bf16: __hadd2_rn(__hmul2_rn(y, a), b) -> HMUL2 + HADD2)
// nvcc contracts a plain `y * a + b` into FFMA by default.  The *_rn
// intrinsics emit mul.rn / add.rn, which PTX never contracts; the bf16
// __hmul / __hadd emit mul.bf16 / add.bf16 with no rounding modifier on
// sm_90, which ptxas may fuse into HFMA2, so they are not used here
// (nor their bf16x2 forms __hmul2 / __hadd2).  This source is the
// paper's -fmad=false written into the code; the constants are float (a
// double constant would put the chain on the FP64 pipe).  The library
// must never be built with --use_fast_math.
//
// What bounds it on the H100: bytes at small `iters` (4 B read + 4 B
// written per element: 8 B against 2 * iters flops), operations beyond
// the knee (~2 * iters / 8 flop/B > 67e12 / 3.35e12 = 20 flop/B, i.e.
// iters >= ~80 in f32).  The fma arm's roof is the FP32 peak (132 SMs x
// 128 lanes x 2 flops x clock); the mul_add arm issues two instructions
// per step and so has half of it.
//
// What the design does about it: one dependent chain per element, kept
// in registers.  Each thread takes four elements at a time with one
// 16-byte (f32) or 8-byte (bf16) load and store, and carries their four
// chains interleaved (independent instructions to hide the FMA latency
// at high `iters`); bf16 runs as two packed bf16x2 chains, one
// instruction for two elements.  The step loop is unrolled 32 deep, so
// the loop's own counter and branch cost ~2% of the issue slots at high
// `iters`.  Vectors go grid-stride over a grid that fills every SM; the
// remainder (and an unaligned array) takes a scalar chain, so any n
// works.  The wrapper passes a and b already rounded to x's dtype, as
// the reference casts them.
//
// C interface (loaded with ctypes): mixbench_fwd returns the
// cudaError_t of the launch; it allocates nothing and launches on the
// stream it is given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float step_fma(float y, float a, float b) {
  return __fmaf_rn(y, a, b);
}
__device__ __forceinline__ float step_mul_add(float y, float a, float b) {
  return __fadd_rn(__fmul_rn(y, a), b);
}
__device__ __forceinline__ __nv_bfloat16 step_fma(__nv_bfloat16 y,
                                                  __nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  return __hfma(y, a, b);
}
__device__ __forceinline__ __nv_bfloat16 step_mul_add(__nv_bfloat16 y,
                                                      __nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
  return __hadd_rn(__hmul_rn(y, a), b);
}

template <typename T, bool kFused>
__device__ __forceinline__ T step(T y, T a, T b) {
  if constexpr (kFused) {
    return step_fma(y, a, b);
  } else {
    return step_mul_add(y, a, b);
  }
}

// a packed pair of bf16 chains: one HFMA2 (or HMUL2 + HADD2) for both
template <bool kFused>
__device__ __forceinline__ __nv_bfloat162 step2(__nv_bfloat162 y,
                                                __nv_bfloat162 a,
                                                __nv_bfloat162 b) {
  if constexpr (kFused) {
    return __hfma2(y, a, b);
  } else {
    return __hadd2_rn(__hmul2_rn(y, a), b);
  }
}

// The scalar chain of one element (the tail, or all of an unaligned array).
template <typename T, bool kFused>
__device__ __forceinline__ T chain(T y, int iters, T a, T b) {
#pragma unroll 8
  for (int it = 0; it < iters; ++it) y = step<T, kFused>(y, a, b);
  return y;
}

// Four elements per vector: one 16-byte load of f32 (8 bytes of bf16),
// four independent chains in registers, one store.  Vectors go
// grid-stride; elements past the last whole vector (and every element
// when a pointer is not aligned to the vector) take the scalar chain.
template <bool kFused>
__device__ __forceinline__ void mixbench_f32_body(const float* __restrict__ x,
                                                  float* __restrict__ y,
                                                  int64_t n, int iters,
                                                  float a, float b,
                                                  bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nv = vec ? n / 4 : 0;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* yv = reinterpret_cast<float4*>(y);
  for (int64_t i = tid; i < nv; i += stride) {
    float4 v = xv[i];
#pragma unroll 32
    for (int it = 0; it < iters; ++it) {
      v.x = step<float, kFused>(v.x, a, b);
      v.y = step<float, kFused>(v.y, a, b);
      v.z = step<float, kFused>(v.z, a, b);
      v.w = step<float, kFused>(v.w, a, b);
    }
    yv[i] = v;
  }
  for (int64_t i = nv * 4 + tid; i < n; i += stride)
    y[i] = chain<float, kFused>(x[i], iters, a, b);
}

template <bool kFused>
__device__ __forceinline__ void mixbench_bf16_body(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
    int64_t n, int iters, __nv_bfloat16 a, __nv_bfloat16 b, bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nv = vec ? n / 4 : 0;
  const uint2* xv = reinterpret_cast<const uint2*>(x);
  uint2* yv = reinterpret_cast<uint2*>(y);
  const __nv_bfloat162 a2 = __halves2bfloat162(a, a);
  const __nv_bfloat162 b2 = __halves2bfloat162(b, b);
  for (int64_t i = tid; i < nv; i += stride) {
    uint2 raw = xv[i];
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, 4);
    memcpy(&hi, &raw.y, 4);
#pragma unroll 32
    for (int it = 0; it < iters; ++it) {
      lo = step2<kFused>(lo, a2, b2);
      hi = step2<kFused>(hi, a2, b2);
    }
    memcpy(&raw.x, &lo, 4);
    memcpy(&raw.y, &hi, 4);
    yv[i] = raw;
  }
  for (int64_t i = nv * 4 + tid; i < n; i += stride)
    y[i] = chain<__nv_bfloat16, kFused>(x[i], iters, a, b);
}

// One kernel per (dtype, arm); the symbol names carry both, so the
// instruction check can find each kernel in the library's SASS.
__global__ void __launch_bounds__(kThreads)
mixbench_f32_fma(const float* x, float* y, int64_t n, int iters, float a,
                 float b, bool vec) {
  mixbench_f32_body<true>(x, y, n, iters, a, b, vec);
}

__global__ void __launch_bounds__(kThreads)
mixbench_f32_mul_add(const float* x, float* y, int64_t n, int iters,
                     float a, float b, bool vec) {
  mixbench_f32_body<false>(x, y, n, iters, a, b, vec);
}

__global__ void __launch_bounds__(kThreads)
mixbench_bf16_fma(const __nv_bfloat16* x, __nv_bfloat16* y, int64_t n,
                  int iters, __nv_bfloat16 a, __nv_bfloat16 b, bool vec) {
  mixbench_bf16_body<true>(x, y, n, iters, a, b, vec);
}

__global__ void __launch_bounds__(kThreads)
mixbench_bf16_mul_add(const __nv_bfloat16* x, __nv_bfloat16* y, int64_t n,
                      int iters, __nv_bfloat16 a, __nv_bfloat16 b,
                      bool vec) {
  mixbench_bf16_body<false>(x, y, n, iters, a, b, vec);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; fused: 1 fma, 0 mul_add.  a and b are
// the constants already rounded to x's dtype (exact in float).
extern "C" int mixbench_fwd(const void* x, void* y, long long n, int iters,
                            float a, float b, int fused, int dtype,
                            int n_sm, void* stream) {
  if (n < 1 || iters < 0 || n_sm < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = ((uintptr_t)x % (4 * esize) == 0) &&
                   ((uintptr_t)y % (4 * esize) == 0);
  // enough resident threads to fill every SM (2048 each), no more
  // blocks than one vector of four elements per thread needs
  long long want = (n / 4 + kThreads) / kThreads;
  long long cap = (long long)n_sm * (2048 / kThreads);
  int grid = (int)(want < cap ? want : cap);
  if (dtype == 0) {
    const float* xf = (const float*)x;
    float* yf = (float*)y;
    if (fused)
      mixbench_f32_fma<<<grid, kThreads, 0, s>>>(xf, yf, n, iters, a, b,
                                                 vec);
    else
      mixbench_f32_mul_add<<<grid, kThreads, 0, s>>>(xf, yf, n, iters, a, b,
                                                     vec);
  } else if (dtype == 1) {
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    __nv_bfloat16* yb = (__nv_bfloat16*)y;
    __nv_bfloat16 ab = __float2bfloat16_rn(a);
    __nv_bfloat16 bb = __float2bfloat16_rn(b);
    if (fused)
      mixbench_bf16_fma<<<grid, kThreads, 0, s>>>(xb, yb, n, iters, ab, bb,
                                                  vec);
    else
      mixbench_bf16_mul_add<<<grid, kThreads, 0, s>>>(xb, yb, n, iters, ab,
                                                      bb, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
