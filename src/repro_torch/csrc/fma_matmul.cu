// Path-selectable matmul for Hopper (sm_90a): K9, (M,K) @ (K,N) with
// float32 or bfloat16 inputs and float32 accumulators and output.
//
// Replaces fma_matmul_pallas in src/repro/kernels/fma_matmul/kernel.py:
// grid (M/bm, N/bn, K/bk), K innermost, an f32 VMEM accumulator carried
// across the K steps, and two variants of the tile product:
//   * mxu:     jnp.dot on the 128x128 systolic array (the matrix unit);
//   * mul_add: a broadcast multiply and a reduce-add on the VPU, no
//     matrix unit -- the TPU reading of the paper's -fmad=false.
// Here the variants keep their meaning (core/compute_path.py: mxu ->
// Path.TENSOR, mul_add -> Path.MUL_ADD):
//   * mxu runs on the tensor cores through WMMA: TF32 m16n16k8 for f32
//     inputs (each element rounded to TF32 as it is loaded into the
//     fragment), bf16 m16n16k16 for bf16 inputs, f32 accumulators;
//   * mul_add runs on the CUDA cores: every multiply-accumulate is
//     __fmul_rn then __fadd_rn into an f32 accumulator, which nvcc never
//     contracts -- no tensor core and no FFMA in the kernel.
//   There is no fused (FFMA) arm: the reference has none.
//
// What bounds it on the H100: at the qwen2.5-1.5b MLP shapes (M = 128
// tokens, K x N = 1536 x 8960 or 8960 x 1536) the product does 2*M*K*N
// = 3.5 GFLOP over 27.5 MB (bf16 weights) to 55 MB (f32): ~64 to 128
// flop/B, compute-bound on the CUDA cores (67 TFLOP/s f32, half of it
// for an unfused multiply and add) and bytes-bound on the tensor cores
// (495 TF32 / 989 bf16 against 3.35 TB/s).
//
// What the design does about it, simply: one CTA per 64x64 output tile,
// K staged through shared memory 32 deep (zero-filled past the edges,
// so any M, K, N works), the tile written through shared memory with
// bounds checks.  mxu: four warps, each a 32x32 quarter of the tile as
// 2x2 WMMA fragments.  mul_add: 256 threads, each a 4x4 register block.
// Left for later: wgmma with TMA-fed multi-stage pipelines, a persistent
// grid, and split-K for the 1536-wide output (48 CTAs on 132 SMs).
//
// C interface (loaded with ctypes): fma_matmul_fwd returns the
// cudaError_t of the launch; it allocates nothing and launches on the
// stream it is given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// WMMA shape and shared-memory padding per input type (the leading
// dimension of a fragment load must be a multiple of 16 bytes).
template <typename T> struct Mma;
template <> struct Mma<float> {
  static constexpr int kK = 8;
  static constexpr int kPad = 4;
  using Elem = wmma::precision::tf32;
};
template <> struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  using Elem = __nv_bfloat16;
};

// Stage the (BM x BK) tile of x and the (BK x BN) tile of w at (m0, k0,
// n0) into shared memory as S, zero past the matrix edges.
template <typename T, typename S, int LDA, int LDB, int NT>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ w, S* As, S* Bs,
                                      int M, int K, int N, int m0, int k0,
                                      int n0) {
  for (int e = threadIdx.x; e < BM * BK; e += NT) {
    int r = e / BK, c = e % BK;
    int gr = m0 + r, gc = k0 + c;
    T v = (gr < M && gc < K) ? x[(int64_t)gr * K + gc] : zero<T>();
    if constexpr (sizeof(S) == sizeof(T)) {
      As[r * LDA + c] = v;
    } else {
      As[r * LDA + c] = to_f32(v);
    }
  }
  for (int e = threadIdx.x; e < BK * BN; e += NT) {
    int r = e / BN, c = e % BN;
    int gr = k0 + r, gc = n0 + c;
    T v = (gr < K && gc < N) ? w[(int64_t)gr * N + gc] : zero<T>();
    if constexpr (sizeof(S) == sizeof(T)) {
      Bs[r * LDB + c] = v;
    } else {
      Bs[r * LDB + c] = to_f32(v);
    }
  }
}

// ---------------------------------------------------------------------
// mxu: tensor cores
// ---------------------------------------------------------------------

constexpr int kMxuThreads = 128;

template <typename T>
__device__ __forceinline__ void mxu_body(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         float* __restrict__ out, int M,
                                         int K, int N) {
  constexpr int LDA = BK + Mma<T>::kPad;
  constexpr int LDB = BN + Mma<T>::kPad;
  constexpr int LDC = BN + 4;
  constexpr int MK = Mma<T>::kK;
  using Elem = typename Mma<T>::Elem;
  // raw bytes: fragment loads need 32-byte aligned rows
  __shared__ __align__(32) unsigned char a_bytes[BM * LDA * sizeof(T)];
  __shared__ __align__(32) unsigned char b_bytes[BK * LDB * sizeof(T)];
  __shared__ __align__(32) float Cs[BM * LDC];
  T* As = reinterpret_cast<T*>(a_bytes);
  T* Bs = reinterpret_cast<T*>(b_bytes);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, MK, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<T, T, LDA, LDB, kMxuThreads>(x, w, As, Bs, M, K, N, m0, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += MK) {
      wmma::fragment<wmma::matrix_a, 16, 16, MK, Elem, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, MK, Elem, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LDA + kk, LDA);
        wmma::load_matrix_sync(b[i], Bs + kk * LDB + wn + 16 * i, LDB);
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int t = 0; t < a[i].num_elements; ++t)
            a[i].x[t] = wmma::__float_to_tf32(a[i].x[t]);
#pragma unroll
          for (int t = 0; t < b[i].num_elements; ++t)
            b[i].x[t] = wmma::__float_to_tf32(b[i].x[t]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += kMxuThreads) {
    int r = e / BN, c = e % BN;
    if (m0 + r < M && n0 + c < N)
      out[(int64_t)(m0 + r) * N + n0 + c] = Cs[r * LDC + c];
  }
}

__global__ void __launch_bounds__(kMxuThreads)
fma_matmul_mxu_f32(const float* x, const float* w, float* out, int M, int K,
                   int N) {
  mxu_body<float>(x, w, out, M, K, N);
}

__global__ void __launch_bounds__(kMxuThreads)
fma_matmul_mxu_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                    float* out, int M, int K, int N) {
  mxu_body<__nv_bfloat16>(x, w, out, M, K, N);
}

// ---------------------------------------------------------------------
// mul_add: CUDA cores, separate multiply and add
// ---------------------------------------------------------------------

constexpr int kMulAddThreads = 256;

template <typename T>
__device__ __forceinline__ void mul_add_body(const T* __restrict__ x,
                                             const T* __restrict__ w,
                                             float* __restrict__ out, int M,
                                             int K, int N) {
  constexpr int LDA = BK + 1;
  constexpr int LDB = BN;
  __shared__ float As[BM * LDA];
  __shared__ float Bs[BK * LDB];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<T, float, LDA, LDB, kMulAddThreads>(x, w, As, Bs, M, K, N, m0, k0,
                                              n0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(int64_t)r * N + c] = acc[i][j];
    }
}

__global__ void __launch_bounds__(kMulAddThreads)
fma_matmul_mul_add_f32(const float* x, const float* w, float* out, int M,
                       int K, int N) {
  mul_add_body<float>(x, w, out, M, K, N);
}

__global__ void __launch_bounds__(kMulAddThreads)
fma_matmul_mul_add_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                        float* out, int M, int K, int N) {
  mul_add_body<__nv_bfloat16>(x, w, out, M, K, N);
}

}  // namespace

// variant: 0 mxu, 1 mul_add; dtype: 0 float32, 1 bfloat16 (x and w).
extern "C" int fma_matmul_fwd(const void* x, const void* w, void* out, int M,
                              int K, int N, int variant, int dtype,
                              void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  float* o = (float*)out;
  if (dtype == 0) {
    const float* xf = (const float*)x;
    const float* wf = (const float*)w;
    if (variant == 0)
      fma_matmul_mxu_f32<<<grid, kMxuThreads, 0, s>>>(xf, wf, o, M, K, N);
    else if (variant == 1)
      fma_matmul_mul_add_f32<<<grid, kMulAddThreads, 0, s>>>(xf, wf, o, M, K,
                                                             N);
    else
      return (int)cudaErrorInvalidValue;
  } else if (dtype == 1) {
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
    if (variant == 0)
      fma_matmul_mxu_bf16<<<grid, kMxuThreads, 0, s>>>(xb, wb, o, M, K, N);
    else if (variant == 1)
      fma_matmul_mul_add_bf16<<<grid, kMulAddThreads, 0, s>>>(xb, wb, o, M,
                                                              K, N);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
